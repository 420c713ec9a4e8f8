"""The keyframe mapping step on the device, and the landmark-set fuse.

Port of ``planarslam_tpu/slam/device_mapper.py``. Per keyframe,
``dispatch_mapping_step`` uploads the new keyframe, its landmarks and its
``N_NEIGHBORS`` covisible neighbours as one packed float32 buffer
(``MappingInputLayout``) and issues ``_mapping_step_impl`` on the current
CUDA stream:

  - fuse search: the new keyframe's landmarks projected into each neighbour
    and matched within a window (``matching.search_by_projection`` with the
    neighbours as its leading dimension: one K24, K3 and K25 launch);
  - point triangulation: brute-force matching of the new keyframe's free
    (unassociated, depthless) features against each neighbour's free
    features (``matching.match_descriptors``, one K3 and one K25 launch for
    all neighbours), then the two-view DLT and chi2 gates for all
    neighbours at once (K5, ``solvers/triangulation``);
  - line triangulation: descriptor matching of free segments and the cut
    of the own endpoint rays with the neighbour's back-projection plane,
    for all neighbours in one K42 launch (``triangulate_lines``,
    ``csrc/line_triangulate.cu``).

The JAX module vmaps over the neighbours; here they are the leading batch
dimension of every kernel. The result is one packed
bundle (``MappingLayout``) pulled through a pinned buffer behind a CUDA
event (``tracking._HostPull``); ``join_mapping_step`` waits for it and
unpacks it into the dict the host code reads.

``run_fuse_set`` / ``fuse_set_step_packed`` project a landmark set into up
to ``N_NEIGHBORS`` target keyframes (keyframe creation, the mapping step,
loop closing's fuse): one packed pinned upload (``FuseSetInputLayout``),
one launch each of K24, K3 and K25 over the targets padded to
``N_NEIGHBORS``, one pull.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.ops import matching
from planarslam_tpu_torch.slam.device_tracker import _f32_bits
from planarslam_tpu_torch.slam.tracking import _HostPull, _upload
from planarslam_tpu_torch.solvers.triangulation import triangulate_two_view

N_NEIGHBORS = 5  # covisible neighbours processed per keyframe


class MappingLayout:
    """Static layout of the packed mapping bundle."""

    def __init__(self, cfg: SystemConfig):
        K = cfg.orb.max_keypoints
        L = cfg.lines.max_lines
        NB = N_NEIGHBORS
        self.fields = [
            ("fuse_idx", (NB, K), np.int32),   # own-landmark slot -> nb feat
            ("tri_idx", (NB, K), np.int32),    # own feat -> nb feat
            ("tri_x", (NB, K, 3), np.float32),  # triangulated world point
            ("tri_good", (NB, K), np.int32),   # acceptance mask
            ("ln_tri_idx", (NB, L), np.int32),  # own line -> nb line
            ("ln_tri_s", (NB, L, 3), np.float32),  # start endpoint (world)
            ("ln_tri_e", (NB, L, 3), np.float32),  # end endpoint (world)
            ("ln_tri_good", (NB, L), np.int32),
        ]
        self.sizes = [int(np.prod(s)) for _, s, _ in self.fields]
        self.total = sum(self.sizes)

    def unpack(self, flat: np.ndarray) -> dict:
        out = {}
        off = 0
        for (name, shape, dtype), size in zip(self.fields, self.sizes):
            chunk = flat[off:off + size]
            if dtype == np.int32:
                chunk = chunk.view(np.int32)
            out[name] = chunk.reshape(shape).copy()
            off += size
        return out


class PackedInputLayout:
    """Static layout for packing a device program's whole input list into
    one float32 buffer (one upload): ints and uints ride as their bit
    patterns, bools as 0/1."""

    KINDS = {"f": np.float32, "u": np.uint32, "i": np.int32, "b": bool}

    def __init__(self, fields):
        self.fields = fields
        self.sizes = [int(np.prod(s)) for _, s, _ in self.fields]
        self.total = sum(self.sizes)

    def pack(self, arrays: dict) -> np.ndarray:
        parts = []
        for (name, shape, kind), size in zip(self.fields, self.sizes):
            a = np.ascontiguousarray(arrays[name])
            assert a.shape == shape, (name, a.shape, shape)
            if kind == "f":
                p = a.astype(np.float32, copy=False)
            elif kind in ("u", "i"):
                p = a.astype(self.KINDS[kind], copy=False).view(np.float32)
            else:
                p = a.astype(np.float32)
            parts.append(p.reshape(-1))
        return np.concatenate(parts)

    def unpack_device(self, flat: torch.Tensor) -> list:
        """Views of the packed device buffer; uint32 fields become int32
        bit patterns (the port's descriptor convention)."""
        out = []
        off = 0
        for (name, shape, kind), size in zip(self.fields, self.sizes):
            x = flat[off:off + size].reshape(shape)
            if kind in ("u", "i"):
                x = x.view(torch.int32)
            elif kind == "b":
                x = x > 0.5
            out.append(x)
            off += size
        return out


class MappingInputLayout(PackedInputLayout):
    """_mapping_step_impl inputs (26 fields) as one packed upload."""

    def __init__(self, cfg: SystemConfig):
        K = cfg.orb.max_keypoints
        L = cfg.lines.max_lines
        D = cfg.lines.desc_dim
        NB = N_NEIGHBORS
        # (name, shape, kind) in _mapping_step_impl argument order
        super().__init__([
            ("own_T", (4, 4), "f"), ("own_uv", (K, 2), "f"),
            ("own_desc", (K, 8), "u"), ("own_level", (K,), "i"),
            ("own_free", (K,), "b"), ("lm_xyz", (K, 3), "f"),
            ("lm_desc", (K, 8), "u"), ("lm_valid", (K,), "b"),
            ("nb_T", (NB, 4, 4), "f"), ("nb_uv", (NB, K, 2), "f"),
            ("nb_desc", (NB, K, 8), "u"), ("nb_level", (NB, K), "i"),
            ("nb_valid", (NB, K), "b"), ("nb_ur", (NB, K), "f"),
            ("nb_free", (NB, K), "b"), ("nb_ok", (NB,), "b"),
            ("own_ln_uvs", (L, 2), "f"), ("own_ln_uve", (L, 2), "f"),
            ("own_ln_l2d", (L, 3), "f"), ("own_ln_desc", (L, D), "f"),
            ("own_ln_angle", (L,), "f"), ("own_ln_free", (L,), "b"),
            ("nb_ln_l2d", (NB, L, 3), "f"), ("nb_ln_desc", (NB, L, D), "f"),
            ("nb_ln_angle", (NB, L), "f"), ("nb_ln_free", (NB, L), "b"),
        ])


def line_constants(K) -> tuple:
    """(fx, fy, cx, cy) and the entries of K^-1 in float32, in closed form:
    1 / fx, 1 / fy, -cx / fx, -cy / fy (K42's arguments, as Python
    floats)."""
    f = np.float32
    fx, fy, cx, cy = (f(v) for v in K)
    return tuple(float(v) for v in (fx, fy, cx, cy, f(1) / fx, f(1) / fy,
                                    -(cx / fx), -(cy / fy)))


def _dot3(a, b):
    """a . b over the last dimension, (a0 b0 + a1 b1) + a2 b2."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def triangulate_lines_plain(own_T, own_ln_uvs, own_ln_uve, own_ln_l2d,
                            own_ln_desc, own_ln_free, nb_T, nb_ln_l2d,
                            nb_ln_desc, nb_ln_free, nb_ok, K):
    """Plain version of K42 (``triangulate_lines``) for one mapping step:
    CreateNewMapLines2 for all NB neighbours at once. Each 2D segment
    back-projects to a plane through its camera centre (pi = P^T l); the
    own segment's endpoint rays cut the matched neighbour segment's plane.
    own_T (4, 4), own_ln_* (L, ...), nb_T (NB, 4, 4), nb_ln_* (NB, L,
    ...), nb_ok (NB,), K = (fx, fy, cx, cy). Every dot product is spelled
    in one order, the order K42 repeats: the D-term similarities d = 0 ..
    D - 1, 3-term ones (x + y) + z. The arg-max takes NaN above every
    number and the first index among equals, as torch.max and jnp.argmax.
    Returns idx (NB, L) int32, Xs, Xe (NB, L, 3) float32, good (NB, L)
    bool."""
    fx, fy, cx, cy, ifx, ify, ncx, ncy = line_constants(K)
    L = nb_ln_desc.shape[1]
    D = own_ln_desc.shape[-1]
    R, t = own_T[:3, :3], own_T[:3, 3]
    C1 = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])

    def ray(uv):  # world-frame ray directions R1^T K^-1 (u, v, 1), (L, 3)
        kx = (uv[:, 0] * ifx + ncx)[:, None]
        ky = (uv[:, 1] * ify + ncy)[:, None]
        return kx * R[0] + ky * R[1] + R[2]

    def backproject(T, l, n):  # (K [R | t])^T l, its first n entries
        return torch.stack([
            (fx * T[..., 0, c] + cx * T[..., 2, c]) * l[..., 0]
            + (fy * T[..., 1, c] + cy * T[..., 2, c]) * l[..., 1]
            + T[..., 2, c] * l[..., 2] for c in range(n)], dim=-1)

    a = own_ln_desc[None, :, None, :]
    c = nb_ln_desc[:, None, :, :]
    sim = a[..., 0] * c[..., 0]  # (NB, L, L)
    for d in range(1, D):
        sim = sim + a[..., d] * c[..., d]
    gate = (own_ln_free[None, :, None] & nb_ln_free[:, None, :]
            & nb_ok[:, None, None])
    sim = torch.where(gate, sim, -1.0)
    best = torch.amax(sim, dim=2)
    hit = (sim == best[..., None]) | (torch.isnan(sim)
                                      & torch.isnan(best)[..., None])
    cols = torch.arange(L, dtype=torch.int32, device=sim.device)
    idx = torch.amin(torch.where(hit, cols, L), dim=2).to(torch.int32)
    has = best > 0.75
    j = torch.clamp(idx, 0, L - 1).long()
    l2 = torch.gather(nb_ln_l2d, 1, j[..., None].expand(-1, -1, 3))
    pi2 = backproject(nb_T[:, None], l2, 4)  # (NB, L, 4)
    pi1 = backproject(own_T, own_ln_l2d, 3)  # (L, 3)
    cosp = torch.abs(_dot3(pi1[None], pi2)) / (
        torch.sqrt(_dot3(pi1, pi1))[None] * torch.sqrt(_dot3(pi2, pi2))
        + 1e-12)

    def cut(dirs):
        denom = _dot3(pi2, dirs[None])
        num = _dot3(pi2, C1) + pi2[..., 3]
        s = -num / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        return C1 + s[..., None] * dirs[None], s

    Xs, ts = cut(ray(own_ln_uvs))
    Xe, te = cut(ray(own_ln_uve))
    # depth in the own camera and a sane segment length
    zs = _dot3(R[2], Xs) + t[2]
    ze = _dot3(R[2], Xe) + t[2]
    dx = Xe - Xs
    seg = torch.sqrt(_dot3(dx, dx))
    good = (has & (cosp < 0.998)             # parallax >= ~3.6 deg
            & (ts > 0) & (te > 0)
            & (zs > 0.1) & (zs < 40.0) & (ze > 0.1) & (ze < 40.0)
            & (seg > 0.05) & (seg < 20.0)
            & torch.all(torch.isfinite(Xs), dim=-1)
            & torch.all(torch.isfinite(Xe), dim=-1))
    return idx, Xs, Xe, good


def _empty(shape, dtype, dev) -> torch.Tensor:
    """K42's output allocator."""
    return torch.empty(shape, dtype=dtype, device=dev)


def triangulate_lines(own_T, own_ln_uvs, own_ln_uve, own_ln_l2d, own_ln_desc,
                      own_ln_free, nb_T, nb_ln_l2d, nb_ln_desc, nb_ln_free,
                      nb_ok, K):
    """K42 wrapper; the arguments and results of ``triangulate_lines_plain``,
    each with an optional leading batch dimension (B mapping steps: own_T
    (B, 4, 4), nb_T (B, NB, 4, 4), ...). One launch over every neighbour of
    every step."""
    args = (own_T, own_ln_uvs, own_ln_uve, own_ln_l2d, own_ln_desc,
            own_ln_free, nb_T, nb_ln_l2d, nb_ln_desc, nb_ln_free, nb_ok)
    batched = own_T.dim() == 3
    if kernels.on_cpu(*args):
        if not batched:
            return triangulate_lines_plain(*args, K)
        return kernels.per_problem(triangulate_lines_plain, args, K)
    lead = own_T.shape[:1] if batched else ()
    B = own_T.shape[0] if batched else 1
    NB, L = nb_ln_desc.shape[-3], nb_ln_desc.shape[-2]
    D = own_ln_desc.shape[-1]
    f32, b8 = torch.float32, torch.bool
    for name, x, dtype, shape in (
            ("own_T", own_T, f32, (4, 4)), ("own_ln_uvs", own_ln_uvs, f32,
                                            (L, 2)),
            ("own_ln_uve", own_ln_uve, f32, (L, 2)),
            ("own_ln_l2d", own_ln_l2d, f32, (L, 3)),
            ("own_ln_desc", own_ln_desc, f32, (L, D)),
            ("own_ln_free", own_ln_free, b8, (L,)),
            ("nb_T", nb_T, f32, (NB, 4, 4)),
            ("nb_ln_l2d", nb_ln_l2d, f32, (NB, L, 3)),
            ("nb_ln_desc", nb_ln_desc, f32, (NB, L, D)),
            ("nb_ln_free", nb_ln_free, b8, (NB, L)),
            ("nb_ok", nb_ok, b8, (NB,))):
        kernels.check(x, name, dtype, lead + shape)
    dev = own_T.device
    idx = _empty(lead + (NB, L), torch.int32, dev)
    Xs = _empty(lead + (NB, L, 3), f32, dev)
    Xe = _empty(lead + (NB, L, 3), f32, dev)
    good = _empty(lead + (NB, L), b8, dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_triangulate_lines",
                       *(kernels.ptr(x) for x in args), B, NB, L, D,
                       *line_constants(K), kernels.ptr(idx), kernels.ptr(Xs),
                       kernels.ptr(Xe), kernels.ptr(good))
    kernels.LAUNCHES["triangulate_lines"] += 1
    return idx, Xs, Xe, good


@record_function("device_mapper.mapping_step")
def _mapping_step_impl(
    own_T, own_uv, own_desc, own_level, own_free, lm_xyz, lm_desc, lm_valid,
    nb_T, nb_uv, nb_desc, nb_level, nb_valid, nb_ur, nb_free, nb_ok,
    own_ln_uvs, own_ln_uve, own_ln_l2d, own_ln_desc, own_ln_angle,
    own_ln_free, nb_ln_l2d, nb_ln_desc, nb_ln_angle, nb_ln_free,
    cfg: SystemConfig,
) -> torch.Tensor:
    """Fuse search, point and line triangulation against the stacked
    neighbours; returns the packed MappingLayout bundle (float32)."""
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    Kp = cfg.orb.max_keypoints
    NB = nb_T.shape[0]

    # fuse: own landmarks projected into each neighbour
    fuse_idx = _fuse_set_impl(lm_xyz, lm_desc, lm_valid, nb_T, nb_uv, nb_desc,
                              nb_level, nb_valid, nb_ur, nb_ok, cfg,
                              radius=3.0)
    # triangulation candidates: free features matched to each neighbour,
    # the neighbours as the leading dimension of one match (one K3 and one
    # K25 launch)
    tri_idx = matching.match_descriptors(
        own_desc.expand(NB, *own_desc.shape).contiguous(), nb_desc,
        own_free[None] & nb_ok[:, None], nb_free,
        max_dist=cfg.matcher.th_low, ratio=0.8).idx
    j = torch.clamp(tri_idx, 0, Kp - 1).to(torch.int64)
    uv2 = torch.gather(nb_uv, 1, j[..., None].expand(-1, -1, 2))
    level2 = torch.gather(nb_level, 1, j)
    tri_x, tri_good = triangulate_two_view(
        own_uv.contiguous(), own_level.contiguous(), uv2.contiguous(),
        level2.contiguous(), (tri_idx >= 0).contiguous(), own_T.contiguous(),
        nb_T.contiguous(), K, cfg.orb.scale_factor)

    ln_tri_idx, ln_tri_s, ln_tri_e, ln_tri_good = triangulate_lines(
        *(x.contiguous() for x in (
            own_T, own_ln_uvs, own_ln_uve, own_ln_l2d, own_ln_desc,
            own_ln_free, nb_T, nb_ln_l2d, nb_ln_desc, nb_ln_free, nb_ok)),
        K)

    return torch.cat([
        _f32_bits(fuse_idx.to(torch.int32)), _f32_bits(tri_idx.to(torch.int32)),
        _f32_bits(tri_x), _f32_bits(tri_good.to(torch.int32)),
        _f32_bits(ln_tri_idx.to(torch.int32)), _f32_bits(ln_tri_s),
        _f32_bits(ln_tri_e), _f32_bits(ln_tri_good.to(torch.int32)),
    ])


def mapping_step_packed(flat: torch.Tensor, cfg: SystemConfig
                        ) -> torch.Tensor:
    """_mapping_step_impl over one packed input buffer (MappingInputLayout)."""
    return _mapping_step_impl(*MappingInputLayout(cfg).unpack_device(flat),
                              cfg)


class FuseSetInputLayout(PackedInputLayout):
    """_fuse_set_impl inputs (10 fields) as one packed upload."""

    def __init__(self, cfg: SystemConfig):
        K = cfg.orb.max_keypoints
        C = cfg.orb.max_keypoints  # landmark set capacity (== K)
        NB = N_NEIGHBORS
        super().__init__([
            ("lm_xyz", (C, 3), "f"), ("lm_desc", (C, 8), "u"),
            ("lm_valid", (C,), "b"), ("nb_T", (NB, 4, 4), "f"),
            ("nb_uv", (NB, K, 2), "f"), ("nb_desc", (NB, K, 8), "u"),
            ("nb_level", (NB, K), "i"), ("nb_valid", (NB, K), "b"),
            ("nb_ur", (NB, K), "f"), ("nb_ok", (NB,), "b"),
        ])


def _fuse_set_impl(lm_xyz, lm_desc, lm_valid, nb_T, nb_uv, nb_desc, nb_level,
                   nb_valid, nb_ur, nb_ok, cfg: SystemConfig,
                   radius: float = 4.0) -> torch.Tensor:
    """Project the landmark set into each of the NB target keyframes and
    match: one search_by_projection over the targets as its leading
    dimension (one launch each of K24, K3 and K25, whatever NB). Returns
    (NB, C) int32 feature index or -1 (all -1 for targets with nb_ok
    False)."""
    cam = cfg.camera
    NB = nb_T.shape[0]
    res = matching.search_by_projection(
        lm_xyz.expand(NB, *lm_xyz.shape), lm_desc.expand(NB, *lm_desc.shape),
        lm_valid[None] & nb_ok[:, None], nb_T, nb_uv, nb_desc, nb_level,
        nb_valid, nb_ur, K=(cam.fx, cam.fy, cam.cx, cam.cy),
        image_wh=(float(cam.width), float(cam.height)), bf=cam.bf,
        scale_factor=cfg.orb.scale_factor, radius=radius,
        max_dist=cfg.matcher.th_low, level_window=1)
    return res.idx


@record_function("device_mapper.fuse_set")
def fuse_set_step_packed(flat, cfg: SystemConfig, radius: float = 4.0,
                         device="cuda") -> torch.Tensor:
    """_fuse_set_impl over one packed input buffer (FuseSetInputLayout; a
    tensor, or a numpy array uploaded to `device`). Returns (NB, C) int32."""
    if not isinstance(flat, torch.Tensor):
        flat = _upload(np.asarray(flat, np.float32), resolve_device(device))
    return _fuse_set_impl(*FuseSetInputLayout(cfg).unpack_device(flat), cfg,
                          radius=radius)


def fuse_set_inputs(slam_map, lm_ids: np.ndarray, target_kfs,
                    cfg: SystemConfig):
    """The packed input buffer (numpy) of a fuse set, the landmark set cut
    to C = max_keypoints and the targets padded to N_NEIGHBORS with nb_ok
    False, as the JAX package packs it, and its host-side selections."""
    m = slam_map
    C = cfg.orb.max_keypoints
    ids = np.full(C, 0, np.int64)
    n = min(len(lm_ids), C)
    ids[:n] = lm_ids[:n]
    valid = np.zeros(C, bool)
    valid[:n] = m.pt_valid[ids[:n]]
    NB = N_NEIGHBORS
    tg = [int(t) for t in list(target_kfs)[:NB]]
    nb_arr = np.asarray((tg + [0] * NB)[:NB], np.int64)
    nb_ok = np.zeros(NB, bool)
    nb_ok[:len(tg)] = True
    flat = FuseSetInputLayout(cfg).pack({
        "lm_xyz": m.pt_xyz[ids], "lm_desc": m.pt_desc[ids],
        "lm_valid": valid, "nb_T": m.kf_pose[nb_arr],
        "nb_uv": m.kf_uv[nb_arr], "nb_desc": m.kf_desc[nb_arr],
        "nb_level": m.kf_level[nb_arr], "nb_valid": m.kf_feat_valid[nb_arr],
        "nb_ur": m.kf_ur[nb_arr], "nb_ok": nb_ok})
    return flat, {"lm_ids": ids, "lm_valid": valid, "nb_ids": nb_arr,
                  "nb_ok": nb_ok}


def run_fuse_set(slam_map, lm_ids: np.ndarray, target_kfs, cfg: SystemConfig,
                 radius: float = 4.0, device="cuda") -> dict:
    """Host wrapper of the fuse set over up to N_NEIGHBORS target
    keyframes: one pinned packed upload, one fuse_set_step_packed (K24, K3
    and K25 once each), one pull. Returns JAX's run_fuse_set dict (the
    rows of absent targets all -1)."""
    device = resolve_device(device)
    flat, out = fuse_set_inputs(slam_map, lm_ids, target_kfs, cfg)
    idx = fuse_set_step_packed(_upload(flat, device), cfg, radius=radius)
    out["idx"] = _HostPull(idx).result()
    return out


def run_mapping_step(slam_map, kf: int, cfg: SystemConfig,
                     device="cuda") -> dict:
    """Gather inputs from the host map, run the mapping step, unpack.
    Synchronous convenience wrapper over dispatch + join."""
    return join_mapping_step(dispatch_mapping_step(slam_map, kf, cfg,
                                                   device=device))


def join_mapping_step(pending: dict) -> dict:
    """Wait for a dispatch_mapping_step pull and unpack the bundle."""
    packed = pending.pop("pull").result()
    out = pending.pop("layout").unpack(packed)
    out.update(pending)
    return out


def mapping_inputs(slam_map, kf: int, cfg: SystemConfig):
    """The packed input buffer (numpy) of keyframe kf's mapping step and
    the host-side selections its results are applied with."""
    m = slam_map
    own_row = m.kf_pt_idx[kf]
    lm_ids = np.clip(own_row, 0, None)
    lm_valid = (own_row >= 0) & m.pt_valid[lm_ids]
    own_free = (own_row < 0) & m.kf_feat_valid[kf] & (m.kf_depth[kf] <= 0)

    nbs = [int(n) for n in m.covisible_kfs(kf)[:N_NEIGHBORS]]
    NB = N_NEIGHBORS
    nb_ids = (nbs + [0] * NB)[:NB]
    nb_ok = np.zeros(NB, bool)
    nb_ok[:len(nbs)] = True
    # baseline gate for triangulation (close neighbours are skipped)
    c1 = -m.kf_pose[kf][:3, :3].T @ m.kf_pose[kf][:3, 3]
    tri_ok = nb_ok.copy()
    for i, nb in enumerate(nb_ids):
        c2 = -m.kf_pose[nb][:3, :3].T @ m.kf_pose[nb][:3, 3]
        if np.linalg.norm(c1 - c2) < 0.02:
            tri_ok[i] = False
    nb_ids_arr = np.asarray(nb_ids)
    nb_free = ((m.kf_pt_idx[nb_ids_arr] < 0)
               & m.kf_feat_valid[nb_ids_arr]) & tri_ok[:, None]

    # free lines: valid detections with neither a map-line association nor
    # a depth-based 3D lift (keyframe insertion created those)
    own_ln_row = m.kf_ln_idx[kf]
    own_ln_free = (own_ln_row < 0) & m.kf_ln_valid[kf]
    nb_ln_free = ((m.kf_ln_idx[nb_ids_arr] < 0)
                  & m.kf_ln_valid[nb_ids_arr]) & tri_ok[:, None]

    flat = MappingInputLayout(cfg).pack({
        "own_T": m.kf_pose[kf], "own_uv": m.kf_uv[kf],
        "own_desc": m.kf_desc[kf], "own_level": m.kf_level[kf],
        "own_free": own_free, "lm_xyz": m.pt_xyz[lm_ids],
        "lm_desc": m.pt_desc[lm_ids], "lm_valid": lm_valid,
        "nb_T": m.kf_pose[nb_ids_arr], "nb_uv": m.kf_uv[nb_ids_arr],
        "nb_desc": m.kf_desc[nb_ids_arr], "nb_level": m.kf_level[nb_ids_arr],
        "nb_valid": m.kf_feat_valid[nb_ids_arr],
        "nb_ur": m.kf_ur[nb_ids_arr], "nb_free": nb_free, "nb_ok": nb_ok,
        "own_ln_uvs": m.kf_ln_uv_s[kf], "own_ln_uve": m.kf_ln_uv_e[kf],
        "own_ln_l2d": m.kf_ln_line2d[kf], "own_ln_desc": m.kf_ln_desc[kf],
        "own_ln_angle": m.kf_ln_angle[kf], "own_ln_free": own_ln_free,
        "nb_ln_l2d": m.kf_ln_line2d[nb_ids_arr],
        "nb_ln_desc": m.kf_ln_desc[nb_ids_arr],
        "nb_ln_angle": m.kf_ln_angle[nb_ids_arr], "nb_ln_free": nb_ln_free,
    })
    meta = {"kf": kf, "nb_ids": nb_ids_arr, "nb_ok": nb_ok, "tri_ok": tri_ok,
            "own_free": own_free, "own_ln_free": own_ln_free,
            "lm_valid": lm_valid}
    return flat, meta


def dispatch_mapping_step(slam_map, kf: int, cfg: SystemConfig,
                          device="cuda") -> dict:
    """Upload keyframe kf's mapping inputs (one packed buffer), issue the
    step on the current stream, and start its pull; join_mapping_step
    waits for it later. The upload is a snapshot: later host map mutations
    cannot reach the step in flight."""
    device = resolve_device(device)
    flat, meta = mapping_inputs(slam_map, kf, cfg)
    packed = mapping_step_packed(_upload(flat, device), cfg)
    meta.update(pull=_HostPull(packed), layout=MappingLayout(cfg))
    return meta
