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
  - line triangulation: cosine matching of free segments and the cut of the
    own endpoint rays with the neighbour's back-projection plane (plain
    PyTorch; 5 x 64 x 64 similarities are too small for a kernel yet).

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


def _line_triangulation(own_T, own_ln_uvs, own_ln_uve, own_ln_l2d,
                        own_ln_desc, own_ln_free, nb_T, nb_ln_l2d,
                        nb_ln_desc, nb_ln_free, nb_ok, Kmat):
    """CreateNewMapLines2 for all neighbours at once: each 2D segment
    back-projects to a plane through its camera centre (pi = P^T l); the own
    segment's endpoint rays cut the matched neighbour segment's plane."""
    Rw1 = own_T[:3, :3]
    C1 = -Rw1.T @ own_T[:3, 3]
    Kinv = torch.linalg.inv(Kmat)

    def ray_dir(uv):  # world-frame ray directions R1^T K^-1 u, (L, 3)
        h = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)
        return (Kinv @ h.T).T @ Rw1

    d_s = ray_dir(own_ln_uvs)
    d_e = ray_dir(own_ln_uve)
    sim = own_ln_desc[None] @ nb_ln_desc.transpose(1, 2)  # (NB, L, L)
    gate = (own_ln_free[None, :, None] & nb_ln_free[:, None, :]
            & nb_ok[:, None, None])
    sim = torch.where(gate, sim, -1.0)
    best, idx = sim.max(dim=2)  # ties: the first index, as jnp.argmax
    has = best > 0.75
    L = nb_ln_l2d.shape[1]
    j = torch.clamp(idx, 0, L - 1)
    l2 = torch.gather(nb_ln_l2d, 1, j[..., None].expand(-1, -1, 3))
    P2 = Kmat @ nb_T[:, :3]  # (NB, 3, 4)
    pi2 = (P2.transpose(1, 2)[:, None] @ l2[..., None])[..., 0]  # (NB, L, 4)
    n2 = pi2[..., :3]
    P1w = Kmat @ own_T[:3]
    pi1 = (P1w.T @ own_ln_l2d[..., None])[..., 0]  # (L, 4)
    cosp = torch.abs(torch.sum(pi1[None, :, :3] * n2, dim=-1)) / (
        torch.linalg.norm(pi1[:, :3], dim=-1)[None]
        * torch.linalg.norm(n2, dim=-1) + 1e-12)

    def cut(dirs):
        denom = torch.sum(n2 * dirs[None], dim=-1)
        t = -(n2 @ C1 + pi2[..., 3]) / torch.where(
            torch.abs(denom) < 1e-9, 1e-9, denom)
        return C1 + t[..., None] * dirs[None], t

    Xs, ts = cut(d_s)
    Xe, te = cut(d_e)
    # depth in the own camera and a sane segment length
    zs = (Xs @ Rw1.T)[..., 2] + own_T[2, 3]
    ze = (Xe @ Rw1.T)[..., 2] + own_T[2, 3]
    seg = torch.linalg.norm(Xe - Xs, dim=-1)
    good = (has & (cosp < 0.998)             # parallax >= ~3.6 deg
            & (ts > 0) & (te > 0)
            & (zs > 0.1) & (zs < 40.0) & (ze > 0.1) & (ze < 40.0)
            & (seg > 0.05) & (seg < 20.0)
            & torch.all(torch.isfinite(Xs), dim=-1)
            & torch.all(torch.isfinite(Xe), dim=-1))
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
    dev = own_T.device
    Kmat = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                        dtype=torch.float32, device=dev)
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

    ln_tri_idx, ln_tri_s, ln_tri_e, ln_tri_good = _line_triangulation(
        own_T, own_ln_uvs, own_ln_uve, own_ln_l2d, own_ln_desc, own_ln_free,
        nb_T, nb_ln_l2d, nb_ln_desc, nb_ln_free, nb_ok, Kmat)

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
