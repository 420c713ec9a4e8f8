"""Port parity, on the CPU, of the plain versions of K37 (the step's sensor
decode and window casts), K38 (the carried-state lift) and K39 (the
Manhattan seed), and of the packed fuse set, against the JAX package: its
jitted to_gray_depth and packed unpack (planarslam_tpu/slam/
device_tracker.py:145-158, :573-590), unpack_window (:762), _state_from
(:171), ops/manhattan.py::seed_from_plane_normals (:123) and slam/
device_mapper.py's FuseSetInputLayout, fuse_set_step_packed and
run_fuse_set (:327-430). Inputs are made from numpy seeds, with
chip_smoke.py's planted windows and direction sets.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import chip_smoke
from planarslam_tpu import config as jconfig
from planarslam_tpu.ops import manhattan as jmanh
from planarslam_tpu.slam import device_mapper as jdm
from planarslam_tpu.slam import device_tracker as jdt
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.ops import manhattan as tmanh
from planarslam_tpu_torch.slam import device_mapper as tdm
from planarslam_tpu_torch.slam import device_tracker as tdt

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("factor", [5000.0, 1000.0, 5208.0])
def test_depth_decode_all_values_matches_jax(factor):
    """Every uint16 depth value through the port's plain decode (as uint16
    and as the int32 the packed unpack gives) equals JAX's jitted
    to_gray_depth bit for bit: raw times float32(1) / float32(factor),
    the product XLA makes of the division."""
    jcfg = jconfig.SystemConfig()
    jcfg = jcfg.replace(camera=dataclasses.replace(jcfg.camera,
                                                   depth_map_factor=factor))
    tcfg = tconfig.SystemConfig()
    tcfg = tcfg.replace(camera=dataclasses.replace(tcfg.camera,
                                                   depth_map_factor=factor))
    raw = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    gray = np.zeros((256, 256), np.uint8)
    jfn = jax.jit(jdt.to_gray_depth, static_argnames=("cfg",))
    want = np.asarray(jfn(jnp.asarray(gray), jnp.asarray(raw), jcfg)[1])
    for d in (_t(raw.astype(np.int32)), _t(raw.view(np.int16)).view(
            torch.uint16)):
        got = tdt.to_gray_depth(_t(gray), d, tcfg)[1].numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(want).tolist() != _bits(raw.astype(np.float32)
                                         / np.float32(factor)).tolist()


def _jax_decode(frame_u8, win_flat, cfg):
    """The JAX package's step inputs from a packed frame and a window: the
    unpack of fused_track_step_packed, to_gray_depth and unpack_window, in
    one jit."""
    gray = frame_u8[0]
    depth16 = (frame_u8[1].astype(jnp.uint16)
               | (frame_u8[2].astype(jnp.uint16) << 8))
    g, d = jdt.to_gray_depth(gray, depth16, cfg)
    return g, d, jdt.unpack_window(win_flat, cfg)


@pytest.mark.parametrize("shape", [(120, 160), (481, 643)])
def test_decode_step_inputs_plain_matches_jax(shape):
    """decode_step_inputs_plain on seeded packed frames (two lanes) and
    chip_smoke.py's planted windows (flags 0, 0.5, the float above, 1 and
    NaN; cloud counts 0, 1 and 128) against JAX's jitted unpack,
    to_gray_depth and unpack_window: grey and depth bit-equal, the
    window's floats and descriptor bits equal, the flags and cloud counts
    exact; decode_step_inputs on the CPU gives the same."""
    jcfg = jconfig.SystemConfig()
    tcfg = tconfig.SystemConfig()
    rng = np.random.default_rng(37)
    h, w = shape
    frames = np.stack([tdt.pack_frame(
        rng.integers(0, 256, (h, w), dtype=np.uint8),
        rng.integers(0, 65536, (h, w), dtype=np.uint16)) for _ in range(2)])
    wins = np.stack([chip_smoke.planted_window(tcfg, 40 + b)
                     for b in range(2)])
    got = tdt.decode_step_inputs_plain(_t(frames), _t(wins), tcfg)
    again = tdt.decode_step_inputs(frames, wins, tcfg, device="cpu")
    jfn = jax.jit(_jax_decode, static_argnames=("cfg",))
    for b in range(2):
        g, d, win = jfn(jnp.asarray(frames[b]), jnp.asarray(wins[b]), jcfg)
        np.testing.assert_array_equal(_bits(got[0][b].numpy()), _bits(g))
        np.testing.assert_array_equal(_bits(got[1][b].numpy()), _bits(d))
        for name in tdt.DeviceWindow._fields:
            x, y = getattr(got[2], name)[b].numpy(), np.asarray(
                getattr(win, name))
            if name == "pt_desc":
                y = y.view(np.int32)
            if x.dtype == np.float32:
                x, y = _bits(x), _bits(y)
            np.testing.assert_array_equal(x, y, err_msg=name)
    for x, y in zip([again[0], again[1], *again[2]],
                    [got[0], got[1], *got[2]]):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x,
                           y.view(torch.int32) if y.dtype == torch.float32
                           else y)
    flags = got[2].pt_valid.numpy()
    assert 0 < flags.sum() < flags.size


def test_decode_unpacked_frames_matches_packed():
    """The step's unpacked entry (grey uint8 with depth as int32 or
    uint16) and float frames (passed through) give what the packed frames
    give; the window casts are the same."""
    tcfg = tconfig.SystemConfig.tiny()
    rng = np.random.default_rng(38)
    g = rng.integers(0, 256, (2, 120, 160), dtype=np.uint8)
    d = rng.integers(0, 65536, (2, 120, 160), dtype=np.uint16)
    frames = np.stack([tdt.pack_frame(g[b], d[b]) for b in range(2)])
    wins = _t(np.stack([chip_smoke.planted_window(tcfg, 41 + b)
                        for b in range(2)]))
    want = tdt._decode(wins, tcfg, frame=_t(frames))
    for depth in (_t(d.astype(np.int32)), _t(d.view(np.int16)).view(
            torch.uint16)):
        got = tdt._decode(wins, tcfg, gray=_t(g), depth=depth)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
        for x, y in zip(got[2], want[2]):
            assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y)
    got = tdt._decode(wins, tcfg, gray=want[0], depth=want[1])
    assert got[0] is want[0] and got[1] is want[1]


@pytest.mark.parametrize("batch", [1, 3])
def test_lift_state_matches_jax(batch):
    """K38's plain version (lift_state on the CPU, lane by lane) against
    the JAX package's _state_from on seeded features at seeded poses:
    world points within 1e-5 m, the mask exact; _state_from of one lane
    equals lane 0 of the batch."""
    from planarslam_tpu_torch.ops.frontend import PointFeatures

    jcfg = jconfig.SystemConfig()
    tcfg = tconfig.SystemConfig()
    rng = np.random.default_rng(38)
    K = 1024
    uv = rng.uniform(0, [640, 480], (batch, K, 2)).astype(np.float32)
    depth = np.where(rng.random((batch, K)) < 0.8,
                     rng.uniform(0.3, 6, (batch, K)), 0).astype(np.float32)
    valid = rng.random((batch, K)) < 0.9
    T = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 0.3, (batch, 3))
                                        ).as_matrix()
    T[:, :3, 3] = rng.normal(0, 1, (batch, 3))
    pw, has = tdt.lift_state(_t(uv), _t(depth), _t(valid), _t(T), tcfg)
    for b in range(batch):
        pts = types.SimpleNamespace(uv=jnp.asarray(uv[b]),
                                    depth=jnp.asarray(depth[b]),
                                    valid=jnp.asarray(valid[b]))
        want = jdt._state_from(types.SimpleNamespace(points=pts),
                               jnp.asarray(T[b]), None, jcfg)
        np.testing.assert_allclose(pw[b].numpy(), np.asarray(want.pt3d_w),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(has[b].numpy(),
                                      np.asarray(want.valid3d))
    feats = types.SimpleNamespace(points=PointFeatures(
        uv=_t(uv[0]), uv_raw=None, response=None, level=None, angle=None,
        desc=None, depth=_t(depth[0]), u_right=None, valid=_t(valid[0])))
    state = tdt._state_from(feats, _t(T[0]), None, tcfg)
    assert torch.equal(state.pt3d_w.view(torch.int32),
                       pw[0].view(torch.int32))
    assert torch.equal(state.valid3d, has[0])


def _seed_cases():
    """(normals, counts, valid) sets: seeded ones (some valid, some near
    the first axis' perpendicular gate) and the candidate sets of
    chip_smoke.py's planted direction sets (SEED_PLANTED)."""
    rng = np.random.default_rng(39)
    out = {}
    for k in range(4):
        n = rng.normal(size=(80, 3))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        out[f"seeded_{k}"] = (n.astype(np.float32),
                              rng.integers(0, 3000, 80).astype(np.int32),
                              rng.random(80) < 0.4)
    tcfg = tconfig.SystemConfig()
    for case in chip_smoke.SEED_PLANTED:
        (coeffs, count, pl_valid, p3d_s, p3d_e, has_3d, ln_valid, response,
         _, _) = chip_smoke.planted_seed_problem(case, tcfg)
        v = (p3d_e - p3d_s).astype(np.float32)
        ln_len = np.sqrt((v[:, 0] * v[:, 0] + v[:, 2] * v[:, 2])
                         + v[:, 1] * v[:, 1])
        d = v / np.maximum(ln_len, np.float32(1e-9))[:, None]
        out[case] = (np.concatenate([coeffs[:, :3], d]).astype(np.float32),
                     np.concatenate([count, response.astype(np.int32)]),
                     np.concatenate([pl_valid,
                                     has_3d & ln_valid & (ln_len > 0.1)]))
    return out


@pytest.mark.parametrize("case", list(_seed_cases()))
def test_seed_from_plane_normals_matches_jax(case):
    """The port's seed_from_plane_normals against JAX's jitted one on
    seeded and planted candidate sets: R within 1e-5, ok exact; K39's
    plain version (seed_manhattan_plain) gives the same seed on the
    planted frames' full inputs."""
    normals, counts, valid = _seed_cases()[case]
    Rj, okj = jmanh.seed_from_plane_normals(
        jnp.asarray(normals), jnp.asarray(counts), jnp.asarray(valid))
    Rt, okt = tmanh.seed_from_plane_normals(_t(normals), _t(counts),
                                            _t(valid))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5, rtol=0)
    assert bool(okt) == bool(okj)
    if case in chip_smoke.SEED_PLANTED:
        args = chip_smoke.planted_seed_problem(case, tconfig.SystemConfig())
        seed = tmanh.seed_manhattan_plain(*[_t(a) for a in args])
        np.testing.assert_allclose(seed.R_seed.numpy(), np.asarray(Rj),
                                   atol=1e-5, rtol=0)
        assert bool(seed.ok) == bool(okj)
        batched = tmanh.seed_manhattan(*[_t(a)[None] for a in args])
        assert torch.equal(batched.picks[0], seed.picks)
        assert torch.equal(batched.R_seed[0], seed.R_seed)


def _seeded_map(cfg, n_points: int, n_kf: int = 6, seed: int = 21):
    """A map's fuse-set fields, seeded: points in front of n_kf cameras a
    few cm apart, each keyframe's features the points' projections with a
    pixel of noise, their descriptors with 1% of the bits flipped."""
    rng = np.random.default_rng(seed)
    K = cfg.orb.max_keypoints
    cam = cfg.camera
    xyz = rng.uniform([-2, -1.5, 2], [2, 1.5, 5], (n_points, 3))
    desc = rng.integers(0, 2 ** 32, (n_points, 8), dtype=np.uint32)
    poses = np.tile(np.eye(4), (n_kf, 1, 1))
    poses[:, :3, :3] = Rotation.from_rotvec(
        rng.normal(0, 0.02, (n_kf, 3))).as_matrix()
    poses[:, :3, 3] = rng.normal(0, 0.05, (n_kf, 3))
    kf_uv = np.zeros((n_kf, K, 2), np.float32)
    kf_desc = np.zeros((n_kf, K, 8), np.uint32)
    for k in range(n_kf):
        pick = rng.permutation(n_points)[:K]
        pc = xyz[pick] @ poses[k, :3, :3].T + poses[k, :3, 3]
        kf_uv[k] = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                             cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
        kf_uv[k] += rng.normal(0, 1.0, (K, 2))
        kf_desc[k] = desc[pick] ^ (rng.random((K, 8)) < 0.01).astype(
            np.uint32)
    return types.SimpleNamespace(
        pt_xyz=xyz.astype(np.float32), pt_desc=desc,
        pt_valid=rng.random(n_points) < 0.95,
        kf_pose=poses.astype(np.float32), kf_uv=kf_uv, kf_desc=kf_desc,
        kf_level=rng.integers(0, 2, (n_kf, K)).astype(np.int32),
        kf_feat_valid=rng.random((n_kf, K)) < 0.97,
        kf_ur=np.full((n_kf, K), -1, np.float32))


@pytest.mark.parametrize("n_targets", [0, 1, 5])
@pytest.mark.parametrize("n_points", [300, 1500])
def test_fuse_set_packed_matches_jax(n_targets, n_points):
    """The packed fuse set against the JAX package's on a seeded map with
    0, 1 and 5 targets and a landmark set below and above capacity (cut to
    C): the packed buffer's bytes equal to JAX's FuseSetInputLayout.pack,
    fuse_set_step_packed's indices and every entry of run_fuse_set's dict
    equal to JAX's; absent targets' rows all -1."""
    jcfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    m = _seeded_map(tcfg, n_points)
    lm_ids = np.random.default_rng(5).permutation(n_points)
    targets = list(range(1, 1 + n_targets))
    flat, meta = tdm.fuse_set_inputs(m, lm_ids, targets, tcfg)
    nb = meta["nb_ids"]
    ids = meta["lm_ids"]
    want_flat = jdm.FuseSetInputLayout(jcfg).pack({
        "lm_xyz": m.pt_xyz[ids], "lm_desc": m.pt_desc[ids],
        "lm_valid": meta["lm_valid"], "nb_T": m.kf_pose[nb],
        "nb_uv": m.kf_uv[nb], "nb_desc": m.kf_desc[nb],
        "nb_level": m.kf_level[nb], "nb_valid": m.kf_feat_valid[nb],
        "nb_ur": m.kf_ur[nb], "nb_ok": meta["nb_ok"]})
    assert flat.tobytes() == want_flat.tobytes()
    got = tdm.fuse_set_step_packed(flat, tcfg, radius=4.0, device="cpu")
    want = np.asarray(jdm.fuse_set_step_packed(jnp.asarray(flat), jcfg,
                                               radius=4.0))
    np.testing.assert_array_equal(got.numpy(), want)
    res_t = tdm.run_fuse_set(m, lm_ids, targets, tcfg, radius=4.0,
                             device="cpu")
    res_j = jdm.run_fuse_set(m, lm_ids, targets, jcfg, radius=4.0)
    assert sorted(res_t) == sorted(res_j)
    for k in res_j:
        np.testing.assert_array_equal(res_t[k], np.asarray(res_j[k]),
                                      err_msg=k)
    assert (res_t["idx"][n_targets:] == -1).all()
    if n_targets:
        assert (res_t["idx"] >= 0).sum() > 20


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-5, 1e-3, 0.1])
def test_orthonormalize_near_rotation_matches_jax(scale):
    """se3.orthonormalize (K15's and K39's polar factor) against the JAX
    package's SVD projection on seeded rotations perturbed by `scale`: at
    and near a rotation (R^T R's three eigenvalues coincide, where the
    closed-form eigenvectors lost their orthogonality before) and far
    from one; within 1e-5, a rotation (R^T R within 1e-5 of I, det 1)."""
    from planarslam_tpu.geometry import se3 as jse3
    from planarslam_tpu_torch.geometry import se3 as tse3

    rng = np.random.default_rng(int(scale * 1e7) + 3)
    R = Rotation.from_rotvec(rng.normal(0, 1.0, (64, 3))).as_matrix()
    R = (R + scale * rng.normal(size=R.shape)).astype(np.float32)
    got = tse3.orthonormalize(_t(R)).numpy()
    want = np.asarray(jax.vmap(jse3.orthonormalize)(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    eye = np.einsum("bki,bkj->bij", got, got)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def _fake_cuda(shape, dtype=torch.float32):
    """A CUDA-typed tensor that needs no card (no storage behind it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype, device="cuda")


def _k37_k39_calls():
    cfg = tconfig.SystemConfig.tiny()
    f, b = _fake_cuda, torch.bool
    P, L = cfg.planes.max_planes, cfg.lines.max_lines
    Nn = cfg.manhattan.max_normals
    fields = tdt._window_fields(cfg.map.max_planes, cfg.lines.desc_dim)
    S = fields[-1][2] + fields[-1][3]
    return {
        "decode_step_inputs": lambda: tdt._decode(
            f((1, S)), cfg, frame=f((1, 3, 120, 160), torch.uint8)),
        "lift_state": lambda: tdt.lift_state(
            f((1, 256, 2)), f((1, 256)), f((1, 256), b), f((1, 4, 4)), cfg),
        "seed_manhattan": lambda: tmanh.seed_manhattan(
            f((1, P, 4)), f((1, P), torch.int32), f((1, P), b),
            f((1, L, 3)), f((1, L, 3)), f((1, L), b), f((1, L), b),
            f((1, L)), f((1, Nn, 3)), f((1, Nn), b)),
    }


@pytest.mark.parametrize("name", sorted(_k37_k39_calls()))
def test_k37_k39_wrappers_without_card_raise(monkeypatch, name):
    """On CUDA-typed inputs without a card, K37's, K38's and K39's wrappers
    raise (they cannot allocate or build) and never take their plain
    versions."""
    def forbidden(*args, **kw):
        raise AssertionError("a CUDA input reached a plain version")

    for mod, fn in ((tdt, "decode_step_inputs_plain"), (tdt, "unpack_window"),
                    (tdt, "to_gray_depth"), (tdt, "lift_state_plain"),
                    (tmanh, "seed_manhattan_plain")):
        monkeypatch.setattr(mod, fn, forbidden)
    with pytest.raises(Exception) as err:
        _k37_k39_calls()[name]()
    assert "plain version" not in str(err.value)
