"""Port parity of the plain versions of K28-K31 (the rest of the tracking
step) against the JAX expressions they replace, on the CPU: K28's depth
noise scale against the inline median of planarslam_tpu/ops/planes.py::
extract_planes (:243-254), K29's normal chain against box_smooth_depth,
backproject_depth, surface_normals and the padding of
planarslam_tpu/slam/frame.py (:53-63), K30 against
planarslam_tpu/slam/device_tracker.py::_associate_planes_device, K31 against
a jit of the step's tail (:440-500, with _state_from). Inputs are frames of
the synthetic room or are made from numpy seeds, with planted cases; each
wrapper's leading batch is held to its problems alone.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import plane as jplane
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.io import synthetic
from planarslam_tpu.ops import planes as jplanes
from planarslam_tpu.slam import device_tracker as jdt
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.ops import planes as tplanes
from planarslam_tpu_torch.slam import device_tracker as tdt
from planarslam_tpu_torch.slam.frame import _normal_stride

torch.set_num_threads(2)

MARGIN = 1e-3  # float decisions are compared away from this margin


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _room_depth(h, w, i=0, noise=False):
    """Frame i's quantized depth of the synthetic room at h x w (metres),
    with the Kinect noise model when asked."""
    seq = synthetic.make_sequence(i + 1, width=w, height=h,
                                  depth_noise=1.0 if noise else 0.0,
                                  noise_model="kinect")
    d = np.asarray(seq.render(i)[1], np.float32)
    return (np.round(d * 5000.0) / 5000.0).astype(np.float32)


# ---------------------------------------------------------------------------
# K28


@jax.jit
def _jax_alpha(depth):
    """planarslam_tpu/ops/planes.py:243-254 at max_distance 10."""
    z2 = jnp.maximum(depth, 1.0) ** 2
    ok = (depth > 1e-6) & (depth < 10.0)
    d2_r = jnp.abs(depth - 2 * jnp.roll(depth, -1, axis=1)
                   + jnp.roll(depth, -2, axis=1))
    interior = ok & jnp.roll(ok, -1, axis=1) & jnp.roll(ok, -2, axis=1)
    sub_r = jnp.where(interior, d2_r / z2, jnp.nan)[::4, ::4]
    alpha = jnp.nanmedian(sub_r) / (0.674 * jnp.sqrt(6.0))
    return jnp.nan_to_num(alpha, nan=0.0), jnp.sum(~jnp.isnan(sub_r))


def _alpha_case(case):
    """Depth maps for K28: the room clean and noisy at 640x480 (the 160x120
    room is held in test_torch_planes_lines_manhattan.py) and chip_smoke.py's
    planted cases."""
    if not case.startswith("room"):
        return chip_smoke.planted_alpha_depth(case)
    return _room_depth(480, 640, 3, case.endswith("noisy"))


ALPHA_CASES = ["room_clean", "room_noisy", *chip_smoke.ALPHA_CASES]


@pytest.mark.parametrize("case", ALPHA_CASES)
def test_noise_alpha_plain_vs_jax(case):
    """K28's plain version against the JAX median: rtol 1e-6, 0 without a
    valid sample."""
    depth = _alpha_case(case)
    want, n = (np.asarray(a) for a in _jax_alpha(jnp.asarray(depth)))
    got = tplanes.noise_alpha_plain(_t(depth), 10.0)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if case == "empty":
        assert n == 0 and float(got) == 0.0
    if case in ("even", "odd"):
        assert n == (100 if case == "even" else 99)
    if case == "flat":
        assert n > 0 and float(got) == 0.0
    if case.startswith("room") or case == "duplicates":
        assert float(want) > 0.0
    # the middle two samples' bits: "split" in two top 11-bit digits (the
    # kernel's neighbour pass), "pair" in one 22-bit prefix (its last
    # pass's counts)
    bits = np.sort(chip_smoke.alpha_samples(depth)).view(np.uint32)
    assert len(bits) == n
    if case == "split":
        assert n == 100 and bits[49] >> 21 != bits[50] >> 21
    if case == "pair":
        assert n == 2 and bits[0] != bits[1] and bits[0] >> 10 == bits[1] >> 10
    if case == "wide":
        assert depth.shape == (960, 1280) and n > 19200


def test_noise_alpha_batched_cpu():
    """The K28 wrapper's leading batch on the CPU: each frame as alone."""
    frames = np.stack([_room_depth(120, 160, 3),
                       _room_depth(120, 160, 3, noise=True)])
    got = tplanes._noise_alpha(_t(frames), 10.0)
    assert got.shape == (2,)
    for b in range(2):
        assert torch.equal(got[b], tplanes.noise_alpha_plain(_t(frames[b]),
                                                             10.0))
    assert got[0] != got[1]


# ---------------------------------------------------------------------------
# K29


def _jax_normals(depth, cfg, stride, budget):
    """planarslam_tpu/slam/frame.py:53-63 over the same depth."""
    d = jplanes.box_smooth_depth(jnp.asarray(depth),
                                 cfg.planes.smooth_window)
    n, v = jplanes.surface_normals(
        jplanes.backproject_depth(d, cfg.camera), stride=stride)
    n = n.reshape(-1, 3)
    v = v.reshape(-1)
    if n.shape[0] < budget:
        n = jnp.pad(n, ((0, budget - n.shape[0]), (0, 0)))
        v = jnp.pad(v, (0, budget - v.shape[0]))
    return np.asarray(n[:budget]), np.asarray(v[:budget])


def _config(h, w, budget):
    """The tiny configuration's camera at h x w with `budget` normals, in
    both packages."""
    return [mod.SystemConfig.tiny(height=h, width=w).replace(
        manhattan=dataclasses.replace(mod.SystemConfig().manhattan,
                                      max_normals=budget))
            for mod in (jconfig, tconfig)]


# (h, w, budget): strides 13 (37 x 49 = 1813 samples cut to 1764), 7
# (34 x 45 padded to 2048), 4 (30 x 40 padded; the first row and column of
# samples have windows that wrap around the image: off = 2 < b = 3) and 1
# (a 40 x 30 image padded)
NORMAL_CASES = {"stride13_cut": (480, 640, 1764),
                "stride7": (240, 320, 2048), "stride4": (120, 160, 2048),
                "stride1": (30, 40, 2048)}


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("case", list(NORMAL_CASES))
def test_frame_normals_plain_vs_jax(case, noise):
    """K29's plain version against the JAX chain and padding: validity
    exact, normals atol 1e-5 on the valid rows, the padding zero and
    False."""
    h, w, budget = NORMAL_CASES[case]
    jc, tc = _config(h, w, budget)
    stride = _normal_stride(tc)
    assert stride == int(case[6:].split("_")[0])
    depth = _room_depth(h, w, 2, noise)
    want_n, want_v = _jax_normals(depth, jc, stride, budget)
    got_n, got_v = tplanes.frame_normals_plain(
        _t(depth), tc.camera, tc.planes.smooth_window, stride, budget)
    assert got_n.shape == (budget, 3) and got_v.dtype == torch.bool
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_allclose(got_n.numpy()[want_v], want_n[want_v],
                               atol=1e-5)
    off = stride // 2 if stride > 1 else 0
    step = max(stride, 1)
    grid = len(range(off, h, step)) * len(range(off, w, step))
    assert want_v.sum() > 0.3 * min(grid, budget)
    if grid < budget:
        assert not got_v[grid:].any() and not got_n[grid:].any()


def test_frame_normals_batched_cpu():
    """The K29 wrapper's leading batch on the CPU: each frame as alone."""
    _, tc = _config(240, 320, 2048)
    frames = np.stack([_room_depth(240, 320, i) for i in (0, 5)])
    args = (tc.camera, 5, 7, 2048)
    n, v = tplanes.frame_normals(_t(frames), *args)
    assert n.shape == (2, 2048, 3) and v.shape == (2, 2048)
    for b in range(2):
        n1, v1 = tplanes.frame_normals_plain(_t(frames[b]), *args)
        assert torch.equal(n[b], n1) and torch.equal(v[b], v1)
    assert not torch.equal(n[0], n[1])


# ---------------------------------------------------------------------------
# K30


PLANE_KEYS = chip_smoke.PLANE_KEYS


def _jax_assoc(p, cfg):
    feats = SimpleNamespace(planes=SimpleNamespace(
        coeffs=jnp.asarray(p["coeffs"]), valid=jnp.asarray(p["valid"])))
    win = SimpleNamespace(**{k: jnp.asarray(p[k]) for k in PLANE_KEYS[3:]})
    return [np.asarray(a) for a in jdt._associate_planes_device(
        feats, jnp.asarray(p["T_cw"]), win, cfg)]


@pytest.mark.parametrize("case", chip_smoke.PLANE_CASES)
def test_associate_planes_plain_vs_jax(case):
    """K30's plain version against the JAX PlaneMatcher on chip_smoke.py's
    planted associations: indices exact, pi_w atol 1e-6, the three
    observation blocks the map planes gathered."""
    jc = jconfig.SystemConfig()
    tc = tconfig.SystemConfig()
    p = chip_smoke.planted_plane_problem(np.random.default_rng(30), case)
    want = _jax_assoc(p, jc)
    got = tdt._associate_planes_plain(*[_t(p[k]) for k in PLANE_KEYS],
                                      tc.planes)
    for g, w in zip((got.direct, got.par, got.ver), want[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(got.pi_w.numpy(), want[3], atol=1e-6)
    ids = np.stack(want[:3])
    np.testing.assert_array_equal(
        got.obs_pi_w.numpy(), p["pl_coeffs"][np.clip(ids, 0, 127)])
    np.testing.assert_array_equal(got.obs_valid.numpy(),
                                  (ids >= 0) & p["valid"][None])
    direct, par, ver = want[:3]
    if case == "no_map":
        assert (ids == -1).all()
        return
    assert (direct >= 0).sum() >= 4 and (par >= 0).any() and (ver >= 0).any()
    if case == "tie":
        assert 5 in direct and 9 not in direct
    if case == "self_parallel":
        assert direct[0] == 0 and par[0] in (40, 50)
    if case == "empty_cloud":
        assert 3 not in direct and par[2] in (3, 42)
    if case == "invalid_near":  # it would win frame plane 0 were it valid
        assert direct[0] == 0 and 100 not in ids
        flip = dict(p, pl_valid=p["pl_valid"].copy())
        flip["pl_valid"][100] = True
        alt = tdt._associate_planes_plain(*[_t(flip[k]) for k in PLANE_KEYS],
                                          tc.planes)
        assert int(alt.direct[0]) == 100
    if case == "cloud_n_range":
        assert 4 not in direct and par[4] == 4
        assert direct[6] == 6 and direct[7] == 7
    if case == "nan_point":
        assert 5 not in direct and par[5] == 5
    if case == "invalid_frame":
        assert (ids[:, 1::2] == -1).all()
        assert not got.obs_valid.numpy()[:, 1::2].any()


def test_associate_planes_batched_cpu():
    """The K30 wrapper's leading batch on the CPU: each step as alone."""
    tc = tconfig.SystemConfig()
    probs = [chip_smoke.planted_plane_problem(np.random.default_rng(s), c)
             for s, c in ((1, "random"), (2, "tie"))]
    got = tdt._associate_planes_device(
        *[_t(np.stack([q[k] for q in probs])) for k in PLANE_KEYS],
        tc.planes)
    for b, q in enumerate(probs):
        one = tdt._associate_planes_plain(*[_t(q[k]) for k in PLANE_KEYS],
                                          tc.planes)
        for f in one._fields:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f


# ---------------------------------------------------------------------------
# K31


def _tail_problem(rng, cfg, final_ok=True):
    """chip_smoke.py's random tail as a StepTail of numpy arrays."""
    t = chip_smoke.random_tail_problem(rng, cfg, final_ok)
    return tdt.StepTail(*[np.asarray(t[f]) for f in tdt.StepTail._fields])


def _jax_tail(t, cfg):
    """planarslam_tpu/slam/device_tracker.py:440-500 over the same inputs;
    returns the unpacked bundle, the new state's world points and mask,
    the new velocity and the uv of the window points and line midpoints
    (their decisions rest on them)."""
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    j = {k: jnp.asarray(v) for k, v in t._asdict().items()}
    ok2 = j["n_in2"] >= cfg.tracking.min_matches_local_map // 2
    T_out = jnp.where(ok2, j["T_cand"], j["T1"])
    inl = j["inl"]
    has_slot = j["feat_slot"] >= 0
    feat_slot_out = jnp.where(inl | ~has_slot, j["feat_slot"], -1)
    ln_win_found = (j["lm_idx"] >= 0).astype(jnp.int32)
    mid_ln = 0.5 * (j["ln_sw"] + j["ln_ew"])
    pc_ln = jse3.transform_points(T_out, mid_ln)
    uv_ln = jse3.project(K, pc_ln)
    ln_win_visible = (j["ln_valid"] & (pc_ln[:, 2] > 0.05)
                      & (uv_ln[:, 0] >= 0) & (uv_ln[:, 0] < cam.width)
                      & (uv_ln[:, 1] >= 0) & (uv_ln[:, 1] < cam.height)
                      ).astype(jnp.int32)
    win_found = (j["win_idx"] >= 0).astype(jnp.int32)
    pc_win = jse3.transform_points(T_out, j["win_xyz"])
    uv_win = jse3.project(K, pc_win)
    win_visible = (j["win_valid"] & (pc_win[:, 2] > 0.05)
                   & (uv_win[:, 0] >= 0) & (uv_win[:, 0] < cam.width)
                   & (uv_win[:, 1] >= 0) & (uv_win[:, 1] < cam.height)
                   ).astype(jnp.int32)
    depth = j["pt_depth"]
    close = (depth > 0) & (depth < cam.depth_threshold)
    tracked = j["obs2_valid"] & inl
    kf_stats = jnp.stack([
        jnp.sum((close & tracked).astype(jnp.float32)),
        jnp.sum((close & ~tracked & j["pt_valid"]).astype(jnp.float32)),
        jnp.sum((depth > 0).astype(jnp.float32)),
        jnp.sum(tracked.astype(jnp.float32))])
    layout = jdt.BundleLayout(cfg)
    packed = jdt._pack(
        layout, T_out=T_out, R_cm=j["R_cm"],
        flags=jnp.stack([j["manh_success"].astype(jnp.float32),
                         j["use_manh"].astype(jnp.float32),
                         j["n_in1"].astype(jnp.float32),
                         j["n_in2"].astype(jnp.float32)]),
        ff_idx=j["ff_idx"], win_idx=feat_slot_out,
        pt_inlier=inl.astype(jnp.int32), win_found=win_found,
        win_visible=win_visible, ln_win_idx=j["ln_slot"],
        ln_win_found=ln_win_found, ln_win_visible=ln_win_visible,
        pl_direct=j["pl_direct"], pl_par=j["pl_par"], pl_ver=j["pl_ver"],
        pl_coeffs_w=jplane.transform(jse3.T_inv(T_out), j["pl_coeffs"]),
        pl_valid=j["pl_valid"].astype(jnp.int32), kf_stats=kf_stats)
    feats = SimpleNamespace(points=SimpleNamespace(
        depth=depth, valid=j["pt_valid"], uv=j["pt_uv"]))
    state = jdt._state_from(feats, T_out, None, cfg)
    vel = T_out @ jse3.T_inv(j["T_last"])
    return (layout.unpack(np.asarray(packed)), np.asarray(state.pt3d_w),
            np.asarray(state.valid3d), np.asarray(vel),
            np.asarray(pc_win), np.asarray(uv_win), np.asarray(pc_ln),
            np.asarray(uv_ln))


def _near_view_edge(pc, uv, w, h):
    """Rows whose in-view decision rests on a value within MARGIN of its
    threshold."""
    return ((np.abs(pc[:, 2] - 0.05) < MARGIN)
            | (np.minimum.reduce([np.abs(uv[:, 0]), np.abs(uv[:, 0] - w),
                                  np.abs(uv[:, 1]),
                                  np.abs(uv[:, 1] - h)]) < MARGIN))


INT_FIELDS = ("ff_idx", "win_idx", "pt_inlier", "win_found", "ln_win_idx",
              "ln_win_found", "pl_direct", "pl_par", "pl_ver", "pl_valid")


def _small_jax_config(jc):
    """The JAX configuration of chip_smoke._small_tail_config."""
    return dataclasses.replace(
        jc, orb=dataclasses.replace(jc.orb, max_keypoints=1000),
        lines=dataclasses.replace(jc.lines, max_lines=60),
        planes=dataclasses.replace(jc.planes, max_planes=13))


def _tail_vs_jax(t, tc, jc):
    """K31's plain version on one tail (a StepTail of numpy arrays) against
    the JAX tail: integer fields exact (the visible flags away from MARGIN
    of the frustum's edges), the keyframe counts and flags exact, floats
    atol 1e-5, the final pose the one n_in2 picks, the carried world
    points atol 1e-5 m and their mask exact, the velocity atol 1e-5.
    Returns the plain version's outputs, its unpacked bundle, the JAX
    bundle and, per visible flag, the rows compared."""
    want, pt3d_w, valid3d, vel, pc_w, uv_w, pc_l, uv_l = _jax_tail(t, jc)
    out = tdt.finish_step_plain(tdt.StepTail(*[_t(np.asarray(x))
                                               for x in t]), tc)
    got = tdt.BundleLayout(tc).unpack(out.packed.numpy())
    for name in INT_FIELDS + ("kf_stats", "flags"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    w, h = tc.camera.width, tc.camera.height
    kept = {}
    for name, pc, uv in (("win_visible", pc_w, uv_w),
                         ("ln_win_visible", pc_l, uv_l)):
        kept[name] = ~_near_view_edge(pc, uv, w, h)
        np.testing.assert_array_equal(got[name][kept[name]],
                                      want[name][kept[name]])
    for name in ("T_out", "R_cm", "pl_coeffs_w"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   err_msg=name)
    final = t.n_in2 >= tc.tracking.min_matches_local_map // 2
    np.testing.assert_array_equal(got["T_out"], t.T_cand if final else t.T1)
    np.testing.assert_array_equal(out.T_out.numpy(), got["T_out"])
    np.testing.assert_allclose(out.pt3d_w.numpy(), pt3d_w, atol=1e-5)
    np.testing.assert_array_equal(out.valid3d.numpy(), valid3d)
    np.testing.assert_allclose(out.velocity.numpy(), vel, atol=1e-5)
    return out, got, want, kept


def _small_jax_config(jc):
    """The JAX configuration of chip_smoke._small_tail_config."""
    return dataclasses.replace(
        jc, orb=dataclasses.replace(jc.orb, max_keypoints=1000),
        lines=dataclasses.replace(jc.lines, max_lines=60),
        planes=dataclasses.replace(jc.planes, max_planes=13))


def _planted_tail_vs_jax(case):
    """Every problem of a planted K31 case, four seeds: _tail_vs_jax lane
    by lane, the planted window rows' and line midpoints' flags exactly
    chip_smoke.view_f32's (the float order of the plain version at the
    frustum's edges), and the wrapper's B = 4 equal to it."""
    jc, tc = jconfig.SystemConfig(), tconfig.SystemConfig()
    for c, t, lane_plants in chip_smoke.planted_tail_lanes(case, tc, 4):
        got4 = tdt.finish_step(tdt.StepTail(*[
            _t(t[f]) for f in tdt.StepTail._fields]), c)
        for b, plants in enumerate(lane_plants):
            lane = tdt.StepTail(*[np.asarray(t[f][b])
                                  for f in tdt.StepTail._fields])
            out, got, _, _ = _tail_vs_jax(
                lane, c, jc if c is tc else _small_jax_config(jc))
            assert torch.equal(got4.packed[b].view(torch.int32),
                               out.packed.view(torch.int32))
            for f in out._fields[1:]:
                assert torch.equal(getattr(got4, f)[b], getattr(out, f)), f
            if "visible" in plants:
                vis = chip_smoke.view_f32(lane.T_cand, lane.win_xyz[
                    plants["rows"]], c.camera)[0]
                np.testing.assert_array_equal(
                    got["win_visible"][plants["rows"]], vis)
                np.testing.assert_array_equal(
                    got["ln_win_visible"][plants["lines"]], vis)
            if "final" in plants:
                assert bool(np.array_equal(got["T_out"], lane.T_cand)) \
                    == plants["final"]


@pytest.mark.parametrize("final_ok", [True, False,
                                      *chip_smoke.TAIL_PLANTED])
def test_finish_step_plain_vs_jax(final_ok):
    """K31's plain version against the JAX tail (_tail_vs_jax states the
    tolerances) on a random tail, the final pose kept and not; most rows
    away from the frustum's edges, a share of each visible flag set, the
    keyframe counts ordered. Also on chip_smoke.py's planted cases
    (TAIL_PLANTED: the frustum's edges, NaN and infinite window
    coordinates, planted depths, every feature tracked, none valid, n_in2
    at min_inliers - 1 and min_inliers, K = 1000 with L = 60 and P =
    13)."""
    if not isinstance(final_ok, bool):
        _planted_tail_vs_jax(final_ok)
        return
    jc, tc = jconfig.SystemConfig(), tconfig.SystemConfig()
    t = _tail_problem(np.random.default_rng(31), tc, final_ok)
    _, got, want, kept = _tail_vs_jax(t, tc, jc)
    for name in ("win_visible", "ln_win_visible"):
        assert kept[name].mean() > 0.99
        assert 0.2 < want[name].mean() < 0.8, name
    assert 0 < got["kf_stats"][0] < got["kf_stats"][2]


def test_finish_step_batched_cpu():
    """The K31 wrapper's leading batch on the CPU: each step as alone."""
    tc = tconfig.SystemConfig()
    probs = [_tail_problem(np.random.default_rng(s), tc, ok)
             for s, ok in ((1, True), (2, False))]
    got = tdt.finish_step(tdt.StepTail(*[
        _t(np.stack([np.asarray(getattr(q, f)) for q in probs]))
        for f in tdt.StepTail._fields]), tc)
    for b, q in enumerate(probs):
        one = tdt.finish_step_plain(tdt.StepTail(*[_t(np.asarray(x))
                                                   for x in q]), tc)
        # the bundle's int32 fields are bit patterns (-1 reads as a NaN)
        assert torch.equal(got.packed[b].view(torch.int32),
                           one.packed.view(torch.int32))
        for f in one._fields[1:]:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f
