"""Port parity, stage by stage, of the plain versions of K24-K27 (the
matching stage around K3) against the JAX expressions they replace, on the
CPU: K24's projection prologue against the gates of
planarslam_tpu/ops/matching.py::search_by_projection, K25 against its ratio
and mutual tails and _resolve_duplicates, K26 against the frame-to-frame
selection of planarslam_tpu/slam/device_tracker.py::_track_core (a jit of
its lines), K27 against its observation assembly. Inputs are made from
numpy seeds at the tiny configuration's widths and at the default one's
(M = 1024 frame landmarks or 4096 window points, N = 1024 features, 256
window lines, 64 frame lines).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.ops import matching as jmatch
from chip_smoke import (ASSEMBLE_LEVELS, ASSEMBLE_PLANTED,
                        DENORMAL_ROTATIONS, FILTER_KEYS, FRAME_KEYS,
                        FRAME_PLANTED, JAX_EDGE_BINS, SELECT_PLANTED,
                        card_rotation_bins, edge_bin_probe,
                        planted_assemble_problem, planted_frame_lanes,
                        planted_select_lanes, rotation_edge_values)
from planarslam_tpu_torch.ops import lax_compat
from planarslam_tpu_torch.ops import matching as tmatch

torch.set_num_threads(2)

CONFIGS = {"tiny": jconfig.SystemConfig.tiny(),
           "full": jconfig.SystemConfig()}
WINDOW_POINTS, WINDOW_LINES = 4096, 256
MARGIN = 1e-3  # integers are compared away from this margin of a threshold


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _camera(cfg):
    cam = cfg.camera
    return ((cam.fx, cam.fy, cam.cx, cam.cy),
            (float(cam.width), float(cam.height)), cam.bf)


# ---------------------------------------------------------------------------
# K24


def _jax_prologue(pts_w, valid_pts, T_cw, K, image_wh, bf, scale_factor,
                  radius, view_normals=None, dist_range=None):
    """planarslam_tpu/ops/matching.py:142-179 and the radius and ur_pred
    lines after them, returning the values its decisions rest on."""
    w_img, h_img = image_wh
    pc = jse3.transform_points(T_cw, pts_w)
    z = pc[:, 2]
    uv = jse3.project(K, pc)
    in_front = z > 0.05
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < w_img) &
              (uv[:, 1] >= 0) & (uv[:, 1] < h_img))
    gate_pt = valid_pts & in_front & in_img
    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    vec = pts_w - cam_center[None, :]
    dist = jnp.linalg.norm(vec, axis=-1).clip(1e-6)
    out = {"z": z, "dist": dist}
    if dist_range is not None:
        dmin, dmax = dist_range
        gate_pt = gate_pt & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
        out["level_arg"] = (jnp.log(jnp.clip(dmax / dist, 1.0, None))
                            / jnp.log(scale_factor))
        pred_level = jnp.ceil(out["level_arg"]).astype(jnp.int32)
    else:
        pred_level = jnp.zeros_like(z, dtype=jnp.int32)
    if view_normals is not None:
        out["cosv"] = jnp.sum(vec * view_normals, axis=-1) / dist
        gate_pt = gate_pt & (out["cosv"] > 0.5)
    r = radius * scale_factor ** pred_level.astype(jnp.float32)
    ur_pred = uv[:, 0] - bf / jnp.maximum(z, 1e-6)
    out.update(a_uv=uv, a_r=r, a_level=pred_level, a_ur_pred=ur_pred,
               gate_pt=gate_pt)
    return {k: np.asarray(v) for k, v in out.items()}


def _landmarks(rng, m, K, image_wh, window):
    """m landmarks around a random camera: most in view, some behind it or
    outside the image; for the window, normals and distance ranges that
    turn some gates."""
    R = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(0, 0.5, 3)
    (fx, fy, cx, cy), (w, h) = K, image_wh
    uv = rng.uniform([-0.1 * w, -0.1 * h], [1.1 * w, 1.1 * h], (m, 2))
    z = np.where(rng.random(m) < 0.9, rng.uniform(0.3, 6.0, m),
                 rng.uniform(-1.0, 0.1, m))
    pc = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
    T_wc = np.linalg.inv(T.astype(np.float64))
    pts = (pc @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)
    valid = rng.random(m) < 0.9
    extra = {}
    if window:
        centre = T_wc[:3, 3]
        dist = np.linalg.norm(pts - centre, axis=1)
        view = (pts - centre) / dist[:, None]
        tilt = rng.normal(0, 0.7, (m, 3))
        normals = view + tilt
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        dmin = dist * rng.uniform(0.5, 1.5, m)
        dmax = dist * rng.uniform(0.5, 2.5, m)
        extra = dict(view_normals=normals.astype(np.float32),
                     dist_range=(dmin.astype(np.float32),
                                 dmax.astype(np.float32)))
    return pts, valid, T, extra


@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("variant", ["frame", "window"])
def test_project_landmarks_plain_vs_jax(variant, width):
    """K24's plain version against the JAX prologue: floats within 1e-4 px
    or 1e-5 relative; gate_pt and the predicted level exact wherever no
    value they rest on lies within 1e-3 of its threshold."""
    cfg = CONFIGS[width]
    K, wh, bf = _camera(cfg)
    m = WINDOW_POINTS if variant == "window" else cfg.orb.max_keypoints
    rng = np.random.default_rng(24 + m)
    pts, valid, T, extra = _landmarks(rng, m, K, wh, variant == "window")
    kw = dict(K=K, image_wh=wh, bf=bf, scale_factor=cfg.orb.scale_factor,
              radius=4.0 if variant == "window" else 15.0)
    want = _jax_prologue(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(T), **kw,
        **{k: (jnp.asarray(v) if k == "view_normals"
               else tuple(jnp.asarray(a) for a in v))
           for k, v in extra.items()})
    got = tmatch.project_landmarks_plain(
        _t(pts), _t(valid), _t(T), **kw,
        **{k: (_t(v) if k == "view_normals" else tuple(_t(a) for a in v))
           for k, v in extra.items()})
    w, h = wh
    u, v = want["a_uv"][:, 0], want["a_uv"][:, 1]
    near = ((np.abs(want["z"] - 0.05) < MARGIN)
            | (np.minimum.reduce([np.abs(u), np.abs(u - w), np.abs(v),
                                  np.abs(v - h)]) < MARGIN))
    if variant == "window":
        dmin, dmax = extra["dist_range"]
        arg = want["level_arg"]
        near |= ((np.abs(want["dist"] - 0.8 * dmin) < MARGIN)
                 | (np.abs(want["dist"] - 1.2 * dmax) < MARGIN)
                 | (np.abs(want["cosv"] - 0.5) < MARGIN)
                 | ((arg > 0) & (np.abs(arg - np.round(arg)) < MARGIN)))
    keep = ~near
    assert keep.mean() > 0.95
    gate = got.gate_pt.numpy()
    np.testing.assert_array_equal(gate[keep], want["gate_pt"][keep])
    level = got.a_level.numpy()
    np.testing.assert_array_equal(level[keep], want["a_level"][keep])
    n_seen = want["gate_pt"].sum()
    if variant == "window":  # the range and cosine gates turn some
        assert 0.1 * m < n_seen < 0.5 * valid.sum()
        assert len(np.unique(level[want["gate_pt"]])) >= 3
    else:
        assert n_seen > 0.5 * m
    same = keep & (level == want["a_level"])
    np.testing.assert_allclose(got.a_r.numpy()[same], want["a_r"][same],
                               rtol=1e-5, atol=0)
    seen = want["gate_pt"]
    for f in ("a_uv", "a_ur_pred"):
        np.testing.assert_allclose(getattr(got, f).numpy()[seen],
                                   want[f][seen], rtol=1e-5, atol=1e-4)


def test_project_landmarks_batched_cpu():
    """The K24 wrapper's leading batch on the CPU: each problem as alone."""
    cfg = CONFIGS["full"]
    K, wh, bf = _camera(cfg)
    rng = np.random.default_rng(3)
    probs = [_landmarks(rng, 512, K, wh, True) for _ in range(2)]
    kw = dict(K=K, image_wh=wh, bf=bf, scale_factor=1.2, radius=4.0)
    got = tmatch.project_landmarks(
        _t(np.stack([p[0] for p in probs])),
        _t(np.stack([p[1] for p in probs])),
        _t(np.stack([p[2] for p in probs])), **kw,
        view_normals=_t(np.stack([p[3]["view_normals"] for p in probs])),
        dist_range=tuple(_t(np.stack([p[3]["dist_range"][i] for p in probs]))
                         for i in range(2)))
    for b, (pts, valid, T, extra) in enumerate(probs):
        one = tmatch.project_landmarks_plain(
            _t(pts), _t(valid), _t(T), **kw,
            view_normals=_t(extra["view_normals"]),
            dist_range=tuple(_t(a) for a in extra["dist_range"]))
        for f in one._fields:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f


# ---------------------------------------------------------------------------
# K25


def _jax_select(best, second, best_idx, max_dist, ratio, back, n_targets):
    """The tails of planarslam_tpu/ops/matching.py::search_by_projection
    (:184-189) and ::match_descriptors (:102-109), back given."""
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.astype(jnp.float32)
                   < ratio * second.astype(jnp.float32))
    if back is not None:
        ok = ok & (back[best_idx] == jnp.arange(best.shape[0]))
    idx = jnp.where(ok, best_idx, -1).astype(jnp.int32)
    dist = jnp.where(ok, best, jmatch.INF_DIST).astype(jnp.int32)
    if n_targets is not None:
        idx, dist = jmatch._resolve_duplicates(idx, dist, n_targets)
    return np.asarray(idx), np.asarray(dist)


def _top2_problem(rng, m, n):
    """K3-shaped outputs with many rows per target, exact distance ties and
    ratio tests on their rounding edge (best 9k against second 10k)."""
    best = rng.integers(0, 130, m)
    second = best + rng.integers(0, 40, m)
    edge = rng.random(m) < 0.1
    k = rng.integers(1, 11, m)
    best = np.where(edge, 9 * k, best)
    second = np.where(edge, 10 * k, second)
    second = np.where(rng.random(m) < 0.05, jmatch.INF_DIST, second)
    best_idx = rng.integers(0, n // 4, m)  # ~4 sources per target
    back = rng.integers(0, m, n)
    back[best_idx[: m // 2]] = np.arange(m // 2)  # half of them mutual
    return [a.astype(np.int32) for a in (best, second, best_idx, back)]


# (max_dist, ratio, mutual, resolve): the projection searches of the
# tracking step (ratio 1 -> none), a ratio search, match_descriptors
_SELECT_CASES = {
    "search": (100, None, False, True),
    "search_ratio": (100, 0.8, False, True),
    "descriptors_mutual": (50, 0.9, True, False),
    "descriptors": (50, 0.9, False, False),
}


@pytest.mark.parametrize(
    "case,m", [(c, m) for c in _SELECT_CASES for m in (1024, 4096)]
    + [(c, None) for c in SELECT_PLANTED])
def test_match_select_plain_vs_jax(case, m):
    """K25's plain version against the JAX tails and _resolve_duplicates:
    indices and distances exact; also on chip_smoke.py's planted cases
    (SELECT_PLANTED), every problem of each at B = 4 lane by lane."""
    if case in SELECT_PLANTED:
        _planted_select_vs_jax(case)
        return
    max_dist, ratio, mutual, resolve = _SELECT_CASES[case]
    n = 1024
    best, second, best_idx, back = _top2_problem(np.random.default_rng(m),
                                                 m, n)
    want = _jax_select(jnp.asarray(best), jnp.asarray(second),
                       jnp.asarray(best_idx), max_dist, ratio,
                       jnp.asarray(back) if mutual else None,
                       n if resolve else None)
    got = tmatch.match_select_plain(_t(best), _t(second), _t(best_idx),
                                    max_dist, ratio,
                                    _t(back) if mutual else None,
                                    n if resolve else None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[0] >= 0).sum() > 50
    if resolve:
        kept = want[0][want[0] >= 0]
        assert len(np.unique(kept)) == len(kept)


def _planted_select_vs_jax(case):
    """Every problem of a planted K25 case, four seeds: the plain version
    equal to the JAX tails lane by lane, and the wrapper's B = 4 equal to
    it. On `mutual_range` JAX reads back[-1] for a best_idx of -1 and
    back[N - 1] for one of N and above (its indexing wraps and clamps),
    where the port finds no transposed match; the case's column N - 1
    belongs to another row's mutual pair, so both reject those rows."""
    for p in planted_select_lanes(case, 4):
        stacked = [_t(p[k]) for k in ("best", "second", "best_idx")]
        back4 = None if p["back"] is None else _t(p["back"])
        got4 = tmatch.match_select(*stacked, p["max_dist"], ratio=p["ratio"],
                                   back=back4, n_targets=p["n_targets"])
        for b in range(4):
            lane = [a[b].numpy() for a in stacked]
            back = None if back4 is None else back4[b]
            want = _jax_select(*[jnp.asarray(a) for a in lane],
                               p["max_dist"], p["ratio"],
                               None if back is None else jnp.asarray(
                                   back.numpy()), p["n_targets"])
            got = tmatch.match_select_plain(*[_t(a) for a in lane],
                                            p["max_dist"], p["ratio"], back,
                                            p["n_targets"])
            for g, g4, w in zip(got, got4, want):
                np.testing.assert_array_equal(g.numpy(), w)
                assert torch.equal(g4[b], g)
            if p["n_targets"] is not None:
                kept = want[0][want[0] >= 0]
                assert len(np.unique(kept)) == len(kept)
    if case == "none_pass":
        assert not (want[0] >= 0).any()
    elif case == "one_target":
        assert (want[0] >= 0).sum() <= 1
    else:
        assert (want[0] >= 0).sum() > 0


def test_match_select_batched_cpu():
    """The K25 wrapper's leading batch on the CPU: each problem as alone."""
    rng = np.random.default_rng(5)
    probs = [_top2_problem(rng, 700, 256) for _ in range(3)]
    stacked = [_t(np.stack(f)) for f in zip(*probs)]
    got = tmatch.match_select(*stacked[:3], 100, ratio=0.9,
                              back=stacked[3], n_targets=256)
    for b, p in enumerate(probs):
        one = tmatch.match_select_plain(*[_t(a) for a in p[:3]], 100, 0.9,
                                        _t(p[3]), 256)
        assert torch.equal(got[0][b], one[0])
        assert torch.equal(got[1][b], one[1])


# ---------------------------------------------------------------------------
# K26


@jax.jit
def _jax_frame_select(proj_idx, bf_idx, angle_src, angle_tgt, uv, u_right,
                      level, scale_factor):
    """planarslam_tpu/slam/device_tracker.py:314-338 over the same inputs."""
    Kp = angle_tgt.shape[0]
    n_proj = jnp.sum(proj_idx >= 0)
    use_bf = n_proj < 20
    ff_idx = jnp.where(use_bf, bf_idx, proj_idx)
    ang_tgt = angle_tgt[jnp.clip(ff_idx, 0, Kp - 1)]
    rot_ok = jmatch.rotation_histogram_filter(angle_src, ang_tgt, ff_idx >= 0)
    ff_idx = jnp.where(rot_ok, ff_idx, -1)
    inv_s2_feat = jnp.power(scale_factor,
                            -2.0 * level.astype(jnp.float32))
    matched_ff = ff_idx >= 0
    fi = jnp.clip(ff_idx, 0, Kp - 1)
    return (ff_idx, uv[fi], jnp.where(matched_ff, u_right[fi], -1.0),
            inv_s2_feat[fi], matched_ff)


def _matches(rng, m, n, count):
    """count matches of m sources onto distinct targets of n, -1 elsewhere."""
    idx = np.full(m, -1)
    src = rng.choice(m, count, replace=False)
    idx[src] = rng.choice(n, count, replace=False)
    return idx.astype(np.int32)


def _frame_problem(rng, n, case):
    """Sources and targets of one frame pair (M = N = n). "projection" and
    "brute_force" put the rotation of most matches in one bin, the rest in
    others; "tied_bins" gives the three largest bins tied counts."""
    proj = _matches(rng, n, n, n // 3 if case != "brute_force" else 12)
    bf = _matches(rng, n, n, n // 4)
    ff = bf if case == "brute_force" else proj
    a_src = rng.uniform(-math.pi, math.pi, n)
    rot = np.where(rng.random(n) < 0.7, 0.3 + rng.normal(0, 0.02, n),
                   rng.uniform(0, 2 * math.pi, n))
    if case == "tied_bins":
        # three bins of equal count ahead of the rest; bin 14 far below 10%
        matched = np.flatnonzero(ff >= 0)
        groups = np.array_split(matched[: 3 * (len(matched) // 3)], 3)
        rot = np.full(n, (14 + 0.5) * 2 * math.pi / 30)
        for g, b in zip(groups, (2, 9, 20)):
            rot[g] = (b + 0.5) * 2 * math.pi / 30
    a_tgt = np.zeros(n)
    a_tgt[ff[ff >= 0]] = a_src[ff >= 0] - rot[ff >= 0]
    a_tgt = np.where(a_tgt == 0, rng.uniform(-math.pi, math.pi, n), a_tgt)
    uv = rng.uniform(0, 640, (n, 2))
    ur = np.where(rng.random(n) < 0.7, uv[:, 0] - 20.0, -1.0)
    level = rng.integers(0, 8, n)
    return (proj, bf, a_src.astype(np.float32), a_tgt.astype(np.float32),
            uv.astype(np.float32), ur.astype(np.float32),
            level.astype(np.int32))


@jax.jit
def _jax_bins(angle_src, angle_tgt):
    """The rotation bins of planarslam_tpu/ops/matching.py:76-78."""
    two_pi = 2.0 * jnp.pi
    rot = jnp.mod(angle_src - angle_tgt, two_pi)
    return jnp.clip((rot * 30 / two_pi).astype(jnp.int32), 0, 29)


def _plain_bins(angle_src, angle_tgt):
    """The rotation bins of the plain version on the CPU
    (matching.rotation_bins, which rotation_histogram_filter_plain and
    frame_match_select_plain take)."""
    return tmatch.rotation_bins(_t(angle_src), _t(angle_tgt)).numpy()


def _planted_frame_vs_jax(case):
    """Every problem of a planted K26 case, four seeds: the plain version
    equal to the jit of device_tracker.py:314-338 lane by lane in every
    row (the bin edges included), and the wrapper's B = 4 equal to it; the
    kept matches as the case plants them."""
    sf = CONFIGS["full"].orb.scale_factor
    table = tmatch.level_inv_sigma2(sf, 8, "cpu")
    for p in planted_frame_lanes(case, 4):
        got4 = tmatch.frame_match_select(*[_t(p[k]) for k in FRAME_KEYS],
                                         table)
        for b in range(4):
            lane = [p[k][b] for k in FRAME_KEYS]
            want = [np.asarray(a) for a in _jax_frame_select(
                *[jnp.asarray(a) for a in lane], jnp.float32(sf))]
            got = tmatch.frame_match_select_plain(*[_t(a) for a in lane],
                                                  table)
            for g4, g in zip(got4, got):
                assert torch.equal(g4[b], g)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
            if p["expect"] is not None:
                assert (want[0] >= 0).sum() == p["expect"]


@pytest.mark.parametrize(
    "case,n", [(c, n) for c in ("projection", "brute_force", "tied_bins")
               for n in (256, 1024)]
    + [(c, None) for c in FRAME_PLANTED if c != "filter"])
def test_frame_match_select_plain_vs_jax(case, n):
    """K26's plain version against a jit of device_tracker.py:314-338:
    matches exact, the gathered uv, u_right and 1/sigma^2 bit-equal; also
    on chip_smoke.py's planted cases (FRAME_PLANTED, frame mode: rotations
    of +0 and -0, just below 0, at the bin edges, ties, the 10% edge, few
    bins, 19 and 20 projection matches, M = 1 and 33, N = 600)."""
    if case in FRAME_PLANTED:
        _planted_frame_vs_jax(case)
        return
    sf = CONFIGS["full"].orb.scale_factor
    prob = _frame_problem(np.random.default_rng(n), n, case)
    want = [np.asarray(a) for a in _jax_frame_select(
        *[jnp.asarray(a) for a in prob], jnp.float32(sf))]
    table = tmatch.level_inv_sigma2(sf, 8, "cpu")
    got = tmatch.frame_match_select_plain(*[_t(a) for a in prob], table)
    np.testing.assert_array_equal(got.ff_idx.numpy(), want[0])
    np.testing.assert_array_equal(got.uv.numpy(), want[1])
    np.testing.assert_array_equal(got.u_right.numpy(), want[2])
    np.testing.assert_array_equal(got.inv_sigma2.numpy(), want[3])
    np.testing.assert_array_equal(got.valid.numpy(), want[4])
    ff_in = prob[1] if case == "brute_force" else prob[0]
    kept, had = (want[0] >= 0).sum(), (ff_in >= 0).sum()
    assert 0.5 * had < kept < had  # the histogram dropped some, not most


@pytest.mark.parametrize("k", range(5))
def test_rotation_histogram_filter_plain_vs_jax(k):
    """K26's filter mode, the plain version against planarslam_tpu/ops/
    matching.py::rotation_histogram_filter under jit on chip_smoke.py's
    planted filter problems (M = 1, 1024 with the bin edges, 4096 with
    rotations just below 0, 5000, 1024 with the 270 edge values and the
    denormal rotations), four seeds: the kept mask exact in every row, the
    wrapper's B = 4 equal lane by lane, the kept matches as planted."""
    p = planted_frame_lanes("filter", 5)[k]
    got4 = tmatch.rotation_histogram_filter(*[_t(p[key])
                                              for key in FILTER_KEYS])
    jfilter = jax.jit(jmatch.rotation_histogram_filter)
    for b in range(4):
        lane = [p[key][b] for key in FILTER_KEYS]
        want = np.asarray(jfilter(*[jnp.asarray(a) for a in lane]))
        got = tmatch.rotation_histogram_filter_plain(*[_t(a) for a in lane])
        assert torch.equal(got4[b], got)
        np.testing.assert_array_equal(got.numpy(), want)
        if p["expect"] is not None:
            assert want.sum() == p["expect"]
        else:
            assert 0 < want.sum() < lane[2].sum()


def test_rotation_bin_float_forms():
    """The bins of rot * 30 / 2 pi in JAX under jit, in the plain version
    (matching.rotation_bins) and in the card's form (K26 and the plain
    version there, chip_smoke.card_rotation_bins) are equal: on 10^5
    seeded rotations and differences of seeded angles, on the 270 edge
    values (rotation_edge_values: every float32 k 2 pi / 30, the float
    either side, each as it is, less and plus float32 2 pi) and on
    denormal rotations (0 in JAX on the CPU, which flushes them); and
    chip_smoke.JAX_EDGE_BINS, which the card is held to, are JAX's bins of
    the 270."""
    rng = np.random.default_rng(26)
    f32 = np.float32
    rot = rng.uniform(0, 2 * math.pi, 100000).astype(f32)
    a = rng.uniform(-math.pi, 3 * math.pi, (2, 100000)).astype(f32)
    edges = rotation_edge_values()
    assert len(edges) == 270
    for src, tgt in ((rot, np.zeros_like(rot)), (a[0], a[1]),
                     (edges, np.zeros_like(edges)),
                     (DENORMAL_ROTATIONS, np.zeros_like(DENORMAL_ROTATIONS))):
        jb = np.asarray(_jax_bins(jnp.asarray(src), jnp.asarray(tgt)))
        np.testing.assert_array_equal(_plain_bins(src, tgt), jb)
        np.testing.assert_array_equal(
            card_rotation_bins((src - tgt).astype(f32)), jb)
    np.testing.assert_array_equal(
        np.asarray(_jax_bins(jnp.asarray(edges), jnp.zeros(270, f32))),
        np.array(JAX_EDGE_BINS))
    np.testing.assert_array_equal(
        np.asarray(_jax_bins(jnp.asarray(DENORMAL_ROTATIONS),
                             jnp.zeros(len(DENORMAL_ROTATIONS), f32))), 0)


def test_edge_bin_probe_reads_the_bins():
    """chip_smoke.edge_bin_probe, which reads K26's bins of the 270 edge
    values and the denormal rotations through its filter mode: with the
    expected bins, JAX's jitted rotation_histogram_filter keeps every
    value's row in both of its lanes, the plain version keeps the same
    rows as JAX in every lane, and with a bin one off a lane drops it."""
    values = np.concatenate([rotation_edge_values(), DENORMAL_ROTATIONS])
    bins = np.array(JAX_EDGE_BINS + (0,) * len(DENORMAL_ROTATIONS))
    jfilter = jax.jit(jax.vmap(jmatch.rotation_histogram_filter))
    for shift in (0, 1):
        probe = edge_bin_probe(values, (bins + shift) % 30)
        want = np.asarray(jfilter(*[jnp.asarray(probe[k])
                                    for k in FILTER_KEYS]))
        got = tmatch.rotation_histogram_filter(*[_t(probe[k])
                                                 for k in FILTER_KEYS])
        np.testing.assert_array_equal(got.numpy(), want)
        both = want[:, 0].reshape(-1, 2).all(axis=1)
        assert both.all() if shift == 0 else not both.any()


# ---------------------------------------------------------------------------
# K27


def _jax_assemble(win_idx, ff_idx, last_xw, win_xyz, feat_valid, feat_ur,
                  feat_level, scale_factor, lm_idx, ln_sw, ln_ew, line_valid):
    """planarslam_tpu/slam/device_tracker.py:352-362 (lines) and :406-428
    (points) over the same inputs."""
    Kp, Lf = feat_valid.shape[0], line_valid.shape[0]
    ln_slot = jnp.full((Lf,), -1, jnp.int32)
    wl_ids = jnp.arange(ln_sw.shape[0], dtype=jnp.int32)
    tgt_l = jnp.clip(lm_idx, 0, Lf - 1)
    ln_slot = ln_slot.at[tgt_l].max(jnp.where(lm_idx >= 0, wl_ids, -1))
    has_ln = ln_slot >= 0
    lslot = jnp.clip(ln_slot, 0, ln_sw.shape[0] - 1)
    lines = (ln_slot, ln_sw[lslot], ln_ew[lslot],
             jnp.ones((Lf,), jnp.float32), has_ln & line_valid)

    n_win = win_idx.shape[0]
    feat_slot = jnp.full((Kp,), -1, jnp.int32)
    w_ids = jnp.arange(n_win, dtype=jnp.int32)
    tgt = jnp.clip(win_idx, 0, Kp - 1)
    feat_slot = feat_slot.at[tgt].max(jnp.where(win_idx >= 0, w_ids, -1))
    has_slot = feat_slot >= 0
    slot = jnp.clip(feat_slot, 0, n_win - 1)
    matched_ff = ff_idx >= 0
    fi_safe = jnp.where(matched_ff, ff_idx, Kp)
    ff_xw = jnp.zeros((Kp, 3), jnp.float32).at[fi_safe].set(
        last_xw, mode="drop")
    ff_feat_valid = jnp.zeros((Kp,), bool).at[fi_safe].set(True, mode="drop")
    obs2_valid = (has_slot | ff_feat_valid) & feat_valid
    inv_s2_feat = jnp.power(scale_factor,
                            -2.0 * feat_level.astype(jnp.float32))
    points = (feat_slot, jnp.where(has_slot[:, None], win_xyz[slot], ff_xw),
              jnp.where(obs2_valid, feat_ur, -1.0), inv_s2_feat, obs2_valid)
    return ([np.asarray(a) for a in points], [np.asarray(a) for a in lines])


def _assembly_problem(rng, n, n_lines, n_levels):
    """The window search's matches (4096 points onto n features, the line
    search's 256 lines onto n_lines), frame-to-frame matches of n sources,
    with a planted clash in each: two window points, two window lines and
    two sources on one target."""
    win_idx = _matches(rng, WINDOW_POINTS, n, n // 2)
    win_idx[np.flatnonzero(win_idx < 0)[:2]] = 7
    ff_idx = _matches(rng, n, n, n // 2)
    ff_idx[np.flatnonzero(ff_idx < 0)[:2]] = ff_idx[ff_idx >= 0][0]
    lm_idx = _matches(rng, WINDOW_LINES, n_lines, n_lines // 2)
    lm_idx[np.flatnonzero(lm_idx < 0)[:2]] = 3
    f = np.float32
    return dict(
        win_idx=win_idx, ff_idx=ff_idx,
        last_xw=rng.normal(0, 2, (n, 3)).astype(f),
        win_xyz=rng.normal(0, 2, (WINDOW_POINTS, 3)).astype(f),
        feat_valid=rng.random(n) < 0.95,
        feat_ur=np.where(rng.random(n) < 0.7, rng.uniform(0, 600, n),
                         -1.0).astype(f),
        feat_level=rng.integers(0, n_levels, n).astype(np.int32),
        lm_idx=lm_idx, ln_sw=rng.normal(0, 2, (WINDOW_LINES, 3)).astype(f),
        ln_ew=rng.normal(0, 2, (WINDOW_LINES, 3)).astype(f),
        line_valid=rng.random(n_lines) < 0.9)


@pytest.mark.parametrize("width", ["tiny", "full"] + [
    f"planted_{c}" for c in ASSEMBLE_PLANTED])
def test_assemble_observations_plain_vs_jax(width):
    """K27's plain versions against device_tracker.py:352-362 and
    :406-428: slots, gathers and validity exact, a planted clash included
    (the window's .at[].max takes the largest point or line, the temporal
    .at[].set the last source, which K27 makes the largest); also on
    chip_smoke's ASSEMBLE_PLANTED problems (several window rows on a
    target, temporal clashes, window and temporal on one target, targets
    of -1, -7, n, n + 1 and far above n, clamped by the window's .at[].max
    and dropped by the temporal mode="drop", no match, W = 1 and N = 1, W
    = 256 onto 64, N = MAX_TARGETS, W = 5000 with M = 2000 and N = 1500),
    the line mode on the same window indices."""
    if width.startswith("planted_"):
        p = planted_assemble_problem(width[len("planted_"):])
        p["lm_idx"] = p["win_idx"]
        n_levels, sf = ASSEMBLE_LEVELS, 1.2
    else:
        cfg = CONFIGS[width]
        n, n_lines = cfg.orb.max_keypoints, cfg.lines.max_lines
        n_levels, sf = cfg.orb.n_levels, cfg.orb.scale_factor
        p = _assembly_problem(np.random.default_rng(n), n, n_lines,
                              n_levels)
    want_pts, want_lns = _jax_assemble(
        *[jnp.asarray(p[k]) for k in (
            "win_idx", "ff_idx", "last_xw", "win_xyz", "feat_valid",
            "feat_ur", "feat_level")], jnp.float32(sf),
        *[jnp.asarray(p[k]) for k in ("lm_idx", "ln_sw", "ln_ew",
                                      "line_valid")])
    table = tmatch.level_inv_sigma2(sf, n_levels, "cpu")
    pts = tmatch.assemble_point_obs_plain(
        *[_t(p[k]) for k in ("win_idx", "ff_idx", "last_xw", "win_xyz",
                             "feat_valid", "feat_ur", "feat_level")], table)
    for f, w in zip(("feat_slot", "xw", "u_right", "inv_sigma2", "valid"),
                    want_pts):
        np.testing.assert_array_equal(getattr(pts, f).numpy(), w, err_msg=f)
    lns = tmatch.assemble_line_obs_plain(
        *[_t(p[k]) for k in ("lm_idx", "ln_sw", "ln_ew", "line_valid")])
    for g, w in zip(lns, want_lns):
        np.testing.assert_array_equal(g.numpy(), w)
    if width.startswith("planted_"):
        return
    # the clashes took effect: the largest window point and line won, and
    # the clashing sources' target carries the larger source's landmark
    assert pts.feat_slot[7] == np.flatnonzero(p["win_idx"] == 7).max()
    assert lns.ln_slot[3] == np.flatnonzero(p["lm_idx"] == 3).max()
    tgt = p["ff_idx"][p["ff_idx"] >= 0][0]
    src = np.flatnonzero(p["ff_idx"] == tgt)
    assert len(src) == 3
    if pts.feat_slot[tgt] < 0:
        np.testing.assert_array_equal(pts.xw[tgt].numpy(),
                                      p["last_xw"][src.max()])


def test_assemble_observations_batched_cpu():
    """The K27 wrappers' leading batch on the CPU: each problem as alone."""
    rng = np.random.default_rng(27)
    probs = [_assembly_problem(rng, 256, 64, 8) for _ in range(2)]
    table = tmatch.level_inv_sigma2(1.2, 8, "cpu")

    def stack(k):
        return _t(np.stack([q[k] for q in probs]))

    pk = ("win_idx", "ff_idx", "last_xw", "win_xyz", "feat_valid", "feat_ur",
          "feat_level")
    lk = ("lm_idx", "ln_sw", "ln_ew", "line_valid")
    pts = tmatch.assemble_point_obs(*[stack(k) for k in pk], table)
    lns = tmatch.assemble_line_obs(*[stack(k) for k in lk])
    for b, q in enumerate(probs):
        one = tmatch.assemble_point_obs_plain(*[_t(q[k]) for k in pk], table)
        for f in one._fields:
            assert torch.equal(getattr(pts, f)[b], getattr(one, f)), f
        one = tmatch.assemble_line_obs_plain(*[_t(q[k]) for k in lk])
        for f in one._fields:
            assert torch.equal(getattr(lns, f)[b], getattr(one, f)), f
