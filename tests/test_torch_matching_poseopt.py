"""Port parity: gated Hamming matching (K3's plain version) and the robust
pose-only optimizer with all five residual blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from chip_smoke import _pose_problem
from planarslam_tpu import config as jconfig
from planarslam_tpu.io import synthetic
from planarslam_tpu.ops import matching as jmatch
from planarslam_tpu.slam import frame as jframe
from planarslam_tpu.solvers import pose_opt as jpo
from planarslam_tpu_torch.ops import matching as tmatch
from planarslam_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(2)

JC = jconfig.SystemConfig.tiny()
CAM = JC.camera
K = (CAM.fx, CAM.fy, CAM.cx, CAM.cy)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _pose(rotvec, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def two_frames():
    """Features of two consecutive frames; the first one's with depth
    lifted to world points at its true pose."""
    seq = synthetic.make_sequence(12, width=160, height=120)
    out = []
    for i in (3, 4):
        g, d = seq.render(i)
        f = jframe.extract_frame(jnp.asarray(np.array(g, np.float32)),
                                 jnp.asarray(np.array(d, np.float32)), JC)
        out.append(f)
    Tcw = [np.linalg.inv(seq.poses_wc[i]).astype(np.float32) for i in (3, 4)]
    pts_w = jframe.unproject_points(out[0].points, JC,
                                    seq.poses_wc[3].astype(np.float32))
    return out, Tcw, pts_w


def _proj_args(f0, f1, pts_w, valid):
    p0, p1 = f0.points, f1.points
    return [pts_w, np.asarray(p0.desc), valid, None, np.asarray(p1.uv),
            np.asarray(p1.desc), np.asarray(p1.level), np.asarray(p1.valid),
            np.asarray(p1.u_right)]


@pytest.mark.parametrize("variant", ["frame", "window"])
def test_search_by_projection_parity(variant, two_frames):
    """Projection search (gates + Hamming + top-2 + duplicate resolution):
    match index and distance exact for every landmark whose projection is
    not within 1e-3 px of a window edge."""
    (f0, f1), Tcw, pts_w = two_frames
    T = (_pose([0.004, -0.003, 0.002], [0.005, 0.0, -0.004]) @ Tcw[1])
    valid = np.asarray(f0.points.depth) > 0
    args = _proj_args(f0, f1, pts_w, valid)
    args[3] = T
    kw = dict(K=K, image_wh=(160.0, 120.0), bf=CAM.bf,
              scale_factor=JC.orb.scale_factor, max_dist=JC.matcher.th_high)
    if variant == "frame":
        kw.update(radius=15.0, level_window=JC.orb.n_levels)
        extra_j = extra_t = {}
    else:
        rng = np.random.default_rng(1)
        dist = np.linalg.norm(pts_w - np.linalg.inv(T)[:3, 3], axis=1)
        normals = (pts_w - np.linalg.inv(T)[:3, 3]) / np.maximum(
            dist[:, None], 1e-6)
        dmin = (dist * rng.uniform(0.3, 0.9, dist.shape)).astype(np.float32)
        dmax = (dist * rng.uniform(1.0, 2.0, dist.shape)).astype(np.float32)
        kw.update(radius=4.0, level_window=1)
        extra_j = dict(view_normals=jnp.asarray(normals.astype(np.float32)),
                       dist_range=(jnp.asarray(dmin), jnp.asarray(dmax)))
        extra_t = dict(view_normals=_t(normals.astype(np.float32)),
                       dist_range=(_t(dmin), _t(dmax)))
    rj = jmatch.search_by_projection(*[jnp.asarray(a) for a in args],
                                     **kw, **extra_j)
    rt = tmatch.search_by_projection(*[_t(a) for a in args], **kw, **extra_t)
    idx_j, idx_t = np.asarray(rj.idx), rt.idx.numpy()
    assert (idx_j >= 0).sum() >= 20
    # rows with a candidate within 1e-3 px of its window edge are excluded
    pc = pts_w @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2],
                   K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    du = np.abs(uv[:, None, :] - np.asarray(f1.points.uv)[None, :, :])
    radii = kw["radius"] * JC.orb.scale_factor ** np.arange(
        JC.orb.n_levels + 1)
    keep = ~(np.abs(du[..., None] - radii) < 1e-3).any(axis=(1, 2, 3))
    np.testing.assert_array_equal(idx_t[keep], idx_j[keep])
    np.testing.assert_array_equal(rt.dist.numpy()[keep],
                                  np.asarray(rj.dist)[keep])


def test_match_descriptors_parity(two_frames):
    """Brute-force matching with ratio test and mutual check (two K3
    problems): indices and distances exact."""
    (f0, f1), _, _ = two_frames
    args = [f0.points.desc, f1.points.desc, f0.points.valid, f1.points.valid]
    for mutual in (True, False):
        rj = jmatch.match_descriptors(*args, max_dist=JC.matcher.th_low,
                                      ratio=0.9, mutual=mutual)
        rt = tmatch.match_descriptors(*[_t(a) for a in args],
                                      max_dist=JC.matcher.th_low, ratio=0.9,
                                      mutual=mutual)
        assert (np.asarray(rj.idx) >= 0).sum() > 20
        np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
        np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))


def test_hamming_and_top2_plain(two_frames):
    """K3's plain version against the JAX Hamming matrix and _top2_min,
    ungated: best, second and argmin exact (ties to the lowest index)."""
    (f0, f1), _, _ = two_frames
    a, b = np.asarray(f0.points.desc), np.asarray(f1.points.desc)
    a_ok, b_ok = np.asarray(f0.points.valid), np.asarray(f1.points.valid)
    from planarslam_tpu.ops.orb import hamming_distance
    d = hamming_distance(jnp.asarray(a), jnp.asarray(b))
    d = jnp.where(jnp.asarray(a_ok)[:, None] & jnp.asarray(b_ok)[None, :], d,
                  jmatch.INF_DIST)
    bj, sj, ij = jmatch._top2_min(d)
    bt, st, it = tmatch.gated_hamming_top2_plain(_t(a), _t(b), _t(a_ok),
                                                 _t(b_ok))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("n", [300, 1024])
def test_rotation_filter_and_duplicates(n):
    """Rotation-histogram consistency and duplicate resolution: exact, at a
    small width and at the main path's (1024 matches: K26's filter mode on
    tracking's modular path)."""
    rng = np.random.default_rng(11)
    a_src = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    a_tgt = (a_src - 0.3 + np.where(rng.random(n) < 0.8, 0.0,
                                    rng.uniform(-3, 3, n))).astype(np.float32)
    valid = rng.random(n) < 0.9
    kj = jmatch.rotation_histogram_filter(jnp.asarray(a_src),
                                          jnp.asarray(a_tgt),
                                          jnp.asarray(valid))
    kt = tmatch.rotation_histogram_filter(_t(a_src), _t(a_tgt), _t(valid))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < int(kt.sum()) < int(valid.sum())  # some dropped, not all
    n_tgt = n // 5
    idx = np.where(rng.random(n) < 0.8, rng.integers(0, n_tgt, n), -1)
    dist = rng.integers(0, 40, n)
    ij, dj = jmatch._resolve_duplicates(jnp.asarray(idx, jnp.int32),
                                        jnp.asarray(dist, jnp.int32), n_tgt)
    it, dt = tmatch._resolve_duplicates(_t(idx.astype(np.int32)),
                                        _t(dist.astype(np.int32)), n_tgt)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


# the cases of test_pose_optimize_parity: the problem's size and camera
# (the tiny one, or the default 640x480 one at the main path's widths:
# N = max_keypoints, L = max_lines, P = 16 per plane block) and the blocks
# that take part; "False" and "True" keep their original ids
_FULL = dict(n=1024, n_lines=64, n_planes=16)
_POSE_CASES = {
    "False": (False, {}, "tiny", "all"),
    "True": (True, {}, "tiny", "all"),
    "full-False": (False, _FULL, "full", "all"),
    "full-True": (True, _FULL, "full", "all"),
    "points_only": (False, _FULL, "full", "points"),
    "planes_only": (False, _FULL, "full", "planes"),
    "all_invalid": (False, _FULL, "full", "invalid"),
    "converged": (False, dict(_FULL, start="converged"), "full", "all"),
    "far": (False, dict(_FULL, start="far"), "full", "all"),
}


def _pose_case(case):
    """The problem of a case as numpy inputs: (rotation_fixed, K, bf, T0,
    blocks) with blocks a dict of pose_optimize's keyword lists (absent
    blocks left out)."""
    rotation_fixed, size, cam_name, which = _POSE_CASES[case]
    cam = CAM if cam_name == "tiny" else jconfig.SystemConfig().camera
    K_c = (cam.fx, cam.fy, cam.cx, cam.cy)
    T0, pts, lns, pls, par, ver = _pose_problem(K_c, cam.bf, **size)
    blocks = dict(points=pts, lines=lns, planes=pls, par_planes=par,
                  ver_planes=ver)
    if which == "points":
        blocks = dict(points=pts)
    elif which == "planes":
        blocks = dict(planes=pls, par_planes=par, ver_planes=ver)
    elif which == "invalid":
        for b in blocks.values():
            b[-1] = np.zeros_like(b[-1])
    return rotation_fixed, K_c, cam.bf, T0, blocks


@pytest.mark.parametrize("case", list(_POSE_CASES))
def test_pose_optimize_parity(case):
    """pose_optimize of the port (its plain version, the CPU route of K11)
    against the JAX function: pose atol 1e-4, every inlier mask exact,
    inlier count exact. Cases: the small problem and the main path's full
    width (N = 1024 with 10% outliers, stereo and mono, L = 64, P = 16 per
    plane block), each with rotation_fixed False and True; at full width
    from the true pose (nearly every LM step rejected) and from 0.1 rad
    and 0.1 m off; the modular path's points-only call; a planes-only call (plane weights of 2500 to
    328280 against a 1e-9 regulariser); and an all-invalid call, which
    keeps T at T_init with chi2 0 and no inliers in both packages."""
    from planarslam_tpu.config import PlaneConfig as JPC
    from planarslam_tpu_torch.config import PlaneConfig as TPC

    rotation_fixed, K_c, bf, T0, blocks = _pose_case(case)
    jcls = dict(points=jpo.PointObs, lines=jpo.LineObs)
    tcls = dict(points=tpo.PointObs, lines=tpo.LineObs)
    rj = jpo.pose_optimize(
        jnp.asarray(T0), K_c, bf,
        weights=jpo.PoseOptWeights.from_config(JPC()),
        rotation_fixed=rotation_fixed,
        **{k: jcls.get(k, jpo.PlaneObs)(*[jnp.asarray(a) for a in v])
           for k, v in blocks.items()})
    obs = {k: tcls.get(k, tpo.PlaneObs)(*[_t(a) for a in v])
           for k, v in blocks.items()}
    # the flag as the device tracker passes it: a bool tensor
    rt = tpo.pose_optimize(_t(T0), K_c, bf,
                           weights=tpo.PoseOptWeights.from_config(TPC()),
                           rotation_fixed=torch.tensor(rotation_fixed), **obs)
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw),
                               atol=1e-4)
    for name in ("point_inlier", "line_inlier", "plane_inlier", "par_inlier",
                 "ver_inlier", "n_point_inliers"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    if "points" in blocks and case != "all_invalid":
        n_out = len(blocks["points"][0]) // 10
        assert not bool(np.asarray(rj.point_inlier)[:n_out].all())
        assert int(rt.n_point_inliers) > 0.5 * len(blocks["points"][0])
    if case == "all_invalid":
        np.testing.assert_array_equal(rt.T_cw.numpy(), T0)
        np.testing.assert_array_equal(np.asarray(rj.T_cw), T0)
        assert float(rt.chi2) == 0.0 and float(rj.chi2) == 0.0
        assert int(rt.n_point_inliers) == 0
    if rotation_fixed:
        np.testing.assert_array_equal(rt.T_cw.numpy()[:3, :3], T0[:3, :3])
    # a Python bool selects the same solve
    rb = tpo.pose_optimize(_t(T0), K_c, bf,
                           weights=tpo.PoseOptWeights.from_config(TPC()),
                           rotation_fixed=rotation_fixed, **obs)
    np.testing.assert_array_equal(rb.T_cw.numpy(), rt.T_cw.numpy())
