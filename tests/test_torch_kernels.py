"""The hand-written Hopper kernels (K1-K50) against their plain PyTorch
versions on the card. These need a GPU: without one every test skips.

    python -m pytest tests/test_torch_kernels.py -q     # on the GPU machine
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import _ba_problem, _pose_problem
from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.io import synthetic
from planarslam_tpu_torch.ops import fast, image, lines, matching, orb, planes
from planarslam_tpu_torch.ops.frontend import EDGE_BORDER
from planarslam_tpu_torch.slam import device_tracker

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frame(dev):
    seq = synthetic.make_sequence(4, width=640, height=480)
    g, d = seq.render(1)
    return (torch.from_numpy(np.array(g, np.float32)).to(dev),
            torch.from_numpy(np.array(d, np.float32)).to(dev))


def test_fast_score(frame):
    """K1 equals its plain version exactly on every pyramid level."""
    for lv in image.build_pyramid(frame[0], 8, 1.2):
        n0 = kernels.LAUNCHES["fast_score"]
        out = fast.fast_score(lv)
        assert kernels.LAUNCHES["fast_score"] == n0 + 1
        torch.testing.assert_close(out, fast.fast_score_plain(lv), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("case", chip_smoke.PLANTED_FAST_CASES)
def test_fast_score_planted_levels(dev, case):
    """K1 over chip_smoke.py's planted levels (narrower or shorter than the
    7-pixel ring among larger ones; noise and flat) in one launch: exactly
    its plain version and the one-level launches; the flat image scores 0
    everywhere."""
    table, buf = chip_smoke.planted_fast_levels(case)
    buf = torch.from_numpy(buf).to(dev)
    n0 = kernels.LAUNCHES["fast_score"]
    got = fast.fast_score_levels(buf, table)
    assert kernels.LAUNCHES["fast_score"] == n0 + 1
    assert torch.equal(got, fast.fast_score_levels_plain(buf, table))
    for l, (h, w) in enumerate(table.shapes):
        lv = buf[0, table.level_slice(l)].reshape(h, w)
        assert torch.equal(fast.fast_score(lv).reshape(-1),
                           got[0, table.level_slice(l)])
    if case == "flat":
        assert not bool(got.any())
    else:
        assert bool(got.any())


def test_fast_score_batched(dev):
    """K1 over four frames' 8-level pyramids in one launch: each lane's
    bits those of its own launch, and exactly the plain version."""
    from planarslam_tpu_torch.ops.frontend import orb_level_table

    cfg = SystemConfig()
    seq = synthetic.make_sequence(4, width=640, height=480)
    table = orb_level_table(480, 640, cfg.orb)
    gray = torch.from_numpy(np.stack([np.round(np.array(
        seq.render(i)[0], np.float32)) for i in range(4)])).to(dev)
    buf = image.build_pyramid_levels(gray, table, cfg.orb.scale_factor)
    n0 = kernels.LAUNCHES["fast_score"]
    got = fast.fast_score_levels(buf, table)
    assert kernels.LAUNCHES["fast_score"] == n0 + 1
    for b in range(4):
        one = fast.fast_score_levels(buf[b:b + 1].contiguous(), table)
        assert torch.equal(got[b].view(torch.int32), one[0].view(torch.int32))
    assert torch.equal(got, fast.fast_score_levels_plain(buf, table))


def test_orb_describe(frame):
    """K2: angles atol 1e-4 (sum order of the moments); descriptors
    bit-identical for >= 99% of valid keypoints."""
    n_valid = n_same = 0
    for l, lv in enumerate(image.build_pyramid(frame[0], 8, 1.2)):
        uv, _, valid = fast.select_keypoints(
            fast.fast_score_plain(lv), tile=max(8, round(32 / 1.2 ** l)),
            k_total=150, min_score=7.0, border=EDGE_BORDER)
        blur = image.blur(lv, 7, 2.0)
        a_k, d_k = orb.orb_describe(lv, blur, uv, valid)
        a_p, d_p = orb.orb_describe_plain(lv, blur, uv, valid)
        torch.testing.assert_close(a_k, a_p, rtol=0, atol=1e-4)
        same = (d_k == d_p).all(dim=1) & valid
        n_valid += int(valid.sum())
        n_same += int(same.sum())
    assert n_valid > 0 and n_same >= 0.99 * n_valid


@pytest.mark.parametrize("gated", [False, True])
def test_gated_hamming_top2(dev, gated):
    """K3 equals its plain version exactly (ties to the lowest index)."""
    rng = np.random.default_rng(2)
    M, N = 4096, 1024
    a = rng.integers(-2 ** 31, 2 ** 31, (M, 8)).astype(np.int32)
    src = rng.integers(0, M, N)
    # near-duplicates (and exact ones, for ties)
    flips = (rng.random((N, 8)) < 0.2) * rng.integers(0, 2 ** 31, (N, 8))
    b = (a[src] ^ flips).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    gate = None
    if gated:
        a_uv = rng.uniform(0, [640, 480], (M, 2)).astype(np.float32)
        lvl = rng.integers(0, 8, M).astype(np.int32)
        gate = matching.ProjGate(
            a_uv=t(a_uv), a_r=t((5.0 * 1.2 ** lvl).astype(np.float32)),
            a_level=t(lvl), a_ur_pred=t(a_uv[:, 0] - 20.0),
            b_uv=t((a_uv[src] + rng.normal(0, 3, (N, 2))).astype(np.float32)),
            b_level=t(lvl[src]),
            b_ur=t(np.where(rng.random(N) < 0.5, a_uv[src, 0] - 20.0,
                            -1.0).astype(np.float32)),
            level_window=1)
    a_ok, b_ok = t(rng.random(M) < 0.9), t(rng.random(N) < 0.9)
    got = matching.gated_hamming_top2(t(a), t(b), a_ok, b_ok, gate)
    want = matching.gated_hamming_top2_plain(t(a), t(b), a_ok, b_ok, gate)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_hamming_edge_cases(dev):
    """K3 on chip_smoke.py's planted edge cases (every row dead, one
    gated-in column, N = 1, duplicate best columns across two tiles, N
    above one tile, B = 8, both directions of a mutual match in one
    launch): bit-equal to its plain version, two launches equal."""
    res = _held(chip_smoke.hamming_edge_cases, SystemConfig(), dev)
    assert res["one_gated_in_column"]["matched"] == 1
    assert res["mutual"]["mutual_pairs"] > 100


def test_plane_components_lanes(dev):
    """K12 on eight lanes in one launch bit-equal to each lane's own
    launch and held to its plain version, and its launch captured in a
    CUDA graph replaying the eager bits."""
    seq = synthetic.make_sequence(chip_smoke.TRACKING_FRAMES, width=640,
                                  height=480)
    res = _held(chip_smoke.components_lanes, seq, SystemConfig(), dev)
    assert res["lanes"] == 8 and res["graph_replay_bit_equal"]
    assert min(res["candidates"]) >= 2


def test_plane_block_moments(frame):
    """K4: counts exact, sums within 1e-5 of their largest magnitude."""
    cfg = SystemConfig()
    depth = frame[1]
    alpha = planes._noise_alpha(depth, cfg.planes.max_distance)
    args = (depth, alpha, cfg.camera, 0.02, cfg.planes.max_distance, 8)
    got = planes.plane_block_moments(*args)
    want = planes.plane_block_moments_plain(*args)
    torch.testing.assert_close(got.n, want.n, rtol=0, atol=0)
    for g, w in ((got.s1, want.s1), (got.s2, want.s2)):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def _project(K, T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2],
                     K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)


def _pose(rng, rot=0.05, trans=0.3):
    from scipy.spatial.transform import Rotation

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(0, rot, 3)).as_matrix()
    T[:3, 3] = rng.normal(0, trans, 3)
    return T


def test_triangulate_two_view(dev):
    """K5: good equal on >= 99.5% of pairs, X relative error <= 1e-3 where
    good in both (both solve in float64; the gates are float32)."""
    from planarslam_tpu_torch.solvers import triangulation

    cfg = SystemConfig()
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    rng = np.random.default_rng(5)
    NB, Kp = 5, 1024
    X = np.stack([rng.uniform(-2, 2, Kp), rng.uniform(-1.5, 1.5, Kp),
                  rng.uniform(2, 6, Kp)], -1)
    nb_T = np.stack([_pose(rng) for _ in range(NB)])
    uv1 = _project(K, np.eye(4), X) + rng.normal(0, 0.5, (Kp, 2))
    uv2 = np.stack([_project(K, T, X) for T in nb_T])
    uv2 += rng.normal(0, 0.5, uv2.shape)
    lvl = rng.integers(0, 8, Kp).astype(np.int32)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    args = (t(uv1), t(lvl, np.int32), t(uv2), t(np.tile(lvl, (NB, 1)),
                                                  np.int32),
            t(rng.random((NB, Kp)) < 0.9, bool), t(np.eye(4)), t(nb_T), K,
            cfg.orb.scale_factor)
    n0 = kernels.LAUNCHES["triangulate_two_view"]
    Xk, gk = triangulation.triangulate_two_view(*args)
    assert kernels.LAUNCHES["triangulate_two_view"] == n0 + 1
    Xp, gp = triangulation.triangulate_two_view_plain(*args)
    assert int(gp.sum()) > 500
    assert float((gk == gp).float().mean()) >= 0.995
    both = (gk > 0) & (gp > 0)
    rel = (Xk - Xp).norm(dim=-1) / Xp.norm(dim=-1)
    assert float(rel[both].max()) <= 1e-3


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_horn_align_batch(dev, n):
    """K6 on the 64 one-hot hypothesis rows and the refit row: inlier
    counts equal, R and t atol 1e-4."""
    from planarslam_tpu_torch.solvers import sim3_solver

    rng = np.random.default_rng(n)
    src = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    T = _pose(rng, 0.3, 0.5)
    dst = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, (n, 3))
    bad = rng.random(n) >= 0.6
    dst[bad] = rng.uniform(-3, 3, (int(bad.sum()), 3))
    s, d, v, picks = sim3_solver._pad_pair(src, dst, 64)
    w = np.zeros((64, len(s)), np.float32)
    np.put_along_axis(w, picks.astype(np.int64), 1.0, axis=1)
    w = w * v[None] + np.float32(1e-9)
    args = [torch.from_numpy(a).to(dev) for a in (s, d, v, w)]
    for rows in (args[3], args[3][:1].contiguous()):
        got = sim3_solver.horn_align_batch(*args[:3], rows, 0.08)
        want = sim3_solver.horn_align_batch_plain(*args[:3], rows, 0.08)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        for g, w_ in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w_, rtol=0, atol=1e-4)


def test_pnp_dlt_hypotheses(dev):
    """K7 on 128 hypotheses over 256 correspondences (80% inliers): scores
    within 2 on >= 95% of hypotheses, best T atol 0.01 (R) / 0.05 (t)."""
    from planarslam_tpu_torch.solvers import pnp

    rng = np.random.default_rng(7)
    K = (535.4, 539.2, 319.5, 239.5)
    n = 256
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    uv = _project(K, _pose(rng, 0.1, 0.1), xw) + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) >= 0.8
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    uv_n = np.stack([(uv[:, 0] - K[2]) / K[0], (uv[:, 1] - K[3]) / K[1]],
                    -1).astype(np.float32)
    picks = np.random.default_rng(11).integers(0, n, (128, 6)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (
        xw, uv_n, np.full(n, K[0] * K[1], np.float32), np.ones(n, bool),
        picks)]
    sk, Tk = pnp.pnp_dlt_hypotheses(*args, 5.991)
    sp, Tp = pnp.pnp_dlt_hypotheses_plain(*args, 5.991)
    assert float(((sk - sp).abs() <= 2).float().mean()) >= 0.95
    bk, bp = Tk[int(torch.argmax(sk))], Tp[int(torch.argmax(sp))]
    torch.testing.assert_close(bk[:3, :3], bp[:3, :3], rtol=0, atol=0.01)
    torch.testing.assert_close(bk[:3, 3], bp[:3, 3], rtol=0, atol=0.05)


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("want_hcp", [True, False])
def test_ba_normal_eqs(dev, want_hcp):
    """K8 at the LBA shape (Kt=16, 1000 point and 64 endpoint slots,
    M=2336; chip_smoke.py's seeded tables): every output within 1e-4 of its
    largest value (float32 sums in another order); two launches give
    identical bits (no atomics)."""
    from planarslam_tpu_torch.solvers import ba_core

    poses, pts, pt, ln, K = _ba_problem(dev, 16, 1000, 64, 2304, seed=1)
    M = 2336
    plan = ba_core.obs_plan(pt.slot, pt.mask, ln.slot, ln.mask, M)
    args = (poses, pts, pt, ln, M, K, 40.0, True, want_hcp)
    n0 = kernels.LAUNCHES["ba_normal_eqs"]
    got = ba_core.ba_normal_eqs(*args, plan=plan)
    again = ba_core.ba_normal_eqs(*args, plan=plan)
    assert kernels.LAUNCHES["ba_normal_eqs"] == n0 + 2
    want = ba_core.ba_normal_eqs_plain(*args)
    for g, a, w in zip(got, again, want):
        if w is None:
            assert g is None
            continue
        assert _rel(g, w) <= 1e-4
        assert torch.equal(g, a)


def test_ba_schur_eliminate(dev):
    """K9's two entries against their plain versions at the LBA shape:
    Hpp_inv, HcpHinv, rhs and dxp within 1e-4 of their largest values."""
    from planarslam_tpu_torch.solvers import ba_core

    poses, pts, pt, ln, K = _ba_problem(dev, 16, 1000, 64, 2304, seed=2)
    M = 2336
    Hcc, bc, Hpp, bp, Hcp, _, _ = ba_core.ba_normal_eqs_plain(
        poses, pts, pt, ln, M, K, 40.0)
    Hpp[2304:] = torch.eye(3, device=dev)
    lam = torch.tensor(1e-3, device=dev)
    mu = ba_core._mu_p(Hpp)
    dxc = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1e-3, (16, 6)).astype(np.float32)).to(dev)
    got = ba_core.ba_schur_eliminate(Hpp, bp, Hcp, bc, lam, mu)
    want = ba_core.ba_schur_eliminate_plain(Hpp, bp, Hcp, bc, lam, mu)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4
    assert _rel(ba_core.ba_schur_backsub(got[0], bp, Hcp, dxc),
                ba_core.ba_schur_backsub_plain(want[0], bp, Hcp, dxc)) <= 1e-4


def test_pose_graph_normal_eqs(dev):
    """K10 on a 96-keyframe chain with skip edges and a repeated loop edge:
    H and g within 1e-5 of their largest values (both float64 inside)."""
    from planarslam_tpu_torch.solvers import pose_graph

    rng = np.random.default_rng(4)
    N = 96
    Tw = [np.eye(4, dtype=np.float32)]
    for _ in range(N - 1):
        Tw.append((_pose(rng, 0.05, 0.1) @ Tw[-1]).astype(np.float32))
    Tw = np.stack(Tw)
    ij = [(i, i - 1) for i in range(1, N)] + [(i, i + 3) for i in
                                              range(N - 3)]
    ij = np.asarray(ij + [(N - 1, 0), (N - 1, 0)], np.int32)
    meas = np.stack([_pose(rng, 0.01, 0.01) @ Tw[i] @ np.linalg.inv(Tw[j])
                     for i, j in ij]).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (t(Tw), t(ij), t(np.linalg.inv(meas).astype(np.float32)),
            t(rng.uniform(1, 5, len(ij)).astype(np.float32)),
            pose_graph.edge_plan(ij, N, device=dev))
    H, g = pose_graph.pose_graph_normal_eqs(*args)
    Hp, gp = pose_graph.pose_graph_normal_eqs_plain(*args)
    assert _rel(H, Hp) <= 1e-5 and _rel(g, gp) <= 1e-5


@pytest.mark.parametrize("case", ["False", "True", "points_only",
                                  "planes_only", "all_invalid"])
def test_pose_optimize(dev, case):
    """K11 on the seeded problem at the main path's width (N = 1024, L =
    64, P = 16 per plane block; chip_smoke.py's) with rotation_fixed False
    and True (a device flag), and False (a Python bool) with points only
    (the modular path's call; the other blocks absent), planes only, and
    every observation invalid: pose atol 1e-4 against the plain version,
    every inlier mask and the inlier count equal, chi2 within 1e-4
    relative; one launch per call, and two launches give identical bits
    (fixed-order sums, no atomics)."""
    from planarslam_tpu_torch.solvers import pose_opt

    cam = SystemConfig().camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    T0, pts, lns, pls, par, ver = _pose_problem(K, cam.bf, n=1024,
                                                n_lines=64, n_planes=16)
    if case == "all_invalid":
        for block in (pts, lns, pls, par, ver):
            block[-1] = np.zeros_like(block[-1])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    obs = dict(points=pose_opt.PointObs(*map(t, pts)),
               lines=pose_opt.LineObs(*map(t, lns)),
               planes=pose_opt.PlaneObs(*map(t, pls)),
               par_planes=pose_opt.PlaneObs(*map(t, par)),
               ver_planes=pose_opt.PlaneObs(*map(t, ver)))
    if case == "points_only":
        obs = dict(points=obs["points"], rotation_fixed=False)
    elif case == "planes_only":
        del obs["points"], obs["lines"]
    else:
        obs["rotation_fixed"] = torch.tensor(case == "True", device=dev)
    n0 = kernels.LAUNCHES["pose_optimize"]
    got = pose_opt.pose_optimize(t(T0), K, cam.bf, **obs)
    again = pose_opt.pose_optimize(t(T0), K, cam.bf, **obs)
    assert kernels.LAUNCHES["pose_optimize"] == n0 + 2
    want = pose_opt._pose_optimize_plain(t(T0), K, cam.bf, **obs)
    torch.testing.assert_close(got.T_cw, want.T_cw, rtol=0, atol=1e-4)
    for name in ("point_inlier", "line_inlier", "plane_inlier", "par_inlier",
                 "ver_inlier", "n_point_inliers"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert abs(float(got.chi2) - float(want.chi2)) <= 1e-4 * float(want.chi2)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    if case == "True":
        assert torch.equal(got.T_cw[:3, :3], t(T0)[:3, :3])
    if case == "all_invalid":
        assert torch.equal(got.T_cw, t(T0))
        assert float(got.chi2) == 0.0 and int(got.n_point_inliers) == 0


@pytest.mark.parametrize("start", ["converged", "far"])
def test_pose_optimize_start(dev, start):
    """K11 on the seeded problem at the main path's width from the true
    pose (nearly every LM step is rejected and the kernel keeps the sums
    it has) and from 0.1 rad / 0.1 m off with its 10% outliers: pose
    within 1e-4 of the plain version; masks exact from the true pose, and
    flipping only at their gates from afar (chip_smoke._pose_compare); one
    launch per call and two launches give the same bits."""
    from planarslam_tpu_torch.solvers import pose_opt

    cam = SystemConfig().camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    T0, pts, lns, pls, par, ver = _pose_problem(K, cam.bf, n=1024,
                                                n_lines=64, n_planes=16,
                                                start=start)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kw = dict(points=pose_opt.PointObs(*map(t, pts)),
              lines=pose_opt.LineObs(*map(t, lns)),
              planes=pose_opt.PlaneObs(*map(t, pls)),
              par_planes=pose_opt.PlaneObs(*map(t, par)),
              ver_planes=pose_opt.PlaneObs(*map(t, ver)),
              rotation_fixed=torch.tensor(False, device=dev))
    args = (t(T0), K, cam.bf)
    res = _held(chip_smoke._pose_compare, args, kw, start == "converged")
    assert res["n_inliers"] > 0.5 * 1024
    got, n = _launched("pose_optimize", pose_opt.pose_optimize, *args, **kw)
    assert n == 1
    _same_bits(got, pose_opt.pose_optimize(*args, **kw))


def test_pose_optimize_large(dev):
    """K11 on a problem too large to stage in shared memory (5000 points,
    64 lines, 16 planes per block: the global-scratch layout), two lanes
    in one launch: each lane equals its own launch bit for bit and its
    plain version within the single problem's limits (pose 1e-4, flips
    only at their gates)."""
    from planarslam_tpu_torch.solvers import pose_opt

    assert kernels.cuda_lib().psl_pose_optimize_scratch_bytes(5000 + 64 + 48) > 0
    cam = SystemConfig().camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    probs = [_pose_problem(K, cam.bf, seed=i, n=5000, n_lines=64,
                           n_planes=16, start=st)
             for i, st in ((0, "near"), (1, "far"))]

    def t(*a):
        return torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(dev)

    names = ("points", "lines", "planes", "par_planes", "ver_planes")
    classes = (pose_opt.PointObs, pose_opt.LineObs, pose_opt.PlaneObs,
               pose_opt.PlaneObs, pose_opt.PlaneObs)
    blocks = {name: cls(*[t(*[p[k + 1][f] for p in probs])
                          for f in range(len(probs[0][k + 1]))])
              for k, (name, cls) in enumerate(zip(names, classes))}
    T0 = t(*[p[0] for p in probs])
    flag = torch.tensor([False, True], device=dev)
    got = pose_opt.pose_optimize(T0, K, cam.bf, **blocks,
                                 rotation_fixed=flag)
    for i in range(2):
        lane = {k: type(b)(*[x[i] for x in b]) for k, b in blocks.items()}
        one = pose_opt.pose_optimize(T0[i], K, cam.bf, **lane,
                                     rotation_fixed=flag[i])
        _same_bits([x[i] for x in got], one)
        _held(chip_smoke._pose_compare, (T0[i], K, cam.bf),
              dict(lane, rotation_fixed=flag[i]), False)


def test_select_top_e_planted(dev):
    """K20's selection stage alone (lines.select_top_e) equals
    lax_compat.top_k bit for bit on chip_smoke.planted_top_e_maps at
    120x160 and 480x640 (ties below and at the E-th rank, fewer than E
    nonzero, all zero), two calls equal bits (chip_smoke's
    select_stage_parity)."""
    entry = {}
    _held(chip_smoke.select_stage_parity, dev, entry)
    assert set(entry["select_stage"]) == {"120x160", "480x640"}


def _held(fn, *args):
    """Run one of chip_smoke.py's comparisons; its failure (an exit) fails
    the test."""
    try:
        return fn(*args)
    except SystemExit:
        pytest.fail(f"{fn.__name__} failed (message on stderr)")


@pytest.mark.parametrize("which", ["clean", "noisy"])
def test_plane_segment_kernels(dev, which):
    """K12, the three rounds of K13 and K14 at 640x480 against their plain
    versions (chip_smoke.py's plane_segment_compare states the limits): K12
    integer-exact on clean depth, its candidate fits no further from a
    float64 refit than the float32 plain run is, plus
    chip_smoke.CANDIDATE_EPS; K13's fits no further from the float64 plain
    run than the float32 plain run is, plus chip_smoke.REFIT_EPS, labels
    equal on >= 99.5% of pixels; K14 validity
    and counts exact, coefficients 1e-5, labels >= 99.9%; two launches of
    each give equal bits; one launch per call."""
    cfg = SystemConfig()
    factor = cfg.camera.depth_map_factor
    seq = synthetic.make_sequence(4, width=640, height=480)
    d = np.round(np.array(seq.render(1)[1], np.float32) * factor) / factor
    d = d.astype(np.float32)
    if which == "noisy":
        d = chip_smoke.noisy_depth(d, factor)
    n0 = dict(kernels.LAUNCHES)
    res = _held(chip_smoke.plane_segment_compare,
                torch.from_numpy(d).to(dev), cfg, which == "clean")
    assert res["plane_label_pixels"]["planes"] >= 2
    # two launches of each kernel per comparison
    rounds = 1 + cfg.planes.refine_rounds
    for name, n in (("plane_components", 2), ("plane_assign_refit",
                                              2 * rounds),
                    ("plane_label_pixels", 2)):
        assert kernels.LAUNCHES[name] == n0[name] + n


def test_plane_assign_refit_rounds(dev):
    """K13's three rounds of extract_planes at B = 1, 4 and 9
    (chip_smoke.refit_problems): one launch a round up to 8 frames (two at
    9), as the C entry reports; with every partial-sum buffer filled with
    NaN and with other problems' sums left in reused buffers, each run
    bit-equal to its first and no flag word left set after a round
    (chip_smoke.refit_protocol); lane 0 of the B = 4 and 9 rounds equal to
    the B = 1 rounds; and a CUDA graph of the B = 4 rounds replays
    bit-equal to them, its flag words clear after each replay."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(9, width=640, height=480)
    probs = chip_smoke.refit_problems(seq, cfg, dev, frames=9)
    rounds = 1 + cfg.planes.refine_rounds
    got = _held(chip_smoke.refit_protocol, probs, rounds, 2)
    assert got["calls"] == 2 * 2 * len(probs) == 12
    outs = {name: fn() for name, fn in probs.items()}
    for name in ("b4", "b9"):
        for a, b in zip(outs[name], outs["b1"]):
            assert torch.equal(a[:1], b)
    assert _held(chip_smoke.graph_replay, probs["b4"])


def test_extract_planes_on_card(dev, frame):
    """extract_planes on the card (K4, K12-K14) against the composition of
    the plain versions on the same depth: validity exact, counts rtol
    2e-3, labels equal on >= 99.5% of pixels, coefficients and centroids
    atol 2e-3 (the limits of the CPU parity test on noisy depth); a CUDA
    input never reaches a plain function."""
    cfg = SystemConfig()
    pc, cam = cfg.planes, cfg.camera
    depth = frame[1]
    n0 = dict(kernels.LAUNCHES)
    got = planes.extract_planes(depth, cam, pc)
    for name, n in (("plane_block_moments", 1), ("plane_components", 1),
                    ("plane_assign_refit", 1 + pc.refine_rounds),
                    ("plane_label_pixels", 1)):
        assert kernels.LAUNCHES[name] == n0[name] + n
    h, w = depth.shape
    alpha = planes._noise_alpha(depth, pc.max_distance)
    stats = planes.plane_block_moments_plain(
        depth, alpha, cam, planes._geo_tol(w), pc.max_distance, pc.block)
    cand = planes.plane_components_plain(stats, h // pc.block, w // pc.block,
                                         pc)
    fit = planes.plane_assign_refit_plain(depth, alpha, cam, pc, cand.normal,
                                          cand.d, cand.valid)
    for _ in range(pc.refine_rounds):
        fit = planes.plane_assign_refit_plain(
            depth, alpha, cam, pc, fit.normal, fit.d, fit.alive,
            (fit.mse, fit.mean, fit.n))
    want = planes.plane_label_pixels_plain(depth, alpha, cam, pc, fit)
    assert int(want.valid.sum()) >= 2
    assert torch.equal(got.valid, want.valid)
    torch.testing.assert_close(got.count.float(), want.count.float(),
                               rtol=2e-3, atol=0)
    assert float((got.pixel_label == want.pixel_label).float().mean()) >= 0.995
    torch.testing.assert_close(got.coeffs, want.coeffs, rtol=0, atol=2e-3)
    torch.testing.assert_close(got.centroid[want.valid],
                               want.centroid[want.valid], rtol=0, atol=2e-3)


def test_manhattan_mean_shift(dev):
    """K15 at N = 2112 on a frame's normals and line directions
    (chip_smoke.py's manhattan_kernel_parity): both cone sines, one axis
    missing (cross-product completion), two missing (success false, R_cm
    returned unchanged), the normals twice over (N = 4224) and none;
    R_cm atol 1e-5, support counts, axis count and success exact, two
    launches equal bits."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(2, width=640, height=480)
    n0 = kernels.LAUNCHES["manhattan_mean_shift"]
    out = _held(chip_smoke.manhattan_kernel_parity, seq, cfg, dev)
    assert kernels.LAUNCHES["manhattan_mean_shift"] > n0
    assert out[0]["shapes"]["N"] == (cfg.manhattan.max_normals
                                     + cfg.lines.max_lines)
    assert set(out[0]["cases"]) == {"track", "project", "axis_missing",
                                    "two_missing", "n_twice", "n_zero"}


def test_frontend_kernels(dev):
    """K16-K19 and the all-levels launches of K1 and K2 at the default
    configuration's width on frame 0 (chip_smoke.py's
    frontend_kernel_parity states the limits): K16 within
    chip_smoke.PYRAMID_TOLERANCE grey levels of the plain pyramid, >= 97%
    of the keypoints shared; K17 and K18 exactly equal to their plain
    versions, K17 also on planted levels at 1, 3, 5 and 7 taps, K18 also
    on the planted score map with ties, empty tiles and 15 candidates per
    tile and on PLANTED_SELECT; K19 uv and u_right atol 1e-4, the rest
    exact, with and without distortion."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(2, width=640, height=480)
    n0 = dict(kernels.LAUNCHES)
    out = _held(chip_smoke.frontend_kernel_parity, seq, cfg, dev)
    assert [k["name"] for k in out] == ["pyramid_resize", "gaussian_blur",
                                        "select_keypoints", "point_epilogue"]
    for k in out:
        assert kernels.LAUNCHES[k["name"]] > n0[k["name"]]
    assert out[2]["planted"]["k_tile"] == [15, 2, 1]
    assert set(out[3]["cases"]) == {"pinhole", "distorted"}


def test_pyramid_resize_launches(dev, frame):
    """K16 builds the pyramid in the launches its C entry reports: one, as
    image.PYRAMID_LAUNCHES says and kernels.LAUNCHES counts."""
    from planarslam_tpu_torch.ops import frontend as fe

    oc = SystemConfig().orb
    table = fe.orb_level_table(480, 640, oc)
    n0 = kernels.LAUNCHES["pyramid_resize"]
    image.build_pyramid_levels(frame[0][None], table, oc.scale_factor)
    assert image.PYRAMID_LAUNCHES == 1
    assert kernels.LAUNCHES["pyramid_resize"] == n0 + 1


def test_pyramid_resize_cases(dev):
    """K16 on chip_smoke.py's pyramid_inputs (frame 0, frames 0-3 at B = 4
    lane by lane, a 1280x960 frame, a 64x48 one whose top levels are
    narrower than a tile): within chip_smoke.PYRAMID_TOLERANCE of the plain
    pyramid, two launches equal bits, the keypoints shared
    (pyramid_cases states the limits)."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(4, width=640, height=480)
    out = chip_smoke.pyramid_cases(seq, cfg, dev)
    assert set(out) == {"b1", "b4", "wide", "small"}
    assert out["small"]["levels"][-1][1] < 32
    assert out["wide"]["shape"] == [960, 1280]


def test_pyramid_resize_protocol(dev):
    """K16 into a buffer filled with NaN (chip_smoke.pyramid_protocol): each
    call, after other frames' calls, is bit-equal to its first run, one
    launch, every pixel written; a CUDA graph of it replays bit-equal."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(4, width=640, height=480)
    probs = chip_smoke.pyramid_problems(seq, cfg, dev)
    out = chip_smoke.pyramid_protocol(probs, reps=2)
    assert out["calls"] == 2 * 2 * len(probs)
    assert chip_smoke.graph_replay(lambda: probs["b4"](), "pyramid_resize",
                                   None)


@pytest.mark.parametrize("batch", [1, 4])
def test_associate_planes_planted_b4(dev, batch):
    """K30 on chip_smoke.py's planted cases of what it skips (an invalid
    map plane nearer than any valid one with NaN past its points, point
    counts of 0, C and above C, a NaN point in a counted cloud, half the
    frame planes invalid), one at a time and all four in one launch:
    every output bit-equal to the plain version lane by lane, one
    launch."""
    cfg = SystemConfig()
    cases = chip_smoke.PLANE_CASES[-4:]
    probs = [chip_smoke.planted_plane_problem(np.random.default_rng(30), c)
             for c in cases]
    groups = [probs] if batch == 4 else [[p] for p in probs]
    for group in groups:
        args = [torch.from_numpy(np.stack([p[k] for p in group])).to(dev)
                for k in chip_smoke.PLANE_KEYS]
        n0 = kernels.LAUNCHES["associate_planes"]
        got = device_tracker._associate_planes_device(*args, cfg.planes)
        assert kernels.LAUNCHES["associate_planes"] == n0 + 1
        want = kernels.per_problem(device_tracker._associate_planes_plain,
                                   args, cfg.planes)
        for f in got._fields:
            x, y = getattr(got, f), getattr(want, f)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f


@pytest.mark.parametrize("ksize,sigma", chip_smoke.PLANTED_BLUR_TAPS)
@pytest.mark.parametrize("batch", [1, 3])
def test_blur_planted_levels(dev, ksize, sigma, batch):
    """K17 over chip_smoke.py's planted levels (1-6 pixels wide or tall,
    widths no multiple of 4, odd offsets, wider than a strip, taller than a
    band) at 1, 3, 5 and 7 taps, `batch` lanes in one launch: exactly its
    plain version, and each lane its one-lane launch."""
    table, buf = chip_smoke.planted_blur_levels(batch=batch)
    buf = torch.from_numpy(buf).to(dev)
    n0 = kernels.LAUNCHES["gaussian_blur"]
    got = image.gaussian_blur_levels(buf, table, ksize, sigma)
    assert kernels.LAUNCHES["gaussian_blur"] == n0 + 1
    assert torch.equal(got, image.gaussian_blur_levels_plain(buf, table,
                                                             ksize, sigma))
    for b in range(batch):
        one = image.gaussian_blur_levels(buf[b:b + 1].contiguous(), table,
                                         ksize, sigma)
        assert torch.equal(got[b], one[0])


@pytest.mark.parametrize("batch", [1, 3])
def test_select_keypoints_planted_levels(dev, batch):
    """K18 over chip_smoke.py's PLANTED_SELECT levels (a tile wider than its
    level, a dry tile of the sort branch, a level of -1 only, a tie across
    tiles at the quota's cut), `batch` lanes in one call of the launches
    its C entry reports: uv, response and validity exactly its plain
    version's in every slot, and each lane its one-lane call's."""
    ps = chip_smoke.PLANTED_SELECT
    table, scores = chip_smoke.planted_select_levels(batch=batch)
    scores = torch.from_numpy(scores).to(dev)
    kw = dict(min_score=ps["min_score"], border=ps["border"])
    n0 = kernels.LAUNCHES["select_keypoints"]
    got = fast.select_keypoints_levels(scores, table, **kw)
    assert kernels.LAUNCHES["select_keypoints"] == (
        n0 + fast.select_launches(table))
    for a, b in zip(got, fast.select_keypoints_levels_plain(scores, table,
                                                            **kw)):
        assert torch.equal(a, b)
    for b in range(batch):
        one = fast.select_keypoints_levels(scores[b:b + 1].contiguous(),
                                           table, **kw)
        assert all(torch.equal(x[b], y[0]) for x, y in zip(got, one))


@pytest.mark.parametrize("batch", [1, 3])
def test_frontend_kernels_batched(dev, batch):
    """The leading batch count of K1, K2 and K16-K19: `batch` different
    frames through one launch each give what each frame gives alone (K16
    within chip_smoke.PYRAMID_TOLERANCE of the plain pyramid, the others
    exactly their plain versions on the kernel's pyramid), with one launch
    per stage whatever the batch."""
    from planarslam_tpu_torch.ops import frontend as fe

    cfg = SystemConfig()
    oc, cam = cfg.orb, cfg.camera
    seq = synthetic.make_sequence(4, width=640, height=480)
    frames = [seq.render(i) for i in range(batch)]
    gray = torch.from_numpy(np.stack(
        [np.round(np.array(g, np.float32)) for g, _ in frames])).to(dev)
    depth = torch.from_numpy(np.stack(
        [np.array(d, np.float32) for _, d in frames])).to(dev)
    table = fe.orb_level_table(480, 640, oc)
    n0 = dict(kernels.LAUNCHES)
    buf = image.build_pyramid_levels(gray, table, oc.scale_factor)
    scores = fast.fast_score_levels(buf, table)
    sel = fast.select_keypoints_levels(scores, table, float(oc.min_th_fast),
                                       EDGE_BORDER)
    blur = image.gaussian_blur_levels(buf, table, 7, 2.0)
    ang, desc = orb.orb_describe_levels(buf, blur, sel[0], sel[2], table,
                                        oc.max_keypoints)
    ep = fe.point_epilogue(*sel, depth, cam, table, oc.max_keypoints)
    for name, n in (("pyramid_resize", image.PYRAMID_LAUNCHES),
                    ("fast_score", 1),
                    ("select_keypoints", fast.select_launches(table)),
                    ("gaussian_blur", 1),
                    ("orb_describe", 1), ("point_epilogue", 1)):
        assert kernels.LAUNCHES[name] == n0[name] + n, name
    torch.testing.assert_close(
        buf, image.build_pyramid_levels_plain(gray, table, oc.scale_factor),
        rtol=0, atol=chip_smoke.PYRAMID_TOLERANCE)
    assert torch.equal(scores, fast.fast_score_levels_plain(buf, table))
    for a, b in zip(sel, fast.select_keypoints_levels_plain(
            scores, table, float(oc.min_th_fast), EDGE_BORDER)):
        assert torch.equal(a, b)
    assert torch.equal(blur, image.gaussian_blur_levels_plain(buf, table, 7,
                                                              2.0))
    a_p, d_p = orb.orb_describe_levels_plain(buf, blur, sel[0], sel[2], table,
                                             oc.max_keypoints)
    torch.testing.assert_close(ang, a_p, rtol=0, atol=1e-4)
    n_valid = int(sel[2].sum())
    same = (desc == d_p).all(dim=-1)[:, :table.n_slots] & sel[2]
    assert n_valid > 500 * batch and int(same.sum()) >= 0.99 * n_valid
    want = fe.point_epilogue_plain(*sel, depth, cam, table, oc.max_keypoints)
    for f in ("uv_raw", "response", "level", "depth", "valid"):
        assert torch.equal(getattr(ep, f), getattr(want, f)), f
    torch.testing.assert_close(ep.uv, want.uv, rtol=0, atol=1e-4)
    torch.testing.assert_close(ep.u_right, want.u_right, rtol=0, atol=1e-4)
    if batch > 1:
        assert not torch.equal(buf[0], buf[1])


def test_line_kernels(dev):
    """K20-K23 at the default configuration's width on frame 0, clean and
    with Kinect noise (chip_smoke.py's line_kernel_parity states the
    limits): K20 equal to its plain version off its sums, the responses
    within their rounding and flips only at plain near-decisions, K21
    within chip_smoke.DESC_TOLERANCE, K22 has_3d exact and endpoints within
    chip_smoke.P3D_TOLERANCE, K23 indices exact and similarities within
    chip_smoke.SIM_TOLERANCE on the window, 4096 lines, no candidate,
    fewer than 6 earned, a planted tie, 250 and 1000 lines and every
    candidate NaN."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(8, width=640, height=480)
    n0 = dict(kernels.LAUNCHES)
    out = _held(chip_smoke.line_kernel_parity, seq, cfg, dev)
    assert [k["name"] for k in out] == ["detect_lines", "line_descriptors",
                                        "lift_lines_3d",
                                        "search_lines_by_projection"]
    for k in out:
        assert kernels.LAUNCHES[k["name"]] > n0[k["name"]]
    assert set(out[3]["cases"]) == {"window", "fuse_4096", "no_candidates",
                                    "few_earned", "tie", "window_250",
                                    "fuse_1000", "all_nan"}


@pytest.mark.parametrize("batch", [1, 3])
def test_line_kernels_batched(dev, batch):
    """The leading batch count of K20-K23: `batch` different frames (or
    search problems) through one call each give what each gives alone, with
    the same launches whatever the batch."""
    cfg = SystemConfig()
    lc, cam = cfg.lines, cfg.camera
    seq = synthetic.make_sequence(4, width=640, height=480)
    frames = [seq.render(i) for i in range(batch)]
    gray = torch.from_numpy(np.stack(
        [np.round(np.array(g, np.float32)) for g, _ in frames])).to(dev)
    depth = torch.from_numpy(np.stack(
        [np.array(d, np.float32) for _, d in frames])).to(dev)
    blurred = torch.stack([image.gaussian_blur(g, 5, 1.0) for g in gray])
    n0 = dict(kernels.LAUNCHES)
    det = lines.detect_lines(blurred, lc)
    args = (det.gx, det.gy, det.uv_s, det.uv_e, det.valid)
    desc = lines.line_descriptors(*args)
    lifted = lines.lift_lines_3d(depth, cam, lc, det.uv_s, det.uv_e,
                                 det.valid)
    T = torch.from_numpy(np.stack([np.linalg.inv(seq.poses_wc[i]).astype(
        np.float32) for i in range(batch)])).to(dev)
    search = (lifted[0], lifted[1], desc, lifted[2], T, det.uv_s, det.uv_e,
              det.angle, desc, det.valid)
    kw = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
              image_wh=(float(cam.width), float(cam.height)), radius=14.0)
    idx, sim = lines.search_lines_by_projection_batched(*search, **kw)
    for name, n in (("detect_lines", lines.DETECT_LAUNCHES),
                    ("line_descriptors", 1), ("lift_lines_3d", 1),
                    ("search_lines_by_projection",
                     lines.search_launches(desc.shape[1]))):
        assert kernels.LAUNCHES[name] == n0[name] + n, name
    for b in range(batch):
        one = lines.detect_lines(blurred[b:b + 1], lc)
        for f in det._fields:
            assert torch.equal(getattr(det, f)[b], getattr(one, f)[0]), f
        d1 = lines.line_descriptors(*[a[b:b + 1] for a in args])
        assert torch.equal(desc[b], d1[0])
        l1 = lines.lift_lines_3d(depth[b:b + 1], cam, lc, det.uv_s[b:b + 1],
                                 det.uv_e[b:b + 1], det.valid[b:b + 1])
        for a, c in zip(lifted, l1):
            assert torch.equal(a[b], c[0])
        i1, s1 = lines.search_lines_by_projection(
            *[a[b] for a in search], **kw)
        assert torch.equal(idx[b], i1) and torch.equal(sim[b], s1)
    if batch > 1:
        assert not torch.equal(det.uv_s[0], det.uv_s[1])


@pytest.mark.parametrize("case", ["tie", "fuse_4096", "fuse_1000",
                                  "window_250", "all_nan"])
def test_search_lines_planted(dev, case):
    """K23 on chip_smoke.py's planted problems at the default
    configuration's width: indices exactly the plain version's,
    similarities within chip_smoke.SIM_TOLERANCE (NaN where the plain
    version's are), the launches of its M's configuration, two calls equal
    bits; the tie goes to the lower row and the lower segment."""
    cfg = SystemConfig()
    cam = cfg.camera
    seq = synthetic.make_sequence(8, width=640, height=480)
    kw0 = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
               image_wh=(float(cam.width), float(cam.height)))
    feats = chip_smoke.line_search_feats(seq, cfg, dev)
    probs = chip_smoke._line_search_problems(feats, seq, dev,
                                             np.random.default_rng(23), kw0)
    args, radius = probs[case]
    kw = dict(kw0, radius=radius)
    M = args[0].shape[0]
    n0 = kernels.LAUNCHES["search_lines_by_projection"]
    idx, sim = lines.search_lines_by_projection_batched(
        *[a[None] for a in args], **kw)
    assert (kernels.LAUNCHES["search_lines_by_projection"]
            == n0 + lines.search_launches(M))
    idx2, sim2 = lines.search_lines_by_projection_batched(
        *[a[None] for a in args], **kw)
    assert torch.equal(idx, idx2)
    assert torch.equal(sim.view(torch.int32), sim2.view(torch.int32))
    idx_p, sim_p = lines.search_lines_by_projection_plain(*args, **kw)
    assert torch.equal(idx[0], idx_p)
    assert chip_smoke._finite_err(sim[0], sim_p) <= chip_smoke.SIM_TOLERANCE
    if case == "tie":
        w = probs["window"][0]
        m, m2, l, l2 = chip_smoke._line_tie_slots(
            *lines.search_lines_by_projection_plain(*w, radius=14.0, **kw0),
            w[8].shape[0])
        assert int(idx[0, min(m, m2)]) == min(l, l2)
        assert int(idx[0, max(m, m2)]) == -1
    if case == "all_nan":
        assert bool(sim.isnan().any()) and not bool((idx >= 0).any())


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", chip_smoke.LIFT_CASES)
def test_lift_lines_planted(dev, case, batch):
    """K22 on chip_smoke.py's planted frames (LIFT_CASES: invalid slots,
    depth holes, endpoints off the image and half-pixel samples, an extent
    at 0.05 m, S = 24 / 16 and 64 / 64 hypotheses) at B = 1 and 4: one
    launch a call, two launches equal bits, has_3d exactly the plain
    version's and endpoints within chip_smoke.P3D_TOLERANCE, each lane of
    B = 4 bit-equal to its B = 1 launch."""
    cfg = SystemConfig()
    args = chip_smoke._lift_args(chip_smoke.planted_lift_lanes(case, batch),
                                 cfg, dev)
    got, n = _launched("lift_lines_3d", lines.lift_lines_3d, *args)
    assert n == 1
    _same_bits(got, lines.lift_lines_3d(*args))
    want = lines.lift_lines_3d_plain(*args)
    assert torch.equal(got[2], want[2])
    for k in (0, 1):
        assert chip_smoke._finite_err(got[k], want[k]) \
            <= chip_smoke.P3D_TOLERANCE
    for b in range(batch if batch > 1 else 0):
        one = lines.lift_lines_3d(*chip_smoke.lift_lane(args, b))
        _same_bits([x[b] for x in got], [x[0] for x in one])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", chip_smoke.SELECT_PLANTED)
def test_match_select_planted(dev, case, batch):
    """K25 on every problem of chip_smoke.py's planted cases
    (SELECT_PLANTED) at B = 1 and 4: one launch a call, two launches
    equal bits, bit-equal to the plain version lane by lane, and each lane
    of B = 4 bit-equal to its B = 1 launch."""
    for p in chip_smoke.planted_select_lanes(case, batch):
        args, kw = chip_smoke._select_args(p, dev)
        got, n = _launched("match_select", matching.match_select, *args,
                           **kw)
        assert n == 1
        _same_bits(got, matching.match_select(*args, **kw))
        for b in range(batch):
            back = None if kw["back"] is None else kw["back"][b]
            want = matching.match_select_plain(
                *[a[b] for a in args], kw["max_dist"], kw["ratio"], back,
                kw["n_targets"])
            _same_bits([x[b] for x in got], want)
            if batch > 1:
                a1, kw1 = chip_smoke.select_lane(args, kw, b)
                one = matching.match_select(*a1, **kw1)
                _same_bits([x[b] for x in got], [x[0] for x in one])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", chip_smoke.FRAME_PLANTED)
def test_frame_match_select_planted(dev, case, batch):
    """K26 on every problem of chip_smoke.py's planted cases
    (FRAME_PLANTED) at B = 1 and 4: one launch a call, two launches equal
    bits, every output written (a launch into outputs filled with NaN
    gives the same bits), bit-equal to the plain version lane by lane,
    and each lane of B = 4 bit-equal to its B = 1 launch."""
    cfg = SystemConfig()
    table = matching.level_inv_sigma2(cfg.orb.scale_factor,
                                      cfg.orb.n_levels, dev)
    for p in chip_smoke.planted_frame_lanes(case, batch):
        fn, plain = chip_smoke.frame_call(p, dev, table)
        got, n = _launched("frame_match_select", fn)
        assert n == 1
        assert chip_smoke.same_bits(got, fn())
        with chip_smoke.poisoned_outputs(matching, "_out"):
            assert chip_smoke.same_bits(got, fn())
        for b, want in enumerate(plain()):
            assert chip_smoke.same_bits([x[b] for x in got], want)
            if batch > 1:
                lane = {k: v[b:b + 1] if isinstance(v, np.ndarray) else v
                        for k, v in p.items()}
                one = chip_smoke.frame_call(lane, dev, table)[0]()
                assert chip_smoke.same_bits([x[b] for x in got],
                                            [x[0] for x in one])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", chip_smoke.TAIL_PLANTED)
def test_finish_step_planted(dev, case, batch):
    """K31 on every problem of chip_smoke.py's planted cases
    (TAIL_PLANTED) at B = 1 and 4: one launch a call, two launches equal
    bits, every output written (a launch into outputs filled with NaN
    gives the same bits), bit-equal to the plain version lane by lane (the
    bundle as int32), and each lane of B = 4 bit-equal to its B = 1
    launch."""
    for c, t, _ in chip_smoke.planted_tail_lanes(case, SystemConfig(),
                                                 batch):
        tail = chip_smoke._tail_of(t, dev)
        got, n = _launched("finish_step", device_tracker.finish_step, tail,
                           c)
        assert n == 1
        assert chip_smoke.same_bits(got, device_tracker.finish_step(tail, c))
        with chip_smoke.poisoned_outputs(device_tracker, "_empty"):
            assert chip_smoke.same_bits(got,
                                        device_tracker.finish_step(tail, c))
        for b in range(batch):
            lane = device_tracker.StepTail(*[x[b:b + 1] for x in tail])
            want = device_tracker.finish_step_plain(
                device_tracker.StepTail(*[x[0] for x in lane]), c)
            _same_bits([x[b] for x in got], want)
            if batch > 1:
                one = device_tracker.finish_step(lane, c)
                assert chip_smoke.same_bits([x[b] for x in got],
                                            [x[0] for x in one])


def test_matching_kernels(dev):
    """K24-K27 on frames 0 -> 1 of the 640x480 room at the default
    configuration's widths (chip_smoke.py's matching_kernel_parity states
    the cases): every output equal to the plain version's bit for bit, two
    launches equal bits."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(2, width=640, height=480)
    n0 = dict(kernels.LAUNCHES)
    out = _held(chip_smoke.matching_kernel_parity, seq, cfg, dev)
    assert [k["name"] for k in out] == ["project_landmarks", "match_select",
                                        "frame_match_select",
                                        "assemble_observations"]
    for k in out:
        assert kernels.LAUNCHES[k["name"]] > n0[k["name"]]


@pytest.mark.parametrize("batch", [2, 4])
def test_matching_kernels_batched(dev, batch):
    """The leading batch count of K24-K27: `batch` window problems (the
    frame 0 -> 1 landmarks tiled with other perturbations) through one
    launch each give what each gives alone."""
    cfg = SystemConfig()
    cam = cfg.camera
    seq = synthetic.make_sequence(2, width=640, height=480)
    probs = [chip_smoke._matching_problems(seq, cfg, dev,
                                           np.random.default_rng(b))
             for b in range(batch)]
    p1, last = probs[0]["f1"].points, probs[0]["last"]
    n = p1.desc.shape[0]
    kw = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
              image_wh=(float(cam.width), float(cam.height)), bf=cam.bf,
              scale_factor=cfg.orb.scale_factor, radius=4.0)

    def stack(f):
        return torch.stack([f(p) for p in probs])

    T = stack(lambda p: p["T_cw"])
    args = (stack(lambda p: p["window"]["pts_w"]),
            stack(lambda p: p["window"]["valid"]), T)
    rng_kw = dict(view_normals=stack(lambda p: p["window"]["view_normals"]),
                  dist_range=(stack(lambda p: p["window"]["dist_range"][0]),
                              stack(lambda p: p["window"]["dist_range"][1])))
    n0 = dict(kernels.LAUNCHES)
    proj = matching.project_landmarks(*args, **kw, **rng_kw)
    top2 = [matching.gated_hamming_top2(
        probs[b]["window"]["descs"], p1.desc, proj.gate_pt[b], p1.valid,
        matching.ProjGate(proj.a_uv[b], proj.a_r[b], proj.a_level[b],
                          proj.a_ur_pred[b], p1.uv, p1.level, p1.u_right, 1))
        for b in range(batch)]
    t3 = [torch.stack(f) for f in zip(*top2)]
    sel = matching.match_select(*t3, 100, n_targets=n)
    table = matching.level_inv_sigma2(cfg.orb.scale_factor, cfg.orb.n_levels,
                                      dev)
    rep = [a[None].expand(batch, *a.shape).contiguous()
           for a in (last.feats.points.angle, p1.angle, p1.uv, p1.u_right,
                     p1.level)]
    ff_in = torch.roll(sel[0][:, :n], 1, 0)  # a 1024-row problem per lane
    fm = matching.frame_match_select(sel[0][:, :n], ff_in, *rep, table)
    pa = matching.assemble_point_obs(
        sel[0], fm.ff_idx, last.pt3d_w[None].expand(batch, -1, -1), args[0],
        p1.valid[None].expand(batch, -1), rep[3], rep[4], table)
    for name in ("project_landmarks", "match_select", "frame_match_select",
                 "assemble_observations"):
        assert kernels.LAUNCHES[name] == n0[name] + 1, name
    for b in range(batch):
        one = matching.project_landmarks(
            *[a[b:b + 1] for a in args], **kw,
            view_normals=rng_kw["view_normals"][b:b + 1],
            dist_range=tuple(d[b:b + 1] for d in rng_kw["dist_range"]))
        for f in one._fields:
            assert torch.equal(getattr(proj, f)[b], getattr(one, f)[0]), f
        one = matching.match_select(*[a[b:b + 1] for a in t3], 100,
                                    n_targets=n)
        assert torch.equal(sel[0][b], one[0][0])
        assert torch.equal(sel[1][b], one[1][0])
        one = matching.frame_match_select(
            sel[0][b:b + 1, :n], ff_in[b:b + 1], *[a[b:b + 1] for a in rep],
            table)
        for f in one._fields:
            assert torch.equal(getattr(fm, f)[b], getattr(one, f)[0]), f
        one = matching.assemble_point_obs(
            sel[0][b:b + 1], fm.ff_idx[b:b + 1], last.pt3d_w[None],
            args[0][b:b + 1], p1.valid[None], rep[3][:1], rep[4][:1], table)
        for f in one._fields:
            assert torch.equal(getattr(pa, f)[b], getattr(one, f)[0]), f
    assert not torch.equal(sel[0][0], sel[0][1])


def test_tail_kernels(dev):
    """K28-K31 at the default configuration's widths (chip_smoke.py's
    tail_kernel_parity states the cases): every output equal to the plain
    version's bit for bit, two launches equal bits."""
    cfg = SystemConfig()
    seq = synthetic.make_sequence(chip_smoke.TAIL_FRAMES, width=640,
                                  height=480)
    n0 = dict(kernels.LAUNCHES)
    out = _held(chip_smoke.tail_kernel_parity, seq, cfg, dev)
    assert [k["name"] for k in out] == ["noise_alpha", "frame_normals",
                                        "associate_planes", "finish_step"]
    for k in out:
        assert kernels.LAUNCHES[k["name"]] > n0[k["name"]]


def test_noise_alpha_frame_size_limit(dev):
    """K28 keeps a frame's strided samples in its cluster's shared memory:
    at 2560x2560 (409600 samples) it is bit-equal to the plain version, at
    2600x2600 (422500, past the 421888 it holds) it raises with the limit
    in the message."""
    rng = np.random.default_rng(28)
    d = torch.from_numpy((2.0 + rng.normal(0, 0.01, (2560, 2560)))
                         .astype(np.float32)).to(dev)
    got = planes._noise_alpha(d, 10.0)
    want = planes.noise_alpha_plain(d, 10.0)
    assert torch.equal(got[None].view(torch.int32),
                       want[None].view(torch.int32))
    with pytest.raises(RuntimeError, match="421888"):
        planes._noise_alpha(torch.full((2600, 2600), 2.0, device=dev), 10.0)


@pytest.mark.parametrize("batch", [2, 3])
def test_tail_kernels_batched(dev, batch):
    """The leading batch count of K28-K31: `batch` frames (the room's
    first), planted associations and random tails through one launch each
    give what each gives alone."""
    cfg = SystemConfig()
    cam = cfg.camera
    seq = synthetic.make_sequence(batch, width=640, height=480,
                                  depth_noise=1.0, noise_model="kinect")
    depth = torch.from_numpy(np.stack([np.asarray(seq.render(b)[1],
                                                  np.float32)
                                       for b in range(batch)])).to(dev)
    assoc = [chip_smoke.planted_plane_problem(np.random.default_rng(b),
                                              chip_smoke.PLANE_CASES[b])
             for b in range(batch)]
    a_args = [torch.from_numpy(np.stack([p[k] for p in assoc])).to(dev)
              for k in chip_smoke.PLANE_KEYS]
    tails = [chip_smoke.random_tail_problem(np.random.default_rng(b), cfg,
                                            b % 2 == 0)
             for b in range(batch)]
    tail = device_tracker.StepTail(*[
        torch.from_numpy(np.stack([np.asarray(t[f]) for t in tails])).to(dev)
        for f in device_tracker.StepTail._fields])
    n_args = (cam, cfg.planes.smooth_window, 13, cfg.manhattan.max_normals)
    n0 = dict(kernels.LAUNCHES)
    alpha = planes._noise_alpha(depth, cfg.planes.max_distance)
    normals, valid = planes.frame_normals(depth, *n_args)
    pa = device_tracker._associate_planes_device(*a_args, cfg.planes)
    out = device_tracker.finish_step(tail, cfg)
    for name in ("noise_alpha", "frame_normals", "associate_planes",
                 "finish_step"):
        assert kernels.LAUNCHES[name] == n0[name] + 1, name
    for b in range(batch):
        assert torch.equal(alpha[b], planes._noise_alpha(
            depth[b], cfg.planes.max_distance))
        n1, v1 = planes.frame_normals(depth[b], *n_args)
        assert torch.equal(normals[b], n1) and torch.equal(valid[b], v1)
        one = device_tracker._associate_planes_device(
            *[a[b:b + 1] for a in a_args], cfg.planes)
        for f in one._fields:
            assert torch.equal(getattr(pa, f)[b], getattr(one, f)[0]), f
        one = device_tracker.finish_step(
            device_tracker.StepTail(*[x[b:b + 1] for x in tail]), cfg)
        assert torch.equal(out.packed[b].view(torch.int32),
                           one.packed[0].view(torch.int32))
        for f in one._fields[1:]:
            assert torch.equal(getattr(out, f)[b], getattr(one, f)[0]), f
    assert alpha[0] != alpha[1]
    assert not torch.equal(pa.direct[0], pa.direct[1])


def _refine_inputs(dev, case, batch, N=1024):
    """`batch` seeded loop-edge refinements (chip_smoke._refine_problem) as
    the K32 wrapper's stacked tensors, and K."""
    rng = np.random.default_rng(32)
    probs = [chip_smoke._refine_problem(rng, N, case) for _ in range(batch)]
    ins = [torch.from_numpy(np.stack([p[i] for p in probs])).to(dev)
           for i in range(6)]
    return (ins[0], torch.ones(batch, device=dev), *ins[1:]), probs[0][6]


@pytest.mark.parametrize("case", ["outliers", "behind", "nonfinite"])
def test_refine_relative(dev, case):
    """K32 against _refine_relative_plain, N = 1024 (the guided rematch's
    width): pose entries within 1e-5, with 10% outliers, a point behind
    both cameras, and a NaN pixel that makes every step's dx non-finite
    (both then return the start exactly); a batch of 3 equals each problem
    launched alone; two launches equal bits."""
    from planarslam_tpu_torch.solvers import sim3_solver

    ins, K = _refine_inputs(dev, case, 3)
    n0 = kernels.LAUNCHES["refine_relative"]
    got = sim3_solver.refine_relative(*ins, K)
    again = sim3_solver.refine_relative(*ins, K)
    assert kernels.LAUNCHES["refine_relative"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for b in range(3):
        want = sim3_solver._refine_relative_plain(*[x[b] for x in ins], K)
        alone = sim3_solver.refine_relative(*[x[b:b + 1] for x in ins], K)
        assert float((got[0][b] - want[0]).abs().max()) <= 1e-5
        assert torch.equal(alone[0][0], got[0][b])
        assert float(got[1][b]) == float(want[1]) == 1.0
        if case == "nonfinite":
            assert torch.equal(got[0][b], ins[0][b])
            assert torch.equal(want[0], ins[0][b])
        else:
            assert not torch.equal(got[0][b], ins[0][b])


def _plane_step(dev, case, Kt=16, Q=8, seed=33, raw=None):
    """A BA problem with plane tables (chip_smoke._ba_problem and
    _plane_problem): its _Problem, poses, plane coefficients, state (points
    and chart coordinates), K8's sums and K. case "q0": no plane block;
    "empty_par": a parallel table without columns. With a list `raw`, the
    raw inputs of _problem are appended to it."""
    from planarslam_tpu_torch.config import PlaneConfig
    from planarslam_tpu_torch.solvers import ba_core

    poses, pts, pt, ln, K = _ba_problem(dev, Kt, 256, 32, 1024, seed=seed)
    prob = chip_smoke._plane_problem(np.random.default_rng(seed), Kt, 16, Q,
                                     par_cols=0 if case == "empty_par"
                                     else None, poses=poses.cpu().numpy())
    base = torch.from_numpy(prob["base"]).to(dev)
    theta = torch.from_numpy(prob["theta"]).to(dev)
    if case == "q0":
        base, theta = base[:0], theta[:0]
    pl, par, ver = chip_smoke._plane_tables(prob, dev)
    w = ba_core.BAWeights.from_config(PlaneConfig())
    pb = ba_core._problem(pts, base, pt, ln, pl, par, ver, w)
    if raw is not None:
        raw.append((pts, base, pt, ln, pl, par, ver, w))
    lm = torch.cat([pts, theta]).contiguous()
    sums = ba_core.ba_normal_eqs_plain(poses, pts, pb.pt, pb.ln, pb.M, K,
                                       40.0)[:5]
    return pb, poses, base, lm, sums, K


def _batched_problem(raw):
    """The batched _Problem of problems of one shape (their raw inputs)."""
    from planarslam_tpu_torch.solvers import ba_core

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return type(xs[0])(*[stack(*f) for f in zip(*xs)])

    return ba_core._problem(*[stack(*x) for x in zip(*[r[:7] for r in raw])],
                            raw[0][7])


@pytest.mark.parametrize("case", ["tables", "q0", "empty_par"])
def test_ba_plane_blocks(dev, case):
    """K33 against plane_blocks_plain on 16 keyframes, 3 x 16 plane
    observation slots, Q = 8 (planted hemisphere flips and vertical
    pairs): every sum and record within 1e-5 of its largest value, on
    zeroed sums (the plane blocks alone) and on K8's, mu_p too; Q = 0
    launches only the mu_p pass; an empty parallel table adds nothing;
    two launches equal bits; a batch of two problems equals each alone."""
    from planarslam_tpu_torch.solvers import ba_core

    pb, poses, base, lm, sums, _ = _plane_step(dev, case)
    theta = lm[pb.P:]
    for start in ([torch.zeros_like(x) for x in sums], sums):
        n0 = kernels.LAUNCHES["ba_plane_blocks"]
        got = ba_core.ba_plane_blocks(pb, poses, base, theta,
                                      *[x.clone() for x in start], True)
        assert kernels.LAUNCHES["ba_plane_blocks"] == n0 + (
            1 if case == "q0" else 2)
        again = ba_core.ba_plane_blocks(pb, poses, base, theta,
                                        *[x.clone() for x in start], True)
        want = ba_core.plane_blocks_plain(pb, poses, base, theta,
                                          *[x.clone() for x in start], True)
        for g, a, w in zip(got[:5] + (got[6],), again[:5] + (again[6],),
                           want[:5] + (want[6],)):
            assert _rel(g, w) <= 1e-5
            assert torch.equal(g, a)
        assert len(got[5]) == len(want[5]) == (
            0 if case == "q0" else 2 if case == "empty_par" else 3)
        for g, w in zip(got[5], want[5]):
            assert torch.equal(g.slot, w.slot)
            for x, y in zip(g[1:], w[1:]):
                assert _rel(x, y) <= 1e-5
    if case == "q0":
        assert all(torch.equal(g, s) for g, s in zip(got[:5], sums))
    # a batch of two problems equals each launched alone
    raw = []
    steps = [_plane_step(dev, case, seed=seed, raw=raw) for seed in (33, 36)]
    bpb = _batched_problem(raw)
    stacked = [torch.stack(x) for x in zip(*[
        (p[1], p[2], p[3][p[0].P:].contiguous(), *p[4]) for p in steps])]
    got = ba_core.ba_plane_blocks(bpb, *stacked, True)
    for b, (pb1, poses1, base1, lm1, sums1, _) in enumerate(steps):
        one = ba_core.ba_plane_blocks(pb1, poses1, base1, lm1[pb1.P:],
                                      *[x.clone() for x in sums1], True)
        for g, o in zip(got[:5] + (got[6],), one[:5] + (one[6],)):
            assert torch.equal(g[b], o)
        for g, o in zip(got[5], one[5]):
            for x, y in zip(g[1:], o[1:]):
                assert torch.equal(x[b], y)


@pytest.mark.parametrize("case", ["accepted", "rejected"])
def test_ba_cost_test(dev, case):
    """K34 against cost_test_plain on the plane problem: a step that
    undoes a planted pose error is accepted, a 0.3 rad step rejected (lam
    x 6, the state kept exactly); the decrease within 2 (n - 1) 2^-24 of
    the sum of the |rho| terms, the selected state equal; the tables mode
    within 1e-6 of each table's largest chi2; two launches equal bits; a
    batch of two problems equals each alone, in both modes."""
    from planarslam_tpu_torch.geometry import se3
    from planarslam_tpu_torch.solvers import ba_core

    pb, poses, base, lm, _, K = _plane_step(dev, "tables")
    rng = np.random.default_rng(34)
    Kt, M = poses.shape[0], pb.M
    delta = torch.from_numpy(rng.normal(
        0, 0.3 if case == "rejected" else 0.002, (Kt, 6)).astype(
            np.float32)).to(dev)
    if case == "accepted":
        poses = (se3.se3_exp(delta) @ poses).contiguous()
        delta = -delta
    dxp = torch.from_numpy(rng.normal(0, 1e-4, (M, 3)).astype(
        np.float32)).to(dev)
    lam = torch.tensor(1e-3, device=dev)
    args = (pb, poses, lm, delta, dxp, lam, base, K, 40.0, True)
    n0 = kernels.LAUNCHES["ba_cost_test"]
    got = ba_core.ba_cost_test(*args)
    again = ba_core.ba_cost_test(*args)
    assert kernels.LAUNCHES["ba_cost_test"] == n0 + 2
    want = ba_core.cost_test_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    chis = [ba_core._chi2(pb, p, x, base, K, 40.0, pb.w)
            for p, x in ((se3.se3_exp(delta) @ poses, lm + dxp),
                         (poses, lm))]
    rho = [ba_core._rho_fn(c, g, m, True) for cs in chis
           for c, g, m in zip(cs, pb.gates, pb.masks)]
    n = sum(int(r.numel()) for r in rho)
    bound = 2 * (n - 1) * 2.0 ** -24 * float(sum(r.abs().sum() for r in rho))
    assert abs(float(got.decrease) - float(want.decrease)) <= bound
    assert abs(float(want.decrease)) > bound
    assert bool(got.accept) == bool(want.accept) == (case == "accepted")
    assert torch.equal(got.lam, want.lam) and torch.equal(got.lm, want.lm)
    assert float((got.poses - want.poses).abs().max()) <= 1e-5
    if case == "rejected":
        assert torch.equal(got.poses, poses) and torch.equal(got.lm, lm)
        assert float(got.lam) == float(np.float32(1e-3) * np.float32(6.0))
    chi_k = ba_core.ba_chi2_tables(pb, poses, lm, base, K, 40.0)
    chi_p = ba_core._chi2(pb, poses, lm, base, K, 40.0, pb.w)
    for a, b in zip(chi_k, chi_p):
        assert _rel(a, b) <= 1e-6
    # a batch of this problem and another equals each launched alone
    raw = []
    other = _plane_step(dev, "tables", seed=37, raw=raw)
    _plane_step(dev, "tables", raw=raw)
    bpb = _batched_problem([raw[1], raw[0]])
    states = [(poses, lm, delta, dxp, lam, base),
              (other[1], other[3], delta, dxp, lam, other[2])]
    batch = [torch.stack(x).contiguous() for x in zip(*states)]
    got_b = ba_core.ba_cost_test(bpb, *batch, K, 40.0, True)
    chi_b = ba_core.ba_chi2_tables(bpb, batch[0], batch[1], batch[5], K,
                                   40.0)
    for b, (p1, (ps, x, dc, dp, lm_, bs)) in enumerate(zip(
            (pb, other[0]), states)):
        one = ba_core.ba_cost_test(p1, ps, x, dc, dp, lm_, bs, K, 40.0, True)
        assert all(torch.equal(g[b], o) for g, o in zip(got_b, one))
        chi1 = ba_core.ba_chi2_tables(p1, ps, x, bs, K, 40.0)
        assert all(torch.equal(g[b], o) for g, o in zip(chi_b, chi1))


def test_ba_reduced_system(dev):
    """K35 against reduced_system_plain on Kt = 16 (S = -A A^T, PSD Hcc
    blocks), every pose fixed but one, and with the first pose fixed: S
    within 4 ulps, the fixed rows and columns exactly the identity, rhs
    exact; a batch of two equals each alone; two launches equal bits."""
    from planarslam_tpu_torch.solvers import ba_core

    rng = np.random.default_rng(35)
    Kt, n = 16, 96

    def problem(fixed):
        A = rng.normal(0, 1, (n, 2 * n))
        B = rng.normal(0, 1, (Kt, 6, 8))
        f32 = np.float32
        return [torch.from_numpy(x.astype(f32)).to(dev) for x in (
            -(A @ A.T), np.einsum("kab,kcb->kac", B, B) + 50 * np.eye(6),
            rng.normal(0, 1, (Kt, 6)), np.array(1e-3), fixed)]

    all_but_one = np.ones(Kt)
    all_but_one[5] = 0.0
    first = np.zeros(Kt)
    first[0] = 1.0
    probs = [problem(all_but_one), problem(first)]
    batch = [torch.stack([p[i] for p in probs]) for i in range(5)]
    n0 = kernels.LAUNCHES["ba_reduced_system"]
    got = ba_core.ba_reduced_system(*batch)
    again = ba_core.ba_reduced_system(*batch)
    assert kernels.LAUNCHES["ba_reduced_system"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    eye = torch.eye(n, device=dev)
    for b, p in enumerate(probs):
        want = ba_core.reduced_system_plain(*p)
        alone = ba_core.ba_reduced_system(*p)
        assert torch.equal(alone[0], got[0][b])
        assert torch.equal(alone[1], got[1][b])
        assert float(chip_smoke._ulps(got[0][b], want[0]).max()) <= 4
        assert torch.equal(got[1][b], want[1])
        rows = torch.repeat_interleave(p[4], 6) > 0
        assert torch.equal(got[0][b][rows], eye[rows])
        assert torch.equal(got[0][b][:, rows], eye[:, rows])


# --------------------------------------------------------------------------
# the leading batch of K3, K4, K11-K15 and K36: one launch for B problems,
# each problem's result the bits it has alone


def _launched(name, fn, *args, **kw):
    """fn's result and how many `name` launches it made."""
    n0 = kernels.LAUNCHES[name]
    out = fn(*args, **kw)
    return out, kernels.LAUNCHES[name] - n0


def _same_bits(got, want):
    for g, w in zip(got, want):
        if g is None:
            assert w is None
            continue
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_gated_hamming_top2_batched(dev, batch):
    """K3 over B gated problems of 1024 x 512 in one launch: each problem's
    rows equal its own launch and the plain version exactly."""
    rng = np.random.default_rng(40 + batch)
    M, N = 1024, 512

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    a = rng.integers(-2 ** 31, 2 ** 31, (batch, M, 8)).astype(np.int32)
    src = rng.integers(0, M, (batch, N))
    flips = (rng.random((batch, N, 8)) < 0.2) * rng.integers(
        0, 2 ** 31, (batch, N, 8))
    b = (np.take_along_axis(a, src[..., None], 1) ^ flips).astype(np.int32)
    a_uv = rng.uniform(0, [640, 480], (batch, M, 2)).astype(np.float32)
    lvl = rng.integers(0, 8, (batch, M)).astype(np.int32)
    b_uv = np.take_along_axis(a_uv, src[..., None], 1) + rng.normal(
        0, 3, (batch, N, 2))
    gate = matching.ProjGate(
        a_uv=t(a_uv), a_r=t((5.0 * 1.2 ** lvl).astype(np.float32)),
        a_level=t(lvl), a_ur_pred=t(a_uv[..., 0] - 20.0),
        b_uv=t(b_uv.astype(np.float32)),
        b_level=t(np.take_along_axis(lvl, src, 1)),
        b_ur=t(np.full((batch, N), -1.0, np.float32)), level_window=1)
    a_ok = t(rng.random((batch, M)) < 0.9)
    b_ok = t(rng.random((batch, N)) < 0.9)
    got, n = _launched("gated_hamming_top2", matching.gated_hamming_top2,
                       t(a), t(b), a_ok, b_ok, gate)
    assert n == 1 and got[0].shape == (batch, M)
    for i in range(batch):
        g_i = matching.ProjGate(*[x[i] for x in gate[:-1]], 1)
        one = matching.gated_hamming_top2(t(a[i]), t(b[i]), a_ok[i],
                                          b_ok[i], g_i)
        plain = matching.gated_hamming_top2_plain(t(a[i]), t(b[i]), a_ok[i],
                                                  b_ok[i], g_i)
        _same_bits([x[i] for x in got], one)
        _same_bits([x[i] for x in got], plain)


def _depths(dev, batch):
    cfg = SystemConfig()
    factor = cfg.camera.depth_map_factor
    frames = []
    for i in range(batch):
        seq = synthetic.make_sequence(2, width=640, height=480, seed=11 + i)
        d = np.round(np.array(seq.render(1)[1], np.float32) * factor)
        d = (d / factor).astype(np.float32)
        frames.append(chip_smoke.noisy_depth(d, factor, seed=i) if i % 2
                      else d)
    return torch.from_numpy(np.stack(frames)).to(dev)


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_plane_block_moments_batched(dev, batch):
    """K4 over B 480x640 depths in one launch (the grid's third axis):
    each frame equals its own launch bit for bit, counts equal the plain
    version's, sums within 1e-5 of their largest magnitude."""
    cfg = SystemConfig()
    depth = _depths(dev, batch)
    alpha = planes._noise_alpha(depth, cfg.planes.max_distance)
    kw = dict(cam=cfg.camera, geo_tol=0.02,
              max_distance=cfg.planes.max_distance, block=8)
    got, n = _launched("plane_block_moments", planes.plane_block_moments,
                       depth, alpha, **kw)
    assert n == 1 and got.n.shape == (batch, 4800)
    for i in range(batch):
        one = planes.plane_block_moments(depth[i], alpha[i], **kw)
        _same_bits([x[i] for x in got], one)
        want = planes.plane_block_moments_plain(depth[i], alpha[i], **kw)
        torch.testing.assert_close(got.n[i], want.n, rtol=0, atol=0)
        for g, w in ((got.s1[i], want.s1), (got.s2[i], want.s2)):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_pose_optimize_batched(dev, batch):
    """K11 over B seeded problems at the main path's width in one launch
    of B blocks, the rotation flag per lane: each lane equals its own
    launch bit for bit, and its plain version within the single problem's
    limits (pose 1e-4, masks exact)."""
    from planarslam_tpu_torch.solvers import pose_opt

    cam = SystemConfig().camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    probs = [_pose_problem(K, cam.bf, seed=i, n=1024, n_lines=64,
                           n_planes=16) for i in range(batch)]

    def t(*a):
        return torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(dev)

    T0 = t(*[p[0] for p in probs])
    blocks = [cls(*[t(*[p[k][f] for p in probs])
                    for f in range(len(probs[0][k]))])
              for k, cls in ((1, pose_opt.PointObs), (2, pose_opt.LineObs),
                             (3, pose_opt.PlaneObs), (4, pose_opt.PlaneObs),
                             (5, pose_opt.PlaneObs))]
    flag = torch.tensor([i % 2 == 1 for i in range(batch)], device=dev)
    names = ("points", "lines", "planes", "par_planes", "ver_planes")
    got, n = _launched("pose_optimize", pose_opt.pose_optimize, T0, K,
                       cam.bf, **dict(zip(names, blocks)),
                       rotation_fixed=flag)
    assert n == 1 and got.T_cw.shape == (batch, 4, 4)
    for i in range(batch):
        lane = {k: type(b)(*[x[i] for x in b]) for k, b in zip(names,
                                                                blocks)}
        one = pose_opt.pose_optimize(T0[i], K, cam.bf, **lane,
                                     rotation_fixed=flag[i])
        _same_bits([x[i] for x in got], one)
        want = pose_opt._pose_optimize_plain(T0[i], K, cam.bf, **lane,
                                             rotation_fixed=flag[i])
        torch.testing.assert_close(one.T_cw, want.T_cw, rtol=0, atol=1e-4)
        assert torch.equal(one.point_inlier, want.point_inlier)


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_plane_segment_batched(dev, batch):
    """extract_planes over B 480x640 depths (clean and noisy): one launch
    of K4, K12 and K14 and 1 + refine_rounds of K13 for all frames, and
    each frame's planes and labels the bits of extract_planes on it
    alone."""
    cfg = SystemConfig()
    pc = cfg.planes
    depth = _depths(dev, batch)
    n0 = dict(kernels.LAUNCHES)
    got = planes.extract_planes(depth, cfg.camera, pc)
    for name, n in (("plane_block_moments", 1), ("plane_components", 1),
                    ("plane_assign_refit", 1 + pc.refine_rounds),
                    ("plane_label_pixels", 1)):
        assert kernels.LAUNCHES[name] == n0[name] + n, name
    assert got.pixel_label.shape == (batch, 480, 640)
    for i in range(batch):
        one = planes.extract_planes(depth[i], cfg.camera, pc)
        assert int(one.valid.sum()) >= 2
        _same_bits([x[i] for x in got], one)


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_manhattan_mean_shift_batched(dev, batch):
    """K15 over B frames' normals and line directions (N = 2112) in one
    launch, with the step's initial-pose epilogue: each frame equals its
    own launch bit for bit, R_cm within 1e-5 of the plain version, the
    epilogue's T_init and use_manh bit-equal to init_select_plain on the
    kernel's own R_cm and success."""
    from planarslam_tpu_torch.ops import manhattan
    from planarslam_tpu_torch.slam.frame import extract_frame

    cfg = SystemConfig()
    mc = cfg.manhattan
    grays, depths = [], []
    for i in range(batch):
        seq = synthetic.make_sequence(2, width=640, height=480, seed=11 + i)
        g, d = seq.render(1)
        grays.append(np.asarray(g, np.float32))
        depths.append(np.asarray(d, np.float32))
    feats = extract_frame(torch.from_numpy(np.stack(grays)).to(dev),
                          torch.from_numpy(np.stack(depths)).to(dev), cfg)
    rng = np.random.default_rng(batch)
    eye = torch.eye(4, device=dev).expand(batch, 4, 4)
    pre = device_tracker.step_prelude(
        eye.contiguous(), torch.zeros(batch, dtype=torch.bool, device=dev),
        eye.contiguous(), eye.contiguous(), feats.lines.p3d_s,
        feats.lines.p3d_e, feats.lines.has_3d, feats.lines.valid,
        feats.normals, feats.normals_valid,
        torch.eye(3, device=dev).expand(batch, 3, 3).contiguous())
    T_pred = torch.from_numpy(np.stack([_pose(rng) for _ in range(batch)]
                                       ).astype(np.float32)).to(dev)
    R_wm = torch.from_numpy(np.stack([_pose(rng)[:3, :3]
                                      for _ in range(batch)]
                                     ).astype(np.float32)).to(dev)
    init = manhattan.InitSelect(T_pred, R_wm,
                                torch.arange(batch, device=dev) % 2 == 0)
    kw = dict(cone_sin=mc.cone_sin_track, kernel=mc.mean_shift_kernel,
              min_support=mc.min_axis_support)
    R0 = pre.R_init
    got, n = _launched("manhattan_mean_shift",
                       manhattan.track_manhattan_frame, R0, pre.dirs,
                       pre.dirs_valid, init=init, **kw)
    assert n == 1 and got.R_cm.shape == (batch, 3, 3)
    for i in range(batch):
        init_i = manhattan.InitSelect(*[x[i] for x in init])
        one = manhattan.track_manhattan_frame(R0[i], pre.dirs[i],
                                              pre.dirs_valid[i],
                                              init=init_i, **kw)
        _same_bits([None if x is None else x[i] for x in got], one)
        plain = manhattan.track_manhattan_frame_plain(
            R0[i], pre.dirs[i], pre.dirs_valid[i], **kw)
        torch.testing.assert_close(one.R_cm, plain.R_cm, rtol=0, atol=1e-5)
        assert torch.equal(one.success, plain.success)
        _same_bits(manhattan.init_select_plain(one.R_cm, one.success,
                                               init_i),
                   (one.T_init, one.use_manh))


def test_step_prelude_kernel(dev):
    """K36 at the main path's width (64 lines, 2048 normals) on four
    seeded lanes (the override on and off, zero-length and short lines, a
    NaN endpoint) equals step_prelude_plain bit for bit in every output;
    one launch per call; two launches equal bits."""
    rng = np.random.default_rng(36)
    B, L, Nn = 4, 64, 2048

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    p3d_s = rng.normal(size=(B, L, 3)).astype(np.float32)
    p3d_e = (p3d_s + rng.normal(scale=0.3, size=(B, L, 3))).astype(
        np.float32)
    p3d_e[:, 0] = p3d_s[:, 0]
    p3d_e[:, 1] = p3d_s[:, 1] + 0.05
    p3d_e[0, 2, 0] = np.nan
    normals = rng.normal(size=(B, Nn, 3)).astype(np.float32)
    poses = [np.stack([_pose(rng) for _ in range(B)]).astype(np.float32)
             for _ in range(3)]
    args = [t(poses[0]), t(np.array([True, False, True, False])),
            t(poses[1]), t(poses[2]), t(p3d_s), t(p3d_e),
            t(rng.random((B, L)) > 0.2), t(rng.random((B, L)) > 0.2),
            t(normals / np.linalg.norm(normals, axis=-1, keepdims=True)),
            t(rng.random((B, Nn)) > 0.3),
            t(np.stack([_pose(rng)[:3, :3] for _ in range(B)]).astype(
                np.float32))]
    got, n = _launched("step_prelude", device_tracker.step_prelude, *args)
    again = device_tracker.step_prelude(*args)
    assert n == 1
    want = device_tracker.step_prelude_plain(*args)
    _same_bits(got, want)
    _same_bits(got, again)


@pytest.mark.parametrize("widths", chip_smoke.PRELUDE_WIDTHS)
def test_step_prelude_planted_widths(dev, widths):
    """K36 on chip_smoke.py's planted lanes at each PRELUDE_WIDTHS (the
    main path's, 2047 normals on its scalar path, no line and one; NaN,
    zero-length and 0.1 m edge lines): one launch a call, bit-equal to
    step_prelude_plain in every output at B = 4, each lane equal to its own
    launch."""
    nn, n_l = widths
    args = chip_smoke._planted_prelude(dev, 4, n_l, nn)
    got, n = _launched("step_prelude", device_tracker.step_prelude, *args)
    assert n == 1
    _same_bits(got, device_tracker.step_prelude_plain(*args))
    for b in range(4):
        one = device_tracker.step_prelude(*[x[b:b + 1].contiguous()
                                            for x in args])
        _same_bits([x[b:b + 1] for x in got], one)


@pytest.mark.parametrize("batch", [1, 4])
def test_orb_describe_planted(dev, batch):
    """K2 on every chip_smoke.ORB_PLANTED problem (chip_smoke.py's
    orb_planted_parity states the limits: angles 1e-4, >= 99% of the
    valid descriptors, the ORB_EXACT cases bit-equal, empty slots 0; at
    B = 1 into outputs filled with NaN, at B = 4 each lane equal to its
    own launch)."""
    out = _held(chip_smoke.orb_planted_parity, dev, batch)
    assert set(out) == set(chip_smoke.ORB_PLANTED)
    assert all(out[c]["bit_equal"] for c in chip_smoke.ORB_EXACT)


def _decoded(out):
    gray, depth, win = out
    return [gray, depth, *win]


@pytest.mark.parametrize("shape", [(480, 640), (481, 643), (48, 64)])
@pytest.mark.parametrize("batch", [1, 3])
def test_decode_step_inputs(dev, shape, batch):
    """K37 on packed frames (seeded grey and uint16 depth; 481 x 643 takes
    the scalar path) and chip_smoke.py's planted windows (flags 0, 0.5,
    the float above, 1 and NaN; cloud counts 0, 1 and 128): one launch a
    call, bit-equal to decode_step_inputs_plain in every output (NaN
    window entries by their bits), each lane of a batch equal to its own
    launch, two launches equal bits."""
    cfg = SystemConfig()
    rng = np.random.default_rng(37 + batch)
    h, w = shape
    frames = np.stack([device_tracker.pack_frame(
        rng.integers(0, 256, (h, w), dtype=np.uint8),
        rng.integers(0, 65536, (h, w), dtype=np.uint16))
        for _ in range(batch)])
    wins = np.stack([chip_smoke.planted_window(cfg, 40 + b)
                     for b in range(batch)])
    f = torch.from_numpy(frames).to(dev)
    win = torch.from_numpy(wins).to(dev)
    got, n = _launched("decode_step_inputs", device_tracker.decode_step_inputs,
                       f, win, cfg)
    assert n == 1
    got = _decoded(got)
    _same_bits(got, _decoded(device_tracker.decode_step_inputs_plain(
        f, win, cfg)))
    _same_bits(got, _decoded(device_tracker.decode_step_inputs(f, win, cfg)))
    for b in range(batch):
        one = _decoded(device_tracker.decode_step_inputs(f[b:b + 1],
                                                         win[b:b + 1], cfg))
        _same_bits([x[b:b + 1] for x in got], one)


@pytest.mark.parametrize("shape", [(480, 640), (481, 643)])
def test_decode_step_inputs_shared_window(dev, shape):
    """K37's shared-window mode: C = 8 frames against one (1, S) window in
    one launch, bit-equal to decode_step_inputs_plain and to K37 on the
    window repeated C times (every lane's window fields equal the shared
    row), two launches equal bits."""
    cfg = SystemConfig()
    rng = np.random.default_rng(47)
    h, w = shape
    f = torch.from_numpy(np.stack([device_tracker.pack_frame(
        rng.integers(0, 256, (h, w), dtype=np.uint8),
        rng.integers(0, 65536, (h, w), dtype=np.uint16))
        for _ in range(8)])).to(dev)
    win = torch.from_numpy(chip_smoke.planted_window(cfg, 48)[None]).to(dev)
    got, n = _launched("decode_step_inputs", device_tracker._decode, win,
                       cfg, frame=f)
    assert n == 1
    got = _decoded(got)
    assert all(x.shape[0] == 1 for x in got[2:])
    _same_bits(got, _decoded(device_tracker.decode_step_inputs_plain(
        f, win, cfg)))
    _same_bits(got, _decoded(device_tracker._decode(win, cfg, frame=f)))
    rep = _decoded(device_tracker._decode(win.expand(8, -1).contiguous(),
                                          cfg, frame=f))
    _same_bits(got[:2], rep[:2])
    for x, y in zip(got[2:], rep[2:]):
        for b in range(8):
            _same_bits([x[0]], [y[b]])


def test_captured_chunk_replay_equals_eager(dev):
    """A CapturedChunk (C = 4, two slots) at the tiny config: a System's
    carried state and window after 5 streamed frames, then three replays
    on the next frames (the ring twice round the first slot) bit-equal to
    the eager fused_track_chunk_packed chained from the same state
    (bundles, per-frame and final state leaves); a replay adds the
    launches its capture recorded (the first also its warm-up chunk's),
    and each slot's bundles and per-frame states keep their bits under the
    other slot's replays."""
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System

    cfg = SystemConfig.tiny()
    seq = synthetic.make_sequence(17, width=160, height=120)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(17)]
    slam = System(config=cfg, enable_local_mapping=False,
                  enable_loop_closing=False, device=dev)
    for i in range(5):
        slam.track_rgbd(*frames[i], seq.timestamps[i])
    slam.shutdown()
    tr = slam.tracker
    tr._refresh_window()
    _, _, R_wm, manh = tr._step_consts()
    state, win, weights = tr._fused_state, tr._window, tr._pose_weights
    packs = [np.stack([device_tracker.pack_frame(*frames[i])
                       for i in range(k, k + 4)]) for k in (5, 9, 13)]
    eager = []
    st = state
    for p in packs:
        eager.append(device_tracker.fused_track_chunk_packed(
            torch.from_numpy(p).to(dev), R_wm, manh, st, win, weights, cfg))
        st = eager[-1].final_state
    graph = device_tracker.CapturedChunk(4, cfg, weights, dev, slots=2)
    graph.set_state(state)
    graph.set_inputs(win, R_wm, manh)
    # a slot holds its bundles and per-frame states; its final_state is
    # the graphs' shared carry, which every replay rewrites
    n_slot = 1 + len(device_tracker.state_leaves(eager[0].states))
    kept = {}
    for k, p in enumerate(packs):
        slot = graph.next_slot
        n0 = dict(kernels.LAUNCHES)
        out = graph.replay(p)
        torch.cuda.synchronize()
        # the first replay captures the ring after an eager warm-up chunk
        assert {name: kernels.LAUNCHES[name] - n for name, n in n0.items()
                if kernels.LAUNCHES[name] != n} == {
            name: (2 if k == 0 else 1) * n
            for name, n in graph.per_replay.items()}
        leaves = chip_smoke._chunk_leaves
        _same_bits(leaves(out), leaves(eager[k]))
        kept[slot] = [x.clone() for x in leaves(out)[:n_slot]]
        for other, held in kept.items():
            _same_bits(leaves(graph.outs[other])[:n_slot], held)
    assert graph.per_replay["decode_step_inputs"] == 1
    assert graph.per_replay["finish_step"] == 4


def test_decode_step_inputs_all_depths(dev):
    """K37's depth on a frame holding every uint16 value: raw times
    float32(1) / float32(5000) in one rounding, bit for bit, and the same
    through the unpacked int32 entry."""
    cfg = SystemConfig()
    fr = torch.from_numpy(chip_smoke.all_depths_frame()[None]).to(dev)
    win = torch.from_numpy(chip_smoke.planted_window(cfg)[None]).to(dev)
    gray, depth, _ = device_tracker.decode_step_inputs(fr, win, cfg)
    raw = np.arange(65536, dtype=np.float32).reshape(1, 256, 256)
    want = raw * (np.float32(1) / np.float32(cfg.camera.depth_map_factor))
    np.testing.assert_array_equal(depth.cpu().numpy().view(np.int32),
                                  want.view(np.int32))
    d32 = torch.from_numpy(np.arange(65536, dtype=np.int32).reshape(
        1, 256, 256)).to(dev)
    _, d2, _ = device_tracker._decode(win, cfg, gray=gray, depth=d32)
    _same_bits([d2], [depth])


@pytest.mark.parametrize("batch", [1, 3])
def test_lift_state(dev, batch):
    """K38 on seeded features (some without depth, some invalid) at B
    poses: bit-equal to lift_state_plain lane by lane; one launch."""
    cfg = SystemConfig()
    rng = np.random.default_rng(38)
    K = 1024

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    uv = t(rng.uniform(0, [640, 480], (batch, K, 2)).astype(np.float32))
    depth = t(np.where(rng.random((batch, K)) < 0.8,
                       rng.uniform(0.3, 6, (batch, K)), 0).astype(
                           np.float32))
    valid = t(rng.random((batch, K)) < 0.9)
    T = t(np.stack([_pose(rng) for _ in range(batch)]))
    got, n = _launched("lift_state", device_tracker.lift_state, uv, depth,
                       valid, T, cfg)
    assert n == 1
    for b in range(batch):
        want = device_tracker.lift_state_plain(uv[b], depth[b], valid[b],
                                               T[b], cfg)
        _same_bits([x[b] for x in got], want)


@pytest.mark.parametrize("case", chip_smoke.SEED_PLANTED)
def test_seed_manhattan_planted(dev, case):
    """K39 on chip_smoke.py's planted direction sets: R_seed within 1e-6
    of seed_manhattan_plain, ok, the picks and the direction set exact;
    one launch."""
    from planarslam_tpu_torch.ops import manhattan

    args = [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
            for a in chip_smoke.planted_seed_problem(case, SystemConfig())]
    got, n = _launched("seed_manhattan", manhattan.seed_manhattan, *args)
    assert n == 1
    want = manhattan.seed_manhattan_plain(*[a[0] for a in args])
    torch.testing.assert_close(got.R_seed[0], want.R_seed, rtol=0,
                               atol=chip_smoke.SEED_TOLERANCE)
    _same_bits([got.ok[0], got.picks[0], got.dirs[0], got.dirs_valid[0]],
               [want.ok, want.picks, want.dirs, want.dirs_valid])


def test_rotation_bins_at_edges(dev):
    """The 270 edge rotations and the denormal ones binned as JAX bins
    them (chip_smoke.JAX_EDGE_BINS): the plain bins on the card and K26's
    through its filter mode (chip_smoke.edge_bin_parity)."""
    got = chip_smoke.edge_bin_parity(dev)
    assert got["k26_equal_jax"] == got["plain_equal_jax"] == got["values"]


def test_fuse_search_over_targets(dev):
    """The fuse set's search with the five targets as the leading batch
    (one launch each of K24, K3 and K25) equals five searches, one a
    target, on a seeded landmark set; a target with nb_ok False matches
    nothing."""
    from planarslam_tpu_torch.slam import device_mapper

    cfg = SystemConfig()
    rng = np.random.default_rng(21)
    K, NB = cfg.orb.max_keypoints, device_mapper.N_NEIGHBORS
    layout = device_mapper.FuseSetInputLayout(cfg)
    T = np.stack([_pose(rng, trans=0.05) for _ in range(NB)])
    xyz = rng.uniform([-2, -1.5, 2], [2, 1.5, 5], (K, 3)).astype(np.float32)
    pc = np.einsum("bij,kj->bki", T[:, :3, :3], xyz) + T[:, None, :3, 3]
    cam = cfg.camera
    uv = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                   cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1)
    uv += rng.normal(scale=1.0, size=uv.shape)
    desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint32)
    nb_desc = np.repeat(desc[None], NB, 0) ^ (
        rng.random((NB, K, 8)) < 0.01).astype(np.uint32)
    flat = layout.pack({
        "lm_xyz": xyz, "lm_desc": desc, "lm_valid": rng.random(K) < 0.9,
        "nb_T": T, "nb_uv": uv.astype(np.float32), "nb_desc": nb_desc,
        "nb_level": rng.integers(0, 3, (NB, K)),
        "nb_valid": rng.random((NB, K)) < 0.95,
        "nb_ur": np.full((NB, K), -1, np.float32),
        "nb_ok": np.array([True, True, False, True, True])})
    ft = torch.from_numpy(flat).to(dev)
    before = dict(kernels.LAUNCHES)
    got = device_mapper.fuse_set_step_packed(ft, cfg)
    assert {k: kernels.LAUNCHES[k] - before[k] for k in chip_smoke.
            FUSE_SET_LAUNCHES} == chip_smoke.FUSE_SET_LAUNCHES
    with chip_smoke.per_target_matching():
        want = device_mapper.fuse_set_step_packed(ft, cfg)
    assert torch.equal(got, want)
    assert bool((got[2] == -1).all()) and int((got >= 0).sum()) > 1000


@pytest.mark.parametrize("case", ("random",) + chip_smoke.SCHUR_PLANTED)
def test_schur_complement_planted(dev, case):
    """K40 on chip_smoke's planted problems (first LM step, 16 keyframes):
    one launch, each entry within 2 (n - 1) 2^-24 of the sum of its |terms|
    of the dense product, within one ulp of the emulation of its order
    (chip_smoke.complement_emulation, whose fused multiply-add rounds
    twice), blocks of pairs that share nothing exactly 0, two launches
    equal bits."""
    from planarslam_tpu_torch.solvers import ba_core

    st = chip_smoke.schur_step(chip_smoke.planted_schur_problem(case, dev))
    plan = st["pb"].pairs
    n0 = kernels.LAUNCHES["ba_schur_complement"]
    got = ba_core.ba_schur_complement(st["HcpHinv"], st["Hcp"], plan)
    assert kernels.LAUNCHES["ba_schur_complement"] == n0 + 1
    again = ba_core.ba_schur_complement(st["HcpHinv"], st["Hcp"], plan)
    want = ba_core.ba_schur_complement_plain(st["HcpHinv"], st["Hcp"])
    inc = ba_core.plan_incidence(plan, st["Hcp"].shape[2])
    bound, shared = chip_smoke.complement_bound(st["HcpHinv"], st["Hcp"],
                                                inc)
    assert torch.equal(got, again)
    assert bool(((got.double() - want.double()).abs() <= bound).all())
    emu = chip_smoke.complement_emulation(
        st["HcpHinv"].cpu().numpy(), st["Hcp"].cpu().numpy(),
        inc.cpu().numpy())
    g = got.cpu().numpy()
    ulp = np.spacing(np.abs(emu).astype(np.float32))
    assert np.all(np.abs(g.astype(np.float64) - emu) <= ulp)
    alone = torch.repeat_interleave(torch.repeat_interleave(
        shared == 0, 6, 0), 6, 1)
    assert bool((got[alone] == 0).all())
    if case == "empty_keyframe":
        assert bool(alone[18:24].all())


def test_schur_complement_batched(dev):
    """K40 over four planted problems in one launch: each lane bit-equal
    to its own B = 1 launch; the batched plan's lanes equal the lanes'
    plans."""
    from planarslam_tpu_torch.solvers import ba_core

    sts = [chip_smoke.schur_step(chip_smoke.planted_schur_problem(
        "random", dev, seed=40 + b)) for b in range(4)]
    plan = chip_smoke.schur_plan([st["pb"] for st in sts])
    got = ba_core.ba_schur_complement(
        torch.stack([st["HcpHinv"] for st in sts]),
        torch.stack([st["Hcp"] for st in sts]), plan)
    for b, st in enumerate(sts):
        assert torch.equal(plan.bits[b], st["pb"].pairs.bits)
        assert torch.equal(plan.counts[b], st["pb"].pairs.counts)
        one = ba_core.ba_schur_complement(st["HcpHinv"], st["Hcp"],
                                          st["pb"].pairs)
        assert torch.equal(got[b].view(torch.int32), one.view(torch.int32))


def test_pose_graph_normal_eqs_gauge(dev):
    """K10 with the gauge diagonal on chip_smoke's 96-keyframe graph
    (keyframe 0 fixed): H and g within 1e-5 of the largest values of the
    plain ones (H without the gauge diagonal), the fixed rows' diagonal
    within one ulp, every entry of H and g written (outputs taken from
    torch.empty)."""
    from planarslam_tpu_torch.solvers import pose_graph

    args, fixed = chip_smoke.ba_kernel_graph(dev)
    for _ in range(2):  # a second call into reused, unzeroed memory
        H, g = pose_graph.pose_graph_normal_eqs(*args, fixed_mask=fixed)
    Hp, gp = pose_graph.pose_graph_normal_eqs_plain(*args, fixed_mask=fixed)
    H0, _ = pose_graph.pose_graph_normal_eqs_plain(*args)
    gauge = torch.diag((torch.repeat_interleave(fixed, 6) > 0).float()) > 0
    ulp = torch.nextafter(Hp.abs(), torch.full_like(Hp, float("inf"))) \
        - Hp.abs()
    assert float((H - Hp).abs()[~gauge].max()) <= 1e-5 * float(
        H0.abs().max())
    assert bool(((H - Hp).abs()[gauge] <= ulp[gauge]).all())
    assert _rel(g, gp) <= 1e-5
    assert bool(torch.isfinite(H).all() and torch.isfinite(g).all())


@pytest.mark.parametrize("case", chip_smoke.UPDATE_PLANTED)
def test_pose_graph_update_planted(dev, case):
    """K41 on chip_smoke's planted steps over 96 keyframes, at B = 1 and
    in one launch at B = 4: entries within 1e-6 of max(1, |entry|) of the
    plain version, NaN where the plain version's; each lane equal to its
    own launch."""
    from planarslam_tpu_torch.solvers import pose_graph

    args, _ = chip_smoke.ba_kernel_graph(dev)
    poses = args[0]
    step = torch.from_numpy(chip_smoke.planted_update_steps(
        case, poses.shape[0])).to(dev)
    n0 = kernels.LAUNCHES["pose_graph_update"]
    got = pose_graph.pose_graph_update(poses, step)
    assert kernels.LAUNCHES["pose_graph_update"] == n0 + 1
    want = pose_graph.pose_graph_update_plain(poses, step)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert bool(((got[ok] - want[ok]).abs() <= 1e-6 * torch.clamp(
        want[ok].abs(), min=1.0)).all())
    lanes = pose_graph.pose_graph_update(torch.stack([poses] * 4),
                                         torch.stack([step] * 4))
    for b in range(4):
        assert torch.equal(torch.nan_to_num(lanes[b]),
                           torch.nan_to_num(got))


@pytest.mark.parametrize("case", chip_smoke.LINE_TRI_PLANTED)
def test_triangulate_lines_planted(dev, case):
    """K42 on chip_smoke's planted mapping steps: one launch, idx, Xs, Xe
    and good bit-equal to the plain version, into outputs filled with NaN;
    the four in one launch at B = 4 equal to their B = 1 launches."""
    from planarslam_tpu_torch.slam import device_mapper

    cfg = SystemConfig()
    args, K = chip_smoke.line_tri_args(
        chip_smoke.planted_line_tri_problem(case, cfg), dev)
    n0 = kernels.LAUNCHES["triangulate_lines"]
    with chip_smoke.poisoned_outputs(device_mapper, "_empty"):
        got = device_mapper.triangulate_lines(*args, K)
    assert kernels.LAUNCHES["triangulate_lines"] == n0 + 1
    want = device_mapper.triangulate_lines_plain(*args, K)
    assert chip_smoke.same_bits(got, want)
    lanes = [torch.stack([x] * 4) for x in args]
    out = device_mapper.triangulate_lines(*lanes, K)
    for b in range(4):
        assert chip_smoke.same_bits([x[b] for x in out], got)


@pytest.mark.parametrize("problem", ["recipe", "orbit"])
def test_pcg_kernels(dev, problem):
    """K43-K45 against their plain versions at a first LM step
    (chip_smoke.pcg_kernel_check's limits: K43 1e-5 of each output's
    largest value, inv(Minv) 1e-5 of the largest |Hcc_d|; K44 and K45's
    sums within 2 (n - 1) 2^-24 of their |terms|; two launches equal
    bits; fixed rows 0) on the line-and-plane recipe and a 64-keyframe
    orbit."""
    if problem == "recipe":
        args = chip_smoke.ba_recipe(dev)[1]
    else:
        args = chip_smoke._orbit_problem(np.random.default_rng(5), 64, 512,
                                         24, dev)[2]
    chip_smoke.pcg_kernel_check(problem, chip_smoke.pcg_step_inputs(args))


def test_pcg_solve_matches_plain(dev):
    """ba_solve_pcg through K43-K45 against the same solve through their
    plain versions on the card, on the recipe: poses within 1e-4 after one
    LM step, the cost within 1% after 15; K43 once a LM step, K44 and K45
    as chip_smoke.pcg_launches says."""
    _, args = chip_smoke.ba_recipe(dev)
    (pk, _), (pp, _) = chip_smoke._pcg_solve_pair(args, 1)
    assert float((pk - pp).abs().max()) <= 1e-4
    before = dict(kernels.LAUNCHES)
    (pk, ck), (pp, cp) = chip_smoke._pcg_solve_pair(args, 15)
    assert abs(ck - cp) <= 0.01 * abs(cp)
    launched = {k: kernels.LAUNCHES[k] - before[k]
                for k in chip_smoke.pcg_launches(15)}
    assert launched == chip_smoke.pcg_launches(15)


def _k7_lanes(dev, B=4):
    """chip_smoke's K7 recipe for B lanes (seeds 7 + b, picks 11 + b),
    stacked with a leading B."""
    from planarslam_tpu_torch.solvers import pnp

    cam = SystemConfig().camera
    lanes = [chip_smoke.pnp_problem(cam, 256, 7 + b, 11 + b) for b in range(B)]
    return [torch.from_numpy(np.stack(f)).to(dev) for f in zip(*lanes)], pnp


def test_pnp_dlt_hypotheses_warp_solve(dev):
    """K7 (a warp's parallel Jacobi) at B = 4: T within 1e-5 of max(1, |T|)
    of the float64 plain version where the 6 picks are distinct (a repeated
    pick held to a score in [-1, n]); two launches equal bits; each lane
    bit-equal to its own B = 1 launch; scores the plain _inliers count of
    the kernel's own T."""
    (xw, uv_n, is2, valid, picks), pnp = _k7_lanes(dev)
    sk, Tk = pnp.pnp_dlt_hypotheses(xw, uv_n, is2, valid, picks, 5.991)
    s2, T2 = pnp.pnp_dlt_hypotheses(xw, uv_n, is2, valid, picks, 5.991)
    assert torch.equal(sk, s2) and torch.equal(Tk.view(torch.int32),
                                               T2.view(torch.int32))
    for b in range(4):
        args = (xw[b], uv_n[b], is2[b], valid[b], picks[b])
        s1, T1 = pnp.pnp_dlt_hypotheses(*args, 5.991)
        assert torch.equal(s1, sk[b]) and torch.equal(T1, Tk[b])
        _, Tp = pnp.pnp_dlt_hypotheses_plain(*args, 5.991)
        p = picks[b].cpu().numpy()
        distinct = torch.from_numpy(np.array([len(set(r)) == 6 for r in p]))
        err = ((Tk[b] - Tp).abs() / Tp.abs().clamp(min=1.0))[distinct.to(dev)]
        assert float(err.max()) <= 1e-5
        assert bool(((sk[b] >= -1) & (sk[b] <= 256)).all())
        own = pnp._inliers(Tk[b], *args[:4], 5.991).sum(dim=1)
        fin = torch.isfinite(Tk[b]).reshape(128, -1).all(dim=1)
        assert torch.equal(torch.where(fin, own, -1).to(torch.int32), sk[b])


def test_pnp_select(dev):
    """K46 at B = 4 on K7's outputs: every lane bit-equal to the plain
    version (packed T, count, mask) and to its own B = 1 launch; the count
    the lane's best score; the RANSAC (K7, K46) one launch each."""
    (xw, uv_n, is2, valid, picks), pnp = _k7_lanes(dev)
    sk, Tk = pnp.pnp_dlt_hypotheses(xw, uv_n, is2, valid, picks, 5.991)
    rows = pnp.pnp_select(xw, uv_n, is2, valid, sk, Tk, 5.991)
    for b in range(4):
        args = (xw[b], uv_n[b], is2[b], valid[b])
        want = pnp.pnp_select_plain(*args, sk[b], Tk[b], 5.991)
        assert torch.equal(rows[b].view(torch.int32), want.view(torch.int32))
        assert torch.equal(pnp.pnp_select(*args, sk[b], Tk[b], 5.991), rows[b])
        assert int(rows[b, 16:17].view(torch.int32)) == int(sk[b].max())
    before = dict(kernels.LAUNCHES)
    again = pnp._pnp_ransac(xw, uv_n, valid, is2, picks, 5.991)
    assert torch.equal(again, rows)
    assert kernels.LAUNCHES["pnp_dlt_hypotheses"] == \
        before["pnp_dlt_hypotheses"] + 1
    assert kernels.LAUNCHES["pnp_select"] == before["pnp_select"] + 1


def _horn_lanes(dev, scale, B=4):
    """chip_smoke's K6 recipe (1024 correspondences, 60% inliers of a
    planted similarity) for B lanes (seeds 60 + b), stacked."""
    lanes = [chip_smoke.horn_problem(60 + b, scale) for b in range(B)]
    return [torch.from_numpy(np.stack(f)).to(dev) for f in zip(*lanes)]


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_triplets_refit(dev, with_scale):
    """K6's triplet and refit modes at B = 4: two launches equal bits; each
    lane bit-equal to its own B = 1 launch; without the scale, the triplet
    rows bit-equal to a weights launch on the plain version's rows and the
    refit to the plain pick and a weights launch; with it (scale 1.3), R,
    t (of max(1, |t|)) and s within 1e-5 of the plain version on distinct
    triplets and on the refit, counts and masks equal."""
    from planarslam_tpu_torch.solvers import sim3_solver as ss

    src, dst, valid, tri = _horn_lanes(dev, 1.3 if with_scale else 1.0)
    trip = ss.horn_triplets(src, dst, valid, tri, 0.08, with_scale)
    again = ss.horn_triplets(src, dst, valid, tri, 0.08, with_scale)
    assert all(torch.equal(x, y) for x, y in zip(trip, again))
    rows = ss.horn_refit(src, dst, valid, trip[3], trip[4], 0.08, with_scale)
    assert torch.equal(rows, ss.horn_refit(src, dst, valid, trip[3], trip[4],
                                           0.08, with_scale))
    for b in range(4):
        one = (src[b], dst[b], valid[b])
        t1 = ss.horn_triplets(*one, tri[b], 0.08, with_scale)
        assert all(torch.equal(x, y[b]) for x, y in zip(t1, trip))
        r1 = ss.horn_refit(*one, trip[3][b], trip[4][b], 0.08, with_scale)
        assert torch.equal(r1, rows[b])
        if not with_scale:
            w = ss.triplet_weights(valid[b].cpu(), tri[b].cpu()).to(dev)
            by_w = ss.horn_align_batch(*one, w, 0.08)
            for x, y in zip((trip[0][b], trip[1][b], trip[3][b], trip[4][b]),
                            by_w):
                assert torch.equal(x, y)
            best = int(torch.argmax(trip[3][b]))
            wb = (trip[4][b, best].float() + 1e-9)[None].contiguous()
            R, t, n_inl, inl = ss.horn_align_batch(*one, wb, 0.08)
            want = torch.cat([R.reshape(9), t.reshape(3),
                              torch.ones(1, device=dev),
                              n_inl.view(torch.float32), inl[0].float()])
            assert torch.equal(rows[b].view(torch.int32),
                               want.view(torch.int32))
            continue
        want = ss.horn_triplets_plain(*one, tri[b], 0.08, True)
        p = tri[b].cpu().numpy()
        ok = torch.from_numpy(np.array([len(set(r)) == 3 for r in p])).to(dev)
        assert float((trip[0][b] - want[0]).abs()[ok].max()) <= 1e-5
        assert float(((trip[1][b] - want[1]).abs()
                      / want[1].abs().clamp(min=1.0))[ok].max()) <= 1e-5
        assert float(((trip[2][b] - want[2]).abs()
                      / want[2].abs())[ok].max()) <= 1e-5
        assert torch.equal(trip[3][b], want[3])
        assert torch.equal(trip[4][b], want[4])
        prow = ss.horn_refit_plain(*one, want[3], want[4], 0.08, True)
        assert float((rows[b, :9] - prow[:9]).abs().max()) <= 1e-5
        assert float(((rows[b, 9:12] - prow[9:12]).abs()
                      / prow[9:12].abs().clamp(min=1.0)).max()) <= 1e-5
        assert abs(float(rows[b, 12]) - float(prow[12])) <= 1e-5 * float(
            prow[12])
        assert torch.equal(rows[b, 13:].view(torch.int32),
                           prow[13:].view(torch.int32))
        assert abs(float(rows[b, 12]) - 1.3) < 0.01


@pytest.mark.parametrize("case", chip_smoke.MATCH_PLANTED)
def test_match_lines(dev, case):
    """K47 on chip_smoke's planted problem: bit-equal to its plain version
    (idx and best), two launches equal bits, and at B = 4 (the problem and
    three reseeded ones) each lane bit-equal to its own launch."""
    lanes = [[torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
              chip_smoke.planted_match_problem(case, seed=5 + b)]
             for b in range(4)]
    n0 = kernels.LAUNCHES["match_lines"]
    got = lines.match_lines(*lanes[0])
    assert kernels.LAUNCHES["match_lines"] == n0 + 1
    want = lines.match_lines_plain(*lanes[0])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    again = lines.match_lines(*lanes[0])
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(got, again))
    b4 = lines.match_lines(*[torch.stack(f) for f in zip(*lanes)])
    for b in range(4):
        one = lines.match_lines(*lanes[b])
        assert torch.equal(b4[0][b], one[0])
        assert torch.equal(b4[1][b].view(torch.int32),
                           one[1].view(torch.int32))


def test_ransac_entry_points_match_cpu(dev):
    """pnp_ransac, horn_ransac_se3 and horn_ransac_sim3 on the card against
    the same calls on the CPU (plain versions): inlier masks and counts
    equal, T within 1e-4 (PnP: 0.01 R, 0.05 t, counts within 2, its
    float64 SVDs differ in their last bits), s within 1e-5 relative."""
    from planarslam_tpu_torch.solvers import pnp, sim3_solver

    rng = np.random.default_rng(3)
    n = 300
    src = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    T = _pose(rng, 0.3, 0.5)
    dst = (0.9 * (src @ T[:3, :3].T) + T[:3, 3]
           + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    for fn, out_s in ((sim3_solver.horn_ransac_se3, False),
                      (sim3_solver.horn_ransac_sim3, True)):
        d = dst if out_s else (src @ T[:3, :3].T + T[:3, 3]).astype(
            np.float32)
        got, want = fn(src, d, 0.08, device=dev), fn(src, d, 0.08,
                                                     device="cpu")
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        assert got[-2] == want[-2]
        np.testing.assert_array_equal(got[-1], want[-1])
        if out_s:
            assert abs(got[1] - want[1]) <= 1e-5 * abs(want[1])
    (xw, uv_n, is2, valid, picks), _ = _k7_lanes(dev, 1)
    cam = SystemConfig().camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    uv = uv_n[0].cpu().numpy() * np.array(K[:2]) + np.array(K[2:])
    pts = xw[0].cpu().numpy()
    Tg, ig, ng = pnp.pnp_ransac(pts, uv, np.ones(256, bool), K, device=dev)
    Tc, ic, nc = pnp.pnp_ransac(pts, uv, np.ones(256, bool), K,
                                device="cpu")
    assert abs(ng - nc) <= 2 and ng == int(ig.sum())
    np.testing.assert_allclose(Tg[:3, :3], Tc[:3, :3], atol=0.01)
    np.testing.assert_allclose(Tg[:3, 3], Tc[:3, 3], atol=0.05)



@pytest.mark.parametrize("case", chip_smoke.TWO_VIEW_PLANTED)
def test_two_view_kernels(dev, case):
    """On chip_smoke's planted two-view problem: K48 against its plain
    version (F and H up to sign 1e-5 of max |entry| on well-posed distinct
    picks, scores within 2 (n - 1) 2^-24 of the plain scoring of the
    kernel's models, other picks a score in [-1, 2 N 5.991], two launches
    equal bits); K49 bit-equal to its plain version on K48's outputs, into
    outputs filled with NaN; K50 on the four candidates (X 1e-5 of max(1,
    |X|), ok exact, lanes equal to their B = 1 launches) and its gates mode
    bit-equal."""
    p = chip_smoke.planted_two_view(case)
    ins = chip_smoke._two_view_inputs(p, dev)
    mp = chip_smoke.two_view_model_parity(case, p, ins)
    row = chip_smoke.two_view_select_parity(case, ins, mp["outputs"])
    chip_smoke.two_view_dlt_parity(case, p, row[0].cpu().numpy(), dev)


def test_two_view_lanes(dev):
    """K48 and K49 at B = 4 (chip_smoke.TWO_VIEW_LANES, padded with valid
    False): every lane bit-equal to its own B = 1 launch."""
    probs = {c: chip_smoke.planted_two_view(c)
             for c in chip_smoke.TWO_VIEW_LANES}
    chip_smoke.two_view_lanes(dev, {"problems": probs})


def test_initialize_two_view_on_card(dev):
    """initialize_two_view on the card: one K48, one K49 and one K50 launch
    a call; on the JAX test's problem the result of the CPU run (success,
    the model, the inliers; T within 1e-4)."""
    from planarslam_tpu_torch.solvers import initializer

    p = chip_smoke.planted_two_view("jax_test")
    before = dict(kernels.LAUNCHES)
    got = initializer.initialize_two_view(p["uv1"], p["uv2"], p["valid"],
                                          p["K"], device=dev)
    for name in ("two_view_hypotheses", "two_view_select",
                 "triangulate_dlt"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    want = initializer.initialize_two_view(p["uv1"], p["uv2"], p["valid"],
                                           p["K"], device="cpu")
    assert got.success and want.success
    assert got.used_homography == want.used_homography
    np.testing.assert_array_equal(got.inliers, want.inliers)
    np.testing.assert_allclose(got.T_21, want.T_21, atol=1e-4)
