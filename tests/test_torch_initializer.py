"""Port parity of the monocular two-view initializer
(``planarslam_tpu_torch/solvers/initializer.py``: K48's and K49's plain
versions and ``initialize_two_view``) and of the JAX ``triangulation.py``'s
two functions (K50's plain versions), each against the JAX package (JAX on
the CPU), on chip_smoke's planted two-view problems.

Tolerances. The JAX package solves each pick's 8 x 9 system on raw pixels
with a float32 SVD; the port solves it in float64. A model of a pick with
distinct points is held to JAX's up to sign within 2^-24 kappa of its
largest entry, kappa = sigma_1 / sigma_8 of the float64 system: the
float32 solve's forward error (the measured gap stays below a tenth of
it). That bound is loose where kappa is large, so 40% of the distinct
picks or more must have 2^-24 kappa < 0.1 and hold there. Scores: the port's scoring of a model within 1e-3 of JAX's scoring of
the same model (its largest score), and the port's score of a pick within
1% of the best of JAX's on 90% of the distinct picks. A pick that repeats a
point has a null space of dimension 2 or more, so its model is up to the
SVD routine: held to a score in [-1, 2 N 5.991]. The winner must be JAX's
where both lead the runner-up by more than the largest score gap of a
distinct pick and both winners are distinct picks; masks equal off 2% of
the gates around them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from planarslam_tpu.solvers import initializer as jinit
from planarslam_tpu.solvers import triangulation as jtri
from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.solvers import initializer as tinit
from planarslam_tpu_torch.solvers import triangulation as ttri

torch.set_num_threads(2)

PARITY_CASES = ("jax_test", "noisy_outliers", "planar", "n9")
EPS32 = 2.0 ** -24


def _problem(case):
    p = chip_smoke.planted_two_view(case)
    return p, len(p["uv1"])


def _torch_ins(p):
    n = len(p["uv1"])
    return (torch.from_numpy(p["uv1"]), torch.from_numpy(p["uv2"]),
            torch.from_numpy(p["valid"]), torch.ones(1),
            torch.from_numpy(tinit.two_view_picks(n)))


def _jax_hypotheses(p, picks):
    """JAX's per-pick models and scores (vmap of the module's own
    functions over the same picks)."""
    n = len(p["uv1"])
    uv1, uv2 = jnp.asarray(p["uv1"]), jnp.asarray(p["uv2"])
    x1h = jnp.concatenate([uv1, jnp.ones((n, 1))], -1)
    x2h = jnp.concatenate([uv2, jnp.ones((n, 1))], -1)
    valid = jnp.asarray(p["valid"])
    Fs = jax.vmap(lambda k: jinit._eight_point_F(uv1[k], uv2[k]))(picks)
    Hs = jax.vmap(lambda k: jinit._four_point_H(uv1[k[:4]], uv2[k[:4]]))(
        picks)

    def scores(Ms, fn):
        def one(M):
            s, _ = fn(M, x1h, x2h, 1.0, valid)
            return jnp.where(jnp.all(jnp.isfinite(M)), s, -1.0)
        return np.asarray(jax.vmap(one)(jnp.asarray(Ms)))

    return {"F": np.asarray(Fs), "H": np.asarray(Hs),
            "sf": scores(Fs, jinit._score_F), "sh": scores(Hs, jinit._score_H),
            "score_of": lambda tag, Ms: scores(
                Ms, jinit._score_F if tag == "F" else jinit._score_H)}


def _up_to_sign(a, b):
    d = np.minimum(np.abs(a - b).max((-2, -1)), np.abs(a + b).max((-2, -1)))
    return d / np.abs(b).max((-2, -1))


@pytest.mark.parametrize("n", [9, 120, 1000])
def test_picks_match_jax(n):
    """two_view_picks draws the JAX module's picks: np.random.default_rng(17)
    over the n true rows, with replacement; JAX's _dual_ransac returns the
    model of the best of exactly these picks (its score within 2 (n - 1)
    2^-24 of it: the jitted program sums in its own order)."""
    picks = tinit.two_view_picks(n)
    want = np.random.default_rng(17).integers(0, max(n, 1), (128, 8))
    np.testing.assert_array_equal(picks, want)
    assert picks.dtype == np.int32
    p = chip_smoke.planted_two_view(
        {9: "n9", 120: "jax_test", 1000: "noisy_outliers"}[n])
    j = _jax_hypotheses(p, picks)
    F, H, sf, sh, _, _ = jinit._dual_ransac(
        jnp.asarray(p["uv1"]), jnp.asarray(p["uv2"]),
        jnp.asarray(p["valid"]), jnp.float32(1.0))
    np.testing.assert_array_equal(np.asarray(F), j["F"][np.argmax(j["sf"])])
    np.testing.assert_array_equal(np.asarray(H), j["H"][np.argmax(j["sh"])])
    for got, want in ((sf, j["sf"].max()), (sh, j["sh"].max())):
        assert abs(float(got) - want) <= chip_smoke.sum_rtol(n) * want


@pytest.mark.parametrize("case", PARITY_CASES)
def test_hypotheses_match_jax(case):
    """K48's plain version against JAX per pick: models on distinct picks
    up to sign within 2^-24 kappa of their largest entry, and 40% of them
    or more (of 8 distinct picks or more) with 2^-24 kappa < 0.1; the port's
    scoring of its own models within 1e-3 of JAX's scoring of them; scores
    within 1% of the best on 90% of the distinct picks; repeated picks a
    score in [-1, 2 N 5.991]."""
    p, n = _problem(case)
    ins = _torch_ins(p)
    picks = ins[4].numpy()
    sf, sh, Fs, Hs = tinit.two_view_hypotheses_plain(*ins)
    j = _jax_hypotheses(p, picks)
    A, AH = chip_smoke.two_view_systems(p, picks)
    for tag, sysA, width, s_t, M_t in (("F", A, 8, sf, Fs),
                                       ("H", AH, 4, sh, Hs)):
        s_t, M_t = s_t.numpy(), M_t.numpy()
        s_j, M_j = j["s" + tag.lower()], j[tag]
        distinct = np.array([len(set(r[:width])) == width for r in picks])
        kappa = chip_smoke._system_kappa(sysA)
        err = _up_to_sign(M_t, M_j)[distinct]
        assert (err <= EPS32 * kappa[distinct]).all(), (tag, err.max())
        # the picks where that bound is tight enough to mean something:
        # 2^-24 kappa < 0.1, their models within a tenth of their largest
        # entry (35-106 of 67-128 distinct picks a case; n9's two
        # distinct eight-point picks both above, held by their scores)
        binds = EPS32 * kappa[distinct] < 0.1
        if distinct.sum() >= 8:
            assert binds.mean() >= 0.4, (tag, binds.mean())
        assert (err[binds] < 0.1).all()
        same_model = j["score_of"](tag, M_t)
        top = max(1.0, float(same_model.max()))
        assert np.abs(s_t - same_model).max() <= 1e-3 * top
        close = np.abs(s_t - s_j)[distinct] <= 0.01 * max(1.0, s_j.max())
        assert close.mean() >= 0.9, (tag, close.mean())
        assert ((s_t >= -1) & (s_t <= chip_smoke.score_ceiling(n))).all()


def _winner_margin(s, rows):
    order = np.sort(s)
    return int(np.argmax(s)), float(order[-1] - order[-2])


def _gate_window(M, tag, p):
    """Each correspondence's distance of the port's model M nearest to its
    gate, relative to the gate."""
    x1h = tinit._homogeneous(torch.from_numpy(p["uv1"]))
    x2h = tinit._homogeneous(torch.from_numpy(p["uv2"]))
    M = torch.from_numpy(M)
    x1, y1, x2, y2 = x1h[:, 0], x1h[:, 1], x2h[:, 0], x2h[:, 1]
    if tag == "F":
        th = tinit.TH_F
        d2 = tinit._line_dist(M, x1, y1, x2, y2, 1.0, False)
        d1 = tinit._line_dist(M, x2, y2, x1, y1, 1.0, True)
    else:
        th = tinit.TH_SCORE
        d2 = tinit._transfer_dist(M, x1, y1, x2, y2, 1.0)
        d1 = tinit._transfer_dist(tinit._h_inverse(M), x2, y2, x1, y1, 1.0)
    return np.minimum(np.abs(d1.numpy() - th), np.abs(d2.numpy() - th)) / th


@pytest.mark.parametrize("case", PARITY_CASES + ("none_valid",))
def test_dual_ransac_matches_jax(case):
    """The port's _dual_ransac (K48 then K49, plain) against JAX's: where
    both winners are distinct picks leading their runner-up by more than
    the largest score gap of a distinct pick, the same winner, its score
    within that gap and the masks equal off 2% of the gates; otherwise the
    port's best score its largest and its masks JAX's scoring of its own
    model off the gates."""
    p, n = _problem(case)
    ins = _torch_ins(p)
    picks = ins[4].numpy()
    sf, sh, Fs, Hs = tinit.two_view_hypotheses_plain(*ins)
    row = tinit._dual_ransac(*ins).numpy()
    F, H, bsf, bsh, inl_f, inl_h = tinit.unpack_two_view(row, n)
    jout = jinit._dual_ransac(jnp.asarray(p["uv1"]), jnp.asarray(p["uv2"]),
                              jnp.asarray(p["valid"]), jnp.float32(1.0))
    j = _jax_hypotheses(p, picks)
    for tag, width, s_t, M, best, inl, jM, js, jinl, jfn in (
            ("F", 8, sf.numpy(), F, bsf, inl_f, jout[0], jout[2], jout[4],
             jinit._score_F),
            ("H", 4, sh.numpy(), H, bsh, inl_h, jout[1], jout[3], jout[5],
             jinit._score_H)):
        s_j = j["s" + tag.lower()]
        distinct = np.array([len(set(r[:width])) == width for r in picks])
        tol = float(np.abs(s_t - s_j)[distinct].max())
        bt, mt = _winner_margin(s_t, distinct)
        bj, mj = _winner_margin(s_j, distinct)
        assert best == s_t.max()
        near = _gate_window(M, tag, p) <= 0.02
        if distinct[bt] and distinct[bj] and min(mt, mj) > tol:
            assert bt == bj, (tag, bt, bj)
            # js is the jitted program's sum, in its own order
            assert abs(best - float(js)) <= tol + chip_smoke.sum_rtol(n) * js
            np.testing.assert_array_equal(inl[~near],
                                          np.asarray(jinl)[~near])
        else:
            own = np.asarray(jfn(jnp.asarray(M), jnp.concatenate(
                [jnp.asarray(p["uv1"]), jnp.ones((n, 1))], -1),
                jnp.concatenate([jnp.asarray(p["uv2"]), jnp.ones((n, 1))],
                                -1), 1.0, jnp.asarray(p["valid"]))[1])
            np.testing.assert_array_equal(inl[~near], own[~near])
        if case == "none_valid":
            assert best == 0.0 and not inl.any()


def _pts_err(a, b):
    return float((np.abs(a - b).max(-1) / np.maximum(
        1.0, np.abs(b).max(-1))).max())


@pytest.mark.parametrize("case", PARITY_CASES + ("none_valid",))
def test_initialize_two_view_matches_jax(case):
    """initialize_two_view on the CPU against JAX's: success, the model and
    the inlier count equal; where the selected model's winner is JAX's
    (test_dual_ransac_matches_jax's rule) T_21 within 1e-3 and the points
    within 1e-2 of max(1, |X|); otherwise (ties of noise-free picks, a
    repeated pick winning) the result held: the JAX test's limits on its
    problem, the inliers of the planar scene's H JAX's."""
    p, n = _problem(case)
    got = tinit.initialize_two_view(p["uv1"], p["uv2"], p["valid"], p["K"],
                                    device="cpu")
    want = jinit.initialize_two_view(p["uv1"], p["uv2"], p["valid"], p["K"])
    assert got.success == want.success
    assert got.used_homography == want.used_homography
    assert abs(int(got.inliers.sum()) - int(want.inliers.sum())) <= 0.02 * n
    ins = _torch_ins(p)
    picks = ins[4].numpy()
    sf, sh, _, _ = tinit.two_view_hypotheses_plain(*ins)
    j = _jax_hypotheses(p, picks)
    tag, width = ("H", 4) if got.used_homography else ("F", 8)
    s_t = (sh if tag == "H" else sf).numpy()
    s_j = j["s" + tag.lower()]
    distinct = np.array([len(set(r[:width])) == width for r in picks])
    tol = float(np.abs(s_t - s_j)[distinct].max())
    bt, mt = _winner_margin(s_t, distinct)
    bj, mj = _winner_margin(s_j, distinct)
    same = distinct[bt] and distinct[bj] and min(mt, mj) > tol and bt == bj
    if same and tag == "F" and got.success:
        np.testing.assert_allclose(got.T_21, want.T_21, atol=1e-3)
        sel = got.inliers & want.inliers
        assert _pts_err(got.points3d[sel], want.points3d[sel]) <= 1e-2
    if case == "jax_test":
        errs = chip_smoke._pose_errors(got, p)
        assert got.success and errs["R_err"] < 0.02
        assert errs["t_err"] < 0.05 and got.inliers.sum() > 100
    if case == "planar":
        np.testing.assert_array_equal(got.inliers, want.inliers)


def test_noisy_outliers_reference_fault():
    """On the noisy problem with outliers, the JAX package itself misses
    two of the JAX test's limits, which chip_smoke's path 7 reports there
    and does not hold: its translation direction is off by more than 0.05
    (|t . t_true| = 0.868) and planted outliers 333, 677 and 939 stand
    among its inliers (the winning F of 8 raw pixels is not the true F).
    The port follows it: the same winning pick, both leading their
    runner-up by more than the largest score gap of a distinct pick,
    T_21 within 1e-3 of JAX's, the same planted outliers kept, and the
    inliers equal off 2% of the gates around the port's F."""
    p, n = _problem("noisy_outliers")
    got = tinit.initialize_two_view(p["uv1"], p["uv2"], p["valid"], p["K"],
                                    device="cpu")
    want = jinit.initialize_two_view(p["uv1"], p["uv2"], p["valid"], p["K"])
    assert want.success and not want.used_homography
    assert chip_smoke._pose_errors(want, p)["t_err"] > 0.05
    kept = np.flatnonzero(want.inliers & ~p["inlier"])
    np.testing.assert_array_equal(kept, [333, 677, 939])
    assert got.success and not got.used_homography
    np.testing.assert_array_equal(
        np.flatnonzero(got.inliers & ~p["inlier"]), kept)
    np.testing.assert_allclose(got.T_21, want.T_21, atol=1e-3)
    ins = _torch_ins(p)
    picks = ins[4].numpy()
    sf = tinit.two_view_hypotheses_plain(*ins)[0].numpy()
    s_j = _jax_hypotheses(p, picks)["sf"]
    distinct = np.array([len(set(r)) == 8 for r in picks])
    tol = float(np.abs(sf - s_j)[distinct].max())
    bt, mt = _winner_margin(sf, distinct)
    bj, mj = _winner_margin(s_j, distinct)
    assert bt == bj and distinct[bt] and min(mt, mj) > tol
    F = tinit.unpack_two_view(tinit._dual_ransac(*ins).numpy(), n)[0]
    near = _gate_window(F, "F", p) <= 0.02
    np.testing.assert_array_equal(got.inliers[~near], want.inliers[~near])


def _two_cameras(seed, n):
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = chip_smoke.TWO_VIEW_K
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    T2 = chip_smoke._rotvec_pose(rng.normal(0, 0.1, 3),
                                 rng.normal(0, 0.3, 3))
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 7, n)], -1).astype(np.float32)

    def proj(T, pts):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                         fy * pc[:, 1] / pc[:, 2] + cy], -1)

    eye = np.eye(4, dtype=np.float32)
    uv1 = (proj(eye, X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(T2, X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    return (K @ eye[:3]).astype(np.float32), (K @ T2[:3]).astype(
        np.float32), eye, T2, uv1, uv2


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_matches_jax(seed):
    """K50's plain DLT against JAX's triangulate: ok equal, X within 1e-3 of
    max(1, |X|) (JAX's float32 SVD against the float64 null vector), on two
    cameras with 0.5 px noise and on the four candidates of the JAX test's
    problem."""
    P1, P2, _, _, uv1, uv2 = _two_cameras(seed, 200)
    Xt, okt = ttri.triangulate(*map(torch.from_numpy, (P1, P2, uv1, uv2)))
    Xj, okj = jtri.triangulate(P1, P2, uv1, uv2)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert _pts_err(Xt.numpy(), np.asarray(Xj)) <= 1e-3
    p = chip_smoke.planted_two_view("jax_test")
    F = np.asarray(jinit._dual_ransac(
        jnp.asarray(p["uv1"]), jnp.asarray(p["uv2"]),
        jnp.asarray(p["valid"]), jnp.float32(1.0))[0])
    fx, fy, cx, cy = p["K"]
    Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    _, P1, P2s = tinit.two_view_candidates(F, Kmat)
    for P2 in P2s:
        Xt, okt = ttri.triangulate(*map(torch.from_numpy,
                                        (P1, P2, p["uv1"], p["uv2"])))
        Xj, okj = jtri.triangulate(P1, P2, p["uv1"], p["uv2"])
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        assert _pts_err(Xt.numpy(), np.asarray(Xj)) <= 1e-3


def test_reprojection_checks_match_jax():
    """K50's plain gates mode against JAX's reprojection_checks on the same
    points, scalar and per-point inverse sigma^2: masks equal off 1e-4 of
    the chi2 gate and of the 0.05 depth."""
    P1, P2, T1, T2, uv1, uv2 = _two_cameras(3, 400)
    X = np.array(jtri.triangulate(P1, P2, uv1, uv2)[0])
    X[::7] += np.float32(0.05)  # some beyond the gate
    X[::11, 2] = np.float32(0.02)  # some in front of z = 0.05
    K = chip_smoke.TWO_VIEW_K
    table = (1.2 ** -(2 * (np.arange(400) % 8))).astype(np.float32)
    for s1, s2 in ((1.0, 1.0), (table, 0.5)):
        got = ttri.reprojection_checks(
            *map(torch.from_numpy, (X, T1, T2, uv1, uv2)), K,
            torch.from_numpy(s1) if isinstance(s1, np.ndarray) else s1, s2)
        want = np.asarray(jtri.reprojection_checks(X, T1, T2, uv1, uv2, K,
                                                   s1, s2))
        near = np.zeros(400, bool)
        for T, uv, s in ((T1, uv1, s1), (T2, uv2, s2)):
            pc = X.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
            u = K[0] * pc[:, 0] / pc[:, 2] + K[2]
            v = K[1] * pc[:, 1] / pc[:, 2] + K[3]
            err = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * s
            near |= (np.abs(err - 5.991) <= 1e-4 * 5.991) | (
                np.abs(pc[:, 2] - 0.05) <= 1e-4)
        np.testing.assert_array_equal(got.numpy()[~near], want[~near])
        assert 0 < want.sum() < 400


def test_plain_versions_batched_lanes():
    """The plain versions at B = 4 (chip_smoke.TWO_VIEW_LANES padded to the
    longest with valid False): K48's, K49's and K50's batched CPU paths
    equal to each lane's own call."""
    probs = {c: chip_smoke.planted_two_view(c)
             for c in chip_smoke.TWO_VIEW_LANES}
    pad = max(len(p["uv1"]) for p in probs.values())
    lanes = [chip_smoke._two_view_inputs(p, torch.device("cpu"), pad)
             for p in probs.values()]
    ins = [torch.cat(f) for f in zip(*lanes)]
    hyp = tinit.two_view_hypotheses(*ins)
    rows = tinit.two_view_select(*ins[:4], *hyp)
    for b, one in enumerate(lanes):
        h1 = tinit.two_view_hypotheses(*[a[0] for a in one])
        for x, y in zip(hyp, h1):
            assert torch.equal(x[b], y)
        r1 = tinit.two_view_select(*[a[0] for a in one[:4]], *h1)
        assert torch.equal(rows[b], r1)
    P1, P2, T1, T2, uv1, uv2 = _two_cameras(4, 50)
    P2s = np.stack([P2, P1, P2, P2])
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        np.broadcast_to(P1, (4, 3, 4)), P2s,
        np.broadcast_to(uv1, (4, 50, 2)), np.broadcast_to(uv2, (4, 50, 2)))]
    X, ok = ttri.triangulate(*args)
    Xp, okp = kernels.pull(X, ok)
    np.testing.assert_array_equal(Xp, X.numpy())
    np.testing.assert_array_equal(okp, ok.numpy())
    for b in range(4):
        X1, ok1 = ttri.triangulate(*[a[b] for a in args])
        assert torch.equal(X1, X[b]) and torch.equal(ok1, ok[b])


def test_normalize_pts_matches_jax():
    """_normalize_pts, kept as unused as in the JAX module, equals JAX's."""
    p = chip_smoke.planted_two_view("noisy_outliers")
    got, T = tinit._normalize_pts(torch.from_numpy(p["uv1"]))
    want, Tj = jinit._normalize_pts(jnp.asarray(p["uv1"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=1e-5)
