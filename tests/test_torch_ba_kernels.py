"""Port parity of the loop-correction kernels' plain versions and
arithmetic (K32-K35) on the CPU, against the JAX package on the same
numpy-seeded inputs (JAX on the CPU):

  - K32: sim3_solver._refine_relative_plain (analytic Jacobian) against
    the JAX _refine_relative (jax.jacfwd), with and without outliers, with
    a correspondence behind both cameras, with the scale free, and with a
    NaN pixel that rejects every step;
  - K33: ba_core.plane_jacs_closed (the closed-form Jacobians of the
    kernel and its plain version) against the JAX _plane_jacs (jacfwd) for
    the direct, parallel and vertical errors (planted
    hemisphere flips and vertical pairs), and plane_blocks_plain's sums
    and mu_p against the JAX step's (ba_core.py:407-445, :459-461);
  - K34: cost_test_plain against the JAX _all_chi2_tables at both states
    and _robust_decrease_tables, on a step that is accepted and one that
    is rejected;
  - K35: reduced_system_plain against a numpy transcription of the JAX
    step (ba_core.py:459-482), the fixed rows exactly the identity;
  - the batched wrappers' CPU paths (K32, K35).
The slice-level parity (ba_solve, global BA on a map, a whole loop
correction) stays in tests/test_torch_ba.py and tests/test_torch_loop.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import plane as jplane
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.solvers import ba_core as jba
from planarslam_tpu.solvers import sim3_solver as jsim3
from planarslam_tpu_torch.config import PlaneConfig
from planarslam_tpu_torch.geometry import se3
from planarslam_tpu_torch.solvers import ba_core as tba
from planarslam_tpu_torch.solvers import sim3_solver as tsim3

torch.set_num_threads(2)

JAX_ERR_FNS = (jplane.ominus, jplane.ominus_par, jplane.ominus_ver)
BF = 40.0


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# K32


@pytest.mark.parametrize("case,fix_scale", [("clean", True),
                                            ("outliers", True),
                                            ("behind", True),
                                            ("outliers", False)])
def test_refine_relative_plain_matches_jax(case, fix_scale):
    """_refine_relative_plain on 1024 seeded correspondences against the
    JAX refinement: pose entries and the scale within 1e-5; the refined
    pose moves from the start."""
    T0, p1, p2, uv1, uv2, valid, K = chip_smoke._refine_problem(
        np.random.default_rng(7), 1024, case)
    Tj, sj = jsim3._refine_relative(
        jnp.asarray(T0), jnp.float32(1.0), *map(jnp.asarray,
                                                 (p1, p2, uv1, uv2, valid)),
        K, fix_scale=fix_scale)
    Tt, st = tsim3._refine_relative_plain(
        torch.from_numpy(T0), torch.tensor(1.0),
        *map(torch.from_numpy, (p1, p2, uv1, uv2, valid)), K,
        fix_scale=fix_scale)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5)
    assert abs(float(st) - float(sj)) <= 1e-5
    assert (float(st) == 1.0) == fix_scale
    assert np.abs(Tt.numpy() - T0).max() > 1e-3


def test_refine_relative_nonfinite_rejects_every_step():
    """A NaN pixel makes every step's dx non-finite: the plain version and
    the JAX refinement both keep the start exactly."""
    T0, p1, p2, uv1, uv2, valid, K = chip_smoke._refine_problem(
        np.random.default_rng(8), 256, "nonfinite")
    Tj, _ = jsim3._refine_relative(
        jnp.asarray(T0), jnp.float32(1.0), *map(jnp.asarray,
                                                 (p1, p2, uv1, uv2, valid)),
        K)
    Tt, st = tsim3._refine_relative_plain(
        torch.from_numpy(T0), torch.tensor(1.0),
        *map(torch.from_numpy, (p1, p2, uv1, uv2, valid)), K)
    np.testing.assert_array_equal(Tt.numpy(), T0)
    np.testing.assert_array_equal(np.asarray(Tj), T0)
    assert float(st) == 1.0


def test_refine_relative_batched_cpu():
    """The K32 wrapper on CPU tensors with a batch of 3: each problem's
    result is the plain version's on that problem alone."""
    rng = np.random.default_rng(9)
    probs = [chip_smoke._refine_problem(rng, 300, c)
             for c in ("clean", "outliers", "nonfinite")]
    K = probs[0][6]
    ins = [torch.from_numpy(np.stack([p[i] for p in probs]))
           for i in range(6)]
    T, s = tsim3.refine_relative(ins[0], torch.ones(3), *ins[1:], K)
    assert T.shape == (3, 4, 4) and s.shape == (3,)
    for b in range(3):
        Tb, sb = tsim3._refine_relative_plain(ins[0][b], torch.tensor(1.0),
                                              *[x[b] for x in ins[1:]], K)
        assert torch.equal(T[b], Tb) and float(s[b]) == float(sb)


# ---------------------------------------------------------------------------
# K33


def _plane_inputs(seed=11, Kt=8, Pp=12, Q=5, par_cols=None):
    """A seeded plane problem (chip_smoke._plane_problem) as numpy."""
    return chip_smoke._plane_problem(np.random.default_rng(seed), Kt, Pp, Q,
                                     par_cols=par_cols)


def _block_close(got, want, rel, name):
    """|got - want| within rel of each observation block's largest |want|
    (blocks: the trailing two dimensions)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    err = np.abs(got - want)
    assert np.all(err <= rel * scale + 1e-12), (
        f"{name}: {float((err / np.maximum(scale, 1e-30)).max())}")


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_plane_jacs_closed_matches_jax(kind):
    """The closed-form plane Jacobians (K33's arithmetic and its plain
    version's) against the JAX package's jax.jacfwd, for the
    direct (kind 0), parallel (1) and vertical (2) errors: Jx and Jt within
    1e-5 of each observation block's largest entry, the residuals within
    1e-5 (the distance row is a difference of two distances of 1-6 m). The
    inputs hold measurements with negated coefficients, parallel planes in
    the other hemisphere, vertical pairs and empty slots."""
    prob = _plane_inputs()
    tab = prob["tables"][kind]
    slot = np.clip(tab["slot"], 0, None)
    args = (prob["poses"], prob["base"], prob["theta"], slot, tab["pi_obs"])
    rj, Jxj, Jtj = jba._plane_jacs(*map(jnp.asarray, args),
                                   JAX_ERR_FNS[kind], jnp.float32)
    if kind < 2:  # measurements with negated coefficients
        assert bool(np.any(tab["pi_obs"][..., 3] < 0))
    rt, Jxt, Jtt = tba.plane_jacs_closed(*map(torch.from_numpy, args), kind)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    _block_close(Jxt.numpy(), np.asarray(Jxj), 1e-5, "Jx")
    _block_close(Jtt.numpy(), np.asarray(Jtj), 1e-5, "Jt")
    if kind == 2:
        assert np.all(Jxt.numpy()[..., 1, :] == 0)
        assert np.all(Jtt.numpy()[..., 1, :] == 0)


def _problem(prob, Q=None, seed=12):
    """The port's _Problem of a seeded point, line and plane problem on the
    CPU, and its state (poses, landmarks with the chart coordinates
    appended); Q = 0 leaves the plane blocks out."""
    Kt = prob["poses"].shape[0]
    poses, pts, pt, ln, K = chip_smoke._ba_problem("cpu", Kt, 96, 16, 512,
                                                   seed=seed)
    poses = torch.from_numpy(prob["poses"])
    base = torch.from_numpy(prob["base"])
    theta = torch.from_numpy(prob["theta"])
    if Q == 0:
        base, theta = base[:0], theta[:0]
    pl, par, ver = chip_smoke._plane_tables(prob, "cpu")
    w = tba.BAWeights.from_config(PlaneConfig())
    pb = tba._problem(pts, base, pt, ln, pl, par, ver, w)
    return pb, poses, base, torch.cat([pts, theta]), K


def _jax_weights():
    return jba.BAWeights.from_config(jconfig.SystemConfig().planes)


def _jax_plane_sums(pb, poses, base, lm):
    """The plane sums of the JAX step (add_plane_block, ba_core.py:407-445)
    from the JAX _plane_jacs, in float64 numpy, and mu_p (:463-465)."""
    P, M, Kt = pb.P, pb.M, poses.shape[0]
    Hcc = np.zeros((Kt, 6, 6))
    bc = np.zeros((Kt, 6))
    Hpp = np.zeros((M, 3, 3))
    bp = np.zeros((M, 3))
    Hcp = np.zeros((Kt, M, 6, 3))
    theta = lm[P:].numpy()
    for tables, slot, kind, info, gate in tba._active_planes(pb):
        s = slot.numpy()
        rr, Jx, Jt = (np.asarray(a, np.float64) for a in jba._plane_jacs(
            jnp.asarray(poses.numpy()), jnp.asarray(base.numpy()),
            jnp.asarray(theta), jnp.asarray(s), jnp.asarray(_np(
                tables.pi_obs)), JAX_ERR_FNS[kind], jnp.float32))
        info = info.numpy().astype(np.float64)
        chi = np.sum(rr * rr * info, -1)
        hw = np.where(chi > gate, np.sqrt(gate / np.clip(chi, 1e-12, None)),
                      1.0)
        Wv = (hw * tables.mask.numpy())[..., None] * info
        Hcc += np.einsum("kpdi,kpd,kpdj->kij", Jx, Wv, Jx)
        bc += np.einsum("kpdi,kpd->ki", Jx, rr * Wv)
        np.add.at(Hpp, s + P, np.einsum("kpdi,kpd,kpdj->kpij", Jt, Wv, Jt))
        np.add.at(bp, s + P, np.einsum("kpdi,kpd->kpi", Jt, rr * Wv))
        kk = np.broadcast_to(np.arange(Kt)[:, None], s.shape)
        np.add.at(Hcp, (kk, s + P),
                  np.einsum("kpdi,kpd,kpdj->kpij", Jx, Wv, Jt))
    return Hcc, bc, Hpp, bp, Hcp.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", ["tables", "empty_par", "q0"])
def test_plane_blocks_plain_matches_jax(case):
    """plane_blocks_plain from zeroed sums against the JAX step's plane
    sums in float64: Hcc, bc, Hpp, bp and Hcp within 2e-5 of their largest
    values (float32 sums, as test_torch_ba holds K8's plain version); the
    records of each table with slots; mu_p of K8-like point
    rows plus the plane rows against the JAX formula; an empty parallel
    table and Q = 0 add nothing."""
    prob = _plane_inputs(par_cols=0 if case == "empty_par" else None)
    pb, poses, base, lm = _problem(prob, Q=0 if case == "q0" else None)[:4]
    Kt, M = poses.shape[0], pb.M
    zeros = [torch.zeros(s) for s in ((Kt, 6, 6), (Kt, 6), (M, 3, 3),
                                      (M, 3), (Kt, 6, M, 3))]
    Hpp_in = zeros[2].clone()
    Hpp_in[:pb.P] = torch.eye(3) * torch.linspace(0, 9, pb.P)[:, None, None]
    zeros[2] = Hpp_in
    got = tba.plane_blocks_plain(pb, poses, base, lm[pb.P:], *zeros)
    want = _jax_plane_sums(pb, poses, base, lm)
    want = (want[0], want[1], want[2] + Hpp_in.numpy(), want[3], want[4])
    for name, g, w in zip(("Hcc", "bc", "Hpp", "bp", "Hcp"), got[:5], want):
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g.numpy() - w).max()) <= 2e-5 * scale, name
    diag = np.einsum("mii->mi", want[2])
    mu = diag.sum() / (3 * (np.sum(diag.sum(-1) > 0) + 1))
    assert abs(float(got[6]) - mu) <= 1e-5 * mu
    assert len(got[5]) == {"tables": 3, "empty_par": 2, "q0": 0}[case]
    if case == "q0":
        assert all(torch.equal(g, z) for g, z in zip(got[:5], zeros))


# ---------------------------------------------------------------------------
# K34


@pytest.mark.parametrize("case", ["accepted", "rejected"])
def test_cost_test_plain_matches_jax(case):
    """cost_test_plain against the JAX step's test: _all_chi2_tables at
    both states (chi2 within 1e-5 of each table's largest value) and
    _robust_decrease_tables (within 2 (n - 1) 2^-24 of the sum of the |rho|
    terms); the accept, lam and selected state equal. A step undoing a
    planted pose error is accepted; a 0.3 rad step rejected."""
    prob = _plane_inputs(seed=13)
    pb, poses, base, lm, K = _problem(prob, seed=13)
    rng = np.random.default_rng(14)
    Kt, M, P = poses.shape[0], pb.M, pb.P
    delta = torch.from_numpy(rng.normal(
        0, 0.3 if case == "rejected" else 0.002, (Kt, 6)).astype(np.float32))
    if case == "accepted":
        poses = se3.se3_exp(delta) @ poses
        delta = -delta
    dxp = torch.from_numpy(rng.normal(0, 1e-4, (M, 3)).astype(np.float32))
    lam = torch.tensor(1e-3)
    got = tba.cost_test_plain(pb, poses, lm, delta, dxp, lam, base, K, BF)

    wj = _jax_weights()
    pt, ln = pb.pt, pb.ln
    (pl, pl_s), (par, par_s), (ver, ver_s) = (
        (jba.PlaneTables(*map(jnp.asarray, map(_np, t))), jnp.asarray(
            _np(s))) for t, s, *_ in pb.planes)
    jpt = jba.PointTables(*map(jnp.asarray, map(_np, pt)))
    jln = jba.LineTables(*map(jnp.asarray, map(_np, ln)))

    def chis(p, x):
        return jba._all_chi2_tables(
            jnp.asarray(_np(p)), jnp.asarray(_np(x)), jnp.asarray(_np(base)),
            P, jpt, jln, pl, par, ver, jpt.slot, jln.slot, pl_s, par_s,
            ver_s, jnp.asarray(_np(pt.ur)) >= 0, K, BF, wj)

    p_new = jax.vmap(jse3.se3_exp)(jnp.asarray(_np(delta))) @ jnp.asarray(
        _np(poses))
    new, cur = chis(p_new, lm + dxp), chis(poses, lm)
    gates = (jnp.asarray(_np(pb.gates[0])), jba.CHI2_MONO, wj.plane_chi,
             wj.vp_chi, wj.vp_chi)
    masks = [jnp.asarray(_np(m)) for m in pb.masks]
    dec = float(jba._robust_decrease_tables(new, cur, gates, masks, True))
    for a, b in zip(tba._chi2(pb, poses, lm, base, K, BF, pb.w), cur):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(np.abs(b).max(),
                                                         1e-12)
    rho = [np.abs(np.asarray(jba._rho_fn(c, g, m, True)))
           for cs in (new, cur) for c, g, m in zip(cs, gates, masks)]
    n = sum(r.size for r in rho)
    bound = 2 * (n - 1) * 2.0 ** -24 * sum(float(r.sum()) for r in rho)
    assert abs(float(got.decrease) - dec) <= bound < abs(dec)
    assert bool(got.accept) == (dec < 0) == (case == "accepted")
    assert float(got.lam) == float(np.clip(
        np.float32(1e-3) * np.float32(0.3 if dec < 0 else 6.0), 1e-8, 1e6))
    if case == "rejected":
        assert torch.equal(got.poses, poses) and torch.equal(got.lm, lm)
    else:
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(p_new),
                                   rtol=0, atol=1e-6)
        assert torch.equal(got.lm, lm + dxp)


# ---------------------------------------------------------------------------
# K35


def _reduced_numpy(S, Hcc, rhs, lam, fixed):
    """ba_core.py:459-482 of the JAX package, transcribed in float32 numpy
    (S is -S_blocks, laid out (6 Kt, 6 Kt))."""
    Kt = Hcc.shape[0]
    S = S.copy()
    for k in range(Kt):
        S[6 * k:6 * k + 6, 6 * k:6 * k + 6] += Hcc[k]
    free = np.repeat(np.float32(1.0) - fixed, 6)
    diag = np.diag(S)
    mu_c = np.sum(diag * free) / (np.sum(free) + np.float32(1.0))
    n = 6 * Kt
    S = (S + lam * np.diag(diag)
         + (lam * mu_c + np.float32(1e-8)) * np.eye(n, dtype=np.float32))
    S = S * free[:, None] * free[None, :] + np.diag(np.float32(1.0) - free)
    return S, rhs.reshape(-1) * free


def _reduced_problem(rng, Kt, fixed):
    A = rng.normal(0, 1, (6 * Kt, 12 * Kt))
    B = rng.normal(0, 1, (Kt, 6, 8))
    f = np.float32
    return (-(A @ A.T)).astype(f), (np.einsum("kab,kcb->kac", B, B)
                                    + 50 * np.eye(6)).astype(f), \
        rng.normal(0, 1, (Kt, 6)).astype(f), f(1e-3), fixed.astype(f)


@pytest.mark.parametrize("pattern", ["first", "all_but_one", "none"])
def test_reduced_system_plain_matches_numpy(pattern):
    """reduced_system_plain against the numpy transcription of the JAX
    step on Kt = 8: within 4 ulps (mu_c's summation order), the fixed rows
    and columns exactly the identity, rhs exact."""
    Kt = 8
    fixed = np.zeros(Kt)
    if pattern == "first":
        fixed[0] = 1
    elif pattern == "all_but_one":
        fixed[:] = 1
        fixed[3] = 0
    S, Hcc, rhs, lam, fx = _reduced_problem(np.random.default_rng(15), Kt,
                                            fixed)
    got = tba.reduced_system_plain(torch.from_numpy(S),
                                   torch.from_numpy(Hcc),
                                   torch.from_numpy(rhs), torch.tensor(lam),
                                   torch.from_numpy(fx))
    want = _reduced_numpy(S, Hcc, rhs, lam, fx)
    w = torch.from_numpy(want[0])
    assert float(chip_smoke._ulps(got[0], w).max()) <= 4
    np.testing.assert_array_equal(got[1].numpy()[:, 0], want[1])
    rows = np.repeat(fixed, 6) > 0
    eye = np.eye(6 * Kt, dtype=np.float32)
    np.testing.assert_array_equal(got[0].numpy()[rows], eye[rows])
    np.testing.assert_array_equal(got[0].numpy()[:, rows], eye[:, rows])


def test_reduced_system_batched_cpu():
    """The K35 wrapper on CPU tensors with a batch of 2 gives each
    problem's plain result."""
    rng = np.random.default_rng(16)
    probs = [_reduced_problem(rng, 6, f) for f in (
        np.eye(6)[0], np.ones(6) - np.eye(6)[2])]
    batch = [torch.from_numpy(np.stack([p[i] for p in probs]))
             for i in range(5)]
    S, r = tba.ba_reduced_system(*batch)
    for b, p in enumerate(probs):
        Sb, rb = tba.reduced_system_plain(*map(torch.as_tensor, p))
        assert torch.equal(S[b], Sb) and torch.equal(r[b], rb)
