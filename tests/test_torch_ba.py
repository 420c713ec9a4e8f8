"""Port parity of bundle adjustment: K8's and K9's plain versions against
the JAX package's measurement model and Schur formulas, ba_solve and
ba_solve_pcg on the line-and-plane recipe of tests/test_ba_full.py, and
local and global BA on a tracked map, each against the JAX package on the
same inputs (JAX on the CPU).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import plane as jplane
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu.solvers import ba_core as jba
from planarslam_tpu.solvers import global_ba as jgba
from planarslam_tpu.solvers import local_ba as jlba
from planarslam_tpu.solvers.ba_pcg import ba_solve_pcg as jpcg
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.slam.device_tracker import map_from_numpy
from planarslam_tpu_torch.solvers import ba_core as tba
from planarslam_tpu_torch.solvers import global_ba as tgba
from planarslam_tpu_torch.solvers import local_ba as tlba
from planarslam_tpu_torch.solvers.ba_pcg import ba_solve_pcg as tpcg

torch.set_num_threads(2)

CAM_K = (300.0, 310.0, 160.0, 120.0)
BF = 24.0


def _project(T, x):
    pc = T[:3, :3] @ x + T[:3, 3]
    return np.array([CAM_K[0] * pc[0] / pc[2] + CAM_K[2],
                     CAM_K[1] * pc[1] / pc[2] + CAM_K[3]]), pc[2]


def _recipe(seed=42):
    """The problem of test_ba_full.test_ba_recovers_lines_and_planes:
    Kt = 4, 96 points, 6 lines, 3 planes, perfect observations, perturbed
    start. Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    Kt, P_pts, NL, NP, F = 4, 96, 6, 3, 96
    pts_gt = rng.uniform(-2, 2, (P_pts, 3)).astype(np.float32)
    pts_gt[:, 2] = rng.uniform(3, 6, P_pts)
    poses_gt = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(np.r_[
        rng.normal(0, 0.15, 3) * 0.3, rng.normal(0, 0.15, 3)].astype(
            np.float32)))) for _ in range(Kt)])
    ln_s = rng.uniform(-2, 2, (NL, 3)).astype(np.float32)
    ln_s[:, 2] = rng.uniform(3, 5, NL)
    d = rng.normal(0, 1, (NL, 3)).astype(np.float32)
    ln_e = ln_s + d / np.linalg.norm(d, axis=1, keepdims=True)
    pl_gt = np.asarray(jplane.normalize(jnp.asarray(
        rng.normal(0, 1, (NP, 4)).astype(np.float32)
        + np.array([0, 0, 0, 5.0], np.float32))))
    slot = np.full((Kt, F), -1, np.int32)
    uv = np.zeros((Kt, F, 2), np.float32)
    ur = np.full((Kt, F), -1.0, np.float32)
    for k in range(Kt):
        for f, p in enumerate(rng.choice(P_pts, F - 16, replace=False)):
            u, z = _project(poses_gt[k], pts_gt[p])
            if z < 0.5:
                continue
            slot[k, f], uv[k, f], ur[k, f] = p, u, u[0] - BF / z
    L2 = 2 * NL
    ln_slot = np.full((Kt, L2), -1, np.int32)
    l2d = np.zeros((Kt, L2, 3), np.float32)
    for k in range(Kt):
        for i in range(NL):
            us, zs = _project(poses_gt[k], ln_s[i])
            ue, ze = _project(poses_gt[k], ln_e[i])
            if zs < 0.5 or ze < 0.5:
                continue
            eq = np.cross(np.r_[us, 1.0], np.r_[ue, 1.0])
            eq /= np.linalg.norm(eq[:2])
            ln_slot[k, 2 * i:2 * i + 2] = (P_pts + 2 * i, P_pts + 2 * i + 1)
            l2d[k, 2 * i] = l2d[k, 2 * i + 1] = eq
    pl_slot = np.tile(np.arange(NP, dtype=np.int32), (Kt, 1))
    pl_obs = np.stack([np.stack([np.asarray(jplane.normalize(jplane.transform(
        jnp.asarray(poses_gt[k]), jnp.asarray(pl_gt[i])))) for i in range(NP)])
        for k in range(Kt)]).astype(np.float32)
    poses0 = poses_gt.copy()
    for k in range(1, Kt):
        xi = np.r_[rng.normal(0, 0.004, 3), rng.normal(0, 0.015, 3)]
        poses0[k] = np.asarray(jse3.se3_exp(jnp.asarray(
            xi.astype(np.float32)))) @ poses0[k]
    lm0 = np.concatenate([
        pts_gt + rng.normal(0, 0.03, (P_pts, 3)).astype(np.float32),
        np.stack([ln_s, ln_e], axis=1).reshape(-1, 3)
        + rng.normal(0, 0.05, (L2, 3)).astype(np.float32)])
    pl0 = pl_gt.copy()
    pl0[:, 3] += rng.normal(0, 0.05, NP).astype(np.float32)
    nrm = pl0[:, :3] + rng.normal(0, 0.02, (NP, 3)).astype(np.float32)
    pl0[:, :3] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    fixed = np.zeros(Kt, np.float32)
    fixed[0] = 1.0
    return dict(poses0=poses0, fixed=fixed, lm0=lm0, pl0=pl0, slot=slot,
                uv=uv, ur=ur, ln_slot=ln_slot, l2d=l2d, pl_slot=pl_slot,
                pl_obs=pl_obs, poses_gt=poses_gt)


def _tables(r, lib):
    """The recipe's five tables for the JAX package (lib=jnp) or the port
    (lib=torch)."""
    if lib is jnp:
        put, ns = jnp.asarray, jba
    else:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a))
        ns = tba
    Kt = r["slot"].shape[0]
    ones = np.ones
    pt = ns.PointTables(put(r["slot"]), put(r["uv"]), put(r["ur"]),
                        put(ones(r["slot"].shape, np.float32)),
                        put((r["slot"] >= 0).astype(np.float32)))
    ln = ns.LineTables(put(r["ln_slot"]), put(r["l2d"]),
                       put(ones(r["ln_slot"].shape, np.float32)),
                       put((r["ln_slot"] >= 0).astype(np.float32)))
    pl = ns.PlaneTables(put(r["pl_slot"]), put(r["pl_obs"]),
                        put(ones(r["pl_slot"].shape, np.float32)))
    if lib is jnp:
        return pt, ln, pl, jba.empty_plane_tables(Kt), \
            jba.empty_plane_tables(Kt)
    return (pt, ln, pl, tba.empty_plane_tables(Kt, "cpu"),
            tba.empty_plane_tables(Kt, "cpu"))


def _jax_normal_eqs(poses, pts, r, M):
    """Hcc, bc, Hpp, bp, Hcp (Kt, 6, M, 3), chi_pt, chi_ln for points and
    line endpoints, from the JAX package's _point_jacs / _line_jacs and the
    sums of ba_solve.step (ba_core.py:361-404), in float64 numpy."""
    Kt = poses.shape[0]
    slot, ln_slot = r["slot"].clip(0), r["ln_slot"].clip(0)
    is_st = r["ur"] >= 0
    rp, Jc, Jp = (np.asarray(a, np.float64) for a in jba._point_jacs(
        jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(slot),
        jnp.asarray(r["uv"]), jnp.asarray(r["ur"]), jnp.asarray(is_st),
        CAM_K, BF))
    chi = np.sum(rp * rp, -1)
    gate = np.where(is_st, jba.CHI2_STEREO, jba.CHI2_MONO)
    hw = np.where(chi > gate, np.sqrt(gate / np.clip(chi, 1e-12, None)), 1.0)
    w = hw * (r["slot"] >= 0)
    W = w[..., None] * np.stack([np.ones_like(w), np.ones_like(w), is_st],
                                -1)
    rl, Jcl, Jpl = (np.asarray(a, np.float64) for a in jba._line_jacs(
        jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(ln_slot),
        jnp.asarray(r["l2d"]), CAM_K))
    chi_l = rl * rl
    wl = np.where(chi_l > jba.CHI2_MONO,
                  np.sqrt(jba.CHI2_MONO / np.clip(chi_l, 1e-12, None)),
                  1.0) * (r["ln_slot"] >= 0)
    Hcc = (np.einsum("kfai,kfa,kfaj->kij", Jc, W, Jc)
           + np.einsum("kli,kl,klj->kij", Jcl, wl, Jcl))
    bc = (np.einsum("kfai,kfa->ki", Jc, rp * W)
          + np.einsum("kli,kl->ki", Jcl, rl * wl))
    Hpp = np.zeros((M, 3, 3))
    bp = np.zeros((M, 3))
    Hcp = np.zeros((Kt, M, 6, 3))
    np.add.at(Hpp, slot, np.einsum("kfai,kfa,kfaj->kfij", Jp, W, Jp))
    np.add.at(bp, slot, np.einsum("kfai,kfa->kfi", Jp, rp * W))
    np.add.at(Hpp, ln_slot, np.einsum("kli,kl,klj->klij", Jpl, wl, Jpl))
    np.add.at(bp, ln_slot, Jpl * (rl * wl)[..., None])
    kk = np.arange(Kt)[:, None]
    np.add.at(Hcp, (np.broadcast_to(kk, slot.shape), slot),
              np.einsum("kfai,kfa,kfaj->kfij", Jc, W, Jp))
    np.add.at(Hcp, (np.broadcast_to(kk, ln_slot.shape), ln_slot),
              np.einsum("kli,kl,klj->klij", Jcl, wl, Jpl))
    return (Hcc, bc, Hpp, bp, Hcp.transpose(0, 2, 1, 3), chi, chi_l)


def _close(got, want, rel, name):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"{name}: {err} > {rel} x {scale}"


def test_ba_normal_eqs_plain_matches_jax():
    """K8's plain version against the JAX measurement model and sums, on
    the recipe with half the points mono, Huber active and one (keyframe,
    landmark) pair observed twice (it must add): every output within 2e-5
    of its largest magnitude (float32 sums in another order)."""
    r = _recipe()
    r["ur"][:, ::2] = -1.0
    f1, f2 = np.flatnonzero(r["slot"][1] >= 0)[:2]
    r["slot"][1, f2], r["uv"][1, f2] = r["slot"][1, f1], r["uv"][1, f1] + 40.0
    r["ur"][1, f2] = r["ur"][1, f1]
    P = r["lm0"].shape[0]
    M = P + 3
    want = _jax_normal_eqs(r["poses0"], r["lm0"], r, M)
    pt, ln, _, _, _ = _tables(r, torch)
    pt = pt._replace(slot=pt.slot.clamp(0))
    ln = ln._replace(slot=ln.slot.clamp(0))
    got = tba.ba_normal_eqs(torch.from_numpy(r["poses0"]),
                            torch.from_numpy(r["lm0"]), pt, ln, M, CAM_K, BF)
    assert float(np.max(want[5])) > jba.CHI2_STEREO  # Huber acts
    for name, g, w in zip(("Hcc", "bc", "Hpp", "bp", "Hcp", "chi_pt",
                           "chi_ln"), got, want):
        _close(g.numpy(), w, 2e-5, name)


def test_ba_schur_plain_matches_jax():
    """K9's plain versions against ba_solve's Schur formulas
    (ba_core.py:463-473, 491-492) evaluated in jnp float32: Hpp_inv,
    HcpHinv, rhs and dxp within 1e-4 of their largest magnitudes."""
    r = _recipe()
    P = r["lm0"].shape[0]
    M = P + 3
    Hcc, bc, Hpp, bp, Hcp, _, _ = (a.astype(np.float32) for a in
                                   _jax_normal_eqs(r["poses0"], r["lm0"], r,
                                                   M))
    lam, mu_p = np.float32(3e-3), np.float32(Hpp.trace(0, 1, 2).sum() / 300)
    Hpp[P:] = np.eye(3, dtype=np.float32) * 5.0  # plane rows, non-singular
    dxc = np.random.default_rng(3).normal(0, 1e-2, (4, 6)).astype(np.float32)
    jH = jnp.asarray(Hpp)
    diag = jnp.diagonal(jH, axis1=-2, axis2=-1)
    Hd = jH + lam * jnp.stack([jnp.diag(d) for d in diag]) + \
        (lam * mu_p + 1e-6) * jnp.eye(3)
    Hinv = jnp.linalg.inv(Hd)
    jHcp = jnp.asarray(Hcp.transpose(0, 2, 1, 3))      # JAX (Kt, M, 6, 3)
    HcpHinv = jnp.einsum("kpij,pjl->kpil", jHcp, Hinv)
    rhs = jnp.asarray(bc) - jnp.einsum("kpil,pl->ki", HcpHinv, bp)
    dxp = -jnp.einsum("pij,pj->pi", Hinv,
                      bp + jnp.einsum("kpij,ki->pj", jHcp, dxc))
    t = torch.from_numpy
    g_inv, g_hh, g_rhs = tba.ba_schur_eliminate(
        t(Hpp), t(bp), t(np.ascontiguousarray(Hcp)), t(bc), torch.tensor(lam),
        torch.tensor(mu_p))
    g_dxp = tba.ba_schur_backsub(g_inv, t(bp), t(np.ascontiguousarray(Hcp)),
                                 t(dxc))
    _close(g_inv.numpy(), Hinv, 1e-4, "Hpp_inv")
    _close(g_hh.numpy(), np.asarray(HcpHinv).transpose(0, 2, 1, 3), 1e-4,
           "HcpHinv")
    _close(g_rhs.numpy(), rhs, 1e-4, "rhs")
    _close(g_dxp.numpy(), dxp, 1e-4, "dxp")


@pytest.mark.parametrize("n_iters", [1, 15])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_solve_matches_jax(solver, n_iters):
    """ba_solve / ba_solve_pcg on the recipe against the JAX solver. After
    one iteration: poses atol 1e-4, landmarks 1e-3 m, planes 1e-4. After the
    full 15: poses and planes atol 1e-5, landmarks 2e-3 m (the line
    endpoints slide along their unobservable direction), the robust cost
    within 1% and the GT pose error reduced as JAX's."""
    r = _recipe()
    w_cfg = jconfig.PlaneConfig()
    j_args = (jnp.asarray(r["poses0"]), jnp.asarray(r["fixed"]),
              jnp.asarray(r["lm0"]), jnp.asarray(r["pl0"]),
              *_tables(r, jnp), CAM_K, BF, jba.BAWeights.from_config(w_cfg))
    t = torch.from_numpy
    t_args = (t(r["poses0"]), t(r["fixed"]), t(r["lm0"]), t(r["pl0"]),
              *_tables(r, torch), CAM_K, BF, tba.BAWeights.from_config(w_cfg))
    jf, tf = (jba.ba_solve, tba.ba_solve) if solver == "dense" else \
        (jpcg, tpcg)
    jp, jl, jpl, jchi = jf(*j_args, n_iters=n_iters)
    tp, tl, tpl, tchi = tf(*t_args, n_iters=n_iters)
    tol = (1e-4, 1e-3, 1e-4) if n_iters == 1 else (1e-5, 2e-3, 1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=tol[0])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol[1])
    np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), atol=tol[2])
    cost_j = sum(float(np.sum(np.asarray(v))) for v in jchi.values())
    cost_t = sum(float(v.sum()) for v in tchi.values())
    assert abs(cost_t - cost_j) <= 0.01 * cost_j + 1e-3
    if n_iters == 15:
        gt = r["poses_gt"][1:, :3, 3]
        err_t = np.linalg.norm(tp.numpy()[1:, :3, 3] - gt)
        err0 = np.linalg.norm(r["poses0"][1:, :3, 3] - gt)
        assert err_t < 0.2 * err0


@pytest.fixture(scope="module")
def tracked_map():
    """The JAX System (loop closing on, as in test_solvers and
    test_reloc_loop) over 16 frames of the tiny room."""
    cfg = jconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(16, width=cfg.camera.width,
                                  height=cfg.camera.height)
    slam = JSystem(config=cfg)
    for i in range(len(seq)):
        slam.track_rgbd(*seq.render(i), seq.timestamps[i])
    assert slam.map.n_kf >= 3
    return slam.map


def _compare_maps(tmap, jmap, atol):
    """Poses, points and planes atol; line endpoints 10 x atol, since a
    point-to-image-line residual leaves the endpoint free along its line
    (test_ba_full measures them off-line for the same reason)."""
    n = jmap.n_kf
    np.testing.assert_allclose(tmap.kf_pose[:n], jmap.kf_pose[:n], atol=atol)
    for name, tol in (("pt_xyz", atol), ("ln_sw", 10 * atol),
                      ("ln_ew", 10 * atol), ("pl_coeffs", atol)):
        np.testing.assert_allclose(getattr(tmap, name), getattr(jmap, name),
                                   atol=tol, err_msg=name)
    for name in ("kf_pt_idx", "pt_nobs", "pt_valid"):
        np.testing.assert_array_equal(getattr(tmap, name),
                                      getattr(jmap, name), err_msg=name)


def test_local_ba_on_map_matches_jax(tracked_map):
    """local_bundle_adjustment of the last keyframe on copies of the
    tracked map: kf_pose, pt_xyz and pl_coeffs atol 1e-3, ln_sw/ln_ew
    1e-2 (15 float32 LM iterations whose accept tests may flip near
    convergence); the erased observations (kf_pt_idx, pt_nobs) equal."""
    jcfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    jmap = copy.deepcopy(tracked_map)
    tmap = map_from_numpy(jmap, tcfg)
    kf = jmap.n_kf - 1
    before = jmap.kf_pose.copy()
    jlba.local_bundle_adjustment(jmap, kf, jcfg)
    tlba.local_bundle_adjustment(tmap, kf, tcfg, device="cpu")
    assert np.abs(jmap.kf_pose - before).max() > 0  # BA moved something
    _compare_maps(tmap, jmap, 1e-3)


def test_global_ba_on_map_matches_jax(tracked_map, monkeypatch):
    """global_bundle_adjustment on copies of the tracked map, with the caps
    of both packages cut to the same values (16 keyframes, 2048 points, 64
    lines, 16 planes; the map fits inside them, so the problem is the full
    one): poses, points and planes atol 5e-3, line endpoints 5e-2 (18
    float32 LM iterations), valid flags and associations equal."""
    for mod in (jgba, tgba):
        monkeypatch.setattr(mod, "MAX_GBA_KF", 16)
        monkeypatch.setattr(mod, "MAX_GBA_PTS", 2048)
        monkeypatch.setattr(mod, "MAX_GBA_LNS", 64)
        monkeypatch.setattr(mod, "MAX_GBA_PLS", 16)
    assert len(tracked_map.valid_kf_ids()) <= 16
    assert int(tracked_map.pt_valid.sum()) <= 2048
    jmap = copy.deepcopy(tracked_map)
    tmap = map_from_numpy(jmap, tconfig.SystemConfig.tiny())
    jgba.global_bundle_adjustment(jmap, jconfig.SystemConfig.tiny())
    tgba.global_bundle_adjustment(tmap, tconfig.SystemConfig.tiny(),
                                  device="cpu")
    assert np.isfinite(tmap.kf_pose[:tmap.n_kf]).all()
    _compare_maps(tmap, jmap, 5e-3)
