"""The 512-keyframe PCG orbit of chip_smoke.py's path 4c
(MAX_GBA_KF_PCG) on the CPU: the JAX package's ba_solve_pcg against the
port's solve through its plain versions, on the same orbit (ROADMAP
C.7(b)). Slow: not in the quick tier.

    python -m pytest tests/test_torch_pcg_orbit.py -q -m slow
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from planarslam_tpu.config import PlaneConfig as JPlaneConfig
from planarslam_tpu.solvers import ba_core as jba
from planarslam_tpu.solvers.ba_pcg import ba_solve_pcg as jpcg
from planarslam_tpu_torch.solvers.ba_pcg import ba_solve_pcg as tpcg

torch.set_num_threads(4)

# path 4c's limits on the 256-keyframe orbit (tests/test_ba_full.py::
# test_gba_pcg_beyond_dense_window): mean and max pose error after the
# solve below these shares of the start's, median point chi2 below 0.5
LIMIT_MEAN, LIMIT_MAX, LIMIT_CHI2 = 0.2, 0.4, 0.5


def _orbit_512():
    """Path 4c's 512-keyframe orbit: the third orbit drawn from
    default_rng(42), after the 96- and 256-keyframe ones, as
    chip_smoke.run_ba_scale_path draws them. Also returns its true
    landmarks, _orbit_problem's first draw."""
    rng = np.random.default_rng(42)
    for Kt, F in ((96, 48), (256, 24)):
        chip_smoke._orbit_problem(rng, Kt, 1024, F, torch.device("cpu"))
    pts_gt = copy.deepcopy(rng).normal(0, 1.5, (1024, 3)).astype(np.float32)
    return (*chip_smoke._orbit_problem(rng, chip_smoke.PCG_KF_LARGE, 1024,
                                       24, torch.device("cpu")), pts_gt)


def _jax_args(args):
    poses0, fixed, pts0, planes, pt = (a.numpy() if isinstance(
        a, torch.Tensor) else a for a in args[:5])
    Kt = poses0.shape[0]
    tab = jba.PointTables(*[jnp.asarray(t.numpy()) for t in pt])
    empty = jba.empty_plane_tables(Kt)
    return (jnp.asarray(poses0), jnp.asarray(fixed), jnp.asarray(pts0),
            jnp.asarray(planes), tab, jba.empty_line_tables(Kt), empty,
            empty, empty, args[9], args[10],
            jba.BAWeights.from_config(JPlaneConfig()))


def _outcome(poses_gt, poses0, poses1, chis, slot):
    err0 = np.linalg.norm(poses0[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    err1 = np.linalg.norm(poses1[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    chi = np.asarray(chis["pt"])[slot >= 0]
    # the orbit has points only: its cost is the observed slots' chi2
    assert all(np.asarray(v).size == 0 for k, v in chis.items()
               if k != "pt"), sorted(chis)
    cost = float(chi.sum())
    return {"mean": float(err1.mean() / err0.mean()),
            "max": float(err1.max() / err0.max()),
            "chi2": float(np.median(chi)), "cost": cost,
            "err1": err1}


@pytest.mark.slow
def test_pcg_512_orbit_matches_jax():
    """ba_solve_pcg (12 LM steps, as path 4c runs it) on the 512-keyframe
    orbit. The JAX package meets the 256 orbit's limits there (mean and
    max pose error below 0.2 and 0.4 of the start's, median chi2 below
    0.5), and so does the port's plain solve. The port's poses and
    landmarks are held to JAX's with test_ba_solve_matches_jax's limits
    after a full solve (poses atol 1e-5, landmarks 2e-3 m), and its cost
    to JAX's within that test's 1% plus this orbit's floor: the cost JAX
    evaluates at the true poses and landmarks, which is rounding alone
    (the observations are exact).

    Both solves end about 20 times above that floor (2.2e-7), where
    float32 holds the state (a rounding of a 6 m translation, 4.8e-7,
    moves a pixel by 2.4e-5): JAX at 5.13e-6, the port at 4.99e-6 to
    5.04e-6 (its CPU sums' order varies from run to run), a gap of 0.8e-7
    to 1.4e-7 (1.7-2.7%) that the 1% term alone (5.1e-8) would not hold;
    the pose errors differ by 1.4e-6 to 3.3e-6 m. The gap is where the
    solves stopped, not how the cost is summed: one evaluator gives JAX's
    state 5.17e-6 and the port's 4.97e-6 (the port's; JAX's: 5.13e-6 and
    4.97e-6), while the two evaluators differ by under 1% on one state."""
    poses_gt, poses0, args, slot, pts_gt = _orbit_512()
    n = chip_smoke.PCG_N_ITERS
    jargs = _jax_args(args)
    jp, jl, _, jchi = jpcg(*jargs, n_iters=n)
    tp, tl, _, tchi = tpcg(*args, n_iters=n)
    # the cost at the true state: no LM step, only the evaluation
    _, _, _, fchi = jpcg(jnp.asarray(poses_gt), jargs[1], jnp.asarray(pts_gt),
                         *jargs[3:], n_iters=0)
    want = _outcome(poses_gt, poses0, np.asarray(jp),
                    {k: np.asarray(v) for k, v in jchi.items()}, slot)
    got = _outcome(poses_gt, poses0, tp.numpy(),
                   {k: v.numpy() for k, v in tchi.items()}, slot)
    floor = _outcome(poses_gt, poses0, poses_gt,
                     {k: np.asarray(v) for k, v in fchi.items()},
                     slot)["cost"]
    gap = float(np.abs(got["err1"] - want["err1"]).max())
    print({k: v for k, v in want.items() if k != "err1"},
          {k: v for k, v in got.items() if k != "err1"},
          {"floor": floor, "pose_error_gap_m": gap})
    assert want["mean"] < LIMIT_MEAN and want["max"] < LIMIT_MAX \
        and want["chi2"] < LIMIT_CHI2, want
    assert got["mean"] < LIMIT_MEAN and got["max"] < LIMIT_MAX \
        and got["chi2"] < LIMIT_CHI2, got
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)
    assert 0 < floor < want["cost"], (floor, want["cost"])
    assert abs(got["cost"] - want["cost"]) <= 0.01 * want["cost"] + floor, \
        (got["cost"], want["cost"], floor)
