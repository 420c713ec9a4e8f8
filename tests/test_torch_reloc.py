"""Port parity of relocalization: Horn RANSAC (K6's plain version), PnP
RANSAC (K7's plain version), and the System relocalizing after a loss with
a mature map, each against the JAX package (JAX on the CPU); and the reset
after a loss with a young map.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu.solvers import pnp as jpnp
from planarslam_tpu.solvers import sim3_solver as jsim3
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.slam.system import System as TSystem
from planarslam_tpu_torch.slam.tracking import TrackingState
from planarslam_tpu_torch.solvers import pnp as tpnp
from planarslam_tpu_torch.solvers import sim3_solver as tsim3

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [40, 300, 2000])
def test_horn_ransac_se3_matches_jax(n):
    """horn_ransac_se3 on seeded correspondences (a known SE3, 1 cm noise,
    40% outliers; n spans three padding buckets): inlier count and mask
    equal to JAX's, T atol 1e-4."""
    rng = np.random.default_rng(n)
    src = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.3, 6).astype(np.float32))))
    dst = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    bad = rng.random(n) < 0.4
    dst[bad] = rng.uniform(-3, 3, (int(bad.sum()), 3))
    Tj, nj, ij = jsim3.horn_ransac_se3(src, dst, threshold=0.08)
    Tt, nt, it = tsim3.horn_ransac_se3(src, dst, threshold=0.08,
                                       device="cpu")
    assert nt == nj and nt > 0.5 * n
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)


def test_pnp_ransac_matches_jax(rng):
    """pnp_ransac on the case of test_reloc_loop.py::test_pnp_ransac_basic:
    the same thresholds (>= 55 inliers, R atol 0.01, t atol 0.05 against
    the true pose), and an inlier count within 2 of JAX's."""
    K = (300.0, 310.0, 160.0, 120.0)
    n = 80
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2, 6, n)
    xi = np.array([0.2, -0.1, 0.15, 0.05, -0.08, 0.1], np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2],
                   K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    out = rng.choice(n, 16, replace=False)
    uv[out] += rng.uniform(20, 60, (16, 2))
    uv = uv.astype(np.float32)
    _, _, n_j = jpnp.pnp_ransac(pts, uv, np.ones(n, bool), K)
    T_est, inl, n_t = tpnp.pnp_ransac(pts, uv, np.ones(n, bool), K,
                                      device="cpu")
    assert n_t >= 55 and n_t == int(inl.sum())
    assert abs(n_t - n_j) <= 2
    np.testing.assert_allclose(T_est[:3, :3], T[:3, :3], atol=0.01)
    np.testing.assert_allclose(T_est[:3, 3], T[:3, 3], atol=0.05)


def _reloc_recipe(make_system, cfg):
    """test_reloc_loop.py's recipe: a keyframe every 4 frames, keyframe
    culling off, track until more than 5 keyframes, 4 noise frames, then
    revisit frame 3. Returns (system, pose, sequence, state after noise)."""
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=4))
    seq = synthetic.make_sequence(n_frames=40, width=cfg.camera.width,
                                  height=cfg.camera.height)
    slam = make_system(cfg)
    slam.local_mapper._cull_keyframes = lambda kf: None
    i = 0
    while i < len(seq) and (i < 12 or len(slam.map.valid_kf_ids()) <= 5):
        slam.track_rgbd(*seq.render(i), seq.timestamps[i])
        i += 1
    assert len(slam.map.valid_kf_ids()) > 5
    rng = np.random.default_rng(0)
    for j in range(4):
        noise = rng.uniform(0, 255, (cfg.camera.height, cfg.camera.width)
                            ).astype(np.float32)
        slam.track_rgbd(noise, np.zeros_like(noise), 50.0 + j)
    lost_state = slam.get_tracking_state()
    pose = slam.track_rgbd(*seq.render(3), 60.0)
    return slam, pose, seq, lost_state


@pytest.fixture(scope="module")
def jax_reloc():
    slam, pose, _, lost = _reloc_recipe(
        lambda c: JSystem(config=c, enable_loop_closing=False),
        jconfig.SystemConfig.tiny())
    assert lost.name == "LOST" and slam.get_tracking_state().name == "OK"
    return pose


def test_relocalization_after_lost(jax_reloc):
    """The port's System relocalizes after a loss with a mature map (the
    recipe of test_reloc_loop.py::test_relocalization_after_lost, local
    mapping on): LOST after the noise frames, OK on the revisit, position
    error < 0.05 m, and the relocalized pose within 1 cm of the JAX
    tracker's."""
    slam, pose, seq, lost = _reloc_recipe(
        lambda c: TSystem(config=c, enable_loop_closing=False, device="cpu"),
        tconfig.SystemConfig.tiny())
    assert lost == TrackingState.LOST
    assert slam.get_tracking_state() == TrackingState.OK
    assert slam.tracker.stats.get("relocalizations", 0) >= 1
    T_gt_cw = np.linalg.inv(seq.poses_wc[3])
    assert np.linalg.norm(pose[:3, 3] - T_gt_cw[:3, 3]) < 0.05
    assert np.linalg.norm(pose[:3, 3] - jax_reloc[:3, 3]) < 0.01


def test_auto_reset_on_early_loss():
    """A loss with a young map (<= 5 keyframes) resets the port's System
    instead of relocalizing, and clean frames then re-initialize and track
    (test_reloc_loop.py::test_auto_reset_on_early_loss)."""
    cfg = tconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(n_frames=14, width=cfg.camera.width,
                                  height=cfg.camera.height)
    slam = TSystem(config=cfg, enable_loop_closing=False, device="cpu")
    for i in range(3):
        slam.track_rgbd(*seq.render(i), seq.timestamps[i])
    assert len(slam.map.valid_kf_ids()) <= 5
    rng = np.random.default_rng(0)
    for j in range(3):
        noise = rng.uniform(0, 255, (cfg.camera.height, cfg.camera.width)
                            ).astype(np.float32)
        slam.track_rgbd(noise, np.zeros_like(noise), 50.0 + j)
    assert slam.get_tracking_state() != TrackingState.LOST
    assert len(slam.map.valid_kf_ids()) == 0
    for i in range(3, 10):
        slam.track_rgbd(*seq.render(i), seq.timestamps[i])
    assert slam.get_tracking_state() == TrackingState.OK
    assert len(slam.map.valid_kf_ids()) >= 1
