"""Port parity of the whole System with its backend: loop closing on (the
default System) over the tiny loop sequence of
tests/test_reloc_loop.py::test_loop_closing_on_loop_sequence, and local
mapping with local BA over the 16-frame sequence of
tests/test_torch_mapping.py, each against the JAX System with the same
switches and the same uint8 / uint16 frames (JAX on the CPU).
"""

import dataclasses

import numpy as np
import torch

from planarslam_tpu import config as jconfig
from planarslam_tpu.evaluation.ate import ate_rmse
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu.solvers import global_ba as jgba
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.io.frames import quantize_frame
from planarslam_tpu_torch.slam.system import System as TSystem
from planarslam_tpu_torch.solvers import global_ba as tgba

torch.set_num_threads(2)


def _run(slam, seq, frames):
    for i, (g, d) in enumerate(frames):
        slam.track_rgbd(g, d, seq.timestamps[i])
    return slam.frame_poses_wc()


def _gap(a, b):
    return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)


def test_system_loop_closing_matches_jax(monkeypatch):
    """The default System (loop closing on) with min_kf_gap=3 and
    consistency_threshold=2, as the JAX test relaxes them, over 30 frames
    of the loop sequence: loops_closed and lost counts equal to the JAX
    System's; per-frame position gap median <= 3 mm, max <= 2 cm; ATE
    < 0.08 m as the JAX test holds. The GBA caps of both packages are cut
    to the same 16 keyframes, 2048 points, 64 lines and 16 planes (which
    hold this map) to keep the file short."""
    for mod in (jgba, tgba):
        monkeypatch.setattr(mod, "MAX_GBA_KF", 16)
        monkeypatch.setattr(mod, "MAX_GBA_PTS", 2048)
        monkeypatch.setattr(mod, "MAX_GBA_LNS", 64)
        monkeypatch.setattr(mod, "MAX_GBA_PLS", 16)

    def relaxed(cfg):
        return cfg.replace(loop=dataclasses.replace(
            cfg.loop, min_kf_gap=3, consistency_threshold=2))

    jcfg = relaxed(jconfig.SystemConfig.tiny())
    tcfg = relaxed(tconfig.SystemConfig.tiny())
    seq = synthetic.make_sequence(30, kind="loop", width=jcfg.camera.width,
                                  height=jcfg.camera.height)
    frames = [quantize_frame(*seq.render(i), jcfg.camera.depth_map_factor)
              for i in range(len(seq))]
    js = JSystem(config=jcfg)
    jp = _run(js, seq, frames)
    ts = TSystem(config=tcfg, device="cpu")
    tp = _run(ts, seq, frames)
    assert tp.shape == (len(seq), 4, 4)
    assert ts.loop_closer.loops_closed == js.loop_closer.loops_closed
    assert ts.tracker.stats["lost"] == js.tracker.stats["lost"] <= 2
    gap = _gap(tp, jp)
    assert np.median(gap) <= 0.003 and gap.max() <= 0.02
    assert ate_rmse(tp[:, :3, 3], seq.poses_wc[:, :3, 3]) < 0.08
    assert np.isfinite(ts.map.kf_pose[:ts.map.n_kf]).all()


def test_system_local_ba_matches_jax():
    """Local mapping with local BA on, loop closing off, over the 16-frame
    tiny room: 0 lost in both, per-frame position gap to the JAX System
    median <= 3 mm and max <= 2 cm, valid keyframe counts equal, local BA
    run on every keyframe whose mapping step found >= 3 keyframes."""
    jcfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(16, width=160, height=120)
    frames = [quantize_frame(*seq.render(i), jcfg.camera.depth_map_factor)
              for i in range(len(seq))]
    js = JSystem(config=jcfg, enable_loop_closing=False)
    js.local_mapper.enable_local_ba = True
    jp = _run(js, seq, frames)
    ts = TSystem(config=tcfg, enable_loop_closing=False, device="cpu")
    ts.local_mapper.enable_local_ba = True
    tp = _run(ts, seq, frames)
    assert ts.tracker.stats["lost"] == 0 == js.tracker.stats["lost"]
    gap = _gap(tp, jp)
    assert np.median(gap) <= 0.003 and gap.max() <= 0.02
    assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids())
    assert ts.local_mapper.stats["local_ba"] >= 1


def _rebase_map(m, W):
    """Move a whole map into the world frame W (x' = W x), as a loop
    correction moves it: keyframe poses, points, line endpoints, planes and
    their clouds."""
    R, t = W[:3, :3], W[:3, 3]
    W_inv = np.linalg.inv(W).astype(np.float32)
    n = m.n_kf
    m.kf_pose[:n] = (m.kf_pose[:n] @ W_inv).astype(np.float32)
    for arr in (m.pt_xyz, m.ln_sw, m.ln_ew):
        arr[:] = (arr @ R.T + t).astype(np.float32)
    n_w = m.pl_coeffs[:, :3] @ R.T
    m.pl_coeffs[:] = np.concatenate(
        [n_w, (m.pl_coeffs[:, 3] - n_w @ t)[:, None]], axis=1)
    m.pl_cloud[:] = (m.pl_cloud @ R.T + t).astype(np.float32)


def test_tracker_rebase_after_map_correction_matches_jax():
    """Tracking only, 12 frames of the tiny room; after frame 6 both maps
    move rigidly (5 cm, 0.03 rad) and each tracker is re-based with
    apply_map_correction, as loop closing does, while frames are in flight.
    The port's pose after every later frame matches the JAX tracker's
    within 3 mm (the tracking parity of test_torch_slice.py); a tracker
    that dropped the override or the in-flight correction would be off by
    the 5-9 cm of the move."""
    from planarslam_tpu_torch.geometry import se3

    jcfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(12, width=160, height=120)
    frames = [quantize_frame(*seq.render(i), jcfg.camera.depth_map_factor)
              for i in range(len(seq))]
    W = se3.se3_exp(torch.tensor([0.03, -0.02, 0.03, 0.02, -0.01, 0.02])
                    ).numpy().astype(np.float32)
    js = JSystem(config=jcfg, enable_local_mapping=False,
                 enable_loop_closing=False)
    ts = TSystem(config=tcfg, enable_local_mapping=False,
                 enable_loop_closing=False, device="cpu")
    after = []
    for i, (g, d) in enumerate(frames):
        if i == 6:
            for slam in (js, ts):
                kf = slam.tracker.ref_kf
                T_old = slam.map.kf_pose[kf].copy()
                _rebase_map(slam.map, W)
                assert slam.tracker._pending  # frames are in flight
                slam.tracker.apply_map_correction(T_old,
                                                  slam.map.kf_pose[kf].copy())
        Tj = js.track_rgbd(g, d, seq.timestamps[i])
        Tt = ts.track_rgbd(g, d, seq.timestamps[i])
        if i >= 6:
            after.append((i, Tj, Tt))
    for i, Tj, Tt in after:
        gap = np.linalg.norm(np.linalg.inv(Tt)[:3, 3]
                             - np.linalg.inv(Tj)[:3, 3])
        assert gap <= 0.003, (i, gap)
