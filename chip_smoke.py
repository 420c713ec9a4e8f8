#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of planarslam on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 96]

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the hand-written kernels from planarslam_tpu_torch/csrc
     (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the 640x480 paths give it (inputs from frame 0 of the
     synthetic sequence, or from a numpy seed with planted structure), with
     both timings (median of 25 calls, CUDA events);
  4. path 1, tracking only: System(SystemConfig(), enable_local_mapping=
     False, enable_loop_closing=False) tracks the 640x480 synthetic room
     with frames quantized to uint8 gray / uint16 depth; ATE against ground
     truth, 0 lost frames;
  5. path 2, local mapping: System(SystemConfig(), enable_loop_closing=
     False) on the same frames; ATE, 0 lost, a mapping step per keyframe
     after the first;
  6. path 3, relocalization: the same System with a keyframe every 4
     frames tracks until the map holds more than 5 keyframes, loses
     tracking on noise frames, relocalizes on a revisited frame (Horn
     branch), then loses again and revisits a frame without depth (PnP
     branch).
Each path runs with the launch counts set to 0 just before it and read just
after; every kernel must have launched on the paths. The line before the
last is a JSON object with one entry per kernel; the last line is the
device JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ATE_LIMIT_M = 0.010
TIMING_REPS = 25
TRACKING_FRAMES = 48  # path 1 (tracking alone): cut to keep the run short


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_parity(seq, cfg, dev) -> list:
    """K1-K4 against their plain versions on the card."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import fast, image, orb, planes
    from planarslam_tpu_torch.ops import matching
    from planarslam_tpu_torch.ops.frontend import EDGE_BORDER, level_quotas

    out = []
    g8, d16 = quantize_frame(*seq.render(0), cfg.camera.depth_map_factor)
    gray = torch.from_numpy(g8.astype(np.float32)).to(dev)
    depth = torch.from_numpy(
        d16.astype(np.float32) / np.float32(cfg.camera.depth_map_factor)
    ).to(dev)
    levels = image.build_pyramid(gray, cfg.orb.n_levels, cfg.orb.scale_factor)
    blurs = [image.blur(l, ksize=7, sigma=2.0) for l in levels]
    quotas = level_quotas(cfg.orb.n_features, cfg.orb.n_levels,
                          cfg.orb.scale_factor)

    # K1: FAST score over all pyramid levels (exact: min/max/sub only)
    err = max(float((fast.fast_score(l) - fast.fast_score_plain(l))
                    .abs().max()) for l in levels)
    _check(err == 0.0, f"fast_score differs from plain by {err}")
    out.append({"name": "fast_score", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/fast_score.cu",
                "replaces": "planarslam_tpu/ops/fast.py:41",
                "max_abs_err": err, "tolerance": 0.0,
                "ms": _time_ms(lambda: [fast.fast_score(l) for l in levels]),
                "plain_ms": _time_ms(
                    lambda: [fast.fast_score_plain(l) for l in levels])})

    # K2: orientation + steered BRIEF at each level's selected keypoints
    kps = []
    for l, img_l in enumerate(levels):
        tile = max(8, int(round(cfg.orb.tile / (cfg.orb.scale_factor ** l))))
        uv, _, valid = fast.select_keypoints(
            fast.fast_score_plain(img_l), tile=tile, k_total=quotas[l],
            min_score=float(cfg.orb.min_th_fast), border=EDGE_BORDER)
        kps.append((levels[l], blurs[l], uv.contiguous(), valid.contiguous()))
    ang_err, bits_bad, n_valid = 0.0, 0, 0
    for img_l, blur_l, uv, valid in kps:
        a_k, d_k = orb.orb_describe(img_l, blur_l, uv, valid)
        a_p, d_p = orb.orb_describe_plain(img_l, blur_l, uv, valid)
        ang_err = max(ang_err, float((a_k - a_p).abs().max()))
        bits_bad += int(((d_k != d_p).any(dim=1) & valid).sum())
        n_valid += int(valid.sum())
    _check(ang_err <= 1e-4, f"orb_describe angle error {ang_err} > 1e-4")
    _check(bits_bad <= 0.01 * n_valid,
           f"orb_describe: {bits_bad}/{n_valid} descriptors differ (> 1%)")
    out.append({"name": "orb_describe", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/orb_describe.cu",
                "replaces": "planarslam_tpu/ops/orb.py:57",
                "max_abs_err": ang_err, "tolerance": 1e-4,
                "desc_mismatch": bits_bad, "n_keypoints": n_valid,
                "ms": _time_ms(lambda: [orb.orb_describe(*k) for k in kps]),
                "plain_ms": _time_ms(
                    lambda: [orb.orb_describe_plain(*k) for k in kps])})

    # K3: gated window search, M=4096 landmarks x N=1024 features
    rng = np.random.default_rng(7)
    M, N = 4096, cfg.orb.max_keypoints
    W, H = cfg.camera.width, cfg.camera.height

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    a_desc = t(rng.integers(-2 ** 31, 2 ** 31, (M, 8)), np.int32)
    b_desc = t(rng.integers(-2 ** 31, 2 ** 31, (N, 8)), np.int32)
    # plant near-duplicates so the window holds real matches
    src = rng.integers(0, M, N)
    flips = rng.random((N, 8, 32)) < 0.05
    flip_words = (flips * (1 << np.arange(32, dtype=np.int64))).sum(-1)
    b_desc = t((a_desc.cpu().numpy()[src].astype(np.int64)
                ^ flip_words).astype(np.uint32).view(np.int32))
    a_uv = rng.uniform(0, [W, H], (M, 2))
    b_uv = a_uv[src] + rng.normal(0, 2.0, (N, 2))
    a_level = rng.integers(0, cfg.orb.n_levels, M)
    gate = matching.ProjGate(
        a_uv=t(a_uv, np.float32),
        a_r=t(4.0 * cfg.orb.scale_factor ** a_level, np.float32),
        a_level=t(a_level, np.int32),
        a_ur_pred=t(a_uv[:, 0] - 20.0, np.float32),
        b_uv=t(b_uv, np.float32), b_level=t(a_level[src], np.int32),
        b_ur=t(np.where(rng.random(N) < 0.7, b_uv[:, 0] - 20.0, -1.0),
               np.float32),
        level_window=1)
    a_ok = t(rng.random(M) < 0.9)
    b_ok = t(rng.random(N) < 0.95)
    k3 = matching.gated_hamming_top2(a_desc, b_desc, a_ok, b_ok, gate)
    p3 = matching.gated_hamming_top2_plain(a_desc, b_desc, a_ok, b_ok, gate)
    err = max(int((x - y).abs().max()) for x, y in zip(k3, p3))
    k3u = matching.gated_hamming_top2(b_desc, a_desc[:N], b_ok, a_ok[:N])
    p3u = matching.gated_hamming_top2_plain(b_desc, a_desc[:N], b_ok,
                                            a_ok[:N])
    err = max(err, max(int((x - y).abs().max()) for x, y in zip(k3u, p3u)))
    _check(err == 0, f"gated_hamming_top2 differs from plain by {err}")
    _check(int((k3[0] <= cfg.matcher.th_high).sum()) > 100,
           "gated_hamming_top2 parity input holds too few matches")
    out.append({"name": "gated_hamming_top2", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/hamming_top2.cu",
                "replaces": "planarslam_tpu/ops/matching.py:169",
                "max_abs_err": float(err), "tolerance": 0.0,
                "ms": _time_ms(lambda: matching.gated_hamming_top2(
                    a_desc, b_desc, a_ok, b_ok, gate)),
                "plain_ms": _time_ms(lambda: matching.gated_hamming_top2_plain(
                    a_desc, b_desc, a_ok, b_ok, gate))})

    # K4: plane block moments of the 640x480 depth map
    pc = cfg.planes
    alpha = planes._noise_alpha(depth, pc.max_distance)
    geo_tol = 0.02 * 640.0 / W
    args = (depth, alpha, cfg.camera, geo_tol, pc.max_distance, pc.block)
    k4 = planes.plane_block_moments(*args)
    p4 = planes.plane_block_moments_plain(*args)
    err = max(float((x - y).abs().max()) for x, y in zip(k4, p4))
    scale = max(float(y.abs().max()) for y in p4)
    _check(err <= 1e-5 * scale,
           f"plane_block_moments error {err} > 1e-5 x {scale}")
    out.append({"name": "plane_block_moments", "route": "triton",
                "source": "planarslam_tpu_torch/csrc/plane_moments_triton.py",
                "replaces": "planarslam_tpu/ops/planes.py:223",
                "max_abs_err": err, "tolerance": 1e-5 * scale,
                "ms": _time_ms(lambda: planes.plane_block_moments(*args)),
                "plain_ms": _time_ms(
                    lambda: planes.plane_block_moments_plain(*args))})
    for k in out:
        print(f"kernel {k['name']}: max_abs_err={k['max_abs_err']} "
              f"(tolerance {k.pop('tolerance')}) ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f}", flush=True)
    return out


def _planted_se3(rng, scale: float = 0.3) -> np.ndarray:
    """A random rigid transform (numpy)."""
    w = rng.normal(0, scale, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T[:3, 3] = rng.normal(0, scale, 3)
    return T.astype(np.float32)


def backend_kernel_parity(cfg, dev) -> list:
    """K5-K7 against their plain versions on the card, on numpy-seeded
    inputs with planted structure, at the shapes of the 640x480 paths."""
    import torch

    from planarslam_tpu_torch.solvers import pnp, sim3_solver, triangulation

    out = []
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    Kp = cfg.orb.max_keypoints

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    def project(T, X):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)

    # K5: points seen from the own pose and 5 neighbours 0.1-0.5 m away,
    # 0.5 px noise, 10% outlier matches
    rng = np.random.default_rng(5)
    NB = 5
    X = np.stack([rng.uniform(-2.0, 2.0, Kp), rng.uniform(-1.5, 1.5, Kp),
                  rng.uniform(2.0, 6.0, Kp)], -1)
    own_T = np.eye(4, dtype=np.float32)
    nb_T = np.stack([_planted_se3(rng, 0.05) for _ in range(NB)])
    for i in range(NB):
        d = rng.normal(0, 1, 3)
        nb_T[i, :3, 3] = (0.1 + 0.4 * rng.random()) * d / np.linalg.norm(d)
    own_uv = project(own_T, X) + rng.normal(0, 0.5, (Kp, 2))
    uv2 = np.stack([project(nb_T[i], X) for i in range(NB)])
    uv2 += rng.normal(0, 0.5, uv2.shape)
    outl = rng.random((NB, Kp)) < 0.1
    uv2[outl] = rng.uniform(0, [cam.width, cam.height], (int(outl.sum()), 2))
    own_level = rng.integers(0, cfg.orb.n_levels, Kp)
    args5 = (t(own_uv, np.float32), t(own_level, np.int32),
             t(uv2, np.float32),
             t(np.broadcast_to(own_level, (NB, Kp)), np.int32),
             t(rng.random((NB, Kp)) < 0.9), t(own_T), t(nb_T, np.float32),
             K, cfg.orb.scale_factor)
    Xk, gk = triangulation.triangulate_two_view(*args5)
    Xp, gp = triangulation.triangulate_two_view_plain(*args5)
    torch.cuda.synchronize()
    both = (gk > 0) & (gp > 0)
    n_good = int(gp.sum())
    mismatch = int((gk != gp).sum())
    _check(n_good > 500, f"triangulate_two_view: only {n_good} good pairs")
    rel = float(((Xk - Xp).norm(dim=-1) / Xp.norm(dim=-1).clamp(min=1e-9))
                [both].max())
    _check(mismatch <= 0.005 * NB * Kp,
           f"triangulate_two_view: good differs on {mismatch} pairs")
    _check(rel <= 1e-3, f"triangulate_two_view: X relative error {rel}")
    out.append({"name": "triangulate_two_view", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/triangulate.cu",
                "replaces": "planarslam_tpu/slam/device_mapper.py:125",
                "max_abs_err": float((Xk - Xp)[both].abs().max()),
                "tolerance": "good mismatch <= 0.5%, X rel <= 1e-3",
                "good_pairs": n_good, "good_mismatch": mismatch,
                "ms": _time_ms(lambda: triangulation.triangulate_two_view(
                    *args5)),
                "plain_ms": _time_ms(
                    lambda: triangulation.triangulate_two_view_plain(*args5))})

    # K6: 1024 correspondences, 60% inliers of a known SE3 (1 cm noise),
    # the 64 one-hot hypothesis rows of the RANSAC (default_rng(7) picks)
    rng = np.random.default_rng(6)
    n = 1024
    src = rng.uniform([-3, -2, 1], [3, 2, 7], (n, 3)).astype(np.float32)
    Tg = _planted_se3(rng)
    dst = src @ Tg[:3, :3].T + Tg[:3, 3] + rng.normal(0, 0.01, (n, 3))
    bad = rng.random(n) >= 0.6
    dst[bad] = rng.uniform([-3, -2, 1], [3, 2, 7], (int(bad.sum()), 3))
    s_p, d_p, v_p, picks = sim3_solver._pad_pair(src, dst, 64)
    w = np.zeros((64, len(s_p)), np.float32)
    np.put_along_axis(w, picks.astype(np.int64), 1.0, axis=1)
    w = w * v_p[None] + np.float32(1e-9)
    args6 = (t(s_p), t(d_p), t(v_p), t(w), 0.08)
    k6 = sim3_solver.horn_align_batch(*args6)
    p6 = sim3_solver.horn_align_batch_plain(*args6)
    torch.cuda.synchronize()
    err6 = max(float((k6[0] - p6[0]).abs().max()),
               float((k6[1] - p6[1]).abs().max()))
    _check(bool((k6[2] == p6[2]).all()),
           "horn_align_batch: inlier counts differ from plain")
    _check(err6 <= 1e-4, f"horn_align_batch: R, t error {err6} > 1e-4")
    best = int(p6[2].max())
    _check(best > 0.5 * n, f"horn_align_batch: best hypothesis has {best} "
           f"inliers of {n} (planted 60%)")
    out.append({"name": "horn_align_batch", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/horn_align.cu",
                "replaces": "planarslam_tpu/solvers/sim3_solver.py:23",
                "max_abs_err": err6, "tolerance": "n_inl equal, R t 1e-4",
                "best_inliers": best,
                "ms": _time_ms(lambda: sim3_solver.horn_align_batch(*args6)),
                "plain_ms": _time_ms(
                    lambda: sim3_solver.horn_align_batch_plain(*args6))})

    # K7: 256 correspondences, 80% inliers (0.5 px), the 128 DLT hypotheses
    # of the RANSAC (default_rng(11) picks)
    rng = np.random.default_rng(7)
    n = 256
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    Tg = _planted_se3(rng, 0.1)
    uv = project(Tg, xw) + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) >= 0.8
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    uv_n = np.stack([(uv[:, 0] - cam.cx) / cam.fx,
                     (uv[:, 1] - cam.cy) / cam.fy], -1).astype(np.float32)
    picks = np.random.default_rng(11).integers(0, n, (128, 6)).astype(
        np.int32)
    inv_s2 = np.full(n, np.float32(cam.fx * cam.fy), np.float32)
    args7 = (t(xw), t(uv_n), t(inv_s2), t(np.ones(n, bool)), t(picks), 5.991)
    sk, Tk = pnp.pnp_dlt_hypotheses(*args7)
    sp, Tp = pnp.pnp_dlt_hypotheses_plain(*args7)
    torch.cuda.synchronize()
    close = float(((sk - sp).abs() <= 2).to(torch.float32).mean())
    Tbk, Tbp = Tk[int(torch.argmax(sk))], Tp[int(torch.argmax(sp))]
    err_R = float((Tbk[:3, :3] - Tbp[:3, :3]).abs().max())
    err_t = float((Tbk[:3, 3] - Tbp[:3, 3]).abs().max())
    _check(close >= 0.95, f"pnp_dlt_hypotheses: scores within 2 on only "
           f"{close:.3f} of hypotheses")
    _check(err_R <= 0.01 and err_t <= 0.05,
           f"pnp_dlt_hypotheses: best T differs by {err_R} (R), {err_t} (t)")
    _check(int(sp.max()) > 0.6 * n, f"pnp_dlt_hypotheses: best hypothesis "
           f"has {int(sp.max())} inliers of {n} (planted 80%)")
    out.append({"name": "pnp_dlt_hypotheses", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/pnp_dlt.cu",
                "replaces": "planarslam_tpu/solvers/pnp.py:25",
                "max_abs_err": max(err_R, err_t),
                "tolerance": "scores +-2 on >= 95%, best T 0.01 / 0.05",
                "scores_within_2": close,
                "max_score_diff": int((sk - sp).abs().max()),
                "ms": _time_ms(lambda: pnp.pnp_dlt_hypotheses(*args7)),
                "plain_ms": _time_ms(
                    lambda: pnp.pnp_dlt_hypotheses_plain(*args7))})
    for k in out:
        print(f"kernel {k['name']}: max_abs_err={k['max_abs_err']} "
              f"(tolerance {k.pop('tolerance')}) ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f}", flush=True)
    return out


def _drive(slam, frames, timestamps) -> list:
    """Track the frames; per-frame host ms."""
    times = []
    for i, (g, d) in enumerate(frames):
        t0 = time.perf_counter()
        slam.track_rgbd(g, d, timestamps[i])
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def run_tracking_path(name, seq, frames, cfg, dev, local_mapping: bool
                      ) -> dict:
    """Path 1 (tracking only) or path 2 (with local mapping) end to end;
    returns its metrics and launch counts."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.evaluation.ate import ate_rmse
    from planarslam_tpu_torch.slam.system import System

    n_frames = len(frames)
    slam = System(config=cfg, enable_local_mapping=local_mapping,
                  enable_loop_closing=False, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    times = _drive(slam, frames, seq.timestamps)
    slam.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = dict(kernels.LAUNCHES)
    poses = slam.frame_poses_wc()
    _check(poses.shape == (n_frames, 4, 4),
           f"{name}: trajectory shape {poses.shape} != ({n_frames}, 4, 4)")
    _check(bool(np.all(np.isfinite(poses))), f"{name}: non-finite poses")
    ate = ate_rmse(poses[:, :3, 3], seq.poses_wc[:n_frames, :3, 3])
    t_ms = np.asarray(times[1:])
    m = slam.map
    st = slam.tracker.stats
    res = {"ate_rmse_m": ate, "frames": n_frames,
           "keyframes": int(m.n_kf),
           "valid_keyframes": int(len(m.valid_kf_ids())),
           "map_points": int(m.pt_valid.sum()),
           "map_lines": int(m.ln_valid.sum()),
           "lost": int(st["lost"]),
           "manhattan_success": int(st["manhattan_success"]),
           "median_ms_per_frame": float(np.median(t_ms)),
           "p95_ms_per_frame": float(np.percentile(t_ms, 95)),
           "wall_s": wall, "launches": launches}
    if slam.local_mapper is not None:
        res["mapping"] = dict(slam.local_mapper.stats)
    print(f"{name} " + json.dumps(res), flush=True)
    _check(ate < ATE_LIMIT_M, f"{name}: ATE {ate:.5f} m >= {ATE_LIMIT_M} m")
    _check(res["lost"] == 0, f"{name}: {res['lost']} lost frames")
    if slam.local_mapper is not None:
        steps = res["mapping"]["mapping_steps"]
        _check(steps >= m.n_kf - 1, f"{name}: {steps} mapping steps for "
               f"{m.n_kf} keyframes")
    return res


def run_reloc_path(seq, cfg, dev) -> dict:
    """Path 3: lose tracking with a mature map and relocalize, first on a
    revisited frame with depth (Horn branch), then on one without (PnP
    branch)."""
    import dataclasses

    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System
    from planarslam_tpu_torch.slam.tracking import TrackingState

    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=4))
    dmf = cfg.camera.depth_map_factor
    slam = System(config=cfg, enable_loop_closing=False, device=dev)
    # keyframe culling out of the way: relocalization is the subject
    slam.local_mapper._cull_keyframes = lambda kf: None
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    i = 0
    while i < len(seq) and (i < 12 or len(slam.map.valid_kf_ids()) <= 5):
        slam.track_rgbd(*quantize_frame(*seq.render(i), dmf),
                        seq.timestamps[i])
        i += 1
    tracked = i
    n_kf = int(len(slam.map.valid_kf_ids()))
    _check(slam.get_tracking_state() == TrackingState.OK and n_kf > 5,
           f"reloc: {n_kf} keyframes after {tracked} frames, state "
           f"{slam.get_tracking_state()}")
    rng = np.random.default_rng(0)
    H, W = cfg.camera.height, cfg.camera.width

    def kill(t0):
        for j in range(4):
            noise = rng.uniform(0, 255, (H, W)).astype(np.uint8)
            slam.track_rgbd(noise, np.zeros((H, W), np.uint16), t0 + j)
        _check(slam.get_tracking_state() == TrackingState.LOST,
               "reloc: noise frames did not lose tracking")

    def revisit(k, t, with_depth):
        g8, d16 = quantize_frame(*seq.render(k), dmf)
        if not with_depth:
            d16 = np.zeros_like(d16)
        t0 = time.perf_counter()
        pose = slam.track_rgbd(g8, d16, t)
        ms = (time.perf_counter() - t0) * 1e3
        err = float(np.linalg.norm(
            pose[:3, 3] - np.linalg.inv(seq.poses_wc[k])[:3, 3]))
        return slam.get_tracking_state() == TrackingState.OK, err, ms

    kill(50.0)
    n_horn0 = kernels.LAUNCHES["horn_align_batch"]
    ok, err, ms = revisit(3, 60.0, True)
    relocs = int(slam.tracker.stats.get("relocalizations", 0))
    _check(ok and relocs >= 1, f"reloc: revisit of frame 3 not relocalized "
           f"(ok={ok}, relocalizations={relocs})")
    _check(err < 0.05, f"reloc: position error {err} m >= 0.05 m")
    _check(kernels.LAUNCHES["horn_align_batch"] > n_horn0,
           "reloc: the Horn branch did not launch horn_align_batch")
    kill(70.0)
    n_pnp0 = kernels.LAUNCHES["pnp_dlt_hypotheses"]
    ok2, err2, ms2 = revisit(5, 80.0, False)
    torch.cuda.synchronize()
    res = {"frames_tracked": tracked, "keyframes": n_kf,
           "horn": {"ok": ok, "position_error_m": err, "ms": ms},
           "pnp": {"ok": ok2, "position_error_m": err2, "ms": ms2,
                   "pnp_launches": kernels.LAUNCHES["pnp_dlt_hypotheses"]
                   - n_pnp0},
           "relocalizations": int(slam.tracker.stats.get(
               "relocalizations", 0)),
           "wall_s": time.perf_counter() - t_all,
           "launches": dict(kernels.LAUNCHES)}
    print("path3_reloc " + json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=96,
                    help="frames of path 2 (local mapping)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs a GPU")

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    kernels.cuda_lib()
    kernels.triton_module()
    print(f"build {time.perf_counter() - t0:.1f}s -> {path}", flush=True)

    cfg = SystemConfig()
    n = max(args.frames, TRACKING_FRAMES)
    seq = synthetic.make_sequence(n, width=cfg.camera.width,
                                  height=cfg.camera.height)
    report = kernel_parity(seq, cfg, dev) + backend_kernel_parity(cfg, dev)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(n)]
    paths = [
        run_tracking_path("path1_tracking", seq,
                          frames[:TRACKING_FRAMES], cfg, dev, False),
        run_tracking_path("path2_mapping", seq, frames[:args.frames], cfg,
                          dev, True),
        run_reloc_path(seq, cfg, dev),
    ]
    for k in report:
        k["launches"] = sum(p["launches"][k["name"]] for p in paths)
        _check(k["launches"] > 0,
               f"kernel {k['name']} was not launched by the paths")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
