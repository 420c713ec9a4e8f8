#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of planarslam on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 96]

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the hand-written kernels from planarslam_tpu_torch/csrc
     (one nvcc per source, in parallel), and print ptxas's registers,
     spills and stack frame for each kernel of pose_opt.cu, lines.cu,
     hamming_top2.cu, plane_segment.cu, manhattan.cu, depth_normals.cu,
     fast_score.cu and line_lift_search.cu;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the 640x480 paths give it (inputs from frame 0 of the
     synthetic sequence, or from a numpy seed with planted structure), with
     both timings (median of 25 calls, CUDA events); K11 (pose_optimize)
     on its seeded problem from three starts (near, the true pose, 0.1 rad
     and 0.1 m off), timed per call, per LM step (1 x 1, 1 x 10 and 4 x 10
     steps) and by its device time, and also on the inputs of one tracked
     frame of path 1, after that path;
     K3 also on planted edge cases (every row dead, one gated-in column,
     N = 1, duplicate best columns across two column tiles, N above one
     tile, windows of up to 70 pixels, B = 8, both directions of a mutual
     match in one launch) and timed on one tracking step's launches;
     K12-K14 (plane segmentation) on frame 0's quantized depth and on the
     same depth with Kinect noise, also against the plain version run in
     float64; K12 also on eight lanes' frame 0 in one launch (each lane
     bit-equal to its own launch), captured in a CUDA graph and replayed;
     K6 (Horn alignment) in its weights mode, its triplet mode bit-equal
     to a weights launch on the plain version's rows, its refit to the
     plain pick and a weights launch, its scale mode within 1e-5 of its
     plain version; K7 (the DLT hypotheses, a warp's Jacobi solve each)
     within 1e-5 of its float64 plain version where the picks are
     distinct, K46 (the PnP selection) bit-equal at B = 1 and 4; K47
     (match_lines) bit-equal on path 1's consecutive frames' line features
     and MATCH_PLANTED at B = 1 and 4;
     K15 (Manhattan mean shift) on frame 0's normals and line directions,
     also on them twice over (N = 4224) and on none; K16-K19 (pyramid, blur, keypoint selection, point
     epilogue) and the all-levels launches of K1 and K2 on frame 0's
     8-level pyramid and 1000 keypoints, K16 also on a 1280x960 frame, a
     64x48 one and frames 0-3 at B = 4 lane by lane, into a buffer
     filled with NaN (pyramid_protocol) and captured and replayed, K1
     also on planted levels
     narrower or shorter than its ring and a flat image, K18 also on a
     planted score map
     with ties, empty tiles and more than 4 candidates per tile, and the
     whole extract_point_features on the card against the same function
     composed of plain versions; K20-K23 (line detection, band
     descriptors, 3D lifting, guided line search) on frame 0, its depth
     clean and with Kinect noise, the search on the 256-line window of four
     frames' lines seen from a fifth, on 4096 lines, with no candidate,
     with fewer than 6 earned, with a planted tie, on 250 and 1000 lines
     and with every candidate NaN, and the whole extract_line_features
     against its plain composition; K20's device time split by launch, and its
     selection stage alone against lax_compat.top_k on planted score maps
     (ties below and at the E-th rank, fewer than E nonzero, all zero);
     K24-K27 (projection prologue, match
     selection, frame-match selection, observation assembly) on frames
     0 -> 1: the frame search, the window search over those landmarks
     tiled to 4096 slots with planted normals and distance ranges,
     match_descriptors, and the line observations of frame 1's line search;
     K25 also on SELECT_PLANTED and K26 on FRAME_PLANTED (rotations of +0
     and -0, just below 0, at the bin edges, ties, the 10% edge, few bins,
     19 and 20 projection matches, small M and N, the filter mode up to M
     = 5000), at B = 1 and 4 lane by lane, into outputs filled with NaN,
     K26's kept rows also against card_keep_reference;
     K28-K31 (depth-noise median, frame normals, plane association, the
     step's tail), each bit-equal to its plain version in every output
     slot: K28 on frame 0's depth clean and with Kinect noise and on
     planted depths (no valid sample, odd and even counts, a flat plane,
     many duplicates, two middle values in different top digits, exactly
     two samples, a 1280x960 frame), K29 on the same two depths, at
     strides 1, 4 (windows
     that wrap around the image) and 7, and at B = 4 lane by lane,
     K30 on planted associations (a tie, the direct match also the most
     parallel, an empty cloud, no map plane, an invalid map plane nearer
     than any valid one, point counts of 0, C and above C, a NaN point,
     half the frame planes invalid), also four of them at B = 4 lane by
     lane, K30 and K31 on the last
     tracking step of two 10-frame Systems (clean, noisy), K31 on random
     tails and on TAIL_PLANTED (the frustum's edges hit exactly, NaN and
     infinite coordinates, planted depths, every feature tracked, none
     valid, n_in2 at min_inliers - 1 and at it, K = 1000 with L = 60 and
     P = 13; B = 1 and 4 lane by lane, outputs filled with NaN), and both
     again on the inputs of path 1's 48th tracking step;
     K36 (the step's prelude) bit-equal to its plain version on the
     inputs of path 1's 48th tracking step and on four planted lanes;
     K37 (the step's sensor decode and window casts) bit-equal to its
     plain version on path 1's frame 0, a frame holding every depth value,
     643x481, 1280x960 and 64x48 frames, frames 0-3 at B = 4 lane by lane,
     planted windows (flags 0, 0.5, the float above 0.5, 1 and NaN, cloud
     counts 0, 1 and 128), the unpacked entry and float frames, into
     outputs filled with NaN; K38 (the carried-state lift) on path 1's
     48th step against its plain version and K31's new_state at B = 1 and
     4; K39 (the Manhattan seed) on path 1's first frame and planted
     direction sets (no valid plane, ties, no perpendicular candidate, a
     lone line; B = 4), R_seed within 1e-6, ok, the picks and the
     direction set exact; K26's bins of the 270 edge values and of
     denormal rotations equal to JAX's (JAX_EDGE_BINS); the packed fuse
     set against the per-target loop on path 2's map (0-5 targets, a set
     above capacity) and path 2's mapping steps bit-equal to the same
     steps run per target; the
     batch of K1, K3, K4, K11, K12-K14, K15 (with its initial-pose
     epilogue), K16, K23 and K28 on four lanes in one launch each, every lane
     bit-equal to its own B = 1 launch and held to its plain version as
     one problem is,
     timed at B = 1 and B = 4; one K13 launch per round and one K28
     launch per call (the wrappers' counts), their device time per call
     under torch.profiler, and K13's rounds captured in a CUDA graph and
     replayed bit-equal;
  4. path 1, tracking only: System(SystemConfig(), enable_local_mapping=
     False, enable_loop_closing=False) tracks 96 frames of the 640x480
     synthetic room, quantized to uint8 gray / uint16 depth; ATE against
     ground truth, 0 lost frames;
  5. path 2, local mapping: System(SystemConfig(), enable_loop_closing=
     False) on the same frames; ATE, 0 lost, a mapping step per keyframe
     after the first; then line_triangulation_parity: K42 (the mapping
     step's line triangulation) bit-equal to its plain version on path
     2's captured mapping steps and LINE_TRI_PLANTED problems (no free
     line, ties, NaN descriptors, nb_ok False, a ray parallel to its
     plane, parallaxes at the 0.998 edge), into outputs filled with NaN,
     at B = 1 and 4 lane by lane; then chunk_parity: from path 2's
     carried state and window at its 40th step, the eager chunk
     (fused_track_chunk_packed, C = 8) bit-equal to 8 chained streaming
     steps and free of host syncs (set_sync_debug_mode("error")), a
     CapturedChunk's replays over two rounds of its ring bit-equal to the
     eager chain with every slot kept until its next replay, a replay's
     launches (chunk_launches), K37's shared-window mode against its
     plain version and the repeated window; then path 8, the default
     System in chunked mode (chunk_size 8, chunk_pipeline_depth 2, as
     bench.py's first CHUNK_SWEEP entry) on path 2's 96 frames: ATE, 0
     lost, a mapping step per keyframe, one replay a chunk, ms per call
     and frames/s beside the same System and frames in streaming mode
     (chunk_size 1); and path 8b, its first 45 frames (a partial chunk
     of 4 at the flush);
  6. path 3, relocalization: the same System with a keyframe every 4
     frames tracks until the map holds more than 5 keyframes, loses
     tracking on noise frames, relocalizes on a revisited frame (Horn
     branch), then loses again and revisits a frame without depth (PnP
     branch); then path 6, the public entry points no path of the System
     calls: horn_ransac_sim3 on a planted similarity and match_lines on
     path 1's consecutive frames; then path 7, the monocular two-view
     initializer (initialize_two_view, on no path of the System) on
     TWO_VIEW_PLANTED (the JAX test's problem, N = 1000 with noise and
     outliers, N = 8 and 9, a planar scene, no valid flag) and on the
     matches of the room's frames 0 and 8 at 640x480; then
     two_view_parity: K48 (the F and H hypotheses, a warp's Jacobi solve
     each) against its plain version on every problem of path 7 (models
     up to sign 1e-5 on well-posed distinct picks, scores within the
     summation bound of the plain scoring of its models, other picks a
     score range), K49 (the selection) bit-equal, K50 (the DLT of given
     projections, and its gates mode) on the four candidates, each at B =
     1 and K48 and K49 at B = 4 lane by lane, with their device ms;
  7. path 4a, loop closing: the default System(cfg) (loop closing on, with
     loop.min_kf_gap=3 and loop.consistency_threshold=2) over the 96-frame
     640x480 loop sequence; ATE, 0 lost, loops closed, and K3 and K6
     launched inside every loop verification;
  8. path 4b, a constructed loop: a map tracked over the room's first 48
     frames gets a copy of keyframe 0 with a drifted pose and cloned
     landmarks; verification (K3, K6, K32), the pose graph (K10), the fuse
     and global BA (K8, K9, K33-K35) must pull the drift back and merge the
     clones; then the loop kernels' parity (loop_kernel_parity): K32-K35
     against their plain versions on the inputs path 4b's correction gave
     them (its two loop-edge refinements, one LM step of its first global
     BA solve), two launches equal bits; then schur_pose_graph_parity:
     K40 (the Schur complement over shared landmarks) against the dense
     product on that LM step, path 4c's dense orbit, SCHUR_PLANTED
     problems and four lanes at B = 4, each entry within 2 (n - 1) 2^-24
     of the sum of its |terms|, blocks of pairs sharing no landmark
     exactly 0, the same Cholesky info; K10 with the gauge diagonal and
     K41 (the pose update) along path 4b's 10 Gauss-Newton steps, K10 on
     the 96-keyframe graph, K41 on UPDATE_PLANTED steps and at B = 4;
  9. path 4c, BA at scale: ba_solve on a 96-keyframe perturbed orbit and
     ba_solve_pcg on a 256-keyframe one, to the convergence limits of
     tests/test_ba_full.py, and ba_solve_pcg on a 512-keyframe one
     (MAX_GBA_KF_PCG; finite, reported), each PCG solve with one K43 a
     LM step and K44's and K45's launches of pcg_launches; then
     pcg_parity: K43-K45 (the PCG system, S p and the back-substitution,
     the CG update) against their plain versions on the line-and-plane
     recipe and the 256- and 512-keyframe orbits at their first LM step
     and on four recipes at B = 4 lane by lane, and ba_solve_pcg through
     them against the same solve through the plain versions on the card
     (poses within 1e-4 after one LM step, the cost within 1% after a
     full solve);
 10. path 5, batched replay: BatchedSLAM(SystemConfig(), B) at B = 4 and 8
     over 48 quantized frames per lane (bench.py::_run_batched's
     sequences); every lane's ATE, 0 lost, the fused lane frames, and per
     batched step every step kernel launched as often as in one streaming
     step whatever B; lane b of one B = 4 step bit-equal to the B = 1 step
     on its inputs; make_batched_frame_step once at B = 8;
 11. host-to-device copies: a tracking-only System warms up, then 32 tracked
     frames run under one torch.profiler session, each in a span of its
     own, and their "Memcpy HtoD" events are counted per span: one per
     frame (the packed sensor frame), one per refresh of the local-map
     window and one per keyframe's packed fuse set, no constant among
     them, every frame held; then 4 chunks of a chunked tracking-only
     System, one upload a chunk plus one per window refresh and fuse set;
     then 24 batched steps of four tracking-only lanes: two per step (the stacked frames, the small
     parameters) plus one per lane window upload.
Each path runs with the launch counts set to 0 just before it and read just
after; every kernel must have launched on the paths, and on every path K11
must have launched once per pose_optimize call, K12 and K14 once and K13
1 + refine_rounds times per extract_planes call, K15 once per
track_manhattan_frame call, and per extract_point_features call K1, K2 and
K16 and K19 once and K18 twice (K16 and K18 as their C entries report),
with one K17 launch per
extract_point_features and per extract_line_features call, and per
extract_line_features call K20's eight launches (one C call), one K21 and one
K22, and per search_lines_by_projection call over M map lines one K23
launch up to M = 256 (tracking's window) and two above (local mapping's
line fuse over 4096), one K24 per search_by_projection call, one
K3 per search_by_projection and per match_descriptors call (both
directions in one launch), one K25 per
either call, one K26 per tracking step and per rotation_histogram_filter
call and two K27 per tracking step (inside each tracking step K24 2, K3
3, K25 3, K26 1, K27 2, K30 1, K31 1, K11 2, K15 1, K36 1, whatever the
step's batch of lanes), one K37 per tracking step, one K38 per
_state_from call, one K39 per initialization, inside each fuse set one
K24, K3 and K25 and inside each mapping step one K24, two K3, two K25,
one K5 and one K42 (whatever the targets), one K28 and one K29 per
extract_frame
call, one K32 per refine_relative_se3 call, per LM step of
ba_solve and ba_solve_pcg one K33 launch (the mu_p pass) and one more
with plane tables and one K34, per dense step one K35 and one K40 (none
in the PCG solve), per PCG step one K43, K45's init, per CG step K44's
two launches and one K45, and K44's back-substitution, one K34 per solve
(its tables mode), per pose graph one K10 and one K41 per Gauss-Newton
step (10); no plain decode, line triangulation, PCG, line,
matching, noise, normal, plane association, step-tail, prelude, lift,
seed, plane, Manhattan, pose, refinement, plane-block, cost-test,
reduced-system, Schur-complement or pose-graph function may see a tensor
on the card; on paths 3, 4a, 4b and 6 each PnP RANSAC makes one upload,
one K7 and one K46 launch and one pull, each Horn RANSAC one upload, two
K6 launches and one pull, on path 7 each initialize_two_view one upload,
one K48 and one K49 launch and one pull, then, past its inlier count, one
upload, one K50 launch and one pull, and no PyTorch function but a
metadata read touches a card tensor between an upload and its pull. The
line before the last is a JSON object with one entry per kernel (its time
and its plain version's, the least time the card could take for the same
bytes and operations, and a PyTorch call's time where one computes the
same function); the last line is the device JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ATE_LIMIT_M = 0.010
TIMING_REPS = 25
# what a kernel row's "ms" is
MS_SOURCE = ("chip_smoke.py::_time_ms: CUDA events around one wrapper "
             "call, median of 25 calls after 3")
TRACKING_FRAMES = 96  # path 1 (tracking alone)
LOOP_FRAMES = 96      # path 4a
CONSTRUCTED_FRAMES = 48  # path 4b, the first frames of a sequence of
CONSTRUCTED_SEQUENCE = 96  # frames (the trajectory spans them all)
# one NVIDIA H100 SXM at its 700 W limit (NVIDIA data sheet): HBM
# bytes/s, float32 operations/s outside the tensor cores (the rate used for
# a kernel's operations, integer work included), and float64 operations/s
# outside the tensor cores (half the float32 rate; the rate of the kernels
# whose solves run in float64: K5-K7)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12


# Operation counts of the small dense solves inside K5, K7, K48 and K50,
# fixed by each function's shapes and not by the algorithm a kernel runs:
# Golub and Van Loan, Matrix Computations (4th ed.), Householder QR
# (section 5.2.2) and the Golub-Reinsch SVD's table (section 8.6.3).
def null_vector_ops(rows: int, cols: int) -> float:
    """A null vector of a rows x cols system, rows < cols: the Householder
    QR of its transpose, 2 m n^2 - 2 n^3 / 3 with m = cols, n = rows, and
    the last column of Q, the n reflectors applied to e_m (4 (m - k) each)."""
    m, n = cols, rows
    return 2.0 * m * n * n - 2.0 * n ** 3 / 3 + sum(4.0 * (m - k)
                                                    for k in range(n))


def svd_ops(m: int, n: int, with_u: bool) -> float:
    """The SVD of an m x n matrix, m >= n: Sigma and V 4 m n^2 + 8 n^3;
    with U as well 4 m^2 n + 8 m n^2 + 9 n^3."""
    if with_u:
        return 4.0 * m * m * n + 8.0 * m * n * n + 9.0 * n ** 3
    return 4.0 * m * n * n + 8.0 * n ** 3


# a two-view DLT pair (K5, K50): its 4 x 4 system (4 rows of 4 products
# and differences), the smallest right singular vector, X = Xh[:3] / w
DLT_PAIR_OPS = 32 + svd_ops(4, 4, False) + 4
# a pair's two reprojection gates in float32 (K5): per view the camera
# coordinate (18), the projection (7), chi2 (6) and the two tests
GATE_PAIR_OPS = 2 * 33


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


def _nbytes(*objs) -> int:
    """Bytes of the tensors in objs (tuples and named tuples walked)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += _nbytes(*o)
    return total


def _bound(n_bytes: float, n_ops: float,
           ops_per_s: float = FP32_OPS_PER_S, n_ops_fp64: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over their peak rate (float32 unless
    given). A kernel that mixes types gives its float64 operations apart as
    n_ops_fp64; their time at FP64_OPS_PER_S adds to that of n_ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / ops_per_s + n_ops_fp64 / FP64_OPS_PER_S) * 1e3
    row = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": int(n_bytes), "operations": float(n_ops + n_ops_fp64),
           "ops_per_s": ops_per_s}
    if n_ops_fp64:
        row["operations_fp64"] = float(n_ops_fp64)
    return row


def _launch_split(fn, reps: int = TIMING_REPS, match: str = "") -> dict:
    """Device ms per call of fn by kernel name (the kernels whose name
    holds `match`), from torch.profiler over `reps` calls after a warm-up:
    {name: {"ms": ..., "calls": ...}}, "calls" the launches the profiler
    saw per call of fn, "ms" the mean launch's time times their rounded
    number (the profiler may miss the first call's launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        key = e.key.replace("(anonymous namespace)::", "")
        name = key.split("(")[0].split("::")[-1].removeprefix("void ")
        if match in name and us > 0 and "Memcpy" not in name:
            per_call = max(1, round(e.count / reps))
            split[name] = {"ms": us / e.count * per_call / 1e3,
                           "calls": e.count / reps}
    return split


PTXAS_SOURCES = ("pose_opt.cu", "lines.cu", "hamming_top2.cu",
                 "plane_segment.cu", "manhattan.cu", "depth_normals.cu",
                 "fast_score.cu", "line_lift_search.cu", "pyramid.cu",
                 "select_keypoints.cu", "matching.cu")


def _kernel_name(mangled: str) -> str:
    """The kernel's name in a mangled symbol (its length-prefixed
    identifier ending in _kernel), with a bool or int template
    argument."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):  # a hash may run into the length
            n = int(mangled[i:m.end()])
            name = mangled[m.end():m.end() + n]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                          name):
                arg = re.match(r"ILb([01])E", mangled[m.end() + n:])
                if arg:
                    return f"{name}<{arg.group(1) == '1'}>"
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + n:])
                return f"{name}<{arg.group(1)}>" if arg else name
    return mangled


def start_ptxas_report(kernels):
    """Compile each source of PTXAS_SOURCES as the build does, with
    ptxas's -v report, in processes started now (the objects go to a
    temporary directory of the build's): (directory, [(source, process)])
    for ptxas_summary."""
    import tempfile

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    procs = []
    for src in PTXAS_SOURCES:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS,
               *kernels.SOURCE_FLAGS.get(src, ()), "-I", kernels.CSRC,
               "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, f"{src}.o"),
               os.path.join(kernels.CSRC, src)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
    return tmp, procs


def ptxas_summary(started) -> dict:
    """Registers, spills and stack frame of each kernel of PTXAS_SOURCES
    from the reports of start_ptxas_report: {source: {kernel: {...}}}."""
    import re
    import shutil

    tmp, procs = started
    reports = {}
    for src, proc in procs:
        _, err = proc.communicate()
        _check(proc.returncode == 0, f"nvcc -Xptxas -v failed on {src}: "
               f"{err}")
        reports[src] = err
    shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for src, text in reports.items():
        per, name = {}, None
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = _kernel_name(m.group(1))
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and name:
                per.setdefault(name, {}).update(
                    stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                    spill_loads=int(m.group(3)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                per.setdefault(name, {})["registers"] = int(m.group(1))
                name = None
        out[src] = per
    return out


def _print_kernels(out: list) -> None:
    for k in out:
        print(f"kernel {k['name']}: max_abs_err={k['max_abs_err']} "
              f"(tolerance {k.pop('tolerance')}) ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} "
              f"({k['bound_by']})", flush=True)


# K1's operations per pixel for its bound: per polarity the 64 min (or
# max) of the doubled arcs and 15 for the best start, two subtractions of
# the centre and the two max of the score
FAST_OPS_PER_PIXEL = 2 * (64 + 15) + 2 + 2
# K1's planted levels: (h, w) shapes narrower or shorter than the 7-pixel
# ring (the clamps reach across the level) among larger ones
PLANTED_FAST_SHAPES = ((37, 70), (6, 23), (19, 5), (3, 3), (1, 9), (7, 1),
                       (65, 129), (2, 2))
PLANTED_FAST_CASES = ("noise", "flat")
# K17's planted levels: (h, w) shapes 1-6 pixels wide or tall (narrower or
# shorter than the 7-tap halo: the clamps reach across the level), widths
# that are no multiple of 4 (so odd level offsets), a level wider than one
# strip and levels taller than one band; and the (ksize, sigma) pairs
PLANTED_BLUR_SHAPES = ((1, 1), (1, 6), (5, 1), (2, 3), (6, 5), (4, 37),
                       (33, 2), (3, 129), (67, 61), (130, 59))
PLANTED_BLUR_TAPS = ((1, 1.0), (3, 0.8), (5, 1.0), (7, 2.0))
# K18's planted levels (border 2, min_score 7): "wide_tile", a 16-pixel
# tile wider than its 12-pixel level (k_tile 3); "dry_sort", k_tile 12 (the
# sort branch) over tiles with fewer maxima than that; "all_below", no
# score above min_score (every candidate -1); "tie_at_cut", one isolated
# maximum per tile, 3 of 60 and 13 of 50, so that the quota of 8 cuts
# inside the tie across tiles
PLANTED_SELECT = dict(
    names=("wide_tile", "dry_sort", "all_below", "tie_at_cut"),
    shapes=[(21, 12), (40, 40), (30, 50), (64, 64)],
    quotas=[3, 150, 20, 8], tiles=[16, 8, 10, 16], scales=[1.0] * 4,
    border=2, min_score=7.0)


def planted_blur_levels(seed: int = 17, batch: int = 1):
    """K17's planted levels (PLANTED_BLUR_SHAPES) as one (batch, n_pixels)
    float32 buffer of uniform values in [0, 255) and its level table."""
    from planarslam_tpu_torch.ops import levels

    n = len(PLANTED_BLUR_SHAPES)
    table = levels.table_from_levels(PLANTED_BLUR_SHAPES, [0] * n, [8] * n,
                                     [1.0] * n)
    rng = np.random.default_rng(seed)
    buf = rng.uniform(0.0, 255.0, (batch, table.n_pixels)).astype(np.float32)
    return table, buf


def planted_select_levels(seed: int = 18, batch: int = 1):
    """K18's planted levels (PLANTED_SELECT) as one (batch, n_pixels)
    float32 score buffer and its level table; each lane draws its own
    peaks."""
    from planarslam_tpu_torch.ops import levels

    ps = PLANTED_SELECT
    table = levels.table_from_levels(ps["shapes"], ps["quotas"], ps["tiles"],
                                     ps["scales"])
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(batch):
        maps = []
        for name, (h, w), tile in zip(ps["names"], ps["shapes"],
                                      ps["tiles"]):
            if name == "all_below":
                s = rng.uniform(0.0, ps["min_score"], (h, w)).astype(
                    np.float32)
            elif name == "tie_at_cut":
                s = np.zeros((h, w), np.float32)
                for t in range(16):
                    y = (t // 4) * tile + int(rng.integers(3, tile - 3))
                    x = (t % 4) * tile + int(rng.integers(3, tile - 3))
                    s[y, x] = 60.0 if t in (2, 7, 13) else 50.0
            else:
                s = planted_scores(rng, h, w, tile, 4 * tile, ps["border"])
            maps.append(s.reshape(-1))
        lanes.append(np.concatenate(maps))
    return table, np.stack(lanes)


def planted_fast_levels(case: str, seed: int = 1):
    """K1's planted levels (PLANTED_FAST_SHAPES) as one (1, n_pixels)
    float32 buffer and its level table: "noise", integer grey levels
    0-255 with a bright and a dark 3x3 blob on each level large enough,
    "flat", every pixel 7 (every score 0)."""
    from planarslam_tpu_torch.ops import levels

    n = len(PLANTED_FAST_SHAPES)
    table = levels.table_from_levels(PLANTED_FAST_SHAPES, [0] * n, [8] * n,
                                     [1.0] * n)
    rng = np.random.default_rng(seed)
    maps = []
    for h, w in PLANTED_FAST_SHAPES:
        if case == "flat":
            img = np.full((h, w), 7.0, np.float32)
        else:
            img = rng.integers(0, 256, (h, w)).astype(np.float32)
            if h >= 12 and w >= 12:
                img[3:6, 3:6] = 255.0
                img[h - 6:h - 3, w - 6:w - 3] = 0.0
        maps.append(img.reshape(-1))
    return table, np.concatenate(maps)[None]


def kernel_parity(seq, cfg, dev) -> list:
    """K1-K4 against their plain versions on the card."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import fast, image, orb, planes
    from planarslam_tpu_torch.ops import matching
    from planarslam_tpu_torch.ops.frontend import EDGE_BORDER, orb_level_table

    out = []
    g8, d16 = quantize_frame(*seq.render(0), cfg.camera.depth_map_factor)
    gray = torch.from_numpy(g8.astype(np.float32)).to(dev)
    depth = torch.from_numpy(
        d16.astype(np.float32) / np.float32(cfg.camera.depth_map_factor)
    ).to(dev)
    levels = image.build_pyramid(gray, cfg.orb.n_levels, cfg.orb.scale_factor)
    blurs = [image.blur(l, ksize=7, sigma=2.0) for l in levels]

    # the same levels as the one buffer the main path keeps them in
    table = orb_level_table(*gray.shape, cfg.orb)
    quotas, tiles = table.column("quota"), table.column("tile")
    buf = torch.cat([l.reshape(-1) for l in levels])[None].contiguous()
    blur_buf = torch.cat([b.reshape(-1) for b in blurs])[None].contiguous()

    # K1: FAST score over all pyramid levels (exact: min/max/sub only), one
    # launch per level and the main path's one launch for all levels, then
    # the planted levels (narrower or shorter than the ring, noise and
    # flat)
    scores = [fast.fast_score(l) for l in levels]
    err = max(float((sk - fast.fast_score_plain(l)).abs().max())
              for sk, l in zip(scores, levels))
    _check(err == 0.0, f"fast_score differs from plain by {err}")
    all_scores = fast.fast_score_levels(buf, table)
    _check(torch.equal(all_scores[0],
                       torch.cat([sk.reshape(-1) for sk in scores]))
           and torch.equal(all_scores, fast.fast_score_levels(buf, table)),
           "fast_score_levels differs from the per-level launches or from "
           "its own second launch")
    planted = {}
    for case in PLANTED_FAST_CASES:
        p_table, p_buf = planted_fast_levels(case)
        p_buf = torch.from_numpy(p_buf).to(dev)
        got = fast.fast_score_levels(p_buf, p_table)
        want = fast.fast_score_levels_plain(p_buf, p_table)
        torch.cuda.synchronize()
        _check(torch.equal(got, want), f"fast_score ({case}): "
               f"{int((got != want).sum())} planted scores differ from plain")
        planted[case] = {"levels": [list(s) for s in p_table.shapes],
                         "nonzero": int((got != 0).sum())}
    _check(planted["flat"]["nonzero"] == 0
           and planted["noise"]["nonzero"] > 0
           and min(min(s) for s in planted["noise"]["levels"]) < 7,
           f"fast_score: the planted levels do not exercise it: {planted}")
    n_px = sum(l.numel() for l in levels)
    out.append({"name": "fast_score", "route": "cuda", "library_ms": None,
                **_bound(_nbytes(levels, scores), FAST_OPS_PER_PIXEL * n_px),
                "source": "planarslam_tpu_torch/csrc/fast_score.cu",
                "replaces": "planarslam_tpu/ops/fast.py:41",
                "max_abs_err": err, "tolerance": 0.0, "planted": planted,
                "ms": _time_ms(lambda: fast.fast_score_levels(buf, table)),
                "per_level_ms": _time_ms(
                    lambda: [fast.fast_score(l) for l in levels]),
                "plain_ms": _time_ms(
                    lambda: [fast.fast_score_plain(l) for l in levels])})

    # K2: orientation + steered BRIEF at each level's selected keypoints
    kps = []
    for l, img_l in enumerate(levels):
        uv, _, valid = fast.select_keypoints(
            fast.fast_score_plain(img_l), tile=int(tiles[l]),
            k_total=int(quotas[l]),
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
    k2_out = [orb.orb_describe(*k) for k in kps]
    _check(bits_bad <= 0.01 * n_valid,
           f"orb_describe: {bits_bad}/{n_valid} descriptors differ (> 1%)")
    # the main path's one launch for all levels, into the 1024-slot outputs
    cap = cfg.orb.max_keypoints
    uv_all = torch.cat([k[2] for k in kps])[None].contiguous()
    valid_all = torch.cat([k[3] for k in kps])[None].contiguous()
    k2_args = (buf, blur_buf, uv_all, valid_all, table, cap)
    a_all, d_all = orb.orb_describe_levels(*k2_args)
    n_all = uv_all.shape[1]
    _check(torch.equal(a_all[0, :n_all], torch.cat([a for a, _ in k2_out]))
           and torch.equal(d_all[0, :n_all], torch.cat([d for _, d in k2_out]))
           and not bool(a_all[0, n_all:].any())
           and not bool(d_all[0, n_all:].any()),
           "orb_describe_levels differs from the per-level launches")
    out.append({"name": "orb_describe", "route": "cuda", "library_ms": None,
                # per keypoint: the 31 x 31 intensity moments, 256 rotated
                # pair comparisons
                **_bound(_nbytes(kps, k2_out), 5000 * n_valid),
                "source": "planarslam_tpu_torch/csrc/orb_describe.cu",
                "replaces": "planarslam_tpu/ops/orb.py:57",
                "max_abs_err": ang_err, "tolerance": 1e-4,
                "desc_mismatch": bits_bad, "n_keypoints": n_valid,
                "ms": _time_ms(lambda: orb.orb_describe_levels(*k2_args)),
                "per_level_ms": _time_ms(
                    lambda: [orb.orb_describe(*k) for k in kps]),
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
    k3_cases = hamming_edge_cases(cfg, dev)
    print(f"gated_hamming_top2 edge cases: {json.dumps(k3_cases)}",
          flush=True)
    out.append({"name": "gated_hamming_top2", "route": "cuda",
                "library_ms": None, "edge_cases": k3_cases,
                # per pair: 8 xor + 8 popcount + 8 adds, the window gate
                **_bound(_nbytes(a_desc, b_desc, a_ok, b_ok, gate, k3),
                         34.0 * M * N),
                "source": "planarslam_tpu_torch/csrc/hamming_top2.cu",
                "replaces": "planarslam_tpu/ops/matching.py:169",
                "max_abs_err": float(err), "tolerance": 0.0,
                "step_timing": {
                    k: kernel_timing_entry(fn, "hamming_top2")
                    for k, fn in hamming_step_problems(seq, cfg,
                                                       dev).items()},
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
                "library_ms": None,
                # per pixel: back-projection, noise gate, 1 + 3 + 6 sums
                **_bound(_nbytes(depth, alpha, k4), 40 * depth.numel()),
                "source": "planarslam_tpu_torch/csrc/plane_moments_triton.py",
                "replaces": "planarslam_tpu/ops/planes.py:223",
                "max_abs_err": err, "tolerance": 1e-5 * scale,
                "ms": _time_ms(lambda: planes.plane_block_moments(*args)),
                "plain_ms": _time_ms(
                    lambda: planes.plane_block_moments_plain(*args))})
    _print_kernels(out)
    return out


def _k3_problem(rng, B: int, M: int, N: int, dev, gated: bool = True):
    """A K3 problem of B lanes: random descriptors, each column a copy of a
    random row with 5% of its bits flipped, pixels near that row's, the
    planted gates of kernel_parity's window search. Returns (a_desc,
    b_desc, a_ok, b_ok, gate or None), every tensor with the leading B."""
    import torch

    from planarslam_tpu_torch.ops import matching

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    a = rng.integers(-2 ** 31, 2 ** 31, (B, M, 8)).astype(np.int64)
    src = rng.integers(0, M, (B, N))
    flips = rng.random((B, N, 8, 32)) < 0.05
    words = (flips * (1 << np.arange(32, dtype=np.int64))).sum(-1)
    bd = np.take_along_axis(a, src[..., None], 1) ^ words
    a_uv = rng.uniform(0, [640, 480], (B, M, 2))
    lvl = rng.integers(0, 8, (B, M))
    b_uv = np.take_along_axis(a_uv, src[..., None], 1) + rng.normal(
        0, 2.0, (B, N, 2))
    gate = matching.ProjGate(
        a_uv=t(a_uv, np.float32), a_r=t(4.0 * 1.2 ** lvl, np.float32),
        a_level=t(lvl, np.int32),
        a_ur_pred=t(a_uv[..., 0] - 20.0, np.float32),
        b_uv=t(b_uv, np.float32),
        b_level=t(np.take_along_axis(lvl, src, 1), np.int32),
        b_ur=t(np.where(rng.random((B, N)) < 0.7, b_uv[..., 0] - 20.0, -1.0),
               np.float32), level_window=1) if gated else None
    return (t(a.astype(np.uint32).view(np.int32)),
            t(bd.astype(np.uint32).view(np.int32)),
            t(rng.random((B, M)) < 0.9), t(rng.random((B, N)) < 0.95),
            gate)


def hamming_edge_cases(cfg, dev) -> dict:
    """K3 on planted edge cases, every output bit-equal to its plain
    version lane by lane and two launches equal: every row dead; a row
    with one gated-in column; N = 1; exact duplicates of the best column
    in two column tiles (one before and one after the tile edge); N larger
    than one tile, gated and not; windows of up to 70 pixels, pixels off
    the image and NaN; B = 8 at the window search's shapes; and both
    directions of a mutual match in one launch (match_descriptors'
    problem, and N > M). Returns what each case exercised."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import matching

    rng = np.random.default_rng(33)
    res = {}

    def lane(x, b):
        return None if x is None else (
            matching.ProjGate(*[y[b] for y in x[:-1]], x.level_window)
            if isinstance(x, matching.ProjGate) else x[b])

    def held(name, prob):
        a, bd, ao, bo, gate = prob
        n0 = kernels.LAUNCHES["gated_hamming_top2"]
        got = matching.gated_hamming_top2(a, bd, ao, bo, gate)
        again = matching.gated_hamming_top2(a, bd, ao, bo, gate)
        torch.cuda.synchronize()
        _check(kernels.LAUNCHES["gated_hamming_top2"] == n0 + 2,
               f"gated_hamming_top2 ({name}): not one launch per call")
        _check(all(torch.equal(x, y) for x, y in zip(got, again)),
               f"gated_hamming_top2 ({name}): two launches differ")
        for b in range(a.shape[0]):
            want = matching.gated_hamming_top2_plain(
                *[lane(x, b) for x in prob])
            _check(all(torch.equal(x[b], y) for x, y in zip(got, want)),
                   f"gated_hamming_top2 ({name}): lane {b} differs from "
                   f"its plain version")
        res[name] = {"B": int(a.shape[0]), "M": int(a.shape[1]),
                     "N": int(bd.shape[1]), "gated": gate is not None,
                     "live_rows": int(ao.sum()),
                     "matched": int((got[0] < matching.INF_DIST).sum()),
                     "ties_at_best": int(((got[0] == got[1])
                                          & (got[0] < matching.INF_DIST))
                                         .sum())}
        return got

    N = cfg.orb.max_keypoints
    dead = list(_k3_problem(rng, 1, 256, N, dev))
    dead[2] = torch.zeros_like(dead[2])
    got = held("all_rows_dead", dead)
    _check(bool((got[0] == matching.INF_DIST).all()
                & (got[1] == matching.INF_DIST).all()
                & (got[2] == 0).all()),
           "gated_hamming_top2: a dead row must give (10000, 10000, 0)")
    one = list(_k3_problem(rng, 1, 64, N, dev))
    g = one[4]
    uv, lvl, urp = g.a_uv.clone(), g.a_level.clone(), g.a_ur_pred.clone()
    uv[0, 0] = g.b_uv[0, 17]  # row 0 sits on column 17 alone
    lvl[0, 0] = g.b_level[0, 17]
    urp[0, 0] = g.b_uv[0, 17, 0] - 20.0
    one[4] = g._replace(a_uv=uv, a_level=lvl, a_ur_pred=urp,
                        a_r=torch.full_like(g.a_r, 1e-3))
    one[2][0, 0], one[3][0, 17] = True, True
    got = held("one_gated_in_column", one)
    _check(int(got[2][0, 0]) == 17 and int(got[1][0, 0])
           == matching.INF_DIST, "gated_hamming_top2: the one gated-in "
           "column is not row 0's best with nothing second")
    held("n_1", _k3_problem(rng, 1, 300, 1, dev))
    held("n_1_ungated", _k3_problem(rng, 1, 300, 1, dev, gated=False))
    tie = list(_k3_problem(rng, 1, 48, 2500, dev, gated=False))
    bd = tie[1].clone()
    bd[0, 1500] = bd[0, 5] = tie[0][0, 3]  # row 3's exact copy, twice
    tie[1] = bd
    tie[2][0, 3], tie[3][0, 5], tie[3][0, 1500] = True, True, True
    got = held("duplicate_best_across_tiles", tie)
    _check(int(got[0][0, 3]) == 0 and int(got[1][0, 3]) == 0
           and int(got[2][0, 3]) == 5, "gated_hamming_top2: the tied "
           "best must keep the lower column and give second == best")
    held("n_above_tile_gated", _k3_problem(rng, 1, 700, 2500, dev))
    # rows on 32-pixel grid lines, radii of 1-70 pixels, columns off the
    # image and a NaN pixel on either side
    wide = list(_k3_problem(rng, 1, 600, N, dev))
    g = wide[4]
    uv, bv = g.a_uv.clone(), g.b_uv.clone()
    edge = rng.integers(0, 20, (64, 2)) * 32 + rng.choice([-0.5, 0.0, 0.5],
                                                         (64, 2))
    uv[0, :64] = torch.from_numpy(edge.astype(np.float32)).to(dev)
    uv[0, 70, 1] = float("nan")
    bv[0, :20] = torch.from_numpy(rng.uniform(-100, 1200, (20, 2)).astype(
        np.float32)).to(dev)
    bv[0, 20, 0] = float("nan")
    wide[4] = g._replace(a_uv=uv, b_uv=bv, a_r=torch.from_numpy(
        rng.uniform(1.0, 70.0, (1, 600)).astype(np.float32)).to(dev))
    held("wide_windows", wide)
    held("b8_window", _k3_problem(rng, 8, MATCH_WINDOW, N, dev))

    # both directions in one launch, against the two plain problems
    for name, (m, n) in (("mutual", (N, N)), ("mutual_n_above_m",
                                               (300, 1700))):
        a, bd, ao, bo, _ = _k3_problem(rng, 2, m, n, dev, gated=False)
        n0 = kernels.LAUNCHES["gated_hamming_top2"]
        got = matching.mutual_hamming_top2(a, bd, ao, bo)
        again = matching.mutual_hamming_top2(a, bd, ao, bo)
        torch.cuda.synchronize()
        _check(kernels.LAUNCHES["gated_hamming_top2"] == n0 + 2,
               f"mutual_hamming_top2 ({name}): not one launch per call")
        _check(all(torch.equal(x, y) for x, y in zip(got, again)),
               f"mutual_hamming_top2 ({name}): two launches differ")
        for b in range(2):
            fwd = matching.gated_hamming_top2_plain(a[b], bd[b], ao[b], bo[b])
            back = matching.gated_hamming_top2_plain(bd[b], a[b], bo[b],
                                                     ao[b])[2]
            _check(all(torch.equal(x[b], y) for x, y in
                       zip(got, (*fwd, back))),
                   f"mutual_hamming_top2 ({name}): lane {b} differs from "
                   f"its plain version")
        res[name] = {"B": 2, "M": m, "N": n,
                     "mutual_pairs": int((got[3].gather(
                         1, got[2].long()) == torch.arange(
                             m, device=dev)[None]).sum())}
    return res


def planted_scores(rng, h: int, w: int, tile: int, n_peaks: int,
                   border: int) -> np.ndarray:
    """A score map (numpy) with ties inside and across tiles, empty tiles,
    maxima on the border gate and in the last partial tile: isolated peaks
    and 2-pixel plateaus with values from a small set, in one tile of three
    only, so that a level cannot fill its quota."""
    s = np.zeros((h, w), np.float32)
    ys = rng.integers(0, h, n_peaks)
    xs = rng.integers(0, w, n_peaks)
    vals = rng.choice(np.array([6.0, 8.0, 8.0, 9.5, 12.0], np.float32),
                      n_peaks)
    for y, x, v in zip(ys, xs, vals):
        if ((y // tile) * 7 + x // tile) % 3 != 0:
            continue  # an empty tile
        s[y, x] = v
        if x + 1 < w and v == 8.0:
            s[y, x + 1] = v  # a plateau: both pixels pass the NMS
    # maxima exactly on the first and last rows and columns the gate admits
    s[border, border:w - border:29] = 9.5
    s[h - border - 1, border:w - border:31] = 9.5
    s[border:h - border:23, w - border - 1] = 12.0
    return s


def planted_top_e_maps(h: int, w: int, E: int, seed: int = 7) -> dict:
    """Planted (h, w) float32 score maps for K20's top-E selection (numpy):
    "tie_2000", 9000 nonzero scores, 2000 of them equal to 80 (below the
    E-th rank at E = 6144: none of them is taken);
    "fewer_than_E", 3000 nonzero (the rest of the E are the first zero
    pixels in pixel order); "all_zero"; "tie_across_bands", distinct
    scores above 80 away from the top rows and 12 full rows of 80 from
    row 2 on, of which the first 7.5 rows' worth are taken, so that the
    taken ties span the selection's 4-row bands and the cut falls inside
    one. The first two draw from one generator in this order (the planted
    maps of tests/test_torch_line_kernels.py)."""
    rng = np.random.default_rng(seed)
    n = h * w
    f32 = np.float32
    maps = {}
    for name, n_nonzero, n_tie in (("tie_2000", 9000, 2000),
                                   ("fewer_than_E", 3000, 0)):
        score = np.zeros(n, f32)
        pix = rng.choice(n, n_nonzero, replace=False)
        vals = rng.uniform(41.0, 500.0, n_nonzero).astype(f32)
        vals[:n_tie] = f32(80.0)
        vals[n_tie:] = np.where(vals[n_tie:] == 80.0, 81.0, vals[n_tie:])
        score[pix] = vals
        maps[name] = score.reshape(h, w)
    maps["all_zero"] = np.zeros((h, w), f32)
    taken = int(7.5 * w)
    above, below = E - taken, 3000
    free = np.arange(16 * w, n)
    assert above > 0 and len(free) >= above + below, (h, w, E)
    pick = rng.choice(free, above + below, replace=False)
    score = np.zeros(n, f32)
    score[2 * w:14 * w] = f32(80.0)
    score[pick[:above]] = rng.uniform(81.0, 500.0, above).astype(f32)
    score[pick[above:]] = rng.uniform(41.0, 79.0, below).astype(f32)
    maps["tie_across_bands"] = score.reshape(h, w)
    return maps


# a three-level geometry for K18 whose levels keep 15, 2 and 1 candidates
# per tile: the sort branch and the arg-max branch in one launch
PLANTED_LEVELS = dict(shapes=[(120, 160), (100, 133), (83, 111)],
                      quotas=[600, 80, 40], tiles=[16, 13, 11],
                      scales=[1.0, 1.2, 1.44])
PLANTED_PEAKS = [24000, 250, 100]  # planted per level: no quota fills


def planted_levels_map(planted) -> np.ndarray:
    """The (n_pixels,) planted score map of PLANTED_LEVELS (border 5)."""
    rng = np.random.default_rng(18)
    return np.concatenate([
        planted_scores(rng, h, w, t, n, 5).reshape(-1)
        for (h, w), t, n in zip(planted.shapes, PLANTED_LEVELS["tiles"],
                                PLANTED_PEAKS)])
# K16 against the plain pyramid's two float32 products: grey levels. Both
# add the same 2-3 products per output; the product's summation order and
# its use of fused multiply-adds are the library's, so only a few float32
# ulps of 255 (1.5e-5 each) are expected, and 1e-3 is the limit the CPU
# test holds the plain pyramid to against JAX.
PYRAMID_TOLERANCE = 1e-3
# K16's frames besides the path's: the room rendered at 1280x960 and at
# 64x48 (its top levels narrower than one 32-pixel tile)
PYRAMID_FRAMES = {"wide": (960, 1280), "small": (48, 64)}
PYRAMID_MIN_KEYPOINTS = 100  # the keypoint share is held above this many


def pyramid_inputs(seq, cfg, dev) -> dict:
    """K16's inputs at cfg's ORB settings, {name: (gray (B, H, W) on the
    card, level table)}: frame 0 ("b1"), frames 0-3 ("b4") and the room's
    frame 0 at each size of PYRAMID_FRAMES, quantized."""
    import torch

    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops.frontend import orb_level_table

    gray, table = _frames_gray(seq, cfg, dev)
    out = {"b1": (gray[:1].contiguous(), table), "b4": (gray, table)}
    for name, (h, w) in PYRAMID_FRAMES.items():
        g8, _ = quantize_frame(*synthetic.make_sequence(
            1, width=w, height=h).render(0), cfg.camera.depth_map_factor)
        out[name] = (torch.from_numpy(g8.astype(np.float32))[None].to(dev),
                     orb_level_table(h, w, cfg.orb))
    return out


def pyramid_problems(seq, cfg, dev, inputs=None) -> dict:
    """K16 on pyramid_inputs (or `inputs`, built by it): {name: fn}, fn()
    launching it."""
    from planarslam_tpu_torch.ops import image

    sf = cfg.orb.scale_factor
    inputs = inputs or pyramid_inputs(seq, cfg, dev)
    return {k: (lambda g=g, t=t: (image.build_pyramid_levels(g, t, sf),))
            for k, (g, t) in inputs.items()}


def _selected_sets(buf, table, cfg) -> list:
    """Per lane of a (B, n_pixels) pyramid, the keypoints (level, u, v)
    FAST and the selection keep on it (the kernels)."""
    from planarslam_tpu_torch.ops import fast
    from planarslam_tpu_torch.ops.frontend import EDGE_BORDER

    uv, _, valid = fast.select_keypoints_levels(
        fast.fast_score_levels(buf, table), table,
        float(cfg.orb.min_th_fast), EDGE_BORDER)
    level = np.repeat(np.arange(table.n_levels), table.column("quota"))
    uv, valid = uv.cpu().numpy(), valid.cpu().numpy()
    return [{(int(l), float(x), float(y))
             for l, (x, y), v in zip(level, uv[b], valid[b]) if v}
            for b in range(buf.shape[0])]


def pyramid_cases(seq, cfg, dev, inputs=None) -> dict:
    """K16 on pyramid_inputs (or `inputs`, built by it) against the plain
    pyramid: within
    PYRAMID_TOLERANCE, level 0 the frames, two launches equal bits, the
    launches its C entry reports, B = 4 lane by lane bit-equal to B = 1,
    and the keypoints FAST and the selection keep on it >= 97% shared with
    the plain pyramid's where it has PYRAMID_MIN_KEYPOINTS or more."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import image

    sf = cfg.orb.scale_factor
    inputs = inputs or pyramid_inputs(seq, cfg, dev)
    out = {}
    for name, (g, table) in inputs.items():
        n0 = kernels.LAUNCHES["pyramid_resize"]
        got = image.build_pyramid_levels(g, table, sf)
        _check(kernels.LAUNCHES["pyramid_resize"] - n0
               == image.PYRAMID_LAUNCHES,
               f"pyramid_resize ({name}): "
               f"{kernels.LAUNCHES['pyramid_resize'] - n0} launches, the C "
               f"entry's count {image.PYRAMID_LAUNCHES}")
        want = image.build_pyramid_levels_plain(g, table, sf)
        again = image.build_pyramid_levels(g, table, sf)
        torch.cuda.synchronize()
        _check(torch.equal(got, again),
               f"pyramid_resize ({name}): two launches differ")
        _check(torch.equal(got[:, table.level_slice(0)],
                           g.reshape(g.shape[0], -1)),
               f"pyramid_resize ({name}): level 0 is not the frame")
        err = _max_err(got, want)
        _check(err <= PYRAMID_TOLERANCE,
               f"pyramid_resize ({name}) error {err} > {PYRAMID_TOLERANCE}")
        if g.shape[0] > 1:
            _same_lanes(f"pyramid_resize ({name})", (got,), [
                (image.build_pyramid_levels(g[b:b + 1].contiguous(), table,
                                            sf),) for b in range(g.shape[0])])
        keys_k = _selected_sets(got, table, cfg)
        keys_p = _selected_sets(want, table, cfg)
        shared = [len(a & b) / max(len(b), 1) for a, b in zip(keys_k, keys_p)]
        for n_p, s in zip(map(len, keys_p), shared):
            _check(n_p < PYRAMID_MIN_KEYPOINTS or s >= 0.97,
                   f"pyramid_resize ({name}): {s:.4f} of {n_p} keypoints "
                   f"shared with the plain pyramid's")
        out[name] = {"shape": list(table.shapes[0]), "lanes": g.shape[0],
                     "levels": [list(s) for s in table.shapes],
                     "max_abs_err": err,
                     "differing_pixels": int((got != want).sum()),
                     "keypoints": [len(k) for k in keys_p],
                     "keypoints_shared": shared}
    return out


def pyramid_protocol(probs: dict, reps: int = 4) -> dict:
    """K16 on pyramid_problems, each problem once as the reference; then
    `reps` passes over the problems in turn, each run once into a buffer
    the allocator hands back after it was filled with NaN (so every pixel
    of every level was written by the call: the cones' owned parts
    partition the pyramid) and once as is, each bit-equal to its
    reference, one launch a call, as the C entry reports."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import image

    want = {k: fn()[0] for k, fn in probs.items()}
    calls = 0
    for _ in range(reps):
        for k, fn in probs.items():
            for poison in (True, False):
                ptr = None
                if poison:
                    nan = torch.full_like(want[k], math.nan)
                    ptr = nan.data_ptr()
                    del nan
                n0 = kernels.LAUNCHES["pyramid_resize"]
                got = fn()[0]
                torch.cuda.synchronize()
                _check(kernels.LAUNCHES["pyramid_resize"] - n0
                       == image.PYRAMID_LAUNCHES,
                       f"pyramid_resize: "
                       f"{kernels.LAUNCHES['pyramid_resize'] - n0} launches "
                       f"for {k}")
                _check(ptr is None or got.data_ptr() == ptr,
                       f"pyramid_resize: {k} did not reuse the NaN buffer")
                _check(torch.equal(got, want[k]),
                       f"pyramid_resize: {k} differs from its first run "
                       f"(buffer filled with NaN: {poison})")
                calls += 1
    return {"calls": calls, "problems": sorted(probs),
            "nan_buffer_bit_equal": True}


def _keypoint_set(uv, level, valid) -> set:
    uv, level, valid = uv.cpu().numpy(), level.cpu().numpy(), \
        valid.cpu().numpy()
    return {(int(l), float(x), float(y))
            for l, (x, y), v in zip(level, uv, valid) if v}


def frontend_kernel_parity(seq, cfg, dev) -> list:
    """K16-K19 against their plain versions on the card on frame 0 of the
    quantized sequence at the default configuration's full width (8 levels,
    1000 features in 1024 slots), and the whole extract_point_features on
    the card against the same function composed of plain versions.
    K16: within PYRAMID_TOLERANCE of the plain pyramid, and the front end
    fed K16's pyramid shares >= 97% of its keypoints (pixel and level) with
    the one fed the plain pyramid. K17: exact, 7 taps on all levels and 5
    taps on the frame, and on PLANTED_BLUR_SHAPES at 1, 3, 5 and 7 taps.
    K18: uv, response and validity exactly equal in every slot on frame 0's
    scores, on the planted score map and on PLANTED_SELECT, with the
    launches its C entry reports. Both with their device times (*_timing,
    blur_problems and select_problems). K19: depth,
    validity, level, response and uv_raw exact, uv and u_right within 1e-4,
    with and without distortion."""
    import dataclasses

    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import fast, image, levels, orb
    from planarslam_tpu_torch.ops import frontend as fe

    oc, cam = cfg.orb, cfg.camera
    g8, d16 = quantize_frame(*seq.render(0), cam.depth_map_factor)
    gray = torch.from_numpy(g8.astype(np.float32)).to(dev)
    depth = torch.from_numpy(
        d16.astype(np.float32) / np.float32(cam.depth_map_factor)).to(dev)
    table = fe.orb_level_table(*gray.shape, oc)
    cap = oc.max_keypoints
    min_score = float(oc.min_th_fast)
    src = "planarslam_tpu_torch/csrc/"
    out = []

    def after_pyramid(buf):
        """The card's stages after the pyramid on a level buffer."""
        scores = fast.fast_score_levels(buf, table)
        uv_l, resp, valid = fast.select_keypoints_levels(
            scores, table, min_score, fe.EDGE_BORDER)
        blur = image.gaussian_blur_levels(buf, table, 7, 2.0)
        angle, desc = orb.orb_describe_levels(buf, blur, uv_l, valid, table,
                                              cap)
        ep = fe.point_epilogue(uv_l, resp, valid, depth[None], cam, table,
                               cap)
        return fe._features(angle, desc, ep)

    # K16: one launch a pyramid against the plain pyramid, on frame 0
    # ("b1") and on pyramid_inputs' other frames (1280x960, 64x48, B = 4
    # lane by lane), into a buffer filled with NaN, and captured and
    # replayed; then the whole front end on frame 0's two pyramids
    inputs16 = pyramid_inputs(seq, cfg, dev)
    cases16 = pyramid_cases(seq, cfg, dev, inputs16)
    probs16 = pyramid_problems(seq, cfg, dev, inputs16)
    protocol16 = pyramid_protocol(probs16)
    replay16 = graph_replay(lambda: probs16["b4"](), "pyramid_resize", None)
    k16 = lambda: probs16["b1"]()[0]  # noqa: E731
    p16 = lambda: image.build_pyramid_levels_plain(  # noqa: E731
        *inputs16["b1"], oc.scale_factor)
    buf, buf_plain = k16(), p16()
    torch.cuda.synchronize()
    f_k, f_p = after_pyramid(buf), after_pyramid(buf_plain)
    keys_k = _keypoint_set(f_k.uv_raw, f_k.level, f_k.valid)
    keys_p = _keypoint_set(f_p.uv_raw, f_p.level, f_p.valid)
    shared = len(keys_k & keys_p) / max(len(keys_p), 1)
    _check(len(keys_p) > 500 and shared >= 0.97,
           f"pyramid_resize: {shared:.4f} of {len(keys_p)} keypoints shared "
           f"with the plain pyramid's front end")
    n_out = table.n_pixels - gray.numel()
    taps = sum(image.resize_taps(a, b).nbytes
               for s0, s1 in zip(table.shapes, table.shapes[1:])
               for a, b in zip(s0, s1))
    out.append({"name": "pyramid_resize", "route": "cuda", "library_ms": None,
                # per output pixel: up to 3 x 3 row taps and 3 column taps
                **_bound(_nbytes(gray, buf) + taps, 24.0 * n_out),
                "source": src + "pyramid.cu",
                "replaces": "planarslam_tpu/ops/image.py:48",
                "max_abs_err": max(c["max_abs_err"]
                                   for c in cases16.values()),
                "tolerance": PYRAMID_TOLERANCE,
                "keypoints_shared": shared, "keypoints": len(keys_p),
                "differing_pixels": cases16["b1"]["differing_pixels"],
                "cases": cases16, "protocol": protocol16,
                "graph_replay_bit_equal": replay16,
                "launches_per_call": image.PYRAMID_LAUNCHES,
                **{f"{k}_timing": kernel_timing_entry(fn, "pyramid_")
                   for k, fn in probs16.items()},
                "ms": _time_ms(k16), "plain_ms": _time_ms(p16)})

    # K17: 7 taps on all levels, 5 taps on the frame (the line stage)
    blur_k = image.gaussian_blur_levels(buf, table, 7, 2.0)
    blur_p = image.gaussian_blur_levels_plain(buf, table, 7, 2.0)
    line_k = image.gaussian_blur(gray, 5, 1.0)
    line_p = image.blur(gray, 5, 1.0)
    torch.cuda.synchronize()
    err17 = max(_max_err(blur_k, blur_p), _max_err(line_k, line_p))
    _check(torch.equal(blur_k, blur_p),
           f"gaussian_blur (7 taps, all levels) differs from plain by "
           f"{_max_err(blur_k, blur_p)}")
    _check(torch.equal(line_k, line_p),
           f"gaussian_blur (5 taps, the frame) differs from plain by "
           f"{_max_err(line_k, line_p)}")
    # the planted levels (1-6 pixels wide or tall, odd offsets) at every
    # tap count, one launch each
    changed = {}
    p_table, p_buf = planted_blur_levels()
    p_buf = torch.from_numpy(p_buf).to(dev)
    for ksize, sigma in PLANTED_BLUR_TAPS:
        n0 = kernels.LAUNCHES["gaussian_blur"]
        got = image.gaussian_blur_levels(p_buf, p_table, ksize, sigma)
        want = image.gaussian_blur_levels_plain(p_buf, p_table, ksize, sigma)
        torch.cuda.synchronize()
        _check(kernels.LAUNCHES["gaussian_blur"] == n0 + 1,
               f"gaussian_blur (planted, {ksize} taps): not one launch")
        _check(torch.equal(got, want), f"gaussian_blur (planted, {ksize} "
               f"taps): {int((got != want).sum())} pixels differ from plain")
        changed[ksize] = int((got != p_buf).sum())
    planted17 = {"levels": [list(x) for x in p_table.shapes],
                 "pixels_changed_by_ksize": changed}
    out.append({"name": "gaussian_blur", "route": "cuda", "library_ms": None,
                # per pixel and pass: 7 multiplies and 7 adds
                **_bound(_nbytes(buf, blur_k), 28.0 * table.n_pixels),
                # the 5-tap frame launch: the frame read and written, per
                # pixel and pass 5 multiplies and 5 adds
                "line_stage_bound": _bound(_nbytes(gray, line_k),
                                           20.0 * gray.numel()),
                "source": src + "pyramid.cu",
                "replaces": "planarslam_tpu/ops/image.py:27",
                "max_abs_err": err17, "tolerance": 0.0,
                "planted": planted17,
                **{f"{k}_timing": kernel_timing_entry(fn, "gaussian_blur")
                   for k, fn in blur_problems(seq, cfg, dev).items()},
                "ms": _time_ms(lambda: image.gaussian_blur_levels(
                    buf, table, 7, 2.0)),
                "line_stage_ms": _time_ms(
                    lambda: image.gaussian_blur(gray, 5, 1.0)),
                "plain_ms": _time_ms(lambda: image.gaussian_blur_levels_plain(
                    buf, table, 7, 2.0))})

    # K18: frame 0's scores, then the planted map
    scores = fast.fast_score_levels(buf, table)
    k18 = fast.select_keypoints_levels(scores, table, min_score,
                                       fe.EDGE_BORDER)
    p18 = fast.select_keypoints_levels_plain(scores, table, min_score,
                                             fe.EDGE_BORDER)
    again = fast.select_keypoints_levels(scores, table, min_score,
                                         fe.EDGE_BORDER)
    torch.cuda.synchronize()
    names = ("uv", "response", "valid")
    for n, a, b, c in zip(names, k18, p18, again):
        _check(torch.equal(a, b), f"select_keypoints: {n} differs from plain "
               f"on frame 0 in {int((a != b).sum())} entries")
        _check(torch.equal(a, c),
               f"select_keypoints: two launches differ in {n}")
    planted = levels.table_from_levels(**PLANTED_LEVELS)
    pl_scores = torch.from_numpy(planted_levels_map(planted)).to(dev)[None]
    n0 = kernels.LAUNCHES["select_keypoints"]
    k18p = fast.select_keypoints_levels(pl_scores, planted, 7.0, 5)
    _check(kernels.LAUNCHES["select_keypoints"]
           == n0 + fast.select_launches(planted),
           f"select_keypoints: {kernels.LAUNCHES['select_keypoints'] - n0} "
           f"launches, the C entry's count {fast.select_launches(planted)}")
    p18p = fast.select_keypoints_levels_plain(pl_scores, planted, 7.0, 5)
    torch.cuda.synchronize()
    for n, a, b in zip(names, k18p, p18p):
        _check(torch.equal(a, b), f"select_keypoints: {n} differs from plain "
               f"on the planted map in {int((a != b).sum())} entries")
    # PLANTED_SELECT: a tile wider than its level, a dry tile of the sort
    # branch, a level of -1 only, a tie across tiles at the quota's cut
    ps = PLANTED_SELECT
    s_table, s_scores = planted_select_levels()
    s_scores = torch.from_numpy(s_scores).to(dev)
    k18s = fast.select_keypoints_levels(s_scores, s_table, ps["min_score"],
                                        ps["border"])
    p18s = fast.select_keypoints_levels_plain(s_scores, s_table,
                                              ps["min_score"], ps["border"])
    torch.cuda.synchronize()
    for n, a, b in zip(names, k18s, p18s):
        _check(torch.equal(a, b), f"select_keypoints: {n} differs from plain "
               f"on PLANTED_SELECT in {int((a != b).sum())} entries")
    planted_select = dict(zip(ps["names"], [
        int(v.sum()) for v in torch.split(
            k18s[2][0], [int(x) for x in s_table.column("quota")])]))
    _check(planted_select["all_below"] == 0
           and planted_select["tie_at_cut"] == ps["quotas"][3]
           and 0 < planted_select["dry_sort"] < ps["quotas"][1],
           f"select_keypoints: PLANTED_SELECT does not exercise it: "
           f"{planted_select}")
    q = planted.column("quota")
    planted_valid = [int(v.sum()) for v in torch.split(k18p[2][0],
                                                       [int(x) for x in q])]
    _check(all(0 < v < n for v, n in zip(planted_valid, q))
           and int(planted.column("k_tile").max()) > 4,
           f"select_keypoints: the planted map fills {planted_valid} of "
           f"{q.tolist()} slots, k_tile {planted.column('k_tile').tolist()}")
    tiles, k_tiles = table.column("tile"), table.column("k_tile")
    n_tiles = table.column("n_tiles")
    ops18 = (12.0 * table.n_pixels
             + float((n_tiles * k_tiles * tiles * tiles).sum())
             + 3.0 * float(((n_tiles * k_tiles) ** 2).sum()))
    out.append({"name": "select_keypoints", "route": "cuda",
                "library_ms": None,
                # per pixel the gate and 8 neighbour compares; per tile and
                # pass a scan of its cells; per level n^2 rank compares
                **_bound(_nbytes(scores, k18), ops18),
                "source": src + "select_keypoints.cu",
                "replaces": "planarslam_tpu/ops/fast.py:73",
                "max_abs_err": 0.0, "tolerance": 0.0,
                "valid_keypoints": int(k18[2].sum()),
                "planted": {"k_tile": [int(k) for k in
                                       planted.column("k_tile")],
                            "quotas": [int(x) for x in q],
                            "valid": planted_valid},
                "planted_select_valid": planted_select,
                "launches_per_call": fast.select_launches(table),
                **{f"{k}_timing": kernel_timing_entry(fn, "select_")
                   for k, fn in select_problems(seq, cfg, dev).items()},
                "ms": _time_ms(lambda: fast.select_keypoints_levels(
                    scores, table, min_score, fe.EDGE_BORDER)),
                "plain_ms": _time_ms(
                    lambda: fast.select_keypoints_levels_plain(
                        scores, table, min_score, fe.EDGE_BORDER))})

    # K19: the synthetic camera (no distortion) and one with all five
    # coefficients set
    uv_l, resp, valid = k18
    cams = {"pinhole": cam,
            "distorted": dataclasses.replace(cam, k1=0.08, k2=-0.12,
                                             p1=0.002, p2=-0.001, k3=0.03)}
    cases = {}
    for name, c in cams.items():
        got = fe.point_epilogue(uv_l, resp, valid, depth[None], c, table, cap)
        want = fe.point_epilogue_plain(uv_l, resp, valid, depth[None], c,
                                       table, cap)
        torch.cuda.synchronize()
        for f in ("uv_raw", "response", "level", "depth", "valid"):
            _check(torch.equal(getattr(got, f), getattr(want, f)),
                   f"point_epilogue ({name}): {f} differs from plain")
        cases[name] = {"uv": _max_err(got.uv, want.uv),
                       "u_right": _max_err(got.u_right, want.u_right),
                       "with_depth": int((got.depth > 0).sum()),
                       "moved_px": _max_err(got.uv, got.uv_raw)}
        _check(max(cases[name]["uv"], cases[name]["u_right"]) <= 1e-4,
               f"point_epilogue ({name}) differs from plain: {cases[name]}")
    _check(cases["distorted"]["moved_px"] > 1.0
           and cases["pinhole"]["moved_px"] == 0.0
           and cases["pinhole"]["with_depth"] > 500,
           f"point_epilogue: the cases do not exercise it: {cases}")
    ep = fe.point_epilogue(uv_l, resp, valid, depth[None], cam, table, cap)
    out.append({"name": "point_epilogue", "route": "cuda", "library_ms": None,
                # per slot: the scale, 5 undistortion steps of ~30 where the
                # camera distorts, the depth gather, the right coordinate
                **_bound(_nbytes(uv_l, resp, valid, ep) + 4 * cap,
                         (30.0 + 150.0 * cam.has_distortion) * cap),
                "source": src + "select_keypoints.cu",
                "replaces": "planarslam_tpu/ops/frontend.py:92",
                "max_abs_err": max(max(c["uv"], c["u_right"])
                                   for c in cases.values()),
                "tolerance": "uv, u_right 1e-4; the rest exact",
                "cases": cases,
                "ms": _time_ms(lambda: fe.point_epilogue(
                    uv_l, resp, valid, depth[None], cam, table, cap)),
                "plain_ms": _time_ms(lambda: fe.point_epilogue_plain(
                    uv_l, resp, valid, depth[None], cam, table, cap))})

    # the whole front end: kernels after the plain pyramid against the plain
    # composition (K16 out of the way), then the card's function itself
    want = fe.extract_point_features_plain(gray, depth, cam, oc)
    got = fe.extract_point_features(gray, depth, cam, oc)
    torch.cuda.synchronize()
    for f in ("uv_raw", "response", "level", "depth", "valid"):
        _check(torch.equal(getattr(f_p, f), getattr(want, f)),
               f"front end after the plain pyramid: {f} differs from the "
               f"plain composition")
    for f in ("uv", "u_right"):
        _check(_max_err(getattr(f_p, f), getattr(want, f)) <= 1e-4,
               f"front end after the plain pyramid: {f} is "
               f"{_max_err(getattr(f_p, f), getattr(want, f))} from the "
               f"plain composition")
    ang = _max_err(f_p.angle, want.angle)
    bad = int(((f_p.desc != want.desc).any(dim=1) & want.valid).sum())
    n_valid = int(want.valid.sum())
    _check(ang <= 1e-4 and bad <= 0.01 * n_valid,
           f"front end after the plain pyramid: angle error {ang}, "
           f"{bad}/{n_valid} descriptors differ")
    for f in got._fields:
        _check(torch.equal(getattr(got, f), getattr(f_k, f)),
               f"extract_point_features differs from its stages in {f}")
    keys_g = _keypoint_set(got.uv_raw, got.level, got.valid)
    keys_w = _keypoint_set(want.uv_raw, want.level, want.valid)
    whole = {"keypoints": len(keys_w),
             "shared": len(keys_g & keys_w) / max(len(keys_w), 1),
             "angle_err_after_plain_pyramid": ang,
             "desc_mismatch_after_plain_pyramid": bad,
             "ms": _time_ms(lambda: fe.extract_point_features(
                 gray, depth, cam, oc), reps=10),
             "plain_ms": _time_ms(lambda: fe.extract_point_features_plain(
                 gray, depth, cam, oc), reps=5)}
    _check(whole["shared"] >= 0.97,
           f"extract_point_features shares {whole['shared']:.4f} of its "
           f"keypoints with the plain composition")
    print(f"frontend_kernel_parity extract_point_features: "
          f"{json.dumps(whole)}", flush=True)
    _print_kernels(out)
    return out


# K21-K23 float tolerances (K20 forms every float as its plain version does
# on the card, so it is held exactly). K21: its means and deviations sum in
# index order where torch.mean / std reduce in their own (a few ulp of
# normalized values <= 1). K22: the direction comes from eig3.cuh's solve,
# not the plain version's tensor ops (ulps of a unit vector times extents of
# a few metres). K23: a 72-term dot product of unit descriptors, a chain of
# fused multiply-adds where the library product orders its sums otherwise at
# M = 256 (at M = 4096 they agree bit for bit).
DESC_TOLERANCE = 1e-5
P3D_TOLERANCE = 1e-5  # metres
SIM_TOLERANCE = 1e-5
LINE_WINDOW = 256  # the local-map window's line slots: tracking's M
LINE_FUSE = 4096   # cfg.map.max_lines: local mapping's _fuse_lines M


def _same(a, b) -> bool:
    """Equal entries, NaN equal to NaN."""
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return bool((a == b).all())


def _finite_err(a, b) -> float:
    """max |a - b| over entries finite in both; inf where the non-finite
    entries differ."""
    both = a.isfinite() & b.isfinite()
    if not bool((both | (a == b) | (a.isnan() & b.isnan())).all()):
        return float("inf")
    return float((a.double() - b.double()).abs()[both].max()) \
        if bool(both.any()) else 0.0


def sum_rtol(n: int) -> float:
    """How far apart, relative to the sum, two float32 sums of the same n
    nonnegative terms in two orders can lie: 2 (n - 1) 2^-24."""
    return 2.0 * (n - 1) * 2.0 ** -24


def _detect_same(got, want):
    """The slots (valid's shape) of two detections whose outputs that pass
    through no sum (validity, angle, endpoints, line equation) are
    equal."""
    lead = tuple(got.valid.shape)
    same = None
    for f in ("valid", "angle", "uv_s", "uv_e", "line2d"):
        a, b = getattr(got, f), getattr(want, f)
        eq = (a == b) | (a.isnan() & b.isnan()) \
            if a.dtype.is_floating_point else a == b
        eq = eq.reshape(lead + (-1,)).all(dim=-1)
        same = eq if same is None else same & eq
    return same


def _rel_err(a, b) -> float:
    """max |a - b| / |b| (0 where both are 0)."""
    d = (a.double() - b.double()).abs()
    return float((d / b.double().abs().clamp(min=1e-30))[d > 0].max()) \
        if bool((d > 0).any()) else 0.0


def _near_decisions(blurred, lc) -> dict:
    """K20's tolerance on one (1, H, W) blurred frame, from the plain
    detection: "terms", the most terms any one of its sums adds (a Hough
    bin's edge slots, a line's supporters, which bound its histogram bins
    and its response), "rtol" = sum_rtol(terms), and the counts of the
    decisions resting on a sum whose plain values lie within 2 rtol of
    turning: a Hough bin against the largest of its 8 neighbours (the peak
    test), neighbours in the order of the best L + 1 peak scores, a
    histogram bin against the occupancy threshold, neighbours in the order
    of the valid responses."""
    import dataclasses

    import torch

    from planarslam_tpu_torch.ops import lines as ln
    from planarslam_tpu_torch.ops.lax_compat import segment_sum

    h, w = blurred.shape[1:]
    diag, n_rho = ln.hough_shape(h, w)
    L = lc.max_lines
    _, _, mag, pix, ft, fr = ln._edge_slots(blurred[0], 40.0,
                                            min(ln.N_EDGE, h * w))
    hough = ln._hough(mag, ft, fr, diag, n_rho)
    bins = ft * n_rho + torch.clamp(((fr + diag) / ln.RHO_RES).int(), 0,
                                    n_rho - 1)
    _, top_idx = ln._peaks(hough, L)
    *_, support, _, _, hist = ln._line_support(mag, pix, ft, fr, top_idx,
                                               w, diag, n_rho)
    terms = int(max(segment_sum((mag > 0).float(), bins, hough.numel()).max(),
                    support.sum(dim=1).max()))
    tol = 2.0 * sum_rtol(terms)

    def near(a, b):
        return (a - b).abs() <= tol * torch.maximum(a.abs(), b.abs())

    pad = torch.nn.functional.pad(
        torch.cat([hough[-1:], hough, hough[:1]]), (1, 1), value=-math.inf)
    nb = torch.stack([pad[1 + dt:1 + dt + ln.N_THETA, 1 + dr:1 + dr + n_rho]
                      for dt in (-1, 0, 1) for dr in (-1, 0, 1)
                      if (dt, dr) != (0, 0)]).amax(0)
    best = torch.topk(torch.where(hough >= nb, hough, 0.0).reshape(-1),
                      L + 1).values
    det = ln.detect_lines_plain(blurred, dataclasses.replace(lc, keep_top=L))
    resp = det.response[0][det.valid[0]]
    return {"terms": terms, "rtol": sum_rtol(terms),
            "peak_test": int(((hough > 0) & near(hough, nb)).sum()),
            "peak_order": int((near(best[:-1], best[1:])
                               & (best[:-1] > 0)).sum()),
            "occupancy": int(near(hist, torch.full_like(hist, 40.0)).sum()),
            "response_order": int(near(resp[:-1], resp[1:]).sum())}


def _bilinear_pixels(uv, h: int, w: int):
    """Flat indices of the 2 x 2 neighbourhoods image.bilinear_sample reads
    at the (..., 2) positions uv."""
    import torch

    u = torch.nan_to_num(uv[..., 0]).clamp(0.0, w - 1.001).floor().long()
    v = torch.nan_to_num(uv[..., 1]).clamp(0.0, h - 1.001).floor().long()
    i = v * w + u
    return torch.stack([i, i + 1, i + w, i + w + 1])


LINE_WINDOW_FRAMES = (0, 1, 2, 6)  # the window's lifted lines
LINE_LANE_VIEWS = (3, 4, 5, 7)     # the frames that see it, one a lane


def _line_window(feats, seq, dev, view: int = 3) -> tuple:
    """K23's tracking problem: the lifted lines of LINE_WINDOW_FRAMES in
    world coordinates (4 x 64 = 256 lines, the window's slots, at the
    default configuration) against frame `view`'s segments at its pose."""
    import torch

    def world(i, p):
        T = torch.from_numpy(seq.poses_wc[i].astype(np.float32)).to(dev)
        return p @ T[:3, :3].T + T[:3, 3]

    src = LINE_WINDOW_FRAMES
    sw = torch.cat([world(i, feats[i].p3d_s) for i in src])
    ew = torch.cat([world(i, feats[i].p3d_e) for i in src])
    desc = torch.cat([feats[i].desc for i in src])
    valid = torch.cat([feats[i].has_3d & feats[i].valid for i in src])
    T_cw = torch.from_numpy(np.linalg.inv(seq.poses_wc[view]).astype(
        np.float32)).to(dev)
    f = feats[view]
    return (sw, ew, desc, valid, T_cw, f.uv_s, f.uv_e, f.angle, f.desc,
            f.valid)


def _line_search_problems(feats, seq, dev, rng, kw) -> dict:
    """K23's inputs, {name: (args, radius)}. "window": _line_window seen
    from frame 3 (radius 14, as tracking calls it); "fuse_4096": the window
    tiled to 4096 lines, the copies moved by 2 cm and their descriptors
    perturbed, 70% of them valid (radius 8, as _fuse_lines calls it);
    "no_candidates": no valid map line (both medians of all-NaN);
    "few_earned": only the four map lines with the best similarities in
    the window valid, fewer than the 6 candidates the adaptive gate needs;
    "tie": the window with its best match's segment copied into a second
    slot (a row's two best segments equal) and its map line into a row 96
    lines on (a column's two best rows equal, in two row tiles);
    "window_250" and "fuse_1000": the first 250 and 1000 map lines of the
    window and of fuse_4096 (a last row tile part full, in one cluster and
    in the two-launch configuration); "all_nan": the window with every
    valid map line's descriptor NaN (every gated similarity NaN, so no
    candidate). kw: the camera (K, image_wh)."""
    import torch

    from planarslam_tpu_torch.ops import lines

    win = _line_window(feats, seq, dev)
    sw, ew, desc, valid = win[:4]
    frame = win[4:]
    out = {"window": (win, 14.0)}
    n, d = desc.shape
    reps = LINE_FUSE // n

    def rand(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    shift = rand(rng.normal(0.0, 0.02, (reps, n, 3)))
    shift[0] = 0.0
    noise = rand(rng.normal(0.0, 0.05, (reps, n, d)))
    noise[0] = 0.0
    d4 = desc[None] + noise
    d4 = d4 / torch.linalg.norm(d4, dim=-1, keepdim=True).clamp(min=1e-9)
    keep = torch.from_numpy(rng.random((reps, n)) < 0.7).to(dev)
    keep[0] = True
    out["fuse_4096"] = ((
        (sw[None] + shift).reshape(-1, 3), (ew[None] + shift).reshape(-1, 3),
        d4.reshape(-1, d), (valid[None] & keep).reshape(-1)) + frame, 8.0)
    none = torch.zeros_like(valid)
    out["no_candidates"] = ((sw, ew, desc, none) + frame, 14.0)
    idx, sim = lines.search_lines_by_projection_plain(*win, radius=14.0,
                                                      **kw)
    few = torch.zeros_like(valid)
    few[torch.topk(sim, 4).indices] = True
    out["few_earned"] = ((sw, ew, desc, few) + frame, 14.0)
    # the tie: the best match (m, l), l's segment also in slot l2, m's map
    # line also in row m2
    m, m2, l, l2 = _line_tie_slots(idx, sim, frame[4].shape[0])
    tie = [t.clone() for t in win]
    for t in tie[:4]:
        t[m2] = t[m]
    for t in tie[5:]:
        t[l2] = t[l]
    out["tie"] = (tuple(tie), 14.0)
    out["window_250"] = (tuple(t[:250] for t in win[:4]) + frame, 14.0)
    fuse = out["fuse_4096"][0]
    out["fuse_1000"] = (tuple(t[:1000] for t in fuse[:4]) + frame, 8.0)
    nan_desc = torch.where(valid[:, None], torch.full_like(desc, math.nan),
                           desc)
    out["all_nan"] = ((sw, ew, nan_desc, valid) + frame, 14.0)
    return out


def _line_tie_slots(idx, sim, L: int) -> tuple:
    """The "tie" problem's planted slots from the window's plain result:
    (m, m2, l, l2), the best match (m, l), the row m2 = m + 96 (mod the
    window's 256) that copies map line m and the slot l2 = l + 37 (mod L)
    that copies segment l."""
    import torch

    m = int(torch.where(idx >= 0, sim, -2.0).argmax())
    l = int(idx[m])
    return m, (m + 96) % idx.shape[0], l, (l + 37) % L


def line_search_feats(seq, cfg, dev) -> dict:
    """The card's line features of the quantized frames of seq that
    _line_window and line_search_lanes read."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import lines as ln

    cam, factor = cfg.camera, cfg.camera.depth_map_factor
    feats = {}
    for i in sorted(set(LINE_WINDOW_FRAMES) | set(LINE_LANE_VIEWS)):
        g8, d16 = quantize_frame(*seq.render(i), factor)
        feats[i] = ln.extract_line_features(
            torch.from_numpy(g8.astype(np.float32)).to(dev),
            torch.from_numpy(d16.astype(np.float32)
                             / np.float32(factor)).to(dev), cam, cfg.lines)
    return feats


def line_search_lanes(feats, seq, dev) -> list:
    """K23's window seen from each frame of LINE_LANE_VIEWS, stacked as B =
    4 problems (every tensor with a leading B)."""
    import torch

    lanes = [_line_window(feats, seq, dev, v) for v in LINE_LANE_VIEWS]
    return [torch.stack(f).contiguous() for f in zip(*lanes)]


def line_search_problems(seq, cfg, dev) -> dict:
    """K23 at the main path's shapes: the tracking window (M = 256) at B =
    1 ("window") and seen from LINE_LANE_VIEWS in one launch
    ("window_b4"), "fuse_4096", "no_candidates" and "few_earned" of
    _line_search_problems. Returns {name: fn}, fn() launching it."""
    from planarslam_tpu_torch.ops import lines as ln

    cam = cfg.camera
    kw = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
              image_wh=(float(cam.width), float(cam.height)))
    feats = line_search_feats(seq, cfg, dev)
    probs = _line_search_problems(feats, seq, dev,
                                  np.random.default_rng(23), kw)
    out = {}
    for name in ("window", "fuse_4096", "no_candidates", "few_earned"):
        args, radius = probs[name]
        bat = [a[None].contiguous() for a in args]
        out[name] = (lambda b=bat, r=radius:
                     ln.search_lines_by_projection_batched(*b, radius=r,
                                                           **kw))
    lanes = line_search_lanes(feats, seq, dev)
    out["window_b4"] = lambda: ln.search_lines_by_projection_batched(
        *lanes, radius=14.0, **kw)
    return out


def _frames_gray(seq, cfg, dev):
    """Frames 0-3 of `seq` (taken again from the first where it is
    shorter), quantized, on the card (4, H, W), and their level table."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops.frontend import orb_level_table

    cam = cfg.camera
    n = len(seq.poses_wc)
    gray = torch.from_numpy(np.stack([
        quantize_frame(*seq.render(i % n), cam.depth_map_factor)[0].astype(
            np.float32) for i in range(4)])).to(dev)
    return gray, orb_level_table(cam.height, cam.width, cfg.orb)


def _frames_pyramid(seq, cfg, dev):
    """_frames_gray's frames and table, and their 8-level pyramids (4,
    n_pixels) built by the tree's K16."""
    from planarslam_tpu_torch.ops import image

    gray, table = _frames_gray(seq, cfg, dev)
    return gray, table, image.build_pyramid_levels(gray, table,
                                                   cfg.orb.scale_factor)


def fast_problems(seq, cfg, dev) -> dict:
    """K1 at the main path's shapes: frame 0's 8-level pyramid ("b1") and
    frames 0-3's in one launch ("b4"), built by the tree's K16. Returns
    {name: fn}, fn() launching it."""
    from planarslam_tpu_torch.ops import fast

    _, table, buf = _frames_pyramid(seq, cfg, dev)
    one = buf[:1].contiguous()
    return {"b1": lambda: (fast.fast_score_levels(one, table),),
            "b4": lambda: (fast.fast_score_levels(buf, table),)}


def blur_problems(seq, cfg, dev) -> dict:
    """K17 at the main path's shapes: 7 taps on frame 0's 8-level pyramid
    ("b1") and on frames 0-3's in one launch ("b4"), and the line stage's
    5 taps on frame 0 ("frame_5tap") and on frames 0-3 in one launch
    ("frame_5tap_b4"). Returns {name: fn}, fn() launching it."""
    from planarslam_tpu_torch.ops import image

    gray, table, buf = _frames_pyramid(seq, cfg, dev)
    one, g1 = buf[:1].contiguous(), gray[:1].contiguous()
    return {"b1": lambda: (image.gaussian_blur_levels(one, table, 7, 2.0),),
            "b4": lambda: (image.gaussian_blur_levels(buf, table, 7, 2.0),),
            "frame_5tap": lambda: (image.gaussian_blur(g1, 5, 1.0),),
            "frame_5tap_b4": lambda: (image.gaussian_blur(gray, 5, 1.0),)}


def select_problems(seq, cfg, dev) -> dict:
    """K18 at the main path's shapes: frame 0's FAST scores ("b1") and
    frames 0-3's in one launch ("b4"), from the tree's K16 and K1, and the
    planted map of PLANTED_LEVELS ("planted"). Returns {name: fn}, fn()
    launching it."""
    import torch

    from planarslam_tpu_torch.ops import fast, levels
    from planarslam_tpu_torch.ops.frontend import EDGE_BORDER

    _, table, buf = _frames_pyramid(seq, cfg, dev)
    scores = fast.fast_score_levels(buf, table)
    one = scores[:1].contiguous()
    min_score = float(cfg.orb.min_th_fast)
    planted = levels.table_from_levels(**PLANTED_LEVELS)
    pl_scores = torch.from_numpy(planted_levels_map(planted)).to(dev)[None]
    return {"b1": lambda: fast.select_keypoints_levels(
                one, table, min_score, EDGE_BORDER),
            "b4": lambda: fast.select_keypoints_levels(
                scores, table, min_score, EDGE_BORDER),
            "planted": lambda: fast.select_keypoints_levels(
                pl_scores, planted, 7.0, 5)}


def detect_timing(blurred, lc) -> dict:
    """K20's times on blurred frames: ms per wrapper call and its device ms
    per call by launch under the profiler."""
    from planarslam_tpu_torch.ops import lines as ln

    split = _launch_split(lambda: ln.detect_lines(blurred, lc),
                          match="lines_")
    return {"ms": _time_ms(lambda: ln.detect_lines(blurred, lc)),
            "launch_split_ms": split,
            "device_ms": sum(v["ms"] for v in split.values())}


# K22's planted cases: half the slots invalid (among them segments whose fit
# would pass), segments over depth holes (some and all of their samples on
# zero depth), endpoints off the image and samples on exact half pixels
# beside a depth step, a 3D extent just under and just over 0.05 m, and
# the small configuration's and the C entry's largest sizes
LIFT_CASES = ("invalid_slots", "depth_holes", "off_image", "extent_edge",
              "sizes_24_16", "sizes_64_64")
# (n_depth_samples, ransac_iters) of the sizes cases
LIFT_SIZES = {"sizes_24_16": (24, 16), "sizes_64_64": (64, 64)}
LIFT_SHAPE = (480, 640)  # the planted depths' (h, w)
LIFT_PANEL_Z = 2.0      # depth of the noiseless panel extent_edge lies on
LIFT_SLOTS = 64         # segments a planted frame holds (max_lines)


def _lift_segments(rng, n: int, h: int, w: int) -> tuple:
    """n random segments 40-220 pixels long inside a (h, w) image."""
    start = np.stack([rng.uniform(30, w - 30, n), rng.uniform(30, h - 30, n)],
                     -1)
    ang = rng.uniform(0.0, np.pi, n)
    length = rng.uniform(40.0, 220.0, n)
    end = start + length[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    end = np.stack([np.clip(end[:, 0], 0, w - 1),
                    np.clip(end[:, 1], 0, h - 1)], -1)
    return start.astype(np.float32), end.astype(np.float32)


def _zero_along(depth: np.ndarray, s, e, a0: float = 0.0, a1: float = 1.0):
    """Zero the depth 2 pixels around the segment s -> e between its
    fractions a0 and a1."""
    h, w = depth.shape
    for a in np.linspace(a0, a1, 400):
        u, v = s + a * (e - s)
        u0, v0 = int(round(u)), int(round(v))
        depth[max(v0 - 2, 0):min(v0 + 3, h), max(u0 - 2, 0):min(u0 + 3, w)] = 0


def planted_lift_problem(case: str, seed: int = 19, fx: float = 535.4,
                         factor: float = 5000.0) -> dict:
    """One planted K22 frame of LIFT_CASES as numpy arrays: depth (h, w)
    metres (a slanted wall, a nearer box, a depth step at column 200 and
    row 150, quantized with the Kinect noise model; a noiseless panel at
    LIFT_PANEL_Z), uv_s, uv_e (L, 2), valid (L,), and the case's
    (n_depth_samples, ransac_iters) or None for the configuration's. fx is
    the camera's (extent_edge's lengths follow from it)."""
    rng = np.random.default_rng(seed)
    h, w = LIFT_SHAPE
    L = LIFT_SLOTS
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    z = 3.2 + 0.0015 * (u - w / 2) + 0.0004 * (v - h / 2)
    z = np.where((u > 380) & (u < 560) & (v > 60) & (v < 280),
                 1.7 + 0.002 * (u - 470), z)
    z = np.where(u <= 200, z - 0.6, z)   # a step between columns 200, 201
    z = np.where(v <= 150, z + 0.3, z)   # and between rows 150, 151
    depth = noisy_depth(z.astype(np.float32), factor, seed=seed)
    panel = (v >= 300) & (v < 470) & (u >= 20) & (u < 360)
    depth[panel] = np.float32(LIFT_PANEL_Z)
    uv_s, uv_e = _lift_segments(rng, L, h, w)
    valid = np.ones(L, bool)
    if case == "invalid_slots":
        valid[rng.permutation(L)[:L // 2]] = False
    elif case == "depth_holes":
        for k in range(0, 16):      # every sample on zero depth
            _zero_along(depth, uv_s[k], uv_e[k])
        for k in range(16, 32):     # a part of the samples
            _zero_along(depth, uv_s[k], uv_e[k], 0.25, 0.25 + 0.1 * (k - 15)
                        / 4.0)
    elif case == "off_image":
        for k in range(16):         # both ends beyond the image
            uv_s[k] = (rng.uniform(-80, -1), rng.uniform(-60, h + 60))
            uv_e[k] = (rng.uniform(w, w + 80), rng.uniform(-60, h + 60))
        for k in range(16, 24):     # one end beyond a corner
            uv_e[k] = (rng.choice([-40.0, w + 40.0]),
                       rng.choice([-40.0, h + 40.0]))
        for k in range(24, 32):     # vertical, on column 200.5 / 202.5
            x = np.float32(200.5 + 2 * (k % 2))
            uv_s[k] = (x, rng.uniform(20, 200))
            uv_e[k] = (x, rng.uniform(260, h - 20))
        for k in range(32, 40):     # horizontal, on row 150.5 / 148.5
            y = np.float32(150.5 - 2 * (k % 2))
            uv_s[k] = (rng.uniform(20, 200), y)
            uv_e[k] = (rng.uniform(260, w - 20), y)
    elif case == "extent_edge":
        # horizontal segments on the panel, their 3D extent (0.96 of the
        # length times z / fx) 0.998 and 1.002 of 0.05 m in turn
        base = 0.05 * fx / (0.96 * LIFT_PANEL_Z)
        for k in range(32):
            x0 = np.float32(rng.uniform(30, 330))
            y0 = np.float32(rng.uniform(305, 465))
            uv_s[k] = (x0, y0)
            uv_e[k] = (x0 + np.float32(base * (0.998 if k % 2 == 0
                                               else 1.002)), y0)
    return {"depth": depth, "uv_s": uv_s.astype(np.float32),
            "uv_e": uv_e.astype(np.float32), "valid": valid,
            "sizes": LIFT_SIZES.get(case)}


def planted_lift_lanes(case: str, batch: int, seed: int = 19) -> dict:
    """planted_lift_problem of seeds seed .. seed + batch - 1 stacked on a
    leading lane dimension (the case's sizes shared)."""
    probs = [planted_lift_problem(case, seed + b) for b in range(batch)]
    out = {k: np.stack([p[k] for p in probs])
           for k in ("depth", "uv_s", "uv_e", "valid")}
    out["sizes"] = probs[0]["sizes"]
    return out


def lift_config(lc, sizes):
    """The line configuration with a planted case's (n_depth_samples,
    ransac_iters), or lc itself."""
    import dataclasses

    if sizes is None:
        return lc
    return dataclasses.replace(lc, n_depth_samples=sizes[0],
                               ransac_iters=sizes[1])


def _lift_args(prob: dict, cfg, dev) -> tuple:
    """lift_lines_3d's arguments for a planted_lift_lanes problem."""
    import torch

    t = {k: torch.from_numpy(prob[k]).to(dev)
         for k in ("depth", "uv_s", "uv_e", "valid")}
    return (t["depth"], cfg.camera, lift_config(cfg.lines, prob["sizes"]),
            t["uv_s"], t["uv_e"], t["valid"])


def lift_lane(args: tuple, b: int) -> tuple:
    """Lane b of lift_lines_3d's batched arguments, as a batch of one."""
    return (args[0][b:b + 1].contiguous(), *args[1:3],
            *[a[b:b + 1].contiguous() for a in args[3:]])


def lift_planted_parity(cfg, dev) -> dict:
    """K22 on every LIFT_CASES frame against its plain version: has_3d
    exact, endpoints within P3D_TOLERANCE, two launches equal bits, one
    launch a call; each case also at B = 4 (four seeds) in one launch,
    each lane bit-equal to its B = 1 launch. Returns per case the lines
    lifted, the largest error and what the case plants."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import lines as ln

    out = {}
    for case in LIFT_CASES:
        lanes = planted_lift_lanes(case, 4)
        args4 = _lift_args(lanes, cfg, dev)
        singles, err = [], 0.0
        for b in range(4):
            args = lift_lane(args4, b)
            n0 = kernels.LAUNCHES["lift_lines_3d"]
            got = ln.lift_lines_3d(*args)
            _check(kernels.LAUNCHES["lift_lines_3d"] == n0 + 1,
                   f"lift_lines_3d ({case}): not one launch a call")
            again = ln.lift_lines_3d(*args)
            want = ln.lift_lines_3d_plain(*args)
            torch.cuda.synchronize()
            _check(all(_bit_diff(x, y, as_int=x.dtype == torch.float32) == 0
                       for x, y in zip(got, again)),
                   f"lift_lines_3d ({case}): two launches differ")
            _check(torch.equal(got[2], want[2]),
                   f"lift_lines_3d ({case}, lane {b}): has_3d differs from "
                   f"plain in {int((got[2] != want[2]).sum())} lines")
            e = max(_finite_err(got[0], want[0]), _finite_err(got[1], want[1]))
            _check(e <= P3D_TOLERANCE, f"lift_lines_3d ({case}, lane {b}) "
                   f"differs from plain by {e} m")
            err = max(err, e)
            singles.append((got, want))
        n0 = kernels.LAUNCHES["lift_lines_3d"]
        got4 = ln.lift_lines_3d(*args4)
        _check(kernels.LAUNCHES["lift_lines_3d"] == n0 + 1,
               f"lift_lines_3d ({case}, B = 4): not one launch")
        torch.cuda.synchronize()
        for b, (one, _) in enumerate(singles):
            _check(all(_bit_diff(x[b], y[0], as_int=x.dtype == torch.float32)
                       == 0 for x, y in zip(got4, one)),
                   f"lift_lines_3d ({case}): lane {b} of B = 4 differs from "
                   f"its B = 1 launch")
        has = singles[0][1][2][0]
        rec = {"valid": int(args4[5][0].sum()), "has_3d": int(has.sum()),
               "max_abs_err": err}
        if case == "invalid_slots":
            # the invalid slots' fits, were the slots valid
            allv = ln.lift_lines_3d_plain(*args4[:5],
                                          torch.ones_like(args4[5]))[2][0]
            rec["would_pass"] = int((allv & ~args4[5][0]).sum())
        if case == "extent_edge":
            rec["under"] = int(has[0:32:2].sum())
            rec["over"] = int(has[1:32:2].sum())
        out[case] = rec
    _check(out["invalid_slots"]["would_pass"] > 5
           and out["depth_holes"]["has_3d"] > 5
           and out["extent_edge"]["under"] == 0
           and out["extent_edge"]["over"] == 16
           and all(out[c]["has_3d"] > 5 for c in LIFT_SIZES),
           f"lift_lines_3d: the planted cases do not exercise it: {out}")
    return out


def lift_problems(seq, cfg, dev) -> dict:
    """K22 at the main path's shapes: frame 0's segments (K20 on its 5-tap
    blur) on its clean and its Kinect-noisy depth, as line_kernel_parity
    builds them, frames 0-3 in one launch ("b4"), and every LIFT_CASES
    frame alone and at B = 4. Returns {name: fn}, fn() launching it."""
    import torch

    from planarslam_tpu_torch.ops import image
    from planarslam_tpu_torch.ops import lines as ln

    lc, cam = cfg.lines, cfg.camera
    gray, _ = _frames_gray(seq, cfg, dev)
    depth = _room_depths(seq, cfg, dev, 4)
    blurred = torch.stack([image.gaussian_blur(g, 5, 1.0) for g in gray])
    det = ln.detect_lines(blurred, lc)
    noisy = torch.from_numpy(noisy_depth(
        depth[0].cpu().numpy(), cam.depth_map_factor)).to(dev)
    one = [det.uv_s[:1].contiguous(), det.uv_e[:1].contiguous(),
           det.valid[:1].contiguous()]
    probs = {"clean": (depth[:1].contiguous(), cam, lc, *one),
             "noisy": (noisy[None], cam, lc, *one),
             "b4": (depth, cam, lc, det.uv_s, det.uv_e, det.valid)}
    for case in LIFT_CASES:
        args4 = _lift_args(planted_lift_lanes(case, 4), cfg, dev)
        probs[case] = lift_lane(args4, 0)
        probs[f"{case}_b4"] = args4
    return {k: (lambda a=a: ln.lift_lines_3d(*a)) for k, a in probs.items()}


def lift_stats(seq, cfg, dev) -> dict:
    """The line slots of path 1's frames: valid ones and those K22 lifts
    (has_3d), each frame's line front end on its quantized frame; min,
    median and max over the frames."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import lines as ln

    cam = cfg.camera
    counts = {"valid": [], "has_3d": []}
    for i in range(len(seq.poses_wc)):
        g8, d16 = quantize_frame(*seq.render(i), cam.depth_map_factor)
        f = ln.extract_line_features(
            torch.from_numpy(g8.astype(np.float32)).to(dev),
            torch.from_numpy(d16.astype(np.float32)
                             / np.float32(cam.depth_map_factor)).to(dev),
            cam, cfg.lines)
        counts["valid"].append(int(f.valid.sum()))
        counts["has_3d"].append(int((f.has_3d & f.valid).sum()))
    return {k: {"min": min(v), "median": float(np.median(v)), "max": max(v)}
            for k, v in counts.items()} | {"frames": len(seq.poses_wc),
                                           "slots": cfg.lines.max_lines}


def line_kernel_parity(seq, cfg, dev) -> list:
    """K20-K23 against their plain versions on the card at the default
    configuration's full width (640x480, 64 lines, E = 6144 edge pixels,
    36 x 803 Hough bins, 48 depth samples, 32 hypotheses), on frame 0 clean
    and with Kinect noise on its depth, and the whole extract_line_features
    against the same function composed of plain versions. K20: the
    gradients and every output that passes through none of its three sums
    (validity, angle, the endpoints of every slot, the invalid ones too)
    exactly equal, the responses within the rounding of two orders of a
    sum (sum_rtol of the most terms any one sum of the frame adds), and a
    slot may differ only where a decision of the plain version on a sum
    lies within twice that rounding of turning (_near_decisions, printed
    with torch's version); K21: within DESC_TOLERANCE; K22: has_3d exact,
    endpoints within P3D_TOLERANCE, also on every LIFT_CASES frame at B =
    1 and 4 lane by lane (lift_planted_parity); K23 on
    _line_search_problems (the
    256-line window, 4096 lines, no candidate, fewer than 6 earned, a
    planted tie of two segments and of two rows in two row tiles, 250 and
    1000 lines, every candidate NaN): indices exact, similarities within
    SIM_TOLERANCE, NaN where the plain version's are, the launches the
    configuration of its M takes. Every kernel gives the same bits on two
    launches."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import image
    from planarslam_tpu_torch.ops import lines as ln

    lc, cam = cfg.lines, cfg.camera
    factor = cam.depth_map_factor

    def frame(i):
        g8, d16 = quantize_frame(*seq.render(i), factor)
        return (torch.from_numpy(g8.astype(np.float32)).to(dev),
                d16.astype(np.float32) / np.float32(factor))

    gray, clean = frame(0)
    depths = {"clean": torch.from_numpy(clean).to(dev),
              "noisy": torch.from_numpy(noisy_depth(clean, factor)).to(dev)}
    blurred = image.gaussian_blur(gray, 5, 1.0)[None]
    src = "planarslam_tpu_torch/csrc/"
    out, cases = [], {}

    # K20
    det = ln.detect_lines(blurred, lc)
    det_p = ln.detect_lines_plain(blurred, lc)
    again = ln.detect_lines(blurred, lc)
    torch.cuda.synchronize()
    for f in det._fields:
        _check(_same(getattr(det, f), getattr(again, f)),
               f"detect_lines: two launches differ in {f}")
    for f in ("gx", "gy"):
        _check(_same(getattr(det, f), getattr(det_p, f)),
               f"detect_lines: {f} differs from plain")
    h, w = gray.shape
    diag, n_rho = ln.hough_shape(h, w)
    E = min(ln.N_EDGE, h * w)
    L = lc.max_lines
    near = _near_decisions(blurred, lc)
    rtol = near["rtol"]
    same = _detect_same(det, det_p)
    flips = int((~same).sum())
    n_near = sum(v for k, v in near.items() if k not in ("terms", "rtol"))
    _check(flips == 0 or n_near > 0,
           f"detect_lines: {flips} slots differ from plain with no decision "
           f"of the plain version within {2.0 * rtol} of turning: {near}")
    resp_err = _rel_err(det.response[same], det_p.response[same])
    _check(resp_err <= rtol, f"detect_lines: responses differ from plain by "
           f"{resp_err} (relative) > {rtol}")
    n_valid = int(det.valid.sum())
    _check(n_valid > 10, f"detect_lines: only {n_valid} valid lines")
    k20 = {"torch": torch.__version__, "flips": flips, "near": near,
           "response_rel_err": resp_err}
    print(f"line_kernel_parity detect_lines: {json.dumps(k20)}", flush=True)
    out.append({
        "name": "detect_lines", "route": "cuda", "library_ms": None,
        # per pixel: Sobel, magnitude, atan2, NMS (~60); per edge slot its
        # bin and vote (~30); per line and slot the support test, position
        # and bin (~20)
        **_bound(_nbytes(blurred, det), 60.0 * h * w + 30.0 * E
                 + 20.0 * L * E),
        "source": src + "lines.cu",
        "replaces": "planarslam_tpu/ops/lines.py:58",
        "max_abs_err": float((det.response[same].double()
                              - det_p.response[same].double()).abs().max()),
        "tolerance": f"gradients and every output off the sums exact, "
                     f"responses {rtol} relative, flips only at plain "
                     f"decisions within {2.0 * rtol}",
        "valid_lines": n_valid, "hough_bins": 36 * n_rho, **k20,
        "launches_per_call": ln.DETECT_LAUNCHES,
        **detect_timing(blurred, lc),
        "plain_ms": _time_ms(lambda: ln.detect_lines_plain(blurred, lc))})
    print(f"line_kernel_parity detect_lines launches: "
          f"{json.dumps(out[-1]['launch_split_ms'])}", flush=True)

    # K21 on K20's outputs
    dargs = (det.gx, det.gy, det.uv_s, det.uv_e, det.valid)
    desc = ln.line_descriptors(*dargs)
    desc_p = ln.line_descriptors_plain(*dargs)
    torch.cuda.synchronize()
    _check(_same(desc, ln.line_descriptors(*dargs)),
           "line_descriptors: two launches differ")
    err21 = _finite_err(desc, desc_p)
    _check(err21 <= DESC_TOLERANCE,
           f"line_descriptors differs from plain by {err21}")
    # the gradient pixels the samples read: the 2 x 2 neighbourhoods of
    # every line's 9 x 24 band positions, each distinct pixel once per image
    d = det.uv_e[0] - det.uv_s[0]
    t = d / torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-9)
    nrm = torch.stack([-t[:, 1], t[:, 0]], -1)
    alphas = torch.from_numpy(ln._DESC_ALPHAS).to(dev)
    band = torch.from_numpy(ln._BAND_OFF).to(dev)
    centers = (det.uv_s[0][:, None, None] + alphas[None, None, :, None]
               * d[:, None, None] + band[None, :, None, None]
               * nrm[:, None, None])
    n_pix21 = int(torch.unique(_bilinear_pixels(centers, h, w)).numel())
    out.append({
        "name": "line_descriptors", "route": "cuda", "library_ms": None,
        # per line: 216 samples of two bilinear gathers (~30), 36 means and
        # deviations over 24 (~100), the norm
        **_bound(_nbytes(*dargs[2:], alphas, desc) + 2 * 4 * n_pix21,
                 L * (216 * 30.0 + 36 * 100.0)),
        "gradient_pixels_read": n_pix21,
        "source": src + "lines.cu",
        "replaces": "planarslam_tpu/ops/lines.py:224",
        "max_abs_err": err21, "tolerance": DESC_TOLERANCE,
        "ms": _time_ms(lambda: ln.line_descriptors(*dargs)),
        "plain_ms": _time_ms(lambda: ln.line_descriptors_plain(*dargs))})

    # K22, clean and noisy depth
    lifted = {}
    for name, depth in depths.items():
        largs = (depth[None], cam, lc, det.uv_s, det.uv_e, det.valid)
        got = ln.lift_lines_3d(*largs)
        want = ln.lift_lines_3d_plain(*largs)
        torch.cuda.synchronize()
        for a, c in zip(got, ln.lift_lines_3d(*largs)):
            _check(_same(a, c), f"lift_lines_3d ({name}): two launches differ")
        _check(torch.equal(got[2], want[2]),
               f"lift_lines_3d ({name}): has_3d differs from plain in "
               f"{int((got[2] != want[2]).sum())} lines")
        err = max(_finite_err(got[0], want[0]), _finite_err(got[1], want[1]))
        _check(err <= P3D_TOLERANCE,
               f"lift_lines_3d ({name}) differs from plain by {err} m")
        cases[name] = {"has_3d": int(got[2].sum()), "max_abs_err": err}
        lifted[name] = largs
    _check(cases["clean"]["has_3d"] > 10,
           f"lift_lines_3d: the cases do not exercise it: {cases}")
    planted = lift_planted_parity(cfg, dev)
    print(f"line_kernel_parity lift_lines_3d planted: {json.dumps(planted)}",
          flush=True)
    largs = lifted["clean"]
    S, iters = lc.n_depth_samples, lc.ransac_iters
    # the depth pixels the S nearest samples per line read, each once
    tables = ln._lift_tables(lc, dev)
    pts = (det.uv_s[0][:, None] + tables[0][None, :, None]
           * (det.uv_e[0] - det.uv_s[0])[:, None])
    index_img = torch.arange(h * w, dtype=torch.float64,
                             device=dev).reshape(h, w)
    n_pix22 = int(torch.unique(image.nearest_sample(
        index_img, torch.nan_to_num(pts))).numel())
    out.append({
        "name": "lift_lines_3d", "route": "cuda", "library_ms": None,
        # per line: S samples (~15), iters x S point-line distances (~30),
        # the weighted PCA (~40 per sample and ~300 for the solve)
        **_bound(_nbytes(largs[3:], tables, ln.lift_lines_3d(*largs))
                 + 4 * n_pix22,
                 L * (S * 15.0 + iters * S * 30.0 + S * 40.0 + 300.0)),
        "depth_pixels_read": n_pix22,
        "source": src + "line_lift_search.cu",
        "replaces": "planarslam_tpu/ops/lines.py:260",
        "max_abs_err": max(c["max_abs_err"] for c in (*cases.values(),
                                                       *planted.values())),
        "tolerance": f"has_3d exact, endpoints {P3D_TOLERANCE} m",
        "cases": cases, "planted": planted,
        "ms": _time_ms(lambda: ln.lift_lines_3d(*largs)),
        "plain_ms": _time_ms(lambda: ln.lift_lines_3d_plain(*largs))})

    # K23 on the window of frames 0, 1, 2, 6 seen from frame 3, and the
    # other problems built from it
    feats = line_search_feats(seq, cfg, dev)
    kw0 = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
               image_wh=(float(cam.width), float(cam.height)))
    problems = _line_search_problems(feats, seq, dev,
                                     np.random.default_rng(23), kw0)
    scases, plain_idx = {}, {}
    for name, (args, radius) in problems.items():
        kw = dict(kw0, radius=radius)
        bat = [a[None] for a in args]
        M = int(args[0].shape[0])
        n0 = kernels.LAUNCHES["search_lines_by_projection"]
        idx, sim = ln.search_lines_by_projection_batched(*bat, **kw)
        launched = kernels.LAUNCHES["search_lines_by_projection"] - n0
        idx2, sim2 = ln.search_lines_by_projection_batched(*bat, **kw)
        idx_p, sim_p = ln.search_lines_by_projection_plain(*args, **kw)
        torch.cuda.synchronize()
        _check(launched == ln.search_launches(M),
               f"search_lines_by_projection ({name}): {launched} launches "
               f"at M = {M}, expected {ln.search_launches(M)}")
        _check(_same(idx, idx2) and _bit_diff(sim, sim2, as_int=True) == 0,
               f"search_lines_by_projection ({name}): two launches differ")
        _check(torch.equal(idx[0], idx_p),
               f"search_lines_by_projection ({name}): {int((idx[0] != idx_p).sum())}"
               f" indices differ from plain")
        err = _finite_err(sim[0], sim_p)
        _check(err <= SIM_TOLERANCE, f"search_lines_by_projection ({name}): "
               f"similarities differ from plain by {err}")
        cand = sim_p > -0.5
        plain_idx[name] = idx_p
        scases[name] = {"M": M, "launches": launched,
                        "matches": int((idx_p >= 0).sum()),
                        "candidates": int(cand.sum()),
                        "earned": int((cand & (sim_p >= 0.575)).sum()),
                        "nan_best": int(sim_p.isnan().sum()),
                        "max_abs_err": err}
    wargs, _ = problems["window"]
    m, m2, l, l2 = _line_tie_slots(*ln.search_lines_by_projection_plain(
        *wargs, radius=14.0, **kw0), wargs[8].shape[0])
    tie = plain_idx["tie"]
    scases["tie"]["slots"] = [m, m2, l, l2]
    _check(scases["window"]["matches"] > 5
           and scases["fuse_4096"]["matches"] > 5
           and scases["window_250"]["matches"] > 5
           and scases["fuse_1000"]["matches"] > 5
           and scases["no_candidates"]["candidates"] == 0
           and 0 < scases["few_earned"]["earned"] < 6
           and int(tie[min(m, m2)]) == min(l, l2)
           and int(tie[max(m, m2)]) == -1
           and m // 32 != m2 // 32
           and scases["all_nan"]["candidates"] == 0
           and scases["all_nan"]["nan_best"] > 0,
           f"search_lines_by_projection: the cases do not exercise it: "
           f"{scases}")
    kw = dict(kw0, radius=14.0)
    fargs, _ = problems["fuse_4096"]
    m, d = LINE_WINDOW, wargs[2].shape[1]
    out.append({
        "name": "search_lines_by_projection", "route": "cuda",
        "library_ms": None,
        # per map line the projection (~60); per pair the gates (~40) and
        # the 72-term product (2 per term)
        **_bound(_nbytes(wargs), m * 60.0 + m * L * (40.0 + 2.0 * d)),
        "source": src + "line_lift_search.cu",
        "replaces": "planarslam_tpu/ops/lines.py:412",
        "max_abs_err": max(c["max_abs_err"] for c in scases.values()),
        "tolerance": f"indices exact, similarities {SIM_TOLERANCE}",
        "cases": scases,
        "ms": _time_ms(lambda: ln.search_lines_by_projection(*wargs, **kw)),
        "plain_ms": _time_ms(
            lambda: ln.search_lines_by_projection_plain(*wargs, **kw)),
        "fuse_4096_ms": _time_ms(lambda: ln.search_lines_by_projection(
            *fargs, **dict(kw0, radius=8.0))),
        "fuse_4096_plain_ms": _time_ms(
            lambda: ln.search_lines_by_projection_plain(
                *fargs, **dict(kw0, radius=8.0)))})

    # the whole line front end against its plain composition
    depth = depths["clean"]
    got = ln.extract_line_features(gray, depth, cam, lc)
    want = ln.extract_line_features_plain(gray, depth, cam, lc)
    torch.cuda.synchronize()
    # slots K20 turned (flips, justified above) are left out of the rest
    same = _detect_same(got, want)
    _check(int((~same).sum()) == flips, "extract_line_features: "
           f"{int((~same).sum())} slots differ, K20 on the frame {flips}")
    tol = {"desc": DESC_TOLERANCE, "p3d_s": P3D_TOLERANCE,
           "p3d_e": P3D_TOLERANCE}
    whole = {"flips": flips,
             "response_rel_err": _rel_err(got.response[same],
                                          want.response[same])}
    _check(whole["response_rel_err"] <= rtol, "extract_line_features: "
           f"responses differ by {whole['response_rel_err']} > {rtol}")
    for f in ("desc", "p3d_s", "p3d_e", "has_3d"):
        a, b = getattr(got, f)[same], getattr(want, f)[same]
        if f in tol:
            whole[f] = _finite_err(a, b)
            _check(whole[f] <= tol[f], f"extract_line_features: {f} differs "
                   f"from the plain composition by {whole[f]}")
        else:
            _check(_same(a, b), f"extract_line_features: {f} differs from "
                   f"the plain composition")
    whole.update(
        valid=int(got.valid.sum()), has_3d=int(got.has_3d.sum()),
        ms=_time_ms(lambda: ln.extract_line_features(gray, depth, cam, lc),
                    reps=10),
        plain_ms=_time_ms(lambda: ln.extract_line_features_plain(
            gray, depth, cam, lc), reps=5))
    print(f"line_kernel_parity extract_line_features: {json.dumps(whole)}",
          flush=True)
    _print_kernels(out)
    return out


# K47's planted problems: the MAD-shifted pair of tests/test_lines.py
# (true pairs at similarity ~0.6), ties (a repeated row and two repeated
# columns), NaN descriptors (one entry, one whole row), no valid line, and
# angles at the 0.26 gate (one float below, at it, one above, some across
# the pi wrap)
MATCH_PLANTED = ("mad_shift", "tie", "nan_desc", "no_valid", "angle_gate")
MATCH_PAIRS = 4  # path 1's consecutive frame pairs K47 is held on


def _unit_rows(rng, n: int, D: int = 72) -> np.ndarray:
    x = rng.normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def planted_match_problem(case: str, n: int = 64, seed: int = 5) -> tuple:
    """match_lines' inputs (numpy): desc_a, desc_b, valid_a, valid_b,
    angle_a, angle_b for the MATCH_PLANTED case at n lines a frame."""
    rng = np.random.default_rng(seed)
    base = _unit_rows(rng, n)
    noise = rng.normal(size=(n, 72))
    noise -= (noise * base).sum(1, keepdims=True) * base
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    target = 0.60 + rng.uniform(-0.02, 0.02, n)
    shifted = (target[:, None] * base
               + np.sqrt(1 - target[:, None] ** 2) * noise).astype(np.float32)
    angles = rng.uniform(0, np.pi, n).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "mad_shift":
        return base, shifted, valid, valid.copy(), angles, angles.copy()
    if case == "tie":
        a = _unit_rows(rng, n)
        b = a.copy()
        a[7] = a[3]
        b[11] = b[2]
        b[12] = b[2]
        return a, b, valid, valid.copy(), angles, angles.copy()
    if case == "nan_desc":
        a, b = base.copy(), base.copy()
        a[4, 9] = np.nan
        b[6, :] = np.nan
        return a, b, valid, valid.copy(), angles, angles.copy()
    if case == "no_valid":
        return base, base.copy(), np.zeros(n, bool), valid, angles, angles
    if case != "angle_gate":
        raise ValueError(f"case: {case!r}")
    gate = np.float32(0.26)
    k = np.arange(n) % 3
    off = np.where(k == 0, np.nextafter(gate, np.float32(0)),
                   np.where(k == 1, gate, np.nextafter(gate, np.float32(1))))
    ang_b = (angles + off).astype(np.float32)
    ang_b[::5] = np.float32(np.pi) - ang_b[::5]
    return base, base.copy(), valid, valid.copy(), angles, ang_b


def match_feats(seq, cfg, dev) -> list:
    """The card's line features of path 1's first MATCH_PAIRS + 1 quantized
    frames (K47's consecutive pairs)."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import lines as ln

    cam, factor = cfg.camera, cfg.camera.depth_map_factor
    feats = []
    for i in range(MATCH_PAIRS + 1):
        g8, d16 = quantize_frame(*seq.render(i), factor)
        feats.append(ln.extract_line_features(
            torch.from_numpy(g8.astype(np.float32)).to(dev),
            torch.from_numpy(d16.astype(np.float32)
                             / np.float32(factor)).to(dev), cam, cfg.lines))
    return feats


def match_lines_parity(seq, cfg, dev) -> list:
    """K47 (match_lines) bit-equal to its plain version on the card: on
    the line features of path 1's consecutive quantized frames (MATCH_PAIRS
    pairs) and every MATCH_PLANTED problem at B = 1 (twice) and the four of
    each set at B = 4 in one launch, lane by lane; its kernels row."""
    import torch

    from planarslam_tpu_torch.ops import lines as ln

    feats = match_feats(seq, cfg, dev)
    sets = {"frames": [tuple(x.contiguous() for x in (
        feats[i].desc, feats[i + 1].desc, feats[i].valid, feats[i + 1].valid,
        feats[i].angle, feats[i + 1].angle)) for i in range(MATCH_PAIRS)],
            "planted": [tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
                dev) for x in planted_match_problem(c))
                for c in MATCH_PLANTED]}
    matched = []
    for name, probs in sets.items():
        for k, args in enumerate(probs):
            got = _twice(ln.match_lines, *args)
            want = ln.match_lines_plain(*args)
            _check(same_bits(got, want), f"match_lines: {name} {k} differs "
                   f"from the plain version")
            if name == "frames":
                matched.append(int((got[0] >= 0).sum()))
        lanes = probs[:4]
        b4 = ln.match_lines(*[torch.stack(f) for f in zip(*lanes)])
        for b, args in enumerate(lanes):
            _check(same_bits([x[b] for x in b4], ln.match_lines(*args)),
                   f"match_lines: {name} lane {b} of B = 4 differs from its "
                   f"own launch")
    _check(min(matched) >= 3, f"match_lines: consecutive frames matched "
           f"{matched} lines")
    args = sets["frames"][0]
    A, D = args[0].shape
    B = args[1].shape[0]
    row = {"name": "match_lines", "route": "cuda", "library_ms": None,
           # the A x B similarities of D products and sums, the gates, the
           # two sorts of the adaptive gate
           **_bound(_nbytes(args) + 8 * A, 2.0 * A * B * D + 20.0 * A * B),
           "source": "planarslam_tpu_torch/csrc/line_lift_search.cu",
           "replaces": "planarslam_tpu/ops/lines.py:381",
           "max_abs_err": 0.0, "tolerance": "bit-equal",
           "frames_matched": matched,
           "ms": _time_ms(lambda: ln.match_lines(*args)),
           "plain_ms": _time_ms(lambda: ln.match_lines_plain(*args))}
    out = [row]
    _print_kernels(out)
    return out


SELECT_SHAPES = ((120, 160), (480, 640))  # the CPU test's frame, the path's


def select_stage_parity(dev, entry: dict) -> None:
    """K20's selection stage alone on the card (ops/lines.py::select_top_e,
    csrc/lines.cu::psl_lines_select) against lax_compat.top_k on the
    planted maps of planted_top_e_maps (a tie of 2000 below the E-th rank,
    fewer than E nonzero, all zero, a tie cut inside a band) at the CPU
    test's 120x160 and the path's 480x640, E = min(6144, h w), all maps of
    a size in one call: pixels and values bit-equal, two calls equal bits.
    The results join K20's report entry."""
    import torch

    from planarslam_tpu_torch.ops import lines as ln
    from planarslam_tpu_torch.ops.lax_compat import top_k

    res = {}
    for h, w in SELECT_SHAPES:
        E = min(ln.N_EDGE, h * w)
        maps = planted_top_e_maps(h, w, E)
        score = torch.from_numpy(np.stack(list(maps.values()))).to(dev)
        val, pix = ln.select_top_e(score, E)
        val2, pix2 = ln.select_top_e(score, E)
        want_val, want_pix = top_k(score.reshape(len(maps), -1), E)
        torch.cuda.synchronize()
        _check(torch.equal(val, val2) and torch.equal(pix, pix2),
               f"select_top_e {h}x{w}: two calls differ")
        for i, name in enumerate(maps):
            _check(torch.equal(pix[i].long(), want_pix[i])
                   and torch.equal(val[i], want_val[i]),
                   f"select_top_e {h}x{w} {name}: differs from top_k in "
                   f"{int((pix[i].long() != want_pix[i]).sum())} pixels")
        one = score[:1]
        res[f"{h}x{w}"] = {
            "maps": list(maps), "E": E,
            "ms": _time_ms(lambda: ln.select_top_e(one, E)),
            "top_k_ms": _time_ms(lambda: top_k(one.reshape(1, -1), E))}
    print(f"select_stage_parity: {json.dumps(res)}", flush=True)
    entry["select_stage"] = res


MATCH_WINDOW = 4096  # the local-map window's point slots (WIN_PTS)
# the matching launches of one tracking step (device_tracker._track_core):
# two projection searches, match_descriptors, the frame-match selection, the
# line and the point observations
MATCH_PER_STEP = {"project_landmarks": 2, "gated_hamming_top2": 3,
                  "match_select": 3, "frame_match_select": 1,
                  "assemble_observations": 2}


def _matching_problems(seq, cfg, dev, rng) -> dict:
    """K24-K27's inputs from frames 0 -> 1 of the 640x480 room on the card:
    frame 0's features with depth lifted at its true pose (the carried
    LastState) searched in frame 1 at frame 1's pose ("frame", radius 15,
    every level), and those landmarks tiled to the 4096 window slots,
    the copies moved by 1 cm, their descriptors perturbed, 70% valid, with
    viewing normals and distance ranges planted around the true ones so
    that some gates turn and levels 0 to 4 are predicted ("window", radius
    4, level window 1); frame 0's 64 lines lifted to world and tiled to
    the 256 window lines for frame 1's line search."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam import device_tracker as dt
    from planarslam_tpu_torch.slam.frame import extract_frame

    cam = cfg.camera

    def features(i):
        g8, d16 = quantize_frame(*seq.render(i), cam.depth_map_factor)
        return extract_frame(*dt.to_gray_depth(
            torch.from_numpy(g8).to(dev),
            torch.from_numpy(d16.astype(np.int32)).to(dev), cfg), cfg)

    def pose_cw(i):
        return torch.from_numpy(np.linalg.inv(seq.poses_wc[i]).astype(
            np.float32)).to(dev)

    def rand(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    f0, f1 = features(0), features(1)
    last = dt._state_from(f0, pose_cw(0), torch.eye(4, device=dev), cfg)
    kp = cfg.orb.max_keypoints
    reps = MATCH_WINDOW // kp
    shift = rand(rng.normal(0.0, 0.01, (reps, kp, 3)))
    shift[0] = 0.0
    pts = (last.pt3d_w[None] + shift).reshape(-1, 3)
    flips = rng.random((reps, kp, 8, 32)) < 0.03
    flips[0] = False
    words = (flips * (1 << np.arange(32, dtype=np.int64))).sum(-1)
    desc = (f0.points.desc[None] ^ rand(words.astype(np.uint32).view(
        np.int32), np.int32)).reshape(-1, 8)
    keep = rand(rng.random((reps, kp)) < 0.7, bool)
    keep[0] = True
    valid = (last.valid3d[None] & keep).reshape(-1)
    centre = rand(seq.poses_wc[1][:3, 3])
    vec = pts - centre
    dist = torch.linalg.norm(vec, dim=-1)
    normals = vec / dist[:, None] + rand(rng.normal(0.0, 0.5, (MATCH_WINDOW,
                                                                3)))
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    dmin = dist * rand(rng.uniform(0.5, 1.1, MATCH_WINDOW))
    dmax = dist * rand(rng.uniform(0.9, 2.5, MATCH_WINDOW))

    def world(p):
        T = rand(seq.poses_wc[0])
        return p @ T[:3, :3].T + T[:3, 3]

    lreps = LINE_WINDOW // cfg.lines.max_lines
    lines0 = f0.lines
    return {
        "f1": f1, "last": last, "T_cw": pose_cw(1),
        "frame": dict(pts_w=last.pt3d_w, descs=f0.points.desc,
                      valid=last.valid3d, radius=15.0,
                      level_window=cfg.orb.n_levels),
        "window": dict(pts_w=pts.contiguous(), descs=desc.contiguous(),
                       valid=valid.contiguous(), radius=4.0, level_window=1,
                       view_normals=normals.contiguous(),
                       dist_range=(dmin.contiguous(), dmax.contiguous())),
        "lines": (world(lines0.p3d_s).repeat(lreps, 1),
                  world(lines0.p3d_e).repeat(lreps, 1),
                  lines0.desc.repeat(lreps, 1),
                  (lines0.has_3d & lines0.valid).repeat(lreps))}


def hamming_step_problems(seq, cfg, dev) -> dict:
    """K3's launches of one tracking step at the main path's shapes, on
    _matching_problems' frames 0 -> 1: the frame search (1024 x 1024,
    gated), the window search (4096 x 1024, gated), match_descriptors'
    two directions (1024 x 1024 each, ungated; one launch where the tree
    has mutual_hamming_top2, else two), and the window search at B = 4
    lanes in one launch. Returns {name: fn}, fn() launching them."""
    import torch

    from planarslam_tpu_torch.ops import matching as mt

    cam = cfg.camera
    probs = _matching_problems(seq, cfg, dev, np.random.default_rng(24))
    p1, last, T_cw = probs["f1"].points, probs["last"], probs["T_cw"]
    out = {}
    for case in ("frame", "window"):
        c = probs[case]
        proj = mt.project_landmarks(
            c["pts_w"][None], c["valid"][None], T_cw[None],
            K=(cam.fx, cam.fy, cam.cx, cam.cy),
            image_wh=(float(cam.width), float(cam.height)), bf=cam.bf,
            scale_factor=cfg.orb.scale_factor, radius=c["radius"],
            view_normals=None if case == "frame" else c["view_normals"][None],
            dist_range=None if case == "frame" else tuple(
                d[None] for d in c["dist_range"]))
        gate = mt.ProjGate(*proj[:4], p1.uv[None], p1.level[None],
                           p1.u_right[None], c["level_window"])
        args = (c["descs"][None], p1.desc[None], proj.gate_pt, p1.valid[None])
        out[case] = (lambda a=args, g=gate: mt.gated_hamming_top2(*a, g))
        if case == "window":
            a4 = [torch.cat([x] * 4).contiguous() for x in args]
            g4 = mt.ProjGate(*[torch.cat([x] * 4).contiguous()
                               for x in gate[:-1]], gate.level_window)
            out["window_b4"] = (lambda a=a4, g=g4:
                                mt.gated_hamming_top2(*a, g))
    da, db = last.feats.points.desc[None], p1.desc[None]
    va, vb = last.valid3d[None], p1.valid[None]
    if hasattr(mt, "mutual_hamming_top2"):
        out["descriptors"] = lambda: mt.mutual_hamming_top2(da, db, va, vb)
    else:
        out["descriptors"] = lambda: (
            *mt.gated_hamming_top2(da, db, va, vb),
            mt.gated_hamming_top2(db, da, vb, va)[2])
    return out


def kernel_timing_entry(fn, match: str) -> dict:
    """One kernel problem's times: ms per wrapper call (CUDA events) and
    its device ms per call under the profiler (launches whose kernel name
    holds `match`), with the launches per call, and by kernel name."""
    split = _launch_split(fn, match=match)
    return {"ms": _time_ms(fn),
            "device_ms": sum(v["ms"] for v in split.values()),
            "launches": sum(v["calls"] for v in split.values()),
            "device_ms_by_kernel": {k: v["ms"] for k, v in split.items()}}


def components_inputs(seq, cfg, dev):
    """K12's inputs at the main path's shapes: K4's block moments of frame
    0 of `seq` (lane 0) and of path 5's lane sequences 1-7, quantized, in
    one batch of 8. Returns (stats, hb, wb)."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import planes as P

    pc, cam = cfg.planes, cfg.camera
    factor = cam.depth_map_factor
    depths = []
    for b in range(8):
        s = seq if b == 0 else _lane_sequence(cfg, b)
        _, d16 = quantize_frame(*s.render(0), factor)
        depths.append(d16.astype(np.float32) / np.float32(factor))
    depth = torch.from_numpy(np.stack(depths)).to(dev)
    h, w = depth.shape[-2:]
    alpha = P._noise_alpha(depth, pc.max_distance)
    stats = P.plane_block_moments(depth, alpha, cam, P._geo_tol(w),
                                  pc.max_distance, pc.block)
    return stats, h // pc.block, w // pc.block


def components_problems(seq, cfg, dev) -> dict:
    """K12 on components_inputs: lane 0 alone ("b1") and all eight lanes
    in one launch ("b8"). Returns {name: fn}, fn() launching it."""
    from planarslam_tpu_torch.ops import planes as P

    pc = cfg.planes
    stats, hb, wb = components_inputs(seq, cfg, dev)
    one = P._BlockStats(*[x[:1].contiguous() for x in stats])
    return {"b1": lambda: P.plane_components(one, hb, wb, pc),
            "b8": lambda: P.plane_components(stats, hb, wb, pc)}


def _distinct(idx) -> int:
    """Distinct non-negative entries of idx: the rows a gather reads."""
    import torch

    return int(torch.unique(idx[idx >= 0]).numel())


def _clashes(idx, n: int) -> int:
    """Targets that more than one row of idx is matched to."""
    import torch

    hits = torch.bincount(idx[idx >= 0].long(), minlength=n)
    return int((hits > 1).sum())


# K25's planted cases: every row on one target at one distance, equal least
# distances on rows i and i + 1024 (one thread of the first K25 held
# both), no row passing max_dist, best exactly ratio x second in float32,
# a best_idx of -1 and of n and above, n = MAX_TARGETS, M = 1, 1025 and
# 5000, distances below 0 and above 16383 (the resolution's 64-bit keys)
SELECT_PLANTED = ("one_target", "stride_ties", "none_pass", "ratio_edge",
                  "mutual_range", "max_targets", "odd_rows", "wide_keys")


def _ratio_edges(ratio: float, top: int = 256) -> list:
    """(best, second) pairs with float(best) == float32(ratio) *
    float(second) in float32, which the strict ratio test rejects."""
    r = np.float32(ratio)
    out = []
    for sec in range(1, top + 1):
        prod = r * np.float32(sec)
        if prod == np.floor(prod):
            out.append((int(prod), sec))
    return out


def planted_select_problem(case: str, seed: int = 25) -> list:
    """The K25 problems of a SELECT_PLANTED case as numpy arrays: a list
    of dicts with best, second, best_idx (M,) int32, back (N,) int32 or
    None, max_dist, ratio (or None) and n_targets (or None), the modes of
    the tracking step's three launches (the searches resolve duplicates,
    match_descriptors takes the ratio test and the mutual check)."""
    rng = np.random.default_rng(seed)
    out = []

    def add(best, second, best_idx, max_dist=100, ratio=None, back=None,
            n_targets=None):
        out.append({"best": np.asarray(best, np.int32),
                    "second": np.asarray(second, np.int32),
                    "best_idx": np.asarray(best_idx, np.int32),
                    "back": None if back is None else np.asarray(back,
                                                                 np.int32),
                    "max_dist": max_dist, "ratio": ratio,
                    "n_targets": n_targets})

    def fill(m, lo_t, hi_t):
        best = rng.integers(0, 130, m)
        return best, best + rng.integers(0, 40, m), rng.integers(lo_t, hi_t,
                                                                 m)

    if case == "one_target":
        m, n = 4096, 1024
        best = np.full(m, int(rng.integers(0, 100)))
        second = best + rng.integers(0, 60, m)
        idx = np.full(m, int(rng.integers(0, n)))
        add(best, second, idx, n_targets=n)
        add(best, second, idx, ratio=0.8, n_targets=n)
    elif case == "stride_ties":
        m, n = 4096, 1024
        best, second, idx = fill(m, 0, n - 64)
        rows = rng.permutation(1024)[:64]
        for k, i in enumerate(rows):
            d = int(rng.integers(0, 60))
            idx[[i, i + 1024, i + 2048, i + 3072]] = n - 64 + k
            best[[i + 1024, i + 3072]] = d
            best[[i, i + 2048]] = d if k % 2 == 0 else d + 1
        add(best, second, idx, n_targets=n)
    elif case == "none_pass":
        m, n = 4096, 1024
        best = rng.integers(101, 300, m)
        add(best, best + rng.integers(0, 40, m), rng.integers(0, n, m),
            n_targets=n)
        best = rng.integers(51, 200, 1024)
        add(best, best + rng.integers(0, 40, 1024),
            rng.permutation(1024), max_dist=50, ratio=0.9,
            back=np.argsort(rng.permutation(1024)))
    elif case == "ratio_edge":
        m = n = 1024
        for ratio, max_dist, mutual in ((0.9, 50, True), (0.8, 100, False)):
            edges = [e for e in _ratio_edges(ratio) if e[0] <= max_dist]
            pick = rng.integers(0, len(edges), m)
            best = np.array([edges[k][0] for k in pick])
            second = np.array([edges[k][1] for k in pick])
            best = np.where(np.arange(m) % 2 == 1, best - 1, best)
            idx = rng.permutation(n)
            back = np.argsort(idx) if mutual else None
            add(best, second, idx, max_dist, ratio, back,
                None if mutual else n)
    elif case == "mutual_range":
        m = n = 1024
        best = rng.integers(0, 40, m)
        second = best + 100
        idx = rng.permutation(n)
        back = np.argsort(idx)
        r0 = int(back[n - 1])          # row r0 and column n - 1: mutual
        rows = [r for r in rng.permutation(m)[:6] if r != r0][:4]
        idx[rows] = [-1, n, n + 5, -1]
        add(best, second, idx, 50, 0.9, back)
        # duplicates resolved over rows with a best_idx of -1 that pass
        # their test (parked in slot n as the plain version parks them)
        # and of n: their least distance below the parked ones' (the first
        # such row kept), then above (none kept)
        for parked, near in ((5, [8, 3, 5, 3]), (2, [8, 3, 5, 4])):
            best, second, idx = fill(m, 0, n)
            rows = rng.permutation(m)[:8]
            idx[rows[:4]] = -1
            idx[rows[4:]] = n
            best[rows[:4]] = parked + np.arange(4)
            best[rows[4:]] = near
            add(best, second, idx, n_targets=n)
    elif case == "max_targets":
        m, n = 4096, 6143
        best, second, idx = fill(m, 0, n)
        idx[rng.permutation(m)[:40]] = n - 1
        idx[rng.permutation(m)[:40]] = 0
        add(best, second, idx, n_targets=n)
    elif case == "wide_keys":
        n = 1024
        for m in (1024, 4096):
            best = rng.integers(-40, 20000, m)
            best[rng.permutation(m)[:m // 8]] = 10000  # INF_DIST
            best[rng.permutation(m)[:m // 8]] = 10001
            idx = rng.integers(0, n // 2, m)
            add(best, best + 1, idx, max_dist=30000, n_targets=n)
    elif case == "odd_rows":
        n = 1024
        for m in (1, 1025, 5000):  # 5000: rows beyond a thread's registers
            best, second, idx = fill(m, 0, n)
            add(best, second, idx, n_targets=n)
            add(best, second, idx, ratio=0.8, n_targets=n)
        best, second, idx = fill(1025, 0, n)
        back = rng.integers(0, 1025, n)
        back[idx[:600]] = np.arange(600)
        add(best, second, idx, 50, 0.9, back)
    return out


def planted_select_lanes(case: str, batch: int, seed: int = 25) -> list:
    """planted_select_problem of seeds seed .. seed + batch - 1, each
    problem's arrays stacked on a leading lane dimension."""
    lanes = [planted_select_problem(case, seed + b) for b in range(batch)]
    out = []
    for probs in zip(*lanes):
        p = dict(probs[0])
        for k in ("best", "second", "best_idx", "back"):
            if p[k] is not None:
                p[k] = np.stack([q[k] for q in probs])
        out.append(p)
    return out


def _select_args(p: dict, dev) -> tuple:
    """match_select's (args, kwargs) for a planted_select_lanes problem."""
    import torch

    args = [torch.from_numpy(p[k]).to(dev)
            for k in ("best", "second", "best_idx")]
    kw = {"max_dist": p["max_dist"], "ratio": p["ratio"],
          "n_targets": p["n_targets"],
          "back": None if p["back"] is None
          else torch.from_numpy(p["back"]).to(dev)}
    return args, kw


def select_lane(args: list, kw: dict, b: int) -> tuple:
    """Lane b of match_select's batched (args, kwargs), a batch of one."""
    back = kw["back"]
    if back is not None:
        back = back[b:b + 1].contiguous()
    return [a[b:b + 1].contiguous() for a in args], dict(kw, back=back)


def select_planted_parity(dev) -> dict:
    """K25 on every SELECT_PLANTED problem: bit-equal to its plain version,
    two launches equal bits, one launch a call, no target matched twice
    where duplicates are resolved; each also at B = 4 (four seeds) in one
    launch, each lane bit-equal to its B = 1 launch. Returns per case the
    matches and what the case plants."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import matching as mt

    out = {}
    for case in SELECT_PLANTED:
        rec = []
        for p in planted_select_lanes(case, 4):
            args4, kw4 = _select_args(p, dev)
            ones = []
            for b in range(4):
                args, kw = select_lane(args4, kw4, b)
                n0 = kernels.LAUNCHES["match_select"]
                got = mt.match_select(*args, **kw)
                _check(kernels.LAUNCHES["match_select"] == n0 + 1,
                       f"match_select ({case}): not one launch a call")
                again = mt.match_select(*args, **kw)
                want = mt.match_select_plain(
                    *[a[0] for a in args], kw["max_dist"], kw["ratio"],
                    None if kw["back"] is None else kw["back"][0],
                    kw["n_targets"])
                torch.cuda.synchronize()
                _check(all(torch.equal(x, y) for x, y in zip(got, again)),
                       f"match_select ({case}): two launches differ")
                _check(all(torch.equal(x[0], y) for x, y in zip(got, want)),
                       f"match_select ({case}, lane {b}): differs from the "
                       f"plain version in {int((got[0][0] != want[0]).sum())}"
                       f" indices, {int((got[1][0] != want[1]).sum())} "
                       f"distances")
                ones.append(got)
            n0 = kernels.LAUNCHES["match_select"]
            got4 = mt.match_select(*args4, **kw4)
            _check(kernels.LAUNCHES["match_select"] == n0 + 1,
                   f"match_select ({case}, B = 4): not one launch")
            torch.cuda.synchronize()
            for b, one in enumerate(ones):
                _check(all(torch.equal(x[b], y[0]) for x, y in zip(got4, one)),
                       f"match_select ({case}): lane {b} of B = 4 differs "
                       f"from its B = 1 launch")
            idx = ones[0][0][0]
            n = p["n_targets"] or p["back"].shape[-1]
            rec.append({"M": int(idx.shape[0]), "n": n,
                        "matches": int((idx >= 0).sum()),
                        "clashes": _clashes(idx, n + 1)
                        if p["n_targets"] else None, "idx": idx})
        out[case] = rec
    summary = {c: [{k: v for k, v in r.items() if k != "idx"} for r in rec]
               for c, rec in out.items()}
    one = out["one_target"]
    lo = planted_select_problem("stride_ties")
    st = out["stride_ties"][0]["idx"].cpu().numpy()
    pairs = [(i, int(lo[0]["best_idx"][i]))
             for i in range(1024) if lo[0]["best_idx"][i] >= 1024 - 64]
    mr = planted_select_problem("mutual_range")[0]["best_idx"]
    got_mr = out["mutual_range"][0]["idx"].cpu().numpy()
    _check(one[0]["matches"] == 1 and int(one[0]["idx"][0]) >= 0
           and one[1]["matches"] <= 1
           and all(st[i] == t or st[i + 1024] == t for i, t in pairs)
           and all(st[i + 2048] != t and st[i + 3072] != t
                   for i, t in pairs)
           and all(r["matches"] == 0 for r in out["none_pass"])
           and all(r["matches"] == r["M"] // 2 for r in out["ratio_edge"])
           and not bool((got_mr[(mr < 0) | (mr >= 1024)] >= 0).any())
           and out["mutual_range"][0]["matches"] > 100
           and int((out["mutual_range"][1]["idx"] == 1024).sum()) == 1
           and int((out["mutual_range"][2]["idx"] == 1024).sum()) == 0
           and out["max_targets"][0]["matches"] > 100
           and all(r["matches"] > 50 for r in out["wide_keys"])
           and all(r["clashes"] in (None, 0) for rec in out.values()
                   for r in rec),
           f"match_select: the planted cases do not exercise it: {summary}")
    return summary


@contextlib.contextmanager
def poisoned_outputs(module, name: str):
    """module.name, an output allocator (shape, dtype, device) of a kernel
    wrapper, handing out tensors filled with NaN (floats) or 0x7f bytes
    (integers and bools, a value no output takes): a launch whose outputs
    equal the plain version's wrote every entry."""
    import torch

    real = getattr(module, name)

    def filled(shape, dtype, dev):
        t = real(shape, dtype, dev)
        if t.dtype.is_floating_point:
            t.fill_(math.nan)
        else:
            t.view(torch.uint8).fill_(0x7F)
        return t

    setattr(module, name, filled)
    try:
        yield
    finally:
        setattr(module, name, real)


def same_bits(got, want) -> bool:
    """Every output of two launches (or of a launch and its plain version)
    bit-equal (_bit_diff's int32 bits; a NaN matches only its own bits)."""
    return all(_bit_diff(x, y, as_int=True) == 0 for x, y in zip(got, want))


# K26's planted cases: every match at rotation 0 (+0 and -0), rotations
# just below 0 (bin 29, down to where rot + 2 pi rounds to 2 pi), at k 2 pi
# / 30 and one float either side, ties at the first, second and third
# place (a fourth bin tied with the third), second and third bins at
# exactly 10% of the first in float32 and one below, fewer than 3
# non-empty bins, one match and none, 19 and 20 projection matches
# (MIN_PROJ_MATCHES), M = 1, 33 and 1024 against N = 600 and 1024, and the
# filter mode at M = 1, 1024, 4096 and 5000
FRAME_PLANTED = ("zero_rotation", "below_zero", "bin_edges", "ties",
                 "ten_percent", "few_bins", "min_proj", "sizes", "filter")
TWO_PI = 2.0 * math.pi
# rotations just below 0 (as -delta); those below 2.4e-7 round to 2 pi
# when shifted
BELOW_ZERO = np.array([1e-8, 5e-8, 1e-7, 2e-7, 2.3e-7, 2.4e-7, 2.5e-7, 3e-7,
                       4.7e-7, 5e-7, 1e-6, 1e-5, 1e-3, 0.05, 0.2, 1e-30],
                      np.float32)


def rotation_bin_edges() -> np.ndarray:
    """float32 k 2 pi / 30 (k = 0 .. 30) and the float on either side,
    those in [0, float32 2 pi)."""
    f = np.float32
    r = []
    for k in range(31):
        x = f(k * TWO_PI / 30)
        r += [np.nextafter(x, f(-1)), x, np.nextafter(x, f(10))]
    r = np.array(r, f)
    return r[(r >= 0) & (r < f(TWO_PI))]


def rotation_edge_values() -> np.ndarray:
    """The 270 float32 rotations of rotation_bin_edges() as they are, less
    float32 2 pi (through jnp.mod's shift of a negative remainder) and
    plus it (through its remainder)."""
    f = np.float32
    e = rotation_bin_edges()
    return np.concatenate([e, (e - f(TWO_PI)).astype(f),
                           (e + f(TWO_PI)).astype(f)])


# JAX's jitted bins of rotation_edge_values() (planarslam_tpu/ops/
# matching.py::rotation_histogram_filter on the CPU), recorded and held by
# tests/test_torch_matching_kernels.py::test_rotation_bin_float_forms
JAX_EDGE_BINS = tuple(int(x) for x in (
    "0,0,0,1,1,1,2,2,2,3,3,3,4,4,4,5,5,5,6,6,6,7,7,7,8,8,8,9,9,9,10,10,10,"
    "11,11,11,12,12,12,13,13,13,14,14,14,15,15,15,16,16,16,17,17,17,18,18,"
    "18,19,19,19,20,20,20,20,21,21,22,22,22,22,23,23,24,24,24,24,25,25,26,"
    "26,26,26,27,27,28,28,28,28,29,29,0,0,0,1,1,2,2,2,2,2,3,4,4,4,4,5,5,6,"
    "6,6,6,6,7,8,8,8,8,9,9,10,10,10,10,11,11,11,12,12,12,13,13,13,14,14,14,"
    "15,15,15,16,16,16,17,17,17,18,18,18,19,19,19,20,20,20,20,21,21,22,22,"
    "22,22,23,23,24,24,24,24,25,25,26,26,26,26,27,27,28,28,28,28,29,29,0,0,"
    "0,1,1,2,2,2,2,2,3,4,4,4,4,5,5,6,6,6,6,6,7,8,8,8,9,9,9,10,10,10,10,10,"
    "11,11,11,12,13,13,13,14,14,14,14,14,14,15,16,16,16,17,17,18,18,18,18,"
    "18,19,19,19,20,20,21,21,21,22,22,22,22,22,23,24,24,24,24,25,26,26,26,"
    "26,26,27,27,27,28,28,29,29,29").split(","))
# denormal rotations: JAX on the CPU flushes them to 0, bin 0
DENORMAL_ROTATIONS = np.array([-1e-40, 1e-40, -1e-45], np.float32)


def card_rotation_bins(rot) -> np.ndarray:
    """The bins K26 and its plain version give float32 rotations (numpy
    float32, one rounding an operation): a denormal taken as 0, jnp.mod,
    then one product with float32(30) / float32(2 pi), the form of JAX's
    jitted rot * 30 / 2 pi, truncated and clamped."""
    f = np.float32
    rot = np.asarray(rot, f)
    rot = np.where(np.abs(rot) < np.finfo(f).tiny, f(0), rot)
    r = np.fmod(rot, f(TWO_PI))
    r = np.where((r != 0) & (r < 0), (r + f(TWO_PI)).astype(f), r)
    scaled = r.astype(f) * (f(30) / f(TWO_PI))
    return np.clip(scaled.astype(np.int64), 0, 29)


def edge_bin_probe(values, bins) -> dict:
    """K26 filter-mode problems that read the bin of each rotation in
    `values` and hold it to `bins`: per value two lanes of 31 rows, the
    value's row and 10 rows at the centre of each of three bins, (e, e + 1,
    e + 2) and (e, e - 1, e - 2) modulo 30 for the expected bin e. The
    value's row is kept in both lanes exactly when its bin is e. Returns
    the stacked filter inputs (2 V lanes) and which lanes hold e + 1."""
    f = np.float32
    values = np.asarray(values, f)
    n = len(values)
    a_src = np.zeros((2 * n, 31), f)
    for i, (v, e) in enumerate(zip(values, bins)):
        for side, sign in ((0, 1), (1, -1)):
            lane = a_src[2 * i + side]
            lane[0] = v
            fill = [(e + sign * k) % 30 for k in range(3)]
            lane[1:] = np.repeat([(k + 0.5) * TWO_PI / 30 for k in fill], 10)
    return {"angle_src": a_src, "angle_tgt": np.zeros_like(a_src),
            "valid": np.ones(a_src.shape, bool)}


def card_keep_reference(angle_src, angle_tgt, valid) -> np.ndarray:
    """The rows K26's rotation histogram keeps on the card, in numpy: the
    bins of card_rotation_bins, the three largest counts with ties to the
    lower bin, the second and third kept at >= float32(0.1) x the first
    (one rounding)."""
    f = np.float32
    with np.errstate(all="ignore"):
        bins = card_rotation_bins((np.asarray(angle_src, f)
                                   - np.asarray(angle_tgt, f)).astype(f))
    counts = np.bincount(bins[valid], minlength=30)
    top = sorted(range(30), key=lambda k: (-counts[k], k))[:3]
    tenth = f(0.1) * f(counts[top[0]])
    kept = [top[0]] + [k for k in top[1:] if f(counts[k]) >= tenth]
    return valid & np.isin(bins, kept)


def planted_frame_problem(case: str, seed: int = 26) -> list:
    """The K26 problems of a FRAME_PLANTED case as numpy arrays: a list of
    dicts, frame mode with proj_idx, bf_idx (M,) int32, angle_src (M,),
    angle_tgt (N,), uv_tgt (N, 2), ur_tgt (N,) float32 and level_tgt (N,)
    int32, filter mode with angle_src, angle_tgt (M,) and valid (M,) bool;
    "expect", the matches kept by design (None where a bin edge decides).
    Matches take distinct rows and targets; a match of a planted exact
    rotation r has angle_src = r and a target angle of 0 (r - 0 = r
    exactly), one in a bin k a rotation of k + U(0.25, 0.75) bins."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    edges = rotation_bin_edges()
    out = []

    def rotations(groups):
        """(rotation, exact) per match of groups: ("bin", k, count),
        ("exact", values), ("zero", count: angle_src == angle_tgt)."""
        rot, exact = [], []
        for g in groups:
            if g[0] == "bin":
                rot += list((g[1] + rng.uniform(0.25, 0.75, g[2]))
                            * TWO_PI / 30)
                exact += [0] * g[2]
            elif g[0] == "exact":
                rot += list(np.asarray(g[1], f32))
                exact += [1] * len(g[1])
            else:
                rot += [0.0] * g[1]
                exact += [2] * g[1]
        return np.asarray(rot, np.float64), np.asarray(exact)

    def place(a_src, a_tgt, rows, tgts, rot, exact):
        c = a_tgt[tgts].astype(np.float64)
        a_tgt[tgts] = np.where(exact == 1, 0.0, a_tgt[tgts])
        a_src[rows] = np.where(exact == 1, rot.astype(f32),
                               np.where(exact == 2, a_tgt[tgts],
                                        (c + rot).astype(f32)))

    def frame(groups, bf_groups=(), m=1024, n=1024, expect=None):
        rot_p, ex_p = rotations(groups)
        rot_b, ex_b = rotations(bf_groups)
        n_p, n_b = len(rot_p), len(rot_b)
        assert n_p + n_b <= min(m, n)
        rows, tgts = rng.permutation(m), rng.permutation(n)
        a_src = rng.uniform(-math.pi, math.pi, m).astype(f32)
        a_tgt = rng.uniform(-math.pi, math.pi, n).astype(f32)
        proj = np.full(m, -1, np.int32)
        bf = np.full(m, -1, np.int32)
        proj[rows[:n_p]] = tgts[:n_p]
        bf[rows[n_p:n_p + n_b]] = tgts[n_p:n_p + n_b]
        place(a_src, a_tgt, rows[:n_p], tgts[:n_p], rot_p, ex_p)
        place(a_src, a_tgt, rows[n_p:n_p + n_b], tgts[n_p:n_p + n_b],
              rot_b, ex_b)
        uv = rng.uniform(0, [640, 480], (n, 2)).astype(f32)
        ur = np.where(rng.random(n) < 0.7, uv[:, 0] - rng.uniform(5, 40, n),
                      -1.0).astype(f32)
        out.append({"mode": "frame", "proj_idx": proj, "bf_idx": bf,
                    "angle_src": a_src, "angle_tgt": a_tgt, "uv_tgt": uv,
                    "ur_tgt": ur,
                    "level_tgt": rng.integers(0, 8, n).astype(np.int32),
                    "expect": expect})

    def filt(groups, m, expect=None):
        rot, ex = rotations(groups)
        k = len(rot)
        rows = rng.permutation(m)[:k]
        a_src = rng.uniform(-math.pi, math.pi, m).astype(f32)
        a_tgt = rng.uniform(-math.pi, math.pi, m).astype(f32)
        place(a_src, a_tgt, rows, rows, rot, ex)
        valid = np.zeros(m, bool)
        valid[rows] = True
        out.append({"mode": "filter", "angle_src": a_src,
                    "angle_tgt": a_tgt, "valid": valid, "expect": expect})

    rand = [("bin", 16, 60), ("bin", 23, 40)]  # brute-force matches unused
    if case == "zero_rotation":
        frame([("zero", 500), ("exact", [-0.0] * 100), ("bin", 7, 80),
               ("bin", 20, 10)], rand, expect=680)
        frame([("zero", 300), ("exact", [-0.0] * 300)], rand, expect=600)
    elif case == "below_zero":
        frame([("exact", np.repeat(-BELOW_ZERO, 20)), ("bin", 0, 100),
               ("bin", 14, 60)], rand, expect=480)
        frame([("exact", np.repeat(-BELOW_ZERO, 3)), ("bin", 3, 200)], rand,
              expect=248)
    elif case == "bin_edges":
        # bins 1, 10 and 20 kept: the edges at k = 1, 2, 10, 11, 20, 21
        # decide; then bins 14-16 (pi, 16 and 17 2 pi / 30 on their edges)
        frame([("bin", 1, 400), ("bin", 10, 60), ("bin", 20, 45),
               ("exact", np.repeat(edges, 2))], rand)
        frame([("bin", 14, 300), ("bin", 15, 100), ("bin", 16, 40),
               ("exact", np.repeat(edges, 3))], rand[:1])
        # the 270 edge values (through jnp.mod's shift and remainder) and
        # the denormal rotations
        frame([("bin", 3, 450), ("bin", 19, 60), ("bin", 26, 50),
               ("exact", np.concatenate([rotation_edge_values(),
                                         DENORMAL_ROTATIONS]))], rand[:1])
    elif case == "ties":
        frame([("bin", 7, 80), ("bin", 3, 80), ("bin", 12, 30),
               ("bin", 25, 30), ("bin", 28, 30)], rand, expect=190)
        frame([("bin", 15, 100), ("bin", 9, 40), ("bin", 4, 40),
               ("bin", 20, 39), ("bin", 22, 39)], rand, expect=180)
        frame([("bin", k, 10) for k in range(30)], rand[:1], expect=30)
    elif case == "ten_percent":
        for groups, expect in (
                ([("bin", 5, 200), ("bin", 12, 20), ("bin", 22, 19)], 220),
                ([("bin", 0, 100), ("bin", 29, 10), ("bin", 14, 9)], 110),
                ([("bin", 8, 250), ("bin", 2, 25), ("bin", 27, 24)], 275),
                ([("bin", 3, 25), ("bin", 17, 3), ("bin", 9, 2)], 28),
                ([("bin", 11, 30), ("bin", 6, 3), ("bin", 26, 3)], 36)):
            frame(groups, rand, expect=expect)
    elif case == "few_bins":
        frame([("bin", 6, 300)], rand, expect=300)
        frame([("bin", 6, 300), ("bin", 13, 50)], rand, expect=350)
        frame([("bin", 4, 1)], [("bin", 9, 1)], expect=1)
        frame([], [], expect=0)
        frame([("bin", 4, 1)], [], expect=0)
    elif case == "min_proj":
        bf = [("bin", 5, 200), ("bin", 18, 50)]
        frame([("bin", 2, 19)], bf, expect=250)
        frame([("bin", 2, 20)], bf, expect=20)
    elif case == "sizes":
        for m, n in ((1, 600), (1, 1024), (33, 600), (33, 1024),
                     (1024, 600)):
            if m == 1:
                frame([], [("bin", 3, 1)], m, n, expect=1)
            elif m == 33:
                frame([("bin", 3, 20), ("bin", 10, 5)], [("bin", 7, 8)], m,
                      n, expect=25)
            else:
                frame([("bin", 1, 350), ("bin", 2, 100), ("bin", 25, 10)],
                      rand, m, n, expect=450)
    elif case == "filter":
        filt([("bin", 5, 1)], 1, expect=1)
        filt([("bin", 1, 300), ("bin", 2, 100), ("bin", 20, 40),
              ("exact", np.repeat(edges, 2))], 1024)
        filt([("bin", 28, 2000), ("bin", 0, 500), ("bin", 14, 199),
              ("exact", np.repeat(-BELOW_ZERO, 10))], 4096, expect=2500)
        filt([("bin", 10, 3000), ("bin", 11, 300), ("bin", 12, 299),
              ("bin", 13, 299)], 5000, expect=3300)
        # the 270 edge values and the denormal rotations
        filt([("bin", 3, 450), ("bin", 19, 60), ("bin", 26, 50),
              ("exact", np.concatenate([rotation_edge_values(),
                                        DENORMAL_ROTATIONS]))], 1024)
    return out


def planted_frame_lanes(case: str, batch: int, seed: int = 26) -> list:
    """planted_frame_problem of seeds seed .. seed + batch - 1, each
    problem's arrays stacked on a leading lane dimension."""
    lanes = [planted_frame_problem(case, seed + b) for b in range(batch)]
    out = []
    for probs in zip(*lanes):
        p = dict(probs[0])
        for k, v in p.items():
            if isinstance(v, np.ndarray):
                p[k] = np.stack([q[k] for q in probs])
        out.append(p)
    return out


FRAME_KEYS = ("proj_idx", "bf_idx", "angle_src", "angle_tgt", "uv_tgt",
              "ur_tgt", "level_tgt")
FILTER_KEYS = ("angle_src", "angle_tgt", "valid")


def frame_call(p: dict, dev, table):
    """The K26 wrapper call of a planted_frame_lanes problem: a function
    of no argument launching it (B lanes in one launch), and its plain
    version's outputs lane by lane (a list of B tuples)."""
    import torch

    from planarslam_tpu_torch.ops import matching as mt

    if p["mode"] == "filter":
        args = [torch.from_numpy(p[k]).to(dev) for k in FILTER_KEYS]
        return ((lambda: (mt.rotation_histogram_filter(*args),)),
                lambda: [(mt.rotation_histogram_filter_plain(
                    *[a[b] for a in args]),)
                         for b in range(args[0].shape[0])])
    args = [torch.from_numpy(p[k]).to(dev) for k in FRAME_KEYS]
    return ((lambda: mt.frame_match_select(*args, table)),
            lambda: [mt.frame_match_select_plain(*[a[b] for a in args],
                                                 table)
                     for b in range(args[0].shape[0])])


def frame_planted_parity(dev, table) -> dict:
    """K26 on every FRAME_PLANTED problem: bit-equal to its plain version,
    two launches equal bits, one launch a call, every output written (each
    call also into outputs filled with NaN, poisoned_outputs), the kept
    matches as the case plants them; each also at B = 4 (four seeds) in
    one launch, each lane bit-equal to its B = 1 launch. Returns per case
    the problems' sizes and kept matches."""
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import matching as mt

    out = {}
    for case in FRAME_PLANTED:
        rec = []
        for p in planted_frame_lanes(case, 4):
            ones = []
            for b in range(4):
                lane = {k: v[b:b + 1] if isinstance(v, np.ndarray) else v
                        for k, v in p.items()}
                fn, plain = frame_call(lane, dev, table)
                n0 = kernels.LAUNCHES["frame_match_select"]
                got = fn()
                _check(kernels.LAUNCHES["frame_match_select"] == n0 + 1,
                       f"frame_match_select ({case}): not one launch a call")
                again = fn()
                with poisoned_outputs(mt, "_out"):
                    filled = fn()
                want = plain()[0]
                _check(same_bits(got, again) and same_bits(got, filled),
                       f"frame_match_select ({case}, lane {b}): two "
                       f"launches differ, or an output was left unwritten")
                _check(same_bits([x[0] for x in got], want),
                       f"frame_match_select ({case}, lane {b}): differs "
                       f"from the plain version in "
                       f"{int((got[0][0] != want[0]).sum())} rows")
                ones.append(got)
            fn, _ = frame_call(p, dev, table)
            n0 = kernels.LAUNCHES["frame_match_select"]
            got4 = fn()
            _check(kernels.LAUNCHES["frame_match_select"] == n0 + 1,
                   f"frame_match_select ({case}, B = 4): not one launch")
            for b, one in enumerate(ones):
                _check(same_bits([x[b] for x in got4], [x[0] for x in one]),
                       f"frame_match_select ({case}): lane {b} of B = 4 "
                       f"differs from its B = 1 launch")
            kept = [int(x.sum()) for x in (got4[0] >= 0 if p["mode"] ==
                                           "frame" else got4[0])]
            for b in range(4):
                if p["mode"] == "filter":
                    ref = card_keep_reference(*[p[k][b] for k in FILTER_KEYS])
                else:
                    proj, bf = p["proj_idx"][b], p["bf_idx"][b]
                    ff = bf if (proj >= 0).sum() < mt.MIN_PROJ_MATCHES \
                        else proj
                    ref = card_keep_reference(
                        p["angle_src"][b], p["angle_tgt"][b][np.clip(
                            ff, 0, p["angle_tgt"].shape[1] - 1)], ff >= 0)
                got_keep = (got4[0][b] >= 0 if p["mode"] == "frame"
                            else got4[0][b]).cpu().numpy()
                _check(np.array_equal(got_keep, ref),
                       f"frame_match_select ({case}, lane {b}): the kept rows"
                       f" differ from card_keep_reference's in "
                       f"{int((got_keep != ref).sum())}")
            rec.append({"mode": p["mode"], "M": int(p["angle_src"].shape[1]),
                        "kept": kept, "expect": p["expect"]})
        out[case] = rec
    _check(all(r["expect"] is None or r["kept"] == [r["expect"]] * 4
               for rec in out.values() for r in rec)
           and all(min(r["kept"]) > 400 for r in out["bin_edges"]),
           f"frame_match_select: the planted cases do not exercise it: {out}")
    return out


def edge_bin_parity(dev) -> dict:
    """The bins of the 270 edge values (rotation_edge_values) and the
    denormal rotations on the card equal JAX's (JAX_EDGE_BINS, 0 for a
    denormal): the plain version's (matching.rotation_bins) directly, K26's
    through its filter mode (edge_bin_probe: every value's row kept in both
    of its lanes, one launch for all of them), which also holds K26's kept
    rows to its plain version's."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import matching as mt

    values = np.concatenate([rotation_edge_values(), DENORMAL_ROTATIONS])
    want = np.array(JAX_EDGE_BINS + (0,) * len(DENORMAL_ROTATIONS))
    v = torch.from_numpy(values).to(dev)
    plain = mt.rotation_bins(v, torch.zeros_like(v)).cpu().numpy()
    _check(np.array_equal(plain, want), f"rotation_bins on the card differ "
           f"from JAX's at {np.flatnonzero(plain != want).tolist()}")
    _check(np.array_equal(card_rotation_bins(values), want),
           "card_rotation_bins differs from JAX's bins")
    probe = edge_bin_probe(values, want)
    args = [torch.from_numpy(probe[k]).to(dev) for k in FILTER_KEYS]
    n0 = kernels.LAUNCHES["frame_match_select"]
    keep = mt.rotation_histogram_filter(*args)
    _check(kernels.LAUNCHES["frame_match_select"] == n0 + 1,
           "rotation bins: the probe was not one K26 launch")
    lanes = [mt.rotation_histogram_filter_plain(*[a[b] for a in args])
             for b in range(args[0].shape[0])]
    _check(same_bits([keep], [torch.stack(lanes)]),
           "rotation bins: K26's probe differs from its plain version")
    row0 = keep[:, 0].view(-1, 2).all(dim=1).cpu().numpy()
    _check(bool(row0.all()), f"rotation bins: K26 bins values "
           f"{values[~row0].tolist()} off JAX's bins")
    return {"values": int(len(values)), "lanes": int(args[0].shape[0]),
            "k26_equal_jax": int(row0.sum()),
            "plain_equal_jax": int((plain == want).sum())}


def match_select_problems(seq, cfg, dev) -> dict:
    """K25 at the main path's shapes: the three launches of one tracking
    step on the K3 outputs of hamming_step_problems (the frame search,
    1024 rows, and the window search, 4096 rows, resolving duplicates
    over the frame's 1024 features; match_descriptors, 1024 rows, the
    ratio test and the mutual check), the window search at B = 4, and
    every SELECT_PLANTED problem alone (`<case>_<k>`) and at B = 4.
    Returns {name: fn}, fn() launching it."""
    from planarslam_tpu_torch.ops import matching as mt

    k3 = hamming_step_problems(seq, cfg, dev)
    n = cfg.orb.max_keypoints
    mc = cfg.matcher
    probs = {}
    for case in ("frame", "window", "window_b4"):
        probs[case] = (list(k3[case]()),
                       dict(max_dist=mc.th_high, n_targets=n))
    *fwd, back = k3["descriptors"]()
    probs["descriptors"] = (list(fwd), dict(max_dist=mc.th_low, ratio=0.9,
                                            back=back))
    for case in SELECT_PLANTED:
        for k, p in enumerate(planted_select_lanes(case, 4)):
            args4, kw4 = _select_args(p, dev)
            probs[f"{case}_{k}"] = select_lane(args4, kw4, 0)
            probs[f"{case}_{k}_b4"] = (args4, kw4)
    return {k: (lambda a=a, kw=kw: mt.match_select(*a, **kw))
            for k, (a, kw) in probs.items()}


def frame_match_problems(seq, cfg, dev) -> dict:
    """K26 at the main path's shapes: one tracking step's launch on the
    frame search's matches ("projection": hamming_step_problems' K3
    outputs through K25, match_descriptors' as the brute-force ones), the
    same with the projection matches cut to 10 ("brute_force"), the filter
    mode on the projection matches ("filter"), the projection problem four
    times in one launch ("b4"), and every FRAME_PLANTED problem alone
    (`<case>_<k>`, lane 0) and, in frame mode, at B = 4. Returns {name:
    fn}, fn() launching it."""
    import torch

    from planarslam_tpu_torch.ops import matching as mt

    k3 = hamming_step_problems(seq, cfg, dev)
    probs = _matching_problems(seq, cfg, dev, np.random.default_rng(24))
    p1, last = probs["f1"].points, probs["last"]
    n, mc = cfg.orb.max_keypoints, cfg.matcher
    table = mt.level_inv_sigma2(cfg.orb.scale_factor, cfg.orb.n_levels, dev)
    proj_idx = mt.match_select(*k3["frame"](), max_dist=mc.th_high,
                               n_targets=n)[0]
    *fwd, back = k3["descriptors"]()
    bf_idx = mt.match_select(*fwd, max_dist=mc.th_low, ratio=0.9,
                             back=back)[0]
    few = proj_idx.clone()
    few[:, torch.cumsum((few >= 0).int(), 1)[0] > 10] = -1
    tgt = [t[None] for t in (p1.angle, p1.uv, p1.u_right, p1.level)]
    src = last.feats.points.angle[None]
    args = {"projection": (proj_idx, bf_idx, src, *tgt),
            "brute_force": (few, bf_idx, src, *tgt)}
    args["b4"] = tuple(torch.cat([a] * 4) for a in args["projection"])
    out = {k: (lambda a=a: mt.frame_match_select(*a, table))
           for k, a in args.items()}
    fargs = (last.feats.points.angle,
             p1.angle[torch.clamp(proj_idx[0], 0, n - 1).long()],
             proj_idx[0] >= 0)
    out["filter"] = lambda: (mt.rotation_histogram_filter(*fargs),)
    for case in FRAME_PLANTED:
        for k, p in enumerate(planted_frame_lanes(case, 4)):
            lane = {key: v[0] if isinstance(v, np.ndarray) else v
                    for key, v in p.items()}
            if p["mode"] == "filter":  # (M,): one problem a call
                a = [torch.from_numpy(lane[key]).to(dev)
                     for key in FILTER_KEYS]
                out[f"{case}_{k}"] = (
                    lambda a=a: (mt.rotation_histogram_filter(*a),))
                continue
            out[f"{case}_{k}"] = frame_call(
                {key: v[None] if isinstance(v, np.ndarray) else v
                 for key, v in lane.items()}, dev, table)[0]
            out[f"{case}_{k}_b4"] = frame_call(p, dev, table)[0]
    return out


def matching_kernel_parity(seq, cfg, dev) -> list:
    """K24-K27 against their plain versions on the card, on the problems of
    _matching_problems (frames 0 -> 1 of the 640x480 room at the default
    configuration's widths: 1024 landmarks or 4096 window points against
    1024 features, 256 window lines against 64 frame lines). K24 on both
    searches, K25 on both searches' K3 outputs and on match_descriptors'
    two (mutual), K26 on the frame search and the brute-force matches (and
    with the projection matches cut below MIN_PROJ_MATCHES, and in filter
    mode; also every FRAME_PLANTED problem, frame_planted_parity), K27 on
    the window search and K26's matches, and on the line search of frame 1
    in the 256 window lines. Every output equals the
    plain version's bit for bit (integers and gathered floats; K24's floats
    because kernel and plain version take the same operations in the same
    order), and two launches give the same bits. Targets matched by more
    than one row (clashes, which K25's duplicate resolution and mutual
    check rule out) are counted."""
    import torch

    from planarslam_tpu_torch.ops import lines as ln
    from planarslam_tpu_torch.ops import matching as mt

    cam = cfg.camera
    kw0 = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
               image_wh=(float(cam.width), float(cam.height)), bf=cam.bf,
               scale_factor=cfg.orb.scale_factor)
    probs = _matching_problems(seq, cfg, dev, np.random.default_rng(24))
    f1, last, T_cw = probs["f1"], probs["last"], probs["T_cw"]
    p1 = f1.points
    src = "planarslam_tpu_torch/csrc/matching.cu"
    out, cases = [], {}

    def twice_same(fn, *args, **kw):
        """fn's kernel output, checked equal to a second launch."""
        a, b = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        _check(all(_same(x, y) for x, y in zip(a, b)),
               f"{fn.__name__}: two launches differ")
        return a

    def held(name, got, want):
        bad = {f: int((~((x == y) | (x.isnan() & y.isnan()))).sum())
               if x.dtype.is_floating_point else int((x != y).sum())
               for f, x, y in zip(got._fields if hasattr(got, "_fields")
                                  else range(len(got)), got, want)}
        _check(not any(bad.values()),
               f"{name}: entries differ from the plain version: {bad}")

    # K24 on both searches
    proj = {}
    for case in ("frame", "window"):
        c = probs[case]
        args = (c["pts_w"][None], c["valid"][None], T_cw[None])
        kw = dict(kw0, radius=c["radius"])
        if case == "window":
            kw.update(view_normals=c["view_normals"][None],
                      dist_range=tuple(d[None] for d in c["dist_range"]))
        got = twice_same(mt.project_landmarks, *args, **kw)
        want = mt.project_landmarks_plain(
            c["pts_w"], c["valid"], T_cw, **dict(kw0, radius=c["radius"]),
            view_normals=c.get("view_normals"),
            dist_range=c.get("dist_range"))
        held(f"project_landmarks ({case})", [g[0] for g in got], want)
        proj[case] = (got, args, kw)
        cases[case] = {"M": int(c["valid"].shape[0]),
                       "gated": int(got.gate_pt.sum()),
                       "levels": sorted(set(
                           got.a_level[got.gate_pt].tolist()))}
    _check(cases["frame"]["gated"] > 200 and cases["window"]["gated"] > 500
           and len(cases["window"]["levels"]) >= 3,
           f"project_landmarks: the cases do not exercise it: {cases}")
    got, args, kw = proj["window"]
    c = probs["window"]
    out.append({
        "name": "project_landmarks", "route": "cuda", "library_ms": None,
        # per landmark: the transform and projection (~25), the camera
        # centre, distance and cosine (~30), log, ceil, pow (~60)
        **_bound(_nbytes(args, c["view_normals"], c["dist_range"], got),
                 MATCH_WINDOW * 120.0),
        "source": src, "replaces": "planarslam_tpu/ops/matching.py:142",
        "max_abs_err": 0.0, "tolerance": "every output bit-equal",
        "cases": cases,
        "ms": _time_ms(lambda: mt.project_landmarks(*args, **kw)),
        "plain_ms": _time_ms(lambda: mt.project_landmarks_plain(
            c["pts_w"], c["valid"], T_cw, **dict(kw0, radius=4.0),
            view_normals=c["view_normals"], dist_range=c["dist_range"])),
        "frame_ms": _time_ms(lambda: mt.project_landmarks(
            *proj["frame"][1], **proj["frame"][2]))})

    # K25 on K3's outputs: both searches (duplicates resolved), and
    # match_descriptors' rows with the transposed problem's (mutual)
    n = p1.desc.shape[0]
    top2 = {}
    for case in ("frame", "window"):
        g = proj[case][0]
        gate = mt.ProjGate(a_uv=g.a_uv[0], a_r=g.a_r[0], a_level=g.a_level[0],
                           a_ur_pred=g.a_ur_pred[0], b_uv=p1.uv,
                           b_level=p1.level, b_ur=p1.u_right,
                           level_window=probs[case]["level_window"])
        top2[case] = (mt.gated_hamming_top2(probs[case]["descs"], p1.desc,
                                            g.gate_pt[0], p1.valid, gate),
                      dict(max_dist=cfg.matcher.th_high, n_targets=n))
    # match_descriptors' two directions in one K3 launch
    *fwd, back = (x[0] for x in twice_same(
        mt.mutual_hamming_top2, last.feats.points.desc[None], p1.desc[None],
        last.valid3d[None], p1.valid[None]))
    top2["descriptors"] = (fwd, dict(max_dist=cfg.matcher.th_low, ratio=0.9,
                                     back=back))
    plain_back = mt.gated_hamming_top2_plain(
        p1.desc, last.feats.points.desc, p1.valid, last.valid3d)[2]
    for case, (t3, kw) in top2.items():
        a, b, ao, bo, gate = (
            (probs[case]["descs"], p1.desc, proj[case][0].gate_pt[0],
             p1.valid, mt.ProjGate(*[x[0] for x in proj[case][0][:4]],
                                   p1.uv, p1.level, p1.u_right,
                                   probs[case]["level_window"]))
            if case != "descriptors" else
            (last.feats.points.desc, p1.desc, last.valid3d, p1.valid, None))
        held(f"gated_hamming_top2 ({case})", t3,
             mt.gated_hamming_top2_plain(a, b, ao, bo, gate))
    held("mutual_hamming_top2 (back)", [back], [plain_back])
    sel = {}
    for case, (t3, kw) in top2.items():
        bat = [t[None] for t in t3]
        kwb = dict(kw, back=kw["back"][None]) if "back" in kw else kw
        got = twice_same(mt.match_select, *bat, **kwb)
        want = mt.match_select_plain(*t3, kw["max_dist"], kw.get("ratio"),
                                     kw.get("back"), kw.get("n_targets"))
        held(f"match_select ({case})", [g[0] for g in got], want)
        sel[case] = {"matches": int((got[0] >= 0).sum()),
                     "before": int((t3[0] <= kw["max_dist"]).sum()),
                     "clashes": _clashes(got[0][0], n)}
    _check(all(v["matches"] > 20 for v in sel.values())
           and sel["window"]["matches"] < sel["window"]["before"]
           and sel["window"]["clashes"] == 0
           and sel["descriptors"]["clashes"] == 0,
           f"match_select: the cases do not exercise it: {sel}")
    planted = select_planted_parity(dev)
    print(f"matching_kernel_parity match_select planted: "
          f"{json.dumps(planted)}", flush=True)
    t3, kw = top2["window"]
    bat = [t[None] for t in t3]
    t3d, kwd = top2["descriptors"]
    batd = [t[None] for t in t3d]
    kwdb = dict(kwd, back=kwd["back"][None])
    out.append({
        "name": "match_select", "route": "cuda", "library_ms": None,
        # per row: the tests and three passes of shared-memory minima (~20);
        # with the ratio test off the kernel reads best and best_idx only
        **_bound(_nbytes(bat[0], bat[2]) + 8 * MATCH_WINDOW,
                 MATCH_WINDOW * 20.0),
        "source": src, "replaces": "planarslam_tpu/ops/matching.py:184",
        "max_abs_err": 0.0, "tolerance": "indices and distances exact",
        "cases": sel, "planted": planted,
        "ms": _time_ms(lambda: mt.match_select(*bat, **kw)),
        "plain_ms": _time_ms(lambda: mt.match_select_plain(
            *t3, kw["max_dist"], n_targets=n)),
        "descriptors_ms": _time_ms(lambda: mt.match_select(*batd, **kwdb))})

    # K26 on the frame search and the brute-force matches, with the
    # projection matches cut below MIN_PROJ_MATCHES, and in filter mode
    table = mt.level_inv_sigma2(cfg.orb.scale_factor, cfg.orb.n_levels, dev)
    proj_idx = mt.match_select(*[t[None] for t in top2["frame"][0]],
                               **top2["frame"][1])[0]
    bf_idx = mt.match_select(*batd, **kwdb)[0]
    few = proj_idx.clone()
    few[:, torch.cumsum((few >= 0).int(), 1)[0] > 10] = -1
    tgt = (p1.angle, p1.uv, p1.u_right, p1.level)
    fm_args = {"projection": (proj_idx, bf_idx),
               "brute_force": (few, bf_idx)}
    fm = {}
    for case, (pi, bi) in fm_args.items():
        args = (pi, bi, last.feats.points.angle[None],
                *[t[None] for t in tgt], table)
        got = twice_same(mt.frame_match_select, *args)
        want = mt.frame_match_select_plain(pi[0], bi[0],
                                           last.feats.points.angle, *tgt,
                                           table)
        held(f"frame_match_select ({case})", [g[0] for g in got], want)
        chosen = bi if case == "brute_force" else pi
        fm[case] = {"input": int((chosen >= 0).sum()),
                    "kept": int((got.ff_idx >= 0).sum()),
                    "clashes": _clashes(got.ff_idx[0], n), "out": got,
                    "args": args}
    ang = p1.angle[torch.clamp(proj_idx[0], 0, n - 1).long()]
    fargs = (last.feats.points.angle, ang, proj_idx[0] >= 0)
    keep = twice_same(lambda *a: (mt.rotation_histogram_filter(*a),),
                      *fargs)[0]
    held("rotation_histogram_filter", [keep],
         [mt.rotation_histogram_filter_plain(*fargs)])
    _check(all(0 < v["kept"] <= v["input"] and v["clashes"] == 0
               for v in fm.values())
           and torch.equal(fm["projection"]["out"].ff_idx[0] >= 0,
                           keep),
           f"frame_match_select: the cases do not exercise it: {fm}")
    fplanted = frame_planted_parity(dev, table)
    print(f"matching_kernel_parity frame_match_select planted: "
          f"{json.dumps(fplanted)}", flush=True)
    print(f"matching_kernel_parity rotation bins: "
          f"{json.dumps(edge_bin_parity(dev))}", flush=True)
    args = fm["projection"]["args"]
    got = fm["projection"]["out"]
    ff = got.ff_idx[0]
    out.append({
        "name": "frame_match_select", "route": "cuda", "library_ms": None,
        # per source: the count, the gather, mod and bin (~20), the
        # histogram test and the obs1 gathers (~10). Bytes: proj_idx (the
        # projection matches suffice, so bf_idx is not read), the source
        # angles, the table and the outputs, and of the targets only the
        # rows gathered: the angles of the matched ones, the uv and level
        # of the kept ones (row 0 for the rest), their u_right
        **_bound(_nbytes(args[0], args[2], table, got)
                 + 4 * _distinct(args[0]) + 4 * _distinct(ff)
                 + 12 * _distinct(torch.clamp(ff, 0, n - 1)), n * 30.0),
        "source": src,
        "replaces": "planarslam_tpu/slam/device_tracker.py:314",
        "max_abs_err": 0.0, "tolerance": "every output bit-equal",
        "cases": {k: {f: v[f] for f in ("input", "kept", "clashes")}
                  for k, v in fm.items()},
        "planted": fplanted,
        "ms": _time_ms(lambda: mt.frame_match_select(*args)),
        "plain_ms": _time_ms(lambda: mt.frame_match_select_plain(
            *[a[0] for a in args[:-1]], table)),
        "filter_ms": _time_ms(lambda: mt.rotation_histogram_filter(*fargs))})

    # K27 on the window search and K26's matches, and on frame 1's line
    # search in the 256 window lines
    win_idx = mt.match_select(*bat, **kw)[0]
    ff_idx = fm["projection"]["out"].ff_idx
    c = probs["window"]
    pargs = (win_idx, ff_idx, last.pt3d_w[None], c["pts_w"][None],
             p1.valid[None], p1.u_right[None], p1.level[None], table)
    got = twice_same(mt.assemble_point_obs, *pargs)
    want = mt.assemble_point_obs_plain(*[a[0] for a in pargs[:-1]], table)
    held("assemble_point_obs", [g[0] for g in got], want)
    lw = probs["lines"]
    lm_idx, _ = ln.search_lines_by_projection(
        *lw, T_cw, f1.lines.uv_s, f1.lines.uv_e, f1.lines.angle,
        f1.lines.desc, f1.lines.valid, K=kw0["K"],
        image_wh=kw0["image_wh"], radius=14.0)
    largs = (lm_idx[None], lw[0][None].contiguous(),
             lw[1][None].contiguous(), f1.lines.valid[None])
    lgot = twice_same(mt.assemble_line_obs, *largs)
    held("assemble_line_obs", [g[0] for g in lgot],
         mt.assemble_line_obs_plain(*[a[0] for a in largs]))
    temporal = torch.zeros(n, dtype=torch.bool, device=dev)
    temporal[ff_idx[0][ff_idx[0] >= 0].long()] = True
    temporal &= got.feat_slot[0] < 0
    asm = {"window_slots": int((got.feat_slot >= 0).sum()),
           "temporal": int(((got.feat_slot < 0) & got.valid).sum()),
           "temporal_rows": int(temporal.sum()),
           "line_slots": int((lgot.ln_slot >= 0).sum()),
           "window_clashes": _clashes(win_idx[0], n),
           "temporal_clashes": fm["projection"]["clashes"],
           "line_clashes": _clashes(lm_idx, cfg.lines.max_lines)}
    _check(asm["window_slots"] > 50 and asm["temporal"] > 0
           and asm["line_slots"] > 5,
           f"assemble_observations: the cases do not exercise it: {asm}")
    print(f"matching_kernel_parity clashes (expected 0): {json.dumps(asm)}",
          flush=True)
    out.append({
        "name": "assemble_observations", "route": "cuda",
        "library_ms": None,
        # per window row and source: one shared-memory maximum; per target
        # the selections and gathers (~10). Bytes: win_idx, ff_idx, the
        # per-feature inputs, the table and the outputs, and 12 per point
        # gathered: the matched window rows and the temporal landmarks of
        # the features without one
        **_bound(_nbytes(pargs[:2], pargs[4:], got)
                 + 12 * (asm["window_slots"] + asm["temporal_rows"]),
                 2.0 * MATCH_WINDOW + 10.0 * n),
        "source": src,
        "replaces": "planarslam_tpu/slam/device_tracker.py:406",
        "max_abs_err": 0.0, "tolerance": "every output bit-equal",
        "cases": asm,
        "ms": _time_ms(lambda: mt.assemble_point_obs(*pargs)),
        "plain_ms": _time_ms(lambda: mt.assemble_point_obs_plain(
            *[a[0] for a in pargs[:-1]], table)),
        "lines_ms": _time_ms(lambda: mt.assemble_line_obs(*largs)),
        "lines_plain_ms": _time_ms(lambda: mt.assemble_line_obs_plain(
            *[a[0] for a in largs]))})
    _print_kernels(out)
    return out


# ---------------------------------------------------------------------------
# K28-K31: the depth-noise median, the frame normals, the plane association
# and the step's tail

# the tail's launches of one tracking step, its prelude, Manhattan and pose
# launches, and all of a step's counted ones (the same whatever the step's
# batch of lanes)
TAIL_PER_STEP = {"associate_planes": 1, "finish_step": 1}
CORE_PER_STEP = {"step_prelude": 1, "manhattan_mean_shift": 1,
                 "pose_optimize": 2}
STEP_LAUNCHES = {**MATCH_PER_STEP, **TAIL_PER_STEP, **CORE_PER_STEP}
PLANE_KEYS = ("coeffs", "valid", "T_cw", "pl_coeffs", "pl_cloud",
              "pl_cloud_n", "pl_valid")
PLANE_CASES = ("random", "tie", "self_parallel", "empty_cloud", "no_map",
               "invalid_near", "cloud_n_range", "nan_point", "invalid_frame")
ALPHA_CASES = ("empty", "even", "odd", "flat", "duplicates", "split", "pair",
               "wide")
TAIL_FRAMES = 10  # frames of the Systems whose last step K30 and K31 see


def _unit(rng, n: int) -> np.ndarray:
    v = rng.normal(0, 1, (n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def alpha_samples(depth: np.ndarray, max_distance: float = 10.0
                  ) -> np.ndarray:
    """K28's valid strided samples of a depth map as float32, in float32
    arithmetic as the kernel rounds them (the plain version's spelling)."""
    d = depth.astype(np.float32)
    d1, d2 = np.roll(d, -1, 1), np.roll(d, -2, 1)
    ok = (d > 1e-6) & (d < max_distance)
    ok = ok & np.roll(ok, -1, 1) & np.roll(ok, -2, 1)
    z = np.maximum(d, np.float32(1.0))
    r = np.abs((d - np.float32(2.0) * d1) + d2) / (z * z)
    return r[::4, ::4][ok[::4, ::4]].astype(np.float32)


def planted_alpha_depth(case: str) -> np.ndarray:
    """Depth maps (metres) for K28's planted cases: no valid sample
    ("empty"), 100 and 99 samples ("even", "odd"), a flat plane whose every
    sample is 0 ("flat"), a ramp quantized to 5 mm, a few distinct values
    each many times ("duplicates"), 100 samples whose two middle values
    differ in their top 11 bits, half near 2.5e-4 and half near 0.025
    ("split"), exactly two samples that share their first 22 bits and no
    value ("pair"), and a 1280x960 ramp with noise and a hole (76800
    samples, "wide")."""
    rng = np.random.default_rng(28)
    if case == "empty":
        return np.zeros((40, 40), np.float32)
    if case in ("even", "odd"):
        d = (2.0 + rng.normal(0, 0.01, (40, 40))).astype(np.float32)
        if case == "odd":
            d[0, 1] = 0.0  # only the sample at (0, 0) reads pixel (0, 1)
        return d
    if case == "flat":
        return np.full((48, 64), 1.5, np.float32)
    if case == "split":
        # sample (y, x) alone reads pixel (y, x + 1): |2 - 2 d1 + 2| / 4
        d = np.full((40, 40), 2.0, np.float32)
        e = np.concatenate([1e-3 * (1.0 + np.arange(50) / 50.0),
                            0.1 * (1.0 + np.arange(50) / 50.0)])
        d[0::4, 1::4] = (2.0 - rng.permutation(e) / 2.0).reshape(10, 10)
        return d
    if case == "pair":
        d = np.zeros((40, 40), np.float32)
        d[0, 0:3] = d[20, 20:23] = 2.0
        d[0, 1] = np.float32(1.99)
        one = d[0, 1]
        for _ in range(64):  # the next d1 whose sample keeps 22 bits
            d[20, 21] = np.nextafter(d[20, 21] if d[20, 21] < 2.0 else one,
                                     np.float32(2.0))
            a, b = np.sort(alpha_samples(d)).view(np.uint32)
            if a != b and a >> 10 == b >> 10:
                break
        return d
    if case == "wide":
        yy, xx = np.mgrid[:960, :1280]
        d = 1.0 + 0.002 * xx + 0.001 * yy + rng.normal(0, 0.005, xx.shape)
        d[100:300, 200:520] = 0.0
        return d.astype(np.float32)
    yy, xx = np.mgrid[:120, :160]
    ramp = 1.0 + 0.01 * xx + 0.004 * yy + rng.normal(0, 0.002, (120, 160))
    return (np.round(ramp * 200.0) / 200.0).astype(np.float32)


def planted_plane_problem(rng, case: str, P: int = 16, Mp: int = 128,
                          C: int = 512) -> dict:
    """K30's inputs (numpy, keyed by PLANE_KEYS): P frame planes against Mp
    map planes with C-point clouds. Half the frame planes are seen map
    planes (a direct match each), the rest random; map planes 40-43 are
    parallel to frame planes 0-3 at another offset, 60-63 perpendicular.
    Planted: "tie", map planes 5 and 9 equal in coefficients and cloud (the
    direct match ties, the first wins); "self_parallel", frame plane 0's
    direct match is also its most parallel plane (excluded) beside a second
    parallel one, 50; "empty_cloud", map plane 3, frame plane 2's plane,
    has no cloud point (never direct) and is a parallel candidate; "no_map",
    no valid map plane; "invalid_near", map plane 100, invalid, as well
    aligned as frame plane 0's plane and nearer (no noise), its cloud NaN
    past its 300 counted points; "cloud_n_range", pl_cloud_n 0 (map plane
    4), exactly C (7) and above C (6); "nan_point", a NaN point inside map
    plane 5's counted cloud (never direct, still a parallel or vertical
    candidate); "invalid_frame", the odd frame planes invalid."""
    T_cw = _planted_se3(rng, 0.4).astype(np.float64)
    nm = _unit(rng, Mp)
    dm = rng.uniform(0.5, 4.0, Mp)
    nw = np.concatenate([nm[:P // 2], _unit(rng, P - P // 2)])
    dw = np.concatenate([dm[:P // 2], rng.uniform(0.5, 4.0, P - P // 2)])
    for j in range(4):
        nm[40 + j], dm[40 + j] = nw[j], dw[j] + 0.3
        perp = np.cross(nw[j], _unit(rng, 1)[0])
        nm[60 + j] = perp / np.linalg.norm(perp)
    if case == "tie":
        nm[9], dm[9] = nm[5], dm[5]
    if case == "self_parallel":
        nm[50], dm[50] = nw[0], dw[0] + 0.5
    if case == "empty_cloud":
        nm[3], dm[3] = nw[2], dw[2]
    if case == "invalid_near":
        nm[100], dm[100] = nw[0], dw[0]
    b1 = np.cross(nm, _unit(rng, Mp))
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 = np.cross(nm, b1)
    ab = rng.uniform(-1, 1, (Mp, C, 2))
    cloud = (-dm[:, None, None] * nm[:, None, :] + ab[..., :1] * b1[:, None]
             + ab[..., 1:] * b2[:, None] + rng.normal(0, 0.002, (Mp, C, 3)))
    if case == "tie":
        cloud[9] = cloud[5]
    n_pts = rng.integers(1, C + 1, Mp)
    n_pts[:P] = C
    if case == "empty_cloud":
        n_pts[3] = 0
    if case == "invalid_near":  # on its plane exactly, NaN past its points
        cloud[100] = (-dm[100] * nm[100] + ab[100, :, :1] * b1[100]
                      + ab[100, :, 1:] * b2[100])
        n_pts[100] = 300
        cloud[100, 300:] = np.nan
    if case == "cloud_n_range":
        n_pts[4], n_pts[6], n_pts[7] = 0, C + 7, C
    if case == "nan_point":
        cloud[5, 7] = np.nan
    # the frame planes in the camera: n_c = R n_w, d_c = d_w - n_c . t
    n_c = nw @ T_cw[:3, :3].T
    coeffs = np.concatenate([n_c, (dw - n_c @ T_cw[:3, 3])[:, None]], 1)
    coeffs *= rng.uniform(0.9, 1.1, (P, 1))  # not unit: K30 normalizes
    pl_valid = rng.random(Mp) < 0.9
    pl_valid[:P] = True
    pl_valid[[3, 5, 9, 40, 41, 42, 43, 50]] = True
    if case == "no_map":
        pl_valid[:] = False
    if case == "invalid_near":
        pl_valid[100] = False
    valid = rng.random(P) < 0.9
    valid[[0, 2, 5]] = True
    if case == "cloud_n_range":
        valid[[4, 6, 7]] = True
        pl_valid[[4, 6, 7]] = True
    if case == "invalid_frame":
        valid[:] = True
        valid[1::2] = False
    pl_coeffs = np.concatenate([nm, dm[:, None]], 1) * rng.uniform(
        0.9, 1.1, (Mp, 1))
    f32 = np.float32
    return dict(coeffs=coeffs.astype(f32), valid=valid,
                T_cw=T_cw.astype(f32), pl_coeffs=pl_coeffs.astype(f32),
                pl_cloud=cloud.astype(f32), pl_cloud_n=n_pts.astype(np.int64),
                pl_valid=pl_valid)


def random_tail_problem(rng, cfg, final_ok: bool = True) -> dict:
    """K31's inputs (numpy, keyed by StepTail's fields) at cfg's widths: a
    pose and the final solve's pose near it (kept, or with too few inliers
    the pose before it), 4096 window points and 256 window lines around
    the view (some outside the image or behind the camera), 1024 features,
    matches, inliers and 16 planes."""
    from planarslam_tpu_torch.slam.device_tracker import WIN_LNS, WIN_PTS

    cam = cfg.camera
    K, L, P = cfg.orb.max_keypoints, cfg.lines.max_lines, cfg.planes.max_planes
    f32, i32 = np.float32, np.int32
    T1 = _planted_se3(rng, 0.3).astype(np.float64)
    T_cand = _planted_se3(rng, 0.01).astype(np.float64) @ T1
    T_wc = np.linalg.inv(T_cand)

    def world_points(n):
        uv = rng.uniform([-0.2 * cam.width, -0.2 * cam.height],
                         [1.2 * cam.width, 1.2 * cam.height], (n, 2))
        z = np.where(rng.random(n) < 0.9, rng.uniform(0.2, 8.0, n),
                     rng.uniform(-2.0, 0.1, n))
        pc = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                       (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
        return pc @ T_wc[:3, :3].T + T_wc[:3, 3]

    def ids(n, m, frac):
        return np.where(rng.random(n) < frac, rng.integers(0, m, n),
                        -1).astype(i32)

    mid = world_points(WIN_LNS)
    half = rng.normal(0, 0.3, (WIN_LNS, 3))
    depth = np.where(rng.random(K) < 0.8, rng.uniform(0.3, 9.0, K),
                     np.where(rng.random(K) < 0.5, 0.0, -1.0))
    n_in2 = 200 if final_ok else cfg.tracking.min_matches_local_map // 2 - 1
    return dict(
        T_cand=T_cand.astype(f32), n_in2=np.int64(n_in2), T1=T1.astype(f32),
        n_in1=np.int64(123), T_last=_planted_se3(rng, 0.3),
        R_cm=_planted_se3(rng, 1.0)[:3, :3].copy(),
        manh_success=np.bool_(True), use_manh=np.bool_(False),
        ff_idx=ids(K, K, 0.5), feat_slot=ids(K, WIN_PTS, 0.6),
        inl=rng.random(K) < 0.7, obs2_valid=rng.random(K) < 0.8,
        pt_uv=rng.uniform(0, [cam.width, cam.height], (K, 2)).astype(f32),
        pt_depth=depth.astype(f32), pt_valid=rng.random(K) < 0.95,
        win_idx=ids(WIN_PTS, K, 0.3), win_xyz=world_points(WIN_PTS).astype(
            f32), win_valid=rng.random(WIN_PTS) < 0.8,
        lm_idx=ids(WIN_LNS, L, 0.2), ln_sw=(mid - half).astype(f32),
        ln_ew=(mid + half).astype(f32), ln_valid=rng.random(WIN_LNS) < 0.8,
        ln_slot=ids(L, WIN_LNS, 0.4), pl_direct=ids(P, 128, 0.5),
        pl_par=ids(P, 128, 0.3), pl_ver=ids(P, 128, 0.3),
        pl_coeffs=np.concatenate([_unit(rng, P), rng.uniform(
            0.5, 4.0, (P, 1))], 1).astype(f32), pl_valid=rng.random(P) < 0.8)


def _bit_diff(x, y, as_int: bool = False) -> int:
    """Entries of x and y whose bits differ; a float NaN matches any NaN
    unless as_int (a bundle whose int32 fields are stored as bits); a bool
    by its byte."""
    import torch

    if x.dtype == torch.bool:
        x, y = x.view(torch.uint8), y.view(torch.uint8)
    if x.dtype == torch.float32:
        xi, yi = x.contiguous().view(torch.int32), y.contiguous().view(
            torch.int32)
        same = xi == yi
        if not as_int:
            same |= x.isnan() & y.isnan()
        return int((~same).sum())
    return int((x != y).sum())


def _tail_held(name: str, got, want) -> None:
    """Every output field of a K28-K31 launch bit-equal to the plain
    version's (the bundle compared as int32 bits)."""
    fields = got._fields if hasattr(got, "_fields") else range(len(got))
    bad = {f: _bit_diff(x, y, as_int=f == "packed")
           for f, x, y in zip(fields, got, want)}
    _check(not any(bad.values()),
           f"{name}: entries differ from the plain version: {bad}")


def _twice(fn, *args):
    """fn's kernel output, checked bit-equal to a second launch."""
    import torch

    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    _check(all(_bit_diff(x, y, as_int=True) == 0 for x, y in zip(a, b)),
           f"{fn.__name__}: two launches differ")
    return a


def _tail_capture(step: int) -> tuple:
    """_pose_calls' capture of K30's and K31's wrappers in tracking step
    `step` (from 1; -1: the last), where _track_core looks them up."""
    return (("device_tracker", "_associate_planes_device", step),
            ("device_tracker", "finish_step", step))


def _tail_inputs(inputs: dict, step: int) -> tuple:
    """The positional inputs of K30 and K31 that _tail_capture(step) kept."""
    got = [inputs.get(c) for c in _tail_capture(step)]
    _check(None not in got, f"tail: tracking step {step} was not captured")
    return got[0][0], got[1][0][0]


def _last_step(frames, cfg, dev) -> tuple:
    """The K30 arguments and K31's StepTail of the last tracking step of a
    tracking-only System over `frames`."""
    from planarslam_tpu_torch.slam.system import System

    slam = System(config=cfg, enable_local_mapping=False,
                  enable_loop_closing=False, device=dev)
    with _pose_calls(_tail_capture(-1)) as rec:
        for i, (g, d) in enumerate(frames):
            slam.track_rgbd(g, d, float(i) / 30.0)
    slam.shutdown()
    return _tail_inputs(rec["inputs"], -1)


def _hold_assoc(name, args, pcfg) -> dict:
    """K30 on args (B = 1) against its plain version, twice; the counts of
    its matches."""
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam import device_tracker as dt

    got = _twice(dt._associate_planes_device, *args, pcfg)
    _tail_held(f"associate_planes ({name})", got,
               kernels.per_problem(dt._associate_planes_plain, list(args),
                                   pcfg))
    return {f: int((getattr(got, f) >= 0).sum())
            for f in ("direct", "par", "ver")}


def plane_stats(args) -> dict:
    """What K30 walks on its inputs (B = 1): the valid frame planes, the
    valid map planes, those with a point, and the points they count
    (pl_cloud_n clamped to the cloud's C)."""
    import torch

    valid, pl_cloud, pl_cloud_n, pl_valid = (args[1], args[4], args[5],
                                             args[6])
    n = torch.clamp(pl_cloud_n, 0, pl_cloud.shape[2]) * pl_valid
    return {"frame_valid": int(valid.sum()), "map_valid": int(pl_valid.sum()),
            "map_with_points": int((n > 0).sum()),
            "cloud_points": int(n.sum())}


ASSOC_STEP = 48  # path 1's tracking step whose K30 inputs are timed


def assoc_inputs(seq, cfg, dev, steps: int = ASSOC_STEP) -> dict:
    """K30's inputs (the 7 tensors, B = 1) at tracking steps 1..steps of a
    tracking-only System over seq's frames (as many as those steps take),
    its depth clean and with Kinect noise as tail_kernel_parity makes
    them: {"clean": [step 1's, ...], "noisy": [...]}."""
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System

    dmf = cfg.camera.depth_map_factor
    capture = tuple(("device_tracker", "_associate_planes_device", n)
                    for n in range(1, steps + 1))
    out = {}
    for name in ("clean", "noisy"):
        slam = System(config=cfg, enable_local_mapping=False,
                      enable_loop_closing=False, device=dev)
        with _pose_calls(capture) as rec:
            for i in range(len(seq.poses_wc)):
                if capture[-1] in rec["inputs"]:
                    break
                g, d16 = quantize_frame(*seq.render(i), dmf)
                d = d16.astype(np.float32) / np.float32(dmf)
                if name == "noisy":
                    d = noisy_depth(d, dmf, seed=i)
                slam.track_rgbd(g, np.round(d * dmf).astype(np.uint16),
                                float(i) / 30.0)
        slam.shutdown()
        _check(all(c in rec["inputs"] for c in capture),
               f"assoc_inputs: {name}: not {steps} tracking steps")
        out[name] = [rec["inputs"][c][0][:7] for c in capture]
    return out


def assoc_problems(seq, cfg, dev, inputs=None) -> dict:
    """K30 at the main path's shapes: path 1's ASSOC_STEP-th step clean and
    noisy (assoc_inputs), every PLANE_CASES problem, and B = 4 (steps
    ASSOC_STEP - 1 and ASSOC_STEP, clean and noisy) in one launch. Returns
    {name: fn}, fn() launching it."""
    import torch

    from planarslam_tpu_torch.slam import device_tracker as dt

    inputs = inputs or assoc_inputs(seq, cfg, dev)
    probs = {f"step{ASSOC_STEP}_{k}": inputs[k][-1]
             for k in ("clean", "noisy")}
    for case in PLANE_CASES:
        p = planted_plane_problem(np.random.default_rng(30), case)
        probs[case] = [torch.from_numpy(p[key][None]).to(dev)
                       for key in PLANE_KEYS]
    probs["b4"] = [torch.cat(x) for x in zip(
        inputs["clean"][-2], inputs["clean"][-1], inputs["noisy"][-2],
        inputs["noisy"][-1])]
    pcfg = cfg.planes
    return {k: (lambda a=a: dt._associate_planes_device(*a, pcfg))
            for k, a in probs.items()}


def _hold_tail(name, tail, cfg) -> dict:
    """K31 on tail (B = 1) against its plain version, twice; a few of its
    counts."""
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam import device_tracker as dt

    got = _twice(dt.finish_step, tail, cfg)
    _tail_held(f"finish_step ({name})", got, kernels.per_problem(
        lambda *f: dt.finish_step_plain(dt.StepTail(*f), cfg), list(tail)))
    b = dt.BundleLayout(cfg).unpack(got.packed[0].cpu().numpy())
    return {"kf_stats": b["kf_stats"].tolist(),
            "win_visible": int(b["win_visible"].sum()),
            "ln_win_visible": int(b["ln_win_visible"].sum()),
            "valid3d": int(got.valid3d.sum())}


# K31's planted cases: window points and line midpoints on the frustum's
# edges (u = 0 and the width, v = 0 and the height, each hit exactly and
# its neighbours; z = 0.05 and its neighbours; z = +-1e-8) at a planted
# pose; NaN and infinite window coordinates; feature depths 0, -0,
# negative, +-1e-30 and depth_threshold and a float either side;
# every feature tracked; no feature valid; n_in2 at min_inliers - 1 and at
# min_inliers; a configuration of K = 1000, L = 60, P = 13
TAIL_PLANTED = ("frustum_edges", "nonfinite", "depths", "all_tracked",
                "none_valid", "min_inliers", "small_config")


def view_f32(T, pts, cam) -> tuple:
    """K31's and its plain version's in-view test of world points (N, 3)
    at pose T (4, 4) in numpy float32, one rounding an operation in their
    order: (visible, u, v, z)."""
    f = np.float32
    T = np.asarray(T, f)
    p = np.asarray(pts, f)
    with np.errstate(all="ignore"):
        pc = [((T[r, 0] * p[:, 0] + T[r, 1] * p[:, 1]) + T[r, 2] * p[:, 2])
              + T[r, 3] for r in range(3)]
        z = pc[2]
        inv_z = f(1) / np.where(np.abs(z) < f(1e-8), f(1e-8), z)
        u = (f(cam.fx) * pc[0]) * inv_z + f(cam.cx)
        v = (f(cam.fy) * pc[1]) * inv_z + f(cam.cy)
        vis = ((z > f(0.05)) & (u >= 0) & (u < f(cam.width)) & (v >= 0)
               & (v < f(cam.height)))
    return vis, u, v, z


def frustum_edge_points(cam) -> np.ndarray:
    """Camera points (identity pose) whose u or v is exactly 0, the width
    or the height in float32 (view_f32), with the float on either side of
    each; points at z = 0.05 and +-1e-8 and the floats about them."""
    f = np.float32
    out = []
    for axis, edge, other in ((0, 0.0, 0.3), (0, float(cam.width), -0.2),
                              (1, 0.0, 0.1), (1, float(cam.height), 0.4)):
        for z in (1.0, 2.5):
            fc, cc = (cam.fx, cam.cx) if axis == 0 else (cam.fy, cam.cy)
            x = f((edge - cc) * z / fc)
            xs = [x]
            for step in (-1.0, 1.0):
                y = x
                for _ in range(300):
                    y = np.nextafter(y, f(step * 1e9))
                    xs.append(y)
            xs = np.array(sorted(set(xs)), f)
            pts = np.zeros((len(xs), 3), f)
            pts[:, axis] = xs
            pts[:, 1 - axis] = other
            pts[:, 2] = z
            uv = view_f32(np.eye(4), pts, cam)[1 + axis]
            hit = np.flatnonzero(uv == f(edge))
            k = hit[0] if len(hit) else int(np.searchsorted(uv, f(edge)))
            out.append(pts[max(k - 1, 0):k + 2])
    zs = []
    for z0 in (0.05, 1e-8, -1e-8):
        z = f(z0)
        zs += [np.nextafter(z, f(-1)), z, np.nextafter(z, f(1))]
    zs += [f(0.0), f(-0.0)]
    out.append(np.array([[0.001, -0.001, z] for z in zs], f))
    return np.concatenate(out)


def _small_tail_config(cfg):
    """cfg with K = 1000 features, L = 60 lines and P = 13 planes."""
    import dataclasses

    return cfg.replace(
        orb=dataclasses.replace(cfg.orb, max_keypoints=1000),
        lines=dataclasses.replace(cfg.lines, max_lines=60),
        planes=dataclasses.replace(cfg.planes, max_planes=13))


def planted_tail_problem(case: str, cfg, seed: int = 31) -> list:
    """The K31 problems of a TAIL_PLANTED case: a list of (configuration,
    inputs as random_tail_problem gives them, what it plants), the
    planted window rows and their view_f32 visibility where the case
    plants frustum edges."""
    rng = np.random.default_rng(seed)
    f = np.float32
    cam = cfg.camera
    m = cfg.tracking.min_matches_local_map // 2
    t = random_tail_problem(rng, cfg, True)
    plants = {}
    if case == "frustum_edges":
        t["T_cand"] = np.eye(4, dtype=f)
        pts = frustum_edge_points(cam)
        k = len(pts)
        rows = rng.permutation(len(t["win_valid"]))[:k]
        t["win_xyz"][rows] = pts
        t["win_valid"][rows] = True
        lines = rng.permutation(len(t["ln_valid"]))[:k]
        t["ln_sw"][lines] = pts
        t["ln_ew"][lines] = pts
        t["ln_valid"][lines] = True
        vis = view_f32(t["T_cand"], pts, cam)
        plants = {"rows": rows, "lines": lines, "visible": vis[0],
                  "on_edge": int(((vis[1] == 0) | (vis[1] == cam.width)
                                  | (vis[2] == 0) | (vis[2] == cam.height)
                                  | (vis[3] == f(0.05))).sum())}
    elif case == "nonfinite":
        nan, inf = np.nan, np.inf
        bad = np.array([[nan, 0, 1], [0, nan, 1], [0, 0, nan], [inf, 0, 1],
                        [-inf, 0, 1], [0, inf, 1], [0, 0, inf], [0, 0, -inf],
                        [inf, inf, inf], [nan, nan, nan], [inf, -inf, 2]], f)
        rows = rng.permutation(len(t["win_valid"]))[:len(bad)]
        t["win_xyz"][rows] = bad
        t["win_valid"][rows] = True
        lines = rng.permutation(len(t["ln_valid"]))[:len(bad)]
        t["ln_sw"][lines] = bad
        t["ln_ew"][lines] = bad[::-1]
        t["ln_valid"][lines] = True
        plants = {"rows": rows, "lines": lines}
    elif case == "depths":
        th = f(cam.depth_threshold)
        d = np.array([0.0, -0.0, -1.0, -1e-30, 1e-30, th,
                      np.nextafter(th, f(0)), np.nextafter(th, f(1e9)),
                      2 * th, 0.05], f)
        rows = rng.permutation(len(t["pt_depth"]))[:10 * len(d)]
        t["pt_depth"][rows] = np.tile(d, 10)
        t["pt_valid"][rows] = True
        plants = {"rows": rows}
    elif case == "all_tracked":
        k = len(t["inl"])
        t["inl"][:] = True
        t["obs2_valid"][:] = True
        t["pt_valid"][:] = True
        t["pt_depth"] = rng.uniform(0.3, 2.0 * cam.depth_threshold,
                                    k).astype(f)
    elif case == "none_valid":
        t["pt_valid"][:] = False
        t["obs2_valid"][:] = False
    elif case == "min_inliers":
        t2 = {k: np.copy(v) for k, v in t.items()}
        t["n_in2"] = np.int64(m - 1)
        t2["n_in2"] = np.int64(m)
        return [(cfg, t, {"final": False}), (cfg, t2, {"final": True})]
    elif case == "small_config":
        small = _small_tail_config(cfg)
        return [(small, random_tail_problem(rng, small, True), {}),
                (small, random_tail_problem(rng, small, False), {})]
    return [(cfg, t, plants)]


def planted_tail_lanes(case: str, cfg, batch: int, seed: int = 31) -> list:
    """planted_tail_problem of seeds seed .. seed + batch - 1: per problem
    (configuration, inputs stacked on a leading lane dimension, the lanes'
    plants)."""
    lanes = [planted_tail_problem(case, cfg, seed + b) for b in range(batch)]
    return [(probs[0][0], {k: np.stack([np.asarray(q[1][k]) for q in probs])
                           for k in probs[0][1]}, [q[2] for q in probs])
            for probs in zip(*lanes)]


def _tail_of(t: dict, dev):
    """A StepTail on dev from stacked numpy inputs."""
    import torch

    from planarslam_tpu_torch.slam import device_tracker as dt

    return dt.StepTail(*[torch.from_numpy(np.ascontiguousarray(t[f])).to(dev)
                         for f in dt.StepTail._fields])


def tail_planted_parity(cfg, dev) -> dict:
    """K31 on every TAIL_PLANTED problem: bit-equal to its plain version
    (the bundle as int32), two launches equal bits, one launch a call, every
    output written (each call also into outputs filled with NaN,
    poisoned_outputs), what the case plants (the planted window rows'
    visibility as view_f32 gives it, the pose n_in2 picks, the counts);
    each also at B = 4 (four seeds) in one launch, each lane bit-equal to
    its B = 1 launch. Returns per case a few of its counts."""
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam import device_tracker as dt

    out = {}
    for case in TAIL_PLANTED:
        rec = []
        for c, t, lane_plants in planted_tail_lanes(case, cfg, 4):
            plants = lane_plants[0]
            tail4 = _tail_of(t, dev)
            ones = []
            for b in range(4):
                tail = dt.StepTail(*[x[b:b + 1] for x in tail4])
                n0 = kernels.LAUNCHES["finish_step"]
                got = dt.finish_step(tail, c)
                _check(kernels.LAUNCHES["finish_step"] == n0 + 1,
                       f"finish_step ({case}): not one launch a call")
                again = dt.finish_step(tail, c)
                with poisoned_outputs(dt, "_empty"):
                    filled = dt.finish_step(tail, c)
                _check(same_bits(got, again) and same_bits(got, filled),
                       f"finish_step ({case}, lane {b}): two launches "
                       f"differ, or an output was left unwritten")
                _tail_held(f"finish_step ({case}, lane {b})", got,
                           kernels.per_problem(
                               lambda *x: dt.finish_step_plain(
                                   dt.StepTail(*x), c), list(tail)))
                ones.append(got)
            n0 = kernels.LAUNCHES["finish_step"]
            got4 = dt.finish_step(tail4, c)
            _check(kernels.LAUNCHES["finish_step"] == n0 + 1,
                   f"finish_step ({case}, B = 4): not one launch")
            for b, one in enumerate(ones):
                _check(same_bits([x[b] for x in got4], [x[0] for x in one]),
                       f"finish_step ({case}): lane {b} of B = 4 differs "
                       f"from its B = 1 launch")
            bundle = dt.BundleLayout(c).unpack(got4.packed[0].cpu().numpy())
            r = {"K": int(t["inl"].shape[1]),
                 "kf_stats": bundle["kf_stats"].tolist(),
                 "valid3d": int(got4.valid3d[0].sum()),
                 "T_out_is_T_cand": bool(np.array_equal(
                     got4.T_out[0].cpu().numpy(), t["T_cand"][0]))}
            if "visible" in plants:
                vis = bundle["win_visible"][plants["rows"]] != 0
                lvis = bundle["ln_win_visible"][plants["lines"]] != 0
                r.update(planted=len(vis), on_edge=plants["on_edge"],
                         planted_visible=int(vis.sum()),
                         as_emulated=bool(np.array_equal(vis, plants[
                             "visible"]) and np.array_equal(lvis, plants[
                                 "visible"])))
            if "final" in plants:
                r["final"] = plants["final"]
            rec.append(r)
        out[case] = rec
    fe = out["frustum_edges"][0]
    _check(fe["as_emulated"] and fe["on_edge"] >= 8
           and 0 < fe["planted_visible"] < fe["planted"]
           and all(r["T_out_is_T_cand"] == r["final"]
                   for r in out["min_inliers"])
           and out["all_tracked"][0]["kf_stats"][3] == 1024
           and out["none_valid"][0]["valid3d"] == 0
           and out["none_valid"][0]["kf_stats"][1] == 0
           and all(r["K"] == 1000 for r in out["small_config"]),
           f"finish_step: the planted cases do not exercise it: {out}")
    return out


def _normal_reads(h: int, w: int, stride: int, k: int) -> int:
    """Depth pixels K29's stencils read at least once: the box windows
    around the smoothed pixels each sample needs (rows and columns apart:
    the samples form a grid)."""
    if stride <= 1:
        return h * w
    b, lo = min(stride, 3), (k - 1) // 2

    def axis(n):
        near = {(c + o) % n for c in range(stride // 2, n, stride)
                for o in range(-b, b + 2)}
        return len({r for c in near for r in range(c - lo, c + k - lo)
                    if 0 <= r < n})
    return axis(h) * axis(w)


def tail_step_inputs(seq, cfg, dev, step: int = ASSOC_STEP,
                     lanes: int = 4) -> list:
    """K31's StepTail (B = 1) at tracking steps step - lanes + 1 .. step
    of a tracking-only System over seq's frames (path 1's, clean)."""
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System

    capture = tuple(("device_tracker", "finish_step", k)
                    for k in range(step - lanes + 1, step + 1))
    slam = System(config=cfg, enable_local_mapping=False,
                  enable_loop_closing=False, device=dev)
    with _pose_calls(capture) as rec:
        for i in range(len(seq.poses_wc)):
            if capture[-1] in rec["inputs"]:
                break
            g, d16 = quantize_frame(*seq.render(i),
                                    cfg.camera.depth_map_factor)
            slam.track_rgbd(g, d16, float(i) / 30.0)
    slam.shutdown()
    _check(all(c in rec["inputs"] for c in capture),
           f"tail_step_inputs: not {step} tracking steps")
    return [rec["inputs"][c][0][0] for c in capture]


def finish_step_problems(seq, cfg, dev, inputs=None) -> dict:
    """K31 at the main path's shapes: path 1's ASSOC_STEP-th step
    (tail_step_inputs, the inputs tail_frame_parity holds), steps
    ASSOC_STEP - 3 .. ASSOC_STEP in one launch ("b4"), the two random
    tails of tail_kernel_parity, and every TAIL_PLANTED problem alone
    (`<case>_<k>`, lane 0) and at B = 4. Returns {name: fn}, fn()
    launching it."""
    import torch

    from planarslam_tpu_torch.slam import device_tracker as dt

    tails = inputs or tail_step_inputs(seq, cfg, dev)
    probs = {f"step{ASSOC_STEP}": (cfg, tails[-1]),
             "b4": (cfg, dt.StepTail(*[torch.cat(x).contiguous()
                                       for x in zip(*tails)]))}
    for ok in (True, False):
        t = random_tail_problem(np.random.default_rng(31), cfg, ok)
        probs[f"random_final_{ok}"] = (cfg, _tail_of(
            {f: np.asarray(t[f])[None] for f in t}, dev))
    for case in TAIL_PLANTED:
        for k, (c, t, _) in enumerate(planted_tail_lanes(case, cfg, 4)):
            probs[f"{case}_{k}"] = (c, _tail_of({f: v[:1] for f, v in
                                                 t.items()}, dev))
            probs[f"{case}_{k}_b4"] = (c, _tail_of(t, dev))
    return {k: (lambda c=c, t=t: dt.finish_step(t, c))
            for k, (c, t) in probs.items()}


def tail_kernel_parity(seq, cfg, dev) -> list:
    """K28-K31 against their plain versions on the card, each output slot
    bit-equal and two launches equal bits. K28 on frame 0's quantized depth
    clean and with Kinect noise and on the planted ALPHA_CASES; K29 on
    those two depths at the 640x480 stride (13), on the room rendered at
    40x30, 160x120 and 320x240 (strides 1, 4 and 7, budget 2048; the last
    also with boxes of 3 and 11 pixels) and on four 640x480 depths in one
    launch (each lane bit-equal to its own launch); K30 on the planted
    PLANE_CASES; K30 and K31 on the last tracking step of a System over
    the first TAIL_FRAMES frames, clean and noisy (the map planes of frame
    0's keyframe in its window), and K31 on two
    random tails (the final pose kept and not) and on every TAIL_PLANTED
    problem (tail_planted_parity). Times at the 640x480
    shapes (median of 25 calls); K28's device time and launches per call
    on alpha_problems (one launch each). ALPHA_CASES' "wide" is 1280x960."""
    import dataclasses

    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import planes as P
    from planarslam_tpu_torch.slam import device_tracker as dt
    from planarslam_tpu_torch.slam.frame import _normal_stride

    cam, pcfg = cfg.camera, cfg.planes
    dmf = cam.depth_map_factor
    frames = [quantize_frame(*seq.render(i), dmf) for i in range(TAIL_FRAMES)]
    clean = [d.astype(np.float32) / np.float32(dmf) for _, d in frames]
    noisy = [noisy_depth(d, dmf, seed=i) for i, d in enumerate(clean)]
    depths = {"clean": clean[0], "noisy": noisy[0]}
    src = "planarslam_tpu_torch/csrc/"
    out = []

    # K28
    mx = pcfg.max_distance
    alphas = {}
    for name, d in [*depths.items(),
                    *((c, planted_alpha_depth(c)) for c in ALPHA_CASES)]:
        dd = torch.from_numpy(d).to(dev)
        got = _twice(P._noise_alpha, dd, mx)
        _tail_held(f"noise_alpha ({name})", got,
                   (P.noise_alpha_plain(dd, mx),))
        alphas[name] = float(got[0])
    _check(alphas["empty"] == 0.0 and alphas["flat"] == 0.0
           and alphas["clean"] < alphas["noisy"]
           and min(alphas[c] for c in ("duplicates", "odd", "split", "pair",
                                        "wide")) > 0,
           f"noise_alpha: the cases do not exercise it: {alphas}")
    d0 = torch.from_numpy(clean[0]).to(dev)
    h, w = clean[0].shape
    ok = (d0 > 1e-6) & (d0 < mx)
    d2 = torch.abs(d0 - 2 * torch.roll(d0, -1, 1) + torch.roll(d0, -2, 1))
    interior = ok & torch.roll(ok, -1, 1) & torch.roll(ok, -2, 1)
    sub = torch.where(interior, d2 / torch.clamp(d0, min=1.0) ** 2,
                      math.nan)[::4, ::4]
    cols = len({(x + o) % w for x in range(0, w, 4) for o in range(3)})
    k28_problems = alpha_problems(seq, cfg, dev)
    for k, fn in k28_problems.items():
        n0 = kernels.LAUNCHES["noise_alpha"]
        fn()
        _check(kernels.LAUNCHES["noise_alpha"] == n0 + 1,
               f"noise_alpha: {kernels.LAUNCHES['noise_alpha'] - n0} "
               f"launches for {k}")
    k28_timing = {f"{k}_timing": kernel_timing_entry(fn, "noise_alpha")
                  for k, fn in k28_problems.items()}
    out.append({
        "name": "noise_alpha", "route": "cuda", "library_ms": _time_ms(
            lambda: torch.nanquantile(sub, 0.5)),
        # the pixels the strided samples read; per sample the difference,
        # the division and four radix passes over it
        **_bound(4 * len(range(0, h, 4)) * cols + 4, 16.0 * sub.numel()),
        "source": src + "depth_normals.cu",
        "replaces": "planarslam_tpu/ops/planes.py:243",
        "max_abs_err": 0.0, "tolerance": "bit-equal", "cases": alphas,
        **k28_timing,
        "ms_of": "CUDA events around one wrapper call on frame 0's clean "
                 "depth, median of 25 (_time_ms); device ms per launch in "
                 "*_timing (torch.profiler)",
        "ms": _time_ms(lambda: P._noise_alpha(d0, mx)),
        "plain_ms": _time_ms(lambda: P.noise_alpha_plain(d0, mx))})

    # K29 at the 640x480 stride and at strides 1, 4 (windows that wrap
    # around the image: off = 2 < b = 3) and 7
    k = pcfg.smooth_window
    budget = cfg.manhattan.max_normals
    stride = _normal_stride(cfg)
    normals = {}
    probs = {name: (torch.from_numpy(d).to(dev), cam, stride)
             for name, d in depths.items()}
    for hs, ws in ((30, 40), (120, 160), (240, 320)):
        small = cfg.tiny(height=hs, width=ws).replace(
            manhattan=dataclasses.replace(cfg.manhattan, max_normals=budget))
        g8, d16 = quantize_frame(*synthetic.make_sequence(
            1, width=ws, height=hs).render(0), dmf)
        probs[f"{ws}x{hs}"] = (torch.from_numpy(
            d16.astype(np.float32) / np.float32(dmf)).to(dev), small.camera,
            _normal_stride(small))
    for name, (dd, c, s) in probs.items():
        args = (dd, c, k, s, budget)
        got = _twice(P.frame_normals, *args)
        _tail_held(f"frame_normals ({name})", got,
                   P.frame_normals_plain(*args))
        normals[name] = {"stride": s, "valid": int(got[1].sum())}
    _check([v["stride"] for v in normals.values()] == [stride, stride, 1, 4,
                                                        7]
           and all(v["valid"] > 100 for v in normals.values()),
           f"frame_normals: the cases do not exercise it: {normals}")
    # box sides other than the configuration's 5, whose samples read their
    # boxes from device memory, as wrapped windows do: 3 and 11
    dd, c, s = probs["320x240"]
    for kk in (3, 11):
        _tail_held(f"frame_normals (320x240, k = {kk})",
                   _twice(P.frame_normals, dd, c, kk, s, budget),
                   P.frame_normals_plain(dd, c, kk, s, budget))
    # B = 4 in one launch: frames 0 and 1, clean and noisy, each lane
    # bit-equal to its own B = 1 launch and to the plain version
    lanes = [clean[0], noisy[0], clean[1], noisy[1]]
    d4 = torch.from_numpy(np.stack(lanes)).to(dev)
    got4 = _twice(P.frame_normals, d4, cam, k, stride, budget)
    _same_lanes("frame_normals", got4, [
        [x[None] for x in P.frame_normals(torch.from_numpy(d).to(dev), cam,
                                          k, stride, budget)]
        for d in lanes])
    for b, d in enumerate(lanes):
        _tail_held(f"frame_normals (B = 4, lane {b})",
                   [x[b] for x in got4],
                   P.frame_normals_plain(torch.from_numpy(d).to(dev), cam, k,
                                         stride, budget))
    normals["b4"] = {"stride": stride, "valid": got4[1].sum(1).tolist()}
    args = (d0, cam, k, stride, budget)
    got = P.frame_normals(*args)
    out.append({
        "name": "frame_normals", "route": "cuda", "library_ms": None,
        # the depth pixels the stencils read, once; per sample the
        # (2b + 2)^2 smoothed pixels (k^2 taps each), the normal and guards
        **_bound(4 * _normal_reads(h, w, stride, k) + _nbytes(got),
                 budget * ((2 * min(stride, 3) + 2) ** 2 * 4 * k * k
                           + 200.0)),
        "source": src + "depth_normals.cu",
        "replaces": "planarslam_tpu/slam/frame.py:53",
        "max_abs_err": 0.0, "tolerance": "bit-equal", "cases": normals,
        "ms_source": MS_SOURCE,
        "ms": _time_ms(lambda: P.frame_normals(*args)),
        "plain_ms": _time_ms(lambda: P.frame_normals_plain(*args))})

    # K30 on the planted cases, and the last four of them at B = 4 (each
    # lane against the plain version)
    assoc, planted = {}, {}
    for case in PLANE_CASES:
        p = planted_plane_problem(np.random.default_rng(30), case)
        planted[case] = [torch.from_numpy(p[key][None]).to(dev)
                         for key in PLANE_KEYS]
        assoc[case] = _hold_assoc(case, planted[case], pcfg)
    assoc["planted_b4"] = _hold_assoc("planted, B = 4", [
        torch.cat(x) for x in zip(*[planted[c] for c in PLANE_CASES[-4:]])],
        pcfg)
    # K30 and K31 on the first tracking step, clean and noisy
    steps = {}
    tails = {}
    for name, ds in (("clean", clean), ("noisy", noisy)):
        fr = [(g, np.round(d * dmf).astype(np.uint16))
              for (g, _), d in zip(frames, ds)]
        a_args, tail = _last_step(fr, cfg, dev)
        steps[name] = a_args
        assoc[f"step_{name}"] = _hold_assoc(f"step {name}", a_args[:7], pcfg)
        tails[f"step_{name}"] = tail
    for ok in (True, False):
        t = random_tail_problem(np.random.default_rng(31), cfg, ok)
        tails[f"random_final_{ok}"] = dt.StepTail(*[
            torch.from_numpy(np.asarray(t[f])[None]).to(dev)
            for f in dt.StepTail._fields])
    tail_cases = {name: _hold_tail(name, t, cfg) for name, t in tails.items()}
    tplanted = tail_planted_parity(cfg, dev)
    print(f"tail_kernel_parity finish_step planted: {json.dumps(tplanted)}",
          flush=True)
    _check(assoc["step_clean"]["direct"] > 0
           and assoc["no_map"] == {"direct": 0, "par": 0, "ver": 0}
           and all(v["direct"] >= 4 and v["par"] > 0 and v["ver"] > 0
                   for c, v in assoc.items() if c in PLANE_CASES[:4]),
           f"associate_planes: the cases do not exercise it: {assoc}")
    print(f"tail_kernel_parity steps: {json.dumps(tail_cases)}", flush=True)

    a_args = steps["clean"][:7]
    n_pts = torch.clamp(a_args[5][0], 0, a_args[4].shape[2])
    cloud_pts = int(n_pts[a_args[6][0]].sum())
    n_p, n_m = a_args[0].shape[1], a_args[3].shape[1]
    assoc_out = dt._associate_planes_device(*a_args, pcfg)
    out.append({
        "name": "associate_planes", "route": "cuda", "library_ms": None,
        "planes": {k: plane_stats(a[:7]) for k, a in steps.items()},
        # the plane rows, the counts and flags, and of the clouds the
        # points of the valid map planes (the rest never enter a decision)
        **_bound(_nbytes(a_args[:4], a_args[5:], assoc_out)
                 + 12 * cloud_pts, 7.0 * n_p * cloud_pts + 20.0 * n_p * n_m),
        "source": src + "step_tail.cu",
        "replaces": "planarslam_tpu/slam/device_tracker.py:185",
        "max_abs_err": 0.0, "tolerance": "bit-equal", "cases": assoc,
        "ms": _time_ms(lambda: dt._associate_planes_device(*a_args, pcfg)),
        "plain_ms": _time_ms(lambda: dt._associate_planes_plain(
            *[a[0] for a in a_args], pcfg))})

    tail = tails["step_clean"]
    tail_out = dt.finish_step(tail, cfg)
    n_k = tail.inl.shape[1]
    n_wv, n_lv = int(tail.win_valid.sum()), int(tail.ln_valid.sum())
    read = tail._replace(T1=None, win_xyz=None, ln_sw=None, ln_ew=None)
    out.append({
        "name": "finish_step", "route": "cuda", "library_ms": None,
        # the flags, indices and per-feature rows, one of the two poses
        # (n_in2 picks it), and the coordinates of the valid window points
        # and lines alone (no other row is projected); per valid window
        # point or line the transform, projection and gates (~30), per
        # feature the slot, counts and lift (~30)
        **_bound(_nbytes(read, tail_out) + 12 * n_wv + 24 * n_lv,
                 30.0 * (n_wv + n_lv + n_k)),
        "source": src + "step_tail.cu",
        "replaces": "planarslam_tpu/slam/device_tracker.py:440",
        "max_abs_err": 0.0, "tolerance": "bit-equal (the bundle as int32)",
        "cases": tail_cases, "planted": tplanted,
        "ms": _time_ms(lambda: dt.finish_step(tail, cfg)),
        "plain_ms": _time_ms(lambda: dt.finish_step_plain(
            dt.StepTail(*[x[0] for x in tail]), cfg))})
    _print_kernels(out)
    return out


def tail_frame_parity(report: list, a_args, tail) -> None:
    """K30 and K31 against their plain versions on the inputs of a
    mid-sequence step of path 1 (captured at the call); the counts join
    their report entries."""
    from planarslam_tpu_torch.config import SystemConfig

    cfg = SystemConfig()
    entries = {k["name"]: k for k in report}
    entries["associate_planes"]["cases"]["path1_step"] = _hold_assoc(
        "path 1 step", a_args[:7], cfg.planes)
    entries["associate_planes"]["planes"]["path1_step"] = plane_stats(
        a_args[:7])
    entries["finish_step"]["cases"]["path1_step"] = _hold_tail(
        "path 1 step", tail, cfg)
    print(f"tail_kernel_parity path 1 step: "
          f"{entries['associate_planes']['cases']['path1_step']} "
          f"{entries['finish_step']['cases']['path1_step']}", flush=True)


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


def _rotvec_pose(rotvec, t) -> np.ndarray:
    """A 4x4 float32 pose from a rotation vector and a translation."""
    from scipy.spatial.transform import Rotation

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    T[:3, 3] = t
    return T


def _pose_problem(K, bf, seed=0, n=120, n_lines=8, n_planes=4,
                  start="near"):
    """A seeded pose_optimize problem observed from a known pose (numpy):
    n points 1.5-4 m away (0.5 px noise, the first n // 10 gross outliers,
    60% pseudo-stereo, 5% invalid), n_lines lines (one in eight invalid),
    and n_planes planes per block from the three axis families of a room,
    observed with 0.005 noise, some invalid; parallel observations pair a
    plane with another of its family, vertical ones with a neighbour of
    another family. The initial pose is a few cm and degrees off ("near"),
    the true pose ("converged": nearly every LM step is rejected), or 0.1
    rad and 0.1 m off ("far": the true rotation turned by 0.1 rad about a
    fixed axis, its translation moved by 0.1 m). Returns (T_init, points,
    lines, planes, par, ver) as lists of the fields of PointObs, LineObs
    and PlaneObs."""
    rng = np.random.default_rng(seed)
    T_true = _rotvec_pose([0.05, -0.08, 0.03], [0.1, -0.05, 0.2])
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                   rng.uniform(1.5, 4.0, n)], -1)
    Tinv = np.linalg.inv(T_true)
    xw = (pc @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2],
                   K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    n_out = n // 10
    uv[:n_out] += rng.uniform(-20, 20, (n_out, 2))  # outliers
    ur = np.where(rng.random(n) < 0.6, uv[:, 0] - bf / pc[:, 2], -1.0)
    points = [xw, uv.astype(np.float32), ur.astype(np.float32),
              (1.2 ** (-2.0 * rng.integers(0, 4, n))).astype(np.float32),
              rng.random(n) < 0.95]
    L = n_lines
    s_c = np.stack([rng.uniform(-1, 1, L), rng.uniform(-1, 1, L),
                    rng.uniform(2, 3, L)], -1)
    e_c = s_c + rng.normal(0, 0.5, (L, 3)) * [1, 1, 0.1]

    def proj(p):
        return np.stack([K[0] * p[:, 0] / p[:, 2] + K[2],
                         K[1] * p[:, 1] / p[:, 2] + K[3], np.ones(len(p))],
                        -1)

    l2d = np.cross(proj(s_c), proj(e_c))
    l2d /= np.linalg.norm(l2d[:, :2], axis=1, keepdims=True)
    lines = [(s_c @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32),
             (e_c @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32),
             l2d.astype(np.float32), np.ones(L, np.float32),
             np.arange(L) % 8 < 7]
    P = n_planes
    k = np.arange(P)
    n_c = np.array([[0, 0, -1.0], [1.0, 0, 0], [0, -1.0, 0]])[k % 3]
    d_c = np.resize([3.5, 1.2, 0.9, 5.0], P) + 0.3 * (k // 4)
    pi_c = np.concatenate([n_c, d_c[:, None]], 1)
    # world planes: the camera planes moved by T_true^-1
    nw = n_c @ Tinv[:3, :3].T
    dw = d_c - nw @ Tinv[:3, 3]
    pi_w = np.concatenate([nw, dw[:, None]], 1).astype(np.float32)
    pi_obs = (pi_c + rng.normal(0, 0.005, pi_c.shape)).astype(np.float32)
    planes = [pi_w, pi_obs, k % 4 != 3]
    par = [pi_w[(k + 3) % P], pi_obs, k % 4 == 0]
    ver = [pi_w[k ^ 1], pi_obs, k % 4 < 2]
    if start == "near":
        T_init = _rotvec_pose([0.06, -0.07, 0.035], [0.13, -0.07, 0.17])
    elif start == "converged":
        T_init = T_true
    elif start == "far":
        u = np.array([1.0, -2.0, 2.0]) / 3.0
        T_init = T_true.copy()
        T_init[:3, :3] = _rotvec_pose(0.1 * u, [0, 0, 0])[:3, :3] \
            @ T_true[:3, :3]
        T_init[:3, 3] = T_true[:3, 3] + 0.1 * u[[2, 0, 1]]
    else:
        raise ValueError(f"start: {start!r}")
    return T_init.astype(np.float32), points, lines, planes, par, ver


def horn_problem(seed: int = 6, scale: float = 1.0, n: int = 1024) -> tuple:
    """K6's seeded problem (numpy): n correspondences, 60% inliers of a
    planted similarity (scale, 1 cm noise), padded with the default_rng(7)
    triplets by sim3_solver._pad_pair: (src, dst, valid, triplets)."""
    from planarslam_tpu_torch.solvers import sim3_solver

    rng = np.random.default_rng(seed)
    src = rng.uniform([-3, -2, 1], [3, 2, 7], (n, 3)).astype(np.float32)
    Tg = _planted_se3(rng)
    dst = scale * (src @ Tg[:3, :3].T) + Tg[:3, 3] + rng.normal(0, 0.01,
                                                                (n, 3))
    bad = rng.random(n) >= 0.6
    dst[bad] = rng.uniform([-3, -2, 1], [3, 2, 7], (int(bad.sum()), 3))
    return sim3_solver._pad_pair(src, dst.astype(np.float32), 64)


def pnp_problem(cam, n: int = 256, seed: int = 7,
                picks_seed: int = 11) -> tuple:
    """K7's seeded problem (numpy): n points 2-6 m in front of a planted
    pose, 0.5 px noise, 20% outliers moved 20-60 px, the 128
    default_rng(picks_seed) picks: (xw, uv_n, inv_sigma2, valid, picks)."""
    rng = np.random.default_rng(seed)
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    Tg = _planted_se3(rng, 0.1)
    pc = xw @ Tg[:3, :3].T + Tg[:3, 3]
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uv = uv + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) >= 0.8
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    uv_n = np.stack([(uv[:, 0] - cam.cx) / cam.fx,
                     (uv[:, 1] - cam.cy) / cam.fy], -1).astype(np.float32)
    picks = np.random.default_rng(picks_seed).integers(0, n, (128, 6)).astype(
        np.int32)
    return (xw, uv_n, np.full(n, np.float32(cam.fx * cam.fy), np.float32),
            np.ones(n, bool), picks)


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
                "library_ms": None,
                # per pair the 4 x 4 DLT's null vector (float64) and both
                # views' gates (float32)
                **_bound(_nbytes(args5[:7], Xk, gk), GATE_PAIR_OPS * NB * Kp,
                         n_ops_fp64=DLT_PAIR_OPS * NB * Kp),
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
    n = 1024
    s_p, d_p, v_p, picks = horn_problem(6)
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
    modes = horn_mode_parity(t, s_p, d_p, v_p, picks, args6)
    args6s = modes.pop("scale_args")
    out.append({"name": "horn_align_batch", "route": "cuda",
                "library_ms": None,
                # per row and point: weighted sums, covariance (float64),
                # inlier test
                **_bound(_nbytes(args6[:4], k6), 40.0 * w.size,
                         FP64_OPS_PER_S),
                "source": "planarslam_tpu_torch/csrc/horn_align.cu",
                "replaces": "planarslam_tpu/solvers/sim3_solver.py:23",
                "modes": "weights, triplets, refit; each with the scale",
                "max_abs_err": max(err6, modes["scale_err"]),
                "tolerance": "n_inl equal, R t 1e-4; triplets and refit "
                             "bit-equal to weights launches; scale 1e-5",
                "best_inliers": best, **modes,
                "ms": _time_ms(lambda: sim3_solver.horn_align_batch(*args6)),
                "plain_ms": _time_ms(
                    lambda: sim3_solver.horn_align_batch_plain(*args6)),
                "ransac_ms": _time_ms(
                    lambda: sim3_solver._ransac_align(*args6s)),
                "ransac_plain_ms": _time_ms(
                    lambda: sim3_solver._ransac_align_plain(
                        *[a[0] for a in args6s[:4]], *args6s[4:]))})

    # K7: 256 correspondences, 80% inliers (0.5 px), the 128 DLT hypotheses
    # of the RANSAC (default_rng(11) picks)
    n = 256
    prob7 = pnp_problem(cam, n)
    picks = prob7[4]
    args7 = (*[t(a) for a in prob7], 5.991)
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
    held = pnp_distinct_picks(picks, sk, Tk, Tp, n)
    k46 = pnp_select_parity(args7, sk, Tk)
    out.append({"name": "pnp_dlt_hypotheses", "route": "cuda",
                "library_ms": None,
                # per hypothesis (float64) the 12 x 12 DLT (48 products),
                # its smallest right singular vector, the depths' sign (42),
                # the 3 x 3 SVD of P's left block and R, t (60); the
                # reprojection score of every point (float32)
                **_bound(_nbytes(args7[:5], sk, Tk), 128 * 30.0 * n,
                         n_ops_fp64=128 * (48 + svd_ops(12, 12, False) + 42
                                           + svd_ops(3, 3, True) + 60)),
                "source": "planarslam_tpu_torch/csrc/pnp_dlt.cu",
                "replaces": "planarslam_tpu/solvers/pnp.py:25",
                "max_abs_err": max(err_R, err_t),
                "tolerance": "scores +-2 on >= 95%, best T 0.01 / 0.05; "
                             "T 1e-5 of max(1, |T|) where the picks are "
                             "distinct",
                "scores_within_2": close,
                "max_score_diff": int((sk - sp).abs().max()), **held,
                "ms": _time_ms(lambda: pnp.pnp_dlt_hypotheses(*args7)),
                "plain_ms": _time_ms(
                    lambda: pnp.pnp_dlt_hypotheses_plain(*args7))})
    out.append(k46)
    _print_kernels(out)
    return out


def horn_mode_parity(t, s_p, d_p, v_p, picks, args6) -> dict:
    """K6's triplet, refit and scale modes on the card: the triplet launch
    bit-equal to the weights launch on the rows the plain version builds
    (sim3_solver.triplet_weights), the refit bit-equal to the plain pick of
    the best row (torch.argmax) and a weights launch on its inliers, each
    twice; the scale mode (a planted similarity, scale 1.3) within 1e-5 of
    its plain version (R, t of max(1, |t|), s relative) on the rows whose
    triplet is distinct and on the refit, with equal counts and masks.
    Returns the figures and the scale RANSAC's arguments."""
    import torch

    from planarslam_tpu_torch.solvers import sim3_solver

    dev = args6[0].device
    one = [t(a[None]) for a in (s_p, d_p, v_p, picks)]
    trip = _twice(sim3_solver.horn_triplets, *one, 0.08)
    rows = sim3_solver.triplet_weights(torch.from_numpy(v_p),
                                       torch.from_numpy(picks)).to(dev)
    by_w = sim3_solver.horn_align_batch(*args6[:3], rows, 0.08)
    _check(same_bits([x[0] for x in (trip[0], trip[1], trip[3], trip[4])],
                     by_w), "horn_triplets: differs from the weights launch "
           "on the plain version's rows")
    refit = _twice(sim3_solver.horn_refit, *one[:3], trip[3], trip[4],
                   0.08)[0]
    best = int(torch.argmax(trip[3][0]))
    w_best = (trip[4][0, best].to(torch.float32) + 1e-9)[None].contiguous()
    R, tt, n_inl, inl = sim3_solver.horn_align_batch(*args6[:3], w_best, 0.08)
    want = torch.cat([R.reshape(9), tt.reshape(3),
                      torch.ones(1, device=dev), n_inl.view(torch.float32),
                      inl[0].to(torch.float32)])
    _check(same_bits([refit[0]], [want]), "horn_refit: differs from the "
           "plain pick and a weights launch")
    # the scale mode on a planted similarity
    prob = horn_problem(46, 1.3)
    pk = prob[3]
    sc = [t(a[None]) for a in prob]
    got = _twice(sim3_solver.horn_triplets, *sc, 0.08, True)
    want = sim3_solver.horn_triplets_plain(*[a[0] for a in sc], 0.08, True)
    distinct = torch.from_numpy(np.array([len(set(p)) == 3 for p in pk]))
    rows = distinct.to(dev)

    def rel(a, b, scale):
        return float(((a - b).abs() / scale).max())

    err = max(rel(got[0][0][rows], want[0][rows], 1.0),
              rel(got[1][0][rows], want[1][rows],
                  want[1][rows].abs().clamp(min=1.0)),
              rel(got[2][0][rows], want[2][rows], want[2][rows].abs()))
    _check(err <= 1e-5, f"horn_triplets (scale): {err} from the plain "
           f"version")
    _check(bool((got[3][0] == want[3]).all()) and bool(
        (got[4][0] == want[4]).all()),
           "horn_triplets (scale): counts or masks differ from the plain "
           "version")
    row = _twice(sim3_solver.horn_refit, *sc[:3], got[3], got[4], 0.08,
                 True)[0][0]
    prow = sim3_solver.horn_refit_plain(*[a[0] for a in sc[:3]], want[3],
                                        want[4], 0.08, True)
    r_err = max(rel(row[:9], prow[:9], 1.0),
                rel(row[9:12], prow[9:12], prow[9:12].abs().clamp(min=1.0)),
                rel(row[12:13], prow[12:13], prow[12:13].abs()))
    _check(r_err <= 1e-5 and same_bits([row[13:]], [prow[13:]]),
           f"horn_refit (scale): {r_err} from the plain version, or its "
           f"count or mask differs")
    s_est = float(row[12])
    _check(abs(s_est - 1.3) < 0.01, f"horn_refit (scale): s = {s_est}, "
           f"planted 1.3")
    return {"triplets_bit_equal": True, "refit_bit_equal": True,
            "scale_err": max(err, r_err), "scale": s_est,
            "scale_repeated_triplets": int((~distinct).sum()),
            "scale_args": (*sc, 0.08, True)}


def pnp_distinct_picks(picks, sk, Tk, Tp, n: int) -> dict:
    """K7 against the float64 plain version per hypothesis: T within 1e-5
    of max(1, |T|) where the 6 picks are distinct; a hypothesis that
    repeats a point (its DLT null space has dimension 2 or more) held to
    nothing but a score in [-1, n]."""
    import torch

    distinct = torch.from_numpy(np.array([len(set(p)) == 6 for p in picks]))
    rows = distinct.to(Tk.device)
    scale = Tp.abs().clamp(min=1.0)
    err = float(((Tk - Tp).abs() / scale)[rows].max())
    _check(err <= 1e-5, f"pnp_dlt_hypotheses: T {err} from the plain "
           f"version on distinct picks")
    _check(bool(((sk >= -1) & (sk <= n)).all()),
           "pnp_dlt_hypotheses: a score outside [-1, n]")
    return {"distinct_T_err": err, "repeated_picks": int((~distinct).sum())}


def pnp_select_parity(args7, sk, Tk) -> dict:
    """K46 bit-equal to its plain version on K7's outputs, twice, at B = 1
    and four lanes at B = 4 (the problem with its scores rolled), its count
    K7's best score; its kernels row."""
    import torch

    from planarslam_tpu_torch.solvers import pnp

    ins = [a[None] for a in args7[:4]]
    got = _twice(pnp.pnp_select, *ins, sk[None], Tk[None], 5.991)[0]
    want = pnp.pnp_select_plain(*args7[:4], sk, Tk, 5.991)
    _check(same_bits([got[0]], [want]), "pnp_select: differs from the plain "
           "version")
    count = int(got[0, 16:17].view(torch.int32))
    _check(count == int(sk.max()), f"pnp_select: count {count}, K7's best "
           f"score {int(sk.max())}")
    lanes = [torch.roll(sk, 7 * b) for b in range(4)]
    lane_T = [torch.roll(Tk, 7 * b, 0) for b in range(4)]
    b4 = pnp.pnp_select(*[a.expand(4, *a.shape[1:]).contiguous()
                          for a in ins], torch.stack(lanes),
                        torch.stack(lane_T), 5.991)
    for b in range(4):
        _check(same_bits([b4[b]], [pnp.pnp_select(
            *ins, lanes[b][None], lane_T[b][None], 5.991)[0]]),
               f"pnp_select: lane {b} of B = 4 differs from its own launch")
    n, h = args7[0].shape[0], sk.shape[0]
    return {"name": "pnp_select", "route": "cuda", "library_ms": None,
            # the scores' arg-max, then per point 9 multiply-adds, two
            # divisions and the chi2 in float32; of the Ts it reads only the
            # winner's 16 floats
            **_bound(_nbytes(args7[:4], sk, got) + 4 * 16,
                     4.0 * h + 25.0 * n),
            "source": "planarslam_tpu_torch/csrc/pnp_dlt.cu",
            "replaces": "planarslam_tpu/solvers/pnp.py:63",
            "max_abs_err": 0.0, "tolerance": "bit-equal",
            "count": count,
            "ms": _time_ms(lambda: pnp.pnp_select(*ins, sk[None], Tk[None],
                                                  5.991)),
            "plain_ms": _time_ms(lambda: pnp.pnp_select_plain(
                *args7[:4], sk, Tk, 5.991)),
            "ransac_ms": _time_ms(lambda: pnp._pnp_ransac(
                ins[0], ins[1], ins[3], ins[2], args7[4][None], 5.991)),
            "ransac_plain_ms": _time_ms(lambda: pnp.pnp_select_plain(
                *args7[:4], *pnp.pnp_dlt_hypotheses_plain(*args7), 5.991))}


POSE_BLOCKS = ("points", "lines", "planes", "par_planes", "ver_planes")
POSE_MASKS = ("point_inlier", "line_inlier", "plane_inlier", "par_inlier",
              "ver_inlier")


def _pose_rows(kw) -> int:
    """Residual rows of a pose_optimize call: 3 per point, 2 per line, 3
    per plane, 2 per parallel or vertical plane."""
    per = dict(points=3, lines=2, planes=3, par_planes=2, ver_planes=2)
    return sum(per[k] * kw[k].valid.shape[0] for k in POSE_BLOCKS
               if kw.get(k) is not None)


def _pose_bound(args, kw, out) -> dict:
    """K11's bound: its inputs read and outputs written once; per residual
    row and round, ~110 operations at the round's first pose (residual,
    Jacobian, weight, the 28 sums of J^T W J, J^T W r and chi2), ~135 at
    the new pose of each LM step but the last (the same, and the accept
    test's weighted chi2) and ~25 at the last one's (its chi2, whose
    per-item terms also give the round's gates)."""
    rows = _pose_rows(kw)
    n_rounds, n_iters = kw.get("n_rounds", 4), kw.get("n_iters", 10)
    ops = rows * n_rounds * (110 + 135 * (n_iters - 1) + 25)
    return _bound(_nbytes(args, [kw[k] for k in POSE_BLOCKS
                                 if kw.get(k) is not None], out), ops)


def _pose_compare(args, kw, exact_masks: bool) -> dict:
    """K11 against its plain version on the same inputs: the pose error,
    the inlier-flag mismatches, and how many of those lie within 1e-4
    relative of their chi2 gate (at the kernel's or the plain version's
    pose). With exact_masks no mismatch is allowed."""
    import torch

    from planarslam_tpu_torch.solvers import pose_opt

    got = pose_opt.pose_optimize(*args, **kw)
    want = pose_opt._pose_optimize_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.T_cw - want.T_cw).abs().max())
    flips = {m: (getattr(got, m) != getattr(want, m)) for m in POSE_MASKS}
    n_flips = int(sum(int(f.sum()) for f in flips.values()))
    near = 0
    if n_flips:
        w = kw.get("weights") or pose_opt._default_weights()
        T0, K, bf = args
        dev = T0.device
        empty = (pose_opt._empty_points, pose_opt._empty_lines,
                 *[pose_opt._empty_planes] * 3)
        full = [kw.get(k) or e(dev) for k, e in zip(POSE_BLOCKS, empty)]
        K = tuple(float(np.float32(v)) for v in K)
        bf = float(np.float32(bf))
        gates = (torch.where(full[0].u_right >= 0, pose_opt.CHI2_STEREO,
                             pose_opt.CHI2_MONO),
                 2.0 * pose_opt.CHI2_MONO, w.plane_chi, w.vp_chi, w.vp_chi)
        chis = []
        for T in (got.T_cw, want.T_cw):
            res = pose_opt._block_residuals(T, K, bf, *full)
            c = list(pose_opt._chi2_blocks(res, full[0], full[1], w))
            chis.append(c)
        for i, m in enumerate(POSE_MASKS):
            lo = torch.minimum(chis[0][i], chis[1][i])
            hi = torch.maximum(chis[0][i], chis[1][i])
            g = torch.as_tensor(gates[i], device=dev)
            at_gate = (lo <= g * (1 + 1e-4)) & (hi >= g * (1 - 1e-4))
            if at_gate.dim() > 1:  # lines: either endpoint
                at_gate = at_gate.any(dim=-1)
            near += int((flips[m] & at_gate).sum())
    res = {"pose_err": err, "mask_flips": n_flips, "flips_at_gate": near,
           "n_inliers": int(got.n_point_inliers),
           "n_inliers_plain": int(want.n_point_inliers),
           "chi2": float(got.chi2), "chi2_plain": float(want.chi2)}
    _check(err <= 1e-4, f"pose_optimize: pose error {err} > 1e-4 ({res})")
    _check(n_flips == 0 if exact_masks else near == n_flips,
           f"pose_optimize: inlier flags differ away from their gates "
           f"({res})")
    return res


POSE_ABLATION = ((1, 1), (1, 10), (4, 10))  # (n_rounds, n_iters)


def pose_problem(cfg, dev, start: str):
    """_pose_problem on the card at the main path's width (N =
    max_keypoints, L = max_lines, P = 16 per plane block;
    tests/test_torch_matching_poseopt.py's full-width case), rotation not
    fixed: ((T_init, K, bf), the keyword arguments of pose_optimize)."""
    import torch

    from planarslam_tpu_torch.solvers import pose_opt

    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    T0, pts, lns, pls, par, ver = _pose_problem(
        K, cam.bf, n=cfg.orb.max_keypoints, n_lines=cfg.lines.max_lines,
        n_planes=16, start=start)
    kw = dict(points=pose_opt.PointObs(*map(t, pts)),
              lines=pose_opt.LineObs(*map(t, lns)),
              planes=pose_opt.PlaneObs(*map(t, pls)),
              par_planes=pose_opt.PlaneObs(*map(t, par)),
              ver_planes=pose_opt.PlaneObs(*map(t, ver)),
              weights=pose_opt.PoseOptWeights.from_config(cfg.planes),
              rotation_fixed=torch.tensor(False, device=dev))
    return (t(T0), K, cam.bf), kw


def pose_timing(args, kw) -> dict:
    """K11's times on one problem: ms per wrapper call, its device ms per
    call under the profiler, ms at each (n_rounds, n_iters) of
    POSE_ABLATION and the ms per LM step and per call fitted to them."""
    from planarslam_tpu_torch.solvers import pose_opt

    ablation = {f"{r}x{i}": _time_ms(lambda: pose_opt.pose_optimize(
        *args, n_rounds=r, n_iters=i, **kw)) for r, i in POSE_ABLATION}
    steps = [r * i for r, i in POSE_ABLATION]
    per_step, per_call = np.polyfit(steps, list(ablation.values()), 1)
    split = _launch_split(lambda: pose_opt.pose_optimize(*args, **kw),
                          match="pose_opt_kernel")
    return {"ms": _time_ms(lambda: pose_opt.pose_optimize(*args, **kw)),
            "device_ms": sum(v["ms"] for v in split.values()),
            "step_ablation_ms": ablation, "ms_per_lm_step": float(per_step),
            "ms_per_call_fixed": float(per_call)}


def pose_kernel_parity(cfg, dev) -> list:
    """K11 against its plain version on the card on the seeded problem at
    the main path's width (pose_problem), with rotation_fixed False and
    True, masks exact; from the true pose
    ("converged": nearly every LM step is rejected, so the kernel reuses
    the sums it has), masks exact; and 0.1 rad / 0.1 m off with its 10%
    outliers ("far"), masks flipping only at their gates; the pose within
    1e-4 in every case. Timed with rotation_fixed False (pose_timing)."""
    import torch

    from planarslam_tpu_torch.solvers import pose_opt

    args, kw = pose_problem(cfg, dev, "near")
    cases = {}
    for rf in (False, True):
        kw["rotation_fixed"] = torch.tensor(rf, device=dev)
        cases[f"rotation_fixed={rf}"] = _pose_compare(args, kw, True)
    for start in ("converged", "far"):
        cases[start] = _pose_compare(*pose_problem(cfg, dev, start),
                                     start == "converged")
    print(f"pose_optimize seeded problem: {json.dumps(cases)}", flush=True)
    kw["rotation_fixed"] = torch.tensor(False, device=dev)
    out_k = pose_opt.pose_optimize(*args, **kw)
    timing = pose_timing(args, kw)
    entry = {"name": "pose_optimize", "route": "cuda", "library_ms": None,
             **_pose_bound(args, kw, out_k),
             "source": "planarslam_tpu_torch/csrc/pose_opt.cu",
             "replaces": "planarslam_tpu/solvers/pose_opt.py:163",
             "max_abs_err": max(c["pose_err"] for c in cases.values()),
             "tolerance": "pose 1e-4, masks exact (far start: flips only "
                          "at their gates)",
             "rows": _pose_rows(kw), "seeded": cases, **timing,
             "plain_ms": _time_ms(
                 lambda: pose_opt._pose_optimize_plain(*args, **kw))}
    _print_kernels([entry])
    print(f"pose_optimize step ablation: "
          f"{json.dumps(timing['step_ablation_ms'])} "
          f"ms_per_lm_step={timing['ms_per_lm_step']:.5f} "
          f"ms_per_call_fixed={timing['ms_per_call_fixed']:.5f} "
          f"device_ms={timing['device_ms']:.5f}", flush=True)
    return [entry]


def _lane0(obj):
    """Lane 0 of a call's batched (B = 1) tensors, tuples and dicts
    walked."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj[0]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_lane0(x) for x in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(_lane0(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _lane0(v) for k, v in obj.items()}
    return obj


def pose_frame_parity(entry: dict, captured: list) -> None:
    """K11 against its plain version on the inputs of the two calls of one
    tracked frame of path 1 (obs1 and obs2, captured at the call, the
    step's one lane); the results join K11's report entry."""
    frame = {}
    for name, (args, kw) in zip(("obs1", "obs2"), captured):
        frame[name] = _pose_compare(*_lane0((args, kw)), False)
        frame[name]["rows"] = _pose_rows(_lane0(kw))
    print(f"pose_optimize tracked frame: {json.dumps(frame)}", flush=True)
    entry["tracked_frame"] = frame
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               *(c["pose_err"] for c in frame.values()))


def _max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


# float32 evaluation noise of the moment fit allowed on top of the plain
# version's own distance from the float64 run: cov = s2 / n - mean mean^T
# cancels terms of size z^2 <= 16 m^2 (an ulp there is 1.9e-6) down to the
# mse, and the normal, d and the centroid inherit that over the eigen-gap
REFIT_EPS = {"normal": 5e-5, "d": 5e-5, "mse": 4e-6, "mean": 5e-5}


# The same allowance for K12's candidate fits: a thin component (a strip of
# blocks) has an eigen-gap of ~1e-3 m^2, so the 1e-6 rounding of its float32
# covariance tilts its normal by up to ~1e-3 whatever the sums' accuracy;
# kernel and plain version then both sit 2-5e-4 from the float64 refit.
CANDIDATE_EPS = 5e-4
# A float32 covariance is rounded at ~2e-6 m^2 (an ulp of z^2 <= 16), which
# tilts the normal by about that over the gap between the two smallest
# eigenvalues: under 4e-3 m^2 (a strip narrower than 0.22 m) the fit is not
# defined to the 2e-3 the comparison asks for.
MIN_EIGEN_GAP = 4e-3


def plane_refit_compare(args, planes, fit, area: float):
    """One K13 round on the card against its plain version and against the
    plain version run in float64 on the same inputs. The float32 plain
    version and the kernel round their moment sums differently and the mse
    they feed cancels, so the kernel is not held to the plain version's
    bits: each fitted output must lie no further from the float64 run than
    the plain version does plus REFIT_EPS, the support within two
    subsampled pixels more, the alive masks equal and the labels equal on
    >= 99.5% of the pixels. Returns (the kernel's PlaneRefit, the errors)."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    depth, alpha, cam, pc = args
    got = P.plane_assign_refit(*args, *planes, fit)
    again = P.plane_assign_refit(*args, *planes, fit)
    want = P.plane_assign_refit_plain(*args, *planes, fit)

    def dbl(ts):
        return tuple(t.double() if t.is_floating_point() else t for t in ts)

    ref = P.plane_assign_refit_plain(
        depth.double(), alpha.double(), cam, pc, *dbl(planes),
        None if fit is None else dbl(fit))
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           "plane_assign_refit: two launches on equal inputs differ")
    _check(torch.equal(got.alive, want.alive) and torch.equal(got.alive,
                                                              ref.alive),
           "plane_assign_refit: alive masks differ")
    m = ref.alive & (ref.n > 3)
    res = {"planes": int(m.sum()),
           "labels_equal": float((got.label_sub == want.label_sub)
                                 .float().mean()),
           "labels_equal_f64": float((got.label_sub == ref.label_sub)
                                     .float().mean())}
    _check(res["planes"] > 0, "plane_assign_refit: no plane in the input")
    _check(res["labels_equal"] >= 0.995,
           f"plane_assign_refit: labels equal on {res['labels_equal']}")
    for name in ("normal", "d", "mse", "mean", "n"):
        ek = _max_err(getattr(got, name)[m], getattr(ref, name)[m])
        ep = _max_err(getattr(want, name)[m], getattr(ref, name)[m])
        eps = 2.0 * area if name == "n" else REFIT_EPS[name]
        res[name] = {"kernel_vs_f64": ek, "plain_vs_f64": ep}
        _check(ek <= ep + eps, f"plane_assign_refit: {name} is {ek} from "
               f"the float64 run, the plain version {ep} (+ {eps})")
    res["max_abs_err"] = max(_max_err(got.normal[m], want.normal[m]),
                             _max_err(got.d[m], want.d[m]),
                             _max_err(got.mean[m], want.mean[m]))
    return got, res


def _component_fits_f64(stats, cand, p_cap: int):
    """The per-component refit of plane_components_plain in float64 over
    the components of `cand` (its labels and block validity): (normal, d,
    eigen-gap of the covariance above its smallest eigenvalue) of the
    top-P components, in the plain version's order."""
    import torch

    from planarslam_tpu_torch.ops import planes as P
    from planarslam_tpu_torch.ops.lax_compat import segment_sum, top_k

    nb = cand.labels.numel()
    bv = cand.block_valid.double()
    seg = torch.where(cand.block_valid, cand.labels.long(), nb)
    s1 = segment_sum(stats.s1.double() * bv[:, None], seg, nb + 1)
    s2 = segment_sum(stats.s2.double() * bv[:, None, None], seg, nb + 1)
    n = segment_sum(stats.n.double() * bv, seg, nb + 1)
    top_n, top_idx = top_k(n[:nb], p_cap)
    s1, s2, top_n = s1[top_idx], s2[top_idx], torch.clamp(top_n, min=1.0)
    mean = s1 / top_n[:, None]
    cov = s2 / top_n[:, None, None] - mean[:, :, None] * mean[:, None, :]
    ev = torch.linalg.eigvalsh(cov)
    return P._plane_from_moments(s1, s2, top_n)[:2] + (ev[:, 1] - ev[:, 0],)


def components_compare(stats, hb: int, wb: int, pc, exact: bool):
    """K12 on one frame's block moments against its plain version (the
    limits of plane_segment_compare), two launches equal bits. Returns
    (the kernel's PlaneCandidates, the errors)."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    got = P.plane_components(stats, hb, wb, pc)
    again = P.plane_components(stats, hb, wb, pc)
    want = P.plane_components_plain(stats, hb, wb, pc)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           "plane_components: two launches on equal inputs differ")
    nb = hb * wb
    k12 = {"block_valid_differ": int((got.block_valid != want.block_valid)
                                     .sum()),
           "labels_differ": int((got.labels != want.labels).sum()),
           "cand_valid_differ": int((got.valid != want.valid).sum()),
           "candidates": int(want.valid.sum()),
           "valid_blocks": int(want.block_valid.sum())}
    v = want.valid
    ref = _component_fits_f64(stats, want, pc.max_planes)

    def per_plane(a, b):  # (P,) largest |normal| or |d| difference
        return torch.maximum(
            (a.normal.double() - b[0]).abs().amax(dim=-1),
            (a.d.double() - b[1]).abs())

    ek, ep = per_plane(got, ref), per_plane(want, ref)
    well = v & (ref[2] >= MIN_EIGEN_GAP)
    k12.update(
        well_conditioned=int(well.sum()),
        max_abs_err=float(per_plane(got, (want.normal, want.d))[well].max()),
        kernel_vs_f64=ek[v].tolist(), plain_vs_f64=ep[v].tolist())
    _check(k12["well_conditioned"] > 0,
           "plane_components: no well-conditioned candidate")
    lim = 0 if exact else 0.005 * nb
    _check(k12["cand_valid_differ"] == 0
           and k12["block_valid_differ"] <= lim
           and k12["labels_differ"] <= lim
           and k12["max_abs_err"] <= 2e-3 + CANDIDATE_EPS
           and bool((ek[well] <= ep[well] + CANDIDATE_EPS).all()),
           f"plane_components differs from plain: {k12}")
    return got, k12


def components_lanes(seq, cfg, dev) -> dict:
    """K12 on frame 0 of eight lanes (components_problems' inputs) in one
    launch: each lane bit-equal to its own B = 1 launch and held to its
    plain version (the noisy-depth limits: the lanes' frames are not
    frame 0); and the launch captured in a CUDA graph, replayed twice,
    bit-equal to the eager launch."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    pc = cfg.planes
    stats, hb, wb = components_inputs(seq, cfg, dev)
    got = P.plane_components(stats, hb, wb, pc)
    lanes = [P._BlockStats(*[x[b:b + 1].contiguous() for x in stats])
             for b in range(stats.n.shape[0])]
    _same_lanes("plane_components (B = 8)", got,
                [P.plane_components(x, hb, wb, pc) for x in lanes])
    res = {"lanes": len(lanes), "candidates": []}
    for x in lanes:
        _, k12 = components_compare(P._BlockStats(*[y[0] for y in x]), hb,
                                    wb, pc, exact=False)
        res["candidates"].append(k12["candidates"])
    # capture: a later PR captures the step as a CUDA graph
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        P.plane_components(stats, hb, wb, pc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = P.plane_components(stats, hb, wb, pc)
    for _ in range(2):
        for t in cap:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(cap, got)),
               "plane_components: the graph replay differs from the "
               "eager launch")
    res["graph_replay_bit_equal"] = True
    return res


def plane_segment_compare(depth, cfg, exact: bool) -> dict:
    """K12, the 1 + refine_rounds rounds of K13 and K14 against their plain
    versions on one depth map on the card, each stage on the kernel's own
    earlier outputs. K12: block validity, labels and candidate validity
    equal on clean depth (`exact`); on noisy depth a block fit can sit on
    its mse gate, so block validity and labels may differ on <= 0.5% of
    the blocks while candidate validity stays equal. The candidate fits
    come from sums over up to thousands of blocks whose covariance
    cancels, which the kernel takes in float64 and the plain version in
    float32 one block after the other: each candidate must lie no further
    from the plain version's refit taken in float64 over the same
    components than the float32 plain version does plus CANDIDATE_EPS, and
    within 2e-3 + CANDIDATE_EPS of the plain version. A strip one block
    wide (a wall's edge) has no well-defined normal (there the float32
    plain version itself lands up to 0.12 m from the float64 refit):
    candidates whose covariance has an eigen-gap under MIN_EIGEN_GAP are
    reported and not held.
    K13: plane_refit_compare. K14:
    validity and counts equal, coefficients within 1e-5, pixel labels
    equal on >= 99.9% of the pixels."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    pc, cam = cfg.planes, cfg.camera
    h, w = depth.shape
    hb, wb = h // pc.block, w // pc.block
    alpha = P._noise_alpha(depth, pc.max_distance)
    stats = P.plane_block_moments(depth, alpha, cam, P._geo_tol(w),
                                  pc.max_distance, pc.block)
    res = {"alpha": float(alpha)}

    got, res["plane_components"] = components_compare(stats, hb, wb, pc,
                                                      exact)
    args = (depth, alpha, cam, pc)
    area = float(max(1, pc.refine_stride) ** 2)
    rounds = []
    fit, r = plane_refit_compare(args, (got.normal, got.d, got.valid), None,
                                 area)
    rounds.append(r)
    for _ in range(pc.refine_rounds):
        fit, r = plane_refit_compare(args, (fit.normal, fit.d, fit.alive),
                                     (fit.mse, fit.mean, fit.n), area)
        rounds.append(r)
    res["plane_assign_refit"] = rounds

    out = P.plane_label_pixels(*args, fit)
    out2 = P.plane_label_pixels(*args, fit)
    ref = P.plane_label_pixels_plain(*args, fit)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(out, out2)),
           "plane_label_pixels: two launches on equal inputs differ")
    k14 = {"valid_differ": int((out.valid != ref.valid).sum()),
           "count_differ": int((out.count != ref.count).sum()),
           "planes": int(ref.valid.sum()),
           "max_abs_err": _max_err(out.coeffs, ref.coeffs),
           "labels_equal": float((out.pixel_label == ref.pixel_label)
                                 .float().mean()),
           "labeled": float((ref.pixel_label >= 0).float().mean())}
    res["plane_label_pixels"] = k14
    _check(k14["planes"] > 0, "plane_label_pixels: no valid plane")
    _check(k14["valid_differ"] == 0 and k14["count_differ"] == 0
           and k14["max_abs_err"] <= 1e-5 and k14["labels_equal"] >= 0.999,
           f"plane_label_pixels differs from plain: {k14}")
    res["inputs"] = (stats, hb, wb, got, fit, args)
    return res


def noisy_depth(depth_m: np.ndarray, factor: float, seed: int = 0):
    """A quantized depth map (metres) with the Kinect noise model of
    io/synthetic.py added and quantized again."""
    from planarslam_tpu_torch.io import synthetic

    rng = np.random.default_rng(seed)
    sigma = synthetic.kinect_depth_std(depth_m)
    noisy = depth_m + rng.normal(0.0, 1.0, depth_m.shape) * sigma
    noisy = np.where(depth_m > 0, np.clip(noisy, 0.0, None), 0.0)
    return (np.round(noisy * factor) / factor).astype(np.float32)


def plane_kernel_parity(seq, cfg, dev) -> list:
    """K12-K14 against their plain versions on the card at the main path's
    sizes, on frame 0's quantized depth and on the same depth with Kinect
    noise; timed on the clean depth."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import planes as P

    factor = cfg.camera.depth_map_factor
    _, d16 = quantize_frame(*seq.render(0), factor)
    clean = d16.astype(np.float32) / np.float32(factor)
    cases = {}
    for name, d in (("noisy", noisy_depth(clean, factor)), ("clean", clean)):
        cases[name] = plane_segment_compare(torch.from_numpy(d).to(dev), cfg,
                                            name == "clean")
    stats, hb, wb, cand, fit, args = cases["clean"].pop("inputs")
    cases["noisy"].pop("inputs")
    print(f"plane kernels: {json.dumps(cases)}", flush=True)
    depth, alpha, cam, pc = args
    nb, p_cap = hb * wb, pc.max_planes
    n_sub = fit.label_sub.numel()
    planes2 = (fit.normal, fit.d, fit.alive)
    fit2 = (fit.mse, fit.mean, fit.n)
    n_alive = int(fit.alive.sum())
    out14 = P.plane_label_pixels(*args, fit)
    n_valid = int(out14.valid.sum())
    src = "planarslam_tpu_torch/csrc/plane_segment.cu"
    # K13: one launch a round up to 8 frames, as the C entry reports the
    # launches it made; partial sums filled with NaN and other problems'
    # sums left in reused buffers change no bit, and no flag word is left
    # set (refit_protocol); the profiler's launch count, which can miss
    # records, is reported
    k13_problems = refit_problems(seq, cfg, dev, frames=9)
    k13_timing = {"protocol": refit_protocol(k13_problems,
                                             1 + pc.refine_rounds)}
    k13_timing.update({f"{k}_timing": kernel_timing_entry(k13_problems[k],
                                                          "plane_")
                       for k in ("b1", "b4")})
    k13_timing["graph_replay_bit_equal"] = graph_replay(k13_problems["b4"])

    def worst(name):
        return max(c[name]["max_abs_err"] for c in cases.values())

    out = [
        {"name": "plane_components", "route": "cuda", "library_ms": None,
         # per block: the moment fit (~300), two edges, merge_rounds pulls
         # and jumps, P arg-max passes; the top components' sums
         **_bound(_nbytes(stats, cand),
                  nb * (340.0 + 12 * pc.merge_rounds + 2 * p_cap)
                  + 24.0 * cases["clean"]["plane_components"]["valid_blocks"]),
         "source": src, "replaces": "planarslam_tpu/ops/planes.py:265",
         "max_abs_err": worst("plane_components"),
         "tolerance": "validity and labels exact (clean), <= 0.5% of "
                      "blocks (Kinect noise); fits no further from the "
                      "float64 refit than the float32 plain run plus "
                      f"{CANDIDATE_EPS}",
         "cases": {k: c["plane_components"] for k, c in cases.items()},
         "b8_lanes": components_lanes(seq, cfg, dev),
         **{f"{k}_timing": kernel_timing_entry(fn, "plane_")
            for k, fn in components_problems(seq, cfg, dev).items()},
         "ms": _time_ms(lambda: P.plane_components(stats, hb, wb, pc)),
         "plain_ms": _time_ms(
             lambda: P.plane_components_plain(stats, hb, wb, pc))},
        {"name": "plane_assign_refit", "route": "cuda", "library_ms": None,
         # per subsampled pixel: gate and back-projection (~30), a distance
         # to each alive plane (8), the 10 moment terms and their tree
         **_bound(_nbytes(depth, alpha, planes2, fit2, fit),
                  n_sub * (60.0 + 8 * n_alive)),
         "source": src, "replaces": "planarslam_tpu/ops/planes.py:363",
         "max_abs_err": max(r["max_abs_err"] for c in cases.values()
                            for r in c["plane_assign_refit"]),
         "tolerance": "no further from the float64 plain run than the "
                      f"float32 plain run plus {REFIT_EPS}; labels >= 99.5%",
         "cases": {k: c["plane_assign_refit"] for k, c in cases.items()},
         **k13_timing,
         "ms_of": "CUDA events around one wrapper call (a refine round) on "
                  "frame 0's clean depth, median of 25 (_time_ms); device "
                  "ms and launches of extract_planes' rounds in *_timing "
                  "(torch.profiler)",
         "ms": _time_ms(lambda: P.plane_assign_refit(*args, *planes2, fit2)),
         "plain_ms": _time_ms(
             lambda: P.plane_assign_refit_plain(*args, *planes2, fit2))},
        {"name": "plane_label_pixels", "route": "cuda", "library_ms": None,
         # per pixel: gate and back-projection, a distance per valid plane
         **_bound(_nbytes(depth, alpha, planes2, fit2, out14),
                  depth.numel() * (30.0 + 8 * n_valid)),
         "source": src, "replaces": "planarslam_tpu/ops/planes.py:439",
         "max_abs_err": worst("plane_label_pixels"),
         "tolerance": "validity and counts exact, coefficients 1e-5, "
                      "labels >= 99.9%",
         "cases": {k: c["plane_label_pixels"] for k, c in cases.items()},
         "ms": _time_ms(lambda: P.plane_label_pixels(*args, fit)),
         "plain_ms": _time_ms(
             lambda: P.plane_label_pixels_plain(*args, fit))},
    ]
    _print_kernels(out)
    return out


def manhattan_compare(R0, normals, valid, kw, want_success=None) -> dict:
    """K15 against its plain version on the card: support counts, the axis
    count and success equal, R_cm within 1e-5 (the kernel sums the
    mean-shift weights in float64, the plain version in float32 in another
    order; the weights feed a ratio); two launches give equal bits."""
    import torch

    from planarslam_tpu_torch.ops import manhattan as M

    got = M.track_manhattan_frame(R0, normals, valid, **kw)
    again = M.track_manhattan_frame(R0, normals, valid, **kw)
    want = M.track_manhattan_frame_plain(R0, normals, valid, **kw)
    torch.cuda.synchronize()
    res = {"support": got.axis_support.tolist(),
           "support_plain": want.axis_support.tolist(),
           "n_axes": int(got.n_axes), "success": bool(got.success),
           "max_abs_err": _max_err(got.R_cm, want.R_cm)}
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           "manhattan_mean_shift: two launches on equal inputs differ")
    _check(res["support"] == res["support_plain"]
           and res["n_axes"] == int(want.n_axes)
           and res["success"] == bool(want.success)
           and res["max_abs_err"] <= 1e-5,
           f"manhattan_mean_shift differs from plain: {res}")
    if want_success is not None:
        _check(res["success"] == want_success,
               f"manhattan_mean_shift: success {res['success']}, expected "
               f"{want_success}: {res}")
    if not res["success"]:
        _check(torch.equal(got.R_cm, R0),
               "manhattan_mean_shift: R_cm changed without success")
    return res


def manhattan_inputs(seq, cfg, dev) -> tuple:
    """K15's inputs at the main path's shapes: frame 0's surface normals
    and line directions (N = max_normals + max_lines), a seed rotation from
    its planes and lines turned by a small twist, and the tracking cone.
    Returns (R0, normals, valid, kw)."""
    import torch
    from scipy.spatial.transform import Rotation

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import manhattan as M
    from planarslam_tpu_torch.slam.frame import extract_frame

    g8, d16 = quantize_frame(*seq.render(0), cfg.camera.depth_map_factor)
    gray = torch.from_numpy(g8.astype(np.float32)).to(dev)
    depth = torch.from_numpy(
        d16.astype(np.float32) / np.float32(cfg.camera.depth_map_factor)
    ).to(dev)
    f = extract_frame(gray, depth, cfg)
    vec = f.lines.p3d_e - f.lines.p3d_s
    ln_len = torch.linalg.norm(vec, dim=-1, keepdim=True)
    dirs = vec / torch.clamp(ln_len, min=1e-9)
    ln_ok = f.lines.has_3d & f.lines.valid & (ln_len[:, 0] > 0.1)
    R_seed, seed_ok = M.seed_from_plane_normals(
        torch.cat([f.planes.coeffs[:, :3], dirs]),
        torch.cat([f.planes.count, f.lines.response.to(torch.int32)]),
        torch.cat([f.planes.valid, ln_ok]))
    _check(bool(seed_ok), "manhattan parity: no seed frame in frame 0")
    normals = torch.cat([f.normals, dirs]).contiguous()
    valid = torch.cat([f.normals_valid, ln_ok]).contiguous()
    twist = torch.from_numpy(Rotation.from_rotvec(
        [0.03, -0.02, 0.01]).as_matrix().astype(np.float32)).to(dev)
    R0 = (R_seed @ twist).contiguous()
    mc = cfg.manhattan
    kw = dict(cone_sin=mc.cone_sin_track, kernel=mc.mean_shift_kernel,
              min_support=mc.min_axis_support)
    return R0, normals, valid, kw


def manhattan_problems(seq, cfg, dev) -> dict:
    """K15 on manhattan_inputs alone ("b1") and four times in one launch
    ("b4"). Returns {name: fn}, fn() launching it."""
    import torch

    from planarslam_tpu_torch.ops import manhattan as M

    R0, normals, valid, kw = manhattan_inputs(seq, cfg, dev)
    four = [torch.stack([x] * 4).contiguous() for x in (R0, normals, valid)]
    return {"b1": lambda: M.track_manhattan_frame(R0, normals, valid, **kw),
            "b4": lambda: M.track_manhattan_frame(*four, **kw)}


def _room_depths(seq, cfg, dev, n: int):
    """Frames 0..n-1 of `seq`, quantized, as one (n, H, W) float32 depth
    on the card."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame

    factor = cfg.camera.depth_map_factor
    return torch.from_numpy(np.stack([
        quantize_frame(*seq.render(i), factor)[1].astype(np.float32)
        / np.float32(factor) for i in range(n)])).to(dev)


def alpha_problems(seq, cfg, dev) -> dict:
    """K28 at the main path's shapes: frame 0's quantized 640x480 depth
    clean ("clean") and with Kinect noise ("noisy") alone, and frames 0-3
    in one launch ("b4"). Returns {name: fn}, fn() launching it."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    depth = _room_depths(seq, cfg, dev, 4)
    clean = depth[0].contiguous()
    noisy = torch.from_numpy(noisy_depth(
        clean.cpu().numpy(), cfg.camera.depth_map_factor)).to(dev)
    mx = cfg.planes.max_distance
    return {"clean": lambda: (P._noise_alpha(clean, mx),),
            "noisy": lambda: (P._noise_alpha(noisy, mx),),
            "b4": lambda: (P._noise_alpha(depth, mx),)}


def refit_problems(seq, cfg, dev, frames: int = 4) -> dict:
    """K13 at the main path's shapes: the 1 + refine_rounds rounds of
    extract_planes from K12's candidates, on frame 0's quantized depth
    alone ("b1") and on frames 0-3 in one launch a round ("b4"), and with
    frames > 8 on frames 0-8 ("b9": two launches a round). Returns {name:
    fn}, fn() running the rounds and returning every round's outputs;
    fn(poison=True) gives each round a partial-sum buffer filled with NaN
    and checks the stream's flag words all zero after it."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    pc, cam = cfg.planes, cfg.camera
    depth = _room_depths(seq, cfg, dev, frames)
    h, w = depth.shape[-2:]
    alpha = P._noise_alpha(depth, pc.max_distance)
    stats = P.plane_block_moments(depth, alpha, cam, P._geo_tol(w),
                                  pc.max_distance, pc.block)
    cand = P.plane_components(stats, h // pc.block, w // pc.block, pc)
    rs = max(1, int(pc.refine_stride))
    n_part = -(-(-(-h // rs) * -(-w // rs)) // P.ASSIGN_PIXELS_PER_BLOCK)

    def rounds(b, poison=False):
        dd, a = depth[:b].contiguous(), alpha[:b].contiguous()
        nm, d0, v = (x[:b].contiguous() for x in cand[:3])

        def one(*planes):
            if not poison:  # as any tree's wrapper takes it
                return P.plane_assign_refit(dd, a, cam, pc, *planes)
            part = torch.full((b, n_part, nm.shape[-2], 10), float("nan"),
                              dtype=torch.float64, device=dev)
            fit = P.plane_assign_refit(dd, a, cam, pc, *planes,
                                       partial=part)
            refit_flags_clear()
            return fit

        fit = one(nm, d0, v)
        out = list(fit)
        for _ in range(pc.refine_rounds):
            fit = one(fit.normal, fit.d, fit.alive,
                      (fit.mse, fit.mean, fit.n))
            out += list(fit)
        return tuple(out)

    probs = {"b1": lambda poison=False: rounds(1, poison),
             "b4": lambda poison=False: rounds(4, poison)}
    if frames >= 9:
        probs["b9"] = lambda poison=False: rounds(9, poison)
    return probs


def refit_flags_clear(stream=None) -> None:
    """K13's flag words of `stream` (the current one when None) all zero
    once the card has run what was queued: every launch's last collector
    of a frame cleared the frame's words."""
    import torch

    from planarslam_tpu_torch.ops import planes as P

    torch.cuda.synchronize()
    stream = stream or torch.cuda.current_stream()
    words = P._FLAGS[(stream.device, stream.cuda_stream)]
    left = int((words != 0).sum())
    _check(left == 0, f"plane_assign_refit: {left} flag words left set "
           f"after a launch (first {torch.nonzero(words)[:8].flatten()})")


def refit_protocol(probs: dict, rounds: int, reps: int = 8) -> dict:
    """K13's flag protocol on the card, on refit_problems' problems: each
    problem's rounds once as the reference; then `reps` passes over the
    problems in turn, each run with every partial-sum buffer filled with
    NaN (so every term a collector adds was written by a block of its own
    launch) and once as is (so a collector that read another problem's
    sums from a reused buffer would show), each bit-equal to its
    reference, the flag words all zero after every round, and each round
    as many launches as the C entry reports for its frames (one a round
    up to 8 frames)."""
    import torch

    from planarslam_tpu_torch import kernels

    want = {k: fn() for k, fn in probs.items()}
    refit_flags_clear()
    frames = {"b1": 1, "b4": 4, "b9": 9}
    calls = 0
    for _ in range(reps):
        for k, fn in probs.items():
            for poison in (True, False):
                n0 = kernels.LAUNCHES["plane_assign_refit"]
                got = fn(poison=poison)
                n = kernels.LAUNCHES["plane_assign_refit"] - n0
                _check(n == rounds * -(-frames[k] // 8),
                       f"plane_assign_refit: {n} launches for the rounds "
                       f"of {k}")
                refit_flags_clear()
                _check(all(torch.equal(a, b) for a, b in zip(got, want[k])),
                       f"plane_assign_refit: the rounds of {k} differ from "
                       f"their first run (partial filled with NaN: "
                       f"{poison})")
                calls += 1
    return {"calls": calls, "problems": sorted(probs),
            "nan_partials_bit_equal": True, "flags_clear": True}


def graph_replay(fn, name: str = "plane_assign_refit",
                 flags_clear=refit_flags_clear) -> bool:
    """A kernel's calls (fn: K13's rounds of refit_problems, or K16's
    pyramid) captured in a CUDA graph on a side stream after a warm-up
    there, and replayed twice, each replay bit-equal to the eager calls;
    with flags_clear (K13's), the flag words the launches share need no
    reset between replays, and they are all zero after each."""
    import torch

    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        cap = fn()
    for _ in range(2):
        for t in cap:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(cap, want)),
               f"{name}: the graph replay differs from the eager calls")
        if flags_clear is not None:
            flags_clear(side)
    return True


def normals_problems(seq, cfg, dev) -> dict:
    """K29 at the main path's shapes: frame 0's quantized 640x480 depth
    alone ("b1") and frames 0-3 in one launch ("b4"). Returns {name: fn},
    fn() launching it."""
    from planarslam_tpu_torch.ops import planes as P
    from planarslam_tpu_torch.slam.frame import _normal_stride

    depth = _room_depths(seq, cfg, dev, 4)
    one = depth[:1].contiguous()
    args = (cfg.camera, cfg.planes.smooth_window, _normal_stride(cfg),
            cfg.manhattan.max_normals)
    return {"b1": lambda: P.frame_normals(one, *args),
            "b4": lambda: P.frame_normals(depth, *args)}


def manhattan_kernel_parity(seq, cfg, dev) -> list:
    """K15 against its plain version on the card on manhattan_inputs (frame
    0's surface normals and line directions with a perturbed seed
    rotation), at both cone sines, with one axis's normals invalidated (the
    cross-product completion) and with two (no success), on those normals
    twice over (N = 4224: more than a thread keeps in registers) and on
    none."""
    import torch

    from planarslam_tpu_torch.ops import manhattan as M

    R0, normals, valid, kw = manhattan_inputs(seq, cfg, dev)
    mc = cfg.manhattan
    cases = {"track": manhattan_compare(R0, normals, valid, kw, True),
             "project": manhattan_compare(
                 R0, normals, valid, dict(kw, cone_sin=mc.cone_sin_project),
                 True)}
    # drop the normals of the weakest found axis, then of the two weakest
    axis = torch.argmax(torch.abs(normals @ R0), dim=-1)
    order = np.argsort(cases["track"]["support"])
    one = valid & (axis != int(order[0]))
    two = one & (axis != int(order[1]))
    cases["axis_missing"] = manhattan_compare(R0, normals, one, kw, True)
    _check(cases["axis_missing"]["n_axes"] == 2,
           f"manhattan parity: expected 2 axes: {cases['axis_missing']}")
    cases["two_missing"] = manhattan_compare(R0, normals, two, kw, False)
    # N past the normals a thread keeps in registers (the rest recomputed
    # in each pass), and N = 0
    cases["n_twice"] = manhattan_compare(
        R0, torch.cat([normals] * 2).contiguous(),
        torch.cat([valid] * 2).contiguous(), kw, True)
    cases["n_zero"] = manhattan_compare(R0, normals[:0].contiguous(),
                                        valid[:0].contiguous(), kw, False)
    print(f"manhattan kernel: {json.dumps(cases)}", flush=True)
    got = M.track_manhattan_frame(R0, normals, valid, **kw)
    n = normals.shape[0]
    steps = 3 * (1 + 4)
    out = [{"name": "manhattan_mean_shift", "route": "cuda",
            "library_ms": None,
            # per normal and pass: the rotation (15), the cone test, the
            # tangent coordinates, one exp and three weighted sums (~45)
            **_bound(_nbytes(R0, normals, valid, got), 45.0 * n * steps),
            "source": "planarslam_tpu_torch/csrc/manhattan.cu",
            "replaces": "planarslam_tpu/ops/manhattan.py:38",
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "tolerance": "R_cm 1e-5, support, axis count and success exact",
            "shapes": {"N": n}, "cases": cases, "ms_source": MS_SOURCE,
            "ms": _time_ms(lambda: M.track_manhattan_frame(
                R0, normals, valid, **kw)),
            "plain_ms": _time_ms(lambda: M.track_manhattan_frame_plain(
                R0, normals, valid, **kw))}]
    _print_kernels(out)
    return out


def _clone(obj):
    """A copy of the tensors in obj (tuples, named tuples and dicts
    walked)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_clone(x) for x in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    return obj


PLAIN_LINE_FUNCTIONS = ("detect_lines_plain", "line_descriptors_plain",
                        "lift_lines_3d_plain", "extract_line_features_plain",
                        "search_lines_by_projection_plain",
                        "match_lines_plain")
PLAIN_MATCHING_FUNCTIONS = ("gated_hamming_top2_plain",
                            "project_landmarks_plain", "match_select_plain",
                            "rotation_histogram_filter_plain",
                            "frame_match_select_plain",
                            "assemble_point_obs_plain",
                            "assemble_line_obs_plain")
PLAIN_TAIL_FUNCTIONS = (("device_tracker", "decode_step_inputs_plain"),
                        ("device_tracker", "unpack_frame"),
                        ("device_tracker", "to_gray_depth"),
                        ("device_tracker", "unpack_window"),
                        ("device_tracker", "lift_state_plain"),
                        ("manhattan", "seed_manhattan_plain"),
                        ("manhattan", "seed_from_plane_normals"),
                        ("planes", "noise_alpha_plain"),
                        ("planes", "frame_normals_plain"),
                        ("device_tracker", "_associate_planes_plain"),
                        ("device_tracker", "finish_step_plain"),
                        ("device_tracker", "step_prelude_plain"),
                        ("planes", "plane_block_moments_plain"),
                        ("planes", "plane_components_plain"),
                        ("planes", "plane_assign_refit_plain"),
                        ("planes", "plane_label_pixels_plain"),
                        ("manhattan", "track_manhattan_frame_plain"),
                        ("manhattan", "init_select_plain"),
                        ("pose_opt", "_pose_optimize_plain"))
PLAIN_LOOP_FUNCTIONS = (("sim3_solver", "_refine_relative_plain"),
                        ("ba_core", "plane_blocks_plain"),
                        ("ba_core", "cost_test_plain"),
                        ("ba_core", "_chi2"),
                        ("ba_core", "reduced_system_plain"),
                        ("ba_core", "ba_schur_complement_plain"),
                        ("pose_graph", "pose_graph_normal_eqs_plain"),
                        ("pose_graph", "pose_graph_update_plain"),
                        ("device_mapper", "triangulate_lines_plain"),
                        ("ba_pcg", "pcg_prepare_plain"),
                        ("ba_pcg", "pcg_schur_matvec_plain"),
                        ("ba_pcg", "pcg_backsub_plain"),
                        ("ba_pcg", "pcg_cg_update_plain"),
                        ("pnp", "_inliers"),
                        ("pnp", "pnp_dlt_hypotheses_plain"),
                        ("pnp", "pnp_select_plain"),
                        ("sim3_solver", "triplet_weights"),
                        ("sim3_solver", "_horn_rows_plain"),
                        ("sim3_solver", "horn_triplets_plain"),
                        ("sim3_solver", "horn_refit_plain"),
                        ("sim3_solver", "_ransac_align_plain"),
                        ("initializer", "two_view_hypotheses_plain"),
                        ("initializer", "two_view_select_plain"),
                        ("initializer", "_eight_point_F"),
                        ("initializer", "_four_point_H"),
                        ("initializer", "_score_F"),
                        ("initializer", "_score_H"),
                        ("triangulation", "triangulate_plain"),
                        ("triangulation", "reprojection_checks_plain"))
# the inputs of path 4b's two loop-edge refinements, its first global BA
# solve (loop_kernel_parity's, schur_pose_graph_parity's) and its pose
# graph (schur_pose_graph_parity's)
LOOP_CAPTURE = (("sim3_solver", "refine_relative_se3", 1),
                ("sim3_solver", "refine_relative_se3", 2),
                ("global_ba", "ba_solve", 1),
                ("pose_graph", "_optimize", 1))
# the two pose_optimize calls (obs1, obs2) of path 1's 21st fused frame
POSE_CAPTURE = (("pose_opt", "pose_optimize", 41),
                ("pose_opt", "pose_optimize", 42))
# the calls _pose_calls counts: (module, attribute, count key)
COUNTED_CALLS = (
    ("pose_opt", "pose_optimize", "calls"),
    ("planes", "extract_planes", "plane_calls"),
    ("manhattan", "track_manhattan_frame", "manhattan_calls"),
    ("frame", "extract_point_features", "point_calls"),
    ("lines", "extract_line_features", "line_calls"),
    ("lines", "search_lines_by_projection", "search_calls"),
    ("device_tracker", "search_lines_by_projection", "search_calls"),
    ("matching", "search_by_projection", "projection_search_calls"),
    ("matching", "match_descriptors", "descriptor_match_calls"),
    ("matching", "rotation_histogram_filter", "rotation_filter_calls"),
    ("device_tracker", "_track_core", "track_core_calls"),
    ("device_tracker", "extract_frame", "frame_calls"),
    ("tracking", "extract_frame", "frame_calls"),
    ("sim3_solver", "refine_relative_se3", "refine_calls"),
    ("ba_core", "ba_plane_blocks", "plane_block_calls"),
    ("ba_pcg", "ba_plane_blocks", "plane_block_calls"),
    ("ba_core", "ba_cost_test", "cost_test_calls"),
    ("ba_pcg", "ba_cost_test", "cost_test_calls"),
    ("ba_core", "ba_chi2_tables", "chi2_table_calls"),
    ("ba_core", "ba_reduced_system", "reduced_system_calls"),
    ("pose_graph", "_optimize", "pose_graph_calls"),
    ("ba_pcg", "pcg_prepare", "pcg_prepare_calls"),
    ("ba_pcg", "pcg_schur_matvec", "pcg_matvec_calls"),
    ("ba_pcg", "pcg_backsub", "pcg_backsub_calls"),
    ("ba_pcg", "pcg_cg_update", "pcg_cg_update_calls"),
    ("device_tracker", "_state_from", "state_from_calls"),
    ("manhattan", "seed_manhattan", "seed_calls"),
    ("device_mapper", "run_fuse_set", "fuse_set_calls"),
    ("device_mapper", "_mapping_step_impl", "mapping_step_calls"))
# the launches inside each call of a counted function (per call)
FUSE_SET_LAUNCHES = {"project_landmarks": 1, "gated_hamming_top2": 1,
                     "match_select": 1}
MAPPING_STEP_LAUNCHES = {"project_landmarks": 1, "gated_hamming_top2": 2,
                         "match_select": 2, "triangulate_two_view": 1,
                         "triangulate_lines": 1}


def _on_card(obj) -> bool:
    """A tensor on the card in obj (tuples, lists and dicts walked)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (tuple, list)):
        return any(_on_card(x) for x in obj)
    if isinstance(obj, dict):
        return any(_on_card(x) for x in obj.values())
    return False


@contextlib.contextmanager
def _pose_calls(capture=()):
    """Count the calls of COUNTED_CALLS made inside the block, each where
    its caller looks it up (slam/frame.py imports extract_point_features
    and slam/device_tracker.py search_lines_by_projection by name; the
    others are reached through their modules, local_mapping.py and
    tracking.py import the line search from ops/lines.py at the call,
    fused_track_step calls device_tracker._track_core, the tracking step
    of one frame, whose counted launches are counted apart, and
    device_tracker.py and tracking.py import extract_frame by name;
    loop_closing.py imports refine_relative_se3 from sim3_solver at the
    call, ba_solve looks K33-K35's and K40's wrappers up in ba_core and
    ba_pcg imports K33's and K34's by name; a K33 call with plane tables is
    counted apart; optimize_pose_graph calls pose_graph._optimize, whose
    Gauss-Newton steps are counted),
    count the calls of a plain line, matching, noise, normal, plane
    association, step-tail, refinement, plane-block, cost-test,
    reduced-system, Schur-complement, pose-graph normal-equation or
    pose-graph update function with a tensor on the card, and keep under
    "inputs", keyed by the triple, the inputs of each call named in
    `capture` by (module, attribute, call number from 1; -1: the last)."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import lines, manhattan, matching, planes
    from planarslam_tpu_torch.slam import (device_mapper, device_tracker,
                                           frame, tracking)
    from planarslam_tpu_torch.solvers import (ba_core, ba_pcg, global_ba,
                                              initializer, pnp, pose_graph,
                                              pose_opt, sim3_solver,
                                              triangulation)

    modules = {"pose_opt": pose_opt, "planes": planes, "pnp": pnp,
               "initializer": initializer, "triangulation": triangulation,
               "manhattan": manhattan, "frame": frame, "lines": lines,
               "device_tracker": device_tracker, "matching": matching,
               "tracking": tracking, "sim3_solver": sim3_solver,
               "ba_core": ba_core, "ba_pcg": ba_pcg, "global_ba": global_ba,
               "device_mapper": device_mapper, "pose_graph": pose_graph}
    rec = {key: 0 for _, _, key in COUNTED_CALLS}
    inner = {"track_core_calls": ("step_launches", STEP_LAUNCHES),
             "fuse_set_calls": ("fuse_set_launches", FUSE_SET_LAUNCHES),
             "mapping_step_calls": ("mapping_step_launches",
                                    MAPPING_STEP_LAUNCHES)}
    rec.update(inputs={}, plain_calls_on_card=0, plane_block_with_planes=0,
               search_launches=0, gn_steps=0,
               **{k: dict.fromkeys(kern, 0) for k, kern in inner.values()})
    orig = [(modules[mod], attr, getattr(modules[mod], attr))
            for mod, attr, _ in COUNTED_CALLS]
    plain = [(mod, name, getattr(mod, name))
             for mod, names in ((lines, PLAIN_LINE_FUNCTIONS),
                                (matching, PLAIN_MATCHING_FUNCTIONS))
             for name in names]
    plain += [(modules[mod], name, getattr(modules[mod], name))
              for mod, name in PLAIN_TAIL_FUNCTIONS + PLAIN_LOOP_FUNCTIONS]

    def counting(fn, key):
        def counted(*args, **kw):
            rec[key] += 1
            if key == "plane_block_calls" and ba_core._active_planes(args[0]):
                rec["plane_block_with_planes"] += 1
            if key == "search_calls":  # K23's launches at this call's M
                rec["search_launches"] += lines.search_launches(
                    args[0].shape[-2])
            if key == "pose_graph_calls":  # the Gauss-Newton steps it runs
                rec["gn_steps"] += kw.get("n_iters", args[5] if len(args)
                                          > 5 else 10)
            if key not in inner:
                return fn(*args, **kw)
            field, kern = inner[key]
            before = dict(kernels.LAUNCHES)
            out = fn(*args, **kw)
            for k in kern:
                rec[field][k] += kernels.LAUNCHES[k] - before[k]
            return out
        return counted

    def capturing(fn, mod, attr):
        numbers = {n for m, a, n in capture if (m, a) == (mod, attr)}
        calls = [0]

        def captured(*args, **kw):
            calls[0] += 1
            for n in numbers & {calls[0], -1}:
                rec["inputs"][mod, attr, n] = _clone((args, kw))
            return fn(*args, **kw)
        return captured

    def guarded(fn):
        def plain_call(*args, **kw):
            if _on_card((args, kw)):
                rec["plain_calls_on_card"] += 1
            return fn(*args, **kw)
        return plain_call

    for (mod, attr, fn), (_, _, key) in zip(orig, COUNTED_CALLS):
        setattr(mod, attr, counting(fn, key))
    for mod, name, fn in plain:
        setattr(mod, name, guarded(fn))
    targets = list(dict.fromkeys((m, a) for m, a, _ in capture))
    kept = [(modules[m], a, getattr(modules[m], a)) for m, a in targets]
    for (mod, attr, fn), (name, _) in zip(kept, targets):
        setattr(mod, attr, capturing(fn, name, attr))
    try:
        yield rec
    finally:
        for mod, attr, fn in kept[::-1] + orig + plain:
            setattr(mod, attr, fn)


# the launches inside each RANSAC: K7 and K46 in a PnP RANSAC, K6's
# triplet and refit launches in a Horn RANSAC, K48 and K49 in the two-view
# initializer's dual RANSAC and K50 in its triangulation of the candidates
RANSAC_LAUNCHES = {"pnp": {"pnp_dlt_hypotheses": 1, "pnp_select": 1},
                   "horn": {"horn_align_batch": 2},
                   "two_view": {"two_view_hypotheses": 1,
                                "two_view_select": 1},
                   "two_view_tri": {"triangulate_dlt": 1}}
# what a RANSAC may do to a card tensor between its upload and its pull,
# besides launching its kernels: read the tensor's metadata, or take a view
# of its bytes (narrow and view move no data: K50's X and ok are views of
# one buffer)
RANSAC_META = ("torch.Tensor.device.__get__", "torch.Tensor.dim",
               "torch.Tensor.dtype.__get__", "torch.Tensor.is_contiguous",
               "torch.Tensor.shape.__get__", "torch.Tensor.data_ptr",
               "torch.Tensor.narrow", "torch.Tensor.view")
# PyTorch functions that bring a card tensor's values to the host
PULLS = ("torch.Tensor.cpu", "torch.Tensor.item", "torch.Tensor.tolist",
         "torch.Tensor.numpy", "torch.Tensor.__int__", "torch.Tensor.__bool__",
         "torch.Tensor.__float__")


@contextlib.contextmanager
def _ransac_calls():
    """Count the RANSACs run inside the block and what each does on the
    card. The entry points (pnp.pnp_ransac, sim3_solver.horn_ransac_se3 and
    horn_ransac_sim3, initializer.initialize_two_view, each where its
    caller looks it up at the call) count their uploads (a Tensor.to onto
    the card) and pulls (PULLS); the device parts (pnp._pnp_ransac,
    sim3_solver._ransac_align, initializer._dual_ransac and
    triangulation.triangulate) the kernel launches inside them and every
    PyTorch function they apply to a card tensor (a TorchFunctionMode), by
    name."""
    from torch.overrides import TorchFunctionMode, resolve_name

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.solvers import (initializer, pnp, sim3_solver,
                                              triangulation)

    rec = {"pnp": 0, "horn": 0, "two_view": 0, "two_view_tri": 0,
           "entries": 0, "uploads": 0, "pulls": 0,
           "launches": {k: dict.fromkeys(v, 0)
                        for k, v in RANSAC_LAUNCHES.items()},
           "card_ops": {}}

    class Seen(TorchFunctionMode):
        def __init__(self, ops=None):
            super().__init__()
            self.ops = ops

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = resolve_name(func) or repr(func)
            card = _on_card((args, kwargs))
            if self.ops is not None:
                if card:
                    self.ops[name] = self.ops.get(name, 0) + 1
            elif card and name in PULLS:
                rec["pulls"] += 1
            elif name == "torch.Tensor.to" and not card and _on_card(out):
                rec["uploads"] += 1
            return out

    def entry(fn):
        def counted(*args, **kw):
            rec["entries"] += 1
            with Seen():
                return fn(*args, **kw)
        return counted

    def device_part(fn, kind):
        def counted(*args, **kw):
            before = dict(kernels.LAUNCHES)
            with Seen(rec["card_ops"]):
                out = fn(*args, **kw)
            rec[kind] += 1
            for k in RANSAC_LAUNCHES[kind]:
                rec["launches"][kind][k] += kernels.LAUNCHES[k] - before[k]
            return out
        return counted

    swaps = [(pnp, "pnp_ransac", entry(pnp.pnp_ransac)),
             (sim3_solver, "horn_ransac_se3",
              entry(sim3_solver.horn_ransac_se3)),
             (sim3_solver, "horn_ransac_sim3",
              entry(sim3_solver.horn_ransac_sim3)),
             (pnp, "_pnp_ransac", device_part(pnp._pnp_ransac, "pnp")),
             (sim3_solver, "_ransac_align",
              device_part(sim3_solver._ransac_align, "horn")),
             (initializer, "initialize_two_view",
              entry(initializer.initialize_two_view)),
             (initializer, "_dual_ransac",
              device_part(initializer._dual_ransac, "two_view")),
             (triangulation, "triangulate",
              device_part(triangulation.triangulate, "two_view_tri"))]
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, fn in swaps:
        setattr(mod, attr, fn)
    try:
        yield rec
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def _check_ransacs(name: str, rec: dict) -> dict:
    """Per PnP RANSAC one K7 and one K46 launch, per Horn RANSAC two K6
    launches, per two-view dual RANSAC one K48 and one K49 and per
    triangulation of its candidates one K50; no PyTorch function but
    RANSAC_META on a card tensor inside any (no scatter_, argmax or plain
    _inliers); one upload and one pull per entry point, and one more of
    each per triangulation of the candidates. Returns the counts."""
    for kind, per in RANSAC_LAUNCHES.items():
        want = {k: n * rec[kind] for k, n in per.items()}
        got = rec["launches"][kind]
        _check(got == want, f"{name}: {got} launches in {rec[kind]} {kind} "
               f"RANSACs, expected {want}")
    other = {k: v for k, v in rec["card_ops"].items() if k not in RANSAC_META}
    _check(not other, f"{name}: PyTorch ops on card tensors inside the "
           f"RANSACs: {other}")
    want = rec["entries"] + rec["two_view_tri"]
    _check(rec["uploads"] == rec["pulls"] == want,
           f"{name}: {rec['uploads']} uploads and {rec['pulls']} pulls in "
           f"{rec['entries']} RANSAC calls ({rec['two_view_tri']} with a "
           f"triangulation)")
    return {k: rec[k] for k in ("pnp", "horn", "two_view", "two_view_tri",
                                "entries", "uploads", "pulls", "launches",
                                "card_ops")}


def _check_pose_launches(name: str, launches: dict, rec: dict, cfg=None,
                         frames=None) -> None:
    """One K11 launch per pose_optimize call; per extract_planes call one
    K4, one K12, 1 + refine_rounds K13 and one K14 launch; one K15 launch
    per track_manhattan_frame call; per extract_point_features call one K1,
    one K2, one K19, n_levels - 1 K16 and fast.select_launches(table) K18
    launches (two, as its C entry reports them); one K17 launch
    per extract_point_features and per extract_line_features call; per
    extract_line_features call the DETECT_LAUNCHES of K20's one call, one
    K21 and one K22; lines.search_launches(M) of K23 per
    search_lines_by_projection call over M map lines (1 for tracking's
    window, 2 for local mapping's fuse); one K24 per search_by_projection
    call; one K3 per search_by_projection call and per match_descriptors
    call (rows and the
    transposed problem in one launch: every caller checks mutual matches);
    one K25
    per search_by_projection and per match_descriptors call; one K26 per
    tracking step and per rotation_histogram_filter call; two K27 per
    tracking step (its line observations, which the first pose solve
    takes, then its point observations after the window search); one K28
    and one K29 per extract_frame call; one K30 and one K31 per tracking
    step, and inside each tracking step STEP_LAUNCHES; one K32 per
    refine_relative_se3 call; per LM step of ba_solve or ba_solve_pcg (one
    K8 launch) one ba_plane_blocks call of one K33 launch (its mu_p pass)
    and one more with plane tables, and one ba_cost_test call (K34); per
    dense step (two K9 launches) one K35 and one K40, none in the PCG
    solve; one K34 per solve in its tables mode; per pose_graph._optimize
    call one K10 and one K41 per Gauss-Newton step (10); no plain line,
    matching, noise, normal, plane association, step-tail, refinement,
    plane-block, cost-test, reduced-system, Schur-complement or pose-graph
    function called with a tensor on the card; with `frames`, one
    extract_frame, extract_planes, extract_point_features and
    extract_line_features call per frame, and a tracking step on all frames
    but the first."""
    from planarslam_tpu_torch.ops import fast, image, lines
    from planarslam_tpu_torch.ops.frontend import orb_level_table
    from planarslam_tpu_torch.solvers import ba_pcg

    rounds = 1 + (cfg.planes.refine_rounds if cfg is not None else 0)
    # K16's and K18's launches per call, as their C entries report them
    resizes = image.PYRAMID_LAUNCHES if cfg is not None else 0
    selects = (fast.select_launches(orb_level_table(
        cfg.camera.height, cfg.camera.width, cfg.orb))
        if cfg is not None else 0)
    points, lns = rec["point_calls"], rec["line_calls"]
    searches = rec["projection_search_calls"]
    matches = rec["descriptor_match_calls"]
    steps = rec["track_core_calls"]
    want = {"pose_optimize": rec["calls"],
            "plane_block_moments": rec["plane_calls"],
            "plane_components": rec["plane_calls"],
            "plane_assign_refit": rounds * rec["plane_calls"],
            "plane_label_pixels": rec["plane_calls"],
            "manhattan_mean_shift": rec["manhattan_calls"],
            "fast_score": points, "orb_describe": points,
            "point_epilogue": points, "pyramid_resize": resizes * points,
            "select_keypoints": selects * points,
            "gaussian_blur": points + lns,
            "detect_lines": lines.DETECT_LAUNCHES * lns,
            "line_descriptors": lns, "lift_lines_3d": lns,
            "search_lines_by_projection": rec["search_launches"],
            "project_landmarks": searches,
            "gated_hamming_top2": searches + matches,
            "match_select": searches + matches,
            "frame_match_select": steps + rec["rotation_filter_calls"],
            "assemble_observations": 2 * steps,
            "noise_alpha": rec["frame_calls"],
            "frame_normals": rec["frame_calls"],
            "associate_planes": steps, "finish_step": steps,
            "step_prelude": steps, "decode_step_inputs": steps,
            "lift_state": rec["state_from_calls"],
            "seed_manhattan": rec["seed_calls"],
            "refine_relative": rec["refine_calls"],
            "ba_plane_blocks": rec["plane_block_calls"]
                               + rec["plane_block_with_planes"],
            "ba_cost_test": rec["cost_test_calls"] + rec["chi2_table_calls"],
            "ba_reduced_system": rec["reduced_system_calls"],
            "ba_schur_complement": rec["reduced_system_calls"],
            "pose_graph_normal_eqs": rec["gn_steps"],
            "pose_graph_update": rec["gn_steps"],
            "pcg_prepare": rec["pcg_prepare_calls"],
            "pcg_schur_matvec": ba_pcg.MATVEC_LAUNCHES
                                * rec["pcg_matvec_calls"]
                                + ba_pcg.BACKSUB_LAUNCHES
                                * rec["pcg_backsub_calls"],
            "pcg_cg_update": rec["pcg_cg_update_calls"]}
    _check(rec["gn_steps"] == 10 * rec["pose_graph_calls"],
           f"{name}: {rec['gn_steps']} Gauss-Newton steps in "
           f"{rec['pose_graph_calls']} pose graphs, expected 10 each")
    # every LM step (one K8 launch) adds its plane blocks and ends in a
    # cost test, every dense step (two K9 launches) reduces its system
    _check(rec["plane_block_calls"] == launches["ba_normal_eqs"]
           == rec["cost_test_calls"]
           == rec["reduced_system_calls"] + rec["pcg_prepare_calls"]
           and 2 * rec["reduced_system_calls"]
           == launches["ba_schur_eliminate"],
           f"{name}: {launches['ba_normal_eqs']} K8 and "
           f"{launches['ba_schur_eliminate']} K9 launches for "
           f"{_call_counts(rec)}")
    # every PCG LM step (one K43) starts its CG with K45's init mode, runs
    # a K44 product and a K45 update a CG step, and ends in one
    # back-substitution
    _check(rec["pcg_backsub_calls"] == rec["pcg_prepare_calls"]
           and rec["pcg_cg_update_calls"]
           == rec["pcg_prepare_calls"] + rec["pcg_matvec_calls"],
           f"{name}: PCG calls out of step: {_call_counts(rec)}")
    for kernel, n in want.items():
        _check(launches[kernel] == n, f"{name}: {launches[kernel]} {kernel} "
               f"launches, expected {n} ({_call_counts(rec)})")
    for field, key, kern, what in (
            ("step_launches", "track_core_calls", STEP_LAUNCHES,
             "tracking steps"),
            ("fuse_set_launches", "fuse_set_calls", FUSE_SET_LAUNCHES,
             "fuse sets"),
            ("mapping_step_launches", "mapping_step_calls",
             MAPPING_STEP_LAUNCHES, "mapping steps")):
        per = {k: n * rec[key] for k, n in kern.items()}
        _check(rec[field] == per, f"{name}: {rec[field]} counted launches "
               f"in {rec[key]} {what}, expected {per}")
    _check(rec["plain_calls_on_card"] == 0,
           f"{name}: {rec['plain_calls_on_card']} plain line, matching, "
           f"noise, normal, association, tail, refinement, plane-block, "
           f"cost-test, reduced-system, Schur-complement, pose-graph, line "
           f"triangulation or PCG calls with tensors on the card")
    if frames is not None:
        _check(rec["plane_calls"] == frames and rec["frame_calls"] == frames
               and rec["manhattan_calls"] > 0
               and points == frames and lns == frames
               and rec["search_calls"] >= frames - 1
               and steps >= frames - 1,
               f"{name}: {_call_counts(rec)} for {frames} frames")


def _call_counts(rec: dict) -> dict:
    out = {f"{attr.lstrip('_')}_calls": rec[key]
           for _, attr, key in COUNTED_CALLS}
    out["ba_plane_blocks_with_planes"] = rec["plane_block_with_planes"]
    out["pose_graph_gn_steps"] = rec["gn_steps"]
    out["launches_in_tracking_steps"] = rec["step_launches"]
    out["launches_in_fuse_sets"] = rec["fuse_set_launches"]
    out["launches_in_mapping_steps"] = rec["mapping_step_launches"]
    return out


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def _ba_problem(dev, Kt: int, F: int, L2: int, P: int, seed: int):
    """Seeded K8 inputs at the shape of a BA window: Kt keyframes 0-0.3 m
    apart viewing points 2-6 m away, F point slots per keyframe (15% empty,
    half the points mono, 0.5 px noise and 5% gross outliers so the Huber
    weights act, one (keyframe, landmark) pair observed twice) and L2
    line-endpoint slots in the line range of the landmark array."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core

    rng = np.random.default_rng(seed)
    K = (535.4, 539.2, 320.1, 247.6)
    n_pts = P - 512 if P > 1024 else P - L2
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                    rng.uniform(2, 6, P)], -1).astype(np.float32)
    poses = np.stack([_planted_se3(rng, 0.05) for _ in range(Kt)])
    poses[:, :3, 3] = rng.uniform(-0.3, 0.3, (Kt, 3))
    slot = rng.integers(0, n_pts, (Kt, F)).astype(np.int32)
    slot[rng.random((Kt, F)) < 0.15] = -1
    slot[0, 1] = slot[0, 0] = max(int(slot[0, 0]), 0)
    pc = np.einsum("kij,kfj->kfi", poses[:, :3, :3], pts[slot.clip(0)]) \
        + poses[:, None, :3, 3]
    uv = np.stack([K[0] * pc[..., 0] / pc[..., 2] + K[2],
                   K[1] * pc[..., 1] / pc[..., 2] + K[3]], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[rng.random((Kt, F)) < 0.05] += 30.0
    ur = np.where(rng.random((Kt, F)) < 0.5,
                  uv[..., 0] - 40.0 / pc[..., 2], -1.0)
    ln_slot = rng.integers(n_pts, P, (Kt, L2)).astype(np.int32)
    ln_slot[rng.random((Kt, L2)) < 0.3] = -1
    l2d = rng.normal(0, 1, (Kt, L2, 3))
    l2d[..., :2] /= np.linalg.norm(l2d[..., :2], axis=-1, keepdims=True)
    l2d[..., 2] = rng.uniform(-400, 400, (Kt, L2))

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    pt = ba_core.PointTables(t(slot.clip(0), np.int32), t(uv), t(ur),
                             t(np.ones((Kt, F))), t(slot >= 0))
    ln = ba_core.LineTables(t(ln_slot.clip(0), np.int32), t(l2d),
                            t(np.ones((Kt, L2))), t(ln_slot >= 0))
    return t(poses), t(pts), pt, ln, K


def ba_kernel_parity(dev) -> list:
    """K8-K10 against their plain versions on the card, K8 and K9 at the
    GBA shape (Kt=128, M=12864) and the LBA shape (Kt=16, M=2336), K10 at
    N=96 keyframes. Times are at the GBA shape."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core, pose_graph

    out = []
    errs8, errs9 = [], []
    timed = None
    for name, Kt, F, L2, P, Q in (("lba", 16, 1000, 64, 2304, 32),
                                  ("gba", 128, 1000, 64, 12800, 64)):
        poses, pts, pt, ln, K = _ba_problem(dev, Kt, F, L2, P, seed=Kt)
        M = P + Q
        plan = ba_core.obs_plan(pt.slot, pt.mask, ln.slot, ln.mask, M)
        args8 = (poses, pts, pt, ln, M, K, 40.0, True, True)
        k8 = ba_core.ba_normal_eqs(*args8, plan=plan)
        p8 = ba_core.ba_normal_eqs_plain(*args8)
        torch.cuda.synchronize()
        err8 = max(_rel_err(a, b) for a, b in zip(k8, p8))
        _check(err8 <= 1e-4, f"ba_normal_eqs ({name}) relative error {err8}")
        errs8.append(err8)
        Hcc, bc, Hpp, bp, Hcp = p8[:5]
        Hpp = Hpp.clone()
        Hpp[P:] = torch.eye(3, device=dev) * 10.0  # plane rows
        lam = torch.tensor(1e-3, device=dev)
        mu_p = ba_core._mu_p(Hpp)
        dxc = torch.from_numpy(np.random.default_rng(9).normal(
            0, 1e-3, (Kt, 6)).astype(np.float32)).to(dev)
        args9 = (Hpp, bp, Hcp, bc, lam, mu_p)

        def k9():
            r = ba_core.ba_schur_eliminate(*args9)
            return r + (ba_core.ba_schur_backsub(r[0], bp, Hcp, dxc),)

        def p9():
            r = ba_core.ba_schur_eliminate_plain(*args9)
            return r + (ba_core.ba_schur_backsub_plain(r[0], bp, Hcp, dxc),)

        got9, want9 = k9(), p9()
        torch.cuda.synchronize()
        err9 = max(_rel_err(a, b) for a, b in zip(got9, want9))
        _check(err9 <= 1e-4, f"ba_schur_eliminate ({name}) relative error "
               f"{err9}")
        errs9.append(err9)
        print(f"ba kernels at the {name} shape Kt={Kt} M={M}: K8 rel err "
              f"{err8}, K9 rel err {err9}", flush=True)
        timed = (args8, plan, k8, k9, p9, args9, got9, dxc)
    args8, plan, k8, k9, p9, args9, got9, dxc = timed
    Kt, M = args8[0].shape[0], args8[4]
    n_obs = Kt * (args8[2].slot.shape[1] + args8[3].slot.shape[1])
    out.append({"name": "ba_normal_eqs", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/ba_normal_eqs.cu",
                "replaces": "planarslam_tpu/solvers/ba_core.py:361",
                "max_abs_err": max(errs8),
                "tolerance": "relative 1e-4 of each output's largest value",
                "shapes": {"Kt": Kt, "M": M, "observations": n_obs},
                "library_ms": None,
                # per observation: projection, Jacobians, 54 product terms
                **_bound(_nbytes(args8[:4], k8), 600.0 * n_obs),
                "ms": _time_ms(lambda: ba_core.ba_normal_eqs(*args8,
                                                             plan=plan)),
                "plain_ms": _time_ms(lambda: ba_core.ba_normal_eqs_plain(
                    *args8))})
    Hpp_inv = got9[0]
    out.append({"name": "ba_schur_eliminate", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/ba_schur.cu",
                "replaces": "planarslam_tpu/solvers/ba_core.py:463",
                "max_abs_err": max(errs9),
                "tolerance": "relative 1e-4 of each output's largest value",
                "shapes": {"Kt": Kt, "M": M},
                "library_ms": None,
                # elimination (reads Hcp, writes HcpHinv) and the
                # back-substitution (reads Hcp again)
                **_bound(_nbytes(args9[:4], got9[:3], dxc, got9[3])
                         + _nbytes(args9[2], Hpp_inv, args9[1]),
                         M * Kt * 6 * 3 * (5 + 2 + 2)),
                "ms": _time_ms(k9), "plain_ms": _time_ms(p9)})

    # K10: a 96-keyframe chain with covisibility and loop edges, keyframe
    # 0 fixed (the gauge diagonal in K10's epilogue)
    args10, fixed = ba_kernel_graph(dev)
    N, E = args10[0].shape[0], args10[1].shape[0]
    H_k, g_k = pose_graph.pose_graph_normal_eqs(*args10, fixed_mask=fixed)
    H_p, g_p = pose_graph.pose_graph_normal_eqs_plain(*args10,
                                                      fixed_mask=fixed)
    H_0, _ = pose_graph.pose_graph_normal_eqs_plain(*args10)
    torch.cuda.synchronize()
    # the 1e8 of the fixed rows is left out of the scale; those diagonal
    # entries are held within one ulp
    gauge = torch.diag((torch.repeat_interleave(fixed, 6) > 0).float()) > 0
    ulp = torch.nextafter(H_p.abs(), torch.full_like(H_p, float("inf"))) \
        - H_p.abs()
    err10 = max(float((H_k - H_p).abs()[~gauge].max())
                / float(H_0.abs().max()), _rel_err(g_k, g_p))
    _check(err10 <= 1e-5 and bool(((H_k - H_p).abs()[gauge]
                                   <= ulp[gauge]).all()),
           f"pose_graph_normal_eqs relative error {err10}, or a gauge "
           f"diagonal entry beyond one ulp")
    out.append({"name": "pose_graph_normal_eqs", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/pose_graph.cu",
                "replaces": "planarslam_tpu/solvers/pose_graph.py:44",
                "max_abs_err": err10,
                "tolerance": "relative 1e-5 of H's (without the gauge "
                             "diagonal) and g's largest value; the fixed "
                             "rows' diagonal within one ulp",
                "shapes": {"N": N, "E": E, "fixed": int(fixed.sum())},
                "library_ms": None,
                # per edge: log, Jr^-1, Ad, two 6x6 products, four 6x6
                # blocks; H and g written whole
                **_bound(_nbytes(args10[:4], fixed, H_k, g_k),
                         24000.0 * E),
                "ms": _time_ms(lambda: pose_graph.pose_graph_normal_eqs(
                    *args10, fixed_mask=fixed)),
                "plain_ms": _time_ms(
                    lambda: pose_graph.pose_graph_normal_eqs_plain(
                        *args10, fixed_mask=fixed))})
    _print_kernels(out)
    return out


def ba_kernel_graph(dev) -> tuple:
    """K10's seeded 96-keyframe pose graph: a chain with covisibility edges
    (gaps 2, 3, 5) and three loop edges, one repeated, measurements 0.01
    rad / m off; returns K10's arguments (poses, edges, meas_inv, w, plan)
    and the fixed mask (keyframe 0)."""
    import torch

    from planarslam_tpu_torch.solvers import pose_graph

    rng = np.random.default_rng(10)
    N = 96
    Tw = [np.eye(4, dtype=np.float32)]
    for _ in range(N - 1):
        step = _planted_se3(rng, 0.05)
        step[:3, 3] = rng.normal(0, 0.1, 3)
        Tw.append((step @ Tw[-1]).astype(np.float32))
    Tw = np.stack(Tw)
    ij = [(i, i - 1) for i in range(1, N)]
    ij += [(i, i + d) for i in range(N) for d in (2, 3, 5) if i + d < N]
    ij += [(N - 1, 0), (N - 2, 1), (N - 1, 0)]   # loops, one repeated
    ij = np.asarray(ij, np.int32)
    meas = np.stack([_planted_se3(rng, 0.01) @ Tw[i] @ np.linalg.inv(Tw[j])
                     for i, j in ij]).astype(np.float32)
    w = np.where(np.arange(len(ij)) >= len(ij) - 3, 5.0, 1.0).astype(
        np.float32)
    fixed = np.zeros(N, np.float32)
    fixed[0] = 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ((t(Tw), t(ij), t(np.linalg.inv(meas).astype(np.float32)), t(w),
             pose_graph.edge_plan(ij, N, device=dev)), t(fixed))


def _refine_problem(rng, N: int, case: str = "outliers") -> tuple:
    """Seeded inputs of one loop-edge refinement (numpy): N points 2-6 m in
    front of camera 2 and their camera-1 coordinates through a planted
    transform, 0.5 px noise, the last 5 correspondences invalid, a start 1
    cm / 0.01 rad off. "clean" has no outlier; "outliers" moves 10% of
    camera 1's pixels 30 px; "behind" also puts one point behind both
    cameras and marks it invalid, so its clamped projection (z at 1e-6,
    pixels near 1e8) must leave the sums through the mask without a NaN (a
    valid one makes the float32 refinement diverge, the JAX package's
    too); "nonfinite" gives one pixel a NaN, so every step's dx is NaN and
    is rejected. Returns (T0, p1, p2, uv1, uv2, valid, K)."""
    K = (535.4, 539.2, 319.5, 239.5)
    p2 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(2, 6, N)], -1)
    T = _planted_se3(rng, 0.05).astype(np.float64)
    p1 = p2 @ T[:3, :3].T + T[:3, 3]

    def proj(p):
        return np.stack([K[0] * p[:, 0] / p[:, 2] + K[2],
                         K[1] * p[:, 1] / p[:, 2] + K[3]], -1)

    uv1 = proj(p1) + rng.normal(0, 0.5, (N, 2))
    uv2 = proj(p2) + rng.normal(0, 0.5, (N, 2))
    if case != "clean":
        uv1[:N // 10] += 30.0
    if case == "behind":
        p2[N // 2] = (0.4, -0.2, -3.0)
        p1[N // 2] = T[:3, :3] @ p2[N // 2] + T[:3, 3]
    if case == "nonfinite":
        uv2[3, 0] = np.nan
    valid = np.ones(N)
    valid[-5:] = 0.0
    if case == "behind":
        valid[N // 2] = 0.0
    T0 = _planted_se3(rng, 0.01) @ T
    f = np.float32
    return (T0.astype(f), p1.astype(f), p2.astype(f), uv1.astype(f),
            uv2.astype(f), valid.astype(f), K)


def _plane_problem(rng, Kt: int, Pp: int, Q: int, par_cols=None,
                   poses=None) -> dict:
    """Seeded plane inputs of a BA step (numpy): Q world planes (unit
    normals, d 1-4 m) with chart coordinates of 0.02, Kt poses 0.3 rad /
    0.3 m from the origin, and three (Kt, Pp) observation tables with 20%
    empty slots (slot -1, zero coefficients, mask 0, as
    local_ba.build_plane_tables leaves them): direct observations of the
    plane seen from the keyframe with 0.01 noise, half of them with the
    coefficients negated; parallel ones, planes of the same normal at
    another distance, half of them in the other hemisphere; vertical ones,
    a plane about perpendicular to the observed one. par_cols sets the
    parallel table's width (0: an empty table); `poses` (Kt, 4, 4) replaces
    the random poses."""
    base = rng.normal(0, 1, (Q, 4))
    base[:, :3] /= np.linalg.norm(base[:, :3], axis=1, keepdims=True)
    base[:, 3] = rng.uniform(1, 4, Q)
    theta = rng.normal(0, 0.02, (Q, 3))
    if poses is None:
        poses = np.stack([_planted_se3(rng, 0.3) for _ in range(Kt)])
    poses = np.asarray(poses, np.float64)

    def retract(q):
        n0 = base[q, :3]
        seed = np.eye(3)[np.argmin(np.abs(n0))]
        b1 = np.cross(n0, seed)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(n0, b1)
        n = n0 + theta[q, 0] * b1 + theta[q, 1] * b2
        return np.r_[n / np.linalg.norm(n), base[q, 3] + theta[q, 2]]

    def seen(k, pi):
        n = poses[k, :3, :3] @ pi[:3]
        return np.r_[n, pi[3] - n @ poses[k, :3, 3]]

    def table(kind, cols):
        slot = rng.integers(0, Q, (Kt, cols)).astype(np.int32)
        slot[rng.random((Kt, cols)) < 0.2] = -1
        pi = np.zeros((Kt, cols, 4))
        for k in range(Kt):
            for p in range(cols):
                if slot[k, p] < 0:
                    continue
                w = retract(slot[k, p])
                if kind == 1:
                    w = np.r_[w[:3], w[3] + rng.uniform(0.5, 2)]
                elif kind == 2:
                    v = np.cross(w[:3], rng.normal(0, 1, 3))
                    w = np.r_[v / np.linalg.norm(v), rng.uniform(1, 4)]
                c = seen(k, w) + rng.normal(0, 0.01, 4)
                pi[k, p] = -c if (kind < 2 and rng.random() < 0.5) else c
        f = np.float32
        return {"slot": slot, "pi_obs": pi.astype(f),
                "mask": (slot >= 0).astype(f)}

    return {"poses": poses.astype(np.float32),
            "base": base.astype(np.float32),
            "theta": theta.astype(np.float32),
            "tables": [table(0, Pp), table(1, Pp if par_cols is None
                                           else par_cols), table(2, Pp)]}


def _plane_tables(prob: dict, dev) -> list:
    """_plane_problem's three tables as port PlaneTables on dev."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core

    return [ba_core.PlaneTables(*[torch.from_numpy(t[k]).to(dev)
                                  for k in ("slot", "pi_obs", "mask")])
            for t in prob["tables"]]


def _ulps(got, want):
    """|got - want| in units of the last place of want (float32)."""
    import torch

    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return (got - want).abs() / ulp


def _rho_terms(pb, chis) -> tuple:
    """The robust cost of every observation (ba_core._rho_fn per table) and
    their count."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core

    terms = [ba_core._rho_fn(c, g, m, True)
             for c, g, m in zip(chis, pb.gates, pb.masks)]
    return terms, sum(int(t.numel()) for t in terms)


# K40's planted problems (schur_pose_graph_parity, tests): the K8 inputs of
# _ba_problem and the plane tables of _plane_problem at 16 keyframes, M =
# 1024 but in "odd_m", each case planting one structure
SCHUR_PLANTED = ("empty_keyframe", "single_view", "seen_twice",
                 "planes_everywhere", "all_fixed", "odd_m")
SCHUR_LANES = 4  # K40's batch, lane by lane


def planted_schur_problem(case: str, dev, seed: int = 40, Kt: int = 16
                          ) -> tuple:
    """The arguments of ba_core.ba_solve for one planted problem: "random"
    (_ba_problem's points, mono and stereo, line endpoints, one landmark
    observed twice by keyframe 0; _plane_problem's three tables with 20%
    empty slots; keyframe 0 fixed), "empty_keyframe" (keyframe 3 has no
    live observation in any table), "single_view" (landmark 5 is seen by
    keyframe 2 only), "seen_twice" (keyframe 1 sees landmark 7 at two
    slots), "planes_everywhere" (the direct plane table has every plane in
    every keyframe), "all_fixed" (every keyframe fixed), "odd_m" (M = 1010,
    no multiple of K40's 32-landmark words)."""
    import torch

    from planarslam_tpu_torch.config import PlaneConfig
    from planarslam_tpu_torch.solvers import ba_core

    P, Q = (1001, 9) if case == "odd_m" else (1015, 9)
    poses, pts, pt, ln, K = _ba_problem(dev, Kt, 64, 16, P, seed)
    rng = np.random.default_rng(seed + 1)
    prob = _plane_problem(rng, Kt, 4, Q, poses=poses.cpu().numpy())
    pl, par, ver = _plane_tables(prob, dev)
    pt = ba_core.PointTables(*[x.clone() for x in pt])
    ln = ba_core.LineTables(*[x.clone() for x in ln])
    fixed = torch.zeros(Kt, device=dev)
    fixed[0] = 1.0
    if case == "empty_keyframe":
        for t in (pt, ln, pl, par, ver):
            t.mask[3] = 0.0
    elif case == "single_view":
        pt.mask[pt.slot == 5] = 0.0
        pt.slot[2, 0], pt.mask[2, 0] = 5, 1.0
    elif case == "seen_twice":
        pt.slot[1, :2] = 7
        pt.mask[1, :2] = 1.0
    elif case == "planes_everywhere":
        T = prob["poses"].astype(np.float64)
        base = prob["base"].astype(np.float64)
        n_c = np.einsum("kij,qj->kqi", T[:, :3, :3], base[:, :3])
        d_c = base[None, :, 3] - np.einsum("kqi,ki->kq", n_c, T[:, :3, 3])
        pi = np.concatenate([n_c, d_c[..., None]], -1)
        pi += rng.normal(0, 0.01, pi.shape)
        pl = ba_core.PlaneTables(
            torch.arange(Q, dtype=torch.int32, device=dev).repeat(Kt, 1),
            torch.from_numpy(pi.astype(np.float32)).to(dev),
            torch.ones((Kt, Q), device=dev))
    elif case == "all_fixed":
        fixed[:] = 1.0
    base = torch.from_numpy(prob["base"]).to(dev)
    return (poses, fixed, pts, base, pt, ln, pl, par, ver, K, 40.0,
            ba_core.BAWeights.from_config(PlaneConfig()))


def schur_step(args) -> dict:
    """The first LM step of ba_solve on `args` (its arguments), up to K40's
    inputs: K8, K33 and K9 through their wrappers (their plain versions on
    the CPU). Returns the problem, HcpHinv, Hcp, Hcc, rhs, lam and the
    fixed mask."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core

    poses, fixed, lm_xyz, plane_base, pt, ln, pl, par, ver, K, bf, w = args
    pb = ba_core._problem(lm_xyz, plane_base, pt, ln, pl, par, ver, w)
    P, Q, M = pb.P, pb.Q, pb.M
    dev = poses.device
    lm = torch.cat([lm_xyz, torch.zeros((Q, 3), device=dev)]).contiguous()
    Hcc, bc, Hpp, bp, Hcp, _, _ = ba_core.ba_normal_eqs(
        poses, lm[:P], pb.pt, pb.ln, M, K, bf, True, True, pb.plan)
    Hcc, bc, Hpp, bp, Hcp, _, mu_p = ba_core.ba_plane_blocks(
        pb, poses, plane_base, lm[P:], Hcc, bc, Hpp, bp, Hcp, True)
    lam = torch.tensor(1e-4, device=dev)
    _, HcpHinv, rhs = ba_core.ba_schur_eliminate(Hpp, bp, Hcp, bc, lam,
                                                 mu_p)
    return {"pb": pb, "HcpHinv": HcpHinv, "Hcp": Hcp, "Hcc": Hcc,
            "rhs": rhs, "lam": lam, "fixed": fixed.contiguous()}


def schur_plan(pbs: list):
    """K40's plan of one problem or, from several of one shape, of their
    batch (ba_core.pair_plan on the stacked tables)."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core

    def stack(get):
        xs = [get(pb) for pb in pbs]
        return xs[0] if len(xs) == 1 else torch.stack(xs)

    pb = pbs[0]
    return ba_core.pair_plan(
        stack(lambda p: p.pt.slot), stack(lambda p: p.pt.mask),
        stack(lambda p: p.ln.slot), stack(lambda p: p.ln.mask),
        [stack(lambda p, i=i: p.pl_slots[i]) for i in range(3)],
        [stack(lambda p, i=i: p.masks[2 + i]) for i in range(3)],
        pb.P, pb.M)


def complement_emulation(HcpHinv: np.ndarray, Hcp: np.ndarray,
                         inc: np.ndarray) -> np.ndarray:
    """K40's sum in numpy, in its order: for every entry of every pair, the
    shared landmarks ascending, per landmark the products l = 0, 1, 2 each
    fused into the float32 entry in turn; then negated. The fused
    multiply-add is emulated in float64 (the product exact, the sum rounded
    to float64 and then to float32, which can differ from one rounding
    only at a float32 halfway point). HcpHinv and Hcp (Kt, 6, M, 3)
    float32, inc (Kt, M) bool (ba_core.plan_incidence)."""
    Kt, _, M, _ = Hcp.shape
    acc = np.zeros((Kt, 6, Kt, 6), np.float32)
    a64, b64 = HcpHinv.astype(np.float64), Hcp.astype(np.float64)
    for p in range(M):
        if not inc[:, p].any():
            continue
        both = (inc[:, p][:, None, None, None]
                & inc[:, p][None, None, :, None])
        for l in range(3):
            fused = (a64[:, :, p, l][:, :, None, None]
                     * b64[:, :, p, l][None, None] + acc).astype(np.float32)
            acc = np.where(both, fused, acc)
    return -acc.reshape(Kt * 6, Kt * 6)


def complement_bound(HcpHinv, Hcp, inc):
    """K40's limit per entry of S: 2 (n - 1) 2^-24 times the sum of the
    |terms|, n the entry's terms (3 per landmark its pair shares), the
    bound two float32 summation orders keep; also the shared landmark
    count per keyframe pair. Torch tensors (Kt, 6, M, 3) and (Kt, M),
    float64 sums."""
    import torch

    Kt, _, M, _ = Hcp.shape
    a = HcpHinv.abs().double().reshape(Kt * 6, M * 3)
    b = Hcp.abs().double().reshape(Kt * 6, M * 3)
    shared = inc.double() @ inc.double().T
    n = torch.repeat_interleave(torch.repeat_interleave(3 * shared, 6, 0),
                                6, 1)
    return 2 * torch.clamp(n - 1, min=0) * 2.0 ** -24 * (a @ b.T), shared


def loop_kernel_parity(dev, captured: dict) -> list:
    """K32-K35 against their plain versions on the card at path 4b's
    shapes: K32 on the inputs of the constructed loop's two
    refine_relative_se3 calls (about the identity) and on planted clean
    and outlier problems of their widths; K33-K35 on one LM step of its
    first global
    BA solve (Kt = 128, three plane tables of 16 columns, Q = 64, M =
    12864), the step's Hcc, bc, Hpp, bp and Hcp from K8: K33 on zeroed sums
    (the plane blocks alone) and on K8's (with mu_p), K35 on the step's S,
    K34 on its dxc and dxp and, in tables mode, at the step's state. Every
    kernel twice, with equal bits."""
    import torch

    from planarslam_tpu_torch.geometry import se3
    from planarslam_tpu_torch.solvers import ba_core, sim3_solver

    out = []
    # K32 --------------------------------------------------------------
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            dev)[None]

    def refine_inputs(args):
        return ((t(args[0]), torch.ones(1, device=dev), *map(t, args[1:6])),
                tuple(float(v) for v in args[6]))

    def held(ins, K, what):
        got = sim3_solver.refine_relative(*ins, K)
        again = sim3_solver.refine_relative(*ins, K)
        want = sim3_solver._refine_relative_plain(*[x[0] for x in ins], K)
        torch.cuda.synchronize()
        err = float((got[0][0] - want[0]).abs().max())
        _check(err <= 1e-5 and bool(torch.isfinite(got[0]).all()),
               f"refine_relative ({what}): pose entries off by {err}")
        _check(all(torch.equal(a, b) for a, b in zip(got, again)),
               f"refine_relative ({what}): two launches differ")
        return err, float((want[0] - ins[0][0]).abs().max())

    # path 4b's two refinements: the new keyframe copies keyframe 0's
    # features, so both start at about the identity with residuals about
    # 0, and a kernel that returned its start would pass them; K32 is
    # held on planted problems of the same widths, which the refinement
    # must move more than 1e-3 from their start
    errs4b, ns = [], []
    for n in (1, 2):
        ins, K = refine_inputs(captured["sim3_solver", "refine_relative_se3",
                                        n][0])
        errs4b.append(held(ins, K, f"path 4b call {n}")[0])
        ns.append(int(ins[2].shape[1]))
    rng = np.random.default_rng(32)
    errs, moved = [], []
    for N in ns:
        for case in ("clean", "outliers"):
            err, move = held(*refine_inputs(_refine_problem(rng, N, case)),
                             f"planted {case}, N = {N}")
            _check(move > 1e-3, f"refine_relative: the planted {case} "
                   f"problem (N = {N}) moved only {move} from its start")
            errs.append(err)
            moved.append(move)
    N = ns[-1]
    out.append({"name": "refine_relative", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/refine_relative.cu",
                "replaces": "planarslam_tpu/solvers/sim3_solver.py:117",
                "max_abs_err": max(errs),
                "max_abs_err_path4b": max(errs4b),
                "moved_from_start": min(moved),
                "tolerance": "pose entries 1e-5, on planted clean and "
                             "outlier problems at path 4b's widths (each "
                             "moved > 1e-3 from its start) and on path 4b's "
                             "own (about the identity)",
                "shapes": {"N": ns, "steps": 8}, "library_ms": None,
                # per step and correspondence: two projections with their
                # 2 x 7 Jacobians and the 35 weighted sums of each
                **_bound(_nbytes(ins) + 68, 8 * N * 600.0),
                "ms": _time_ms(lambda: sim3_solver.refine_relative(*ins, K)),
                "plain_ms": _time_ms(
                    lambda: sim3_solver._refine_relative_plain(
                        *[x[0] for x in ins], K), reps=5)})

    # one LM step of the first GBA solve -----------------------------------
    args, _ = captured["global_ba", "ba_solve", 1]
    poses, fixed, lm_xyz, plane_base, pt, ln, pl, par, ver, K, bf, w = args
    pb = ba_core._problem(lm_xyz, plane_base, pt, ln, pl, par, ver, w)
    Kt, P, Q, M = poses.shape[0], pb.P, pb.Q, pb.M
    lm = torch.cat([lm_xyz, torch.zeros((Q, 3), device=dev)]).contiguous()
    theta = lm[P:]
    lam = torch.tensor(1e-4, device=dev)
    k8 = ba_core.ba_normal_eqs(poses, lm[:P], pb.pt, pb.ln, M, K, bf, True,
                               True, pb.plan)[:5]
    n_obs = sum(int(t.mask.numel()) for t in (pl, par, ver))

    # K33: the plane blocks alone (zeroed sums), then on K8's sums with mu_p
    def blocks(fn, sums):
        return fn(pb, poses, plane_base, theta, *[x.clone() for x in sums],
                  True)

    zero = [torch.zeros_like(x) for x in k8]
    got, again = (blocks(ba_core.ba_plane_blocks, zero) for _ in range(2))
    want = blocks(ba_core.plane_blocks_plain, zero)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got[:5], again[:5]))
           and all(torch.equal(x, y) for a, b in zip(got[5], again[5])
                   for x, y in zip(a[1:], b[1:])),
           "ba_plane_blocks: two launches differ")
    err33 = max(_rel_err(a, b) for a, b in zip(got[:5], want[:5]))
    for a, b in zip(got[5], want[5]):
        err33 = max(err33, *(_rel_err(x, y) for x, y in zip(a[1:], b[1:])))
    got_f = blocks(ba_core.ba_plane_blocks, k8)
    want_f = blocks(ba_core.plane_blocks_plain, k8)
    torch.cuda.synchronize()
    err33_full = max(_rel_err(a, b) for a, b in zip(
        got_f[:5] + (got_f[6],), want_f[:5] + (want_f[6],)))
    _check(err33 <= 1e-5 and err33_full <= 1e-5,
           f"ba_plane_blocks: relative error {err33} (blocks alone), "
           f"{err33_full} (with K8's sums and mu_p)")
    _check(torch.equal(got_f[4][:, :, :P], k8[4][:, :, :P]),
           "ba_plane_blocks: Hcp's point columns changed")
    scratch = [x.clone() for x in k8]
    # the tables and states read, the sums' plane rows and columns read
    # and written, the records written, the mu_p pass's diagonal read
    bytes33 = (_nbytes(poses, plane_base, theta, pl, par, ver)
               + 2 * 4 * (Kt * 42 + Q * 12 + Kt * 18 * Q)
               + sum(4 * 11 * int(t.rr.numel()) for t in got[5])
               + 12 * M)
    out.append({"name": "ba_plane_blocks", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/ba_step.cu",
                "replaces": "planarslam_tpu/solvers/ba_core.py:407",
                "max_abs_err": max(err33, err33_full),
                "tolerance": "relative 1e-5 of each output's largest value "
                             "(the plane blocks alone and with K8's sums, "
                             "mu_p)",
                "shapes": {"Kt": Kt, "Pp": [int(t.slot.shape[1]) for t in
                                            (pl, par, ver)], "Q": Q, "M": M},
                "library_ms": None,
                # per observation: chart, transform, normalization and 9
                # Jacobian columns, then its shares of Hcc, bc, Hcp, Hpp, bp
                **_bound(bytes33, 1500.0 * n_obs),
                "ms": _time_ms(lambda: ba_core.ba_plane_blocks(
                    pb, poses, plane_base, theta, *scratch, True)),
                "plain_ms": _time_ms(lambda: ba_core.plane_blocks_plain(
                    pb, poses, plane_base, theta, *scratch, True), reps=5)})

    # the rest of the step, plain, to K35's and K34's inputs
    Hcc, bc, Hpp, bp, Hcp = want_f[:5]
    Hinv, HcpHinv, rhs = ba_core.ba_schur_eliminate(Hpp, bp, Hcp, bc, lam,
                                                    want_f[6])
    S = ba_core.ba_schur_complement_plain(HcpHinv, Hcp)
    del HcpHinv, scratch, got_f, zero
    args35 = (S, Hcc, rhs, lam, fixed)
    got35 = ba_core.ba_reduced_system(*args35)
    again35 = ba_core.ba_reduced_system(*args35)
    want35 = ba_core.reduced_system_plain(*args35)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got35, again35)),
           "ba_reduced_system: two launches differ")
    ulps = float(_ulps(got35[0], want35[0]).max())
    fixed_rows = torch.repeat_interleave(fixed, 6) > 0
    eye = torch.eye(Kt * 6, device=dev)
    _check(ulps <= 4 and torch.equal(got35[1], want35[1])
           and torch.equal(got35[0][fixed_rows], eye[fixed_rows])
           and torch.equal(got35[0][:, fixed_rows], eye[:, fixed_rows]),
           f"ba_reduced_system: {ulps} ulps, or a fixed row not exactly "
           f"the identity")
    out.append({"name": "ba_reduced_system", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/ba_step.cu",
                "replaces": "planarslam_tpu/solvers/ba_core.py:475",
                "max_abs_err": float((got35[0] - want35[0]).abs().max()),
                "tolerance": "4 ulps; the fixed rows and columns exactly "
                             "the identity; rhs exact",
                "ulps": ulps, "shapes": {"Kt": Kt, "n": 6 * Kt,
                                         "fixed": int(fixed.sum())},
                "library_ms": None,
                # mu_c over the diagonal, then four operations per entry
                **_bound(_nbytes(args35, got35), 5.0 * (6 * Kt) ** 2),
                "ms": _time_ms(lambda: ba_core.ba_reduced_system(*args35)),
                "plain_ms": _time_ms(
                    lambda: ba_core.reduced_system_plain(*args35))})
    L, info = torch.linalg.cholesky_ex(want35[0])
    dx0 = torch.cholesky_solve(want35[1], L)
    dx = dx0 + torch.cholesky_solve(want35[1] - want35[0] @ dx0, L)
    dxc = torch.where(info == 0, -dx.reshape(Kt, 6), float("nan")
                      ).contiguous()
    dxp = ba_core.ba_schur_backsub(Hinv, bp, Hcp, dxc)
    del S, got35, again35, want35, L, Hinv

    # K34: the cost test of the step, then the tables mode at its state
    args34 = (pb, poses, lm, dxc, dxp, lam, plane_base, K, bf, True)
    got34 = ba_core.ba_cost_test(*args34)
    again34 = ba_core.ba_cost_test(*args34)
    want34 = ba_core.cost_test_plain(*args34)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(got34, again34)),
           "ba_cost_test: two launches differ")
    chis_new = ba_core._chi2(pb, se3.se3_exp(dxc) @ poses, lm + dxp,
                             plane_base, K, bf, w)
    chis_cur = ba_core._chi2(pb, poses, lm, plane_base, K, bf, w)
    terms, n_terms = _rho_terms(pb, chis_new)
    terms_c, _ = _rho_terms(pb, chis_cur)
    bound = 2 * (2 * n_terms - 1) * 2.0 ** -24 * float(
        sum(t.abs().sum() for t in terms + terms_c))
    dec_err = abs(float(got34.decrease) - float(want34.decrease))
    _check(dec_err <= bound, f"ba_cost_test: decrease {float(got34.decrease)}"
           f" against {float(want34.decrease)}, bound {bound}")
    decided = abs(float(want34.decrease)) > bound
    same = bool(got34.accept) == bool(want34.accept)
    _check(same or not decided, "ba_cost_test: accept differs on a decided "
           "step")
    if same:
        _check(torch.equal(got34.lm, want34.lm)
               and torch.equal(got34.lam, want34.lam)
               and float((got34.poses - want34.poses).abs().max()) <= 1e-5,
               "ba_cost_test: the selected state differs")
    # each table's decrease: K34's per-keyframe sums (its scratch) summed
    # over keyframes against the plain table's, within the table's own
    # bound, so a table left out or wrong fails where the total would not
    scratch34 = torch.empty(Kt * ba_core.COST_SCRATCH, device=dev)
    ba_core._cost_test_launch(
        pb, poses, lm, plane_base, K, bf, True,
        step=(dxc, dxp, lam, *[torch.empty_like(x) for x in got34],
              scratch34))
    k_sums = scratch34.view(Kt, ba_core.COST_SCRATCH)[
        :, ba_core.COST_SCRATCH_SUMS:ba_core.COST_SCRATCH_SUMS + 5].double(
    ).sum(0).tolist()
    tables34 = []
    for name, k_sum, tn, tc in zip(("pt", "ln", "pl", "par", "ver"), k_sums,
                                   terms, terms_c):
        p_sum = float((tn.double() - tc.double()).sum())
        b_t = 2 * (2 * max(int(tn.numel()), 1) - 1) * 2.0 ** -24 * float(
            tn.abs().sum() + tc.abs().sum())
        _check(abs(k_sum - p_sum) <= b_t, f"ba_cost_test: table {name}'s "
               f"decrease {k_sum} against {p_sum}, bound {b_t}")
        tables34.append({"table": name, "decrease": [k_sum, p_sum],
                         "bound": b_t, "decided": abs(p_sum) > b_t})
    chi_k = ba_core.ba_chi2_tables(pb, poses, lm, plane_base, K, bf)
    chi_p = ba_core._chi2(pb, poses, lm, plane_base, K, bf, w)
    torch.cuda.synchronize()
    err34 = max(_rel_err(a, b) for a, b in zip(chi_k, chi_p) if b.numel())
    _check(err34 <= 1e-6, f"ba_cost_test (tables mode): chi2 relative "
           f"error {err34}")
    out.append({"name": "ba_cost_test", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/ba_step.cu",
                "replaces": "planarslam_tpu/solvers/ba_core.py:497",
                "max_abs_err": err34,
                "tolerance": "chi2 1e-6 of each table's largest value; the "
                             "decrease within 2 (n - 1) 2^-24 of the sum of "
                             "the |rho| terms, and each table's within its "
                             "own; accept equal where |decrease| exceeds "
                             "that",
                "decrease": [float(got34.decrease), float(want34.decrease)],
                "decrease_bound": bound, "tables": tables34,
                "accept": bool(got34.accept),
                "accept_flips_within_bound": int(not same),
                "shapes": {"Kt": Kt, "F": int(pt.slot.shape[1]),
                           "L2": int(ln.slot.shape[1]), "M": M,
                           "observations": n_terms},
                "library_ms": None,
                # per observation and state: a transform, a projection or
                # a plane error, the robust cost
                **_bound(_nbytes(args34[1:6], pt, ln, pl, par, ver, got34),
                         2 * 60.0 * n_terms),
                "ms": _time_ms(lambda: ba_core.ba_cost_test(*args34)),
                "plain_ms": _time_ms(
                    lambda: ba_core.cost_test_plain(*args34))})
    _print_kernels(out)
    return out


# K41's planted steps (schur_pose_graph_parity): theta^2 of the rotation
# part just below and just above se3.so3_exp's small-angle threshold
SMALL_ANGLE = 1e-8
UPDATE_PLANTED = ("zero", "below_threshold", "above_threshold", "near_pi",
                  "nonfinite")


def planted_update_steps(case: str, N: int, seed: int = 41) -> np.ndarray:
    """(N, 6) float32 steps of K41 (the solve's, negated inside): "zero";
    rotations with theta^2 at 0.99 and 1.01 of SMALL_ANGLE (the Taylor
    branch and the closed form), translations 1e-3; "near_pi", rotations
    of pi - 1e-4 about random axes; "nonfinite", a NaN in one pose's
    translation, a NaN and an infinity in others' rotations, the rest
    random."""
    rng = np.random.default_rng(seed)
    step = np.zeros((N, 6), np.float64)
    if case == "zero":
        return step.astype(np.float32)
    axis = rng.normal(0, 1, (N, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    step[:, :3] = rng.normal(0, 1e-3, (N, 3))
    if case in ("below_threshold", "above_threshold"):
        th2 = SMALL_ANGLE * (0.99 if case == "below_threshold" else 1.01)
        step[:, 3:] = axis * np.sqrt(th2)
    elif case == "near_pi":
        step[:, 3:] = axis * (np.pi - 1e-4)
    else:
        step[:, 3:] = rng.normal(0, 0.05, (N, 3))
        step[0, 1] = np.nan
        step[1, 4] = np.nan
        step[2, 5] = np.inf
    return step.astype(np.float32)


def _update_held(name: str, got, want) -> float:
    """K41's limit: entries within 1e-6 of max(1, |entry|), NaN exactly
    where the plain version has NaN; returns the largest difference."""
    import torch

    nan_k, nan_p = torch.isnan(got), torch.isnan(want)
    _check(torch.equal(nan_k, nan_p), f"pose_graph_update ({name}): NaN at "
           f"{int((nan_k != nan_p).sum())} entries where the plain version "
           f"has none, or the reverse")
    ok = ~nan_p
    diff = (got[ok] - want[ok]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    _check(bool((diff <= 1e-6 * torch.clamp(want[ok].abs(), min=1.0)).all()),
           f"pose_graph_update ({name}): entries off by {err}")
    return err


def schur_pose_graph_parity(dev, captured: dict) -> list:
    """K40 (ba_schur_complement) against its plain version, the dense
    product, on path 4b's captured first LM step (Kt = 128, M = 12864),
    path 4c's dense orbit (Kt = 96) at its start, the SCHUR_PLANTED
    problems and four lanes at B = 4 (each lane bit-equal to its own B = 1
    launch): every entry within complement_bound of the plain one, the
    blocks of pairs that share no landmark exactly 0 in both, two launches
    equal bits, and K35 then the Cholesky of both S giving the same info;
    K10 with the gauge diagonal against its plain version on path 4b's pose
    graph (its 10 GN steps) and on ba_kernel_parity's 96-keyframe graph;
    K41 (pose_graph_update) against its plain version along path 4b's 10
    GN steps, on UPDATE_PLANTED steps and at B = 4."""
    import torch

    from planarslam_tpu_torch.geometry import se3
    from planarslam_tpu_torch.solvers import ba_core, pose_graph

    out = []

    def hold_complement(name, st, plan):
        """K40 on one step's inputs: bits of two launches, the bound, zero
        blocks, the Cholesky info; returns (error, shared counts)."""
        a, b, M = st["HcpHinv"], st["Hcp"], st["Hcp"].shape[-2]
        got = ba_core.ba_schur_complement(a, b, plan)
        again = ba_core.ba_schur_complement(a, b, plan)
        want = ba_core.ba_schur_complement_plain(a, b)
        torch.cuda.synchronize()
        _check(torch.equal(got, again) and bool(
            torch.equal(got.view(torch.int32), again.view(torch.int32))),
            f"ba_schur_complement ({name}): two launches differ")
        inc = ba_core.plan_incidence(plan, M)
        bound, shared = complement_bound(a, b, inc)
        err = (got.double() - want.double()).abs()
        over = err > bound
        _check(not bool(over.any()), f"ba_schur_complement ({name}): "
               f"{int(over.sum())} entries beyond 2 (n - 1) 2^-24 sum|t|, "
               f"largest {float(err.max())}")
        alone = torch.repeat_interleave(torch.repeat_interleave(
            shared == 0, 6, 0), 6, 1)
        _check(bool((got[alone] == 0).all()) and bool(
            (want[alone] == 0).all()), f"ba_schur_complement ({name}): a "
            f"block of a pair that shares no landmark is not 0")
        infos = []
        for S in (got, want):
            S_r, _ = ba_core.ba_reduced_system(S, st["Hcc"], st["rhs"],
                                               st["lam"], st["fixed"])
            infos.append(int(torch.linalg.cholesky_ex(S_r)[1]))
        _check(infos[0] == infos[1], f"ba_schur_complement ({name}): "
               f"Cholesky info {infos[0]} against the plain S's {infos[1]}")
        Kt = b.shape[0]
        triplets = float((shared.sum() + shared.diagonal().sum()) / 2)
        res = {"max_abs_err": float(err.max()),
               "max_err_over_bound": float((err / torch.clamp(
                   bound, min=1e-300)).max()),
               "pairs": int(((shared > 0).sum() + (
                   shared.diagonal() > 0).sum()) // 2),
               "pairs_of": Kt * (Kt + 1) // 2,
               "triplets": triplets, "cholesky_info": infos[0],
               "incidences": int(inc.sum())}
        print(f"ba_schur_complement ({name}): {json.dumps(res)}", flush=True)
        return res

    # path 4b's first global BA step, path 4c's dense orbit at its start
    steps = {"path4b": schur_step(captured["global_ba", "ba_solve", 1][0])}
    _, _, orbit, _ = _orbit_problem(np.random.default_rng(42), 96, 1024, 48,
                                    dev)
    steps["path4c_dense"] = schur_step(orbit)
    cases = {}
    for name, st in steps.items():
        cases[name] = hold_complement(name, st, st["pb"].pairs)
    for case in SCHUR_PLANTED:
        st = schur_step(planted_schur_problem(case, dev))
        cases[case] = hold_complement(case, st, st["pb"].pairs)
        del st
    lanes = [schur_step(planted_schur_problem("random", dev, seed=40 + b))
             for b in range(SCHUR_LANES)]
    plan_b = schur_plan([st["pb"] for st in lanes])
    a_b = torch.stack([st["HcpHinv"] for st in lanes])
    b_b = torch.stack([st["Hcp"] for st in lanes])
    S_b = ba_core.ba_schur_complement(a_b, b_b, plan_b)
    for i, st in enumerate(lanes):
        _check(torch.equal(plan_b.bits[i], st["pb"].pairs.bits)
               and torch.equal(plan_b.counts[i], st["pb"].pairs.counts),
               f"pair_plan: lane {i} of the batch differs from its own plan")
        cases[f"lane{i}"] = hold_complement(f"lane {i}", st, st["pb"].pairs)
        _check(torch.equal(S_b[i].view(torch.int32), ba_core.
                           ba_schur_complement(st["HcpHinv"], st["Hcp"],
                                               st["pb"].pairs)
                           .view(torch.int32)),
               f"ba_schur_complement: lane {i} of B = {SCHUR_LANES} differs "
               f"from its B = 1 launch")
    st = steps["path4b"]
    a, b, plan = st["HcpHinv"], st["Hcp"], st["pb"].pairs
    Kt, M = b.shape[0], b.shape[2]
    rec = cases["path4b"]
    # the nonzero 6 x 3 blocks of both operands read once, S written
    n_bytes = 2 * rec["incidences"] * 18 * 4 + (6 * Kt) ** 2 * 4
    a2, b2 = a.view(Kt * 6, M * 3), b.view(Kt * 6, M * 3)
    st4c = steps["path4c_dense"]
    out.append({"name": "ba_schur_complement", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/ba_complement.cu",
                "replaces": "planarslam_tpu/solvers/ba_core.py:470",
                "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                "tolerance": "each entry within 2 (n - 1) 2^-24 of the sum "
                             "of its |terms| (n its terms, 3 per shared "
                             "landmark); blocks of pairs sharing no landmark "
                             "exactly 0; two launches equal bits; the same "
                             "Cholesky info",
                "cases": cases,
                "shapes": {"Kt": Kt, "M": M, "lanes": SCHUR_LANES},
                **_bound(n_bytes, 2 * 216.0 * rec["triplets"]),
                "ms": _time_ms(lambda: ba_core.ba_schur_complement(
                    a, b, plan)),
                "ms_path4c_dense": _time_ms(
                    lambda: ba_core.ba_schur_complement(
                        st4c["HcpHinv"], st4c["Hcp"], st4c["pb"].pairs)),
                "plain_ms": _time_ms(
                    lambda: ba_core.ba_schur_complement_plain(a, b)),
                "library_ms": _time_ms(lambda: torch.matmul(a2, b2.T)),
                "library_ms_path4c_dense": _time_ms(lambda: torch.matmul(
                    st4c["HcpHinv"].view(96 * 6, -1),
                    st4c["Hcp"].view(96 * 6, -1).T)),
                "batch_ms": _time_ms(lambda: ba_core.ba_schur_complement(
                    a_b, b_b, plan_b))})
    del steps, lanes, a_b, b_b, st, st4c

    # K10 with the gauge diagonal and K41 along path 4b's 10 GN steps
    (poses0, ij, meas, w, fixed), kw = captured["pose_graph", "_optimize",
                                               1]
    plan10 = kw["plan"]
    meas_inv = se3.T_inv(meas).contiguous()
    n = poses0.shape[0]

    def hold_normal_eqs(name, args, fx):
        got = pose_graph.pose_graph_normal_eqs(*args, fixed_mask=fx)
        want = pose_graph.pose_graph_normal_eqs_plain(*args, fixed_mask=fx)
        bare = pose_graph.pose_graph_normal_eqs_plain(*args)
        torch.cuda.synchronize()
        gauge = torch.diag((torch.repeat_interleave(fx, 6) > 0).float()) > 0
        scale = float(bare[0].abs().max())
        dH = (got[0] - want[0]).abs()
        ulp = torch.nextafter(want[0].abs(), torch.full_like(
            want[0], float("inf"))) - want[0].abs()
        err = max(float(dH[~gauge].max()) / scale,
                  float((got[1] - want[1]).abs().max())
                  / max(float(want[1].abs().max()), 1e-30))
        _check(err <= 1e-5 and bool((dH[gauge] <= ulp[gauge]).all()),
               f"pose_graph_normal_eqs ({name}): relative error {err}, or a "
               f"gauge diagonal entry beyond one ulp")
        return err

    poses_k = poses0.contiguous()
    errs10, errs41 = [], []
    for it in range(10):
        args = (poses_k, ij, meas_inv, w, plan10)
        errs10.append(hold_normal_eqs(f"path 4b step {it}", args, fixed))
        H, g = pose_graph.pose_graph_normal_eqs(*args, fixed_mask=fixed)
        step = torch.linalg.solve_ex(H, g, check_errors=False)[0].view(n, 6)
        got = pose_graph.pose_graph_update(poses_k, step)
        again = pose_graph.pose_graph_update(poses_k, step)
        want = pose_graph.pose_graph_update_plain(poses_k, step)
        torch.cuda.synchronize()
        _check(torch.equal(got, again), "pose_graph_update: two launches "
               "differ")
        errs41.append(_update_held(f"path 4b step {it}", got, want))
        poses_k = got
    gn_args, gn_step = (poses0.contiguous(), ij, meas_inv, w, plan10), step
    # ba_kernel_parity's 96-keyframe graph with keyframe 0 fixed
    args96, fx96 = ba_kernel_graph(dev)
    errs10.append(hold_normal_eqs("96 keyframes", args96, fx96))
    planted = {}
    for case in UPDATE_PLANTED:
        st6 = torch.from_numpy(planted_update_steps(case, n)).to(dev)
        got = pose_graph.pose_graph_update(poses0, st6)
        planted[case] = _update_held(case, got,
                                     pose_graph.pose_graph_update_plain(
                                         poses0, st6))
    lanes = torch.stack([poses0] * 4), torch.from_numpy(np.stack(
        [planted_update_steps(c, n) for c in UPDATE_PLANTED[:4]])).to(dev)
    got_b = pose_graph.pose_graph_update(*lanes)
    for i in range(4):
        _check(torch.equal(got_b[i], pose_graph.pose_graph_update(
            lanes[0][i], lanes[1][i])), f"pose_graph_update: lane {i} of B "
            f"= 4 differs from its B = 1 launch")
    planted["batch4"] = _update_held("B = 4", got_b,
                                     pose_graph.pose_graph_update_plain(
                                         *lanes))
    out.append({"name": "pose_graph_update", "route": "cuda",
                "source": "planarslam_tpu_torch/csrc/pose_graph.cu",
                "replaces": "planarslam_tpu/solvers/pose_graph.py:75",
                "max_abs_err": max(errs41 + list(planted.values())),
                "max_abs_err_planted": planted,
                "tolerance": "pose entries within 1e-6 of max(1, |entry|), "
                             "NaN where the plain version's; two launches "
                             "equal bits, B = 4 lanes equal their B = 1 "
                             "launches",
                "shapes": {"N": n, "gn_steps": 10}, "library_ms": None,
                # per pose: se3_exp's Rodrigues and left Jacobian, a 4 x 4
                # product
                **_bound(_nbytes(poses0, gn_step) * 2 - _nbytes(gn_step),
                         300.0 * n),
                "ms": _time_ms(lambda: pose_graph.pose_graph_update(
                    poses0, gn_step)),
                "plain_ms": _time_ms(lambda: pose_graph.
                                     pose_graph_update_plain(poses0,
                                                             gn_step))})
    ms10 = _time_ms(lambda: pose_graph.pose_graph_normal_eqs(
        *gn_args, fixed_mask=fixed))
    print(f"pose_graph_normal_eqs with the gauge diagonal: relative errors "
          f"{errs10}, {ms10} ms at path 4b's N = {n}, E = {ij.shape[0]}",
          flush=True)
    _print_kernels(out)
    return out


def construct_loop(m, src: int = 0):
    """The constructed loop of tests/test_reloc_loop.py::
    test_loop_verify_and_correct_constructed on a port map: a new keyframe
    copies keyframe `src`'s snapshot with its pose drifted by
    (0.08, -0.04, 0.06) m and observes clones of src's landmarks. Returns
    (kf, number of clones, drifted pose)."""
    kf = m.alloc_keyframe()
    m.kf_valid[kf] = True
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [0.08, -0.04, 0.06]
    m.kf_pose[kf] = (drift @ m.kf_pose[src]).astype(np.float32)
    for arr in ("kf_uv", "kf_ur", "kf_depth", "kf_level", "kf_angle",
                "kf_desc", "kf_feat_valid", "kf_pt_idx", "kf_bow"):
        getattr(m, arr)[kf] = getattr(m, arr)[src]
    m.kf_parent[kf] = m.n_kf - 2
    sel = np.flatnonzero((m.kf_pt_idx[src] >= 0)
                         & m.pt_valid[np.clip(m.kf_pt_idx[src], 0, None)])
    orig = m.kf_pt_idx[src][sel]
    clones = m.alloc_points(len(sel))
    for arr in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
                "pt_max_dist"):
        getattr(m, arr)[clones] = getattr(m, arr)[orig]
    m.pt_valid[clones] = True
    m.pt_nobs[clones] = 1
    m.pt_found[clones] = 1
    m.pt_visible[clones] = 1
    m.pt_first_kf[clones] = kf
    m.kf_pt_idx[kf, sel] = clones
    m.update_covisibility(kf)
    return kf, len(clones), m.kf_pose[kf].copy()


def loop_capture(seq, cfg, dev) -> dict:
    """The inputs path 4b's correction gives its first global BA solve and
    its pose graph, keyed as LOOP_CAPTURE's, from a System tracked over the
    sequence's first CONSTRUCTED_FRAMES frames and the constructed loop,
    with no check (the timing tools' problems, on any tree of the port)."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System
    from planarslam_tpu_torch.solvers import global_ba, pose_graph

    slam = System(config=cfg, device=dev)
    for i in range(CONSTRUCTED_FRAMES):
        slam.track_rgbd(*quantize_frame(*seq.render(i),
                                        cfg.camera.depth_map_factor),
                        seq.timestamps[i])
    slam.shutdown()
    kf, _, _ = construct_loop(slam.map)
    slam.loop_closer.run_gba = True
    captured = {}
    kept = [(global_ba, "ba_solve"), (pose_graph, "_optimize")]
    orig = [getattr(mod, attr) for mod, attr in kept]

    def capturing(fn, key):
        def captured_call(*args, **kw):
            captured.setdefault(key, _clone((args, kw)))
            return fn(*args, **kw)
        return captured_call

    for (mod, attr), fn in zip(kept, orig):
        setattr(mod, attr, capturing(fn, (mod.__name__.split(".")[-1],
                                          attr, 1)))
    try:
        slam.loop_closer._verify_and_correct(kf, 0)
    finally:
        for (mod, attr), fn in zip(kept, orig):
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    return captured


def schur_problems(captured: dict, dev) -> dict:
    """K40 on path 4b's first LM step, path 4c's dense orbit at its start
    and four planted lanes at B = 4, and the dense torch.matmul of each
    step (the library call; on a tree without K40, the matmuls alone)."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core

    steps = {"path4b": schur_step(captured["global_ba", "ba_solve", 1][0]),
             "path4c_dense": schur_step(_orbit_problem(
                 np.random.default_rng(42), 96, 1024, 48, dev)[2])}
    probs = {}
    for name, st in steps.items():
        Kt = st["Hcp"].shape[0]
        a, b = st["HcpHinv"].view(Kt * 6, -1), st["Hcp"].view(Kt * 6, -1)
        probs[f"{name}_matmul"] = (lambda a=a, b=b: torch.matmul(a, b.T))
        if hasattr(ba_core, "ba_schur_complement"):
            probs[name] = (lambda st=st: ba_core.ba_schur_complement(
                st["HcpHinv"], st["Hcp"], st["pb"].pairs))
    if hasattr(ba_core, "ba_schur_complement"):
        lanes = [schur_step(planted_schur_problem("random", dev,
                                                  seed=40 + b))
                 for b in range(SCHUR_LANES)]
        args = (torch.stack([st["HcpHinv"] for st in lanes]),
                torch.stack([st["Hcp"] for st in lanes]),
                schur_plan([st["pb"] for st in lanes]))
        probs["planted_b4"] = lambda: ba_core.ba_schur_complement(*args)
    return probs


def pose_graph_problems(captured: dict, dev) -> dict:
    """Path 4b's pose graph: _optimize with one and with two Gauss-Newton
    steps (`gn_steps_1`, `gn_steps_2`: every device launch; their
    difference is one step's), K10 at its start without the
    gauge diagonal (any tree) and with it, and K41 on its first step (a
    tree with K41)."""
    import torch

    from planarslam_tpu_torch.geometry import se3
    from planarslam_tpu_torch.solvers import pose_graph

    (poses, ij, meas, w, fixed), kw = captured["pose_graph", "_optimize", 1]
    plan = kw["plan"]
    args = (poses.contiguous(), ij, se3.T_inv(meas).contiguous(), w, plan)
    probs = {f"gn_steps_{n}": (lambda n=n: pose_graph._optimize(
        poses, ij, meas, w, fixed, n_iters=n, plan=plan)) for n in (1, 2)}
    probs["normal_eqs"] = lambda: pose_graph.pose_graph_normal_eqs(*args)
    if hasattr(pose_graph, "pose_graph_update"):
        H, g = pose_graph.pose_graph_normal_eqs(*args, fixed_mask=fixed)
        step = torch.linalg.solve_ex(H, g)[0].view(-1, 6)
        probs["normal_eqs_gauge"] = lambda: pose_graph.pose_graph_normal_eqs(
            *args, fixed_mask=fixed)
        probs["update"] = lambda: pose_graph.pose_graph_update(poses, step)
    return probs


def _count_verifications(lc) -> dict:
    """Wrap a loop closer's verification: count the calls and the K3 and K6
    launches made inside them."""
    from planarslam_tpu_torch import kernels

    inside = {"verifications": 0, "gated_hamming_top2": 0,
              "horn_align_batch": 0}
    orig = lc._verify_and_correct

    def counted(kf, c):
        before = dict(kernels.LAUNCHES)
        try:
            return orig(kf, c)
        finally:
            inside["verifications"] += 1
            for name in ("gated_hamming_top2", "horn_align_batch"):
                inside[name] += kernels.LAUNCHES[name] - before[name]

    lc._verify_and_correct = counted
    return inside


def _count_fuse_searches(local_mapper):
    """Wrap a local mapper's _fuse_lines: count the calls and the K23
    launches made inside them (its search over cfg.map.max_lines lines)."""
    from planarslam_tpu_torch import kernels

    inside = {"fuse_lines_calls": 0, "k23_in_fuse_lines": 0}
    orig = local_mapper._fuse_lines

    def counted(kf):
        before = kernels.LAUNCHES["search_lines_by_projection"]
        try:
            return orig(kf)
        finally:
            inside["fuse_lines_calls"] += 1
            inside["k23_in_fuse_lines"] += (
                kernels.LAUNCHES["search_lines_by_projection"] - before)

    local_mapper._fuse_lines = counted
    return inside


def run_loop_path(seq, cfg, dev) -> dict:
    """Path 4a: the default System (loop closing on) over the loop
    sequence."""
    import dataclasses

    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.evaluation.ate import ate_rmse
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System

    cfg = cfg.replace(loop=dataclasses.replace(
        cfg.loop, min_kf_gap=3, consistency_threshold=2))
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(len(seq))]
    slam = System(config=cfg, device=dev)
    inside = _count_verifications(slam.loop_closer)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    with _pose_calls() as pc, _ransac_calls() as rc:
        times = _drive(slam, frames, seq.timestamps)
    poses = slam.frame_poses_wc()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = dict(kernels.LAUNCHES)
    _check(poses.shape == (len(seq), 4, 4) and bool(np.isfinite(poses).all()),
           "path4a: bad trajectory")
    ate = ate_rmse(poses[:, :3, 3], seq.poses_wc[:len(seq), :3, 3])
    lc = slam.loop_closer
    t_ms = np.asarray(times[1:])
    res = {"ate_rmse_m": ate, "frames": len(seq),
           "keyframes": int(slam.map.n_kf),
           "valid_keyframes": int(len(slam.map.valid_kf_ids())),
           "lost": int(slam.tracker.stats["lost"]),
           "loops_closed": int(lc.loops_closed),
           "verifications": inside["verifications"],
           "k3_in_verification": inside["gated_hamming_top2"],
           "k6_in_verification": inside["horn_align_batch"],
           "pose_graph_calls": lc.stats["pose_graphs"],
           "gba_calls": lc.stats["gba_calls"],
           "median_ms_per_frame": float(np.median(t_ms)),
           "p95_ms_per_frame": float(np.percentile(t_ms, 95)),
           **_call_counts(pc), "wall_s": wall, "launches": launches,
           "ransacs": _check_ransacs("path4a", rc)}
    print("path4a_loop " + json.dumps(res), flush=True)
    _check_pose_launches("path4a", launches, pc, cfg, len(seq))
    _check(ate < ATE_LIMIT_M, f"path4a: ATE {ate:.5f} m >= {ATE_LIMIT_M} m")
    _check(res["lost"] == 0, f"path4a: {res['lost']} lost frames")
    if inside["verifications"]:
        _check(inside["gated_hamming_top2"] > 0
               and inside["horn_align_batch"] > 0,
               "path4a: loop verification ran without K3 and K6 on the card")
    return res


def run_constructed_loop_path(seq, cfg, dev) -> dict:
    """Path 4b: verification and correction of a constructed loop on a
    640x480 map, global BA on."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System
    from planarslam_tpu_torch.solvers import global_ba

    slam = System(config=cfg, device=dev)
    kernels.reset_launches()
    with _pose_calls() as pc_track:
        for i in range(CONSTRUCTED_FRAMES):
            slam.track_rgbd(*quantize_frame(*seq.render(i),
                                            cfg.camera.depth_map_factor),
                            seq.timestamps[i])
        slam.shutdown()
    tracking_launches = dict(kernels.LAUNCHES)
    _check_pose_launches("path4b (tracking)", tracking_launches, pc_track,
                         cfg, CONSTRUCTED_FRAMES)
    m = slam.map
    kf, n_clones, pose_before = construct_loop(m)
    n_valid = int(m.pt_valid.sum())
    lc = slam.loop_closer
    lc.run_gba = True
    inside = _count_verifications(lc)
    after_pg = {}
    orig_gba = global_ba.global_bundle_adjustment

    def gba_after_pose_graph(slam_map, c, **kw):
        after_pg["pose"] = slam_map.kf_pose[kf].copy()
        t0 = time.perf_counter()
        orig_gba(slam_map, c, **kw)
        torch.cuda.synchronize()
        after_pg["gba_s"] = time.perf_counter() - t0

    # verification ends where it records the loop edge (its results are
    # on the host by then)
    orig_edge = m.add_loop_edge

    def timed_edge(*a):
        after_pg["verify_s"] = time.perf_counter() - t0
        return orig_edge(*a)

    global_ba.global_bundle_adjustment = gba_after_pose_graph
    m.add_loop_edge = timed_edge
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with _pose_calls(LOOP_CAPTURE) as pc, _ransac_calls() as rc:
            ok = lc._verify_and_correct(kf, 0)
    finally:
        global_ba.global_bundle_adjustment = orig_gba
        del m.add_loop_edge
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    drift = float(np.linalg.norm(pose_before[:3, 3] - m.kf_pose[0][:3, 3]))
    delta_pg = float(np.linalg.norm(after_pg.get("pose", pose_before)[:3, 3]
                                    - m.kf_pose[0][:3, 3]))
    delta_gba = float(np.linalg.norm(m.kf_pose[kf][:3, 3]
                                     - m.kf_pose[0][:3, 3]))
    fused = n_valid - int(m.pt_valid.sum())
    res = {"keyframes": int(len(m.valid_kf_ids())), "verified": bool(ok),
           "drift_m": drift, "offset_after_pose_graph_m": delta_pg,
           "offset_after_gba_m": delta_gba, "clones": n_clones,
           "fused": fused, "last_fuse_count": lc.last_fuse_count,
           "k3_in_verification": inside["gated_hamming_top2"],
           "k6_in_verification": inside["horn_align_batch"],
           "verify_s": after_pg.get("verify_s"),
           "gba_s": after_pg.get("gba_s"), "wall_s": wall,
           **_call_counts(pc), "launches": launches,
           "tracking_calls": _call_counts(pc_track),
           "tracking_launches": tracking_launches,
           "ransacs": _check_ransacs("path4b", rc)}
    print("path4b_constructed_loop " + json.dumps(res), flush=True)
    _check(rc["horn"] >= 1, "path4b: verification ran no Horn RANSAC")
    _check_pose_launches("path4b", launches, pc, cfg)
    _check(ok, "path4b: the constructed loop was not verified")
    _check("pose" in after_pg, "path4b: global BA did not run")
    _check(delta_pg < 0.4 * drift, f"path4b: the pose graph left "
           f"{delta_pg:.4f} m of the {drift:.4f} m drift")
    _check(fused >= 0.3 * n_clones,
           f"path4b: only {fused} of {n_clones} cloned points fused")
    _check(np.isfinite(m.kf_pose[:m.n_kf]).all(), "path4b: non-finite poses")
    for name in ("ba_normal_eqs", "ba_schur_eliminate",
                 "pose_graph_normal_eqs", "gated_hamming_top2",
                 "horn_align_batch", "refine_relative", "ba_plane_blocks",
                 "ba_cost_test", "ba_reduced_system", "ba_schur_complement",
                 "pose_graph_update"):
        _check(launches[name] > 0, f"path4b: {name} not launched")
    _check(all(c in pc["inputs"] for c in LOOP_CAPTURE),
           "path4b: the refinement, global BA and pose-graph inputs were not "
           "captured")
    res["captured"] = pc["inputs"]
    return res


def _orbit_problem(rng, Kt: int, P: int, F: int, dev):
    """tests/test_ba_full.py::_orbit_problem in numpy and the port: cameras
    on a radius-6 circle around a landmark cloud, perfect observations,
    accumulated pose drift; returns port tables on `dev`."""
    import torch

    from planarslam_tpu_torch.config import PlaneConfig
    from planarslam_tpu_torch.geometry import se3
    from planarslam_tpu_torch.solvers import ba_core

    K, bf = (300.0, 310.0, 160.0, 120.0), 24.0
    pts_gt = rng.normal(0, 1.5, (P, 3)).astype(np.float32)
    poses_gt = []
    for k in range(Kt):
        ang = 2 * np.pi * k / Kt
        c = np.array([6 * np.sin(ang), 0.3 * np.sin(3 * ang),
                      -6 * np.cos(ang)], np.float32)
        fwd = -c / np.linalg.norm(c)
        right = np.cross(np.array([0, 1, 0], np.float32), fwd)
        right /= np.linalg.norm(right)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        T_wc[:3, 3] = c
        poses_gt.append(np.linalg.inv(T_wc).astype(np.float32))
    poses_gt = np.stack(poses_gt)
    slot = np.full((Kt, F), -1, np.int32)
    uv = np.zeros((Kt, F, 2), np.float32)
    ur = np.full((Kt, F), -1.0, np.float32)
    for k in range(Kt):
        for f, p in enumerate(rng.choice(P, F, replace=False)):
            pc = poses_gt[k, :3, :3] @ pts_gt[p] + poses_gt[k, :3, 3]
            u = K[0] * pc[0] / pc[2] + K[2]
            v = K[1] * pc[1] / pc[2] + K[3]
            if pc[2] < 0.5 or not (0 <= u < 320 and 0 <= v < 240):
                continue
            slot[k, f], uv[k, f], ur[k, f] = p, (u, v), u - bf / pc[2]
    poses0 = poses_gt.copy()
    drift = np.eye(4, dtype=np.float32)
    for k in range(1, Kt):
        xi = np.r_[rng.normal(0, 0.0006, 3), rng.normal(0, 0.002, 3)]
        drift = se3.se3_exp(torch.from_numpy(xi.astype(np.float32))
                            ).numpy() @ drift
        poses0[k] = drift @ poses0[k]
    pts0 = pts_gt + rng.normal(0, 0.02, (P, 3)).astype(np.float32)
    fixed = np.zeros(Kt, np.float32)
    fixed[0] = 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pt = ba_core.PointTables(t(slot), t(uv), t(ur),
                             t(np.ones((Kt, F), np.float32)),
                             t((slot >= 0).astype(np.float32)))
    empty = ba_core.empty_plane_tables(Kt, dev)
    args = (t(poses0), t(fixed), t(pts0), torch.zeros((0, 4), device=dev),
            pt, ba_core.empty_line_tables(Kt, dev), empty, empty, empty, K,
            bf, ba_core.BAWeights.from_config(PlaneConfig()))
    return poses_gt, poses0, args, slot


PCG_N_ITERS, PCG_N_CG = 12, 48  # path 4c's LM steps, ba_solve_pcg's CG steps
PCG_KF_LARGE = 512  # solvers/global_ba.py MAX_GBA_KF_PCG


def pcg_launches(n_iters: int = PCG_N_ITERS, n_cg: int = PCG_N_CG) -> dict:
    """K43-K45's launches in one ba_solve_pcg call: per LM step one K43,
    K44's C calls (two launches a CG step, as its entry reports them, and
    one for the back-substitution) and K45 once a CG step and once in its
    init mode."""
    from planarslam_tpu_torch.solvers import ba_pcg

    return {"pcg_prepare": n_iters,
            "pcg_schur_matvec": n_iters * (ba_pcg.MATVEC_LAUNCHES * n_cg
                                           + ba_pcg.BACKSUB_LAUNCHES),
            "pcg_cg_update": n_iters * (n_cg + 1)}


def run_ba_scale_path(dev) -> dict:
    """Path 4c: ba_solve on the 96-keyframe orbit and ba_solve_pcg on the
    256-keyframe one, held to tests/test_ba_full.py's limits, and
    ba_solve_pcg on a 512-keyframe orbit (MAX_GBA_KF_PCG; reported, held
    finite: its convergence limits are not verified); each PCG solve
    through K43-K45 as pcg_launches says. Under "problems" the PCG orbits'
    arguments, for pcg_parity."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.solvers.ba_core import ba_solve
    from planarslam_tpu_torch.solvers.ba_pcg import ba_solve_pcg

    rng = np.random.default_rng(42)
    res, problems = {}, {}
    kernels.reset_launches()
    calls = {}
    for name, solver, Kt, F, lim_mean, lim_max in (
            ("dense", ba_solve, 96, 48, 0.15, 0.3),
            ("pcg", ba_solve_pcg, 256, 24, 0.2, 0.4),
            ("pcg512", ba_solve_pcg, PCG_KF_LARGE, 24, None, None)):
        poses_gt, poses0, args, slot = _orbit_problem(rng, Kt, 1024, F, dev)
        if solver is ba_solve_pcg:
            problems[name] = (poses_gt, args)
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        with _pose_calls() as pc:
            poses1, _, _, chis = solver(*args, n_iters=PCG_N_ITERS)
            poses1 = poses1.cpu().numpy()
        wall = time.perf_counter() - t0
        for key, n in pc.items():
            if isinstance(n, int):
                calls[key] = calls.get(key, 0) + n
        _check(all(kernels.LAUNCHES[k] > before[k]
                   for k in ("ba_plane_blocks", "ba_cost_test")),
               f"path4c: the {name} solve launched no K33 or K34")
        err0 = np.linalg.norm(poses0[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
        err1 = np.linalg.norm(poses1[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
        chi = chis["pt"].cpu().numpy()[slot >= 0]
        med_chi = float(np.median(chi))
        res[name] = {"keyframes": Kt, "err0_mean": float(err0.mean()),
                     "err1_mean": float(err1.mean()),
                     "err0_max": float(err0.max()),
                     "err1_max": float(err1.max()),
                     "median_chi2": med_chi, "wall_s": wall}
        if solver is ba_solve_pcg:
            launched = {k: kernels.LAUNCHES[k] - before[k]
                        for k in pcg_launches()}
            res[name]["pcg_launches_per_solve"] = launched
            _check(launched == pcg_launches(), f"path4c: the {name} solve "
                   f"made {launched} PCG launches, expected "
                   f"{pcg_launches()}")
        _check(bool(np.isfinite(poses1).all() and np.isfinite(chi).all()),
               f"path4c: the {name} solve is not finite: {res[name]}")
        if lim_mean is not None:
            _check(err1.mean() < lim_mean * err0.mean()
                   and err1.max() < lim_max * err0.max() and med_chi < 0.5,
                   f"path4c: {name} orbit did not converge: {res[name]}")
    res["launches"] = dict(kernels.LAUNCHES)
    print("path4c_ba_scale " + json.dumps(res), flush=True)
    _check(res["launches"]["ba_reduced_system"] > 0
           and res["launches"]["ba_schur_complement"]
           == res["launches"]["ba_reduced_system"],
           "path4c: the dense solve launched no K35, or not one K40 per "
           "dense LM step")
    _check_pose_launches("path4c (BA alone)", res["launches"],
                         dict(calls, step_launches=dict.fromkeys(
                             STEP_LAUNCHES, 0),
                             fuse_set_launches=dict.fromkeys(
                                 FUSE_SET_LAUNCHES, 0),
                             mapping_step_launches=dict.fromkeys(
                                 MAPPING_STEP_LAUNCHES, 0)))
    res["problems"] = problems
    return res


# K43-K45's lanes in pcg_parity (four recipes, seeds 42 + b)
PCG_LANES = 4


def ba_recipe(dev, seed: int = 42):
    """tests/test_torch_ba.py::_recipe with the port's geometry: Kt = 4, 96
    points, 6 lines (12 endpoints), 3 planes, perfect observations, a
    perturbed start, keyframe 0 fixed. Returns (poses_gt, ba_solve_pcg's
    positional arguments on dev)."""
    import torch

    from planarslam_tpu_torch.config import PlaneConfig
    from planarslam_tpu_torch.geometry import plane as plane_geo
    from planarslam_tpu_torch.geometry import se3
    from planarslam_tpu_torch.solvers import ba_core

    K, bf = (300.0, 310.0, 160.0, 120.0), 24.0
    rng = np.random.default_rng(seed)
    Kt, P_pts, NL, NP, F = 4, 96, 6, 3, 96

    def exp(xi):
        return se3.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))
                           ).numpy()

    def project(T, x):
        pc = T[:3, :3] @ x + T[:3, 3]
        return np.array([K[0] * pc[0] / pc[2] + K[2],
                         K[1] * pc[1] / pc[2] + K[3]]), pc[2]

    pts_gt = rng.uniform(-2, 2, (P_pts, 3)).astype(np.float32)
    pts_gt[:, 2] = rng.uniform(3, 6, P_pts)
    poses_gt = np.stack([exp(np.r_[rng.normal(0, 0.15, 3) * 0.3,
                                   rng.normal(0, 0.15, 3)])
                         for _ in range(Kt)])
    ln_s = rng.uniform(-2, 2, (NL, 3)).astype(np.float32)
    ln_s[:, 2] = rng.uniform(3, 5, NL)
    d = rng.normal(0, 1, (NL, 3)).astype(np.float32)
    ln_e = ln_s + d / np.linalg.norm(d, axis=1, keepdims=True)
    pl_gt = plane_geo.normalize(torch.from_numpy(
        rng.normal(0, 1, (NP, 4)).astype(np.float32)
        + np.array([0, 0, 0, 5.0], np.float32))).numpy()
    slot = np.full((Kt, F), -1, np.int32)
    uv = np.zeros((Kt, F, 2), np.float32)
    ur = np.full((Kt, F), -1.0, np.float32)
    for k in range(Kt):
        for f, p in enumerate(rng.choice(P_pts, F - 16, replace=False)):
            u, z = project(poses_gt[k], pts_gt[p])
            if z < 0.5:
                continue
            slot[k, f], uv[k, f], ur[k, f] = p, u, u[0] - bf / z
    L2 = 2 * NL
    ln_slot = np.full((Kt, L2), -1, np.int32)
    l2d = np.zeros((Kt, L2, 3), np.float32)
    for k in range(Kt):
        for i in range(NL):
            us, zs = project(poses_gt[k], ln_s[i])
            ue, ze = project(poses_gt[k], ln_e[i])
            if zs < 0.5 or ze < 0.5:
                continue
            eq = np.cross(np.r_[us, 1.0], np.r_[ue, 1.0])
            eq /= np.linalg.norm(eq[:2])
            ln_slot[k, 2 * i:2 * i + 2] = (P_pts + 2 * i, P_pts + 2 * i + 1)
            l2d[k, 2 * i] = l2d[k, 2 * i + 1] = eq
    pl_obs = np.stack([plane_geo.normalize(plane_geo.transform(
        torch.from_numpy(poses_gt[k]), torch.from_numpy(pl_gt))).numpy()
        for k in range(Kt)]).astype(np.float32)
    poses0 = poses_gt.copy()
    for k in range(1, Kt):
        poses0[k] = exp(np.r_[rng.normal(0, 0.004, 3),
                              rng.normal(0, 0.015, 3)]) @ poses0[k]
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

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    ones = np.ones
    pt = ba_core.PointTables(t(slot, np.int32), t(uv), t(ur),
                             t(ones((Kt, F))), t(slot >= 0))
    ln = ba_core.LineTables(t(ln_slot, np.int32), t(l2d),
                            t(ones((Kt, L2))), t(ln_slot >= 0))
    pl = ba_core.PlaneTables(t(np.tile(np.arange(NP, dtype=np.int32),
                                       (Kt, 1)), np.int32), t(pl_obs),
                             t(ones((Kt, NP))))
    empty = ba_core.empty_plane_tables(Kt, dev)
    return poses_gt, (t(poses0), t(fixed), t(lm0), t(pl0), pt, ln, pl, empty,
                      empty, K, bf,
                      ba_core.BAWeights.from_config(PlaneConfig()))


def pcg_step_inputs(args, lam: float = 1e-4) -> dict:
    """K43's inputs at the start of ba_solve_pcg's first LM step on args:
    the plan, K8's sums and cross blocks, K33's plane terms and mu_p (the
    kernels'), lam, free."""
    import torch

    from planarslam_tpu_torch.solvers import ba_core, ba_pcg

    poses, fixed, lm_xyz, base, pt, ln, pl, par, ver, K, bf, w = args
    pb = ba_core._problem(lm_xyz, base, pt, ln, pl, par, ver, w,
                          want_pairs=False)
    plan = ba_pcg.pcg_plan(pb)
    lm = torch.cat([lm_xyz, torch.zeros((pb.Q, 3), device=poses.device)])
    Hcc, bc, Hpp, bp, _, _, _, cross = ba_core.ba_normal_eqs(
        poses, lm[:pb.P], pb.pt, pb.ln, pb.M, K, bf, True, False, pb.plan,
        want_cross=True)
    Hcc, bc, Hpp, bp, _, terms, mu_p = ba_core.ba_plane_blocks(
        pb, poses, base, lm[pb.P:].contiguous(), Hcc, bc, Hpp, bp, None,
        True)
    return {"plan": plan, "cross": cross, "terms": terms, "Hcc": Hcc,
            "bc": bc, "Hpp": Hpp, "bp": bp, "mu_p": mu_p,
            "lam": torch.tensor(lam, device=poses.device),
            "free": (1.0 - fixed).contiguous(), "fixed": fixed}


PREPARE_KEYS = ("plan", "cross", "terms", "Hcc", "bc", "Hpp", "bp", "mu_p",
                "lam", "free")


@contextlib.contextmanager
def plain_pcg():
    """ba_solve_pcg with K43-K45's plain versions in the place of their
    wrappers (on the card too): the plain solve the kernels' is held to."""
    from planarslam_tpu_torch.solvers import ba_pcg

    names = ("pcg_prepare", "pcg_schur_matvec", "pcg_backsub",
             "pcg_cg_update")
    saved = [getattr(ba_pcg, n) for n in names]
    ba_pcg.pcg_prepare = ba_pcg.pcg_prepare_plain
    ba_pcg.pcg_schur_matvec = ba_pcg.pcg_schur_matvec_plain
    ba_pcg.pcg_backsub = ba_pcg.pcg_backsub_plain
    ba_pcg.pcg_cg_update = ba_pcg.pcg_cg_update_plain
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ba_pcg, n, fn)


def _abs_terms_matvec(sys, plan, free, p):
    """Each entry's sum of |terms| for S p (float64): |Hcc_d| |xm| plus
    sum_o |C_o| |Hpp_inv| sum_o' |C_o'|^T |xm|."""
    import torch

    from planarslam_tpu_torch.solvers import ba_pcg

    a = ba_pcg.PcgSystem(*(x.double().abs() for x in sys))
    xm = (p * free[:, None]).double().abs()
    Kt, M = p.shape[0], sys.Hpp_inv.shape[0]
    v = torch.einsum("pij,pj->pi", a.Hpp_inv,
                     ba_pcg._landmark_sum(a, plan, xm, M))
    s = torch.where(plan.live[:, None], torch.einsum(
        "oij,oj->oi", a.C, v[plan.obs_slot.long()]), 0.0)
    return (torch.einsum("kij,kj->ki", a.Hcc_d, xm)
            + ba_pcg.segment_sum(s, plan.obs_kf, Kt))


def _chain_terms(plan, M: int, Kt: int) -> int:
    """The longest chain of terms of one S p entry: 6 of Hcc_d, per
    observation of the keyframe 3 products and a sum, 3 of the inverse and
    per observation of the landmark 6 products and a sum."""
    live = plan.live
    n_kf = int(_bincount(plan.obs_kf[live], Kt).max())
    n_lm = int(_bincount(plan.obs_slot[live], M).max())
    return 6 + 4 * n_kf + 3 + 7 * n_lm


def _bincount(x, n: int):
    """bincount of x (int tensor) with n bins."""
    import torch

    return torch.bincount(x.long(), minlength=n) if x.numel() else \
        torch.zeros(n, dtype=torch.int64)


def _held_bound(name: str, got, want, bound, fixed=None) -> float:
    """Every entry within its bound (float64); fixed rows exactly 0 in
    both; returns the largest error over its bound."""
    err = (got.double() - want.double()).abs()
    _check(bool((err <= bound).all()), f"{name}: {int((err > bound).sum())} "
           f"entries beyond 2 (n - 1) 2^-24 of their sum of |terms|, "
           f"largest error {float(err.max())}")
    if fixed is not None:
        rows = fixed > 0
        _check(bool((got[rows] == 0).all() and (want[rows] == 0).all()),
               f"{name}: a fixed pose's entry is not 0")
    return float((err / bound.clamp(min=1e-300)).max())


def _held_rel(name: str, got, want, rel: float = 1e-5) -> float:
    """max |got - want| within rel of the largest |want|; returns it
    relative."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max()) / scale
    _check(err <= rel, f"{name}: {err} of the largest value, limit {rel}")
    return err


def pcg_kernel_check(name: str, st: dict) -> dict:
    """K43-K45 against their plain versions on one LM step's inputs (st,
    pcg_step_inputs'): two launches equal bits each; K43's Hpp_inv, Hcc_d,
    rhs and C within 1e-5 of each output's largest value, its Minv through
    its float64 inverse within 1e-5 of the largest |Hcc_d| of the plain
    Pm (Pm's terms nearly cancel), rhs exactly 0 at fixed poses; K44's S p
    and back-substitution on the same system each entry within 2 (n - 1)
    2^-24 of its sum of |terms|, S p's fixed rows exactly 0; K45's init
    and one update on the same inputs: pAp within that bound (n = 6 Kt),
    rz of the init too (n = 6 Kt + 6); x, r and p within 1e-6 of max(1,
    |v|), or where larger the rounding of pAp carried through alpha (and
    of rz_new through beta, and of the update's rz likewise), exactly 0 at
    fixed poses. Returns errors and the outputs."""
    import torch

    from planarslam_tpu_torch.solvers import ba_pcg

    args = [st[k] for k in PREPARE_KEYS]
    plan, free, fixed = st["plan"], st["free"], st["fixed"]
    got = ba_pcg.pcg_prepare(*args)
    again = ba_pcg.pcg_prepare(*args)
    want = ba_pcg.pcg_prepare_plain(*args)
    torch.cuda.synchronize()
    _check(same_bits(got, again), f"pcg_prepare ({name}): two launches "
           f"differ")
    live = plan.live
    err = {}
    for f in ("Hpp_inv", "Hcc_d", "rhs"):
        err[f] = _held_rel(f"pcg_prepare ({name}) {f}", getattr(got, f),
                           getattr(want, f))
    err["C"] = _held_rel(f"pcg_prepare ({name}) C", got.C[live], want.C[live])
    Pm_g = torch.linalg.inv(got.Minv.double())
    Pm_w = torch.linalg.inv(want.Minv.double())
    err["Minv_via_Pm"] = float((Pm_g - Pm_w).abs().max()) / float(
        want.Hcc_d.abs().max())
    _check(err["Minv_via_Pm"] <= 1e-5 and bool(torch.isfinite(got.Minv)
                                                .all()),
           f"pcg_prepare ({name}): inv(Minv) {err['Minv_via_Pm']} of the "
           f"largest |Hcc_d| off the plain one's, limit 1e-5")
    _check(bool((got.rhs[fixed > 0] == 0).all()),
           f"pcg_prepare ({name}): rhs of a fixed pose is not 0")
    sys = want
    Kt, M = sys.rhs.shape[0], sys.Hpp_inv.shape[0]
    n = _chain_terms(plan, M, Kt)
    u24 = 2.0 ** -24
    # K45's init on the plain system, then S p of its p
    st0 = ba_pcg.pcg_cg_update(sys.Minv, free, sys.rhs)
    st0b = ba_pcg.pcg_cg_update(sys.Minv, free, sys.rhs)
    st0p = ba_pcg.pcg_cg_update_plain(sys.Minv, free, sys.rhs)
    _check(same_bits(st0, st0b), f"pcg_cg_update ({name}): two init "
           f"launches differ")
    p = st0p.p
    Ap = ba_pcg.pcg_schur_matvec(sys, plan, free, p)
    Ap_b = ba_pcg.pcg_schur_matvec(sys, plan, free, p)
    Ap_p = ba_pcg.pcg_schur_matvec_plain(sys, plan, free, p)
    _check(same_bits((Ap,), (Ap_b,)), f"pcg_schur_matvec ({name}): two "
           f"launches differ")
    terms = _abs_terms_matvec(sys, plan, free, p)
    err["matvec_over_bound"] = _held_bound(
        f"pcg_schur_matvec ({name})", Ap, Ap_p,
        2 * (n - 1) * u24 * terms, fixed)
    dxc = -st0p.p.contiguous()
    bp = st["bp"]
    dxp = ba_pcg.pcg_backsub(sys, plan, bp, dxc)
    dxp_b = ba_pcg.pcg_backsub(sys, plan, bp, dxc)
    dxp_p = ba_pcg.pcg_backsub_plain(sys, plan, bp, dxc)
    _check(same_bits((dxp,), (dxp_b,)), f"pcg_backsub ({name}): two "
           f"launches differ")
    a = ba_pcg.PcgSystem(*(x.double().abs() for x in sys))
    bterms = torch.einsum("pij,pj->pi", a.Hpp_inv, bp.double().abs()
                          + ba_pcg._landmark_sum(a, plan, dxc.double().abs(),
                                                 M))
    n_lm = int(_bincount(plan.obs_slot[live], M).max())
    err["backsub_over_bound"] = _held_bound(
        f"pcg_backsub ({name})", dxp, dxp_p,
        2 * (3 + 1 + 7 * n_lm - 1) * u24 * bterms)
    # K45: init against plain, then one update on identical inputs
    f6 = free[:, None].double()
    Mi = sys.Minv.double().abs()

    def rz_terms(r):
        ra = (r.double() * f6).abs()
        return float((ra * torch.einsum("kij,kj->ki", Mi, ra)).sum())

    err["init_rz_over_bound"] = _held_bound(
        f"pcg_cg_update ({name}) init rz", st0.scal[:1], st0p.scal[:1],
        torch.tensor([2 * (6 * Kt + 6 - 1) * u24 * rz_terms(sys.rhs)],
                     device=p.device, dtype=torch.float64))
    for f in ("x", "r", "p"):
        g, w = getattr(st0, f), getattr(st0p, f)
        _held_bound(f"pcg_cg_update ({name}) init {f}", g, w,
                    1e-6 * w.double().abs().clamp(min=1.0), fixed)
    upd = (st0p.r, st0p.x, st0p.p, Ap_p, st0p.scal)
    st1 = ba_pcg.pcg_cg_update(sys.Minv, free, *upd)
    st1b = ba_pcg.pcg_cg_update(sys.Minv, free, *upd)
    st1p = ba_pcg.pcg_cg_update_plain(sys.Minv, free, *upd)
    _check(same_bits(st1, st1b), f"pcg_cg_update ({name}): two launches "
           f"differ")
    pap_terms = float((st0p.p.double() * Ap_p.double()).abs().sum())
    err["pAp_over_bound"] = _held_bound(
        f"pcg_cg_update ({name}) pAp", st1.scal[1:], st1p.scal[1:],
        torch.tensor([2 * (6 * Kt - 1) * u24 * pap_terms], device=p.device,
                     dtype=torch.float64))
    # the update's alpha = rz / pAp and beta = rz_new / rz carry their
    # sums' rounding into x, r and p: each entry's bound is the larger of
    # 1e-6 max(1, |v|) and that rounding carried through (float64)
    dd = {f: getattr(st0p, f).double() for f in ("x", "r", "p")}
    Ap0 = Ap_p.double()
    pAp_w, rz0 = float(st1p.scal[1]), float(st0p.scal[0])
    alpha = rz0 / pAp_w if pAp_w > 0 else 0.0
    dalpha = abs(alpha) * 2 * (6 * Kt - 1) * u24 * pap_terms / max(
        abs(pAp_w), 1e-300)
    rb = dalpha * Ap0.abs() + 2 * u24 * (dd["r"].abs()
                                         + abs(alpha) * Ap0.abs())
    xb = dalpha * dd["p"].abs() + 2 * u24 * (dd["x"].abs()
                                             + abs(alpha) * dd["p"].abs())
    r1 = st1p.r.double()
    z1 = torch.einsum("kij,kj->ki", sys.Minv.double(), r1 * f6) * f6
    zb = torch.einsum("kij,kj->ki", Mi, (rb + 12 * u24 * r1.abs()) * f6) * f6
    rz_b = (2 * (6 * Kt - 1) * u24 * float((r1.abs() * z1.abs()).sum())
            + float((rb * z1.abs() + r1.abs() * zb).sum()))
    err["rz_over_bound"] = _held_bound(
        f"pcg_cg_update ({name}) rz", st1.scal[:1], st1p.scal[:1],
        torch.tensor([rz_b], device=p.device, dtype=torch.float64))
    rz1 = float(st1p.scal[0])
    beta = rz1 / rz0 if rz0 > 0 else 0.0
    dbeta = abs(beta) * rz_b / max(abs(rz1), 1e-300)
    pb = zb + dbeta * dd["p"].abs() + 2 * u24 * (z1.abs() + abs(beta)
                                                  * dd["p"].abs())
    xrp = 0.0
    for f, b in (("x", xb), ("r", rb), ("p", pb)):
        g, w = getattr(st1, f), getattr(st1p, f)
        xrp = max(xrp, _held_bound(
            f"pcg_cg_update ({name}) {f}", g, w,
            torch.maximum(b, 1e-6 * w.double().abs().clamp(min=1.0)),
            fixed))
    err["xrp_over_bound"] = xrp
    print(f"pcg ({name}): {json.dumps(err)}", flush=True)
    return {"err": err, "sys": got, "p": p, "dxc": dxc, "upd": upd,
            "n_obs": int(live.sum())}


def _pcg_solve_pair(args, n_iters: int):
    """ba_solve_pcg with the kernels and with their plain versions, both on
    the card: (poses, cost) each, cost the sum of the chi2 tables."""
    import torch

    from planarslam_tpu_torch.solvers import ba_pcg

    out = []
    for plain in (False, True):
        with plain_pcg() if plain else contextlib.nullcontext():
            poses, _, _, chis = ba_pcg.ba_solve_pcg(*args, n_iters=n_iters)
        cost = float(sum(float(v.double().sum()) for v in chis.values()))
        out.append((poses, cost))
    torch.cuda.synchronize()
    return out


def pcg_parity(dev, problems: dict) -> list:
    """K43-K45 (pcg_prepare, pcg_schur_matvec, pcg_cg_update) against their
    plain versions on the card (pcg_kernel_check) on the line-and-plane
    recipe and on path 4c's 256- and 512-keyframe orbits at their first LM
    step; at B = 4 (four recipes) lane by lane, each lane bit-equal to its
    B = 1 launch; and ba_solve_pcg through the kernels against the same
    solve through the plain versions on the card: after one LM step poses
    within 1e-4 (the recipe, both orbits), after a full solve (15 LM steps
    on the recipe, 12 on the 256 orbit) the cost within 1%."""
    import torch

    from planarslam_tpu_torch.solvers import ba_pcg

    _, recipe = ba_recipe(dev)
    probs = {"recipe": recipe, "orbit256": problems["pcg"][1],
             "orbit512": problems["pcg512"][1]}
    checks, solves = {}, {}
    for name, args in probs.items():
        checks[name] = pcg_kernel_check(name, pcg_step_inputs(args))
        (pk, _), (pp, _) = _pcg_solve_pair(args, 1)
        d1 = float((pk - pp).abs().max())
        _check(d1 <= 1e-4 and bool(torch.isfinite(pk).all()),
               f"ba_solve_pcg ({name}): poses after one LM step {d1} off "
               f"the plain solve's, limit 1e-4")
        solves[name] = {"one_step_pose_err": d1}
        if name != "orbit512":
            full = 15 if name == "recipe" else PCG_N_ITERS
            (pk, ck), (pp, cp) = _pcg_solve_pair(args, full)
            rel = abs(ck - cp) / max(abs(cp), 1e-30)
            _check(rel <= 0.01, f"ba_solve_pcg ({name}): cost {ck} after "
                   f"{full} LM steps against the plain solve's {cp}")
            solves[name].update(cost=ck, plain_cost=cp, cost_rel=rel,
                                full_pose_err=float((pk - pp).abs().max()))
    print("pcg_solves " + json.dumps(solves), flush=True)
    # four recipes in one launch each, lane by lane
    lanes = [pcg_step_inputs(ba_recipe(dev, 42 + b)[1])
             for b in range(PCG_LANES)]
    singles = [pcg_kernel_check(f"lane {b}", st) for b, st in
               enumerate(lanes)]

    def stack(key):
        xs = [st[key] for st in lanes]
        if key == "terms":
            return [ba_core_terms(list(t)) for t in zip(*xs)]
        if key == "plan":
            return ba_pcg.PcgPlan(*(torch.stack(list(f)) for f in zip(*xs)))
        return torch.stack(xs)

    bargs = [stack(k) for k in PREPARE_KEYS]
    sys_b = ba_pcg.pcg_prepare(*bargs)
    plan_b, free_b = bargs[0], bargs[-1]
    p_b = torch.stack([s["p"] for s in singles])
    sys_p = ba_pcg.PcgSystem(*(torch.stack(list(f)) for f in zip(
        *[s["sys"] for s in singles])))
    Ap_b = ba_pcg.pcg_schur_matvec(sys_p, plan_b, free_b, p_b)
    dxp_b = ba_pcg.pcg_backsub(sys_p, plan_b, stack("bp"), torch.stack(
        [s["dxc"] for s in singles]))
    upd_b = [torch.stack([s["upd"][i] for s in singles]) for i in range(5)]
    cg_b = ba_pcg.pcg_cg_update(sys_p.Minv, free_b, *upd_b)
    for b, (st, s) in enumerate(zip(lanes, singles)):
        one = s["sys"]
        _check(same_bits([x[b] for x in sys_b], one),
               f"pcg_prepare: lane {b} of B = {PCG_LANES} differs from its "
               f"B = 1 launch")
        Ap1 = ba_pcg.pcg_schur_matvec(one, st["plan"], st["free"], s["p"])
        dxp1 = ba_pcg.pcg_backsub(one, st["plan"], st["bp"], s["dxc"])
        cg1 = ba_pcg.pcg_cg_update(one.Minv, st["free"], *s["upd"])
        _check(same_bits((Ap_b[b], dxp_b[b]), (Ap1, dxp1))
               and same_bits([x[b] for x in cg_b], cg1),
               f"pcg_schur_matvec / pcg_cg_update: lane {b} of B = "
               f"{PCG_LANES} differs from its B = 1 launch")
    # timings at path 4c's 256-keyframe step
    st = pcg_step_inputs(probs["orbit256"])
    args = [st[k] for k in PREPARE_KEYS]
    c = checks["orbit256"]
    sys, plan, free, p = c["sys"], st["plan"], st["free"], c["p"]
    Kt, M = sys.rhs.shape[0], sys.Hpp_inv.shape[0]
    n_obs, n_all = c["n_obs"], sys.C.shape[0]
    f4 = 4
    upd = c["upd"]
    out = [
        {"name": "pcg_prepare", "route": "cuda",
         "source": "planarslam_tpu_torch/csrc/ba_pcg.cu",
         "replaces": "planarslam_tpu/solvers/ba_pcg.py:162",
         "max_abs_err": max(v["err"]["Hpp_inv"] for v in checks.values()),
         "errors": {k: v["err"] for k, v in checks.items()},
         "tolerance": "Hpp_inv, Hcc_d, rhs, C within 1e-5 of each output's "
                      "largest value; inv(Minv) within 1e-5 of the largest "
                      "|Hcc_d| of the plain one's; fixed rows of rhs 0; two "
                      "launches and B = 4 lanes equal bits",
         "shapes": {"Kt": Kt, "M": M, "n_obs": n_all, "live": n_obs},
         "library_ms": None,
         # Hcc, bc, Hpp, bp, the cross rows and plan read; Hpp_inv, Hcc_d,
         # Minv, rhs and C written; per observation a 3 x 3 inverse in
         # float64 (~60), its product and the 6 x 6 correction (~400)
         **_bound(f4 * (Kt * 42 * 2 + M * 12 * 2 + n_all * 18 * 2
                        + n_obs * 3 + Kt * 6),
                  460.0 * n_obs + 60.0 * M + 700.0 * Kt),
         "ms": _time_ms(lambda: ba_pcg.pcg_prepare(*args)),
         "plain_ms": _time_ms(lambda: ba_pcg.pcg_prepare_plain(*args))},
        {"name": "pcg_schur_matvec", "route": "cuda",
         "source": "planarslam_tpu_torch/csrc/ba_pcg.cu",
         "replaces": "planarslam_tpu/solvers/ba_pcg.py:208",
         "max_abs_err": max(v["err"]["matvec_over_bound"]
                            for v in checks.values()),
         "tolerance": "each entry of S p and of the back-substitution "
                      "within 2 (n - 1) 2^-24 of its sum of |terms| "
                      "(max_abs_err: the largest error over its bound); "
                      "fixed rows 0; two launches and B = 4 lanes equal "
                      "bits",
         "shapes": {"Kt": Kt, "M": M, "live": n_obs}, "library_ms": None,
         # C (18) and the plan (3 ints) of each live observation read
         # twice, p, Hcc_d, Hpp_inv, the landmark pass's v written and
         # read, Ap written; 2 x 36 flops an observation, 72 a keyframe,
         # 18 a landmark
         **_bound(f4 * (2 * n_obs * 21 + Kt * (6 + 36 + 6) + M * (9 + 6)),
                  72.0 * n_obs + 72.0 * Kt + 18.0 * M),
         "ms": _time_ms(lambda: ba_pcg.pcg_schur_matvec(sys, plan, free, p)),
         "plain_ms": _time_ms(lambda: ba_pcg.pcg_schur_matvec_plain(
             sys, plan, free, p))},
        {"name": "pcg_cg_update", "route": "cuda",
         "source": "planarslam_tpu_torch/csrc/ba_pcg.cu",
         "replaces": "planarslam_tpu/solvers/ba_pcg.py:244",
         "max_abs_err": max(max(v["err"]["pAp_over_bound"],
                                v["err"]["rz_over_bound"])
                            for v in checks.values()),
         "tolerance": "pAp and rz within 2 (n - 1) 2^-24 of their sum of "
                      "|terms| (max_abs_err: the larger error over its "
                      "bound; the update's rz with alpha's rounding "
                      "carried); x, r, p within 1e-6 of max(1, |v|) or "
                      "alpha's and beta's rounding carried where larger, "
                      "fixed entries 0; two launches and B = 4 lanes equal "
                      "bits",
         "shapes": {"Kt": Kt}, "library_ms": None,
         # x, r, p, Ap, Minv read, x, r, p written; 36 + 30 flops a
         # keyframe's z and 4 x 12 its updates and products
         **_bound(f4 * Kt * (4 * 6 + 36 + 3 * 6), 130.0 * Kt),
         "ms": _time_ms(lambda: ba_pcg.pcg_cg_update(sys.Minv, free, *upd)),
         "plain_ms": _time_ms(lambda: ba_pcg.pcg_cg_update_plain(
             sys.Minv, free, *upd))}]
    _print_kernels(out)
    return out


def pcg_problems(dev) -> dict:
    """K43-K45's timing problems (tools/kernel_timing.py) on path 4c's
    256-keyframe orbit at its first LM step, keyed by kernel: K43; K44's
    product (of K45's first p) and back-substitution; K45's init and
    update. {} on a tree without them."""
    from planarslam_tpu_torch.solvers import ba_pcg

    if not hasattr(ba_pcg, "pcg_prepare"):
        return {}
    rng = np.random.default_rng(42)
    _orbit_problem(rng, 96, 1024, 48, dev)  # path 4c's dense orbit first
    _, _, args, _ = _orbit_problem(rng, 256, 1024, 24, dev)
    st = pcg_step_inputs(args)
    pargs = [st[k] for k in PREPARE_KEYS]
    plan, free = st["plan"], st["free"]
    sys = ba_pcg.pcg_prepare(*pargs)
    st0 = ba_pcg.pcg_cg_update(sys.Minv, free, sys.rhs)
    Ap = ba_pcg.pcg_schur_matvec(sys, plan, free, st0.p)
    dxc = -st0.p
    upd = (st0.r, st0.x, st0.p, Ap, st0.scal)
    return {"pcg_prepare": {"orbit256": lambda: ba_pcg.pcg_prepare(*pargs)},
            "pcg_schur_matvec": {
                "orbit256": lambda: ba_pcg.pcg_schur_matvec(sys, plan, free,
                                                            st0.p),
                "backsub": lambda: ba_pcg.pcg_backsub(sys, plan, st["bp"],
                                                      dxc)},
            "pcg_cg_update": {
                "init": lambda: ba_pcg.pcg_cg_update(sys.Minv, free,
                                                     sys.rhs),
                "update": lambda: ba_pcg.pcg_cg_update(sys.Minv, free,
                                                       *upd)}}


def ba_core_terms(ts: list):
    """Lanes' PlaneTerms of one table stacked into a batch."""
    import torch

    from planarslam_tpu_torch.solvers.ba_core import PlaneTerms

    return PlaneTerms(*(torch.stack(list(f)) for f in zip(*ts)))


def _drive(slam, frames, timestamps) -> list:
    """Track the frames; per-frame host ms."""
    times = []
    for i, (g, d) in enumerate(frames):
        t0 = time.perf_counter()
        slam.track_rgbd(g, d, timestamps[i])
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def run_tracking_path(name, seq, frames, cfg, dev, local_mapping: bool,
                      capture=()) -> dict:
    """Path 1 (tracking only) or path 2 (with local mapping) end to end;
    returns its metrics and launch counts, and under "captured" the inputs
    of the calls named in `capture` (as _pose_calls keeps them)."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.evaluation.ate import ate_rmse
    from planarslam_tpu_torch.slam.system import System

    n_frames = len(frames)
    slam = System(config=cfg, enable_local_mapping=local_mapping,
                  enable_loop_closing=False, device=dev)
    fuse = (_count_fuse_searches(slam.local_mapper)
            if slam.local_mapper is not None else None)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    with _pose_calls(capture) as pc:
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
           **_call_counts(pc), "wall_s": wall, "launches": launches}
    if slam.local_mapper is not None:
        res["mapping"] = dict(slam.local_mapper.stats, **fuse)
    print(f"{name} " + json.dumps(res), flush=True)
    _check_pose_launches(name, launches, pc, cfg, n_frames)
    res["captured"] = pc["inputs"]
    res["map"] = m
    _check(ate < ATE_LIMIT_M, f"{name}: ATE {ate:.5f} m >= {ATE_LIMIT_M} m")
    _check(res["lost"] == 0, f"{name}: {res['lost']} lost frames")
    if slam.local_mapper is not None:
        steps = res["mapping"]["mapping_steps"]
        _check(steps >= m.n_kf - 1, f"{name}: {steps} mapping steps for "
               f"{m.n_kf} keyframes")
        _check(fuse["fuse_lines_calls"] > 0 and fuse["k23_in_fuse_lines"] > 0,
               f"{name}: local mapping's line fuse ran without K23: {fuse}")
    return res


def run_reloc_path(seq, cfg, dev) -> dict:
    """Path 3: lose tracking with a mature map and relocalize, first on a
    revisited frame with depth (Horn branch), then on one without (PnP
    branch)."""
    import dataclasses

    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam.system import System

    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=4))
    slam = System(config=cfg, enable_loop_closing=False, device=dev)
    # keyframe culling out of the way: relocalization is the subject
    slam.local_mapper._cull_keyframes = lambda kf: None
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    with _pose_calls() as pc, _ransac_calls() as rc:
        res = _reloc_run(slam, seq, cfg)
    torch.cuda.synchronize()
    res.update(wall_s=time.perf_counter() - t_all, **_call_counts(pc),
               launches=dict(kernels.LAUNCHES))
    res["ransacs"] = _check_ransacs("path3", rc)
    print("path3_reloc " + json.dumps(res), flush=True)
    _check_pose_launches("path3", res["launches"], pc, cfg)
    _check(rc["pnp"] >= 1 and rc["horn"] >= 1,
           f"path3: {rc['horn']} Horn and {rc['pnp']} PnP RANSACs")
    return res


def run_unpathed_entries(seq, cfg, dev) -> dict:
    """Path 6: the public entry points that no path of the System calls,
    as a user calls them, with the launch counts set to 0 just before and
    read just after: horn_ransac_sim3 on a planted similarity (300
    correspondences, scale 0.8, 1 cm noise, 40% outliers; one upload, K6's
    triplet and refit launches with the scale, one pull), and match_lines
    (K47) on the line features of path 1's consecutive quantized frames,
    one call a pair (the features made before the counts are reset; the
    median distance of the matched segments' midpoints is reported, not
    held: segments of one line differ in extent from frame to frame)."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import lines as ln
    from planarslam_tpu_torch.solvers import sim3_solver

    rng = np.random.default_rng(61)
    n = 300
    src = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    Tg = _planted_se3(rng)
    dst = 0.8 * (src @ Tg[:3, :3].T) + Tg[:3, 3] + rng.normal(0, 0.01, (n, 3))
    bad = rng.random(n) < 0.4
    dst[bad] = rng.uniform(-3, 3, (int(bad.sum()), 3))
    dst = dst.astype(np.float32)
    feats = match_feats(seq, cfg, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _pose_calls() as pc, _ransac_calls() as rc:
        T, s, n_inl, inl = sim3_solver.horn_ransac_sim3(src, dst,
                                                        threshold=0.08,
                                                        device=dev)
        sim3_ms = (time.perf_counter() - t0) * 1e3
        pairs = []
        for i in range(MATCH_PAIRS):
            a, b = feats[i], feats[i + 1]
            idx, best = ln.match_lines(a.desc, b.desc, a.valid, b.valid,
                                       a.angle, b.angle)
            idx = idx.cpu().numpy()
            hit = idx >= 0
            m0 = 0.5 * (a.uv_s + a.uv_e).cpu().numpy()
            m1 = 0.5 * (b.uv_s + b.uv_e).cpu().numpy()
            d = np.linalg.norm(m0[hit] - m1[idx[hit]], axis=1)
            pairs.append({"matched": int(hit.sum()),
                          "median_px": float(np.median(d)) if hit.any()
                          else None})
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res = {"sim3": {"scale": s, "n_inliers": n_inl, "ms": sim3_ms,
                    "rotation_err": float(np.abs(T[:3, :3]
                                                 - Tg[:3, :3]).max())},
           "match_lines": pairs, "wall_s": time.perf_counter() - t0,
           "ransacs": _check_ransacs("path6", rc), "launches": launches}
    print("path6_unpathed " + json.dumps(res), flush=True)
    _check(rc["horn"] == 1 and launches["horn_align_batch"] == 2,
           f"path6: {launches['horn_align_batch']} K6 launches in "
           f"{rc['horn']} similarity RANSACs")
    _check(abs(s - 0.8) < 0.01 and n_inl > 0.5 * n
           and res["sim3"]["rotation_err"] < 0.01,
           f"path6: horn_ransac_sim3 gave s = {s}, {n_inl} inliers")
    _check(launches["match_lines"] == MATCH_PAIRS,
           f"path6: {launches['match_lines']} K47 launches in "
           f"{MATCH_PAIRS} match_lines calls")
    _check(all(p["matched"] >= 3 for p in pairs),
           f"path6: consecutive frames' line matches {pairs}")
    _check(pc["plain_calls_on_card"] == 0,
           f"path6: {pc['plain_calls_on_card']} plain calls on the card")
    return res


# Path 7: the monocular two-view initializer (K48-K50), on no path of the
# System. Its planted problems take the JAX test's camera and motion
# (tests/test_misc_components.py::test_mono_initializer): K = (300, 310,
# 160, 120) of a 320x240 image, R = exp([0.02, 0.1, -0.01]), t = (0.4,
# 0.05, 0.1), points from default_rng(42) as its rng fixture draws them.
TWO_VIEW_K = (300.0, 310.0, 160.0, 120.0)
TWO_VIEW_MOTION = ((0.02, 0.1, -0.01), (0.4, 0.05, 0.1))
TWO_VIEW_PLANTED = ("jax_test", "noisy_outliers", "n8", "n9", "planar",
                    "none_valid")
TWO_VIEW_LANES = ("jax_test", "planar", "n9", "none_valid")  # at B = 4
# path 7's room pair: frames 0 and 8 of path 1's arc, 0.234 m and 6.3
# degrees apart: tens of pixels of parallax at the room's 2-4 m, and most
# of the view shared, so matching keeps hundreds of correspondences
ROOM_PAIR = (0, 8)
# a pick's system is held to its plain version's null vector where the
# float64 solves' forward error, 2^-53 sigma_1 / sigma_8, stays below a
# tenth of the 1e-5 tolerance
TWO_VIEW_KAPPA = 1e-6 * 2.0 ** 53
MODEL_TOLERANCE = 1e-5


def planted_two_view(case: str) -> dict:
    """A planted two-view problem: uv1, uv2 (N, 2) float32, valid (N,), the
    camera K, the true R, t and the planted inlier mask. "jax_test" is the
    JAX test's problem (N = 120, no noise); "noisy_outliers" N = 1000, 0.5
    px noise and 10% outliers (default_rng(43)); "n8" and "n9" the minimal
    sizes; "planar" its 120 points on one plane, 0.5 px noise, where H
    should win; "none_valid" the JAX test's problem with every valid flag
    False."""
    n = {"noisy_outliers": 1000, "n8": 8, "n9": 9}.get(case, 120)
    rng = np.random.default_rng(42)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(3, 8, n)
    if case == "planar":
        pts[:, 2] = 5.0 + 0.3 * pts[:, 0] - 0.2 * pts[:, 1]
    T = _rotvec_pose(*TWO_VIEW_MOTION)
    R, t = T[:3, :3], T[:3, 3]
    fx, fy, cx, cy = TWO_VIEW_K

    def proj(p):
        return np.stack([fx * p[:, 0] / p[:, 2] + cx,
                         fy * p[:, 1] / p[:, 2] + cy], -1)

    uv1 = proj(pts).astype(np.float32)
    uv2 = proj(pts @ R.T + t).astype(np.float32)
    inlier = np.ones(n, bool)
    noise = np.random.default_rng(43)
    if case in ("noisy_outliers", "planar"):
        uv1 = (uv1 + noise.normal(0, 0.5, uv1.shape)).astype(np.float32)
        uv2 = (uv2 + noise.normal(0, 0.5, uv2.shape)).astype(np.float32)
    if case == "noisy_outliers":
        inlier = noise.random(n) >= 0.1
        uv2[~inlier] = noise.uniform(0, (2 * cx, 2 * cy),
                                     (int((~inlier).sum()), 2))
    return {"uv1": uv1, "uv2": uv2, "valid": np.full(n, case != "none_valid"),
            "K": TWO_VIEW_K, "R": R, "t": t, "inlier": inlier}


def room_two_view(seq, cfg, dev) -> dict:
    """ROOM_PAIR's correspondences at full width: each frame quantized, its
    features from the port's extract_frame, the matches from
    match_descriptors (K3, K25; mutual, ratio 0.9, distance 50), the
    matched level-0 pixels; R, t the true pose of the second view in the
    first."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import matching
    from planarslam_tpu_torch.slam.frame import extract_frame

    cam, factor = cfg.camera, cfg.camera.depth_map_factor
    pts = []
    for i in ROOM_PAIR:
        g8, d16 = quantize_frame(*seq.render(i), factor)
        pts.append(extract_frame(
            torch.from_numpy(g8.astype(np.float32)).to(dev),
            torch.from_numpy(d16.astype(np.float32)
                             / np.float32(factor)).to(dev), cfg).points)
    a, b = pts
    idx = matching.match_descriptors(a.desc, b.desc, a.valid,
                                     b.valid).idx.cpu().numpy()
    hit = idx >= 0
    T = np.linalg.inv(seq.poses_wc[ROOM_PAIR[1]]) @ seq.poses_wc[ROOM_PAIR[0]]
    return {"uv1": a.uv.cpu().numpy()[hit],
            "uv2": b.uv.cpu().numpy()[idx[hit]],
            "valid": np.ones(int(hit.sum()), bool),
            "K": (cam.fx, cam.fy, cam.cx, cam.cy),
            "R": T[:3, :3].astype(np.float32),
            "t": T[:3, 3].astype(np.float32), "inlier": None}


def _pose_errors(res, p) -> dict:
    """The result's rotation (max |entry| and degrees) and translation
    direction errors against the true R, t."""
    R, t = res.T_21[:3, :3], res.T_21[:3, 3]
    t_true = p["t"] / np.linalg.norm(p["t"])
    cos = np.clip((np.trace(R.T @ p["R"]) - 1) / 2, -1.0, 1.0)
    return {"R_err": float(np.abs(R - p["R"]).max()),
            "R_err_deg": float(np.degrees(np.arccos(cos))),
            "t_err": float(abs(abs(t @ t_true) - 1.0)),
            "t_err_deg": float(np.degrees(np.arccos(np.clip(
                abs(t @ t_true) / max(np.linalg.norm(t), 1e-12), -1, 1))))}


def run_two_view_path(seq, cfg, dev) -> dict:
    """Path 7: initialize_two_view as a user calls it, on TWO_VIEW_PLANTED
    and on ROOM_PAIR's matches (made before the counts are reset), with the
    launch counts set to 0 just before and read just after: per call one
    upload, K48 and K49, one pull, and where it gets past the inlier count
    one upload, one K50 launch over the four candidates and one pull; no
    plain initializer or triangulation function on a card tensor. The JAX
    test's problem must succeed with R within 0.02, |t . t_true| within
    0.05 of 1 and more than 100 inliers, the noisy one with outliers with R
    within 0.02 and more than 100 inliers (its translation error and the
    planted outliers among its inliers reported: the JAX package misses
    those limits there), the planar one choose H (RH > 0.40), the one
    without a valid flag fail; the minimal ones and the room are reported,
    not held."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.solvers import initializer

    problems = {c: planted_two_view(c) for c in TWO_VIEW_PLANTED}
    problems["room"] = room_two_view(seq, cfg, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, results = {}, {}
    with _pose_calls() as pc, _ransac_calls() as rc:
        for name, p in problems.items():
            t1 = time.perf_counter()
            r = initializer.initialize_two_view(p["uv1"], p["uv2"],
                                                p["valid"], p["K"],
                                                device=dev)
            ms = (time.perf_counter() - t1) * 1e3
            results[name] = r
            out[name] = {"n": len(p["uv1"]), "success": r.success,
                         "used_homography": r.used_homography,
                         "rh": r.score_h / max(r.score_h + r.score_f, 1e-9),
                         "inliers": int(r.inliers.sum()), "ms": ms,
                         **_pose_errors(r, p)}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res = {"problems": out, "wall_s": time.perf_counter() - t0,
           "ransacs": _check_ransacs("path7", rc), "launches": launches}
    out["noisy_outliers"]["outliers_kept"] = int(
        (results["noisy_outliers"].inliers
         & ~problems["noisy_outliers"]["inlier"]).sum())
    print("path7_two_view " + json.dumps(res), flush=True)
    calls = len(problems)
    _check(launches["two_view_hypotheses"] == launches["two_view_select"]
           == rc["two_view"] == calls,
           f"path7: {launches['two_view_hypotheses']} K48 and "
           f"{launches['two_view_select']} K49 launches in {calls} calls")
    _check(launches["triangulate_dlt"] == rc["two_view_tri"]
           == sum(int(r.inliers.sum() >= 8) for r in results.values()),
           f"path7: {launches['triangulate_dlt']} K50 launches")
    _check(pc["plain_calls_on_card"] == 0,
           f"path7: {pc['plain_calls_on_card']} plain calls on the card")
    o = out["jax_test"]
    _check(o["success"] and o["R_err"] < 0.02 and o["t_err"] < 0.05
           and o["inliers"] > 100, f"path7: jax_test gave {o}")
    # the JAX package misses t_err < 0.05 on noisy_outliers (0.1324) and
    # keeps 3 planted outliers among its inliers (the winning F of 8 raw
    # pixels is not the true F): both reported, the rest held
    o = out["noisy_outliers"]
    _check(o["success"] and o["R_err"] < 0.02 and o["inliers"] > 100,
           f"path7: noisy_outliers gave {o}")
    _check(out["planar"]["used_homography"] and out["planar"]["rh"] > 0.40,
           f"path7: the planar scene gave RH = {out['planar']['rh']}")
    _check(not out["none_valid"]["success"]
           and out["none_valid"]["inliers"] == 0,
           f"path7: no valid flag gave {out['none_valid']}")
    res["captured"] = {"problems": problems, "results": results}
    return res


def _system_kappa(A) -> np.ndarray:
    """sigma_1 / sigma_8 of each 8 x 9 system (float64): its null vector's
    condition."""
    s = np.linalg.svd(A, compute_uv=False)
    with np.errstate(divide="ignore"):
        return s[:, 0] / s[:, 7]


def two_view_systems(p: dict, picks) -> tuple:
    """The float64 eight-point and four-point systems of each pick (H, 8,
    9), as K48 builds them."""
    u1, v1 = (p["uv1"][picks, k].astype(np.float64) for k in (0, 1))
    u2, v2 = (p["uv2"][picks, k].astype(np.float64) for k in (0, 1))
    A = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                  np.ones_like(u1)], -1)
    u, v, x, y = u1[:, :4], v1[:, :4], u2[:, :4], v2[:, :4]
    o, z = np.ones_like(u), np.zeros_like(u)
    r1 = np.stack([-u, -v, -o, z, z, z, x * u, x * v, x], -1)
    r2 = np.stack([z, z, z, -u, -v, -o, y * u, y * v, y], -1)
    return A, np.stack([r1, r2], -2).reshape(len(picks), 8, 9)


# K48's float64 operations per hypothesis (both systems' 48 products, the
# null vectors of the 8 x 9 eight-point and four-point systems, F's rank-2
# step: the 3 x 3 SVD with U and U diag(s1, s2, 0) Vt (33), and H's
# adjugate inverse (44)), and its float32 operations per correspondence
# and hypothesis (F's two line distances, 23 each, H's two transfer
# distances, 20 each, and the gates and score terms, 6 a model; the
# homogeneous 1 saves a product in each model-point product)
TWO_VIEW_MODEL_OPS = (48 + 2 * null_vector_ops(8, 9) + svd_ops(3, 3, True)
                      + 33 + 44)
TWO_VIEW_SCORE_OPS = 2 * 23 + 2 * 20 + 2 * 6


def score_ceiling(n: int) -> float:
    """The largest score of N correspondences, 2 N float32(5.991), with
    the rounding of a float32 sum of its 2 N terms."""
    return 2 * n * float(np.float32(5.991)) * (1 + sum_rtol(2 * n))


def _two_view_inputs(p: dict, dev, pad: int = 0) -> list:
    """initialize_two_view's upload of one problem at B = 1 (uv1, uv2,
    valid, sigma2, picks), its rows padded to `pad` with valid False."""
    import torch

    from planarslam_tpu_torch.solvers import initializer

    n = len(p["uv1"])
    m = max(n, pad)
    uv1, uv2 = (np.zeros((m, 2), np.float32) for _ in range(2))
    valid = np.zeros(m, bool)
    uv1[:n], uv2[:n], valid[:n] = p["uv1"], p["uv2"], p["valid"]
    arrays = [uv1, uv2, valid, np.ones((1,), np.float32),
              initializer.two_view_picks(n)]
    return [torch.from_numpy(a[None]).to(dev) for a in arrays]


def _up_to_sign(got, want):
    """max over entries of the smaller of |got - want| and |got + want|,
    over max |want|, per model (H, 3, 3)."""
    import torch

    d = torch.minimum((got - want).abs().amax((-2, -1)),
                      (got + want).abs().amax((-2, -1)))
    return d / want.abs().amax((-2, -1)).clamp(min=1e-30)


def two_view_model_parity(name: str, p: dict, ins: list) -> dict:
    """K48 against its plain version on one problem: two launches equal
    bits; F and H up to sign within MODEL_TOLERANCE of max |entry| of the
    plain version's where the pick's points are distinct and its system's
    sigma_1 / sigma_8 below TWO_VIEW_KAPPA; every kernel score within 2 (n -
    1) 2^-24 of the sum of its terms of the plain scoring of the kernel's
    own model (-1 exactly where that model is not finite); the other picks
    (a repeated point, or near-degenerate: 8 points of one plane) held to
    a score in [-1, 2 N 5.991]."""
    import torch

    from planarslam_tpu_torch.solvers import initializer

    sk, shk, Fk, Hk = _twice(initializer.two_view_hypotheses, *ins)
    one = [a[0] for a in ins]
    sp, shp, Fp, Hp = initializer.two_view_hypotheses_plain(*one)
    torch.cuda.synchronize()
    picks = one[4].cpu().numpy()
    n = one[0].shape[0]
    A, AH = two_view_systems(p, picks)
    held = {}
    for tag, sysA, width, s_k, M_k, s_p, M_p, score in (
            ("F", A, 8, sk[0], Fk[0], sp, Fp, initializer._score_F),
            ("H", AH, 4, shk[0], Hk[0], shp, Hp, initializer._score_H)):
        distinct = np.array([len(set(r[:width])) == width for r in picks])
        posed = distinct & (_system_kappa(sysA) < TWO_VIEW_KAPPA)
        rows = torch.from_numpy(posed).to(M_k.device)
        err = float(_up_to_sign(M_k, M_p)[rows].max()) if posed.any() \
            else 0.0
        _check(err <= MODEL_TOLERANCE, f"two_view_hypotheses: {name} {tag} "
               f"{err} from the plain version on well-posed picks")
        x1h = initializer._homogeneous(one[0])
        x2h = initializer._homogeneous(one[1])
        own = initializer._finite_or(score(M_k, x1h, x2h, one[3],
                                           one[2])[0], M_k)
        gap = float(((s_k - own).abs() - sum_rtol(n) * own.clamp(min=0))
                    .max())
        _check(gap <= 0.0 and bool(((own == -1) == (s_k == -1)).all()),
               f"two_view_hypotheses: {name} {tag} scores beyond the "
               f"summation bound of the plain scoring by {gap}")
        _check(bool(((s_k >= -1) & (s_k <= score_ceiling(n))).all()),
               f"two_view_hypotheses: {name} {tag} a score outside "
               f"[-1, 2 N 5.991]")
        diff = (s_k - s_p).abs()[rows]
        held[tag] = {"model_err": err, "well_posed": int(posed.sum()),
                     "repeated": int((~distinct).sum()),
                     "near_degenerate": int((distinct & ~posed).sum()),
                     "score_diff_well_posed": float(diff.max())
                     if posed.any() else 0.0}
    return {"outputs": (sk, shk, Fk, Hk), "held": held}


def two_view_select_parity(name: str, ins: list, hyp) -> list:
    """K49 bit-equal to its plain version on K48's outputs, into outputs
    filled with NaN, two launches equal bits."""
    import torch

    from planarslam_tpu_torch.solvers import initializer

    with poisoned_outputs(initializer, "_empty"):
        got = _twice(initializer.two_view_select, *ins[:4], *hyp)[0]
    want = initializer.two_view_select_plain(*[a[0] for a in ins[:4]],
                                             *[h[0] for h in hyp])
    torch.cuda.synchronize()
    _check(same_bits([got[0]], [want]),
           f"two_view_select: {name} differs from the plain version")
    return got


def two_view_dlt_parity(name: str, p: dict, row, dev) -> dict:
    """K50 on the four candidates of the kernel's best F (the problem's
    inliers of the model initialize_two_view selects, all its rows where
    fewer than 8): X within 1e-5 of max(1, |X|) of the plain version, ok
    exact, two launches equal bits, each lane equal to its own B = 1
    launch; the gates mode (the first view at the identity, the second at
    each candidate, inverse sigma^2 1 and a per-point table) bit-equal to
    its plain version on the kernel's X; X and ok pulled in one copy
    (kernels.pull) equal to their own copies."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.solvers import initializer, triangulation

    n = len(p["uv1"])
    F, _, sf, sh, inl_f, inl_h = initializer.unpack_two_view(row, n)
    inl = inl_h if sh / max(sh + sf, 1e-9) > 0.40 else inl_f
    sel = np.flatnonzero(inl) if inl.sum() >= 8 else np.arange(n)
    fx, fy, cx, cy = p["K"]
    Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    T21s, P1, P2s = initializer.two_view_candidates(F, Kmat)
    m = len(sel)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    args = [t(np.broadcast_to(P1, (4, 3, 4))), t(P2s),
            t(np.broadcast_to(p["uv1"][sel], (4, m, 2))),
            t(np.broadcast_to(p["uv2"][sel], (4, m, 2)))]
    with poisoned_outputs(triangulation, "_empty"):
        Xk, okk = _twice(triangulation.triangulate, *args)
    Xp, okp = triangulation.triangulate_plain(*args)
    torch.cuda.synchronize()
    _check(torch.equal(okk, okp), f"triangulate_dlt: {name} ok differs")
    both = okk & okp
    err = float(((Xk - Xp).abs().amax(-1) / Xp.abs().amax(-1).clamp(
        min=1.0))[both].max()) if bool(both.any()) else 0.0
    _check(err <= 1e-5, f"triangulate_dlt: {name} X {err} from the plain "
           f"version")
    for b in range(4):
        X1, ok1 = triangulation.triangulate(*[a[b] for a in args])
        _check(same_bits([X1, ok1], [Xk[b], okk[b]]),
               f"triangulate_dlt: {name} lane {b} differs from its launch")
    Xh, okh = kernels.pull(Xk, okk)
    _check(np.array_equal(Xh, Xk.cpu().numpy(), equal_nan=True)
           and np.array_equal(okh, okk.cpu().numpy()),
           f"triangulate_dlt: {name} one pull of X and ok differs from "
           f"their own copies")
    eye = t(np.broadcast_to(np.eye(4), (4, 4, 4)))
    table = t(np.broadcast_to(1.2 ** -(2 * (np.arange(m) % 8)), (4, m)))
    gates = (Xk, eye, t(T21s), args[2], args[3], p["K"])
    flips = 0
    for s1, s2 in ((1.0, 1.0), (table, 1.0)):
        with poisoned_outputs(triangulation, "_empty"):
            gk = _twice(triangulation.reprojection_checks, *gates, s1, s2)[0]
        gp = triangulation.reprojection_checks_plain(*gates, s1, s2)
        flips += int((gk != gp).sum())
    _check(flips == 0, f"reprojection_checks: {name} {flips} masks differ "
           f"from the plain version")
    return {"args": args, "gates": gates, "X_err": err,
            "good": int(okk.sum())}


def two_view_lanes(dev, captured) -> tuple:
    """K48 and K49 on TWO_VIEW_LANES at B = 4 (their rows padded to the
    longest with valid False) in one launch each, every lane bit-equal to
    its own B = 1 launch on the same rows; returns the B = 4 inputs and
    K48's outputs."""
    import torch

    from planarslam_tpu_torch.solvers import initializer

    probs = captured["problems"]
    pad = max(len(probs[c]["uv1"]) for c in TWO_VIEW_LANES)
    lanes = [_two_view_inputs(probs[c], dev, pad) for c in TWO_VIEW_LANES]
    ins = [torch.cat(f) for f in zip(*lanes)]
    hyp = initializer.two_view_hypotheses(*ins)
    rows = initializer.two_view_select(*ins[:4], *hyp)
    for b, one in enumerate(lanes):
        h1 = initializer.two_view_hypotheses(*one)
        r1 = initializer.two_view_select(*one[:4], *h1)
        _check(same_bits([x[b] for x in hyp] + [rows[b]],
                         [x[0] for x in h1] + [r1[0]]),
               f"two_view: lane {b} ({TWO_VIEW_LANES[b]}) of B = 4 differs "
               f"from its own launch")
    return ins, hyp


def two_view_parity(dev, captured: dict) -> list:
    """Path 7's kernel phase: K48, K49 and K50 against their plain versions
    on every problem of path 7 (TWO_VIEW_PLANTED and the room pair) and at
    B = 4 lane by lane; their device ms (torch.profiler) at N = 120 and
    1000 and at B = 4 on a line of their own; their kernels rows on the
    room pair, path 7's full-width problem."""
    import torch

    from planarslam_tpu_torch.solvers import initializer, triangulation

    held, dlt = {}, {}
    for name, p in captured["problems"].items():
        ins = _two_view_inputs(p, dev)
        mp = two_view_model_parity(name, p, ins)
        row = two_view_select_parity(name, ins, mp["outputs"])
        held[name] = mp["held"]
        dlt[name] = two_view_dlt_parity(name, p, row[0].cpu().numpy(), dev)
        held[name]["X_err"] = dlt[name]["X_err"]
        if name == "room":
            room = (p, ins, mp["outputs"])
    lane_ins, lane_hyp = two_view_lanes(dev, captured)
    print("two_view_parity " + json.dumps(held), flush=True)

    def hyp_fn(ins):
        return lambda: initializer.two_view_hypotheses(*ins)

    def sel_fn(ins, hyp):
        return lambda: initializer.two_view_select(*ins[:4], *hyp)

    def dlt_fn(args):
        return lambda: triangulation.triangulate(*args)

    split = {}
    for name in ("jax_test", "noisy_outliers"):
        p = captured["problems"][name]
        ins = _two_view_inputs(p, dev)
        hyp = initializer.two_view_hypotheses(*ins)
        split[name] = {"n": len(p["uv1"]),
                       "K48": _launch_split(hyp_fn(ins), match="two_view"),
                       "K49": _launch_split(sel_fn(ins, hyp),
                                            match="two_view"),
                       "K50": _launch_split(dlt_fn(dlt[name]["args"]),
                                            match="triangulate_dlt")}
    split["B4"] = {"K48": _launch_split(hyp_fn(lane_ins), match="two_view"),
                   "K49": _launch_split(sel_fn(lane_ins, lane_hyp),
                                        match="two_view")}
    print("two_view_device_ms " + json.dumps(split), flush=True)

    p, ins, hyp = room
    n, h = len(p["uv1"]), ins[4].shape[1]
    hm = held["room"]
    out = [{"name": "two_view_hypotheses", "route": "cuda",
            "library_ms": None,
            # per hypothesis both models in float64, per correspondence
            # and hypothesis both models' scores in float32
            **_bound(_nbytes(ins, hyp), TWO_VIEW_SCORE_OPS * n * h,
                     n_ops_fp64=TWO_VIEW_MODEL_OPS * h),
            "source": "planarslam_tpu_torch/csrc/two_view.cu",
            "replaces": "planarslam_tpu/solvers/initializer.py:116",
            "max_abs_err": max(hm["F"]["model_err"], hm["H"]["model_err"]),
            "tolerance": "F, H up to sign 1e-5 of max |entry| on well-posed "
                         "distinct picks; scores within 2 (n - 1) 2^-24 of "
                         "the plain scoring of the kernel's models; other "
                         "picks a score in [-1, 2 N 5.991]",
            "n": n, "held": hm,
            "device_ms": split,
            "ms": _time_ms(hyp_fn(ins)),
            "plain_ms": _time_ms(lambda: initializer.two_view_hypotheses_plain(
                *[a[0] for a in ins]))},
           {"name": "two_view_select", "route": "cuda", "library_ms": None,
            # the two arg-maxes, then per correspondence both masks in
            # float32; of the models only the two winners read
            **_bound(_nbytes(ins[:4], hyp[:2]) + 4 * 18
                     + 4 * (20 + 2 * n), 8.0 * h + TWO_VIEW_SCORE_OPS * n),
            "source": "planarslam_tpu_torch/csrc/two_view.cu",
            "replaces": "planarslam_tpu/solvers/initializer.py:128",
            "max_abs_err": 0.0, "tolerance": "bit-equal",
            "ms": _time_ms(sel_fn(ins, hyp)),
            "plain_ms": _time_ms(lambda: initializer.two_view_select_plain(
                *[a[0] for a in ins[:4]], *[x[0] for x in hyp]))}]
    args = dlt["room"]["args"]
    pairs = args[2].shape[0] * args[2].shape[1]
    Xk, okk = triangulation.triangulate(*args)
    out.append({"name": "triangulate_dlt", "route": "cuda",
                "library_ms": None,
                # per pair the 4 x 4 DLT's null vector (float64)
                **_bound(_nbytes(args, Xk, okk), 0.0,
                         n_ops_fp64=DLT_PAIR_OPS * pairs),
                "source": "planarslam_tpu_torch/csrc/triangulate.cu",
                "replaces": "planarslam_tpu/solvers/triangulation.py:16",
                "max_abs_err": max(d["X_err"] for d in dlt.values()),
                "tolerance": "X 1e-5 of max(1, |X|), ok exact; the gates "
                             "mode bit-equal",
                "pairs": pairs,
                "gates_ms": _time_ms(lambda: triangulation.reprojection_checks(
                    *dlt["room"]["gates"], 1.0, 1.0)),
                "ms": _time_ms(dlt_fn(args)),
                "plain_ms": _time_ms(
                    lambda: triangulation.triangulate_plain(*args))})
    _print_kernels(out)
    return out


def _reloc_run(slam, seq, cfg) -> dict:
    """Path 3's frames: track to a mature map, lose tracking, relocalize
    by Horn with depth, lose again, relocalize without depth (PnP)."""
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.tracking import TrackingState

    dmf = cfg.camera.depth_map_factor
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
    return {"frames_tracked": tracked, "keyframes": n_kf,
            "horn": {"ok": ok, "position_error_m": err, "ms": ms},
            "pnp": {"ok": ok2, "position_error_m": err2, "ms": ms2,
                    "pnp_launches": kernels.LAUNCHES["pnp_dlt_hypotheses"]
                    - n_pnp0},
            "relocalizations": int(slam.tracker.stats.get(
                "relocalizations", 0))}


H2D_WARMUP_FRAMES = 20
H2D_FRAMES = 32  # long enough to hold a keyframe and the refresh after it
# idle host time before each frame's span: a device copy that no host op
# issued counts in the span that starts at most half of it after the copy
H2D_GAP_S = 0.02


def _h2d_by_span(kineto_events, events, prefix: str, where: str) -> dict:
    """The "Memcpy HtoD" device events of one profile, each given to the
    span (a host event named prefix + frame) in which the host op that
    issued it started. kineto_events are the profile's raw events
    (prof.profiler.kineto_results.events()), events its FunctionEvents
    (prof.events()), which give the ops' parents. A copy's op is the host
    event whose correlation id the copy is linked to, as torch links a
    device event to its op, and the op's start and the spans' lie on one
    clock, so the count does not rest on the profiler's mapping of device
    times onto the host clock, which can be off by milliseconds within one
    profile (a copy then seems to start before the op that issued it:
    "device_minus_issue_us"). A copy that no host op issued counts in the
    span that starts at most half of H2D_GAP_S after it. Returns the
    frames of the spans in order, the copies per frame, per frame the host
    ops (outermost three) that issued them, the number of copies with no
    host op, and the range of each copy's device start minus its op's
    start, in us."""
    ops, copies = {}, []
    for e in kineto_events:
        if "CUDA" in str(e.device_type()):
            if "Memcpy HtoD" in e.name():
                copies.append(e)
        elif e.linked_correlation_id() == 0:
            ops.setdefault(e.correlation_id(), e)
    starts = sorted((e.start_ns(), int(e.name().rsplit("_", 1)[1]))
                    for e in ops.values() if e.name().startswith(prefix))
    parents = {(e.id, e.name): e for e in events
               if "CUDA" not in str(e.device_type)}
    half_gap_ns = int(H2D_GAP_S * 1e9) // 2

    def frame_of(t):
        k = [i for t0, i in starts if t0 <= t]
        return k[-1] if k else None

    per, asked, lag = {}, {}, []
    unlinked = 0
    for e in copies:
        op = ops.get(e.linked_correlation_id())
        if op is None:
            unlinked += 1
            i = frame_of(e.start_ns() + half_gap_ns)
            key = "(no host op)"
        else:
            i = frame_of(op.start_ns())
            lag.append((e.start_ns() - op.start_ns()) / 1e3)
            chain = [op.name()]
            fe = parents.get((op.correlation_id(), op.name()))
            p = fe.cpu_parent if fe is not None else None
            while p is not None and not p.name.startswith(prefix):
                chain.append(p.name)
                p = p.cpu_parent
            key = " < ".join(chain[-3:][::-1])
        _check(i is not None, f"{where}: a copy precedes the first span")
        per[i] = per.get(i, 0) + 1
        by = asked.setdefault(i, {})
        by[key] = by.get(key, 0) + 1
    return {"frames": [i for _, i in starts], "copies": per,
            "asked_by": asked, "unlinked": unlinked,
            "device_minus_issue_us": [float(min(lag)), float(max(lag))]
            if lag else None}


def run_h2d_copies(seq, frames, cfg, dev) -> dict:
    """Host-to-device copies of tracked frames of path 1. After
    H2D_WARMUP_FRAMES frames of a tracking-only System, one more frame and
    then H2D_FRAMES frames run under one torch.profiler session, each in a
    record_function span that ends with a device synchronization, after
    H2D_GAP_S of idle host, and each "Memcpy HtoD" device event counts in
    the span of the host op that issued it (_h2d_by_span; the first frame
    under the profiler only absorbs its start and is not counted). The
    allowed
    copies of a tracked frame, each named: the packed sensor frame (gray and
    depth in one pinned upload) and, in a frame that follows a change of the
    map, the packed local-map window, and in a frame that makes a
    keyframe its packed fuse set (one pinned upload, run_fuse_set). No
    constant is among them: level tables travel as launch arguments, and
    every table or number a stage needs is cached on the card at its first
    use. Every frame is held to 1 + its refreshes + its fuse sets; a
    keyframe's frame is also reported with the host ops that asked for its
    copies; one frame must refresh the window and one make a fuse set."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from planarslam_tpu_torch.slam import device_mapper as dm
    from planarslam_tpu_torch.slam.system import System

    slam = System(config=cfg, enable_local_mapping=False,
                  enable_loop_closing=False, device=dev)
    for i in range(H2D_WARMUP_FRAMES):
        slam.track_rgbd(*frames[i], seq.timestamps[i])
    tr = slam.tracker
    seen = {"refresh": 0, "keyframe": 0, "fuse_set": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if name != "keyframe" or out is not False:
                seen[name] += 1
            return out
        return wrapped

    tr._refresh_window = counting("refresh", tr._refresh_window)
    tr._begin_keyframe = counting("keyframe", tr._begin_keyframe)
    tr._apply_pending_kf = counting("keyframe", tr._apply_pending_kf)
    real_fuse_set = dm.run_fuse_set
    dm.run_fuse_set = counting("fuse_set", real_fuse_set)
    first = H2D_WARMUP_FRAMES
    per_frame = []
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(first, first + 1 + H2D_FRAMES):
                seen.update(refresh=0, keyframe=0, fuse_set=0)
                time.sleep(H2D_GAP_S)
                with record_function(f"h2d_frame_{i}"):
                    slam.track_rgbd(*frames[i], seq.timestamps[i])
                    torch.cuda.synchronize()
                per_frame.append({"frame": i, "h2d_copies": 0,
                                  "window_refreshes": seen["refresh"],
                                  "keyframe_events": seen["keyframe"],
                                  "fuse_sets": seen["fuse_set"]})
    finally:
        dm.run_fuse_set = real_fuse_set
    slam.shutdown()
    got = _h2d_by_span(prof.profiler.kineto_results.events(),
                       prof.events(), "h2d_frame_", "h2d")
    _check(got["frames"] == [r["frame"] for r in per_frame],
           f"h2d: the profiler kept {len(got['frames'])} of "
           f"{len(per_frame)} frame spans")
    for rec in per_frame:
        rec["h2d_copies"] = got["copies"].get(rec["frame"], 0)
        if rec["frame"] in got["asked_by"]:
            rec["asked_by"] = got["asked_by"][rec["frame"]]
    n_events = sum(got["copies"].values())
    per_frame = per_frame[1:]  # the frame that absorbed the profiler's start
    for rec in per_frame:
        limit = 1 + rec["window_refreshes"] + rec["fuse_sets"]
        if rec["h2d_copies"] == limit and rec["fuse_sets"] == 0:
            rec.pop("asked_by", None)
        _check(rec["h2d_copies"] <= limit,
               f"h2d: frame {rec['frame']} made {rec['h2d_copies']} "
               f"host-to-device copies, allowed {limit}: the packed frame, "
               f"{rec['window_refreshes']} window refreshes and "
               f"{rec['fuse_sets']} packed fuse sets ({rec})")
        _check(rec["h2d_copies"] >= 1, f"h2d: the profiler saw no copy in "
               f"frame {rec['frame']} ({n_events} in all)")
    refreshes = sum(r["window_refreshes"] for r in per_frame)
    keyframes = [r for r in per_frame if r["keyframe_events"]]
    res = {"frames": H2D_FRAMES, "frames_held": len(per_frame),
           "keyframe_frames": len(keyframes),
           "fuse_sets": sum(r["fuse_sets"] for r in per_frame),
           "window_refreshes": refreshes,
           "limit_per_frame": "1 packed frame + 1 per window refresh + 1 "
                              "per packed fuse set",
           "copies_per_frame": float(np.mean(
               [r["h2d_copies"] for r in per_frame])),
           "copies_per_keyframe_frame": float(np.mean(
               [r["h2d_copies"] for r in keyframes])) if keyframes else None,
           "copies_without_host_op": got["unlinked"],
           "device_minus_issue_us": got["device_minus_issue_us"],
           "per_frame": per_frame}
    print("h2d_copies " + json.dumps(res), flush=True)
    _check(refreshes >= 1, f"h2d: no window refresh in {H2D_FRAMES} frames: "
           f"the window's allowance was not exercised")
    _check(res["fuse_sets"] >= 1, f"h2d: no keyframe's fuse set in "
           f"{H2D_FRAMES} frames: its allowance was not exercised")
    return res


# ---------------------------------------------------------------------------
# K36 (the step's prelude), the batch of K3, K4, K11-K15, and path 5

BATCH_SIZES = (4, 8)   # path 5's lanes (bench.py::_run_batched)
BATCH_FRAMES = 48      # frames per lane (bench.py::_run_batched), the
BATCH_SEQUENCE = 96    # first of a sequence of this many: at bench.py's
                       # pace (48-frame sequences) lanes 0 and 1 lose
                       # tracking and reset in both packages
BATCH_WARMUP = 8       # batched steps left out of the step times
BATCH_PARITY = 4       # lanes of the batched kernel phases
H2D_BATCH_STEPS = 24   # batched steps under the profiler (B = 4)
# the step prelude's inputs in path 1's 48th tracking step
PRELUDE_CAPTURE = (("device_tracker", "step_prelude", 48),)


def _planted_prelude(dev, B: int, L: int, Nn: int, seed: int = 36) -> tuple:
    """K36's inputs for B seeded lanes at the main path's widths: the
    override on and off, a zero-length, a short and a NaN line."""
    import torch

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def poses(n):
        return np.stack([_planted_se3(rng) for _ in range(n)]).astype(
            np.float32)

    p3d_s = rng.normal(size=(B, L, 3)).astype(np.float32)
    p3d_e = (p3d_s + rng.normal(scale=0.3, size=(B, L, 3))).astype(
        np.float32)
    p3d_e[:, 0] = p3d_s[:, 0]
    p3d_e[:, 1] = p3d_s[:, 1] + 0.05
    p3d_e[0, 2, 0] = np.nan
    normals = rng.normal(size=(B, Nn, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return (t(poses(B)), t(np.arange(B) % 2 == 0), t(poses(B)), t(poses(B)),
            t(p3d_s), t(p3d_e), t(rng.random((B, L)) > 0.2),
            t(rng.random((B, L)) > 0.2), t(normals.astype(np.float32)),
            t(rng.random((B, Nn)) > 0.3), t(poses(B)[:, :3, :3].copy()))


def prelude_kernel_parity(cfg, dev, captured: dict) -> list:
    """K36 against its plain version, every output bit-equal, two
    launches equal bits: on the inputs of path 1's 48th tracking step and
    on four planted lanes at the main path's widths."""
    from planarslam_tpu_torch.slam import device_tracker as dt

    key = PRELUDE_CAPTURE[0]
    _check(key in captured, "prelude: path 1's step prelude was not "
           "captured")
    cases = {"path1_step48": captured[key][0],
             "planted": _planted_prelude(dev, BATCH_PARITY,
                                         cfg.lines.max_lines,
                                         cfg.manhattan.max_normals)}
    for name, args in cases.items():
        got = _twice(dt.step_prelude, *args)
        _tail_held(f"step_prelude ({name})", got, dt.step_prelude_plain(*args))
    args = cases["path1_step48"]
    out = dt.step_prelude(*args)
    n = out.dirs_valid.shape[1]
    entry = {"name": "step_prelude", "route": "cuda", "library_ms": None,
             # T_last, the velocity select, 64 products for T_pred, 45 for
             # R_init, per line ~15 (difference, norm, divisions, gates)
             **_bound(_nbytes(args, out),
                      out.T_pred.shape[0] * (200 + 15 * args[4].shape[1])),
             "source": "planarslam_tpu_torch/csrc/step_prelude.cu",
             "replaces": "planarslam_tpu/slam/device_tracker.py:274",
             "max_abs_err": 0.0, "tolerance": "bit-equal",
             "shapes": {"lanes": int(out.T_pred.shape[0]), "N": int(n)},
             "ms": _time_ms(lambda: dt.step_prelude(*args)),
             "plain_ms": _time_ms(lambda: dt.step_prelude_plain(*args))}
    _print_kernels([entry])
    return [entry]


def _same_lanes(name: str, batched, singles: list) -> None:
    """Lane b of a batched launch's outputs bit-equal to the B = 1 launch
    of that lane (None fields skipped)."""
    for b, one in enumerate(singles):
        for f, x, y in zip(range(len(one)), batched, one):
            if y is None:
                continue
            _check(_bit_diff(x[b], y[0], as_int=True) == 0,
                   f"{name}: lane {b} field {f} differs from its B = 1 "
                   f"launch")


def _batch_entry(report: list, name: str, ms_b1: float, ms_b: float,
                 lanes: int, extra: dict) -> None:
    """Add the batched timings to a kernel's report entry: its time at B =
    1 and at B = lanes on this phase's inputs, and the bound at B = lanes
    (lanes times the single problem's bytes and operations)."""
    entry = next(k for k in report if k["name"] == name)
    entry[f"batch{lanes}"] = {
        "ms_b1": ms_b1, "ms": ms_b,
        **_bound(lanes * entry["bytes"], lanes * entry["operations"]),
        "lanes_bit_equal_to_b1": True, **extra}


def batched_kernel_parity(seq, cfg, dev, report: list) -> None:
    """K1, K3, K4, K11, K12-K18, K23 and K28 on BATCH_PARITY lanes in one
    launch each (K16 on the lanes' frames, K1 and K17 on the lanes'
    pyramids, K17 also
    on their frames at 5 taps and on planted levels, K18 on the lanes'
    scores and on PLANTED_SELECT, K23 on the window seen from
    LINE_LANE_VIEWS): every lane bit-equal to its own B = 1 launch, and
    held to its plain version as the single problem is; one launch per
    call whatever B; times at B = 1 and B = BATCH_PARITY beside the bound."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import fast, image
    from planarslam_tpu_torch.ops import lines as ln
    from planarslam_tpu_torch.ops import manhattan, matching, planes
    from planarslam_tpu_torch.ops.frontend import EDGE_BORDER, orb_level_table
    from planarslam_tpu_torch.slam import device_tracker as dt
    from planarslam_tpu_torch.slam.frame import extract_frame
    from planarslam_tpu_torch.solvers import pose_opt

    B = BATCH_PARITY
    factor = cfg.camera.depth_map_factor
    W, H = cfg.camera.width, cfg.camera.height
    frames = []
    for b in range(B):
        s = seq if b == 0 else _lane_sequence(cfg, b)
        g8, d16 = quantize_frame(*s.render(1), factor)
        d = d16.astype(np.float32) / np.float32(factor)
        frames.append((g8.astype(np.float32),
                       noisy_depth(d, factor, seed=b) if b % 2 else d))
    gray = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    depth = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)

    def launches(name, fn, *a, **kw):
        n0 = kernels.LAUNCHES[name]
        out = fn(*a, **kw)
        _check(kernels.LAUNCHES[name] == n0 + 1, f"{name}: "
               f"{kernels.LAUNCHES[name] - n0} launches for {B} lanes")
        return out

    def timed(fn_b, fn_1):
        return _time_ms(fn_1), _time_ms(fn_b)

    # K3 at the window search's shapes (4096 x 1024 per lane)
    rng = np.random.default_rng(3)
    M, N = 4096, cfg.orb.max_keypoints

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    a = rng.integers(-2 ** 31, 2 ** 31, (B, M, 8)).astype(np.int32)
    src = rng.integers(0, M, (B, N))
    flips = (rng.random((B, N, 8)) < 0.2) * rng.integers(0, 2 ** 31,
                                                         (B, N, 8))
    bd = (np.take_along_axis(a, src[..., None], 1) ^ flips).astype(np.int32)
    a_uv = rng.uniform(0, [W, H], (B, M, 2))
    lvl = rng.integers(0, cfg.orb.n_levels, (B, M))
    b_uv = np.take_along_axis(a_uv, src[..., None], 1) + rng.normal(
        0, 2.0, (B, N, 2))
    gate = matching.ProjGate(
        a_uv=t(a_uv, np.float32), a_r=t(4.0 * 1.2 ** lvl, np.float32),
        a_level=t(lvl, np.int32), a_ur_pred=t(a_uv[..., 0] - 20.0,
                                              np.float32),
        b_uv=t(b_uv, np.float32),
        b_level=t(np.take_along_axis(lvl, src, 1), np.int32),
        b_ur=t(np.full((B, N), -1.0), np.float32), level_window=1)
    k3a = (t(a), t(bd), t(rng.random((B, M)) < 0.9),
           t(rng.random((B, N)) < 0.95))
    got = launches("gated_hamming_top2", matching.gated_hamming_top2, *k3a,
                   gate)

    def k3_lane(b):
        return ([x[b:b + 1] for x in k3a],
                matching.ProjGate(*[x[b:b + 1] for x in gate[:-1]], 1))

    singles = [matching.gated_hamming_top2(*x, g)
               for x, g in map(k3_lane, range(B))]
    _same_lanes("gated_hamming_top2", got, singles)
    for b in range(B):
        x, g = k3_lane(b)
        want = matching.gated_hamming_top2_plain(
            *[y[0] for y in x], matching.ProjGate(*[y[0] for y in g[:-1]], 1))
        _check(all(torch.equal(u[b], v) for u, v in zip(got, want)),
               f"gated_hamming_top2: lane {b} differs from plain")
    x1, g1 = k3_lane(0)
    _batch_entry(report, "gated_hamming_top2", *timed(
        lambda: matching.gated_hamming_top2(*k3a, gate),
        lambda: matching.gated_hamming_top2(*x1, g1)), B, {})

    # K28 on the lanes' depths (odd lanes with Kinect noise)
    pc = cfg.planes
    mx = pc.max_distance
    alpha = launches("noise_alpha", planes._noise_alpha, depth, mx)
    for b in range(B):
        one = planes._noise_alpha(depth[b:b + 1], mx)
        plain = planes.noise_alpha_plain(depth[b], mx)[None]
        _check(_bit_diff(alpha[b:b + 1], one, as_int=True) == 0,
               f"noise_alpha: lane {b} differs from its B = 1 launch")
        _check(_bit_diff(one, plain, as_int=True) == 0,
               f"noise_alpha: lane {b} differs from plain")
    _batch_entry(report, "noise_alpha", *timed(
        lambda: planes._noise_alpha(depth, mx),
        lambda: planes._noise_alpha(depth[:1], mx)), B, {})

    # K4 on the lanes' depths
    kw4 = dict(cam=cfg.camera, geo_tol=planes._geo_tol(W),
               max_distance=pc.max_distance, block=pc.block)
    got = launches("plane_block_moments", planes.plane_block_moments, depth,
                   alpha, **kw4)
    singles = [planes.plane_block_moments(depth[b:b + 1], alpha[b:b + 1],
                                          **kw4) for b in range(B)]
    _same_lanes("plane_block_moments", got, singles)
    err = 0.0
    for b in range(B):
        want = planes.plane_block_moments_plain(depth[b], alpha[b], **kw4)
        _check(torch.equal(got.n[b], want.n), f"plane_block_moments: lane "
               f"{b} counts differ from plain")
        scale = max(float(w.abs().max()) for w in want)
        e = max(float((g[b] - w).abs().max()) for g, w in zip(got, want))
        _check(e <= 1e-5 * scale, f"plane_block_moments: lane {b} error {e}")
        err = max(err, e / scale)
    _batch_entry(report, "plane_block_moments", *timed(
        lambda: planes.plane_block_moments(depth, alpha, **kw4),
        lambda: planes.plane_block_moments(depth[:1], alpha[:1], **kw4)),
        B, {"max_rel_err_plain": err})

    # K12-K14 through extract_planes: one launch of K12 and K14 and 1 +
    # refine_rounds of K13 for all lanes
    n0 = dict(kernels.LAUNCHES)
    got = planes.extract_planes(depth, cfg.camera, pc)
    for name, n in (("plane_components", 1),
                    ("plane_assign_refit", 1 + pc.refine_rounds),
                    ("plane_label_pixels", 1)):
        _check(kernels.LAUNCHES[name] == n0[name] + n,
               f"extract_planes: {kernels.LAUNCHES[name] - n0[name]} {name} "
               f"launches for {B} lanes")
    singles = [planes.extract_planes(depth[b:b + 1], cfg.camera, pc)
               for b in range(B)]
    _same_lanes("extract_planes", got, singles)
    stats = planes.plane_block_moments(depth, alpha, **kw4)
    hb, wb = H // pc.block, W // pc.block
    cand = planes.plane_components(stats, hb, wb, pc)
    _same_lanes("plane_components", cand, [
        planes.plane_components(planes._BlockStats(*[x[b:b + 1]
                                                     for x in stats]),
                                hb, wb, pc) for b in range(B)])
    fit = planes.plane_assign_refit(depth, alpha, cfg.camera, pc,
                                    cand.normal, cand.d, cand.valid)
    _batch_entry(report, "plane_components", *timed(
        lambda: planes.plane_components(stats, hb, wb, pc),
        lambda: planes.plane_components(
            planes._BlockStats(*[x[:1] for x in stats]), hb, wb, pc)), B, {})
    _batch_entry(report, "plane_assign_refit", *timed(
        lambda: planes.plane_assign_refit(depth, alpha, cfg.camera, pc,
                                          cand.normal, cand.d, cand.valid),
        lambda: planes.plane_assign_refit(depth[:1], alpha[:1], cfg.camera,
                                          pc, cand.normal[:1], cand.d[:1],
                                          cand.valid[:1])), B, {})
    _batch_entry(report, "plane_label_pixels", *timed(
        lambda: planes.plane_label_pixels(depth, alpha, cfg.camera, pc, fit),
        lambda: planes.plane_label_pixels(
            depth[:1], alpha[:1], cfg.camera, pc,
            planes.PlaneRefit(*[x[:1] for x in fit]))), B, {})

    # K15 with the initial-pose epilogue on the lanes' normals and lines
    feats = extract_frame(gray, depth, cfg)
    pre = dt.step_prelude(*_planted_prelude(dev, B, cfg.lines.max_lines,
                                            cfg.manhattan.max_normals)[:4],
                          feats.lines.p3d_s, feats.lines.p3d_e,
                          feats.lines.has_3d, feats.lines.valid,
                          feats.normals, feats.normals_valid,
                          torch.eye(3, device=dev).expand(B, 3, 3)
                          .contiguous())
    mc = cfg.manhattan
    kw15 = dict(cone_sin=mc.cone_sin_track, kernel=mc.mean_shift_kernel,
                min_support=mc.min_axis_support)
    R0 = torch.eye(3, device=dev).expand(B, 3, 3).contiguous()
    init = manhattan.InitSelect(pre.T_pred, pre.R_init,
                                torch.arange(B, device=dev) % 2 == 0)
    got = launches("manhattan_mean_shift", manhattan.track_manhattan_frame,
                   R0, pre.dirs, pre.dirs_valid, init=init, **kw15)
    singles = [manhattan.track_manhattan_frame(
        R0[b:b + 1], pre.dirs[b:b + 1], pre.dirs_valid[b:b + 1],
        init=manhattan.InitSelect(*[x[b:b + 1] for x in init]), **kw15)
        for b in range(B)]
    _same_lanes("manhattan_mean_shift", got, singles)
    err = 0.0
    for b in range(B):
        want = manhattan.track_manhattan_frame_plain(
            R0[b], pre.dirs[b], pre.dirs_valid[b], **kw15)
        e = float((got.R_cm[b] - want.R_cm).abs().max())
        _check(e <= 1e-5 and torch.equal(got.success[b], want.success)
               and torch.equal(got.axis_support[b], want.axis_support),
               f"manhattan_mean_shift: lane {b} differs from plain ({e})")
        err = max(err, e)
        T_i, use_i = manhattan.init_select_plain(
            got.R_cm[b], got.success[b],
            manhattan.InitSelect(*[x[b] for x in init]))
        _check(_bit_diff(got.T_init[b], T_i, as_int=True) == 0
               and torch.equal(got.use_manh[b], use_i),
               f"manhattan_mean_shift: lane {b}'s epilogue differs from "
               f"init_select_plain")
    _batch_entry(report, "manhattan_mean_shift", *timed(
        lambda: manhattan.track_manhattan_frame(R0, pre.dirs, pre.dirs_valid,
                                                init=init, **kw15),
        lambda: manhattan.track_manhattan_frame(
            R0[:1], pre.dirs[:1], pre.dirs_valid[:1],
            init=manhattan.InitSelect(*[x[:1] for x in init]), **kw15)),
        B, {"max_abs_err_plain": err, "epilogue_bit_equal": True})

    # K11 on B seeded problems at the main path's width, the rotation flag
    # per lane
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    probs = [_pose_problem(K, cam.bf, seed=b, n=cfg.orb.max_keypoints,
                           n_lines=cfg.lines.max_lines, n_planes=16)
             for b in range(B)]

    def st(*xs):
        return torch.from_numpy(np.ascontiguousarray(np.stack(xs))).to(dev)

    names = POSE_BLOCKS
    classes = (pose_opt.PointObs, pose_opt.LineObs, pose_opt.PlaneObs,
               pose_opt.PlaneObs, pose_opt.PlaneObs)
    T0 = st(*[p[0] for p in probs])
    kw11 = {n: cls(*[st(*[p[k + 1][f] for p in probs])
                     for f in range(len(probs[0][k + 1]))])
            for k, (n, cls) in enumerate(zip(names, classes))}
    kw11["weights"] = pose_opt.PoseOptWeights.from_config(cfg.planes)
    kw11["rotation_fixed"] = torch.arange(B, device=dev) % 2 == 1
    got = launches("pose_optimize", pose_opt.pose_optimize, T0, K, cam.bf,
                   **kw11)

    def lane(b):
        return {k: (v[b:b + 1] if isinstance(v, torch.Tensor)
                    else type(v)(*[x[b:b + 1] for x in v])
                    if k != "weights" else v) for k, v in kw11.items()}

    singles = [pose_opt.pose_optimize(T0[b:b + 1], K, cam.bf, **lane(b))
               for b in range(B)]
    _same_lanes("pose_optimize", got, singles)
    err = max(_pose_compare(*_lane0(((T0[b:b + 1], K, cam.bf), lane(b))),
                            False)["pose_err"] for b in range(B))
    _batch_entry(report, "pose_optimize", *timed(
        lambda: pose_opt.pose_optimize(T0, K, cam.bf, **kw11),
        lambda: pose_opt.pose_optimize(T0[:1], K, cam.bf, **lane(0))), B,
        {"max_abs_err_plain": err})
    # K16 on the lanes' frames in one launch, each lane bit-equal to its B
    # = 1 launch and within PYRAMID_TOLERANCE of the plain pyramid
    oc = cfg.orb
    table = orb_level_table(H, W, oc)
    buf = launches("pyramid_resize", image.build_pyramid_levels, gray, table,
                   oc.scale_factor)
    _same_lanes("pyramid_resize", (buf,), [
        (image.build_pyramid_levels(gray[b:b + 1].contiguous(), table,
                                    oc.scale_factor),) for b in range(B)])
    err16 = _max_err(buf, image.build_pyramid_levels_plain(
        gray, table, oc.scale_factor))
    _check(err16 <= PYRAMID_TOLERANCE,
           f"pyramid_resize: the lanes are {err16} from the plain pyramid")
    g1 = gray[:1].contiguous()
    _batch_entry(report, "pyramid_resize", *timed(
        lambda: image.build_pyramid_levels(gray, table, oc.scale_factor),
        lambda: image.build_pyramid_levels(g1, table, oc.scale_factor)), B,
        {"max_abs_err_plain": err16})
    # K1 on the lanes' 8-level pyramids, exact against its plain version
    got = launches("fast_score", fast.fast_score_levels, buf, table)
    _same_lanes("fast_score", (got,), [
        (fast.fast_score_levels(buf[b:b + 1].contiguous(), table),)
        for b in range(B)])
    _check(torch.equal(got, fast.fast_score_levels_plain(buf, table)),
           "fast_score: the lanes differ from the plain version")
    one = buf[:1].contiguous()
    _batch_entry(report, "fast_score", *timed(
        lambda: fast.fast_score_levels(buf, table),
        lambda: fast.fast_score_levels(one, table)), B,
        {"max_abs_err_plain": 0.0})
    scores = got

    # K17: 7 taps on the lanes' pyramids, 5 taps on their frames (the line
    # stage) and 7 taps on planted levels of B lanes, exact
    p_table, p_buf = planted_blur_levels(batch=B)
    p_buf = torch.from_numpy(p_buf).to(dev)
    for what, x, t17, ksize, sigma in (("pyramid", buf, table, 7, 2.0),
                                       ("frame", gray, None, 5, 1.0),
                                       ("planted", p_buf, p_table, 7, 2.0)):
        if t17 is None:  # (B, H, W) frames: gaussian_blur and blur
            fn = lambda y: image.gaussian_blur(y, ksize, sigma)  # noqa: E731
            want = torch.stack([image.blur(g, ksize, sigma) for g in x])
        else:
            fn = lambda y: image.gaussian_blur_levels(  # noqa: E731
                y, t17, ksize, sigma)
            want = image.gaussian_blur_levels_plain(x, t17, ksize, sigma)
        got = launches("gaussian_blur", fn, x)
        _same_lanes(f"gaussian_blur ({what})", (got,), [
            (fn(x[b:b + 1].contiguous()),) for b in range(B)])
        _check(torch.equal(got, want),
               f"gaussian_blur ({what}): the lanes differ from plain")
    _batch_entry(report, "gaussian_blur", *timed(
        lambda: image.gaussian_blur_levels(buf, table, 7, 2.0),
        lambda: image.gaussian_blur_levels(one, table, 7, 2.0)), B,
        {"max_abs_err_plain": 0.0, "frame_5tap": dict(zip(
            ("ms_b1", "ms"), timed(
                lambda: image.gaussian_blur(gray, 5, 1.0),
                lambda: image.gaussian_blur(gray[:1], 5, 1.0))))})

    # K18 on the lanes' scores and on PLANTED_SELECT's levels for B lanes,
    # exact in every slot, with the launches its C entry reports
    ps = PLANTED_SELECT
    s_table, s_scores = planted_select_levels(batch=B)
    s_scores = torch.from_numpy(s_scores).to(dev)
    min_score = float(oc.min_th_fast)
    for what, t18, x, ms, border in (
            ("frames", table, scores, min_score, EDGE_BORDER),
            ("planted", s_table, s_scores, ps["min_score"], ps["border"])):
        n0 = kernels.LAUNCHES["select_keypoints"]
        got = fast.select_keypoints_levels(x, t18, ms, border)
        _check(kernels.LAUNCHES["select_keypoints"]
               == n0 + fast.select_launches(t18),
               f"select_keypoints ({what}): "
               f"{kernels.LAUNCHES['select_keypoints'] - n0} launches for "
               f"{B} lanes, the C entry's count {fast.select_launches(t18)}")
        _same_lanes(f"select_keypoints ({what})", got, [
            fast.select_keypoints_levels(x[b:b + 1].contiguous(), t18, ms,
                                         border) for b in range(B)])
        want = fast.select_keypoints_levels_plain(x, t18, ms, border)
        _check(all(torch.equal(a, c) for a, c in zip(got, want)),
               f"select_keypoints ({what}): the lanes differ from plain")
    s_one = scores[:1].contiguous()
    _batch_entry(report, "select_keypoints", *timed(
        lambda: fast.select_keypoints_levels(scores, table, min_score,
                                             EDGE_BORDER),
        lambda: fast.select_keypoints_levels(s_one, table, min_score,
                                             EDGE_BORDER)), B,
        {"max_abs_err_plain": 0.0})

    # K23 on the window seen from LINE_LANE_VIEWS, one lane each
    cam = cfg.camera
    kw23 = dict(K=(cam.fx, cam.fy, cam.cx, cam.cy),
                image_wh=(float(W), float(H)), radius=14.0)
    lanes = line_search_lanes(line_search_feats(seq, cfg, dev), seq, dev)
    got = launches("search_lines_by_projection",
                   ln.search_lines_by_projection_batched, *lanes, **kw23)
    _same_lanes("search_lines_by_projection", got, [
        ln.search_lines_by_projection_batched(
            *[x[b:b + 1] for x in lanes], **kw23) for b in range(B)])
    err = 0.0
    for b in range(B):
        idx_p, sim_p = ln.search_lines_by_projection_plain(
            *[x[b] for x in lanes], **kw23)
        _check(torch.equal(got[0][b], idx_p),
               f"search_lines_by_projection: lane {b}'s indices differ "
               f"from plain")
        err = max(err, _finite_err(got[1][b], sim_p))
    _check(err <= SIM_TOLERANCE, f"search_lines_by_projection: the lanes' "
           f"similarities differ from plain by {err}")
    lane0 = [x[:1] for x in lanes]
    _batch_entry(report, "search_lines_by_projection", *timed(
        lambda: ln.search_lines_by_projection_batched(*lanes, **kw23),
        lambda: ln.search_lines_by_projection_batched(*lane0, **kw23)), B,
        {"max_abs_err_plain": err,
         "matches": [int((got[0][b] >= 0).sum()) for b in range(B)]})
    print("batched_kernel_parity " + json.dumps(
        {k["name"]: k[f"batch{B}"] for k in report if f"batch{B}" in k}),
        flush=True)


def _lane_sequence(cfg, b: int, n: int = BATCH_SEQUENCE):
    """Path 5's sequence of lane b (bench.py::_run_batched's seed, at the
    pace of a BATCH_SEQUENCE-frame sequence)."""
    from planarslam_tpu_torch.io import synthetic

    return synthetic.make_sequence(n, width=cfg.camera.width,
                                   height=cfg.camera.height, seed=11 + b)


def _render_lane(args) -> list:
    """The first n quantized frames of lane b's sequence (a worker
    process's task)."""
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io.frames import quantize_frame

    b, n = args
    cfg = SystemConfig()
    s = _lane_sequence(cfg, b)
    return [quantize_frame(*s.render(i), cfg.camera.depth_map_factor)
            for i in range(n)]


def _lane_frames(B: int, n: int) -> list:
    """Lanes 0..B-1's first n quantized frames (SystemConfig's camera),
    rendered in parallel, one worker process per lane (spawned, so no CUDA
    state is shared; all ended on return)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=B,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_render_lane, [(b, n) for b in range(B)]))


def batched_step_lane_equality(captured, cfg) -> dict:
    """Lane b of one batched step (path 5's, B = 4) bit-equal to the B = 1
    step on that lane's inputs: the bundle as int32 bits and every leaf of
    the new carried state."""
    from planarslam_tpu_torch.slam import device_tracker as dt

    args, kw = captured
    frames, T_ovr, use, R_wm, manh, state, win, weights = args[:8]
    B = frames.shape[0]
    res = dt.fused_track_step_packed(*args[:8], cfg)
    leaves = dt.state_leaves(state)
    for b in range(B):
        one = dt.fused_track_step_packed(
            frames[b:b + 1], T_ovr[b:b + 1], use[b:b + 1], R_wm[b:b + 1],
            manh[b:b + 1], dt.state_of_leaves([x[b:b + 1] for x in leaves]),
            win[b:b + 1], weights, cfg)
        _check(_bit_diff(res.packed[b], one.packed[0], as_int=True) == 0,
               f"lane equality: lane {b}'s bundle differs from its B = 1 "
               f"step")
        for i, (x, y) in enumerate(zip(dt.state_leaves(res.new_state),
                                       dt.state_leaves(one.new_state))):
            _check(_bit_diff(x[b], y[0], as_int=True) == 0,
                   f"lane equality: lane {b}'s state leaf {i} differs")
    out = {"lanes": B, "bundle_words": int(res.packed.shape[1]),
           "state_leaves": len(leaves), "bit_equal": True}
    print("batched_lane_equality " + json.dumps(out), flush=True)
    return out


def run_batched_path(cfg, dev, lane_frames: list, B: int,
                     capture: int = 0) -> dict:
    """Path 5: BatchedSLAM(cfg, B) over the first B lanes' frames of
    lane_frames (_lane_frames: bench.py::_run_batched's seeds, quantized
    frames): every lane's ATE <
    ATE_LIMIT_M and 0 lost; fused lane frames at least B x (n_frames - the
    frames before a lane's first fused step); per batched step, every step
    kernel launched as often as in one streaming step, and the extraction
    kernels as per extract_frame call; no plain function on a card
    tensor. Reports the median and p95 ms of a batched step and the frames
    per second over all lanes. With `capture`, the inputs of that batched
    step (from 1) are kept under "captured"."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.evaluation.ate import ate_rmse
    from planarslam_tpu_torch.parallel.replay import BatchedSLAM

    name = f"path5_batched_B{B}"
    seqs = [_lane_sequence(cfg, b) for b in range(B)]
    frames = lane_frames[:B]
    n_frames = len(frames[0])
    bs = BatchedSLAM(cfg, B, device=dev)
    first_fused = [None] * B
    torch.cuda.synchronize()
    kernels.reset_launches()
    cap = (("device_tracker", "fused_track_step_packed", capture),) \
        if capture else ()
    times = []
    t_all = time.perf_counter()
    with _pose_calls(cap) as pc:
        for i in range(n_frames):
            t0 = time.perf_counter()
            bs.track([frames[b][i][0] for b in range(B)],
                     [frames[b][i][1] for b in range(B)],
                     np.full(B, float(i) / 30.0))
            times.append(time.perf_counter() - t0)
            for b in range(B):
                if first_fused[b] is None and bs._lane_live[b]:
                    first_fused[b] = i
        bs.flush()
        for s in bs.systems:
            s.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = dict(kernels.LAUNCHES)
    ates, lost, shapes = [], [], []
    for b, s in enumerate(bs.systems):
        poses = s.frame_poses_wc()
        shapes.append(poses.shape)
        ok = poses.shape == (n_frames, 4, 4) and np.isfinite(poses).all()
        ates.append(float(ate_rmse(poses[:, :3, 3],
                                   seqs[b].poses_wc[:n_frames, :3, 3]))
                    if ok else None)
        lost.append(int(s.tracker.stats["lost"]))
    steps = bs.stats["batched_steps"]
    t = np.asarray(times[BATCH_WARMUP:])
    res = {"B": B, "frames": n_frames, "ate_rmse_m": ates, "lost": lost,
           "first_fused_frame": first_fused, "batched_steps": steps,
           **{k: v for k, v in bs.stats.items() if k != "batched_steps"},
           "median_step_ms": float(np.median(t)) * 1e3,
           "p95_step_ms": float(np.percentile(t, 95)) * 1e3,
           "fps_all_lanes": B * len(t) / float(t.sum()),
           "keyframes": [int(s.map.n_kf) for s in bs.systems],
           **_call_counts(pc), "wall_s": wall, "launches": launches}
    print(f"{name} " + json.dumps(res), flush=True)
    for b in range(B):
        _check(ates[b] is not None, f"{name}: lane {b} trajectory "
               f"{shapes[b]}, not ({n_frames}, 4, 4) and finite (a reset "
               f"drops the frames before it)")
    _check(steps == pc["track_core_calls"] and steps >= n_frames - 2,
           f"{name}: {steps} batched steps, {pc['track_core_calls']} "
           f"tracking steps")
    _check_pose_launches(name, launches, pc, cfg)
    for b in range(B):
        _check(ates[b] < ATE_LIMIT_M, f"{name}: lane {b} ATE {ates[b]:.5f} "
               f"m >= {ATE_LIMIT_M} m")
        _check(lost[b] == 0, f"{name}: lane {b} lost {lost[b]} frames")
    want = sum(n_frames - f for f in first_fused if f is not None)
    _check(None not in first_fused and bs.stats["fused_lane_frames"] >= want,
           f"{name}: {bs.stats['fused_lane_frames']} fused lane frames, "
           f"expected >= {want}")
    if capture:
        key = cap[0]
        _check(key in pc["inputs"], f"{name}: step {capture} not captured")
        res["captured"] = pc["inputs"][key]
    return res


def run_batched_vo_step(cfg, dev, B: int = 8) -> dict:
    """make_batched_frame_step once at B lanes and full width: frame 1 of
    path 5's sequences against frame 0's features (run_batched_replay's
    carry); finite poses, and each lane within 0.05 m and 0.05 rad of its
    ground-truth motion with > 50 point inliers."""
    import torch

    from planarslam_tpu_torch.parallel.replay import make_batched_frame_step
    from planarslam_tpu_torch.slam import device_tracker as dt
    from planarslam_tpu_torch.slam.frame import (extract_frame,
                                                 unproject_points)

    seqs = [_lane_sequence(cfg, b) for b in range(B)]
    step, put = make_batched_frame_step(cfg, device=dev)
    r0 = [s.render(0) for s in seqs]
    r1 = [s.render(1) for s in seqs]

    def stack(rs, j):
        return put(np.stack([np.asarray(r[j], np.float32) for r in rs]))

    f0 = dt.feats_to_numpy(extract_frame(stack(r0, 0), stack(r0, 1),
                                         cfg)).points
    k = cfg.orb.max_keypoints
    pts_w = np.zeros((B, k, 3), np.float32)
    for b in range(B):
        T_wc0 = seqs[b].poses_wc[0].astype(np.float32)
        pts_w[b] = unproject_points(type(f0)(*[a[b] for a in f0]), cfg,
                                    T_wc0)
    T_init = np.stack([np.linalg.inv(s.poses_wc[0]) for s in seqs]).astype(
        np.float32)
    n0 = time.perf_counter()
    T, R, n_in = step(stack(r1, 0), stack(r1, 1), put(T_init),
                      put(np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))),
                      put(pts_w), put(f0.desc), put(f0.valid & (f0.depth > 0)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - n0) * 1e3
    T = T.cpu().numpy()
    err_t, err_r = [], []
    for b in range(B):
        gt = np.linalg.inv(seqs[b].poses_wc[1])
        err_t.append(float(np.linalg.norm(T[b, :3, 3] - gt[:3, 3])))
        err_r.append(float(np.abs(T[b, :3, :3] - gt[:3, :3]).max()))
    res = {"B": B, "ms": ms, "n_inliers": n_in.cpu().tolist(),
           "err_t_m": err_t, "err_R": err_r}
    print("batched_vo_step " + json.dumps(res), flush=True)
    _check(np.isfinite(T).all() and max(err_t) < 0.05 and max(err_r) < 0.05
           and min(res["n_inliers"]) > 50,
           f"batched VO step: {res}")
    return res


def run_h2d_batched(cfg, dev, lane_frames: list, B: int = 4) -> dict:
    """Host-to-device copies of batched steps: a BatchedSLAM of B
    tracking-only lanes warms up, then H2D_BATCH_STEPS steps run under one
    torch.profiler session, each in a span that ends synchronized after
    H2D_GAP_S of idle host, and each copy counts in the span of the host op
    that issued it (_h2d_by_span). Allowed per step: the stacked frame
    upload and the small-parameter upload, plus one window upload per lane
    whose window was refreshed (its insert into the stack is a device
    copy). A
    step in which a lane decides or makes a keyframe (its fuse set is
    uploaded apart) is reported, not held."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from planarslam_tpu_torch.parallel.replay import BatchedSLAM
    from planarslam_tpu_torch.slam.system import System

    n = H2D_WARMUP_FRAMES + 1 + H2D_BATCH_STEPS
    frames = lane_frames[:B]
    _check(len(frames[0]) >= n, f"h2d batched: {n} frames needed")
    bs = BatchedSLAM(cfg, B, device=dev)
    bs.systems = [System(config=cfg, enable_local_mapping=False,
                         enable_loop_closing=False, device=dev)
                  for _ in range(B)]

    def track(i):
        bs.track([frames[b][i][0] for b in range(B)],
                 [frames[b][i][1] for b in range(B)],
                 np.full(B, float(i) / 30.0))

    for i in range(H2D_WARMUP_FRAMES):
        track(i)
    seen = {"refresh": 0, "keyframe": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if key == "refresh" or out is not False:
                seen[key] += 1
            return out
        return wrapped

    for s in bs.systems:
        tr = s.tracker
        tr._refresh_window = counting("refresh", tr._refresh_window)
        tr._begin_keyframe = counting("keyframe", tr._begin_keyframe)
        tr._apply_pending_kf = counting("keyframe", tr._apply_pending_kf)
    per_step = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(H2D_WARMUP_FRAMES, n):
            seen.update(refresh=0, keyframe=0)
            time.sleep(H2D_GAP_S)
            with record_function(f"h2d_step_{i}"):
                track(i)
                torch.cuda.synchronize()
            per_step.append({"frame": i, "h2d_copies": 0,
                             "window_refreshes": seen["refresh"],
                             "keyframe_events": seen["keyframe"]})
    bs.flush()
    got = _h2d_by_span(prof.profiler.kineto_results.events(),
                       prof.events(), "h2d_step_", "h2d batched")
    _check(got["frames"] == [r["frame"] for r in per_step],
           f"h2d batched: the profiler kept {len(got['frames'])} of "
           f"{len(per_step)} step spans")
    for r in per_step:
        r["h2d_copies"] = got["copies"].get(r["frame"], 0)
    per_step = per_step[1:]
    held = [r for r in per_step if r["keyframe_events"] == 0]
    for r in held:
        limit = 2 + r["window_refreshes"]
        _check(1 <= r["h2d_copies"] <= limit,
               f"h2d batched: step at frame {r['frame']} made "
               f"{r['h2d_copies']} host-to-device copies, allowed {limit} "
               f"(frames, small parameters, {r['window_refreshes']} window "
               f"uploads): {r}")
    res = {"B": B, "steps": H2D_BATCH_STEPS, "steps_held": len(held),
           "limit_per_step": "2 (frames, small parameters) + 1 per lane "
                             "window upload",
           "copies_per_held_step": float(np.mean(
               [r["h2d_copies"] for r in held])) if held else None,
           "copies_per_step": float(np.mean(
               [r["h2d_copies"] for r in per_step])),
           "copies_without_host_op": got["unlinked"],
           "device_minus_issue_us": got["device_minus_issue_us"],
           "per_step": per_step}
    print("h2d_copies_batched " + json.dumps(res), flush=True)
    _check(len(held) >= 3, f"h2d batched: only {len(held)} steps without a "
           f"keyframe event in {H2D_BATCH_STEPS}")
    return res



# ---------------------------------------------------------------------------
# K37 (the step's decode), K38 (the carried-state lift), K39 (the Manhattan
# seed) and the packed fuse set

# a window's flag values (0, 0.5, the float above it, 1, NaN) and cloud
# counts (0, 1, 128), planted in turn
WINDOW_FLAGS = (0.0, 0.5, float(np.nextafter(np.float32(0.5), np.float32(1))),
                1.0, math.nan)
WINDOW_CLOUD_COUNTS = (0.0, 1.0, 128.0)
# planted decode frames: (h, w); "odd" is not a multiple of 4 pixels
DECODE_SHAPES = {"odd": (481, 643), "wide": (960, 1280), "small": (48, 64)}


def planted_window(cfg, seed: int = 37) -> np.ndarray:
    """A packed window (S,) float32: seeded values, the flags cycling
    through WINDOW_FLAGS, the cloud counts through WINDOW_CLOUD_COUNTS."""
    from planarslam_tpu_torch.slam import device_tracker as dt

    rng = np.random.default_rng(seed)
    fields = dt._window_fields(cfg.map.max_planes, cfg.lines.desc_dim)
    flat = rng.normal(size=fields[-1][2] + fields[-1][3]).astype(np.float32)
    for name, _, off, n in fields:
        if name in ("pt_valid", "ln_valid", "pl_valid"):
            vals = WINDOW_FLAGS
        elif name == "pl_cloud_n":
            vals = WINDOW_CLOUD_COUNTS
        else:
            continue
        k = rng.integers(0, len(vals))
        flat[off:off + n] = np.resize(np.roll(np.asarray(vals, np.float32),
                                              k), n)
    return flat


def all_depths_frame(seed: int = 38) -> np.ndarray:
    """A packed (3, 256, 256) uint8 frame whose depth holds every uint16
    value once (both bytes of each), a seeded grey."""
    rng = np.random.default_rng(seed)
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    return np.stack([rng.integers(0, 256, (256, 256), dtype=np.uint8),
                     (v & 0xFF).astype(np.uint8), (v >> 8).astype(np.uint8)])


def _packed(gray: np.ndarray, depth: np.ndarray) -> np.ndarray:
    from planarslam_tpu_torch.slam import device_tracker as dt

    return dt.pack_frame(gray, depth)


def _decoded(out) -> list:
    """K37's or its plain version's outputs as a flat list: grey, depth
    and every DeviceWindow field."""
    gray, depth, win = out
    return [gray, depth, *win]


def _decode_held(name: str, got, want) -> None:
    """Every output of a K37 launch bit-equal to the plain version's (the
    window's float views compared as int32 bits: a NaN matches only its own
    bits)."""
    from planarslam_tpu_torch.slam import device_tracker as dt

    names = ["gray", "depth", *dt.DeviceWindow._fields]
    bad = {n: _bit_diff(x, y, as_int=True)
           for n, x, y in zip(names, _decoded(got), _decoded(want))}
    _check(not any(bad.values()),
           f"decode_step_inputs ({name}): entries differ from the plain "
           f"version: {bad}")


def _decode_once(name: str, fn, want) -> list:
    """One K37 call of fn: one launch, two launches and one into outputs
    filled with NaN equal in bits, and bit-equal to `want`."""
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam import device_tracker as dt

    n0 = kernels.LAUNCHES["decode_step_inputs"]
    got = fn()
    _check(kernels.LAUNCHES["decode_step_inputs"] == n0 + 1,
           f"decode_step_inputs ({name}): not one launch a call")
    again = fn()
    with poisoned_outputs(dt, "_empty"):
        filled = fn()
    _check(same_bits(_decoded(got), _decoded(again))
           and same_bits(_decoded(got), _decoded(filled)),
           f"decode_step_inputs ({name}): two launches differ, or an output "
           f"was left unwritten")
    _decode_held(name, got, want)
    return _decoded(got)


def decode_kernel_parity(seq, cfg, dev) -> list:
    """K37 against its plain version, every output bit-equal, two launches
    equal bits, each call also into outputs filled with NaN: path 1's frame
    0; a 256x256 frame holding every depth value; a 643x481 frame (the
    scalar path), 1280x960 and 64x48; frames 0-3 at B = 4 lane by lane,
    each lane bit-equal to its B = 1 launch; each with a planted window
    (flags 0, 0.5, the float above 0.5, 1 and NaN, cloud counts 0, 1 and
    128); the unpacked entry (grey uint8, depth int32 and uint16, the
    uint16 depth equal to the int32 one) and float frames, which pass
    through (a launch of the window's casts alone)."""
    import torch

    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam import device_tracker as dt

    rng = np.random.default_rng(37)
    win1 = torch.from_numpy(planted_window(cfg)[None]).to(dev)
    q0 = quantize_frame(*seq.render(0), cfg.camera.depth_map_factor)
    frames = {"path1_frame0": _packed(*q0), "all_depths": all_depths_frame()}
    for name, (h, w) in DECODE_SHAPES.items():
        frames[name] = _packed(
            rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 65536, (h, w), dtype=np.uint16))
    shapes = {}
    for name, fr in frames.items():
        f = torch.from_numpy(fr[None]).to(dev)
        _decode_once(name, lambda: dt._decode(win1, cfg, frame=f),
                     dt.decode_step_inputs_plain(f, win1, cfg))
        shapes[name] = list(fr.shape[1:])
    # B = 4: frames 0-3 and four windows, lane by lane
    packed4 = np.stack([_packed(*quantize_frame(
        *seq.render(i), cfg.camera.depth_map_factor)) for i in range(4)])
    f4 = torch.from_numpy(packed4).to(dev)
    w4 = torch.from_numpy(np.stack([planted_window(cfg, 37 + b)
                                    for b in range(4)])).to(dev)
    got4 = _decode_once("B = 4", lambda: dt._decode(w4, cfg, frame=f4),
                        dt.decode_step_inputs_plain(f4, w4, cfg))
    for b in range(4):
        one = dt._decode(w4[b:b + 1], cfg, frame=f4[b:b + 1])
        _check(same_bits([x[b:b + 1] for x in got4], _decoded(one)),
               f"decode_step_inputs: lane {b} of B = 4 differs from its "
               f"B = 1 launch")
    # the unpacked entry: grey uint8 with int32 and uint16 depth
    g8 = torch.from_numpy(q0[0][None]).to(dev)
    d32 = torch.from_numpy(q0[1][None].astype(np.int32)).to(dev)
    d16 = torch.from_numpy(q0[1][None].view(np.int16).copy()).to(dev).view(
        torch.uint16)
    got32 = _decode_once("int32 depth",
                         lambda: dt._decode(win1, cfg, gray=g8, depth=d32),
                         (*dt.to_gray_depth(g8, d32, cfg),
                          dt.unpack_window(win1, cfg)))
    got16 = dt._decode(win1, cfg, gray=g8, depth=d16)
    _check(same_bits(_decoded(got16), got32),
           "decode_step_inputs: uint16 depth differs from its int32 values")
    # float frames pass through: the window's casts alone
    gf = g8.to(torch.float32)
    df = d32.to(torch.float32) * dt.depth_scale(cfg)
    got_f = _decode_once("float frames",
                         lambda: dt._decode(win1, cfg, gray=gf, depth=df),
                         (gf, df, dt.unpack_window(win1, cfg)))
    _check(got_f[0].data_ptr() == gf.data_ptr()
           and got_f[1].data_ptr() == df.data_ptr(),
           "decode_step_inputs: float frames were copied")
    f1 = torch.from_numpy(frames["path1_frame0"][None]).to(dev)
    out = dt._decode(win1, cfg, frame=f1)
    h, w = f1.shape[2:]
    items = sum(t.shape[-1] for t in (out[2].pt_valid, out[2].ln_valid,
                                      out[2].pl_valid))
    n_pl = out[2].pl_valid.shape[-1]

    def moved(b):  # frame read, grey and depth written, flags read and cast
        return b * (3 * h * w + 8 * h * w + 4 * (items + n_pl) + items
                    + 8 * n_pl)

    entry = {"name": "decode_step_inputs", "route": "cuda",
             "library_ms": None,
             # a pixel: the depth's or and shift, two conversions, one
             # product; a window item one compare or conversion
             **_bound(moved(1), 5 * h * w + items + n_pl),
             "source": "planarslam_tpu_torch/csrc/step_decode.cu",
             "replaces": "planarslam_tpu/slam/device_tracker.py:145",
             "max_abs_err": 0.0, "tolerance": "bit-equal",
             "shapes": {"frames": shapes, "B4": list(packed4.shape)},
             "ms": _time_ms(lambda: dt._decode(win1, cfg, frame=f1)),
             "plain_ms": _time_ms(
                 lambda: dt.decode_step_inputs_plain(f1, win1, cfg)),
             "ms_b4": _time_ms(lambda: dt._decode(w4, cfg, frame=f4)),
             "bound_ms_b4": moved(4) / HBM_BYTES_PER_S * 1e3,
             "device_ms": _launch_split(
                 lambda: dt._decode(win1, cfg, frame=f1), match="decode"),
             "device_ms_b4": _launch_split(
                 lambda: dt._decode(w4, cfg, frame=f4), match="decode")}
    _print_kernels([entry])
    return [entry]


# K39's planted direction sets (one frame each): no valid plane, ties in
# weight (the first index wins both picks), no perpendicular candidate (ok
# false), a lone valid line (ok false)
SEED_PLANTED = ("no_plane", "ties", "no_perpendicular", "lone_line")
SEED_TOLERANCE = 1e-6


def planted_seed_problem(case: str, cfg, seed: int = 39) -> list:
    """K39's inputs of a SEED_PLANTED case at the main path's widths, numpy:
    coeffs (P, 4), count (P,) int32, pl_valid (P,), p3d_s, p3d_e (L, 3),
    has_3d, ln_valid (L,), response (L,), normals (Nn, 3), normals_valid
    (Nn,)."""
    rng = np.random.default_rng(seed)
    P, L = cfg.planes.max_planes, cfg.lines.max_lines
    Nn = cfg.manhattan.max_normals
    f32 = np.float32

    def unit(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    axes = R.T  # rows: three perpendicular unit axes
    coeffs = np.zeros((P, 4))
    coeffs[:, :3] = unit(rng.normal(size=(P, 3)))
    coeffs[:, 3] = rng.uniform(-3, 3, P)
    count = rng.integers(100, 5000, P)
    pl_valid = rng.random(P) < 0.5
    p3d_s = rng.normal(size=(L, 3))
    d = unit(rng.normal(size=(L, 3)))
    length = rng.uniform(0.2, 1.5, L)
    has_3d = rng.random(L) < 0.8
    ln_valid = rng.random(L) < 0.8
    response = rng.uniform(10, 900, L)
    if case == "no_plane":
        pl_valid[:] = False
        d[: L // 2] = axes[0] + rng.normal(scale=0.01, size=(L // 2, 3))
        d[L // 2:] = axes[1] + rng.normal(scale=0.01, size=(L - L // 2, 3))
    elif case == "ties":
        pl_valid[:] = False
        pl_valid[[1, 3, 5, 6]] = True
        coeffs[[1, 3], :3] = axes[0]
        coeffs[[5, 6], :3] = axes[1]
        count[[1, 3, 5, 6]] = 6000
        ln_valid[:] = False
    elif case == "no_perpendicular":
        coeffs[:, :3] = unit(axes[2] + rng.normal(scale=0.05, size=(P, 3)))
        d[:] = unit(axes[2] + rng.normal(scale=0.05, size=(L, 3)))
    elif case == "lone_line":
        pl_valid[:] = False
        ln_valid[:] = False
        ln_valid[5] = has_3d[5] = True
        length[:4] = 0.05  # short lines: their gate
    p3d_e = p3d_s + unit(d) * length[:, None]
    normals = unit(rng.normal(size=(Nn, 3)))
    return [coeffs.astype(f32), count.astype(np.int32), pl_valid,
            p3d_s.astype(f32), p3d_e.astype(f32), has_3d, ln_valid,
            response.astype(f32), normals.astype(f32),
            rng.random(Nn) < 0.6]


def _seed_held(name: str, got, want) -> float:
    """K39's outputs against the plain version's, lane by lane: R_seed
    within SEED_TOLERANCE, ok and the picks exact, the direction set
    bit-equal. Returns the largest R_seed difference."""
    err = float((got.R_seed - want.R_seed).abs().max())
    bad = {f: _bit_diff(getattr(got, f), getattr(want, f))
           for f in ("ok", "picks", "dirs", "dirs_valid")}
    _check(err <= SEED_TOLERANCE and not any(bad.values()),
           f"seed_manhattan ({name}): R_seed {err:.3g} from the plain "
           f"version (limit {SEED_TOLERANCE}), entries differ: {bad}")
    return err


def _seed_lanes_plain(args):
    import torch

    from planarslam_tpu_torch.ops import manhattan as M

    lanes = [M.seed_manhattan_plain(*[a[b] for a in args])
             for b in range(args[0].shape[0])]
    return M.ManhattanSeed(*[torch.stack(f) for f in zip(*lanes)])


def seed_lift_parity(seq, frames, cfg, dev, captured: dict) -> list:
    """K38 on path 1's 48th tracking step against its plain version and
    against K31's new_state (which lifts the same features at the step's
    pose), at B = 1 and at B = 4 (the step's features at four of its
    poses), bit-equal, two launches equal bits, into outputs filled with
    NaN; K39 on path 1's first frame (as the initializer extracts it) and
    on SEED_PLANTED, each alone and all four at B = 4 in one launch, each
    lane within SEED_TOLERANCE of the plain version with ok, the picks and
    the direction set exact, and equal in bits to its B = 1 launch."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.ops import manhattan as M
    from planarslam_tpu_torch.slam import device_tracker as dt
    from planarslam_tpu_torch.slam.frame import extract_frame

    _, tail = _tail_inputs(captured, 48)
    new = dt.finish_step(tail, cfg)
    poses = torch.cat([new.T_out, tail.T1, tail.T_last, tail.T_cand])
    lifts = {"B1": [t.contiguous() for t in (
        tail.pt_uv, tail.pt_depth, tail.pt_valid, new.T_out)],
        "B4": [t.expand(4, *t.shape[1:]).contiguous() for t in (
            tail.pt_uv, tail.pt_depth, tail.pt_valid)] + [poses]}
    for name, args in lifts.items():
        n0 = kernels.LAUNCHES["lift_state"]
        got = _twice(lambda *a: dt.lift_state(*a, cfg), *args)
        _check(kernels.LAUNCHES["lift_state"] == n0 + 2,
               f"lift_state ({name}): not one launch a call")
        with poisoned_outputs(dt, "_empty"):
            filled = dt.lift_state(*args, cfg)
        want = kernels.per_problem(dt.lift_state_plain, args, cfg)
        _check(same_bits(got, filled), f"lift_state ({name}): an output "
               f"was left unwritten")
        _tail_held(f"lift_state ({name})", got, want)
        if name == "B1":
            _tail_held("lift_state (K31's new_state)", got,
                       (new.pt3d_w, new.valid3d))
        else:
            for b in range(4):
                one = dt.lift_state(*[a[b:b + 1] for a in args], cfg)
                _check(same_bits([x[b:b + 1] for x in got], one),
                       f"lift_state: lane {b} of B = 4 differs from its "
                       f"B = 1 launch")
    args = lifts["B1"]
    k = args[1].shape[1]
    lift = {"name": "lift_state", "route": "cuda", "library_ms": None,
            # per feature two differences, six products, three dots and
            # sums; uv, depth, valid, the pose in; the points and mask out
            **_bound(_nbytes(args) + 13 * k, 30 * k),
            "source": "planarslam_tpu_torch/csrc/step_tail.cu",
            "replaces": "planarslam_tpu/slam/device_tracker.py:171",
            "max_abs_err": 0.0, "tolerance": "bit-equal",
            "shapes": {"K": int(k)},
            "ms": _time_ms(lambda: dt.lift_state(*args, cfg)),
            "plain_ms": _time_ms(lambda: dt.lift_state_plain(
                *[a[0] for a in args], cfg)),
            "ms_b4": _time_ms(lambda: dt.lift_state(*lifts["B4"], cfg)),
            "device_ms": _launch_split(lambda: dt.lift_state(*args, cfg),
                                       match="lift_state")}

    # K39: path 1's first frame as the initializer extracts it, then the
    # planted sets
    g, d = frames[0]
    feats = extract_frame(
        torch.from_numpy(np.asarray(g, np.float32)).to(dev),
        torch.from_numpy(d.astype(np.float32)
                         / cfg.camera.depth_map_factor).to(dev), cfg)
    ln, pl = feats.lines, feats.planes
    frame0 = [t[None].contiguous() for t in (
        pl.coeffs, pl.count, pl.valid, ln.p3d_s, ln.p3d_e, ln.has_3d,
        ln.valid, ln.response, feats.normals, feats.normals_valid)]
    cases = {"path1_frame0": frame0}
    for case in SEED_PLANTED:
        cases[case] = [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                       for a in planted_seed_problem(case, cfg)]
    cases["B4"] = [torch.cat(t) for t in zip(
        *[cases[c] for c in SEED_PLANTED])]
    errs, oks, picks = {}, {}, {}
    for name, args in cases.items():
        n0 = kernels.LAUNCHES["seed_manhattan"]
        got = _twice(M.seed_manhattan, *args)
        _check(kernels.LAUNCHES["seed_manhattan"] == n0 + 2,
               f"seed_manhattan ({name}): not one launch a call")
        got = M.ManhattanSeed(*got)
        with poisoned_outputs(M, "_empty"):
            filled = M.seed_manhattan(*args)
        _check(same_bits(got, filled), f"seed_manhattan ({name}): an output "
               f"was left unwritten")
        errs[name] = _seed_held(name, got, _seed_lanes_plain(args))
        oks[name] = got.ok.tolist()
        picks[name] = got.picks.tolist()
    for b, case in enumerate(SEED_PLANTED):
        _check(same_bits([x[b:b + 1] for x in M.seed_manhattan(
            *cases["B4"])], M.seed_manhattan(*cases[case])),
            f"seed_manhattan: lane {b} of B = 4 differs from its B = 1 "
            f"launch")
    want_ok = {"path1_frame0": [True], "no_plane": [True], "ties": [True],
               "no_perpendicular": [False], "lone_line": [False]}
    _check(all(oks[c] == v for c, v in want_ok.items())
           and picks["ties"] == [[1, 5]]
           and picks["lone_line"] == [[cfg.planes.max_planes + 5, 0]],
           f"seed_manhattan: the planted cases do not exercise it: ok "
           f"{oks}, picks {picks}")
    args = frame0
    out = M.seed_manhattan(*args)
    n_dirs = out.dirs_valid.shape[1]
    seed = {"name": "seed_manhattan", "route": "cuda", "library_ms": None,
            # per candidate a direction (~15) and two picks (~10); the
            # polar factor ~600; the normals copied
            **_bound(_nbytes(args, out), 25 * (args[0].shape[1]
                                               + args[3].shape[1]) + 600),
            "source": "planarslam_tpu_torch/csrc/manhattan.cu",
            "replaces": "planarslam_tpu/ops/manhattan.py:123",
            "max_abs_err": max(errs.values()),
            "tolerance": f"R_seed {SEED_TOLERANCE}; ok, picks, directions "
                         f"exact",
            "shapes": {"candidates": int(args[0].shape[1] + args[3].shape[1]),
                       "directions": int(n_dirs)},
            "ok": oks, "picks": picks, "errors": errs,
            "ms": _time_ms(lambda: M.seed_manhattan(*args)),
            "plain_ms": _time_ms(lambda: M.seed_manhattan_plain(
                *[a[0] for a in args])),
            "device_ms": _launch_split(lambda: M.seed_manhattan(*args),
                                       match="seed_manhattan")}
    _print_kernels([lift, seed])
    return [lift, seed]


def _per_target(fn):
    """fn (a search or a match with a leading batch in its positional
    tensors; its keywords are numbers) run lane by lane, one call a lane,
    as the mapping step and the fuse set ran it over their targets before
    they took the targets as the batch."""
    import torch

    from planarslam_tpu_torch.ops.matching import MatchResult

    def run(*args, **kw):
        rows = [fn(*[a[i] for a in args], **kw)
                for i in range(args[0].shape[0])]
        return MatchResult(torch.stack([r.idx for r in rows]),
                           torch.stack([r.dist for r in rows]))
    return run


@contextlib.contextmanager
def per_target_matching():
    """device_mapper's searches and matches over the targets one call a
    target (the parent's loops), inside the block."""
    import types

    from planarslam_tpu_torch.ops import matching
    from planarslam_tpu_torch.slam import device_mapper as dm

    real = dm.matching
    dm.matching = types.SimpleNamespace(
        search_by_projection=_per_target(matching.search_by_projection),
        match_descriptors=_per_target(matching.match_descriptors))
    try:
        yield
    finally:
        dm.matching = real


MAPPING_CAPTURE = tuple(("device_mapper", "_mapping_step_impl", n)
                        for n in (1, 3, -1))


# K42's planted mapping steps (planted_line_tri_problem): seeded lines seen
# from the own keyframe and five neighbours (some segments not free), no
# own line free, tied similarities (a neighbour's matched row copied to
# another slot, below and above it), NaN descriptors (an own entry, a whole
# own row, a neighbour row that every own row sees), neighbours with nb_ok
# False, a ray parallel to the matched plane (its denominator exactly 0)
# and parallaxes at the 0.998 edge (rows whose float32 cosp lie on the
# last floats either side of it)
LINE_TRI_PLANTED = ("random", "no_free", "ties", "nan_desc", "nb_not_ok",
                    "parallel_ray", "parallax_edge")
# _mapping_step_impl's positional inputs that K42 takes, in its order
LINE_TRI_ARGS = (0, 16, 17, 18, 19, 21, 8, 22, 23, 25, 15)
LINE_TRI_KEYS = ("own_T", "own_ln_uvs", "own_ln_uve", "own_ln_l2d",
                 "own_ln_desc", "own_ln_free", "nb_T", "nb_ln_l2d",
                 "nb_ln_desc", "nb_ln_free", "nb_ok")
LINE_TRI_NB = 5  # slam/device_mapper.py N_NEIGHBORS


def _f32_dot3(a, b):
    """K42's 3-term dot product in numpy float32: (a0 b0 + a1 b1) + a2 b2."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _f32_backproject(T, l, K, n: int) -> list:
    """K42's back-projection plane (K [R | t])^T l in numpy float32."""
    fx, fy, cx, cy = (np.float32(v) for v in K)
    return [(fx * T[0, c] + cx * T[2, c]) * l[0]
            + (fy * T[1, c] + cy * T[2, c]) * l[1] + T[2, c] * l[2]
            for c in range(n)]


def line_tri_cosp(T1, l1, T2, l2, K) -> np.float32:
    """K42's parallax cosine of two image lines' planes in numpy float32,
    each operation rounded as the kernel and its plain version round it."""
    p1 = _f32_backproject(T1, l1, K, 3)
    p2 = _f32_backproject(T2, l2, K, 3)
    return np.float32(np.abs(_f32_dot3(p1, p2)) / (
        np.sqrt(_f32_dot3(p1, p1)) * np.sqrt(_f32_dot3(p2, p2))
        + np.float32(1e-12)))


def _image_line(s, e) -> np.ndarray:
    """The line through pixels s and e, (a, b) of unit norm (float32)."""
    ln = np.cross([s[0], s[1], 1.0], [e[0], e[1], 1.0])
    return (ln / np.linalg.norm(ln[:2])).astype(np.float32)


def _project_px(T, X, K) -> np.ndarray:
    pc = T[:3, :3].astype(np.float64) @ X + T[:3, 3]
    return np.array([K[0] * pc[0] / pc[2] + K[2], K[1] * pc[1] / pc[2] + K[3]])


def _zero_ray_pixel(c: float, f: float) -> np.float32:
    """A float32 pixel u near c whose K42 ray term u (1 / f) + (-c / f) is
    exactly 0 in float32."""
    inv, neg = np.float32(1) / np.float32(f), -(np.float32(c) / np.float32(f))
    u = np.float32(c)
    for step in range(256):
        for cand in (u, np.nextafter(u, np.float32(np.inf))):
            if np.float32(cand * inv) + neg == 0:
                return cand
        u = np.nextafter(u, np.float32(-np.inf)) if step % 2 else \
            np.nextafter(u, np.float32(np.inf))
    _fail(f"no float32 pixel near {c} zeroes the ray term")


def planted_line_tri_problem(case: str, cfg, seed: int = 42) -> dict:
    """One planted K42 problem (LINE_TRI_PLANTED) at cfg's line slots L and
    descriptor width D, NB = 5 neighbours, as numpy arrays keyed as
    LINE_TRI_KEYS (bools as bool), plus "K". Seeded lines 1.5-4 m in front
    of the own camera, each neighbour 0.1-0.3 m away seeing them in
    another slot order with descriptor noise of 0.03."""
    rng = np.random.default_rng(seed)
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    L, D, NB = cfg.lines.max_lines, cfg.lines.desc_dim, LINE_TRI_NB
    W, H = cam.width, cam.height
    flat = case in ("parallel_ray", "parallax_edge")
    own_T = (np.eye(4, dtype=np.float32) if flat else
             _rotvec_pose(rng.normal(0, 0.05, 3), rng.normal(0, 0.2, 3)))
    nb_T = np.stack([_rotvec_pose(rng.normal(0, 0.03, 3),
                                  rng.uniform(-0.3, 0.3, 3)) @ own_T
                     for _ in range(NB)]).astype(np.float32)
    desc = rng.normal(0, 1, (L, D))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    uvs = np.stack([rng.uniform(0.1 * W, 0.9 * W, L),
                    rng.uniform(0.1 * H, 0.9 * H, L)], -1)
    uve = np.clip(uvs + rng.normal(0, 0.15 * W, (L, 2)), 1, [W - 2, H - 2])
    T_wc = np.linalg.inv(own_T.astype(np.float64))

    def world(uv, z):
        pc = np.array([(uv[0] - K[2]) / K[0] * z, (uv[1] - K[3]) / K[1] * z,
                       z])
        return T_wc[:3, :3] @ pc + T_wc[:3, 3]

    Xs = [world(uvs[i], rng.uniform(1.5, 4)) for i in range(L)]
    Xe = [world(uve[i], rng.uniform(1.5, 4)) for i in range(L)]
    nb_l2d = np.zeros((NB, L, 3), np.float32)
    nb_desc = np.zeros((NB, L, D), np.float32)
    perms = [rng.permutation(L) for _ in range(NB)]
    for n in range(NB):
        for i in range(L):
            nb_l2d[n, perms[n][i]] = _image_line(_project_px(nb_T[n], Xs[i], K),
                                                 _project_px(nb_T[n], Xe[i], K))
            d = desc[i] + rng.normal(0, 0.03, D)
            nb_desc[n, perms[n][i]] = d / np.linalg.norm(d)
    p = {"own_T": own_T, "own_ln_uvs": uvs.astype(np.float32),
         "own_ln_uve": uve.astype(np.float32),
         "own_ln_l2d": np.stack([_image_line(uvs[i], uve[i])
                                 for i in range(L)]),
         "own_ln_desc": desc.astype(np.float32),
         "own_ln_free": rng.random(L) > 0.1, "nb_T": nb_T,
         "nb_ln_l2d": nb_l2d, "nb_ln_desc": nb_desc,
         "nb_ln_free": rng.random((NB, L)) > 0.1,
         "nb_ok": np.ones(NB, bool), "K": K}
    if case == "no_free":
        p["own_ln_free"][:] = False
    elif case == "ties":
        for n in range(NB):
            for i in range(0, L - 1, 4):
                j, j2 = perms[n][i], perms[n][i + 1]
                nb_desc[n, j2], nb_l2d[n, j2] = nb_desc[n, j], nb_l2d[n, j]
                p["nb_ln_free"][n, [j, j2]] = True
                p["own_ln_free"][i] = True
    elif case == "nan_desc":
        p["own_ln_desc"][1, 5] = np.nan
        p["own_ln_desc"][2] = np.nan
        nb_desc[2, 3, 0] = np.nan
        p["nb_ln_free"][2, 3] = True
        p["own_ln_free"][:] = True
    elif case == "nb_not_ok":
        p["nb_ok"][[1, 3]] = False
    elif case == "parallel_ray":
        # own line 0's start ray is the optical axis, and neighbour 0 (no
        # rotation, 0.3 m along x) matches it to the line u = cx, whose
        # plane holds the axis: the ray's denominator is exactly 0
        nb_T[0] = np.eye(4, dtype=np.float32)
        nb_T[0, 0, 3] = 0.3
        u0 = _zero_ray_pixel(cam.cx, cam.fx)
        v0 = _zero_ray_pixel(cam.cy, cam.fy)
        p["own_ln_uvs"][0] = (u0, v0)
        p["own_ln_uve"][0] = (u0 + 40, v0 + 30)
        p["own_ln_l2d"][0] = _image_line(p["own_ln_uvs"][0],
                                         p["own_ln_uve"][0])
        nb_l2d[0, 0] = np.array([1.0, 0.0, -np.float32(cam.cx)], np.float32)
        nb_desc[0, 0] = p["own_ln_desc"][0]
        p["own_ln_free"][0] = p["nb_ln_free"][0, 0] = True
    elif case == "parallax_edge":
        # vertical segments at x = 0.3 m seen from the own camera and from
        # neighbour 0, 0.2 m along x: their planes' cosp crosses 0.998 near
        # 3.15 m; row i takes a depth whose float32 cosp lies on the last
        # floats below or at and above 0.998 (idx i: equal descriptors)
        nb_T[0] = np.eye(4, dtype=np.float32)
        nb_T[0, 0, 3] = -0.2
        edge = np.float32(0.998)

        def row(z):
            a, b = np.array([0.3, -0.3, z]), np.array([0.3, 0.3, z])
            s1, e1 = _project_px(own_T, a, K), _project_px(own_T, b, K)
            l1 = _image_line(s1, e1)
            l2 = _image_line(_project_px(nb_T[0], a, K),
                             _project_px(nb_T[0], b, K))
            return line_tri_cosp(own_T, l1, nb_T[0], l2, K), s1, e1, l1, l2

        rows = {}
        for z in np.linspace(3.0, 3.3, 6001):
            r = row(z)
            rows.setdefault(float(r[0]), r)
        vals = np.array(sorted(rows))
        below = vals[vals < edge][-(L // 2):]
        above = vals[vals >= edge][:L - len(below)]
        picks = list(below) + list(above)
        _check(len(picks) == L and len(below) and len(above),
               f"parallax_edge: {len(picks)} rows about the edge")
        for i, c in enumerate(picks):
            _, s1, e1, l1, l2 = rows[c]
            p["own_ln_uvs"][i], p["own_ln_uve"][i] = s1, e1
            p["own_ln_l2d"][i], nb_l2d[0, i] = l1, l2
            nb_desc[0, i] = p["own_ln_desc"][i]
        p["own_ln_free"][:] = True
        p["nb_ln_free"][0] = True
        p["edge_below"] = len(below)  # rows 0 .. below - 1 pass the edge
    return p


def line_tri_args(p: dict, dev) -> tuple:
    """A planted problem's K42 inputs as tensors on dev, and its K."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(p[k])).to(dev)
                 for k in LINE_TRI_KEYS), p["K"]


def captured_line_tri(captured: dict, cfg) -> list:
    """K42's inputs (tensors, K) of path 2's captured mapping steps."""
    cam = cfg.camera
    steps = [captured[c] for c in MAPPING_CAPTURE if c in captured]
    return [(tuple(args[i].contiguous() for i in LINE_TRI_ARGS),
             (cam.fx, cam.fy, cam.cx, cam.cy)) for args, _ in steps]


def line_tri_problems(cfg, dev) -> dict:
    """K42's timing problems (tools/kernel_timing.py): the planted random,
    tied, NaN and parallax-edge mapping steps alone and the four in one
    launch; a tree without K42 times its plain line triangulation
    (`_line_triangulation`) on the four alone."""
    import torch

    from planarslam_tpu_torch.slam import device_mapper as dm

    names = ("random", "ties", "nan_desc", "parallax_edge")
    probs = {c: line_tri_args(planted_line_tri_problem(c, cfg), dev)
             for c in names}
    if not hasattr(dm, "triangulate_lines"):
        cam = cfg.camera
        Kmat = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                             [0, 0, 1]], dtype=torch.float32, device=dev)
        return {n: (lambda a=a: dm._line_triangulation(*a[0], Kmat))
                for n, a in probs.items()}
    out = {n: (lambda a=a: dm.triangulate_lines(*a[0], a[1])) for n, a in
           probs.items()}
    batch = [torch.stack([probs[n][0][i] for n in names])
             for i in range(len(LINE_TRI_KEYS))]
    out["batch4"] = lambda: dm.triangulate_lines(*batch, probs["random"][1])
    return out


def line_triangulation_parity(cfg, dev, captured: dict) -> list:
    """K42 (triangulate_lines) against its plain version on the card, on
    path 2's captured mapping steps (MAPPING_CAPTURE) and every
    LINE_TRI_PLANTED problem at B = 1, each launch into outputs filled with
    NaN (bools and ints 0x7f), idx, Xs, Xe and good bit-equal, two launches
    equal bits; then at B = 4 lane by lane (the planted problems four at a
    time), each lane bit-equal to its B = 1 launch."""
    import torch

    from planarslam_tpu_torch.slam import device_mapper as dm

    probs = {f"path2_step{k[2]}": a for k, a in zip(
        MAPPING_CAPTURE, captured_line_tri(captured, cfg))}
    _check(len(probs) == len(MAPPING_CAPTURE),
           f"line triangulation: {len(probs)} of path 2's mapping steps "
           f"captured")
    planted = {c: planted_line_tri_problem(c, cfg) for c in LINE_TRI_PLANTED}
    for case, p in planted.items():
        probs[case] = line_tri_args(p, dev)
    stats, singles = {}, {}
    for name, (args, K) in probs.items():
        with poisoned_outputs(dm, "_empty"):
            got = dm.triangulate_lines(*args, K)
            again = dm.triangulate_lines(*args, K)
        want = dm.triangulate_lines_plain(*args, K)
        torch.cuda.synchronize()
        _check(same_bits(got, again), f"triangulate_lines ({name}): two "
               f"launches differ")
        bad = [_bit_diff(x, y, as_int=True) for x, y in zip(got, want)]
        _check(not any(bad), f"triangulate_lines ({name}): idx, Xs, Xe, "
               f"good differ from the plain version in {bad} entries")
        singles[name] = got
        stats[name] = {"good": int(got[3].sum()),
                       "matched": int((got[0] >= 0).sum()),
                       "rows": int(got[0].numel())}
    _check(stats["path2_step1"]["good"] + stats["random"]["good"] > 0,
           f"triangulate_lines: nothing triangulated: {stats}")
    names = list(LINE_TRI_PLANTED)
    lanes = 0
    for g in range(0, len(names) - 3, 4):
        group = names[g:g + 4]
        batch = [torch.stack([probs[n][0][i] for n in group])
                 for i in range(len(LINE_TRI_KEYS))]
        with poisoned_outputs(dm, "_empty"):
            out = dm.triangulate_lines(*batch, probs[group[0]][1])
        for b, n in enumerate(group):
            _check(same_bits([x[b] for x in out], singles[n]),
                   f"triangulate_lines: lane {b} ({n}) of B = 4 differs "
                   f"from its B = 1 launch")
            lanes += 1
    below = planted["parallax_edge"]["edge_below"]
    g0 = singles["parallax_edge"][3][0].cpu().numpy()
    _check(bool(g0[:below].all()) and not g0[below:].any(),
           f"triangulate_lines: neighbour 0's parallax edge rows give good "
           f"{g0.astype(int).tolist()}, expected the first {below}")
    args, K = probs["path2_step1"]
    NB, L = args[8].shape[0], args[8].shape[1]
    D = args[8].shape[2]
    n_bytes = _nbytes(args) + NB * L * (4 + 24 + 1)
    ops = 2.0 * NB * L * L * D + 250.0 * NB * L
    out = [{"name": "triangulate_lines", "route": "cuda",
            "source": "planarslam_tpu_torch/csrc/line_triangulate.cu",
            "replaces": "planarslam_tpu/slam/device_mapper.py:187",
            "max_abs_err": 0.0,
            "tolerance": "idx, Xs, Xe and good bit-equal (the plain version "
                         "spells each dot product in the kernel's order); "
                         "two launches and B = 4 lanes equal bits",
            "cases": stats, "lanes_checked": lanes,
            "shapes": {"NB": NB, "L": L, "D": D}, "library_ms": None,
            **_bound(n_bytes, ops),
            "ms": _time_ms(lambda: dm.triangulate_lines(*args, K)),
            "plain_ms": _time_ms(lambda: dm.triangulate_lines_plain(*args,
                                                                     K))}]
    _print_kernels(out)
    print("line_triangulation_parity " + json.dumps(stats), flush=True)
    return out


def fuse_set_parity(slam_map, cfg, dev, captured: dict) -> dict:
    """The packed fuse set (fuse_set_step_packed: one K24, K3 and K25
    launch over the targets padded to N_NEIGHBORS) against the per-target
    loop it replaces, indices equal, on path 2's map: keyframes' landmark
    sets (fewer than C) into 0-5 targets, and every map point (more than
    C, cut to C) into 5; and path 2's captured mapping steps
    (MAPPING_CAPTURE) bit-equal, the bundle as int32 bits, to the same
    steps with the fuse and the triangulation matches run per target."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam import device_mapper as dm

    m = slam_map
    C = cfg.orb.max_keypoints
    kfs = [int(k) for k in m.valid_kf_ids()]
    _check(len(kfs) >= 6, f"fuse set: path 2 made {len(kfs)} keyframes")
    every = np.flatnonzero(m.pt_valid)
    big = np.resize(every, max(len(every), C + 100))
    cases = {}
    for n_t in range(6):
        kf = kfs[n_t]
        row = m.kf_pt_idx[kf]
        cov = [int(c) for c in m.covisible_kfs(kf)]
        near = cov + [k for k in kfs if k != kf and k not in cov]
        cases[f"targets_{n_t}"] = (np.unique(row[row >= 0]), near[:n_t])
    cases["over_capacity"] = (big, kfs[-5:])
    rec = {}
    for name, (ids, targets) in cases.items():
        flat, meta = dm.fuse_set_inputs(m, ids, targets, cfg)
        ft = torch.from_numpy(flat).to(dev)
        before = dict(kernels.LAUNCHES)
        got = dm.fuse_set_step_packed(ft, cfg, radius=4.0)
        launched = {k: kernels.LAUNCHES[k] - before[k]
                    for k in FUSE_SET_LAUNCHES}
        _check(launched == FUSE_SET_LAUNCHES, f"fuse set ({name}): "
               f"launches {launched}, expected {FUSE_SET_LAUNCHES}")
        with per_target_matching():
            want = dm.fuse_set_step_packed(ft, cfg, radius=4.0)
        absent = ~torch.from_numpy(meta["nb_ok"]).to(dev)
        _check(torch.equal(got, want) and bool((got[absent] == -1).all()),
               f"fuse set ({name}): indices differ from the per-target "
               f"loop in {int((got != want).sum())}, or an absent target's "
               f"row is not all -1")
        rec[name] = {"landmarks": int(len(ids)), "targets": len(targets),
                     "matched": int((got >= 0).sum())}
    _check(rec["over_capacity"]["landmarks"] > C
           and sum(r["matched"] for r in rec.values()) > 100,
           f"fuse set: the cases do not exercise it: {rec}")
    flat, _ = dm.fuse_set_inputs(m, big, kfs[-5:], cfg)
    ft = torch.from_numpy(flat).to(dev)
    rec["ms_packed"] = _time_ms(lambda: dm.fuse_set_step_packed(ft, cfg))
    with per_target_matching():
        rec["ms_per_target"] = _time_ms(
            lambda: dm.fuse_set_step_packed(ft, cfg))
    steps = [captured[c] for c in MAPPING_CAPTURE if c in captured]
    _check(len(steps) == len(MAPPING_CAPTURE),
           f"fuse set: {len(steps)} of path 2's mapping steps captured")
    for (args, kw), key in zip(steps, MAPPING_CAPTURE):
        got = dm._mapping_step_impl(*args, **kw)
        with per_target_matching():
            want = dm._mapping_step_impl(*args, **kw)
        _check(_bit_diff(got, want, as_int=True) == 0,
               f"mapping step {key[2]}: the bundle differs from the "
               f"per-target one in {_bit_diff(got, want, as_int=True)} "
               f"words")
    rec["mapping_steps_equal"] = len(steps)
    print("fuse_set_parity " + json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# Path 8: chunked throughput mode, a chunk one captured CUDA graph replay

CHUNK_SIZE = 8         # bench.py CHUNK_SWEEP's first entry: C = 8,
CHUNK_DEPTH = 2        # chunk_pipeline_depth = 2
CHUNK_PARTIAL_FRAMES = 45  # path 8b: frame 0 initializes, five chunks of 8
                           # and a partial one of 4 at the flush
CHUNK_PARITY_CALL = 40  # path 2's streaming step (frame 40) whose carried
                        # state and window start chunk_parity
CHUNK_PARITY_CHUNKS = 3  # chunks chunk_parity replays (frames 40-63)
H2D_CHUNKS = 4         # chunks under the profiler in run_h2d_chunks
L2_FLUSH_BYTES = 100 << 20  # twice the H100's 50 MB L2: read before a
                            # launch timed with L2 cold


# path 2's streaming step whose inputs chunk_parity starts from
CHUNK_CAPTURE = (("device_tracker", "fused_track_step_packed",
                  CHUNK_PARITY_CALL),)


def chunk_config(cfg):
    """cfg with chunked throughput mode at CHUNK_SIZE, CHUNK_DEPTH."""
    import dataclasses

    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, chunk_size=CHUNK_SIZE,
        chunk_pipeline_depth=CHUNK_DEPTH))


def chunk_launches(cfg, C: int = CHUNK_SIZE) -> dict:
    """The launches of one chunk: one K37 (its C frames and the shared
    window), the extraction kernels once (one extract_frame call at B = C,
    each as its C entry reports them) and C times a streaming step's
    launches (STEP_LAUNCHES and K23's one launch over the 256-line
    window)."""
    from planarslam_tpu_torch.ops import fast, image, lines
    from planarslam_tpu_torch.ops.frontend import orb_level_table

    table = orb_level_table(cfg.camera.height, cfg.camera.width, cfg.orb)
    out = {k: C * n for k, n in STEP_LAUNCHES.items()}
    out["search_lines_by_projection"] = C * lines.search_launches(LINE_WINDOW)
    out.update({"decode_step_inputs": 1, "fast_score": 1, "orb_describe": 1,
                "point_epilogue": 1, "pyramid_resize": image.PYRAMID_LAUNCHES,
                "select_keypoints": fast.select_launches(table),
                "gaussian_blur": 2, "detect_lines": lines.DETECT_LAUNCHES,
                "line_descriptors": 1, "lift_lines_3d": 1,
                "plane_block_moments": 1, "plane_components": 1,
                "plane_assign_refit": 1 + cfg.planes.refine_rounds,
                "plane_label_pixels": 1, "noise_alpha": 1,
                "frame_normals": 1})
    return out


def _chunk_leaves(res) -> list:
    """A ChunkResult's tensors: the bundles, every per-frame state leaf,
    every final state leaf."""
    from planarslam_tpu_torch.slam import device_tracker as dt

    return ([res.packed] + dt.state_leaves(res.states)
            + dt.state_leaves(res.final_state))


def _chunk_same(name: str, got, want) -> None:
    bad = [i for i, (x, y) in enumerate(zip(_chunk_leaves(got),
                                            _chunk_leaves(want)))
           if x.shape != y.shape or _bit_diff(x, y, as_int=True)]
    _check(not bad, f"chunk_parity: {name}: leaves {bad} differ (0 the "
           f"bundles, then the per-frame and the final state leaves)")


def _replay_device(graph, packs: list, reps: int = 6) -> dict:
    """Device ms and kernel events of one replay (torch.profiler over
    `reps` replays after one, events per replay and their summed device
    time), and CUDA events around the replay alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graph.replay(packs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(reps):
            graph.replay(packs[k % len(packs)])
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        if t > 0 and "Memcpy" not in e.key:
            n += e.count
            us += t
    times = []
    for k in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.frames.copy_(torch.from_numpy(packs[k % len(packs)]))
        start.record()
        graph.graphs[graph.next_slot].replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"device_ms_per_chunk": us / reps / 1e3 if n else None,
            "device_events_per_chunk": n / reps if n else None,
            "replay_ms_events": float(np.median(times))}


def chunk_parity(frames, cfg, dev, captured, report: list) -> dict:
    """Chunked mode against the streaming step, from path 2's carried
    state and window at its CHUNK_PARITY_CALL-th step (frame
    CHUNK_PARITY_CALL), on the next CHUNK_SIZE frames: the eager
    fused_track_chunk_packed bit-equal to CHUNK_SIZE chained B = 1
    fused_track_step_packed steps over the frozen window (the bundles as
    int32 bits, every per-frame and final state leaf); a CapturedChunk's
    replays bit-equal to the eager chunks chained from that state, two
    rounds of the ring of CHUNK_DEPTH + 1 slots (CHUNK_PARITY_CHUNKS
    frame sets in turn), each slot's bundles and per-frame states unchanged
    by the other slots' replays; the
    launches a replay adds (its capture's) equal to the eager chunk's and
    to chunk_launches; K37's shared-window mode (C frames, one window)
    bit-equal to its plain version and to K37 on the window repeated C
    times, two launches equal bits, with its time and bound beside K37's
    kernel row; an eager chunk under torch.cuda.set_sync_debug_mode
    ("error"), which raises at a host sync; a replay's device ms and
    kernel events."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.slam import device_tracker as dt

    args, _ = captured
    frame1, _, _, R_wm, manh, state, win, weights = args[:8]
    C = CHUNK_SIZE
    i0 = CHUNK_PARITY_CALL
    packs = [np.stack([_packed(*frames[i]) for i in range(i0 + k * C,
                                                          i0 + (k + 1) * C)])
             for k in range(CHUNK_PARITY_CHUNKS)]
    _check(np.array_equal(frame1[0].cpu().numpy(), packs[0][0]),
           f"chunk_parity: path 2's step {i0} is not frame {i0}")
    fr = [torch.from_numpy(p).to(dev) for p in packs]
    eye = torch.eye(4, device=dev)[None]
    no = torch.zeros(1, dtype=torch.bool, device=dev)

    # the eager chunk against chained streaming steps
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    eager = dt.fused_track_chunk_packed(fr[0], R_wm, manh, state, win,
                                        weights, cfg)
    capture_s = None
    eager_counts = {k: kernels.LAUNCHES[k] - n for k, n in before.items()
                    if kernels.LAUNCHES[k] != n}
    st = state
    for i in range(C):
        one = dt.fused_track_step_packed(fr[0][i:i + 1], eye, no, R_wm, manh,
                                         st, win, weights, cfg)
        _check(_bit_diff(eager.packed[i], one.packed[0], as_int=True) == 0,
               f"chunk_parity: frame {i}'s bundle differs from the "
               f"streaming step's")
        bad = [j for j, (x, y) in enumerate(zip(
            dt.state_leaves(eager.states), dt.state_leaves(one.new_state)))
            if _bit_diff(x[i], y[0], as_int=True)]
        _check(not bad, f"chunk_parity: frame {i}'s state leaves {bad} "
               f"differ from the streaming step's")
        st = one.new_state
    bad = [j for j, (x, y) in enumerate(zip(dt.state_leaves(st),
                                            dt.state_leaves(eager.final_state)))
           if _bit_diff(x, y, as_int=True)]
    _check(not bad, f"chunk_parity: final state leaves {bad} differ from "
           f"the last streaming step's")
    # no host sync inside the chunk (what a capture could not hold)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dt.fused_track_chunk_packed(fr[0], R_wm, manh, state, win, weights,
                                    cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    chained = [eager]
    for k in range(1, CHUNK_PARITY_CHUNKS):
        chained.append(dt.fused_track_chunk_packed(
            fr[k], R_wm, manh, chained[-1].final_state, win, weights, cfg))

    # the captured chunk: two rounds of the ring, each replay against the
    # eager chain, and every other slot's bundles and per-frame states
    # (its final_state is the graphs' carry, which every replay rewrites)
    # as that slot's own replay left them
    graph = dt.CapturedChunk(C, cfg, weights, dev, slots=CHUNK_DEPTH + 1)
    graph.set_state(state)
    graph.set_inputs(win, R_wm, manh)
    n_slot = 1 + len(dt.state_leaves(eager.states))
    kept = {}
    t0 = time.perf_counter()
    for k in range(2 * graph.slots):
        if k >= len(chained):
            chained.append(dt.fused_track_chunk_packed(
                fr[k % len(fr)], R_wm, manh, chained[-1].final_state, win,
                weights, cfg))
        slot = graph.next_slot
        out = graph.replay(packs[k % len(packs)])
        torch.cuda.synchronize()
        if k == 0:
            capture_s = time.perf_counter() - t0
        _chunk_same(f"replay {k + 1} against the eager chain", out,
                    chained[k])
        kept[slot] = [x.clone() for x in _chunk_leaves(out)[:n_slot]]
        for other, leaves in kept.items():
            _check(all(_bit_diff(x, y, as_int=True) == 0 for x, y in zip(
                _chunk_leaves(graph.outs[other])[:n_slot], leaves)),
                f"chunk_parity: slot {other}'s bundles or per-frame states "
                f"changed under replay {k + 1} (slot {slot})")
    want = chunk_launches(cfg, C)
    _check(graph.per_replay == eager_counts == want,
           f"chunk_parity: launches a replay {graph.per_replay}, an eager "
           f"chunk {eager_counts}, expected {want}")
    n0 = dict(kernels.LAUNCHES)
    graph.replay(packs[0])
    _check(all(kernels.LAUNCHES[k] - n0[k] == want.get(k, 0)
               for k in n0), "chunk_parity: a replay did not add its "
           "capture's launches")
    device = _replay_device(graph, packs)
    # the same chunk issued eagerly, each wrapper from Python (CUDA events
    # around the call: the host's issue time bounds it)
    device["eager_chunk_ms"] = _time_ms(
        lambda: dt.fused_track_chunk_packed(fr[0], R_wm, manh, state, win,
                                            weights, cfg), reps=5)

    # K37's shared-window mode
    wide = win.expand(C, -1).contiguous()
    shared = _decode_once("shared window, C = 8",
                          lambda: dt._decode(win, cfg, frame=fr[0]),
                          dt.decode_step_inputs_plain(fr[0], win, cfg))
    rep = _decoded(dt._decode(wide, cfg, frame=fr[0]))
    _check(same_bits(shared[:2], rep[:2]) and all(
        _bit_diff(x[0], y[b], as_int=True) == 0
        for x, y in zip(shared[2:], rep[2:]) for b in range(C)),
           "chunk_parity: K37's shared window differs from K37 on the "
           "window repeated C times")
    h, w = fr[0].shape[2:]
    items = sum(t.shape[-1] for t in (rep[2 + 5], rep[2 + 9], rep[2 + 13]))
    n_pl = rep[2 + 13].shape[-1]
    moved = C * 11 * h * w + 4 * (items + n_pl) + items + 8 * n_pl
    k37 = next(k for k in report if k["name"] == "decode_step_inputs")
    # the bound counts every byte from HBM; the chunk's 27 MB fit in L2,
    # so the cold time reads a buffer twice L2's size before each launch
    # (a read leaves clean lines: evicting them costs the launch nothing)
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_shared():
        flush.sum()
        dt._decode(win, cfg, frame=fr[0])

    k37.update(
        ms_shared_c8=_time_ms(lambda: dt._decode(win, cfg, frame=fr[0])),
        ms_repeated_c8=_time_ms(lambda: dt._decode(wide, cfg, frame=fr[0])),
        device_ms_shared_c8_cold_l2=_launch_split(cold_shared,
                                                  match="decode"),
        device_ms_shared_c8_warm_l2=_launch_split(
            lambda: dt._decode(win, cfg, frame=fr[0]), match="decode"),
        bound_ms_shared_c8=_bound(moved, 5 * C * h * w + items + n_pl))
    del flush
    res = {"chunk": C, "slots": graph.slots, "frames": [i0, i0 + C * len(
        packs) - 1], "capture_s": capture_s,
        "launches_per_chunk": graph.per_replay,
        "replays": 2 * graph.slots,
        "bit_equal": ["eager chunk = 8 streaming steps",
                      "replays = eager chain", "every slot kept until its "
                      "next replay", "K37 shared window"],
        **device}
    print("chunk_parity " + json.dumps(res), flush=True)
    return res


def _drive_system(name, seq, frames, cfg, dev):
    """The default System (local mapping and loop closing on, as
    bench.py::_run_slam builds it) of cfg over the frames under
    _pose_calls() (no capture): (slam, its common metrics, the call
    counts), with ATE < ATE_LIMIT_M, 0 lost and every frame's pose held.
    Reports ms per track_rgbd call (median, p95) and sustained
    frames/s."""
    import torch

    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.evaluation.ate import ate_rmse
    from planarslam_tpu_torch.slam.system import System

    n_frames = len(frames)
    slam = System(config=cfg, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t_all = time.perf_counter()
    with _pose_calls() as pc:
        times = _drive(slam, frames, seq.timestamps)
        slam.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    poses = slam.frame_poses_wc()
    _check(poses.shape == (n_frames, 4, 4),
           f"{name}: trajectory shape {poses.shape} != ({n_frames}, 4, 4)")
    _check(bool(np.all(np.isfinite(poses))), f"{name}: non-finite poses")
    ate = ate_rmse(poses[:, :3, 3], seq.poses_wc[:n_frames, :3, 3])
    t_ms = np.asarray(times[1:])
    res = {"ate_rmse_m": ate, "frames": n_frames,
           "keyframes": int(slam.map.n_kf),
           "lost": int(slam.tracker.stats["lost"]),
           "map_points": int(slam.map.pt_valid.sum()),
           "median_ms_per_call": float(np.median(t_ms)),
           "p95_ms_per_call": float(np.percentile(t_ms, 95)),
           "fps_sustained": n_frames / wall,
           "mapping": dict(slam.local_mapper.stats),
           "loops_closed": int(slam.loop_closer.loops_closed),
           "wall_s": wall, "times": times,
           "launches": dict(kernels.LAUNCHES)}
    _check(ate < ATE_LIMIT_M, f"{name}: ATE {ate:.5f} m >= {ATE_LIMIT_M} m")
    _check(res["lost"] == 0, f"{name}: {res['lost']} lost frames")
    return slam, res, pc


def run_streaming_beside(seq, frames, cfg, dev) -> dict:
    """Path 8's System in streaming mode (chunk_size 1, everything else
    as path 8: loop closing on, no captured inputs), over the same
    frames in the same run: what path 8's frame rates are set beside."""
    _, res, _ = _drive_system("path8_streaming", seq, frames, cfg, dev)
    res.pop("times")
    print("path8_streaming " + json.dumps(res), flush=True)
    return res


def run_chunk_path(name, seq, frames, cfg, dev) -> dict:
    """Path 8 (96 frames) or 8b (45): _drive_system in chunked mode
    (chunk_config) over path 2's quantized room frames: a mapping step per
    keyframe after the first; every full chunk and the flush's partial
    one one replay of the captured chunk, which adds chunk_launches a
    replay; K37, K31 and K36 launched only in chunks (the warm-up's eager
    chunk and the replays); no plain function on a card tensor. Reports
    host ms per chunk (its C calls) besides _drive_system's metrics."""
    ccfg = chunk_config(cfg)
    n_frames = len(frames)
    slam, res, pc = _drive_system(name, seq, frames, ccfg, dev)
    times, launches = res.pop("times"), res["launches"]
    graph = slam.tracker._chunk_graph
    _check(graph is not None, f"{name}: no chunk was captured")
    C = CHUNK_SIZE
    # calls 1 .. n - 1 in chunks of C (call 0 initializes)
    per_chunk = [float(np.sum(times[1 + k * C:1 + (k + 1) * C]))
                 for k in range((n_frames - 1) // C)]
    m = slam.map
    res.update(chunk=C, chunk_pipeline_depth=CHUNK_DEPTH,
               replays=graph.replays,
               host_ms_per_chunk_median=float(np.median(per_chunk))
               if per_chunk else None,
               host_ms_per_chunk=per_chunk, **_call_counts(pc))
    print(f"{name} " + json.dumps(res), flush=True)
    steps = res["mapping"]["mapping_steps"]
    _check(steps >= m.n_kf - 1, f"{name}: {steps} mapping steps for "
           f"{m.n_kf} keyframes")
    chunks = -(-(n_frames - 1) // C)
    _check(graph.replays == chunks, f"{name}: {graph.replays} replays for "
           f"{chunks} chunks")
    want = chunk_launches(cfg, C)
    _check(graph.per_replay == want, f"{name}: a replay's launches "
           f"{graph.per_replay}, expected {want}")
    for k in ("decode_step_inputs", "finish_step", "step_prelude"):
        n = (graph.replays + 1) * want[k]
        _check(launches[k] == n, f"{name}: {launches[k]} {k} launches, "
               f"expected {n} ((replays + the warm-up) x {want[k]})")
    for k, n in want.items():
        _check(launches[k] >= (graph.replays + 1) * n,
               f"{name}: {launches[k]} {k} launches, fewer than "
               f"{graph.replays + 1} chunks of {n}")
    _check(pc["plain_calls_on_card"] == 0,
           f"{name}: {pc['plain_calls_on_card']} plain calls with tensors "
           f"on the card")
    return res


def run_h2d_chunks(seq, frames, cfg, dev) -> dict:
    """Host-to-device copies of chunked tracking, counted as run_h2d_copies
    counts a frame's: a tracking-only System in chunked mode warms up over
    H2D_WARMUP_FRAMES frames and the first chunks (the capture), then one
    more chunk and H2D_CHUNKS chunks run under one torch.profiler session,
    each chunk's CHUNK_SIZE calls in a span of its own. Every chunk is
    held to 1 (its frames' packed upload into the replay) + 1 per window
    refresh + 1 per keyframe's packed fuse set."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from planarslam_tpu_torch.slam import device_mapper as dm
    from planarslam_tpu_torch.slam.system import System

    C = CHUNK_SIZE
    slam = System(config=chunk_config(cfg), enable_local_mapping=False,
                  enable_loop_closing=False, device=dev)
    first = 1 + C * (H2D_WARMUP_FRAMES // C + CHUNK_DEPTH + 1)
    for i in range(first):
        slam.track_rgbd(*frames[i], seq.timestamps[i])
    _check(slam.tracker._chunk_graph is not None
           and slam.tracker._chunk_graph.replays > 0,
           "h2d_chunks: no replay during the warm-up")
    tr = slam.tracker
    seen = {"refresh": 0, "fuse_set": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapped

    tr._refresh_window = counting("refresh", tr._refresh_window)
    real_fuse_set = dm.run_fuse_set
    dm.run_fuse_set = counting("fuse_set", real_fuse_set)
    per_chunk = []
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(1 + H2D_CHUNKS):
                seen.update(refresh=0, fuse_set=0)
                time.sleep(H2D_GAP_S)
                i0 = first + k * C
                with record_function(f"h2d_chunk_{k}"):
                    for i in range(i0, i0 + C):
                        slam.track_rgbd(*frames[i], seq.timestamps[i])
                    torch.cuda.synchronize()
                per_chunk.append({"chunk": k, "frames": [i0, i0 + C - 1],
                                  "h2d_copies": 0,
                                  "window_refreshes": seen["refresh"],
                                  "fuse_sets": seen["fuse_set"]})
    finally:
        dm.run_fuse_set = real_fuse_set
    slam.shutdown()
    got = _h2d_by_span(prof.profiler.kineto_results.events(),
                       prof.events(), "h2d_chunk_", "h2d_chunks")
    _check(got["frames"] == [r["chunk"] for r in per_chunk],
           f"h2d_chunks: the profiler kept {len(got['frames'])} of "
           f"{len(per_chunk)} chunk spans")
    for rec in per_chunk:
        rec["h2d_copies"] = got["copies"].get(rec["chunk"], 0)
        rec["asked_by"] = got["asked_by"].get(rec["chunk"], {})
    per_chunk = per_chunk[1:]  # the chunk that absorbed the profiler's start
    for rec in per_chunk:
        limit = 1 + rec["window_refreshes"] + rec["fuse_sets"]
        _check(1 <= rec["h2d_copies"] <= limit,
               f"h2d_chunks: chunk {rec['frames']} made {rec['h2d_copies']} "
               f"host-to-device copies, allowed {limit}: the packed frames, "
               f"{rec['window_refreshes']} window refreshes and "
               f"{rec['fuse_sets']} packed fuse sets ({rec})")
    res = {"chunks": H2D_CHUNKS, "chunk": C,
           "window_refreshes": sum(r["window_refreshes"] for r in per_chunk),
           "fuse_sets": sum(r["fuse_sets"] for r in per_chunk),
           "limit_per_chunk": "1 packed upload + 1 per window refresh + 1 "
                              "per packed fuse set",
           "copies_without_host_op": got["unlinked"],
           "per_chunk": per_chunk}
    print("h2d_chunks " + json.dumps(res), flush=True)
    _check(res["window_refreshes"] >= 1 and res["fuse_sets"] >= 1,
           f"h2d_chunks: the window's or the fuse set's allowance was not "
           f"exercised in {H2D_CHUNKS} chunks")
    return res


def chunk_beside(stream: dict, path8: dict) -> dict:
    """Path 8's frame rates beside run_streaming_beside's (the same
    System and frames with chunk_size 1, in the same run): ms per
    track_rgbd call (median, p95; path 8's calls alternate between
    buffering and a dispatch with its drain) and sustained frames/s."""
    keys = ("median_ms_per_call", "p95_ms_per_call", "fps_sustained")
    out = {"streaming": {k: stream[k] for k in keys},
           "path8_chunked": {k: path8[k] for k in keys
                             + ("host_ms_per_chunk_median",)},
           "fps_ratio": path8["fps_sustained"] / stream["fps_sustained"]}
    print("chunk_beside_streaming " + json.dumps(out), flush=True)
    return out


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

    t_start = t0 = time.perf_counter()
    ptxas = start_ptxas_report(kernels)
    path = kernels.build(verbose=True)
    kernels.cuda_lib()
    kernels.triton_module()
    print(f"build {time.perf_counter() - t0:.1f}s -> {path}", flush=True)
    print(f"ptxas {json.dumps(ptxas_summary(ptxas))}", flush=True)

    cfg = SystemConfig()
    n = max(args.frames, TRACKING_FRAMES, CONSTRUCTED_SEQUENCE)
    seq = synthetic.make_sequence(n, width=cfg.camera.width,
                                  height=cfg.camera.height)
    k11 = pose_kernel_parity(cfg, dev)
    report = (kernel_parity(seq, cfg, dev) + backend_kernel_parity(cfg, dev)
              + ba_kernel_parity(dev) + k11
              + plane_kernel_parity(seq, cfg, dev)
              + manhattan_kernel_parity(seq, cfg, dev)
              + frontend_kernel_parity(seq, cfg, dev)
              + line_kernel_parity(seq, cfg, dev)
              + matching_kernel_parity(seq, cfg, dev)
              + tail_kernel_parity(seq, cfg, dev)
              + decode_kernel_parity(seq, cfg, dev)
              + match_lines_parity(seq, cfg, dev))
    select_stage_parity(dev, next(k for k in report
                                  if k["name"] == "detect_lines"))
    batched_kernel_parity(seq, cfg, dev, report)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(n)]
    # the two calls (obs1, obs2) of path 1's 21st fused frame, and the
    # plane association and tail of its 48th tracking step
    path1 = run_tracking_path("path1_tracking", seq,
                              frames[:TRACKING_FRAMES], cfg, dev, False,
                              capture=POSE_CAPTURE + _tail_capture(48)
                              + PRELUDE_CAPTURE)
    captured = path1.pop("captured")
    _check(all(c in captured for c in POSE_CAPTURE),
           "path1: the pose_optimize inputs of a tracked frame were not "
           "captured")
    pose_frame_parity(k11[0], [captured[c] for c in POSE_CAPTURE])
    tail_frame_parity(report, *_tail_inputs(captured, 48))
    report += prelude_kernel_parity(cfg, dev, captured)
    report += seed_lift_parity(seq, frames, cfg, dev, captured)
    path2 = run_tracking_path("path2_mapping", seq, frames[:args.frames],
                              cfg, dev, True,
                              capture=MAPPING_CAPTURE + CHUNK_CAPTURE)
    captured2 = path2.pop("captured")
    report += line_triangulation_parity(cfg, dev, captured2)
    fuse_set_parity(path2.pop("map"), cfg, dev, captured2)
    chunk_parity(frames, cfg, dev, captured2[CHUNK_CAPTURE[0]], report)
    path8 = run_chunk_path("path8_chunked", seq, frames[:TRACKING_FRAMES],
                           cfg, dev)
    path8b = run_chunk_path("path8b_chunked_partial", seq,
                            frames[:CHUNK_PARTIAL_FRAMES], cfg, dev)
    chunk_beside(run_streaming_beside(seq, frames[:TRACKING_FRAMES], cfg,
                                      dev), path8)
    paths = [
        path1,
        path2,
        path8,
        path8b,
        run_reloc_path(seq, cfg, dev),
        run_unpathed_entries(seq, cfg, dev),
    ]
    path7 = run_two_view_path(seq, cfg, dev)
    report += two_view_parity(dev, path7.pop("captured"))
    paths += [path7, run_loop_path(synthetic.make_sequence(
        LOOP_FRAMES, kind="loop", width=cfg.camera.width,
        height=cfg.camera.height), cfg, dev)]
    path4b = run_constructed_loop_path(seq, cfg, dev)
    captured4b = path4b.pop("captured")
    report += loop_kernel_parity(dev, captured4b)
    report += schur_pose_graph_parity(dev, captured4b)
    del captured4b
    path4c = run_ba_scale_path(dev)
    report += pcg_parity(dev, path4c.pop("problems"))
    paths += [path4b, path4c]
    lane_frames = _lane_frames(max(BATCH_SIZES), BATCH_FRAMES)
    path5 = [run_batched_path(cfg, dev, lane_frames, B,
                              capture=12 if B == BATCH_PARITY else 0)
             for B in BATCH_SIZES]
    batched_step_lane_equality(path5[0].pop("captured"), cfg)
    paths += path5
    run_batched_vo_step(cfg, dev, B=max(BATCH_SIZES))
    run_h2d_copies(seq, frames, cfg, dev)
    run_h2d_chunks(seq, frames, cfg, dev)
    run_h2d_batched(cfg, dev, lane_frames, B=BATCH_PARITY)
    for k in report:
        k["launches"] = sum(p["launches"][k["name"]] for p in paths)
        _check(k["launches"] > 0,
               f"kernel {k['name']} was not launched by the paths")
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
