#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on a GPU.

    python3 tools/port_profile.py [--frames 40] [--warmup 20]
                                  [--tracking-only | --loop-correction
                                   [--repeat N] | --batched B |
                                   --ba-scale [--repeat N]] [--out DIR]
                                  [--root DIR]

--root profiles another checkout's planarslam_tpu_torch (built into its
build/), with this checkout's chip_smoke.py for path 5's sequences.

Tracks the 640x480 synthetic sequence (with --loop-correction path 4b's:
chip_smoke.CONSTRUCTED_SEQUENCE frames, unless --frames is longer) with
System(SystemConfig(), enable_loop_closing=False) (local mapping on; with
--tracking-only also enable_local_mapping=False) and wraps frames
warmup..frames-1 in torch.profiler (CPU + CUDA). With --loop-correction the
default System (loop closing on) tracks the first `warmup` frames, the
constructed loop of chip_smoke.py's path 4b is added to its map, and the
window is that loop's verification and correction (pose graph, fuse,
global BA), counted as one "frame"; --repeat N rebuilds that loop on a
fresh copy of the tracked map and corrects it N times in the process,
each under a profiler session of its own (the first pays the first-call
costs, the later ones do not), and prints one result per correction. The
loop-correction spans split the stall: loop_closing.verify (with
verify_match, verify_ransac, verify_refine, verify_guided_search),
loop_closing.correct (pose_graph.optimize_pose_graph's host spans
pose_graph.build_edges, pose_graph.edge_plan, pose_graph.upload,
pose_graph.gn_steps (pose_graph.optimize inside it) and pose_graph.pull,
loop_closing.reanchor, loop_closing.search_and_fuse with its device call
fuse_search and host merge fuse_merge, global_ba.global_bundle_adjustment
with global_ba.build_tables and each global_ba.ba_solve, and inside each
LM step ba_core.plane_blocks, ba_core.schur_complement (K40),
ba_core.reduced_system, ba_core.cholesky and ba_core.cost_test); the
kernel table keys K40 and K41 give their device ms per correction).
Prints, for each stage span (the
record_function names of the port's stage functions, among them
device_mapper.mapping_step, local_mapping.finish_keyframe,
tracking.relocalize, loop_closing.process_keyframe, pose_graph.optimize,
global_ba.global_bundle_adjustment and local_ba.local_bundle_adjustment,
the fused step's device_tracker.decode_step_inputs (K37; unpack_window
before) and device_tracker.step_prelude (K36), and the spans of K28-K31's
wrappers:
planes.extract_planes (K28 in it), planes.frame_normals (K29; box_smooth_depth, backproject_depth and
surface_normals before), device_tracker._associate_planes_device (K30;
with plane_observations before) and device_tracker.finish_step (K31;
keyframe_stats, _pack and _state_from before)),
the host time and the device time of its kernels, the busy share of the
device over the window, the device time and launches of each
hand-written kernel per frame (K1-K50, `port_kernels_ms_per_frame`; their
share of the busy time, and every other device event by name), the
host-to-device copies per frame, the device time of each launch of K17
and K18 apart (`port_launches_per_frame`: by kernel name and grid, so
K17's 7-tap pyramid blur apart from its 5-tap frame blur), the device
time of each of K25's launches by call site (`port_sites_per_frame`: the
frame search, match_descriptors, the window search, other), and the top
kernels by device time.
Writes the chrome trace to DIR/port_trace.json when --out is given.

With --ba-scale, path 4c's PCG solve (chip_smoke.py's 256-keyframe orbit,
ba_solve_pcg with 12 LM steps of 48 CG steps) runs once to warm up, three
times unprofiled (their walls), then --repeat N times, each under a
profiler session of its own: per solve its
wall, and per LM step its host ms (the span ba_pcg.lm_step where the tree
has it, else the wall over the steps), device busy ms and device events,
the device ms and launches of each hand-written kernel, and the top
kernels.

With --batched B, BatchedSLAM(SystemConfig(), B) replays chip_smoke.py's
path 5 sequences (one per lane, quantized) and the window is batched steps
warmup..frames-1, each counted as one "frame" of B lanes: it prints the
same per-step numbers (launches, device busy share, host-to-device copies,
spans), and host ms per step in each span of BatchedSLAM.track
(host_lanes: the lanes on their own host path; frame_upload;
small_upload; state_win_insert: window refreshes and lane inserts;
dispatch: the batched step's launches; drain: the previous step's pull and
the lanes' host policy).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# the repository root, so that the port (and chip_smoke.py) import when run
# as a script
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# modules whose stage functions carry record_function("<module>.<function>")
SPAN_MODULES = ("frontend", "lines", "planes", "manhattan", "matching",
                "pose_opt", "device_tracker", "device_mapper",
                "local_mapping", "tracking", "loop_closing", "pose_graph",
                "global_ba", "local_ba", "ba_core", "ba_pcg")
# the hand-written kernels by number and name, each with the entry names
# (substrings of the trace's kernel names) of its launches; a trace kernel
# counts for the first kernel whose entry name it holds
PORT_KERNELS = {
    "K1 fast_score": ("fast_score_levels_kernel",),
    "K2 orb_describe": ("orb_describe_levels_kernel",),
    "K3 gated_hamming_top2": ("hamming_top2_kernel",),
    "K4 plane_block_moments": ("_plane_block_moments_kernel",),
    "K5 triangulate_two_view": ("triangulate_kernel",),
    "K6 horn_align_batch": ("horn_align_kernel",),
    "K7 pnp_dlt_hypotheses": ("pnp_dlt_kernel",),
    "K8 ba_normal_eqs": ("normal_eqs_",),
    "K9 ba_schur_eliminate": ("schur_",),
    "K10 pose_graph_normal_eqs": ("pose_graph_",),
    "K11 pose_optimize": ("pose_opt_kernel",),
    "K12 plane_components": ("plane_components_kernel",
                             "plane_fits_kernel"),
    "K13 plane_assign_refit": ("plane_assign_", "plane_refit_kernel"),
    "K14 plane_label_pixels": ("plane_label_kernel",),
    "K15 manhattan_mean_shift": ("manhattan_kernel",),
    "K16 pyramid_resize": ("pyramid_cone_kernel",),
    "K17 gaussian_blur": ("gaussian_blur_kernel",),
    "K18 select_keypoints": ("select_tiles_kernel", "select_rank_kernel"),
    "K19 point_epilogue": ("point_epilogue_kernel",),
    "K20 detect_lines": ("lines_stencil_kernel", "lines_compact_kernel",
                         "lines_select_kernel", "lines_count_rank_kernel",
                         "lines_slot_kernel", "lines_peaks_kernel",
                         "lines_segment_kernel", "lines_rank_kernel"),
    "K21 line_descriptors": ("lines_descriptor_kernel",),
    "K22 lift_lines_3d": ("lines_lift_kernel",),
    "K23 search_lines_by_projection": ("lines_search_cluster_kernel",
                                       "lines_search_rows_kernel",
                                       "lines_search_gate_kernel"),
    "K24 project_landmarks": ("project_landmarks_kernel",),
    "K25 match_select": ("match_select_kernel",),
    "K26 frame_match_select": ("frame_matches_kernel",),
    "K27 assemble_observations": ("assemble_observations_kernel",),
    "K28 noise_alpha": ("noise_alpha_kernel",),
    "K29 frame_normals": ("frame_normals_strided_kernel",
                          "frame_normals_full_kernel"),
    "K30 associate_planes": ("associate_planes_kernel",),
    "K31 finish_step": ("finish_step_kernel",),
    "K32 refine_relative": ("refine_relative_kernel",),
    "K33 ba_plane_blocks": ("plane_kf_kernel", "plane_lm_kernel",
                            "mu_p_kernel"),
    "K34 ba_cost_test": ("cost_obs_kernel", "cost_decide_kernel",
                         "cost_select_kernel"),
    "K35 ba_reduced_system": ("reduced_system_kernel",),
    "K36 step_prelude": ("step_prelude_kernel",),
    "K37 decode_step_inputs": ("decode_step_kernel",),
    "K38 lift_state": ("lift_state_kernel",),
    "K39 seed_manhattan": ("seed_manhattan_kernel",),
    "K40 ba_schur_complement": ("camera_complement_kernel",),
    "K41 pose_graph_update": ("pose_update_kernel",),
    "K42 triangulate_lines": ("triangulate_lines_kernel",),
    "K43 pcg_prepare": ("pcg_prepare_kernel",),
    "K44 pcg_schur_matvec": ("pcg_landmark_kernel", "pcg_keyframe_kernel"),
    "K45 pcg_cg_update": ("pcg_cg_kernel",),
    "K46 pnp_select": ("pnp_select_kernel",),
    "K47 match_lines": ("match_lines_kernel",),
    "K48 two_view_hypotheses": ("two_view_hypotheses_kernel",),
    "K49 two_view_select": ("two_view_select_kernel",),
    "K50 triangulate_dlt": ("triangulate_dlt_kernel",
                            "reprojection_checks_kernel"),
}


# kernels whose launches are also reported one by one, by kernel name and
# grid (`port_launches_per_frame`): K17's 7-tap pyramid blur and 5-tap
# frame blur, K18's tiles and rank
SPLIT_KERNELS = ("K17 gaussian_blur", "K18 select_keypoints")


def port_kernel(trace_name: str):
    """The PORT_KERNELS key a trace kernel belongs to, or None."""
    for key, entries in PORT_KERNELS.items():
        if any(e in trace_name for e in entries):
            return key
    return None


# kernels whose launches are also reported by call site
# (`port_sites_per_frame`): the span that issued each launch, K25's
# searches told apart by the launch after them (match_descriptors' follows
# the frame search, not the window search)
SITE_KERNELS = ("K25 match_select",)
SITE_SPANS = ("matching.search_by_projection", "matching.match_descriptors")


def trace_events(prof) -> list:
    """The profile's chrome trace events (written to build/port_profile/
    and removed)."""
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "port_profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"split_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def site_split(events, n: int) -> dict:
    """Device ms and launches per frame of SITE_KERNELS' launches by call
    site: the innermost SITE_SPANS span around the host call that launched
    each (its correlation id); "frame_search", "window_search",
    "match_descriptors", or "other" outside them."""
    launched, spans, kern = {}, [], []
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "cuda_runtime" and "LaunchKernel" in e.get("name", ""):
            launched[args.get("correlation")] = e["ts"]
        elif cat in ("user_annotation", "cpu_op") and e.get(
                "name") in SITE_SPANS:
            spans.append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif cat == "kernel" and port_kernel(e["name"]) in SITE_KERNELS:
            kern.append(e)
    kern.sort(key=lambda e: e["ts"])
    sites = []
    for e in kern:
        t = launched.get(e.get("args", {}).get("correlation"))
        around = [sp for sp in spans if t is not None and sp[0] <= t <= sp[1]]
        sites.append(min(around, key=lambda sp: sp[1] - sp[0])[2]
                     if around else "other")
    out = {}
    for i, (e, site) in enumerate(zip(kern, sites)):
        if site == "matching.search_by_projection":
            after = sites[i + 1] if i + 1 < len(sites) else None
            site = ("frame_search" if after == "matching.match_descriptors"
                    else "window_search")
        elif site == "matching.match_descriptors":
            site = "match_descriptors"
        key = f"{port_kernel(e['name'])} {site}"
        rec = out.setdefault(key, {"ms_per_frame": 0.0,
                                   "launches_per_frame": 0.0})
        rec["ms_per_frame"] += e["dur"] / n / 1e3
        rec["launches_per_frame"] += 1.0 / n
    return out


def launch_split(events, n: int) -> dict:
    """Device ms and launches per frame of each launch of SPLIT_KERNELS,
    keyed "<kernel name> grid <x>x<y>", from the profile's chrome trace
    events."""
    split = {}
    for e in events:
        if e.get("cat") != "kernel" or port_kernel(e["name"]) not in (
                SPLIT_KERNELS):
            continue
        name = e["name"].replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")
        grid = e.get("args", {}).get("grid", [0, 0, 0])
        key = f"{name} grid {grid[0]}x{grid[1]}"
        rec = split.setdefault(key, {"ms_per_frame": 0.0,
                                     "launches_per_frame": 0.0})
        rec["ms_per_frame"] += e["dur"] / n / 1e3
        rec["launches_per_frame"] += 1.0 / n
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--tracking-only", action="store_true",
                    help="local mapping off (the tracking path alone)")
    ap.add_argument("--loop-correction", action="store_true",
                    help="profile one constructed loop's verification and "
                    "correction after `warmup` tracked frames")
    ap.add_argument("--repeat", type=int, default=1,
                    help="with --loop-correction: corrections of the "
                    "constructed loop, each on a fresh copy of the map")
    ap.add_argument("--batched", type=int, default=0, metavar="B",
                    help="profile batched steps of B lanes (path 5)")
    ap.add_argument("--ba-scale", action="store_true",
                    help="profile path 4c's 256-keyframe PCG solve")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose planarslam_tpu_torch is "
                    "profiled (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 1
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System

    print(f"root {os.path.dirname(os.path.dirname(kernels.__file__))}",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"device {smi.stdout.strip()}", flush=True)
    kernels.build()
    cfg = SystemConfig()
    if args.ba_scale:
        _profile_ba_scale(args)
        return 0
    if args.batched:
        _profile_batched(args, cfg)
        return 0
    n_seq = args.frames
    if args.loop_correction:
        from chip_smoke import CONSTRUCTED_SEQUENCE

        n_seq = max(n_seq, CONSTRUCTED_SEQUENCE)
    seq = synthetic.make_sequence(n_seq, width=cfg.camera.width,
                                  height=cfg.camera.height)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(args.frames)]
    slam = System(config=cfg, enable_local_mapping=not args.tracking_only,
                  enable_loop_closing=args.loop_correction, device="cuda")
    for i in range(args.warmup):
        slam.track_rgbd(*frames[i], seq.timestamps[i])
    runs, loop_kf = 1, None
    if args.loop_correction:
        import copy

        from chip_smoke import construct_loop

        slam.shutdown()
        base_map = slam.map
        runs = args.repeat
    for r in range(runs):
        if args.loop_correction:
            # a fresh copy of the tracked map for every correction
            slam.map = slam.loop_closer.map = copy.deepcopy(base_map)
            loop_kf, _, _ = construct_loop(slam.map)
        torch.cuda.synchronize()
        _profile_window(args, slam, frames, seq, r, loop_kf)
    return 0


def _profile_batched(args, cfg) -> None:
    """Profile batched steps warmup..frames-1 of BatchedSLAM(cfg, B) on
    path 5's sequences, with BatchedSLAM.track's host spans."""
    from chip_smoke import BATCH_SEQUENCE, _lane_sequence
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.parallel.replay import BatchedSLAM

    B = args.batched
    factor = cfg.camera.depth_map_factor
    seqs = [_lane_sequence(cfg, b, max(args.frames, BATCH_SEQUENCE))
            for b in range(B)]
    frames = [[quantize_frame(*s.render(i), factor)
               for i in range(args.frames)] for s in seqs]
    bs = BatchedSLAM(cfg, B, device="cuda")

    def track(i):
        bs.track([frames[b][i][0] for b in range(B)],
                 [frames[b][i][1] for b in range(B)],
                 np.full(B, float(i) / 30.0))

    for i in range(args.warmup):
        track(i)
    bs.enable_profile()
    steps0 = bs.stats["batched_steps"]
    out = _profile_window(args, bs, frames, None, 0, None, step=track)
    steps = bs.stats["batched_steps"] - steps0
    out["batched"] = {
        "lanes": B, "batched_steps": steps,
        "host_ms_per_step": {k: float(np.sum(v)) / max(steps, 1) * 1e3
                             for k, v in bs.prof.items()},
        **{k: v for k, v in bs.stats.items()}}
    print(json.dumps(out["batched"], indent=1), flush=True)


def _profile_ba_scale(args) -> None:
    """Profile path 4c's PCG solve on the 256-keyframe orbit (after one
    warm-up solve), --repeat times."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from planarslam_tpu_torch.solvers.ba_pcg import ba_solve_pcg

    # this checkout's chip_smoke.py (path 4c's orbit), whatever the root
    spec = importlib.util.spec_from_file_location(
        "port_profile_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    PCG_N_CG, PCG_N_ITERS = smoke.PCG_N_CG, smoke.PCG_N_ITERS
    _orbit_problem = smoke._orbit_problem
    rng = np.random.default_rng(42)
    _orbit_problem(rng, 96, 1024, 48, "cuda")  # path 4c's dense orbit first
    _, _, pargs, _ = _orbit_problem(rng, 256, 1024, 24, "cuda")

    def solve():
        poses = ba_solve_pcg(*pargs, n_iters=PCG_N_ITERS, n_cg=PCG_N_CG)[0]
        torch.cuda.synchronize()
        return poses

    solve()
    walls = []
    for _ in range(3):  # unprofiled, host clock around solve and sync
        t0 = time.perf_counter()
        solve()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"ba_scale_wall_s_unprofiled": walls}), flush=True)
    n = PCG_N_ITERS
    for run in range(args.repeat):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            poses = solve()
            wall = time.perf_counter() - t0
        events = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)

        kern = sorted(((dev_us(e), e.key, e.count) for e in events
                       if "CUDA" in str(e.device_type) and dev_us(e) > 0
                       and e.key.split(".")[0] not in SPAN_MODULES),
                      reverse=True)
        busy_ms = sum(k[0] for k in kern) / 1e3
        launches = sum(k[2] for k in kern)
        steps = [e for e in events if e.key == "ba_pcg.lm_step"
                 and "CUDA" not in str(e.device_type)]
        host_ms = (steps[0].cpu_time_total / 1e3 / n if steps
                   else wall * 1e3 / n)
        port = {}
        for us, name, count in kern:
            key = port_kernel(name)
            if key is not None:
                rec = port.setdefault(key, {"ms_per_lm_step": 0.0,
                                            "launches_per_lm_step": 0.0})
                rec["ms_per_lm_step"] += us / n / 1e3
                rec["launches_per_lm_step"] += count / n
        out = {"ba_scale": "path4c pcg, 256 keyframes", "run": run,
               "lm_steps": n, "cg_steps": PCG_N_CG, "wall_s": wall,
               "host_ms_per_lm_step": host_ms,
               "host_ms_from": "span ba_pcg.lm_step" if steps else "wall",
               "device_busy_ms_per_lm_step": busy_ms / n,
               "device_busy_share": busy_ms / (wall * 1e3),
               "device_events_per_lm_step": launches / n,
               "device_events_per_solve": launches,
               "finite": bool(torch.isfinite(poses).all()),
               "port_kernels_per_lm_step": port,
               "top_kernels": [{"name": k[1][:80],
                                "ms_per_lm_step": k[0] / n / 1e3,
                                "calls_per_lm_step": k[2] / n}
                               for k in kern[:20]]}
        print(json.dumps(out, indent=1), flush=True)


def _profile_window(args, slam, frames, seq, run: int, loop_kf,
                    step=None) -> dict:
    """Profile one window (the tracked frames, or the correction of the
    loop that keyframe loop_kf closes) and print its JSON result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def n_kf():
        systems = getattr(slam, "systems", [slam])
        return sum(int(s.map.n_kf) for s in systems)

    n_kf0 = n_kf()
    n = 1 if args.loop_correction else args.frames - args.warmup
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.loop_correction:
            ok = slam.loop_closer._verify_and_correct(loop_kf, 0)
        elif step is not None:
            for i in range(args.warmup, args.frames):
                step(i)
        else:
            for i in range(args.warmup, args.frames):
                slam.track_rgbd(*frames[i], seq.timestamps[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    events_trace = trace_events(prof)

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    def self_dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    def is_span(e):
        return e.key.split(".")[0] in SPAN_MODULES

    def on_device(e):
        return "CUDA" in str(e.device_type)

    # A record_function span shows up twice: as a host event, whose device
    # time is that of the kernels it launched, and as a device-side
    # annotation covering its whole wall interval. Only the host event is a
    # span, and the annotation is no kernel.
    spans = {e.key: {"calls_per_frame": e.count / n,
                     "host_ms_per_frame": e.cpu_time_total / n / 1e3,
                     "device_ms_per_frame": dev_us(e) / n / 1e3}
             for e in events if is_span(e) and not on_device(e)}
    kern = sorted(((self_dev_us(e), e.key, e.count) for e in events
                   if on_device(e) and not is_span(e)
                   and self_dev_us(e) > 0), reverse=True)
    busy_ms = sum(k[0] for k in kern) / 1e3
    n_kernels = sum(k[2] for k in kern)
    # device time and launches of each hand-written kernel, and of every
    # other device event (PyTorch's own kernels, copies, memsets)
    port_kernels = {key: 0.0 for key in PORT_KERNELS}
    port_launches = {key: 0.0 for key in PORT_KERNELS}
    other = []
    for us, name, count in kern:
        key = port_kernel(name)
        if key is None:
            other.append({"name": name[:80], "ms_per_frame": us / n / 1e3,
                          "calls_per_frame": count / n})
        else:
            port_kernels[key] += us / n / 1e3
            port_launches[key] += count / n
    out = {"frames": n, "local_mapping": not args.tracking_only,
           "batched": args.batched,
           "loop_correction": args.loop_correction, "run": run,
           "keyframes_in_window": n_kf() - n_kf0,
           "wall_ms_per_frame": wall / n * 1e3,
           **({"verified": bool(ok)} if args.loop_correction else {}),
           "device_busy_ms_per_frame": busy_ms / n,
           "device_busy_share": busy_ms / (wall * 1e3),
           "kernel_launches_per_frame": n_kernels / n,
           "h2d_copies_per_frame": sum(
               k[2] for k in kern if "Memcpy HtoD" in k[1]) / n,
           "port_kernels_ms_per_frame": port_kernels,
           "port_kernels_launches_per_frame": port_launches,
           "port_kernels_share_of_busy": sum(port_kernels.values())
           / max(busy_ms / n, 1e-12),
           "port_launches_per_frame": launch_split(events_trace, n),
           "port_sites_per_frame": site_split(events_trace, n),
           "other_kernels": other,
           "spans": spans,
           "top_kernels": [{"name": k[1][:80], "ms_per_frame": k[0] / n / 1e3,
                            "calls_per_frame": k[2] / n} for k in kern[:25]]}
    print(json.dumps(out, indent=1), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, f"port_trace_{run}.json" if run else "port_trace.json"))
    return out


if __name__ == "__main__":
    sys.exit(main())
