#!/usr/bin/env python3
"""Time K1 (fast_score), K3 (gated_hamming_top2), K11 (pose_optimize),
K12 (plane_components), K13 (plane_assign_refit), K15
(manhattan_mean_shift), K16 (pyramid_resize), K17 (gaussian_blur), K18
(select_keypoints), K20 (detect_lines), K22 (lift_lines_3d), K23
(search_lines_by_projection), K25 (match_select), K26
(frame_match_select), K28 (noise_alpha), K29 (frame_normals), K30
(associate_planes), K31 (finish_step), K40 (ba_schur_complement), the
pose graph's step (K10, K41), K42 (triangulate_lines) and K43-K45
(pcg_prepare, pcg_schur_matvec, pcg_cg_update), K14 (plane_label_pixels),
K27 (assemble_observations), K2 (orb_describe) and K36 (step_prelude) of
one tree of the port on a GPU, so that two trees can be compared in one
run.

    python3 tools/kernel_timing.py [--root DIR] [--only NAME,...]

--root is the checkout whose planarslam_tpu_torch is timed (default: this
one); its kernels are built into DIR/build/. The problems and the timing
come from this checkout's chip_smoke.py, whatever the root: K3 on the
launches of one tracking step (`hamming_step_problems`: the frame search,
the window search, match_descriptors' two directions, one launch or two
as the tree has them) and on the window search at B = 4, each timed by
`kernel_timing_entry` (per wrapper call, device time and launches per
call), with their device time per tracking step; K11 on `pose_problem`
from its usual start, from the true pose ("converged") and from 0.1 rad /
0.1 m off ("far"), timed by `pose_timing` (per call, device time, per LM
step); K12 on frame 0's block moments at B = 1 and on eight lanes' at B =
8 (`components_problems`); K15 on frame 0's normals and line directions
with the tracking cone at B = 1 and 4 (`manhattan_problems`); K20 on
frame 0 of the 640x480 synthetic room after its 5-tap blur, timed by
`detect_timing` (per call, device time by launch); K29 on frame 0's depth
at B = 1 and on frames 0-3 at B = 4 (`normals_problems`); K28 on frame
0's depth clean and with Kinect noise and on frames 0-3 at B = 4
(`alpha_problems`); K13 on extract_planes' 1 + refine_rounds rounds from
K12's candidates, frame 0 at B = 1 and frames 0-3 at B = 4
(`refit_problems`: per call the three rounds, their launches and device
time); K1 on frame 0's 8-level pyramid at B = 1 and frames 0-3's at B =
4 (`fast_problems`); K17 at 7 taps on frame 0's 8-level pyramid at B = 1
and frames 0-3's at B = 4, and the line stage's 5-tap blur of frame 0
and of frames 0-3 (`blur_problems`); K18 on frame 0's FAST scores at B =
1 and frames 0-3's at B = 4, and on the planted map of PLANTED_LEVELS
(`select_problems`; device time by launch: the tiles and the rank); K23
on the tracking window (M = 256) at B = 1 and seen from four frames at B
= 4, on 4096 lines, with no candidate and with fewer than 6 earned
(`line_search_problems`); K16 on frame 0 at B = 1, frames 0-3 at B = 4,
a 1280x960 frame and a 64x48 one (`pyramid_problems`); K30 on path 1's
48th tracking step clean and noisy, every PLANE_CASES problem and those
steps at B = 4 (`assoc_problems`), with the valid frame and map planes
and the points K30 walks over path 1's first 48 steps (`plane_stats`);
K22 on frame 0's segments over its clean and its noisy depth, frames 0-3
at B = 4 and every planted LIFT_CASES frame alone and at B = 4
(`lift_problems`), with the valid line slots and those lifted on path 1's
frames (`lift_stats`); K25 on the three launches of one tracking step on
`hamming_step_problems`' K3 outputs (the frame search, the window search,
match_descriptors), the window search at B = 4 and every planted
SELECT_PLANTED problem alone and at B = 4 (`match_select_problems`), with
its device time per tracking step; K26 on one tracking step's launch (the
frame search's matches through K25, match_descriptors' as the brute-force
ones), the same with the projection matches cut to 10, the filter mode,
the step's problem four times in one launch and every planted
FRAME_PLANTED problem alone and (frame mode) at B = 4
(`frame_match_problems`); K31 on path 1's 48th tracking step, steps 45-48
in one launch, the two random tails and every planted TAIL_PLANTED problem
alone and at B = 4 (`finish_step_problems`); K40 (ba_schur_complement)
on path 4b's first global BA step (`loop_capture`: path 4b's tracking and
correction), path 4c's dense orbit at its start and four planted lanes at
B = 4, beside the dense torch.matmul of each step, every device launch of
it (`schur_problems`; a tree without K40 times the matmuls alone); under
`pose_graph`, path 4b's pose graph: _optimize with one and two
Gauss-Newton steps (every device launch), K10 without and with the gauge
diagonal and K41 on its first step (`pose_graph_problems`); K42
(triangulate_lines) on the planted random, tied, NaN and parallax-edge
mapping steps alone and the four in one launch (`line_tri_problems`; a
tree without K42 times its plain line triangulation); K43-K45 on path
4c's 256-keyframe orbit at its first LM step: K43, K44's product and
back-substitution, K45's init and update (`pcg_problems`; a tree without
them has none); K27 on both launches of path 1's 48th tracking step,
steps 45-48 at B = 4 and every ASSEMBLE_PLANTED problem alone and at B =
4 (`assemble_problems`), K14 on path 1's 48th frame, frames 45-48 at B =
4 and every LABEL_PLANTED problem (1280x960 and 643x481 among them) at
refine_stride 2 and 1, alone and at B = 4 (`label_problems`), K2 on path
1's 48th frame, frames 45-48 at B = 4, frames 41-48 in one launch as
chunked mode's front end makes it (C = 8) and every ORB_PLANTED problem
alone and at B = 4 (`orb_problems`), K36 on path 1's 48th step, steps
45-48 at B = 4 and planted lanes at every PRELUDE_WIDTHS alone and at B =
4 (`prelude_problems`), all four on the inputs `step_kernel_inputs`
captures once. K1, K2, K3, K12, K13, K14, K15, K16, K17, K18, K22, K23,
K25, K26, K27, K28, K29, K30, K31, K36, K40, K10, K41 and K42-K45 are
timed by `kernel_timing_entry`.
--only times the named kernels alone (their keys in the output, e.g.
`lift_lines_3d,match_select`). Prints one JSON
object with the card's name and power limit, those times and a hash of
each output, so that two trees' outputs can be compared bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (the problems, the timing helpers)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_timing_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(obj) -> str:
    h = hashlib.sha256()
    for t in obj:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default="",
                    help="comma-separated output keys to time alone")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    only = set(filter(None, args.only.split(",")))

    def wanted(key: str) -> bool:
        return not only or key in only

    smoke = _smoke()
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.ops import image
    from planarslam_tpu_torch.ops import lines as ln
    from planarslam_tpu_torch.solvers import pose_opt

    assert kernels.__file__.startswith(root), kernels.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    kernels.build()
    dev = torch.device("cuda", 0)
    cfg = SystemConfig()
    cam = cfg.camera
    out = {"root": root, "device": smi.stdout.strip(),
           "torch": torch.__version__}
    if wanted("pose_optimize"):
        out["pose_optimize"] = {}
        for start in ("near", "converged", "far"):
            pargs, kw = smoke.pose_problem(cfg, dev, start)
            out["pose_optimize"][start] = {
                "hash": _digest(pose_opt.pose_optimize(*pargs, **kw)),
                **smoke.pose_timing(pargs, kw)}

    seq = synthetic.make_sequence(smoke.TRACKING_FRAMES, width=cam.width,
                                  height=cam.height)
    for key, problems, match in (
            ("gated_hamming_top2", smoke.hamming_step_problems,
             "hamming_top2"),
            ("match_select", smoke.match_select_problems, "match_select")):
        if not wanted(key):
            continue
        rec = {name: {"hash": _digest(fn()),
                      **smoke.kernel_timing_entry(fn, match)}
               for name, fn in problems(seq, cfg, dev).items()}
        rec["device_ms_per_step"] = sum(rec[n]["device_ms"] for n in (
            "frame", "window", "descriptors"))
        out[key] = rec
    if wanted("plane_components"):
        out["plane_components"] = {
            name: {"hash": _digest(fn()),
                   **smoke.kernel_timing_entry(fn, "plane_")}
            for name, fn in smoke.components_problems(seq, cfg, dev).items()}

    step_keys = ("assemble_observations", "plane_label_pixels",
                 "orb_describe", "step_prelude")
    if any(wanted(k) for k in step_keys):
        step_inputs = smoke.step_kernel_inputs(seq, cfg, dev)
    for key, problems, match in (
            ("assemble_observations", smoke.assemble_problems,
             "assemble_observations"),
            ("plane_label_pixels", smoke.label_problems, "plane_label"),
            ("orb_describe", smoke.orb_problems, "orb_describe"),
            ("step_prelude", smoke.prelude_problems, "step_prelude")):
        if wanted(key):
            out[key] = {name: {"hash": _digest(fn()),
                               **smoke.kernel_timing_entry(fn, match)}
                        for name, fn in problems(seq, cfg, dev,
                                                 step_inputs).items()}
    for key, problems, match in (
            ("manhattan_mean_shift", smoke.manhattan_problems, "manhattan"),
            ("frame_normals", smoke.normals_problems, "frame_normals"),
            ("noise_alpha", smoke.alpha_problems, "noise_alpha"),
            ("plane_assign_refit", smoke.refit_problems, "plane_"),
            ("fast_score", smoke.fast_problems, "fast_score"),
            ("gaussian_blur", smoke.blur_problems, "gaussian_blur"),
            ("select_keypoints", smoke.select_problems, "select_"),
            ("search_lines_by_projection", smoke.line_search_problems,
             "lines_search"),
            ("pyramid_resize", smoke.pyramid_problems, "pyramid_"),
            ("lift_lines_3d", smoke.lift_problems, "lines_lift"),
            ("frame_match_select", smoke.frame_match_problems,
             "frame_matches"),
            ("finish_step", smoke.finish_step_problems, "finish_step")):
        if wanted(key):
            out[key] = {name: {"hash": _digest(fn()),
                               **smoke.kernel_timing_entry(fn, match)}
                        for name, fn in problems(seq, cfg, dev).items()}
    if wanted("lift_lines_3d"):
        out["lift_lines_3d"]["path1_frames"] = smoke.lift_stats(seq, cfg,
                                                                dev)
    if wanted("associate_planes"):
        assoc = smoke.assoc_inputs(seq, cfg, dev)
        out["associate_planes"] = {
            name: {"hash": _digest(fn()),
                   **smoke.kernel_timing_entry(fn, "associate_planes")}
            for name, fn in smoke.assoc_problems(seq, cfg, dev,
                                                 assoc).items()}
        steps = [smoke.plane_stats(a) for a in assoc["clean"]]
        out["associate_planes"]["path1_steps"] = {
            k: {"min": min(s[k] for s in steps),
                "median": float(np.median([s[k] for s in steps])),
                "max": max(s[k] for s in steps), f"step{smoke.ASSOC_STEP}":
                steps[-1][k]} for k in steps[0]}
    if wanted("ba_schur_complement") or wanted("pose_graph"):
        captured = smoke.loop_capture(seq, cfg, dev)
    if wanted("ba_schur_complement"):
        out["ba_schur_complement"] = {
            name: {"hash": _digest(fn()), **smoke.kernel_timing_entry(
                fn, "" if name.endswith("_matmul") else "camera_complement")}
            for name, fn in smoke.schur_problems(captured, dev).items()}
    if wanted("pose_graph"):
        match = {"normal_eqs": "pose_graph_", "normal_eqs_gauge":
                 "pose_graph_", "update": "pose_update"}
        out["pose_graph"] = {
            name: {"hash": _digest(fn()),
                   **smoke.kernel_timing_entry(fn, match.get(name, ""))}
            for name, fn in smoke.pose_graph_problems(captured,
                                                      dev).items()}
    if wanted("triangulate_lines"):
        from planarslam_tpu_torch.slam import device_mapper

        # a tree without K42: every device launch of its plain version
        match = ("triangulate_lines" if hasattr(device_mapper,
                                                "triangulate_lines") else "")
        out["triangulate_lines"] = {
            name: {"hash": _digest(fn()),
                   **smoke.kernel_timing_entry(fn, match)}
            for name, fn in smoke.line_tri_problems(cfg, dev).items()}
    for key, match in (("pcg_prepare", "pcg_prepare"),
                       ("pcg_schur_matvec", "pcg_"),
                       ("pcg_cg_update", "pcg_cg")):
        if wanted(key):
            out[key] = {name: {"hash": _digest(fn()),
                               **smoke.kernel_timing_entry(fn, match)}
                        for name, fn in smoke.pcg_problems(dev).get(
                            key, {}).items()}
    if wanted("detect_lines"):
        g8, _ = quantize_frame(*seq.render(0), cam.depth_map_factor)
        gray = torch.from_numpy(g8.astype(np.float32)).to(dev)
        blurred = image.gaussian_blur(gray, 5, 1.0)[None]
        out["detect_lines"] = {
            "hash": _digest(ln.detect_lines(blurred, cfg.lines)),
            "launches_per_call": ln.DETECT_LAUNCHES,
            **smoke.detect_timing(blurred, cfg.lines)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
