#!/usr/bin/env python3
"""Profile the two RANSACs of one tree of the port on a GPU, so that two
trees can be compared in one run.

    python3 tools/ransac_profile.py [--root DIR] [--reps 20]

--root is the checkout whose planarslam_tpu_torch is profiled (default:
this one); its kernels are built into DIR/build/. The problems and the
paths come from this checkout's chip_smoke.py, whatever the root:
- path 3 (`chip_smoke._reloc_run`: a System with a keyframe every 4 frames
  tracks to a mature map, loses tracking, relocalizes on a revisit with
  depth by `horn_ransac_se3`, loses again and revisits a frame without
  depth, `pnp_ransac`), with the wall of each revisit (host clock around
  its `track_rgbd`) and its position error;
- path 4b's verification (`chip_smoke.construct_loop` on the map of the
  room's first 48 frames, then `LoopClosing._verify_and_correct`), its
  `horn_ransac_se3` calls.
Every RANSAC call of those runs is captured with its arguments and replayed
alone: its wall (host clock around the call, median of --reps), and under
torch.profiler its device events (kernels, copies, memsets), their device
time, and the host ops it issues (aten:: events, all and outermost). K7's
and K6's device time per launch on chip_smoke's K7 and K6 problems come
from `chip_smoke._launch_split`, and, where the tree has them, those of
K6's triplet, refit and scale modes on the K6 problem, K46 on K7's
outputs and K47 on chip_smoke's planted "mad_shift" problem (64 lines a
frame) at B = 1 and four MATCH_PLANTED problems at B = 4. Prints one JSON object with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (the paths, the problems)."""
    spec = importlib.util.spec_from_file_location(
        "ransac_profile_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(calls: list):
    """Swap pnp.pnp_ransac and sim3_solver.horn_ransac_se3 (where their
    callers look them up at the call) for recorders of their arguments;
    returns the undo."""
    from planarslam_tpu_torch.solvers import pnp, sim3_solver

    kept = []
    for mod, name in ((pnp, "pnp_ransac"), (sim3_solver, "horn_ransac_se3")):
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, _fn, args, kw))
            return _fn(*args, **kw)
        kept.append((mod, name, fn))
        setattr(mod, name, rec)

    def undo():
        for mod, name, fn in kept:
            setattr(mod, name, fn)
    return undo


def _profile_call(fn, args, kw, reps: int) -> dict:
    """One RANSAC call replayed: wall (median of reps, host clock around
    the call and a synchronize), then one call under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*args, **kw)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args, **kw)
        torch.cuda.synchronize()
    kinds, device_us, host_ops, outer_ops = {}, 0.0, 0, 0
    for e in prof.events():
        if "CUDA" in str(e.device_type):
            name = e.name
            kind = ("memcpy" if "Memcpy" in name else
                    "memset" if "Memset" in name else "kernel")
            key = name.split("(")[0][:60] if kind == "kernel" else name
            kinds[key] = kinds.get(key, 0) + 1
            device_us += e.time_range.end - e.time_range.start
        elif e.name.startswith("aten::"):
            host_ops += 1
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(
                    "aten::"):
                parent = parent.cpu_parent
            outer_ops += parent is None
    return {"wall_ms_median": float(np.median(walls)),
            "wall_ms_min": float(np.min(walls)),
            "device_events": int(sum(kinds.values())),
            "device_ms": device_us / 1e3, "events_by_name": kinds,
            "host_aten_ops": host_ops, "host_aten_outermost": outer_ops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    smoke = _smoke()
    sys.path.insert(0, root)

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("ransac_profile: no CUDA device", file=sys.stderr)
        return 1
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System
    from planarslam_tpu_torch.solvers import pnp, sim3_solver

    assert kernels.__file__.startswith(root), kernels.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    kernels.build()
    dev = torch.device("cuda", 0)
    cfg = SystemConfig()
    out = {"root": root, "device": smi.stdout.strip(),
           "torch": torch.__version__}
    seq = synthetic.make_sequence(smoke.CONSTRUCTED_SEQUENCE,
                                  width=cfg.camera.width,
                                  height=cfg.camera.height)

    # path 3: the two revisits
    rcfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=4))
    slam = System(config=rcfg, enable_loop_closing=False, device=dev)
    slam.local_mapper._cull_keyframes = lambda kf: None
    calls = []
    undo = _capture(calls)
    try:
        out["path3"] = smoke._reloc_run(slam, seq, rcfg)
    finally:
        undo()
    path3_calls = list(calls)

    # path 4b: the constructed loop's verification
    slam = System(config=cfg, device=dev)
    for i in range(smoke.CONSTRUCTED_FRAMES):
        slam.track_rgbd(*quantize_frame(*seq.render(i),
                                        cfg.camera.depth_map_factor),
                        seq.timestamps[i])
    slam.shutdown()
    kf, _, _ = smoke.construct_loop(slam.map)
    calls = []
    undo = _capture(calls)
    try:
        t0 = time.perf_counter()
        out["path4b_verified"] = bool(slam.loop_closer._verify_and_correct(
            kf, 0))
        torch.cuda.synchronize()
        out["path4b_correction_s"] = time.perf_counter() - t0
    finally:
        undo()
    out["ransacs"] = {}
    for where, cs in (("path3", path3_calls), ("path4b", calls)):
        for k, (name, fn, a, kw) in enumerate(cs):
            out["ransacs"][f"{where}_{name}_{k}"] = {
                "n": int(len(a[0])), **_profile_call(fn, a, kw, args.reps)}

    # K7 and K6 alone, device time per launch (chip_smoke's problems)
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args7 = (*[t(a) for a in smoke.pnp_problem(cfg.camera)], 5.991)
    out["k7_pnp_dlt_hypotheses"] = {
        "wrapper_ms": smoke._time_ms(lambda: pnp.pnp_dlt_hypotheses(*args7)),
        "device": smoke._launch_split(
            lambda: pnp.pnp_dlt_hypotheses(*args7), match="pnp_dlt")}
    s_p, d_p, v_p, pk = smoke.horn_problem(6)
    w = np.zeros((64, len(s_p)), np.float32)
    np.put_along_axis(w, pk.astype(np.int64), 1.0, axis=1)
    args6 = (t(s_p), t(d_p), t(v_p), t(w * v_p[None] + np.float32(1e-9)),
             0.08)
    out["k6_horn_align_batch"] = {
        "wrapper_ms": smoke._time_ms(
            lambda: sim3_solver.horn_align_batch(*args6)),
        "device": smoke._launch_split(
            lambda: sim3_solver.horn_align_batch(*args6), match="horn")}
    if hasattr(pnp, "pnp_select"):  # the trees with K46, K47, K6's modes
        ones = [t(a[None]) for a in (s_p, d_p, v_p, pk)]
        trip = sim3_solver.horn_triplets(*ones, 0.08)
        out["k6_modes"] = {
            "triplets": smoke._launch_split(
                lambda: sim3_solver.horn_triplets(*ones, 0.08),
                match="horn"),
            "refit": smoke._launch_split(
                lambda: sim3_solver.horn_refit(*ones[:3], trip[3], trip[4],
                                               0.08), match="horn"),
            "triplets_scale": smoke._launch_split(
                lambda: sim3_solver.horn_triplets(*ones, 0.08, True),
                match="horn")}
        ins = [a[None] for a in args7[:4]]
        sk, Tk = pnp.pnp_dlt_hypotheses(*ins, args7[4][None], 5.991)
        out["k46_pnp_select"] = smoke._launch_split(
            lambda: pnp.pnp_select(*ins, sk, Tk, 5.991), match="pnp_select")
        from planarslam_tpu_torch.ops import lines as ln

        planted = [t(x) for x in smoke.planted_match_problem("mad_shift")]
        lanes = [[t(x) for x in smoke.planted_match_problem(c, seed=5 + b)]
                 for b, c in enumerate(smoke.MATCH_PLANTED[:4])]
        b4 = [torch.stack(f) for f in zip(*lanes)]
        out["k47_match_lines"] = {
            "B1": smoke._launch_split(lambda: ln.match_lines(*planted),
                                      match="match_lines"),
            "B4": smoke._launch_split(lambda: ln.match_lines(*b4),
                                      match="match_lines")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
