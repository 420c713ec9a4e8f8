#!/usr/bin/env python3
"""How far path 4b's loop correction moves between two trees of the port.

    python3 tools/loop_positions.py [--root DIR] --save OUT.npz
    python3 tools/loop_positions.py --compare A.npz B.npz

The first form runs chip_smoke.py's path 4b on a GPU with DIR's
planarslam_tpu_torch (default: this checkout): a System tracks the first
CONSTRUCTED_FRAMES frames of the 640x480 room, the constructed loop is
added to its map and verified and corrected with global BA. It prints the
corrected keyframe's position after the pose graph and after global BA
(and each one's distance to keyframe 0, path 4b's offsets) and saves every
keyframe pose at both points to OUT.npz. The second form prints the
largest difference of the saved poses (all entries and translations)
between two runs, e.g. the parent's and the change's made in one call.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(a_path: str, b_path: str) -> None:
    a, b = np.load(a_path), np.load(b_path)
    for key in ("pose_graph", "gba"):
        d = np.abs(a[key] - b[key])
        print(f"{key}: poses differ by up to {d.max()} "
              f"(translations {d[:, :3, 3].max()})")


def run(root: str, out: str) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("loop_positions: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io import synthetic
    from planarslam_tpu_torch.io.frames import quantize_frame
    from planarslam_tpu_torch.slam.system import System
    from planarslam_tpu_torch.solvers import global_ba

    cfg = SystemConfig()
    seq = synthetic.make_sequence(smoke.CONSTRUCTED_SEQUENCE,
                                  width=cfg.camera.width,
                                  height=cfg.camera.height)
    slam = System(config=cfg, device="cuda")
    for i in range(smoke.CONSTRUCTED_FRAMES):
        slam.track_rgbd(*quantize_frame(*seq.render(i),
                                        cfg.camera.depth_map_factor),
                        seq.timestamps[i])
    slam.shutdown()
    m = slam.map
    kf, _, _ = smoke.construct_loop(m)
    slam.loop_closer.run_gba = True
    after = {}
    orig = global_ba.global_bundle_adjustment

    def hooked(slam_map, c, **kw):
        after["pose_graph"] = slam_map.kf_pose[:slam_map.n_kf].copy()
        return orig(slam_map, c, **kw)

    global_ba.global_bundle_adjustment = hooked
    try:
        ok = slam.loop_closer._verify_and_correct(kf, 0)
    finally:
        global_ba.global_bundle_adjustment = orig
    torch.cuda.synchronize()
    gba = m.kf_pose[:m.n_kf].copy()
    pg = after["pose_graph"]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, pose_graph=pg, gba=gba)
    # the offsets of chip_smoke.py's path 4b: to keyframe 0 at the end
    print(f"verified {ok}, keyframe {kf}: after the pose graph "
          f"{pg[kf][:3, 3].tolist()} (offset "
          f"{float(np.linalg.norm(pg[kf][:3, 3] - gba[0][:3, 3]))} m), "
          f"after global BA {gba[kf][:3, 3].tolist()} (offset "
          f"{float(np.linalg.norm(gba[kf][:3, 3] - gba[0][:3, 3]))} m)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--save", default=None, help="the .npz to write")
    ap.add_argument("--compare", nargs=2, default=None,
                    metavar=("A.npz", "B.npz"))
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if not args.save:
        ap.error("--save or --compare is required")
    return run(args.root, args.save)


if __name__ == "__main__":
    sys.exit(main())
