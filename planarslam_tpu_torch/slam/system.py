"""System facade — the public API.

Port of ``planarslam_tpu/slam/system.py``: feed frames with ``track_rgbd``,
drain with ``shutdown``, read the trajectory. Local mapping and loop
closing run as deterministic stages per keyframe: the mapping step is
dispatched when the keyframe materializes and joined a fixed number of
frames later (at once while the map holds fewer than 8 keyframes); loop
detection follows the join, and a closed loop re-bases the tracker on the
corrected map.

The device defaults to ``"cuda"``, and a System asked for a card where
there is none raises (``planarslam_tpu_torch.device.resolve_device``): a
CPU run names ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from planarslam_tpu_torch.config import SystemConfig, load_yaml_config
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.slam.local_mapping import LocalMapping
from planarslam_tpu_torch.slam.loop_closing import LoopClosing
from planarslam_tpu_torch.slam.map import SlamMap
from planarslam_tpu_torch.slam.retrieval import KeyFrameDatabase
from planarslam_tpu_torch.slam.tracking import Tracking, TrackingState

BACKEND_LAG_FRAMES = 3  # frames from a keyframe to its mapping join


class System:
    def __init__(self, settings: Optional[str] = None,
                 config: Optional[SystemConfig] = None,
                 enable_local_mapping: bool = True,
                 enable_loop_closing: bool = True,
                 device="cuda"):
        if config is None:
            config = load_yaml_config(settings) if settings else SystemConfig()
        self.cfg = config
        self.device = resolve_device(device)
        self.enable_local_mapping = enable_local_mapping
        self.enable_loop_closing = enable_loop_closing
        self.localization_only = False
        self.timings: List[float] = []
        self.compactions = 0
        self._new_tracker()

    def _new_tracker(self) -> None:
        self.map = SlamMap(self.cfg)
        self.kf_db = KeyFrameDatabase(self.cfg)
        self.tracker = Tracking(self.cfg, self.map, kf_db=self.kf_db,
                                device=self.device)
        self.local_mapper = LocalMapping(self.cfg, self.map,
                                         device=self.device) \
            if self.enable_local_mapping else None
        self.loop_closer = LoopClosing(self.cfg, self.map, kf_db=self.kf_db,
                                       device=self.device) \
            if self.enable_loop_closing else None
        # first KF id whose backend has not started; the KF whose mapping
        # join is pending, and the frame at which it matures
        self._next_backend_kf = 0
        self._backend_kf: Optional[int] = None
        self._backend_due = 0

    # ------------------------------------------------------------- main API
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> Optional[np.ndarray]:
        """Process one frame; returns T_cw. gray: (H, W) uint8 or float;
        depth: uint16 in depth_map_factor units, or float metres."""
        t0 = time.perf_counter()
        gray = np.asarray(gray)
        depth = np.asarray(depth)
        if gray.dtype not in (np.uint8, np.float32):
            gray = gray.astype(np.float32)
        if depth.dtype not in (np.uint16, np.float32):
            depth = depth.astype(np.float32)
        n_kf_before = self.map.n_kf
        pose = self.tracker.track(gray, depth, timestamp)
        self._post_track(n_kf_before)
        self.timings.append(time.perf_counter() - t0)
        return pose

    TrackRGBD = track_rgbd

    def submit_fused_result(self, result, timestamp: float,
                            state_stack=None, lane: int = 0) -> np.ndarray:
        """Batched-replay entry (parallel/replay.py): apply one lane of an
        externally computed batched step (its bundle already on the host,
        the carried state stacked on the device) and run the back-end
        stages of track_rgbd. Returns T_cw."""
        n_kf_before = self.map.n_kf
        tr = self.tracker
        tr.frame_id += 1
        tr.stats["frames"] += 1
        ok = tr.submit_fused_result(result, timestamp,
                                    state_stack=state_stack, lane=lane)
        if not ok:
            tr.stats["lost"] += 1
            tr.state = TrackingState.LOST
            tr._flag_reset_if_young()
        self._post_track(n_kf_before)
        return tr.T_cw.copy()

    def _post_track(self, n_kf_before: int) -> None:
        """Backend stages after one tracked frame: retrieval DB, local
        mapping, slot compaction, auto-reset when lost with a young map."""
        if self.map.n_kf > n_kf_before:
            self._run_backend()
            self._maybe_compact_keyframes()
        elif (self._backend_kf is not None
              and self.tracker.frame_id >= self._backend_due):
            # the deferred mapping join matures a fixed number of frames
            # after its keyframe (deterministic)
            self._finish_backend_kf()
        if self.tracker.needs_reset and not self.localization_only:
            self.reset()

    def _run_backend(self, drain: bool = False) -> None:
        """Start the backend of every keyframe that materialized since the
        last call, finishing the previous keyframe's deferred work first.
        Per KF: retrieval-DB add and local-mapping begin (culls, step
        dispatch); the join and apply run BACKEND_LAG_FRAMES frames later,
        at the next keyframe or at drain."""
        while self._next_backend_kf < self.map.n_kf:
            kf = self._next_backend_kf
            self._next_backend_kf += 1
            self.kf_db.add(self.map, kf)
            if self.localization_only:
                continue
            self._finish_backend_kf()
            if self.local_mapper is not None and self.map.kf_valid[kf]:
                self.local_mapper.begin_keyframe(kf)
            self._backend_kf = kf
            self._backend_due = self.tracker.frame_id + BACKEND_LAG_FRAMES
            if self.map.n_kf < 8:
                # young map: finish at once, pairing the tracker's
                # synchronous young-map keyframes (the keyframe policy
                # reads pt_nobs that the fuse fills)
                self._finish_backend_kf()
        if drain:
            self._finish_backend_kf()

    def _finish_backend_kf(self) -> None:
        """Apply the previous keyframe's deferred local mapping, then loop
        detection (the LocalMapping -> LoopClosing queue order)."""
        kf = self._backend_kf
        if kf is None:
            return
        self._backend_kf = None
        if self.local_mapper is not None:
            self.local_mapper.finish_keyframe()
        if self.loop_closer is not None and self.map.kf_valid[kf]:
            T_old = self.map.kf_pose[kf].copy()
            if self.loop_closer.process_keyframe(kf) is not None:
                # re-base the pipelined tracker onto the corrected map
                self.tracker.apply_map_correction(
                    T_old, self.map.kf_pose[kf].copy())

    def _maybe_compact_keyframes(self) -> None:
        """Reclaim culled keyframe slots when nearing capacity, remapping
        every external holder of keyframe ids: trajectory records, the
        tracker's reference keyframe, the loop-consistency streaks and the
        local mapper's probation birth stamps."""
        m = self.map
        if m.n_kf < m.n_kf_slots - 4:
            return
        # pending mapping work is applied by keyframe id: drain first
        self._run_backend(drain=True)
        tr = self.tracker
        cache: dict = {}

        def res(k: int):
            k = int(k)
            if k not in cache:
                cache[k] = m.resolve_kf(k)
            return cache[k]

        rec_res = [res(r.ref_kf) for r in tr.records]
        trk_anchor, _ = res(tr.ref_kf)
        streaks: dict = {}
        if self.loop_closer is not None:
            for c, n in self.loop_closer._consistency.items():
                a, _ = res(c)
                if a >= 0:
                    streaks[a] = max(streaks.get(a, 0), n)
        lm = self.local_mapper
        births = []
        if lm is not None:
            for d in (lm._recent_pts, lm._recent_lns, lm._recent_pls):
                births.append({lid: res(born)[0] for lid, born in d.items()})
        remap = m.compact_keyframes()
        if remap is None:
            print(f"[planarslam] WARNING: keyframe capacity "
                  f"{m.n_kf_slots} reached with no culled slots to "
                  f"reclaim; raise config.map.max_keyframes", flush=True)
            return
        self.compactions += 1
        self._next_backend_kf = self.map.n_kf
        for rec, (anchor, T_rel) in zip(tr.records, rec_res):
            new_id = int(remap[anchor]) if anchor >= 0 else 0
            if new_id != rec.ref_kf:
                rec.T_cr = (rec.T_cr @ T_rel).astype(np.float32)
                rec.ref_kf = new_id
        tr.ref_kf = int(remap[trk_anchor]) if trk_anchor >= 0 else 0
        tr._window_dirty = True
        if self.loop_closer is not None:
            self.loop_closer._consistency = {
                int(remap[a]): n for a, n in streaks.items() if remap[a] >= 0}
        if lm is not None:
            for d, born in zip((lm._recent_pts, lm._recent_lns,
                                lm._recent_pls), births):
                for lid, a in born.items():
                    d[lid] = int(remap[a]) if a >= 0 and remap[a] >= 0 else 0

    def activate_localization_mode(self):
        self.localization_only = True
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.only_tracking = False

    def reset(self):
        """Clear the map, keyframe database, tracker, local mapper and loop
        closer (its consistency streaks with it)."""
        self._new_tracker()
        self.timings.clear()

    def shutdown(self):
        """Drain the tracking pipeline and the deferred backend."""
        self.tracker.flush_pending()
        self._run_backend(drain=True)

    def get_tracking_state(self) -> TrackingState:
        return self.tracker.state

    def n_tracked_points(self) -> int:
        return self.tracker.n_inliers

    # ------------------------------------------------------------ trajectory
    def frame_poses_wc(self, flush: bool = True) -> np.ndarray:
        """Per-frame camera-to-world poses chained through reference
        keyframes (relative pose times the current keyframe estimate)."""
        if flush:
            self.shutdown()
        out = []
        for rec in self.tracker.records:
            anchor, T_rel = self.map.resolve_kf(int(rec.ref_kf))
            T_rw = T_rel @ self.map.kf_pose[anchor]
            out.append(np.linalg.inv(rec.T_cr @ T_rw))
        if not out:
            return np.zeros((0, 4, 4), np.float32)
        return np.asarray(out)

    def save_trajectory_tum(self, path: str) -> None:
        from planarslam_tpu_torch.io.tum import write_trajectory_tum

        ts = [r.timestamp for r in self.tracker.records]
        write_trajectory_tum(path, ts, self.frame_poses_wc())

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        from planarslam_tpu_torch.io.tum import write_trajectory_tum

        ids = self.map.valid_kf_ids()
        poses = np.asarray([np.linalg.inv(self.map.kf_pose[k]) for k in ids])
        write_trajectory_tum(path, self.map.kf_timestamp[ids], poses)

    def save_map(self, path: str) -> None:
        """Serialize the full map (one compressed npz with every SlamMap
        array and counter), after draining the pipeline and the backend."""
        from planarslam_tpu_torch.slam.serialization import save_map

        self.tracker.flush_pending()
        self._run_backend(drain=True)
        save_map(path, self.map)

    def load_map(self, path: str) -> None:
        """Load a map checkpoint; the tracker restarts LOST and must
        relocalize against it (kidnapped-robot start)."""
        from planarslam_tpu_torch.slam.serialization import load_map

        self.map = load_map(path, self.cfg)
        self.tracker = Tracking(self.cfg, self.map, kf_db=self.kf_db,
                                device=self.device)
        self.tracker.state = TrackingState.LOST
        valid = self.map.valid_kf_ids()
        self.tracker.ref_kf = int(valid[-1]) if len(valid) else 0
        self.tracker.frame_id = int(self.map.kf_frame_id[:self.map.n_kf].max(
            initial=-1)) + 1
        if self.local_mapper is not None:
            self.local_mapper = LocalMapping(self.cfg, self.map,
                                             device=self.device)
        if self.loop_closer is not None:
            self.loop_closer = LoopClosing(self.cfg, self.map,
                                           kf_db=self.kf_db,
                                           device=self.device)
        # the checkpoint's KFs were backend-processed before the save
        self._next_backend_kf = self.map.n_kf
        self._backend_kf = None

    def save_mesh(self, path: str) -> None:
        """Planar mesh export of the map's planes."""
        from planarslam_tpu_torch.viz.mesh import save_planar_mesh

        save_planar_mesh(path, self.map)

    def timing_summary(self) -> dict:
        t = np.asarray(self.timings[1:]) if len(self.timings) > 1 else \
            np.asarray(self.timings)
        if len(t) == 0:
            return {"median_s": 0.0, "mean_s": 0.0, "fps": 0.0}
        return {"median_s": float(np.median(t)), "mean_s": float(t.mean()),
                "fps": float(1.0 / np.median(t))}
