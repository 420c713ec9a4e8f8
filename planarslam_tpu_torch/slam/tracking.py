"""The per-frame tracking state machine (host orchestration).

Port of the streaming path of ``planarslam_tpu/slam/tracking.py``:

  NOT_INITIALIZED -> stereo initialization (KF0 with all three landmark
  types, Manhattan frame seeded from plane normals and line directions);
  then per frame the device step (``device_tracker.fused_track_step``) is
  dispatched for frame k while the packed bundle of frame
  k - ``pipeline_depth`` is applied on the host (``_process_bundle``:
  landmark statistics, associations, reference keyframe, keyframe policy).
  Keyframes are created deferred, on a fixed frame horizon, from a packed
  feature pull.

The bundle and the keyframe features come back through pinned host buffers
copied with ``non_blocking=True`` behind a CUDA event, so the frame loop
only waits for a result that is ``pipeline_depth`` frames old.

After a loss the modular path takes over (``_track_frame``): with more
than 5 keyframes it relocalizes against retrieval candidates (descriptor
seeds, Horn RANSAC with depth or PnP RANSAC without, guided rematches,
local-map tracking) and rebuilds the device state; with a younger map it
flags a reset, as the JAX tracker does.

Chunked throughput mode (``tracking.chunk_size`` C > 1) buffers C frames
and tracks them as one chunk against the frozen local-map window
(``device_tracker.fused_track_chunk_packed``), keeping
``chunk_pipeline_depth`` chunks in flight before the oldest is applied
frame by frame. On the card a chunk is one pinned upload and one replay of
a captured CUDA graph (``device_tracker.CapturedChunk``); on the CPU it
runs eagerly on the plain versions.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.geometry import plane as plane_geo
from planarslam_tpu_torch.ops import manhattan as manhattan_ops
from planarslam_tpu_torch.ops import matching
from planarslam_tpu_torch.slam import device_tracker as dt
from planarslam_tpu_torch.slam.frame import (FrameFeatures, extract_frame,
                                             unproject_points)
from planarslam_tpu_torch.slam.map import SlamMap
from planarslam_tpu_torch.solvers import pose_opt


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class LastFrame:
    feats: FrameFeatures    # device features
    T_cw: np.ndarray
    pt3d_w: np.ndarray      # (K, 3) world points for features with depth
    map_pt: np.ndarray      # (K,) map point id per feature or -1
    map_ln: np.ndarray      # (L,) map line id per line or -1


@dataclass
class FrameRecord:
    timestamp: float
    T_cr: np.ndarray        # pose relative to reference KF (Tcw * Trw^-1)
    ref_kf: int
    lost: bool


class _HostPull:
    """A device tensor on its way to the host: a pinned buffer filled with
    a non-blocking copy, and the CUDA event recorded after it. On the CPU
    the tensor is already there."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t
            self.event = None

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _Pulled:
    """A bundle already on the host (a lane's row of a batched pull)."""

    def __init__(self, a: np.ndarray):
        self.host = a

    def result(self) -> np.ndarray:
        return self.host


def _upload(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(device, non_blocking=True)
    return t


class Tracking:
    def __init__(self, cfg: SystemConfig, slam_map: SlamMap, kf_db=None,
                 device="cuda"):
        from planarslam_tpu_torch.slam.retrieval import KeyFrameDatabase

        self.cfg = cfg
        self.device = resolve_device(device)
        self.map = slam_map
        self.kf_db = kf_db or KeyFrameDatabase(cfg)
        self.state = TrackingState.NO_IMAGES_YET
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.R_wm: Optional[np.ndarray] = None  # world-from-Manhattan
        self.last: Optional[LastFrame] = None
        self.ref_kf = -1
        self.frame_id = -1
        self.last_kf_frame_id = -1
        self.records: List[FrameRecord] = []
        self.only_tracking = False
        self.last_track_time = 0.0
        self.new_plane_flag = False
        self.manhattan_ok = False
        self.n_inliers = 0
        self._pose_weights = pose_opt.PoseOptWeights.from_config(cfg.planes)
        # per-level inverse sigma^2
        s2 = cfg.orb.scale_factor ** (2 * np.arange(cfg.orb.n_levels))
        self.inv_level_sigma2 = (1.0 / s2).astype(np.float32)
        self.K = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
        self.wh = (float(cfg.camera.width), float(cfg.camera.height))
        self._layout = dt.BundleLayout(cfg)
        self._feats_layout = dt.FeatsHostLayout(cfg)
        self._fused_state: Optional[dt.LastState] = None
        self._window = None
        self._win_pt_ids = None
        self._win_ln_ids = None
        self._win_kf_ids = None
        self._win_pt_gen = None
        self._win_ln_gen = None
        self._window_dirty = True
        self._host_last_map_pt = np.full(cfg.orb.max_keypoints, -1, np.int32)
        self._host_last_map_pt_gen = np.zeros(cfg.orb.max_keypoints, np.int32)
        self._pending_kf: Optional[dict] = None
        self.needs_reset = False
        self.pipeline_depth = cfg.tracking.pipeline_depth
        self._pending: list = []
        self._dev_consts = None  # (eye4, False, R_wm, manh_enabled)
        # a loop correction re-bases the device step once (pose override)
        # and right-multiplies the poses of the frames in flight
        self._pose_override: Optional[np.ndarray] = None
        self._bundle_correction: Optional[Tuple[np.ndarray, int]] = None
        self.stats = {"manhattan_success": 0, "translation_only": 0,
                      "full_pose": 0, "frames": 0, "kfs": 0, "lost": 0}
        self._last_depth = np.zeros((1, 1), np.float32)
        # chunked throughput mode (cfg.tracking.chunk_size > 1): the frames
        # buffered for the next chunk, the chunks in flight, and on the
        # card the captured chunk (made at the first chunk)
        self._chunk_buf: list = []
        self._pending_chunks: list = []
        self.chunk_pipeline_depth = cfg.tracking.chunk_pipeline_depth
        self._chunk_graph: Optional[dt.CapturedChunk] = None

    # ------------------------------------------------------- main entry point
    def track(self, gray: np.ndarray, depth: np.ndarray,
              timestamp: float) -> Optional[np.ndarray]:
        """Process one RGB-D frame; returns T_cw (the freshest processed
        estimate, pipeline_depth frames behind the dispatched frame)."""
        import time as _time

        self.frame_id += 1
        self.stats["frames"] += 1
        self._last_depth = np.asarray(depth)
        t1 = _time.perf_counter()

        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            feats_dev = self._extract(gray, depth)
            self._stereo_initialization(feats_dev, timestamp)
            return self.T_cw.copy()

        if self.state == TrackingState.LOST or self._fused_state is None:
            self.flush_pending()
            feats = self._extract(gray, depth)
            ok = self._track_frame(feats, timestamp)
            if ok:
                self._rebuild_fused_state(feats)
            self.last_track_time = _time.perf_counter() - t1
            if not ok:
                self.stats["lost"] += 1
                self.state = TrackingState.LOST
                self._flag_reset_if_young()
            self._append_record(timestamp,
                                lost=self.state == TrackingState.LOST)
            return self.T_cw.copy()

        ok = self._track_frame_fused(gray, depth, timestamp)
        self.last_track_time = _time.perf_counter() - t1
        if not ok:
            self.stats["lost"] += 1
            self.state = TrackingState.LOST
            self._flag_reset_if_young()
        return self.T_cw.copy()

    def _flag_reset_if_young(self) -> None:
        if len(self.map.valid_kf_ids()) <= 5:
            self.needs_reset = True

    def _extract(self, gray, depth) -> FrameFeatures:
        g = torch.from_numpy(np.asarray(gray, np.float32)).to(self.device)
        d = np.asarray(depth)
        if d.dtype == np.uint16:
            d = d.astype(np.float32) / self.cfg.camera.depth_map_factor
        d = torch.from_numpy(np.asarray(d, np.float32)).to(self.device)
        return extract_frame(g, d, self.cfg)

    def _depth_metres_at(self, raw: np.ndarray, ys, xs) -> np.ndarray:
        z = raw[ys, xs].astype(np.float32)
        if raw.dtype == np.uint16:
            z /= self.cfg.camera.depth_map_factor
        return z

    def _append_record(self, timestamp: float, lost: bool) -> None:
        T_rw = self.map.kf_pose[self.ref_kf]
        T_cr = self.T_cw @ np.linalg.inv(T_rw)
        self.records.append(FrameRecord(timestamp, T_cr.astype(np.float32),
                                        self.ref_kf, lost))

    def flush_pending(self) -> None:
        """Drain in-flight frames (end of sequence) and materialize a
        pending keyframe. A partial chunk is padded to C by repeating its
        last frame and dispatched; only its real frames are applied, and
        the padded steps leave a carried state that is dropped."""
        if self._chunk_buf:
            C = self.cfg.tracking.chunk_size
            buf = self._chunk_buf
            self._chunk_buf = []
            n_real = len(buf)
            buf = buf + [buf[-1]] * (C - n_real)
            self._dispatch_chunk(buf, n_real, override=False)
            self._fused_state = None
        while self._pending_chunks:
            entry = self._pending_chunks.pop(0)
            if not self._process_chunk(entry):
                self.state = TrackingState.LOST
                self._fused_state = None
                for e2 in self._pending_chunks:
                    for ts, _, _ in e2["frames"]:
                        self._append_record(ts, lost=True)
                self._pending_chunks.clear()
                break
        while self._pending:
            prev = self._pending.pop(0)
            if not self._process_bundle(prev):
                self.stats["lost"] += 1
                self.state = TrackingState.LOST
                self._fused_state = None
                for dropped in self._pending:
                    self._append_record(dropped["timestamp"], lost=True)
                self._pending.clear()
        self._apply_pending_kf(block=True)

    # ------------------------------------------------------ initialization
    def _stereo_initialization(self, feats_dev: FrameFeatures,
                               timestamp: float) -> None:
        """KF0 from the first frame with enough depth, Manhattan seed."""
        feats = dt.feats_to_numpy(feats_dev)
        if int((feats.points.depth > 0).sum()) < 50:
            return
        self.T_cw = np.eye(4, dtype=np.float32)
        kf = self._create_keyframe(
            feats, timestamp, np.full(self.cfg.orb.max_keypoints, -1, np.int32),
            np.full(self.cfg.lines.max_lines, -1, np.int32),
            plane_matches=None)
        self.ref_kf = kf
        # the Manhattan seed from the plane normals and line directions, and
        # the direction set of the mean shift after it (K39, B = 1)
        ln, pl = feats_dev.lines, feats_dev.planes
        seed = manhattan_ops.seed_manhattan(*[t[None] for t in (
            pl.coeffs, pl.count, pl.valid, ln.p3d_s, ln.p3d_e, ln.has_3d,
            ln.valid, ln.response, feats_dev.normals,
            feats_dev.normals_valid)])
        res = manhattan_ops.track_manhattan_frame(
            seed.R_seed, seed.dirs, seed.dirs_valid,
            cone_sin=self.cfg.manhattan.cone_sin_project,
            kernel=self.cfg.manhattan.mean_shift_kernel,
            min_support=self.cfg.manhattan.min_axis_support)
        if bool(seed.ok[0]) and bool(res.success[0]):
            self.R_wm = res.R_cm[0].cpu().numpy()
        self._set_last(feats_dev, feats)
        self.state = TrackingState.OK
        self.records.append(FrameRecord(timestamp,
                                        np.eye(4, dtype=np.float32), kf,
                                        False))
        self._fused_state = dt.lanes(dt._state_from(
            feats_dev, self._dev(self.T_cw), self._dev(self.velocity),
            self.cfg))
        self._window_dirty = True
        self._pending = []
        self._chunk_buf = []
        self._pending_chunks = []
        self._pose_override = None
        self._bundle_correction = None

    def _set_last(self, feats: FrameFeatures, feats_np: FrameFeatures,
                  map_pt: Optional[np.ndarray] = None,
                  map_ln: Optional[np.ndarray] = None) -> None:
        T_wc = np.linalg.inv(self.T_cw)
        pt3d = unproject_points(feats_np.points, self.cfg, T_wc)
        if map_pt is None:
            map_pt = self.map.kf_pt_idx[self.ref_kf].copy()
        if map_ln is None:
            map_ln = np.full(self.cfg.lines.max_lines, -1, np.int32)
        self.last = LastFrame(feats=feats, T_cw=self.T_cw.copy(),
                              pt3d_w=pt3d, map_pt=map_pt, map_ln=map_ln)
        self._host_last_map_pt = np.asarray(map_pt, np.int32).copy()
        self._host_last_map_pt_gen = self.map.pt_gen[
            np.clip(self._host_last_map_pt, 0, None)].copy()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """numpy -> tensor on the tracker's device (uint32 descriptors as
        int32 bit patterns)."""
        return dt._tensor_from(a, self.device)

    # ----------------------------------------------------- fused device path
    def _refresh_window(self) -> None:
        kf_ids = self.map.valid_kf_ids()
        if len(kf_ids) > 12:
            ids = [self.ref_kf] + [int(c) for c in
                                   self.map.covisible_kfs(self.ref_kf)[:11]]
            kf_ids = np.asarray(sorted(set(i for i in ids
                                           if self.map.kf_valid[i])))
        flat, self._win_pt_ids, self._win_ln_ids = dt.build_window_host(
            self.map, kf_ids, self.cfg)
        self._window = _upload(flat[None], self.device)
        self._win_kf_ids = np.asarray(kf_ids, np.int64)
        self._win_pt_gen = self.map.pt_gen[
            np.clip(self._win_pt_ids, 0, None)].copy()
        self._win_ln_gen = self.map.ln_gen[
            np.clip(self._win_ln_ids, 0, None)].copy()
        self._window_dirty = False

    def fused_step_inputs(self, gray, depth=None) -> tuple:
        """Arguments of fused_track_step (minus cfg) for one lane (B = 1):
        frames (1, H, W), or with depth=None a packed (1, 3, H, W) uint8
        frame, and the tuple fits fused_track_step_packed."""
        if self._window_dirty or self._window is None:
            self._refresh_window()
        head = self._step_consts()[:2]
        if self._pose_override is not None:
            # the first step after a map correction starts from the
            # re-based pose with zero velocity
            head = (self._dev(self._pose_override.astype(np.float32)[None]),
                    torch.tensor([True], device=self.device))
            self._pose_override = None
        tail = head + self._dev_consts[2:] + (self._fused_state, self._window,
                                             self._pose_weights)
        if depth is None:
            return (_upload(gray[None], self.device),) + tail
        return (_upload(gray[None], self.device),
                _upload(depth[None], self.device)) + tail

    def _step_consts(self) -> tuple:
        """(eye4 (1, 4, 4), False (1,), R_wm (1, 3, 3), manh_enabled (1,))
        on the device, made once: R_wm is fixed at initialization."""
        if self._dev_consts is None:
            manh = self.R_wm is not None
            R = self.R_wm if manh else np.eye(3, dtype=np.float32)
            self._dev_consts = (
                self._dev(np.eye(4, dtype=np.float32)[None]),
                torch.tensor([False], device=self.device),
                self._dev(R.astype(np.float32)[None]),
                torch.tensor([manh], device=self.device))
        return self._dev_consts

    def submit_fused_result(self, result: dt.StepResult, timestamp: float,
                            state_stack: Optional[dt.LastState] = None,
                            lane: int = 0) -> bool:
        """Queue a step result and process the bundle now due (frame k
        dispatched, frame k - pipeline_depth applied).

        Streaming: `result` is this tracker's B = 1 step. Batched replay
        (parallel/replay.py): `result.packed` is this lane's bundle, already
        pulled to the host, and the carried state stays stacked on the
        device as `state_stack`; this lane's keyframe feature pull slices
        it there (pack_feats_slice), and the stack is this tracker's
        fused state, the marker that the lane is alive."""
        self._apply_pending_kf()
        if state_stack is None:
            state_stack = result.new_state
            pull = _HostPull(result.packed[lane])
        else:
            pull = _Pulled(np.asarray(result.packed))
        self._pending.append({
            "pull": pull, "state_stack": state_stack, "lane": lane,
            "timestamp": timestamp, "frame_id": self.frame_id,
            "depth": self._last_depth})
        self._fused_state = state_stack
        while len(self._pending) > self.pipeline_depth:
            prev = self._pending.pop(0)
            if not self._process_bundle(prev):
                for dropped in self._pending:
                    self._append_record(dropped["timestamp"], lost=True)
                self._pending.clear()
                self._fused_state = None
                return False
        return True

    def _track_frame_fused(self, gray, depth, timestamp: float) -> bool:
        if self.cfg.tracking.chunk_size > 1:
            return self._track_frame_chunked(gray, depth, timestamp)
        packed = dt.pack_frame(np.asarray(gray), np.asarray(depth))
        if packed is not None:
            # native sensor dtypes: one upload per frame
            result = dt.fused_track_step_packed(
                *self.fused_step_inputs(packed), self.cfg)
        else:
            result = dt.fused_track_step(
                *self.fused_step_inputs(np.asarray(gray, np.float32),
                                        np.asarray(depth, np.float32)),
                self.cfg)
        return self.submit_fused_result(result, timestamp)

    # ------------------------------------------------- chunked throughput
    def _track_frame_chunked(self, gray, depth, timestamp: float) -> bool:
        """Buffer C frames, then track them as one chunk; keep
        chunk_pipeline_depth chunks in flight and apply the oldest."""
        C = self.cfg.tracking.chunk_size
        self._chunk_buf.append((np.asarray(gray), np.asarray(depth),
                                timestamp, self.frame_id, self._last_depth))
        if len(self._chunk_buf) < C:
            return True
        buf = self._chunk_buf
        self._chunk_buf = []
        self._dispatch_chunk(buf, C)
        while len(self._pending_chunks) > self.chunk_pipeline_depth:
            if not self._process_chunk(self._pending_chunks.pop(0)):
                for entry in self._pending_chunks:
                    for ts, _, _ in entry["frames"]:
                        self._append_record(ts, lost=True)
                self._pending_chunks.clear()
                self._chunk_buf = []
                self._fused_state = None
                return False
        return True

    def _captured_chunk(self) -> dt.CapturedChunk:
        if self._chunk_graph is None:
            self._chunk_graph = dt.CapturedChunk(
                self.cfg.tracking.chunk_size, self.cfg, self._pose_weights,
                self.device, slots=self.chunk_pipeline_depth + 1)
        return self._chunk_graph

    @record_function("tracking.dispatch_chunk")
    def _dispatch_chunk(self, buf: list, n_real: int,
                        override: bool = True) -> None:
        """Track the C buffered frames as one chunk and queue it with the
        first n_real frames' records. A pending pose override (a loop
        correction) re-bases the carried state first: T_cw becomes the
        override and the velocity the identity, so the in-chunk steps need
        none. Native uint8 / uint16 frames travel as one packed upload: on
        the card into the captured chunk's replay, on the CPU into the
        eager fused_track_chunk_packed; other dtypes take the eager
        fused_track_chunk."""
        if self._window_dirty or self._window is None:
            self._refresh_window()
        if override and self._pose_override is not None:
            self._fused_state = self._fused_state._replace(
                T_cw=self._dev(self._pose_override.astype(np.float32)[None]),
                velocity=self._dev(np.eye(4, dtype=np.float32)[None]))
            self._pose_override = None
        R_wm, manh = self._step_consts()[2:]
        packed = dt.pack_chunk_frames([b[0] for b in buf],
                                      [b[1] for b in buf])
        if packed is not None and self.device.type == "cuda":
            graph = self._captured_chunk()
            if self._fused_state is not graph.carry:
                graph.set_state(self._fused_state)
            graph.set_inputs(self._window, R_wm, manh)
            res = graph.replay(packed)
        elif packed is not None:
            res = dt.fused_track_chunk_packed(
                _upload(packed, self.device), R_wm, manh, self._fused_state,
                self._window, self._pose_weights, self.cfg)
        else:
            res = dt.fused_track_chunk(
                _upload(np.stack([b[0] for b in buf]).astype(np.float32),
                        self.device),
                _upload(np.stack([b[1] for b in buf]).astype(np.float32),
                        self.device),
                R_wm, manh, self._fused_state, self._window,
                self._pose_weights, self.cfg)
        self._pending_chunks.append({
            "pull": _HostPull(res.packed), "states": res.states,
            "frames": [(b[2], b[3], b[4]) for b in buf[:n_real]]})
        self._fused_state = res.final_state

    def _process_chunk(self, entry: dict) -> bool:
        """Apply a chunk's frames in order (one pull of its (C, total)
        bundles); a keyframe decided during the previous chunk
        materializes first, at this chunk boundary."""
        self._apply_pending_kf(block=True)
        packed_all = entry["pull"].result()
        for i, (ts, fid, raw_depth) in enumerate(entry["frames"]):
            prev = {"pull": _Pulled(packed_all[i]), "timestamp": ts,
                    "frame_id": fid, "depth": raw_depth,
                    "state_stack": entry["states"], "lane": i}
            if not self._process_bundle(prev):
                self.stats["lost"] += 1
                for ts2, _, _ in entry["frames"][i + 1:]:
                    self._append_record(ts2, lost=True)
                return False
        return True

    def _process_bundle(self, prev: dict) -> bool:
        """Apply the (lagged) step results to the host map and state."""
        cfg = self.cfg
        m = self.map
        bundle = self._layout.unpack(prev["pull"].result())
        self._last_depth = prev["depth"]

        flags = bundle["flags"]
        if flags[0] > 0:
            self.stats["manhattan_success"] += 1
        if flags[1] > 0:
            self.stats["translation_only"] += 1
        else:
            self.stats["full_pose"] += 1
        self.manhattan_ok = flags[1] > 0
        n_in2 = int(flags[3])
        self.n_inliers = n_in2
        if n_in2 < cfg.tracking.min_matches_local_map // 2:
            self._append_record(prev["timestamp"], lost=True)
            return False

        T_before = self.T_cw.copy()
        T_out = bundle["T_out"].astype(np.float32)
        if self._bundle_correction is not None:
            # this frame was computed before a loop correction landed
            corr, remaining = self._bundle_correction
            T_out = (T_out @ corr).astype(np.float32)
            self._bundle_correction = (corr, remaining - 1) \
                if remaining > 1 else None
        self.T_cw = T_out
        self.velocity = (self.T_cw @ np.linalg.inv(T_before)).astype(
            np.float32)

        # landmark statistics; slots recycled since the window snapshot are
        # rejected by their generation stamp
        vis = bundle["win_visible"] > 0
        fnd = bundle["win_found"] > 0
        ids = self._win_pt_ids
        idc = np.clip(ids, 0, None)
        real = ((ids >= 0) & m.pt_valid[idc]
                & (m.pt_gen[idc] == self._win_pt_gen))
        m.pt_visible[ids[real & vis]] += 1
        m.pt_found[ids[real & vis & fnd]] += 1

        # associations: temporal carry overridden by direct window matches
        cur_map_pt = np.full(cfg.orb.max_keypoints, -1, np.int32)
        ff = bundle["ff_idx"]
        okf = (ff >= 0) & (self._host_last_map_pt >= 0)
        carried = self._host_last_map_pt[okf]
        carried_gen = self._host_last_map_pt_gen[okf]
        cc = np.clip(carried, 0, None)
        carried_ok = m.pt_valid[cc] & (m.pt_gen[cc] == carried_gen)
        cur_map_pt[ff[okf][carried_ok]] = carried[carried_ok]
        wi = bundle["win_idx"]
        okw = wi >= 0
        okw[okw] &= real[wi[okw]]
        cur_map_pt[okw] = ids[wi[okw]]
        inl_feat = bundle["pt_inlier"] > 0
        cur_map_pt = np.where(inl_feat | (cur_map_pt < 0), cur_map_pt, -1)
        occ = np.flatnonzero(cur_map_pt >= 0)
        _, keep = np.unique(cur_map_pt[occ], return_index=True)
        drop = np.setdiff1d(np.arange(len(occ)), keep)
        cur_map_pt[occ[drop]] = -1
        self._host_last_map_pt = cur_map_pt.copy()
        self._host_last_map_pt_gen = m.pt_gen[
            np.clip(cur_map_pt, 0, None)].copy()
        lids = self._win_ln_ids
        lidc = np.clip(lids, 0, None)
        lreal = ((lids >= 0) & m.ln_valid[lidc]
                 & (m.ln_gen[lidc] == self._win_ln_gen))
        cur_map_ln = np.full(cfg.lines.max_lines, -1, np.int32)
        li = bundle["ln_win_idx"]
        okl = li >= 0
        okl[okl] &= lreal[li[okl]]
        cur_map_ln[okl] = lids[li[okl]]

        lf = bundle["ln_win_found"] > 0
        lv = (bundle["ln_win_visible"] > 0) | lf
        sel_l = lreal & lv
        if sel_l.any():
            T_wc = np.linalg.inv(self.T_cw)
            m.line_stats_update(lids[sel_l], lf[sel_l],
                                cam_center_w=T_wc[:3, 3])

        # reference keyframe: strongest voter among matched landmarks over
        # the window keyframes and their covisibility neighbours
        matched = cur_map_pt[cur_map_pt >= 0]
        if len(matched) > 0 and m.n_kf > 0:
            cand_mask = np.zeros(m.n_kf, bool)
            win = self._win_kf_ids
            win = win[win < m.n_kf] if win is not None else None
            if win is not None and len(win) > 0:
                cand_mask[win] = True
                cand_mask |= (m.covis[win, :m.n_kf] > 0).any(axis=0)
            if self.ref_kf < m.n_kf:
                cand_mask[self.ref_kf] = True
            cand_mask &= m.kf_valid[:m.n_kf]
            cand = np.flatnonzero(cand_mask)
            if len(cand) > 0:
                votes = np.isin(m.kf_pt_idx[cand], matched).sum(axis=1)
                best = int(np.argmax(votes))
                if votes[best] > 0:
                    self.ref_kf = int(cand[best])

        if (self._pending_kf is None
                and self._need_new_keyframe_fused(bundle["kf_stats"],
                                                  cur_map_pt,
                                                  prev["frame_id"])):
            self._begin_keyframe(prev, cur_map_pt, cur_map_ln)
            if self.map.n_kf < 8:
                # young map: materialize now, reseeding the carry
                self._apply_pending_kf(block=True, reseed_carry=True)

        self.state = TrackingState.OK
        self._append_record(prev["timestamp"], lost=False)
        return True

    def _begin_keyframe(self, prev: dict, cur_map_pt: np.ndarray,
                        cur_map_ln: np.ndarray) -> None:
        """Start deferred keyframe creation: dispatch the packed feature
        pull and snapshot what the materialization needs."""
        self._pending_kf = {
            "pull": _HostPull(dt.pack_feats_slice(prev["state_stack"].feats,
                                                  prev["lane"])),
            "timestamp": prev["timestamp"], "frame_id": prev["frame_id"],
            "decided_at": self.frame_id,
            "T_cw": self.T_cw.copy(),
            "depth": prev["depth"],
            "cur_map_pt": cur_map_pt.copy(),
            "cur_map_ln": cur_map_ln.copy(),
        }
        self.last_kf_frame_id = prev["frame_id"]

    def _apply_pending_kf(self, block: bool = False,
                          reseed_carry: bool = False) -> bool:
        """Materialize the deferred keyframe after a fixed pipeline_depth
        frame horizon (or now, with block=True)."""
        p = self._pending_kf
        if p is None:
            return False
        if not block and self.frame_id < p["decided_at"] + max(
                1, self.pipeline_depth):
            return False
        feats_np = self._feats_layout.unpack(p["pull"].result())
        plane_matches = self._associate_planes(feats_np, T_cw=p["T_cw"])
        kf = self._create_keyframe(
            feats_np, p["timestamp"], p["cur_map_pt"], p["cur_map_ln"],
            plane_matches, T_cw=p["T_cw"], frame_id=p["frame_id"],
            depth_raw=p["depth"])
        self.ref_kf = kf
        self.stats["kfs"] += 1
        self._window_dirty = True
        if reseed_carry:
            self._host_last_map_pt = self.map.kf_pt_idx[kf].copy()
            self._host_last_map_pt_gen = self.map.pt_gen[
                np.clip(self._host_last_map_pt, 0, None)].copy()
        self._pending_kf = None
        return True

    def _need_new_keyframe_fused(self, kf_stats: np.ndarray,
                                 cur_map_pt: np.ndarray,
                                 frame_id: int) -> bool:
        cfg = self.cfg
        if self.only_tracking:
            return False
        if self.map.n_kf >= self.map.n_kf_slots - 1:
            return False
        frames_since = frame_id - self.last_kf_frame_id
        if frames_since >= cfg.tracking.max_frames_between_kf:
            return True
        if self.new_plane_flag:
            return True
        tracked_close, nontracked_close, _, _ = [int(v) for v in kf_stats]
        need_close = tracked_close < 100 and nontracked_close > 70
        min_obs = 3 if self.map.n_kf > 2 else 2
        ref_row = self.map.kf_pt_idx[self.ref_kf]
        ref_pts = ref_row[ref_row >= 0]
        ref_pts = ref_pts[self.map.pt_valid[ref_pts]]
        ref_obs = int((self.map.pt_nobs[ref_pts] >= min_obs).sum())
        n_map = int((cur_map_pt >= 0).sum())
        weak = n_map < 0.75 * max(ref_obs, 1)
        return (weak or need_close) and n_map > 15 and frames_since >= 1

    # ------------------------------------------------------- modular path
    def _search_frame(self, pts_w, descs, valid_pts, T_cw, feats, radius,
                      max_dist, level_window, view_normals=None,
                      dist_range=None) -> np.ndarray:
        """Projection search of landmarks (numpy, host order) into the
        frame's device features; returns the (M,) feature index or -1."""
        cam = self.cfg.camera
        pts = feats.points
        res = matching.search_by_projection(
            self._dev(pts_w), self._dev(descs), self._dev(valid_pts),
            self._dev(np.asarray(T_cw, np.float32)), pts.uv, pts.desc,
            pts.level, pts.valid, pts.u_right, K=self.K, image_wh=self.wh,
            bf=cam.bf, scale_factor=self.cfg.orb.scale_factor, radius=radius,
            max_dist=max_dist,
            view_normals=None if view_normals is None
            else self._dev(view_normals),
            dist_range=None if dist_range is None
            else tuple(self._dev(d) for d in dist_range),
            level_window=level_window)
        return res.idx.cpu().numpy()

    def _rotation_filter(self, angle_src: np.ndarray, idx: np.ndarray,
                         feats_np: FrameFeatures) -> np.ndarray:
        """idx with the matches outside the rotation histogram's main
        bins set to -1."""
        ang_tgt = feats_np.points.angle[np.clip(idx, 0, None)]
        keep = matching.rotation_histogram_filter(
            self._dev(angle_src), self._dev(ang_tgt), self._dev(idx >= 0))
        return np.where(keep.cpu().numpy(), idx, -1)

    def _point_obs_from_matches(self, feats_np: FrameFeatures,
                                pts_w: np.ndarray, match_idx: np.ndarray
                                ) -> pose_opt.PointObs:
        """The padded PointObs block for pose optimization. pts_w: (M, 3)
        landmark world positions; match_idx: (M,) feature index or -1."""
        kp = self.cfg.orb.max_keypoints
        pts = feats_np.points
        xw = np.zeros((kp, 3), np.float32)
        uv_o = np.zeros((kp, 2), np.float32)
        ur_o = np.full(kp, -1.0, np.float32)
        valid = np.zeros(kp, bool)
        inv_s2 = np.ones(kp, np.float32)
        ok = match_idx >= 0
        fi = match_idx[ok]
        xw[fi] = pts_w[ok]
        uv_o[fi] = pts.uv[fi]
        ur_o[fi] = pts.u_right[fi]
        valid[fi] = True
        inv_s2[fi] = self.inv_level_sigma2[pts.level[fi]]
        return pose_opt.PointObs(xw=self._dev(xw), uv=self._dev(uv_o),
                                 u_right=self._dev(ur_o),
                                 inv_sigma2=self._dev(inv_s2),
                                 valid=self._dev(valid))

    def _run_pose_opt(self, T_init, points=None, lines=None, planes=None,
                      par=None, ver=None, rotation_fixed=False):
        return pose_opt.pose_optimize(
            self._dev(np.asarray(T_init, np.float32)), self.K,
            self.cfg.camera.bf, points=points, lines=lines, planes=planes,
            par_planes=par, ver_planes=ver, weights=self._pose_weights,
            rotation_fixed=rotation_fixed)

    def _manh_obs(self, feats: FrameFeatures):
        """Surface normals and line directions for Manhattan tracking."""
        ln = feats.lines
        ln_vec = ln.p3d_e - ln.p3d_s
        ln_len = torch.linalg.norm(ln_vec, dim=-1, keepdim=True)
        dirs = ln_vec / torch.clamp(ln_len, min=1e-9)
        ok = ln.has_3d & ln.valid & (ln_len[:, 0] > 0.1)
        return (torch.cat([feats.normals, dirs], dim=0),
                torch.cat([feats.normals_valid, ok], dim=0))

    def _rebuild_fused_state(self, feats: FrameFeatures) -> None:
        """Device state for the fused path from the frame just tracked on
        the modular path."""
        self._fused_state = dt.lanes(dt._state_from(
            feats, self._dev(self.T_cw), self._dev(self.velocity), self.cfg))
        self._window_dirty = True
        self._pending = []
        self._chunk_buf = []
        self._pending_chunks = []
        self._pose_override = None
        self._bundle_correction = None

    def apply_map_correction(self, T_kf_old: np.ndarray,
                             T_kf_new: np.ndarray) -> None:
        """Re-base tracking after a loop correction: the camera keeps its
        pose relative to the corrected keyframe. The deferred keyframe's
        snapshot and the frames in flight were computed before it, and the
        next device step starts from the re-based pose."""
        corr = (np.linalg.inv(T_kf_old) @ T_kf_new).astype(np.float32)
        self.T_cw = (self.T_cw @ corr).astype(np.float32)
        if self._pending_kf is not None:
            self._pending_kf["T_cw"] = (
                self._pending_kf["T_cw"] @ corr).astype(np.float32)
        if self._pending:
            self._bundle_correction = (corr, len(self._pending))
        self._pose_override = self.T_cw.copy()
        self._window_dirty = True

    def _track_frame(self, feats: FrameFeatures, timestamp: float) -> bool:
        """The modular (non-fused) step: relocalization when LOST, else
        Manhattan rotation, frame-to-frame matching and pose optimization,
        then local-map tracking and the keyframe policy."""
        cfg = self.cfg
        feats_np = dt.feats_to_numpy(feats)
        if self.state == TrackingState.LOST:
            reloc = self._relocalize(feats, feats_np)
            if reloc is None:
                return False
            self.velocity = np.eye(4, dtype=np.float32)
            ok_local, cur_map_pt, cur_map_ln, _ = self._track_local_map(
                feats, feats_np, reloc)
            if not ok_local:
                return False
            self._set_last(feats, feats_np, cur_map_pt, cur_map_ln)
            self.state = TrackingState.OK
            return True
        T_pred = (self.velocity @ self.T_cw).astype(np.float32)

        # 1. Manhattan rotation tracking
        R_manh = None
        if self.R_wm is not None:
            R_cm_pred = (T_pred[:3, :3] @ self.R_wm).astype(np.float32)
            mn, mv = self._manh_obs(feats)
            res = manhattan_ops.track_manhattan_frame(
                self._dev(R_cm_pred), mn, mv,
                cone_sin=cfg.manhattan.cone_sin_track,
                kernel=cfg.manhattan.mean_shift_kernel,
                min_support=cfg.manhattan.min_axis_support)
            if bool(res.success):
                R_manh = res.R_cm.cpu().numpy() @ self.R_wm.T
                self.stats["manhattan_success"] += 1
        self.manhattan_ok = R_manh is not None

        # 2. translation estimation against the last frame
        T_init = T_pred.copy()
        if R_manh is not None:
            T_init[:3, :3] = R_manh
        last = self.last
        last_pts = dt.feats_to_numpy(last.feats).points
        has3d = (last_pts.depth > 0) & last_pts.valid
        idx = self._search_frame(last.pt3d_w, last_pts.desc, has3d, T_init,
                                 feats, radius=15.0,
                                 max_dist=cfg.matcher.th_high,
                                 level_window=cfg.orb.n_levels)
        if int((idx >= 0).sum()) < 20:
            # brute-force fallback
            idx = matching.match_descriptors(
                last.feats.points.desc, feats.points.desc,
                self._dev(has3d), feats.points.valid,
                max_dist=cfg.matcher.th_low, ratio=0.9).idx.cpu().numpy()
        idx = self._rotation_filter(last_pts.angle, idx, feats_np)
        if int((idx >= 0).sum()) >= cfg.tracking.min_matches_track:
            obs = self._point_obs_from_matches(feats_np, last.pt3d_w, idx)
            rot_fixed = R_manh is not None
            result = self._run_pose_opt(T_init, points=obs,
                                        rotation_fixed=rot_fixed)
            if rot_fixed:
                self.stats["translation_only"] += 1
            else:
                self.stats["full_pose"] += 1
            if int(result.n_point_inliers) >= cfg.tracking.min_matches_track:
                self.T_cw = result.T_cw.cpu().numpy()
            else:
                self.T_cw = T_init  # rollback
        else:
            self.T_cw = T_init

        # carry map-point associations from the last frame
        cur_map_pt = np.full(cfg.orb.max_keypoints, -1, np.int32)
        ok = idx >= 0
        cur_map_pt[idx[ok]] = last.map_pt[ok]

        # 3. track the local map
        ok_local, cur_map_pt, cur_map_ln, plane_matches = \
            self._track_local_map(feats, feats_np, cur_map_pt)
        if not ok_local:
            return False
        self.velocity = (self.T_cw @ np.linalg.inv(last.T_cw)).astype(
            np.float32)

        # 4. keyframe policy
        if self._need_new_keyframe(feats_np, cur_map_pt):
            kf = self._create_keyframe(feats_np, timestamp, cur_map_pt,
                                       cur_map_ln, plane_matches)
            self.ref_kf = kf
            self.last_kf_frame_id = self.frame_id
            self.stats["kfs"] += 1

        self._set_last(feats, feats_np, cur_map_pt, cur_map_ln)
        self.state = TrackingState.OK
        return True

    def _need_new_keyframe(self, feats_np: FrameFeatures,
                           cur_map_pt: np.ndarray) -> bool:
        """Keyframe policy of the modular path (the fused path reads the
        same statistics from the device bundle)."""
        cfg = self.cfg
        if self.only_tracking:
            return False
        if self.map.n_kf >= self.map.n_kf_slots - 1:
            return False
        frames_since = self.frame_id - self.last_kf_frame_id
        if frames_since >= cfg.tracking.max_frames_between_kf:
            return True
        if self.new_plane_flag:
            return True
        depth = feats_np.points.depth
        close = (depth > 0) & (depth < cfg.camera.depth_threshold)
        tracked_close = int((close & (cur_map_pt >= 0)).sum())
        nontracked_close = int((close & (cur_map_pt < 0)).sum())
        need_close = tracked_close < 100 and nontracked_close > 70
        min_obs = 3 if self.map.n_kf > 2 else 2
        ref_row = self.map.kf_pt_idx[self.ref_kf]
        ref_pts = ref_row[ref_row >= 0]
        ref_pts = ref_pts[self.map.pt_valid[ref_pts]]
        ref_obs = int((self.map.pt_nobs[ref_pts] >= min_obs).sum())
        n_tracked = int((cur_map_pt >= 0).sum())
        weak = n_tracked < 0.75 * max(ref_obs, 1)
        return (weak or need_close) and n_tracked > 15 and frames_since >= 1

    # ------------------------------------------------------- relocalization
    def _reloc_guided_pass(self, feats: FrameFeatures,
                           feats_np: FrameFeatures, kf_c: int,
                           T_est: np.ndarray, cur_map_pt: np.ndarray,
                           radius: float, max_dist: int):
        """One guided rematch of relocalization: project all of the
        candidate keyframe's landmarks through the pose estimate,
        window-match (radius scaled by the image width / 640), keep matches
        whose frame depth agrees with the landmark in 3D, merge with the
        existing associations and re-optimize. Returns (T, cur_map_pt,
        n_inliers)."""
        cfg = self.cfg
        m = self.map
        cam = cfg.camera
        Kp = cfg.orb.max_keypoints
        row = m.kf_pt_idx[kf_c]
        lm = np.unique(row[row >= 0])
        lm = lm[m.pt_valid[lm]][:Kp]
        if len(lm) == 0:
            return T_est, cur_map_pt, 0
        pad_ids = np.zeros(Kp, np.int64)
        pad_ids[:len(lm)] = lm
        pad_valid = np.zeros(Kp, bool)
        pad_valid[:len(lm)] = True
        idx = self._search_frame(m.pt_xyz[pad_ids], m.pt_desc[pad_ids],
                                 pad_valid, T_est, feats,
                                 radius=radius * cam.width / 640.0,
                                 max_dist=max_dist,
                                 level_window=cfg.orb.n_levels)
        ok = idx >= 0
        # 3D-consistency gate: the landmark in the estimated camera frame
        # against the feature's own backprojection
        depth_f = feats_np.points.depth
        uv_f = feats_np.points.uv
        pc_lm = m.pt_xyz[pad_ids] @ T_est[:3, :3].T + T_est[:3, 3]
        fi = np.clip(idx, 0, Kp - 1)
        z_f = depth_f[fi]
        xb = (uv_f[fi, 0] - cam.cx) / cam.fx * z_f
        yb = (uv_f[fi, 1] - cam.cy) / cam.fy * z_f
        p_f = np.stack([xb, yb, z_f], -1)
        d3 = np.linalg.norm(pc_lm - p_f, axis=-1)
        ok = ok & ((z_f <= 0) | (d3 < np.maximum(0.08, 0.05 * z_f)))
        merged = cur_map_pt.copy()
        # new matches fill features left unassociated; landmarks already
        # associated elsewhere are not assigned twice
        taken = set(int(p) for p in merged[merged >= 0])
        for s in np.flatnonzero(ok):
            f = int(idx[s])
            p = int(pad_ids[s])
            if merged[f] < 0 and p not in taken:
                merged[f] = p
                taken.add(p)
        obs = self._point_obs_from_matches(
            feats_np, m.pt_xyz[np.clip(merged, 0, None)],
            np.where(merged >= 0, np.arange(Kp), -1))
        result = self._run_pose_opt(T_est, points=obs)
        inl = result.point_inlier.cpu().numpy()
        merged = np.where(inl | (merged < 0), merged, -1)
        return (result.T_cw.cpu().numpy(), merged,
                int(result.n_point_inliers))

    @record_function("tracking.relocalize")
    def _relocalize(self, feats: FrameFeatures, feats_np: FrameFeatures
                    ) -> Optional[np.ndarray]:
        """Retrieval candidates -> descriptor seeds against each
        candidate's landmarks -> Horn RANSAC (>= 8 seeds with depth) or PnP
        RANSAC -> coarse, then fine, guided rematch -> acceptance on the
        inlier count and the coverage of the landmarks findable at the
        pose. Returns the feature -> map-point association or None."""
        from planarslam_tpu_torch.solvers.pnp import pnp_ransac
        from planarslam_tpu_torch.solvers.sim3_solver import horn_ransac_se3

        cfg = self.cfg
        m = self.map
        cam = cfg.camera
        pts = feats_np.points
        cands = self.kf_db.reloc_candidates(m, pts.desc, pts.valid)
        for c in cands:
            if not m.kf_valid[c]:
                continue
            row = m.kf_pt_idx[c]
            has_pt = (row >= 0) & m.pt_valid[np.clip(row, 0, None)]
            idx = matching.match_descriptors(
                self._dev(m.kf_desc[c]), feats.points.desc,
                self._dev(has_pt), feats.points.valid,
                max_dist=cfg.matcher.th_low, ratio=0.9).idx.cpu().numpy()
            # rotation consistency on the seed matches
            idx = self._rotation_filter(m.kf_angle[c], idx, feats_np)
            ok = idx >= 0
            if ok.sum() < 8:
                continue
            pt_ids = row[ok]
            feat_ids = idx[ok]
            z = pts.depth[feat_ids]
            has_z = z > 0
            accept = cfg.tracking.reloc_min_inliers
            if has_z.sum() >= 8:
                # 3D-3D Horn RANSAC on the frame's own depth; its consensus
                # seeds the associations, and the guided pass below widens
                # them before the first reprojection solve
                x = (pts.uv[feat_ids, 0] - cam.cx) / cam.fx * z
                y = (pts.uv[feat_ids, 1] - cam.cy) / cam.fy * z
                pc = np.stack([x, y, z], -1).astype(np.float32)[has_z]
                T, n_inl, horn_inl = horn_ransac_se3(
                    m.pt_xyz[pt_ids][has_z], pc, threshold=0.08,
                    device=self.device)
                if n_inl < 8:
                    continue
                keep = np.zeros(len(feat_ids), bool)
                keep[np.flatnonzero(has_z)[np.asarray(horn_inl, bool)]] = True
                T_est = np.asarray(T, np.float32)
                cur = np.full(cfg.orb.max_keypoints, -1, np.int32)
                cur[feat_ids[keep]] = pt_ids[keep]
            else:
                T, _, n_inl = pnp_ransac(
                    m.pt_xyz[pt_ids], pts.uv[feat_ids],
                    np.ones(len(pt_ids), bool), self.K,
                    inv_sigma2=self.inv_level_sigma2[pts.level[feat_ids]],
                    device=self.device)
                if n_inl < 8:
                    continue
                # refine over all matches (chi2 gating re-classifies)
                cur_map_pt = np.full(cfg.orb.max_keypoints, -1, np.int32)
                cur_map_pt[feat_ids] = pt_ids
                obs = self._point_obs_from_matches(
                    feats_np, m.pt_xyz[np.clip(cur_map_pt, 0, None)],
                    np.where(cur_map_pt >= 0,
                             np.arange(cfg.orb.max_keypoints), -1))
                result = self._run_pose_opt(T, points=obs)
                if int(result.n_point_inliers) < 10:
                    continue
                T_est = result.T_cw.cpu().numpy()
                inlier_mask = result.point_inlier.cpu().numpy()
                cur = np.where(inlier_mask | (cur_map_pt < 0), cur_map_pt,
                               -1)
            # coarse guided rematch: wide window, permissive threshold
            T_est, cur, n_good = self._reloc_guided_pass(
                feats, feats_np, c, T_est, cur, radius=10.0,
                max_dist=cfg.matcher.th_high)
            if n_good < 10:
                continue
            if accept // 2 <= n_good < accept:
                # narrow re-search around the improved pose
                T_est, cur, n_good = self._reloc_guided_pass(
                    feats, feats_np, c, T_est, cur, radius=3.0, max_dist=64)
            # coverage: at a correct pose the matches cover a large share
            # of the candidate's landmarks findable in the frame
            n_vis = self._n_frustum_landmarks(c, T_est, feats_np)
            if n_good >= accept and n_good >= 0.25 * max(n_vis, 1):
                self.T_cw = T_est
                self.ref_kf = c
                self.stats["relocalizations"] = \
                    self.stats.get("relocalizations", 0) + 1
                return cur
        return None

    def _n_frustum_landmarks(self, kf_c: int, T_est: np.ndarray,
                             feats_np: FrameFeatures) -> int:
        """How many of a keyframe's landmarks are findable at the pose: in
        the image, inside the scale range and viewing cone, and with a
        detected feature within the coarse guided window."""
        m = self.map
        cam = self.cfg.camera
        row = m.kf_pt_idx[kf_c]
        lm = np.unique(row[row >= 0])
        lm = lm[m.pt_valid[lm]]
        if len(lm) == 0:
            return 0
        pc = m.pt_xyz[lm] @ T_est[:3, :3].T + T_est[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        cam_center = -T_est[:3, :3].T @ T_est[:3, 3]
        vec = m.pt_xyz[lm] - cam_center
        dist = np.maximum(np.linalg.norm(vec, axis=1), 1e-6)
        in_range = ((dist >= 0.8 * m.pt_min_dist[lm])
                    & (dist <= 1.2 * m.pt_max_dist[lm]))
        cosv = (vec * m.pt_normal[lm]).sum(axis=1) / dist
        ok = ((pc[:, 2] > 0.05) & (u >= 0) & (u < cam.width)
              & (v >= 0) & (v < cam.height) & in_range & (cosv > 0.5))
        if not ok.any():
            return 0
        f_uv = feats_np.points.uv[feats_np.points.valid]
        if len(f_uv) == 0:
            return 0
        radius = 10.0 * cam.width / 640.0
        proj = np.stack([u[ok], v[ok]], -1)
        d2 = ((proj[:, None, :] - f_uv[None, :, :]) ** 2).sum(-1)
        return int((d2.min(axis=1) <= radius * radius).sum())

    # ------------------------------------------------------ local map tracking
    def _track_local_map(self, feats: FrameFeatures, feats_np: FrameFeatures,
                         cur_map_pt: np.ndarray
                         ) -> Tuple[bool, np.ndarray, np.ndarray, dict]:
        """Match the covisibility-local points and lines, associate planes
        and optimize the pose over every residual type."""
        from planarslam_tpu_torch.ops.lines import search_lines_by_projection

        cfg = self.cfg
        m = self.map

        # local KFs: voters for the matched points and their best covisibles
        matched = cur_map_pt[cur_map_pt >= 0]
        kf_ids = set()
        best_voter = -1
        if len(matched) > 0:
            obs_mask = np.isin(m.kf_pt_idx[:m.n_kf], matched) \
                & m.kf_valid[:m.n_kf, None]
            votes = obs_mask.sum(axis=1)
            voters = np.argsort(-votes)[:10]
            for k in voters:
                if votes[k] > 0:
                    kf_ids.add(int(k))
                    for c in m.covisible_kfs(int(k))[:5]:
                        kf_ids.add(int(c))
            if votes[voters[0]] > 0:
                best_voter = int(voters[0])
        if not kf_ids:
            kf_ids = {self.ref_kf}
        kf_ids = np.asarray(sorted(kf_ids), np.int32)
        if best_voter >= 0:
            self.ref_kf = best_voter

        # local points
        pt_ids = m.local_map_points(kf_ids, cap=4096)
        if len(pt_ids) == 0:
            return False, cur_map_pt, np.full(cfg.lines.max_lines, -1,
                                              np.int32), {}
        ids_p = np.pad(pt_ids, (0, 4096 - len(pt_ids)), constant_values=0)
        valid_p = np.zeros(4096, bool)
        valid_p[:len(pt_ids)] = True
        idx = self._search_frame(
            m.pt_xyz[ids_p], m.pt_desc[ids_p], valid_p, self.T_cw, feats,
            radius=4.0, max_dist=cfg.matcher.th_high, level_window=1,
            view_normals=m.pt_normal[ids_p],
            dist_range=(m.pt_min_dist[ids_p], m.pt_max_dist[ids_p]))
        found = idx >= 0
        m.point_stats_update(pt_ids, found[:len(pt_ids)])
        new_map_pt = cur_map_pt.copy()
        new_map_pt[idx[found]] = ids_p[found]

        # local lines: guided projection search at the current pose
        ln_ids = m.local_map_lines(kf_ids, cap=cfg.map.max_lines)
        cur_map_ln = np.full(cfg.lines.max_lines, -1, np.int32)
        line_obs = None
        if len(ln_ids) > 0:
            cam = cfg.camera
            lcap = cfg.map.max_lines
            ids_l = np.pad(ln_ids, (0, lcap - len(ln_ids)), constant_values=0)
            valid_l = np.zeros(lcap, bool)
            valid_l[:len(ln_ids)] = True
            ln = feats.lines
            midx, _ = search_lines_by_projection(
                self._dev(m.ln_sw[ids_l]), self._dev(m.ln_ew[ids_l]),
                self._dev(m.ln_desc[ids_l]), self._dev(valid_l),
                self._dev(self.T_cw), ln.uv_s, ln.uv_e, ln.angle, ln.desc,
                ln.valid, K=self.K, image_wh=self.wh)
            midx = midx.cpu().numpy()
            mok = midx >= 0
            cur_map_ln[midx[mok]] = ids_l[mok]
            T_wc = np.linalg.inv(self.T_cw)
            # frustum-gated visible and found statistics, the rule of the
            # fused path's _process_bundle
            mid_l = 0.5 * (m.ln_sw[ids_l] + m.ln_ew[ids_l])
            pc_l = mid_l @ self.T_cw[:3, :3].T + self.T_cw[:3, 3]
            zl = np.maximum(pc_l[:, 2], 1e-6)
            u_l = cam.fx * pc_l[:, 0] / zl + cam.cx
            v_l = cam.fy * pc_l[:, 1] / zl + cam.cy
            vis_l = (valid_l & (pc_l[:, 2] > 0.05) & (u_l >= 0)
                     & (u_l < cam.width) & (v_l >= 0)
                     & (v_l < cam.height)) | mok
            vis_l &= valid_l
            if vis_l.any():
                m.line_stats_update(ids_l[vis_l], mok[vis_l],
                                    cam_center_w=T_wc[:3, 3])
            if mok.any():
                L = cfg.lines.max_lines
                xw_s = np.zeros((L, 3), np.float32)
                xw_e = np.zeros((L, 3), np.float32)
                l2d = np.zeros((L, 3), np.float32)
                lval = np.zeros(L, bool)
                f = midx[mok]
                xw_s[f] = m.ln_sw[ids_l[mok]]
                xw_e[f] = m.ln_ew[ids_l[mok]]
                l2d[f] = feats_np.lines.line2d[f]
                lval[f] = True
                line_obs = pose_opt.LineObs(
                    xw_s=self._dev(xw_s), xw_e=self._dev(xw_e),
                    line2d=self._dev(l2d),
                    inv_sigma2=self._dev(np.ones(L, np.float32)),
                    valid=self._dev(lval))

        # plane association, then the full pose optimization
        plane_matches = self._associate_planes(feats_np)
        plane_obs, par_obs, ver_obs = self._plane_obs(feats_np, plane_matches)
        obs = self._point_obs_from_matches(
            feats_np, m.pt_xyz[np.clip(new_map_pt, 0, None)],
            np.where(new_map_pt >= 0, np.arange(cfg.orb.max_keypoints), -1))
        result = self._run_pose_opt(self.T_cw, points=obs, lines=line_obs,
                                    planes=plane_obs, par=par_obs,
                                    ver=ver_obs)
        n_in = int(result.n_point_inliers)
        self.n_inliers = n_in
        if n_in < cfg.tracking.min_matches_local_map // 2:
            return False, new_map_pt, cur_map_ln, plane_matches
        self.T_cw = result.T_cw.cpu().numpy()
        # drop the associations the optimization rejected
        inl = result.point_inlier.cpu().numpy()
        new_map_pt = np.where(inl | (new_map_pt < 0), new_map_pt, -1)
        return True, new_map_pt, cur_map_ln, plane_matches

    def _plane_obs(self, feats_np: FrameFeatures, matches: dict):
        """Direct, parallel and vertical PlaneObs blocks from the
        frame-plane -> map-plane association."""
        m = self.map
        coeffs_c = feats_np.planes.coeffs

        def block(ids):
            val = ids >= 0
            j = np.clip(ids, 0, None)
            pi_w = np.where(val[:, None], m.pl_coeffs[j], 0.0)
            pi_o = np.where(val[:, None], coeffs_c, 0.0)
            return pose_opt.PlaneObs(
                pi_w=self._dev(pi_w.astype(np.float32)),
                pi_obs=self._dev(pi_o.astype(np.float32)),
                valid=self._dev(val))

        return block(matches["direct"]), block(matches["par"]), \
            block(matches["ver"])

    # ------------------------------------------------------ plane association
    def _associate_planes(self, feats: FrameFeatures,
                          T_cw: Optional[np.ndarray] = None) -> dict:
        """Frame-plane -> map-plane association against the current map
        (host, native). Returns {"direct", "par", "ver"}: (P,) ids or -1."""
        from planarslam_tpu_torch import native

        cfg = self.cfg
        m = self.map
        P = cfg.planes.max_planes
        pl_valid = np.asarray(feats.planes.valid)
        coeffs_c = np.asarray(feats.planes.coeffs)
        direct = np.full(P, -1, np.int32)
        par = np.full(P, -1, np.int32)
        ver = np.full(P, -1, np.int32)
        idxs = np.flatnonzero(pl_valid)
        if len(idxs) == 0 or not m.pl_valid.any():
            return {"direct": direct, "par": par, "ver": ver}
        if T_cw is None:
            T_cw = self.T_cw
        T_wc_T = np.linalg.inv(T_cw).astype(np.float32)
        pi_w = plane_geo.transform_np(T_wc_T, coeffs_c[idxs])
        d, p, v = native.associate_planes(
            pi_w.astype(np.float64), m.pl_coeffs.astype(np.float64),
            m.pl_valid, m.pl_cloud, m.pl_cloud_n,
            cfg.planes.assoc_angle, cfg.planes.assoc_dist,
            cfg.planes.vertical_threshold, cfg.planes.parallel_threshold)
        direct[idxs] = d
        par[idxs] = p
        ver[idxs] = v
        return {"direct": direct, "par": par, "ver": ver}

    # ------------------------------------------------------ keyframe creation
    def _create_keyframe(self, feats: FrameFeatures, timestamp: float,
                         cur_map_pt: np.ndarray, cur_map_ln: np.ndarray,
                         plane_matches: Optional[dict],
                         T_cw: Optional[np.ndarray] = None,
                         frame_id: Optional[int] = None,
                         depth_raw: Optional[np.ndarray] = None) -> int:
        """Insert a keyframe from host (numpy) features: existing
        associations, new close map points, lines and planes."""
        cfg = self.cfg
        m = self.map
        if T_cw is None:
            T_cw = self.T_cw
        if frame_id is None:
            frame_id = self.frame_id
        if depth_raw is None:
            depth_raw = self._last_depth
        kf = m.alloc_keyframe()
        m.kf_valid[kf] = True
        m.kf_pose[kf] = T_cw
        m.kf_frame_id[kf] = frame_id
        m.kf_timestamp[kf] = timestamp
        pts = feats.points
        m.kf_uv[kf] = pts.uv
        m.kf_ur[kf] = pts.u_right
        m.kf_depth[kf] = pts.depth
        m.kf_level[kf] = pts.level
        m.kf_angle[kf] = pts.angle
        m.kf_desc[kf] = pts.desc
        m.kf_feat_valid[kf] = pts.valid
        m.kf_ln_line2d[kf] = feats.lines.line2d
        m.kf_ln_desc[kf] = feats.lines.desc
        m.kf_ln_valid[kf] = feats.lines.valid
        m.kf_ln_uv_s[kf] = feats.lines.uv_s
        m.kf_ln_uv_e[kf] = feats.lines.uv_e
        m.kf_ln_angle[kf] = feats.lines.angle
        m.kf_pl_coeffs[kf] = feats.planes.coeffs

        T_wc = np.linalg.inv(T_cw).astype(np.float32)

        m.kf_pt_idx[kf] = cur_map_pt
        obs_pts = cur_map_pt[cur_map_pt >= 0]
        m.pt_nobs[obs_pts] += 1

        # new close map points: all closer than thDepth, at least the 100
        # closest overall
        depth = pts.depth
        cand = np.flatnonzero(pts.valid & (depth > 0) & (cur_map_pt < 0))
        if len(cand) > 0:
            order = cand[np.argsort(depth[cand])]
            close_mask = depth[order] < cfg.camera.depth_threshold
            n_keep = max(int(close_mask.sum()), min(100, len(order)))
            new_feats = order[:n_keep]
            pw = unproject_points(pts, cfg, T_wc)[new_feats]
            ids = m.alloc_points(len(new_feats))
            m.pt_xyz[ids] = pw
            m.pt_desc[ids] = pts.desc[new_feats]
            vec = pw - T_wc[:3, 3]
            dist = np.linalg.norm(vec, axis=1)
            m.pt_normal[ids] = vec / np.maximum(dist[:, None], 1e-9)
            lvl = pts.level[new_feats]
            sf = cfg.orb.scale_factor
            m.pt_max_dist[ids] = dist * (sf ** lvl) * 1.2
            m.pt_min_dist[ids] = (m.pt_max_dist[ids] / (sf ** cfg.orb.n_levels)
                                  * 0.8)
            m.pt_valid[ids] = True
            m.pt_nobs[ids] = 1
            m.pt_found[ids] = 1
            m.pt_visible[ids] = 1
            m.pt_first_kf[ids] = kf
            m.kf_pt_idx[kf, new_feats] = ids

        self._enrich_kf_associations(kf)

        # lines: carry matches, create map lines for unmatched 3D lines
        m.kf_ln_idx[kf] = cur_map_ln
        has3d = feats.lines.has_3d & feats.lines.valid
        new_ln = np.flatnonzero(has3d & (cur_map_ln < 0))
        if len(new_ln) > 0:
            ids = m.alloc_lines(len(new_ln))
            ps = feats.lines.p3d_s[new_ln]
            pe = feats.lines.p3d_e[new_ln]
            m.ln_sw[ids] = ps @ T_wc[:3, :3].T + T_wc[:3, 3]
            m.ln_ew[ids] = pe @ T_wc[:3, :3].T + T_wc[:3, 3]
            m.ln_desc[ids] = feats.lines.desc[new_ln]
            m.ln_valid[ids] = True
            m.ln_nobs[ids] = 1
            m.ln_first_kf[ids] = kf
            m.ln_found[ids] = 1
            m.ln_visible[ids] = 1
            mid = 0.5 * (m.ln_sw[ids] + m.ln_ew[ids]) - T_wc[:3, 3]
            m.ln_view_dir[ids] = mid / np.maximum(
                np.linalg.norm(mid, axis=1, keepdims=True), 1e-9)
            m.kf_ln_idx[kf, new_ln] = ids
        obs_ln = cur_map_ln[cur_map_ln >= 0]
        m.ln_nobs[obs_ln] += 1

        # planes: add observations / create new map planes
        self.new_plane_flag = False
        coeffs_c = feats.planes.coeffs
        lbl = feats.planes.pixel_label
        if plane_matches is None:
            none = np.full(cfg.planes.max_planes, -1, np.int32)
            plane_matches = {"direct": none, "par": none, "ver": none}
        cam = cfg.camera
        for i in np.flatnonzero(feats.planes.valid):
            pi_w = plane_geo.transform_np(T_wc, coeffs_c[i])
            j = plane_matches["direct"][i]
            if j < 0:
                j = m.alloc_plane()
                m.pl_valid[j] = True
                m.pl_coeffs[j] = pi_w
                m.pl_nobs[j] = 0
                m.pl_first_kf[j] = kf
                self.new_plane_flag = True
            m.pl_nobs[j] += 1
            m.kf_pl_idx[kf, i] = j
            ys, xs = np.nonzero(lbl == i)
            if len(ys) > 0:
                sub = slice(0, None, max(1, len(ys) // 512))
                zz = self._depth_metres_at(depth_raw, ys[sub], xs[sub])
                okz = zz > 0
                px = (xs[sub][okz] - cam.cx) / cam.fx * zz[okz]
                py = (ys[sub][okz] - cam.cy) / cam.fy * zz[okz]
                pc = np.stack([px, py, zz[okz]], axis=-1).astype(np.float32)
                m.add_plane_cloud(j, pc @ T_wc[:3, :3].T + T_wc[:3, 3])
                m.refit_plane(j)
        m.kf_pl_par_idx[kf] = plane_matches["par"]
        m.kf_pl_ver_idx[kf] = plane_matches["ver"]

        m.update_covisibility(kf)
        return kf

    def _enrich_kf_associations(self, kf: int) -> int:
        """Bind the new keyframe to every local-map point it sees: a fuse
        search of the visible, not yet associated map points into the
        keyframe (one device call)."""
        from planarslam_tpu_torch.slam.device_mapper import run_fuse_set

        m = self.map
        cfg = self.cfg
        cam = cfg.camera
        row = m.kf_pt_idx[kf]
        taken = set(int(p) for p in row[row >= 0])
        cand = np.flatnonzero(m.pt_valid)
        if len(cand) == 0:
            return 0
        T = m.kf_pose[kf]
        pc = m.pt_xyz[cand] @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        vis = ((z > 0.05) & (u >= 0) & (u < cam.width)
               & (v >= 0) & (v < cam.height))
        cand = cand[vis & ~np.isin(cand, list(taken))]
        if len(cand) == 0:
            return 0
        if len(cand) > cfg.orb.max_keypoints:
            d = np.linalg.norm(m.pt_xyz[cand] - (-T[:3, :3].T @ T[:3, 3]),
                               axis=1)
            cand = cand[np.argsort(d)][:cfg.orb.max_keypoints]
        res = run_fuse_set(m, cand, [kf], cfg, radius=6.0, device=self.device)
        idx = res["idx"][0]
        ok = (idx >= 0) & res["lm_valid"]
        added = 0
        for s in np.flatnonzero(ok):
            p = int(res["lm_ids"][s])
            f = int(idx[s])
            if m.kf_pt_idx[kf, f] >= 0 or p in taken:
                continue
            m.kf_pt_idx[kf, f] = p
            m.pt_nobs[p] += 1
            taken.add(p)
            added += 1
        return added
