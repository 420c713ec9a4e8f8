"""Batched multi-sequence replay on one card.

Port of ``planarslam_tpu/parallel/replay.py``. The JAX module runs B
sequences as ``jax.vmap`` of the per-frame step and shards the batch over a
device mesh (``make_mesh``, ``NamedSharding``). One H100 has no counterpart
of the mesh, so neither is ported: here the B sequences are the leading
batch dimension of every kernel of the step on one card, each kernel
launched once for all of them (``slam/device_tracker.py``).

``make_batched_frame_step`` builds the visual-odometry step (extraction,
Manhattan tracking, projection matching and pose optimization of B frames
at once); ``run_batched_replay`` replays B sequences with it.
``BatchedSLAM`` runs B complete SLAM systems whose per-frame tracking
step is one batched ``fused_track_step``; the host policy (keyframes,
local mapping, loop closing, relocalization) stays per sequence.

Every entry point takes ``device`` (default ``"cuda"``) and raises without
a card (``planarslam_tpu_torch.device.resolve_device``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.ops import manhattan as manhattan_ops
from planarslam_tpu_torch.ops import matching
from planarslam_tpu_torch.slam import device_tracker as dt
from planarslam_tpu_torch.slam.frame import extract_frame, unproject_points
from planarslam_tpu_torch.solvers import pose_opt


def _single_frame_step(gray, depth, T_init, R_cm_prev, prev_pts_w, prev_desc,
                       prev_valid, cfg: SystemConfig):
    """B sequences' visual-odometry step, every input with a leading B:
    extract + Manhattan + match + pose-optimize. Host-side policy stays per
    sequence; this is the dense compute slab. Returns (T_cw (B, 4, 4), R_cm
    (B, 3, 3), the features, point inliers (B,))."""
    feats = extract_frame(gray, depth, cfg)
    manh = manhattan_ops.track_manhattan_frame(
        R_cm_prev, feats.normals, feats.normals_valid,
        cone_sin=cfg.manhattan.cone_sin_track,
        kernel=cfg.manhattan.mean_shift_kernel,
        min_support=cfg.manhattan.min_axis_support)
    pts = feats.points
    res = matching.search_by_projection(
        prev_pts_w, prev_desc, prev_valid, T_init, pts.uv, pts.desc,
        pts.level, pts.valid, pts.u_right,
        K=(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy),
        image_wh=(float(cfg.camera.width), float(cfg.camera.height)),
        bf=cfg.camera.bf, scale_factor=cfg.orb.scale_factor,
        radius=15.0, max_dist=cfg.matcher.th_high,
        level_window=cfg.orb.n_levels)
    k = cfg.orb.max_keypoints
    matched = res.idx >= 0
    fi = torch.clamp(res.idx, 0, k - 1).to(torch.int64)
    uv_o = torch.take_along_dim(pts.uv, fi[..., None], dim=1)
    ur_o = torch.take_along_dim(pts.u_right, fi, dim=1)
    obs = pose_opt.PointObs(
        xw=prev_pts_w, uv=uv_o, u_right=torch.where(matched, ur_o, -1.0),
        inv_sigma2=torch.ones(matched.shape, dtype=torch.float32,
                              device=matched.device),
        valid=matched)
    result = pose_opt.pose_optimize(
        T_init, (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy),
        cfg.camera.bf, points=obs,
        weights=pose_opt.PoseOptWeights.from_config(cfg.planes))
    return result.T_cw, manh.R_cm, feats, result.n_point_inliers


def make_batched_frame_step(cfg: SystemConfig, device=None):
    """The multi-sequence visual-odometry step on `device`.

    Returns (step_fn, to_device) where step_fn(gray (B, H, W), depth,
    T_init (B, 4, 4), R_cm (B, 3, 3), prev_pts_w (B, K, 3), prev_desc (B,
    K, 8), prev_valid (B, K)) -> (T_cw (B, 4, 4), R_cm (B, 3, 3), n_inliers
    (B,)), and to_device puts a numpy array on the step's device (uint32
    descriptors as int32 bit patterns)."""
    dev = resolve_device(device)

    def step(gray, depth, T_init, R_cm, pts_w, desc, valid):
        T, R, _, n_in = _single_frame_step(gray, depth, T_init, R_cm, pts_w,
                                           desc, valid, cfg)
        return T, R, n_in

    def to_device(x) -> torch.Tensor:
        return dt._tensor_from(x, dev)

    return step, to_device


def run_batched_replay(sequences, cfg: SystemConfig,
                       device=None) -> np.ndarray:
    """Replay B synthetic sequences in parallel (visual odometry over the
    previous frame's unprojected features). Returns (B, N, 4, 4) estimated
    T_cw trajectories."""
    _, put = make_batched_frame_step(cfg, device)
    B = len(sequences)
    n = min(len(s) for s in sequences)
    k = cfg.orb.max_keypoints
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    R_cm = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    pts_w = np.zeros((B, k, 3), np.float32)
    desc = np.zeros((B, k, 8), np.uint32)
    valid = np.zeros((B, k), bool)
    out = np.zeros((B, n, 4, 4), np.float32)
    for i in range(n):
        renders = [s.render(i) for s in sequences]
        gray = put(np.stack([np.asarray(r[0], np.float32) for r in renders]))
        depth = put(np.stack([np.asarray(r[1], np.float32) for r in renders]))
        if i == 0:
            feats = extract_frame(gray, depth, cfg)
        else:
            T_j, R_j, feats, _ = _single_frame_step(
                gray, depth, put(T), put(R_cm), put(pts_w), put(desc),
                put(valid), cfg)
            T = T_j.cpu().numpy()
            R_cm = R_j.cpu().numpy()
        out[:, i] = T
        # next-frame references on the host, per sequence
        pts = dt.feats_to_numpy(feats).points
        for b in range(B):
            fb = type(pts)(*[a[b] for a in pts])
            pts_w[b] = unproject_points(fb, cfg, np.linalg.inv(T[b]))
            desc[b] = fb.desc
            valid[b] = fb.valid & (fb.depth > 0)
    return out


class SmallParams:
    """The per-lane small parameters of a batched step as one byte buffer
    (one upload): T_override (B, 4, 4) float32, R_wm (B, 3, 3) float32,
    use_override (B,) and manh_enabled (B,) bool, in that order. On the
    device each is a view of the uploaded buffer: no launch."""

    def __init__(self, B: int):
        self.B = B
        self.nbytes = B * (64 + 36 + 2)

    def host(self, T_override, use_override, R_wm, manh_enabled,
             pin: bool) -> torch.Tensor:
        buf = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=pin)
        a = buf.numpy()
        B = self.B
        a[:64 * B].view(np.float32)[:] = np.asarray(
            T_override, np.float32).reshape(-1)
        a[64 * B:100 * B].view(np.float32)[:] = np.asarray(
            R_wm, np.float32).reshape(-1)
        a[100 * B:101 * B] = np.asarray(use_override, bool)
        a[101 * B:] = np.asarray(manh_enabled, bool)
        return buf

    def views(self, buf: torch.Tensor):
        """(T_override, use_override, R_wm, manh_enabled) of an uploaded
        buffer."""
        B = self.B
        return (buf[:64 * B].view(torch.float32).view(B, 4, 4),
                buf[100 * B:101 * B].view(torch.bool),
                buf[64 * B:100 * B].view(torch.float32).view(B, 3, 3),
                buf[101 * B:].view(torch.bool))


class BatchedSLAM:
    """B complete SLAM systems on one card: per-sequence tracking state
    machines, keyframing, local mapping and loop closing on the host; the
    per-frame tracking step of all B sequences (extraction, Manhattan
    tracking, the two-stage pose optimization, window matching) is one
    batched ``fused_track_step_packed``, each kernel launched once for all
    lanes (BASELINE config 5: several TUM / ICL replays at once).

    Host policy is per sequence (System / Tracking / LocalMapping /
    LoopClosing instances); a sequence that is initializing or lost takes
    its own host path for that frame and rejoins the batch when fused
    tracking resumes.
    """

    def __init__(self, cfg: SystemConfig, n_sequences: int, device=None):
        from planarslam_tpu_torch.slam.system import System

        self.cfg = cfg
        self.B = n_sequences
        self.device = resolve_device(device)
        self.systems = [System(config=cfg, device=self.device)
                        for _ in range(n_sequences)]
        self._small = SmallParams(n_sequences)
        self._weights = pose_opt.PoseOptWeights.from_config(cfg.planes)
        # the carried state and windows of the B lanes, stacked on the
        # device between steps
        self._bstate: Optional[dt.LastState] = None
        self._bwin: Optional[torch.Tensor] = None    # (B, S)
        self._lane_live = [False] * n_sequences      # _bstate[b] is current
        self._win_fresh = [False] * n_sequences      # _bwin[b] is current
        # dispatch epoch per lane, bumped whenever the lane leaves the
        # batch (host path): a drain must not apply a bundle dispatched
        # before the bump, since the lane may have collapsed and recovered
        # in between and the stale bundle would clobber its rebuilt state
        self._lane_epoch = [0] * n_sequences
        self._inflight: list = []    # depth-1 dispatch/drain pipeline
        self.pipeline_depth = 1
        self.stats = {"fused_lane_frames": 0, "host_lane_frames": 0,
                      "padded_lane_frames": 0, "batched_steps": 0}
        # per-span host seconds of track (assign a defaultdict(list))
        self.prof = None

    def enable_profile(self) -> None:
        self.prof = defaultdict(list)

    # ----------------------------------------------------------- stepping
    def track(self, grays, depths, timestamps) -> np.ndarray:
        """One frame for every sequence. grays / depths: (B, H, W) arrays
        or per-sequence lists; timestamps: (B,). Returns (B, 4, 4) poses
        (fused lanes lag by the dispatch pipeline; the records hold the
        exact per-frame trajectory after flush).

        Per step: one stacked frame upload, one small-parameter upload,
        one batched step, one pull of the (B, bundle) result (pipelined),
        and a window upload and lane insert where a lane (re)joins or
        refreshed its window."""
        from planarslam_tpu_torch.slam.tracking import TrackingState, _HostPull

        prof = self.prof
        tp0 = time.perf_counter()

        def lap(key):
            nonlocal tp0
            if prof is not None:
                tp1 = time.perf_counter()
                prof[key].append(tp1 - tp0)
                tp0 = tp1

        B = self.B
        poses = np.zeros((B, 4, 4), np.float32)
        fused, host = [], []
        for b, s in enumerate(self.systems):
            tr = s.tracker
            if tr.state == TrackingState.OK and tr._fused_state is not None:
                fused.append(b)
            else:
                host.append(b)
        # initializing / lost sequences: their own host path this frame
        for b in host:
            poses[b] = self.systems[b].track_rgbd(
                grays[b], depths[b], float(timestamps[b]))
            self._lane_live[b] = False
            self._win_fresh[b] = False
            self._lane_epoch[b] += 1
        if not fused:
            return poses
        self.stats["fused_lane_frames"] += len(fused)
        self.stats["host_lane_frames"] += len(host)
        self.stats["padded_lane_frames"] += B - len(fused)
        self.stats["batched_steps"] += 1
        lap("host_lanes")

        # ---- frames: one stacked pinned buffer, one upload. The batch is
        # always padded to B lanes; a lane that is not in it replays a
        # fused lane's frame and state (its outputs are dropped)
        pin = self.device.type == "cuda"
        src = [b if b in fused else fused[0] for b in range(B)]
        g0, d0 = np.asarray(grays[src[0]]), np.asarray(depths[src[0]])
        packed = g0.dtype == np.uint8 and d0.dtype == np.uint16
        if packed:
            buf = torch.empty((B, 3, *g0.shape), dtype=torch.uint8,
                              pin_memory=pin)
            a = buf.numpy()
            for b in range(B):
                a[b] = dt.pack_frame(np.asarray(grays[src[b]]),
                                     np.asarray(depths[src[b]]))
            frame_args = (buf.to(self.device, non_blocking=True),)
        else:
            frame_args = tuple(
                torch.from_numpy(np.stack([np.asarray(x[src[b]], np.float32)
                                           for b in range(B)])
                                 ).to(self.device)
                for x in (grays, depths))
        lap("frame_upload")

        # ---- small per-lane parameters: one upload
        T_ovr = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        use_ovr = np.zeros(B, bool)
        R_wm = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        manh = np.zeros(B, bool)
        for b in fused:
            tr = self.systems[b].tracker
            if tr._pose_override is not None:
                T_ovr[b] = tr._pose_override
                use_ovr[b] = True
                tr._pose_override = None
            if tr.R_wm is not None:
                R_wm[b] = tr.R_wm
                manh[b] = True
        small = self._small.views(self._small.host(
            T_ovr, use_ovr, R_wm, manh, pin).to(self.device,
                                                non_blocking=True))
        lap("small_upload")

        # ---- carried state and windows: stacked device residents
        for b in fused:
            tr = self.systems[b].tracker
            tr._last_depth = np.asarray(depths[b])
            if tr._window_dirty or tr._window is None:
                tr._refresh_window()
                self._win_fresh[b] = False
        if self._bstate is None:
            trs = [self.systems[b].tracker for b in src]
            self._bstate = dt.stack_states([tr._fused_state for tr in trs])
            self._bwin = torch.cat([tr._window for tr in trs])
            for b in fused:
                self._lane_live[b] = self._win_fresh[b] = True
        for b in fused:
            tr = self.systems[b].tracker
            if not self._lane_live[b]:
                # the lane (re)joins with its host-path state (B = 1)
                dt.insert_lane(self._bstate, tr._fused_state, b)
                self._lane_live[b] = True
                self._win_fresh[b] = False
            if not self._win_fresh[b]:
                self._bwin[b:b + 1].copy_(tr._window)
                self._win_fresh[b] = True
        lap("state_win_insert")

        step = (dt.fused_track_step_packed if packed
                else dt.fused_track_step)
        res = step(*frame_args, *small, self._bstate, self._bwin,
                   self._weights, self.cfg)
        lap("dispatch")
        # the carry stays stacked on the device
        self._bstate = res.new_state
        self._inflight.append({
            "pull": _HostPull(res.packed), "state_stack": res.new_state,
            "lanes": list(fused),
            "epochs": [self._lane_epoch[b] for b in fused],
            "timestamps": [float(timestamps[b]) for b in fused],
            "depths": [np.asarray(depths[b]) for b in fused]})
        while len(self._inflight) > self.pipeline_depth:
            self._drain_one()
        lap("drain")
        for b in fused:
            poses[b] = self.systems[b].tracker.T_cw
        return poses

    def _drain_one(self) -> None:
        """Apply the oldest in-flight batched step to the lanes' hosts: the
        (B, bundle) result is pulled once, then each lane's row goes to its
        System."""
        from planarslam_tpu_torch.slam.tracking import TrackingState

        e = self._inflight.pop(0)
        packed_np = e["pull"].result()
        for i, b in enumerate(e["lanes"]):
            s = self.systems[b]
            tr = s.tracker
            if (tr.state != TrackingState.OK or tr._fused_state is None
                    or self._lane_epoch[b] != e["epochs"][i]):
                # the lane collapsed since dispatch (and may be recovering
                # on its host path): the stale bundle must not touch it
                continue
            tr._last_depth = e["depths"][i]
            s.submit_fused_result(
                dt.StepResult(packed=packed_np[b], new_state=None),
                e["timestamps"][i], state_stack=e["state_stack"], lane=b)

    def flush(self) -> None:
        """Drain the batched dispatch pipeline (end of replay)."""
        while self._inflight:
            self._drain_one()

    def run(self, sequences, timestamps: Optional[np.ndarray] = None
            ) -> np.ndarray:
        """Replay B sequences end to end; returns (B, N, 4, 4) T_cw."""
        n = min(len(s) for s in sequences)
        out = np.zeros((self.B, n, 4, 4), np.float32)
        for i in range(n):
            renders = [s.render(i) for s in sequences]
            ts = (timestamps[:, i] if timestamps is not None
                  else np.full(self.B, float(i) / 30.0))
            out[:, i] = self.track([r[0] for r in renders],
                                   [r[1] for r in renders], ts)
        self.flush()
        for s in self.systems:
            s.shutdown()
        return out
