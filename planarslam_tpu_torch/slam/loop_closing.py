"""Loop closing: retrieval, geometric verification, correction.

Port of ``planarslam_tpu/slam/loop_closing.py``, host orchestration in
numpy as there:

  - detection: the keyframe's LSH sketch against the database
    (``retrieval.KeyFrameDatabase.loop_candidates``), with count-based
    temporal consistency over neighbouring candidate ids;
  - verification: descriptor matching (K3), a Horn RANSAC SE3 between the
    two keyframes' depth points (K6), a bidirectional-reprojection
    refinement (K32), a guided projection rematch (K3) and a second
    refinement;
  - correction: the pose graph (K10), landmark re-anchoring, the fuse of
    duplicated landmarks across the loop (K3) and global BA (K8, K9,
    K33-K35).
Spans: loop_closing.verify (verify_match, verify_ransac, verify_refine
twice, verify_guided_search) and loop_closing.correct (pose_graph.optimize,
reanchor, search_and_fuse with its device call fuse_search and its host
merge fuse_merge, global BA).

Every device call goes to the loop closer's device: a call that fell back
to a helper's CPU default would run quietly on the host beside a card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.slam.map import SlamMap
from planarslam_tpu_torch.slam.retrieval import KeyFrameDatabase


class LoopClosing:
    def __init__(self, cfg: SystemConfig, slam_map: SlamMap,
                 kf_db: Optional[KeyFrameDatabase] = None,
                 run_gba: bool = True, device="cuda"):
        self.cfg = cfg
        self.map = slam_map
        self.db = kf_db or KeyFrameDatabase(cfg)
        self.device = resolve_device(device)
        self._consistency: dict[int, int] = {}  # candidate kf -> streak
        self.loops_closed = 0
        self.last_fuse_count = 0
        self.last_loop_kf = -10 ** 9
        # global BA runs after every essential-graph correction
        self.run_gba = run_gba
        self.stats = {"verifications": 0, "pose_graphs": 0, "gba_calls": 0}

    # ------------------------------------------------------------- detection
    @record_function("loop_closing.process_keyframe")
    def process_keyframe(self, kf: int) -> Optional[int]:
        m = self.map
        self.db.add(m, kf)
        if kf < self.cfg.loop.min_kf_gap:
            return None
        if kf - self.last_loop_kf < self.cfg.loop.min_kf_gap:
            return None

        cand = self.db.loop_candidates(m, kf)

        # temporal consistency streaks
        new_streaks: dict[int, int] = {}
        for c in cand:
            near = [c + d for d in range(-2, 3)]
            prev = max((self._consistency.get(n, 0) for n in near), default=0)
            new_streaks[c] = prev + 1
        self._consistency = new_streaks

        for c, streak in new_streaks.items():
            if streak >= self.cfg.loop.consistency_threshold:
                if self._verify_and_correct(kf, c):
                    self.loops_closed += 1
                    self.last_loop_kf = kf
                    self._consistency.clear()
                    return c
        return None

    # ----------------------------------------------------------- verification
    def _verify_and_correct(self, kf: int, loop_kf: int) -> bool:
        from planarslam_tpu_torch.ops import matching
        from planarslam_tpu_torch.slam.device_tracker import _tensor_from
        from planarslam_tpu_torch.solvers.sim3_solver import (
            horn_ransac_se3, refine_relative_se3)

        m = self.map
        cfg = self.cfg
        dev = self.device
        self.stats["verifications"] += 1

        def put(a):
            return _tensor_from(a, dev)

        with record_function("loop_closing.verify"):
            with record_function("loop_closing.verify_match"):
                res = matching.match_descriptors(
                    put(m.kf_desc[kf]), put(m.kf_desc[loop_kf]),
                    put(m.kf_feat_valid[kf] & (m.kf_depth[kf] > 0)),
                    put(m.kf_feat_valid[loop_kf]
                        & (m.kf_depth[loop_kf] > 0)),
                    max_dist=cfg.matcher.th_low, ratio=0.85)
                idx = res.idx.cpu().numpy()
            ok = idx >= 0
            if ok.sum() < cfg.loop.sim3_min_inliers:
                return False

            cam = cfg.camera

            def unproject(k, feat_ids):
                uv = m.kf_uv[k][feat_ids]
                z = m.kf_depth[k][feat_ids]
                x = (uv[:, 0] - cam.cx) / cam.fx * z
                y = (uv[:, 1] - cam.cy) / cam.fy * z
                return np.stack([x, y, z], -1).astype(np.float32)

            src_ids = np.flatnonzero(ok)
            pts_kf = unproject(kf, src_ids)               # current KF camera
            pts_loop = unproject(loop_kf, idx[src_ids])   # loop KF camera
            # T maps loop-camera coordinates to current-camera coordinates
            with record_function("loop_closing.verify_ransac"):
                T_kl, n_inl, inl = horn_ransac_se3(pts_loop, pts_kf,
                                                   device=dev)
            if n_inl < cfg.loop.sim3_min_inliers:       # first gate
                return False

            # refine the loop edge with bidirectional reprojection
            K = (cam.fx, cam.fy, cam.cx, cam.cy)
            with record_function("loop_closing.verify_refine"):
                T_kl, _ = refine_relative_se3(
                    T_kl.astype(np.float32), pts_kf, pts_loop,
                    m.kf_uv[kf][src_ids], m.kf_uv[loop_kf][idx[src_ids]],
                    inl.astype(np.float32), K, device=dev)

            # guided rematch: all loop-KF depth features projected into the
            # current KF through the refined transform, window-matched
            Kp = cfg.orb.max_keypoints
            all_loop = np.flatnonzero(m.kf_feat_valid[loop_kf]
                                      & (m.kf_depth[loop_kf] > 0))[:Kp]
            pad_ids = np.zeros(Kp, np.int64)
            pad_ids[:len(all_loop)] = all_loop
            pad_valid = np.zeros(Kp, bool)
            pad_valid[:len(all_loop)] = True
            pc_loop_all = unproject(loop_kf, pad_ids)
            with record_function("loop_closing.verify_guided_search"):
                res2 = matching.search_by_projection(
                    put(pc_loop_all), put(m.kf_desc[loop_kf][pad_ids]),
                    put(pad_valid), put(np.asarray(T_kl, np.float32)),
                    put(m.kf_uv[kf].astype(np.float32)), put(m.kf_desc[kf]),
                    put(m.kf_level[kf].astype(np.int32)),
                    put(m.kf_feat_valid[kf]),
                    put(m.kf_ur[kf].astype(np.float32)), K=K,
                    image_wh=(float(cam.width), float(cam.height)),
                    bf=cam.bf, scale_factor=cfg.orb.scale_factor,
                    radius=7.5, max_dist=cfg.matcher.th_high,
                    level_window=1)
                g_idx = res2.idx.cpu().numpy()
            g_ok = (g_idx >= 0) & pad_valid
            if int(g_ok.sum()) < cfg.loop.min_total_matches:  # second gate
                return False
            # re-refine over the guided matches
            pts_loop_g = pc_loop_all[g_ok]
            z_g = m.kf_depth[kf][g_idx[g_ok]]
            uv_g = m.kf_uv[kf][g_idx[g_ok]]
            has_zg = z_g > 0
            if has_zg.sum() >= cfg.loop.sim3_min_inliers:
                x = (uv_g[:, 0] - cam.cx) / cam.fx * z_g
                y = (uv_g[:, 1] - cam.cy) / cam.fy * z_g
                pts_kf_g = np.stack([x, y, z_g], -1).astype(np.float32)
                with record_function("loop_closing.verify_refine"):
                    T_kl, _ = refine_relative_se3(
                        T_kl.astype(np.float32), pts_kf_g[has_zg],
                        pts_loop_g[has_zg].astype(np.float32), uv_g[has_zg],
                        m.kf_uv[loop_kf][pad_ids][g_ok][has_zg],
                        np.ones(int(has_zg.sum()), np.float32), K,
                        device=dev)

            # corrected current pose through the loop:
            # T_kf_w = T_kf_loop T_loop_w
            T_c_w_corr = (T_kl @ m.kf_pose[loop_kf]).astype(np.float32)

            # persist the accepted constraint for every later pose-graph run
            m.add_loop_edge(kf, loop_kf, T_kl)

            # an already consistent loop is recorded without moving the map
            dT = T_c_w_corr @ np.linalg.inv(m.kf_pose[kf])
            dt = np.linalg.norm(dT[:3, 3])
            dR = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
            if dt < 0.03 and dR < np.deg2rad(0.5):
                return True
        with record_function("loop_closing.correct"):
            self._correct(kf, T_c_w_corr, loop_kf)
        return True

    # ------------------------------------------------------------- correction
    def _correct(self, kf: int, T_cw_corrected: np.ndarray, loop_kf: int
                 ) -> None:
        """Pose graph, landmark re-anchoring, fuse, global BA."""
        from planarslam_tpu_torch.solvers.pose_graph import \
            optimize_pose_graph

        m = self.map
        ids = m.valid_kf_ids()
        pt_ids = np.flatnonzero(m.pt_valid)
        # anchors whose keyframe was culled resolve to the nearest valid
        # ancestor (the cull-time relative cancels in before/after)
        resolve_cache: dict[int, int] = {}

        def resolved(kids):
            out = np.empty(len(kids), np.int64)
            for i, k in enumerate(kids):
                k = int(k)
                if k not in resolve_cache:
                    resolve_cache[k] = m.resolve_kf(k)[0]
                out[i] = resolve_cache[k]
            return out

        pt_anchor = resolved(np.clip(m.pt_first_kf[pt_ids], 0, None))
        anchor_before = m.kf_pose[pt_anchor].copy()
        ln_ids = np.flatnonzero(m.ln_valid)
        ln_anchor = resolved(np.clip(m.ln_first_kf[ln_ids], 0, None))
        ln_before = m.kf_pose[ln_anchor].copy()

        new_poses = optimize_pose_graph(
            m, kf_corrected=kf, T_corrected=T_cw_corrected, loop_kf=loop_kf,
            cfg=self.cfg, device=self.device)
        self.stats["pose_graphs"] += 1
        m.kf_pose[ids] = new_poses[ids]

        # re-anchor landmarks: x' = Twc_new Tcw_old x
        def correction(anchor_ids, before):
            return np.einsum("nij,njk->nik",
                             np.linalg.inv(m.kf_pose[anchor_ids]), before)

        with record_function("loop_closing.reanchor"):
            corr = correction(pt_anchor, anchor_before)
            xyz_h = np.concatenate([m.pt_xyz[pt_ids],
                                    np.ones((len(pt_ids), 1), np.float32)],
                                   axis=1)
            m.pt_xyz[pt_ids] = np.einsum("nij,nj->ni", corr, xyz_h)[:, :3]
            corr_l = correction(ln_anchor, ln_before)
            for arr in (m.ln_sw, m.ln_ew):
                h = np.concatenate([arr[ln_ids],
                                    np.ones((len(ln_ids), 1), np.float32)],
                                   axis=1)
                arr[ln_ids] = np.einsum("nij,nj->ni", corr_l, h)[:, :3]

        with record_function("loop_closing.search_and_fuse"):
            self._search_and_fuse(kf, loop_kf)

        if self.run_gba:
            from planarslam_tpu_torch.solvers.global_ba import \
                global_bundle_adjustment

            global_bundle_adjustment(m, self.cfg, device=self.device)
            self.stats["gba_calls"] += 1

    def _search_and_fuse(self, kf: int, loop_kf: int) -> None:
        """Fuse duplicated landmarks across the closed loop: project the
        loop side's landmarks into the corrected current-side keyframes; a
        feature that already has a landmark is merged into the loop-side
        one, otherwise the association is added."""
        from planarslam_tpu_torch.slam.device_mapper import run_fuse_set

        m = self.map
        loop_group = [loop_kf] + [int(c) for c in
                                  m.covisible_kfs(loop_kf)[:4]]
        rows = m.kf_pt_idx[np.asarray(loop_group)]
        lm_ids = np.unique(rows[rows >= 0])
        lm_ids = lm_ids[m.pt_valid[lm_ids]]
        if len(lm_ids) == 0:
            return
        # prefer well-observed landmarks over capacity
        if len(lm_ids) > self.cfg.orb.max_keypoints:
            lm_ids = lm_ids[np.argsort(-m.pt_nobs[lm_ids])][
                :self.cfg.orb.max_keypoints]
        targets = [kf] + [int(c) for c in m.covisible_kfs(kf)[:4]]
        targets = [t for t in targets if t not in loop_group]
        if not targets:
            return
        with record_function("loop_closing.fuse_search"):
            res = run_fuse_set(m, lm_ids, targets, self.cfg, radius=4.0,
                               device=self.device)
        with record_function("loop_closing.fuse_merge"):
            fused = 0
            for i, nb in enumerate(res["nb_ids"]):
                if not res["nb_ok"][i]:
                    continue
                nb = int(nb)
                idx = res["idx"][i]
                for s in np.flatnonzero(idx >= 0):
                    p = int(res["lm_ids"][s])
                    if not m.pt_valid[p]:
                        continue  # merged away in an earlier iteration
                    f = int(idx[s])
                    q = int(m.kf_pt_idx[nb, f])
                    if q == p:
                        continue
                    if q >= 0 and m.pt_valid[q]:
                        # the current-side point is replaced by the loop side's
                        m.replace_point(q, p)
                        fused += 1
                    else:
                        m.kf_pt_idx[nb, f] = p
                        m.pt_nobs[p] += 1
                m.update_covisibility(nb)
            self.last_fuse_count = fused
