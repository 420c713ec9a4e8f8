"""Local mapping: the per-keyframe backend stage.

Port of ``planarslam_tpu/slam/local_mapping.py``, host numpy as there; the
dense work is the keyframe's mapping step on the device
(``device_mapper.dispatch_mapping_step``) and the line fuse
(``ops/lines.search_lines_by_projection``). Stages:

  - point, line and plane culling (found/visible ratio or too few
    observations shortly after creation), and the coplanar plane merge;
  - begin_keyframe dispatches the mapping step; finish_keyframe joins it
    and applies the point and line triangulations and the fuse, fuses
    lines, re-elects landmark descriptors and culls redundant keyframes;
  - with ``enable_local_ba`` (off by default, as in the JAX package and
    the reference's shipped state), local bundle adjustment of the
    keyframe's covisibility window follows (``solvers/local_ba.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.slam.device_tracker import _tensor_from
from planarslam_tpu_torch.slam.map import SlamMap

def _observation_groups(obs_idx, lm_valid, obs_desc, kf: int, neigh: list):
    """The observations, in the keyframes `neigh`, of the valid landmarks
    that keyframe kf observes. obs_idx (n_kf, F) feature -> landmark id or
    -1; obs_desc (n_kf, F, D) descriptors. Returns [(landmark id, (n_obs,
    D) descriptors)] for the landmarks seen at least 3 times, or None when
    kf observes no valid landmark or none is seen in `neigh`."""
    row = obs_idx[kf]
    feats = np.flatnonzero(row >= 0)
    own = row[feats][lm_valid[row[feats]]]
    if len(own) == 0:
        return None
    lut = np.full(lm_valid.shape[0], -1, np.int64)
    lut[own] = np.arange(len(own))
    pool_i, pool_d = [], []
    for other in neigh:
        rowk = obs_idx[other]
        sel = np.flatnonzero(rowk >= 0)
        li = lut[rowk[sel]]
        hit = li >= 0
        if hit.any():
            pool_i.append(li[hit])
            pool_d.append(obs_desc[other, sel[hit]])
    if not pool_i:
        return None
    pi = np.concatenate(pool_i)
    pd = np.concatenate(pool_d)
    order = np.argsort(pi, kind="stable")
    pi, pd = pi[order], pd[order]
    starts = np.searchsorted(pi, np.arange(len(own)))
    ends = np.searchsorted(pi, np.arange(len(own)) + 1)
    return [(own[i], pd[starts[i]:ends[i]]) for i in range(len(own))
            if ends[i] - starts[i] >= 3]


class LocalMapping:
    def __init__(self, cfg: SystemConfig, slam_map: SlamMap,
                 enable_local_ba: bool = False, device="cuda"):
        self.cfg = cfg
        self.enable_local_ba = enable_local_ba
        self.map = slam_map
        self.device = resolve_device(device)
        # recently created landmarks awaiting the culling probation window
        self._recent_pts: dict[int, int] = {}  # point id -> created-at KF
        self._recent_lns: dict[int, int] = {}
        self._recent_pls: dict[int, int] = {}
        # what the mapping steps did, for reports
        self.stats = {"mapping_steps": 0, "triangulated_points": 0,
                      "triangulated_lines": 0, "fused_points": 0,
                      "culled_kfs": 0, "local_ba": 0}
        # begin_keyframe dispatches the mapping step and parks its pull
        # here; finish_keyframe joins and applies it
        self._pending: Optional[dict] = None

    def process_keyframe(self, kf: int) -> None:
        """Synchronous begin + finish."""
        self.begin_keyframe(kf)
        self.finish_keyframe()

    def begin_keyframe(self, kf: int) -> None:
        """Probation bookkeeping, landmark culling, and the dispatch of the
        keyframe's mapping step."""
        from planarslam_tpu_torch.slam.device_mapper import \
            dispatch_mapping_step

        m = self.map
        for p in np.flatnonzero((m.pt_first_kf == kf) & m.pt_valid):
            self._recent_pts[int(p)] = kf
        for ln in np.flatnonzero((m.ln_first_kf == kf) & m.ln_valid):
            self._recent_lns[int(ln)] = kf
        for p in np.flatnonzero((m.pl_first_kf == kf) & m.pl_valid):
            self._recent_pls[int(p)] = kf

        self._cull_points(kf)
        self._cull_lines(kf)
        self._cull_planes(kf)
        if len(m.covisible_kfs(kf)) > 0:
            self._pending = dispatch_mapping_step(m, kf, self.cfg,
                                                  device=self.device)
            self.stats["mapping_steps"] += 1
        else:
            self._pending = {"kf": kf, "no_dispatch": True}

    def finish_keyframe(self) -> None:
        """Join the pending mapping step, apply it, cull keyframes, then
        run local BA when enabled. No-op when nothing is pending. Must run
        before anything that moves keyframe rows (slot compaction): results
        are applied by id."""
        from planarslam_tpu_torch.slam.device_mapper import join_mapping_step

        pending = self._pending
        if pending is None:
            return
        self._pending = None
        m = self.map
        kf = pending["kf"]
        if not m.kf_valid[kf]:
            return  # culled while the step was in flight
        with record_function("local_mapping.finish_keyframe"):
            if not pending.get("no_dispatch"):
                res = join_mapping_step(pending)
                self._apply_triangulation(kf, res)
                self._apply_line_triangulation(kf, res)
                self._apply_fuse(kf, res)
                self._fuse_lines(kf)
                self._update_distinctive_descriptors(kf)
            self._cull_keyframes(kf)
        if self.enable_local_ba and m.n_kf >= 3:
            from planarslam_tpu_torch.solvers.local_ba import \
                local_bundle_adjustment

            local_bundle_adjustment(m, kf, self.cfg, device=self.device)
            self.stats["local_ba"] += 1

    # ----------------------------------------------------- point creation
    def _apply_triangulation(self, kf: int, res: dict) -> None:
        """Create far map points observed by the new keyframe and one
        neighbour (RGB-D close points come from depth at insertion;
        triangulation adds the depthless ones)."""
        m = self.map
        cfg = self.cfg
        T1 = m.kf_pose[kf]
        c1 = -T1[:3, :3].T @ T1[:3, 3]
        free = res["own_free"].copy()
        for i, nb in enumerate(res["nb_ids"]):
            if not res["tri_ok"][i]:
                continue
            nb = int(nb)
            sel = np.flatnonzero(res["tri_good"][i] > 0)
            sel = sel[free[sel]]  # an earlier neighbour may have claimed them
            f2 = res["tri_idx"][i][sel]
            still_free = m.kf_pt_idx[nb, f2] < 0
            sel, f2 = sel[still_free], f2[still_free]
            if len(sel) == 0:
                continue
            X = res["tri_x"][i][sel]
            try:
                ids = m.alloc_points(len(sel))
            except RuntimeError:
                return
            m.pt_xyz[ids] = X
            m.pt_desc[ids] = m.kf_desc[kf][sel]
            vec = X - c1
            dist = np.linalg.norm(vec, axis=1)
            m.pt_normal[ids] = vec / np.maximum(dist[:, None], 1e-9)
            lvl = m.kf_level[kf][sel]
            sf = cfg.orb.scale_factor
            m.pt_max_dist[ids] = dist * (sf ** lvl) * 1.2
            m.pt_min_dist[ids] = m.pt_max_dist[ids] / \
                (sf ** cfg.orb.n_levels) * 0.8
            m.pt_valid[ids] = True
            m.pt_nobs[ids] = 2
            m.pt_found[ids] = 1
            m.pt_visible[ids] = 1
            m.pt_first_kf[ids] = kf
            m.kf_pt_idx[kf, sel] = ids
            m.kf_pt_idx[nb, f2] = ids
            free[sel] = False
            for p in ids:
                self._recent_pts[int(p)] = kf
            self.stats["triangulated_points"] += len(ids)

    def _apply_line_triangulation(self, kf: int, res: dict) -> None:
        """Create map lines from the two-view plane-plane triangulation of
        free 2D segments (lines beyond depth range or over invalid depth)."""
        m = self.map
        T_wc = np.linalg.inv(m.kf_pose[kf])
        created = 0
        taken_nb: set[tuple[int, int]] = set()
        for i, nb in enumerate(res["nb_ids"]):
            if not res["nb_ok"][i]:
                continue
            nb = int(nb)
            good = res["ln_tri_good"][i] > 0
            for s in np.flatnonzero(good):
                if int(m.kf_ln_idx[kf, s]) >= 0:
                    continue  # created via an earlier neighbour
                f2 = int(res["ln_tri_idx"][i, s])
                if (nb, f2) in taken_nb or int(m.kf_ln_idx[nb, f2]) >= 0:
                    continue
                ln = int(m.alloc_lines(1)[0])
                m.ln_sw[ln] = res["ln_tri_s"][i, s]
                m.ln_ew[ln] = res["ln_tri_e"][i, s]
                m.ln_desc[ln] = m.kf_ln_desc[kf, s]
                m.ln_valid[ln] = True
                m.ln_nobs[ln] = 2
                m.ln_first_kf[ln] = kf
                m.ln_found[ln] = 1
                m.ln_visible[ln] = 1
                mid = 0.5 * (m.ln_sw[ln] + m.ln_ew[ln]) - T_wc[:3, 3]
                m.ln_view_dir[ln] = mid / max(np.linalg.norm(mid), 1e-9)
                m.kf_ln_idx[kf, s] = ln
                m.kf_ln_idx[nb, f2] = ln
                taken_nb.add((nb, f2))
                self._recent_lns[ln] = kf
                created += 1
        self.stats["triangulated_lines"] += created

    # ---------------------------------------------------------------- fuse
    def _apply_fuse(self, kf: int, res: dict) -> None:
        """Merge duplicate landmarks and add missed associations in the
        covisible neighbours from the step's projection matches."""
        m = self.map
        own = m.kf_pt_idx[kf]
        for i, nb in enumerate(res["nb_ids"]):
            if not res["nb_ok"][i]:
                continue
            nb = int(nb)
            idx = res["fuse_idx"][i]
            for s in np.flatnonzero(idx >= 0):
                p = int(own[s])
                # re-check every iteration: replace_point in an earlier
                # iteration may have invalidated p
                if p < 0 or not m.pt_valid[p]:
                    continue
                f = int(idx[s])
                q = int(m.kf_pt_idx[nb, f])
                if q == p:
                    continue
                if q >= 0 and m.pt_valid[q]:
                    # duplicate: keep the better-observed landmark
                    keep, drop = (p, q) if m.pt_nobs[p] >= m.pt_nobs[q] \
                        else (q, p)
                    m.replace_point(drop, keep)
                    self.stats["fused_points"] += 1
                else:
                    m.kf_pt_idx[nb, f] = p
                    m.pt_nobs[p] += 1

    # ----------------------------------------------------------------- points
    def _cull_points(self, kf: int) -> None:
        m = self.map
        drop = []
        erase = []
        for p, born in list(self._recent_pts.items()):
            if not m.pt_valid[p]:
                drop.append(p)
                continue
            age = kf - born
            ratio = m.pt_found[p] / max(m.pt_visible[p], 1)
            if m.pt_visible[p] >= 3 and ratio < 0.25:
                erase.append(p)
                drop.append(p)
            elif age >= 2 and m.pt_nobs[p] <= 2:
                erase.append(p)
                drop.append(p)
            elif age >= 3:
                drop.append(p)  # graduated
        if erase:
            m.erase_point(np.asarray(erase))
        for p in drop:
            self._recent_pts.pop(p, None)

    def _cull_lines(self, kf: int) -> None:
        m = self.map
        drop = []
        erase = []
        for ln, born in list(self._recent_lns.items()):
            if not m.ln_valid[ln]:
                drop.append(ln)
                continue
            age = kf - born
            ratio = m.ln_found[ln] / max(m.ln_visible[ln], 1)
            if ratio < 0.25 and m.ln_visible[ln] >= 3:
                erase.append(ln)
                drop.append(ln)
            elif age >= 2 and m.ln_nobs[ln] <= 1:
                erase.append(ln)
                drop.append(ln)
            elif age >= 3:
                drop.append(ln)
        if erase:
            m.erase_line(np.asarray(erase))
        for ln in drop:
            self._recent_lns.pop(ln, None)

    def _fuse_lines(self, kf: int) -> None:
        """Project this keyframe's map lines into each neighbour; a hit on a
        segment bound to a different map line merges the two (the better
        observed id wins), an unbound hit adds the association."""
        from planarslam_tpu_torch.ops.lines import search_lines_by_projection

        m = self.map
        cam = self.cfg.camera
        own = m.kf_ln_idx[kf]
        own_ids = np.unique(own[own >= 0])
        own_ids = own_ids[m.ln_valid[own_ids]]
        if len(own_ids) == 0:
            return
        cap = self.cfg.map.max_lines
        ids_l = np.zeros(cap, np.int64)
        ids_l[:len(own_ids)] = own_ids[:cap]
        valid_l = np.zeros(cap, bool)
        valid_l[:len(own_ids)] = True

        def put(a):
            return _tensor_from(a, self.device)

        for nb in [int(c) for c in m.covisible_kfs(kf)[:4]]:
            idx, _ = search_lines_by_projection(
                put(m.ln_sw[ids_l]), put(m.ln_ew[ids_l]),
                put(m.ln_desc[ids_l]), put(valid_l), put(m.kf_pose[nb]),
                put(m.kf_ln_uv_s[nb]), put(m.kf_ln_uv_e[nb]),
                put(m.kf_ln_angle[nb]), put(m.kf_ln_desc[nb]),
                put(m.kf_ln_valid[nb]),
                K=(cam.fx, cam.fy, cam.cx, cam.cy),
                image_wh=(float(cam.width), float(cam.height)), radius=8.0)
            idx = idx.cpu().numpy()
            for s in np.flatnonzero(idx >= 0):
                p = int(ids_l[s])
                if not m.ln_valid[p]:  # merged away earlier this loop
                    continue
                f = int(idx[s])
                q = int(m.kf_ln_idx[nb, f])
                if q == p:
                    continue
                if q >= 0 and m.ln_valid[q]:
                    keep, dropped = (p, q) if m.ln_nobs[p] >= m.ln_nobs[q] \
                        else (q, p)
                    m.replace_line(dropped, keep)
                else:
                    m.kf_ln_idx[nb, f] = p
                    m.ln_nobs[p] += 1

    # ----------------------------------------------------------------- planes
    def _cull_planes(self, kf: int) -> None:
        """Probation culling of recent planes, then the O(P^2) coplanar
        merge (keep the earlier, more observed one)."""
        m = self.map
        cfg = self.cfg.planes
        drop = []
        for p, born in list(self._recent_pls.items()):
            if not m.pl_valid[p]:
                drop.append(p)
            elif kf - born >= 2 and m.pl_nobs[p] <= 1:
                m.erase_plane(p)
                drop.append(p)
            elif kf - born >= 3:
                drop.append(p)  # graduated
        for p in drop:
            self._recent_pls.pop(p, None)
        ids = np.flatnonzero(m.pl_valid)
        for a_i in range(len(ids)):
            for b_i in range(a_i + 1, len(ids)):
                a, b = int(ids[a_i]), int(ids[b_i])
                if not (m.pl_valid[a] and m.pl_valid[b]):
                    continue
                na = m.pl_coeffs[a, :3] / max(
                    np.linalg.norm(m.pl_coeffs[a, :3]), 1e-9)
                nb = m.pl_coeffs[b, :3] / max(
                    np.linalg.norm(m.pl_coeffs[b, :3]), 1e-9)
                if abs(float(na @ nb)) < cfg.assoc_angle:
                    continue
                d = m.plane_min_dist_to_cloud(m.pl_coeffs[a], b)
                if d < cfg.assoc_dist:
                    self._merge_planes(a, b)

    def _merge_planes(self, keep: int, drop: int) -> None:
        """Replace `drop` with `keep` in the direct, parallel and vertical
        observation tables."""
        m = self.map
        n = int(m.pl_cloud_n[drop])
        if n > 0:
            m.add_plane_cloud(keep, m.pl_cloud[drop, :n])
        for table in (m.kf_pl_idx, m.kf_pl_par_idx, m.kf_pl_ver_idx):
            table[table == drop] = keep
        m.pl_nobs[keep] += m.pl_nobs[drop]
        m.pl_valid[drop] = False
        m.refit_plane(keep)

    def _update_distinctive_descriptors(self, kf: int) -> None:
        """Re-elect each landmark's descriptor as the medoid of its
        observations in the keyframe's covisibility neighbourhood (minimal
        median distance to the others; Hamming for points, cosine for
        lines)."""
        m = self.map
        neigh = [kf] + [int(c) for c in m.covisible_kfs(kf)[:12]]
        neigh = [k for k in neigh if m.kf_valid[k]]
        groups = _observation_groups(m.kf_pt_idx, m.pt_valid, m.kf_desc, kf,
                                     neigh)
        if groups is None:
            return  # as the JAX package: then no line is re-elected either
        for p, D in groups:
            bits = np.unpackbits(D.view(np.uint8), axis=1)
            ham = (bits[:, None, :] != bits[None, :, :]).sum(-1)
            m.pt_desc[p] = D[int(np.argmin(np.median(ham, axis=1)))]
        for ln, D in _observation_groups(m.kf_ln_idx, m.ln_valid,
                                         m.kf_ln_desc, kf, neigh) or ():
            dist = 1.0 - D @ D.T
            m.ln_desc[ln] = D[int(np.argmin(np.median(dist, axis=1)))]

    # -------------------------------------------------------------- keyframes
    def _cull_keyframes(self, kf: int) -> None:
        """A local keyframe is redundant when >= 90% of its points are seen
        by >= 3 other keyframes at the same or a finer scale level; never
        the origin keyframe, nor one that introduced a plane. Observers are
        counted over the candidate's covisibility row at min_weight=1."""
        m = self.map
        n_pts_cap = m.pt_valid.shape[0]
        for cand in m.covisible_kfs(kf):
            cand = int(cand)
            if cand == 0 or not m.kf_valid[cand]:
                continue
            if (m.pl_first_kf[m.pl_valid] == cand).any():
                continue
            row = m.kf_pt_idx[cand]
            feats = np.flatnonzero(row >= 0)
            feats = feats[m.pt_valid[row[feats]]]
            if len(feats) < 20:
                continue
            own = row[feats]
            lvls = m.kf_level[cand, feats]
            lut = np.full(n_pts_cap, -1, np.int64)
            lut[own] = np.arange(len(own))
            counts = np.zeros(len(own), np.int32)
            observers = set(int(c) for c in m.covisible_kfs(cand,
                                                            min_weight=1))
            observers.add(kf)
            for other in sorted(observers):
                if other == cand or not m.kf_valid[other]:
                    continue
                rowk = m.kf_pt_idx[other]
                sel = np.flatnonzero(rowk >= 0)
                li = lut[rowk[sel]]
                hit = li >= 0
                if not hit.any():
                    continue
                # scale rule: observer level <= own level + 1
                lev_ok = m.kf_level[other, sel[hit]] <= lvls[li[hit]] + 1
                counts += np.bincount(li[hit][lev_ok], minlength=len(own)
                                      ).astype(np.int32)
            if (counts >= 3).mean() > 0.9:
                m.cull_keyframe(cand)
                m.pt_nobs[own] -= 1
                # Only the point observations are detached. The JAX
                # package leaves the culled keyframe's line and plane
                # observations behind (a fault of the reference, ROADMAP
                # queue C); the port keeps that behaviour for parity until
                # both packages are fixed together.
                m.kf_pt_idx[cand] = -1
                self.stats["culled_kfs"] += 1
