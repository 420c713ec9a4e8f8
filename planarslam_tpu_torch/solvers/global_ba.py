"""Global bundle adjustment over points + line endpoints + planes.

Port of ``planarslam_tpu/solvers/global_ba.py``: all keyframes (up to the
caps) and all landmark types, the first keyframe fixed, a Huber stage, an
outlier purge and a second stage, then spanning-tree propagation of the
correction to keyframes outside the window and re-anchoring of landmarks
outside the caps. The dense-Schur ``ba_core.ba_solve`` (K8, K9, K33-K35)
holds up to MAX_GBA_KF keyframes; above that the matrix-free
``ba_pcg.ba_solve_pcg`` (K8, K33, K34) takes one problem of up to
MAX_GBA_KF_PCG. Spans: global_ba.build_tables and each global_ba.ba_solve.
"""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.solvers.ba_core import BAWeights, ba_solve
from planarslam_tpu_torch.solvers.local_ba import (_put, build_line_tables,
                                                   build_plane_tables,
                                                   build_point_tables, gated,
                                                   purge_masks)

MAX_GBA_KF = 128
MAX_GBA_PTS = 12288
MAX_GBA_LNS = 256
MAX_GBA_PLS = 64
# beyond the dense-Schur window the matrix-free PCG solver takes over; only
# past this does the spanning-tree out-of-window propagation act
MAX_GBA_KF_PCG = 512


@record_function("global_ba.global_bundle_adjustment")
def global_bundle_adjustment(slam_map, cfg: SystemConfig, n_iters: int = 12,
                             device="cuda") -> None:
    device = resolve_device(device)
    m = slam_map
    K = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    bf = cfg.camera.bf
    w = BAWeights.from_config(cfg.planes)
    ids = [int(k) for k in m.valid_kf_ids()]
    if len(ids) < 3:
        return
    use_pcg = len(ids) > MAX_GBA_KF
    kf_cap = MAX_GBA_KF_PCG if use_pcg else MAX_GBA_KF
    if len(ids) > kf_cap:
        # keep KF0 and the most recent window; the older poses follow
        # through the spanning tree
        ids = [ids[0]] + ids[-(kf_cap - 1):]
    pt_ids = m.local_map_points(np.asarray(ids), cap=MAX_GBA_PTS)
    if len(pt_ids) < 50:
        return
    ln_ids = m.local_map_lines(np.asarray(ids), cap=MAX_GBA_LNS)
    pl_rows = m.kf_pl_idx[np.asarray(ids)]
    pl_ids = np.unique(pl_rows[pl_rows >= 0])
    pl_ids = pl_ids[m.pl_valid[pl_ids]][:MAX_GBA_PLS]

    Kt = kf_cap
    n_real = len(ids)
    fixed_mask = np.ones(Kt, np.float32)
    fixed_mask[:n_real] = 0.0
    fixed_mask[0] = 1.0  # gauge: first keyframe fixed

    with record_function("global_ba.build_tables"):
        pt_tab, _ = build_point_tables(m, ids, Kt, pt_ids, cfg, device)
        P_pts = MAX_GBA_PTS
        ln_tab, _ = build_line_tables(m, ids, Kt, ln_ids, P_pts, cfg,
                                      device)
        pl_tab, par_tab, ver_tab, _ = build_plane_tables(m, ids, Kt, pl_ids,
                                                         cfg, device)

        P_total = P_pts + 2 * MAX_GBA_LNS
        lm = np.zeros((P_total, 3), np.float32)
        lm[:len(pt_ids)] = m.pt_xyz[pt_ids]
        lm[P_pts + 0:P_pts + 2 * len(ln_ids):2] = m.ln_sw[ln_ids]
        lm[P_pts + 1:P_pts + 2 * len(ln_ids):2] = m.ln_ew[ln_ids]
        plane_base = np.zeros((MAX_GBA_PLS, 4), np.float32)
        plane_base[:, 2] = 1.0
        plane_base[:len(pl_ids)] = m.pl_coeffs[pl_ids]

        poses0 = np.tile(np.eye(4, dtype=np.float32), (Kt, 1, 1))
        poses0[:n_real] = m.kf_pose[ids].astype(np.float32)

        solver = ba_solve
        if use_pcg:
            from planarslam_tpu_torch.solvers.ba_pcg import ba_solve_pcg
            solver = ba_solve_pcg

        fixed_t = _put(fixed_mask, device)
        args = (_put(poses0, device), fixed_t, _put(lm, device),
                _put(plane_base, device))

    with record_function("global_ba.ba_solve"):
        poses1, lm1, planes1, chis = solver(
            *args, pt_tab, ln_tab, pl_tab, par_tab, ver_tab, K, bf, w,
            n_iters=n_iters)
        chis = {k: v.cpu().numpy() for k, v in chis.items()}
    keep, _ = purge_masks(chis, pt_tab.ur.cpu().numpy(), Kt, w)
    tabs = [gated(t, k) for t, k in zip(
        (pt_tab, ln_tab, pl_tab, par_tab, ver_tab), keep)]
    with record_function("global_ba.ba_solve"):
        poses_out, lm_out, planes_out, _ = solver(
            poses1, fixed_t, lm1, planes1, *tabs, K, bf, w,
            n_iters=max(4, n_iters // 2))
        poses_out = poses_out.cpu().numpy()

    lm_out = lm_out.cpu().numpy()
    planes_out = planes_out.cpu().numpy()

    # pre-correction poses: landmarks outside the caps follow their anchor
    poses_before_all = m.kf_pose.copy()

    # spanning-tree propagation for keyframes outside the window
    optimized = {k: i for i, k in enumerate(ids)}
    for k in m.valid_kf_ids():
        k = int(k)
        if k in optimized:
            continue
        p = int(m.kf_parent[k])
        hops = 0
        while p >= 0 and p not in optimized and hops < 64:
            p = int(m.kf_parent[p])
            hops += 1
        if p in optimized:
            # the child stays rigid relative to its parent
            m.kf_pose[k] = (m.kf_pose[k] @ np.linalg.inv(m.kf_pose[p])
                            @ poses_out[optimized[p]]).astype(np.float32)
    for i, k in enumerate(ids):
        m.kf_pose[k] = poses_out[i]
    m.pt_xyz[pt_ids] = lm_out[:len(pt_ids)]
    if len(ln_ids):
        m.ln_sw[ln_ids] = lm_out[P_pts + 0:P_pts + 2 * len(ln_ids):2]
        m.ln_ew[ln_ids] = lm_out[P_pts + 1:P_pts + 2 * len(ln_ids):2]
    if len(pl_ids):
        m.pl_coeffs[pl_ids] = planes_out[:len(pl_ids)]

    # re-anchor landmarks outside the caps: x' = T_new^-1 T_old x
    def reanchor(out_ids, first_kf):
        if len(out_ids) == 0:
            return None
        anchors = np.empty(len(out_ids), np.int64)
        cache: dict = {}
        for i, k in enumerate(first_kf):
            k = int(max(k, 0))
            if k not in cache:
                cache[k] = m.resolve_kf(k)[0]
            anchors[i] = cache[k]
        before = poses_before_all[anchors]
        after = m.kf_pose[anchors]
        return np.einsum("nij,njk->nik", np.linalg.inv(after), before)

    all_pts = np.flatnonzero(m.pt_valid)
    out_pts = np.setdiff1d(all_pts, pt_ids, assume_unique=False)
    corr = reanchor(out_pts, m.pt_first_kf[out_pts])
    if corr is not None:
        h = np.concatenate([m.pt_xyz[out_pts],
                            np.ones((len(out_pts), 1), np.float32)], axis=1)
        m.pt_xyz[out_pts] = np.einsum("nij,nj->ni", corr, h)[:, :3]
    all_lns = np.flatnonzero(m.ln_valid)
    out_lns = np.setdiff1d(all_lns, ln_ids, assume_unique=False)
    corr_l = reanchor(out_lns, m.ln_first_kf[out_lns])
    if corr_l is not None:
        for arr in (m.ln_sw, m.ln_ew):
            h = np.concatenate([arr[out_lns],
                                np.ones((len(out_lns), 1), np.float32)],
                               axis=1)
            arr[out_lns] = np.einsum("nij,nj->ni", corr_l, h)[:, :3]

