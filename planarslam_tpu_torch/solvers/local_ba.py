"""Local bundle adjustment over points + line endpoints + planes.

Port of ``planarslam_tpu/solvers/local_ba.py``: the covisibility-local
window of keyframe poses plus the point, line-endpoint and plane landmarks
they observe, with fixed anchor keyframes, in the two-stage schedule (5
iterations, outlier purge, 10 more iterations) and write-back of poses,
landmarks and erased outlier observations. The tables are gathered on the
host (numpy, as in JAX) and the solve runs on the map's device
(``ba_core.ba_solve``, kernels K8, K9 and K33-K35 on a card; each solve
in a local_ba.ba_solve span).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch.config import PlaneConfig, SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.solvers import ba_core
from planarslam_tpu_torch.solvers.ba_core import (CHI2_MONO, CHI2_STEREO,
                                                  BAWeights, LineTables,
                                                  PlaneTables, PointTables,
                                                  ba_solve)

MAX_LOCAL_KF = 8
MAX_FIXED_KF = 8
MAX_LOCAL_PTS = 2048
MAX_LOCAL_LNS = 128   # line landmarks -> 256 endpoint blocks
MAX_LOCAL_PLS = 32


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_point_tables(m, all_kfs: List[int], Kt: int, pt_ids: np.ndarray,
                       cfg: SystemConfig, device
                       ) -> Tuple[PointTables, np.ndarray]:
    """Vectorized observation-table gather (no per-feature Python loops)."""
    slot_lut = np.full(m.pt_xyz.shape[0], -1, np.int32)
    slot_lut[pt_ids] = np.arange(len(pt_ids), dtype=np.int32)
    kf_arr = np.asarray(all_kfs)
    rows = m.kf_pt_idx[kf_arr]
    obs_slot = np.where(rows >= 0, slot_lut[np.clip(rows, 0, None)], -1)
    s2 = (1.0 / cfg.orb.scale_factor ** (
        2 * np.arange(cfg.orb.n_levels))).astype(np.float32)
    obs_uv = m.kf_uv[kf_arr].astype(np.float32)
    obs_ur = np.where(obs_slot >= 0, m.kf_ur[kf_arr], -1.0).astype(np.float32)
    obs_is2 = s2[m.kf_level[kf_arr]].astype(np.float32)

    def pad(a, fill):
        out = np.full((Kt,) + a.shape[1:], fill, a.dtype)
        out[:len(kf_arr)] = a
        return out

    obs_slot = pad(obs_slot, -1).astype(np.int32)
    tables = PointTables(
        slot=_put(obs_slot, device), uv=_put(pad(obs_uv, 0.0), device),
        ur=_put(pad(obs_ur, -1.0), device),
        inv_s2=_put(pad(obs_is2, 1.0), device),
        mask=_put((obs_slot >= 0).astype(np.float32), device))
    return tables, obs_slot


def build_line_tables(m, all_kfs: List[int], Kt: int, ln_ids: np.ndarray,
                      n_xyz_pts: int, cfg: SystemConfig, device
                      ) -> Tuple[LineTables, np.ndarray]:
    """Line-endpoint tables: line id -> two xyz landmark slots after the
    points (start = n_pts + 2i, end = n_pts + 2i + 1)."""
    L = cfg.lines.max_lines
    slot_lut = np.full(m.ln_sw.shape[0], -1, np.int32)
    slot_lut[ln_ids] = np.arange(len(ln_ids), dtype=np.int32)
    kf_arr = np.asarray(all_kfs)
    rows = m.kf_ln_idx[kf_arr]
    lslot = np.where(rows >= 0, slot_lut[np.clip(rows, 0, None)], -1)
    ep_slot = np.full((len(kf_arr), 2 * L), -1, np.int32)
    ep_slot[:, 0::2] = np.where(lslot >= 0, n_xyz_pts + 2 * lslot, -1)
    ep_slot[:, 1::2] = np.where(lslot >= 0, n_xyz_pts + 2 * lslot + 1, -1)
    line2d = np.repeat(m.kf_ln_line2d[kf_arr], 2, axis=1).astype(np.float32)

    def pad(a, fill):
        out = np.full((Kt,) + a.shape[1:], fill, a.dtype)
        out[:len(kf_arr)] = a
        return out

    ep_slot = pad(ep_slot, -1)
    tables = LineTables(
        slot=_put(ep_slot, device), line2d=_put(pad(line2d, 0.0), device),
        inv_s2=torch.ones((Kt, 2 * L), dtype=torch.float32, device=device),
        mask=_put((ep_slot >= 0).astype(np.float32), device))
    return tables, ep_slot


def build_plane_tables(m, all_kfs: List[int], Kt: int, pl_ids: np.ndarray,
                       cfg: SystemConfig, device):
    """Direct, parallel and vertical plane observation tables from the
    keyframes' stored per-frame plane detections (kf_pl_coeffs)."""
    Pp = cfg.planes.max_planes
    slot_lut = np.full(m.pl_coeffs.shape[0], -1, np.int32)
    slot_lut[pl_ids] = np.arange(len(pl_ids), dtype=np.int32)
    kf_arr = np.asarray(all_kfs)

    def table_for(idx_table):
        rows = idx_table[kf_arr]
        slot = np.where(rows >= 0, slot_lut[np.clip(rows, 0, None)], -1)
        out_slot = np.full((Kt, Pp), -1, np.int32)
        out_slot[:len(kf_arr)] = slot
        out_pi = np.zeros((Kt, Pp, 4), np.float32)
        out_pi[:len(kf_arr)] = m.kf_pl_coeffs[kf_arr].astype(np.float32)
        # plane slots with zero coefficients (no detection) are invalid
        has_obs = (np.abs(out_pi).sum(-1) > 1e-6) & (out_slot >= 0)
        out_slot = np.where(has_obs, out_slot, -1).astype(np.int32)
        return PlaneTables(slot=_put(out_slot, device),
                           pi_obs=_put(out_pi, device),
                           mask=_put(has_obs.astype(np.float32), device)), \
            out_slot

    direct, direct_slot = table_for(m.kf_pl_idx)
    par, _ = table_for(m.kf_pl_par_idx)
    ver, _ = table_for(m.kf_pl_ver_idx)
    return direct, par, ver, direct_slot


def gated(t, keep: np.ndarray):
    """Tables with the observations outside `keep` masked off."""
    return t._replace(mask=t.mask * _put(keep.astype(np.float32),
                                         t.mask.device))


def purge_masks(chis: dict, pt_ur: np.ndarray, Kt: int, w: BAWeights):
    """Per-table inlier masks of the two-stage schedule: points at 5.991
    mono / 7.815 stereo, a line's two endpoints together at 2 x 5.991,
    planes at Plane.Chi / VPChi. Returns (pt, ln, pl, par, ver) masks and
    the point gate."""
    gate = np.where(pt_ur >= 0, CHI2_STEREO, CHI2_MONO)
    pt_in = np.asarray(chis["pt"]) <= gate
    chi_ln = np.asarray(chis["ln"]).reshape(Kt, -1, 2).sum(-1)
    ln_in = np.repeat(chi_ln <= 2 * CHI2_MONO, 2, axis=1)
    pl_in = np.asarray(chis["pl"]) <= np.float32(w.plane_chi)
    par_in = np.asarray(chis["par"]) <= np.float32(w.vp_chi)
    ver_in = np.asarray(chis["ver"]) <= np.float32(w.vp_chi)
    return (pt_in, ln_in, pl_in, par_in, ver_in), gate


@record_function("local_ba.local_bundle_adjustment")
def local_bundle_adjustment(slam_map, kf: int, cfg: SystemConfig,
                            device="cuda") -> None:
    """Gather the local window from the map, run the two-stage schedule on
    `device`, write back poses, points, lines and planes and erase the
    outlier point observations."""
    device = resolve_device(device)
    m = slam_map
    K = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    bf = cfg.camera.bf
    w = BAWeights.from_config(cfg.planes)

    local = [kf] + [int(c) for c in m.covisible_kfs(kf)[:MAX_LOCAL_KF - 1]]
    local = [k for k in local if m.kf_valid[k]]
    pt_ids = m.local_map_points(np.asarray(local), cap=MAX_LOCAL_PTS)
    if len(pt_ids) < 30 or len(local) < 2:
        return
    ln_ids = m.local_map_lines(np.asarray(local), cap=MAX_LOCAL_LNS)
    pl_rows = m.kf_pl_idx[np.asarray(local)]
    pl_ids = np.unique(pl_rows[pl_rows >= 0])
    pl_ids = pl_ids[m.pl_valid[pl_ids]][:MAX_LOCAL_PLS]

    # fixed keyframes: observe local points but are not local
    fixed = []
    for other in m.valid_kf_ids():
        if int(other) in local:
            continue
        o = m.kf_pt_idx[other]
        if np.isin(o[o >= 0], pt_ids).any():
            fixed.append(int(other))
        if len(fixed) >= MAX_FIXED_KF:
            break
    all_kfs = local + fixed
    Kt = MAX_LOCAL_KF + MAX_FIXED_KF
    n_real = len(all_kfs)
    fixed_mask = np.ones(Kt, np.float32)  # padding fixed
    for i, k in enumerate(all_kfs):
        fixed_mask[i] = 1.0 if (k in fixed or k == 0) else 0.0
    if fixed_mask[:n_real].sum() == 0:
        fixed_mask[int(np.argmin(local))] = 1.0  # gauge

    pt_tab, _ = build_point_tables(m, all_kfs, Kt, pt_ids, cfg, device)
    # landmark layout: [points | line endpoints] then plane blocks
    P_pts = MAX_LOCAL_PTS
    ln_tab, _ = build_line_tables(m, all_kfs, Kt, ln_ids, P_pts, cfg, device)
    pl_tab, par_tab, ver_tab, _ = build_plane_tables(m, all_kfs, Kt, pl_ids,
                                                     cfg, device)

    P_total = P_pts + 2 * MAX_LOCAL_LNS
    lm = np.zeros((P_total, 3), np.float32)
    lm[:len(pt_ids)] = m.pt_xyz[pt_ids]
    lm[P_pts + 0:P_pts + 2 * len(ln_ids):2] = m.ln_sw[ln_ids]
    lm[P_pts + 1:P_pts + 2 * len(ln_ids):2] = m.ln_ew[ln_ids]
    plane_base = np.zeros((MAX_LOCAL_PLS, 4), np.float32)
    plane_base[:, 2] = 1.0  # harmless unit normal for padding slots
    plane_base[:len(pl_ids)] = m.pl_coeffs[pl_ids]

    poses0 = np.tile(np.eye(4, dtype=np.float32), (Kt, 1, 1))
    poses0[:n_real] = m.kf_pose[all_kfs].astype(np.float32)
    fixed_t = _put(fixed_mask, device)

    with record_function("local_ba.ba_solve"):
        poses1, lm1, planes1, chis = ba_solve(
            _put(poses0, device), fixed_t, _put(lm, device),
            _put(plane_base, device), pt_tab, ln_tab, pl_tab, par_tab,
            ver_tab, K, bf, w, n_iters=5)

    # outlier purge, then 10 more iterations without the outliers
    chis = {k: v.cpu().numpy() for k, v in chis.items()}
    keep, gate = purge_masks(chis, pt_tab.ur.cpu().numpy(), Kt, w)
    tabs = [gated(t, k) for t, k in zip(
        (pt_tab, ln_tab, pl_tab, par_tab, ver_tab), keep)]
    with record_function("local_ba.ba_solve"):
        poses2, lm2, planes2, chis2 = ba_solve(
            poses1, fixed_t, lm1, planes1, *tabs, K, bf, w, n_iters=10)

    poses2 = poses2.cpu().numpy()
    lm2 = lm2.cpu().numpy()
    planes2 = planes2.cpu().numpy()

    # write back free poses and landmarks
    for i, k in enumerate(all_kfs):
        if fixed_mask[i] == 0:
            m.kf_pose[k] = poses2[i]
    m.pt_xyz[pt_ids] = lm2[:len(pt_ids)]
    if len(ln_ids):
        m.ln_sw[ln_ids] = lm2[P_pts + 0:P_pts + 2 * len(ln_ids):2]
        m.ln_ew[ln_ids] = lm2[P_pts + 1:P_pts + 2 * len(ln_ids):2]
    if len(pl_ids):
        m.pl_coeffs[pl_ids] = planes2[:len(pl_ids)]

    # erase the point observations still over the gate after stage 2
    bad = (chis2["pt"].cpu().numpy() > gate) & (pt_tab.mask.cpu().numpy() > 0)
    for i, k in enumerate(all_kfs[:n_real]):
        fbad = np.flatnonzero(bad[i])
        if len(fbad):
            pts_bad = m.kf_pt_idx[k, fbad]
            m.kf_pt_idx[k, fbad] = -1
            ok = pts_bad >= 0
            m.pt_nobs[pts_bad[ok]] -= 1


def _ba_iterate(kf_pose, kf_fixed_mask, pt_xyz, obs_pt_slot, obs_uv, obs_ur,
                obs_inv_s2, obs_mask, K, bf, n_iters=5, huber=True,
                damping=1e-4, pose_prior=0.0):
    """Points-only wrapper over ba_core.ba_solve (tensors in and out);
    damping and pose_prior are accepted and ignored, as in JAX."""
    Kt = kf_pose.shape[0]
    dev = kf_pose.device
    pt_tab = PointTables(slot=obs_pt_slot.to(torch.int32), uv=obs_uv,
                         ur=obs_ur, inv_s2=obs_inv_s2,
                         mask=obs_mask * (obs_pt_slot >= 0))
    poses, lm, _, chis = ba_solve(
        kf_pose, kf_fixed_mask, pt_xyz,
        torch.zeros((0, 4), dtype=torch.float32, device=dev), pt_tab,
        ba_core.empty_line_tables(Kt, dev), ba_core.empty_plane_tables(Kt, dev),
        ba_core.empty_plane_tables(Kt, dev),
        ba_core.empty_plane_tables(Kt, dev),
        tuple(float(v) for v in K), float(bf),
        BAWeights.from_config(PlaneConfig()), n_iters=n_iters, huber=huber)
    return poses, lm, chis["pt"]
