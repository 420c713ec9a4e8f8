"""Unified bundle-adjustment core: poses + points + line endpoints + planes.

Port of ``planarslam_tpu/solvers/ba_core.py``: keyframe SE3 blocks and one
batched (M, 3, 3) landmark system (points and line endpoints as XYZ,
planes in a 3-dof tangent chart around their entry coefficients), masked
observation tables, Huber kernels, fixed poses eliminated exactly, and
Levenberg-Marquardt with multiplicative damping plus an absolute floor and
an accept test on per-observation cost differences.

Two hand-written kernels take the dense work of each LM step:
  - K8 ``ba_normal_eqs`` (``csrc/ba_normal_eqs.cu``): per point and line-
    endpoint observation the residual, analytic Jacobians, Huber weight and
    chi2, reduced into Hcc (Kt, 6, 6), bc (Kt, 6), Hpp (M, 3, 3), bp (M, 3)
    and, when asked, the cross blocks Hcp (Kt, 6, M, 3);
  - K9 ``ba_schur_eliminate`` (``csrc/ba_schur.cu``): the damped landmark
    inverses, Hcp Hpp^-1 and the reduced right-hand side; its second entry
    ``ba_schur_backsub`` recovers the landmark step.
Hcp is laid out (Kt, 6, M, 3), so ``Hcp.view(Kt * 6, M * 3)`` is the
operand of the reduced camera system S = Hcc - (Hcp Hpp^-1) Hcp^T, which
stays one ``torch.matmul`` as it stays one XLA product in JAX. The plane
blocks (``_plane_jacs``, ``torch.func.jacfwd`` per observation as JAX's
``jax.jacfwd``) and the chi2 pass at the new state stay plain torch.

No float atomics: the kernels sum in an order fixed for the whole solve by
``obs_plan`` (stable sorts of the observation slots), and the plain
segment sums use ``index_put_(accumulate=True)``, which PyTorch computes by
sorting on a card. The LM state (poses, landmarks, lam, the accept flag)
stays on the device: the loop has no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import plane as plane_geo
from planarslam_tpu_torch.geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PointTables(NamedTuple):
    """(Kt, F) point observations; slot indexes the xyz landmark array."""

    slot: torch.Tensor      # (Kt, F) int32 in [-1, P)
    uv: torch.Tensor        # (Kt, F, 2)
    ur: torch.Tensor        # (Kt, F) pseudo-stereo right u (-1 = mono)
    inv_s2: torch.Tensor    # (Kt, F)
    mask: torch.Tensor      # (Kt, F) f32


class LineTables(NamedTuple):
    """(Kt, L2) line-endpoint observations: two rows per detected segment
    (start, end endpoint) sharing one image-line equation."""

    slot: torch.Tensor      # (Kt, L2) int32 into the xyz landmark array
    line2d: torch.Tensor    # (Kt, L2, 3) normalized image line (a, b, c)
    inv_s2: torch.Tensor    # (Kt, L2)
    mask: torch.Tensor      # (Kt, L2) f32


class PlaneTables(NamedTuple):
    """(Kt, Pp) plane observations; slot indexes the plane block array."""

    slot: torch.Tensor      # (Kt, Pp) int32 in [-1, Q)
    pi_obs: torch.Tensor    # (Kt, Pp, 4) observed camera-frame plane
    mask: torch.Tensor      # (Kt, Pp) f32


class BAWeights(NamedTuple):
    """Plane information weights and gates (float32 values as floats)."""

    angle_info: float
    dis_info: float
    par_info: float
    ver_info: float
    plane_chi: float
    vp_chi: float

    @staticmethod
    def from_config(planes_cfg) -> "BAWeights":
        f = np.float32
        return BAWeights(
            angle_info=float(f(3282.8 / planes_cfg.angle_info ** 2)),
            dis_info=float(f(planes_cfg.distance_info ** 2)),
            par_info=float(f(3282.8 / planes_cfg.parallel_info ** 2)),
            ver_info=float(f(3282.8 / planes_cfg.vertical_info ** 2)),
            plane_chi=float(f(planes_cfg.chi)),
            vp_chi=float(f(planes_cfg.vp_chi)))


def empty_line_tables(Kt: int, device) -> LineTables:
    return LineTables(
        torch.full((Kt, 0), -1, dtype=torch.int32, device=device),
        torch.zeros((Kt, 0, 3), device=device),
        torch.ones((Kt, 0), device=device),
        torch.zeros((Kt, 0), device=device))


def empty_plane_tables(Kt: int, device) -> PlaneTables:
    return PlaneTables(
        torch.full((Kt, 0), -1, dtype=torch.int32, device=device),
        torch.zeros((Kt, 0, 4), device=device),
        torch.zeros((Kt, 0), device=device))


def plane_retract(base: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Apply a 3-dof tangent update (b1, b2, d) to base plane coeffs
    (Q, 4), in the tangent basis of the base normal."""
    n0 = base[..., :3]
    b1, b2 = plane_geo.tangent_basis(n0)
    n = n0 + theta[..., 0:1] * b1 + theta[..., 1:2] * b2
    n = n / plane_geo._safe_norm(n)[..., None]
    d = base[..., 3] + theta[..., 2]
    return torch.cat([n, d[..., None]], dim=-1)


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int
                ) -> torch.Tensor:
    """sum of vals rows per index (jax.ops.segment_sum), deterministic on
    the CPU and, by sorting, on a card."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_put_((idx.long(),), vals, accumulate=True)


def _proj_jacobians(pc, K, bf):
    """d(u, v, ur)/d pc for camera-frame points pc (..., 3)."""
    fx, fy, _, _ = K
    x, y, z = pc[..., 0], pc[..., 1], torch.clamp(pc[..., 2], min=1e-6)
    z2 = z * z
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx / z, zero, -fx * x / z2], dim=-1)
    row_v = torch.stack([zero, fy / z, -fy * y / z2], dim=-1)
    row_r = torch.stack([fx / z, zero, -fx * x / z2 + bf / z2], dim=-1)
    return torch.stack([row_u, row_v, row_r], dim=-2)


def _point_jacs(poses_c, pts, slot, uv, ur, is_stereo, K, bf):
    """Point reprojection residuals r (Kt, F, 3) = obs - pred and analytic
    Jacobians Jpose (Kt, F, 3, 6) (left se3 tangent, minus sign folded in)
    and Jpt (Kt, F, 3, 3)."""
    fx, fy, cx, cy = K
    R = poses_c[:, :3, :3]
    t = poses_c[:, :3, 3]
    xw = pts[slot.long()]
    pc = torch.einsum("kij,kfj->kfi", R, xw) + t[:, None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    urh = u - bf / z
    r_pt = torch.stack([uv[..., 0] - u, uv[..., 1] - v,
                        torch.where(is_stereo, ur - urh, 0.0)], dim=-1)
    dh = _proj_jacobians(pc, K, bf)
    Jpose = torch.cat([-dh, dh @ se3.hat(pc)], dim=-1)
    Jpt = -dh @ R[:, None]
    return r_pt, Jpose, Jpt


def _line_jacs(poses_c, pts, slot, line2d, K):
    """Line-endpoint point-to-image-line residuals r (Kt, L2) and analytic
    Jacobians Jp (Kt, L2, 6), Jl (Kt, L2, 3)."""
    fx, fy, cx, cy = K
    R = poses_c[:, :3, :3]
    t = poses_c[:, :3, 3]
    xl = pts[slot.long()]
    pcl = torch.einsum("kij,klj->kli", R, xl) + t[:, None, :]
    zl = torch.clamp(pcl[..., 2], min=1e-6)
    ul = fx * pcl[..., 0] / zl + cx
    vl = fy * pcl[..., 1] / zl + cy
    r_ln = line2d[..., 0] * ul + line2d[..., 1] * vl + line2d[..., 2]
    a, b = line2d[..., 0], line2d[..., 1]
    zl2 = zl * zl
    row = torch.stack([a * fx / zl, b * fy / zl,
                       -(a * fx * pcl[..., 0] + b * fy * pcl[..., 1]) / zl2],
                      dim=-1)
    Jp = torch.cat([row, -torch.einsum("kli,klij->klj", row, se3.hat(pcl))],
                   dim=-1)
    Jl = torch.einsum("kli,kij->klj", row, R)
    return r_ln, Jp, Jl


def _plane_jacs(poses_c, plane_base, theta, slot, pi_obs, err_fn):
    """Plane residuals rr (Kt, Pp, D) and their jacfwd Jacobians Jx
    (Kt, Pp, D, 6) wrt the pose tangent and Jt (Kt, Pp, D, 3) wrt the
    plane's tangent chart, one forward-mode pass per observation."""
    from torch.func import jacfwd, vmap

    Kt, Pp = slot.shape
    s = slot.long().reshape(-1)
    T_g = poses_c[:, None].expand(Kt, Pp, 4, 4).reshape(-1, 4, 4)

    def obs_res(x, T0, base0, theta0, pi_o):
        T_new = se3.se3_exp(x[:6]) @ T0
        return err_fn(plane_geo.transform(
            T_new, plane_retract(base0, theta0 + x[6:])), pi_o)

    x0 = torch.zeros(9, dtype=poses_c.dtype, device=poses_c.device)

    def one(T0, base0, theta0, pi_o):
        return (obs_res(x0, T0, base0, theta0, pi_o),
                jacfwd(obs_res)(x0, T0, base0, theta0, pi_o))

    rr, J = vmap(one)(T_g, plane_base[s], theta[s], pi_obs.reshape(-1, 4))
    D = rr.shape[-1]
    return (rr.reshape(Kt, Pp, D), J[..., :6].reshape(Kt, Pp, D, 6),
            J[..., 6:].reshape(Kt, Pp, D, 3))


def _rho_fn(chi, gate, mask, huber: bool):
    """Robust (Huber-composed) per-observation cost."""
    if huber:
        val = torch.where(
            chi > gate,
            2 * torch.sqrt(gate * torch.clamp(chi, min=1e-12)) - gate, chi)
    else:
        val = chi
    return val * mask


def _huber_w_fn(chi, gate, huber: bool):
    """IRLS weight of the Huber kernel at the given chi2."""
    if not huber:
        return torch.ones_like(chi)
    return torch.where(chi > gate,
                       torch.sqrt(gate / torch.clamp(chi, min=1e-12)), 1.0)


def _robust_decrease_tables(chis_new, chis_cur, gates, masks, huber: bool):
    """sum(rho_new - rho_cur) as per-observation differences, which keep
    full relative precision near convergence where the float32 totals
    would not."""
    total = 0.0
    for cn, cc, gate, mask in zip(chis_new, chis_cur, gates, masks):
        total = total + torch.sum(_rho_fn(cn, gate, mask, huber)
                                  - _rho_fn(cc, gate, mask, huber))
    return total


def _info(w: BAWeights, device):
    """(direct, parallel, vertical) information vectors."""
    def t(*v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return (t(w.angle_info, w.angle_info, w.dis_info),
            t(w.par_info, w.par_info), t(w.ver_info, w.ver_info))


def _all_chi2_tables(poses_c, lm_c, plane_base, P, pt, ln, pl, par, ver,
                     pt_slot, ln_slot, pl_slot, par_slot, ver_slot,
                     is_stereo, K, bf, w):
    """Per-observation chi2 of every table at the given state (residuals
    only; shared by both solvers)."""
    fx, fy, cx, cy = K
    pts = lm_c[:P]
    R = poses_c[:, :3, :3]
    t = poses_c[:, :3, 3]

    xw = pts[pt_slot.long()]
    pc = torch.einsum("kij,kfj->kfi", R, xw) + t[:, None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    urh = u - bf / z
    r_pt = torch.stack([pt.uv[..., 0] - u, pt.uv[..., 1] - v,
                        torch.where(is_stereo, pt.ur - urh, 0.0)], dim=-1)
    chi_pt = torch.sum(r_pt * r_pt, dim=-1) * pt.inv_s2

    xl = pts[ln_slot.long()]
    pcl = torch.einsum("kij,klj->kli", R, xl) + t[:, None, :]
    zl = torch.clamp(pcl[..., 2], min=1e-6)
    ul = fx * pcl[..., 0] / zl + cx
    vl = fy * pcl[..., 1] / zl + cy
    r_ln = (ln.line2d[..., 0] * ul + ln.line2d[..., 1] * vl
            + ln.line2d[..., 2])
    chi_ln = r_ln * r_ln * ln.inv_s2

    Q = plane_base.shape[0]
    pi_w = plane_retract(plane_base, lm_c[P:]) if Q > 0 else None

    def plane_chi(tables, slot, err_fn, wts):
        if Q == 0 or slot.shape[1] == 0:
            return torch.zeros(slot.shape, dtype=lm_c.dtype,
                               device=lm_c.device)
        pi_est = plane_geo.transform(poses_c[:, None], pi_w[slot.long()])
        r = err_fn(pi_est, tables.pi_obs)
        return torch.sum(r * r * wts, dim=-1)

    w_pl, w_par, w_ver = _info(w, lm_c.device)
    chi_pl = plane_chi(pl, pl_slot, plane_geo.ominus, w_pl)
    chi_par = plane_chi(par, par_slot, plane_geo.ominus_par, w_par)
    chi_ver = plane_chi(ver, ver_slot, plane_geo.ominus_ver, w_ver)
    return chi_pt, chi_ln, chi_pl, chi_par, chi_ver


# ---------------------------------------------------------------------------
# K8: the point and line-endpoint normal equations


class ObsPlan(NamedTuple):
    """K8's summation order, fixed for one solve. Observations are numbered
    o = k F + f (points), then Kt F + k L2 + l (line endpoints); masked
    ones are left out. lm_order lists them by landmark slot (stably) with
    lm_start (M + 1) bounds; kf_order lists them by (keyframe, slot) with
    kf_start (Kt + 1) bounds and kf_slot the slot of each entry."""

    lm_order: torch.Tensor
    lm_start: torch.Tensor
    kf_order: torch.Tensor
    kf_start: torch.Tensor
    kf_slot: torch.Tensor


def obs_plan(pt_slot, pt_mask, ln_slot, ln_mask, M: int) -> ObsPlan:
    """Build K8's order on the tables' device (clipped slots)."""
    dev = pt_slot.device
    Kt, F = pt_slot.shape
    L2 = ln_slot.shape[1]
    slots = torch.cat([pt_slot.reshape(-1), ln_slot.reshape(-1)]).long()
    live = torch.cat([pt_mask.reshape(-1), ln_mask.reshape(-1)]) > 0
    kf = torch.cat([torch.arange(Kt, device=dev).repeat_interleave(F),
                    torch.arange(Kt, device=dev).repeat_interleave(L2)])
    ids = torch.nonzero(live)[:, 0]
    s, k = slots[ids], kf[ids]

    def starts(keys, n):
        c = torch.bincount(keys, minlength=n)
        return torch.cat([torch.zeros(1, dtype=c.dtype, device=dev),
                          torch.cumsum(c, 0)])

    lm_order = ids[torch.sort(s, stable=True)[1]]
    kf_perm = torch.sort(k * M + s, stable=True)[1]

    def i32(x):
        return x.to(torch.int32).contiguous()

    return ObsPlan(i32(lm_order), i32(starts(s, M)), i32(ids[kf_perm]),
                   i32(starts(k, Kt)), i32(s[kf_perm]))


def ba_normal_eqs_plain(poses, pts, pt: PointTables, ln: LineTables, M: int,
                        K, bf: float, huber: bool = True,
                        want_hcp: bool = True):
    """Plain version of K8 (the kernel's `plan` only orders its sums).
    poses (Kt, 4, 4), pts (P, 3) float32; tables with slots clipped to
    [0, P). Returns Hcc (Kt, 6, 6), bc (Kt, 6),
    Hpp (M, 3, 3), bp (M, 3), Hcp (Kt, 6, M, 3) or None, chi_pt (Kt, F),
    chi_ln (Kt, L2)."""
    Kt = poses.shape[0]
    is_stereo = pt.ur >= 0
    r_pt, Jpose, Jpt = _point_jacs(poses, pts, pt.slot, pt.uv, pt.ur,
                                   is_stereo, K, bf)
    chi_pt = torch.sum(r_pt * r_pt, dim=-1) * pt.inv_s2
    gate_pt = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    w_pt = pt.inv_s2 * _huber_w_fn(chi_pt, gate_pt, huber) * pt.mask
    Wp = w_pt[..., None] * torch.stack(
        [torch.ones_like(w_pt), torch.ones_like(w_pt),
         is_stereo.to(w_pt.dtype)], dim=-1)
    rw = r_pt * Wp
    Hcc = torch.einsum("kfai,kfa,kfaj->kij", Jpose, Wp, Jpose)
    bc = torch.einsum("kfai,kfa->ki", Jpose, rw)
    flat = pt.slot.reshape(-1)
    Hpp = segment_sum(torch.einsum("kfai,kfa,kfaj->kfij", Jpt, Wp, Jpt
                                   ).reshape(-1, 3, 3), flat, M)
    bp = segment_sum(torch.einsum("kfai,kfa->kfi", Jpt, rw).reshape(-1, 3),
                     flat, M)
    kf_ids = torch.arange(Kt, device=poses.device)[:, None]
    Hcp = None
    if want_hcp:
        Hcp = segment_sum(torch.einsum("kfai,kfa,kfaj->kfij", Jpose, Wp, Jpt
                                       ).reshape(-1, 6, 3),
                          (kf_ids * M + pt.slot).reshape(-1), Kt * M)
    chi_ln = torch.zeros(ln.slot.shape, dtype=pts.dtype, device=pts.device)
    if ln.slot.shape[1] > 0:
        r_ln, Jp, Jl = _line_jacs(poses, pts, ln.slot, ln.line2d, K)
        chi_ln = r_ln * r_ln * ln.inv_s2
        w_ln = ln.inv_s2 * _huber_w_fn(chi_ln, CHI2_MONO, huber) * ln.mask
        rwl = r_ln * w_ln
        Hcc = Hcc + torch.einsum("kli,kl,klj->kij", Jp, w_ln, Jp)
        bc = bc + torch.einsum("kli,kl->ki", Jp, rwl)
        flat_l = ln.slot.reshape(-1)
        Hpp = Hpp + segment_sum(torch.einsum(
            "kli,kl,klj->klij", Jl, w_ln, Jl).reshape(-1, 3, 3), flat_l, M)
        bp = bp + segment_sum((Jl * rwl[..., None]).reshape(-1, 3), flat_l,
                              M)
        if want_hcp:
            Hcp = Hcp + segment_sum(torch.einsum(
                "kli,kl,klj->klij", Jp, w_ln, Jl).reshape(-1, 6, 3),
                (kf_ids * M + ln.slot).reshape(-1), Kt * M)
    if want_hcp:
        Hcp = Hcp.view(Kt, M, 6, 3).permute(0, 2, 1, 3).contiguous()
    return Hcc, bc, Hpp, bp, Hcp, chi_pt, chi_ln


def ba_normal_eqs(poses, pts, pt: PointTables, ln: LineTables, M: int, K,
                  bf: float, huber: bool = True, want_hcp: bool = True,
                  plan: Optional[ObsPlan] = None):
    """K8 wrapper; the arguments and results of ``ba_normal_eqs_plain``
    (`plan` from ``obs_plan`` on the same tables)."""
    if kernels.on_cpu(poses, pts, *pt, *ln):
        return ba_normal_eqs_plain(poses, pts, pt, ln, M, K, bf, huber,
                                   want_hcp)
    Kt, F = pt.slot.shape
    L2 = ln.slot.shape[1]
    P = pts.shape[0]
    f32 = torch.float32
    kernels.check(poses, "poses", f32, (Kt, 4, 4))
    kernels.check(pts, "pts", f32, (P, 3))
    for name, t, shape in (("pt.slot", pt.slot, (Kt, F)),
                           ("ln.slot", ln.slot, (Kt, L2))):
        kernels.check(t, name, torch.int32, shape)
    for name, t, shape in (("pt.uv", pt.uv, (Kt, F, 2)),
                           ("pt.ur", pt.ur, (Kt, F)),
                           ("pt.inv_s2", pt.inv_s2, (Kt, F)),
                           ("pt.mask", pt.mask, (Kt, F)),
                           ("ln.line2d", ln.line2d, (Kt, L2, 3)),
                           ("ln.inv_s2", ln.inv_s2, (Kt, L2)),
                           ("ln.mask", ln.mask, (Kt, L2))):
        kernels.check(t, name, f32, shape)
    for t in plan:
        kernels.check(t, "plan", torch.int32)
    dev = poses.device
    Hcc = torch.empty((Kt, 6, 6), dtype=f32, device=dev)
    bc = torch.empty((Kt, 6), dtype=f32, device=dev)
    Hpp = torch.empty((M, 3, 3), dtype=f32, device=dev)
    bp = torch.empty((M, 3), dtype=f32, device=dev)
    Hcp = (torch.empty((Kt, 6, M, 3), dtype=f32, device=dev) if want_hcp
           else None)
    chi_pt = torch.empty((Kt, F), dtype=f32, device=dev)
    chi_ln = torch.empty((Kt, L2), dtype=f32, device=dev)
    scratch = torch.empty((Kt * (F + L2), 54), dtype=f32, device=dev)
    fx, fy, cx, cy = (float(np.float32(v)) for v in K)
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_ba_normal_eqs", kernels.ptr(poses), kernels.ptr(pts),
            kernels.ptr(pt.slot), kernels.ptr(pt.uv), kernels.ptr(pt.ur),
            kernels.ptr(pt.inv_s2), kernels.ptr(pt.mask),
            kernels.ptr(ln.slot), kernels.ptr(ln.line2d),
            kernels.ptr(ln.inv_s2), kernels.ptr(ln.mask), Kt, F, L2, M,
            fx, fy, cx, cy, float(np.float32(bf)), int(huber),
            kernels.ptr(plan.lm_order), kernels.ptr(plan.lm_start),
            kernels.ptr(plan.kf_order), kernels.ptr(plan.kf_start),
            kernels.ptr(plan.kf_slot), kernels.ptr(scratch),
            kernels.ptr(Hcc), kernels.ptr(bc), kernels.ptr(Hpp),
            kernels.ptr(bp), kernels.ptr(Hcp) if want_hcp else None,
            kernels.ptr(chi_pt), kernels.ptr(chi_ln))
    kernels.LAUNCHES["ba_normal_eqs"] += 1
    return Hcc, bc, Hpp, bp, Hcp, chi_pt, chi_ln


# ---------------------------------------------------------------------------
# K9: Schur elimination of the landmark blocks


def _damped(Hpp, lam, mu_p):
    diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    eye = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    return Hpp + lam * torch.diag_embed(diag_p) + (lam * mu_p + 1e-6) * eye


def ba_schur_eliminate_plain(Hpp, bp, Hcp, bc, lam, mu_p):
    """Plain version of K9. Hpp (M, 3, 3), bp (M, 3), Hcp (Kt, 6, M, 3),
    bc (Kt, 6), lam and mu_p 0-d float32. Returns Hpp_inv (M, 3, 3) of the
    damped blocks (inverted in float64), HcpHinv (Kt, 6, M, 3) and
    rhs (Kt, 6) = bc - sum_p HcpHinv bp."""
    Hd = _damped(Hpp, lam, mu_p).to(torch.float64)
    Hinv = torch.linalg.inv_ex(Hd)[0].to(torch.float32)
    HcpHinv = torch.einsum("kipl,plm->kipm", Hcp, Hinv).contiguous()
    rhs = bc - torch.einsum("kipl,pl->ki", HcpHinv, bp)
    return Hinv, HcpHinv, rhs


def ba_schur_backsub_plain(Hpp_inv, bp, Hcp, dxc):
    """Plain version of K9's back-substitution: dxp (M, 3) =
    -Hpp_inv (bp + sum_k Hcp[k]^T dxc[k])."""
    v = bp + torch.einsum("kipj,ki->pj", Hcp, dxc)
    return -torch.einsum("pij,pj->pi", Hpp_inv, v)


def ba_schur_eliminate(Hpp, bp, Hcp, bc, lam, mu_p):
    """K9 wrapper; the arguments and results of
    ``ba_schur_eliminate_plain``."""
    if kernels.on_cpu(Hpp, bp, Hcp, bc, lam, mu_p):
        return ba_schur_eliminate_plain(Hpp, bp, Hcp, bc, lam, mu_p)
    Kt, _, M, _ = Hcp.shape
    f32 = torch.float32
    kernels.check(Hpp, "Hpp", f32, (M, 3, 3))
    kernels.check(bp, "bp", f32, (M, 3))
    kernels.check(Hcp, "Hcp", f32, (Kt, 6, M, 3))
    kernels.check(bc, "bc", f32, (Kt, 6))
    kernels.check(lam, "lam", f32, ())
    kernels.check(mu_p, "mu_p", f32, ())
    dev = Hpp.device
    Hinv = torch.empty((M, 3, 3), dtype=f32, device=dev)
    HcpHinv = torch.empty_like(Hcp)
    rhs = torch.empty((Kt, 6), dtype=f32, device=dev)
    n_blk = (M + 127) // 128
    partial = torch.empty((Kt, n_blk, 6), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_ba_schur_eliminate", kernels.ptr(Hpp),
                       kernels.ptr(bp), kernels.ptr(Hcp), kernels.ptr(bc),
                       kernels.ptr(lam), kernels.ptr(mu_p), Kt, M,
                       kernels.ptr(Hinv), kernels.ptr(HcpHinv),
                       kernels.ptr(rhs), kernels.ptr(partial))
    kernels.LAUNCHES["ba_schur_eliminate"] += 1
    return Hinv, HcpHinv, rhs


def ba_schur_backsub(Hpp_inv, bp, Hcp, dxc):
    """K9's second entry; the arguments and results of
    ``ba_schur_backsub_plain``."""
    if kernels.on_cpu(Hpp_inv, bp, Hcp, dxc):
        return ba_schur_backsub_plain(Hpp_inv, bp, Hcp, dxc)
    Kt, _, M, _ = Hcp.shape
    f32 = torch.float32
    kernels.check(Hpp_inv, "Hpp_inv", f32, (M, 3, 3))
    kernels.check(bp, "bp", f32, (M, 3))
    kernels.check(Hcp, "Hcp", f32, (Kt, 6, M, 3))
    kernels.check(dxc, "dxc", f32, (Kt, 6))
    dxp = torch.empty((M, 3), dtype=f32, device=Hcp.device)
    ks = min(Kt, 16)  # keyframe ranges summed apart, then in order
    partial = torch.empty((ks, M, 3), dtype=f32, device=Hcp.device)
    with torch.cuda.device(Hcp.device):
        kernels.launch("psl_ba_schur_backsub", kernels.ptr(Hpp_inv),
                       kernels.ptr(bp), kernels.ptr(Hcp), kernels.ptr(dxc),
                       Kt, M, ks, kernels.ptr(partial), kernels.ptr(dxp))
    kernels.LAUNCHES["ba_schur_eliminate"] += 1
    return dxp


# ---------------------------------------------------------------------------
# the solver


class _Problem(NamedTuple):
    """What stays fixed for one solve: clipped slots, gates, masks, the
    plane tables and K8's plan."""

    P: int
    Q: int
    M: int
    pt: PointTables
    ln: LineTables
    planes: tuple           # ((tables, slot, err_fn, info, gate), ...)
    pl_slots: tuple
    is_stereo: torch.Tensor
    gates: tuple
    masks: tuple
    plan: ObsPlan


def _problem(lm_xyz, plane_base, pt, ln, pl, par, ver, w) -> _Problem:
    P = lm_xyz.shape[0]
    Q = plane_base.shape[0]
    M = P + Q
    dev = lm_xyz.device

    def clip(slot, n):
        return torch.clamp(slot, 0, max(n - 1, 0)).to(torch.int32).contiguous()

    pt = pt._replace(slot=clip(pt.slot, P))
    ln = ln._replace(slot=clip(ln.slot, P))
    pl_slot, par_slot, ver_slot = (clip(t.slot, Q) for t in (pl, par, ver))
    is_stereo = pt.ur >= 0
    gate_pt = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    w_pl, w_par, w_ver = _info(w, dev)
    planes = ((pl, pl_slot, plane_geo.ominus, w_pl, w.plane_chi),
              (par, par_slot, plane_geo.ominus_par, w_par, w.vp_chi),
              (ver, ver_slot, plane_geo.ominus_ver, w_ver, w.vp_chi))
    plan = None
    if not kernels.on_cpu(pt.slot):
        plan = obs_plan(pt.slot, pt.mask, ln.slot, ln.mask, M)
    return _Problem(P, Q, M, pt, ln, planes, (pl_slot, par_slot, ver_slot),
                    is_stereo,
                    (gate_pt, CHI2_MONO, w.plane_chi, w.vp_chi, w.vp_chi),
                    (pt.mask, ln.mask, pl.mask, par.mask, ver.mask), plan)


def _chi2(pb: _Problem, poses_c, lm_c, plane_base, K, bf, w):
    return _all_chi2_tables(poses_c, lm_c, plane_base, pb.P, pb.pt, pb.ln,
                            pb.planes[0][0], pb.planes[1][0],
                            pb.planes[2][0], pb.pt.slot, pb.ln.slot,
                            *pb.pl_slots, pb.is_stereo, K, bf, w)


def _plane_terms(pb: _Problem, poses_c, plane_base, theta, huber: bool):
    """Per plane table: (slot, rr, Jx, Jt, Wv) with the Huber-weighted
    information Wv (Kt, Pp, D)."""
    out = []
    if pb.Q == 0:
        return out
    for tables, slot, err_fn, info, gate in pb.planes:
        if slot.shape[1] == 0:
            continue
        rr, Jx, Jt = _plane_jacs(poses_c, plane_base, theta, slot,
                                 tables.pi_obs, err_fn)
        chi = torch.sum(rr * rr * info, dim=-1)
        Wv = (_huber_w_fn(chi, gate, huber) * tables.mask)[..., None] * info
        out.append((slot, rr, Jx, Jt, Wv))
    return out


def _add_plane_blocks(pb: _Problem, terms, Hcc, bc, Hpp, bp, Hcp):
    """Add the plane observations into the normal equations; Hcp rows are
    summed per keyframe with a one-hot product (no scatter)."""
    for slot, rr, Jx, Jt, Wv in terms:
        rw = rr * Wv
        Hcc = Hcc + torch.einsum("kpdi,kpd,kpdj->kij", Jx, Wv, Jx)
        bc = bc + torch.einsum("kpdi,kpd->ki", Jx, rw)
        flat = (slot + pb.P).reshape(-1)
        Hpp = Hpp + segment_sum(torch.einsum(
            "kpdi,kpd,kpdj->kpij", Jt, Wv, Jt).reshape(-1, 3, 3), flat, pb.M)
        bp = bp + segment_sum(torch.einsum(
            "kpdi,kpd->kpi", Jt, rw).reshape(-1, 3), flat, pb.M)
        if Hcp is not None:
            C = torch.einsum("kpdi,kpd,kpdj->kpij", Jx, Wv, Jt)
            onehot = torch.nn.functional.one_hot(
                slot.long(), pb.Q).to(C.dtype)            # (Kt, Pp, Q)
            Hcp[:, :, pb.P:, :] += torch.einsum("kpq,kpij->kiqj", onehot, C)
    return Hcc, bc, Hpp, bp


def _mu_p(Hpp):
    diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    n_obs = torch.sum(diag_p.sum(-1) > 0) + 1
    return torch.sum(diag_p) / (3 * n_obs)


def ba_solve(poses: torch.Tensor, fixed_mask: torch.Tensor,
             lm_xyz: torch.Tensor, plane_base: torch.Tensor,
             pt: PointTables, ln: LineTables, pl: PlaneTables,
             par: PlaneTables, ver: PlaneTables,
             K: Tuple[float, float, float, float], bf: float, w: BAWeights,
             n_iters: int = 10, huber: bool = True):
    """Returns (poses, lm_xyz, plane_coeffs, chi2 dict per obs table); runs
    on the tensors' device without a host sync."""
    pb = _problem(lm_xyz, plane_base, pt, ln, pl, par, ver, w)
    Kt = poses.shape[0]
    P, M = pb.P, pb.M
    dev, dt = poses.device, poses.dtype
    free_rep = torch.repeat_interleave(1.0 - fixed_mask, 6)
    eye_c = torch.eye(Kt * 6, dtype=dt, device=dev)
    kidx = torch.arange(Kt, device=dev)

    def step(poses_c, lm_c, lam):
        pts = lm_c[:P]
        Hcc, bc, Hpp, bp, Hcp, _, _ = ba_normal_eqs(
            poses_c, pts, pb.pt, pb.ln, M, K, bf, huber, True, pb.plan)
        Hcc, bc, Hpp, bp = _add_plane_blocks(
            pb, _plane_terms(pb, poses_c, plane_base, lm_c[P:], huber),
            Hcc, bc, Hpp, bp, Hcp)
        Hinv, HcpHinv, rhs = ba_schur_eliminate(Hpp, bp, Hcp, bc, lam,
                                                _mu_p(Hpp))
        S = -(HcpHinv.view(Kt * 6, M * 3) @ Hcp.view(Kt * 6, M * 3).T)
        S4 = S.view(Kt, 6, Kt, 6)
        S4[kidx, :, kidx, :] += Hcc
        diag_S = torch.diagonal(S)
        mu_c = torch.sum(diag_S * free_rep) / (torch.sum(free_rep) + 1.0)
        S = S + lam * torch.diag(diag_S) + (lam * mu_c + 1e-8) * eye_c
        # exact elimination of fixed poses: identity rows/cols, zero rhs
        S = S * free_rep[:, None] * free_rep[None, :] + torch.diag(
            1.0 - free_rep)
        rhs_vec = (rhs.reshape(-1) * free_rep)[:, None]
        # one step of iterative refinement; a matrix that is not positive
        # definite gives NaN, which the finite test below rejects (as JAX's
        # cho_factor does)
        L, info = torch.linalg.cholesky_ex(S)
        dx0 = torch.cholesky_solve(rhs_vec, L)
        dx = dx0 + torch.cholesky_solve(rhs_vec - S @ dx0, L)
        dxc = torch.where(info == 0, -dx.reshape(Kt, 6), float("nan"))
        dxp = ba_schur_backsub(Hinv, bp, Hcp, dxc.contiguous())

        poses_new = se3.se3_exp(dxc) @ poses_c
        lm_new = lm_c + dxp
        decrease = _robust_decrease_tables(
            _chi2(pb, poses_new, lm_new, plane_base, K, bf, w),
            _chi2(pb, poses_c, lm_c, plane_base, K, bf, w),
            pb.gates, pb.masks, huber)
        finite = (torch.isfinite(decrease) & torch.all(torch.isfinite(dxc))
                  & torch.all(torch.isfinite(dxp)))
        accept = (decrease < 0.0) & finite
        return (torch.where(accept, poses_new, poses_c),
                torch.where(accept, lm_new, lm_c),
                torch.clamp(torch.where(accept, lam * 0.3, lam * 6.0),
                            1e-8, 1e6))

    lm = torch.cat([lm_xyz.to(dt), torch.zeros((pb.Q, 3), dtype=dt,
                                               device=dev)], dim=0)
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        poses, lm, lam = step(poses.contiguous(), lm.contiguous(), lam)
    return _finish(pb, poses, lm, plane_base, K, bf, w)


def _finish(pb: _Problem, poses, lm, plane_base, K, bf, w):
    chi_pt, chi_ln, chi_pl, chi_par, chi_ver = _chi2(pb, poses, lm,
                                                     plane_base, K, bf, w)
    P = pb.P
    plane_out = (plane_geo.normalize(plane_retract(plane_base, lm[P:]))
                 if pb.Q > 0 else plane_base)
    return poses, lm[:P], plane_out, {
        "pt": chi_pt, "ln": chi_ln, "pl": chi_pl, "par": chi_par,
        "ver": chi_ver}
