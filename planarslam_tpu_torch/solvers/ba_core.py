"""Unified bundle-adjustment core: poses + points + line endpoints + planes.

Port of ``planarslam_tpu/solvers/ba_core.py``: keyframe SE3 blocks and one
batched (M, 3, 3) landmark system (points and line endpoints as XYZ,
planes in a 3-dof tangent chart around their entry coefficients), masked
observation tables, Huber kernels, fixed poses eliminated exactly, and
Levenberg-Marquardt with multiplicative damping plus an absolute floor and
an accept test on per-observation cost differences.

Hand-written kernels take the work of each LM step:
  - K8 ``ba_normal_eqs`` (``csrc/ba_normal_eqs.cu``): per point and line-
    endpoint observation the residual, analytic Jacobians, Huber weight and
    chi2, reduced into Hcc (Kt, 6, 6), bc (Kt, 6), Hpp (M, 3, 3), bp (M, 3)
    and, when asked, the cross blocks Hcp (Kt, 6, M, 3);
  - K33 ``ba_plane_blocks`` (``csrc/ba_step.cu``): the same for the three
    plane tables with closed-form Jacobians, added into K8's outputs, and
    the landmark damping floor mu_p;
  - K9 ``ba_schur_eliminate`` (``csrc/ba_schur.cu``): the damped landmark
    inverses, Hcp Hpp^-1 and the reduced right-hand side; its second entry
    ``ba_schur_backsub`` recovers the landmark step;
  - K35 ``ba_reduced_system`` (``csrc/ba_step.cu``): Hcc on the diagonal
    blocks of S, the damping, the fixed poses eliminated;
  - K34 ``ba_cost_test`` (``csrc/ba_step.cu``): the chi2 of the five tables
    at both states, the robust decrease, the accept test and the selected
    state; its tables mode gives the final chi2 tables.
  - K40 ``ba_schur_complement`` (``csrc/ba_complement.cu``): the landmark
    product -(Hcp Hpp^-1) Hcp^T of the reduced camera system S = Hcc -
    (Hcp Hpp^-1) Hcp^T over the keyframe pairs that share a landmark only
    (``pair_plan``), where JAX makes one dense XLA product; its plain
    version is that dense product, ``Hcp.view(Kt * 6, M * 3)`` the
    operand.
The Cholesky factorization and its two solves stay PyTorch's, as JAX
leaves them to its library.

No float atomics: the kernels sum in an order fixed for the whole solve by
``obs_plan`` (stable sorts of the observation slots) and ``pair_plan``
(landmarks ascending), and the plain
segment sums use ``index_put_(accumulate=True)``, which PyTorch computes by
sorting on a card. The LM state (poses, landmarks, lam, the accept flag)
stays on the device: the loop has no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import plane as plane_geo
from planarslam_tpu_torch.geometry import se3
from planarslam_tpu_torch.ops.consts import literal

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


# The plane estimate and error spelled in one fixed order of products and
# sums, the order K33 and K34 repeat (csrc/lie.cuh): the plain chi2 of
# _all_chi2_tables and K33's closed-form Jacobians.


def _dot3(a, b):
    """a . b over the last dimension, x + y then + z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _affine3(T, x):
    """R x + t of poses T (Kt, 4, 4) for points x (Kt, n, 3)."""
    return torch.stack([_dot3(T[:, None, i, :3], x) + T[:, None, i, 3]
                        for i in range(3)], dim=-1)


def _norm3(v):
    """plane._safe_norm of 3-vectors."""
    return torch.sqrt(_dot3(v, v) + literal(plane_geo._EPS, v.dtype, v.device))


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _basis3(n):
    """plane.tangent_basis."""
    ax = torch.abs(n)
    use_x = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
    use_y = ~use_x & (ax[..., 1] <= ax[..., 2])
    seed = torch.stack([use_x, use_y, ~use_x & ~use_y], dim=-1).to(n.dtype)
    b1 = _cross3(n, seed)
    b1 = b1 / _norm3(b1)[..., None]
    return b1, _cross3(n, b1)


def _unit_plane(c):
    """plane.normalize."""
    e = c / _norm3(c[..., :3])[..., None]
    return e * torch.where(e[..., 3:4] < 0, -1.0, 1.0)


def _plane_estimate(poses, base, theta):
    """The camera-frame estimate c (Kt, Pp, 4) of planes base (Kt, Pp, 4)
    moved by their chart coordinates theta (``plane_retract``) and then by
    poses (Kt, 4, 4) (``plane.transform``); also the world normal n_w, the
    chart's basis b1, b2 and the norm |n| the retraction divided by."""
    b1, b2 = _basis3(base[..., :3])
    n = (base[..., :3] + theta[..., 0:1] * b1) + theta[..., 1:2] * b2
    sn = _norm3(n)[..., None]
    n_w = n / sn
    d = base[..., 3] + theta[..., 2]
    n_c = torch.stack([_dot3(poses[:, None, i, :3], n_w) for i in range(3)],
                      dim=-1)
    d_c = d - _dot3(n_c, poses[:, None, :3, 3])
    return torch.cat([n_c, d_c[..., None]], dim=-1), n_w, b1, b2, sn


def _plane_rows(c, pi_obs, kind: int):
    """The error rows of estimate c against pi_obs (plane.ominus, kind 0;
    ominus_par, 1; ominus_ver, 2): the rows r and, per row, the vector of
    the measurement it dots the estimate's normal with (None: kind 0's
    distance row e_d - m_d, kind 2's zero row)."""
    e = _unit_plane(c)
    m = _unit_plane(pi_obs)
    if kind == 2:
        return [_dot3(e, m), torch.zeros_like(e[..., 0])], [m[..., :3], None]
    if kind == 1:  # plane._hemi_align to the estimate
        m = m * torch.where(_dot3(m, e)[..., None] < 0, -1.0, 1.0)
    u1, u2 = _basis3(m[..., :3])
    rows, vecs = [_dot3(u1, e), _dot3(u2, e)], [u1, u2]
    if kind == 0:
        rows.append(e[..., 3] - m[..., 3])
        vecs.append(None)
    return rows, vecs


def _plane_chi(poses, base, theta, pi_obs, kind: int, info):
    """The chi2 of plane observations: sum_d r_d^2 info_d."""
    r = _plane_rows(_plane_estimate(poses, base, theta)[0], pi_obs, kind)[0]
    chi = r[0] * r[0] * info[0]
    for d, rd in enumerate(r[1:], 1):
        chi = chi + rd * rd * info[d]
    return chi


def plane_jacs_closed(poses_c, plane_base, theta, slot, pi_obs, kind: int):
    """Plane residuals rr (Kt, Pp, D) and their Jacobians Jx (Kt, Pp, D, 6)
    wrt the pose tangent and Jt (Kt, Pp, D, 3) wrt the plane's tangent
    chart, in closed form, as jax.jacfwd of the JAX module's residual
    (``_plane_jacs``) gives them at 0; K33 computes the same.
      retract: n = n0 + th0 b1 + th1 b2, n_w = n / |n|, d_w = d0 + th2, so
        dn_w/dth_j = (b_j - n_w (n_w . b_j)) / |n| (j = 0, 1), dd_w/dth2 = 1;
      transform by exp(x) T: dn_c = dphi x n_c, dd_c = -n_c . drho (a turn
        about the camera centre keeps d), and through the chart
        dn_c = R dn_w, dd_c = dd_w - (R dn_w) . t;
      normalize: de = sgn (dc - c (n_c . dn_c) / s^2) / s with s the safe
        norm of n_c and sgn the sign that makes d >= 0;
    each error row is the estimate dotted with a vector of the measurement
    (its tangent basis, the basis of the measurement turned into the
    estimate's hemisphere, its normal), which carries no derivative;
    ominus_ver's second row is identically 0."""
    s_idx = slot.long()
    c, n_w, b1, b2, sn = _plane_estimate(poses_c, plane_base[s_idx],
                                         theta[s_idx])
    n_c = c[..., :3]
    zero = torch.zeros_like(c[..., 0])
    cols = [torch.stack([zero, zero, zero, -n_c[..., k]], dim=-1)
            for k in range(3)]
    cols += [torch.stack([zero, -n_c[..., 2], n_c[..., 1], zero], dim=-1),
             torch.stack([n_c[..., 2], zero, -n_c[..., 0], zero], dim=-1),
             torch.stack([-n_c[..., 1], n_c[..., 0], zero, zero], dim=-1)]
    for b in (b1, b2):
        dn_w = (b - n_w * _dot3(n_w, b)[..., None]) / sn
        dn = torch.stack([_dot3(poses_c[:, None, i, :3], dn_w)
                          for i in range(3)], dim=-1)
        cols.append(torch.cat([dn, -_dot3(dn, poses_c[:, None, :3, 3])[
            ..., None]], dim=-1))
    cols.append(torch.stack([zero, zero, zero, torch.ones_like(zero)], -1))
    dc = torch.stack(cols, dim=-1)                        # (Kt, Pp, 4, 9)
    sc = _norm3(n_c)[..., None]
    sgn = torch.where(c[..., 3:4] / sc < 0, -1.0, 1.0)
    nd = _dot3(n_c[..., :, None].transpose(-1, -2), dc[..., :3, :]
               .transpose(-1, -2))                         # (Kt, Pp, 9)
    de = sgn[..., None] * (dc - c[..., :, None] * (nd / (sc * sc))[
        ..., None, :]) / sc[..., None]
    rows, vecs = _plane_rows(c, pi_obs, kind)

    def jac_row(v):
        if v is not None:
            return _dot3(v[..., None, :], de[..., :3, :].transpose(-1, -2))
        if kind == 0:
            return de[..., 3, :]                  # the distance row
        return torch.zeros_like(de[..., 0, :])    # ominus_ver's second row

    J = torch.stack([jac_row(v) for v in vecs], dim=-2)
    return torch.stack(rows, dim=-1), J[..., :6], J[..., 6:]


def _all_chi2_tables(poses_c, lm_c, plane_base, P, pt, ln, pl, par, ver,
                     pt_slot, ln_slot, pl_slot, par_slot, ver_slot,
                     is_stereo, K, bf, w):
    """Per-observation chi2 of every table at the given state (residuals
    only; shared by both solvers): the JAX module's formulas, each product
    and sum spelled in a fixed order (K34's plain version)."""
    fx, fy, cx, cy = K
    pts = lm_c[:P]
    bf_t = literal(float(np.float32(bf)), lm_c.dtype, lm_c.device)

    pc = _affine3(poses_c, pts[pt_slot.long()])
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    urh = u - bf_t / z
    r0 = pt.uv[..., 0] - u
    r1 = pt.uv[..., 1] - v
    r2 = torch.where(is_stereo, pt.ur - urh, 0.0)
    chi_pt = (r0 * r0 + r1 * r1 + r2 * r2) * pt.inv_s2

    pcl = _affine3(poses_c, pts[ln_slot.long()])
    zl = torch.clamp(pcl[..., 2], min=1e-6)
    ul = fx * pcl[..., 0] / zl + cx
    vl = fy * pcl[..., 1] / zl + cy
    r_ln = (ln.line2d[..., 0] * ul + ln.line2d[..., 1] * vl
            + ln.line2d[..., 2])
    chi_ln = r_ln * r_ln * ln.inv_s2

    Q = plane_base.shape[0]
    infos = (w.angle_info, w.angle_info, w.dis_info), \
        (w.par_info, w.par_info), (w.ver_info, w.ver_info)

    def plane_chi(tables, slot, kind):
        if Q == 0 or slot.shape[1] == 0:
            return torch.zeros(slot.shape, dtype=lm_c.dtype,
                               device=lm_c.device)
        s = slot.long()
        return _plane_chi(poses_c, plane_base[s], lm_c[P:][s], tables.pi_obs,
                          kind, infos[kind])

    return (chi_pt, chi_ln, plane_chi(pl, pl_slot, 0),
            plane_chi(par, par_slot, 1), plane_chi(ver, ver_slot, 2))


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


# K8's scratch row per observation (csrc/ba_normal_eqs.cu kStride) and the
# column of its 18 cross terms (kHcp), row-major 6 x 3
NORMAL_EQS_STRIDE, NORMAL_EQS_CROSS = 54, 36


def ba_normal_eqs_plain(poses, pts, pt: PointTables, ln: LineTables, M: int,
                        K, bf: float, huber: bool = True,
                        want_hcp: bool = True, want_cross: bool = False):
    """Plain version of K8 (the kernel's `plan` only orders its sums).
    poses (Kt, 4, 4), pts (P, 3) float32; tables with slots clipped to
    [0, P). Returns Hcc (Kt, 6, 6), bc (Kt, 6),
    Hpp (M, 3, 3), bp (M, 3), Hcp (Kt, 6, M, 3) or None, chi_pt (Kt, F),
    chi_ln (Kt, L2) and, with want_cross, each observation's cross block
    J_pose^T W J_lm as a row of 18 (Kt (F + L2), 18): points o = k F + f,
    then line endpoints Kt F + k L2 + l."""
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
    cross = [torch.einsum("kfai,kfa,kfaj->kfij", Jpose, Wp, Jpt
                          ).reshape(-1, 6, 3)]
    if want_hcp:
        Hcp = segment_sum(cross[0], (kf_ids * M + pt.slot).reshape(-1),
                          Kt * M)
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
        cross.append(torch.einsum("kli,kl,klj->klij", Jp, w_ln, Jl
                                  ).reshape(-1, 6, 3))
        if want_hcp:
            Hcp = Hcp + segment_sum(cross[1],
                                    (kf_ids * M + ln.slot).reshape(-1),
                                    Kt * M)
    if want_hcp:
        Hcp = Hcp.view(Kt, M, 6, 3).permute(0, 2, 1, 3).contiguous()
    if want_cross:
        return (Hcc, bc, Hpp, bp, Hcp, chi_pt, chi_ln,
                torch.cat(cross).reshape(-1, 18))
    return Hcc, bc, Hpp, bp, Hcp, chi_pt, chi_ln


def ba_normal_eqs(poses, pts, pt: PointTables, ln: LineTables, M: int, K,
                  bf: float, huber: bool = True, want_hcp: bool = True,
                  plan: Optional[ObsPlan] = None, want_cross: bool = False):
    """K8 wrapper; the arguments and results of ``ba_normal_eqs_plain``
    (`plan` from ``obs_plan`` on the same tables). The cross blocks are a
    view of the kernel's scratch (rows 54 floats apart), which the PCG
    solve's K43 reads."""
    if kernels.on_cpu(poses, pts, *pt, *ln):
        return ba_normal_eqs_plain(poses, pts, pt, ln, M, K, bf, huber,
                                   want_hcp, want_cross)
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
    scratch = torch.empty((Kt * (F + L2), NORMAL_EQS_STRIDE), dtype=f32,
                          device=dev)
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
    if want_cross:
        return (Hcc, bc, Hpp, bp, Hcp, chi_pt, chi_ln,
                scratch[:, NORMAL_EQS_CROSS:NORMAL_EQS_CROSS + 18])
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
# K40: the landmark product of the reduced camera system


class PairPlan(NamedTuple):
    """K40's plan, fixed for one solve: bits (Kt, W) int32 (a leading batch
    as the tables'), W = ceil(M / 32); bit p % 32 of word p // 32 of row k
    is set when keyframe k has a live observation (mask > 0) of landmark p:
    a point or line endpoint at its slot, a plane at P + its slot. A
    keyframe that sees a landmark twice sets its bit once (Hcp has summed
    both), and keyframes k and q share exactly the landmarks of row k &
    row q. counts (Kt,) int32: the set bits of each row."""

    bits: torch.Tensor
    counts: torch.Tensor


def pair_plan(pt_slot, pt_mask, ln_slot, ln_mask, plane_slots, plane_masks,
              P: int, M: int) -> PairPlan:
    """Build K40's plan on the tables' device, from every table that adds
    to Hcp (clipped slots; plane_slots and plane_masks the three plane
    tables', left out when there is no plane block, M == P). Slots (...,
    Kt, n) with an optional leading batch. No host sync: one scatter of the
    live flags by maximum, then the flags packed 32 to a word."""
    lead, Kt = tuple(pt_slot.shape[:-2]), pt_slot.shape[-2]
    Bn = int(np.prod(lead)) if lead else 1
    W = (M + 31) // 32
    dev = pt_slot.device
    live = torch.zeros((Bn, Kt, W * 32), dtype=torch.int32, device=dev)
    tables = [(pt_slot, pt_mask, 0), (ln_slot, ln_mask, 0)]
    if M > P:
        tables += [(s, m, P) for s, m in zip(plane_slots, plane_masks)]
    for slot, mask, off in tables:
        if slot.shape[-1] == 0:
            continue
        live.scatter_reduce_(
            2, (slot.long() + off).reshape(Bn, Kt, -1),
            (mask > 0).to(torch.int32).reshape(Bn, Kt, -1), reduce="amax")
    weight = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev),
        torch.arange(32, dtype=torch.int64, device=dev))
    words = torch.sum(live.view(Bn, Kt, W, 32).long() * weight, dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    counts = torch.sum(live, dim=-1, dtype=torch.int32)
    return PairPlan(words.to(torch.int32).reshape(lead + (Kt, W))
                    .contiguous(), counts.reshape(lead + (Kt,)).contiguous())


def plan_incidence(plan: PairPlan, M: int) -> torch.Tensor:
    """The plan's (..., Kt, M) bool incidence: keyframe k sees landmark p."""
    bits = plan.bits.long() & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    flags = (bits[..., None] >> shifts) & 1
    return flags.reshape(bits.shape[:-1] + (-1,))[..., :M] > 0


def ba_schur_complement_plain(HcpHinv, Hcp):
    """Plain version of K40: S (6 Kt, 6 Kt) = -(HcpHinv Hcp^T) over the
    flattened (6 Kt, 3 M) operands, one dense float32 product (the
    kernel's plan only tells it which blocks are not zero). HcpHinv and Hcp
    (Kt, 6, M, 3), each with an optional leading batch dimension (one
    product per problem)."""
    if Hcp.dim() == 5:
        return torch.stack([ba_schur_complement_plain(a, b)
                            for a, b in zip(HcpHinv, Hcp)])
    Kt, M = Hcp.shape[0], Hcp.shape[2]
    return -(HcpHinv.reshape(Kt * 6, M * 3) @ Hcp.reshape(Kt * 6, M * 3).T)


def ba_schur_complement(HcpHinv, Hcp, plan: Optional[PairPlan]):
    """K40 wrapper; the arguments and results of
    ``ba_schur_complement_plain`` (`plan` from ``pair_plan`` on the solve's
    tables, with the same leading batch). One launch."""
    if kernels.on_cpu(HcpHinv, Hcp, *(plan or ())):
        return ba_schur_complement_plain(HcpHinv, Hcp)
    lead = tuple(Hcp.shape[:-4])
    B = int(np.prod(lead)) if lead else 1
    Kt, M = Hcp.shape[-4], Hcp.shape[-2]
    W = (M + 31) // 32
    f32 = torch.float32
    kernels.check(HcpHinv, "HcpHinv", f32, lead + (Kt, 6, M, 3))
    kernels.check(Hcp, "Hcp", f32, lead + (Kt, 6, M, 3))
    kernels.check(plan.bits, "plan.bits", torch.int32, lead + (Kt, W))
    kernels.check(plan.counts, "plan.counts", torch.int32, lead + (Kt,))
    S = torch.empty(lead + (6 * Kt, 6 * Kt), dtype=f32, device=Hcp.device)
    with torch.cuda.device(Hcp.device):
        kernels.launch("psl_ba_schur_complement", kernels.ptr(HcpHinv),
                       kernels.ptr(Hcp), kernels.ptr(plan.bits),
                       kernels.ptr(plan.counts), B, Kt, M, W,
                       kernels.ptr(S))
    kernels.LAUNCHES["ba_schur_complement"] += 1
    return S


# ---------------------------------------------------------------------------
# the problem of one solve


class _Problem(NamedTuple):
    """What stays fixed for one solve: clipped slots, gates, masks, the
    plane tables, K8's plan and K40's."""

    P: int
    Q: int
    M: int
    pt: PointTables
    ln: LineTables
    planes: tuple           # ((tables, slot, kind, info, gate), ...)
    pl_slots: tuple
    is_stereo: torch.Tensor
    gates: tuple
    masks: tuple
    plan: ObsPlan
    w: BAWeights
    pairs: Optional[PairPlan] = None


def _problem(lm_xyz, plane_base, pt, ln, pl, par, ver, w,
             want_pairs: bool = True) -> _Problem:
    """The problem of one solve; with a leading batch on every table (and
    lm_xyz (B, P, 3), plane_base (B, Q, 4)) the batch of K33's, K34's and
    K40's wrappers, without K8's plan. The plans are built on a card only
    (the plain versions take no order), K40's unless want_pairs is False
    (the matrix-free PCG solve makes no S)."""
    P = lm_xyz.shape[-2]
    Q = plane_base.shape[-2]
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
    planes = ((pl, pl_slot, 0, w_pl, w.plane_chi),
              (par, par_slot, 1, w_par, w.vp_chi),
              (ver, ver_slot, 2, w_ver, w.vp_chi))
    plan = pairs = None
    if not kernels.on_cpu(pt.slot):
        if lm_xyz.dim() == 2:
            plan = obs_plan(pt.slot, pt.mask, ln.slot, ln.mask, M)
        if want_pairs:
            pairs = pair_plan(pt.slot, pt.mask, ln.slot, ln.mask,
                              (pl_slot, par_slot, ver_slot),
                              (pl.mask, par.mask, ver.mask), P, M)
    return _Problem(P, Q, M, pt, ln, planes, (pl_slot, par_slot, ver_slot),
                    is_stereo,
                    (gate_pt, CHI2_MONO, w.plane_chi, w.vp_chi, w.vp_chi),
                    (pt.mask, ln.mask, pl.mask, par.mask, ver.mask), plan, w,
                    pairs)


def _chi2(pb: _Problem, poses_c, lm_c, plane_base, K, bf, w):
    return _all_chi2_tables(poses_c, lm_c, plane_base, pb.P, pb.pt, pb.ln,
                            pb.planes[0][0], pb.planes[1][0],
                            pb.planes[2][0], pb.pt.slot, pb.ln.slot,
                            *pb.pl_slots, pb.is_stereo, K, bf, w)


def _active_planes(pb: _Problem) -> list:
    """The plane tables that add terms: none without a plane block, and no
    table without observation slots."""
    if pb.Q == 0:
        return []
    return [pl for pl in pb.planes if pl[1].shape[-1] > 0]


def _problem_at(pb: _Problem, b: int) -> _Problem:
    """Problem b of a batched _Problem."""
    def at(x):
        return x[b] if isinstance(x, torch.Tensor) else x

    def tab(t):
        return type(t)(*map(at, t))

    return pb._replace(
        pt=tab(pb.pt), ln=tab(pb.ln),
        planes=tuple((tab(t), at(s), k, i, g) for t, s, k, i, g in pb.planes),
        pl_slots=tuple(map(at, pb.pl_slots)), is_stereo=at(pb.is_stereo),
        gates=tuple(map(at, pb.gates)), masks=tuple(map(at, pb.masks)))


def _stacked(outs):
    """Per-problem results stacked along a new leading batch dimension
    (tuples, named tuples and lists of PlaneTerms walked)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if first is None:
        return None
    if isinstance(first, list):
        return [_stacked(list(x)) for x in zip(*outs)]
    fields = [_stacked(list(x)) for x in zip(*outs)]
    return type(first)(*fields) if hasattr(first, "_fields") \
        else tuple(fields)


# ---------------------------------------------------------------------------
# K33: the plane blocks of the normal equations


class PlaneTerms(NamedTuple):
    """One plane table's per-observation terms (the PCG products' factors):
    slot (Kt, Pp), rr and Wv (Kt, Pp, D), Jx (Kt, Pp, D, 6), Jt (Kt, Pp, D,
    3), Wv the Huber-weighted information."""

    slot: torch.Tensor
    rr: torch.Tensor
    Jx: torch.Tensor
    Jt: torch.Tensor
    Wv: torch.Tensor


def _mu_p(Hpp):
    """The mean observed landmark diagonal: the absolute floor of the
    landmark damping."""
    diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    n_obs = torch.sum(diag_p.sum(-1) > 0) + 1
    return torch.sum(diag_p) / (3 * n_obs)


def plane_blocks_plain(pb: _Problem, poses_c, plane_base, theta, Hcc, bc,
                       Hpp, bp, Hcp, huber: bool = True):
    """Plain version of K33. Per plane observation the residual, the
    closed-form Jacobians (``plane_jacs_closed``) and the Huber-weighted
    information, summed into Hcc (Kt, 6, 6), bc (Kt, 6), the plane rows
    P.. of Hpp (M, 3, 3) and bp (M, 3) and, unless Hcp is None, the plane
    columns of Hcp (Kt, 6, M, 3) (added in place). Returns Hcc, bc, Hpp,
    bp, Hcp, the PlaneTerms of each table that has slots, and mu_p (0-d),
    the landmark damping floor of the summed Hpp."""
    P, M = pb.P, pb.M
    terms = []
    for tables, slot, kind, info, gate in _active_planes(pb):
        rr, Jx, Jt = plane_jacs_closed(poses_c, plane_base, theta, slot,
                                       tables.pi_obs, kind)
        chi = torch.sum(rr * rr * info, dim=-1)
        Wv = (_huber_w_fn(chi, gate, huber) * tables.mask)[..., None] * info
        terms.append(PlaneTerms(slot, rr, Jx, Jt, Wv))
        rw = rr * Wv
        Hcc = Hcc + torch.einsum("kpdi,kpd,kpdj->kij", Jx, Wv, Jx)
        bc = bc + torch.einsum("kpdi,kpd->ki", Jx, rw)
        flat = (slot + P).reshape(-1)
        Hpp = Hpp + segment_sum(torch.einsum(
            "kpdi,kpd,kpdj->kpij", Jt, Wv, Jt).reshape(-1, 3, 3), flat, M)
        bp = bp + segment_sum(torch.einsum(
            "kpdi,kpd->kpi", Jt, rw).reshape(-1, 3), flat, M)
        if Hcp is not None:
            # the plane columns summed per keyframe by a one-hot product
            C = torch.einsum("kpdi,kpd,kpdj->kpij", Jx, Wv, Jt)
            onehot = torch.nn.functional.one_hot(
                slot.long(), pb.Q).to(C.dtype)            # (Kt, Pp, Q)
            Hcp[:, :, P:, :] += torch.einsum("kpq,kpij->kiqj", onehot, C)
    return Hcc, bc, Hpp, bp, Hcp, terms, _mu_p(Hpp)


def ba_plane_blocks(pb: _Problem, poses_c, plane_base, theta, Hcc, bc, Hpp,
                    bp, Hcp, huber: bool = True):
    """K33 wrapper; the arguments and results of ``plane_blocks_plain``,
    each with an optional leading batch dimension (a batched _Problem,
    poses_c (B, Kt, 4, 4), plane_base (B, Q, 4), theta (B, Q, 3), the sums
    (B, ...); mu_p (B,)). On the card the sums are added in place into
    K8's outputs, and each table's terms are views of one (Kt, Pp, D, 11)
    record buffer (r, Wv, Jx, Jt). Two launches with plane tables (the
    blocks, then the mu_p pass), one without."""
    batched = poses_c.dim() == 4
    if kernels.on_cpu(poses_c, plane_base, theta, Hcc, bc, Hpp, bp):
        if not batched:
            return plane_blocks_plain(pb, poses_c, plane_base, theta, Hcc,
                                      bc, Hpp, bp, Hcp, huber)
        return _stacked([plane_blocks_plain(
            _problem_at(pb, b), poses_c[b], plane_base[b], theta[b], Hcc[b],
            bc[b], Hpp[b], bp[b], None if Hcp is None else Hcp[b], huber)
            for b in range(poses_c.shape[0])])
    lead = poses_c.shape[:1] if batched else ()
    B = poses_c.shape[0] if batched else 1
    Kt, P, Q, M = poses_c.shape[-3], pb.P, pb.Q, pb.M
    f32 = torch.float32
    kernels.check(poses_c, "poses_c", f32, lead + (Kt, 4, 4))
    kernels.check(plane_base, "plane_base", f32, lead + (Q, 4))
    kernels.check(theta, "theta", f32, lead + (Q, 3))
    kernels.check(Hcc, "Hcc", f32, lead + (Kt, 6, 6))
    kernels.check(bc, "bc", f32, lead + (Kt, 6))
    kernels.check(Hpp, "Hpp", f32, lead + (M, 3, 3))
    kernels.check(bp, "bp", f32, lead + (M, 3))
    if Hcp is not None:
        kernels.check(Hcp, "Hcp", f32, lead + (Kt, 6, M, 3))
    dev = poses_c.device
    active = _active_planes(pb)
    terms, args = [], []
    for tables, slot, kind, _, _ in pb.planes:
        Pp = slot.shape[-1] if any(a[2] == kind for a in active) else 0
        D = 3 if kind == 0 else 2
        rec = torch.empty(lead + (Kt, Pp, D, 11), dtype=f32, device=dev)
        if Pp:
            kernels.check(slot, "slot", torch.int32, lead + (Kt, Pp))
            kernels.check(tables.pi_obs, "pi_obs", f32, lead + (Kt, Pp, 4))
            kernels.check(tables.mask, "mask", f32, lead + (Kt, Pp))
            terms.append(PlaneTerms(slot, rec[..., 0], rec[..., 2:8],
                                    rec[..., 8:11], rec[..., 1]))
        args += [kernels.ptr(slot), kernels.ptr(tables.pi_obs),
                 kernels.ptr(tables.mask), Pp, kernels.ptr(rec)]
    w = pb.w
    mu_p = torch.empty(lead, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        if active:
            kernels.launch(
                "psl_ba_plane_blocks", kernels.ptr(poses_c),
                kernels.ptr(plane_base), kernels.ptr(theta), B, Kt, Q, P, M,
                *args, w.angle_info, w.dis_info, w.par_info, w.ver_info,
                w.plane_chi, w.vp_chi, int(huber), kernels.ptr(Hcc),
                kernels.ptr(bc), kernels.ptr(Hpp), kernels.ptr(bp),
                kernels.ptr(Hcp) if Hcp is not None else None)
            kernels.LAUNCHES["ba_plane_blocks"] += 1
        kernels.launch("psl_ba_mu_p", kernels.ptr(Hpp), B, M,
                       kernels.ptr(mu_p))
    kernels.LAUNCHES["ba_plane_blocks"] += 1
    return Hcc, bc, Hpp, bp, Hcp, terms, mu_p


# ---------------------------------------------------------------------------
# K34: the LM step's cost test


# K34's scratch per keyframe (csrc/ba_step.cu kScratch): the new pose (16
# floats), the keyframe's decrease per table from COST_SCRATCH_SUMS on (pt,
# ln, pl, par, ver), the finite flag
COST_SCRATCH, COST_SCRATCH_SUMS = 22, 16


class CostTest(NamedTuple):
    """The state after the accept test: poses (Kt, 4, 4), lm (M, 3), lam,
    accept (0-d bool) and the robust cost decrease (0-d)."""

    poses: torch.Tensor
    lm: torch.Tensor
    lam: torch.Tensor
    accept: torch.Tensor
    decrease: torch.Tensor


def cost_test_plain(pb: _Problem, poses_c, lm_c, dxc, dxp, lam, plane_base,
                    K, bf: float, huber: bool = True) -> CostTest:
    """Plain version of K34: poses_new = se3_exp(dxc) poses_c, lm_new =
    lm_c + dxp, the per-observation chi2 of the five tables at both states,
    the robust decrease as a sum of per-observation differences (tables
    in the order pt, ln, pl, par, ver), the finite test, the accept and
    the selected state and lam."""
    poses_new = se3.se3_exp(dxc) @ poses_c
    lm_new = lm_c + dxp
    decrease = _robust_decrease_tables(
        _chi2(pb, poses_new, lm_new, plane_base, K, bf, pb.w),
        _chi2(pb, poses_c, lm_c, plane_base, K, bf, pb.w),
        pb.gates, pb.masks, huber)
    finite = (torch.isfinite(decrease) & torch.all(torch.isfinite(dxc))
              & torch.all(torch.isfinite(dxp)))
    accept = (decrease < 0.0) & finite
    return CostTest(torch.where(accept, poses_new, poses_c),
                    torch.where(accept, lm_new, lm_c),
                    torch.clamp(torch.where(accept, lam * 0.3, lam * 6.0),
                                1e-8, 1e6),
                    accept, decrease)


def _cost_test_launch(pb: _Problem, poses_c, lm_c, plane_base, K, bf,
                      huber, step=None, chis=None):
    """One K34 call: the cost test of `step` = (dxc, dxp, lam, poses_new,
    lm_out, lam_out, accept, decrease, scratch), or with chis the tables
    mode, which writes the five per-observation chi2 tables. A leading
    batch on poses_c (B, Kt, 4, 4) runs B problems."""
    lead = poses_c.shape[:1] if poses_c.dim() == 4 else ()
    B = poses_c.shape[0] if lead else 1
    Kt, P, Q, M = poses_c.shape[-3], pb.P, pb.Q, pb.M
    f32, i32 = torch.float32, torch.int32
    pt, ln = pb.pt, pb.ln
    F, L2 = pt.slot.shape[-1], ln.slot.shape[-1]
    kernels.check(poses_c, "poses", f32, lead + (Kt, 4, 4))
    kernels.check(lm_c, "lm", f32, lead + (M, 3))
    kernels.check(plane_base, "plane_base", f32, lead + (Q, 4))
    kernels.check(pt.slot, "pt.slot", i32, lead + (Kt, F))
    kernels.check(ln.slot, "ln.slot", i32, lead + (Kt, L2))
    for name, t, shape in (("pt.uv", pt.uv, (Kt, F, 2)),
                           ("pt.ur", pt.ur, (Kt, F)),
                           ("pt.inv_s2", pt.inv_s2, (Kt, F)),
                           ("pt.mask", pt.mask, (Kt, F)),
                           ("ln.line2d", ln.line2d, (Kt, L2, 3)),
                           ("ln.inv_s2", ln.inv_s2, (Kt, L2)),
                           ("ln.mask", ln.mask, (Kt, L2))):
        kernels.check(t, name, f32, lead + shape)
    planes = []
    for tables, slot, kind, _, _ in pb.planes:
        Pp = slot.shape[-1] if Q > 0 else 0
        if Pp:
            kernels.check(slot, "slot", i32, lead + (Kt, Pp))
            kernels.check(tables.pi_obs, "pi_obs", f32, lead + (Kt, Pp, 4))
            kernels.check(tables.mask, "mask", f32, lead + (Kt, Pp))
        planes += [kernels.ptr(slot), kernels.ptr(tables.pi_obs),
                   kernels.ptr(tables.mask), Pp]
    if step is None:
        step = (None,) * 9
    else:
        kernels.check(step[0], "dxc", f32, lead + (Kt, 6))
        kernels.check(step[1], "dxp", f32, lead + (M, 3))
        kernels.check(step[2], "lam", f32, lead)
    if chis is None:
        chis = (None,) * 5
    w = pb.w
    fx, fy, cx, cy = (float(np.float32(v)) for v in K)
    with torch.cuda.device(poses_c.device):
        kernels.launch(
            "psl_ba_cost_test", kernels.ptr(poses_c), kernels.ptr(lm_c),
            kernels.ptr(plane_base), B, Kt, P, Q, M, kernels.ptr(pt.slot),
            kernels.ptr(pt.uv), kernels.ptr(pt.ur), kernels.ptr(pt.inv_s2),
            kernels.ptr(pt.mask), F, kernels.ptr(ln.slot),
            kernels.ptr(ln.line2d), kernels.ptr(ln.inv_s2),
            kernels.ptr(ln.mask), L2, *planes, fx, fy, cx, cy,
            float(np.float32(bf)), w.angle_info, w.dis_info, w.par_info,
            w.ver_info, w.plane_chi, w.vp_chi, int(huber),
            *[None if x is None else kernels.ptr(x) for x in step],
            *[None if x is None else kernels.ptr(x) for x in chis])
    kernels.LAUNCHES["ba_cost_test"] += 1


def ba_cost_test(pb: _Problem, poses_c, lm_c, dxc, dxp, lam, plane_base, K,
                 bf: float, huber: bool = True) -> CostTest:
    """K34 wrapper; the arguments and results of ``cost_test_plain``, each
    with an optional leading batch dimension (a batched _Problem, poses_c
    (B, Kt, 4, 4), lm_c (B, M, 3), dxc, dxp, lam (B,), plane_base (B, Q,
    4)). One launch decides on the card: no host sync."""
    batched = poses_c.dim() == 4
    if kernels.on_cpu(poses_c, lm_c, dxc, dxp, lam, plane_base):
        if not batched:
            return cost_test_plain(pb, poses_c, lm_c, dxc, dxp, lam,
                                   plane_base, K, bf, huber)
        return _stacked([cost_test_plain(
            _problem_at(pb, b), poses_c[b], lm_c[b], dxc[b], dxp[b], lam[b],
            plane_base[b], K, bf, huber) for b in range(poses_c.shape[0])])
    lead = poses_c.shape[:1] if batched else ()
    Kt, M = poses_c.shape[-3], lm_c.shape[-2]
    dev, f32 = poses_c.device, torch.float32
    out = CostTest(torch.empty(lead + (Kt, 4, 4), dtype=f32, device=dev),
                   torch.empty(lead + (M, 3), dtype=f32, device=dev),
                   torch.empty(lead, dtype=f32, device=dev),
                   torch.empty(lead, dtype=torch.bool, device=dev),
                   torch.empty(lead, dtype=f32, device=dev))
    # new poses, per-keyframe table sums, per-keyframe finite flags
    scratch = torch.empty(lead + (Kt * COST_SCRATCH,), dtype=f32,
                          device=dev)
    _cost_test_launch(pb, poses_c, lm_c, plane_base, K, bf, huber,
                      step=(dxc, dxp, lam, out.poses, out.lm, out.lam,
                            out.accept, out.decrease, scratch))
    return out


def ba_chi2_tables(pb: _Problem, poses, lm, plane_base, K, bf: float):
    """K34's tables mode: the per-observation chi2 of the five tables at
    one state (chi_pt, chi_ln, chi_pl, chi_par, chi_ver); plain: _chi2.
    An optional leading batch as ``ba_cost_test``'s."""
    if kernels.on_cpu(poses, lm, plane_base):
        if poses.dim() == 3:
            return _chi2(pb, poses, lm, plane_base, K, bf, pb.w)
        return _stacked([_chi2(_problem_at(pb, b), poses[b], lm[b],
                               plane_base[b], K, bf, pb.w)
                         for b in range(poses.shape[0])])
    dev, f32 = poses.device, torch.float32
    chis = tuple(torch.zeros(t.shape, dtype=f32, device=dev)
                 for t in (pb.pt.slot, pb.ln.slot, *pb.pl_slots))
    _cost_test_launch(pb, poses.contiguous(), lm.contiguous(), plane_base,
                      K, bf, True, chis=chis)
    return chis


# ---------------------------------------------------------------------------
# K35: the damped reduced camera system


def reduced_system_plain(S, Hcc, rhs, lam, fixed_mask):
    """Plain version of K35 for one problem. S (6 Kt, 6 Kt) = -(Hcp Hpp^-1)
    Hcp^T, Hcc (Kt, 6, 6), rhs (Kt, 6), lam 0-d, fixed_mask (Kt,) (1 =
    fixed). Returns the damped system with Hcc on its diagonal blocks and
    the fixed poses eliminated (their rows and columns exactly the
    identity), and rhs_vec (6 Kt, 1) with the fixed rows zeroed."""
    Kt = Hcc.shape[0]
    kidx = torch.arange(Kt, device=S.device)
    free_rep = torch.repeat_interleave(1.0 - fixed_mask, 6)
    S = S.clone()
    S.view(Kt, 6, Kt, 6)[kidx, :, kidx, :] += Hcc
    diag_S = torch.diagonal(S)
    mu_c = torch.sum(diag_S * free_rep) / (torch.sum(free_rep) + 1.0)
    eye_c = torch.eye(Kt * 6, dtype=S.dtype, device=S.device)
    S = S + lam * torch.diag(diag_S) + (lam * mu_c + 1e-8) * eye_c
    # exact elimination of fixed poses: identity rows/cols, zero rhs
    S = S * free_rep[:, None] * free_rep[None, :] + torch.diag(
        1.0 - free_rep)
    return S, (rhs.reshape(-1) * free_rep)[:, None]


def ba_reduced_system(S, Hcc, rhs, lam, fixed_mask):
    """K35 wrapper; the arguments and results of ``reduced_system_plain``,
    each with an optional leading batch dimension (B problems: S (B, n,
    n), Hcc (B, Kt, 6, 6), rhs (B, Kt, 6), lam (B,), fixed_mask (B, Kt))."""
    batched = S.dim() == 3
    if kernels.on_cpu(S, Hcc, rhs, lam, fixed_mask):
        if not batched:
            return reduced_system_plain(S, Hcc, rhs, lam, fixed_mask)
        return kernels.per_problem(reduced_system_plain,
                                   (S, Hcc, rhs, lam, fixed_mask))
    lead = S.shape[:1] if batched else ()
    B = S.shape[0] if batched else 1
    Kt = Hcc.shape[-3]
    n, f32 = 6 * Kt, torch.float32
    kernels.check(S, "S", f32, lead + (n, n))
    kernels.check(Hcc, "Hcc", f32, lead + (Kt, 6, 6))
    kernels.check(rhs, "rhs", f32, lead + (Kt, 6))
    kernels.check(lam, "lam", f32, lead)
    kernels.check(fixed_mask, "fixed_mask", f32, lead + (Kt,))
    S_out = torch.empty_like(S)
    rhs_vec = torch.empty(lead + (n, 1), dtype=f32, device=S.device)
    with torch.cuda.device(S.device):
        kernels.launch("psl_ba_reduced_system", kernels.ptr(S),
                       kernels.ptr(Hcc), kernels.ptr(rhs), kernels.ptr(lam),
                       kernels.ptr(fixed_mask), B, Kt, kernels.ptr(S_out),
                       kernels.ptr(rhs_vec))
    kernels.LAUNCHES["ba_reduced_system"] += 1
    return S_out, rhs_vec


# ---------------------------------------------------------------------------
# the solver


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
    fixed_mask = fixed_mask.contiguous()

    def step(poses_c, lm_c, lam):
        pts = lm_c[:P]
        Hcc, bc, Hpp, bp, Hcp, _, _ = ba_normal_eqs(
            poses_c, pts, pb.pt, pb.ln, M, K, bf, huber, True, pb.plan)
        with record_function("ba_core.plane_blocks"):
            Hcc, bc, Hpp, bp, Hcp, _, mu_p = ba_plane_blocks(
                pb, poses_c, plane_base, lm_c[P:], Hcc, bc, Hpp, bp, Hcp,
                huber)
        Hinv, HcpHinv, rhs = ba_schur_eliminate(Hpp, bp, Hcp, bc, lam, mu_p)
        with record_function("ba_core.schur_complement"):
            S = ba_schur_complement(HcpHinv, Hcp, pb.pairs)
        with record_function("ba_core.reduced_system"):
            S, rhs_vec = ba_reduced_system(S, Hcc, rhs, lam, fixed_mask)
        # one step of iterative refinement; a matrix that is not positive
        # definite gives NaN, which the finite test below rejects (as JAX's
        # cho_factor does)
        with record_function("ba_core.cholesky"):
            L, info = torch.linalg.cholesky_ex(S)
            dx0 = torch.cholesky_solve(rhs_vec, L)
            dx = dx0 + torch.cholesky_solve(rhs_vec - S @ dx0, L)
            dxc = torch.where(info == 0, -dx.reshape(Kt, 6), float("nan"))
        dxp = ba_schur_backsub(Hinv, bp, Hcp, dxc.contiguous())
        with record_function("ba_core.cost_test"):
            out = ba_cost_test(pb, poses_c, lm_c, dxc.contiguous(), dxp, lam,
                               plane_base, K, bf, huber)
        return out.poses, out.lm, out.lam

    lm = torch.cat([lm_xyz.to(dt), torch.zeros((pb.Q, 3), dtype=dt,
                                               device=dev)], dim=0)
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        poses, lm, lam = step(poses.contiguous(), lm.contiguous(), lam)
    return _finish(pb, poses, lm, plane_base, K, bf)


def _finish(pb: _Problem, poses, lm, plane_base, K, bf):
    chi_pt, chi_ln, chi_pl, chi_par, chi_ver = ba_chi2_tables(
        pb, poses, lm, plane_base, K, bf)
    P = pb.P
    plane_out = (plane_geo.normalize(plane_retract(plane_base, lm[P:]))
                 if pb.Q > 0 else plane_base)
    return poses, lm[:P], plane_out, {
        "pt": chi_pt, "ln": chi_ln, "pl": chi_pl, "par": chi_par,
        "ver": chi_ver}
