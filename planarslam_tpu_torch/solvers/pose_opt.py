"""Pose-only nonlinear least squares over point/line/plane residuals.

Port of ``planarslam_tpu/solvers/pose_opt.py``: all residuals live in
fixed-capacity masked blocks (points, line endpoints, planes, parallel and
vertical planes); each LM step solves the 6x6 normal equations. 4 rounds x
10 LM iterations; every round restarts from the initial pose with refreshed
chi2 inlier masks, and the Huber kernel is dropped in the last round.

The JAX module takes the stacked Jacobian from ``jax.jacfwd``. Here it is
written out in closed form (``_residuals_and_jacobian``): the derivative of
each block at xi = 0 under the left update exp(xi) @ T, through the same
projection and plane normalization. ``torch.func.jacfwd`` gives the same
matrix, but it decomposes every op into Python references and cost 90% of
the step's host time.

``rotation_fixed`` is a bool or a 0-d bool tensor on the device. The JAX
module solves a 3-dof translation-only problem when it is set; here the
solve always keeps 6 dof and zeroes the rotation columns of the Jacobian
where the flag is set: the rotation step is then exactly 0 and
se3_exp([rho, 0]) @ T adds rho to the translation as the 3-dof update
does, so the caller needs no host-side branch.

Kernel K11 ``pose_optimize`` (``csrc/pose_opt.cu``) runs the whole call,
every round and LM step, in one launch of one thread block per problem
(B problems with a leading B share the launch), reading the flag on the
device; ``_pose_optimize_plain`` is its plain version and the
CPU route. The kernel sums the normal equations across threads in float64
and solves them in float64 (LU with partial pivoting, as the plain
version's float32 ``solve_ex``), so the pose agrees to a tolerance and an
inlier flag can differ only where an observation's chi2 lies at its gate.
It visits each pose once: a step's pass at T_new also sums the next
step's system, which a rejected step does not need, since T and the masks
did not change.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import plane as plane_geo
from planarslam_tpu_torch.geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PointObs(NamedTuple):
    xw: torch.Tensor          # (N, 3) world positions
    uv: torch.Tensor          # (N, 2) observed keypoints (undistorted)
    u_right: torch.Tensor     # (N,) observed pseudo-stereo u (-1 = mono)
    inv_sigma2: torch.Tensor  # (N,) scale weight
    valid: torch.Tensor       # (N,) bool


class LineObs(NamedTuple):
    xw_s: torch.Tensor        # (L, 3) 3D start point (world)
    xw_e: torch.Tensor        # (L, 3) 3D end point (world)
    line2d: torch.Tensor      # (L, 3) normalized image-line equation
    inv_sigma2: torch.Tensor  # (L,)
    valid: torch.Tensor       # (L,) bool


class PlaneObs(NamedTuple):
    pi_w: torch.Tensor        # (P, 4) map plane in world frame
    pi_obs: torch.Tensor      # (P, 4) observed plane in camera frame
    valid: torch.Tensor       # (P,) bool


class PoseOptWeights(NamedTuple):
    """Plane/structural information scalars, float32-rounded."""

    angle_info: float
    dis_info: float
    par_info: float
    ver_info: float
    plane_chi: float
    vp_chi: float

    @staticmethod
    def from_config(planes_cfg) -> "PoseOptWeights":
        f = np.float32
        return PoseOptWeights(
            angle_info=float(f(3282.8 / planes_cfg.angle_info ** 2)),
            dis_info=float(f(planes_cfg.distance_info ** 2)),
            par_info=float(f(3282.8 / planes_cfg.parallel_info ** 2)),
            ver_info=float(f(3282.8 / planes_cfg.vertical_info ** 2)),
            plane_chi=float(f(planes_cfg.chi)),
            vp_chi=float(f(planes_cfg.vp_chi)),
        )


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor
    point_inlier: torch.Tensor
    line_inlier: torch.Tensor
    plane_inlier: torch.Tensor
    par_inlier: torch.Tensor
    ver_inlier: torch.Tensor
    n_point_inliers: torch.Tensor
    chi2: torch.Tensor


def _empty_points(device) -> PointObs:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return PointObs(z(0, 3), z(0, 2), z(0), torch.ones(0, device=device),
                    torch.zeros(0, dtype=torch.bool, device=device))


def _empty_lines(device) -> LineObs:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return LineObs(z(0, 3), z(0, 3), z(0, 3), torch.ones(0, device=device),
                   torch.zeros(0, dtype=torch.bool, device=device))


def _empty_planes(device) -> PlaneObs:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return PlaneObs(z(0, 4), z(0, 4),
                    torch.zeros(0, dtype=torch.bool, device=device))


def _block_residuals(T_cw, K, bf, points: PointObs, lines: LineObs,
                     planes: PlaneObs, par: PlaneObs, ver: PlaneObs):
    """Unweighted residual blocks at pose T_cw."""
    pc = se3.transform_points(T_cw, points.xw)
    uv_hat = se3.project(K, pc)
    z = torch.clamp(pc[:, 2], min=1e-6)
    ur_hat = uv_hat[:, 0] - bf / z
    is_stereo = points.u_right >= 0
    r_pt = torch.cat([
        points.uv - uv_hat,
        torch.where(is_stereo, points.u_right - ur_hat, 0.0)[:, None],
    ], dim=-1)

    def endpoint_err(xw):
        uvh = se3.project(K, se3.transform_points(T_cw, xw))
        return (lines.line2d[:, 0] * uvh[:, 0] + lines.line2d[:, 1] * uvh[:, 1]
                + lines.line2d[:, 2])

    r_ln = torch.stack([endpoint_err(lines.xw_s), endpoint_err(lines.xw_e)],
                       dim=-1)
    r_pl = plane_geo.ominus(plane_geo.transform(T_cw, planes.pi_w),
                            planes.pi_obs)
    r_par = plane_geo.ominus_par(plane_geo.transform(T_cw, par.pi_w),
                                 par.pi_obs)
    r_ver = plane_geo.ominus_ver(plane_geo.transform(T_cw, ver.pi_w),
                                 ver.pi_obs)
    return r_pt, r_ln, r_pl, r_par, r_ver


def _skew_neg(p):
    """-[p]_x for (..., 3) p: the derivative of exp(xi) p in phi at 0."""
    return -se3.hat(p)


def _point_jac(pc, K):
    """d(u, v)/d xi and d z/d xi of projected camera points pc (N, 3) under
    the left update xi = [rho, phi]."""
    fx, fy, _, _ = K
    z = pc[:, 2]
    big = torch.abs(z) >= 1e-8
    inv_z = 1.0 / torch.where(big, z, 1e-8)
    dinv = torch.where(big, -inv_z * inv_z, 0.0)
    zero = torch.zeros_like(z)
    du_dp = torch.stack([fx * inv_z, zero, fx * pc[:, 0] * dinv], -1)
    dv_dp = torch.stack([zero, fy * inv_z, fy * pc[:, 1] * dinv], -1)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[0], 3, 3)
    dp = torch.cat([eye, _skew_neg(pc)], dim=-1)
    return (du_dp[:, None, :] @ dp)[:, 0], (dv_dp[:, None, :] @ dp)[:, 0], dp


def _normalize_jac(c, dc):
    """Value and derivative of plane_geo.normalize at c (P, 4) with dc
    (P, 4, 6)."""
    n = c[:, :3]
    nn = torch.sqrt(torch.sum(n * n, dim=-1) + 1e-9)
    cn = c / nn[:, None]
    sgn = torch.where(cn[:, 3:4] < 0, -1.0, 1.0)
    ndn = torch.sum(n[:, :, None] * dc[:, :3], dim=1)  # (P, 6)
    dcn = dc / nn[:, None, None] - c[:, :, None] * (
        ndn / nn[:, None] ** 3)[:, None, :]
    return cn * sgn, dcn * sgn[:, :, None]


def _plane_jac(T, pi_w):
    """transform(T, pi_w) and its derivative (P, 4, 6)."""
    c = plane_geo.transform(T, pi_w)
    n = c[:, :3]
    zero3 = torch.zeros_like(n)[:, :, None].expand(-1, 3, 3)
    dn = torch.cat([zero3, _skew_neg(n)], dim=-1)
    dd = torch.cat([-n, torch.zeros_like(n)], dim=-1)
    return c, torch.cat([dn, dd[:, None, :]], dim=1)


def _residuals_and_jacobian(T_cw, K, bf, points: PointObs, lines: LineObs,
                            planes: PlaneObs, par: PlaneObs, ver: PlaneObs):
    """Residual blocks at T_cw and the stacked Jacobian (D, 6) of the
    flattened residuals in xi at 0."""
    res = _block_residuals(T_cw, K, bf, points, lines, planes, par, ver)
    pc = se3.transform_points(T_cw, points.xw)
    du, dv, dp = _point_jac(pc, K)
    z = pc[:, 2]
    dz_inv = torch.where(z > 1e-6, bf / torch.clamp(z, min=1e-6) ** 2, 0.0)
    dur = du + dz_inv[:, None] * dp[:, 2]
    is_stereo = (points.u_right >= 0)[:, None]
    J_pt = -torch.stack([du, dv, torch.where(is_stereo, dur, 0.0)], dim=1)

    def line_jac(xw):
        du_l, dv_l, _ = _point_jac(se3.transform_points(T_cw, xw), K)
        return (lines.line2d[:, 0:1] * du_l + lines.line2d[:, 1:2] * dv_l)

    J_ln = torch.stack([line_jac(lines.xw_s), line_jac(lines.xw_e)], dim=1)

    def est(block):
        c, dc = _plane_jac(T_cw, block.pi_w)
        return _normalize_jac(c, dc)

    e_pl, de_pl = est(planes)
    m_pl = plane_geo.normalize(planes.pi_obs)
    b1, b2 = plane_geo.tangent_basis(m_pl[:, :3])
    dn = de_pl[:, :3]
    J_pl = torch.stack([torch.sum(b1[:, :, None] * dn, 1),
                        torch.sum(b2[:, :, None] * dn, 1), de_pl[:, 3]], dim=1)

    e_par, de_par = est(par)
    m_par = plane_geo._hemi_align(plane_geo.normalize(par.pi_obs),
                                  e_par[:, :3])
    b1, b2 = plane_geo.tangent_basis(m_par[:, :3])
    dn = de_par[:, :3]
    J_par = torch.stack([torch.sum(b1[:, :, None] * dn, 1),
                         torch.sum(b2[:, :, None] * dn, 1)], dim=1)

    _, de_ver = est(ver)
    m_ver = plane_geo.normalize(ver.pi_obs)
    J_v0 = torch.sum(m_ver[:, :3, None] * de_ver[:, :3], 1)
    J_ver = torch.stack([J_v0, torch.zeros_like(J_v0)], dim=1)
    J = torch.cat([b.reshape(-1, 6) for b in
                   (J_pt, J_ln, J_pl, J_par, J_ver)], dim=0)
    return res, J


def _chi2_blocks(residuals, points, lines, w: PoseOptWeights):
    r_pt, r_ln, r_pl, r_par, r_ver = residuals
    chi_pt = torch.sum(r_pt * r_pt, dim=-1) * points.inv_sigma2
    chi_ln = (r_ln * r_ln) * lines.inv_sigma2[:, None]
    chi_pl = (w.angle_info * (r_pl[:, 0] ** 2 + r_pl[:, 1] ** 2)
              + w.dis_info * r_pl[:, 2] ** 2)
    chi_par = w.par_info * torch.sum(r_par * r_par, dim=-1)
    chi_ver = w.ver_info * torch.sum(r_ver * r_ver, dim=-1)
    return chi_pt, chi_ln, chi_pl, chi_par, chi_ver


def _huber_w(chi2, delta2, enabled: bool):
    if not enabled:
        return torch.ones_like(chi2)
    return torch.where(chi2 > delta2,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)), 1.0)


def _flat(blocks):
    return torch.cat([x.reshape(-1) for x in blocks])


def _default_weights() -> PoseOptWeights:
    from planarslam_tpu_torch.config import PlaneConfig

    return PoseOptWeights.from_config(PlaneConfig())


def _pose_optimize_plain(
    T_cw_init: torch.Tensor,
    K: Tuple[float, float, float, float],
    bf: float,
    points: Optional[PointObs] = None,
    lines: Optional[LineObs] = None,
    planes: Optional[PlaneObs] = None,
    par_planes: Optional[PlaneObs] = None,
    ver_planes: Optional[PlaneObs] = None,
    weights: Optional[PoseOptWeights] = None,
    rotation_fixed: Union[bool, torch.Tensor] = False,
    n_rounds: int = 4,
    n_iters: int = 10,
) -> PoseOptResult:
    """Plain version of K11, with the arguments of ``pose_optimize``."""
    dev = T_cw_init.device
    points = points if points is not None else _empty_points(dev)
    lines = lines if lines is not None else _empty_lines(dev)
    planes = planes if planes is not None else _empty_planes(dev)
    par_planes = par_planes if par_planes is not None else _empty_planes(dev)
    ver_planes = ver_planes if ver_planes is not None else _empty_planes(dev)
    weights = weights if weights is not None else _default_weights()
    K = tuple(float(np.float32(v)) for v in K)
    bf = float(np.float32(bf))

    eye = torch.eye(6, dtype=torch.float32, device=dev)
    rot_fixed = torch.as_tensor(rotation_fixed, dtype=torch.bool, device=dev)
    col_keep = torch.cat([torch.ones(3, dtype=torch.bool, device=dev),
                          (~rot_fixed).reshape(1).expand(3)])

    def residuals_at(T):
        return _block_residuals(T, K, bf, points, lines, planes,
                                par_planes, ver_planes)

    is_stereo = points.u_right >= 0
    gate_pt = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    ones_n = torch.ones_like(points.u_right)
    stereo_dim = torch.stack([ones_n, ones_n, is_stereo.to(torch.float32)],
                             dim=-1)

    def weights_at(res, masks, huber_on):
        in_pt, in_ln, in_pl, in_par, in_ver = masks
        chi_pt, chi_ln, chi_pl, chi_par, chi_ver = _chi2_blocks(
            res, points, lines, weights)
        w_pt = (points.inv_sigma2 * _huber_w(chi_pt, gate_pt, huber_on)
                * (points.valid & in_pt))[:, None] * stereo_dim
        w_ln = (lines.inv_sigma2[:, None]
                * _huber_w(chi_ln, CHI2_MONO, huber_on)
                * (lines.valid & in_ln)[:, None])
        w_pl_s = (_huber_w(chi_pl, weights.plane_chi, huber_on)
                  * (planes.valid & in_pl))
        info_pl = torch.tensor([weights.angle_info, weights.angle_info,
                                weights.dis_info], device=dev)
        w_pl = w_pl_s[:, None] * info_pl[None, :]
        w_par = (weights.par_info * _huber_w(chi_par, weights.vp_chi, huber_on)
                 * (par_planes.valid & in_par))[:, None].expand(-1, 2)
        w_ver = (weights.ver_info * _huber_w(chi_ver, weights.vp_chi, huber_on)
                 * (ver_planes.valid & in_ver))[:, None].expand(-1, 2)
        return w_pt, w_ln, w_pl, w_par, w_ver

    def run_round(T0, masks, huber_on):
        T = T0
        lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
        chi_cur = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            res, J = _residuals_and_jacobian(T, K, bf, points, lines, planes,
                                             par_planes, ver_planes)
            ws = weights_at(res, masks, huber_on)
            w_flat = _flat(ws)
            r0 = _flat(res)
            J = torch.where(col_keep[None, :], J, 0.0)
            Jw = J * w_flat[:, None]
            H = Jw.T @ J
            g = Jw.T @ r0
            H_lm = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
            dx = -torch.linalg.solve_ex(H_lm, g, check_errors=False)[0]
            T_new = se3.se3_exp(dx) @ T
            r_new = _flat(residuals_at(T_new))
            chi_new = torch.sum(w_flat * r_new * r_new)
            chi_old = torch.sum(w_flat * r0 * r0)
            accept = (chi_new < chi_old) & torch.all(torch.isfinite(dx))
            T = torch.where(accept, T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-8, 1e6)
            chi_cur = torch.where(accept, chi_new, chi_old)
        return T, chi_cur

    in_pt = torch.ones_like(points.valid)
    in_ln = torch.ones_like(lines.valid)
    in_pl = torch.ones_like(planes.valid)
    in_par = torch.ones_like(par_planes.valid)
    in_ver = torch.ones_like(ver_planes.valid)
    T = T_cw_init
    chi_total = torch.zeros((), dtype=torch.float32, device=dev)
    for rnd in range(n_rounds):
        huber_on = rnd < n_rounds - 1
        T, chi_total = run_round(T_cw_init,
                                 (in_pt, in_ln, in_pl, in_par, in_ver),
                                 huber_on)
        chi_pt, chi_ln, chi_pl, chi_par, chi_ver = _chi2_blocks(
            residuals_at(T), points, lines, weights)
        in_pt = chi_pt <= gate_pt
        in_ln = torch.all(chi_ln <= 2.0 * CHI2_MONO, dim=-1)
        in_pl = chi_pl <= weights.plane_chi
        in_par = chi_par <= weights.vp_chi
        in_ver = chi_ver <= weights.vp_chi

    n_in = torch.sum((points.valid & in_pt).to(torch.int32))
    return PoseOptResult(T, points.valid & in_pt, lines.valid & in_ln,
                         planes.valid & in_pl, par_planes.valid & in_par,
                         ver_planes.valid & in_ver, n_in, chi_total)


_BLOCK_DIMS = {PointObs: (3, 2, None, None, None),
               LineObs: (3, 3, 3, None, None),
               PlaneObs: (4, 4, None)}


def _block_args(block, cls, lead, dev):
    """K11's view of one residual block of a problem (lead ()) or of B
    problems (lead (B,)): its pointers and per-problem count, the tensors
    behind them, and the inlier mask the kernel fills. An absent block is
    empty (NULL pointers, count 0)."""
    dims = _BLOCK_DIMS[cls]
    if block is None:
        mask = torch.zeros((*lead, 0), dtype=torch.bool, device=dev)
        return [None] * len(dims) + [0], [], mask
    n = block.valid.shape[-1]
    held = []
    for field, d, t in zip(cls._fields, dims, block):
        dtype = torch.bool if field == "valid" else torch.float32
        t = t.to(dtype).contiguous()
        kernels.check(t, f"{cls.__name__}.{field}", dtype,
                      (*lead, n) if d is None else (*lead, n, d))
        held.append(t)
    mask = torch.empty((*lead, n), dtype=torch.bool, device=dev)
    return [kernels.ptr(t) for t in held] + [n], held, mask


def _pose_optimize_kernel(T_cw_init, K, bf, blocks, weights, rotation_fixed,
                          n_rounds, n_iters) -> PoseOptResult:
    """Launch K11 (csrc/pose_opt.cu) once for the whole solve of one
    problem, or of B problems (every tensor with a leading B)."""
    dev = T_cw_init.device
    T0 = T_cw_init.to(torch.float32).contiguous()
    lead = tuple(T0.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"T_cw_init: expected (4, 4) or (B, 4, 4), got "
                         f"{tuple(T0.shape)}")
    b = lead[0] if lead else 1
    kernels.check(T0, "T_cw_init", torch.float32, (*lead, 4, 4))
    args, held, masks = [kernels.ptr(T0)], [T0], []
    for block, cls in zip(blocks, (PointObs, LineObs, PlaneObs, PlaneObs,
                                   PlaneObs)):
        a, h, mask = _block_args(block, cls, lead, dev)
        args += a
        held += h
        masks.append(mask)
    if isinstance(rotation_fixed, torch.Tensor):
        flag = rotation_fixed.to(torch.bool).contiguous()
        kernels.check(flag, "rotation_fixed", torch.bool, lead)
        held.append(flag)
        args += [kernels.ptr(flag), 0]
    else:
        args += [None, int(bool(rotation_fixed))]
    T_out = torch.empty((*lead, 4, 4), dtype=torch.float32, device=dev)
    n_in = torch.empty(lead, dtype=torch.int64, device=dev)
    chi2 = torch.empty(lead, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # a problem stages in shared memory (0 bytes here) unless it is too
        # large for it
        per = kernels.cuda_lib().psl_pose_optimize_scratch_bytes(
            sum(m.shape[-1] for m in masks))
        if per < 0:
            raise RuntimeError("psl_pose_optimize_scratch_bytes failed")
        scratch = (torch.empty(b * per, dtype=torch.uint8, device=dev)
                   if per else None)
        kernels.launch("psl_pose_optimize", *args, *K, bf, *weights,
                       n_rounds, n_iters, b,
                       None if scratch is None else kernels.ptr(scratch),
                       kernels.ptr(T_out), *[kernels.ptr(m) for m in masks],
                       kernels.ptr(n_in), kernels.ptr(chi2))
    kernels.LAUNCHES["pose_optimize"] += 1
    return PoseOptResult(T_out, *masks, n_in, chi2)


@record_function("pose_opt.pose_optimize")
def pose_optimize(
    T_cw_init: torch.Tensor,
    K: Tuple[float, float, float, float],
    bf: float,
    points: Optional[PointObs] = None,
    lines: Optional[LineObs] = None,
    planes: Optional[PlaneObs] = None,
    par_planes: Optional[PlaneObs] = None,
    ver_planes: Optional[PlaneObs] = None,
    weights: Optional[PoseOptWeights] = None,
    rotation_fixed: Union[bool, torch.Tensor] = False,
    n_rounds: int = 4,
    n_iters: int = 10,
) -> PoseOptResult:
    """Robust pose-only optimization (module docstring). K11 wrapper: CPU
    tensors take ``_pose_optimize_plain``; CUDA tensors launch the kernel
    once per call, or raise. T_cw_init (4, 4) with blocks of (N, ...), or
    B problems: T_cw_init (B, 4, 4), every block tensor and a tensor
    rotation_fixed with a leading B, one launch for all (the result then
    has the leading B too)."""
    blocks = (points, lines, planes, par_planes, ver_planes)
    tensors = [t for b in blocks if b is not None for t in b]
    if isinstance(rotation_fixed, torch.Tensor):
        tensors.append(rotation_fixed)
    if kernels.on_cpu(T_cw_init, *tensors):
        if T_cw_init.dim() == 2:
            return _pose_optimize_plain(T_cw_init, K, bf, *blocks, weights,
                                        rotation_fixed, n_rounds, n_iters)
        outs = []
        for i in range(T_cw_init.shape[0]):
            lane = [None if blk is None else type(blk)(*[t[i] for t in blk])
                    for blk in blocks]
            flag = (rotation_fixed[i]
                    if isinstance(rotation_fixed, torch.Tensor)
                    else rotation_fixed)
            outs.append(_pose_optimize_plain(T_cw_init[i], K, bf, *lane,
                                             weights, flag, n_rounds,
                                             n_iters))
        return PoseOptResult(*[torch.stack(f) for f in zip(*outs)])
    return _pose_optimize_kernel(
        T_cw_init, tuple(float(np.float32(v)) for v in K),
        float(np.float32(bf)), blocks,
        weights if weights is not None else _default_weights(),
        rotation_fixed, n_rounds, n_iters)
