"""SO(3)/SE(3) Lie-group utilities on torch tensors.

Port of ``planarslam_tpu/geometry/se3.py``. Poses are 4x4 matrices; the
tangent convention is [rho, phi] with T = exp([rho, phi]) using the standard
SE(3) left Jacobian. Functions are batched over leading dimensions and
differentiable by ``torch.func`` (no in-place updates).
"""

from __future__ import annotations

import math

import torch

from planarslam_tpu_torch.ops.consts import literal

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of a 3-vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def so3_exp(phi):
    """Rodrigues: 3-vector -> rotation matrix. Safe at phi ~ 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    K2 = K @ K
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return _eye3(phi) + a * K + b * K2


def so3_log(R):
    """Rotation matrix -> 3-vector (axis*angle). Safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_theta = 0.5 * torch.sqrt(torch.sum(w * w, dim=-1) + _EPS)
    theta = torch.atan2(sin_theta, cos_theta)
    scale = torch.where(sin_theta[..., None] < 1e-4,
                        0.5 + theta[..., None] ** 2 / 12.0,
                        theta[..., None] / (2.0 * sin_theta[..., None]))
    general = scale * w
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None]) /
                          torch.clamp(1.0 - cos_theta[..., None], min=_EPS),
                          min=0.0)
    axis = torch.sqrt(axis_sq)
    one = torch.ones_like(trace)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, one, -one)
    sy = torch.where(R[..., 0, 2] - R[..., 2, 0] >= 0, one, -one)
    sz = torch.where(R[..., 1, 0] - R[..., 0, 1] >= 0, one, -one)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    near_pi = theta[..., None] > (math.pi - 1e-3)
    return torch.where(near_pi, axis * theta[..., None], general)


def _so3_left_jacobian(phi):
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    K2 = K @ K
    a = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS)
    b = (theta - torch.sin(theta)) / (theta2.clamp(min=_EPS) * theta)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, a)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, b)
    return _eye3(phi) + a * K + b * K2


def se3_exp(xi):
    """Tangent [rho(3), phi(3)] -> 4x4 transform."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return rt_to_T(R, t)


def se3_log(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    J = _so3_left_jacobian(phi)
    rho = torch.linalg.solve_ex(J, t[..., None], check_errors=False)[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def adjoint(T):
    """6x6 adjoint of T in the [rho, phi] order: exp(Ad(T) xi) =
    T exp(xi) T^-1, Ad(T) = [[R, hat(t) R], [0, R]]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    t2 = theta2.clamp(min=1e-12)
    theta = torch.sqrt(t2)
    K = hat(phi)
    c = 1.0 / t2 - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta))
    c = torch.where(theta2 < 1e-4, 1.0 / 12.0 + theta2 / 720.0, c)
    return _eye3(phi) - 0.5 * K + c * (K @ K)


def se3_left_jacobian_inv(xi):
    """Inverse left Jacobian of SE(3) at xi = [rho, phi]:
    [[Jl^-1, -Jl^-1 Q Jl^-1], [0, Jl^-1]] with Barfoot's Q(rho, phi).
    Taylor series below |phi| = 0.01; the closed forms cancel, so call it
    in float64."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    t2 = theta2.clamp(min=1e-12)
    theta = torch.sqrt(t2)
    small = theta2 < 1e-4
    s, c = torch.sin(theta), torch.cos(theta)
    a1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - s) / (t2 * theta))
    a2 = torch.where(small, 1.0 / 24.0 - theta2 / 720.0,
                     (theta2 + 2.0 * c - 2.0) / (2.0 * t2 * t2))
    a3 = torch.where(small, 1.0 / 120.0 - theta2 / 2520.0,
                     (2.0 * theta - 3.0 * s + theta * c)
                     / (2.0 * t2 * t2 * theta))
    P, Rh = hat(phi), hat(rho)
    PR, RP = P @ Rh, Rh @ P
    PRP = PR @ P
    Q = (0.5 * Rh + a1 * (PR + RP + PRP) + a2 * (P @ PR + RP @ P - 3.0 * PRP)
         + a3 * (PRP @ P + P @ PRP))
    Ji = _so3_left_jacobian_inv(phi)
    top = torch.cat([Ji, -(Ji @ Q @ Ji)], dim=-1)
    bottom = torch.cat([torch.zeros_like(Ji), Ji], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_right_jacobian_inv(xi):
    """Inverse right Jacobian: log(exp(xi) exp(d)) ~ xi + Jr^-1(xi) d."""
    return se3_left_jacobian_inv(-xi)


def rt_to_T(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)  # (..., 3, 4)
    bottom = literal((0.0, 0.0, 0.0, 1.0), R.dtype, R.device).expand(
        R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def T_inv(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T, pts):
    """Apply 4x4 transform to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def quat_to_R(q):
    """Unit quaternion (x, y, z, w) -> rotation matrix (TUM trajectory order)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.clamp(n, min=_EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def R_to_quat(R):
    """Rotation matrix -> unit quaternion (x, y, z, w), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cand = torch.stack([qx2, qy2, qz2, qw2], dim=-1)
    idx = torch.argmax(cand, dim=-1)

    def inv4(s):
        return 0.25 / torch.clamp(s, min=_EPS)

    sw = 0.5 / torch.sqrt(qw2 + _EPS)
    sx = 0.5 / torch.sqrt(qx2 + _EPS)
    sy = 0.5 / torch.sqrt(qy2 + _EPS)
    sz = 0.5 / torch.sqrt(qz2 + _EPS)
    from_w = torch.stack([(m21 - m12) * sw, (m02 - m20) * sw,
                          (m10 - m01) * sw, inv4(sw)], dim=-1)
    from_x = torch.stack([inv4(sx), (m01 + m10) * sx, (m02 + m20) * sx,
                          (m21 - m12) * sx], dim=-1)
    from_y = torch.stack([(m01 + m10) * sy, inv4(sy), (m12 + m21) * sy,
                          (m02 - m20) * sy], dim=-1)
    from_z = torch.stack([(m02 + m20) * sz, (m12 + m21) * sz, inv4(sz),
                          (m10 - m01) * sz], dim=-1)
    qs = torch.stack([from_x, from_y, from_z, from_w], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def project(K_params, pts_cam):
    """Pinhole projection of camera-frame points (..., 3) -> (u, v).

    K_params = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = K_params
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < _EPS, _EPS, z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def backproject(K_params, uv, z):
    """(u, v) pixels + depth -> camera-frame 3D points."""
    fx, fy, cx, cy = K_params
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def _det3(A):
    a0, a1, a2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    return torch.sum(a0 * torch.linalg.cross(a1, a2), dim=-1)


def _dot3_cols(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis (csrc/eig3.cuh's order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _orthonormal_basis(V):
    """The eigenvectors V (columns) of R^T R as orthonormal columns. Where R
    is near a rotation, the three eigenvalues of R^T R coincide and the
    cross products the closed-form solver takes its eigenvectors from lose
    their direction (columns a percent or two from orthogonal were seen);
    any orthonormal basis then serves, since the polar factor is R times
    about the identity. There, with a column pair more than 1e-4 from
    orthogonal, the high column stays, the middle one becomes the unit axis
    least aligned with it made orthogonal to it (the first such axis among
    equals), the low one their cross product; elsewhere V is kept as it
    is."""
    lo, mid, hi = V[..., :, 0], V[..., :, 1], V[..., :, 2]
    off = torch.maximum(torch.maximum(torch.abs(_dot3_cols(lo, mid)),
                                      torch.abs(_dot3_cols(lo, hi))),
                        torch.abs(_dot3_cols(mid, hi)))
    k = torch.argmin(torch.abs(hi), dim=-1, keepdim=True)
    e = torch.zeros_like(hi).scatter_(-1, k, 1.0)
    m = e - torch.gather(hi, -1, k) * hi
    m = m / torch.clamp(torch.sqrt(_dot3_cols(m, m)), min=1e-30)[..., None]
    cross = torch.stack([m[..., 1] * hi[..., 2] - m[..., 2] * hi[..., 1],
                         m[..., 2] * hi[..., 0] - m[..., 0] * hi[..., 2],
                         m[..., 0] * hi[..., 1] - m[..., 1] * hi[..., 0]],
                        dim=-1)
    fixed = torch.stack([cross, m, hi], dim=-1)
    return torch.where((off > 1e-4)[..., None, None], fixed, V)


def orthonormalize(R):
    """Project a near-rotation onto SO(3) (reference `Tracking.cc:1123-1128`).

    The JAX package takes U D Vt from an SVD with D = diag(1, 1, sign det).
    torch's CUDA SVD checks convergence on the host (a device sync), so the
    same projection is computed as the polar factor R (R^T R)^{-1/2} from the
    closed-form symmetric eigensolver, polished by one Newton step
    Q <- (Q + Q^{-T}) / 2, with the smallest singular direction flipped when
    det R < 0 (the role of D)."""
    from planarslam_tpu_torch.ops.eig3 import eigh_sym3x3

    M = R.transpose(-1, -2) @ R
    evals, V = eigh_sym3x3(M)
    V = _orthonormal_basis(V)
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp(evals, min=1e-30))
    Q = R @ (V * inv_sqrt[..., None, :]) @ V.transpose(-1, -2)
    q0, q1, q2 = Q[..., :, 0], Q[..., :, 1], Q[..., :, 2]
    cof = torch.stack([torch.linalg.cross(q1, q2), torch.linalg.cross(q2, q0),
                       torch.linalg.cross(q0, q1)], dim=-1)
    det_q = _det3(Q)
    Q = 0.5 * (Q + cof / det_q[..., None, None])
    s = torch.sign(_det3(R))
    v = V[..., :, 0]  # smallest eigenvalue of R^T R = smallest singular value
    Qv = (Q @ v[..., None])[..., 0]
    return Q - (1.0 - s)[..., None, None] * Qv[..., :, None] * v[..., None, :]
