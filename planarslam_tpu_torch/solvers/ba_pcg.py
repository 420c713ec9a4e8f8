"""Matrix-free preconditioned-CG bundle adjustment for large maps.

Port of ``planarslam_tpu/solvers/ba_pcg.py``: the problem and measurement
model of ``ba_core.ba_solve``, but the reduced camera system is never
formed: each LM step builds the block diagonals and the gradient, then runs
a fixed number of CG iterations on S x = rhs with matrix-free products and
a block-Jacobi preconditioner. Global BA takes it above 128 keyframes.

K8 (``ba_core.ba_normal_eqs`` with the Hcp output off) gives the point and
line-endpoint block diagonals and gradient, K33 (``ba_plane_blocks``) adds
the plane blocks and returns the plane observations' terms and the
landmark damping floor, and K34 (``ba_cost_test``) decides each step. The
per-observation point and line Jacobians that the matrix-free products and
the preconditioner need, the damping and the CG loop stay plain torch.
Gauge and LM policy match ba_solve, and no step reads a value back to the
host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from planarslam_tpu_torch.solvers.ba_core import (
    CHI2_MONO, BAWeights, LineTables, PlaneTables, PointTables, _finish,
    _huber_w_fn, _line_jacs, _point_jacs, _problem, ba_cost_test,
    ba_normal_eqs, ba_plane_blocks, segment_sum)


def ba_solve_pcg(poses: torch.Tensor, fixed_mask: torch.Tensor,
                 lm_xyz: torch.Tensor, plane_base: torch.Tensor,
                 pt: PointTables, ln: LineTables, pl: PlaneTables,
                 par: PlaneTables, ver: PlaneTables,
                 K: Tuple[float, float, float, float], bf: float,
                 w: BAWeights, n_iters: int = 12, n_cg: int = 48,
                 huber: bool = True):
    """Drop-in for ba_core.ba_solve at window sizes the dense Schur cannot
    hold. Returns (poses, lm_xyz, plane_coeffs, chi2 dict per table)."""
    pb = _problem(lm_xyz, plane_base, pt, ln, pl, par, ver, w,
                  want_pairs=False)
    P, M = pb.P, pb.M
    pt, ln = pb.pt, pb.ln
    dev, dt = poses.device, poses.dtype
    have_ln = ln.slot.shape[1] > 0
    free = (1.0 - fixed_mask)[:, None]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    flat = pt.slot.reshape(-1)
    flat_l = ln.slot.reshape(-1)

    def step(poses_c, lm_c, lam):
        pts = lm_c[:P]
        theta = lm_c[P:]
        # per-observation Jacobians and IRLS weights (the matvecs' factors)
        r_pt, Jpose, Jpt = _point_jacs(poses_c, pts, pt.slot, pt.uv, pt.ur,
                                       pb.is_stereo, K, bf)
        chi_pt = torch.sum(r_pt * r_pt, dim=-1) * pt.inv_s2
        w_pt = pt.inv_s2 * _huber_w_fn(chi_pt, pb.gates[0], huber) * pt.mask
        Wp = w_pt[..., None] * torch.stack(
            [torch.ones_like(w_pt), torch.ones_like(w_pt),
             pb.is_stereo.to(dt)], dim=-1)
        if have_ln:
            r_ln, Jp_ln, Jl_ln = _line_jacs(poses_c, pts, ln.slot, ln.line2d,
                                            K)
            chi_ln = r_ln * r_ln * ln.inv_s2
            w_ln = (ln.inv_s2 * _huber_w_fn(chi_ln, CHI2_MONO, huber)
                    * ln.mask)

        # block diagonals and gradient: K8 for points and lines, K33 planes
        Hcc, bc, Hpp, bp, _, _, _ = ba_normal_eqs(
            poses_c, pts, pt, ln, M, K, bf, huber, False, pb.plan)
        Hcc, bc, Hpp, bp, _, pl_terms, mu_p = ba_plane_blocks(
            pb, poses_c, plane_base, theta, Hcc, bc, Hpp, bp, None, huber)

        # Levenberg damping with the absolute floor, as in ba_solve
        diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_d = (Hpp + lam * torch.diag_embed(diag_p)
                 + (lam * mu_p + 1e-6) * eye3)
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
        diag_c = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        mu_c = torch.sum(diag_c * free) / (torch.sum(free) * 6.0 + 1.0)
        Hcc_d = (Hcc + lam * torch.diag_embed(diag_c)
                 + (lam * mu_c + 1e-8) * eye6)

        def hppinv_apply(v):
            return torch.einsum("pij,pj->pi", Hpp_inv, v)

        def hcpT_x(x):                               # (Kt, 6) -> (M, 3)
            u = torch.einsum("kfab,kb->kfa", Jpose, x)
            out = segment_sum(torch.einsum("kfai,kfa->kfi", Jpt, Wp * u
                                           ).reshape(-1, 3), flat, M)
            if have_ln:
                ul = torch.einsum("klb,kb->kl", Jp_ln, x)
                out = out + segment_sum(
                    (Jl_ln * (w_ln * ul)[..., None]).reshape(-1, 3), flat_l,
                    M)
            for slot, _rr, Jx, Jt, Wv in pl_terms:
                up = torch.einsum("kpdb,kb->kpd", Jx, x)
                out = out + segment_sum(torch.einsum(
                    "kpdi,kpd->kpi", Jt, Wv * up).reshape(-1, 3),
                    (slot + P).reshape(-1), M)
            return out

        def hcp_y(y):                                # (M, 3) -> (Kt, 6)
            u = torch.einsum("kfai,kfi->kfa", Jpt, y[pt.slot.long()])
            out = torch.einsum("kfab,kfa->kb", Jpose, Wp * u)
            if have_ln:
                ul = torch.einsum("kli,kli->kl", Jl_ln, y[ln.slot.long()])
                out = out + torch.einsum("klb,kl->kb", Jp_ln, w_ln * ul)
            for slot, _rr, Jx, Jt, Wv in pl_terms:
                up = torch.einsum("kpdi,kpi->kpd", Jt, y[(slot + P).long()])
                out = out + torch.einsum("kpdb,kpd->kb", Jx, Wv * up)
            return out

        def s_mv(x):
            xm = x * free
            out = torch.einsum("kij,kj->ki", Hcc_d, xm)
            out = out - hcp_y(hppinv_apply(hcpT_x(xm)))
            return out * free

        rhs = (bc - hcp_y(hppinv_apply(bp))) * free

        # block-Jacobi preconditioner of S
        C = torch.einsum("kfai,kfa,kfaj->kfij", Jpose, Wp, Jpt)
        corr = torch.einsum("kfij,kfjl,kfml->kim", C,
                            Hpp_inv[pt.slot.long()], C)
        if have_ln:
            Cl = torch.einsum("kai,ka,kaj->kaij", Jp_ln, w_ln, Jl_ln)
            corr = corr + torch.einsum("kaij,kajl,kaml->kim", Cl,
                                       Hpp_inv[ln.slot.long()], Cl)
        for slot, _rr, Jx, Jt, Wv in pl_terms:
            Cp = torch.einsum("kpdi,kpd,kpdj->kpij", Jx, Wv, Jt)
            corr = corr + torch.einsum("kpij,kpjl,kpml->kim", Cp,
                                       Hpp_inv[(slot + P).long()], Cp)
        Minv = torch.linalg.inv_ex(Hcc_d - corr
                                   + (1e-3 * mu_c + 1e-8) * eye6)[0]

        def precond(r):
            return torch.einsum("kij,kj->ki", Minv, r * free) * free

        # CG on the reduced camera system, fixed iteration count
        x = torch.zeros_like(rhs)
        r = rhs
        z = precond(r)
        p = z
        rz = torch.sum(r * z)
        for _ in range(n_cg):
            Ap = s_mv(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0),
                                0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                               0.0)
            p = z + beta * p
            rz = rz_new
        dxc = -x
        dxp = -hppinv_apply(bp + hcpT_x(dxc))

        out = ba_cost_test(pb, poses_c, lm_c, dxc.contiguous(),
                           dxp.contiguous(), lam, plane_base, K, bf, huber)
        return out.poses, out.lm, out.lam

    lm = torch.cat([lm_xyz.to(dt), torch.zeros((pb.Q, 3), dtype=dt,
                                               device=dev)], dim=0)
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        poses, lm, lam = step(poses.contiguous(), lm.contiguous(), lam)
    return _finish(pb, poses, lm, plane_base, K, bf)

