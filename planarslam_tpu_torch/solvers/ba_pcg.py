"""Matrix-free preconditioned-CG bundle adjustment for large maps.

Port of ``planarslam_tpu/solvers/ba_pcg.py``: the problem and measurement
model of ``ba_core.ba_solve``, but the reduced camera system S = Hcc_d -
Hcp Hpp_d^-1 Hcp^T is never formed: each LM step builds the block
diagonals and the gradient, then runs a fixed number of CG iterations on S
x = rhs with matrix-free products and a block-Jacobi preconditioner.
Global BA takes it above 128 keyframes.

Hand-written kernels take every step of the solve:
  - K8 (``ba_core.ba_normal_eqs``, the Hcp output off) gives the point and
    line-endpoint block diagonals and gradient, and each observation's 6 x
    3 cross block C_o = J_pose^T W J_lm as rows of its scratch;
  - K33 (``ba_plane_blocks``) adds the plane blocks and returns the plane
    observations' terms and the landmark damping floor mu_p;
  - K43 (``pcg_prepare``, ``csrc/ba_pcg.cu``) once per LM step: the damped
    landmark inverses Hpp_d^-1 (float64 inside), Hcc_d with mu_c, every
    C_o (the plane ones from K33's terms), the block-Jacobi inverses Minv
    and rhs = (bc - Hcp Hpp_d^-1 bp) free;
  - K44 (``pcg_schur_matvec``) once per CG step: S p as a landmark pass
    and a keyframe pass over the plan's orders; its back-substitution mode
    (``pcg_backsub``) recovers the landmark step;
  - K45 (``pcg_cg_update``) once per CG step: pAp, alpha, x, r, z = Minv r,
    rz, beta and p with JAX's guards; its init mode starts the CG;
  - K34 (``ba_cost_test``) decides each step.
``pcg_plan`` lists every live observation (points, line endpoints, then
the plane tables) by landmark and by keyframe, once per solve: the order of
every sum, so no kernel needs a float atomic. Gauge and LM policy match
ba_solve: fixed poses' entries of x, r, z and p stay exactly 0, and no step
reads a value back to the host.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.solvers.ba_core import (
    BAWeights, LineTables, PlaneTables, PlaneTerms, PointTables, _active_planes,
    _damped, _finish, _problem, _stacked, ba_cost_test, ba_normal_eqs,
    ba_plane_blocks, segment_sum)


class PcgPlan(NamedTuple):
    """The order of the PCG kernels' sums, fixed for one solve. The
    observations are numbered points o = k F + f, line endpoints Kt F + k
    L2 + l, then each plane table with slots (direct, parallel, vertical)
    its k Pp + p: obs_kf and obs_slot (n_obs,) int32 give each one's
    keyframe and landmark (a plane at P + its slot), live (n_obs,) bool its
    mask > 0; lm_order lists the live ones by landmark, stably, with
    lm_start (M + 1,) bounds, kf_order by keyframe with kf_start (Kt + 1,)
    (the others follow past the last bound). A leading batch as the
    kernels'."""

    obs_kf: torch.Tensor
    obs_slot: torch.Tensor
    live: torch.Tensor
    lm_order: torch.Tensor
    lm_start: torch.Tensor
    kf_order: torch.Tensor
    kf_start: torch.Tensor


def pcg_plan(pb) -> PcgPlan:
    """The plan of one solve's problem (``ba_core._problem``) on its
    device, with no host sync: stable sorts of the live observations' keys
    (the others keyed past the last) and scatter counts."""
    pt, ln = pb.pt, pb.ln
    Kt = pt.slot.shape[0]
    dev = pt.slot.device
    tables = [(pt.slot, pt.mask, 0), (ln.slot, ln.mask, 0)]
    tables += [(slot, t.mask, pb.P) for t, slot, _, _, _ in _active_planes(pb)]
    kf_ids = torch.arange(Kt, device=dev, dtype=torch.int64)
    slot = torch.cat([(s.long() + off).reshape(-1) for s, _, off in tables])
    kf = torch.cat([kf_ids.repeat_interleave(s.shape[1]) for s, _, _ in
                    tables])
    live = torch.cat([(m > 0).reshape(-1) for _, m, _ in tables])

    def by(key, n):
        k = torch.where(live, key, n)
        order = torch.sort(k, stable=True)[1]
        counts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        counts.scatter_add_(0, k, torch.ones_like(k))
        start = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:n], 0)])
        return order.to(torch.int32), start.to(torch.int32)

    lm_order, lm_start = by(slot, pb.M)
    kf_order, kf_start = by(kf, Kt)
    return PcgPlan(kf.to(torch.int32), slot.to(torch.int32), live, lm_order,
                   lm_start, kf_order, kf_start)


class PcgSystem(NamedTuple):
    """K43's outputs, one LM step's reduced camera system: Hpp_inv (M, 3,
    3), Hcc_d and Minv (Kt, 6, 6), rhs (Kt, 6) and C (n_obs, 6, 3), each
    observation's cross block in the plan's numbering."""

    Hpp_inv: torch.Tensor
    Hcc_d: torch.Tensor
    Minv: torch.Tensor
    rhs: torch.Tensor
    C: torch.Tensor


class CgState(NamedTuple):
    """K45's outputs: x, r, p (Kt, 6) and scal (2,): rz of r and z = Minv
    r, and the pAp of the step that made them (0 from the init mode)."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    scal: torch.Tensor


def _at(obj, b: int):
    """Problem b of a batched argument (named tuples and lists walked)."""
    if isinstance(obj, torch.Tensor):
        return obj[b]
    if isinstance(obj, (tuple, list)):
        parts = [_at(x, b) for x in obj]
        if hasattr(obj, "_fields"):
            return type(obj)(*parts)
        return type(obj)(parts)
    return obj


def _per_problem(fn, batched: bool, *args):
    """fn on each problem of a leading batch (stacked), or on one."""
    if not batched:
        return fn(*args)
    B = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
    return _stacked([fn(*[_at(a, b) for a in args]) for b in range(B)])


def _tensors(*objs) -> list:
    out = []
    for o in objs:
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (tuple, list)):
            out += _tensors(*o)
    return out


# ---------------------------------------------------------------------------
# K43: the system of one LM step


def _plane_cross(terms) -> list:
    """The plane observations' cross blocks C = Jx^T diag(Wv) Jt, each
    table's (Kt Pp, 6, 3)."""
    return [torch.einsum("kpdi,kpd,kpdj->kpij", t.Jx, t.Wv, t.Jt)
            .reshape(-1, 6, 3) for t in terms]


def pcg_prepare_plain(plan: PcgPlan, cross, terms: List[PlaneTerms], Hcc, bc,
                      Hpp, bp, mu_p, lam, free) -> PcgSystem:
    """Plain version of K43 for one problem: cross (Kt (F + L2), 18) the
    point and line-endpoint cross blocks (K8's), terms the PlaneTerms of
    the active plane tables (K33's), Hcc (Kt, 6, 6), bc (Kt, 6), Hpp (M,
    3, 3), bp (M, 3), mu_p and lam 0-d, free (Kt,) = 1 - fixed_mask. The
    JAX step's expressions: the damped landmark inverses (in float64, as
    K9's plain version), mu_c and Hcc_d, rhs = (bc - hcp_y(Hpp_inv bp))
    free, and the block-Jacobi correction summed per observation, Minv
    inverted in float64."""
    Kt = Hcc.shape[0]
    f = free[:, None]
    C = torch.cat([cross.reshape(-1, 6, 3)] + _plane_cross(terms))
    Hinv = torch.linalg.inv_ex(_damped(Hpp, lam, mu_p).double())[0].float()
    Hinv = Hinv.contiguous()
    diag_c = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    mu_c = torch.sum(diag_c * f) / (torch.sum(f) * 6.0 + 1.0)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hcc_d = (Hcc + lam * torch.diag_embed(diag_c)
             + (lam * mu_c + 1e-8) * eye6)
    slot = plan.obs_slot.long()
    live = plan.live
    y = torch.einsum("pij,pj->pi", Hinv, bp)
    hy = torch.where(live[:, None], torch.einsum("oij,oj->oi", C, y[slot]),
                     0.0)
    rhs = (bc - segment_sum(hy, plan.obs_kf, Kt)) * f
    corr = torch.where(live[:, None, None], torch.einsum(
        "oij,ojl,oml->oim", C, Hinv[slot], C), 0.0)
    Pm = (Hcc_d - segment_sum(corr, plan.obs_kf, Kt)
          + (1e-3 * mu_c + 1e-8) * eye6)
    Minv = torch.linalg.inv_ex(Pm.double())[0].float().contiguous()
    return PcgSystem(Hinv, Hcc_d, Minv, rhs, C)


def _plane_record(t: PlaneTerms) -> torch.Tensor:
    """The (..., Kt, Pp, D, 11) record buffer of K33's terms (r, Wv, Jx,
    Jt a row): the buffer K33 wrote, whose views the terms are, or one
    built from them."""
    base = t.rr._base
    if (base is not None and base.shape[-1] == 11 and base.is_contiguous()
            and base.shape[:-1] == t.rr.shape
            and t.rr.data_ptr() == base.data_ptr()):
        return base
    return torch.cat([t.rr[..., None], t.Wv[..., None], t.Jx, t.Jt],
                     dim=-1).contiguous()


def pcg_prepare(plan: PcgPlan, cross, terms: List[PlaneTerms], Hcc, bc, Hpp,
                bp, mu_p, lam, free) -> PcgSystem:
    """K43 wrapper; the arguments and results of ``pcg_prepare_plain``,
    each with an optional leading batch dimension (B problems of one shape:
    Hcc (B, Kt, 6, 6), cross (B, n, 18), lam (B,), ...). cross may be a
    view with rows apart (K8's scratch). One launch."""
    batched = Hcc.dim() == 4
    if kernels.on_cpu(*_tensors(plan, cross, terms, Hcc, bc, Hpp, bp, mu_p,
                                lam, free)):
        return _per_problem(pcg_prepare_plain, batched, plan, cross, terms,
                            Hcc, bc, Hpp, bp, mu_p, lam, free)
    lead = Hcc.shape[:1] if batched else ()
    B = Hcc.shape[0] if batched else 1
    Kt, M = Hcc.shape[-3], Hpp.shape[-3]
    n_obs = plan.obs_kf.shape[-1]
    n_ptln = cross.shape[-2]
    f32, i32 = torch.float32, torch.int32
    for name, x, shape in (("Hcc", Hcc, (Kt, 6, 6)), ("bc", bc, (Kt, 6)),
                           ("Hpp", Hpp, (M, 3, 3)), ("bp", bp, (M, 3)),
                           ("mu_p", mu_p, ()), ("lam", lam, ()),
                           ("free", free, (Kt,))):
        kernels.check(x, name, f32, lead + shape)
    for name, x, n in (("plan.obs_slot", plan.obs_slot, n_obs),
                       ("plan.kf_order", plan.kf_order, n_obs),
                       ("plan.kf_start", plan.kf_start, Kt + 1)):
        kernels.check(x, name, i32, lead + (n,))
    if cross.dtype != f32 or cross.stride(-1) != 1 or \
            tuple(cross.shape) != lead + (n_ptln, 18):
        raise ValueError(f"cross: expected float32 rows of 18 with unit "
                         f"stride, got {cross.dtype} {tuple(cross.shape)}")
    recs, n_pl = [], 0
    for t in terms:
        rec = _plane_record(t)
        Pp, D = rec.shape[-3], rec.shape[-2]
        kernels.check(rec, "plane records", f32, lead + (Kt, Pp, D, 11))
        recs += [kernels.ptr(rec), D, Pp]
        n_pl += Kt * Pp
    recs += [None, 1, 0] * (3 - len(terms))
    if n_ptln + n_pl != n_obs:
        raise ValueError(f"plan: {n_obs} observations, the tables "
                         f"{n_ptln + n_pl}")
    dev = Hcc.device
    out = PcgSystem(torch.empty(lead + (M, 3, 3), dtype=f32, device=dev),
                    torch.empty(lead + (Kt, 6, 6), dtype=f32, device=dev),
                    torch.empty(lead + (Kt, 6, 6), dtype=f32, device=dev),
                    torch.empty(lead + (Kt, 6), dtype=f32, device=dev),
                    torch.empty(lead + (n_obs, 6, 3), dtype=f32, device=dev))
    lane = cross.stride(0) if batched else 0
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_pcg_prepare", kernels.ptr(Hcc), kernels.ptr(bc),
            kernels.ptr(Hpp), kernels.ptr(bp), kernels.ptr(lam),
            kernels.ptr(mu_p), kernels.ptr(free), kernels.ptr(cross),
            cross.stride(-2), lane, n_ptln, *recs,
            kernels.ptr(plan.obs_slot), kernels.ptr(plan.kf_order),
            kernels.ptr(plan.kf_start), B, Kt, M, n_obs,
            *(kernels.ptr(x) for x in out))
    kernels.LAUNCHES["pcg_prepare"] += 1
    return out


# ---------------------------------------------------------------------------
# K44: S p, matrix free, and the back-substitution


def _landmark_sum(sys: PcgSystem, plan: PcgPlan, q, M: int):
    """sum over each landmark's live observations of C_o^T q[k_o]."""
    t = torch.einsum("oij,oi->oj", sys.C, q[plan.obs_kf.long()])
    return segment_sum(torch.where(plan.live[:, None], t, 0.0),
                       plan.obs_slot, M)


def pcg_schur_matvec_plain(sys: PcgSystem, plan: PcgPlan, free, p):
    """Plain version of K44 for one problem: JAX's s_mv, S p = (Hcc_d xm -
    hcp_y(Hpp_inv hcpT_x(xm))) free with xm = p free, over the plan's live
    observations. p (Kt, 6); returns Ap (Kt, 6)."""
    Kt, M = p.shape[0], sys.Hpp_inv.shape[0]
    f = free[:, None]
    xm = p * f
    v = torch.einsum("pij,pj->pi", sys.Hpp_inv,
                     _landmark_sum(sys, plan, xm, M))
    s = torch.einsum("oij,oj->oi", sys.C, v[plan.obs_slot.long()])
    s = segment_sum(torch.where(plan.live[:, None], s, 0.0), plan.obs_kf, Kt)
    return (torch.einsum("kij,kj->ki", sys.Hcc_d, xm) - s) * f


def pcg_backsub_plain(sys: PcgSystem, plan: PcgPlan, bp, dxc):
    """Plain version of K44's back-substitution: dxp (M, 3) = -Hpp_inv (bp
    + hcpT_x(dxc))."""
    M = sys.Hpp_inv.shape[0]
    return -torch.einsum("pij,pj->pi", sys.Hpp_inv,
                         bp + _landmark_sum(sys, plan, dxc, M))


def _matvec_launch(sys: PcgSystem, plan: PcgPlan, free, x, bp=None):
    """One K44 C call: S x (bp None), or the back-substitution of dxc = x
    (free None: the landmark pass alone does not read it)."""
    batched = x.dim() == 3
    lead = x.shape[:1] if batched else ()
    B = x.shape[0] if batched else 1
    Kt, M = x.shape[-2], sys.Hpp_inv.shape[-3]
    n_obs = sys.C.shape[-3]
    f32, i32 = torch.float32, torch.int32
    for name, t, shape in (("C", sys.C, (n_obs, 6, 3)),
                           ("Hpp_inv", sys.Hpp_inv, (M, 3, 3)),
                           ("Hcc_d", sys.Hcc_d, (Kt, 6, 6)),
                           ("x", x, (Kt, 6))):
        kernels.check(t, name, f32, lead + shape)
    for name, t, n in (("obs_kf", plan.obs_kf, n_obs),
                       ("obs_slot", plan.obs_slot, n_obs),
                       ("lm_order", plan.lm_order, n_obs),
                       ("lm_start", plan.lm_start, M + 1),
                       ("kf_order", plan.kf_order, n_obs),
                       ("kf_start", plan.kf_start, Kt + 1)):
        kernels.check(t, f"plan.{name}", i32, lead + (n,))
    dev = x.device
    v = torch.empty(lead + (M, 3), dtype=f32, device=dev)
    Ap = None
    if bp is None:
        kernels.check(free, "free", f32, lead + (Kt,))
        Ap = torch.empty(lead + (Kt, 6), dtype=f32, device=dev)
    else:
        kernels.check(bp, "bp", f32, lead + (M, 3))
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_pcg_schur_matvec", kernels.ptr(sys.C),
            kernels.ptr(sys.Hpp_inv), kernels.ptr(sys.Hcc_d),
            None if free is None else kernels.ptr(free),
            kernels.ptr(plan.obs_kf),
            kernels.ptr(plan.obs_slot), kernels.ptr(plan.lm_order),
            kernels.ptr(plan.lm_start), kernels.ptr(plan.kf_order),
            kernels.ptr(plan.kf_start), B, Kt, M, n_obs, kernels.ptr(x),
            None if bp is None else kernels.ptr(bp), kernels.ptr(v),
            None if Ap is None else kernels.ptr(Ap),
            ctypes.addressof(launches))
    kernels.LAUNCHES["pcg_schur_matvec"] += launches.value
    return v if bp is not None else Ap


def pcg_schur_matvec(sys: PcgSystem, plan: PcgPlan, free, p):
    """K44 wrapper; the arguments and results of ``pcg_schur_matvec_plain``,
    each with an optional leading batch dimension. One C call of two
    launches (MATVEC_LAUNCHES): the landmark pass, the keyframe pass."""
    if kernels.on_cpu(*_tensors(sys, plan, free, p)):
        return _per_problem(pcg_schur_matvec_plain, p.dim() == 3, sys, plan,
                            free, p)
    return _matvec_launch(sys, plan, free, p)


def pcg_backsub(sys: PcgSystem, plan: PcgPlan, bp, dxc):
    """K44's back-substitution; the arguments and results of
    ``pcg_backsub_plain``. One launch (BACKSUB_LAUNCHES): the landmark
    pass."""
    if kernels.on_cpu(*_tensors(sys, plan, bp, dxc)):
        return _per_problem(pcg_backsub_plain, dxc.dim() == 3, sys, plan, bp,
                            dxc)
    return _matvec_launch(sys, plan, None, dxc, bp)


# K44's launches per C call, as its entry reports them
MATVEC_LAUNCHES, BACKSUB_LAUNCHES = 2, 1


# ---------------------------------------------------------------------------
# K45: the CG update


def pcg_cg_update_plain(Minv, free, r, x=None, p=None, Ap=None,
                        scal=None) -> CgState:
    """Plain version of K45 for one problem: JAX's cg_body (the
    preconditioner z = Minv (r free) free, alpha 0 unless pAp > 0, beta 0
    unless rz > 0) from x, r, p, Ap (Kt, 6) and scal's rz; with Ap None its
    init mode from r = rhs: x = 0, z, p = z, rz = sum(r z)."""
    f = free[:, None]

    def precond(v):
        return torch.einsum("kij,kj->ki", Minv, v * f) * f

    if Ap is None:
        z = precond(r)
        rz = torch.sum(r * z)
        return CgState(torch.zeros_like(r), r, z,
                       torch.stack([rz, torch.zeros_like(rz)]))
    rz = scal[0]
    pAp = torch.sum(p * Ap)
    alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
    x = x + alpha * p
    r = r - alpha * Ap
    z = precond(r)
    rz_new = torch.sum(r * z)
    beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
    return CgState(x, r, z + beta * p, torch.stack([rz_new, pAp]))


def pcg_cg_update(Minv, free, r, x=None, p=None, Ap=None,
                  scal=None) -> CgState:
    """K45 wrapper; the arguments and results of ``pcg_cg_update_plain``,
    each with an optional leading batch dimension (scal (B, 2)). One
    launch, a block a problem."""
    batched = Minv.dim() == 4
    if kernels.on_cpu(*_tensors(Minv, free, r, x, p, Ap, scal)):
        return _per_problem(pcg_cg_update_plain, batched, Minv, free, r, x,
                            p, Ap, scal)
    lead = Minv.shape[:1] if batched else ()
    B = Minv.shape[0] if batched else 1
    Kt = Minv.shape[-3]
    f32 = torch.float32
    kernels.check(Minv, "Minv", f32, lead + (Kt, 6, 6))
    kernels.check(free, "free", f32, lead + (Kt,))
    kernels.check(r, "r", f32, lead + (Kt, 6))
    if Ap is not None:
        for name, t in (("x", x), ("p", p), ("Ap", Ap)):
            kernels.check(t, name, f32, lead + (Kt, 6))
        kernels.check(scal, "scal", f32, lead + (2,))
    dev = Minv.device
    out = CgState(*(torch.empty(lead + (Kt, 6), dtype=f32, device=dev)
                    for _ in range(3)),
                  torch.empty(lead + (2,), dtype=f32, device=dev))
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_pcg_cg_update", kernels.ptr(Minv), kernels.ptr(free), B, Kt,
            *(None if t is None else kernels.ptr(t)
              for t in ((x, r, p, Ap, scal) if Ap is not None
                        else (None, r, None, None, None))),
            *(kernels.ptr(t) for t in out))
    kernels.LAUNCHES["pcg_cg_update"] += 1
    return out


# ---------------------------------------------------------------------------
# the solver


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
    dev, dt = poses.device, poses.dtype
    plan = pcg_plan(pb)
    free = (1.0 - fixed_mask).to(dt).contiguous()

    def step(poses_c, lm_c, lam):
        Hcc, bc, Hpp, bp, _, _, _, cross = ba_normal_eqs(
            poses_c, lm_c[:P], pb.pt, pb.ln, M, K, bf, huber, False,
            pb.plan, want_cross=True)
        Hcc, bc, Hpp, bp, _, terms, mu_p = ba_plane_blocks(
            pb, poses_c, plane_base, lm_c[P:], Hcc, bc, Hpp, bp, None, huber)
        with record_function("ba_pcg.prepare"):
            sys = pcg_prepare(plan, cross, terms, Hcc, bc, Hpp, bp, mu_p,
                              lam, free)
        # CG on the reduced camera system, fixed iteration count
        with record_function("ba_pcg.cg"):
            st = pcg_cg_update(sys.Minv, free, sys.rhs)
            for _ in range(n_cg):
                Ap = pcg_schur_matvec(sys, plan, free, st.p)
                st = pcg_cg_update(sys.Minv, free, st.r, st.x, st.p, Ap,
                                   st.scal)
        dxc = -st.x
        dxp = pcg_backsub(sys, plan, bp, dxc)
        out = ba_cost_test(pb, poses_c, lm_c, dxc, dxp, lam, plane_base, K,
                           bf, huber)
        return out.poses, out.lm, out.lam

    lm = torch.cat([lm_xyz.to(dt), torch.zeros((pb.Q, 3), dtype=dt,
                                               device=dev)], dim=0)
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        with record_function("ba_pcg.lm_step"):
            poses, lm, lam = step(poses.contiguous(), lm.contiguous(), lam)
    return _finish(pb, poses, lm, plane_base, K, bf)
