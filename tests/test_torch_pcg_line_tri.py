"""Port parity of K42-K45's plain versions: the mapping step's line
triangulation (``device_mapper.triangulate_lines_plain``) against the JAX
``_mapping_step_impl`` line outputs, on the packed inputs of a JAX run and
on chip_smoke's planted problems; and the PCG solve's system, matrix-free
product, back-substitution and CG update (``ba_pcg.pcg_prepare_plain``,
``pcg_schur_matvec_plain``, ``pcg_backsub_plain``, ``pcg_cg_update_plain``)
against the JAX step's expressions built here from
``planarslam_tpu.solvers.ba_core``'s Jacobian helpers, on the line-and-plane
recipe of tests/test_torch_ba.py and on a 16-keyframe orbit with two fixed
poses (JAX on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import plane as jplane_geo
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam import device_mapper as jdm
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu.solvers import ba_core as jba
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.io.frames import quantize_frame
from planarslam_tpu_torch.slam import device_mapper as tdm
from planarslam_tpu_torch.solvers import ba_core as tba
from planarslam_tpu_torch.solvers import ba_pcg
from test_torch_ba import BF, CAM_K, _recipe, _tables

torch.set_num_threads(2)

N_FRAMES = 16


# ---------------------------------------------------------------------------
# K42: the line triangulation


@pytest.fixture(scope="module")
def jax_steps():
    """The packed inputs and outputs of every mapping step of the JAX
    System (local mapping on, loop closing off) over the tiny sequence."""
    cfg = jconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(N_FRAMES, width=160, height=120)
    steps = []
    orig = jdm.mapping_step_packed

    def recording(flat, cfg_):
        out = orig(flat, cfg_)
        steps.append((np.asarray(flat), np.asarray(out)))
        return out

    jdm.mapping_step_packed = recording
    try:
        slam = JSystem(config=cfg, enable_loop_closing=False)
        for i in range(N_FRAMES):
            g, d = quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
            slam.track_rgbd(g, d, seq.timestamps[i])
    finally:
        jdm.mapping_step_packed = orig
    assert len(steps) >= 3
    return steps


def _jax_lines(out, jcfg):
    got = jdm.MappingLayout(jcfg).unpack(out)
    return (got["ln_tri_idx"], got["ln_tri_s"], got["ln_tri_e"],
            got["ln_tri_good"] > 0)


def _held(got, want, name):
    """idx and good exact; Xs and Xe within 1e-5 of max(1, |X|) where good
    (the endpoints the mapper keeps: a rejected cut can be nearly parallel,
    where a last-bit difference of the plane or the ray moves the endpoint
    by 4e-5 of itself, tens of metres away)."""
    idx, Xs, Xe, good = (g.numpy() for g in got)
    np.testing.assert_array_equal(idx, want[0], err_msg=f"{name}: idx")
    np.testing.assert_array_equal(good, want[3], err_msg=f"{name}: good")
    for g, w, what in ((Xs, want[1], "Xs"), (Xe, want[2], "Xe")):
        g, w = g[good], w[good]
        tol = 1e-5 * np.maximum(1.0, np.abs(w))
        assert np.all(np.abs(g - w) <= tol), (
            f"{name}: {what} off by {np.abs(g - w).max()}")


def _port_line_args(flat, tcfg):
    parts = tdm.MappingInputLayout(tcfg).unpack_device(
        torch.from_numpy(np.array(flat)))
    return [parts[i].contiguous() for i in chip_smoke.LINE_TRI_ARGS]


def _free_lines(flat, jcfg):
    """The same packed inputs with every line free in the own keyframe and
    in every neighbour with nb_ok (the synthetic room gives its lines
    depth, hence none free)."""
    lay = jdm.MappingInputLayout(jcfg)
    parts, off = {}, 0
    for (name, shape, _), size in zip(lay.fields, lay.sizes):
        parts[name] = flat[off:off + size].reshape(shape).copy()
        off += size
    parts["own_ln_free"] = np.ones_like(parts["own_ln_free"])
    parts["nb_ln_free"] = np.broadcast_to(
        parts["nb_ok"][:, None], parts["nb_ln_free"].shape).copy()
    return np.concatenate([parts[n].reshape(-1) for n, _, _ in lay.fields])


def test_triangulate_lines_plain_matches_jax_steps(jax_steps):
    """triangulate_lines_plain on every mapping step the JAX run packed, and
    on the last two with every line free, against the line outputs JAX's
    _mapping_step_impl gives them."""
    jcfg, tcfg = jconfig.SystemConfig.tiny(), tconfig.SystemConfig.tiny()
    cam = tcfg.camera
    n_good = 0
    cases = list(jax_steps)
    for flat, _ in jax_steps[-2:]:
        freed = _free_lines(flat, jcfg)
        cases.append((freed, np.asarray(jdm.mapping_step_packed(
            jnp.asarray(freed), jcfg))))
    for i, (flat, out) in enumerate(cases):
        got = tdm.triangulate_lines_plain(*_port_line_args(flat, tcfg),
                                          (cam.fx, cam.fy, cam.cx, cam.cy))
        want = _jax_lines(out, jcfg)
        _held(got, want, f"step {i}")
        n_good += int(want[3].sum())
    assert n_good > 0


def _jax_packed(p: dict, jcfg) -> np.ndarray:
    """A planted K42 problem inside a whole packed mapping step: no
    landmark valid and no feature free, so only the lines do work."""
    lay = jdm.MappingInputLayout(jcfg)
    parts = {}
    for name, shape, kind in lay.fields:
        parts[name] = np.zeros(shape, {"f": np.float32, "u": np.uint32,
                                       "i": np.int32, "b": bool}[kind])
    for k in chip_smoke.LINE_TRI_KEYS:
        parts[k] = p[k]
    return lay.pack(parts)


@pytest.mark.parametrize("case", chip_smoke.LINE_TRI_PLANTED)
def test_triangulate_lines_plain_matches_jax_planted(case):
    """triangulate_lines_plain on chip_smoke's planted problem against JAX's
    _mapping_step_impl on the same inputs; the parallax edge rows give good
    on the rows below 0.998 only, and the parallel ray's denominator is
    exactly 0."""
    jcfg, tcfg = jconfig.SystemConfig.tiny(), tconfig.SystemConfig.tiny()
    p = chip_smoke.planted_line_tri_problem(case, tcfg)
    out = np.asarray(jdm.mapping_step_packed(jnp.asarray(_jax_packed(p, jcfg)),
                                             jcfg))
    args = [torch.from_numpy(np.ascontiguousarray(p[k]))
            for k in chip_smoke.LINE_TRI_KEYS]
    got = tdm.triangulate_lines_plain(*args, p["K"])
    _held(got, _jax_lines(out, jcfg), case)
    idx, good = got[0].numpy(), got[3].numpy()
    if case == "no_free":
        assert not good.any() and not idx.any()
    elif case == "nb_not_ok":
        assert not good[[1, 3]].any() and not idx[[1, 3]].any()
    elif case == "nan_desc":
        # neighbour 2's row 3 is NaN: every own row picks it, but own rows
        # 1 and 2, whose similarities are all NaN, pick their first free
        # column in every neighbour
        assert not good[:, 2].any() and not good[:, [1, 2]].any()
        assert (np.delete(idx[2], [1, 2]) == 3).all()
        first = p["nb_ln_free"].argmax(1)
        assert (idx[:, 1] == first).all() and (idx[:, 2] == first).all()
    elif case == "ties":
        L = idx.shape[1]
        assert good.any()
        # own line i's match and its copy: the first of the two slots
        for n in range(idx.shape[0]):
            for i in range(0, L - 1, 4):
                row = p["nb_ln_desc"][n]
                twins = np.flatnonzero((row == row[idx[n, i]]).all(-1))
                assert idx[n, i] == twins.min()
    elif case == "parallax_edge":
        below = p["edge_below"]
        assert good[0, :below].all() and not good[0, below:].any()
        cos = [chip_smoke.line_tri_cosp(p["own_T"], p["own_ln_l2d"][i],
                                        p["nb_T"][0], p["nb_ln_l2d"][0, i],
                                        p["K"]) for i in range(idx.shape[1])]
        assert max(cos[:below]) < np.float32(0.998) <= min(cos[below:])
    elif case == "parallel_ray":
        fx, fy, cx, cy, ifx, ify, ncx, ncy = tdm.line_constants(p["K"])
        u, v = p["own_ln_uvs"][0]
        assert np.float32(u * np.float32(ifx)) + np.float32(ncx) == 0
        assert np.float32(v * np.float32(ify)) + np.float32(ncy) == 0
        assert idx[0, 0] == 0 and not good[0, 0]


def test_triangulate_lines_batched_cpu():
    """The wrapper at B = 3 on the CPU: each problem its own plain result."""
    tcfg = tconfig.SystemConfig.tiny()
    ps = [chip_smoke.planted_line_tri_problem(c, tcfg)
          for c in ("random", "ties", "nan_desc")]
    batch = [torch.stack([torch.from_numpy(np.ascontiguousarray(p[k]))
                          for p in ps]) for k in chip_smoke.LINE_TRI_KEYS]
    got = tdm.triangulate_lines(*batch, ps[0]["K"])
    for b, p in enumerate(ps):
        one = tdm.triangulate_lines(*[x[b] for x in batch], p["K"])
        for x, y in zip(got, one):
            assert torch.equal(torch.nan_to_num(x[b].float()),
                               torch.nan_to_num(y.float()))


# ---------------------------------------------------------------------------
# K43-K45: the PCG solve


def _inv64(a):
    """The inverses of a's float32 blocks taken in float64 and rounded, as
    the port's K43 and its plain version take them. jnp.linalg.inv in
    float32 lies up to cond x 2^-24 off: 5e-5 of the largest entry on the
    recipe and 8e-5 on the orbit, whose landmark blocks reach a condition
    number of 1e4."""
    return jnp.asarray(np.linalg.inv(np.asarray(a, np.float64))
                       .astype(np.float32))


def _jax_step(poses, lm, plane_base, tabs, fixed, lam, P, K, bf, w):
    """The JAX package's ba_solve_pcg step body (ba_pcg.py:100-259) at one
    state, in jnp float32 but for the inverses (``_inv64``): returns the
    system, the per-observation cross blocks in the port's numbering, and
    the closures s_mv, backsub, init and cg_step."""
    pt, ln, pl, par, ver = tabs
    Q = plane_base.shape[0]
    M = P + Q
    pts, theta = lm[:P], lm[P:]
    clip = lambda s, n: jnp.clip(s, 0, max(n - 1, 0))  # noqa: E731
    pt_slot, ln_slot = clip(pt.slot, P), clip(ln.slot, P)
    is_stereo = pt.ur >= 0
    gate_pt = jnp.where(is_stereo, 7.815, jba.CHI2_MONO)
    free = (1.0 - fixed)[:, None]
    r_pt, Jpose, Jpt = jba._point_jacs(poses, pts, pt_slot, pt.uv, pt.ur,
                                       is_stereo, K, bf)
    chi_pt = jnp.sum(r_pt * r_pt, axis=-1) * pt.inv_s2
    w_pt = pt.inv_s2 * jba._huber_w_fn(chi_pt, gate_pt, True) * pt.mask
    Wp = w_pt[..., None] * jnp.stack([jnp.ones_like(w_pt),
                                      jnp.ones_like(w_pt),
                                      is_stereo.astype(w_pt.dtype)], -1)
    have_ln = ln.slot.shape[1] > 0
    if have_ln:
        r_ln, Jp_ln, Jl_ln = jba._line_jacs(poses, pts, ln_slot, ln.line2d,
                                            K)
        chi_ln = r_ln * r_ln * ln.inv_s2
        w_ln = (ln.inv_s2 * jba._huber_w_fn(chi_ln, jba.CHI2_MONO, True)
                * ln.mask)
    infos = ((pl, jplane_geo.ominus,
              jnp.stack([w.angle_info, w.angle_info, w.dis_info]),
              w.plane_chi),
             (par, jplane_geo.ominus_par,
              jnp.stack([w.par_info, w.par_info]), w.vp_chi),
             (ver, jplane_geo.ominus_ver,
              jnp.stack([w.ver_info, w.ver_info]), w.vp_chi))
    pl_jacs = []
    if Q > 0:
        for tables, err_fn, info_vec, gate in infos:
            if tables.slot.shape[1] == 0:
                continue
            slot = clip(tables.slot, Q)
            rr, Jx, Jt = jba._plane_jacs(poses, plane_base, theta, slot,
                                         tables.pi_obs, err_fn, poses.dtype)
            chi = jnp.sum(rr * rr * info_vec, axis=-1)
            Wv = (jba._huber_w_fn(chi, gate, True) * tables.mask)[
                ..., None] * info_vec
            pl_jacs.append((slot, rr, Jx, Jt, Wv))
    seg = jax.ops.segment_sum
    flat = pt_slot.reshape(-1)
    Hcc = jnp.einsum("kfai,kfa,kfaj->kij", Jpose, Wp, Jpose)
    bc = jnp.einsum("kfai,kfa->ki", Jpose, r_pt * Wp)
    Hpp = seg(jnp.einsum("kfai,kfa,kfaj->kfij", Jpt, Wp, Jpt
                         ).reshape(-1, 3, 3), flat, M)
    bp = seg(jnp.einsum("kfai,kfa->kfi", Jpt, r_pt * Wp).reshape(-1, 3),
             flat, M)
    if have_ln:
        flat_l = ln_slot.reshape(-1)
        Hcc += jnp.einsum("kli,kl,klj->kij", Jp_ln, w_ln, Jp_ln)
        bc += jnp.einsum("kli,kl->ki", Jp_ln, r_ln * w_ln)
        Hpp += seg(jnp.einsum("kli,kl,klj->klij", Jl_ln, w_ln, Jl_ln
                              ).reshape(-1, 3, 3), flat_l, M)
        bp += seg((Jl_ln * (r_ln * w_ln)[..., None]).reshape(-1, 3), flat_l,
                  M)
    for slot, rr, Jx, Jt, Wv in pl_jacs:
        Hcc += jnp.einsum("kpdi,kpd,kpdj->kij", Jx, Wv, Jx)
        bc += jnp.einsum("kpdi,kpd->ki", Jx, rr * Wv)
        fp = (slot + P).reshape(-1)
        Hpp += seg(jnp.einsum("kpdi,kpd,kpdj->kpij", Jt, Wv, Jt
                              ).reshape(-1, 3, 3), fp, M)
        bp += seg(jnp.einsum("kpdi,kpd->kpi", Jt, rr * Wv).reshape(-1, 3),
                  fp, M)
    diag_p = jax.vmap(jnp.diag)(Hpp)
    mu_p = jnp.sum(diag_p) / (3 * (jnp.sum(diag_p.sum(-1) > 0) + 1))
    Hpp_inv = _inv64(Hpp + lam * jax.vmap(jnp.diag)(diag_p)
                     + (lam * mu_p + 1e-6) * jnp.eye(3))
    diag_c = jax.vmap(jnp.diag)(Hcc)
    mu_c = jnp.sum(diag_c * free) / (jnp.sum(free) * 6.0 + 1.0)
    Hcc_d = (Hcc + lam * jax.vmap(jnp.diag)(diag_c)
             + (lam * mu_c + 1e-8) * jnp.eye(6))

    def hppinv_apply(v):
        return jnp.einsum("pij,pj->pi", Hpp_inv, v)

    def hcpT_x(x):
        u = jnp.einsum("kfab,kb->kfa", Jpose, x)
        out = seg(jnp.einsum("kfai,kfa->kfi", Jpt, Wp * u).reshape(-1, 3),
                  flat, M)
        if have_ln:
            ul = jnp.einsum("klb,kb->kl", Jp_ln, x)
            out += seg((Jl_ln * (w_ln * ul)[..., None]).reshape(-1, 3),
                       flat_l, M)
        for slot, _, Jx, Jt, Wv in pl_jacs:
            up = jnp.einsum("kpdb,kb->kpd", Jx, x)
            out += seg(jnp.einsum("kpdi,kpd->kpi", Jt, Wv * up
                                  ).reshape(-1, 3), (slot + P).reshape(-1), M)
        return out

    def hcp_y(y):
        u = jnp.einsum("kfai,kfi->kfa", Jpt, y[pt_slot])
        out = jnp.einsum("kfab,kfa->kb", Jpose, Wp * u)
        if have_ln:
            ul = jnp.einsum("kli,kli->kl", Jl_ln, y[ln_slot])
            out += jnp.einsum("klb,kl->kb", Jp_ln, w_ln * ul)
        for slot, _, Jx, Jt, Wv in pl_jacs:
            up = jnp.einsum("kpdi,kpi->kpd", Jt, y[slot + P])
            out += jnp.einsum("kpdb,kpd->kb", Jx, Wv * up)
        return out

    def s_mv(x):
        xm = x * free
        return (jnp.einsum("kij,kj->ki", Hcc_d, xm)
                - hcp_y(hppinv_apply(hcpT_x(xm)))) * free

    rhs = (bc - hcp_y(hppinv_apply(bp))) * free
    C = jnp.einsum("kfai,kfa,kfaj->kfij", Jpose, Wp, Jpt)
    corr = jnp.einsum("kfij,kfjl,kfml->kim", C, Hpp_inv[pt_slot], C)
    blocks = [C.reshape(-1, 6, 3)]
    if have_ln:
        Cl = jnp.einsum("kai,ka,kaj->kaij", Jp_ln, w_ln, Jl_ln)
        corr += jnp.einsum("kaij,kajl,kaml->kim", Cl, Hpp_inv[ln_slot], Cl)
        blocks.append(Cl.reshape(-1, 6, 3))
    for slot, _, Jx, Jt, Wv in pl_jacs:
        Cp = jnp.einsum("kpdi,kpd,kpdj->kpij", Jx, Wv, Jt)
        corr += jnp.einsum("kpij,kpjl,kpml->kim", Cp, Hpp_inv[slot + P], Cp)
        blocks.append(Cp.reshape(-1, 6, 3))
    Pm = Hcc_d - corr + (1e-3 * mu_c + 1e-8) * jnp.eye(6)
    Minv = _inv64(Pm)

    def precond(r):
        return jnp.einsum("kij,kj->ki", Minv, r * free) * free

    def init():
        z = precond(rhs)
        return jnp.zeros_like(rhs), rhs, z, jnp.sum(rhs * z)

    def cg_step(x, r, p, rz):  # cg_body
        Ap = s_mv(p)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
        alpha = jnp.where(pAp > 0, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(rz > 0, rz, 1.0)
        beta = jnp.where(rz > 0, beta, 0.0)
        return x, r, z + beta * p, rz_new, pAp, Ap

    def backsub(dxc):
        return -hppinv_apply(bp + hcpT_x(dxc))

    def backsub_terms(dxc):
        """The sum of |terms| of each entry of backsub(dxc): |Hpp_inv| (|bp|
        + hcpT_x's products with every factor taken by its magnitude)."""
        a = jnp.abs
        x = a(dxc)
        u = jnp.einsum("kfab,kb->kfa", a(Jpose), x)
        out = seg(jnp.einsum("kfai,kfa->kfi", a(Jpt), a(Wp) * u
                             ).reshape(-1, 3), flat, M)
        if have_ln:
            ul = jnp.einsum("klb,kb->kl", a(Jp_ln), x)
            out += seg((a(Jl_ln) * (a(w_ln) * ul)[..., None]).reshape(-1, 3),
                       flat_l, M)
        for slot, _, Jx, Jt, Wv in pl_jacs:
            up = jnp.einsum("kpdb,kb->kpd", a(Jx), x)
            out += seg(jnp.einsum("kpdi,kpd->kpi", a(Jt), a(Wv) * up
                                  ).reshape(-1, 3), (slot + P).reshape(-1), M)
        return jnp.einsum("pij,pj->pi", a(Hpp_inv), a(bp) + out)

    system = {"Hpp_inv": Hpp_inv, "Hcc_d": Hcc_d, "Minv": Minv, "rhs": rhs,
              "C": jnp.concatenate(blocks)}
    sums = {"Hcc": Hcc, "bc": bc, "Hpp": Hpp, "bp": bp, "mu_p": mu_p,
            "Pm": Pm,
            "cross": jnp.concatenate(blocks[:1 + have_ln]).reshape(-1, 18),
            "terms": [(s, rr, Jx, Jt, Wv) for s, rr, Jx, Jt, Wv in pl_jacs]}
    sums["backsub_terms"] = backsub_terms
    return system, s_mv, backsub, init, cg_step, sums


def _orbit(n_fixed_extra: int = 5):
    """chip_smoke's orbit at 16 keyframes, 128 points, 24 slots, keyframe 0
    and one more fixed, as numpy arrays and JAX / port tables."""
    _, poses0, args, slot = chip_smoke._orbit_problem(
        np.random.default_rng(7), 16, 128, 24, "cpu")
    poses, fixed, pts = (a.numpy().copy() for a in args[:3])
    fixed[n_fixed_extra] = 1.0
    pt = args[4]
    r = dict(poses0=poses, fixed=fixed, lm0=pts,
             pl0=np.zeros((0, 4), np.float32), slot=slot,
             uv=pt.uv.numpy(), ur=pt.ur.numpy(),
             ln_slot=np.full((16, 0), -1, np.int32),
             l2d=np.zeros((16, 0, 3), np.float32),
             pl_slot=np.full((16, 0), -1, np.int32),
             pl_obs=np.zeros((16, 0, 4), np.float32), K=args[9], bf=args[10])
    return r


def _problem_of(name):
    if name == "recipe":
        r = _recipe()
        r["K"], r["bf"] = CAM_K, BF
        return r
    return _orbit()


def _jax_of(r, lam_v, P):
    j = jnp.asarray
    w = jba.BAWeights.from_config(jconfig.PlaneConfig())
    Q = r["pl0"].shape[0]
    lm = jnp.concatenate([j(r["lm0"]), jnp.zeros((Q, 3), jnp.float32)])
    return _jax_step(j(r["poses0"]), lm, j(r["pl0"]), _tables(r, jnp),
                     j(r["fixed"]), jnp.float32(lam_v), P, r["K"], r["bf"],
                     w)


def _port_system(r, lam_v):
    """The JAX step at the problem's start, and the port's plain K43 on the
    same sums, cross blocks and plane terms (JAX's), so that only K43's
    expressions differ: returns the JAX step's outputs and the port's
    system, plan, free and bp."""
    t = torch.from_numpy
    w = tba.BAWeights.from_config(tconfig.PlaneConfig())
    pt, ln, pl, par, ver = _tables(r, torch)
    pb = tba._problem(t(r["lm0"]), t(r["pl0"]), pt, ln, pl, par, ver, w,
                      want_pairs=False)
    plan = ba_pcg.pcg_plan(pb)
    jout = _jax_of(r, lam_v, pb.P)
    sums = jout[-1]

    def tt(a):
        return torch.from_numpy(np.array(a, np.float32))

    terms = [tba.PlaneTerms(t(np.asarray(s, np.int32)), tt(rr), tt(Jx),
                            tt(Jt), tt(Wv)) for s, rr, Jx, Jt, Wv in
             sums["terms"]]
    free = 1.0 - t(r["fixed"])
    bp = tt(sums["bp"])
    sys = ba_pcg.pcg_prepare(plan, tt(sums["cross"]), terms, tt(sums["Hcc"]),
                             tt(sums["bc"]), tt(sums["Hpp"]), bp,
                             tt(sums["mu_p"]),
                             torch.tensor(lam_v, dtype=torch.float32), free)
    return jout, sys, plan, free, bp


def _close(got, want, name, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: {err} > {rel} x {scale}"


def _fixed_zero(x, fixed, name):
    assert np.all(np.asarray(x)[np.asarray(fixed) > 0] == 0), \
        f"{name}: a fixed pose's entry is not 0"


def _jax_system(jout) -> ba_pcg.PcgSystem:
    """The JAX step's system as the port's PcgSystem (K44's and K45's
    inputs), so that their tests compare their own expressions."""
    want = jout[0]
    return ba_pcg.PcgSystem(*(torch.from_numpy(np.array(want[k], np.float32))
                              for k in ba_pcg.PcgSystem._fields))


@pytest.mark.parametrize("lam_v", [1e-4, 0.3])
@pytest.mark.parametrize("problem", ["recipe", "orbit"])
def test_pcg_prepare_plain_matches_jax(problem, lam_v):
    """K43's plain version on the JAX step's sums, cross blocks and plane
    terms against the JAX step's expressions: Hpp_inv, Hcc_d, rhs and every
    live observation's cross block within 1e-5 of each output's largest
    value, rhs exactly 0 at fixed poses. Minv inverts Pm = Hcc_d - corr +
    (1e-3 mu_c + 1e-8) I, whose terms nearly cancel (the Schur complement
    of a block that its landmarks constrain well): there the two summation
    orders of corr differ by 1e-7 of the terms, 3e-5 to 1e-4 of Pm. So Minv
    is held through its inverse: inv(Minv) (float64) within 1e-5 of the
    largest |Hcc_d|, the largest term of Pm's sum, of JAX's Pm."""
    r = _problem_of(problem)
    jout, sys, plan, free, _ = _port_system(r, lam_v)
    want, sums = jout[0], jout[-1]
    live = plan.live.numpy()
    for name in ("Hpp_inv", "Hcc_d", "rhs"):
        _close(getattr(sys, name).numpy(), want[name], name)
    _close(sys.C.numpy()[live], np.asarray(want["C"])[live], "C")
    _fixed_zero(sys.rhs.numpy(), r["fixed"], "rhs")
    Pm = np.linalg.inv(sys.Minv.numpy().astype(np.float64))
    err = float(np.abs(Pm - np.asarray(sums["Pm"], np.float64)).max())
    assert err <= 1e-5 * float(np.abs(np.asarray(want["Hcc_d"])).max()), err
    assert np.isfinite(sys.Minv.numpy()).all()


@pytest.mark.parametrize("problem", ["recipe", "orbit"])
def test_pcg_schur_matvec_plain_matches_jax(problem):
    """K44's plain version on the JAX step's system against JAX's s_mv on a
    seeded p, within 1e-5 of the largest value, its fixed rows exactly 0;
    and its back-substitution against -Hpp_inv (bp + hcpT_x(dxc)), each
    entry within 2 (n - 1) 2^-24 of the sum of its |terms| (n the terms
    of its longest chain: 3 of the inverse, 1 of bp, 6 of each
    observation's product, one per observation): JAX factors C^T x as
    Jpt^T (W (Jpose x)), and the landmark blocks' condition numbers of up
    to 1e4 carry that to 7e-5 of the largest dxp on the orbit."""
    r = _problem_of(problem)
    jout, _, plan, free, bp = _port_system(r, 1e-4)
    _, s_mv, backsub = jout[:3]
    sys = _jax_system(jout)
    rng = np.random.default_rng(3)
    p = rng.normal(0, 1e-2, sys.rhs.shape).astype(np.float32)
    got = ba_pcg.pcg_schur_matvec(sys, plan, free, torch.from_numpy(p))
    _close(got.numpy(), s_mv(jnp.asarray(p)), "S p")
    _fixed_zero(got.numpy(), r["fixed"], "S p")
    dxc = p * (1.0 - r["fixed"][:, None])
    got = ba_pcg.pcg_backsub(sys, plan, bp, torch.from_numpy(dxc))
    want = np.asarray(backsub(jnp.asarray(dxc)), np.float64)
    terms = np.asarray(jout[-1]["backsub_terms"](jnp.asarray(dxc)),
                       np.float64)
    per_lm = np.bincount(plan.obs_slot.numpy()[plan.live.numpy()],
                         minlength=want.shape[0])
    n = 3 + 1 + 7 * per_lm.max()
    err = np.abs(got.numpy() - want)
    assert np.all(err <= 2 * (n - 1) * 2.0 ** -24 * terms), \
        float((err / np.maximum(terms, 1e-30)).max())


@pytest.mark.parametrize("problem", ["recipe", "orbit"])
def test_pcg_cg_update_plain_matches_jax(problem):
    """K45's plain version on the JAX step's system against JAX's init and
    cg_body, each step from JAX's state and its S p (so that K45's own
    expressions are compared, not the CG's growth of earlier differences):
    x, r, p, rz and pAp within 1e-5 of each one's largest value, x, r and
    p exactly 0 at fixed poses; four steps."""
    r = _problem_of(problem)
    jout, _, plan, free, _ = _port_system(r, 1e-4)
    s_mv, init, cg_step = jout[1], jout[3], jout[4]
    sys = _jax_system(jout)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    st = ba_pcg.pcg_cg_update(sys.Minv, free, sys.rhs)
    jx, jr, jp, jrz = init()
    for it in range(5):
        for name, g, w in (("x", st.x, jx), ("r", st.r, jr), ("p", st.p, jp)):
            _close(g.numpy(), w, f"{name} (step {it})")
            _fixed_zero(g.numpy(), r["fixed"], f"{name} (step {it})")
        _close(st.scal[0].numpy(), jrz, f"rz (step {it})")
        if it == 4:
            break
        Ap = s_mv(jp)
        st = ba_pcg.pcg_cg_update(sys.Minv, free, t(jr), t(jx), t(jp), t(Ap),
                                  torch.stack([t(jrz), t(0.0)]))
        jx, jr, jp, jrz, jpAp, _ = cg_step(jx, jr, jp, jrz)
        _close(st.scal[1].numpy(), jpAp, f"pAp (step {it})")


def test_pcg_plan_orders():
    """pcg_plan on the recipe: every live observation once in each order,
    by landmark and by keyframe, stably by number, dead ones after the
    bounds."""
    r = _recipe()
    w = tba.BAWeights.from_config(tconfig.PlaneConfig())
    t = torch.from_numpy
    pb = tba._problem(t(r["lm0"]), t(r["pl0"]), *_tables(r, torch), w,
                      want_pairs=False)
    plan = ba_pcg.pcg_plan(pb)
    live = plan.live.numpy()
    n_live = int(live.sum())
    for order, start, key, n in (
            (plan.lm_order, plan.lm_start, plan.obs_slot, pb.M),
            (plan.kf_order, plan.kf_start, plan.obs_kf, 4)):
        order, start, key = order.numpy(), start.numpy(), key.numpy()
        assert start[0] == 0 and start[-1] == n_live and len(start) == n + 1
        for m in range(n):
            run = order[start[m]:start[m + 1]]
            assert (key[run] == m).all() and live[run].all()
            assert (np.diff(run) > 0).all()
        assert not live[order[n_live:]].any()
    # the planes' slots follow the points and line endpoints
    assert plan.obs_slot.numpy().max() == pb.P + 2
