"""Port parity of the similarity transforms (geometry/sim3.py), the Horn
RANSAC's triplet and refit modes and its similarity variant (K6's plain
versions), the PnP RANSAC's selection (K46's plain version) and the mutual
line matching (K47's plain version), each against the JAX package (JAX on
the CPU), at small sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import chip_smoke
from planarslam_tpu.config import SystemConfig as JConfig
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.geometry import sim3 as jsim3
from planarslam_tpu.io import synthetic
from planarslam_tpu.ops import lines as jlines
from planarslam_tpu.solvers import pnp as jpnp
from planarslam_tpu.solvers import sim3_solver as jsolver
from planarslam_tpu_torch.config import SystemConfig as TConfig
from planarslam_tpu_torch.geometry import sim3 as tsim3
from planarslam_tpu_torch.ops import lines as tlines
from planarslam_tpu_torch.solvers import pnp as tpnp
from planarslam_tpu_torch.solvers import sim3_solver as tsolver

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_sim3(rng, batch=()):
    R = Rotation.from_rotvec(rng.normal(0, 0.5, batch + (3,)).reshape(
        -1, 3)).as_matrix().reshape(batch + (3, 3)).astype(np.float32)
    t = rng.normal(0, 1, batch + (3,)).astype(np.float32)
    s = np.exp(rng.normal(0, 0.2, batch)).astype(np.float32)
    return R, t, s


def _close(got, want, atol=1e-5):
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("batch", [(), (5,)])
def test_sim3_functions_match_jax(batch):
    """Every function of geometry/sim3.py against JAX's, 1e-5 (float32):
    make, identity, apply, compose, inverse, exp, log (near the identity,
    as the pose graph uses them), from_se3 and to_se3."""
    rng = np.random.default_rng(3 + len(batch))
    R, t, s = _rand_sim3(rng, batch)
    R2, t2, s2 = _rand_sim3(rng, batch)
    S_j, S2_j = jsim3.make(R, t, s), jsim3.make(R2, t2, s2)
    S_t, S2_t = tsim3.make(_t(R), _t(t), _t(s)), tsim3.make(
        _t(R2), _t(t2), _t(s2))
    _close(tsim3.identity(device="cpu"), jsim3.identity())
    pts = rng.normal(0, 1, batch + (20, 3)).astype(np.float32)
    np.testing.assert_allclose(tsim3.apply(S_t, _t(pts)).numpy(),
                               np.asarray(jsim3.apply(S_j, pts)), atol=1e-5)
    _close(tsim3.compose(S_t, S2_t), jsim3.compose(S_j, S2_j))
    _close(tsim3.inverse(S_t), jsim3.inverse(S_j))
    xi = rng.normal(0, 0.1, batch + (7,)).astype(np.float32)
    _close(tsim3.exp(_t(xi)), jsim3.exp(jnp.asarray(xi)))
    small = jsim3.exp(jnp.asarray(xi))
    got = tsim3.log(tsim3.make(*[_t(np.asarray(small[k]))
                                  for k in ("R", "t", "s")]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsim3.log(small)),
                               atol=1e-5)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.3, batch + (6,)).astype(np.float32))))
    _close(tsim3.from_se3(_t(T)), jsim3.from_se3(T))
    _close(tsim3.from_se3(_t(T), _t(s)), jsim3.from_se3(T, s))
    np.testing.assert_allclose(tsim3.to_se3(S_t).numpy(),
                               np.asarray(jsim3.to_se3(S_j)), atol=1e-5)


def test_sim3_compose_inverse_case(rng):
    """tests/test_geometry.py::test_sim3_compose_inverse's case on both
    packages: the same points to 1e-5, and the identities it checks."""
    def rand_sim3():
        R = Rotation.from_rotvec(rng.normal(0, 0.5, 3)).as_matrix().astype(
            np.float32)
        return (R, rng.normal(0, 1, 3).astype(np.float32),
                np.float32(np.exp(rng.normal(0, 0.2))))

    (R1, t1, s1), (R2, t2, s2) = rand_sim3(), rand_sim3()
    pts = rng.normal(0, 1, (20, 3)).astype(np.float32)
    J1, J2 = jsim3.make(R1, t1, s1), jsim3.make(R2, t2, s2)
    T1 = tsim3.make(_t(R1), _t(t1), torch.tensor(s1))
    T2 = tsim3.make(_t(R2), _t(t2), torch.tensor(s2))
    P = _t(pts)
    out1 = tsim3.apply(T1, tsim3.apply(T2, P)).numpy()
    out2 = tsim3.apply(tsim3.compose(T1, T2), P).numpy()
    back = tsim3.apply(tsim3.inverse(T1), tsim3.apply(T1, P)).numpy()
    np.testing.assert_allclose(out1, out2, atol=1e-4)
    np.testing.assert_allclose(back, pts, atol=1e-4)
    np.testing.assert_allclose(out2, np.asarray(jsim3.apply(
        jsim3.compose(J1, J2), pts)), atol=1e-5)
    np.testing.assert_allclose(back, np.asarray(jsim3.apply(
        jsim3.inverse(J1), jsim3.apply(J1, pts))), atol=1e-5)


def _horn_problem(n, seed, scale=1.0, outliers=0.4):
    """n correspondences of a known similarity (1 cm noise), a share of
    outliers, padded to their bucket with valid = 0 (the JAX module's
    _pad_pair), the default_rng(7) triplets."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.3, 6).astype(np.float32))))
    dst = (scale * (src @ T[:3, :3].T) + T[:3, 3]
           + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    bad = rng.random(n) < outliers
    dst[bad] = rng.uniform(-3, 3, (int(bad.sum()), 3))
    return src, dst, jsolver._pad_pair(src, dst, 64)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("n", [40, 300, 2000])
def test_ransac_align_plain_matches_jax(n, with_scale):
    """_ransac_align_plain (K6's triplet and refit modes, plain) against
    JAX's _ransac_align on the padded buckets 64, 1024 and 4096 (valid = 0
    padding), with two triplets that repeat an index: inlier mask and count
    equal, R and t atol 1e-4, s 1e-4 relative. The triplet rows are JAX's
    weight rows bit for bit (a repeated index weighs 1)."""
    _, _, (s, d, v, picks) = _horn_problem(n, n, 1.3 if with_scale else 1.0)
    picks[3] = [picks[3, 0]] * 3
    picks[5, 1] = picks[5, 0]
    Rj, tj, sj, nj, ij = jsolver._ransac_align(
        s, d, v, picks, jnp.float32(0.08), with_scale=with_scale)
    row = tsolver._ransac_align_plain(_t(s), _t(d), _t(v), _t(picks), 0.08,
                                      with_scale)
    R, t, sc, n_inl, inl = tsolver.unpack_horn(row.numpy(), len(s))
    assert n_inl == int(nj) and n_inl > 0.5 * n
    np.testing.assert_array_equal(inl, np.asarray(ij))
    np.testing.assert_allclose(R, np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t, np.asarray(tj), atol=1e-4)
    assert abs(sc - float(sj)) <= 1e-4 * abs(float(sj))
    w_jax = np.stack([np.asarray(jnp.zeros((len(s),)).at[p].set(1.0) * v
                                 + 1e-9) for p in picks[:8]])
    w = tsolver.triplet_weights(_t(v), _t(picks[:8])).numpy()
    np.testing.assert_array_equal(w.view(np.int32), w_jax.view(np.int32))
    # the kernel path's composition on the CPU is the plain one
    assert torch.equal(tsolver._ransac_align(_t(s), _t(d), _t(v), _t(picks),
                                             0.08, with_scale), row)


def test_horn_refit_batched_lanes():
    """The triplet and refit wrappers at B = 3 on the CPU: each lane the
    lane's own problem."""
    probs = [_horn_problem(300, 10 + b)[2] for b in range(3)]
    stacked = [_t(np.stack([p[k] for p in probs])) for k in range(4)]
    out = tsolver.horn_triplets(*stacked, 0.08, True)
    rows = tsolver.horn_refit(*stacked[:3], out[3], out[4], 0.08, True)
    for b, p in enumerate(probs):
        want = tsolver._ransac_align_plain(*[_t(a) for a in p], 0.08, True)
        assert torch.equal(rows[b], want)


def test_horn_ransac_sim3_solvers_case(rng):
    """tests/test_solvers.py::test_horn_ransac_sim3's case: count and mask
    equal to JAX's, T atol 1e-4, s 1e-4 relative, and its own checks."""
    src = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    R = Rotation.from_rotvec([0.1, 0.2, -0.1]).as_matrix().astype(np.float32)
    dst = 1.4 * (src @ R.T) + np.array([0.1, 0.2, 0.3], np.float32)
    Tj, sj, nj, ij = jsolver.horn_ransac_sim3(src, dst)
    T, s, n_inl, inl = tsolver.horn_ransac_sim3(src, dst, device="cpu")
    assert n_inl == nj and n_inl >= 38 and abs(s - 1.4) < 0.02
    np.testing.assert_array_equal(inl, ij)
    np.testing.assert_allclose(T, Tj, atol=1e-4)
    assert abs(s - sj) <= 1e-4 * abs(sj)


@pytest.mark.parametrize("n", [40, 300, 2000])
def test_horn_ransac_sim3_matches_jax(n):
    """horn_ransac_sim3 on a seeded similarity (scale 0.7, 1 cm noise, 40%
    outliers) per padding bucket: count and mask equal, T atol 1e-4, s 1e-4
    relative."""
    src, dst, _ = _horn_problem(n, 100 + n, 0.7)
    Tj, sj, nj, ij = jsolver.horn_ransac_sim3(src, dst, threshold=0.08)
    T, s, n_inl, inl = tsolver.horn_ransac_sim3(src, dst, threshold=0.08,
                                                device="cpu")
    assert n_inl == nj and n_inl > 0.5 * n
    np.testing.assert_array_equal(inl, ij)
    np.testing.assert_allclose(T, Tj, atol=1e-4)
    assert abs(s - sj) <= 1e-4 * abs(sj)


def _pnp_problem(n, seed):
    """chip_smoke's K7 recipe at n correspondences (the default camera)."""
    return chip_smoke.pnp_problem(TConfig().camera, n, seed)


@pytest.mark.parametrize("n", [64, 256])
def test_pnp_select_plain_matches_jax(n):
    """K46's plain version fed JAX's scores and Ts (the hypo body of
    _pnp_ransac on the same seeded problem): the same best index and T as
    JAX's _pnp_ransac, and the same mask except where chi2 lies within
    2 (n - 1) 2^-24 of the gate (JAX's transform is a matrix product of
    another order), counted; the count is the mask's."""
    xw, uv_n, is2, valid, picks = _pnp_problem(n, n)
    gate = np.float32(5.991)
    jx, ju, js, jv = (jnp.asarray(a) for a in (xw, uv_n, is2, valid))

    def hypo(pick):
        T = jpnp._dlt_pose(jx[pick], ju[pick])
        pc = jse3.transform_points(T, jx)
        z = pc[:, 2]
        pred = pc[:, :2] / jnp.maximum(z, 1e-6)[:, None]
        chi2 = jnp.sum((pred - ju) ** 2, axis=-1) * js
        inl = (chi2 < gate) & (z > 0.05) & jv
        ok = jnp.all(jnp.isfinite(T))
        return jnp.where(ok, jnp.sum(inl), -1), T

    scores, Ts = jax.jit(jax.vmap(hypo))(jnp.asarray(picks))
    Tj, inl_j, score_j = jpnp._pnp_ransac(xw, uv_n, valid, is2, picks, gate)
    row = tpnp.pnp_select_plain(_t(xw), _t(uv_n), _t(is2), _t(valid),
                                _t(np.asarray(scores)), _t(np.asarray(Ts)),
                                5.991)
    T, inl, count = tpnp.unpack_pnp(row.numpy(), n)
    best = int(np.argmax(np.asarray(scores)))
    assert int(scores[best]) == int(score_j)
    np.testing.assert_array_equal(T, np.asarray(Ts)[best])
    np.testing.assert_array_equal(T, np.asarray(Tj))
    assert count == int(inl.sum()) and count > 0.6 * n
    # the flips: only where JAX's chi2 (float64 here) is at the gate
    pc = xw.astype(np.float64) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
    chi2 = (((pc[:, :2] / pc[:, 2:]) - uv_n) ** 2).sum(-1) * is2
    near = np.abs(chi2 - gate) <= 2 * (n - 1) * 2.0 ** -24 * gate
    flips = inl != np.asarray(inl_j)
    assert not (flips & ~near).any()
    assert flips.sum() <= near.sum()


def test_pnp_ransac_kernel_path_on_cpu():
    """pnp_ransac's composition (K7, K46, one packed row) on the CPU: the
    packed row's T, mask and count are _inliers of the best plain
    hypothesis."""
    xw, uv_n, is2, valid, picks = _pnp_problem(256, 5)
    args = [_t(a) for a in (xw, uv_n, is2, valid, picks)]
    scores, Ts = tpnp.pnp_dlt_hypotheses_plain(*args, 5.991)
    row = tpnp._pnp_ransac(args[0], args[1], args[3], args[2], args[4],
                           5.991)
    T, inl, count = tpnp.unpack_pnp(row.numpy(), 256)
    best = int(torch.argmax(scores))
    np.testing.assert_array_equal(T, Ts[best].numpy())
    want = tpnp._inliers(Ts[best][None], *args[:4], 5.991)[0].numpy()
    np.testing.assert_array_equal(inl, want)
    assert count == int(want.sum()) == int(scores[best])
    batched = tpnp.pnp_select(*[a[None] for a in args[:4]], scores[None],
                              Ts[None], 5.991)
    assert torch.equal(batched[0], row)


MATCH_CASES = ("frames", "mad_shift", "tie", "nan_desc", "no_valid",
               "angle_gate")


def _match_case(case):
    """The inputs of match_lines: desc_a, desc_b, valid_a, valid_b,
    angle_a, angle_b (numpy); the planted cases are chip_smoke's, at 24
    lines a frame."""
    if case == "frames":  # tests/test_lines.py: frames 0 and 1, tiny
        cfg = JConfig.tiny()
        seq = synthetic.make_sequence(n_frames=30, width=cfg.camera.width,
                                      height=cfg.camera.height)
        fs = []
        for i in (0, 1):
            g, d = seq.render(i)
            f = jlines.extract_line_features(jnp.asarray(g), jnp.asarray(d),
                                             cfg.camera, cfg.lines)
            fs.append(f)
        return tuple(np.asarray(x) for x in (
            fs[0].desc, fs[1].desc, fs[0].valid, fs[1].valid, fs[0].angle,
            fs[1].angle))
    return chip_smoke.planted_match_problem(case, n=24)


def _near_flip(a, b, va, vb, aa, ab, row, got_best):
    """Whether a row's decision is within the rounding of two orders of
    its 72-term sums (2 (D - 1) 2^-24 of the sum of |terms|): its best
    against its second, the ratio test's edge, or its best segment's
    column against another row."""
    D = a.shape[1]
    tol = 2 * (D - 1) * 2.0 ** -24 * float(np.abs(a[row]).max()) * D
    s = a.astype(np.float64) @ b.T.astype(np.float64)
    d = np.abs(aa[:, None] - ab[None])
    d = np.minimum(d, np.pi - d)
    gate = va[:, None] & vb[None] & (d < 0.26)
    s = np.where(gate, s, -1.0)
    top = np.sort(s[row])[::-1]
    j = int(np.argmax(s[row]))
    col = np.sort(s[:, j])[::-1]
    edges = [top[0] - top[1], col[0] - col[1],
             (1 - top[0]) - (0.85 * (1 - top[1]) + 1e-9)]
    return min(abs(e) for e in edges) <= tol


@pytest.mark.parametrize("case", MATCH_CASES)
def test_match_lines_plain_matches_jax(case):
    """match_lines_plain (K47's plain version) against JAX's match_lines:
    tests/test_lines.py's two cases (frames 0 and 1 of the tiny synthetic
    sequence, the MAD-shifted pair), a planted tie, NaN descriptors, no
    valid line, angles at the 0.26 gate. idx exact (a flip only where a
    decision lies within the rounding of two orders of the sums,
    counted), best atol 1e-5 (NaN where JAX's is NaN)."""
    args = _match_case(case)
    idx_j, best_j = jlines.match_lines(*[jnp.asarray(x) for x in args])
    idx_j, best_j = np.asarray(idx_j), np.asarray(best_j)
    idx, best = tlines.match_lines_plain(*[_t(x) for x in args])
    idx, best = idx.numpy(), best.numpy()
    np.testing.assert_allclose(best, best_j, rtol=0, atol=1e-5)
    flips = np.flatnonzero(idx != idx_j)
    assert all(_near_flip(*args, r, best) for r in flips), (case, flips)
    assert len(flips) <= 1, (case, flips)
    if case == "frames":
        assert (idx >= 0).sum() >= 3
    if case == "mad_shift":
        assert (idx == np.arange(len(idx))).sum() >= len(idx) - 4
    if case == "no_valid":
        assert (idx == -1).all() and (best == -1).all()
    if case == "tie":  # row 7 repeats row 3: only row 3 keeps its match
        assert idx[7] == -1 and idx[3] == 3
    # the wrapper and the batched form on the CPU are the plain version
    w_idx, w_best = tlines.match_lines(*[_t(x) for x in args])
    assert np.array_equal(w_idx.numpy(), idx)
    b_idx, _ = tlines.match_lines(*[_t(np.stack([x, x])) for x in args])
    assert np.array_equal(b_idx.numpy(), np.stack([idx, idx]))
