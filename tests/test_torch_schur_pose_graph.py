"""Port parity of the loop correction's Schur complement (K40) and the pose
graph's Gauss-Newton step (K10 with the gauge diagonal, K41): the plain
versions against the JAX package's expressions on the CPU, K40's pair plan
against a numpy reference of the dense product's nonzero blocks, and a
float32 emulation of K40's summation order held to the dense product.
Inputs come from a numpy seed (chip_smoke's planted problems, at 16
keyframes); every tolerance is stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (UPDATE_PLANTED, complement_bound,
                        complement_emulation, planted_schur_problem,
                        planted_update_steps, schur_plan, schur_step)
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu_torch.solvers import ba_core
from planarslam_tpu_torch.solvers import pose_graph as tpg

torch.set_num_threads(2)

def _step(case, seed=40):
    return schur_step(planted_schur_problem(case, "cpu", seed=seed))


def _jax_blocks(st):
    """The JAX expression of ba_core.py:470 on the port's operands (JAX
    lays Hcp out (Kt, M, 6, 3)), as the port's (6 Kt, 6 Kt) S = -S_blocks
    with rows (k, i) and columns (q, m)."""
    a = jnp.asarray(st["HcpHinv"].numpy().transpose(0, 2, 1, 3))
    b = jnp.asarray(st["Hcp"].numpy().transpose(0, 2, 1, 3))
    blocks = np.asarray(jnp.einsum("kpil,qpml->kqim", a, b))
    Kt = blocks.shape[0]
    return -blocks.transpose(0, 2, 1, 3).reshape(Kt * 6, Kt * 6)


def _reference_pairs(pb):
    """numpy: the keyframes each table's live observations tie to each
    landmark (points and line endpoints at their slot, planes at P +
    slot), and the keyframe pairs that share one."""
    Kt, M, P = pb.pt.slot.shape[0], pb.M, pb.P
    inc = np.zeros((Kt, M), bool)
    tables = [(pb.pt.slot, pb.pt.mask, 0), (pb.ln.slot, pb.ln.mask, 0)]
    if pb.Q:
        tables += [(s, m, P) for s, m in zip(pb.pl_slots, pb.masks[2:])]
    for slot, mask, off in tables:
        for k, row in enumerate(slot.numpy()):
            live = mask.numpy()[k] > 0
            inc[k, row[live] + off] = True
    return inc, (inc.astype(np.int64) @ inc.T.astype(np.int64)) > 0


def _nonzero_blocks(S):
    Kt = S.shape[0] // 6
    return np.abs(S.reshape(Kt, 6, Kt, 6)).max(axis=(1, 3)) > 0


@pytest.mark.parametrize("batched", [False, True])
def test_complement_plain_matches_jax(batched):
    """(a) ba_schur_complement_plain against JAX's einsum of ba_core.py:470
    on the same HcpHinv and Hcp (the first LM step of a planted problem):
    each entry within 2 (n - 1) 2^-24 of the sum of its |terms|, n = 3M
    (both sum over every landmark); with a batch of two, each lane equal
    to its own product."""
    sts = [_step("random", 40 + b) for b in range(2 if batched else 1)]
    if batched:
        got = ba_core.ba_schur_complement_plain(
            torch.stack([st["HcpHinv"] for st in sts]),
            torch.stack([st["Hcp"] for st in sts]))
        for b, st in enumerate(sts):
            np.testing.assert_array_equal(
                got[b].numpy(), ba_core.ba_schur_complement_plain(
                    st["HcpHinv"], st["Hcp"]).numpy())
    for st in sts:
        S = ba_core.ba_schur_complement_plain(st["HcpHinv"],
                                              st["Hcp"]).numpy()
        want = _jax_blocks(st)
        Kt, M = st["Hcp"].shape[0], st["Hcp"].shape[2]
        terms = (np.abs(st["HcpHinv"].numpy().astype(np.float64))
                 .reshape(Kt * 6, M * 3)
                 @ np.abs(st["Hcp"].numpy().astype(np.float64))
                 .reshape(Kt * 6, M * 3).T)
        bound = 2 * (3 * M - 1) * 2.0 ** -24 * terms
        assert np.all(np.abs(S.astype(np.float64) - want) <= bound)
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("case", ["random", "empty_keyframe", "seen_twice",
                                  "planes_everywhere", "batch2"])
def test_pair_plan_matches_dense_blocks(case):
    """(b) K40's pair plan against numpy: its incidence is the tables' live
    (keyframe, landmark) pairs (a landmark seen twice by one keyframe set
    once, a keyframe with no observation empty, the plane tables at P +
    slot), and its pairs are exactly the nonzero 6 x 6 blocks of the dense
    product; "batch2" builds the plan of two problems in one call, each
    lane its own plan."""
    seeds = (40, 41) if case == "batch2" else (40,)
    name = "random" if case == "batch2" else case
    sts = [_step(name, s) for s in seeds]
    plan = schur_plan([st["pb"] for st in sts])
    for b, st in enumerate(sts):
        pb = st["pb"]
        lane = ba_core.PairPlan(plan.bits[b], plan.counts[b]) \
            if len(sts) > 1 else plan
        if len(sts) > 1:
            own = schur_plan([pb])
            np.testing.assert_array_equal(lane.bits.numpy(),
                                          own.bits.numpy())
            np.testing.assert_array_equal(lane.counts.numpy(),
                                          own.counts.numpy())
        inc = ba_core.plan_incidence(lane, pb.M).numpy()
        want_inc, want_pairs = _reference_pairs(pb)
        np.testing.assert_array_equal(inc, want_inc)
        np.testing.assert_array_equal(lane.counts.numpy(), want_inc.sum(1))
        S = ba_core.ba_schur_complement_plain(st["HcpHinv"],
                                              st["Hcp"]).numpy()
        np.testing.assert_array_equal(want_pairs, _nonzero_blocks(S))
        if case == "empty_keyframe":
            assert not inc[3].any() and not want_pairs[3].any()
        if case == "seen_twice":
            assert inc[1, 7] and list(pb.pt.slot[1, :2].numpy()) == [7, 7]
        if case == "planes_everywhere":
            assert inc[:, pb.P:].all() and want_pairs.all()
        assert want_pairs.any()


@pytest.mark.parametrize("case", ["random", "single_view", "odd_m",
                                  "empty_keyframe"])
def test_complement_order_emulation(case):
    """(c) An emulation of K40's order (chip_smoke.complement_emulation:
    per entry the shared landmarks ascending, the three products fused
    into the float32 entry in turn) against the dense product:
    each entry within 2 (n - 1) 2^-24 of the sum of its |terms|, n its
    terms (3 per shared landmark), the blocks of pairs that share nothing
    exactly 0 in both."""
    st = _step(case)
    pb = st["pb"]
    plan = schur_plan([pb])
    inc = ba_core.plan_incidence(plan, pb.M)
    got = complement_emulation(st["HcpHinv"].numpy(), st["Hcp"].numpy(),
                               inc.numpy())
    want = ba_core.ba_schur_complement_plain(st["HcpHinv"], st["Hcp"])
    bound, shared = complement_bound(st["HcpHinv"], st["Hcp"], inc)
    err = np.abs(got.astype(np.float64) - want.double().numpy())
    assert np.all(err <= bound.numpy())
    alone = np.repeat(np.repeat(shared.numpy() == 0, 6, 0), 6, 1)
    assert np.all(got[alone] == 0) and np.all(want.numpy()[alone] == 0)
    if case == "single_view":
        assert int(inc[:, 5].sum()) == 1 and bool(inc[2, 5])
    if case == "odd_m":
        assert pb.M % 32 != 0
    if case == "empty_keyframe":
        assert alone[18:24].all() and alone[:, 18:24].all()


def _graph(rng, n=7, E=20):
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        xi = rng.normal(0, 0.2, 6).astype(np.float32)
        poses.append(np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ poses[-1])
    poses = np.stack(poses).astype(np.float32)
    ij = np.stack([rng.choice(n - 1, 2, replace=False) for _ in range(E)])
    ij = ij.astype(np.int32)   # node n - 1 has no edge
    meas = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.05, 6).astype(np.float32)))) @ poses[i]
        @ np.linalg.inv(poses[j]) for i, j in ij]).astype(np.float32)
    w = rng.uniform(0.5, 5.0, E).astype(np.float32)
    return poses, ij, meas, w


@pytest.mark.parametrize("fixed_nodes", [(0,), (2, 5)])
def test_normal_eqs_gauge_diagonal_matches_jax(fixed_nodes):
    """(d) K10's plain version with the gauge diagonal against JAX's H +
    diag(diag_fix) (pose_graph.py:61-72) built from jax.jacfwd's edge
    blocks: JAX's diag_fix and the port's are equal bit for bit, the
    port's H is its H without the diagonal plus diag_fix (float32 adds),
    and it lies within 1e-4 of the largest magnitude of JAX's H without
    the diagonal (as test_pose_graph_normal_eqs_plain_matches_jacfwd holds
    it) plus 2^-23 of each entry (the rounding at 1e8); a node without an
    edge has H = diag_fix and g = 0."""
    rng = np.random.default_rng(sum(fixed_nodes))
    poses, ij, meas, w = _graph(rng)
    n = poses.shape[0]
    fixed = np.zeros(n, np.float32)
    fixed[list(fixed_nodes)] = 1.0
    m_inv = np.linalg.inv(meas).astype(np.float32)

    def edge_res(xi_i, xi_j, Ti, Tj, mi, we):
        rel = (jse3.se3_exp(xi_i) @ Ti) @ jse3.T_inv(jse3.se3_exp(xi_j) @ Tj)
        return jse3.se3_log(mi @ rel) * we

    z = jnp.zeros(6, jnp.float32)
    _, (Ji, Jj) = jax.vmap(lambda a, b, c, d: (
        edge_res(z, z, a, b, c, d),
        jax.jacfwd(edge_res, argnums=(0, 1))(z, z, a, b, c, d)))(
        jnp.asarray(poses[ij[:, 0]]), jnp.asarray(poses[ij[:, 1]]),
        jnp.asarray(m_inv), jnp.asarray(w))
    Hb = np.zeros((n, n, 6, 6))
    for e, (a, b) in enumerate(ij):
        for p, q, A, B in ((a, a, Ji, Ji), (b, b, Jj, Jj), (a, b, Ji, Jj),
                           (b, a, Jj, Ji)):
            Hb[p, q] += np.asarray(A[e]).T.astype(np.float64) @ np.asarray(
                B[e])
    H_jax = Hb.transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    diag_fix = np.asarray(jnp.repeat(jnp.asarray(fixed), 6) * 1e8 + 1e-6)
    t = torch.from_numpy
    port_fix = tpg._gauge_diagonal(t(fixed)).numpy()
    np.testing.assert_array_equal(port_fix, diag_fix)
    args = (t(poses), t(ij), t(m_inv), t(w))
    H, g = tpg.pose_graph_normal_eqs_plain(*args, fixed_mask=t(fixed))
    H0, g0 = tpg.pose_graph_normal_eqs_plain(*args)
    np.testing.assert_array_equal(H.numpy(), H0.numpy() + np.diag(diag_fix))
    np.testing.assert_array_equal(g.numpy(), g0.numpy())
    want = H_jax + np.diag(diag_fix.astype(np.float64))
    tol = 1e-4 * np.abs(H_jax).max() + 2.0 ** -23 * np.abs(want)
    assert np.all(np.abs(H.numpy() - want) <= tol)
    last = slice(6 * (n - 1), 6 * n)
    np.testing.assert_array_equal(H.numpy()[last, last],
                                  np.diag(diag_fix[last]))
    assert not g.numpy()[last].any()
    # the wrapper on CPU tensors is the plain version
    Hw, _ = tpg.pose_graph_normal_eqs(*args, tpg.edge_plan(ij, n, "cpu"),
                                      fixed_mask=t(fixed))
    np.testing.assert_array_equal(Hw.numpy(), H.numpy())


@pytest.mark.parametrize("case", UPDATE_PLANTED[:4] + ("random",))
def test_pose_update_matches_jax(case):
    """(e) pose_graph_update_plain (se3_exp(-step) poses) against the JAX
    package's jax.vmap(se3.se3_exp)(dx) @ poses with dx = -step
    (pose_graph.py:75), on chip_smoke's planted steps: zero, theta^2 at
    0.99 and 1.01 of the small-angle threshold 1e-8 (the Taylor branch
    and the closed form), rotations near pi, and random steps of 0.05:
    entries within 1e-6 of max(1, |entry|)."""
    rng = np.random.default_rng(7)
    N = 9
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.8, 6).astype(np.float32)))) for _ in range(N)])
    poses = poses.astype(np.float32)
    if case == "random":
        step = rng.normal(0, 0.05, (N, 6)).astype(np.float32)
    else:
        step = planted_update_steps(case, N)
    got = tpg.pose_graph_update_plain(torch.from_numpy(poses),
                                      torch.from_numpy(step)).numpy()
    want = np.asarray(jax.vmap(jse3.se3_exp)(jnp.asarray(-step))
                      @ jnp.asarray(poses))
    assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0,
                                                          np.abs(want)))
    th2 = np.sum(step[:, 3:].astype(np.float64) ** 2, axis=1)
    if case == "below_threshold":
        assert np.all(th2 < 1e-8)
    if case == "above_threshold":
        assert np.all(th2 > 1e-8)
    # the wrapper on CPU tensors is the plain version, with any batch
    both = tpg.pose_graph_update(torch.from_numpy(np.stack([poses] * 2)),
                                 torch.from_numpy(np.stack([step] * 2)))
    np.testing.assert_array_equal(both[1].numpy(), got)
