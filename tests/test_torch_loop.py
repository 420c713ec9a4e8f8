"""Port parity of loop closing: K10's plain version against jax.jacfwd of
the JAX edge residual, the pose-graph solve on the recipes of
tests/test_solvers.py and tests/test_reloc_loop.py, refine_relative_se3,
and loop verification and correction on the constructed loop of
test_loop_verify_and_correct_constructed, each against the JAX package on
the same inputs (JAX on the CPU).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from chip_smoke import construct_loop
from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam.map import SlamMap as JMap
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu.solvers import global_ba as jgba
from planarslam_tpu.solvers import pose_graph as jpg
from planarslam_tpu.solvers.sim3_solver import \
    refine_relative_se3 as j_refine
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.slam.device_tracker import (loop_closer_from_numpy,
                                                      map_from_numpy)
from planarslam_tpu_torch.solvers import global_ba as tgba
from planarslam_tpu_torch.solvers import pose_graph as tpg
from planarslam_tpu_torch.solvers.sim3_solver import \
    refine_relative_se3 as t_refine

torch.set_num_threads(2)


def _se3(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _edges(kind, rng, n=6, E=24):
    """Seeded poses and edges: measurements within 1e-6 of the current
    relative ("near_identity", where so3_log takes its small-angle branch),
    0.3 rad off it ("moderate"), or moderate with every pair repeated with
    another measurement ("duplicated")."""
    poses = np.stack([_se3(rng.normal(0, 0.8, 6)) for _ in range(n)])
    ij = np.stack([rng.choice(n, 2, replace=False) for _ in range(E)])
    noise = 1e-6 if kind == "near_identity" else 0.3
    meas = np.stack([_se3(rng.normal(0, noise, 6)) @ poses[i]
                     @ np.linalg.inv(poses[j]) for i, j in ij])
    w = rng.uniform(0.5, 5.0, E).astype(np.float32)
    if kind == "duplicated":
        ij = np.concatenate([ij, ij])
        meas = np.concatenate([meas, np.stack(
            [_se3(rng.normal(0, 0.3, 6)) @ m for m in meas])])
        w = np.concatenate([w, w[::-1]])
    return (poses.astype(np.float32), ij.astype(np.int32),
            meas.astype(np.float32), w)


@pytest.mark.parametrize("kind", ["near_identity", "moderate", "duplicated"])
def test_pose_graph_normal_eqs_plain_matches_jacfwd(kind):
    """K10's plain version: the analytic edge Jacobians against jax.jacfwd
    of the JAX edge_res (pose_graph.py:44-46) atol 2e-3 x w (JAX float32
    forward mode against the port's float64), residuals atol 1e-4 x w, and
    H and g against the JAX block assembly (pose_graph.py:61-70) of the
    same Jacobians within 1e-4 of their largest magnitude."""
    rng = np.random.default_rng({"near_identity": 0, "moderate": 1,
                                 "duplicated": 2}[kind])
    poses, ij, meas, w = _edges(kind, rng)
    n = poses.shape[0]
    m_inv = np.linalg.inv(meas).astype(np.float32)

    def edge_res(xi_i, xi_j, Ti, Tj, mi, we):
        rel = (jse3.se3_exp(xi_i) @ Ti) @ jse3.T_inv(jse3.se3_exp(xi_j) @ Tj)
        return jse3.se3_log(mi @ rel) * we

    z = jnp.zeros(6, jnp.float32)
    jr, (jJi, jJj) = jax.vmap(lambda a, b, c, d: (
        edge_res(z, z, a, b, c, d),
        jax.jacfwd(edge_res, argnums=(0, 1))(z, z, a, b, c, d)))(
        jnp.asarray(poses[ij[:, 0]]), jnp.asarray(poses[ij[:, 1]]),
        jnp.asarray(m_inv), jnp.asarray(w))
    t = torch.from_numpy
    r, Ji, Jj = tpg.edge_terms(t(poses), t(ij[:, 0]), t(ij[:, 1]), t(m_inv),
                               t(w))
    ww = w[:, None, None].astype(np.float64)
    assert np.all(np.abs(r.numpy() - np.asarray(jr)) <= 1e-4 * ww[:, 0])
    assert np.all(np.abs(Ji.numpy() - np.asarray(jJi)) <= 2e-3 * ww)
    assert np.all(np.abs(Jj.numpy() - np.asarray(jJj)) <= 2e-3 * ww)

    H, g = tpg.pose_graph_normal_eqs(t(poses), t(ij), t(m_inv), t(w),
                                     tpg.edge_plan(ij, n, device="cpu"))
    Hb = np.zeros((n, n, 6, 6))
    gb = np.zeros((n, 6))
    Ji64, Jj64, r64 = (x.numpy() for x in (Ji, Jj, r))
    for e, (a, b) in enumerate(ij):
        for p, q, A, B in ((a, a, Ji64, Ji64), (b, b, Jj64, Jj64),
                           (a, b, Ji64, Jj64), (b, a, Jj64, Ji64)):
            Hb[p, q] += A[e].T @ B[e]
        gb[a] += Ji64[e].T @ r64[e]
        gb[b] += Jj64[e].T @ r64[e]
    H_want = Hb.transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    assert np.abs(H.numpy() - H_want).max() <= 1e-4 * np.abs(H_want).max()
    assert np.abs(g.numpy() - gb.reshape(-1)).max() <= \
        1e-4 * np.abs(gb).max()


def test_optimize_matches_jax(rng):
    """_optimize on the drifted 8-pose circle of
    test_solvers.test_pose_graph_closes_loop: poses atol 1e-4 against the
    JAX solve, and the loop residual under that test's 0.02."""
    n = 8
    gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_euler("y", ang).as_matrix()
        T[:3, 3] = [np.sin(ang), 0.0, 1 - np.cos(ang)]
        gt.append(np.linalg.inv(T).astype(np.float32))
    gt = np.stack(gt)
    est = gt.copy()
    for i in range(1, n):
        est[i] = _se3(rng.normal(0, 0.02 * i, 6) * 0.4) @ est[i]
    edges = [(i, i - 1) for i in range(1, n)] + [(n - 1, 0)]
    meas = [est[i] @ np.linalg.inv(est[i - 1]) for i in range(1, n)]
    meas.append(gt[n - 1] @ np.linalg.inv(gt[0]))
    w = np.array([1.0] * (n - 1) + [5.0], np.float32)
    fixed = np.zeros(n, np.float32)
    fixed[0] = 1.0
    e_ij = np.array(edges, np.int32)
    meas = np.stack(meas).astype(np.float32)
    want = np.asarray(jpg._optimize(jnp.asarray(est), jnp.asarray(e_ij),
                                    jnp.asarray(meas), jnp.asarray(w),
                                    jnp.asarray(fixed)))
    t = torch.from_numpy
    got = tpg._optimize(t(est), t(e_ij), t(meas), t(w), t(fixed)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    rel = got[n - 1] @ np.linalg.inv(got[0])
    err = np.asarray(jse3.se3_log(jnp.asarray(
        (np.linalg.inv(gt[n - 1] @ np.linalg.inv(gt[0])) @ rel
         ).astype(np.float32))))
    assert np.linalg.norm(err) < 0.02


def test_loop_edges_persist_matches_jax():
    """optimize_pose_graph over the two-loop arc of
    test_reloc_loop.test_loop_edges_persist_across_corrections, on copies
    of one map: both corrections atol 1e-4 against the JAX results, and
    the persisted 8 <-> 0 edge held under that test's 0.03."""
    cfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    jm = JMap(cfg)
    n = 10
    gt = []
    for k in range(n):
        gt.append(_se3([0.02 * k, -0.01 * k, 0.015 * k, 0.2 * k, 0.05 * k,
                        0.0]))
        kf = jm.alloc_keyframe()
        jm.kf_valid[kf] = True
        jm.kf_pose[kf] = gt[k]
        jm.kf_parent[kf] = kf - 1 if kf > 0 else -1

    def rel_gt(a, b):
        return (gt[a] @ np.linalg.inv(gt[b])).astype(np.float32)

    tm = map_from_numpy(jm, tcfg)
    drift = _se3([0.0, 0.0, 0.0, 0.12, -0.08, 0.1])
    for (a, b), then_drift in (((8, 0), True), ((9, 1), False)):
        for m, opt, c, kw in ((jm, jpg.optimize_pose_graph, cfg, {}),
                              (tm, tpg.optimize_pose_graph, tcfg,
                               {"device": "cpu"})):
            m.add_loop_edge(a, b, rel_gt(a, b))
            m.kf_pose[:n] = opt(m, kf_corrected=a,
                                T_corrected=rel_gt(a, b) @ m.kf_pose[b],
                                loop_kf=b, cfg=c, **kw)[:n]
            if then_drift:
                for k in range(5, n):
                    m.kf_pose[k] = (drift @ m.kf_pose[k]).astype(np.float32)
        np.testing.assert_allclose(tm.kf_pose[:n], jm.kf_pose[:n], atol=1e-4)
    rel_after = tm.kf_pose[8] @ np.linalg.inv(tm.kf_pose[0])
    err = np.asarray(jse3.se3_log(jnp.asarray(
        (np.linalg.inv(rel_gt(8, 0)) @ rel_after).astype(np.float32))))
    assert np.linalg.norm(err) < 0.03


def test_refine_relative_se3_matches_jax():
    """refine_relative_se3 on 200 seeded correspondences (0.5 px noise, 10%
    outliers 30 px off, 1 cm / 0.01 rad start error): T atol 1e-5 against
    the JAX refinement, and closer to the truth than the start."""
    rng = np.random.default_rng(1)
    K = (300.0, 310.0, 160.0, 120.0)
    n = 200
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    T = _se3(rng.normal(0, 0.05, 6))
    p1 = (p2 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    def proj(p):
        return np.stack([K[0] * p[:, 0] / p[:, 2] + K[2],
                         K[1] * p[:, 1] / p[:, 2] + K[3]], -1)

    uv1 = (proj(p1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(p2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv1[:20] += 30.0
    T0 = _se3(rng.normal(0, 0.01, 6)) @ T
    v = np.ones(n, np.float32)
    Tj, _ = j_refine(T0.astype(np.float32), p1, p2, uv1, uv2, v, K)
    Tt, s = t_refine(T0, p1, p2, uv1, uv2, v, K, device="cpu")
    np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-5)
    assert s == 1.0
    assert np.abs(Tt - T).max() < np.abs(T0 - T).max()


@pytest.fixture(scope="module")
def constructed_loop():
    """The map and loop closer of test_loop_verify_and_correct_constructed:
    the JAX System tracks 16 frames; chip_smoke.construct_loop adds a
    current keyframe that copies KF0's snapshot with an injected drift and
    cloned landmarks."""
    cfg = jconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(16, width=cfg.camera.width,
                                  height=cfg.camera.height)
    slam = JSystem(config=cfg, enable_loop_closing=True)
    for i in range(len(seq)):
        slam.track_rgbd(*seq.render(i), seq.timestamps[i])
    assert slam.map.n_kf >= 3
    kf, n_clones, _ = construct_loop(slam.map, src=0)
    return slam.loop_closer, kf, 0, n_clones


@pytest.mark.parametrize("run_gba", [False, True])
def test_verify_and_correct_matches_jax(constructed_loop, run_gba,
                                        monkeypatch):
    """_verify_and_correct on copies of the constructed loop, GBA off and
    on (GBA caps of both packages cut to the same 16 keyframes, 2048
    points, 64 lines, 16 planes, which hold the whole map): both verify;
    corrected poses atol 1e-4 without GBA and 5e-3 with it; pt_valid,
    kf_pt_idx and last_fuse_count equal; the drift shrinks below 0.4 of its
    size and >= 0.3 of the clones fuse, as the JAX test asks."""
    for mod in (jgba, tgba):
        monkeypatch.setattr(mod, "MAX_GBA_KF", 16)
        monkeypatch.setattr(mod, "MAX_GBA_PTS", 2048)
        monkeypatch.setattr(mod, "MAX_GBA_LNS", 64)
        monkeypatch.setattr(mod, "MAX_GBA_PLS", 16)
    src_lc, kf, src, n_clones = constructed_loop
    jm = copy.deepcopy(src_lc.map)
    tm = map_from_numpy(jm, tconfig.SystemConfig.tiny())
    jlc = copy.copy(src_lc)
    jlc.map, jlc.run_gba = jm, run_gba
    tlc = loop_closer_from_numpy(jlc, tconfig.SystemConfig.tiny(), tm,
                                 device="cpu")
    pose_before = jm.kf_pose[kf].copy()
    n_valid = int(jm.pt_valid.sum())
    assert jlc._verify_and_correct(kf, src)
    assert tlc._verify_and_correct(kf, src)
    n = jm.n_kf
    np.testing.assert_allclose(tm.kf_pose[:n], jm.kf_pose[:n],
                               atol=5e-3 if run_gba else 1e-4)
    np.testing.assert_array_equal(tm.pt_valid, jm.pt_valid)
    np.testing.assert_array_equal(tm.kf_pt_idx, jm.kf_pt_idx)
    assert tlc.last_fuse_count == jlc.last_fuse_count > 0
    assert tlc.stats["pose_graphs"] == 1
    assert tlc.stats["gba_calls"] == int(run_gba)
    if not run_gba:
        delta = np.linalg.norm(tm.kf_pose[kf][:3, 3] - tm.kf_pose[src][:3, 3])
        drift = np.linalg.norm(pose_before[:3, 3] - tm.kf_pose[src][:3, 3])
        assert delta < 0.4 * drift
    assert n_valid - int(tm.pt_valid.sum()) >= 0.3 * n_clones
