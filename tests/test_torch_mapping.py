"""Port parity of local mapping: the two-view triangulation (K5's plain
version), the keyframe mapping step, LocalMapping.process_keyframe and the
System with local mapping on, each against the JAX package on the same
inputs (JAX on the CPU). One JAX System run over the tiny 16-frame sequence
is shared by the tests of this module.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planarslam_tpu import config as jconfig
from planarslam_tpu.evaluation.ate import ate_rmse
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam import device_mapper as jdm
from planarslam_tpu.slam.local_mapping import LocalMapping as JLocalMapping
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.io.frames import quantize_frame
from planarslam_tpu_torch.slam import device_mapper as tdm
from planarslam_tpu_torch.slam.device_tracker import map_from_numpy
from planarslam_tpu_torch.slam.local_mapping import LocalMapping
from planarslam_tpu_torch.slam.system import System as TSystem
from planarslam_tpu_torch.solvers.triangulation import \
    triangulate_two_view_plain

torch.set_num_threads(2)

N_FRAMES = 16


@pytest.fixture(scope="module")
def run():
    """The JAX System (local mapping on, loop closing off) over the tiny
    sequence, recording every mapping step's packed input and output."""
    cfg = jconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(N_FRAMES, width=160, height=120)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(N_FRAMES)]
    steps = []
    orig = jdm.mapping_step_packed

    def recording(flat, cfg_):
        out = orig(flat, cfg_)
        steps.append((np.asarray(flat), np.asarray(out)))
        return out

    jdm.mapping_step_packed = recording
    try:
        slam = JSystem(config=cfg, enable_loop_closing=False)
        for i, (g, d) in enumerate(frames):
            slam.track_rgbd(g, d, seq.timestamps[i])
        poses = slam.frame_poses_wc()
    finally:
        jdm.mapping_step_packed = orig
    return {"seq": seq, "frames": frames, "poses": poses, "slam": slam,
            "steps": steps}


def _jax_tri_one(own_T, nb_T, own_uv, uv2, level1, level2, has, K, sf):
    """The JAX package's inline tri_one math (device_mapper.py:125-167),
    per pair, as written there."""
    fx, fy, cx, cy = K
    Kmat = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)
    own_T = jnp.asarray(own_T)
    P1 = Kmat @ own_T[:3]
    Xs, goods = [], []
    for i in range(nb_T.shape[0]):
        T = jnp.asarray(nb_T[i])
        P2 = Kmat @ T[:3]
        u1, u2 = jnp.asarray(own_uv), jnp.asarray(uv2[i])
        A = jnp.stack([u1[:, 0:1] * P1[2] - P1[0], u1[:, 1:2] * P1[2] - P1[1],
                       u2[:, 0:1] * P2[2] - P2[0], u2[:, 1:2] * P2[2] - P2[1]],
                      axis=1)
        Xh = jnp.linalg.svd(A)[2][:, -1]
        w = Xh[:, 3]
        X = Xh[:, :3] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)[:, None]
        finite = jnp.all(jnp.isfinite(X), axis=-1)

        def gate(Tc, uvp, inv_s2):
            pc = X @ Tc[:3, :3].T + Tc[:3, 3]
            z = pc[:, 2]
            u = fx * pc[:, 0] / jnp.maximum(z, 1e-9) + cx
            v = fy * pc[:, 1] / jnp.maximum(z, 1e-9) + cy
            err = ((u - uvp[:, 0]) ** 2 + (v - uvp[:, 1]) ** 2) * inv_s2
            return (z > 0.05) & (err < 5.991)

        s2a = jnp.power(jnp.float32(sf), -2.0 * jnp.asarray(level1, jnp.float32))
        s2b = jnp.power(jnp.float32(sf),
                        -2.0 * jnp.asarray(level2[i], jnp.float32))
        good = (jnp.asarray(has[i]) & finite & gate(own_T, u1, s2a)
                & gate(T, u2, s2b))
        Xs.append(np.asarray(X))
        goods.append(np.asarray(good))
    return np.stack(Xs), np.stack(goods)


def test_triangulate_two_view_plain_matches_jax():
    """K5's plain version against the JAX tri_one math on seeded pairs
    (points 2-8 m away seen from an own pose and 5 neighbours 0.05-0.5 m
    away, 0.5 px noise, 10% outliers): good equal on >= 99% of pairs; where
    good in both, X relative error <= 1e-4 on 99% of pairs and <= 5e-3 on
    all. The JAX side solves in float32, which keeps few digits at the
    shortest baselines; the port solves in float64 and matches a numpy
    float64 DLT to 1e-6 relative."""
    cfg = jconfig.SystemConfig.tiny()
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    rng = np.random.default_rng(3)
    NB, Kp = 5, 256
    X = np.stack([rng.uniform(-3, 3, Kp), rng.uniform(-2, 2, Kp),
                  rng.uniform(2, 8, Kp)], -1)
    own_T = np.eye(4, dtype=np.float32)
    nb_T = np.tile(np.eye(4, dtype=np.float32), (NB, 1, 1))
    for i in range(NB):
        a = rng.normal(0, 0.05, 3)
        c, s = np.cos(a[1]), np.sin(a[1])
        nb_T[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        d = rng.normal(0, 1, 3)
        nb_T[i, :3, 3] = (0.05 + 0.45 * rng.random()) * d / np.linalg.norm(d)

    def project(T, P):
        pc = P @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)

    own_uv = (project(own_T, X) + rng.normal(0, 0.5, (Kp, 2))).astype(
        np.float32)
    uv2 = np.stack([project(nb_T[i], X) for i in range(NB)])
    uv2 += rng.normal(0, 0.5, uv2.shape)
    out = rng.random((NB, Kp)) < 0.1
    uv2[out] = rng.uniform(0, [cam.width, cam.height], (int(out.sum()), 2))
    uv2 = uv2.astype(np.float32)
    level1 = rng.integers(0, cfg.orb.n_levels, Kp).astype(np.int32)
    level2 = np.broadcast_to(level1, (NB, Kp)).copy()
    has = rng.random((NB, Kp)) < 0.9
    Xj, gj = _jax_tri_one(own_T, nb_T, own_uv, uv2, level1, level2, has, K,
                          cfg.orb.scale_factor)
    Xt, gt = triangulate_two_view_plain(
        torch.from_numpy(own_uv), torch.from_numpy(level1),
        torch.from_numpy(uv2), torch.from_numpy(level2),
        torch.from_numpy(has), torch.from_numpy(own_T),
        torch.from_numpy(nb_T), K, cfg.orb.scale_factor)
    Xt, gt = Xt.numpy(), gt.numpy() > 0
    assert gj.sum() > 0.5 * NB * Kp
    assert np.mean(gt == gj) >= 0.99
    both = gt & gj
    rel = np.linalg.norm(Xt - Xj, axis=-1) / np.linalg.norm(Xj, axis=-1)
    assert np.quantile(rel[both], 0.99) <= 1e-4 and rel[both].max() <= 5e-3
    # the float64 DLT in numpy, pair by pair
    Kmat = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    P1 = Kmat @ own_T[:3].astype(np.float64)
    for i in range(NB):
        P2 = Kmat @ nb_T[i, :3].astype(np.float64)
        for f in np.flatnonzero(both[i])[:64]:
            (a, b), (c, d) = own_uv[f], uv2[i, f]
            A = np.stack([a * P1[2] - P1[0], b * P1[2] - P1[1],
                          c * P2[2] - P2[0], d * P2[2] - P2[1]])
            Xh = np.linalg.svd(A)[2][-1]
            ref = Xh[:3] / Xh[3]
            assert np.linalg.norm(Xt[i, f] - ref) <= 1e-6 * np.linalg.norm(
                ref)


def _free_everything(flat, cfg):
    """The same packed inputs with every valid feature free, so the
    brute-force matching and the DLT get work (the synthetic room gives
    every feature depth, hence no free ones)."""
    lay = jdm.MappingInputLayout(cfg)
    parts, off = {}, 0
    for (name, shape, _), size in zip(lay.fields, lay.sizes):
        parts[name] = flat[off:off + size].reshape(shape).copy()
        off += size
    parts["own_free"] = np.ones_like(parts["own_free"])
    parts["nb_free"] = parts["nb_valid"] * parts["nb_ok"][:, None]
    return np.concatenate([parts[n].reshape(-1) for n, _, _ in lay.fields])


def test_mapping_step_matches_jax(run):
    """The port's _mapping_step_impl on every packed input of the JAX run
    (MappingInputLayout), and on the same inputs with all features free:
    fuse_idx, tri_idx, ln_tri_idx, tri_good and ln_tri_good equal on >= 99%
    of entries; tri_x and the line endpoints atol 1e-4 m where good in
    both."""
    jcfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    steps = run["steps"]
    assert len(steps) >= 3
    cases = [(f, o) for f, o in steps]
    cases.append((_free_everything(steps[-1][0], jcfg), None))
    layout = tdm.MappingLayout(tcfg)
    n_tri_good = 0
    for flat, out in cases:
        if out is None:
            out = np.asarray(jdm.mapping_step_packed(jnp.asarray(flat), jcfg))
        want = jdm.MappingLayout(jcfg).unpack(out)
        got = layout.unpack(tdm.mapping_step_packed(
            torch.from_numpy(np.array(flat)), tcfg).numpy())
        for name in ("fuse_idx", "tri_idx", "ln_tri_idx", "tri_good",
                     "ln_tri_good"):
            assert np.mean(got[name] == want[name]) >= 0.99, name
        tri = (got["tri_good"] > 0) & (want["tri_good"] > 0)
        np.testing.assert_allclose(got["tri_x"][tri], want["tri_x"][tri],
                                   atol=1e-4)
        ln = (got["ln_tri_good"] > 0) & (want["ln_tri_good"] > 0)
        for name in ("ln_tri_s", "ln_tri_e"):
            np.testing.assert_allclose(got[name][ln], want[name][ln],
                                       atol=1e-4)
        n_tri_good += int(tri.sum())
    assert n_tri_good > 0


def test_process_keyframe_matches_jax(run):
    """LocalMapping.process_keyframe on two copies of the JAX run's final
    map, for its last keyframe: every validity flag and association table
    equal, landmark positions atol 1e-4 m."""
    jcfg = jconfig.SystemConfig.tiny()
    tcfg = tconfig.SystemConfig.tiny()
    jmap = copy.deepcopy(run["slam"].map)
    tmap = map_from_numpy(jmap, tcfg)
    kf = int(jmap.valid_kf_ids()[-1])
    JLocalMapping(jcfg, jmap).process_keyframe(kf)
    lm = LocalMapping(tcfg, tmap, device="cpu")
    lm.process_keyframe(kf)
    assert lm.stats["mapping_steps"] == 1
    for name in ("pt_valid", "ln_valid", "pl_valid", "kf_valid", "kf_pt_idx",
                 "kf_ln_idx", "kf_pl_idx", "kf_pl_par_idx", "kf_pl_ver_idx",
                 "pt_nobs", "ln_nobs", "pl_nobs", "pt_desc"):
        np.testing.assert_array_equal(getattr(tmap, name),
                                      getattr(jmap, name), err_msg=name)
    for name in ("pt_xyz", "ln_sw", "ln_ew", "pl_coeffs"):
        np.testing.assert_allclose(getattr(tmap, name), getattr(jmap, name),
                                   atol=1e-4, err_msg=name)


def test_system_with_local_mapping(run):
    """The port's System with local mapping on, over the tiny 16-frame
    sequence, against the JAX System with the same switches: 0 lost, ATE
    <= 2x the JAX figure, per-frame position gap median <= 3 mm and max
    <= 2 cm, valid keyframe counts equal, valid map points within 5%."""
    cfg = tconfig.SystemConfig.tiny()
    seq = run["seq"]
    slam = TSystem(config=cfg, enable_loop_closing=False, device="cpu")
    for i, (g, d) in enumerate(run["frames"]):
        slam.track_rgbd(g, d, seq.timestamps[i])
    poses = slam.frame_poses_wc()
    jslam = run["slam"]
    assert poses.shape == (N_FRAMES, 4, 4)
    assert slam.tracker.stats["lost"] == 0 and jslam.tracker.stats["lost"] == 0
    gt = seq.poses_wc[:, :3, 3]
    assert ate_rmse(poses[:, :3, 3], gt) <= 2.0 * ate_rmse(
        run["poses"][:, :3, 3], gt)
    gap = np.linalg.norm(poses[:, :3, 3] - run["poses"][:, :3, 3], axis=1)
    assert np.median(gap) <= 0.003 and gap.max() <= 0.02
    assert len(slam.map.valid_kf_ids()) == len(jslam.map.valid_kf_ids())
    n_t, n_j = int(slam.map.pt_valid.sum()), int(jslam.map.pt_valid.sum())
    assert abs(n_t - n_j) <= 0.05 * n_j
    assert slam.local_mapper.stats["mapping_steps"] >= slam.map.n_kf - 1
