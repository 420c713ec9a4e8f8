"""Port parity of batched multi-sequence replay
(planarslam_tpu_torch/parallel/replay.py and the batched tracking step)
against planarslam_tpu/parallel/replay.py on the CPU, at
SystemConfig.tiny() (160x120): the batched fused step against jax.vmap of
the JAX step on the same lanes' frames and carried states, a batched step
against its lanes stepped alone, the visual-odometry step and replay, the
full BatchedSLAM replay, a lane dropping out and rejoining,
pack_feats_slice, and K36's plain version against the JAX prelude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import planted_prelude_arrays
from planarslam_tpu import config as jconfig
from planarslam_tpu.io import synthetic
from planarslam_tpu.parallel import replay as jreplay
from planarslam_tpu.slam import device_tracker as jdt
from planarslam_tpu.slam.tracking import TrackingState as JState
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.io.frames import quantize_frame
from planarslam_tpu_torch.parallel import replay as treplay
from planarslam_tpu_torch.slam import device_tracker as tdt
from planarslam_tpu_torch.slam.tracking import TrackingState as TState
from planarslam_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(2)

N_FRAMES = 8
CAPTURE_STEP = 4  # the batched step of the JAX replay held against the port


def _sequences(kinds, n_frames, seed0):
    return [synthetic.make_sequence(n_frames=n_frames, width=160,
                                    height=120, kind=k, seed=seed0 + i)
            for i, k in enumerate(kinds)]


class _Head:
    """The first n frames of a sequence (its motion per frame that of the
    whole sequence's pace)."""

    def __init__(self, seq, n: int):
        self.seq, self.n = seq, n

    def __len__(self) -> int:
        return self.n

    def render(self, i: int):
        return self.seq.render(i)


def _replay(batched, seqs):
    """BatchedSLAM.run over the sequences' frames quantized to uint8 gray
    and uint16 depth (the sensor formats: the packed step)."""
    factor = batched.cfg.camera.depth_map_factor
    for i in range(N_FRAMES):
        frames = [quantize_frame(*s.render(i), factor) for s in seqs]
        batched.track([f[0] for f in frames], [f[1] for f in frames],
                      np.full(len(seqs), float(i) / 30.0))
    batched.flush()
    for s in batched.systems:
        s.shutdown()


@pytest.fixture(scope="module")
def jax_replay():
    """JAX BatchedSLAM at B = 2 (kinds arc and still) over N_FRAMES
    quantized frames; the inputs and the result of its CAPTURE_STEP-th
    batched step are kept."""
    cfg = jconfig.SystemConfig.tiny()
    seqs = _sequences(["arc", "still"], N_FRAMES, 100)
    batched = jreplay.BatchedSLAM(cfg, 2)
    build = batched._build_vstep
    captured = {}

    def build_and_wrap(packed):
        build(packed)
        vstep = batched._vstep
        calls = [0]

        def wrapped(*args):
            out = vstep(*args)
            calls[0] += 1
            if calls[0] == CAPTURE_STEP:
                captured["packed_input"] = packed
                captured["args"] = jax.tree.map(np.array, args)
                captured["bundle"] = np.asarray(out.packed)
                captured["state"] = jax.tree.map(np.asarray, out.new_state)
            return out
        batched._vstep = wrapped

    batched._build_vstep = build_and_wrap
    _replay(batched, seqs)
    return {"seqs": seqs, "batched": batched, "captured": captured}


@pytest.fixture(scope="module")
def port_replay(jax_replay):
    cfg = tconfig.SystemConfig.tiny()
    batched = treplay.BatchedSLAM(cfg, 2, device="cpu")
    _replay(batched, jax_replay["seqs"])
    return {"batched": batched}


def _captured_step_inputs(cap):
    """The port's arguments of the captured JAX step: frames, the small
    parameters split, the stacked state and windows (state_from_numpy)."""
    assert cap["packed_input"], "the replay feeds native uint8 / uint16"
    frames, small, state, win, _ = cap["args"]
    state_t, win_t = tdt.state_from_numpy(state, win, device="cpu")
    return (torch.from_numpy(frames),
            torch.from_numpy(small[:, :16].reshape(-1, 4, 4).copy()),
            torch.from_numpy(small[:, 16] > 0.5),
            torch.from_numpy(small[:, 17:26].reshape(-1, 3, 3).copy()),
            torch.from_numpy(small[:, 26] > 0.5), state_t, win_t)


def test_batched_step_matches_vmapped_jax(jax_replay):
    """(a) The port's fused_track_step_packed at B = 2 on the lanes' own
    frames and carried states against the vmapped JAX step: per lane T_out
    and R_cm atol 1e-4, the flags exact, >= 99% of the frame-to-frame
    matches, window slots and inlier flags equal, the direct plane matches
    and plane validity exact, a parallel or vertical partner different
    only where both candidates' |cos| to the frame plane lie within 1e-3 of
    each other (a near tie that the poses' 1e-4 differences decide), the
    carried landmarks atol 1e-4 m."""
    cap = jax_replay["captured"]
    cfg = tconfig.SystemConfig.tiny()
    args = _captured_step_inputs(cap)
    res = tdt.fused_track_step_packed(
        *args, tpo.PoseOptWeights.from_config(cfg.planes), cfg)
    layout = tdt.BundleLayout(cfg)
    win = tdt.unpack_window(args[-1], cfg)
    for b in range(2):
        got = layout.unpack(res.packed[b].numpy())
        want = layout.unpack(cap["bundle"][b])
        np.testing.assert_allclose(got["T_out"], want["T_out"], atol=1e-4)
        np.testing.assert_allclose(got["R_cm"], want["R_cm"], atol=1e-4)
        np.testing.assert_array_equal(got["flags"][:2], want["flags"][:2])
        assert (want["ff_idx"] >= 0).sum() > 50, b
        for name in ("ff_idx", "win_idx", "pt_inlier"):
            assert np.mean(got[name] == want[name]) >= 0.99, (b, name)
        for name in ("pl_direct", "pl_valid"):
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"lane {b} {name}")
        n_map = win.pl_coeffs[b, :, :3].numpy()
        n_map = n_map / np.maximum(
            np.linalg.norm(n_map, axis=1, keepdims=True), 1e-9)
        for name in ("pl_par", "pl_ver"):
            for p in np.flatnonzero(got[name] != want[name]):
                assert got[name][p] >= 0 and want[name][p] >= 0, (b, name)
                n_f = got["pl_coeffs_w"][p, :3]
                cos = np.abs(n_map[[got[name][p], want[name][p]]] @ n_f)
                cos /= np.linalg.norm(n_f)
                assert abs(cos[0] - cos[1]) <= 1e-3, (b, name, p, cos)
        np.testing.assert_allclose(res.new_state.pt3d_w[b].numpy(),
                                   cap["state"].pt3d_w[b], atol=1e-4)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_batched_step_lanes_equal_single_steps(jax_replay):
    """(b) A batched step at B = 3 equals three B = 1 steps bit for bit,
    per lane: the bundle as int32 bits and every leaf of the new state.
    Lane 2 pairs lane 0's carried state with lane 1's frame."""
    cfg = tconfig.SystemConfig.tiny()
    frames, T_ovr, use, R_wm, manh, state, win = _captured_step_inputs(
        jax_replay["captured"])
    pick = [0, 1, 0]
    frames = frames[[0, 1, 1]]
    T_ovr, use, R_wm, manh, win = (x[pick] for x in (T_ovr, use, R_wm,
                                                     manh, win))
    state = tdt.state_of_leaves([x[pick] for x in tdt.state_leaves(state)])
    weights = tpo.PoseOptWeights.from_config(cfg.planes)
    batched = tdt.fused_track_step_packed(frames, T_ovr, use, R_wm, manh,
                                          state, win, weights, cfg)
    for b in range(3):
        one = tdt.fused_track_step_packed(
            frames[b:b + 1], T_ovr[b:b + 1], use[b:b + 1], R_wm[b:b + 1],
            manh[b:b + 1],
            tdt.state_of_leaves([x[b:b + 1]
                                 for x in tdt.state_leaves(state)]),
            win[b:b + 1], weights, cfg)
        np.testing.assert_array_equal(_bits(batched.packed[b]),
                                      _bits(one.packed[0]))
        for x, y in zip(tdt.state_leaves(batched.new_state),
                        tdt.state_leaves(one.new_state)):
            np.testing.assert_array_equal(_bits(x[b]), _bits(y[0]))


def _vo_inputs(seqs, cfg):
    """Frame 1 of each sequence with frame 0's features as the previous
    frame (the arrays run_batched_replay carries), numpy."""
    from planarslam_tpu_torch.slam.frame import (extract_frame,
                                                 unproject_points)

    renders = [[s.render(i) for s in seqs] for i in (0, 1)]
    stack = [[np.stack([np.asarray(r[j], np.float32) for r in rs])
              for j in (0, 1)] for rs in renders]
    f0 = tdt.feats_to_numpy(extract_frame(torch.from_numpy(stack[0][0]),
                                          torch.from_numpy(stack[0][1]),
                                          cfg)).points
    B, k = len(seqs), cfg.orb.max_keypoints
    pts_w = np.zeros((B, k, 3), np.float32)
    for b in range(B):
        pts_w[b] = unproject_points(type(f0)(*[a[b] for a in f0]), cfg,
                                    np.eye(4, dtype=np.float32))
    return (stack[1][0], stack[1][1],
            np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
            np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)), pts_w,
            f0.desc, f0.valid & (f0.depth > 0))


def test_batched_frame_step_and_replay_match_jax():
    """(c) make_batched_frame_step on frame 1 after frame 0, and
    run_batched_replay over the first 4 frames of two 48-frame sequences
    (arc, loop), against the JAX ones over make_mesh(2): poses atol 1e-4,
    point inliers within 1%."""
    tc = tconfig.SystemConfig.tiny()
    jc = jconfig.SystemConfig.tiny()
    seqs = [_Head(s, 4) for s in _sequences(["arc", "loop"], 48, 300)]
    args = _vo_inputs(seqs, tc)
    mesh = jreplay.make_mesh(2)
    jstep, shard = jreplay.make_batched_frame_step(jc, mesh)
    jT, jR, jn = jstep(*[shard(jnp.asarray(a)) for a in args])
    tstep, put = treplay.make_batched_frame_step(tc, device="cpu")
    tT, tR, tn = tstep(*[put(a) for a in args])
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    jn = np.asarray(jn)
    assert jn.max() > 100
    assert np.all(np.abs(tn.numpy() - jn) <= 0.01 * jn)

    want = jreplay.run_batched_replay(seqs, jc, mesh)
    got = treplay.run_batched_replay(seqs, tc, device="cpu")
    assert got.shape == want.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_batched_slam_matches_jax(jax_replay, port_replay):
    """(d) BatchedSLAM at B = 2 (arc, still; 8 frames) against the JAX
    BatchedSLAM: each lane's positions within 1e-3 m, the same keyframe
    counts, both OK, and at least B x 6 lane frames through the fused
    batch."""
    jb, tb = jax_replay["batched"], port_replay["batched"]
    for b in range(2):
        js, ts = jb.systems[b], tb.systems[b]
        assert js.get_tracking_state() == JState.OK
        assert ts.get_tracking_state() == TState.OK
        assert ts.map.n_kf == js.map.n_kf, b
        gap = np.abs(ts.frame_poses_wc()[:, :3, 3]
                     - js.frame_poses_wc()[:, :3, 3])
        assert gap.max() <= 1e-3, (b, gap.max())
    assert tb.stats["fused_lane_frames"] >= 2 * 6
    assert tb.stats["fused_lane_frames"] == jb.stats["fused_lane_frames"]


def _dropout_run(seqs, drop_at):
    cfg = tconfig.SystemConfig.tiny()
    batched = treplay.BatchedSLAM(cfg, len(seqs), device="cpu")
    for i in range(len(seqs[0])):
        if i == drop_at:
            tr = batched.systems[2].tracker
            tr.flush_pending()
            tr.state = TState.LOST
            tr._fused_state = None
        batched.track([s.render(i)[0] for s in seqs],
                      [s.render(i)[1] for s in seqs],
                      np.full(len(seqs), float(i) / 30.0))
    batched.flush()
    for s in batched.systems:
        s.shutdown()
    return batched


def test_dropout_lane_rejoins_others_unchanged():
    """(e) tests/test_batched_slam.py:55 ported at B = 3 and 10 frames:
    lane 2 forced LOST at frame 5 leaves the batch and rejoins it (the
    batch stays padded to B), and lanes 0 and 1 give bit-equal
    trajectories to a run without the dropout."""
    seqs = _sequences(["arc"] * 3, 10, 200)
    ref = _dropout_run(seqs, drop_at=None)
    drop = _dropout_run(seqs, drop_at=5)
    assert drop.stats["padded_lane_frames"] > 0
    assert drop.systems[2].tracker.state == TState.OK
    assert drop._lane_live[2]
    assert np.isfinite(drop.systems[2].frame_poses_wc()).all()
    for b in (0, 1):
        np.testing.assert_array_equal(drop.systems[b].frame_poses_wc(),
                                      ref.systems[b].frame_poses_wc())


def test_pack_feats_slice_matches_jax(jax_replay):
    """(f) pack_feats_slice of each lane of the captured stacked features
    equals the JAX one, bit for bit."""
    feats = jax_replay["captured"]["state"].feats
    feats_t = tdt.state_from_numpy(jax_replay["captured"]["state"],
                                   np.zeros(0, np.float32),
                                   device="cpu")[0].feats
    for b in range(2):
        want = np.asarray(jdt.pack_feats_slice(
            jax.tree.map(jnp.asarray, feats), jnp.int32(b)))
        got = tdt.pack_feats_slice(feats_t, b).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _jax_prelude(T_override, use_override, T_cw, velocity, p3d_s, p3d_e,
                 has_3d, ln_valid, normals, normals_valid, R_wm):
    """planarslam_tpu/slam/device_tracker.py:274-290 for one lane."""
    T_last = jnp.where(use_override, T_override, T_cw)
    vel = jnp.where(use_override, jnp.eye(4, dtype=jnp.float32), velocity)
    T_pred = vel @ T_last
    ln_vec = p3d_e - p3d_s
    ln_len = jnp.linalg.norm(ln_vec, axis=-1, keepdims=True)
    ln_dir = ln_vec / jnp.maximum(ln_len, 1e-9)
    ln_ok = has_3d & ln_valid & (ln_len[:, 0] > 0.1)
    return (T_last, T_pred, jnp.concatenate([normals, ln_dir], axis=0),
            jnp.concatenate([normals_valid, ln_ok], axis=0),
            T_pred[:3, :3] @ R_wm)


def _seeded_prelude(B: int, L: int, Nn: int) -> list:
    """Four seeded lanes: the override on and off, zero-length and short
    lines."""
    rng = np.random.default_rng(7)

    def pose():
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.normal(size=3)
        return T

    p3d_s = rng.normal(size=(B, L, 3)).astype(np.float32)
    p3d_e = (p3d_s + rng.normal(scale=0.3, size=(B, L, 3))).astype(
        np.float32)
    p3d_e[:, 0] = p3d_s[:, 0]            # zero length
    p3d_e[:, 1] = p3d_s[:, 1] + 0.05     # shorter than 0.1 m
    normals = rng.normal(size=(B, Nn, 3)).astype(np.float32)
    return [np.stack([pose() for _ in range(B)]),
            np.array([True, False, True, False]),
            np.stack([pose() for _ in range(B)]),
            np.stack([pose() for _ in range(B)]), p3d_s, p3d_e,
            rng.random((B, L)) > 0.2, rng.random((B, L)) > 0.2,
            normals / np.linalg.norm(normals, axis=-1, keepdims=True),
            rng.random((B, Nn)) > 0.3,
            np.stack([pose()[:3, :3] for _ in range(B)])]


@pytest.mark.parametrize("case,Nn,L", [("seeded", 32, 16),
                                       ("planted", 2048, 64),
                                       ("planted", 2047, 64),
                                       ("planted", 2047, 0),
                                       ("planted", 2048, 1)])
def test_step_prelude_plain_matches_jax(case, Nn, L):
    """(g) K36's plain version on four lanes against the JAX prelude: the
    seeded lanes (the override on and off, zero-length and short lines),
    and chip_smoke.py's planted lanes at the main path's widths (Nn 2048,
    L 64), at Nn 2047 (K36's scalar path) and with no line and one (lines
    of zero length, of 0.05 m, with a NaN coordinate and at the float32
    either side of 0.1 m and on it): the selections exact, T_pred and
    R_init atol 1e-6, directions atol 1e-6 (NaN where JAX's), validity
    exact."""
    B = 4
    args = (_seeded_prelude(B, L, Nn) if case == "seeded"
            else planted_prelude_arrays(B, L, Nn))
    got = tdt.step_prelude_plain(*[torch.from_numpy(np.ascontiguousarray(a))
                                   for a in args])
    want = jax.vmap(_jax_prelude)(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(got.T_last.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got.T_pred.numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_allclose(got.dirs.numpy(), np.asarray(want[2]),
                               atol=1e-6)
    np.testing.assert_array_equal(got.dirs_valid.numpy(),
                                  np.asarray(want[3]))
    assert not got.dirs_valid[:, Nn:Nn + 2].any()
    if case == "planted" and L >= 6:
        assert np.isnan(got.dirs[:, Nn + 2].numpy()).all(axis=1).all()
        assert got.dirs_valid[:, Nn + 3:Nn + 6].tolist() == [
            [False, False, True]] * B
    np.testing.assert_allclose(got.R_init.numpy(), np.asarray(want[4]),
                               atol=1e-6)


def test_batched_slam_run_shape():
    """BatchedSLAM.run on float renders (the unpacked step) returns (B, N,
    4, 4) finite poses with every lane tracking."""
    cfg = tconfig.SystemConfig.tiny()
    seqs = _sequences(["still", "still"], 4, 400)
    batched = treplay.BatchedSLAM(cfg, 2, device="cpu")
    out = batched.run(seqs)
    assert out.shape == (2, 4, 4, 4) and np.isfinite(out).all()
    assert batched.stats["fused_lane_frames"] >= 2
    assert all(s.get_tracking_state() == TState.OK for s in batched.systems)
