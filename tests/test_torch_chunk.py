"""Port parity of chunked throughput mode (tracking.chunk_size > 1) on the
CPU at SystemConfig.tiny() (160x120): host packing, the eager chunk
against the JAX package's fused_track_chunk_packed from the JAX System's
carried state and window, the chunk against chained streaming steps of
the port, K37's shared-window mode in its plain version, make_last_state,
a pose override in chunk mode, and the whole System in chunk mode against
the JAX System.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planarslam_tpu import config as jconfig
from planarslam_tpu.evaluation.ate import ate_rmse
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam import device_tracker as jdt
from planarslam_tpu.slam.system import System as JSystem
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.io.frames import quantize_frame
from planarslam_tpu_torch.slam import device_tracker as tdt
from planarslam_tpu_torch.slam.map import SlamMap
from planarslam_tpu_torch.slam.system import System as TSystem
from planarslam_tpu_torch.slam.tracking import Tracking
from planarslam_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(2)

N_FRAMES = 12
C = 4          # frames a chunk
STEP_AT = 6    # the streaming frame whose carried state and window start
               # the compared chunk (frames STEP_AT .. STEP_AT + C - 1)


def _chunked(cfg, chunk_size: int = C):
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, chunk_size=chunk_size))


@pytest.fixture(scope="module")
def seq_frames():
    cfg = jconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(N_FRAMES, width=160, height=120)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(N_FRAMES)]
    return seq, frames


@pytest.fixture(scope="module")
def jax_chunk(seq_frames):
    """The JAX System streaming over the sequence; at STEP_AT its carried
    state, window and Manhattan inputs are captured and JAX's
    fused_track_chunk_packed runs once on frames STEP_AT .. + C - 1."""
    seq, frames = seq_frames
    cfg = jconfig.SystemConfig.tiny()
    slam = JSystem(config=cfg, enable_local_mapping=False,
                   enable_loop_closing=False)
    out = None
    for i, (g, d) in enumerate(frames):
        if i == STEP_AT:
            args = slam.tracker.fused_step_inputs(jdt.pack_frame(g, d), None)
            _, _, _, R_wm, manh, state, win, weights = args
            packed = jdt.pack_chunk_frames(
                [f[0] for f in frames[i:i + C]],
                [f[1] for f in frames[i:i + C]])
            res = jdt.fused_track_chunk_packed(jnp.asarray(packed), R_wm,
                                               manh, state, win, weights, cfg)
            out = {"packed": packed, "R_wm": np.asarray(R_wm),
                   "manh": bool(manh),
                   "state": jax.tree.map(np.asarray, state),
                   "win": np.asarray(win),
                   "bundles": [slam.tracker._layout.unpack(row) for row in
                               np.asarray(res.packed)],
                   "final": jax.tree.map(np.asarray, res.final_state)}
        slam.track_rgbd(g, d, seq.timestamps[i])
    return out


def _port_inputs(jc):
    """The JAX captures as the port's B = 1 chunk inputs."""
    state, win = tdt.state_from_numpy(jc["state"], jc["win"], device="cpu")
    return (torch.from_numpy(jc["packed"]),
            torch.from_numpy(np.array(jc["R_wm"]))[None], torch.tensor([jc["manh"]]),
            tdt.lanes(state), win[None])


@pytest.fixture(scope="module")
def port_chunk(jax_chunk):
    cfg = tconfig.SystemConfig.tiny()
    frames, R_wm, manh, state, win = _port_inputs(jax_chunk)
    weights = tpo.PoseOptWeights.from_config(cfg.planes)
    res = tdt.fused_track_chunk_packed(frames, R_wm, manh, state, win,
                                       weights, cfg)
    return res, (frames, R_wm, manh, state, win, weights)


def test_pack_chunk_frames_matches_jax(seq_frames):
    """pack_chunk_frames: JAX's (C, 3, H, W) uint8 bytes; None off the
    native dtypes, as JAX's."""
    _, frames = seq_frames
    g = [f[0] for f in frames[:C]]
    d = [f[1] for f in frames[:C]]
    got = tdt.pack_chunk_frames(g, d)
    want = jdt.pack_chunk_frames(g, d)
    assert got.dtype == np.uint8 and got.shape == (C, 3, 120, 160)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], tdt.pack_frame(g[2], d[2]))
    as_float = [x.astype(np.float32) for x in d]
    assert tdt.pack_chunk_frames(g, as_float) is None
    assert jdt.pack_chunk_frames(g, as_float) is None


def test_chunk_matches_jax_frame_by_frame(jax_chunk, port_chunk):
    """The port's eager fused_track_chunk_packed at C = 4 from the JAX
    carried state and window against JAX's, frame by frame, with
    test_fused_step_from_identical_state's limits: T_out and R_cm atol
    1e-4; >= 99% of ff_idx, win_idx and pt_inlier equal; the plane flags
    equal; the final state's pt3d_w atol 1e-4 m."""
    cfg = tconfig.SystemConfig.tiny()
    res, _ = port_chunk
    layout = tdt.BundleLayout(cfg)
    assert res.packed.shape == (C, layout.total)
    for i, want in enumerate(jax_chunk["bundles"]):
        got = layout.unpack(res.packed[i].numpy())
        np.testing.assert_allclose(got["T_out"], want["T_out"], atol=1e-4,
                                   err_msg=f"frame {i}")
        np.testing.assert_allclose(got["R_cm"], want["R_cm"], atol=1e-4,
                                   err_msg=f"frame {i}")
        np.testing.assert_array_equal(got["flags"][:2], want["flags"][:2])
        assert (want["ff_idx"] >= 0).sum() > 50, i
        for name in ("ff_idx", "win_idx", "pt_inlier"):
            assert np.mean(got[name] == want[name]) >= 0.99, (i, name)
        for name in ("pl_direct", "pl_par", "pl_ver", "pl_valid"):
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"frame {i} {name}")
    np.testing.assert_allclose(res.final_state.pt3d_w[0].numpy(),
                               jax_chunk["final"].pt3d_w, atol=1e-4)
    np.testing.assert_allclose(res.final_state.T_cw[0].numpy(),
                               jax_chunk["final"].T_cw, atol=1e-4)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_chunk_equals_chained_streaming_steps(port_chunk):
    """The eager chunk is exactly C chained B = 1 fused_track_step_packed
    steps over the frozen window (no override): every bundle as int32
    bits, every per-frame state leaf and every final state leaf."""
    cfg = tconfig.SystemConfig.tiny()
    res, (frames, R_wm, manh, state, win, weights) = port_chunk
    eye = torch.eye(4)[None]
    no = torch.tensor([False])
    for i in range(C):
        step = tdt.fused_track_step_packed(frames[i:i + 1], eye, no, R_wm,
                                           manh, state, win, weights, cfg)
        assert torch.equal(_bits(step.packed), _bits(res.packed[i:i + 1])), i
        lane = tdt.state_of_leaves([x[i:i + 1] for x in
                                    tdt.state_leaves(res.states)])
        for a, b in zip(tdt.state_leaves(step.new_state),
                        tdt.state_leaves(lane)):
            assert torch.equal(_bits(a), _bits(b)), i
        state = step.new_state
    for a, b in zip(tdt.state_leaves(state),
                    tdt.state_leaves(res.final_state)):
        assert torch.equal(_bits(a), _bits(b))


def test_shared_window_decode_equals_per_lane(port_chunk):
    """K37's shared-window mode, plain: C frames against one (1, S) window
    give every lane's frames and the window's fields exactly as the same
    frames with the window repeated C times; a window count other than 1
    or C raises."""
    cfg = tconfig.SystemConfig.tiny()
    _, (frames, _, _, _, win, _) = port_chunk
    shared = tdt.decode_step_inputs_plain(frames, win, cfg)
    per_lane = tdt.decode_step_inputs_plain(frames, win.expand(C, -1), cfg)
    wrapped = tdt._decode(win, cfg, frame=frames)
    for got in (shared, wrapped):
        assert torch.equal(_bits(got[0]), _bits(per_lane[0]))
        assert torch.equal(_bits(got[1]), _bits(per_lane[1]))
        for name, x in zip(tdt.DeviceWindow._fields, got[2]):
            y = getattr(per_lane[2], name)
            assert x.shape[0] == 1, name
            for b in range(C):
                assert torch.equal(_bits(x[0]), _bits(y[b])), (name, b)
    with pytest.raises(ValueError):
        tdt.decode_step_inputs_plain(frames, win.expand(2, -1), cfg)
    with pytest.raises(ValueError):
        tdt._decode(win.expand(2, -1), cfg, frame=frames)


def test_make_last_state_matches_jax(seq_frames):
    """make_last_state from a uint8 / uint16 frame against JAX's, with the
    front-end tests' limits: >= 97% of the keypoints (pixel and level)
    shared, the world points and their mask on the shared keypoints
    (atol 1e-4 m), the plane count and validity, T_cw and the velocity."""
    _, frames = seq_frames
    g, d = frames[3]
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.01]
    vel = np.eye(4, dtype=np.float32)
    vel[:3, 3] = [0.001, 0.0, 0.002]
    js = jdt.make_last_state(jnp.asarray(g), jnp.asarray(d), jnp.asarray(T),
                             jnp.asarray(vel), jconfig.SystemConfig.tiny())
    ts = tdt.make_last_state(torch.from_numpy(g),
                             torch.from_numpy(d.astype(np.int32)),
                             torch.from_numpy(T), torch.from_numpy(vel),
                             tconfig.SystemConfig.tiny())
    pj, pt = js.feats.points, ts.feats.points
    uj, ut = np.asarray(pj.uv_raw), pt.uv_raw.numpy()
    lj, lt = np.asarray(pj.level), pt.level.numpy()
    vj, vt = np.asarray(pj.valid), pt.valid.numpy()
    keys_j = {(int(l), *map(float, x)) for l, x, v in zip(lj, uj, vj) if v}
    keys_t = {(int(l), *map(float, x)) for l, x, v in zip(lt, ut, vt) if v}
    assert len(keys_j) > 50
    assert len(keys_j & keys_t) >= 0.97 * len(keys_j)
    same = (ut == uj).all(axis=1) & (lt == lj) & vj & vt
    np.testing.assert_array_equal(ts.valid3d.numpy()[same],
                                  np.asarray(js.valid3d)[same])
    np.testing.assert_allclose(ts.pt3d_w.numpy()[same],
                               np.asarray(js.pt3d_w)[same], atol=1e-4)
    np.testing.assert_array_equal(ts.feats.planes.valid.numpy(),
                                  np.asarray(js.feats.planes.valid))
    np.testing.assert_array_equal(ts.feats.planes.count.numpy(),
                                  np.asarray(js.feats.planes.count))
    np.testing.assert_array_equal(ts.T_cw.numpy(), np.asarray(js.T_cw))
    np.testing.assert_array_equal(ts.velocity.numpy(),
                                  np.asarray(js.velocity))


def test_chunk_pose_override_matches_jax(jax_chunk, seq_frames):
    """A pose override in chunk mode, in both packages' trackers: the
    carried state of the JAX capture, a loop correction's override pending,
    one chunk dispatched. The override re-bases the carried T_cw (velocity
    the identity) before the chunk; the first frame's T_out agrees with
    JAX's (atol 1e-4), and the override is consumed."""
    _, frames = seq_frames
    jc = jax_chunk
    chunk = frames[STEP_AT:STEP_AT + C]
    T_ovr = jc["state"].T_cw.copy()
    T_ovr[:3, 3] += np.float32([0.01, -0.005, 0.008])

    jcfg = _chunked(jconfig.SystemConfig.tiny())
    jslam = JSystem(config=jcfg, enable_local_mapping=False,
                    enable_loop_closing=False)
    jt = jslam.tracker
    jt.chunk_pipeline_depth = 8  # keep the chunk in flight to read it
    jt._fused_state = jax.tree.map(jnp.asarray, jc["state"])
    jt._window = jnp.asarray(jc["win"])
    jt._window_dirty = False
    jt.R_wm = jc["R_wm"] if jc["manh"] else None
    jt._pose_override = T_ovr
    for k, (g, d) in enumerate(chunk):
        jt._track_frame_chunked(g, d, float(k))
    want = jt._layout.unpack(jt._pending_chunks[-1]["future"].result()[0])
    assert jt._pose_override is None

    tcfg = _chunked(tconfig.SystemConfig.tiny())
    tt = Tracking(tcfg, SlamMap(tcfg), device="cpu")
    tt.chunk_pipeline_depth = 8
    _, R_wm, manh, state, win = _port_inputs(jc)
    tt._fused_state = state
    tt._window = win
    tt._window_dirty = False
    tt.R_wm = jc["R_wm"] if jc["manh"] else None
    tt._pose_override = T_ovr
    for k, (g, d) in enumerate(chunk):
        tt._track_frame_chunked(g, d, float(k))
    assert tt._pose_override is None
    got = tt._layout.unpack(tt._pending_chunks[-1]["pull"].result()[0])
    np.testing.assert_allclose(got["T_out"], want["T_out"], atol=1e-4)


def _system_poses(system_cls, cfg, seq, frames, **kw):
    slam = system_cls(config=cfg, enable_local_mapping=False,
                      enable_loop_closing=False, **kw)
    for i, (g, d) in enumerate(frames):
        slam.track_rgbd(g, d, seq.timestamps[i])
    slam.shutdown()
    return slam.frame_poses_wc(), slam.tracker.stats["lost"]


def test_system_chunked_matches_jax(seq_frames):
    """The port's System against the JAX System at chunk_size = 4 over the
    12 frames (frame 0 initializes: two full chunks and a partial one of
    3 at the flush): 12 poses and 0 lost frames in both; ATE <= 0.0135 m;
    the per-frame gap to JAX's median <= 3 mm and max <= 2 cm; and the
    chunk ATE < max(1.5 x the port's streaming ATE, 0.02 m)
    (tests/test_slam_e2e.py's chunk limit)."""
    seq, frames = seq_frames
    gt = seq.poses_wc[:, :3, 3]
    jp, jlost = _system_poses(JSystem, _chunked(jconfig.SystemConfig.tiny()),
                              seq, frames)
    tp, tlost = _system_poses(TSystem, _chunked(tconfig.SystemConfig.tiny()),
                              seq, frames, device="cpu")
    sp, slost = _system_poses(TSystem, tconfig.SystemConfig.tiny(), seq,
                              frames, device="cpu")
    assert jp.shape == tp.shape == (N_FRAMES, 4, 4)
    assert jlost == 0 and tlost == 0 and slost == 0
    ate = ate_rmse(tp[:, :3, 3], gt)
    assert ate <= 0.0135
    gap = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    assert np.median(gap) <= 0.003 and gap.max() <= 0.02
    assert ate < max(1.5 * ate_rmse(sp[:, :3, 3], gt), 0.02)
