"""Port parity of the tracking slice: one fused device step from identical
carried state, and the whole System on the 12-frame tiny sequence, each
against the JAX package with the same switches (local mapping and loop
closing off) and the same uint8 / uint16 frames.
"""

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
from planarslam_tpu_torch.slam.system import System as TSystem
from planarslam_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(2)

N_FRAMES = 12
STEP_AT = 6  # frame whose fused step is compared from identical state


@pytest.fixture(scope="module")
def run():
    """The JAX System over the sequence; at STEP_AT the fused step's inputs
    are captured and the step is run once more on its own."""
    cfg = jconfig.SystemConfig.tiny()
    seq = synthetic.make_sequence(N_FRAMES, width=160, height=120)
    frames = [quantize_frame(*seq.render(i), cfg.camera.depth_map_factor)
              for i in range(N_FRAMES)]
    slam = JSystem(config=cfg, enable_local_mapping=False,
                   enable_loop_closing=False)
    step = None
    for i, (g, d) in enumerate(frames):
        if i == STEP_AT:
            packed = jdt.pack_frame(g, d)
            args = slam.tracker.fused_step_inputs(packed, None)
            out = jdt.fused_track_step_packed(*args, cfg)
            step = {"args": jax.tree.map(np.array, args[:7]),
                    "bundle": slam.tracker._layout.unpack(
                        np.asarray(out.packed)),
                    "state": jax.tree.map(np.asarray, out.new_state)}
        slam.track_rgbd(g, d, seq.timestamps[i])
    poses = slam.frame_poses_wc()
    return {"seq": seq, "frames": frames, "poses": poses, "step": step,
            "lost": slam.tracker.stats["lost"]}


def test_fused_step_from_identical_state(run):
    """The port's fused step from the JAX carried state and window: T_out
    atol 1e-4; >= 99% of frame-to-frame matches, window slots and inlier
    flags equal; the new carried state's landmarks atol 1e-4 m."""
    cfg = tconfig.SystemConfig.tiny()
    frame_u8, T_ovr, use_ovr, R_wm, manh, state, win = run["step"]["args"]
    t_state, t_win = tdt.state_from_numpy(state, win, device="cpu")
    res = tdt.fused_track_step_packed(
        torch.from_numpy(frame_u8)[None], torch.from_numpy(T_ovr)[None],
        torch.tensor([bool(use_ovr)]), torch.from_numpy(R_wm)[None],
        torch.tensor([bool(manh)]), tdt.lanes(t_state), t_win[None],
        tpo.PoseOptWeights.from_config(cfg.planes), cfg)
    got = tdt.BundleLayout(cfg).unpack(res.packed[0].numpy())
    want = run["step"]["bundle"]
    np.testing.assert_allclose(got["T_out"], want["T_out"], atol=1e-4)
    np.testing.assert_allclose(got["R_cm"], want["R_cm"], atol=1e-4)
    np.testing.assert_array_equal(got["flags"][:2], want["flags"][:2])
    assert (want["ff_idx"] >= 0).sum() > 50
    for name in ("ff_idx", "win_idx", "pt_inlier"):
        assert np.mean(got[name] == want[name]) >= 0.99, name
    for name in ("pl_direct", "pl_par", "pl_ver", "pl_valid"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(res.new_state.pt3d_w[0].numpy(),
                               run["step"]["state"].pt3d_w, atol=1e-4)


def test_state_roundtrip_types(run):
    """state_from_numpy keeps every leaf's shape; uint32 descriptors become
    int32 bit patterns."""
    state = run["step"]["args"][5]
    t_state, _ = tdt.state_from_numpy(state, run["step"]["args"][6],
                                      device="cpu")
    assert t_state.feats.points.desc.dtype == torch.int32
    np.testing.assert_array_equal(
        t_state.feats.points.desc.numpy().view(np.uint32),
        state.feats.points.desc)
    leaves_j = jax.tree.leaves(state)
    leaves_t = tdt._flatten(t_state.feats) + [t_state.pt3d_w,
                                              t_state.valid3d, t_state.T_cw,
                                              t_state.velocity]
    assert sorted(a.shape for a in leaves_j) == sorted(
        tuple(t.shape) for t in leaves_t)


def test_system_tiny_sequence(run):
    """The port's System on the tiny 12-frame sequence: ATE <= 0.0135 m
    (twice the JAX package's 0.00675 m), 0 lost frames, per-frame position
    gap to the JAX System median <= 3 mm and max <= 2 cm."""
    cfg = tconfig.SystemConfig.tiny()
    seq = run["seq"]
    slam = TSystem(config=cfg, enable_local_mapping=False,
                   enable_loop_closing=False, device="cpu")
    for i, (g, d) in enumerate(run["frames"]):
        slam.track_rgbd(g, d, seq.timestamps[i])
    poses = slam.frame_poses_wc()
    assert poses.shape == (N_FRAMES, 4, 4)
    assert slam.tracker.stats["lost"] == 0 and run["lost"] == 0
    gt = seq.poses_wc[:, :3, 3]
    assert ate_rmse(poses[:, :3, 3], gt) <= 0.0135
    gap = np.linalg.norm(poses[:, :3, 3] - run["poses"][:, :3, 3], axis=1)
    assert np.median(gap) <= 0.003 and gap.max() <= 0.02


def test_system_refuses_backend():
    """The backend is ported: the default System builds a loop closer on
    its device (the retrieval database shared with the tracker), and
    LocalMapping(enable_local_ba=True) constructs; asking for neither
    leaves both out."""
    from planarslam_tpu_torch.slam.local_mapping import LocalMapping
    from planarslam_tpu_torch.slam.loop_closing import LoopClosing
    from planarslam_tpu_torch.slam.map import SlamMap

    cfg = tconfig.SystemConfig.tiny()
    slam = TSystem(config=cfg, device="cpu")
    assert isinstance(slam.loop_closer, LoopClosing)
    assert slam.loop_closer.device == torch.device("cpu")
    assert slam.loop_closer.db is slam.kf_db
    assert slam.local_mapper is not None
    lm = LocalMapping(cfg, SlamMap(cfg), enable_local_ba=True, device="cpu")
    assert lm.enable_local_ba
    slam = TSystem(config=cfg, enable_local_mapping=False,
                   enable_loop_closing=False, device="cpu")
    assert slam.loop_closer is None and slam.local_mapper is None


@pytest.mark.parametrize("kwargs", [{}, {"device": None}, {"device": "cuda"}],
                         ids=["default", "None", "cuda"])
def test_system_without_card_raises(monkeypatch, kwargs):
    """Without a card, a System asked for the default device (or for None
    or "cuda") raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.SystemConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSystem(config=cfg, enable_loop_closing=False, **kwargs)


def _entry_points():
    """Each public entry point of the port, called with minimal arguments
    and the given device keywords."""
    from planarslam_tpu_torch.slam import device_mapper as tdm
    from planarslam_tpu_torch.slam.local_mapping import LocalMapping
    from planarslam_tpu_torch.slam.loop_closing import LoopClosing
    from planarslam_tpu_torch.slam.map import SlamMap
    from planarslam_tpu_torch.slam.tracking import Tracking
    from planarslam_tpu_torch.solvers import (global_ba, initializer,
                                              local_ba, pnp, pose_graph,
                                              sim3_solver)

    cfg = tconfig.SystemConfig.tiny()
    K = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    p3, p2 = np.zeros((8, 3), np.float32), np.zeros((8, 2), np.float32)
    ok, eye = np.ones(8, bool), np.eye(4, dtype=np.float32)

    def m():
        return SlamMap(cfg)

    return {
        "Tracking": lambda **kw: Tracking(cfg, m(), **kw),
        "LocalMapping": lambda **kw: LocalMapping(cfg, m(), **kw),
        "LoopClosing": lambda **kw: LoopClosing(cfg, m(), **kw),
        "local_bundle_adjustment": lambda **kw:
            local_ba.local_bundle_adjustment(m(), 0, cfg, **kw),
        "global_bundle_adjustment": lambda **kw:
            global_ba.global_bundle_adjustment(m(), cfg, **kw),
        "optimize_pose_graph": lambda **kw:
            pose_graph.optimize_pose_graph(m(), 1, eye, 0, cfg, **kw),
        "horn_ransac_se3": lambda **kw:
            sim3_solver.horn_ransac_se3(p3, p3, **kw),
        "refine_relative_se3": lambda **kw:
            sim3_solver.refine_relative_se3(eye, p3, p3, p2, p2, ok, K,
                                            **kw),
        "pnp_ransac": lambda **kw: pnp.pnp_ransac(p3, p2, ok, K, **kw),
        "initialize_two_view": lambda **kw:
            initializer.initialize_two_view(p2, p2, ok, K, **kw),
        "run_fuse_set": lambda **kw:
            tdm.run_fuse_set(m(), np.zeros(0, np.int64), [], cfg, **kw),
        "fuse_set_step_packed": lambda **kw: tdm.fuse_set_step_packed(
            np.zeros(tdm.FuseSetInputLayout(cfg).total, np.float32), cfg,
            **kw),
        "decode_step_inputs": lambda **kw: tdt.decode_step_inputs(
            np.zeros((1, 3, 120, 160), np.uint8),
            np.zeros((1, tdt._window_fields(cfg.map.max_planes,
                                            cfg.lines.desc_dim)[-1][2]),
                     np.float32), cfg, **kw),
        "CapturedChunk": lambda **kw: tdt.CapturedChunk(
            4, cfg, tpo.PoseOptWeights.from_config(cfg.planes), **kw),
        "run_mapping_step": lambda **kw:
            tdm.run_mapping_step(m(), 0, cfg, **kw),
        "dispatch_mapping_step": lambda **kw:
            tdm.dispatch_mapping_step(m(), 0, cfg, **kw),
        "state_from_numpy": lambda **kw:
            tdt.state_from_numpy({}, np.zeros(0, np.float32), **kw),
        "loop_closer_from_numpy": lambda **kw: tdt.loop_closer_from_numpy(
            LoopClosing(cfg, m(), device="cpu"), cfg, m(), **kw),
    }


@pytest.mark.parametrize("kwargs", [{}, {"device": "cuda"}],
                         ids=["default", "cuda"])
@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_card_raises(monkeypatch, name, kwargs):
    """Every public entry point of the port defaults to the card: without
    one, called with the default device or with "cuda", it raises the
    resolve_device error instead of running on the CPU."""
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(**kwargs)


def _c_entries() -> dict:
    """The PSL_API functions of planarslam_tpu_torch/csrc: name -> the C
    types of their parameters."""
    import os
    import re

    from planarslam_tpu_torch import kernels

    out = {}
    for name in sorted(os.listdir(kernels.CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(kernels.CSRC, name)) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for m in re.finditer(r"PSL_API\s+[\w\s\*]+?\b(psl_\w+)\s*\(([^)]*)\)",
                             text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = params
    return out


def test_kernel_signatures_match_c_entries():
    """Every ctypes signature in kernels.py (launchers and host helpers)
    names a PSL_API function of csrc/ with as many parameters, each a
    pointer where the C parameter is one (the stream included) and a
    64-bit integer, 32-bit integer or float where the C parameter is
    long long, int or float: a wrong count or width passes arguments
    that the card only shows as a fault."""
    import ctypes

    from planarslam_tpu_torch import kernels

    entries = _c_entries()
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_longlong: "long long", ctypes.c_float: "float",
             ctypes.c_double: "double"}
    for name, argtypes in {**kernels._SIGNATURES, **kernels._HELPERS}.items():
        assert name in entries, name
        c = entries[name]
        assert len(c) == len(argtypes), (name, len(c), len(argtypes))
        for p, t in zip(c, argtypes):
            want = ("ptr" if "*" in p or p.startswith("cudaStream_t")
                    else "long long" if p.startswith("long long")
                    else p.split()[-2] if len(p.split()) > 1 else p)
            assert kinds[t] == want, (name, p, kinds[t])
