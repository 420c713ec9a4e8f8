"""Map checkpoints and mesh export cross between the two packages: a map
saved by one loads in the other with every array and counter equal, in both
directions, and both packages' save_mesh write the same file for the same
map. The map comes from the port's System on the tiny synthetic sequence
(CPU); nothing here needs the JAX tracker, only its numpy-side modules.
"""

import numpy as np
import pytest
import torch

from planarslam_tpu import config as jconfig
from planarslam_tpu.io import synthetic
from planarslam_tpu.slam import serialization as jser
from planarslam_tpu.slam.map import SlamMap as JSlamMap
from planarslam_tpu.viz import mesh as jmesh
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.io.frames import quantize_frame
from planarslam_tpu_torch.slam import serialization as tser
from planarslam_tpu_torch.slam.map import SlamMap as TSlamMap
from planarslam_tpu_torch.slam.system import System as TSystem
from planarslam_tpu_torch.slam.tracking import TrackingState
from planarslam_tpu_torch.viz import mesh as tmesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tracked():
    """The port's System after 10 tracked frames of the tiny sequence, with
    local mapping on and a keyframe every 4 frames."""
    import dataclasses

    cfg = tconfig.SystemConfig.tiny()
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=4))
    seq = synthetic.make_sequence(10, width=cfg.camera.width,
                                  height=cfg.camera.height)
    slam = TSystem(config=cfg, enable_loop_closing=False, device="cpu")
    for i in range(len(seq)):
        slam.track_rgbd(*quantize_frame(*seq.render(i),
                                        cfg.camera.depth_map_factor),
                        seq.timestamps[i])
    slam.shutdown()
    assert slam.map.n_kf >= 2 and int(slam.map.pt_valid.sum()) > 100
    assert int(slam.map.pl_valid.sum()) >= 1
    return slam


def _assert_maps_equal(a, b):
    """Every array and counter of two maps (of either package) equal."""
    names = sorted(n for n in vars(a) if n != "cfg")
    assert names == sorted(n for n in vars(b) if n != "cfg")
    n_arrays = 0
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
            n_arrays += 1
        else:
            assert va == vb, name
    assert n_arrays > 30


def test_port_map_loads_in_jax_package(tracked, tmp_path):
    """System.save_map of the port -> the JAX package's load_map: every
    array and counter equal (exact)."""
    path = str(tmp_path / "port_map.npz")
    tracked.save_map(path)
    jmap = jser.load_map(path, jconfig.SystemConfig.tiny())
    assert isinstance(jmap, JSlamMap)
    _assert_maps_equal(jmap, tracked.map)


def test_jax_map_loads_in_port(tracked, tmp_path):
    """A map saved by the JAX package's save_map (the tracked map carried
    into a JAX SlamMap, with changed poses and counters so that it is not
    the file the port wrote) -> System.load_map of the port: every array
    and counter equal, the tracker LOST on the last valid keyframe, the
    backend's keyframe cursor at the end."""
    path = str(tmp_path / "port_map.npz")
    tracked.save_map(path)
    jcfg = jconfig.SystemConfig.tiny()
    jmap = jser.load_map(path, jcfg)
    jmap.kf_pose[1, :3, 3] += np.float32(0.25)
    jmap.pt_xyz[jmap.pt_valid] *= np.float32(1.5)
    jmap.n_loop_edges = int(jmap.n_loop_edges) + 1
    jpath = str(tmp_path / "jax_map.npz")
    jser.save_map(jpath, jmap)

    slam = TSystem(config=tracked.cfg, enable_loop_closing=False,
                   device="cpu")
    slam.load_map(jpath)
    assert isinstance(slam.map, TSlamMap)
    _assert_maps_equal(slam.map, jmap)
    assert slam.get_tracking_state() == TrackingState.LOST
    assert slam.tracker.ref_kf == int(jmap.valid_kf_ids()[-1])
    assert slam.tracker.frame_id == int(
        jmap.kf_frame_id[:jmap.n_kf].max()) + 1
    assert slam._next_backend_kf == jmap.n_kf and slam._backend_kf is None
    assert slam.tracker.map is slam.map and slam.local_mapper.map is slam.map
    # and the module-level functions of the port round-trip their own file
    tser.save_map(str(tmp_path / "again.npz"), slam.map)
    _assert_maps_equal(tser.load_map(str(tmp_path / "again.npz"),
                                     tracked.cfg), jmap)


def test_save_mesh_same_file(tracked, tmp_path):
    """save_mesh of the port's System and the JAX package's
    save_planar_mesh write byte-identical PLY files for the same map, with
    vertices and faces in them."""
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tracked.save_mesh(a)
    jmesh.save_planar_mesh(b, tracked.map)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    n_vertices, n_faces = tmesh.read_ply_counts(a)
    assert n_vertices > 10 and n_faces > 5


def test_load_map_rejects_other_capacities(tracked, tmp_path):
    """A checkpoint of the tiny configuration does not load under the
    default one: the port raises as the JAX package does."""
    path = str(tmp_path / "port_map.npz")
    tracked.save_map(path)
    with pytest.raises(ValueError):
        tser.load_map(path, tconfig.SystemConfig())
    with pytest.raises(ValueError):
        jser.load_map(path, jconfig.SystemConfig())
