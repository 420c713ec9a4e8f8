"""Port parity: configuration, SE(3)/plane geometry, fixed tables, and the
port's independence from JAX.

The same numpy inputs go through the JAX package and planarslam_tpu_torch
(on the CPU); tolerances are stated per test.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import plane as jplane
from planarslam_tpu.geometry import se3 as jse3
from planarslam_tpu.ops import fast as jfast
from planarslam_tpu.ops import image as jimage
from planarslam_tpu.ops import orb as jorb
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.geometry import plane as tplane
from planarslam_tpu_torch.geometry import se3 as tse3
from planarslam_tpu_torch.ops import fast as tfast
from planarslam_tpu_torch.ops import image as timage
from planarslam_tpu_torch.ops import lines as tlines
from planarslam_tpu_torch.ops import orb as torb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["default", "tiny"])
def test_config_equal(name):
    """The copied config is field-for-field the JAX config."""
    if name == "default":
        j, t = jconfig.SystemConfig(), tconfig.SystemConfig()
    else:
        j, t = jconfig.SystemConfig.tiny(), tconfig.SystemConfig.tiny()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_fixed_tables_equal():
    """Tables rebuilt from numpy seeds equal the JAX package's (exact)."""
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(torb.make_brief_pattern(1234),
                                  jorb.make_brief_pattern(1234))
    for a, b in ((torb._MASK, jorb._MASK), (torb._DX, jorb._DX),
                 (torb._DY, jorb._DY)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfast.CIRCLE_OFFSETS, jfast.CIRCLE_OFFSETS)
    for ksize, sigma in ((7, 2.0), (5, 1.0)):
        np.testing.assert_array_equal(timage.gaussian_kernel_1d(ksize, sigma),
                                      jimage.gaussian_kernel_1d(ksize, sigma))
    # the 2-point RANSAC table of ops/lines.py:lift_lines_3d, built with the
    # JAX module's own numpy steps
    for S, iters in ((48, 32), (24, 16)):
        rng = np.random.default_rng(99)
        hyp = rng.integers(0, S, (iters, 2))
        hyp[:, 1] = (hyp[:, 0] + 1 + rng.integers(0, S - 1, iters)) % S
        np.testing.assert_array_equal(tlines.ransac_table(S, iters), hyp)


def test_se3_parity(rng):
    """exp/log/inverse/transform/project/quaternions: atol 1e-5 (float32
    transcendental ulps)."""
    xi = rng.normal(0, 0.5, (16, 6)).astype(np.float32)
    Tj = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Tt = tse3.se3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    np.testing.assert_allclose(tse3.se3_log(_t(Tj)).numpy(),
                               np.asarray(jse3.se3_log(jnp.asarray(Tj))),
                               atol=1e-4)
    np.testing.assert_allclose(tse3.T_inv(_t(Tj)).numpy(),
                               np.asarray(jse3.T_inv(jnp.asarray(Tj))),
                               atol=1e-6)
    pts = rng.normal(0, 2.0, (16, 20, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 0.5
    np.testing.assert_allclose(
        tse3.transform_points(_t(Tj), _t(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(Tj), jnp.asarray(pts))),
        atol=1e-5)
    K = (500.0, 510.0, 320.0, 240.0)
    np.testing.assert_allclose(
        tse3.project(K, _t(pts)).numpy(),
        np.asarray(jse3.project(K, jnp.asarray(pts))), rtol=1e-6, atol=1e-4)
    w = rng.normal(0, 1.5, (32, 3))
    R = Rotation.from_rotvec(w).as_matrix().astype(np.float32)
    np.testing.assert_allclose(
        tse3.R_to_quat(_t(R)).numpy(),
        np.asarray(jse3.R_to_quat(jnp.asarray(R))), atol=1e-5)
    q = Rotation.from_rotvec(w).as_quat().astype(np.float32)
    np.testing.assert_allclose(tse3.quat_to_R(_t(q)).numpy(),
                               np.asarray(jse3.quat_to_R(jnp.asarray(q))),
                               atol=1e-6)


def test_orthonormalize_parity(rng):
    """Polar projection onto SO(3) equals the JAX SVD projection (atol 1e-5),
    including inputs with negative determinant."""
    w = rng.normal(0, 1.0, (32, 3))
    R = Rotation.from_rotvec(w).as_matrix()
    noisy = (R + rng.normal(0, 0.05, R.shape)).astype(np.float32)
    noisy[:4] *= -1.0  # det < 0
    Rt = tse3.orthonormalize(_t(noisy)).numpy()
    Rj = np.asarray(jax.vmap(jse3.orthonormalize)(jnp.asarray(noisy)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-5)


def test_plane_parity(rng):
    """Plane normalize/transform and the three minimal-chart errors:
    atol 1e-6."""
    c = rng.normal(0, 1.0, (24, 4)).astype(np.float32)
    m = rng.normal(0, 1.0, (24, 4)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.3, 6).astype(np.float32))))
    pairs = [
        (tplane.normalize(_t(c)), jplane.normalize(jnp.asarray(c))),
        (tplane.transform(_t(T), _t(c)),
         jplane.transform(jnp.asarray(T), jnp.asarray(c))),
        (tplane.ominus(_t(c), _t(m)),
         jplane.ominus(jnp.asarray(c), jnp.asarray(m))),
        (tplane.ominus_par(_t(c), _t(m)),
         jplane.ominus_par(jnp.asarray(c), jnp.asarray(m))),
        (tplane.ominus_ver(_t(c), _t(m)),
         jplane.ominus_ver(jnp.asarray(c), jnp.asarray(m))),
    ]
    for t_out, j_out in pairs:
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   atol=1e-6)


# modules the port carries as copies of the JAX package's numpy-only code
COPIED = ["config.py", "io/__init__.py", "io/synthetic.py", "io/tum.py",
          "evaluation/__init__.py", "evaluation/ate.py", "slam/map.py",
          "slam/retrieval.py", "native/mapcore.cpp", "native/__init__.py",
          "slam/serialization.py", "viz/__init__.py", "viz/mesh.py",
          "viz/render.py", "viz/html_viewer.py", "viz/live_viewer.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    """Each copied file equals its original once the package name is
    normalized; native/__init__.py may differ only in its docstring and in
    where _build puts the library (compared from get_lib on); config.py
    may differ only in comments and docstrings, which describe the port
    (its code is compared as a syntax tree with the docstrings dropped)."""
    def read(pkg):
        with open(os.path.join(REPO, pkg, rel)) as f:
            return f.read().replace("planarslam_tpu_torch", "planarslam_tpu")

    def code_only(src):
        tree = ast.parse(src)
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                del body[0]
        return ast.dump(tree)

    orig, copy = read("planarslam_tpu"), read("planarslam_tpu_torch")
    if rel == "native/__init__.py":
        start = "\ndef get_lib("
        orig, copy = orig[orig.index(start):], copy[copy.index(start):]
    elif rel == "config.py":
        orig, copy = code_only(orig), code_only(copy)
    assert copy == orig


def test_quantize_frame():
    """Frames quantize as an RGB-D camera stores them (bench.py's format):
    gray rounded half-to-even and clipped to uint8, depth in units of
    1 / depth_map_factor m clipped to uint16."""
    from planarslam_tpu_torch.io.frames import quantize_frame

    gray = np.array([[-5.0, 12.5, 13.5, 255.6]], np.float32)
    depth = np.array([[0.0, 0.0003, 1.0, 14.0]], np.float32)
    g8, d16 = quantize_frame(gray, depth, 5000.0)
    assert g8.dtype == np.uint8 and d16.dtype == np.uint16
    np.testing.assert_array_equal(g8, [[0, 12, 14, 255]])
    np.testing.assert_array_equal(d16, [[0, 2, 5000, 65535]])


def test_port_never_imports_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import planarslam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'planarslam_tpu' or n.startswith('planarslam_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_h2d_copies_counted_by_issuing_op():
    """chip_smoke.py counts a host-to-device copy in the frame span of the
    host op that issued it, whatever device time the profiler gives the
    copy: here 30 ms before its op, past the half gap that a copy with no
    host op is allowed, which counts by its device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, REPO)
    import chip_smoke

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"h2d_frame_{i}"):
                torch.ones(3).to(torch.float64)
    raw = list(prof.profiler.kineto_results.events())
    ops = [e for e in raw if e.name() == "aten::copy_"]
    span2 = next(e for e in raw if e.name() == "h2d_frame_2")
    gap_ns = int(chip_smoke.H2D_GAP_S * 1e9)

    class Copy:
        def __init__(self, linked, start):
            self.linked, self.start = linked, start

        def name(self):
            return "Memcpy HtoD (Pinned -> Device)"

        def device_type(self):
            return "DeviceType.CUDA"

        def linked_correlation_id(self):
            return self.linked

        def start_ns(self):
            return self.start

    got = chip_smoke._h2d_by_span(
        raw + [Copy(ops[1].correlation_id(),
                    ops[1].start_ns() - 3 * gap_ns // 2),
               Copy(ops[2].correlation_id(), ops[2].start_ns() + 40_000),
               Copy(0, span2.start_ns() - 2 * gap_ns // 5)],
        prof.events(), "h2d_frame_", "test")
    assert got["frames"] == [0, 1, 2]
    assert got["copies"] == {1: 1, 2: 2}
    assert got["asked_by"][1] == {
        "aten::to < aten::_to_copy < aten::copy_": 1}
    assert got["asked_by"][2]["(no host op)"] == 1
    assert got["unlinked"] == 1
    assert got["device_minus_issue_us"] == [-1.5 * gap_ns / 1e3, 40.0]
