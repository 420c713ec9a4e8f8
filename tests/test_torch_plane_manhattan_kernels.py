"""Port parity of the plain versions of kernels K12-K15 (plane segmentation
after the block moments, Manhattan mean shift) against the JAX package on
the CPU, stage by stage, and the wrappers' refusal to run a plain version
on CUDA-typed inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch._subclasses.fake_tensor import FakeTensorMode

from chip_smoke import (LABEL_FIT_KEYS, LABEL_PLANTED, label_args,
                        planted_label_lanes)
from planarslam_tpu import config as jconfig
from planarslam_tpu.geometry import plane as jplane_geo
from planarslam_tpu.io import synthetic
from planarslam_tpu.ops import manhattan as jmanh
from planarslam_tpu.ops import planes as jplanes
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.ops import manhattan as tmanh
from planarslam_tpu_torch.ops import planes as tplanes

torch.set_num_threads(2)

JC = jconfig.SystemConfig.tiny()
TC = tconfig.SystemConfig.tiny()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def depths():
    clean = synthetic.make_sequence(8, width=160, height=120)
    noisy = synthetic.make_sequence(8, width=160, height=120,
                                    depth_noise=1.0, noise_model="kinect")
    # Frame 0 of each: no block fit and no pixel of it sits on a gate, so
    # the integer outputs can be held exactly. (A value on its threshold
    # may round to either side in the two frameworks; on other frames of
    # these sequences one block or a few pixels do flip.)
    return {"clean": np.array(clean.render(0)[1], np.float32),
            "noisy": np.array(noisy.render(0)[1], np.float32)}


def _plane_cfgs(stride: int):
    return (dataclasses.replace(JC.planes, refine_stride=stride),
            dataclasses.replace(TC.planes, refine_stride=stride))


def _port_stages(depth, pc):
    """alpha, K4's moments (plain on the CPU) and K12's candidates."""
    d = _t(depth)
    h, w = d.shape
    alpha = tplanes._noise_alpha(d, pc.max_distance)
    stats = tplanes.plane_block_moments(d, alpha, TC.camera,
                                        tplanes._geo_tol(w), pc.max_distance,
                                        pc.block)
    cand = tplanes.plane_components(stats, h // pc.block, w // pc.block, pc)
    return d, alpha, cand


@pytest.mark.parametrize("stop", ["blocks", "cc", "topk"])
@pytest.mark.parametrize("which", ["clean", "noisy"])
def test_plane_components_plain(which, stop, depths):
    """K12's plain version against extract_planes_debug at its stop points:
    block validity ("blocks"), component labels ("cc") and candidate
    validity ("topk") exact; candidate normals and offsets atol 2e-3 where
    valid (the float32 segment sums of the two frameworks add a
    component's blocks in different orders and the covariance built from
    them cancels terms of size z^2, so a candidate moves by up to 7e-4 on
    these frames; candidates only seed the pixel rounds, whose refits the
    other tests hold tighter); clean and Kinect-noise depth."""
    depth = depths[which]
    want = jplanes.extract_planes_debug(jnp.asarray(depth), JC.camera,
                                        JC.planes, stop=stop)
    _, _, cand = _port_stages(depth, TC.planes)
    assert cand.labels.dtype == torch.int32
    if stop == "blocks":
        assert int(np.asarray(want[4]).sum()) > 20
        np.testing.assert_array_equal(cand.block_valid.numpy(),
                                      np.asarray(want[4]))
    elif stop == "cc":
        np.testing.assert_array_equal(cand.labels.numpy(), np.asarray(want))
    else:
        normal_c, d_c, _, _, cand_valid = (np.asarray(x) for x in want)
        assert cand_valid.sum() >= 2
        np.testing.assert_array_equal(cand.valid.numpy(), cand_valid)
        np.testing.assert_allclose(cand.normal.numpy()[cand_valid],
                                   normal_c[cand_valid], atol=2e-3)
        np.testing.assert_allclose(cand.d.numpy()[cand_valid],
                                   d_c[cand_valid], atol=2e-3)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("which", ["clean", "noisy"])
def test_plane_assign_refit_plain_round1(which, stride, depths):
    """K13's plain version, round 1, against extract_planes_debug
    (stop="assign") at refine_stride 1 and 2. Clean depth: support exact,
    normals, offsets and centroids atol 1e-4, mse atol 1e-4 (the covariance
    cancels terms of size z^2; the two float32 matmuls sum in different
    orders). Kinect-noise depth: a pixel at its band edge may flip, so
    support rtol 2e-3 and the fits atol 2e-3."""
    depth = depths[which]
    jpc, tpc = _plane_cfgs(stride)
    want = [np.asarray(x) for x in jplanes.extract_planes_debug(
        jnp.asarray(depth), JC.camera, jpc, stop="assign")]
    d, alpha, cand = _port_stages(depth, tpc)
    fit = tplanes.plane_assign_refit(d, alpha, TC.camera, tpc, cand.normal,
                                     cand.d, cand.valid)
    assert fit.label_sub.dtype == torch.int32
    assert fit.label_sub.numel() == (-(-120 // stride)) * (-(-160 // stride))
    assert torch.equal(fit.alive, cand.valid)
    m = cand.valid.numpy() & (want[4] > 3)
    assert m.sum() >= 2
    if which == "clean":
        np.testing.assert_array_equal(fit.n.numpy(), want[4])
        tol = 1e-4
    else:
        np.testing.assert_allclose(fit.n.numpy(), want[4], rtol=2e-3)
        tol = 2e-3
    for got, ref in zip((fit.normal, fit.d, fit.mse, fit.mean), want[:4]):
        np.testing.assert_allclose(got.numpy()[m], ref[m], atol=tol)


@pytest.mark.parametrize("which", ["clean", "noisy"])
def test_plane_rounds_and_labels_stride2(which, depths):
    """The composition of the plain versions (K12, three rounds of K13,
    K14) at refine_stride 2, where K14 labels the full-resolution pixels
    itself, against the full JAX extract_planes, to the limits of
    test_extract_planes_parity: validity exact; clean depth: counts and
    labels exact, coefficients and centroids atol 1e-4; Kinect-noise depth:
    labels equal on >= 99.5% of pixels, counts rtol 2e-3, coefficients and
    centroids atol 2e-3."""
    depth = depths[which]
    jpc, tpc = _plane_cfgs(2)
    pj = jplanes.extract_planes(jnp.asarray(depth), JC.camera, jpc)
    d, alpha, cand = _port_stages(depth, tpc)
    fit = tplanes.plane_assign_refit(d, alpha, TC.camera, tpc, cand.normal,
                                     cand.d, cand.valid)
    for _ in range(tpc.refine_rounds):
        fit = tplanes.plane_assign_refit(
            d, alpha, TC.camera, tpc, fit.normal, fit.d, fit.alive,
            (fit.mse, fit.mean, fit.n))
    pt = tplanes.plane_label_pixels(d, alpha, TC.camera, tpc, fit)
    whole = tplanes.extract_planes(d, TC.camera, tpc)
    for a, b in zip(pt, whole):
        assert torch.equal(a, b)
    assert int(np.asarray(pj.valid).sum()) > 0
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
    lbl_t, lbl_j = pt.pixel_label.numpy(), np.asarray(pj.pixel_label)
    if which == "clean":
        np.testing.assert_array_equal(pt.count.numpy(), np.asarray(pj.count))
        np.testing.assert_array_equal(lbl_t, lbl_j)
        tol = 1e-4
    else:
        np.testing.assert_allclose(pt.count.numpy(), np.asarray(pj.count),
                                   rtol=2e-3)
        assert np.mean(lbl_t == lbl_j) >= 0.995
        tol = 2e-3
    np.testing.assert_allclose(pt.coeffs.numpy(), np.asarray(pj.coeffs),
                               atol=tol)
    np.testing.assert_allclose(pt.centroid.numpy(), np.asarray(pj.centroid),
                               atol=tol)


def _jax_label_pixels(depth, alpha, cam, cfg, fit):
    """planarslam_tpu/ops/planes.py::extract_planes' depth gate (:223-262,
    alpha given) and its final gate and full-resolution labeling
    (:439-473) over a given last refit, in JAX."""
    h, w = depth.shape
    label_sub, normal_f, d_f, mse_f, mean_f, n_p, cand_valid = fit
    p_cap = normal_f.shape[0]
    points = jplanes.backproject_depth(depth, cam)
    depth_ok = (depth > 1e-6) & (depth < cfg.max_distance)
    z2 = jnp.maximum(depth, 1.0) ** 2
    tol = jnp.maximum(0.02 * (640.0 / w) * jnp.maximum(depth, 1.0),
                      3.0 * jnp.sqrt(2.0) * alpha * z2)
    jump_r = jnp.abs(depth - jnp.roll(depth, -1, axis=1))
    jump_d = jnp.abs(depth - jnp.roll(depth, -1, axis=0))
    jump_r = jump_r.at[:, -1].set(0.0)
    jump_d = jump_d.at[-1, :].set(0.0)
    depth_ok = depth_ok & (jump_r < tol) & (jump_d < tol)
    count = n_p.astype(jnp.int32)
    mse_gate = jnp.maximum(cfg.distance_threshold,
                           2.0 * alpha * mean_f[:, 2] ** 2) ** 2
    valid = cand_valid & (count >= cfg.min_size) & (mse_f < mse_gate)
    coeffs = jplane_geo.normalize(jnp.concatenate([normal_f, d_f[:, None]],
                                                  axis=-1))
    coeffs = jnp.where(valid[:, None], coeffs, 0.0)
    if max(1, int(cfg.refine_stride)) == 1:
        label_pix = label_sub
    else:
        pts_flat = points.reshape(-1, 3)
        band_pix = jnp.maximum(cfg.distance_threshold,
                               3.0 * alpha * z2).reshape(-1)
        dist_full = jnp.abs(pts_flat @ normal_f.T + d_f[None, :])
        dist_full = jnp.where(valid[None, :], dist_full, jnp.inf)
        best_f = jnp.argmin(dist_full, axis=-1)
        best_fd = jnp.min(dist_full, axis=-1)
        tau_f = jnp.maximum(2.5 * jnp.sqrt(jnp.maximum(mse_f, 0.0)), 1e-3)
        keep_f = (best_fd < jnp.minimum(tau_f[best_f], band_pix)) \
            & depth_ok.reshape(-1)
        label_pix = jnp.where(keep_f, best_f, p_cap).astype(jnp.int32)
    pixel_label = jnp.where(
        (label_pix < p_cap) & valid[jnp.clip(label_pix, 0, p_cap - 1)],
        label_pix, -1).reshape(h, w)
    return coeffs, mean_f, count, valid, pixel_label


@pytest.mark.parametrize("stride", [2, 1])
@pytest.mark.parametrize("case", LABEL_PLANTED)
def test_plane_label_pixels_planted(case, stride):
    """K14's plain version against the JAX lines it replaces on
    chip_smoke's LABEL_PLANTED problems (0, 1 and 16 planes through the
    final gate, identical and negated planes, depth holes, jumps and far
    depths at the right and bottom edges, 64x48, 643x481, 640x480 and
    1280x960) at refine_stride 2 and 1: validity, counts, centroids and
    labels exact, coefficients atol 1e-6 (the unit normal's norm, summed
    in each framework's order)."""
    lanes = planted_label_lanes(case, 1)
    cfg = tconfig.SystemConfig()
    depth, alpha, cam, pc, fit = label_args(lanes, cfg, stride, "cpu", 0)
    got = tplanes.plane_label_pixels(depth, alpha, cam, pc, fit)
    jcam = dataclasses.replace(JC.camera, **{
        k: getattr(cam, k) for k in ("fx", "fy", "cx", "cy", "width",
                                     "height")})
    jpc = dataclasses.replace(jconfig.SystemConfig().planes,
                              refine_stride=stride, min_size=pc.min_size)
    want = [np.asarray(x) for x in _jax_label_pixels(
        jnp.asarray(lanes["depth"][0]), jnp.float32(lanes["alpha"][0]),
        jcam, jpc, [jnp.asarray(lanes[k][0]) for k in LABEL_FIT_KEYS])]
    np.testing.assert_allclose(got.coeffs.numpy(), want[0], atol=1e-6)
    for name, g, w in zip(("centroid", "count", "valid", "pixel_label"),
                          got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    n_valid = {"alive0": 0, "alive1": 1, "alive16": 16, "ties": 15,
               "edges": 16}[case]
    assert int(got.valid.sum()) == n_valid
    if stride == 2 and case == "ties":  # the first of equal distances
        labels = set(np.unique(want[4]).tolist())
        assert {0, 2} <= labels and not {1, 3} & labels


@pytest.mark.parametrize("case", ["alive1", "ties", "edges"])
def test_extract_planes_planted_depths(case):
    """The plain versions' extract_planes (K4, K12, the rounds of K13,
    K14) against JAX's on LABEL_PLANTED's depth maps at the default
    configuration (refine_stride 2): validity and labels exact; counts
    rtol 2e-3, coefficients and centroids atol 2e-3, the limits
    test_plane_rounds_and_labels_stride2 holds noisy depth to, where a
    pixel of the refine rounds sits at a gate (the planted planes are
    quantized at 0.2 mm, so a far plane's float32 mse is a cancellation
    residual of either sign, its tau 1 or 3.6 mm: the two frameworks'
    rounds, which sum in other orders, may give it a few subsampled pixels
    more or fewer, "edges"' plane 12 two, which move its centroid 1e-3)."""
    lanes = planted_label_lanes(case, 1)
    cfg = tconfig.SystemConfig()
    depth, _, cam, _, _ = label_args(lanes, cfg, 2, "cpu", 0)
    jcam = dataclasses.replace(JC.camera, **{
        k: getattr(cam, k) for k in ("fx", "fy", "cx", "cy", "width",
                                     "height")})
    pj = jplanes.extract_planes(jnp.asarray(lanes["depth"][0]), jcam,
                                jconfig.SystemConfig().planes)
    pt = tplanes.extract_planes(depth, cam, cfg.planes)
    assert int(np.asarray(pj.valid).sum()) > 0
    for name in ("valid", "pixel_label"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(pt.count.numpy(), np.asarray(pj.count),
                               rtol=2e-3)
    for name in ("coeffs", "centroid"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)), atol=2e-3,
                                   err_msg=name)


def _manhattan_scene(case: str):
    """Seeded unit normals scattered (sigma 0.03) around the three axes of
    a known frame, 300 / 200 / 120 of them, plus 150 random directions and
    30 zero rows marked invalid; "axis_missing" leaves the third axis 10
    normals (under min_support 20), "one_axis" the second and third."""
    rng = np.random.default_rng(11)
    R_true = Rotation.from_rotvec([0.3, -0.5, 0.2]).as_matrix()
    counts = {"full": (300, 200, 120), "axis_missing": (300, 200, 10),
              "one_axis": (300, 10, 10)}[case]
    rows = []
    for k, n in enumerate(counts):
        v = R_true[:, k] * rng.choice([-1.0, 1.0], (n, 1))
        rows.append(v + rng.normal(0, 0.03, (n, 3)))
    rows.append(rng.normal(0, 1, (150, 3)))
    normals = np.concatenate(rows)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    # random directions inside a cone would vote: keep them outside
    inside = np.abs(normals[-150:] @ R_true).max(axis=1) > 0.93
    normals[-150:][inside] = 0.0
    valid = np.linalg.norm(normals, axis=1) > 0.5
    normals = np.concatenate([normals, np.zeros((30, 3))])
    valid = np.concatenate([valid, np.zeros(30, bool)])
    R0 = R_true @ Rotation.from_rotvec([0.03, -0.02, 0.01]).as_matrix()
    return (R0.astype(np.float32), normals.astype(np.float32), valid)


@pytest.mark.parametrize("cone", ["track", "project"])
@pytest.mark.parametrize("case", ["full", "axis_missing", "one_axis"])
def test_track_manhattan_frame_plain(case, cone):
    """K15's plain version against the JAX function at both cone sines:
    with three supported axes, with one axis under min_support (the
    cross-product completion) and with only one axis left (success false,
    R_cm returned unchanged). Support counts, axis count and success exact,
    R_cm atol 1e-5."""
    R0, normals, valid = _manhattan_scene(case)
    mc = JC.manhattan
    kw = dict(cone_sin=getattr(mc, f"cone_sin_{cone}"),
              kernel=mc.mean_shift_kernel, min_support=mc.min_axis_support)
    rj = jmanh.track_manhattan_frame(jnp.asarray(R0), jnp.asarray(normals),
                                     jnp.asarray(valid), **kw)
    rt = tmanh.track_manhattan_frame(_t(R0), _t(normals), _t(valid), **kw)
    np.testing.assert_array_equal(rt.axis_support.numpy(),
                                  np.asarray(rj.axis_support))
    n_axes = {"full": 3, "axis_missing": 2, "one_axis": 1}[case]
    assert int(rt.n_axes) == int(rj.n_axes) == n_axes
    assert bool(rt.success) == bool(rj.success) == (n_axes >= 2)
    np.testing.assert_allclose(rt.R_cm.numpy(), np.asarray(rj.R_cm),
                               atol=1e-5)
    if case == "one_axis":
        np.testing.assert_array_equal(rt.R_cm.numpy(), R0)
    else:
        assert np.abs(rt.R_cm.numpy() - R0).max() > 1e-3


def _fake_cuda(shape, dtype=torch.float32):
    """A CUDA-typed tensor that needs no card (no storage behind it)."""
    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype, device="cuda")


def _wrapper_calls(bad=None):
    """Each new wrapper as a call on CUDA-typed inputs at the tiny config's
    shapes; `bad` swaps one argument for a wrong dtype or shape."""
    pc, cam = TC.planes, TC.camera
    P, B = pc.max_planes, 15 * 20
    f = _fake_cuda
    stats = tplanes._BlockStats(f((B, 3)), f((B, 3, 3)), f((B,)))
    depth, alpha = f((120, 160)), f(())
    normal, d, valid = f((P, 3)), f((P,)), f((P,), torch.bool)
    fit3 = (f((P,)), f((P, 3)), f((P,)))
    fit = tplanes.PlaneRefit(f((120 * 160,), torch.int32), normal, d,
                             *fit3, valid)
    R, nrm, ok = f((3, 3)), f((64, 3)), f((64,), torch.bool)
    if bad == "dtype":
        stats = stats._replace(s1=f((B, 3), torch.float64))
        depth = f((120, 160), torch.float64)
        nrm = f((64, 3), torch.float64)
    elif bad == "shape":
        stats = stats._replace(n=f((B + 1,)))
        d = f((P + 1,))
        fit = fit._replace(d=d)
        ok = f((63,), torch.bool)
    return {
        "plane_components": lambda: tplanes.plane_components(stats, 15, 20,
                                                             pc),
        "plane_assign_refit": lambda: tplanes.plane_assign_refit(
            depth, alpha, cam, pc, normal, d, valid, fit3),
        "plane_label_pixels": lambda: tplanes.plane_label_pixels(
            depth, alpha, cam, pc, fit),
        "manhattan_mean_shift": lambda: tmanh.track_manhattan_frame(
            R, nrm, ok),
    }


WRAPPERS = ["plane_components", "plane_assign_refit", "plane_label_pixels",
            "manhattan_mean_shift"]


def _forbid_plain(monkeypatch):
    def forbidden(*args, **kw):
        raise AssertionError("a CUDA input reached a plain version")

    for mod, name in ((tplanes, "plane_components_plain"),
                      (tplanes, "plane_assign_refit_plain"),
                      (tplanes, "plane_label_pixels_plain"),
                      (tmanh, "track_manhattan_frame_plain")):
        monkeypatch.setattr(mod, name, forbidden)


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrapper_without_card_raises(monkeypatch, name):
    """On CUDA-typed inputs without a card a wrapper raises (it cannot
    allocate its outputs or build its kernel) and never takes its plain
    version."""
    _forbid_plain(monkeypatch)
    with pytest.raises(Exception) as err:
        _wrapper_calls()[name]()
    assert "plain version" not in str(err.value)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrapper_rejects_bad_input(monkeypatch, name, bad):
    """A wrong dtype raises TypeError and a wrong shape ValueError, from
    the wrapper's own checks, before anything is allocated or launched."""
    _forbid_plain(monkeypatch)
    with pytest.raises(TypeError if bad == "dtype" else ValueError,
                       match="expected"):
        _wrapper_calls(bad)[name]()


def test_extract_planes_mixed_devices_raises():
    """CPU and CUDA-typed inputs in one call raise instead of choosing."""
    with pytest.raises(ValueError, match="all be CPU tensors or all"):
        tplanes.plane_assign_refit(
            torch.zeros((120, 160)), _fake_cuda(()), TC.camera, TC.planes,
            torch.zeros((8, 3)), torch.zeros((8,)),
            torch.zeros((8,), dtype=torch.bool))


def test_assign_flags_allocated_once():
    """K13's flag words: one buffer per (device, stream), zeroed at the
    stream's first request and the same words afterwards (the kernel's
    collectors clear them); another stream gets its own; a first request
    inside a CUDA graph capture raises, since the zeroing would then run
    only at replay."""
    dev = torch.device("cpu")
    keys = [(dev, s) for s in (1, 2, 3)]
    for k in keys:
        tplanes._FLAGS.pop(k, None)
    try:
        a = tplanes._assign_flags(dev, 1, 150, False)
        assert a.dtype == torch.int32 and a.shape == (150,) and not a.any()
        assert tplanes._assign_flags(dev, 1, 150, False) is a
        assert tplanes._assign_flags(dev, 1, 150, True) is a
        b = tplanes._assign_flags(dev, 2, 150, False)
        assert b is not a and b.shape == (150,) and not b.any()
        with pytest.raises(RuntimeError, match="capturing stream"):
            tplanes._assign_flags(dev, 3, 150, True)
        assert (dev, 3) not in tplanes._FLAGS
    finally:
        for k in keys:
            tplanes._FLAGS.pop(k, None)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_plane_assign_refit_rejects_bad_partial(bad):
    """K13's partial-sum buffer, when the caller gives one, is held to the
    float64 (F, n_part, P, 10) the kernel writes before anything is
    launched."""
    pc = TC.planes
    p_cap, rs = pc.max_planes, max(1, int(pc.refine_stride))
    n_part = -(-(-(-120 // rs) * -(-160 // rs))
               // tplanes.ASSIGN_PIXELS_PER_BLOCK)
    f = _fake_cuda
    part = f((1, n_part + (bad == "shape"), p_cap, 10),
             torch.float32 if bad == "dtype" else torch.float64)
    with pytest.raises(TypeError if bad == "dtype" else ValueError,
                       match="partial"):
        tplanes.plane_assign_refit(
            f((120, 160)), f(()), TC.camera, pc, f((p_cap, 3)), f((p_cap,)),
            f((p_cap,), torch.bool), partial=part)
