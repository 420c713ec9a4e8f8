"""Port parity for the line stage that is kernels K20-K23 on the card
(detection, band descriptors, 3D lifting, guided line search): the plain
versions against the JAX package on the CPU, stage by stage, at the tiny
configuration (160x120), with numpy references of the orders the kernels
reproduce (the exact top-E ranking with its tie rule, the peak selection
with its zero-valued picks, the wrapping gap fill, nanmedian's two middle
ranks and weights). Inputs come from the synthetic renderer or a numpy seed;
every tolerance is stated in its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _line_search_problems, _line_tie_slots
from chip_smoke import planted_top_e_maps
from chip_smoke import LIFT_CASES, P3D_TOLERANCE, lift_config
from chip_smoke import planted_lift_lanes
from planarslam_tpu import config as jconfig
from planarslam_tpu.io import synthetic
from planarslam_tpu.ops import image as jimage
from planarslam_tpu.ops import lines as jlines
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.ops import image as timage
from planarslam_tpu_torch.ops import lax_compat
from planarslam_tpu_torch.ops import lines as tlines

torch.set_num_threads(2)

JC = jconfig.SystemConfig.tiny()
TC = tconfig.SystemConfig.tiny()
H, W = 120, 160
E = min(tlines.N_EDGE, H * W)
DIAG, N_RHO = tlines.hough_shape(H, W)
CAMERA = dict(K=(TC.camera.fx, TC.camera.fy, TC.camera.cx, TC.camera.cy),
              image_wh=(float(W), float(H)))
f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(8, width=W, height=H)


@pytest.fixture(scope="module")
def gray(seq):
    """Frame 4 quantized to uint8 levels (equal gradients are common)."""
    return np.round(np.array(seq.render(4)[0], f32)).astype(f32)


def stripes():
    """A checkerboard of 4 x 4 squares with a band of diagonal stripes:
    thousands of edge pixels share each magnitude, so equal magnitudes
    straddle the E-th; the board's edges run through the border rows,
    where non-maximum suppression reads the wrapped rows."""
    y, x = np.mgrid[0:H, 0:W]
    img = np.where(((x // 4) + (y // 4)) % 2 == 0, 90.0, 170.0)
    band = np.where(((x + y) // 24) % 2 == 0, 60.0, 200.0)
    img[40:80] = band[40:80]
    return img.astype(f32)


# ---- JAX stages: planarslam_tpu/ops/lines.py::detect_lines, cut where the
# port's plain version is cut

@jax.jit
def _jax_edge_slots(blurred):
    gx, gy = jimage.sobel_gradients(blurred)
    mag = jnp.sqrt(gx * gx + gy * gy + 1e-12)
    ang = jnp.arctan2(gy, gx)
    q = jnp.mod(jnp.round(ang / (jnp.pi / 4)).astype(jnp.int32), 4)
    keep = jnp.zeros_like(mag, dtype=bool)
    for k, (dy, dx) in enumerate([(0, 1), (1, 1), (1, 0), (1, -1)]):
        fwd = jnp.roll(jnp.roll(mag, -dy, axis=0), -dx, axis=1)
        bwd = jnp.roll(jnp.roll(mag, dy, axis=0), dx, axis=1)
        keep = keep | ((q == k) & (mag >= fwd) & (mag >= bwd))
    edge = keep & (mag > 40.0)
    theta = jnp.mod(ang + jnp.pi / 2.0, jnp.pi)
    t_bin = jnp.clip((theta * 36 / jnp.pi).astype(jnp.int32), 0, 35)
    vv = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    uu = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    n_ang = theta + jnp.pi / 2.0
    rho = uu * jnp.cos(n_ang) + vv * jnp.sin(n_ang)
    score = jnp.where(edge, mag, 0.0).reshape(-1)
    return gx, gy, score, t_bin.reshape(-1), rho.reshape(-1)


@jax.jit
def _jax_hough(top_mag, flat_t, flat_r):
    bin_id = flat_t * N_RHO + jnp.clip(
        ((flat_r + DIAG) / 2.0).astype(jnp.int32), 0, N_RHO - 1)
    return jax.ops.segment_sum(jnp.where(top_mag > 0, top_mag, 0.0), bin_id,
                               num_segments=36 * N_RHO).reshape(36, N_RHO)


@jax.jit
def _jax_peaks(hough2d):
    hp = jnp.concatenate([hough2d[-1:], hough2d, hough2d[:1]], axis=0)
    local_max = jimage.maxpool_3x3(hp)[1:-1]
    peak = jnp.where(hough2d >= local_max, hough2d, 0.0).reshape(-1)
    return jax.lax.top_k(peak, TC.lines.max_lines)


@jax.jit
def _jax_longest_run(hist):
    occupied = hist > 40.0
    left = jnp.roll(occupied, 1, axis=1) | jnp.roll(occupied, 2, axis=1)
    right = jnp.roll(occupied, -1, axis=1) | jnp.roll(occupied, -2, axis=1)
    occupied = occupied | (left & right)
    idx = jnp.arange(96, dtype=jnp.int32)[None, :]
    last_zero = jax.lax.cummax(jnp.where(occupied, -1, idx), axis=1)
    run_at = jnp.where(occupied, idx - last_zero, 0)
    end = jnp.argmax(run_at, axis=1).astype(jnp.int32)
    return end - run_at.max(axis=1) + 1, end


# ---- numpy references of the orders the kernels reproduce

def top_e_reference(score: np.ndarray, e: int):
    """K20's top-E: T is the e-th largest score; every score above T and
    the first scores equal to T in pixel order are selected, then ranked by
    value descending, ties to the lower pixel."""
    t = np.sort(score)[::-1][e - 1]
    above = np.flatnonzero(score > t)
    equal = np.flatnonzero(score == t)[:e - len(above)]
    sel = np.concatenate([above, equal])
    order = np.lexsort((sel, -score[sel]))
    return score[sel[order]], sel[order]


def peaks_reference(hough2d: np.ndarray, L: int):
    """K20's peaks: a bin keeps its vote when no bin of its 3 x 3
    neighbourhood (theta wrapped, rho not) is larger; the nonzero kept
    votes ranked by value descending, ties to the lower bin; then the
    zero-scored bins in bin order."""
    nt, nr = hough2d.shape
    score = np.zeros(nt * nr, f32)
    for t in range(nt):
        for r in range(nr):
            nb = [hough2d[(t + dt) % nt, r + dr] for dt in (-1, 0, 1)
                  for dr in (-1, 0, 1) if 0 <= r + dr < nr]
            score[t * nr + r] = hough2d[t, r] if hough2d[t, r] >= max(nb) \
                else 0.0
    nz = np.flatnonzero(score > 0)
    nz = nz[np.lexsort((nz, -score[nz]))][:L]
    zeros = np.flatnonzero(~(score > 0))[:L - len(nz)]
    idx = np.concatenate([nz, zeros])
    return score[idx], idx


def run_reference(hist: np.ndarray, thr: float):
    """K20's run per line: gaps of one or two bins between occupied
    neighbours filled, wrapping around the 96 bins; then the longest run of
    occupied bins (not wrapping), the first of equal ones."""
    starts, ends = [], []
    for row in hist:
        occ = row > thr
        n = len(occ)
        fill = [occ[i] or ((occ[(i - 1) % n] or occ[(i - 2) % n])
                           and (occ[(i + 1) % n] or occ[(i + 2) % n]))
                for i in range(n)]
        best, best_end, cur = 0, 0, 0
        for i, o in enumerate(fill):
            cur = cur + 1 if o else 0
            if cur > best:
                best, best_end = cur, i
        starts.append(best_end - best + 1)
        ends.append(best_end)
    return np.array(starts), np.array(ends)


def nanmedian_reference(x: np.ndarray) -> np.float32:
    """K23's nanmedian: n non-NaN values, q = 0.5 (n - 1), the values at
    ranks floor(q) and ceil(q) (clamped to [0, n - 1]) of the ascending
    order found by counting, weighted (1 - (q - floor q), q - floor q), all
    in float32; NaN when n = 0."""
    vals = x[~np.isnan(x)]
    n = f32(len(vals))
    q = f32(0.5) * f32(n - f32(1))
    lo, hi = np.floor(q), np.ceil(q)
    hw = f32(q - lo)
    lw = f32(f32(1) - hw)
    last = f32(n - f32(1))
    r_lo = int(max(min(lo, last), 0))
    r_hi = int(max(min(hi, last), 0))
    if len(vals) == 0:
        return f32(np.nan)

    def at(r):
        for i, v in enumerate(vals):
            below = np.sum(vals < v) + np.sum(vals[:i] == v)
            if below == r:
                return v

    return f32(f32(at(r_lo) * lw) + f32(at(r_hi) * hw))


def bitonic_keys(x: np.ndarray) -> np.ndarray:
    """K23's sort in numpy: x's float32 values as unsigned keys in float
    order (NaN last), padded with NaN keys to a power of two and run
    through the kernel's bitonic network, pass by pass."""
    nan_key = np.uint32(0xFFFFFFFF)
    u = x.astype(f32).view(np.uint32)
    keys = np.where(np.isnan(x), nan_key,
                    np.where(u & np.uint32(0x80000000), ~u,
                             u | np.uint32(0x80000000))).astype(np.uint32)
    n2 = 1
    while n2 < len(x):
        n2 <<= 1
    keys = np.concatenate([keys, np.full(n2 - len(x), nan_key, np.uint32)])
    t = np.arange(n2 // 2)
    k = 2
    while k <= n2:
        j = k >> 1
        while j > 0:
            i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            p = i | j
            a, b = keys[i].copy(), keys[p].copy()
            swap = (a > b) == ((i & k) == 0)
            keys[i] = np.where(swap, b, a)
            keys[p] = np.where(swap, a, b)
            j >>= 1
        k <<= 1
    return keys


def sorted_nanmedian_reference(x: np.ndarray) -> np.float32:
    """K23's nanmedian in numpy: the bitonic keys, n the non-NaN count,
    the values at lax_compat.nanmedian's two middle ranks read off the
    sorted keys, weighted as its formula weighs them, in float32; NaN when
    n = 0."""
    keys = bitonic_keys(x)
    n = int(np.sum(~np.isnan(x)))
    q = f32(f32(0.5) * f32(f32(n) - f32(1)))
    lo, hi = np.floor(q), np.ceil(q)
    hw = f32(q - lo)
    lw = f32(f32(1) - hw)
    last = f32(f32(n) - f32(1))

    def at(r):
        if n == 0:
            return f32(np.nan)
        k = keys[int(max(min(r, last), 0))]
        v = (k & np.uint32(0x7FFFFFFF)) if k & np.uint32(0x80000000) else ~k
        return np.uint32(v).view(f32)

    return f32(f32(at(lo) * lw) + f32(at(hi) * hw))


def _wins(v, i, u, j) -> bool:
    """K23's order of (value, index) pairs: torch.argmax's."""
    vn, un = bool(np.isnan(v)), bool(np.isnan(u))
    if vn != un:
        return vn
    if vn:
        return i < j
    return bool(v > u) or (bool(v == u) and i < j)


def kernel_bests(s: np.ndarray):
    """K23's row and column bests of an (M, L) similarity matrix in numpy,
    in the kernel's reduction order: a row over each lane's segments
    (lane, lane + 32 of every 64), then a butterfly over the 32 lanes; a
    column over each warp's 4 rows, the 8 warps of a 32-row tile, then
    the tiles, each in row order."""
    M, L = s.shape
    none = (-np.inf, 2 ** 31 - 1)
    rows = []
    for r in range(M):
        lanes = []
        for lane in range(32):
            best = none
            for lg in range(0, L, 64):
                for l in (lg + lane, lg + 32 + lane):
                    if l < L and _wins(s[r, l], l, *best):
                        best = (s[r, l], l)
            lanes.append(best)
        off = 16
        while off:
            lanes = [lanes[x ^ off] if _wins(*lanes[x ^ off], *lanes[x])
                     else lanes[x] for x in range(32)]
            off >>= 1
        rows.append(lanes[0])
    cols = []
    for l in range(L):
        best = none
        for m0 in range(0, M, 32):
            tile = none
            for w0 in range(m0, min(m0 + 32, M), 4):
                warp = none
                for r in range(w0, min(w0 + 4, M)):
                    if _wins(s[r, l], r, *warp):
                        warp = (s[r, l], r)
                if _wins(*warp, *tile):
                    tile = warp
            if _wins(*tile, *best):
                best = tile
        cols.append(best[1])
    return (np.array([r[1] for r in rows]),
            np.array([r[0] for r in rows], f32), np.array(cols))


# ---- stage tests

@pytest.mark.parametrize("case", ["frame", "stripes"])
def test_edge_slots_exact(gray, case):
    """(a) The stencil and the top-E slots on the same blurred frame (the
    blur is K17's stage). Port against JAX: gradients exact; magnitudes
    within 1 ulp (XLA fuses gx * gx + gy * gy into one multiply-add on the
    CPU, PyTorch rounds the product), so edge masks agree but for 0.1% of
    the frame's pixels at such ties (2% of the stripes', where equal
    magnitudes make the suppression's comparisons ties); theta bins exact and rho within 1e-4 px at the
    slots. The top-E of the port's scores: lax_compat.top_k, the JAX
    function (approx_max_k, exact on the CPU) and the numpy reference agree
    exactly. On the stripes the E-th magnitude is shared by pixels inside
    and outside the top E, and the support runs through rows 0 and H - 1
    (non-maximum suppression against the wrapped row)."""
    g = gray if case == "frame" else stripes()
    blurred = timage.blur(_t(g), 5, 1.0)
    gx, gy, top_mag, top_pix, flat_t, flat_r = tlines._edge_slots(
        blurred, 40.0, E)
    jgx, jgy, jscore, jt, jr = map(_n, _jax_edge_slots(
        jnp.asarray(blurred.numpy())))
    # every message below carries the counts and values its check reads,
    # with the float paths in use, so that a failure names its cause
    where = (f"{case}: torch {torch.__version__} "
             f"{torch.backends.cpu.get_cpu_capability()}, jax "
             f"{jax.__version__}")
    for name, got, want in (("gx", gx.numpy(), jgx), ("gy", gy.numpy(), jgy)):
        np.testing.assert_array_equal(got, want, err_msg=(
            f"{where}: {name} differs at {int(np.sum(got != want))} "
            f"pixels"))
    # the port's score map: all pixels ranked
    _, _, all_mag, all_pix, _, _ = tlines._edge_slots(blurred, 40.0, H * W)
    score = np.zeros(H * W, f32)
    score[all_pix.numpy()] = all_mag.numpy()
    both = (score > 0) & (jscore > 0)
    rel = np.abs(score[both] - jscore[both]) / np.abs(jscore[both])
    np.testing.assert_allclose(score[both], jscore[both], rtol=2.4e-7,
                               err_msg=(f"{where}: magnitudes off by up to "
                                        f"{rel.max():.3e} relative"))
    limit = 1e-3 if case == "frame" else 0.02
    flips = np.flatnonzero((score > 0) != (jscore > 0))
    assert len(flips) / score.size < limit, (
        f"{where}: the edge masks differ at {len(flips)} of {score.size} "
        f"pixels (limit {limit * score.size:.1f}), first {flips[:8]}: port "
        f"{score[flips[:8]]}, JAX {jscore[flips[:8]]}")
    pix = top_pix.numpy()
    t_off = np.flatnonzero(flat_t.numpy() != jt[pix])
    np.testing.assert_array_equal(flat_t.numpy(), jt[pix], err_msg=(
        f"{where}: theta bins differ at {len(t_off)} slots, first "
        f"{t_off[:8]} (pixels {pix[t_off[:8]]}): port "
        f"{flat_t.numpy()[t_off[:8]]}, JAX {jt[pix][t_off[:8]]}"))
    d_rho = np.abs(flat_r.numpy() - jr[pix])
    worst = int(np.argmax(d_rho))
    np.testing.assert_allclose(flat_r.numpy(), jr[pix], atol=1e-4, err_msg=(
        f"{where}: rho off by up to {d_rho[worst]:.3e} px at slot {worst} "
        f"(pixel {pix[worst]}, magnitude {top_mag.numpy()[worst]}), "
        f"{int(np.sum(d_rho > 1e-4))} slots beyond 1e-4"))
    ref_val, ref_pix = top_e_reference(score, E)
    j_val, j_pix = jax.lax.approx_max_k(jnp.asarray(score), E,
                                        recall_target=0.95)
    for what, want_pix, want_val in (("reference", ref_pix, ref_val),
                                     ("approx_max_k", _n(j_pix), _n(j_val))):
        off = np.flatnonzero((pix != want_pix)
                             | (top_mag.numpy() != want_val))
        msg = (f"{where}: the top-E differs from the {what} at {len(off)} "
               f"slots, first {off[:4]}: port pixels {pix[off[:4]]} values "
               f"{top_mag.numpy()[off[:4]]}, {what} pixels "
               f"{want_pix[off[:4]]} values {want_val[off[:4]]}")
        np.testing.assert_array_equal(pix, want_pix, err_msg=msg)
        np.testing.assert_array_equal(top_mag.numpy(), want_val, err_msg=msg)
    if case == "stripes":
        tie = score[ref_pix[-1]]
        assert tie > 0 and np.sum(score == tie) > np.sum(ref_val == tie) > 1
        rows = ref_pix[ref_val > 0] // W
        assert np.any(rows == 0) and np.any(rows == H - 1)


def test_top_e_reference_planted():
    """(b) lax_compat.top_k (the plain version's top-E) equals the numpy
    reference and jax.lax.approx_max_k (exact on the CPU) on the planted
    scores of chip_smoke.planted_top_e_maps, which the card's selection
    stage is held to as well: 9000 distinct values with a tie of 2000
    below the E-th rank, a map with fewer than E nonzero scores (the
    zero-valued slots are the first zero pixels in pixel order), an
    all-zero map (the slots are pixels 0..E-1), and a tie at the E-th rank
    whose taken part spans three of the selection's 4-row bands and is cut
    inside one."""
    maps = planted_top_e_maps(H, W, E)
    assert list(maps) == ["tie_2000", "fewer_than_E", "all_zero",
                          "tie_across_bands"]
    for name, score2d in maps.items():
        score = score2d.reshape(-1)
        got_val, got_pix = lax_compat.top_k(_t(score), E)
        ref_val, ref_pix = top_e_reference(score, E)
        j_val, j_pix = jax.lax.approx_max_k(jnp.asarray(score), E,
                                            recall_target=0.95)
        np.testing.assert_array_equal(got_pix.numpy(), ref_pix)
        np.testing.assert_array_equal(got_val.numpy(), ref_val)
        np.testing.assert_array_equal(_n(j_pix), ref_pix)
        if name == "tie_2000":
            assert np.sum(ref_val == 80.0) < 2000
        elif name == "fewer_than_E":
            assert np.sum(ref_val == 0) == E - 3000
        elif name == "all_zero":
            np.testing.assert_array_equal(ref_pix, np.arange(E))
        else:
            tied = np.sort(ref_pix[ref_val == 80.0])
            assert len(tied) == int(7.5 * W) < np.sum(score == 80.0)
            bands = np.unique(tied // W // 4)
            assert len(bands) == 3 and (tied[-1] + 1) % (4 * W) != 0


@pytest.mark.parametrize("case", ["frame", "stripes"])
def test_hough_and_peaks_exact(gray, case):
    """(c) The Hough vote (a sum per bin in slot order) and the top-L
    peaks of the port's plain stages equal the JAX stages and the numpy
    peak reference exactly on the edge slots of a frame."""
    g = gray if case == "frame" else stripes()
    _, _, top_mag, _, flat_t, flat_r = tlines._edge_slots(
        timage.blur(_t(g), 5, 1.0), 40.0, E)
    hough = tlines._hough(top_mag, flat_t, flat_r, DIAG, N_RHO)
    jh = _jax_hough(jnp.asarray(top_mag.numpy()), jnp.asarray(flat_t.numpy()),
                    jnp.asarray(flat_r.numpy()))
    np.testing.assert_array_equal(hough.numpy(), _n(jh))
    L = TC.lines.max_lines
    val, idx = tlines._peaks(hough, L)
    jv, ji = _jax_peaks(jh)
    np.testing.assert_array_equal(idx.numpy(), _n(ji))
    np.testing.assert_array_equal(val.numpy(), _n(jv))
    rv, ri = peaks_reference(hough.numpy(), L)
    np.testing.assert_array_equal(idx.numpy(), ri)
    np.testing.assert_array_equal(val.numpy(), rv)


def test_peaks_fewer_than_L_planted():
    """(d) Peaks on a planted vote with 5 nonzero peaks (of 16 slots): one
    beside the theta seam (bin t = 35 suppressed by t = 0), a plateau of
    two equal bins (both kept), one at the last rho bin; the zero-valued
    picks are the first zero-scored bins in order. Port, JAX and the numpy
    reference agree exactly."""
    h = np.zeros((36, N_RHO), f32)
    h[0, 10], h[35, 11] = 50.0, 40.0
    h[7, 30], h[7, 31] = 25.0, 25.0
    h[20, N_RHO - 1] = 33.0
    h[12, 5] = 12.0
    L = TC.lines.max_lines
    val, idx = tlines._peaks(_t(h), L)
    jv, ji = _jax_peaks(jnp.asarray(h))
    rv, ri = peaks_reference(h, L)
    np.testing.assert_array_equal(idx.numpy(), _n(ji))
    np.testing.assert_array_equal(val.numpy(), _n(jv))
    np.testing.assert_array_equal(idx.numpy(), ri)
    np.testing.assert_array_equal(val.numpy(), rv)
    assert int((val > 0).sum()) == 5 and 35 * N_RHO + 11 not in idx[:5]
    assert idx[5] == 0


def test_longest_run_gap_fill_wraps():
    """(e) The per-line run: gap fill across the bin 95 -> 0 seam (bins 93,
    94, 1, 2 occupied fill 95 and 0), a double gap, a triple gap that
    stays, an all-empty line (run_start 1 > run_end 0: no bin in the
    run). Port, JAX and the numpy reference agree exactly."""
    hist = np.zeros((4, 96), f32)
    hist[0, [93, 94, 1, 2]] = 50.0
    hist[1, [10, 11, 14, 15, 16]] = 60.0
    hist[2, [40, 41, 45, 46, 47, 48]] = 45.0
    start, end = tlines._longest_run(_t(hist), 40.0)
    js, je = _jax_longest_run(jnp.asarray(hist))
    rs, re = run_reference(hist, 40.0)
    np.testing.assert_array_equal(start.numpy(), _n(js))
    np.testing.assert_array_equal(end.numpy(), _n(je))
    np.testing.assert_array_equal(start.numpy(), rs)
    np.testing.assert_array_equal(end.numpy(), re)
    assert (start[0], end[0]) == (0, 2) and (start[1], end[1]) == (10, 16)
    assert (start[2], end[2]) == (45, 48) and (start[3], end[3]) == (1, 0)


def test_detect_lines_plain_matches_jax(gray):
    """(f) The whole detection, the plain version on the blurred frame
    against the JAX detect_lines on the frame: validity exact, endpoints
    1e-3 px, line equations 1e-4, angles 1e-5, responses rtol 1e-5 (the
    JAX sum of a line's support runs in XLA's order). (On the stripes the
    magnitudes' ulps, (a), reorder equal magnitudes: the stages are held
    there on shared inputs instead.)"""
    g = gray
    det = tlines.detect_lines_plain(timage.blur(_t(g), 5, 1.0)[None],
                                    TC.lines)
    ref = jax.jit(jlines.detect_lines, static_argnums=(1,))(jnp.asarray(g),
                                                           JC.lines)
    names = ("uv_s", "uv_e", "line2d", "angle", "response", "valid")
    got = {n: getattr(det, n)[0].numpy() for n in names}
    want = dict(zip(names, map(_n, ref)))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() > 0
    for n, tol in (("uv_s", 1e-3), ("uv_e", 1e-3), ("line2d", 1e-4),
                   ("angle", 1e-5)):
        np.testing.assert_allclose(got[n][v], want[n][v], atol=tol,
                                   err_msg=n)
    np.testing.assert_allclose(got["response"], want["response"], rtol=1e-5)


def test_descriptors_match_jax(gray):
    """(g) The plain descriptors on the plain gradients against the JAX
    line_descriptors: the frame's lines, a segment leaving the image
    (clamped samples) and an invalid slot; atol 1e-5."""
    det = tlines.detect_lines_plain(timage.blur(_t(gray), 5, 1.0)[None],
                                    TC.lines)
    uv_s, uv_e = det.uv_s[0].clone(), det.uv_e[0].clone()
    valid = det.valid[0].clone()
    uv_s[-1] = torch.tensor([-20.0, 30.0])
    uv_e[-1] = torch.tensor([W + 15.0, 70.0])
    valid[-1] = True
    valid[-2] = False
    got = tlines.line_descriptors_plain(det.gx, det.gy, uv_s[None],
                                        uv_e[None], valid[None])[0]
    want = jax.jit(jlines.line_descriptors)(
        jnp.asarray(gray), jnp.asarray(uv_s.numpy()),
        jnp.asarray(uv_e.numpy()), jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(got.numpy(), _n(want), atol=1e-5)
    assert float(got[-1].abs().sum()) > 0 and float(got[-2].abs().sum()) == 0


def test_lift_missing_depth_matches_jax(seq, gray):
    """(h) 3D lifting over a depth map with a hole under one valid line:
    has_3d exact (that line loses it), endpoints atol 1e-4 m."""
    depth = np.array(seq.render(4)[1], f32)
    det = tlines.detect_lines_plain(timage.blur(_t(gray), 5, 1.0)[None],
                                    TC.lines)
    k = int(np.flatnonzero(det.valid[0].numpy())[0])
    us, ue = det.uv_s[0, k].numpy(), det.uv_e[0, k].numpy()
    x0, x1 = sorted((us[0], ue[0]))
    y0, y1 = sorted((us[1], ue[1]))
    depth[int(max(y0 - 2, 0)):int(y1 + 3), int(max(x0 - 2, 0)):int(x1 + 3)] = 0
    got = tlines.lift_lines_3d_plain(_t(depth)[None], TC.camera, TC.lines,
                                     det.uv_s, det.uv_e, det.valid)
    want = jax.jit(jlines.lift_lines_3d, static_argnums=(1, 2))(
                                jnp.asarray(depth), JC.camera, JC.lines,
                                jnp.asarray(det.uv_s[0].numpy()),
                                jnp.asarray(det.uv_e[0].numpy()),
                                jnp.asarray(det.valid[0].numpy()))
    has = got[2][0].numpy()
    np.testing.assert_array_equal(has, _n(want[2]))
    assert not has[k] and has.sum() > 0
    np.testing.assert_allclose(got[0][0].numpy(), _n(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1][0].numpy(), _n(want[1]), atol=1e-4)


@pytest.mark.parametrize("case", LIFT_CASES)
def test_lift_planted_matches_jax(case):
    """(h') 3D lifting on chip_smoke.py's planted frames (LIFT_CASES) at
    the default configuration's width (640x480, 64 slots; the sizes cases
    at S = 24 with 16 hypotheses and S = 64 with 64), four seeds: the plain
    version against JAX lift_lines_3d lane by lane, has_3d exact, endpoints
    within chip_smoke.P3D_TOLERANCE; the wrapper's B = 4 equal to the
    plain version's lanes; and what each case plants."""
    jc, tc = jconfig.SystemConfig(), tconfig.SystemConfig()
    lanes = planted_lift_lanes(case, 4)
    tl = lift_config(tc.lines, lanes["sizes"])
    jl = dataclasses.replace(jc.lines, n_depth_samples=tl.n_depth_samples,
                             ransac_iters=tl.ransac_iters)
    jfn = jax.jit(jlines.lift_lines_3d, static_argnums=(1, 2))
    arrs = [_t(lanes[k]) for k in ("depth", "uv_s", "uv_e", "valid")]
    got4 = tlines.lift_lines_3d(arrs[0], tc.camera, tl, *arrs[1:])
    for b in range(4):
        got = tlines.lift_lines_3d_plain(*[a[b:b + 1] for a in arrs[:1]],
                                         tc.camera, tl,
                                         *[a[b:b + 1] for a in arrs[1:]])
        want = jfn(jnp.asarray(lanes["depth"][b]), jc.camera, jl,
                   *[jnp.asarray(lanes[k][b])
                     for k in ("uv_s", "uv_e", "valid")])
        np.testing.assert_array_equal(got[2][0].numpy(), _n(want[2]))
        for k in (0, 1):
            np.testing.assert_allclose(got[k][0].numpy(), _n(want[k]),
                                       rtol=0, atol=P3D_TOLERANCE)
        for x, y in zip(got4, got):
            assert torch.equal(x[b], y[0])
    has = got4[2][0].numpy()
    valid = lanes["valid"][0]
    if case == "invalid_slots":
        allv = tlines.lift_lines_3d_plain(
            arrs[0][:1], tc.camera, tl, arrs[1][:1], arrs[2][:1],
            torch.ones_like(arrs[3][:1]))[2][0].numpy()
        assert (allv & ~valid).sum() > 5 and not (has & ~valid).any()
    elif case == "depth_holes":
        assert not has[:16].any() and has[32:].sum() > 5
    elif case == "off_image":
        assert has[:24].sum() > 3
        # the samples on column 200.5 round to 200 (even), left of the
        # step at 200 | 201: a line there lies on the nearer side
        z = got4[0][0, 24:32, 2].numpy()
        near, far = z[0::2], z[1::2]
        assert (near[has[24:32:2]] < 3.0).all()
        assert (far[has[25:32:2]] > 3.0).all()
    elif case == "extent_edge":
        assert not has[0:32:2].any() and has[1:32:2].all()
    else:
        assert has.sum() > 5


def sqrt_threshold(g: np.float32) -> np.float32:
    """csrc/line_lift_search.cu::sqrt_threshold in numpy: the square of the
    midpoint of g and the float below it, exact in float64, rounded up to
    float32."""
    if not g > 0 or np.isinf(g):
        return g if (np.isnan(g) or g > 0) else f32(0)
    m = 0.5 * (float(np.nextafter(g, f32(0))) + float(g))
    t = f32(m * m)
    return t if float(t) >= m * m else np.nextafter(t, f32(np.inf))


def least_with_sqrt_at_least(g: np.float32) -> np.float32:
    """The least float32 t with sqrt(t) >= g, by walking from g^2 (np.sqrt
    of a float32 rounds correctly, as sqrtf does)."""
    t = f32(g * g)
    while np.sqrt(t) >= g:
        t = np.nextafter(t, f32(0))
    while not np.sqrt(t) >= g:
        t = np.nextafter(t, f32(np.inf))
    return t


def test_sqrt_threshold_rule():
    """K22 tests a distance sqrtf(x) < gate as x < sqrt_threshold(gate):
    the threshold is the least float whose square root reaches the gate
    (the walk from gate^2 finds the same), and the decision is the same
    for every x near it and near gate^2, on the gates the sigma model gives
    (1.5 sigma + 0.01 over depths 0-10 m), at +inf and NaN."""
    rng = np.random.default_rng(22)
    z = rng.uniform(0.0, 10.0, 3000).astype(f32)
    lc = TC.lines
    sigma = np.maximum(f32(lc.depth_c1) * z * z + f32(lc.depth_c2) * z
                       + f32(lc.depth_c3), f32(2e-3))
    gates = list((f32(1.5) * sigma + f32(0.01)).astype(f32))
    gates += [f32(np.inf), f32(np.nan), f32(0.013)]
    checked = 0
    for g in gates:
        t = sqrt_threshold(g)
        if np.isfinite(g):
            assert t == least_with_sqrt_at_least(g), g
        with np.errstate(over="ignore"):
            sq = f32(g * g)
        xs = [t, np.nextafter(t, f32(0)), np.nextafter(t, f32(np.inf)), sq,
              np.nextafter(sq, f32(0)), np.nextafter(sq, f32(np.inf)),
              f32(1e-18), f32(np.inf), f32(np.nan)]
        for x in xs:
            assert bool(np.sqrt(x) < g) == bool(x < t), (g, x, t)
            checked += 1
    assert checked == 9 * len(gates)


@pytest.fixture(scope="module")
def search_problems(seq):
    """chip_smoke.py's K23 problems at the tiny size, on the CPU: the
    lifted lines of frames 0, 1, 2 and 6 (the window) seen from frame 3;
    tiled to 4096; with no valid map line; with the four best valid."""
    feats = {}
    for i in (0, 1, 2, 3, 6):
        g, d = seq.render(i)
        feats[i] = tlines.extract_line_features_plain(
            _t(np.round(np.array(g, f32))), _t(np.array(d, f32)), TC.camera,
            TC.lines)
    return _line_search_problems(feats, seq, torch.device("cpu"),
                                 np.random.default_rng(23), CAMERA)


@pytest.mark.parametrize("case", ["window", "fuse_4096", "no_candidates",
                                  "few_earned", "tie", "window_250",
                                  "fuse_1000", "all_nan"])
def test_search_lines_matches_jax(search_problems, case):
    """(i) The guided search, plain version against JAX: indices exact,
    similarities atol 1e-5 (a 72-term dot product of unit vectors), NaN
    where JAX's are, on the 64-line window (radius 14, as tracking calls
    it), 4096 lines (radius 8, as local mapping's fuse calls it), no
    candidate (both medians of all-NaN), the four best map lines alone
    (fewer than the 6 earned the adaptive gate needs), a planted tie (two
    equal segments, two equal map lines: the lower of each wins), the
    first 250 and 1000 map lines, and every valid map line's descriptor
    NaN (every gated similarity NaN: no candidate, no match)."""
    args, radius = search_problems[case]
    kw = dict(CAMERA, radius=radius)
    idx, sim = tlines.search_lines_by_projection_plain(*args, **kw)
    j_idx, j_sim = jlines.search_lines_by_projection(
        *[jnp.asarray(a.numpy()) for a in args], **kw)
    np.testing.assert_array_equal(idx.numpy(), _n(j_idx))
    np.testing.assert_allclose(sim.numpy(), _n(j_sim), atol=1e-5)
    cand = sim.numpy() > -0.5
    earned = int((cand & (sim.numpy() >= 0.575)).sum())
    if case in ("window", "fuse_4096", "window_250", "fuse_1000"):
        assert int((idx >= 0).sum()) > 0 and earned >= 6
    elif case == "no_candidates":
        assert cand.sum() == 0 and int((idx >= 0).sum()) == 0
    elif case == "tie":
        w, r = search_problems["window"]
        best = tlines.search_lines_by_projection_plain(
            *w, **dict(CAMERA, radius=r))
        m, m2, l, l2 = _line_tie_slots(*best, w[8].shape[0])
        assert int(idx[min(m, m2)]) == min(l, l2)
        assert int(idx[max(m, m2)]) == -1
    elif case == "all_nan":
        assert cand.sum() == 0 and int((idx >= 0).sum()) == 0
        assert np.isnan(sim.numpy()).any()
    else:
        assert 0 < cand.sum() <= 4 and earned < 6


def test_nanmedian_reference():
    """(j) lax_compat.nanmedian equals K23's rank-and-weight reference and
    jnp.nanmedian exactly: no value (NaN), one value, an even and an odd
    count, ties at the middle ranks, and 4096 similarities with NaNs."""
    rng = np.random.default_rng(11)
    cases = [np.full(8, np.nan, f32), np.array([np.nan, 0.3], f32),
             rng.normal(size=10).astype(f32), rng.normal(size=7).astype(f32),
             np.array([0.5, 0.5, 0.5, 0.2, np.nan, 0.9], f32)]
    big = rng.uniform(-1, 1, 4096).astype(f32)
    big[rng.random(4096) < 0.6] = np.nan
    cases.append(big)
    for x in cases:
        got = np.float32(lax_compat.nanmedian(_t(x)))
        want = np.float32(jnp.nanmedian(jnp.asarray(x)))
        ref = nanmedian_reference(x)
        for v in (got, want):
            assert (np.isnan(v) and np.isnan(ref)) or v == ref


def _median_cases():
    rng = np.random.default_rng(12)
    big = rng.uniform(-1, 1, 4096).astype(f32)
    big[rng.random(4096) < 0.6] = np.nan
    sims = np.round(rng.uniform(0.4, 1.0, 256), 2).astype(f32)
    sims[rng.random(256) < 0.3] = np.nan
    return {"all_nan": np.full(8, np.nan, f32),
            "single": np.array([np.nan, 0.3, np.nan], f32),
            "even": rng.normal(size=10).astype(f32),
            "odd": rng.normal(size=7).astype(f32),
            "ties": np.array([0.5, 0.5, 0.5, 0.2, np.nan, 0.9], f32),
            "tied_middles": np.array([0.7, 0.2, 0.7, 0.7, 0.1, 0.9], f32),
            "sims_256": sims, "nan_4096": big}


@pytest.mark.parametrize("case", list(_median_cases()))
def test_sorted_nanmedian_reference(case):
    """(l) K23's nanmedian (sorted_nanmedian_reference: the bitonic keys
    and the two middle ranks) equals lax_compat.nanmedian and jnp.nanmedian
    bit for bit, and so does its second median, of the absolute deviations
    from the first: every entry NaN, a single entry, even and odd counts,
    ties at and across the middle ranks, 256 rounded similarities with
    NaN, 4096 values with NaN."""
    x = _median_cases()[case]
    ref = sorted_nanmedian_reference(x)
    dev = np.abs(x - ref).astype(f32)
    for vals, want in ((x, ref), (dev, sorted_nanmedian_reference(dev))):
        for got in (np.float32(lax_compat.nanmedian(_t(vals))),
                    np.float32(jnp.nanmedian(jnp.asarray(vals)))):
            assert (np.isnan(got) and np.isnan(want)) or (
                got.view(np.int32) == want.view(np.int32))
        assert np.array_equal(
            np.sort(vals[~np.isnan(vals)]),
            np.sort(vals)[:int(np.sum(~np.isnan(vals)))])


@pytest.mark.parametrize("case", ["window", "tie", "nan_rows", "window_250"])
def test_kernel_bests_reference(search_problems, case):
    """(m) K23's row and column bests in its reduction order (kernel_bests)
    equal torch.argmax and jnp.argmax over both dimensions, and the rows'
    best values torch.amax, bit for bit: on the window's similarities
    rounded to 0.01 (ties) with 70% of the pairs gated out (-1), its rows
    repeated to 256 (equal rows in other tiles), the planted tie, NaN
    entries and a NaN row among them, and 250 rows (a last tile part
    full)."""
    name = "window" if case in ("nan_rows", "window_250") else case
    args, radius = search_problems[name]
    desc, fd = args[2], args[8]
    # the tiny window's rows repeated to the main path's 256 (or 250)
    s = np.tile((desc @ fd.T).numpy(), (4, 1))[:250 if case == "window_250"
                                                else 256]
    s = np.where(np.random.default_rng(5).random(s.shape) < 0.7, f32(-1),
                 np.round(s, 2)).astype(f32)
    if case == "nan_rows":
        s[3, 5], s[3, 9], s[40, :] = np.nan, np.nan, np.nan
        s[100, 7] = s[200, 7] = f32(2.0)
    bi, bv, back = kernel_bests(s)
    st = torch.from_numpy(s)
    for want_i, want_back in ((torch.argmax(st, 1).numpy(),
                               torch.argmax(st, 0).numpy()),
                              (np.asarray(jnp.argmax(s, 1)),
                               np.asarray(jnp.argmax(s, 0)))):
        np.testing.assert_array_equal(bi, want_i)
        np.testing.assert_array_equal(back, want_back)
    amax = torch.amax(st, 1).numpy()
    assert np.array_equal(np.isnan(bv), np.isnan(amax))
    ok = ~np.isnan(bv)
    np.testing.assert_array_equal(bv[ok].view(np.int32),
                                  amax[ok].view(np.int32))


def test_batched_wrappers_on_cpu(seq, gray, search_problems):
    """(k) The batched wrappers on the CPU: two frames through
    detect_lines, line_descriptors and lift_lines_3d, and two problems
    through search_lines_by_projection_batched, equal each frame or
    problem alone (the plain versions run on the CPU)."""
    g2 = np.round(np.array(seq.render(5)[0], f32))
    blurred = torch.stack([timage.blur(_t(g), 5, 1.0) for g in (gray, g2)])
    det = tlines.detect_lines(blurred, TC.lines)
    for b in range(2):
        one = tlines.detect_lines(blurred[b:b + 1], TC.lines)
        for f in det._fields:
            assert torch.equal(getattr(det, f)[b], getattr(one, f)[0]), f
    desc = tlines.line_descriptors(det.gx, det.gy, det.uv_s, det.uv_e,
                                   det.valid)
    depth = torch.stack([_t(np.array(seq.render(i)[1], f32)) for i in (4, 5)])
    lifted = tlines.lift_lines_3d(depth, TC.camera, TC.lines, det.uv_s,
                                  det.uv_e, det.valid)
    assert desc.shape == (2, TC.lines.max_lines, TC.lines.desc_dim)
    assert lifted[2].shape == (2, TC.lines.max_lines)
    args, radius = search_problems["window"]
    kw = dict(CAMERA, radius=radius)
    idx, sim = tlines.search_lines_by_projection_batched(
        *[torch.stack([a, a]) for a in args], **kw)
    i1, s1 = tlines.search_lines_by_projection(*args, **kw)
    assert torch.equal(idx[0], i1) and torch.equal(idx[1], i1)
    assert torch.equal(sim[1], s1)
