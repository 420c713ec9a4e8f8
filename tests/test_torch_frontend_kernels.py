"""Port parity for the stages of the point front end that are kernels
K16-K19 on the card (pyramid taps, keypoint selection, blur, point
epilogue): their plain versions and host tables against the JAX package on
the CPU. Inputs come from a numpy seed or the synthetic renderer; every
tolerance is stated in its test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (ORB_EXACT, ORB_PLANTED, PLANTED_BLUR_TAPS,
                        PLANTED_FAST_CASES, PLANTED_SELECT,
                        planted_blur_levels, planted_fast_levels,
                        planted_orb_lanes, planted_scores,
                        planted_select_levels)
from planarslam_tpu import config as jconfig
from planarslam_tpu.io import synthetic
from planarslam_tpu.ops import fast as jfast
from planarslam_tpu.ops import frontend as jfrontend
from planarslam_tpu.ops import image as jimage
from planarslam_tpu.ops import orb as jorb
from planarslam_tpu_torch import config as tconfig
from planarslam_tpu_torch.ops import consts as tconsts
from planarslam_tpu_torch.ops import fast as tfast
from planarslam_tpu_torch.ops import frontend as tfrontend
from planarslam_tpu_torch.ops import image as timage
from planarslam_tpu_torch.ops import levels as tlevels
from planarslam_tpu_torch.ops import orb as torb

torch.set_num_threads(2)

f32 = np.float32
DISTORTION = dict(k1=0.08, k2=-0.12, p1=0.002, p2=-0.001, k3=0.03)


def _frame(w, h, i=3):
    seq = synthetic.make_sequence(8, width=w, height=h)
    g, d = seq.render(i)
    return np.array(g, np.float32), np.array(d, np.float32)


def test_level_table_default_config():
    """The level table of the default configuration: shapes, quotas, tiles
    and per-tile budgets as the per-level loop of the JAX front end derives
    them, and the offsets of a buffer that holds the levels back to back."""
    oc = jconfig.ORBConfig()
    t = tfrontend.orb_level_table(480, 640, tconfig.ORBConfig())
    quotas = jfrontend.level_quotas(oc.n_features, oc.n_levels,
                                    oc.scale_factor)
    shapes = jimage.pyramid_shapes(480, 640, oc.n_levels, oc.scale_factor)
    assert list(t.shapes) == shapes
    assert list(t.column("quota")) == quotas
    assert t.n_slots == sum(quotas) == 1000
    off = 0
    for l, (h, w) in enumerate(shapes):
        tile = max(8, int(round(oc.tile / (oc.scale_factor ** l))))
        n_tiles = -(-h // tile) * -(-w // tile)
        assert t.column("offset")[l] == off
        assert t.column("tile")[l] == tile
        assert t.column("n_tiles")[l] == n_tiles
        assert t.column("k_tile")[l] == max(
            1, min(tile * tile, -(-2 * quotas[l] // n_tiles)))
        assert t.scale[l] == np.float32(oc.scale_factor ** l)
        off += h * w
    assert t.n_pixels == off == 950532
    assert list(t.column("k_tile")) == [2, 2, 1, 1, 1, 1, 1, 1]


@pytest.mark.parametrize("level", range(1, 8))
@pytest.mark.parametrize("w,h", [(640, 480), (160, 120)])
def test_resize_taps_equal_dense_weights(w, h, level):
    """(a) K16's compact tap table, scattered back to a dense matrix, equals
    the float32 weight matrix of the plain resize exactly, for the row and
    the column pair of every level; every output has 2 or 3 taps."""
    shapes = tlevels.pyramid_shapes(h, w, 8, 1.2)
    for n_in, n_out in zip(shapes[level - 1], shapes[level]):
        taps = timage.resize_taps(n_in, n_out)
        assert taps.shape == (n_out, 5) and taps.dtype == np.int32
        assert taps[:, 1].min() >= 2 and taps[:, 1].max() <= 3
        np.testing.assert_array_equal(timage.taps_to_dense(taps, n_in),
                                      timage._resize_weights(n_in, n_out))


def _fma(a, b, c):
    """float32 a * b + c through float64 (the same rounding on both sides of
    the comparison below)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _resize_emulated(src, rt, ct, rows, cols):
    """K16's outputs (rows x cols index arrays) of one level from `src`
    (a window whose first row and column are given by rows.base and
    cols.base): per output the row taps' sums, each rounded, under the
    column taps, in ascending order."""
    (y_base, ys), (x_base, xs) = rows, cols
    acc = np.zeros((len(ys), len(xs)), np.float32)
    for j in range(3):
        rs = np.zeros_like(acc)
        for t in range(3):
            on = (t < rt[ys, 1])[:, None] & (j < ct[xs, 1])[None, :]
            r = np.clip(rt[ys, 0] + t - y_base, 0, src.shape[0] - 1)
            c = np.clip(ct[xs, 0] + j - x_base, 0, src.shape[1] - 1)
            w = rt[ys, 2 + t].view(np.float32)[:, None]
            rs = np.where(on, _fma(np.broadcast_to(w, acc.shape),
                                   src[np.ix_(r, c)], rs), rs)
        cw = ct[xs, 2 + j].view(np.float32)[None, :]
        acc = np.where((j < ct[xs, 1])[None, :],
                       _fma(rs, np.broadcast_to(cw, acc.shape), acc), acc)
    return acc


@pytest.mark.parametrize("w,h,n", [(160, 120, 8), (64, 48, 8), (77, 53, 5),
                                   (64, 48, 1)])
def test_pyramid_cones_cover_the_pyramid(w, h, n):
    """K16's cones (image.pyramid_cones): walking each cone level by level
    inside its own ranges, as the kernel does, and writing the outputs it
    owns gives every pixel of every level exactly once and the values of
    the level-by-level resize; each cone's chunk holds its ranges and its
    taps, and its levels fit the shared memory the table sizes."""
    shapes = tuple(tlevels.pyramid_shapes(h, w, n, 1.2))
    pc = timage.pyramid_cones(shapes)
    table, n_rows, n_cols = pc.ranges, pc.rows, pc.cols
    offsets = np.cumsum([0] + [a * b for a, b in shapes[:-1]])
    frame = np.random.default_rng(16).uniform(0, 255, (h, w)).astype(
        np.float32)
    want = [frame]
    for l in range(1, n):
        (hi, wi), (ho, wo) = shapes[l - 1], shapes[l]
        want.append(_resize_emulated(
            want[-1], timage.resize_taps(hi, ho), timage.resize_taps(wi, wo),
            (0, np.arange(ho)), (0, np.arange(wo))))
    got = [np.full(s, np.nan, np.float32) for s in shapes]
    hits = [np.zeros(s, np.int32) for s in shapes]
    for ty in range(n_rows):
        for tx in range(n_cols):
            ry, rx = table[0, :, ty], table[1, :, tx]
            assert all((ry[l, 0] <= ry[l, 2] <= ry[l, 3] <= ry[l, 1])
                       and (rx[l, 0] <= rx[l, 2] <= rx[l, 3] <= rx[l, 1])
                       for l in range(n))
            # the cone's chunk: its levels' ranges, offsets and widths, then
            # the taps of its rows and columns; the level-0 ranges as the
            # launch reads them; its levels fit the shared memory sized
            chunk = pc.chunks[ty * n_cols + tx]
            head = chunk[:pc.header_words].reshape(-1)[:10 * n].reshape(n, 10)
            np.testing.assert_array_equal(head[:, :4], ry)
            np.testing.assert_array_equal(head[:, 4:8], rx)
            np.testing.assert_array_equal(head[:, 8], offsets)
            np.testing.assert_array_equal(head[:, 9], [s[1] for s in shapes])
            assert list(pc.level0[:2, ty]) == list(ry[0, :2])
            assert list(pc.level0[2:, tx]) == list(rx[0, :2])
            body = chunk[pc.header_words:]
            for l in range(1, n):
                for axis, r in ((0, ry), (1, rx)):
                    m = 5 * (r[l, 1] - r[l, 0])
                    want_taps = timage.resize_taps(
                        shapes[l - 1][axis], shapes[l][axis])[r[l, 0]:r[l, 1]]
                    np.testing.assert_array_equal(body[:m].reshape(-1, 5),
                                                  want_taps)
                    body = body[m:]
            assert not body.any()
            x0 = rx[0, 0] // 4 * 4
            widths = [-(-rx[0, 1] // 4) * 4 - x0] + list(rx[1:, 1] - rx[1:, 0])
            sizes = (ry[:, 1] - ry[:, 0]) * np.array(widths)
            assert sizes.max() <= pc.buf_floats
            assert (n == 1 or ((ry[1:, 1] - ry[1:, 0])
                               * np.array(widths[:-1])).max()
                    <= pc.mid_floats)
            cur = frame[ry[0, 0]:ry[0, 1], rx[0, 0]:rx[0, 1]]
            for l in range(n):
                if l:
                    (hi, wi), (ho, wo) = shapes[l - 1], shapes[l]
                    rt = timage.resize_taps(hi, ho)
                    ct = timage.resize_taps(wi, wo)
                    ys = np.arange(ry[l, 0], ry[l, 1])
                    xs = np.arange(rx[l, 0], rx[l, 1])
                    # the taps stay inside the level below's ranges
                    assert rt[ys, 0].min() >= ry[l - 1, 0]
                    assert (rt[ys, 0] + rt[ys, 1]).max() <= ry[l - 1, 1]
                    assert ct[xs, 0].min() >= rx[l - 1, 0]
                    assert (ct[xs, 0] + ct[xs, 1]).max() <= rx[l - 1, 1]
                    cur = _resize_emulated(cur, rt, ct, (ry[l - 1, 0], ys),
                                           (rx[l - 1, 0], xs))
                oy, ox = slice(ry[l, 2], ry[l, 3]), slice(rx[l, 2], rx[l, 3])
                got[l][oy, ox] = cur[ry[l, 2] - ry[l, 0]:ry[l, 3] - ry[l, 0],
                                     rx[l, 2] - rx[l, 0]:rx[l, 3] - rx[l, 0]]
                hits[l][oy, ox] += 1
    for l in range(n):
        assert (hits[l] == 1).all(), l
        np.testing.assert_array_equal(got[l], want[l])


def fast_doubling_reference(img: np.ndarray) -> np.ndarray:
    """K1's order in numpy: the ring values of the edge-replicated level
    (its staging clamps the coordinates), the arcs reduced by doubling on
    the ring values (min of 2, of 4, of 8, then the ninth member; max for
    the dark polarity), the best over the 16 starts, and the centre
    subtracted once, after."""
    h, w = img.shape
    p = np.pad(img, 3, mode="edge")
    ring = np.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in tfast.CIRCLE_OFFSETS])

    def best(op, over):
        m2 = op(ring, np.roll(ring, -1, 0))
        m4 = op(m2, np.roll(m2, -2, 0))
        m8 = op(m4, np.roll(m4, -4, 0))
        return over(op(m8, np.roll(ring, -8, 0)), axis=0)

    bright = (best(np.minimum, np.max) - img).astype(f32)
    dark = -(best(np.maximum, np.min) - img).astype(f32)
    return np.maximum(np.maximum(bright, dark), f32(0))


def _fast_levels(case):
    """K1's test levels: chip_smoke.py's planted levels, or the JAX
    pyramid of a 160x120 frame ("pyramid")."""
    if case == "pyramid":
        oc = jconfig.SystemConfig.tiny().orb
        return [np.array(lv) for lv in jimage.build_pyramid(
            jnp.asarray(_frame(160, 120)[0]), oc.n_levels, oc.scale_factor)]
    table, buf = planted_fast_levels(case)
    return [buf[0, table.level_slice(l)].reshape(h, w)
            for l, (h, w) in enumerate(table.shapes)]


@pytest.mark.parametrize("case", PLANTED_FAST_CASES + ("pyramid",))
def test_fast_doubling_reference_planted(case):
    """K1's order (fast_doubling_reference) against JAX fast_score and the
    port's plain version on every level, those narrower or shorter than
    the 7-pixel ring included: every positive score bit for bit, the rest
    0 in all three (the sign of a zero max is each library's own); the
    flat image scores 0 everywhere."""
    levels = _fast_levels(case)
    assert any(min(lv.shape) < 7 for lv in levels) or case == "pyramid"
    n_pos = 0
    for img in levels:
        ref = fast_doubling_reference(img)
        pos = ref > 0
        n_pos += int(pos.sum())
        assert not (ref < 0).any()
        for other in (np.asarray(jfast.fast_score(jnp.asarray(img))),
                      tfast.fast_score_plain(torch.from_numpy(img)).numpy()):
            assert np.array_equal(other > 0, pos)
            assert not (other < 0).any()
            np.testing.assert_array_equal(ref[pos].view(np.int32),
                                          other[pos].view(np.int32))
    assert (n_pos == 0) == (case == "flat")


def _select_by_counting(score, tile, k_total, min_score, border):
    """K18's rule in numpy: the gate, k_tile block-wide arg-max passes per
    tile with ties to the lower in-tile index (a taken maximum becomes -1
    up to 4 passes, and leaves the ranking above), then each candidate's
    rank by counting the candidates with a greater value, or an equal value
    and a lower (tile, pass) index."""
    h, w = score.shape
    pad = np.full((h + 2, w + 2), -np.inf, np.float32)
    pad[1:-1, 1:-1] = score
    nb_max = np.max([pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
    yy, xx = np.mgrid[0:h, 0:w]
    gate = ((yy >= border) & (yy < h - border) & (xx >= border)
            & (xx < w - border) & (score >= nb_max) & (score > min_score))
    s = np.where(gate, score, np.float32(-1.0))
    ntw, n_tiles, k_tile = tlevels.tile_budget(h, w, tile, k_total)
    taken = -1.0 if k_tile <= 4 else -2.0
    vals, px, py = [], [], []
    for t in range(n_tiles):
        y0, x0 = (t // ntw) * tile, (t % ntw) * tile
        cell = np.full((tile, tile), np.float32(-1.0))
        sub = s[y0:y0 + tile, x0:x0 + tile]
        cell[:sub.shape[0], :sub.shape[1]] = sub
        cell = cell.reshape(-1)
        for _ in range(k_tile):
            i = int(np.flatnonzero(cell == cell.max())[0])
            vals.append(cell[i])
            px.append(x0 + i % tile)
            py.append(y0 + i // tile)
            cell[i] = taken
    vals = np.asarray(vals, np.float32)
    idx = np.arange(len(vals))
    rank = ((vals[None, :] > vals[:, None])
            | ((vals[None, :] == vals[:, None])
               & (idx[None, :] < idx[:, None]))).sum(axis=1)
    uv = np.zeros((k_total, 2), np.float32)
    resp = np.zeros(k_total, np.float32)
    valid = np.zeros(k_total, bool)
    for i in np.flatnonzero(rank < k_total):
        uv[rank[i]] = (px[i], py[i])
        resp[rank[i]] = max(vals[i], 0.0)
        valid[rank[i]] = vals[i] > 0
    return uv, resp, valid


# (h, w, tile, k_total, border, peaks, k_tile): 1 to 4 candidates per tile
# (arg-max passes: a dry tile repeats its cell 0) and 5, 8, 12 (the sort
# branch: a dry tile yields its -1 cells in order), partial last tiles
SELECT_CASES = [(70, 90, 16, 12, 5, 160, 1), (70, 90, 16, 40, 5, 400, 3),
                (96, 128, 32, 24, 19, 300, 4), (61, 83, 16, 55, 3, 500, 5),
                (40, 40, 8, 100, 3, 400, 8), (50, 45, 9, 180, 4, 700, 12)]


@pytest.mark.parametrize("h,w,tile,k_total,border,peaks,k_tile", SELECT_CASES)
def test_select_keypoints_planted(h, w, tile, k_total, border, peaks, k_tile):
    """(b) select_keypoints' plain version, the JAX function and K18's
    rank-by-counting rule on planted score maps with ties, empty tiles and
    both per-tile branches: uv, response and validity exactly equal in
    every slot, the invalid ones too."""
    rng = np.random.default_rng(h * 1000 + k_total)
    score = planted_scores(rng, h, w, tile, peaks, border)
    kw = dict(tile=tile, k_total=k_total, min_score=7.0, border=border)
    want = [np.asarray(a) for a in
            jfast.select_keypoints(jnp.asarray(score), **kw)]
    got = [a.numpy() for a in
           tfast.select_keypoints(torch.from_numpy(score), **kw)]
    ref = _select_by_counting(score, **kw)
    assert tlevels.tile_budget(h, w, tile, k_total)[2] == k_tile
    assert want[2].any()
    assert k_tile == 1 or not want[2].all()  # invalid slots too
    assert len(np.unique(want[1][want[2]])) < want[2].sum()  # ties
    for name, a, b, c in zip(("uv", "response", "valid"), want, got, ref):
        np.testing.assert_array_equal(b, a, err_msg=f"plain vs JAX: {name}")
        np.testing.assert_array_equal(c, a, err_msg=f"counting vs JAX: {name}")


@pytest.mark.parametrize("level", range(len(PLANTED_SELECT["names"])))
def test_select_keypoints_planted_levels(level):
    """(b) select_keypoints' plain version, the JAX function and K18's
    rank-by-counting rule on K18's planted levels (chip_smoke.py's
    PLANTED_SELECT: a tile wider than its level, a dry tile of the sort
    branch, a level of -1 only, a tie across tiles at the quota's cut), two
    lanes: uv, response and validity exactly equal in every slot, the
    invalid ones too, and the all-levels plain version's slots of the
    level the same."""
    ps = PLANTED_SELECT
    table, scores = planted_select_levels(batch=2)
    h, w = table.shapes[level]
    tile, quota = int(table.column("tile")[level]), int(
        table.column("quota")[level])
    kw = dict(tile=tile, k_total=quota, min_score=ps["min_score"],
              border=ps["border"])
    lev = tfast.select_keypoints_levels(torch.from_numpy(scores), table,
                                        ps["min_score"], ps["border"])
    q0 = int(table.column("quota")[:level].sum())
    name = ps["names"][level]
    for b in range(2):
        score = scores[b, table.level_slice(level)].reshape(h, w)
        want = [np.asarray(a) for a in
                jfast.select_keypoints(jnp.asarray(score), **kw)]
        got = [a.numpy() for a in
               tfast.select_keypoints(torch.from_numpy(score), **kw)]
        ref = _select_by_counting(score, **kw)
        for n, a, g, c, x in zip(("uv", "response", "valid"), want, got,
                                 ref, lev):
            np.testing.assert_array_equal(g, a, err_msg=f"plain vs JAX: {n}")
            np.testing.assert_array_equal(c, a,
                                          err_msg=f"counting vs JAX: {n}")
            np.testing.assert_array_equal(x[b, q0:q0 + quota].numpy(), a,
                                          err_msg=f"all levels vs JAX: {n}")
        valid = want[2]
        if name == "wide_tile":
            assert tile > w
        elif name == "dry_sort":
            assert table.column("k_tile")[level] > 4
            assert 0 < valid.sum() < quota
        elif name == "all_below":
            assert not valid.any() and (score <= ps["min_score"]).all()
        else:  # tie_at_cut: 13 of the 16 tiles' maxima tie at the cut
            assert valid.all()
            assert (want[1] == 50.0).sum() == quota - 3


@pytest.mark.parametrize("ksize,sigma", PLANTED_BLUR_TAPS)
def test_blur_parity(ksize, sigma):
    """(c) The separable Gaussian blur of a rendered 320x240 frame and of
    chip_smoke.py's planted levels (1-6 pixels wide or tall, widths no
    multiple of 4, odd offsets; K17's planted problem) against the JAX
    function, atol 1e-4 grey levels (XLA may contract a product and a sum);
    the all-levels form on a one-level buffer and on the planted buffer
    (two lanes) gives the same bits as the plain function level by
    level."""
    img, _ = _frame(320, 240)
    got = timage.blur(torch.from_numpy(img), ksize, sigma)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jimage.blur(jnp.asarray(img), ksize, sigma)),
        atol=1e-4)
    assert torch.equal(timage.gaussian_blur(torch.from_numpy(img), ksize,
                                            sigma), got)
    table = tlevels.single_level(240, 320)
    lev = timage.gaussian_blur_levels(torch.from_numpy(img).reshape(1, -1),
                                      table, ksize, sigma)
    assert torch.equal(lev.reshape(240, 320), got)
    table, buf = planted_blur_levels(batch=2)
    lev = timage.gaussian_blur_levels(torch.from_numpy(buf), table, ksize,
                                      sigma)
    assert min(min(s) for s in table.shapes) == 1
    assert sorted(set(table.column("offset") % 4)) == [0, 1, 2, 3]
    for b in range(2):
        for l, (h, w) in enumerate(table.shapes):
            level = buf[b, table.level_slice(l)].reshape(h, w)
            want = timage.blur(torch.from_numpy(level), ksize, sigma)
            np.testing.assert_allclose(
                want.numpy(), np.asarray(jimage.blur(jnp.asarray(level), ksize,
                                                     sigma)), atol=1e-4)
            assert torch.equal(lev[b, table.level_slice(l)].reshape(h, w),
                               want)


def _jax_tail(uv_raw, response, valid, depth, cam):
    """The tail of the JAX extract_point_features on padded level-0
    keypoints (its lines after the padding)."""
    uv = jfrontend.undistort_points(uv_raw, cam)
    d = jimage.nearest_sample(depth, uv_raw)
    has_d = (d > 1e-6) & valid
    u_right = jnp.where(has_d, uv[:, 0] - cam.bf / jnp.maximum(d, 1e-6), -1.0)
    return uv, jnp.where(has_d, d, -1.0), u_right


@pytest.mark.parametrize("distort", [True, False])
def test_point_epilogue_parity(distort):
    """(d) The point epilogue's plain version against the tail of the JAX
    front end, with and without a distorting camera, on seeded keypoints of
    a 4-level table (half-pixel level coordinates whose level-0 products
    round half to even, invalid slots, padding): uv and u_right atol 1e-4,
    uv_raw, level, response, depth and validity equal."""
    w, h, kp = 160, 120, 256
    extra = DISTORTION if distort else {}
    jc = jconfig.SystemConfig.tiny(h, w)
    tc = tconfig.SystemConfig.tiny(h, w)
    jcam = dataclasses.replace(jc.camera, **extra)
    tcam = dataclasses.replace(tc.camera, **extra)
    assert tcam.has_distortion == distort
    orb_cfg = tconfig.ORBConfig(n_features=240, max_keypoints=kp, n_levels=4,
                                tile=16)
    table = tfrontend.orb_level_table(h, w, orb_cfg)
    rng = np.random.default_rng(19)
    _, depth = _frame(w, h)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    quotas = table.column("quota")
    uv_level = np.concatenate([
        np.stack([rng.integers(0, sw, q), rng.integers(0, sh, q)], -1)
        for (sh, sw), q in zip(table.shapes, quotas)]).astype(np.float32)
    uv_level[::7] += 0.5
    resp = rng.uniform(7, 60, table.n_slots).astype(np.float32)
    valid = rng.random(table.n_slots) < 0.8

    got = tfrontend.point_epilogue(
        torch.from_numpy(uv_level)[None], torch.from_numpy(resp)[None],
        torch.from_numpy(valid)[None], torch.from_numpy(depth)[None], tcam,
        table, kp)
    assert got.uv.shape == (1, kp, 2) and got.level.dtype == torch.int32

    # the JAX loop's own scaling, zeroing, level index and padding
    pad = kp - table.n_slots
    level = np.repeat(np.arange(4, dtype=np.int32), quotas)
    uv_raw = np.concatenate([
        np.asarray(jnp.asarray(uv_level[level == l]) * (1.2 ** l))
        for l in range(4)])
    uv_raw = np.pad(uv_raw, ((0, pad), (0, 0)))
    response = np.pad(np.where(valid, resp, np.float32(0.0)), (0, pad))
    uv_j, d_j, ur_j = _jax_tail(jnp.asarray(uv_raw), jnp.asarray(response),
                                jnp.asarray(response > 0),
                                jnp.asarray(depth), jcam)
    np.testing.assert_array_equal(got.uv_raw[0].numpy(), uv_raw)
    np.testing.assert_array_equal(got.response[0].numpy(), response)
    np.testing.assert_array_equal(got.valid[0].numpy(), response > 0)
    np.testing.assert_array_equal(got.level[0].numpy(), np.pad(level, (0, pad)))
    np.testing.assert_array_equal(got.depth[0].numpy(), np.asarray(d_j))
    np.testing.assert_allclose(got.uv[0].numpy(), np.asarray(uv_j), atol=1e-4)
    np.testing.assert_allclose(got.u_right[0].numpy(), np.asarray(ur_j),
                               atol=1e-4)
    assert (np.asarray(d_j) > 0).sum() > 50
    if distort:
        assert np.abs(np.asarray(uv_j) - uv_raw).max() > 0.5


def _orb_cfgs(w, h, **orb_kw):
    j = jconfig.SystemConfig.tiny(h, w)
    t = tconfig.SystemConfig.tiny(h, w)
    return (j.replace(orb=jconfig.ORBConfig(**orb_kw)),
            t.replace(orb=tconfig.ORBConfig(**orb_kw)))


def test_extract_point_features_8_levels():
    """(e) The whole point front end at 8 levels, 320x240, 500 features in
    512 slots, through the CPU route against JAX, at the limits of
    test_extract_point_features_parity: level-0 keypoints equal, >= 97% of
    all keypoints (pixel and level) shared, depth and u_right atol 1e-4 on
    the shared ones."""
    w, h, kp = 320, 240, 512
    g, d = _frame(w, h)
    jc, tc = _orb_cfgs(w, h, n_features=500, max_keypoints=kp, n_levels=8,
                       tile=24)
    pj = jfrontend.extract_point_features(jnp.asarray(g), jnp.asarray(d),
                                          jc.camera, jc.orb)
    pt = tfrontend.extract_point_features(torch.from_numpy(g),
                                          torch.from_numpy(d), tc.camera,
                                          tc.orb)
    assert pt.uv.shape == (kp, 2) and pt.desc.shape == (kp, 8)
    lj, lt = np.asarray(pj.level), pt.level.numpy()
    vj, vt = np.asarray(pj.valid), pt.valid.numpy()
    uj, ut = np.asarray(pj.uv_raw), pt.uv_raw.numpy()
    np.testing.assert_array_equal(lt, lj)
    l0 = (lj == 0) & vj
    np.testing.assert_array_equal(ut[l0], uj[l0])
    np.testing.assert_array_equal(vt[lj == 0], vj[lj == 0])
    keys_j = {(int(l), float(x), float(y)) for l, (x, y), v in zip(lj, uj, vj)
              if v}
    keys_t = {(int(l), float(x), float(y)) for l, (x, y), v in zip(lt, ut, vt)
              if v}
    assert len(keys_j) > 300
    assert len(keys_j & keys_t) >= 0.97 * len(keys_j)
    same = (ut == uj).all(axis=1) & (lt == lj) & vj & vt
    np.testing.assert_allclose(pt.depth.numpy()[same],
                               np.asarray(pj.depth)[same], atol=1e-4)
    np.testing.assert_allclose(pt.u_right.numpy()[same],
                               np.asarray(pj.u_right)[same], atol=1e-4)


def test_levels_route_equals_per_level_route():
    """The all-levels stage functions (what the card launches as one kernel
    each), composed as extract_point_features composes them on the card and
    run here through their plain versions, give the per-level route's
    PointFeatures exactly."""
    w, h = 160, 120
    g, d = _frame(w, h)
    cfg = tconfig.SystemConfig.tiny(h, w)
    oc, cam = cfg.orb, dataclasses.replace(cfg.camera, **DISTORTION)
    gray, depth = torch.from_numpy(g), torch.from_numpy(d)
    want = tfrontend.extract_point_features(gray, depth, cam, oc)

    table = tfrontend.orb_level_table(h, w, oc)
    buf = timage.build_pyramid_levels(gray[None], table, oc.scale_factor)
    assert buf.shape == (1, table.n_pixels)
    scores = tfast.fast_score_levels(buf, table)
    uv_l, resp, valid = tfast.select_keypoints_levels(
        scores, table, float(oc.min_th_fast), tfrontend.EDGE_BORDER)
    blur = timage.gaussian_blur_levels(buf, table, 7, 2.0)
    angle, desc = torb.orb_describe_levels(buf, blur, uv_l, valid, table,
                                           oc.max_keypoints)
    ep = tfrontend.point_epilogue(uv_l, resp, valid, depth[None], cam, table,
                                  oc.max_keypoints)
    got = tfrontend._features(angle, desc, ep)
    assert int(want.valid.sum()) > 50
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("case", ORB_PLANTED)
def test_orb_describe_levels_planted(case):
    """K2's plain all-levels version on chip_smoke.py's ORB_PLANTED
    problems (lane 0: clamped windows and samples, x.5 coordinates, NaN
    in invalid slots, quota-0 levels, no valid slot, a long tail, flat and
    mirror-symmetric levels, the 1280x960 pyramid) against JAX's
    orientations and descriptors level by level, at
    test_fast_orb_per_level's limits: angles atol 1e-4, descriptors equal
    for >= 99% of the valid slots. Invalid slots and those past n_slots
    are exactly 0; the ORB_EXACT cases (flat, symmetric, half_pixel) are
    bit-equal."""
    table, arrs = planted_orb_lanes(case, 1)
    n, cap = table.n_slots, arrs["capacity"]
    angle, desc = torb.orb_describe_levels_plain(
        *[torch.from_numpy(arrs[k]) for k in ("buf", "blur", "uv", "valid")],
        table, cap)
    a_t, d_t = angle[0].numpy(), desc[0].numpy().view(np.uint32)
    assert a_t.shape == (cap,) and d_t.shape == (cap, 8)
    a_j = np.zeros(n, np.float32)
    d_j = np.zeros((n, 8), np.uint32)
    s0 = 0
    for l, ((h, w), q) in enumerate(zip(table.shapes,
                                        table.column("quota"))):
        if q == 0:
            continue
        sl = table.level_slice(l)
        uv = jnp.asarray(arrs["uv"][0, s0:s0 + q])
        ok = jnp.asarray(arrs["valid"][0, s0:s0 + q])
        a = jorb.orientations(jnp.asarray(arrs["buf"][0, sl].reshape(h, w)),
                              uv, ok)
        a_j[s0:s0 + q] = np.asarray(a)
        d_j[s0:s0 + q] = np.asarray(jorb.descriptors(
            jnp.asarray(arrs["blur"][0, sl].reshape(h, w)), uv, a, ok))
        s0 += q
    valid = arrs["valid"][0]
    empty = np.ones(cap, bool)
    empty[:n] = ~valid
    assert not a_t[empty].view(np.int32).any() and not d_t[empty].any()
    np.testing.assert_allclose(a_t[:n], a_j, atol=1e-4)
    same = np.all(d_t[:n] == d_j, axis=1)
    assert (same & valid).sum() >= 0.99 * valid.sum()
    if case in ORB_EXACT:
        assert valid.sum() > 0
        np.testing.assert_array_equal(a_t[:n].view(np.int32),
                                      a_j.view(np.int32))
        np.testing.assert_array_equal(d_t[:n], d_j)


def test_device_constant_is_cached():
    """(f) A constant asked for twice on one device is the same tensor
    object: tables by name, numbers by value and type."""
    dev = torch.device("cpu")
    a = tconsts.const(("test.table", 3), lambda: np.arange(3, dtype=np.float32),
                      dev)
    b = tconsts.const(("test.table", 3), lambda: 1 / 0, dev)  # not rebuilt
    assert a is b and a.tolist() == [0.0, 1.0, 2.0]
    assert tconsts.literal(1.2, torch.float32, dev) is tconsts.literal(
        1.2, torch.float32, dev)
    assert tconsts.literal(1.2, torch.float64, dev) is not tconsts.literal(
        1.2, torch.float32, dev)
    row = tconsts.literal((0.0, 0.0, 0.0, 1.0), torch.float32, dev)
    assert row.shape == (4,) and row is tconsts.literal(
        (0.0, 0.0, 0.0, 1.0), torch.float32, dev)
    # the resize weights of the plain pyramid are such constants
    img = torch.zeros((12, 16))
    timage.resize_bilinear(img, (10, 13))
    w1 = tconsts.const(("resize_weights", 12, 10), None, dev)
    timage.resize_bilinear(img, (10, 13))
    assert w1 is tconsts.const(("resize_weights", 12, 10), None, dev)
