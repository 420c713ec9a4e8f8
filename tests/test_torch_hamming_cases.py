"""Port parity: K3's plain version (``gated_hamming_top2_plain``) and the
mutual pair (``mutual_hamming_top2``) on planted edge cases, against the
JAX package's ``hamming_distance`` + ``_top2_min`` with the projection
search's gate (``ops/matching.py::search_by_projection``) applied to the
same fields. Best, second and index are asserted exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planarslam_tpu.ops import matching as jmatch
from planarslam_tpu.ops.orb import hamming_distance
from planarslam_tpu_torch.ops import matching as tmatch

LEVEL_WINDOW = 1


def _problem(seed: int, m: int, n: int):
    """Descriptors (uint32 bit patterns), validity and gate fields: each
    column a copy of a random row with 5% of its bits flipped, its pixel
    near that row's projection."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, m, n)
    flips = rng.random((n, 8, 32)) < 0.05
    words = (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    b = (a[src].astype(np.uint64) ^ words).astype(np.uint32)
    a_uv = rng.uniform(0, [640, 480], (m, 2)).astype(np.float32)
    lvl = rng.integers(0, 8, m).astype(np.int32)
    b_uv = (a_uv[src] + rng.normal(0, 2.0, (n, 2))).astype(np.float32)
    return dict(
        a=a, b=b, a_ok=rng.random(m) < 0.9, b_ok=rng.random(n) < 0.95,
        a_uv=a_uv, a_r=(4.0 * 1.2 ** lvl).astype(np.float32), a_level=lvl,
        a_ur_pred=(a_uv[:, 0] - 20.0).astype(np.float32), b_uv=b_uv,
        b_level=lvl[src],
        b_ur=np.where(rng.random(n) < 0.7, b_uv[:, 0] - 20.0,
                      -1.0).astype(np.float32))


def _planted(case: str):
    if case == "all_rows_masked":
        p = _problem(1, 40, 96)
        p["a_ok"][:] = False
    elif case == "one_gated_in_column":
        p = _problem(2, 24, 96)
        p["a_r"][:] = 1e-3
        p["a_uv"][0] = p["b_uv"][17]
        p["a_level"][0] = p["b_level"][17]
        p["a_ur_pred"][0] = p["b_uv"][17, 0] - np.float32(20.0)
        p["a_ok"][0] = p["b_ok"][17] = True
    elif case == "n_1":
        p = _problem(3, 50, 1)
        p["b_ok"][0] = True
    elif case == "wide_windows":
        # rows on 32-pixel grid lines, radii from 1 to 70 pixels, pixels
        # off the image and a NaN
        p = _problem(6, 400, 1024)
        rng = np.random.default_rng(6)
        p["a_uv"][:64] = (rng.integers(0, 20, (64, 2)) * 32
                          + rng.choice([-0.5, 0.0, 0.5], (64, 2))
                          ).astype(np.float32)
        p["a_r"] = rng.uniform(1.0, 70.0, 400).astype(np.float32)
        p["b_uv"][:20] = rng.uniform(-100, 1200, (20, 2)).astype(np.float32)
        p["b_uv"][20, 0] = np.nan
        p["a_uv"][70, 1] = np.nan
    elif case == "duplicate_ties":
        p = _problem(4, 30, 200)
        p["b"][[5, 150, 151]] = p["a"][3]  # row 3's exact copy, three times
        p["a_r"][3] = 1e4  # every column within row 3's window
        p["a_ok"][3] = True
        p["b_ok"][[5, 150, 151]] = True
        p["b_level"][[5, 150, 151]] = p["a_level"][3]
        p["b_ur"][[5, 150, 151]] = -1.0
    return p


def _jax_top2(p, gated: bool = True):
    """The JAX package's Hamming distance and _top2_min, with the
    projection search's gate on the fields of p."""
    d = hamming_distance(jnp.asarray(p["a"]), jnp.asarray(p["b"]))
    gate = jnp.asarray(p["a_ok"])[:, None] & jnp.asarray(p["b_ok"])[None, :]
    if gated:
        r = jnp.asarray(p["a_r"])[:, None]
        uv, f_uv = jnp.asarray(p["a_uv"]), jnp.asarray(p["b_uv"])
        du = jnp.abs(uv[:, 0:1] - f_uv[None, :, 0])
        dv = jnp.abs(uv[:, 1:2] - f_uv[None, :, 1])
        window = (du <= r) & (dv <= r)
        lvl_ok = (jnp.abs(jnp.asarray(p["b_level"])[None, :]
                          - jnp.asarray(p["a_level"])[:, None])
                  <= LEVEL_WINDOW)
        f_ur = jnp.asarray(p["b_ur"])[None, :]
        ur_ok = (f_ur < 0) | (jnp.abs(jnp.asarray(p["a_ur_pred"])[:, None]
                                      - f_ur) <= r)
        gate = gate & window & lvl_ok & ur_ok
    d = jnp.where(gate, d, jmatch.INF_DIST)
    return d, jmatch._top2_min(d)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("case", ["all_rows_masked", "one_gated_in_column",
                                  "n_1", "duplicate_ties", "wide_windows",
                                  "mutual"])
def test_hamming_top2_plain_cases(case):
    """K3's plain version equals JAX's gated Hamming top-2 exactly on each
    planted case; "mutual" holds mutual_hamming_top2's four outputs to the
    ungated top-2 and match_descriptors' back argmin."""
    if case == "mutual":
        p = _problem(5, 64, 80)
        d, (bj, sj, ij) = _jax_top2(p, gated=False)
        got = tmatch.mutual_hamming_top2(*[_t(p[k])[None] for k in
                                           ("a", "b", "a_ok", "b_ok")])
        want = (bj, sj, ij, jnp.argmin(d, axis=0))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        return
    p = _planted(case)
    _, (bj, sj, ij) = _jax_top2(p)
    gate = tmatch.ProjGate(
        *[_t(p[k]) for k in ("a_uv", "a_r", "a_level", "a_ur_pred", "b_uv",
                             "b_level", "b_ur")], LEVEL_WINDOW)
    bt, st, it = tmatch.gated_hamming_top2_plain(
        *[_t(p[k]) for k in ("a", "b", "a_ok", "b_ok")], gate)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if case == "all_rows_masked":
        assert (bt == jmatch.INF_DIST).all() and (st == jmatch.INF_DIST).all()
        assert (it == 0).all()
    elif case == "one_gated_in_column":
        assert int(it[0]) == 17 and int(st[0]) == jmatch.INF_DIST
    elif case == "duplicate_ties":
        assert int(bt[3]) == 0 and int(st[3]) == 0 and int(it[3]) == 5
    elif case == "wide_windows":
        assert int((bt < jmatch.INF_DIST).sum()) > 100
