"""The pyramid's level table: where each level lies in the one buffer that
holds all levels of a frame, and how its keypoints are budgeted.

The all-levels kernels (K1, K2, K16-K19) take every level of a frame in one
(B, n_pixels) float32 buffer, level l at ``offset[l]`` as a row-major
(h[l], w[l]) image, and the keypoints of all levels in one (B, n_slots)
block, level l's ``quota[l]`` slots at ``quota_offset[l]``. The table is a
host constant, built once per (shape, ORB settings) and handed to each
launch by value: nothing of it is uploaded.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np

MAX_LEVELS = 16  # capacity of the kernels' by-value table (csrc/levels.cuh)
# columns of LevelTable.ints, the order csrc/levels.cuh reads them in
FIELDS = ("offset", "h", "w", "tile", "tiles_per_row", "n_tiles", "k_tile",
          "quota")


def level_quotas(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level keypoint budget, geometric in 1/scale."""
    f = 1.0 / scale_factor
    base = n_features * (1 - f) / (1 - f ** n_levels)
    quotas = [int(round(base * f ** l)) for l in range(n_levels)]
    quotas[-1] = max(0, n_features - sum(quotas[:-1]))
    return quotas


def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    """Static per-level shapes, matching the reference's round(dim/scale^l)."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def level_tile(tile: int, scale_factor: float, level: int) -> int:
    """Side of the selection tiles of a level (pixels of that level)."""
    return max(8, int(round(tile / (scale_factor ** level))))


def tile_budget(h: int, w: int, tile: int, quota: int) -> Tuple[int, int, int]:
    """(tiles per row, tiles, candidates kept per tile) of select_keypoints
    on an (h, w) level."""
    nth, ntw = -(-h // tile), -(-w // tile)
    n_tiles = nth * ntw
    return ntw, n_tiles, max(1, min(tile * tile, -(-2 * quota // n_tiles)))


class LevelTable(NamedTuple):
    ints: np.ndarray     # (n_levels, len(FIELDS)) int32, C-contiguous
    scale: np.ndarray    # (n_levels,) float32(scale_factor ** level)
    shapes: Tuple[Tuple[int, int], ...]
    n_pixels: int        # pixels of all levels
    n_slots: int         # keypoint slots of all levels (sum of the quotas)
    n_tiles: int         # selection tiles of all levels
    n_candidates: int    # sum of n_tiles * k_tile
    max_tile: int

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    def column(self, name: str) -> np.ndarray:
        return self.ints[:, FIELDS.index(name)]

    def level_slice(self, level: int) -> slice:
        """Level `level`'s pixels in the (B, n_pixels) buffer."""
        off = int(self.column("offset")[level])
        h, w = self.shapes[level]
        return slice(off, off + h * w)


def table_from_levels(shapes, quotas, tiles, scales) -> LevelTable:
    """A table from per-level lists: (h, w) shapes, keypoint quotas, tile
    sides and coordinate scales."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{len(shapes)} levels outside 1..{MAX_LEVELS}")
    rows, off = [], 0
    for l, ((h, w), q, t) in enumerate(zip(shapes, quotas, tiles)):
        ntw, n_tiles, k_tile = tile_budget(h, w, t, q) if q else (0, 0, 0)
        if q > n_tiles * k_tile:
            raise ValueError(f"level {l}: quota {q} exceeds its {n_tiles} "
                             f"tiles x {k_tile} candidates")
        rows.append((off, h, w, t, ntw, n_tiles, k_tile, q))
        off += h * w
    ints = np.ascontiguousarray(rows, np.int32)
    scale = np.asarray(scales, np.float32)
    ints.setflags(write=False)
    scale.setflags(write=False)
    return LevelTable(ints=ints, scale=scale,
                      shapes=tuple((int(h), int(w)) for h, w in shapes),
                      n_pixels=off, n_slots=int(sum(quotas)),
                      n_tiles=int(ints[:, 5].sum()),
                      n_candidates=int((ints[:, 5] * ints[:, 6]).sum()),
                      max_tile=int(ints[:, 3].max()))


@lru_cache(maxsize=16)
def level_table(height: int, width: int, n_levels: int, scale_factor: float,
                n_features: int, tile: int) -> LevelTable:
    """The table of an (height, width) frame under the given ORB settings. A
    level whose quota is 0 holds no tiles: it yields no keypoints."""
    if n_levels < 1:
        raise ValueError(f"n_levels {n_levels} < 1")
    return table_from_levels(
        pyramid_shapes(height, width, n_levels, scale_factor),
        level_quotas(n_features, n_levels, scale_factor),
        [level_tile(tile, scale_factor, l) for l in range(n_levels)],
        [np.float32(scale_factor ** l) for l in range(n_levels)])


@lru_cache(maxsize=16)
def single_level(height: int, width: int) -> LevelTable:
    """A one-level table without keypoints: a lone (height, width) image as
    a buffer."""
    return table_from_levels([(height, width)], [0], [8], [1.0])
