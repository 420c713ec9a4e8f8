// The pyramid's level table, handed to the all-levels kernels by value.
//
// All levels of a frame lie in one float32 buffer (level l at off[l], row-
// major h[l] x w[l]); a batch of B frames is B such buffers, `n_pixels`
// apart. The host keeps the table as an (n_levels, 8) int32 array whose
// columns are ops/levels.py::FIELDS; psl_levels_from_host turns it into the
// struct below, and the launch copies the struct into the kernel's
// parameter space: no device constant, no upload.
#pragma once

#include "common.cuh"

constexpr int kPslMaxLevels = 16;
constexpr int kPslLevelFields = 8;

struct PslLevels {
  int n;                             // levels
  int n_pixels;                      // pixels of all levels
  int off[kPslMaxLevels];            // first pixel of the level
  int h[kPslMaxLevels];
  int w[kPslMaxLevels];
  int tile[kPslMaxLevels];           // side of a selection tile
  int ntw[kPslMaxLevels];            // tiles per row
  int k_tile[kPslMaxLevels];         // candidates kept per tile
  int tile_off[kPslMaxLevels + 1];   // first tile of the level
  int cand_off[kPslMaxLevels + 1];   // first candidate (tile_off * k_tile)
  int slot_off[kPslMaxLevels + 1];   // first keypoint slot (sum of quotas)
  int blk_off[kPslMaxLevels + 1];    // first block, set by tiled launches
  float scale[kPslMaxLevels];        // float32(scale_factor ^ level)
};

// Fill a PslLevels from the host's int32 rows (and float32 scales, or NULL).
// Returns false when n is out of range.
inline bool psl_levels_from_host(const int* rows, const float* scale, int n,
                                 PslLevels* lv) {
  if (n < 1 || n > kPslMaxLevels) return false;
  lv->n = n;
  lv->tile_off[0] = lv->cand_off[0] = lv->slot_off[0] = lv->blk_off[0] = 0;
  for (int l = 0; l < n; ++l) {
    const int* r = rows + l * kPslLevelFields;
    lv->off[l] = r[0];
    lv->h[l] = r[1];
    lv->w[l] = r[2];
    lv->tile[l] = r[3];
    lv->ntw[l] = r[4];
    lv->k_tile[l] = r[6];
    lv->tile_off[l + 1] = lv->tile_off[l] + r[5];
    lv->cand_off[l + 1] = lv->cand_off[l] + r[5] * r[6];
    lv->slot_off[l + 1] = lv->slot_off[l] + r[7];
    lv->blk_off[l + 1] = 0;
    lv->scale[l] = scale != nullptr ? scale[l] : 1.0f;
  }
  lv->n_pixels = lv->off[n - 1] + lv->h[n - 1] * lv->w[n - 1];
  return true;
}

// The level whose half-open range of `bounds` (n + 1 ascending entries)
// holds i.
__device__ __forceinline__ int psl_level_of(const int* bounds, int n, int i) {
  int l = 0;
  while (l + 1 < n && i >= bounds[l + 1]) ++l;
  return l;
}
