#!/usr/bin/env python3
"""Time the phases inside K1 (fast_score), K3 (gated_hamming_top2), K12
(plane_components), K13 (plane_assign_refit), K15 (manhattan_mean_shift),
K16 (pyramid_resize), K17 (gaussian_blur), K18 (select_keypoints), K22
(lift_lines_3d), K23 (search_lines_by_projection), K25 (match_select), K26
(frame_match_select), K28 (noise_alpha), K29 (frame_normals), K30
(associate_planes) and K31 (finish_step) on a GPU.

    python3 tools/kernel_phases.py

Copies csrc/fast_score.cu, csrc/hamming_top2.cu, csrc/plane_segment.cu
(twice: K12, K13), csrc/manhattan.cu, csrc/line_lift_search.cu,
csrc/pyramid.cu (twice: K16, K17), csrc/select_keypoints.cu,
csrc/step_tail.cu, csrc/depth_normals.cu (twice: K28, K29), the K22 part
of csrc/line_lift_search.cu, csrc/matching.cu (K25, K26) and
csrc/step_tail.cu (K31) into
build/kernel_phases/, inserts clock64 (and, in
K1, K3, K13, K17, K18, K23, K28 and K29, %globaltimer) reads at the
phase comments the sources carry,
builds each copy with the build's own flags into a library of its own,
and runs the wrappers of this checkout with those entry points in place
of the built ones:
- K3 on chip_smoke.py's `hamming_step_problems` (one tracking step's
  frame search, window search and match_descriptors' launch, and the
  window search at B = 4): per block the cycles of its phases (the rows'
  validity, staging the tile, the walk, the merge; median and largest
  over the blocks that ran them all), the blocks' start skew and the
  launch's span;
- K12's chain kernel (block 0) on `components_problems`' lane 0: the
  cycles of each phase from the validity copy to the end, median of five
  launches after one, and one block fit's cycles alone (one thread);
- K15 (block 0, thread 0, round 0) on chip_smoke.py's
  `manhattan_problems` at B = 1 and 4: the cycles of the cone pass, of
  one mean-shift pass (the second), of that pass's block reduction (from
  the warps' trees to the new centres, barriers included) and of thread
  0's tail of the round, and of the whole round; median of five launches
  after one;
- K29 on `normals_problems` at B = 1 and 4: per block, the first sample's
  cycles of staging, the box sums, the jump scan and the tail (median and
  largest over the blocks that ran them), the blocks' start skew and the
  launch's span;
- K28 on `alpha_problems` (frame 0 clean and noisy, B = 4): per block the
  cycles of the sampling, pass 0's counts (with their coarse sums), the
  wait at the cluster barrier after them, warp 0's merge and pick of the
  digit, passes 1 and 2, and the neighbour step with the result;
- K13 on `refit_problems` (B = 1 and 4; the marks of the last launch, the
  third round): per logical block the cycles of the ghost merge, the
  assign pass and the partial with its publication (median and largest),
  per collector (one per plane) those of the ghost merge, the in-order
  sums (its waits for the blocks included) and the fit, and per frame
  the tail from its last publication to its last collector's end;
- K1 on chip_smoke.py's `fast_problems` (B = 1 and 4): per block the
  cycles of staging its tile and of thread (0, 0)'s scoring of its
  pixels;
- K23 on chip_smoke.py's `line_search_problems`: per row tile the cycles
  of the projection (with the staging), the products and gates, and the
  row and column bests; per gate (the cluster's first block, or the gate
  launch above 256 lines) those of the two medians and of the mutual
  check, and from %globaltimer the wait of the gate for the last tile;
- K17 on chip_smoke.py's `blur_problems` (7 taps at B = 1 and 4, the
  line stage's 5 taps at B = 1 and 4): per block the cycles of its last
  band's staging wait, vertical pass and horizontal pass (thread 0's);
- K18 on chip_smoke.py's `select_problems` (B = 1 and 4, the planted
  map): per tile block the cycles of warp 0's staging, NMS and gate and
  passes, per rank block those of the staging and counting and of the
  slot, each launch's span and the gap between them;
- K16 on chip_smoke.py's `pyramid_problems` (B = 1 and 4, 1280x960,
  64x48): per block (a cone) the cycles of its staging, of levels 1 (with
  the copy of level 0), 2, 3 and 4, and of levels 5-7 together;
- K30 on chip_smoke.py's `assoc_problems` (path 1's 48th step clean and
  noisy, the planted "random" case, B = 4): per step (the first block of
  its cluster) the cycles of the staging, the distance pass, the cluster
  barrier after it and the picks and gathers;
- K22 on chip_smoke.py's `lift_problems` (frame 0 clean and noisy, B = 4,
  the planted S = 64 / 64 frame): per block, a line, the cycles of the
  loads' issue, the sampling, the hypothesis pass, the pick, the mean and
  covariance, the eigen-solve and the extent (median and largest over
  the blocks of valid lines: an invalid slot returns after its zeros);
- K25 on chip_smoke.py's `match_select_problems` (one tracking step's
  frame search, window search and match_descriptors, the window search
  at B = 4): per block, a problem, the cycles of the row loads' issue, the
  tests, the resolution pass and the stores;
- K26 on chip_smoke.py's `frame_match_problems` (one tracking step's
  launch, the brute-force fallback, B = 4, the first planted bin-edge
  problem): per block, a problem, the cycles of the load round's issue,
  the count, the brute-force gathers, the histogram, the pick and the
  stores;
- K31 on chip_smoke.py's `finish_step_problems` (path 1's 48th step,
  steps 45-48 at B = 4, a random tail): per block the cycles of the load
  round with the pose's staging, the items, the counts and their stores
  in block 0 (the features' block; the others return after their items),
  the blocks' start skew and the launch's span.
Prints one JSON object with the card's name and power limit. The marks
move where the code between them runs, not what it computes.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "build", "kernel_phases")
BLOCK_ROWS = 8192  # per-block mark rows: the largest grid timed (K3, B = 4)
# K3's and K29's mark: thread 0 of each block, clock64 and %globaltimer
BLOCK_MARK = ("if (threadIdx.x == 0) {{ long long g; asm volatile(\"mov.u64 "
              "%0, %%globaltimer;\" : \"=l\"(g)); const int b = "
              "blockIdx.y * gridDim.x + blockIdx.x; psl_phase[b][{k}] = "
              "clock64(); psl_phase[b][8 + {k}] = g; }}")
K3_PHASES = ("rows", "stage", "walk", "merge")
# K3: (anchor, mark index, before the anchor or after it)
K3_ANCHORS = (
    ("  // the rows' validity is asked first, then the first column tile's"
     " loads", 0, True),
    ("  // shared column tile: the descriptor halves", 1, True),
    ("    __syncthreads();\n    if (active) {\n      // four independent "
     "columns per step", 2, "after_sync"),
    ("  // the partial triples of a slot: inside a warp by shuffles", 3,
     True),
    ("              acc.idx);\n  }\n}\n", 4, "end"))
K12_MARK = ("if (threadIdx.x == 0 && blockIdx.x == 0) psl_phase[{k}] = "
            "clock64();")
K12_PHASES = ("valid_copy", "edges", "neighbour_mask", "label_rounds",
              "counts", "top_p_compact", "top_p_rank", "sums", "fits",
              "dedup")
K12_ANCHORS = (
    "  for (int i = tid; i < B; i += kCcThreads) {\n    valid[i] = "
    "p.block_valid[i];",
    "  // coplanarity edges to the right",
    "  // a block's left and upper edges are its neighbours'",
    "  // synchronous min-label pull",
    "  // component support: whole-number",
    "  // top-P by support",
    "  const int K = n_roots;",
    "  // per-component moment sums",
    "  if (k < p.P) {",
    "  // dedup: a candidate")
K12_END = ("    p.cand_valid[tid] = (cand_ok[tid] && !shadowed) ? 1 : 0;\n"
           "  }\n}\n")
K12_FIT = r"""
__global__ void phase_fit_kernel(const float* s1, const float* s2,
                                 const float* n, int i, long long* out,
                                 float* res) {
  float normal[3], d, mse, mean[3], s2v[9];
  const float s1v[3] = {s1[3 * i], s1[3 * i + 1], s1[3 * i + 2]};
  for (int q = 0; q < 9; ++q) s2v[q] = s2[9 * i + q];
  const float nv = n[i];
  const long long t0 = clock64();
  psl_plane_from_moments(s1v, s2v, nv, normal, &d, &mse, mean);
  out[0] = clock64() - t0;
  res[0] = normal[0] + d + mse + mean[0];
}
extern "C" int psl_phase_fit(const float* s1, const float* s2,
                             const float* n, int i, long long* out,
                             float* res) {
  phase_fit_kernel<<<1, 1>>>(s1, s2, n, i, out, res);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
K15_MARK = ("if (threadIdx.x == 0 && blockIdx.x == 0 && rnd == 0{cond}) "
            "psl_phase[{k}] = clock64();")
K15_PHASES = ("cones", "ms_pass", "reduction", "tail", "round")
# K15: (anchor, mark index, extra condition); marks 2 and 4 open passes 1
# and 2, so 4 - 2 is one whole pass and 4 - 3 its reduction
K15_ANCHORS = (
    ("    // cone pass: the owned normals' cones", 0, ""),
    ("    float c[3][2] = {{0.0f, 0.0f}", 1, ""),
    ("      // a mean-shift pass: each thread's weight sums", 2,
     " && ms == 1"),
    ("      // a mean-shift pass: each thread's weight sums", 4,
     " && ms == 2"),
    ("      // the block reduction: the warps' trees", 3, " && ms == 1"),
    ("    // the round's tail", 5, ""),
    ("    __syncthreads();\n  }\n}\n\n}  // namespace", 6, ""))
K29_PHASES = ("stage", "box_sums", "jump_scan", "tail")
K29_ANCHORS = (
    "  // staging: the raw patch of a window inside the image",
    "  // box sums: lane l the smoothed depths",
    "  // jump scan: the 1-pixel jumps",
    "  // the sample's tail, by lane 0")
K29_END = "    valid[o] = ok ? 1 : 0;\n  }\n}\n"
K28_PHASES = ("sampling", "pass0_counts", "cluster_wait", "merge_pick",
              "passes_1_2", "neighbour")
K28_ANCHORS = (
    "  // sampling: this block's samples",
    "  // pass 0's counts:",
    "  cl.sync();  // every block's counts of the pass",
    "  // merge and pick:",
    "  // passes 1 and 2:",
    "  // the neighbour step:",
    "  cl.sync();  // no block leaves while another reads its shared memory")
# K13: marks 0-3 in a logical block (the ghost merge, the assign pass, the
# partial and its publication, the end), 0 and 4-6 in the frame's
# collector (the ghost merge, the in-order sums, the fits, the end)
K13_ANCHORS = (
    "  // the planes: the ghost merge, once per block",
    "  // assign: each pixel's plane",
    "  // this block's partial: its warps summed in order",
    "  if (tid == 0) store_release(flags + blockIdx.x, touched | kPublished);"
    "\n",
    "  // the in-order sums\n",
    "  // the fits: plane j by warp 0's first half-warp",
    "    alive_out[o] = ps.alive[j];\n")
K1_ANCHORS = (
    "  // staging: the tile and its halo",
    "  // scoring: the footprint's")
K1_END = "    if (x < w) o[x] = score_of(v, p);\n  }\n"
K1_PHASES = ("staging", "scoring")
# K1's blocks are 16 x 16 threads: thread (0, 0) marks
K1_MARK = BLOCK_MARK.replace("threadIdx.x == 0", "threadIdx.x == 0 && "
                             "threadIdx.y == 0")
# K23: marks 0-3 in every row tile (projection, products, bests, the
# tile's end), 4-6 in the gate (the medians, the mutual check, the end)
K23_ANCHORS = (
    ("  // projection: a row's endpoints", 0, True),
    ("  // products: warp w takes rows", 1, True),
    ("  // row and column bests:", 2, True),
    ("    out_cr[l] = m0 + r;\n  }\n  __syncthreads();\n", 3, False),
    ("  // the two medians:", 4, True),
    ("  // the mutual check:", 5, True),
    ("    idx[m] = (bs[m] > th && back[b] == m) ? b : -1;\n  }\n", 6,
     False))
# K17: marks 0-3 in each band of a block (thread 0's: the staging wait,
# the vertical pass, the horizontal pass, the band's end); the last band's
K17_ANCHORS = (
    "    // staging: band k + 1's copies issued, band k's awaited",
    "    // vertical pass: rows 8 half",
    "    // horizontal pass: warp w rows",
    "  }  // the walk down the strip")
K17_PHASES = ("staging", "vertical", "horizontal")
# K18: marks 0-3 in a tile block (warp 0's tile: staging, NMS and gate,
# passes, end), 4-6 in a rank block (staging and counting, the slot, end)
K18_ANCHORS = (
    ("  // staging: the tile and its 1-pixel halo", 0, True),
    ("  // NMS and gate:", 1, True),
    ("  // passes: the tile's best by shuffles", 2, True),
    ("    if (lane == 0) cell[b.i] = taken;\n    __syncwarp();\n  }\n", 3,
     False),
    ("  // rank stage: this lane's candidate", 4, True),
    ("  // the slot: the slices' counts summed", 5, True),
    ("      valid[slot] = vi > 0.0f ? 1 : 0;\n    }\n  }\n", 6, False))
# K16: marks per block, a cone (thread 0's): the staging's start and end,
# the ends of levels 1-4, the end
K16_ANCHORS = (
    ("  // staging: the cone's chunk (its levels' ranges and taps) and the",
     0, True),
    ("  // level 0: the part of the frame the cone owns", 1, True),
    ("    an = nx;\n  }\n}\n", 6, "end"))
K16_LEVEL = "    const int* h = chunk + kLevelWords * l;\n"
K16_PHASES = ("staging", "level1", "level2", "level3", "level4",
              "levels5_7")
# K30: marks 0-4 per block (thread 0's: staging, the distance pass, the
# cluster barrier before the keys are complete, the picks and gathers, the
# end; only a cluster's first block picks and reaches marks 3 and 4)
K30_ANCHORS = (
    ("  // staging: a thread a map plane or a frame plane", 0, True),
    ("  // the distance pass: the cluster's warps over the units", 1, True),
    ("  cl.sync();  // the keys complete", 2, True),
    ("  // picks and gathers: a warp per frame plane", 3, True),
    ("      ver[fp] = id_ver;\n    }\n  }\n}\n", 4, "end"))
K30_PHASES = ("staging", "distances", "barrier", "picks")
# K22: marks 0-7 per block, a line (thread 0's): the loads' issue, the
# sampling (its depth gathers and the barrier after it), the hypothesis
# pass (with the barrier after it), the pick of the best, the mean and
# covariance, the eigen-solve, the extent; warp 0 alone from the pick on
K22_ANCHORS = (
    ("  // every load of the line, its sample position and this warp's", 0),
    ("  // sampling: a thread a sample, its nearest depth and", 1),
    ("  // the hypothesis pass: a warp a share of the hypotheses, a lane", 2),
    ("  // the pick of the best: the first largest count", 3),
    ("  // the mean and the covariance: the weighted mean's four", 4),
    ("  // the eigen-solve: every lane of the warp the same one", 5),
    ("  // the extent along dir: the least and the largest t", 6),
    ("  // the outputs\n", 7))
K22_PHASES = ("loads", "sampling", "hypotheses", "pick", "mean_cov",
              "eigen", "extent")
# K25: marks 0-4 per block, a problem (thread 0's): the row loads' issue,
# the tests (the loads' wait and the mutual check's gathers), the rows
# beyond the registers' and the resolution pass with its two barriers, the
# stores
K25_ANCHORS = (
    ("  // the row loads: every row's best, best_idx and second at once", 0,
     True),
    ("  // the tests: best <= max_dist, the ratio test, then the mutual", 1,
     True),
    ("  // rows beyond the registers' (m > R * kBlockThreads)", 2, True),
    ("  // the stores: each row once", 3, True),
    ("      a.dist_out[base + i] = d[r];\n    }\n  }\n}\n", 4, "end"))
K25_PHASES = ("row_loads", "tests", "resolution", "stores")
# K26: marks 0-6 per block, a problem (thread 0's): the load round's issue,
# the count (the projection matches' wait and its barriers), the
# brute-force gathers where they are taken, the histogram (the gathers'
# wait, the bins and the warp-aggregated atomics, with its barrier), the
# pick (each warp's), the stores; frame mode only
K26_ANCHORS = (
    ("  // the load round: row 0's gathers (a dropped match's) and the "
     "per-level", 0, True),
    ("  // the count: use_bf = count(proj_idx >= 0) < kMinProj, the same in",
     1, True),
    ("    // the gathers: the brute-force matches' where they are taken", 2,
     True),
    ("  // the histogram: each row's bin computed once, warp-aggregated", 3,
     True),
    ("  // the pick: every warp alike (no barrier after it), three "
     "reductions of", 4, True),
    ("  // the stores, from registers", 5, True),
    ("      frame_store(a, table, bm + i, x, keep, u0, v0, level0);\n    }\n"
     "  }\n}\n", 6, "end"))
K26_PHASES = ("loads", "count", "gathers", "histogram", "pick", "stores")
# K31: marks 0-4 per block (thread 0's): the load round's issue with the
# pose's staging and its barrier, the items (their wait, outputs and
# stores), the counts (warp reductions, a barrier, warp 0 over the warps'
# sums) and their stores; the last two in block 0 alone, the one whose
# marks all move (the others return after their items)
K31_ANCHORS = (
    ("  // the load round: this thread's first item, and in warp 0 both", 0,
     True),
    ("  // the items\n", 1, True),
    ("  // the counts: block 0's alone (the other blocks are done), per "
     "warp,", 2, True),
    ("  // the stores: block 0's keyframe counts, lane k the k-th", 3, True),
    ("        static_cast<float>(n);\n  }\n}\n", 4, "end"))
K31_PHASES = ("loads", "items", "counts", "stores")
READ = ('\nextern "C" int psl_phase_read(void* out, int bytes) {\n'
        '  return static_cast<int>(cudaMemcpyFromSymbol(out, psl_phase, '
        'bytes));\n}\n')


def _mark(src: str, anchor: str, mark: str, where) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"phase anchor not found once: {anchor!r}")
    if where == "after_sync":
        head, tail = anchor.split("\n", 1)
        return src.replace(anchor, f"{head}\n    {mark}\n{tail}")
    if where == "end":
        return src.replace(anchor,
                           f"{anchor[:-2]}  __syncthreads();\n  {mark}\n}}\n")
    return src.replace(anchor, f"{mark}\n{anchor}")


def _k3_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "hamming_top2.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, where in K3_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), where)
    return src + READ


def _k12_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "plane_segment.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", "__device__ long long psl_phase[16];"
                      "\nnamespace {\n", 1)
    for k, anchor in enumerate(K12_ANCHORS):
        src = _mark(src, anchor, K12_MARK.format(k=k), True)
    src = _mark(src, K12_END, K12_MARK.format(k=len(K12_ANCHORS)), "end")
    return src + K12_FIT + READ


def _k15_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "manhattan.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", "__device__ long long psl_phase[16];"
                      "\nnamespace {\n", 1)
    for anchor, k, cond in K15_ANCHORS:
        src = _mark(src, anchor, K15_MARK.format(k=k, cond=cond), True)
    return src + READ


def _k29_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "depth_normals.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for k, anchor in enumerate(K29_ANCHORS):
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), True)
    if src.count(K29_END) != 1:
        raise RuntimeError(f"phase anchor not found once: {K29_END!r}")
    head = K29_END[:-len("  }\n}\n")]
    src = src.replace(K29_END, f"{head}    "
                      f"{BLOCK_MARK.format(k=len(K29_ANCHORS))}\n  }}\n}}\n")
    return src + READ


def _k28_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "depth_normals.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for k, anchor in enumerate(K28_ANCHORS):
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), True)
    return src + READ


def _k13_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "plane_segment.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for k, anchor in enumerate(K13_ANCHORS):
        # marks 3 and 6 close their blocks: after the anchor, not before
        after = k in (3, 6)
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found once: {anchor!r}")
        mark = BLOCK_MARK.format(k=k)
        src = src.replace(anchor, f"{anchor}{mark}\n" if after
                          else f"{mark}\n{anchor}")
    return src + READ


def _k1_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "fast_score.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for k, anchor in enumerate(K1_ANCHORS):
        src = _mark(src, anchor, K1_MARK.format(k=k), True)
    if src.count(K1_END) != 1:
        raise RuntimeError(f"phase anchor not found once: {K1_END!r}")
    return src.replace(K1_END, K1_END + "  " + K1_MARK.format(
        k=len(K1_ANCHORS)) + "\n") + READ


def _k23_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "line_lift_search.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, before in K23_ANCHORS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found once: {anchor!r}")
        mark = BLOCK_MARK.format(k=k)
        src = src.replace(anchor, f"{mark}\n{anchor}" if before
                          else f"{anchor}  {mark}\n")
    return src + READ


def _k17_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "pyramid.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for k, anchor in enumerate(K17_ANCHORS):
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), True)
    return src + READ


def _k18_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "select_keypoints.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, before in K18_ANCHORS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found once: {anchor!r}")
        mark = BLOCK_MARK.format(k=k)
        src = src.replace(anchor, f"{mark}\n{anchor}" if before
                          else f"{anchor}  {mark}\n")
    return src + READ


def _k16_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "pyramid.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, where in K16_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), where)
    marks = "".join(f"if (l == {l}) {{ {BLOCK_MARK.format(k=l)} }}\n"
                    for l in range(2, 6))
    if src.count(K16_LEVEL) != 1:
        raise RuntimeError("phase anchor not found once: the cone's level")
    return src.replace(K16_LEVEL, marks + K16_LEVEL) + READ


def _k30_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "step_tail.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, where in K30_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), where)
    return src + READ


def _k22_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "line_lift_search.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k in K22_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), True)
    return src + READ


def _k25_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "matching.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, where in K25_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), where)
    return src + READ


def _k26_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "matching.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, where in K26_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), where)
    return src + READ


def _k31_source(kernels) -> str:
    with open(os.path.join(kernels.CSRC, "step_tail.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", f"__device__ long long psl_phase"
                      f"[{BLOCK_ROWS}][16];\nnamespace {{\n", 1)
    for anchor, k, where in K31_ANCHORS:
        src = _mark(src, anchor, BLOCK_MARK.format(k=k), where)
    return src + READ


def _k30_marks(lib, fn) -> dict:
    """K30's marks after one call of fn: per step (its cluster's first
    block, the one that picks) the cycles of its staging, distance pass,
    cluster barrier and picks and gathers (median and largest), and the
    launch's span (us)."""
    return _block_marks(lib, fn, K30_PHASES)


def _k18_marks(lib, fn) -> dict:
    """K18's marks after one call of fn: per tile block (warp 0's tile) the
    cycles of the staging, the NMS and gate and the passes, per rank block
    those of the staging and counting and of the slot (median and
    largest), each launch's span and the rank launch's first mark after
    the tile launch's last (us)."""
    marks, before = _launch_marks(lib, fn)
    tile = marks[(marks[:, 8] != before[:, 8])
                 & (marks[:, 11] != before[:, 11])]
    rank = marks[(marks[:, 12] != before[:, 12])
                 & (marks[:, 14] != before[:, 14])]
    tc = {"staging": tile[:, 1] - tile[:, 0], "nms_gate": tile[:, 2]
          - tile[:, 1], "passes": tile[:, 3] - tile[:, 2]}
    rc = {"count": rank[:, 5] - rank[:, 4], "slot": rank[:, 6] - rank[:, 5]}
    return {"tile_blocks": len(tile), "rank_blocks": len(rank),
            "tile_span_us": float((tile[:, 11].max() - tile[:, 8].min())
                                  / 1e3),
            "rank_span_us": float((rank[:, 14].max() - rank[:, 12].min())
                                  / 1e3),
            "gap_us": float((rank[:, 12].min() - tile[:, 11].max()) / 1e3),
            "tile_cycles_median": {k: float(np.median(v))
                                   for k, v in tc.items()},
            "tile_cycles_max": {k: int(v.max()) for k, v in tc.items()},
            "rank_cycles_median": {k: float(np.median(v))
                                   for k, v in rc.items()},
            "rank_cycles_max": {k: int(v.max()) for k, v in rc.items()}}


def _k23_marks(lib, fn) -> dict:
    """K23's marks after one call of fn: per row tile the cycles of the
    projection (with the staging), the products and gates and the bests
    (median and largest), per gate those of the two medians and the
    mutual check, the gate's wait from the last tile's end (us, the
    cluster configuration) and the call's span."""
    marks, before = _launch_marks(lib, fn)
    tile = marks[(marks[:, 8] != before[:, 8])
                 & (marks[:, 11] != before[:, 11])]
    gate = marks[(marks[:, 12] != before[:, 12])
                 & (marks[:, 14] != before[:, 14])]
    tc = {"projection": tile[:, 1] - tile[:, 0],
          "products": tile[:, 2] - tile[:, 1],
          "bests": tile[:, 3] - tile[:, 2]}
    gc = {"medians": gate[:, 5] - gate[:, 4],
          "mutual_check": gate[:, 6] - gate[:, 5]}
    moved = marks[:, 8:15] != before[:, 8:15]
    stamps = marks[:, 8:15][moved]
    return {"tiles": len(tile), "gates": len(gate),
            "span_us": float((stamps.max() - stamps.min()) / 1e3),
            "gate_wait_us": float((gate[:, 12].min() - tile[:, 11].max())
                                  / 1e3),
            "tile_cycles_median": {k: float(np.median(v))
                                   for k, v in tc.items()},
            "tile_cycles_max": {k: int(v.max()) for k, v in tc.items()},
            "gate_cycles_median": {k: float(np.median(v))
                                   for k, v in gc.items()}}


def _k13_marks(lib, fn, n_part: int, planes: int) -> dict:
    """K13's marks after one call of fn (its last launch): per logical
    block the cycles of the ghost merge, the assign pass and the partial
    with its publication (median and largest), per collector those of the
    ghost merge, the in-order sums (its waits included) and the fit, and
    per frame the tail: its last collector's end less its last
    publication (us). A launch's grid is n_part logical blocks and one
    collector per plane a frame."""
    marks, _ = _launch_marks(lib, fn)
    gx = n_part + planes
    rows = np.arange(len(marks))
    ran = marks[:, 8] != 0
    coll = ran & (rows % gx >= n_part)
    assign = ran & ~coll
    a, c = marks[assign], marks[coll]
    ac = {"planes": a[:, 1] - a[:, 0], "assign": a[:, 2] - a[:, 1],
          "partial_publish": a[:, 3] - a[:, 2]}
    cc = {"planes": c[:, 4] - c[:, 0], "collect": c[:, 5] - c[:, 4],
          "fit": c[:, 6] - c[:, 5]}
    tail = []
    for f in sorted(set((rows[coll] // gx).tolist())):
        blk = marks[gx * f:gx * f + gx]
        tail.append(float((blk[n_part:, 14].max() - blk[:n_part, 11].max())
                          / 1e3))
    return {"assign_blocks": int(assign.sum()), "collectors": int(coll.sum()),
            "span_us": float((marks[ran, 8:15].max() - marks[ran, 8].min())
                             / 1e3),
            "assign_cycles_median": {k: float(np.median(v))
                                     for k, v in ac.items()},
            "assign_cycles_max": {k: int(v.max()) for k, v in ac.items()},
            "collector_cycles_median": {k: float(np.median(v))
                                        for k, v in cc.items()},
            "collector_cycles_max": {k: int(v.max()) for k, v in cc.items()},
            "tail_us": tail}


def _launch_marks(lib, fn):
    """The mark rows after one call of fn that follows three, with the
    rows before it: clock64 (0-7) and %globaltimer (8-15) per block."""
    import torch

    marks = np.zeros((BLOCK_ROWS, 16), np.int64)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    lib.psl_phase_read(marks.ctypes.data_as(ctypes.c_void_p), marks.nbytes)
    before = marks.copy()
    fn()
    torch.cuda.synchronize()
    lib.psl_phase_read(marks.ctypes.data_as(ctypes.c_void_p), marks.nbytes)
    return marks, before


def _block_marks(lib, fn, phases) -> dict:
    """One launch of fn after three: per block the cycles of each phase
    (median and largest over the blocks whose marks all moved), their start
    skew and the launch's span, from per-block rows of clock64 (0-7) and
    %globaltimer (8-15) marks."""
    marks, before = _launch_marks(lib, fn)
    n = len(phases)
    ran = marks[:, 8] != before[:, 8]
    full = ran & (marks[:, 8 + n] != before[:, 8 + n])
    g0 = marks[ran, 8].min()
    cyc = marks[full, 1:n + 1] - marks[full, 0:n]
    return {"blocks_ran": int(ran.sum()), "blocks_full": int(full.sum()),
            "span_us": float((marks[ran, 8:9 + n].max() - g0) / 1e3),
            "start_skew_us": float((marks[ran, 8].max() - g0) / 1e3),
            "cycles_median": dict(zip(phases, np.median(cyc, 0).tolist())),
            "cycles_max": dict(zip(phases, cyc.max(0).tolist()))}


def _build(kernels, name: str, src: str, flags) -> ctypes.CDLL:
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"lib{name}.so")
    # fast_score.cu carries psl_error_string, which kernels.launch calls
    extra = [] if name == "fast_score" else [
        os.path.join(kernels.CSRC, "fast_score.cu")]
    run = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", kernels.CSRC,
         "-shared", "-o", lib, path, *extra],
        capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}: {run.stderr}")
    return ctypes.CDLL(lib)


class _Swap:
    """The built library with some entry points taken from another."""

    def __init__(self, real, other, names):
        self.real, self.other, self.names = real, other, names

    def __getattr__(self, name):
        return getattr(self.other if name in self.names else self.real, name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    from planarslam_tpu_torch import kernels
    from planarslam_tpu_torch.config import SystemConfig
    from planarslam_tpu_torch.io import synthetic

    spec = importlib.util.spec_from_file_location(
        "kernel_phases_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    os.makedirs(OUT, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    real = kernels.cuda_lib()
    k3 = _build(kernels, "hamming_top2", _k3_source(kernels), ())
    k12 = _build(kernels, "plane_segment", _k12_source(kernels),
                 kernels.SOURCE_FLAGS["plane_segment.cu"])
    k15 = _build(kernels, "manhattan", _k15_source(kernels),
                 kernels.SOURCE_FLAGS["manhattan.cu"])
    k29 = _build(kernels, "depth_normals", _k29_source(kernels),
                 kernels.SOURCE_FLAGS["depth_normals.cu"])
    k28 = _build(kernels, "depth_normals_k28", _k28_source(kernels),
                 kernels.SOURCE_FLAGS["depth_normals.cu"])
    k13 = _build(kernels, "plane_segment_k13", _k13_source(kernels),
                 kernels.SOURCE_FLAGS["plane_segment.cu"])
    k1 = _build(kernels, "fast_score", _k1_source(kernels),
                kernels.SOURCE_FLAGS.get("fast_score.cu", ()))
    k23 = _build(kernels, "line_lift_search", _k23_source(kernels),
                 kernels.SOURCE_FLAGS["line_lift_search.cu"])
    k17 = _build(kernels, "pyramid", _k17_source(kernels),
                 kernels.SOURCE_FLAGS["pyramid.cu"])
    k18 = _build(kernels, "select_keypoints", _k18_source(kernels),
                 kernels.SOURCE_FLAGS["select_keypoints.cu"])
    k30 = _build(kernels, "step_tail", _k30_source(kernels),
                 kernels.SOURCE_FLAGS["step_tail.cu"])
    k16 = _build(kernels, "pyramid_k16", _k16_source(kernels),
                 kernels.SOURCE_FLAGS["pyramid.cu"])
    k22 = _build(kernels, "line_lift_search_k22", _k22_source(kernels),
                 kernels.SOURCE_FLAGS["line_lift_search.cu"])
    k25 = _build(kernels, "matching", _k25_source(kernels),
                 kernels.SOURCE_FLAGS["matching.cu"])
    k26 = _build(kernels, "matching_k26", _k26_source(kernels),
                 kernels.SOURCE_FLAGS["matching.cu"])
    k31 = _build(kernels, "step_tail_k31", _k31_source(kernels),
                 kernels.SOURCE_FLAGS["step_tail.cu"])
    entries = {"psl_gated_hamming_top2": k3, "psl_mutual_hamming_top2": k3,
               "psl_plane_components": k12, "psl_manhattan_mean_shift": k15,
               "psl_frame_normals": k29, "psl_noise_alpha": k28,
               "psl_plane_assign_refit": k13, "psl_fast_score_levels": k1,
               "psl_search_lines": k23, "psl_gaussian_blur": k17,
               "psl_select_keypoints": k18, "psl_pyramid_build": k16,
               "psl_associate_planes": k30, "psl_lift_lines_3d": k22,
               "psl_match_select": k25, "psl_frame_match_select": k26,
               "psl_finish_step": k31}
    for name, lib in entries.items():
        getattr(lib, name).argtypes = kernels._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    k23.psl_search_lines_scratch_words.argtypes = kernels._HELPERS[
        "psl_search_lines_scratch_words"]
    k23.psl_search_lines_scratch_words.restype = ctypes.c_longlong
    for lib in (k3, k12, k15, k29, k28, k13, k1, k23, k17, k18, k16, k30,
                k22, k25, k26, k31):
        lib.psl_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cfg = SystemConfig()
    seq = synthetic.make_sequence(smoke.TRACKING_FRAMES,
                                  width=cfg.camera.width,
                                  height=cfg.camera.height)
    dev = torch.device("cuda", 0)
    out = {"device": smi.stdout.strip(), "gated_hamming_top2": {}}

    kernels._lib = _Swap(real, k3, {"psl_gated_hamming_top2",
                                    "psl_mutual_hamming_top2"})
    for name, fn in smoke.hamming_step_problems(seq, cfg, dev).items():
        out["gated_hamming_top2"][name] = _block_marks(k3, fn, K3_PHASES)

    kernels._lib = _Swap(real, k12, {"psl_plane_components"})
    fn = smoke.components_problems(seq, cfg, dev)["b1"]
    t = np.zeros(16, np.int64)
    rows = []
    for rep in range(6):
        fn()
        torch.cuda.synchronize()
        k12.psl_phase_read(t.ctypes.data_as(ctypes.c_void_p), t.nbytes)
        if rep:
            rows.append(np.diff(t[:len(K12_PHASES) + 1]))
    stats, _, _ = smoke.components_inputs(seq, cfg, dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    res = torch.zeros(1, device=dev)
    k12.psl_phase_fit.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fits = []
    for i in (0, 100, 2000, 2401, 4000):
        for _ in range(2):
            k12.psl_phase_fit(stats.s1.data_ptr(), stats.s2.data_ptr(),
                              stats.n.data_ptr(), i, cyc.data_ptr(),
                              res.data_ptr())
        fits.append(int(cyc.item()))
    out["plane_components"] = {
        "cycles_median": dict(zip(K12_PHASES,
                                  np.median(rows, 0).tolist())),
        "one_fit_cycles": fits}
    kernels._lib = _Swap(real, k15, {"psl_manhattan_mean_shift"})
    out["manhattan_mean_shift"] = {}
    for name, fn in smoke.manhattan_problems(seq, cfg, dev).items():
        rows = []
        for rep in range(6):
            fn()
            torch.cuda.synchronize()
            k15.psl_phase_read(t.ctypes.data_as(ctypes.c_void_p), t.nbytes)
            if rep:
                rows.append([t[1] - t[0], t[4] - t[2], t[4] - t[3],
                             t[6] - t[5], t[6] - t[0]])
        out["manhattan_mean_shift"][name] = {
            "cycles_median": dict(zip(K15_PHASES,
                                      np.median(rows, 0).tolist()))}

    kernels._lib = _Swap(real, k29, {"psl_frame_normals"})
    out["frame_normals"] = {
        name: _block_marks(k29, fn, K29_PHASES)
        for name, fn in smoke.normals_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k28, {"psl_noise_alpha"})
    out["noise_alpha"] = {
        name: _block_marks(k28, fn, K28_PHASES)
        for name, fn in smoke.alpha_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k13, {"psl_plane_assign_refit"})
    from planarslam_tpu_torch.ops import planes as P

    rs = max(1, int(cfg.planes.refine_stride))
    n_part = -(-(-(-cfg.camera.height // rs) * -(-cfg.camera.width // rs))
               // P.ASSIGN_PIXELS_PER_BLOCK)
    out["plane_assign_refit"] = {
        name: _k13_marks(k13, fn, n_part, cfg.planes.max_planes)
        for name, fn in smoke.refit_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k1, {"psl_fast_score_levels"})
    out["fast_score"] = {
        name: _block_marks(k1, fn, K1_PHASES)
        for name, fn in smoke.fast_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k23, {"psl_search_lines",
                                     "psl_search_lines_scratch_words"})
    out["search_lines_by_projection"] = {
        name: _k23_marks(k23, fn)
        for name, fn in smoke.line_search_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k17, {"psl_gaussian_blur"})
    out["gaussian_blur"] = {
        name: _block_marks(k17, fn, K17_PHASES)
        for name, fn in smoke.blur_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k18, {"psl_select_keypoints"})
    out["select_keypoints"] = {
        name: _k18_marks(k18, fn)
        for name, fn in smoke.select_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k16, {"psl_pyramid_build"})
    out["pyramid_resize"] = {
        name: _block_marks(k16, fn, K16_PHASES)
        for name, fn in smoke.pyramid_problems(seq, cfg, dev).items()}
    kernels._lib = _Swap(real, k30, {"psl_associate_planes"})
    out["associate_planes"] = {
        name: _k30_marks(k30, fn)
        for name, fn in smoke.assoc_problems(seq, cfg, dev).items()
        if name in (f"step{smoke.ASSOC_STEP}_clean",
                    f"step{smoke.ASSOC_STEP}_noisy", "random", "b4")}
    kernels._lib = _Swap(real, k22, {"psl_lift_lines_3d"})
    out["lift_lines_3d"] = {
        name: _block_marks(k22, fn, K22_PHASES)
        for name, fn in smoke.lift_problems(seq, cfg, dev).items()
        if name in ("clean", "noisy", "b4", "sizes_64_64")}
    kernels._lib = _Swap(real, k25, {"psl_match_select"})
    out["match_select"] = {
        name: _block_marks(k25, fn, K25_PHASES)
        for name, fn in smoke.match_select_problems(seq, cfg, dev).items()
        if name in ("frame", "window", "descriptors", "window_b4")}
    kernels._lib = _Swap(real, k26, {"psl_frame_match_select"})
    out["frame_match_select"] = {
        name: _block_marks(k26, fn, K26_PHASES)
        for name, fn in smoke.frame_match_problems(seq, cfg, dev).items()
        if name in ("projection", "brute_force", "b4", "bin_edges_0")}
    kernels._lib = _Swap(real, k31, {"psl_finish_step"})
    out["finish_step"] = {
        name: _block_marks(k31, fn, K31_PHASES)
        for name, fn in smoke.finish_step_problems(seq, cfg, dev).items()
        if name in (f"step{smoke.ASSOC_STEP}", "b4", "random_final_True")}
    kernels._lib = real
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True)
    out["sm_clock"] = clocks.stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
