"""Build, load and launch the hand-written Hopper kernels.

CUDA C++ kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use into ``build/planarslam_tpu_torch/`` at the
repository root, keyed by a hash of the sources. The Triton kernel
(``csrc/plane_moments_triton.py``) is imported from its file only when it
is launched, because ``triton`` exists only where a card does.

Each op module keeps its kernel's wrapper beside the plain PyTorch version:
the wrapper takes the plain version only for CPU tensors and, for CUDA
tensors, launches the kernel or raises. ``LAUNCHES[name]`` counts kernel
launches (never plain-version calls), so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

KERNEL_NAMES = ("fast_score", "orb_describe", "gated_hamming_top2",
                "plane_block_moments", "triangulate_two_view",
                "horn_align_batch", "pnp_dlt_hypotheses", "ba_normal_eqs",
                "ba_schur_eliminate", "pose_graph_normal_eqs",
                "pose_optimize", "plane_components", "plane_assign_refit",
                "plane_label_pixels", "manhattan_mean_shift",
                "pyramid_resize", "gaussian_blur", "select_keypoints",
                "point_epilogue", "detect_lines", "line_descriptors",
                "lift_lines_3d", "search_lines_by_projection",
                "project_landmarks", "match_select", "frame_match_select",
                "assemble_observations", "noise_alpha", "frame_normals",
                "associate_planes", "finish_step", "refine_relative",
                "ba_plane_blocks", "ba_cost_test", "ba_reduced_system",
                "step_prelude", "decode_step_inputs", "lift_state",
                "seed_manhattan", "ba_schur_complement", "pose_graph_update",
                "triangulate_lines", "pcg_prepare", "pcg_schur_matvec",
                "pcg_cg_update", "pnp_select", "match_lines",
                "two_view_hypotheses", "two_view_select", "triangulate_dlt")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "planarslam_tpu_torch")
CUDA_SOURCES = ("fast_score.cu", "orb_describe.cu", "hamming_top2.cu",
                "triangulate.cu", "horn_align.cu", "pnp_dlt.cu",
                "ba_normal_eqs.cu", "ba_schur.cu", "pose_graph.cu",
                "pose_opt.cu", "plane_segment.cu", "manhattan.cu",
                "pyramid.cu", "select_keypoints.cu", "lines.cu",
                "line_lift_search.cu", "matching.cu", "depth_normals.cu",
                "step_tail.cu", "refine_relative.cu", "ba_step.cu",
                "step_prelude.cu", "step_decode.cu", "ba_complement.cu",
                "line_triangulate.cu", "ba_pcg.cu", "two_view.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# Sources whose float32 gates must round as the plain version's separate
# PyTorch ops do: no contraction of a product and a sum into one FMA.
SOURCE_FLAGS = {"plane_segment.cu": ("-fmad=false",),
                "manhattan.cu": ("-fmad=false",),
                "pyramid.cu": ("-fmad=false",),
                "select_keypoints.cu": ("-fmad=false",),
                "lines.cu": ("-fmad=false",),
                "line_lift_search.cu": ("-fmad=false",),
                "matching.cu": ("-fmad=false",),
                "depth_normals.cu": ("-fmad=false",),
                "step_tail.cu": ("-fmad=false",),
                "ba_step.cu": ("-fmad=false",),
                "step_prelude.cu": ("-fmad=false",),
                "step_decode.cu": ("-fmad=false",),
                "pose_graph.cu": ("-fmad=false",),
                "line_triangulate.cu": ("-fmad=false",),
                "ba_pcg.cu": ("-fmad=false",),
                "two_view.cu": ("-fmad=false",)}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_triton_mod = None
BUILD_SECONDS: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    # img, out, h, w, stream
    "psl_fast_score": [_P, _P, _I, _I, _P],
    # a_desc, b_desc, M, N, batch, a_ok, b_ok, gated, a_uv, a_r, a_level,
    # a_ur_pred, b_uv, b_level, b_ur, level_window, best, second,
    # best_idx, stream
    "psl_gated_hamming_top2": [_P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _P,
                               _P, _P, _P, _P, _I, _P, _P, _P, _P],
    # a_desc, b_desc, M, N, batch, a_ok, b_ok, best, second, best_idx,
    # back_idx, stream
    "psl_mutual_hamming_top2": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                _P],
    # own_uv, own_level, uv2, level2, has, own_T, nb_T, nb, k, fx, fy, cx,
    # cy, scale_factor, X, good, stream
    "psl_triangulate_two_view": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                                 _F, _F, _F, _P, _P, _P],
    # src, dst, valid, weights, h, n, threshold, R, t, n_inl, inl, stream
    "psl_horn_align_batch": [_P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P],
    # src, dst, valid, triplets, n, h, batch, threshold, with_scale, R, t,
    # s, n_inl, inl, stream
    "psl_horn_triplets": [_P] * 4 + [_I] * 3 + [_F, _I] + [_P] * 6,
    # src, dst, valid, n_inl, inl (the triplet launch's), n, h, batch,
    # threshold, with_scale, out (packed rows), stream
    "psl_horn_refit": [_P] * 5 + [_I] * 3 + [_F, _I] + [_P] * 2,
    # xw, uv_n, inv_sigma2, valid, picks, n, n_hyp, batch, chi2_gate,
    # scores, T, stream
    "psl_pnp_dlt_hypotheses": [_P] * 5 + [_I] * 3 + [_F] + [_P] * 3,
    # xw, uv_n, inv_sigma2, valid, scores, Ts, n, n_hyp, batch, chi2_gate,
    # out (packed rows), stream
    "psl_pnp_select": [_P] * 6 + [_I] * 3 + [_F] + [_P] * 2,
    # uv1, uv2, valid, sigma2, picks, n, n_hyp, batch, sf, sh, Fs, Hs,
    # stream
    "psl_two_view_hypotheses": [_P] * 5 + [_I] * 3 + [_P] * 5,
    # uv1, uv2, valid, sigma2, sf, sh, Fs, Hs, n, n_hyp, batch, out (packed
    # rows), stream
    "psl_two_view_select": [_P] * 8 + [_I] * 3 + [_P] * 2,
    # P1, P2, uv1, uv2, n, batch, X, ok, stream
    "psl_triangulate_dlt": [_P] * 4 + [_I] * 2 + [_P] * 3,
    # X, T1, T2, uv1, uv2, inv_sigma2_1, inv_sigma2_2 (or NULL), s1, s2, n,
    # batch, fx, fy, cx, cy, gate, mask, stream
    "psl_reprojection_checks": [_P] * 7 + [_F] * 2 + [_I] * 2 + [_F] * 5
                               + [_P] * 2,
    # desc_a, desc_b, valid_a, valid_b, angle_a, angle_b, A, B, D, batch,
    # max_angle, ratio, min_sim, sim_floor, quality_bar, idx, best, stream
    "psl_match_lines": [_P] * 6 + [_I] * 4 + [_F] * 5 + [_P] * 3,
    # poses, pts, pt_slot, pt_uv, pt_ur, pt_inv_s2, pt_mask, ln_slot,
    # ln_line2d, ln_inv_s2, ln_mask, Kt, F, L2, M, fx, fy, cx, cy, bf,
    # huber, lm_order, lm_start, kf_order, kf_start, kf_slot, scratch, Hcc,
    # bc, Hpp, bp, Hcp (or NULL), chi_pt, chi_ln, stream
    "psl_ba_normal_eqs": [_P] * 11 + [_I] * 4 + [_F] * 5 + [_I]
                         + [_P] * 14,
    # Hpp, bp, Hcp, bc, lam, mu_p, Kt, M, Hpp_inv, HcpHinv, rhs, partial,
    # stream
    "psl_ba_schur_eliminate": [_P] * 6 + [_I, _I] + [_P] * 5,
    # Hpp_inv, bp, Hcp, dxc, Kt, M, ks, partial, dxp, stream
    "psl_ba_schur_backsub": [_P] * 4 + [_I] * 3 + [_P] * 3,
    # poses, edges_ij, meas_inv, w, E, N, order, seg_start, seg_key, S,
    # fixed_mask (or NULL), scratch, H, g, stream
    "psl_pose_graph_normal_eqs": [_P] * 4 + [_I, _I] + [_P] * 3 + [_I]
                                 + [_P] * 5,
    # poses, step, n (poses of the whole batch), poses_out, stream
    "psl_pose_graph_update": [_P, _P, _I, _P, _P],
    # HcpHinv, Hcp, pair_plan bits and counts, batch, Kt, M, words per
    # row, S, stream
    "psl_ba_schur_complement": [_P] * 4 + [_I] * 4 + [_P] * 2,
    # T_init; points xw, uv, u_right, inv_sigma2, valid, N; lines xw_s,
    # xw_e, line2d, inv_sigma2, valid, L; planes, parallel and vertical
    # planes pi_w, pi_obs, valid, P; rotation flag (device) or NULL and the
    # host flag; fx, fy, cx, cy, bf; the six PoseOptWeights; n_rounds,
    # n_iters, batch; scratch (psl_pose_optimize_scratch_bytes per problem,
    # or NULL); T_out, the five inlier masks, n_in, chi2; stream
    "psl_pose_optimize": [_P] * 6 + [_I] + [_P] * 5 + [_I]
                         + ([_P] * 3 + [_I]) * 3 + [_P, _I] + [_F] * 11
                         + [_I] * 3 + [_P] * 10,
    # s1, s2, n, hb, wb, P, merge_rounds, full_count, mse_sigma, mse_tol,
    # angle_cos, dist_thr, min_support, assoc_angle, assoc_dist2, batch,
    # fit_b, normal_c, d_c, cand_valid, labels, block_valid, stream
    "psl_plane_components": [_P] * 3 + [_I] * 4 + [_F] * 8 + [_I]
                            + [_P] * 7,
    # depth, alpha, h, w, rs, fx, fy, cx, cy, geo_tol, max_distance,
    # dist_thr, jump_coef, P, normal, d, valid, mse, mean, n_p (the last
    # three NULL in round 1), pix_per_block, batch, partial, flags,
    # label_sub, normal_f, d_f, mse_f, mean_f, n_f, alive, launches (the
    # int the entry sets to the launches it made), stream
    "psl_plane_assign_refit": [_P, _P] + [_I] * 3 + [_F] * 8 + [_I]
                              + [_P] * 6 + [_I, _I] + [_P] * 11,
    # depth, alpha, h, w, fx, fy, cx, cy, geo_tol, max_distance, dist_thr,
    # jump_coef, P, normal, d, valid, mse, mean, n_p, min_size, batch,
    # label_in (or NULL), coeffs, valid_out, count, pixel_label, stream
    "psl_plane_label_pixels": [_P, _P] + [_I] * 2 + [_F] * 8 + [_I]
                              + [_P] * 6 + [_I, _I] + [_P] * 6,
    # R_init, normals, valid, N, batch, cos_half, kernel, min_support,
    # iters, ms_iters, R_out, support, n_axes, success, the epilogue's
    # T_pred, R_wm, enabled, T_init, use_manh (all NULL without it), stream
    "psl_manhattan_mean_shift": [_P] * 3 + [_I, _I, _F, _F] + [_I] * 3
                                + [_P] * 10,
    # T_override, use_override, T_cw, velocity, p3d_s, p3d_e, has_3d,
    # ln_valid, L, normals, normals_valid, Nn, R_wm, batch, T_last, T_pred,
    # dirs, dirs_valid, R_init, stream
    "psl_step_prelude": [_P] * 8 + [_I, _P, _P, _I, _P, _I] + [_P] * 6,
    # gray (or NULL), gray_stride, depth (or NULL), depth_hi (or NULL),
    # depth_stride, depth_kind, hw, batch, scale, gray_out, depth_out (or
    # NULL), win, win_stride, win_lanes (1 or batch), off_pt, n_pt, off_ln,
    # n_ln, off_pl, off_cn, n_pl, pt_valid, ln_valid, pl_valid, pl_cloud_n,
    # stream
    "psl_decode_step_inputs": [_P, _L, _P, _P, _L] + [_I] * 3 + [_F]
                              + [_P] * 3 + [_L] + [_I] * 8 + [_P] * 5,
    # pt_uv, pt_depth, pt_valid, T_cw, K, batch, cx, cy, inv_fx, inv_fy,
    # pt3d_w, valid3d, stream
    "psl_lift_state": [_P] * 4 + [_I] * 2 + [_F] * 4 + [_P] * 3,
    # coeffs, count, pl_valid, P, p3d_s, p3d_e, has_3d, ln_valid, response,
    # L, normals, normals_valid, Nn, batch, R_seed, seed_ok, picks, dirs,
    # dirs_valid, stream
    "psl_seed_manhattan": [_P] * 3 + [_I] + [_P] * 5 + [_I] + [_P] * 2
                          + [_I] * 2 + [_P] * 6,
    # The all-levels entry points take the host's level table (`rows`, the
    # int32 array of ops/levels.py) and a leading batch count.
    # buf, out, rows, n_levels, batch, stream
    "psl_fast_score_levels": [_P, _P, _P, _I, _I, _P],
    # buf, blur, rows, n_levels, batch, uv, valid, capacity, pattern, angle,
    # desc, stream
    "psl_orb_describe_levels": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                                _P],
    # gray, gray_stride, buf, rows, n_levels, batch, chunks, chunk_words,
    # header_words, cone_rows, cone_cols, level0 (host), buf_floats,
    # mid_floats, launches, stream
    "psl_pyramid_build": [_P, _L, _P, _P, _I, _I, _P] + [_I] * 4
                         + [_P, _I, _I, _P, _P],
    # src, dst, rows, n_levels, batch, ksize, the 7 taps, stream
    "psl_gaussian_blur": [_P, _P, _P, _I, _I, _I] + [_F] * 7 + [_P],
    # score, rows, n_levels, batch, min_score, border, cand_val, cand_xy,
    # uv, response, valid, launches (the int the entry sets to the launches
    # it made), stream
    "psl_select_keypoints": [_P, _P, _I, _I, _F, _I] + [_P] * 7,
    # uv_level, resp, valid_in, depth, h, w, rows, scale, n_levels, batch,
    # capacity, fx, fy, cx, cy, bf, k1, k2, p1, p2, k3, has_distortion, uv,
    # uv_raw, response, level, depth_out, u_right, valid, stream
    "psl_point_epilogue": [_P] * 4 + [_I, _I, _P, _P] + [_I] * 3 + [_F] * 10
                          + [_I] + [_P] * 8,
    # blur, h, w, batch, E, L, n_rho, keep_top, grad_threshold, min_length,
    # diag, scratch, gx, gy, uv_s, uv_e, line2d, angle, response, valid,
    # stream
    "psl_detect_lines": [_P] + [_I] * 7 + [_F, _F, _D] + [_P] * 10,
    # score, h, w, batch, E, scratch, top_pix, top_val, stream: K20's
    # selection stage alone (its tests)
    "psl_lines_select": [_P] + [_I] * 4 + [_P] * 4,
    # gx, gy, h, w, u_max, v_max, uv_s, uv_e, valid, batch, L, alphas,
    # n_samples, band_width, desc, stream
    "psl_line_descriptors": [_P, _P, _I, _I, _F, _F, _P, _P, _P, _I, _I, _P,
                             _I, _F, _P, _P],
    # depth, h, w, uv_s, uv_e, valid, batch, L, alphas, S, hyp, iters, fx,
    # fy, cx, cy, c1, c2, c3, min_inliers, p3d_s, p3d_e, has_3d, stream
    "psl_lift_lines_3d": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _I]
                         + [_F] * 7 + [_I] + [_P] * 4,
    # sw, ew, desc_m, valid_m, T_cw, M, f_uv_s, f_uv_e, f_angle, f_desc,
    # f_valid, L, D, batch, fx, fy, cx, cy, W, H, radius, max_angle,
    # min_sim, sim_floor, quality_bar, scratch, idx, sim, launches (the
    # int the entry sets to the launches it made), stream
    "psl_search_lines": [_P] * 5 + [_I] + [_P] * 5 + [_I] * 3 + [_F] * 11
                        + [_P] * 5,
    # pts, valid, T_cw, normals, dmin, dmax (the last three or NULL), M,
    # batch, fx, fy, cx, cy, W, H, bf, scale_factor, radius, a_uv, a_r,
    # a_level, a_ur_pred, gate, stream
    "psl_project_landmarks": [_P] * 6 + [_I, _I] + [_F] * 9 + [_P] * 6,
    # best, second, best_idx, back (or NULL), M, N, batch, max_dist,
    # use_ratio, ratio, resolve, idx, dist, stream
    "psl_match_select": [_P] * 4 + [_I] * 5 + [_F, _I] + [_P] * 3,
    # proj_idx, bf_idx (or NULL), valid_in (filter mode, or NULL),
    # angle_src, angle_tgt, M, N, batch, uv_tgt, ur_tgt, level_tgt,
    # inv_s2_table, n_levels, two_pi, ff_idx, obs_uv, obs_ur, obs_inv_s2,
    # obs_valid, keep (the outputs of the other mode NULL), stream
    "psl_frame_match_select": [_P] * 5 + [_I] * 3 + [_P] * 4 + [_I, _F]
                              + [_P] * 7,
    # win_idx, n_win, win_a, win_b (lines, or NULL), ff_idx (points, or
    # NULL), M, src_xw, tgt_valid, tgt_ur, tgt_level, inv_s2_table,
    # n_levels, N, batch, slot, out_a, out_b, out_ur, out_inv_s2, out_valid
    # (what a mode does not write NULL), stream
    "psl_assemble_observations": [_P, _I] + [_P] * 3 + [_I] + [_P] * 5
                                 + [_I] * 3 + [_P] * 7,
    # depth, h, w, batch, max_distance, inv_mad, alpha, stream
    "psl_noise_alpha": [_P, _I, _I, _I, _F, _F, _P, _P],
    # depth, h, w, batch, stride, budget, smooth_window, inv_fx, inv_fy, cx,
    # cy, normals, valid, stream
    "psl_frame_normals": [_P] + [_I] * 6 + [_F] * 4 + [_P] * 3,
    # coeffs, valid, T_cw, pl_coeffs, pl_cloud, pl_cloud_n, pl_valid, P,
    # Mp, C, batch, assoc_angle, assoc_dist, par_thr, ver_thr, direct, par,
    # ver, pi_w, obs_pi_w, obs_valid, stream
    "psl_associate_planes": [_P] * 7 + [_I] * 4 + [_F] * 4 + [_P] * 7,
    # the 28 inputs of TailInputs' order, K, L, P, Wp, Wl, batch,
    # min_inliers, fx, fy, cx, cy, inv_fx, inv_fy, width, height,
    # depth_threshold, the bundle's offset table (host), its total, bundle,
    # T_out, velocity, pt3d_w, valid3d, stream
    "psl_finish_step": [_P] * 28 + [_I] * 7 + [_F] * 9 + [_P, _I]
                       + [_P] * 6,
    # T_init, s_init, pts1, pts2, uv1, uv2, valid, batch, N, fx, fy, cx,
    # cy, fix_scale, n_iters, huber, T_out, s_out, stream
    "psl_refine_relative": [_P] * 7 + [_I] * 2 + [_F] * 4 + [_I] * 2
                           + [_F] + [_P] * 3,
    # poses, base, theta, batch, Kt, Q, P, M, per plane table (slot,
    # pi_obs, mask, Pp, records), the four informations, the two gates,
    # huber, Hcc, bc, Hpp, bp, Hcp (or NULL), stream
    "psl_ba_plane_blocks": [_P] * 3 + [_I] * 5 + ([_P] * 3 + [_I, _P]) * 3
                           + [_F] * 6 + [_I] + [_P] * 6,
    # Hpp, batch, M, mu_p, stream
    "psl_ba_mu_p": [_P, _I, _I, _P, _P],
    # poses, lm, base, batch, Kt, P, Q, M, the point table (slot, uv, ur,
    # inv_s2, mask), F, the line table (slot, line2d, inv_s2, mask), L2, per plane
    # table (slot, pi_obs, mask, Pp), fx, fy, cx, cy, bf, the four
    # informations, the two gates, huber; step mode dxc, dxp, lam,
    # poses_out, lm_out, lam_out, accept, decrease, scratch; tables mode the
    # five chi2 tables (what a mode does not use NULL), stream
    "psl_ba_cost_test": [_P] * 3 + [_I] * 5 + [_P] * 5 + [_I] + [_P] * 4
                        + [_I] + ([_P] * 3 + [_I]) * 3 + [_F] * 11 + [_I]
                        + [_P] * 15,
    # S, Hcc, rhs, lam, fixed_mask, batch, Kt, S_out, rhs_vec, stream
    "psl_ba_reduced_system": [_P] * 5 + [_I] * 2 + [_P] * 3,
    # own_T, own_uvs, own_uve, own_l2d, own_desc, own_free, nb_T, nb_l2d,
    # nb_desc, nb_free, nb_ok, batch, NB, L, D, fx, fy, cx, cy, 1 / fx,
    # 1 / fy, -cx / fx, -cy / fy, idx, Xs, Xe, good, stream
    "psl_triangulate_lines": [_P] * 11 + [_I] * 4 + [_F] * 8 + [_P] * 5,
    # Hcc, bc, Hpp, bp, lam, mu_p, free, cross, its row and lane strides,
    # n_ptln, per plane table (records, D, Pp), obs_slot, kf_order,
    # kf_start, batch, Kt, M, n_obs, Hpp_inv, Hcc_d, Minv, rhs, C, stream
    "psl_pcg_prepare": [_P] * 8 + [_L, _L, _I] + [_P, _I, _I] * 3
                       + [_P] * 3 + [_I] * 4 + [_P] * 6,
    # C, Hpp_inv, Hcc_d, free, obs_kf, obs_slot, lm_order, lm_start,
    # kf_order, kf_start, batch, Kt, M, n_obs, x (p or dxc), bp (or NULL),
    # v (the landmark pass's scratch, or dxp), Ap (or NULL), launches (the
    # int the entry sets to the launches it made), stream
    "psl_pcg_schur_matvec": [_P] * 10 + [_I] * 4 + [_P] * 6,
    # Minv, free, batch, Kt, x, r, p, Ap (NULL: the init mode), scal,
    # x_out, r_out, p_out, scal_out, stream
    "psl_pcg_cg_update": [_P] * 2 + [_I] * 2 + [_P] * 10,
}
# Host-side helpers: plain C functions that launch nothing.
_HELPERS = {
    # n_items
    "psl_pose_optimize_scratch_bytes": [_I],
    # h, w, batch, E, L, n_rho
    "psl_detect_lines_scratch_words": [_I] * 6,
    # M, L, batch
    "psl_search_lines_scratch_words": [_I] * 3,
    # h, w, batch, E
    "psl_lines_select_scratch_words": [_I] * 4,
    # (none): K13's flag words a stream keeps
    "psl_plane_assign_flag_words": [],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "planarslam_tpu_torch cannot be built")
    return found


def library_path() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return os.path.join(BUILD_DIR, f"libpsl_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the shared library (once per source hash):
    one nvcc per source, all started together, then one link."""
    global BUILD_SECONDS
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in CUDA_SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), "-I", CSRC,
               "-c", "-o", obj]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd.append(os.path.join(CSRC, src))
        objs.append(obj)
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
    failed = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(err, flush=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = f"{path}.{tag}"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, path)
    BUILD_SECONDS = time.perf_counter() - t0
    return path


def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            for fn, argtypes in _HELPERS.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_longlong
            lib.psl_error_string.argtypes = [_I]
            lib.psl_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def triton_module():
    """csrc/plane_moments_triton.py, imported from its file at first launch."""
    global _triton_mod
    with _lock:
        if _triton_mod is None:
            path = os.path.join(CSRC, "plane_moments_triton.py")
            spec = importlib.util.spec_from_file_location(
                "planarslam_tpu_torch_plane_moments_triton", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _triton_mod = mod
        return _triton_mod


def launch(fn: str, *args) -> None:
    """Call a C entry point on PyTorch's current stream; raise on a launch
    error (cudaGetLastError after the launch)."""
    lib = cuda_lib()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.psl_error_string(rc).decode()}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device (the kernel runs). Anything else
    raises: a CUDA tensor is never sent to the plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    devices = {t.device for t in tensors}
    if kinds != {"cuda"} or len(devices) != 1:
        raise ValueError(f"kernel inputs must all be CPU tensors or all lie "
                         f"on one CUDA device, got {sorted(map(str, devices))}")
    return False


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel argument: dtype, contiguity and (optional) shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def scalar_reciprocal(x: float) -> float:
    """The factor PyTorch multiplies a CUDA float32 tensor with when it
    divides it by the Python number x: 1 / x in double precision, rounded
    to float32. A kernel that repeats such a division takes it as an
    argument."""
    return float(np.float32(1.0 / x))


def per_problem(fn, tensors, *args, **kw):
    """fn over each problem of the tensors' leading batch dimension (a None
    stays None), the outputs stacked: the batched wrappers' CPU path."""
    outs = [fn(*[None if t is None else t[b] for t in tensors], *args, **kw)
            for b in range(tensors[0].shape[0])]
    fields = [torch.stack(f) for f in zip(*outs)]
    return type(outs[0])(*fields) if hasattr(outs[0], "_fields") \
        else tuple(fields)


def upload(arrays, device) -> list:
    """numpy arrays on `device` in one host-to-device copy: packed into
    one byte buffer (each at a 16-byte boundary; page-locked for a card,
    so the copy needs no staging copy) and returned as views of their
    dtypes and shapes."""
    offsets, size = [], 0
    for a in arrays:
        offsets.append(size)
        size += (a.nbytes + 15) // 16 * 16
    pinned = torch.device(device).type == "cuda"
    host = torch.zeros(max(size, 1), dtype=torch.uint8, pin_memory=pinned)
    buf = host.numpy()
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = host.to(device, non_blocking=pinned)
    return [dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
            for a, o in zip(arrays, offsets)]


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}
_NUMPY_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def pull(*views) -> list:
    """numpy copies of contiguous tensors on the card that share one
    storage (a wrapper's packed outputs), in one device-to-host copy of
    that storage; tensors on the CPU as numpy views of themselves."""
    if not views[0].is_cuda:
        return [v.numpy() for v in views]
    storage = views[0].untyped_storage()
    start = storage.data_ptr()
    if any(v.untyped_storage().data_ptr() != start for v in views):
        raise ValueError("pull: the tensors do not share one storage")
    whole = torch.empty(0, dtype=torch.uint8, device=views[0].device)
    host = whole.set_(storage).cpu().numpy()
    out = []
    for v in views:
        o = v.data_ptr() - start
        out.append(host[o:o + v.nbytes].view(_NUMPY_DTYPES[v.dtype])
                   .reshape(v.shape))
    return out


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def host_ptr(a) -> int:
    """Address of a C-contiguous numpy array the caller keeps alive (the
    level table): the C entry point reads it before it returns."""
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("expected a C-contiguous array")
    return a.ctypes.data
