"""Keyframe pose-graph optimization (loop-closure correction).

Port of ``planarslam_tpu/solvers/pose_graph.py``: after a loop is found,
keyframe poses relax over relative-pose edges from the spanning tree or
sequential chain, strong covisibility and the loop edges, with the loop
keyframe gauge-fixed; dense Gauss-Newton on the 6N x 6N normal equations.

Kernel K10 ``pose_graph_normal_eqs`` (``csrc/pose_graph.cu``) computes,
for every edge, the residual r = w log(m_inv T_i T_j^-1) and its two 6x6
Jacobians at 0, and assembles the dense H and g. The JAX module takes the
Jacobians from ``jax.jacfwd`` of the residual; here they are analytic,
with A = T_i T_j^-1 and r0 = r / w:

    J_i = w Jr^-1(r0) Ad(A^-1),    J_j = -w Jr^-1(r0)

(first order of log(E exp(d)) = r0 + Jr^-1(r0) d, since exp(xi_i) A =
A exp(Ad(A^-1) xi_i)). Both the kernel and the plain version compute the
edge terms in float64. The assembly adds each (node, node) block over its
edges in a fixed order from a host-built plan (``edge_plan``), so runs are
identical; a repeated (i, j) pair adds, as the JAX scatter-add does. K10
writes every entry of H and g and adds the gauge diagonal
repeat(fixed_mask, 6) 1e8 + 1e-6 to H's float32 diagonal, as JAX adds
diag_fix.

Kernel K41 ``pose_graph_update`` (``csrc/pose_graph.cu``) applies the
step: poses_new = se3_exp(-step) poses for every keyframe in one launch,
step = solve(H, g) (JAX: dx = -solve, vmap(se3_exp)(dx) @ poses). A
Gauss-Newton step is then K10, ``torch.linalg.solve_ex`` (the dense LU
solve stays a library call, as ``jnp.linalg.solve`` is XLA's) and K41.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.geometry import se3


class EdgePlan(NamedTuple):
    """The assembly order of K10, fixed for one solve. Every edge e gives
    four block terms, c = 4 e + kind: (i, i), (j, j), (i, j), (j, i).
    `order` lists them sorted by block (row node * N + column node),
    stably; `seg_start` (S + 1) bounds the S distinct blocks in `order`,
    `seg_key` names each one."""

    order: torch.Tensor      # (4E,) int32
    seg_start: torch.Tensor  # (S + 1,) int32
    seg_key: torch.Tensor    # (S,) int32


def edge_plan(edges_ij: np.ndarray, n: int, device) -> EdgePlan:
    """Build K10's assembly order from the (E, 2) host edge list."""
    e = np.asarray(edges_ij, np.int64).reshape(-1, 2)
    ii, jj = e[:, 0], e[:, 1]
    rows = np.stack([ii, jj, ii, jj], axis=1).reshape(-1)
    cols = np.stack([ii, jj, jj, ii], axis=1).reshape(-1)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    skey = key[order]
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]])
    seg_start = np.r_[starts, len(skey)]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return EdgePlan(put(order), put(seg_start), put(skey[starts]))


def edge_terms(poses: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
               meas_inv: torch.Tensor, w: torch.Tensor):
    """Per-edge residual (E, 6) and Jacobians J_i, J_j (E, 6, 6) at the
    poses, in float64."""
    P = poses.to(torch.float64)
    Ti, Tj = P[ii.long()], P[jj.long()]
    A = Ti @ se3.T_inv(Tj)
    r0 = se3.se3_log(meas_inv.to(torch.float64) @ A)
    wd = w.to(torch.float64)[:, None, None]
    Jr = se3.se3_right_jacobian_inv(r0)
    Ji = wd * (Jr @ se3.adjoint(se3.T_inv(A)))
    return r0 * wd[:, 0], Ji, -wd * Jr


def _gauge_diagonal(fixed_mask: torch.Tensor) -> torch.Tensor:
    """JAX's diag_fix: 1e8 on the six rows of a fixed pose, 1e-6 on every
    row, in float32."""
    return torch.repeat_interleave(fixed_mask, 6) * 1e8 + 1e-6


def pose_graph_normal_eqs_plain(poses, edges_ij, meas_inv, w, plan=None,
                                fixed_mask=None):
    """Plain version of K10. poses (N, 4, 4), edges_ij (E, 2) int32,
    meas_inv (E, 4, 4), w (E,), float32. Returns H (6N, 6N) and g (6N,),
    float32: H = sum_e J^T J over the four blocks of each edge, g = J^T r
    on the diagonal ones (the plan only orders the kernel's sums), both
    summed in float64; with fixed_mask (N,) the gauge diagonal added to the
    float32 H."""
    n = poses.shape[0]
    ii, jj = edges_ij[:, 0].long(), edges_ij[:, 1].long()
    r, Ji, Jj = edge_terms(poses, ii, jj, meas_inv, w)
    blocks = [(ii, ii, Ji, Ji), (jj, jj, Jj, Jj), (ii, jj, Ji, Jj),
              (jj, ii, Jj, Ji)]
    Hb = torch.zeros((n * n, 6, 6), dtype=torch.float64, device=poses.device)
    for a, b, Ja, Jb in blocks:
        Hb.index_put_((a * n + b,), Ja.transpose(1, 2) @ Jb, accumulate=True)
    gb = torch.zeros((n, 6), dtype=torch.float64, device=poses.device)
    for a, J in ((ii, Ji), (jj, Jj)):
        gb.index_put_((a,), (J.transpose(1, 2) @ r[..., None])[..., 0],
                      accumulate=True)
    H = Hb.view(n, n, 6, 6).transpose(1, 2).reshape(6 * n, 6 * n).to(
        torch.float32)
    if fixed_mask is not None:
        H = H + torch.diag(_gauge_diagonal(fixed_mask))
    return H, gb.reshape(-1).to(torch.float32)


def pose_graph_normal_eqs(poses: torch.Tensor, edges_ij: torch.Tensor,
                          meas_inv: torch.Tensor, w: torch.Tensor,
                          plan: EdgePlan, fixed_mask=None):
    """K10 wrapper; the arguments and results of
    ``pose_graph_normal_eqs_plain``. One launch writes every entry of H and
    g."""
    extra = () if fixed_mask is None else (fixed_mask,)
    if kernels.on_cpu(poses, edges_ij, meas_inv, w, *plan, *extra):
        return pose_graph_normal_eqs_plain(poses, edges_ij, meas_inv, w,
                                           fixed_mask=fixed_mask)
    n, e = poses.shape[0], edges_ij.shape[0]
    kernels.check(poses, "poses", torch.float32, (n, 4, 4))
    kernels.check(edges_ij, "edges_ij", torch.int32, (e, 2))
    kernels.check(meas_inv, "meas_inv", torch.float32, (e, 4, 4))
    kernels.check(w, "w", torch.float32, (e,))
    kernels.check(plan.order, "order", torch.int32, (4 * e,))
    n_seg = plan.seg_key.shape[0]
    kernels.check(plan.seg_start, "seg_start", torch.int32, (n_seg + 1,))
    kernels.check(plan.seg_key, "seg_key", torch.int32)
    if fixed_mask is not None:
        kernels.check(fixed_mask, "fixed_mask", torch.float32, (n,))
    dev = poses.device
    H = torch.empty((6 * n, 6 * n), dtype=torch.float32, device=dev)
    g = torch.empty((6 * n,), dtype=torch.float32, device=dev)
    scratch = torch.empty((e, 78), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_pose_graph_normal_eqs", kernels.ptr(poses),
                       kernels.ptr(edges_ij), kernels.ptr(meas_inv),
                       kernels.ptr(w), e, n, kernels.ptr(plan.order),
                       kernels.ptr(plan.seg_start), kernels.ptr(plan.seg_key),
                       n_seg, None if fixed_mask is None
                       else kernels.ptr(fixed_mask), kernels.ptr(scratch),
                       kernels.ptr(H), kernels.ptr(g))
    kernels.LAUNCHES["pose_graph_normal_eqs"] += 1
    return H, g


def pose_graph_update_plain(poses: torch.Tensor, step: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of K41: se3_exp(-step) poses. poses (..., N, 4, 4),
    step (..., N, 6) float32 (the solve's, so -step is JAX's dx)."""
    return se3.se3_exp(-step) @ poses


def pose_graph_update(poses: torch.Tensor, step: torch.Tensor
                      ) -> torch.Tensor:
    """K41 wrapper; the arguments and results of
    ``pose_graph_update_plain``, any leading batch. One launch."""
    if kernels.on_cpu(poses, step):
        return pose_graph_update_plain(poses, step)
    lead = tuple(poses.shape[:-2])
    kernels.check(poses, "poses", torch.float32, lead + (4, 4))
    kernels.check(step, "step", torch.float32, lead + (6,))
    out = torch.empty_like(poses)
    with torch.cuda.device(poses.device):
        kernels.launch("psl_pose_graph_update", kernels.ptr(poses),
                       kernels.ptr(step), int(np.prod(lead)),
                       kernels.ptr(out))
    kernels.LAUNCHES["pose_graph_update"] += 1
    return out


@record_function("pose_graph.optimize")
def _optimize(poses0: torch.Tensor, edges_ij: torch.Tensor,
              edges_meas: torch.Tensor, edge_w: torch.Tensor,
              fixed_mask: torch.Tensor, n_iters: int = 10,
              plan: EdgePlan = None) -> torch.Tensor:
    """poses0: (N, 4, 4) initial T_cw per KF; edges_ij: (E, 2) int32;
    edges_meas: (E, 4, 4) measured T_i T_j^-1; edge_w: (E,) weights;
    fixed_mask: (N,) 1.0 where the pose is gauge-fixed. Runs on the
    tensors' device without a host sync."""
    n = poses0.shape[0]
    if plan is None:
        plan = edge_plan(edges_ij.cpu().numpy(), n, device=poses0.device)
    meas_inv = se3.T_inv(edges_meas).contiguous()
    fixed_mask = fixed_mask.contiguous()
    poses = poses0.contiguous()
    for _ in range(n_iters):
        # K10 (with the gauge diagonal), the dense solve, K41
        H, g = pose_graph_normal_eqs(poses, edges_ij, meas_inv, edge_w, plan,
                                     fixed_mask)
        step = torch.linalg.solve_ex(H, g, check_errors=False)[0]
        poses = pose_graph_update(poses, step.view(n, 6))
    return poses


def optimize_pose_graph(slam_map, kf_corrected: int, T_corrected: np.ndarray,
                        loop_kf: int, cfg: SystemConfig,
                        min_covis_weight: int = 100, device="cuda"
                        ) -> np.ndarray:
    """Build edges from the map (host numpy) and run the GN pose graph on
    `device`. Returns (n_kf_slots, 4, 4) corrected T_cw (rows of invalid
    keyframes unchanged)."""
    device = resolve_device(device)
    m = slam_map
    ids = m.valid_kf_ids()
    if len(ids) < 2:
        return m.kf_pose.copy()
    id_pos = {int(k): i for i, k in enumerate(ids)}
    poses_before = m.kf_pose[ids].astype(np.float32)

    def rel(a, b):
        return (m.kf_pose[a] @ np.linalg.inv(m.kf_pose[b])).astype(np.float32)

    with record_function("pose_graph.build_edges"):
        edges: List[Tuple[int, int, np.ndarray, float]] = []
        # sequential / spanning-tree chain
        for i in range(1, len(ids)):
            a, b = int(ids[i]), int(ids[i - 1])
            p = int(m.kf_parent[a])
            b = p if p in id_pos else b
            edges.append((id_pos[a], id_pos[b], rel(a, b), 1.0))
        # strong covisibility edges
        for a in ids:
            for b in m.covisible_kfs(int(a), min_weight=min_covis_weight):
                if int(b) > int(a) and int(b) in id_pos:
                    edges.append((id_pos[int(a)], id_pos[int(b)],
                                  rel(int(a), int(b)), 1.0))
        # the loop edge: measured relative from the corrected pose
        T_rel_loop = (T_corrected @ np.linalg.inv(m.kf_pose[loop_kf])
                      ).astype(np.float32)
        edges.append((id_pos[kf_corrected], id_pos[loop_kf], T_rel_loop,
                      5.0))
        # loop edges persisted by earlier corrections; an endpoint culled
        # since chains the stored measurement through its cull-time relative
        for e in range(m.n_loop_edges):
            a, b = int(m.loop_edge_ab[e, 0]), int(m.loop_edge_ab[e, 1])
            T_ab = m.loop_edge_T[e]
            if (a, b) == (kf_corrected, loop_kf):
                continue  # the current loop edge, added above
            if not m.kf_valid[a]:
                a, T_rel_a = m.resolve_kf(a)
                T_ab = np.linalg.inv(T_rel_a) @ T_ab
            if not m.kf_valid[b]:
                b, T_rel_b = m.resolve_kf(b)
                T_ab = T_ab @ T_rel_b
            if a < 0 or b < 0 or a == b:
                continue
            edges.append((id_pos[a], id_pos[b], T_ab.astype(np.float32),
                          5.0))

        e_ij = np.asarray([(a, b) for a, b, _, _ in edges], np.int32)
        e_meas = np.asarray([t for _, _, t, _ in edges], np.float32)
        e_w = np.asarray([w for _, _, _, w in edges], np.float32)
        fixed = np.zeros(len(ids), np.float32)
        fixed[id_pos[loop_kf]] = 1.0

        # start from the current estimates, seeding the corrected keyframe
        init = poses_before.copy()
        init[id_pos[kf_corrected]] = T_corrected

    with record_function("pose_graph.edge_plan"):
        plan = edge_plan(e_ij, len(ids), device=device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with record_function("pose_graph.upload"):
        args = [put(a) for a in (init, e_ij, e_meas, e_w, fixed)]
    with record_function("pose_graph.gn_steps"):
        out = _optimize(*args, plan=plan)
    with record_function("pose_graph.pull"):
        result = m.kf_pose.copy()
        result[ids] = out.cpu().numpy()
    return result
