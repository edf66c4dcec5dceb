"""The closest quad hit of each ray: TPU kernel O.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_quad.py`` (``quad_search``,
``pallas_quad.py:90``) and of its XLA twin ``_quad_quants`` /
``_quad_candidates`` (``rust_ray_tracer_tpu/ops/intersect.py:216-246``):
:func:`quad_search` runs :func:`_quad_candidates` (the plain version) for
CPU tensors and ``quad_search_kernel`` (``csrc/split.cu``) for CUDA
tensors. Both find the same winner: both sides of a parallelogram hit,
[0, 1]^2 inclusive, the lowest index wins a tie in t; the kernel's
per-cluster cull is conservative. :func:`quad_sweep_replay` replays the
kernel's sweep (live rays packed, a warp's vote on each cluster, the
staged test) in torch, and counts its tests by stage.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.shade_core import (_cross, _dot, _safe_div,
                                                      _xyz)

RAY_BLOCK = 2048        # rays per block of the plain [rays, quads] sweep
QUAD_ROW = 16           # floats a row of kernel O's table (quad_table)
QCL = 128               # quads a cull cluster (models/scene CLUSTER)
QBLOCK = 128            # rays a block of kernel O, its live rays packed
WARP = 32
CULL_EPS = 1e-3         # the cull boxes' margin


def _quad_quants(o, d, q, u_e, v_e):
    """Plane hit and parallelogram coordinates (``intersect.py:216``) of
    component triples that broadcast: (t, alpha, beta, n, denom, p)."""
    n = _cross(u_e, v_e)
    denom = _dot(*d, *n)
    t = _safe_div(_dot(*(a - b for a, b in zip(q, o)), *n), denom)
    p = tuple(a + t * b for a, b in zip(o, d))
    w = tuple(a - b for a, b in zip(p, q))
    inv_n2 = _safe_div(torch.ones_like(n[0]), _dot(*n, *n))
    alpha = _dot(*_cross(w, v_e), *n) * inv_n2
    beta = _dot(*_cross(u_e, w), *n) * inv_n2
    return t, alpha, beta, n, denom, p


def _quad_block(scene, o, d, t_min, t_max):
    oc = tuple(x[:, None] for x in _xyz(o))
    dc = tuple(x[:, None] for x in _xyz(d))
    t, alpha, beta, _, denom, _ = _quad_quants(
        oc, dc, _xyz(scene.quad_q[None]), _xyz(scene.quad_u[None]),
        _xyz(scene.quad_v[None]))
    valid = ((denom.abs() > 0.0) & (t >= t_min[:, None])
             & (t <= t_max[:, None]) & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    return torch.min(torch.where(valid, t, torch.full_like(t, torch.inf)),
                     dim=-1)


def _quad_candidates(scene, o, d, t_min, t_max):
    """[C] best (t float32, index int64) over the quads: the plain version
    of TPU kernel O (``intersect.py:229-246``): both sides hit, inclusive
    [0, 1]^2, the lowest index wins a tie, nothing found gives (inf, 0).
    Swept in blocks of :data:`RAY_BLOCK` rays, so its [rays, quads]
    intermediates stay bounded."""
    outs = [_quad_block(scene, o[i:i + RAY_BLOCK], d[i:i + RAY_BLOCK],
                        t_min[i:i + RAY_BLOCK], t_max[i:i + RAY_BLOCK])
            for i in range(0, o.shape[0], RAY_BLOCK)]
    return (torch.cat([t for t, _ in outs]), torch.cat([i for _, i in outs]))


def quad_table(scene):
    """[Q, 16] rows of the scene's quads, kernel O's table: q, u, v, the
    normal n = u x v, 1 / |n|^2 and three zeros. n and 1 / |n|^2 are
    :func:`_quad_quants`' operations (torch elementwise, never fused), so
    the kernel reads the plain version's bits."""
    q, u, v = scene.quad_q, scene.quad_u, scene.quad_v
    n = _cross(_xyz(u), _xyz(v))
    inv_n2 = _safe_div(torch.ones_like(n[0]), _dot(*n, *n))
    return torch.cat([q, u, v, torch.stack(n, dim=1), inv_n2[:, None],
                      torch.zeros_like(q)], dim=1).contiguous()


def _table_quants(oc, dc, tab):
    """(t, alpha, beta, denom) of rays ``oc``, ``dc`` (component triples
    [R, 1]) against the rows of :func:`quad_table` ``tab``, in kernel O's
    operations: n and 1 / |n|^2 read from the row."""
    q, u, v, n = (tuple(tab[None, :, 3 * j + a] for a in range(3))
                  for j in range(4))
    inv_n2 = tab[None, :, 12]
    denom = _dot(*dc, *n)
    t = _safe_div(_dot(*(a - b for a, b in zip(q, oc)), *n), denom)
    p = tuple(a + t * b for a, b in zip(oc, dc))
    w = tuple(a - b for a, b in zip(p, q))
    alpha = _dot(*_cross(w, v), *n) * inv_n2
    beta = _dot(*_cross(u, w), *n) * inv_n2
    return t, alpha, beta, denom


def enters_boxes(rays, cl_min, cl_max):
    """[N, K] bool: live ray i of ``rays`` [N, 8] (o, d, tmin, tmax)
    enters box k of ``cl_min`` / ``cl_max`` [K, 3], widened by
    :data:`CULL_EPS`, within [tmin, tmax]: kernel O's ``enters_box``
    (``pallas_intersect._tile_cluster_mask`` for one ray; an axis with
    |d| < 1e-12 asks for the origin inside the slab, an inverted box never
    passes)."""
    o, d, tmin, tmax = rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7]
    n, k = rays.shape[0], cl_min.shape[0]
    enter = torch.full((n, k), -torch.inf, dtype=rays.dtype,
                       device=rays.device)
    exit_ = torch.full_like(enter, torch.inf)
    ok = (tmax > tmin)[:, None] & (cl_min <= cl_max).all(1)[None]
    for a in range(3):
        small = (d[:, a].abs() < 1e-12)[:, None]
        inv = (1.0 / d[:, a])[:, None]
        lo = (cl_min[:, a] - CULL_EPS)[None]
        hi = (cl_max[:, a] + CULL_EPS)[None]
        oa = o[:, a, None]
        t0, t1 = (lo - oa) * inv, (hi - oa) * inv
        enter = torch.where(small, enter,
                            torch.maximum(enter, torch.minimum(t0, t1)))
        exit_ = torch.where(small, exit_,
                            torch.minimum(exit_, torch.maximum(t0, t1)))
        ok = ok & (~small | ((oa >= lo) & (oa <= hi)))
    return (ok & (enter <= exit_) & (exit_ >= tmin[:, None])
            & (enter <= tmax[:, None]))


def quad_sweep_replay(rays, table, cl_min, cl_max):
    """Kernel O's sweep as torch ops, on any device: a block of
    :data:`QBLOCK` rays packs its live rays in ray order and sorts them by
    the clusters each enters (bit c % 32 of a mask, then the packed
    order), 32 to a warp; a warp sweeps, in ascending order, every cluster
    one of its rays enters (``__any_sync`` of :func:`enters_boxes`), each
    of its rays testing every quad there with ``quad_table``'s rows: t
    first, alpha and beta only where t can win (|denom| > 0, t in [tmin,
    tmax], t below the ray's best so far). Returns (best t [N], inf for none; best index [N]
    int64, 0 for none; the work: live rays, warps that sweep, the (warp,
    cluster) pairs swept, ``tests`` (a live ray's tests, the t stage),
    ``ab_tests`` (those where t could win), and ``ray_tests`` /
    ``ray_ab_tests`` the same with each ray alone testing the clusters
    it enters, what the data needs)."""
    n, dev = rays.shape[0], rays.device
    live = rays[:, 7] > rays[:, 6]
    enter = enters_boxes(rays, cl_min, cl_max) & live[:, None]
    # the packed slot of each live ray in its block; the block's live rays
    # in the order of (cluster mask, slot) and 32 to a warp
    blk = torch.arange(n, device=dev) // QBLOCK
    cum = torch.cumsum(live.long(), 0)
    prior = torch.where(blk > 0, cum[(blk * QBLOCK - 1).clamp(min=0)], 0)
    slot = cum - 1 - prior
    mask = torch.zeros(n, dtype=torch.long, device=dev)
    for c in range(enter.shape[1]):
        mask = mask | (enter[:, c].long() << (c % 32))
    order = torch.argsort((blk << 41) | (mask << 8) | slot.clamp(min=0))
    ranked = torch.empty_like(order)
    ranked[order] = torch.arange(n, device=dev)
    # a live ray's place in its block's sorted list: dead rays sort among
    # them by slot, so count the live rays before it in the block instead
    live_sorted = live[order]
    rank = torch.cumsum(live_sorted.long(), 0)[ranked] - 1 - prior
    warp = blk * (QBLOCK // WARP) + rank // WARP
    n_warps = -(-n // QBLOCK) * (QBLOCK // WARP)
    votes = torch.zeros((n_warps, enter.shape[1]), dtype=torch.long,
                        device=dev).index_add_(0, warp[live],
                                               enter[live].long()) > 0
    swept = votes[warp.clamp(min=0)] & live[:, None]
    cluster = torch.arange(table.shape[0], device=dev) // QCL
    best_t = torch.full((n,), torch.inf, dtype=rays.dtype, device=dev)
    best_i = torch.zeros((n,), dtype=torch.long, device=dev)
    work = {"live_rays": int(live.sum()),
            "warps": int(votes.any(1).sum()),
            "warp_clusters": int(votes.sum()),
            "tests": 0, "ab_tests": 0, "ray_tests": 0, "ray_ab_tests": 0}
    for i in range(0, n, RAY_BLOCK):
        r = rays[i:i + RAY_BLOCK]
        t, alpha, beta, denom = _table_quants(
            tuple(r[:, a, None] for a in range(3)),
            tuple(r[:, 3 + a, None] for a in range(3)), table)
        tested = swept[i:i + RAY_BLOCK][:, cluster]
        cand = (tested & (denom.abs() > 0.0) & (t >= r[:, 6, None])
                & (t <= r[:, 7, None]))
        valid = (cand & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0)
                 & (beta <= 1.0))
        tv = torch.where(valid, t, torch.full_like(t, torch.inf))
        bt = tv.min(dim=1).values
        best_t[i:i + RAY_BLOCK] = bt
        # strict <: the first index of the least t (inf everywhere: 0)
        best_i[i:i + RAY_BLOCK] = (tv == bt[:, None]).int().argmax(dim=1)
        # the ray's best t before each quad, the staged test's bar
        bar = torch.cat([torch.full_like(tv[:, :1], torch.inf),
                         torch.cummin(tv, dim=1).values[:, :-1]], dim=1)
        ab = cand & (t < bar)
        own = enter[i:i + RAY_BLOCK][:, cluster]
        work["tests"] += int(tested.sum())
        work["ab_tests"] += int(ab.sum())
        work["ray_tests"] += int(own.sum())
        work["ray_ab_tests"] += int((ab & own).sum())
    return best_t, best_i, work


def quad_search(scene, o, d, t_min, t_max, table=None):
    """(best t [C] float32, inf for none; best index [C], 0 for none) of
    rays ``o``, ``d`` [C, 3] in [t_min, t_max] [C] over the scene's quads.
    ``table`` is :func:`quad_table` of the scene, made here if None."""
    dev = o.device.type
    if dev == "cpu":
        return _quad_candidates(scene, o, d, t_min, t_max)
    if dev != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    from rust_ray_tracer_tpu_torch.kernels import quad_search_kernel
    rays = torch.cat([o, d, t_min[:, None], t_max[:, None]], dim=1)
    return quad_search_kernel(
        rays.contiguous(), quad_table(scene) if table is None else table,
        scene.quad_cluster_min.contiguous(),
        scene.quad_cluster_max.contiguous())
