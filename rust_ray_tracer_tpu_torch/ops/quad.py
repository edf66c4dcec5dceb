"""The closest quad hit of each ray: TPU kernel O.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_quad.py`` (``quad_search``,
``pallas_quad.py:90``) and of its XLA twin ``_quad_quants`` /
``_quad_candidates`` (``rust_ray_tracer_tpu/ops/intersect.py:216-246``):
:func:`quad_search` runs :func:`_quad_candidates` (the plain version) for
CPU tensors and ``quad_search_kernel`` (``csrc/split.cu``) for CUDA
tensors. Both find the same winner: both sides of a parallelogram hit,
[0, 1]^2 inclusive, the lowest index wins a tie in t; the kernel's
per-cluster cull is conservative.
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops.shade_core import (_cross, _dot, _safe_div,
                                                      _xyz)

RAY_BLOCK = 2048        # rays per block of the plain [rays, quads] sweep


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
    """[Q, 9] rows q, u, v of the scene's quads, the kernel's table."""
    return torch.cat([scene.quad_q, scene.quad_u, scene.quad_v],
                     dim=1).contiguous()


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
