"""The closest sphere hit of each ray over 128 or more sphere rows: TPU
kernel N.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_sphere.py``
(``sph_search``, ``pallas_sphere.py:88-163``, body ``_kernel`` ``:35-85``),
which the JAX package's phase 1 calls from ``CLUSTER`` (128) sphere rows
up (``intersect._sph_candidates``, ``intersect.py:199-201``); below that
it takes the XLA form, as the port's ``ops/intersect._sph_candidates``
does. :func:`sph_search` runs :func:`sph_search_plain` for CPU tensors and
``sph_search_kernel`` (``csrc/sphere.cu``) for CUDA tensors, with no
fallback.

N's own arithmetic, not the XLA form's: the time-lerped centre ``c0 +
(time - t0) * inv_dt * (c1 - c0)`` with ``inv_dt`` = 1 / (t1 - t0), its
magnitude floored at 1e-12 with its sign kept (``ops/search.sphere_rows``,
``pallas_sphere.py:106-108``); ``sq = sqrt(max(disc, 1e-12)) * (disc >
0)``; ``root = (-b -+ sq) * (1 / max(a, 1e-12))``; the near root when it
lies in [t_min, t_max], else the far one (``ops/search.sphere_tests``).
The lowest index wins a tie in t; a miss gives (inf, 0); the index is
clamped to the last real row.

The cull is ``_tile_cluster_mask``'s (``pallas_intersect.py:145``): a
256-ray tile tests the 128 spheres of a cluster when one of its rays'
slab tests enters the cluster's swept box grown by 1e-3 (the test of
TPU kernel K, ``ops/search.tile_enter_plain``); tiles restart at each
chunk's first ray, as JAX's per-chunk calls do. The cull is per tile and
conservative, so it never changes a ray's winner.

The table is padded to whole clusters with far rows (c0 = 1e30, r = 0):
``(oc . d)^2`` and ``|d|^2 |oc|^2`` both overflow to inf, the
discriminant is NaN and every comparison rejects it. A finite far pad
would not do: float32 rounding of the discriminant can leave a tiny
positive value and a finite phantom root (``pallas_sphere.py:117-126``).
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.models.scene import CLUSTER
from rust_ray_tracer_tpu_torch.ops import search as search_ops

FAR = 1e30              # a pad row's centre


def sph_table(scene):
    """[K * CLUSTER, 9] rows of ``search.sphere_rows`` (c0, c1 - c0, t0,
    1 / (t1 - t0), r) for the scene's spheres, padded to the K clusters
    of ``scene.sph_cluster_min`` with far rows; detached."""
    with torch.no_grad():
        rows = search_ops.sphere_rows(scene)
        k = scene.sph_cluster_min.shape[0]
        pad = k * CLUSTER - rows.shape[0]
        if pad:
            far = torch.zeros((pad, 9), dtype=rows.dtype, device=rows.device)
            far[:, 0:3] = FAR
            rows = torch.cat([rows, far])
        return rows.contiguous()


def sph_search_plain(rays, tab, cl_min, cl_max, n_sph: int,
                     chunk: int | None = None):
    """(best t [N] float32, inf for none; best index [N] int64) of the
    rays ``rays`` [9, N] (``ops/search.ray_planes``) over the spheres of
    ``tab`` (:func:`sph_table`, ``n_sph`` real rows) whose clusters' boxes
    ``cl_min`` / ``cl_max`` [K, 3] some ray of the ray's tile enters. The
    clusters fold in index order with strict ``<``, the lowest index of
    one winning its tie: the (t, index) minimum of N's grid."""
    ent = search_ops.tile_enter_plain(rays, cl_min, cl_max, chunk)
    rp, n, chunk, chunk_p = search_ops._padded_rays(rays, chunk)
    tile = torch.arange(rp.shape[1], device=rays.device) // search_ops.BC
    ox, oy, oz, dx, dy, dz, time, tmin, tmax = rp
    best_t = torch.full_like(ox, torch.inf)
    best_i = torch.zeros(rp.shape[1], dtype=torch.int64, device=rays.device)
    for c in range(cl_min.shape[0]):
        sel = torch.nonzero(torch.isfinite(ent[tile, c]))[:, 0]
        if not sel.numel():
            continue
        t = search_ops.sphere_tests(
            tuple(x[sel] for x in (ox, oy, oz, dx, dy, dz, time)),
            tab[c * CLUSTER:(c + 1) * CLUSTER], tmin[sel], tmax[sel])
        loc_t, loc_i = search_ops.first_min(t)
        better = loc_t < best_t[sel]
        best_t[sel] = torch.where(better, loc_t, best_t[sel])
        best_i[sel] = torch.where(better, loc_i + c * CLUSTER, best_i[sel])
    best_t, best_i = (search_ops._unpad(x, n, chunk, chunk_p)
                      for x in (best_t, best_i))
    return best_t, torch.clamp_max(best_i, n_sph - 1)


def sph_search(rays, tab, cl_min, cl_max, n_sph: int,
               chunk: int | None = None):
    """(best t, best index) of :func:`sph_search_plain` for CPU tensors,
    kernel N (``csrc/sphere.cu``) for CUDA tensors."""
    dev = rays.device.type
    if dev == "cpu":
        return sph_search_plain(rays, tab, cl_min, cl_max, n_sph, chunk)
    if dev != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    from rust_ray_tracer_tpu_torch.kernels import sph_search_kernel
    return sph_search_kernel(rays, tab, cl_min, cl_max, n_sph, chunk)
