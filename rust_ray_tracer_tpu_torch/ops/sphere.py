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
conservative, so it never changes a ray's winner. The kernel culls finer
inside it, per warp on :func:`sph_boxes`' sub-boxes of 32 rows, which
leaves every winner as it is; :func:`sph_sweep_replay` replays that
sweep in torch and counts its tests by stage.

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
SPH_ROW = 12            # floats a row of kernel N's table
SUB_ROWS = 32           # rows of a sub-box of kernel N's warp cull (csrc/
                        # sphere.cu ROWS)
BC = search_ops.BC      # rays a tile
WARP = 32
RAY_BLOCK = 2048        # rays (whole tiles) a block of the replay


def sph_table(scene):
    """[K * CLUSTER, SPH_ROW] rows (c0, c1 - c0, t0, 1 / (t1 - t0), r of
    ``search.sphere_rows``, then r * r and two zeros: 16-byte rows) for the
    scene's spheres, padded to the K clusters of ``scene.sph_cluster_min``
    with far rows; detached. The plain version reads columns 0-8; r * r is
    its product, computed here once."""
    with torch.no_grad():
        rows = search_ops.sphere_rows(scene)
        k = scene.sph_cluster_min.shape[0]
        pad = k * CLUSTER - rows.shape[0]
        if pad:
            far = torch.zeros((pad, 9), dtype=rows.dtype, device=rows.device)
            far[:, 0:3] = FAR
            rows = torch.cat([rows, far])
        r = rows[:, 8:9]
        return torch.cat([rows, r * r, torch.zeros_like(rows[:, :2])],
                         dim=1).contiguous()


def sph_boxes(scene):
    """[K * CLUSTER / SUB_ROWS, 8] kernel N's sub-boxes: for each group of
    :data:`SUB_ROWS` table rows, lo, a flag, hi and a zero, where lo /
    hi bound the rows' swept boxes ``min(c0, c1) - r`` / ``max(c0, c1) +
    r`` (``models/scene.py`` ``_cluster_boxes``' rule: rows past the
    scene's, the table's far pads, never enlarge a box; the compiler's
    zero-radius pads are scene rows and count). A cluster holding a row
    with r < 0 (a hollow sphere, whose row box is inverted) gives each of
    its sub-boxes the cluster's own box and the flag 1: there the kernel
    takes its tile's vote alone, the plain version's cull. Detached."""
    with torch.no_grad():
        c0, c1, r = scene.sph_c0, scene.sph_c1, scene.sph_r
        cl_lo, cl_hi = scene.sph_cluster_min, scene.sph_cluster_max
        total = cl_lo.shape[0] * CLUSTER
        n = c0.shape[0]
        lo = torch.full((total, 3), torch.inf, dtype=c0.dtype,
                        device=c0.device)
        hi = torch.full_like(lo, -torch.inf)
        lo[:n] = torch.minimum(c0, c1) - r[:, None]
        hi[:n] = torch.maximum(c0, c1) + r[:, None]
        neg = torch.zeros(total, dtype=torch.bool, device=c0.device)
        neg[:n] = r < 0
        per = CLUSTER // SUB_ROWS
        hollow = neg.reshape(-1, CLUSTER).any(1).repeat_interleave(per)
        lo = torch.where(hollow[:, None], cl_lo.repeat_interleave(per, 0),
                         lo.reshape(-1, SUB_ROWS, 3).amin(1))
        hi = torch.where(hollow[:, None], cl_hi.repeat_interleave(per, 0),
                         hi.reshape(-1, SUB_ROWS, 3).amax(1))
        return torch.cat([lo, hollow.to(lo.dtype)[:, None], hi,
                          torch.zeros_like(lo[:, :1])], dim=1).contiguous()


def sph_search_plain(rays, tab, cl_min, cl_max, n_sph: int,
                     chunk: int | None = None, boxes=None):
    """(best t [N] float32, inf for none; best index [N] int64) of the
    rays ``rays`` [9, N] (``ops/search.ray_planes``) over the spheres of
    ``tab`` (:func:`sph_table`, ``n_sph`` real rows; columns 0-8) whose
    clusters' boxes ``cl_min`` / ``cl_max`` [K, 3] some ray of the ray's
    tile enters. The clusters fold in index order with strict ``<``, the
    lowest index of one winning its tie: the (t, index) minimum of N's
    grid. ``boxes`` (the kernel's sub-boxes) is not read."""
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
               chunk: int | None = None, boxes=None):
    """(best t, best index) of :func:`sph_search_plain` for CPU tensors,
    kernel N (``csrc/sphere.cu``, with the sub-boxes ``boxes`` of
    :func:`sph_boxes`) for CUDA tensors."""
    dev = rays.device.type
    if dev == "cpu":
        return sph_search_plain(rays, tab, cl_min, cl_max, n_sph, chunk)
    if dev != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    from rust_ray_tracer_tpu_torch.kernels import sph_search_kernel
    return sph_search_kernel(rays, tab, cl_min, cl_max, n_sph, chunk, boxes)


def _disc(ray, sph):
    """The discriminant [S, B] of :func:`search.sphere_tests`' test, its
    operations in its order (what kernel N's staged test computes on
    every test)."""
    ox, oy, oz, dx, dy, dz, time = ray
    sp = sph[:, :, None]
    frac = (time - sp[:, 6]) * sp[:, 7]
    ocx = ox - (sp[:, 0] + frac * sp[:, 3])
    ocy = oy - (sp[:, 1] + frac * sp[:, 4])
    ocz = oz - (sp[:, 2] + frac * sp[:, 5])
    a = dx * dx + dy * dy + dz * dz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - sp[:, 8] * sp[:, 8]
    return b * b - a * cc


def sph_sweep_replay(rays, tab, cl_min, cl_max, n_sph: int,
                     chunk: int | None = None, boxes=None):
    """Kernel N's sweep as torch ops, on any device: (best t [N], inf for
    none; best index [N] int64, 0 for none; the work). Each 256-ray tile
    (restarting at each chunk) packs its live rays in ray order, 32 to a
    warp; the tile enters a cluster when one of its live rays' slab tests
    (``ops/quad.enters_boxes``) enters the cluster box; a warp sweeps the
    rows of each sub-box of ``boxes`` (:func:`sph_boxes`) of such a
    cluster that one of its rays enters (a flagged cluster: every
    sub-box), each of its rays testing them with the plain version's
    arithmetic; the lowest index of the least t wins. The work (counted
    for live rays): ``live_rays``; ``cluster_tests`` and ``box_tests``,
    the slab tests of the tile's and the warps' votes; ``tile_tests``,
    the tests of the plain version's per-tile cull (every row of the
    clusters the tile enters); ``tests``, the kernel's (every test runs
    up to the discriminant); ``root_tests``, those in rows where a lane of
    the warp has disc > 0 (the roots and windows run). Each ray alone, what
    the data needs: ``ray_box_tests``, the sub-boxes of the unflagged
    clusters whose box it enters; ``ray_tests``, the rows of the sub-boxes
    it enters (of a flagged cluster: every row of a cluster it enters);
    ``ray_root_tests``, those of its tests whose own disc > 0."""
    from rust_ray_tracer_tpu_torch.ops.quad import enters_boxes

    rp, n, chunk, chunk_p = search_ops._padded_rays(rays, chunk)
    dev = rays.device
    n_p = rp.shape[1]
    k = cl_min.shape[0]
    n_rows = k * CLUSTER
    subs = CLUSTER // SUB_ROWS
    live = rp[8] > rp[7]
    r8 = torch.cat([rp[0:6], rp[7:9]]).T.contiguous()       # o, d, tmin, tmax
    tile = torch.arange(n_p, device=dev) // BC
    n_tiles = n_p // BC
    # the packed slot of each live ray in its tile, its warp
    cum = torch.cumsum(live.long(), 0)
    first = torch.where(tile > 0, cum[(tile * BC - 1).clamp(min=0)], 0)
    warp = tile * (BC // WARP) + (cum - 1 - first) // WARP
    warp = torch.where(live, warp, -1)
    n_warps = n_tiles * (BC // WARP)

    def any_of(group, n_groups, hits):
        votes = torch.zeros((n_groups, hits.shape[1]), dtype=torch.long,
                            device=dev)
        votes.index_add_(0, group[live], hits[live].long())
        return votes > 0

    cl_in = enters_boxes(r8, cl_min, cl_max) & live[:, None]
    tile_in = any_of(tile, n_tiles, cl_in)
    sub_in = enters_boxes(r8, boxes[:, 0:3], boxes[:, 4:7])
    hollow = boxes[:, 3] != 0
    warp_in = any_of(warp, n_warps, sub_in) | hollow[None]
    # per live ray: the sub-boxes its warp sweeps, and those it enters alone
    swept = (warp_in[warp.clamp(min=0)]
             & tile_in[tile].repeat_interleave(subs, 1) & live[:, None])
    own = (sub_in | hollow[None]) & cl_in.repeat_interleave(subs, 1)
    work = {"live_rays": int(live.sum()),
            "cluster_tests": int(live.sum()) * k,
            "box_tests": int((tile_in & ~hollow[::subs])[tile][live].sum())
            * subs,
            "tile_tests": int(tile_in[tile][live].sum()) * CLUSTER,
            "tests": int(swept.sum()) * SUB_ROWS, "root_tests": 0,
            "ray_box_tests": int((cl_in & ~hollow[::subs]).sum()) * subs,
            "ray_tests": int(own.sum()) * SUB_ROWS, "ray_root_tests": 0}
    best_t = torch.full((n_p,), torch.inf, dtype=rays.dtype, device=dev)
    best_i = torch.zeros((n_p,), dtype=torch.long, device=dev)
    sub_of = torch.arange(n_rows, device=dev) // SUB_ROWS
    for s0 in range(0, n_p, RAY_BLOCK):
        sl = slice(s0, s0 + RAY_BLOCK)
        ray = tuple(rp[c, sl] for c in range(7))
        tested = swept[sl][:, sub_of].T                      # [rows, B]
        t = search_ops.sphere_tests(ray, tab[:, :9], rp[7, sl], rp[8, sl])
        t = torch.where(tested, t, torch.inf)
        best_t[sl], best_i[sl] = search_ops.first_min(t)
        # the roots run on a row where a lane of the warp has disc > 0:
        # the block's warps are [s0 / WARP, s0 / WARP + RAY_BLOCK / WARP)
        pos = (_disc(ray, tab[:, :9]) > 0) & tested
        work["ray_root_tests"] += int((pos & own[sl][:, sub_of].T).sum())
        wb = warp[sl] - s0 // WARP
        wl = wb >= 0
        cnt = torch.zeros((RAY_BLOCK // WARP, n_rows), dtype=torch.long,
                          device=dev)
        cnt.index_add_(0, wb[wl], pos[:, wl].T.long())
        ballot = (cnt > 0)[wb.clamp(min=0)].T                # [rows, B]
        work["root_tests"] += int((ballot & tested).sum())
    best_t, best_i = (search_ops._unpad(x, n, chunk, chunk_p)
                      for x in (best_t, best_i))
    return best_t, torch.clamp_max(best_i, n_sph - 1), work
