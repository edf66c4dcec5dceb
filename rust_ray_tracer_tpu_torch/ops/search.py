"""The split route's phase-1 search over triangles: TPU kernels K, M and L.

Counterpart of ``rust_ray_tracer_tpu/ops/pallas_intersect.py``:

  * :func:`tile_enter_plain` — ``tile_cluster_enter_pallas`` /
    ``_mask_kernel`` (``pallas_intersect.py:180-281``, TPU kernel K): the
    smallest entry distance of each 256-ray tile into each triangle
    cluster's box, +inf where no ray of the tile enters it. The plain
    version of ``tile_enter_kernel`` (``csrc/search.cu``);
  * :func:`fused_search_plain` — ``fused_search`` (``:786-1072``, TPU
    kernel M, both its dense and its pair-list grid): the closest (t,
    kind, index) over the triangles of the clusters a ray's tile enters,
    then the small sphere and quad tables (fewer than ``CLUSTER`` rows
    each). The plain version of ``fused_search_kernel``;
  * :func:`tri_search_plain` — ``tri_search`` (``:283-345``, body
    ``_kernel`` ``:81-133``, TPU kernel L): the closest (t, index) over
    the triangles alone, for the per-kind branch (spheres or quads in
    ``CLUSTER`` rows or more). Its arithmetic is M's triangle test, and
    its cull K's, so it is M's sweep with empty sphere and quad tables,
    and the kernel is ``fused_search_kernel`` launched so
    (``kernels.tri_search_kernel``);
  * :func:`tile_enter`, :func:`fused_search` and :func:`tri_search` — the
    dispatchers: CPU tensors take the plain versions, CUDA tensors the
    kernels (no fallback);
  * :func:`sphere_tests`, :func:`quad_tests` and :func:`tri_tests` — the
    per-(primitive, ray) tests of ``_tri_eval_fold`` and
    ``_fold_small_tables`` (``:439-473``, ``:580``), which the whole-wave
    trace's plain search (``ops/uber._search_block``) runs too.

Tiles are 256 rays (``BC``, ``pallas_intersect.py:62``) and restart at
each chunk's first ray, as JAX's per-chunk calls do; a chunk that is not a
multiple of 256 ends in a short tile (JAX's pad rays carry a collapsed
window and enter nothing). Rays travel as one [9, N] tensor of planes: o,
d, time, t_min, t_max (a dead lane has t_max < t_min).

Tie rules, as the TPU kernel's: triangles fold lexicographically in (t,
index), so a tie goes to the lowest triangle index whatever the order the
clusters are swept in; then spheres, then quads, each with strict ``<``,
so a tie goes triangle > sphere > quad. A triangle winner's index is
clamped to the last row (``_finish``). A miss has kind 0, index 0 and t
inf. The cull is conservative (a 1e-3 margin) and per tile, never per ray:
every ray of a tile tests every cluster some ray of the tile enters.

  * :func:`search_order` — ``intersect._search_order`` (``intersect.py:
    460-494``): the permutation of the rays before the unified search of a
    scene of at least :data:`PACKED_MIN_TRIS` triangles (the gate of
    ``intersect.py:626-636``, taken in ``ops/intersect.intersect_select``):
    dead lanes last, live ones by direction octant, then by the Morton
    code of the origin in the clusters' bounds, so a tile's live rays are
    near one another and its cluster union small. JAX sorts each chunk's
    rays in its per-chunk call; the port searches a whole wave at once, so
    the sort is segmented by chunk. K and M take the permutation
    (``perm``): the tiles hold the sorted rays, and the winners come back
    in the rays' own order.

The triangle table comes in one of two inputs (``SearchTables.packed``):

  * staged (below :data:`PACKED_MIN_TRIS` triangles): compact rows
    (:data:`TRI_ROW` floats a row, :func:`compact_rows`), the columns of
    ``_tri_coeffs``' rows that are not structural zeros, and the
    double-sided flag;
  * packed (from :data:`PACKED_MIN_TRIS` on: JAX's ``INKERNEL_COEFFS``
    automatic choice, ``pallas_intersect.py:808``): the vertex rows
    (:data:`PACK_ROW` floats a row, :func:`packed_rows`) v0, e1, e2 and
    the flag, [T, 10] so a stage of 128 rows is 5,120 contiguous bytes
    that kernel M copies in 16-byte pieces. M builds each staged
    cluster's compact rows from them in shared memory
    (``_coeffs_from_pack``, ``pallas_intersect.py:394-431``), in
    :func:`assemble_rows`' order, which is ``_tri_coeffs``': the compact
    rows bit for bit, so both inputs give the same winners, ties
    included, and the gate decides only speed. Half the bytes a row (40
    against 80), and no [10, T] temporaries when the tables are built.

The plain versions expand a compact row back to the four 10-term rows
(:func:`full_rows`) and sum every term (a packed table's rows assembled
first); kernels M and L sum the live terms alone (``csrc/search.cu``'s
header says why the sums agree). L (the per-kind branch) always takes the
staged input, as JAX's ``tri_search`` takes the coefficient tables.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_ray_tracer_tpu_torch.models.scene import CLUSTER
from rust_ray_tracer_tpu_torch.ops.intersect import (KIND_QUAD, KIND_SPH,
                                                     KIND_TRI, TRI_DET_EPS,
                                                     _tri_coeffs)

BC = 256                # rays per tile (pallas_intersect.py:62)
CULL_EPS = 1e-3         # the cull box margin (_mask_kernel)
N_RAY = 9               # ray planes: o(3) d(3) time t_min t_max
# triangles from which phase 1 sorts the rays and the unified search
# takes the packed vertex rows (pallas_intersect.py:78, :808;
# intersect.py:626)
PACKED_MIN_TRIS = 65536
DEAD_KEY = 0x7FFFFFFF   # a dead lane's sort key: after every live one

# The compact triangle row: (row of _tri_coeffs, its feature columns) in
# the row's order, then the double-sided flag. Feature columns: o 0-2,
# d 3-5, o x d 6-8, the constant 9. det = -n.d lives on d; t_num =
# n.o - v0.n on o and the constant; u_num and v_num on d and o x d. The
# kernel reads the row as five float4: (det | t_o0), (t_o1 t_o2 t_1
# flag), u, then v.
DET, U, V, T = range(4)
TRI_LIVE = ((DET, (3, 4, 5)), (T, (0, 1, 2, 9)), (U, (3, 4, 5, 6, 7, 8)),
            (V, (3, 4, 5, 6, 7, 8)))
TRI_FLAG = 7            # the flag's column, between t's terms and u's
TRI_ROW = 20            # floats a compact row (19 coefficients, the flag)
PACK_ROW = 10           # floats a packed row: v0, e1, e2, the flag


@dataclasses.dataclass
class SearchTables:
    """Detached tables of the unified search, built once per render.
    ``tri`` [T, 20] a triangle's compact row (:func:`compact_rows`: the
    live terms of its Plücker rows det, u_num, v_num, t_num over the ray
    features [o, d, o x d, 1], ``intersect._tri_coeffs``, and its
    double-sided flag), or with ``packed`` [T, 10] its packed row
    (:func:`packed_rows`: v0, e1, e2, the flag); ``cl_min`` / ``cl_max``
    [K, 3] the cluster boxes (inverted for an all-pad cluster); ``width``
    triangles a cluster; ``sph`` [S, 9] c0, c1 - c0, t0, 1 / (t1 - t0),
    r; ``quad`` [Q, 9] q, u, v. Empty kinds have 0 rows."""

    tri: torch.Tensor
    cl_min: torch.Tensor
    cl_max: torch.Tensor
    width: int
    sph: torch.Tensor
    quad: torch.Tensor
    packed: bool = False


def unified(scene) -> bool:
    """Does phase 1 take the unified search (``intersect.py:612-614``, the
    TPU's predicate without ``on_tpu``): any primitive rows, fewer than
    ``CLUSTER`` spheres and fewer than ``CLUSTER`` quads."""
    return (scene.n_tris + scene.n_spheres + scene.n_quads > 0
            and scene.n_spheres < CLUSTER and scene.n_quads < CLUSTER)


def compact_rows(coeffs, double):
    """[T, 20] compact rows of the four [10, T] rows ``coeffs`` = (det,
    u_num, v_num, t_num) of ``intersect._tri_coeffs`` and the flags
    ``double`` [T]: the columns :data:`TRI_LIVE` names, in its order, with
    the flag at :data:`TRI_FLAG`. Every other column of ``_tri_coeffs`` is
    a structural zero (``full_rows`` restores them)."""
    cols = [coeffs[r][list(fs)] for r, fs in TRI_LIVE]
    cols.insert(2, double.to(coeffs[0].dtype)[None])
    return torch.cat(cols, dim=0).T.contiguous()


def full_rows(tri):
    """(det, u_num, v_num, t_num) [R, 10] and the flag [R, 1] of compact
    rows ``tri`` [R, 20]: the structural zeros of ``_tri_coeffs`` put back
    (+0.0, as ``_tri_coeffs`` makes them), every coefficient as stored."""
    out = [tri.new_zeros((tri.shape[0], 10)) for _ in range(4)]
    at = 0
    for r, fs in TRI_LIVE:
        if at == TRI_FLAG:
            at += 1
        out[r][:, list(fs)] = tri[:, at:at + len(fs)]
        at += len(fs)
    return (*out, tri[:, TRI_FLAG:TRI_FLAG + 1])


def packed_rows(scene):
    """[T, 10] packed rows of ``scene``'s triangles: v0, e1, e2 and the
    double-sided flag, the columns of JAX's packed [10, T] table
    (``pallas_intersect.py:817-821``) one row a triangle."""
    v0 = scene.tri_v0
    return torch.cat([v0, scene.tri_e1, scene.tri_e2,
                      scene.tri_double.to(v0.dtype)[:, None]], dim=1)


def assemble_rows(pack):
    """[R, 20] compact rows of the packed rows ``pack`` [R, 10]: the plain
    version of kernel M's in-kernel assembly (``_coeffs_from_pack``,
    ``pallas_intersect.py:394-431``), in ``intersect._tri_coeffs``' order
    of operations (the cross products, ``_sum3``, ``sqrt``, the ``nl >
    0`` guard, ``1 / nl``, the products by ``inv_n``), so the rows are
    ``compact_rows(_tri_coeffs(...))``'s bit for bit."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, dbl = pack.T
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    nl = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv_n = 1.0 / torch.where(nl > 0, nl, torch.ones_like(nl))
    nhx, nhy, nhz = nx * inv_n, ny * inv_n, nz * inv_n
    c1 = (e2y * v0z - e2z * v0y, e2z * v0x - e2x * v0z,
          e2x * v0y - e2y * v0x)                  # cross(e2, v0)
    c2 = (v0y * e1z - v0z * e1y, v0z * e1x - v0x * e1z,
          v0x * e1y - v0y * e1x)                  # cross(v0, e1)
    t_1 = -(v0x * nhx + v0y * nhy + v0z * nhz)
    cols = ([-nhx, -nhy, -nhz, nhx, nhy, nhz, t_1, dbl]
            + [-c * inv_n for c in c1] + [e * inv_n for e in (e2x, e2y, e2z)]
            + [-c * inv_n for c in c2]
            + [-e * inv_n for e in (e1x, e1y, e1z)])
    return torch.stack(cols, dim=1)


def tri_rows(tabs: SearchTables, rows=None):
    """The compact rows [R, 20] of ``tabs``' triangles ``rows`` (all of
    them when None): as stored, or assembled from the packed rows."""
    tri = tabs.tri if rows is None else tabs.tri[rows]
    return assemble_rows(tri) if tabs.packed else tri


def sphere_rows(scene):
    """[S, 9] rows of the sphere table (``fused_search``'s, ``:566-577``):
    c0, c1 - c0, t0, 1 / (t1 - t0) (|t1 - t0| floored at 1e-12), r."""
    dt = scene.sph_t1 - scene.sph_t0
    inv_dt = 1.0 / torch.where(dt.abs() < 1e-12,
                               torch.where(dt < 0, -1e-12, 1e-12).to(dt.dtype),
                               dt)
    return torch.cat([scene.sph_c0, scene.sph_c1 - scene.sph_c0,
                      scene.sph_t0[:, None], inv_dt[:, None],
                      scene.sph_r[:, None]], dim=1)


def packed_input(n_tris: int) -> bool:
    """Does the unified search of ``n_tris`` triangles take the packed
    input: JAX's automatic choice (``pallas_intersect.py:808``)."""
    return n_tris >= PACKED_MIN_TRIS


def search_tables(scene, packed: bool | None = None) -> SearchTables:
    """The unified search's tables of ``scene``, detached: the triangles
    as packed rows with ``packed``, as compact rows without, and by
    :func:`packed_input` when None. The packed rows are built from the
    scene's vertex tensors alone (40 bytes a triangle), the compact ones
    through ``_tri_coeffs``' four [10, T] rows."""
    with torch.no_grad():
        f32 = torch.float32
        dev = scene.device
        t_n = scene.n_tris
        packed = packed_input(t_n) if packed is None else packed
        if t_n:
            tri = (packed_rows(scene) if packed else compact_rows(
                _tri_coeffs(scene.tri_v0, scene.tri_e1, scene.tri_e2),
                scene.tri_double))
            k = scene.tri_cluster_min.shape[0]
            width = t_n // k
            if width * k != t_n or width % CLUSTER:
                raise ValueError(f"{t_n} triangles in {k} clusters")
        else:
            tri = torch.zeros((0, PACK_ROW if packed else TRI_ROW),
                              dtype=f32, device=dev)
            width = CLUSTER
        sph = (sphere_rows(scene) if scene.n_spheres
               else torch.zeros((0, 9), dtype=f32, device=dev))
        quad = torch.cat([scene.quad_q, scene.quad_u, scene.quad_v], dim=1)
        return SearchTables(
            tri=tri.contiguous(),
            cl_min=scene.tri_cluster_min.contiguous(),
            cl_max=scene.tri_cluster_max.contiguous(), width=width,
            sph=sph.contiguous(), quad=quad.contiguous(), packed=packed)


def ray_planes(o, d, time, t_min, t_max):
    """[9, N] ray planes of ``o``, ``d`` [N, 3] and ``time``, ``t_min``,
    ``t_max`` [N]."""
    return torch.cat([o.T, d.T, time[None], t_min[None],
                      t_max[None]]).contiguous()


# ---------------------------------------------------------------------------
# per-(primitive, ray) tests: rays broadcast along the last axis
# ---------------------------------------------------------------------------

def tri_tests(f, tabs, tmin, tmax):
    """(valid, t) [T, B] of the triangles whose coefficient rows are
    ``tabs`` = (det, u, v, t) [T, 10] and double-sided flags ``tabs[4]``
    [T, 1] for rays of Plücker features ``f`` (10 tensors [B]):
    ``_tri_eval_fold``'s epilogue (``pallas_intersect.py:439-473``), each
    dot summed term by term in feature order, as the kernels do."""
    det_t, u_t, v_t, t_t, dbl = tabs

    def dots(tab):
        acc = tab[:, 0:1] * f[0]
        for k in range(1, 10):
            acc = acc + tab[:, k:k + 1] * f[k]
        return acc

    dm, um, vm, tm = (dots(x) for x in (det_t, u_t, v_t, t_t))
    eps = TRI_DET_EPS * torch.sqrt(f[3] * f[3] + f[4] * f[4] + f[5] * f[5])
    safe = torch.where(dm.abs() > eps, dm, torch.ones_like(dm))
    inv = 1.0 / safe
    u, v, t = um * inv, vm * inv, tm * inv
    side_ok = (dm > eps) | ((dm < -eps) & (dbl > 0.5))
    valid = (side_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (v < 1.0 - u) & (t >= tmin) & (t <= tmax))
    return valid, t


def sphere_tests(ray, sph, tmin, tmax):
    """t [S, B] (inf: no hit in [tmin, tmax]) of the time-lerped spheres
    of ``sph`` [S, 9] (:func:`sphere_rows`) for rays ``ray`` = (ox, oy,
    oz, dx, dy, dz, time), each [B]: ``_fold_small_tables``' sphere test
    (``pallas_intersect.py:601-630``). A far pad row (c0 = 1e30) gives a
    NaN discriminant and no hit."""
    ox, oy, oz, dx, dy, dz, time = ray
    sp = sph[:, :, None]                         # [S, 9, 1]
    c0x, c0y, c0z = sp[:, 0], sp[:, 1], sp[:, 2]
    e1x, e1y, e1z = sp[:, 3], sp[:, 4], sp[:, 5]
    st0, inv_dt, rr = sp[:, 6], sp[:, 7], sp[:, 8]
    frac = (time - st0) * inv_dt                 # [S, B]
    cx = c0x + frac * e1x
    cy = c0y + frac * e1y
    cz = c0z + frac * e1z
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr
    disc = b * b - a * cc
    ok = disc > 0.0
    sq = torch.sqrt(torch.maximum(disc, disc.new_tensor(1e-12))) * ok
    inv_a = 1.0 / torch.maximum(a, a.new_tensor(1e-12))
    root1 = (-b - sq) * inv_a
    root2 = (-b + sq) * inv_a
    ok1 = ok & (root1 >= tmin) & (root1 <= tmax)
    ok2 = ok & (root2 >= tmin) & (root2 <= tmax)
    return torch.where(ok1, root1, torch.where(ok2, root2, torch.inf))


def quad_tests(ray, quad, tmin, tmax):
    """t [Q, B] (inf: no hit) of the quads of ``quad`` [Q, 9] (q, u, v)
    for rays ``ray`` = (ox, oy, oz, dx, dy, dz), each [B]:
    ``_fold_small_tables``' quad test (``pallas_intersect.py:631-667``),
    both sides, [0, 1]^2 inclusive. A zero-edge pad row has |denom| == 0
    and no hit."""
    ox, oy, oz, dx, dy, dz = ray
    qd = quad[:, :, None]
    qx, qy, qz = qd[:, 0], qd[:, 1], qd[:, 2]
    ux, uy, uz = qd[:, 3], qd[:, 4], qd[:, 5]
    vx, vy, vz = qd[:, 6], qd[:, 7], qd[:, 8]
    wnx = uy * vz - uz * vy
    wny = uz * vx - ux * vz
    wnz = ux * vy - uy * vx
    denom = dx * wnx + dy * wny + dz * wnz       # [Q, B]
    dsafe = torch.where(denom.abs() < 1e-12,
                        torch.where(denom < 0, -1e-12, 1e-12).to(
                            denom.dtype), denom)
    t = ((qx - ox) * wnx + (qy - oy) * wny + (qz - oz) * wnz) / dsafe
    wx = ox + t * dx - qx
    wy = oy + t * dy - qy
    wz = oz + t * dz - qz
    n2 = wnx * wnx + wny * wny + wnz * wnz
    inv_n2 = 1.0 / torch.maximum(n2, n2.new_tensor(1e-12))
    alpha = ((wy * vz - wz * vy) * wnx + (wz * vx - wx * vz) * wny
             + (wx * vy - wy * vx) * wnz) * inv_n2
    beta = ((uy * wz - uz * wy) * wnx + (uz * wx - ux * wz) * wny
            + (ux * wy - uy * wx) * wnz) * inv_n2
    valid = ((denom.abs() > 0.0) & (t >= tmin) & (t <= tmax)
             & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(valid, t, torch.inf)


def first_min(tt):
    """(min over rows, lowest row index attaining it) of tt [R, B] (the
    index is meaningless where the min is inf; the fold ignores it)."""
    loc_t = tt.amin(dim=0)
    return loc_t, torch.argmax((tt == loc_t).to(torch.int32), dim=0)


def fold(best, loc_t, loc_i, kind):
    """Strict-``<`` fold of a later kind into the running winner (t, kind,
    index)."""
    bt, bk, bi = best
    better = loc_t < bt
    return (torch.where(better, loc_t, bt),
            torch.where(better, torch.full_like(bk, kind), bk),
            torch.where(better, loc_i.to(bi.dtype), bi))


# ---------------------------------------------------------------------------
# tiles
# ---------------------------------------------------------------------------

def _tiles(n: int, chunk: int | None):
    """(chunk, tiles a chunk, padded chunk) of ``n`` rays cut into chunks
    of ``chunk`` (the whole input when None)."""
    chunk = n if chunk is None else chunk
    if chunk <= 0 or n % chunk:
        raise ValueError(f"{n} rays are not whole chunks of {chunk}")
    tpc = -(-chunk // BC)
    return chunk, tpc, tpc * BC


def tile_count(n: int, chunk: int | None = None) -> int:
    """256-ray tiles of ``n`` rays in chunks of ``chunk`` (None: one)."""
    chunk, tpc, _ = _tiles(n, chunk)
    return n // chunk * tpc


def _tile_pad(x, chunk: int, chunk_p: int, value: float):
    """[..., n] -> [..., n_chunks * chunk_p]: each chunk padded to whole
    tiles with ``value``."""
    lead = x.shape[:-1]
    x = x.reshape(lead + (-1, chunk))
    x = torch.nn.functional.pad(x, (0, chunk_p - chunk), value=value)
    return x.reshape(lead + (-1,))


def _padded_rays(rays, chunk: int | None):
    """The [9, n_tiles * 256] ray planes of ``rays`` [9, N], each chunk
    padded to whole tiles with rays of a collapsed window (o = d = 0,
    t_min = 0, t_max = -1: ``fused_search``'s pads), and (n, chunk,
    chunk_p)."""
    n = rays.shape[1]
    chunk, _, chunk_p = _tiles(n, chunk)
    if chunk_p == chunk:
        return rays, n, chunk, chunk_p
    pads = [0.0] * 8 + [-1.0]
    rp = torch.stack([_tile_pad(rays[c], chunk, chunk_p, pads[c])
                      for c in range(N_RAY)])
    return rp, n, chunk, chunk_p


def _unpad(x, n: int, chunk: int, chunk_p: int):
    if chunk_p == chunk:
        return x
    return x.reshape(-1, chunk_p)[:, :chunk].reshape(n)


# ---------------------------------------------------------------------------
# K: the tile-cluster entry distances
# ---------------------------------------------------------------------------

_ENTER_TILES = 8        # tiles a block of the plain version tests at once


def tile_enter_plain(rays, cl_min, cl_max, chunk: int | None = None,
                     perm=None):
    """[n_tiles, K] float32: the smallest entry distance of any ray of each
    256-ray tile into each cluster box ``cl_min`` / ``cl_max`` [K, 3], +inf
    where none enters (``_mask_kernel``, ``pallas_intersect.py:180-242``).
    With ``perm`` (:func:`search_order`), the tiles hold the rays
    ``rays[:, perm]``.

    The slab test on unnormalised rays with the box grown by 1e-3: an
    axis with |d| < 1e-12 asks for the origin inside the slab instead; an
    inverted (empty) box and a ray whose window is empty (t_max <= t_min)
    enter nothing; the entry is clamped up to t_min. Max and min propagate
    NaN as ``jnp.maximum`` / ``jnp.minimum`` do."""
    if perm is not None:
        rays = rays[:, perm]
    rp, _, _, _ = _padded_rays(rays, chunk)
    lo = cl_min[None] - CULL_EPS                           # [1, K, 3]
    hi = cl_max[None] + CULL_EPS
    nonempty = (cl_min <= cl_max).all(dim=1)[None]         # [1, K]
    step = _ENTER_TILES * BC
    out = []
    for s in range(0, rp.shape[1], step):
        r = rp[:, s:s + step]
        o = r[0:3].T[:, None, :]                           # [B, 1, 3]
        d = r[3:6].T[:, None, :]
        tmin, tmax = r[7][:, None], r[8][:, None]
        small = d.abs() < 1e-12
        inv = 1.0 / torch.where(small, torch.ones_like(d), d)
        t0 = (lo - o) * inv                                # [B, K, 3]
        t1 = (hi - o) * inv
        tlo = torch.where(small, -torch.inf, torch.minimum(t0, t1))
        thi = torch.where(small, torch.inf, torch.maximum(t0, t1))
        enter = torch.maximum(torch.maximum(tlo[..., 0], tlo[..., 1]),
                              tlo[..., 2])
        exit_ = torch.minimum(torch.minimum(thi[..., 0], thi[..., 1]),
                              thi[..., 2])
        par_ok = (~small | ((o >= lo) & (o <= hi))).all(dim=2)
        hit = (nonempty & par_ok & (enter <= exit_) & (exit_ >= tmin)
               & (enter <= tmax) & (tmax > tmin))
        ent = torch.where(hit, torch.maximum(enter, tmin), torch.inf)
        out.append(ent.reshape(-1, BC, ent.shape[1]).amin(dim=1))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# M: the unified closest-hit search
# ---------------------------------------------------------------------------

def fused_search_plain(rays, ent, tabs: SearchTables,
                       chunk: int | None = None, perm=None):
    """(best t [N] float32, inf for none; kind [N] int32, 0 for none;
    index [N] int32 within its kind's table) of the rays ``rays`` [9, N]:
    ``fused_search`` (``pallas_intersect.py:786-1072``), either input
    (a packed table's rows are assembled first, :func:`tri_rows`).

    Tile by tile, every ray tests the triangles of each cluster whose
    entry ``ent`` [n_tiles, K] (:func:`tile_enter_plain`) is finite —
    ``_tri_eval_fold``'s tests on the full 10-term rows, the lowest index
    winning a tie in t over all of them — then the spheres and the quads
    of ``tabs`` fold in with strict ``<``. A triangle winner's index is
    clamped to the last row. With ``perm`` (:func:`search_order`), the
    tiles hold the rays ``rays[:, perm]`` and each ray's winner is
    returned at its own position."""
    if perm is not None:
        out = fused_search_plain(rays[:, perm], ent, tabs, chunk)
        return tuple(torch.empty_like(x).index_copy_(0, perm, x)
                     for x in out)
    rp, n, chunk, chunk_p = _padded_rays(rays, chunk)
    dev = rays.device
    width = tabs.width
    t_n = tabs.tri.shape[0]
    cols = torch.arange(width, device=dev)
    bts, bks, bis = [], [], []
    for tile in range(rp.shape[1] // BC):
        r = rp[:, tile * BC:(tile + 1) * BC]
        ox, oy, oz, dx, dy, dz, time, tmin, tmax = r
        best = (torch.full_like(ox, torch.inf),
                torch.zeros(BC, dtype=torch.int32, device=dev),
                torch.zeros(BC, dtype=torch.int32, device=dev))
        cs = (torch.nonzero(torch.isfinite(ent[tile]))[:, 0]
              if t_n else cols[:0])
        if cs.numel():
            rows = (cs[:, None] * width + cols).reshape(-1)  # ascending
            tab = tri_rows(tabs, rows)
            f = (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy,
                 oz * dx - ox * dz, ox * dy - oy * dx, torch.ones_like(ox))
            valid, t = tri_tests(f, full_rows(tab), tmin, tmax)
            loc_t, loc_i = first_min(torch.where(valid, t, torch.inf))
            best = fold(best, loc_t, rows[loc_i], KIND_TRI)
        if tabs.sph.shape[0]:
            best = fold(best, *first_min(sphere_tests(
                (ox, oy, oz, dx, dy, dz, time), tabs.sph, tmin, tmax)),
                KIND_SPH)
        if tabs.quad.shape[0]:
            best = fold(best, *first_min(quad_tests(
                (ox, oy, oz, dx, dy, dz), tabs.quad, tmin, tmax)),
                KIND_QUAD)
        bts.append(best[0])
        bks.append(best[1])
        bis.append(best[2])
    bt, bk, bi = (_unpad(torch.cat(x), n, chunk, chunk_p)
                  for x in (bts, bks, bis))
    if t_n:
        bi = torch.where(bk == KIND_TRI, torch.clamp_max(bi, t_n - 1), bi)
    return bt, bk, bi


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------

def tile_enter(rays, cl_min, cl_max, chunk: int | None = None, perm=None):
    """[n_tiles, K] tile-cluster entry distances: :func:`tile_enter_plain`
    for CPU tensors, kernel K (``csrc/search.cu``) for CUDA tensors; with
    ``perm`` (:func:`search_order`) the tiles hold the sorted rays."""
    dev = rays.device.type
    if dev == "cpu":
        return tile_enter_plain(rays, cl_min, cl_max, chunk, perm)
    if dev != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    from rust_ray_tracer_tpu_torch.kernels import tile_enter_kernel
    return tile_enter_kernel(rays, cl_min, cl_max, chunk, perm)


def fused_search(rays, ent, tabs: SearchTables, chunk: int | None = None,
                 perm=None):
    """(best t, kind, index) of :func:`fused_search_plain` for CPU
    tensors, kernel M (``csrc/search.cu``; its packed variant for packed
    tables) for CUDA tensors; ``perm`` as :func:`tile_enter`'s."""
    dev = rays.device.type
    if dev == "cpu":
        return fused_search_plain(rays, ent, tabs, chunk, perm)
    if dev != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    from rust_ray_tracer_tpu_torch.kernels import search_kernel
    return search_kernel(tabs)(rays, ent, tabs, chunk, perm)


def tri_only(tabs: SearchTables) -> SearchTables:
    """``tabs`` without its sphere and quad rows: L's tables."""
    return dataclasses.replace(tabs, sph=tabs.sph[:0], quad=tabs.quad[:0])


def tri_search_plain(rays, ent, tabs: SearchTables,
                     chunk: int | None = None):
    """(best t [N] float32, inf for none; best index [N] int32, 0 for
    none) over the triangles of ``tabs`` alone: ``tri_search``
    (``pallas_intersect.py:283-345``, TPU kernel L). L's body is M's
    triangle test (the ten Plücker features against the det/u/v/t rows,
    ``eps = TRI_DET_EPS * |d|``, ``inv = 1 / safe``, ``side_ok`` by the
    double-sided flag, ``v < 1 - u``, the t window, the lowest index
    winning a tie) over the clusters each tile enters, so this is
    :func:`fused_search_plain` of :func:`tri_only` tables. The cluster
    width comes from the tables (``tabs.width``, the triangles over the
    cluster boxes)."""
    bt, _, bi = fused_search_plain(rays, ent, tri_only(tabs), chunk)
    return bt, bi


def tri_search(rays, ent, tabs: SearchTables, chunk: int | None = None):
    """(best t, best index) of :func:`tri_search_plain` for CPU tensors,
    kernel L (``kernels.tri_search_kernel``: M's kernel with no sphere
    or quad rows) for CUDA tensors."""
    dev = rays.device.type
    if dev == "cpu":
        return tri_search_plain(rays, ent, tabs, chunk)
    if dev != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    from rust_ray_tracer_tpu_torch.kernels import tri_search_kernel
    return tri_search_kernel(rays, ent, tabs, chunk)


def search(rays, tabs: SearchTables, chunk: int | None = None,
           perm=None):
    """The unified phase 1 of rays ``rays`` [9, N]: K (when the scene has
    triangles), then M. Without triangles M takes a one-column +inf entry
    table (``pallas_intersect.py:876-886``) and folds the small tables
    alone. With ``perm`` (:func:`search_order`) both search the rays in
    that order, through the permutation (no sorted copy is made), and the
    winners come back in the rays' own order. Returns (best t, kind,
    index). An unsorted search passes K and M no permutation argument at
    all, so their recorded calls keep the four arguments they had."""
    extra = () if perm is None else (perm,)
    if tabs.tri.shape[0]:
        ent = tile_enter(rays, tabs.cl_min, tabs.cl_max, chunk, *extra)
    else:
        ent = torch.full((tile_count(rays.shape[1], chunk), 1), torch.inf,
                         dtype=torch.float32, device=rays.device)
    return fused_search(rays, ent, tabs, chunk, *extra)


def _spread(v):
    """The 9 low bits of ``v`` spread to every third bit (``spread``)."""
    v = v & 0x1FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


_KEY_BITS = {}          # device -> search_key's constant tables


def _key_bits(device):
    """The constant tables of :func:`search_key` on ``device``, made once:
    :func:`_spread` of every 9-bit value, shifted by 0, 1 and 2 for x, y
    and z ([3 * 512]: x's at 0, y's at 512, z's at 1024) and the three
    offsets; the octant's sign bits 27, 28 and 29 [3]."""
    bits = _KEY_BITS.get(device)
    if bits is None:
        sp = _spread(torch.arange(512, dtype=torch.int32))
        bits = tuple(x.to(device) for x in (
            torch.cat([sp, sp << 1, sp << 2]),
            torch.tensor([0, 512, 1024], dtype=torch.int32),
            torch.tensor([1 << 27, 1 << 28, 1 << 29], dtype=torch.int32)))
        _KEY_BITS[device] = bits
    return bits


def search_key(rays, cl_min, cl_max):
    """[N] int32 sort keys of the rays ``rays`` [9, N] (``_search_order``,
    ``intersect.py:475-493``): the origin quantised to 9 bits a axis in
    the bounds of the cluster boxes ``cl_min`` / ``cl_max`` [K, 3] (``q =
    clip((o - lo) / max(hi - lo, 1e-30), 0, 1)``, truncated ``q * 511``),
    the three interleaved as a Morton code in bits 0-26, the direction's
    octant (the signs of d) in bits 27-29; a dead lane (t_max <= t_min)
    :data:`DEAD_KEY`. The same values as JAX's op for op: the three axes
    go through each op together, each 9-bit value's spread bits come from
    a table, and the axes' disjoint bits are summed (an or)."""
    lo = cl_min.amin(dim=0)
    span = torch.clamp_min(cl_max.amax(dim=0) - lo, 1e-30)
    tab, offs, octb = _key_bits(rays.device)
    q = torch.clamp((rays[0:3].T - lo) / span, 0.0, 1.0)
    at = (q * 511.0).to(torch.int32) + offs
    bits = tab[at] + (rays[3:6].T < 0) * octb                  # [N, 3]
    return torch.where(rays[8] > rays[7], bits.sum(1, dtype=torch.int32),
                       DEAD_KEY)


def search_order(rays, tabs: SearchTables, chunk: int | None = None):
    """[N] int64 permutation of the rays ``rays`` [9, N] for the unified
    search (``intersect._search_order``): within each chunk of ``chunk``
    rays (the whole input when None), the chunk's rays sorted stably by
    :func:`search_key` in the bounds of ``tabs``' clusters — dead lanes
    last, live ones by octant, then Morton order of the origin. JAX sorts each per-chunk call's rays;
    ``perm[c * chunk + j]`` is the ray at position j of chunk c's sorted
    order. Detached: it orders rays and carries no gradient."""
    with torch.no_grad():
        n = rays.shape[1]
        chunk, _, _ = _tiles(n, chunk)
        key = search_key(rays, tabs.cl_min, tabs.cl_max).reshape(-1, chunk)
        order = torch.argsort(key, dim=1, stable=True)
        offs = torch.arange(0, n, chunk, device=rays.device)[:, None]
        return (order + offs).reshape(n)


def tri_candidates(rays, tabs: SearchTables, chunk: int | None = None):
    """The triangles of the per-kind phase 1 (``_tri_candidates``,
    ``intersect.py:136-148``): K's tile-cluster entries, then L. Returns
    (best t, best index)."""
    ent = tile_enter(rays, tabs.cl_min, tabs.cl_max, chunk)
    return tri_search(rays, ent, tabs, chunk)
