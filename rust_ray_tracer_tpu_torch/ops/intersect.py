"""Closest-hit intersection: the trace kernel's tables and the split
route's phase 1.

Counterpart of ``rust_ray_tracer_tpu/ops/intersect.py``:

  * the ``KIND_*`` and ``MATTR_*`` constants, ``_tri_coeffs``
    (``intersect.py:79``), ``_mat_attr_table`` (``:539``) and
    ``mattr_noise_cols`` (``:571``), which the whole-wave trace uses;
  * the split route (scenes the trace kernel cannot render): the phase-1
    candidates ``_sphere_roots`` / ``_sph_candidates`` (``:172-213``)
    and the medium free flight ``_med_t`` (``:249``, sphere, polytope and
    mesh boundaries); :func:`intersect_select` (``:578``): its unified branch
    (fewer than ``CLUSTER`` spheres and quads: TPU kernels K and M,
    ``ops/search.py``) or its per-kind branch (triangles by K and TPU
    kernel L, ``ops/search.py``; spheres by TPU kernel N from ``CLUSTER``
    rows up, ``ops/sphere.py``; quads by TPU kernel O, ``ops/quad.py``),
    media folded with strict ``<``, then the winner-row gathers;
    ``_sphere_uv`` (``:368``).
    ``intersect`` (``:777``) is :func:`intersect_select` followed by the
    hit attributes of TPU kernel J (``ops/hit.py``), or by TPU kernel F's
    whole bounce (``ops/bounce.py``); ``ops/integrator.bounce_split``
    runs them.

Vectors travel as ``[..., 3]`` tensors at the public functions, as in
JAX; inside, the arithmetic runs on components with the formulas and
operation order of the JAX code.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rust_ray_tracer_tpu_torch.models.scene import (MED_MESH, MED_POLY,
                                                    TEX_CHECKER, TEX_NOISE)
from rust_ray_tracer_tpu_torch.ops import gather
from rust_ray_tracer_tpu_torch.ops import quad as quad_ops
from rust_ray_tracer_tpu_torch.ops.shade_core import (_dot, _safe_div,
                                                      _safe_sqrt, _xyz)

TRI_DET_EPS = 1e-5      # triangle.rs:42 (scale-invariant form)
T_MIN = 1e-4            # ray.rs:89

# kind tags for the cross-kind argmin
KIND_NONE, KIND_TRI, KIND_SPH, KIND_QUAD, KIND_MED = 0, 1, 2, 3, 4

# column layout of the per-material attribute rows (_mat_attr_table);
# integer-valued columns travel as exact small floats
MATTR_MKIND = 0
MATTR_FUZZ = 1
MATTR_IOR = 2
MATTR_ALBEDO = slice(3, 6)     # solid leaf / checker base tex_color
MATTR_EVEN = slice(6, 9)       # checker leaves (only when the scene
MATTR_ODD = slice(9, 12)       # has checker textures; A grows 6 -> 13)
MATTR_ISCHK = 12


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


def _tri_coeffs(v0, e1, e2):
    """Four [10, T] coefficient matrices (det, u_num, v_num, t_num) over
    the Plücker ray features [o, d, o×d, 1], pre-scaled by 1/|e1×e2| so
    the determinant row gives det = -d·n̂ and the degeneracy test
    |det| > TRI_DET_EPS·|d| is a pure angle test. Zero-area pads keep
    det == 0 and never pass it."""
    n = _cross(e1, e2)
    nl = torch.sqrt(_sum3(n * n))[:, None]
    inv_n = 1.0 / torch.where(nl > 0, nl, torch.ones_like(nl))
    n = n * inv_n
    z = torch.zeros_like(v0)
    zs = torch.zeros_like(v0[:, 0])

    def col(o_c, d_c, m_c, one_c):
        return torch.cat([o_c.T, d_c.T, m_c.T, one_c[None, :]], dim=0)

    det = col(z, -n, z, zs)
    u_num = col(z, -_cross(e2, v0) * inv_n, e2 * inv_n, zs)
    v_num = col(z, -_cross(v0, e1) * inv_n, -e1 * inv_n, zs)
    t_num = col(n, z, z, -_sum3(v0 * n))
    return det, u_num, v_num, t_num


def _mat_attr_table(scene):
    """[n_mats, A] per-material attribute rows: kind, fuzz, ior, albedo
    (+ checker even/odd leaves and flag when the scene has checkers,
    + noise scale and flag when it has noise)."""
    f32 = scene.mat_fuzz.dtype
    tid = scene.mat_tex.long()
    cols = [scene.mat_kind.to(f32)[:, None], scene.mat_fuzz[:, None],
            scene.mat_ior[:, None], scene.tex_color[tid]]
    if scene.tex_even.shape[0] > 0:
        cols += [scene.tex_color[scene.tex_even.long()[tid]],
                 scene.tex_color[scene.tex_odd.long()[tid]],
                 (scene.tex_kind[tid] == TEX_CHECKER).to(f32)[:, None]]
    if scene.perlin_vec.shape[0] > 0:
        cols += [scene.tex_scale[tid][:, None],
                 (scene.tex_kind[tid] == TEX_NOISE).to(f32)[:, None]]
    return torch.cat(cols, dim=1)


def mattr_noise_cols(has_checker: bool):
    """(scale_col, is_noise_col) positions in the ``_mat_attr_table`` row:
    the noise block sits after the optional checker block."""
    base = 6 + (7 if has_checker else 0)
    return base, base + 1


# ---------------------------------------------------------------------------
# the split route: phase-1 candidates
# ---------------------------------------------------------------------------

def _sphere_roots(o, d, time, c0, c1, st0, st1, r):
    """Both quadratic roots and the time-lerped centre (sphere.rs:52-63,
    145-148): (root1, root2, disc_ok, centre). Component triples ``o``,
    ``d``, ``c0``, ``c1`` and the scalars broadcast (rays [..., 1] against
    spheres [..., S])."""
    frac = _safe_div(time - st0, st1 - st0)
    c = tuple(a + frac * (b - a) for a, b in zip(c0, c1))
    oc = tuple(x - y for x, y in zip(o, c))
    a = _dot(*d, *d)
    b = _dot(*oc, *d)
    cc = _dot(*oc, *oc) - r * r
    disc = b * b - a * cc
    ok = disc > 0.0
    sq = _safe_sqrt(disc)
    root1 = _safe_div(-b - sq, a)
    root2 = _safe_div(-b + sq, a)
    return root1, root2, ok, c


def _sph_candidates(scene, o, d, time, t_min, t_max):
    """[C] best (t, index) over the spheres (``intersect.py:192-213``, the
    XLA branch: fewer than ``CLUSTER`` spheres; from ``CLUSTER`` rows up
    the search is TPU kernel N, ``ops/sphere.py``)."""
    oc = tuple(x[:, None] for x in _xyz(o))
    dc = tuple(x[:, None] for x in _xyz(d))
    root1, root2, ok, _ = _sphere_roots(
        oc, dc, time[:, None], _xyz(scene.sph_c0[None]),
        _xyz(scene.sph_c1[None]), scene.sph_t0[None], scene.sph_t1[None],
        scene.sph_r[None])
    tmn, tmx = t_min[:, None], t_max[:, None]
    ok1 = ok & (root1 >= tmn) & (root1 <= tmx)
    ok2 = ok & (root2 >= tmn) & (root2 <= tmx)
    inf = torch.full_like(root1, torch.inf)
    # torch.min returns the lowest index attaining the min, as jnp.argmin
    return torch.min(torch.where(ok1, root1, torch.where(ok2, root2, inf)),
                     dim=-1)


def _med_t(scene, o, d, med_u, t_min, t_max):
    """Per-(ray, medium) stochastic scatter distance [C, M] (inf: none).

    ``intersect.py:249-348``: the boundary's entry/exit pair over (-inf,
    inf) — quadratic roots for a sphere, the half-space slab interval for
    a polytope, two closest-hit queries over its ``med_tri`` rows for a
    mesh — clamped to [t_min, t_max], then the exponential free flight
    ``neg_inv_d * log(max(u, 1e-30))`` through the length inside. Plain
    torch, as the JAX package leaves it to XLA.
    """
    oc = tuple(x[:, None] for x in _xyz(o))
    dc = tuple(x[:, None] for x in _xyz(d))
    zero = torch.zeros_like(scene.med_r)[None]
    root1, root2, ok, _ = _sphere_roots(
        oc, dc, torch.zeros_like(o[:, 0])[:, None], _xyz(scene.med_c[None]),
        _xyz(scene.med_c[None]), zero, torch.ones_like(zero),
        scene.med_r[None])
    if scene.med_pl_n.shape[1]:
        # convex polytope n.p <= d: den > 0 bounds t above (exit), den < 0
        # below (entry), den ~ 0 needs the origin inside; pad planes
        # (n = 0, d = 1) never constrain
        n = scene.med_pl_n[None]                        # [1, M, P, 3]
        doff = scene.med_pl_d[None]                     # [1, M, P]
        o4 = o[:, None, None, :]
        d4 = d[:, None, None, :]
        den = (n[..., 0] * d4[..., 0] + n[..., 1] * d4[..., 1]
               + n[..., 2] * d4[..., 2])                # [C, M, P]
        num = doff - (n[..., 0] * o4[..., 0] + n[..., 1] * o4[..., 1]
                      + n[..., 2] * o4[..., 2])
        par = den.abs() < 1e-12
        par_ok = ~par | (num >= 0.0)
        to = num / torch.where(par, torch.ones_like(den), den)
        t_ent = torch.where(~par & (den < 0), to,
                            torch.full_like(to, -torch.inf))
        t_exi = torch.where(~par & (den > 0), to,
                            torch.full_like(to, torch.inf))
        t1_p = t_ent.amax(dim=-1)                       # [C, M]
        t2_p = t_exi.amin(dim=-1)
        ok_p = par_ok.all(dim=-1) & (t1_p < t2_p) & torch.isfinite(t2_p)
        is_poly = (scene.med_kind == MED_POLY)[None]
        root1 = torch.where(is_poly, t1_p, root1)
        root2 = torch.where(is_poly, t2_p, root2)
        ok = torch.where(is_poly, ok_p, ok)
    if scene.med_tri.shape[1]:
        # triangle-mesh boundary (intersect.py:293-333): the entry/exit
        # pair is two closest-hit queries over the same triangles — hit1
        # over (-inf, inf), hit2 over (hit1 + 1e-4, inf) — each with the
        # triangle's facing rule (backface cull unless double-sided), so a
        # single-sided closed boundary finds no exit and no medium, as in
        # the reference. A dense Möller-Trumbore with the main path's
        # scale-invariant cutoff |det| / |n| > 1e-5 |d|
        mt = scene.med_tri[None]                        # [1, M, Tm, 10]
        v0, e1, e2, dbl = mt[..., 0:3], mt[..., 3:6], mt[..., 6:9], mt[..., 9]
        o4 = o[:, None, None, :]
        d4 = d[:, None, None, :]
        n = _cross(e1, e2)
        inv_n = 1.0 / torch.clamp_min(_safe_sqrt(_sum3(n * n)), 1e-30)
        pv = _cross(d4, e2)
        det = _sum3(e1 * pv) * inv_n                    # [C, M, Tm]
        eps = 1e-5 * _safe_sqrt(_sum3(d * d))[:, None, None]
        side_ok = (det > eps) | ((det < -eps) & (dbl > 0.5))
        inv = 1.0 / torch.where(det.abs() > eps, det, torch.ones_like(det))
        tv = o4 - v0
        u = _sum3(tv * pv) * inv_n * inv
        qv = _cross(tv, e1)
        v = _sum3(d4 * qv) * inv_n * inv
        t = _sum3(e2 * qv) * inv_n * inv
        valid = (side_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                 & (v < 1.0 - u))
        inf = torch.full_like(t, torch.inf)
        tt = torch.where(valid, t, inf)
        t1_m = tt.amin(dim=-1)                          # [C, M] hit1
        t2_m = torch.where(tt > t1_m[..., None] + 1e-4, tt, inf).amin(dim=-1)
        ok_m = (t1_m < torch.inf) & (t2_m < torch.inf)
        is_mesh = (scene.med_kind == MED_MESH)[None]
        root1 = torch.where(is_mesh, t1_m, root1)
        root2 = torch.where(is_mesh, t2_m, root2)
        ok = torch.where(is_mesh, ok_m, ok)
    t1 = torch.maximum(root1, t_min[:, None])
    # the t_max clamp only matters for a dead lane's collapsed window
    t2 = torch.minimum(root2, t_max[:, None])
    ok = ok & (t1 < t2)
    t1 = torch.clamp_min(t1, 0.0)
    ray_len = _safe_sqrt(_dot(*dc, *dc))
    dist_in = (t2 - t1) * ray_len
    # U in [0, 1); log(U) with U == 0 guarded
    hit_dist = scene.med_neg_inv_d[None] * torch.log(
        torch.clamp_min(med_u, 1e-30))
    ok = ok & (hit_dist <= dist_in)
    t = t1 + _safe_div(hit_dist, ray_len)
    return torch.where(ok, t, torch.full_like(t, torch.inf))


# ---------------------------------------------------------------------------
# the split route: phase 1 and the winner gathers
# ---------------------------------------------------------------------------

def winner_table(scene):
    """(uni [P, 11 + A], dflt [11 + A], (t_off, s_off, q_off)): the
    per-kind winner rows — pack(9) | flip | material id | material attrs —
    in tri/sphere/quad order, and the miss default (the first kind's pack
    row 0, flip and material 0, material 0's attrs): the unified table of
    ``intersect_select`` (``intersect.py:689-727``). Differentiable with
    respect to the scene."""
    f32 = scene.mat_fuzz.dtype
    matt = _mat_attr_table(scene)

    def kind_table(pack_cols, flip_col, mat_col):
        return torch.cat([pack_cols, flip_col.to(f32)[:, None],
                          mat_col.to(f32)[:, None], matt[mat_col.long()]],
                         dim=1)

    parts = []
    t_off = s_off = q_off = off = 0
    if scene.n_tris:
        t_off = off
        parts.append(kind_table(
            torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2], dim=1),
            scene.tri_flip, scene.tri_mat))
        off += scene.n_tris
    if scene.n_spheres:
        s_off = off
        parts.append(kind_table(
            torch.cat([scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
                       scene.sph_t1[:, None], scene.sph_r[:, None]], dim=1),
            scene.sph_flip, scene.sph_mat))
        off += scene.n_spheres
    if scene.n_quads:
        q_off = off
        parts.append(kind_table(
            torch.cat([scene.quad_q, scene.quad_u, scene.quad_v], dim=1),
            scene.quad_flip, scene.quad_mat))
        off += scene.n_quads
    zeros = torch.zeros(2, dtype=f32, device=matt.device)
    if not parts:           # media only: no primitive rows
        return (torch.zeros((0, 11 + matt.shape[1]), dtype=f32,
                            device=matt.device),
                torch.cat([torch.zeros(9, dtype=f32, device=matt.device),
                           zeros, matt[0]]), (0, 0, 0))
    uni = torch.cat(parts, dim=0)
    return uni, torch.cat([uni[0, :9], zeros, matt[0]]), (t_off, s_off, q_off)


class Select(NamedTuple):
    """The detached phase-1 winner and its gathered parameters
    (``intersect.py:515``)."""

    hit: torch.Tensor       # [C] bool
    kind: torch.Tensor      # [C] int32 (KIND_*)
    idx: torch.Tensor       # [C] int64, the index within its kind
    mat: torch.Tensor       # [C] int32 material id of the winner
    flip: torch.Tensor      # [C] bool
    pack: torch.Tensor      # [C, 9] the winner's unified parameter pack
    t_med: torch.Tensor     # [C] the chosen medium's scatter t
    t_min: torch.Tensor     # [C]
    t_max: torch.Tensor     # [C]
    attr: torch.Tensor      # [C, A] the winner's material attrs (MATTR_*)


def intersect_select(scene, o, d, time, tables, med_u=None, t_min=None,
                     t_max=None, chunk=None) -> Select:
    """Phase 1 and the winner gathers of the split route
    (``intersect_select``, ``intersect.py:578-775``). Phase 1 takes one of
    JAX's two branches:

      * the unified one (``:612-642``) when ``ops/search.unified`` holds
        (any primitive rows, fewer than ``CLUSTER`` spheres and fewer than
        ``CLUSTER`` quads): TPU kernel K (the tile-cluster entries, when
        the scene has triangles) and TPU kernel M (triangles, spheres and
        quads in one search, a tie going triangle > sphere > quad), by
        ``ops/search.search`` with 256-ray tiles that restart at each
        ``chunk``'s first ray (the whole input is one chunk when None);
        from ``ops/search.PACKED_MIN_TRIS`` triangles on, the rays of each
        chunk sorted first (``ops/search.search_order``, JAX's
        ``_search_order``: dead last, then octant and Morton order) and M
        reading the triangles packed (``tables.search``), the same winners
        as the staged input's;
      * otherwise (``intersect.py:640-653``) triangles (K's entries and
        TPU kernel L, ``ops/search.tri_candidates``), spheres (TPU kernel
        N from ``CLUSTER`` rows up, ``ops/sphere.sph_search``; plain torch
        below) and quads (TPU kernel O, ``ops/quad.py``) fold with strict
        ``<`` in that order, so a tie keeps the earlier kind.

    Media (``_med_t``, uniforms ``med_u`` [C, M]) fold last with strict
    ``<``, so a tie keeps the earlier kind; then one gather from the
    unified table. Miss and medium lanes take the first kind's row 0 as
    their pack and material 0's attrs (a medium its own material's).

    ``tables`` (``ops/integrator.SplitTables``) gives ``uni``, ``dflt``,
    ``t_off``, ``s_off``, ``q_off`` (:func:`winner_table`), ``med_rows``
    [M, 2 + A] (a medium winner's flip | material id | attrs), ``unified``
    (which branch), ``search`` (the search tables of the unified branch,
    or of L on the other; None without triangles there), ``sph`` and
    ``sph_boxes`` (N's table and sub-boxes; None below ``CLUSTER`` sphere
    rows) and ``quads`` (O's table).

    Phase 1 (the search, the fold) runs under ``no_grad``, as JAX's runs on
    stop-gradient copies; phase 2 is differentiable: the gathers from
    ``uni``, ``dflt`` and ``med_rows``, and (under grad) the chosen
    medium's distance recomputed from the scene, the rays and the detached
    uniforms ``med_u``. The selection (kind, idx, hit, mat, flip) carries
    no gradient."""
    c = o.shape[0]
    f32 = o.dtype
    dev = o.device
    if t_min is None:
        t_min = torch.full((c,), T_MIN, dtype=f32, device=dev)
    if t_max is None:
        t_max = torch.full((c,), torch.inf, dtype=f32, device=dev)
    best_t = torch.full((c,), torch.inf, dtype=f32, device=dev)
    best_kind = torch.zeros((c,), dtype=torch.int32, device=dev)
    best_idx = torch.zeros((c,), dtype=torch.int64, device=dev)

    def consider(kind, t_cand, idx):
        nonlocal best_t, best_kind, best_idx
        better = t_cand < best_t
        best_t = torch.where(better, t_cand, best_t)
        best_kind = torch.where(better, kind, best_kind)
        best_idx = torch.where(better, idx.long(), best_idx)

    # ---- phase 1: the detached candidate search --------------------------
    with torch.no_grad():
        # the searches through their modules, so a check can swap the
        # dispatchers (those modules import this one)
        from rust_ray_tracer_tpu_torch.ops import search as search_ops
        from rust_ray_tracer_tpu_torch.ops import sphere as sphere_ops
        rays = search_ops.ray_planes(o, d, time, t_min, t_max)
        if tables.unified:
            # K and M; from PACKED_MIN_TRIS triangles on the rays sorted
            # first (intersect.py:626-636), the winners in the rays' order
            perm = (search_ops.search_order(rays, tables.search, chunk)
                    if scene.n_tris >= search_ops.PACKED_MIN_TRIS else None)
            best_t, best_kind, idx = search_ops.search(rays, tables.search,
                                                       chunk, perm)
            best_idx = idx.long()
        else:
            if scene.n_tris:
                consider(KIND_TRI, *search_ops.tri_candidates(
                    rays, tables.search, chunk))
            if tables.sph is not None:
                consider(KIND_SPH, *sphere_ops.sph_search(
                    rays, tables.sph, scene.sph_cluster_min,
                    scene.sph_cluster_max, scene.n_spheres, chunk,
                    tables.sph_boxes))
            elif scene.n_spheres:
                consider(KIND_SPH, *_sph_candidates(scene, o, d, time, t_min,
                                                    t_max))
            if scene.n_quads:
                # through the module, so a check can swap the dispatcher
                consider(KIND_QUAD, *quad_ops.quad_search(
                    scene, o, d, t_min, t_max, tables.quads))
        if scene.n_media:
            t_med, i_med = torch.min(_med_t(scene, o, d, med_u, t_min,
                                            t_max), dim=-1)
            consider(KIND_MED, t_med, i_med)
        hit = torch.isfinite(best_t)
        kind = torch.where(hit, best_kind, KIND_NONE).to(torch.int32)
        idx_u = torch.zeros_like(best_idx)
        prim = torch.zeros_like(hit)
        for kd, off in ((KIND_TRI, tables.t_off), (KIND_SPH, tables.s_off),
                        (KIND_QUAD, tables.q_off)):
            is_k = kind == kd
            idx_u = torch.where(is_k, best_idx + off, idx_u)
            prim = prim | is_k
        is_med = kind == KIND_MED
        i_row = torch.where(is_med, best_idx, 0)

    # ---- phase 2: the winner-row gathers, differentiable in the tables --
    ext = tables.dflt[9:].expand(c, -1)
    pack = tables.dflt[:9].expand(c, -1)
    if tables.uni.shape[0]:
        rows = gather.rows(tables.uni, idx_u)
        pack = rows[:, :9]
        ext = torch.where(prim[:, None], rows[:, 9:], ext)
    t_med_best = torch.zeros((c,), dtype=f32, device=dev)
    if scene.n_media:
        ext = torch.where(is_med[:, None], gather.rows(tables.med_rows,
                                                        i_row), ext)
        # the chosen medium's distance again, differentiable
        # (intersect.py:660-663); its value is phase 1's. One pick per
        # row: its backward adds into distinct entries, in any order alike
        t_med_best = (torch.gather(_med_t(scene, o, d, med_u, t_min, t_max),
                                   1, i_med[:, None])[:, 0]
                      if torch.is_grad_enabled() else t_med)
    return Select(hit=hit, kind=kind, idx=best_idx,
                  mat=ext[:, 1].to(torch.int32), flip=ext[:, 0] > 0.5,
                  pack=pack, t_med=t_med_best, t_min=t_min, t_max=t_max,
                  attr=ext[:, 2:])


def _sphere_uv(p_unit):
    """Spherical UV from a point on the unit sphere (sphere.rs:34-40,
    ``intersect.py:368``): (u, v) of [..., 3]."""
    y = torch.clamp(-p_unit[..., 1], -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(y)
    x = p_unit[..., 0]
    z = p_unit[..., 2]
    degen = (x.abs() < 1e-12) & (z.abs() < 1e-12)
    x = torch.where(degen, torch.full_like(x, 1e-12), x)
    phi = torch.atan2(-z, x) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi
