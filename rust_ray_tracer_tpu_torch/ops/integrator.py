"""Sample-wave accumulation: the renderer's entry points.

Counterpart of ``rust_ray_tracer_tpu/ops/integrator.py``
(``render_waves`` and ``render_image``, ``integrator.py:545-622``) on two
routes, chosen per scene as the JAX package chooses on the TPU:

  * the whole-wave trace (:func:`ops.uber.trace_wave_uber`) for every
    scene the trace kernel takes (``ops/uber.uber_eligible``): the Hopper
    trace kernel for a scene on a CUDA device, its plain version on the
    CPU. That render is differentiable: the scene tables are built inside
    the autograd graph, and when a scene leaf requires grad each wave's
    trace runs as :class:`ops.uber.TraceWave`, whose backward is the
    trace's adjoint (a second kernel on the card);
  * the split route (:func:`render_chunk` over a wave's chunks) for the
    others it can take (:func:`split_reason`): media, image textures, noise beside
    checker textures, meshes and other tables past the trace kernel's
    4,096 rows. It is ``trace_rays`` -> ``_bounce``
    (``integrator.py:63-132``), run on the whole wave at once. Each
    bounce's phase 1 (``ops/intersect.intersect_select``) takes JAX's
    unified branch when the scene has fewer than ``CLUSTER`` spheres and
    quads — TPU kernels K (the tiles' cluster entries) and M (triangles,
    spheres and quads in one search, ``ops/search.py``) — and otherwise
    searches each kind apart: triangles with K and TPU kernel L, spheres
    with TPU kernel N from ``CLUSTER`` rows up (in torch below), quads
    with TPU kernel O; media fold in with ``_med_t`` (sphere, polytope
    and mesh boundaries). Then, on ``pallas_bounce.eligible``'s scenes (no
    noise or image leaf, at most 8 lights), TPU kernel F runs the whole
    rest of the bounce: hit attributes, the checker select, shading and
    the estimator update (``ops/bounce.bounce_fused``). On the others TPU
    kernel J computes the winners' hit attributes and ``texture_value``
    evaluates the albedo in torch; then, with at most 8 lights, TPU
    kernel H shades and updates the estimator (the ``su_eligible``
    branch), and with 9 or more (glTF point lights) the plain tail of
    ``_bounce`` (``integrator.py:121-131``) runs: TPU kernel I shades
    (``ops/shade.shade``) and torch updates the estimator. That render is
    differentiable too: the split tables are built inside the autograd
    graph, phase 2 of the intersection (the winner-row gathers, the chosen
    medium's distance), the texture and the tail's update run as torch
    autograd, and F, J, H and I run as autograd functions whose backward
    kernels are F', J', H' and I' (``ops/bounce.BouncePlanes``,
    ``ops/hit.HitPlanes``, ``ops/bounce.ShadeUpdate``,
    ``ops/shade.ShadeFused``). Phase 1 (K, M, L, N, O) is detached, as in
    JAX.

With ``compact=True`` (:func:`trace_wave_compact`, JAX's ``:425-526``)
every scene takes the split route's bounce, the trace kernel's too: each
bounce runs on the wave's live rays only, packed to the front across all
its chunks. :func:`auto_compact` is JAX's rule for when to ask for it.

With ``RRT_UBER_WAVE=0`` the trace kernel's scenes take the per-chunk
path instead (:func:`render_chunk` over the wave's chunks, TPU kernel D a
bounce; ``integrator.py:568-570``), and with ``RRT_NO_UBER_FUSED=1`` too
each bounce there runs TPU kernels E and G (``ops/uber.unfused_bounce``).

Every per-lane step is independent of how the lanes are batched (the
search's 256-ray tiles restart at each chunk, as JAX's per-chunk calls
do), and each lane's randoms are drawn from its (chunk, lane) as the JAX
package draws them, so either route's image depends only on (seed,
chunk_size).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from rust_ray_tracer_tpu_torch.models.scene import (CLUSTER, MED_MESH,
                                                    MED_POLY, MED_SPHERE)
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops import search as search_ops
from rust_ray_tracer_tpu_torch.ops import sphere as sphere_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.bounce import (bounce_fused,
                                                  fused_eligible, light_table,
                                                  shade_update_fused,
                                                  su_eligible)
from rust_ray_tracer_tpu_torch.ops.hit import hit_attrs_fused
from rust_ray_tracer_tpu_torch.ops.intersect import (
    MATTR_FUZZ, MATTR_IOR, MATTR_MKIND, _mat_attr_table, intersect_select,
    winner_table)
from rust_ray_tracer_tpu_torch.ops.quad import quad_table
from rust_ray_tracer_tpu_torch.ops.shade import shade
from rust_ray_tracer_tpu_torch.ops.texture import texture_value
from rust_ray_tracer_tpu_torch.utils import rng as rngu

MAX_DEPTH = 4   # main.rs:56


def split_reason(scene) -> str | None:
    """Why the split route cannot render ``scene``, or None when it can.
    On the card it refuses more lights than kernel I' holds in a block's
    shared memory (``kernels.shade_max_lights``, which asks the built
    library: 3,892, the light table beside I''s light-major stages); the
    plain versions on the CPU take any count, as the JAX package's XLA
    route does."""
    if scene.device.type != "cuda":
        return None
    from rust_ray_tracer_tpu_torch.kernels import shade_max_lights
    most = shade_max_lights()
    if scene.n_lights > most:
        return (f"{scene.n_lights} lights: the shade kernels on the card "
                f"take at most {most} (kernel I' holds the light table in "
                "a block's shared memory)")
    return None


@dataclasses.dataclass
class SplitTables:
    """Scene-derived tables of the split route, built once per render
    inside the autograd graph (but the search tables, which only the
    detached phase 1 reads). ``uni``/``dflt``/offsets from
    ``ops/intersect.winner_table``; ``med_rows`` [M, 2 + A] a medium
    winner's flip | material id | attrs; ``unified`` whether phase 1
    takes the unified search (``ops/search.unified``); ``search`` its
    tables (packed rows from ``ops/search.PACKED_MIN_TRIS`` triangles on),
    or on the per-kind branch kernel L's (``ops/search.search_tables``,
    compact rows; None there without triangles); ``sph`` kernel N's
    table (``ops/sphere.sph_table``; None below ``CLUSTER`` sphere rows
    or on the unified branch) and ``sph_boxes`` its sub-boxes
    (``ops/sphere.sph_boxes``; None with it); ``quads`` [Q, 9] kernel O's
    table; ``lt`` [n_lights + 1, LT_COLS] the lights, the background
    last; ``fused``
    whether kernel F runs the bounce (``ops/bounce.fused_eligible``);
    ``su`` whether, without F, kernel H does (``ops/bounce.su_eligible``),
    else kernel I and torch's update (``_bounce``'s plain tail)."""

    uni: torch.Tensor
    dflt: torch.Tensor
    t_off: int
    s_off: int
    q_off: int
    med_rows: torch.Tensor
    unified: bool
    search: search_ops.SearchTables | None
    sph: torch.Tensor | None
    sph_boxes: torch.Tensor | None
    quads: torch.Tensor
    lt: torch.Tensor
    fused: bool
    su: bool


def make_split_tables(scene) -> SplitTables:
    """Tables of the split route (differentiable in the scene, as
    ``uber.make_ctx``'s); raises NotImplementedError for a scene it cannot
    render."""
    reason = split_reason(scene)
    if reason is not None:
        raise NotImplementedError(reason)
    uni, dflt, (t_off, s_off, q_off) = winner_table(scene)
    matt = _mat_attr_table(scene)
    med_rows = torch.cat(
        [torch.zeros((scene.n_media, 1), dtype=matt.dtype,
                     device=matt.device),
         scene.med_mat.to(matt.dtype)[:, None],
         matt[scene.med_mat.long()]], dim=1)
    with torch.no_grad():
        quads = quad_table(scene)
    unified = search_ops.unified(scene)
    sph_n = not unified and scene.n_spheres >= CLUSTER
    return SplitTables(
        uni=uni, dflt=dflt, t_off=t_off, s_off=s_off, q_off=q_off,
        med_rows=med_rows, unified=unified,
        # the unified search takes the packed input from PACKED_MIN_TRIS
        # triangles on (no [10, T] temporaries); L always the staged one
        search=(search_ops.search_tables(scene, None if unified else False)
                if unified or scene.n_tris else None),
        sph=sphere_ops.sph_table(scene) if sph_n else None,
        sph_boxes=sphere_ops.sph_boxes(scene) if sph_n else None,
        quads=quads, lt=light_table(scene),
        fused=fused_eligible(scene), su=su_eligible(scene))


def bounce_split(scene, st, rnd_b, tables: SplitTables, chunk=None):
    """One bounce of every ray of ``st`` [14, N] (state planes) with the
    randoms ``rnd_b`` [15 + M, N]: the next state. ``_bounce``
    (``integrator.py:63-132``): ``intersect_select`` (phase 1 — K and M,
    or K and L, N or the sphere search, and O — and the winner gathers),
    then kernel F on ``tables.fused`` scenes, else kernel J and
    ``texture_value``, then kernel H on ``tables.su`` scenes, else kernel I
    and :func:`update_plain`; differentiable in ``st`` and the tables (F',
    or J' and H' or I', in the backward). ``chunk`` rays a chunk (the
    search's tiles restart at each; None: one chunk). A dead lane gets the
    collapsed window t_max = -1, so it finds nothing and stays as it
    is."""
    o, d, time = st[0:3].T, st[3:6].T, st[6]
    alive = st[7] > 0.5
    t_max = torch.where(alive, torch.inf, -1.0).to(st.dtype)
    med_u = rnd_b[15:].T if scene.n_media else None
    sel = intersect_select(scene, o, d, time, tables, med_u, t_max=t_max,
                           chunk=chunk)
    if tables.fused:
        return bounce_fused(st, sel, rnd_b, tables.lt, scene.n_lights,
                            scene.tex_even.shape[0] > 0)
    _, p, nrm, u, v, planes = hit_attrs_fused(
        o, d, time, sel.t_min, sel.t_max, sel.kind, sel.flip, sel.pack,
        sel.t_med)
    if not tables.su:
        n = scene.n_lights
        sc = shade(scene, d, p, nrm, u, v, sel.mat, sel.attr, rnd_b,
                   tables.lt[:n])
        return update_plain(st, sel.hit, p, sc, tables.lt[n, 0:3])
    albedo = texture_value(scene, scene.mat_tex[sel.mat.long()], u, v, p)
    return shade_update_fused(
        st, sel.hit, planes, albedo.T, sel.attr[:, MATTR_FUZZ],
        sel.attr[:, MATTR_IOR], sel.attr[:, MATTR_MKIND].to(torch.int32),
        rnd_b, tables.lt, scene.n_lights)


def update_plain(st, hit, p, sc, background):
    """The next state [14, N] of ``st`` [14, N] (o, d, time, alive, L,
    beta) after the shading ``sc`` (``ops/shade.Scatter``) of the rays
    that ``hit`` [N] bool at ``p`` [N, 3]: the tail of ``_bounce``
    (``integrator.py:121-131``) as torch ops. A live miss adds ``beta *
    background``, a live hit ``beta * emitted`` and multiplies beta by the
    weight; a hit whose material scatters moves to ``p`` along the new
    direction, the others stop."""
    o, d, L, beta = st[0:3], st[3:6], st[8:11], st[11:14]
    alive = st[7] > 0.5
    zero = torch.zeros_like(L)
    miss = alive & ~hit
    live = alive & hit
    L = L + torch.where(miss, beta * background[:, None], zero)
    L = L + torch.where(live, beta * sc.emitted.T, zero)
    beta = torch.where(live, beta * sc.weight.T, beta)
    alive2 = live & sc.alive
    o = torch.where(alive2, p.T, o)
    d = torch.where(alive2, sc.direction.T, d)
    return torch.cat([o, d, st[6:7], alive2.to(st.dtype)[None], L, beta])


def trace_prep(scene):
    """The tables :func:`trace_rays` renders ``scene`` with, built once
    per render (inside the autograd graph): ``ops/uber.make_ctx``'s on
    the trace kernel's scenes, else :func:`make_split_tables`'s."""
    if uber.uber_eligible(scene):
        return uber.make_ctx(scene)
    return make_split_tables(scene)


def trace_rays(scene, o, d, time, keys, depth: int = MAX_DEPTH, prep=None):
    """Trace the rays of one or more whole chunks to completion: radiance
    [K, C, 3] of the camera rays ``o``, ``d`` [K, C, 3], ``time`` [K, C]
    whose chunks' CHUNK-stream keys are ``keys`` [K, 2].

    Counterpart of ``trace_rays`` (``integrator.py:358-393``) and, on the
    trace kernel's scenes, ``_trace_rays_uber`` (``:303-355``): each
    chunk's ``depth`` bounces of randoms are drawn at once, keyed by
    (chunk key, bounce) as JAX draws them (its ``RRT_UBER_XRND=1`` hoist,
    bitwise the per-bounce draw), so the image depends only on (seed,
    chunk_size). Uber-eligible scenes run ``depth`` launches of TPU kernel
    D (``ops/uber.bounce_uber``) over all the chunks' lanes, each chunk
    padded to a multiple of 1024 dead lanes; the others run the split
    route's :func:`bounce_split` on the same lanes unpadded, as JAX's
    ``trace_rays`` falls back to ``_bounce``. JAX's chunk-level
    ``lax.cond(any(alive))`` (``:132``) is the identity on a dead chunk:
    D passes dead rows through, so no host sync decides it. ``prep``:
    :func:`trace_prep`'s tables (built here if None)."""
    if prep is None:
        prep = trace_prep(scene)
    k, c = o.shape[:2]
    st = uber.chunk_state(o, d, time)                        # [14, K, Cp]
    if isinstance(prep, uber.TraceCtx):
        cp = st.shape[-1]
        rnd = uber.chunk_randoms(scene, keys, c, depth, cp)
        st = st.reshape(uber.N_STATE, -1)
        for b in range(depth):
            st = uber.bounce_uber(scene, rnd[b], st, prep)
        L = st[8:11].reshape(3, k, cp)[:, :, :c]
    else:
        st = st[:, :, :c].reshape(uber.N_STATE, -1)
        rnd = uber.chunk_randoms(scene, keys, c, depth)
        for b in range(depth):
            st = bounce_split(scene, st, rnd[b], prep, c)
        L = st[8:11].reshape(3, k, c)
    return L.permute(1, 2, 0)


class _Permute(torch.autograd.Function):
    """``x[:, idx]`` for a permutation ``idx`` [N] of the columns of ``x``
    [R, N]; the backward gathers the cotangent's columns by ``inv``, the
    inverse permutation, so neither pass adds into a column (indexing's
    own backward would scatter-add)."""

    @staticmethod
    def forward(fctx, x, idx, inv):
        fctx.save_for_backward(inv)
        return x[:, idx]

    @staticmethod
    def backward(fctx, g):
        inv, = fctx.saved_tensors
        return g[:, inv], None, None


def trace_wave_compact(scene, wkey, width: int, height: int,
                       depth: int = MAX_DEPTH, chunk_size: int = 32768,
                       chunk_ids=None, proc_chunk: int | None = None,
                       prep=None, stats: list | None = None):
    """One sample wave with cross-chunk alive compaction: the radiance
    rows [len(chunk_ids) * chunk_size, 3] of the chunks ``chunk_ids``
    (default: the whole wave) in chunk-major order, the pad tail
    included. Counterpart of ``trace_wave_compact``
    (``integrator.py:425-526``).

    The bounces run wave-major on the split route
    (:func:`bounce_split`, whatever the scene). Before each bounce the
    rays are stably partitioned alive-first over all the chunks (pad lanes
    past ``width * height`` ride along alive, as in JAX), the live count
    is read on the host (the bounce's one synchronisation) and the bounce
    runs on the leading ``ceil(n_alive / proc_chunk) * proc_chunk`` lanes
    only, ``proc_chunk`` (default ``chunk_size``) rays a search chunk; the
    dead tail passes through untouched, as JAX's ``lax.cond`` skips a dead
    processing chunk. A bounce with no live ray ends the wave. Each ray's
    randoms are gathered from its original (chunk, lane)
    (``uber.chunk_randoms`` over the chunks' CHUNK-stream keys, JAX's
    ``_wave_bounce_randoms``, ``:396``) and every per-lane step is
    independent of the lane's position, so the image is the per-chunk
    split route's and does not depend on ``proc_chunk``, which must
    divide the padded ray count (ValueError otherwise). The permutations
    are gathers both ways (:class:`_Permute`): the gradients are bitwise
    repeatable and differ from the per-chunk route's by summation order
    only.

    ``prep``: :func:`make_split_tables`' tables (built here if None).
    ``stats``: a list to which each bounce appends ``{"bounce",
    "n_alive", "lanes", "sync_ms"}`` (its live rays, the lanes it ran and
    the host's milliseconds blocked reading the live count)."""
    n = width * height
    dev = wkey.device
    if chunk_ids is None:
        chunk_ids = torch.arange(-(-n // chunk_size), device=dev)
    chunk_ids = torch.as_tensor(chunk_ids, dtype=torch.int64,
                                device=dev).reshape(-1)
    n_pad = chunk_ids.shape[0] * chunk_size
    pc = proc_chunk or chunk_size
    if n_pad % pc:
        raise ValueError(f"proc_chunk {pc} must divide the wave's padded "
                         f"ray count {n_pad}")
    if prep is None:
        prep = make_split_tables(scene)
    o, d, t, ckey = cam_ops.camera_rays_for_chunks(
        scene.camera, wkey, chunk_ids, chunk_size, width, height)
    st = uber.chunk_state(o, d, t)[:, :, :chunk_size].reshape(
        uber.N_STATE, n_pad)
    rnd = uber.chunk_randoms(scene, rngu.stream(ckey, rngu.CHUNK),
                             chunk_size, depth)
    lane = torch.arange(n_pad, device=dev)
    rid = lane                       # each lane's ray: its original lane
    for b in range(depth):
        alive = st[7] > 0.5
        t0 = time.perf_counter()
        n_alive = int(alive.sum())
        lanes = min(n_pad, -(-n_alive // pc) * pc)
        if stats is not None:
            stats.append({"bounce": b, "n_alive": n_alive, "lanes": lanes,
                          "sync_ms": (time.perf_counter() - t0) * 1e3})
        if not n_alive:
            break
        if n_alive < n_pad:
            # the stable alive-first partition: perm gathers, dest (each
            # lane's new place) is its inverse
            perm = torch.sort(~alive, stable=True).indices
            live = torch.cumsum(alive, 0)
            dest = torch.where(alive, live - 1, n_alive + lane - live)
            st = _Permute.apply(st, perm, dest)
            rid = rid[perm]
        head = bounce_split(scene, st[:, :lanes], rnd[b][:, rid[:lanes]],
                            prep, pc)
        st = head if lanes == n_pad else torch.cat([head, st[:, lanes:]],
                                                   dim=1)
    # back to chunk-major order: a gather by the inverse of rid
    out = _Permute.apply(st[8:11], torch.argsort(rid), rid)
    return out.T


def auto_compact(scene, threshold: float = 0.3) -> bool:
    """Should a render of ``scene`` take the compact wavefront? On a CUDA
    device never: measured on an H100 (PERF.md, the compact wavefront's
    findings) compact wins no time on any scene. On A's scenes it loses
    1.1-10x; on the split route's (final_scene, random with the earth
    map) its forward and training times against the scene's own route
    change sign from run to run, because the split route's waves are host
    glue paid per launch, not per live lane. Its images are bitwise the
    own route's there, and its one gain, less peak memory a training step,
    the forward-only CLI does not use. On the CPU, JAX's host-side rule
    (``integrator.auto_compact``, ``:135-300``) in numpy: yes when at
    least ``threshold`` of a 32x18 grid of pixel-centre primaries hit
    something (spheres, quads, medium boundaries, triangles: exact tests
    up to 65,536 triangles, the cluster boxes beyond), since a hit usually
    survives its bounce and a miss dies. Reads the scene's values on the
    host; callers resolve it once and pass a bool down (``utils/cli.py``'s
    ``--compact auto``). ``render_waves(..., compact=True)`` still takes
    the route on the card when asked."""
    if scene.device.type == "cuda":
        return False

    def f64(x):
        return x.detach().cpu().numpy().astype(np.float64)

    cam = scene.camera
    c2w = f64(cam.c2w)                             # [3, 4] (R | t)
    scale = float(cam.scale)
    aspect = float(cam.aspect)
    eye = c2w[:, 3]
    gw, gh = 32, 18
    fx = (2.0 * (np.arange(gw) + 0.5) / gw - 1.0) * scale * aspect
    fy = (2.0 * (np.arange(gh) + 0.5) / gh - 1.0) * scale
    px, py = np.meshgrid(fx, fy)
    pc = np.stack([px.ravel(), py.ravel(), -np.ones(gw * gh)], 1)
    d = pc @ c2w[:, :3].T                          # unnormalized dirs
    o = np.broadcast_to(eye, d.shape)
    hit = np.zeros(d.shape[0], bool)
    tmin = 1e-4

    def sphere_hit(c, r):
        oc = o - c
        a = (d * d).sum(1)
        b = (oc * d).sum(1)
        cc = (oc * oc).sum(1) - r * r
        disc = b * b - a * cc
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        return ok & (((-b - sq) / a >= tmin) | ((-b + sq) / a >= tmin))

    def box_hit(lo, hi):                           # [K, 3] boxes -> [R, K]
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        t0 = (lo[None] - o[:, None]) * inv[:, None]
        t1 = (hi[None] - o[:, None]) * inv[:, None]
        tn = np.minimum(t0, t1).max(2)
        tf = np.maximum(t0, t1).min(2)
        return (tf >= np.maximum(tn, tmin)) & (tf >= tmin)

    if scene.n_spheres:
        c0, r = f64(scene.sph_c0), f64(scene.sph_r)
        for i in np.nonzero(r > 0)[0]:
            hit |= sphere_hit(c0[i], r[i])
    if scene.n_media:
        mc, mr = f64(scene.med_c), f64(scene.med_r)
        kinds = scene.med_kind.cpu().numpy()
        for i in np.nonzero((kinds == MED_SPHERE) & (mr > 0))[0]:
            hit |= sphere_hit(mc[i], mr[i])
        if scene.med_pl_n.shape[1]:
            # convex-polytope boundaries: _med_t's half-space interval
            pn, pd = f64(scene.med_pl_n), f64(scene.med_pl_d)
            for i in np.nonzero(kinds == MED_POLY)[0]:
                den = d @ pn[i].T                          # [R, P]
                num = pd[i][None] - o @ pn[i].T
                par = np.abs(den) < 1e-12
                par_ok = (~par | (num >= 0)).all(1)
                to = num / np.where(par, 1.0, den)
                t1 = np.where(~par & (den < 0), to, -np.inf).max(1)
                t2 = np.where(~par & (den > 0), to, np.inf).min(1)
                hit |= par_ok & (t1 < t2) & np.isfinite(t2) & (t2 >= tmin)
        if scene.med_tri.shape[1]:
            # triangle-mesh boundaries: the box of the real triangles
            for i in np.nonzero(kinds == MED_MESH)[0]:
                mt = f64(scene.med_tri[i])                 # [Tm, 10]
                real = (np.abs(mt[:, 3:6]).sum(1)
                        + np.abs(mt[:, 6:9]).sum(1)) > 0
                if not real.any():
                    continue
                corners = np.concatenate(
                    [mt[real, 0:3], mt[real, 0:3] + mt[real, 3:6],
                     mt[real, 0:3] + mt[real, 6:9]])
                hit |= box_hit(corners.min(0)[None],
                               corners.max(0)[None])[:, 0]
    if scene.n_quads:
        q, u, v = f64(scene.quad_q), f64(scene.quad_u), f64(scene.quad_v)
        nq = np.cross(u, v)                            # [Q, 3]
        denom = d @ nq.T                               # [R, Q]
        dsafe = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t = ((q[None] - o[:, None]) * nq[None]).sum(2) / dsafe
        w = o[:, None] + t[..., None] * d[:, None] - q[None]
        n2 = np.maximum((nq * nq).sum(1), 1e-12)
        alpha = (np.cross(w, v[None]) * nq[None]).sum(2) / n2
        beta = (np.cross(u[None], w) * nq[None]).sum(2) / n2
        ok = ((np.abs(denom) > 1e-12) & (t >= tmin)
              & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
        hit |= ok.any(1)
    if scene.n_tris:
        if scene.n_tris <= 65536:
            v0, e1, e2 = (f64(scene.tri_v0), f64(scene.tri_e1),
                          f64(scene.tri_e2))
            real = (np.abs(e1).sum(1) + np.abs(e2).sum(1)) > 0
            v0, e1, e2 = v0[real], e1[real], e2[real]
            for s in range(0, v0.shape[0], 1024):
                vv, ee1, ee2 = v0[s:s + 1024], e1[s:s + 1024], e2[s:s + 1024]
                p = np.cross(d[:, None], ee2[None])        # [R, B, 3]
                det = (ee1[None] * p).sum(2)
                inv = 1.0 / np.where(np.abs(det) < 1e-12, 1e-12, det)
                tv = o[:, None] - vv[None]
                uu = (tv * p).sum(2) * inv
                qv = np.cross(tv, ee1[None])
                vv_ = (d[:, None] * qv).sum(2) * inv
                tt = (ee2[None] * qv).sum(2) * inv
                ok = ((np.abs(det) > 1e-12) & (uu >= 0) & (uu <= 1)
                      & (vv_ >= 0) & (uu + vv_ <= 1) & (tt >= tmin))
                hit |= ok.any(1)
        else:
            lo = f64(scene.tri_cluster_min)
            hi = f64(scene.tri_cluster_max)
            ok = (lo <= hi).all(1)
            hit |= box_hit(lo[ok], hi[ok]).any(1)
    return float(hit.mean()) >= threshold


def render_chunk(scene, wkey, chunk_ids, chunk_size: int, width: int,
                 height: int, depth: int = MAX_DEPTH, prep=None):
    """Radiance [len(chunk_ids), chunk_size, 3] of the global pixel
    chunks ``chunk_ids`` [K] of one sample wave — the unit of work of the
    sharded renderer (``integrator.render_chunk``, ``:529-542``). All
    randomness derives from (wave key, global chunk id), so which rank or
    call computes a chunk never changes its value; ids past the last chunk
    (the sharded renderer's pad) render the last chunk's pixels with their
    own keys. ``prep``: :func:`trace_prep`'s tables."""
    chunk_ids = torch.as_tensor(chunk_ids, dtype=torch.int64,
                                device=wkey.device).reshape(-1)
    o, d, t, ckey = cam_ops.camera_rays_for_chunks(
        scene.camera, wkey, chunk_ids, chunk_size, width, height)
    return trace_rays(scene, o, d, t, rngu.stream(ckey, rngu.CHUNK), depth,
                      prep)


def render_waves(scene, width: int, height: int, key, wave_start: int,
                 n_waves: int, depth: int = MAX_DEPTH,
                 chunk_size: int = 32768, acc0=None, compact: bool = False,
                 proc_chunk: int | None = None):
    """Sum of ``n_waves`` one-sample-per-pixel radiance images added onto
    ``acc0`` (zeros if None), [H, W, 3] on the scene's device.

    Wave w uses ``fold_in(key, w)``, and the waves are added in the order
    ``(((acc0 + w0) + w1) + ...)``, so continuing from a partial sum with
    ``wave_start=k`` reproduces the monolithic sum bitwise. ``compact``
    runs each wave through :func:`trace_wave_compact` (``proc_chunk`` its
    processing chunk), bypassing the trace kernel as JAX does: the same
    image. Raises NotImplementedError for a scene neither route can
    render.
    """
    n = width * height
    key = key.to(scene.device)
    prep = make_split_tables(scene) if compact else trace_prep(scene)
    if compact:
        def wave_rows(wkey):
            return trace_wave_compact(scene, wkey, width, height, depth,
                                      chunk_size, proc_chunk=proc_chunk,
                                      prep=prep)
    # RRT_UBER_WAVE=0 renders the trace kernel's scenes chunk by chunk
    # through render_chunk, as JAX does (integrator.py:568-570); like JAX,
    # RRT_NO_UBER_FUSED=1 alone leaves them on the whole-wave kernel A
    # (a reference defect, ADVICE.md:4, mirrored)
    elif isinstance(prep, uber.TraceCtx) and os.environ.get(
            "RRT_UBER_WAVE", "") != "0":
        def wave_rows(wkey):
            return uber.trace_wave_uber(scene, wkey, width, height, depth,
                                        chunk_size, ctx=prep)
    else:
        k = -(-n // chunk_size)
        ids = torch.arange(k, device=scene.device)

        def wave_rows(wkey):
            # the split route needs no pad lanes: each chunk keeps its own;
            # the trace kernel's scenes pad each chunk to whole tiles
            return render_chunk(scene, wkey, ids, chunk_size, width, height,
                                depth, prep).reshape(-1, 3)

    acc = acc0
    if acc is None:
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=scene.device)
    for i in range(n_waves):
        rows = wave_rows(rngu.wave_key(key, wave_start + i))[:n]
        acc = acc + cam_ops.image_from_positions(rows, width, height)
    return acc


def render_image(scene, width: int, height: int, spp: int, key,
                 depth: int = MAX_DEPTH, chunk_size: int = 32768):
    """Mean radiance image [H, W, 3] (pre-tonemap), row y=0 at the top of
    the camera frame; utils.image applies the reference's vertical flip
    at write time (main.rs:108)."""
    acc = render_waves(scene, width, height, key, 0, spp, depth, chunk_size)
    return acc / spp
