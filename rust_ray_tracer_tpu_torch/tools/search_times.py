"""Times of the search kernels of library ``trace_wave`` (TPU kernels A, D
and E, and the noise variants of A and D), of library ``search`` (K and
M, with the unified search's sort of the rays) and of library ``sphere``
(N), of the backward trace kernels B and D' (``--scenes trace_bwd``), of
the split route's backward kernels F', G' and I' (``--scenes
split_bwd``), its fused bounce F and G (``--scenes split_fwd``), H'
(``--scenes su_bwd``), H (``--scenes su_fwd``), I (``--scenes
shade_fwd``), J (``--scenes hit_fwd``) and J' (``--scenes hit_bwd``) on
one CUDA card, for
holding one tree's kernels against another's in the same call;
``chip_smoke.py`` runs :func:`search_report` as its search checks, counts
M's work with :func:`m_work` and times its kernels with :func:`cold_ms`
and :func:`loop_ms`.

    PYTHONPATH=<tree> python3 search_times.py --label new \\
        --out output/search_new.json --save <dir>/new.pt [--scenes mesh]

Run from the root of the tree whose package ``PYTHONPATH`` names (the
script uses only the package's public kernels and tables, so it runs
against an older tree as well; to time a tree with other ``nvcc`` flags,
edit its ``kernels.LIBRARIES``): the flagship (``procedural_flagship``)
and ``random`` at ``bench.py``'s wave (512x288, 4 spp a wave of 147,456
rays, depth 4, chunk 9216), wave 0's inputs. It writes one JSON object:

  * per kernel, ms per launch out of L2 (before each launch a 256 MB read
    evicts the inputs and a spin lets the host enqueue it: median of 10)
    and in a back-to-back loop (the inputs in L2, as in the path: median
    of 5 rounds of 20): A with and without the residuals and A-noise on
    the whole wave; D and D-noise on bounces 0 and 1, and E on bounces
    0-3, each on the state A's residuals hold for that bounce;
  * in the path: ``torch.profiler``'s device ms per launch of A, D and E
    in a one-wave forward render of the flagship through ``render_waves``
    (the whole-wave route, the per-chunk route with ``RRT_UBER_WAVE=0``,
    the unfused bounce with ``RRT_NO_UBER_FUSED=1`` as well);
  * per bounce the live rays and the share of live lanes among the warps
    that sweep, computed in torch from the live mask: without compaction a
    warp sweeps when one of its 32 lanes is live; with it a 128-ray row of
    n live rays sweeps in ceil(n / 32) warps;
  * the libraries' ptxas registers, static shared memory and spills of
    each kernel and, where the tree has
    ``kernels.trace_wave_occupancy``, the resident blocks per SM;
  * the lanes on which D's and E's winners differ from A's residual
    winners of the bounce.

The mesh (``--scenes`` names the parts to run; the first five by
default):
the 65,536-triangle mesh of the tree's ``tests/torch_parity.py`` at the
same wave, wave 0's recorded calls of K and M (and of
``ops/search.search_order`` where the tree has it) on bounces 0-3: per
bounce the live rays, the tiles that hold one, the (tile, cluster) pairs
K lets through, K's and M's ms out of L2, M's in a loop, the sort's ms in
a loop and out of L2, M's ms in a one-wave render (``torch.profiler``,
the launches in bounce order), and M's work (:func:`m_work`); with
``--check`` every lane's winner against ``fused_search_plain``. The
calls are recorded by the tree's ``torch_parity.split_recorder``.
``tri`` and ``gltf``: K's and L's ms out of L2 on each bounce of the L
check scene's wave 0 (``torch_parity.random_tris``), K's and M's on the
9-light glTF flagship's (``write_gltf_flagship``), and L's and M's in a
one-wave render.

``sph``: random with a procedural 1024x512 earth map (the per-kind
branch: kernel N for its 1,024 sphere rows) on each bounce's recorded
call of wave 0: the live rays, N's ms out of L2 and in a loop, in a
one-wave render, and where the tree has ``ops/sphere.sph_sweep_replay``
its tests by stage, per warp and per ray, the bound by stage
(:func:`n_work`) and whether its winners are the kernel's. (To time a variant of K or N, such as K's ``ENTER_CPB`` or N's
``ROWS``, edit it in a copy of the tree with ``sed`` and time the copy.)

``final``: final_scene's wave 0 on the split route: kernel O on each
bounce's recorded call (live rays, ms out of L2 and in a loop, in a
one-wave render; where the tree has ``ops/quad.quad_sweep_replay``, the
tests by stage, per warp and per ray, and the bound by stage), and B' on
each row sum and light-table sum of a one-wave training step, out of L2
and in a loop, beside ``index_add_`` on the same row sums. ``earth``:
the same B' times on random with a procedural 1024x512 earth map (the
atlas's 524,288 texel rows among the tables). ``bwd``: B' on the
flagship's kernel-B sums of one wave, beside ``index_add_``. B' is called
through the tree's own interface (sorted keys and order, or an older
tree's order and row offsets), its sort outside the timed call.

``trace_bwd``: the backward trace kernels (TPU kernels B and D', each
scene's variant) on the flagship and random: B on wave 0's residuals
(A's, depth 4), D' on bounces 0 and 1 of D's inputs, with a seeded
cotangent, each out of L2 and in a loop beside its byte bound
(:func:`bwd_bytes`, which ``chip_smoke.py`` counts with too), each in a
one-wave training step (``torch.profiler``; D' on the per-chunk route,
``RRT_UBER_WAVE=0``), and the library's ptxas registers, stack frames
and spills of B and D'.

``split_bwd``: the split route's backward kernels F', G' and I' on
their cells' recorded calls of wave 0 (bounces 0-3), each with a seeded
cotangent: F' on the mesh's calls of kernel F, G' on the unfused
flagship's calls of kernel G (``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0``),
I' on the 9-light glTF flagship's calls of kernel I and on the 16-light
file's; each out of L2 and in a loop, alone (``partials``) and with B''s
sum of its partials, beside its byte bound (:func:`bp_bwd_bytes`,
:func:`shade_bwd_bytes`, which ``chip_smoke.py`` counts with too), and in
a one-wave training step (``torch.profiler``); the ptxas lines of the two
kernels and their resident blocks an SM (:func:`occupancy`).

``split_fwd``: kernel F on the mesh's recorded calls of wave 0 (bounces
0-3) and G on the unfused flagship's, each out of L2 and in a loop beside
its bound (:func:`bp_fwd_bytes`, :func:`bp_live_bytes`, which
``chip_smoke.py`` counts with too) and in a one-wave forward render; the
ptxas line of ``bounce_planes_kernel`` and its resident blocks an SM.
``su_bwd``: kernel H' on final_scene's and random earth's recorded calls
of kernel H of wave 0, with a seeded cotangent, alone and with B''s sum,
out of L2 and in a loop beside its bound (:func:`su_bwd_bytes`), and in
a one-wave training step; its ptxas line and resident blocks.
``su_fwd``: kernel H on the same calls (final_scene's and random
earth's), out of L2 and in a loop beside its bound by lane class
(:func:`su_fwd_bytes`, which ``chip_smoke.py`` counts with too), and in
a one-wave forward render; its ptxas line and resident blocks.
``shade_fwd``: kernel I on the 9-light glTF flagship's recorded calls of
wave 0 and on its 16-light twin's, out of L2 and in a loop beside its
bound (:func:`shade_fwd_bytes` and the operations by stage of
:func:`shade_work`, which ``chip_smoke.py`` counts with too: each
bounce's candidate lights from the tree's ``ops/shade.
shade_candidates_replay``), and in a one-wave forward render; its ptxas
line and resident blocks at 9 and 16 lights.
``hit_fwd`` and ``hit_bwd``: kernels J and J' on final_scene's and random
earth's recorded calls of J of wave 0 (J also on the 9-light glTF
flagship's), J' with ``torch_parity.split_cots``' cotangents; out of L2
and in a loop beside the bound (:func:`hit_bytes`, which
``chip_smoke.py`` counts with too) and beside one torch copy of the same
bytes (:func:`copy_times`), in a one-wave forward render (J, and the
``torch.cat`` that packs its planes) or training step (J'); both at odd
ray counts (``HIT_ODD_N`` and the wave less one); the ptxas lines, the
resident blocks, the grid and its rounds (:func:`hit_ptxas`).

``bigmesh``: the million-triangle path (``torch_parity.bigmesh``: the
mesh's draws written as a u32 ``.gltf`` with an external ``.bin``, read
back by ``load_gltf_scene``) at :data:`BIGMESH_SIZES` triangles (65,536,
262,144 and 1,048,576: clusters of 128, 512 and 2,048), each: the host
seconds to write, load and compile; wave 0's recorded calls of K and M
(bounces 0-3), on which M's staged input and its packed input
(``search_tables(..., packed=False / True)``) are held bit for bit on
every lane (t, kind, index) and timed in :data:`PAIRS` pairs of turns
(staged, packed, then packed, staged, ...) out of L2 and in a loop, K
out of L2, with M's tests by stage (:func:`m_work`) and each input's
bound by bytes and by operations (the packed input's in-kernel assembly
included, :data:`OPS_M_ASSEMBLE` a triangle of each (live tile, swept
cluster)); a one-wave render under each input (:func:`pack_gate`) in as
many pairs of turns, with M's ms a bounce by the profiler and the wave's
ms, and the packed less staged difference of each pair against the
staged turns' own spread (:func:`pair_spread`); the forward Mrays/s at
the bench shape and one training step's (``bench.py``'s loss), with the
gate's input, and their peak memory.

``--save`` writes A's final states and winners, E's winners, M's and
K's of each mesh bounce (and O's of each final_scene bounce, N's of each
random earth bounce; B's and D''s dst, keys, light-table partials and
the contrib rows of ray-bounces with a winner; F''s, G''s, H''s and I''s
dP or d_data, partials and their sum by B'; F's, G's, H's, I's, J's
and J''s output) to a
``.pt`` file; ``--compare a.pt b.pt
...`` then prints, for each file after the first, whether each of those
tensors equals the first file's bit for bit (floats by their bit
patterns). Needs one CUDA card, imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from rust_ray_tracer_tpu_torch import kernels as K
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import intersect as isect
from rust_ray_tracer_tpu_torch.ops import search as search_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

WIDTH, HEIGHT, SPP, DEPTH, CHUNK = 512, 288, 4, 4, 9216
L2_FLUSH_BYTES = 256 << 20
ROW, WARP = 128, 32
# fp32 operations of M's triangle test by stage (csrc/search.cu, counted
# from the code): the determinant's 3 products and 2 sums and the face
# test's 3 compares on every test; where the face is seen, the t
# numerator's 3 products and 3 sums, the guard's |det| compare and
# select, the division, the product and the window's 3 compares; where t
# lies in the window at or below the ray's closest hit, u's and v's 6
# products and 5 sums each, their 2 products and the 5 barycentric
# compares. A sphere test 40 and a quad test 45, as before
OPS_M_DET, OPS_M_T, OPS_M_UV = 8, 12, 29
OPS_M_SPH, OPS_M_QUAD = 40, 45
# fp32 operations of M's packed input a triangle of each (live tile,
# swept cluster), counted from csrc/search.cu assemble_row: the three
# cross products 27, |n|^2 5, the square root, the guard, the division,
# n / |n| 3, the t constant 6, the products by 1 / |n| 12, the negations
# 12
OPS_M_ASSEMBLE = 70
# (ray, cluster) pairs m_work tests at once, at 128 triangles a cluster
PAIRS_A_BATCH = 1 << 16
# the big-mesh part's sizes: JAX's PACKED_MIN_TRIS, 4x and 16x (clusters
# of 128, 512 and 2,048)
BIGMESH_SIZES = (1 << 16, 1 << 18, 1 << 20)
# pairs of turns (staged and packed, the order alternating) in which the
# big-mesh part times M's two inputs, out of L2 and in the wave
PAIRS = 10


def loop_ms(fn, reps: int = 20, rounds: int = 5) -> list[float]:
    """Per-call ms of ``fn`` from CUDA events around ``reps`` back-to-back
    calls, ``rounds`` times, after a warm-up: the device time when the
    host enqueues faster than the card runs."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return out


def cold_ms(fn, reps: int = 10) -> list[float]:
    """Per-call device ms of ``fn`` with the inputs out of the L2 cache:
    before each call a 256 MB read (five times the H100's 50 MB L2)
    evicts them and a spin of the card lets the host enqueue the call
    before its start event runs. The time under which the byte bound,
    at HBM's rate, is a floor."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        flush.sum()
        torch.cuda._sleep(1_000_000)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def times(fn):
    """Median ms of ``fn`` out of L2 and in a loop."""
    with torch.no_grad():
        return {"cold": statistics.median(cold_ms(fn)),
                "loop": statistics.median(loop_ms(fn))}


def lane_shares(alive):
    """Live rays and the live-lane share of the sweeping warps, without
    and with the row's compaction, for the live mask ``alive`` [N]."""
    n_live = int(alive.sum())
    warps = alive.reshape(-1, WARP)
    before = int(warps.any(1).sum())
    per_row = alive.reshape(-1, ROW).sum(1)
    after = int(torch.div(per_row + WARP - 1, WARP,
                          rounding_mode="floor").sum())
    return {"live": n_live, "rays": alive.numel(),
            "warps_before": before, "warps_after": after,
            "live_lane_share_before": n_live / (WARP * before) if before
            else None,
            "live_lane_share_after": n_live / (WARP * after) if after
            else None}


def ptxas_report(log: str) -> list[dict]:
    """Registers, static shared memory, stack frame and spills of each
    kernel from ``-Xptxas -v`` (a device function's own properties, which
    ptxas prints where it is not inlined, are skipped)."""
    out, name, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and props == name:
            out.append({"function": name, "stack_frame": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and "registers" not in out[-1]:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(smem.group(1)) if smem else 0
    return out


@contextlib.contextmanager
def _env(env):
    """The route flags ``env`` set in ``os.environ`` inside the block,
    the earlier values back after it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def in_path(scene, key, names, env, step=False):
    """Device ms per launch of each profiler name in ``names`` over a
    one-wave forward render of ``scene`` (with ``step``, a one-wave
    training step: ``bench.py``'s loss and its backward over every float
    scene leaf) with the route flags ``env``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rust_ray_tracer_tpu_torch.models.scene import combine, partition

    def run():
        if not step:
            with torch.no_grad():
                render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                             chunk_size=CHUNK)
        else:
            params, static = partition(scene)
            leaves = {k: v.clone().requires_grad_()
                      for k, v in params.items()}
            render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0, 1,
                         depth=DEPTH, chunk_size=CHUNK).mean().backward()
        torch.cuda.synchronize()

    with _env(env):
        run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {}
    for n in names:
        ds = [e.time_range.elapsed_us() / 1e3 for e in kern if n in e.name]
        out[n] = {"ms_per_launch": sum(ds) / len(ds) if ds else None,
                  "launches": len(ds)}
    return out


def search_report(ctx, st0, rnd, residuals=None, save=None, label=""):
    """A, D and E on one wave's inputs ``st0``, ``rnd`` of the scene whose
    tables are ``ctx``: per bounce, the lanes on which D's (the scene's
    variant) and E's winners differ from A's residual winners (A's
    ``residuals`` (hist, kind, idx) when given, else A's own run) and the
    live lanes (:func:`lane_shares`); A's times with and without the
    residuals, D's on bounces 0 and 1 and E's on every bounce. E has no
    marble and runs a noise scene's tables with the noise flag cleared:
    its search reads no texture, and its library (``trace_wave``) is not
    D-noise's. With ``save`` (a dict), A's final states and winners and
    E's winners under ``label``."""
    a = K.trace_kernel(ctx)
    d, e = K.fused_bounce_kernel(ctx), K.select_kernel
    ectx = dataclasses.replace(ctx, has_noise=False)
    with torch.no_grad():
        stf, hist, kind, idx = a(st0, rnd, ctx, DEPTH, residuals=True)
    if residuals is not None:
        hist, kind, idx = residuals
    out = {"kernels": {a.name: a.library, d.name: d.library,
                       e.name: e.library},
           "rays": st0.shape[1], "bounces": [], "winners_equal_a": True,
           "a": {"with_residuals": times(
               lambda: a(st0, rnd, ctx, DEPTH, residuals=True)),
               "without": times(lambda: a(st0, rnd, ctx, DEPTH))}}
    if hasattr(K, "trace_wave_occupancy"):
        out["blocks_per_sm"] = K.trace_wave_occupancy(
            a.library, ctx.n_tri_chunks > 0, st0.device)
    if save is not None:
        save[f"{label}.stf"] = stf.cpu()
        save[f"{label}.kind"] = kind.cpu()
        save[f"{label}.idx"] = idx.cpu()
    for b in range(DEPTH):
        st = hist[b]
        row = {"bounce": b, **lane_shares(st[7] > 0.5)}
        with torch.no_grad():
            _, dk, di = d(st, rnd[b], ctx)
            selv, ek, ei = e(st[0:8], ectx)
        row["winners_differing"] = {
            n: int(((k_ != kind[b]) | (i_ != idx[b])).sum())
            for n, k_, i_ in ((d.name, dk, di), (e.name, ek, ei))}
        out["winners_equal_a"] &= not any(row["winners_differing"].values())
        if save is not None:
            save[f"{label}.e{b}.kind"] = ek.cpu()
            save[f"{label}.e{b}.idx"] = ei.cpu()
            save[f"{label}.e{b}.selv"] = selv.cpu()
        if b < 2:
            row[d.name] = times(lambda s=st, r=rnd[b]: d(s, r, ctx))
        row[e.name] = times(lambda s=st[0:8]: e(s, ectx))
        out["bounces"].append(row)
    return out


def scene_times(label, host_fn, dev, save):
    """:func:`search_report` on wave 0 of ``host_fn()``'s scene, and for a
    scene without noise the in-path times of A, D and E."""
    scene = compile_scene(host_fn(), device=dev)
    key = rng.key(0, dev)
    ctx = uber.make_ctx(scene)
    st0, rnd = uber.wave_inputs(scene, rng.wave_key(key, 0), WIDTH, HEIGHT,
                                DEPTH, CHUNK)
    out = search_report(ctx, st0, rnd, save=save, label=label)
    if not ctx.has_noise:
        v = "false"
        out["in_path"] = {
            "whole_wave": in_path(scene, key, (f"trace_wave_kernel<{v}>",),
                                  {}),
            "per_chunk": in_path(scene, key, (f"fused_bounce_kernel<{v}>",),
                                 {"RRT_UBER_WAVE": "0"}),
            "unfused": in_path(scene, key, ("::select_kernel(",),
                               {"RRT_UBER_WAVE": "0",
                                "RRT_NO_UBER_FUSED": "1"})}
    return out


def _parity():
    """The tree's ``tests/torch_parity.py`` (the working directory's)."""
    tests = os.path.join(os.getcwd(), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_parity
    return torch_parity


def mesh_scene(dev):
    """The mesh workload of the tree in the working directory
    (``tests/torch_parity.mesh``: 65,536 double-sided triangles in 512
    clusters and the flagship's sphere lamp)."""
    from rust_ray_tracer_tpu_torch.models import scene as S
    from rust_ray_tracer_tpu_torch.ops import camera as cam
    return compile_scene(_parity().mesh(S, cam), device=dev)


def tri_scene(dev):
    """The L check scene (``torch_parity.random_tris``: random's world
    with a procedural 1024x512 earth map, written to a temporary working
    directory, and the flagship's 968 triangles), on the per-kind
    branch: K and L for the triangles."""
    from rust_ray_tracer_tpu_torch.models import scene as S
    tp = _parity()
    prev = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tp.write_earth_map(tmp, 1024, 512)
        os.chdir(tmp)
        try:
            return compile_scene(tp.random_tris(S, builders, WIDTH / HEIGHT),
                                 device=dev)
        finally:
            os.chdir(prev)


def gltf9_scene(dev):
    """The 9-light glTF flagship (``torch_parity.write_gltf_flagship``:
    968 triangles, 9 point lights), on the unified search below the
    sort's gate: K and M."""
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
    with tempfile.TemporaryDirectory() as tmp:
        path = _parity().write_gltf_flagship(os.path.join(tmp, "f9.gltf"), 9)
        return compile_scene(load_gltf_scene(path, WIDTH / HEIGHT),
                             device=dev)


def wave_report(scene, kernel, key_name):
    """K's and ``kernel``'s (M or L) ms out of L2 on each bounce's
    recorded calls of wave 0 of ``scene``, and ``kernel``'s in a one-wave
    render (the profiler's launches in bounce order; both launch M's
    staged instance, :func:`m_profiler_name`)."""
    key = rng.key(0, scene.tri_v0.device)

    def render():
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                                chunk_size=CHUNK)

    render()
    with _parity().split_recorder() as rec:
        render()
    torch.cuda.synchronize()
    k = K.tile_enter_kernel
    out = {"bounces": [], "in_path_ms": device_ms_in_order(
        render, m_profiler_name(False))}
    for e_args, args in zip(rec["enter"], rec[key_name]):
        with torch.no_grad():
            bt = kernel(*args)[0]
            out["bounces"].append({
                "live_rays": int((args[0][8] > args[0][7]).sum()),
                "k_ms": times(lambda a=e_args: k(*a)),
                "ms": times(lambda a=args: kernel(*a)),
                "tests": m_work(args, bt)["tests"] if key_name == "search"
                else None})
    return out


def _det_t_rows(tabs):
    """(det, t_num) [T, 10] and the flag [T] of a tree's triangle table:
    the full rows [T, 41] (det, u, v, t, flag), the compact rows [T, 20]
    (``ops/search.full_rows``) or the packed rows [T, 10], assembled."""
    tri = tabs.tri
    if tri.shape[1] == 41:
        return tri[:, 0:10], tri[:, 30:40], tri[:, 40]
    if getattr(tabs, "packed", False):
        tri = search_ops.assemble_rows(tri)
    det, _, _, t_num, flag = search_ops.full_rows(tri)
    return det, t_num, flag[:, 0]


def m_work(args, best_t) -> dict:
    """What kernel M must do on one recorded call ``args`` (rays, ent,
    tabs, chunk[, perm]) whose winners have t ``best_t`` [N] (in the rays'
    order), counted from the data on the card:

      * ``full_cull_tests``: every live ray of a tile against every
        triangle of every cluster the tile enters (K's cull alone);
      * ``tests``: per live ray, the triangles of its tile's entered
        clusters whose entry is at most the ray's final t (inf for a
        miss). No search that keeps these winners tests fewer: a cluster
        entered before the hit may hold a nearer one. Of them, ``t_tests``
        see the face (|det| > eps, a back face where double-sided) and
        ``uv_tests`` have t in the window at or below the final t;
      * ``ops``: ``tests`` x OPS_M_DET + ``t_tests`` x OPS_M_T +
        ``uv_tests`` x OPS_M_UV + the sphere and quad tests of every live
        ray (OPS_M_SPH, OPS_M_QUAD), and for a packed table the rows'
        assembly (``assemble_ops``: ``pairs`` x the cluster width x
        OPS_M_ASSEMBLE); ``bytes``: the rays, the entries, the tables
        (40 bytes a packed triangle, 80 a compact one) and the
        permutation read once, the winners written once;
      * ``live_rays``, ``live_tiles`` (tiles holding one), ``pairs`` (the
        (tile, cluster) pairs K lets through)."""
    rays, ent, tabs, chunk = args[:4]
    perm = args[4] if len(args) > 4 else None
    if perm is not None:
        rays, best_t = rays[:, perm], best_t[perm]
    n = rays.shape[1]
    chunk = n if chunk is None else chunk
    tpc = -(-chunk // search_ops.BC)
    pos = torch.arange(n, device=rays.device)
    tile = pos // chunk * tpc + pos % chunk // search_ops.BC
    live = rays[8] > rays[7]
    width = tabs.width
    w = {"live_rays": int(live.sum()),
         "live_tiles": int(torch.unique(tile[live]).numel()),
         "pairs": int(torch.isfinite(ent).sum()) if tabs.tri.shape[0]
         else 0,
         "full_cull_tests": 0, "tests": 0, "t_tests": 0, "uv_tests": 0}
    if tabs.tri.shape[0]:
        det, t_num, flag = _det_t_rows(tabs)
        fin = torch.isfinite(ent)
        w["full_cull_tests"] = int(fin.sum(1)[tile[live]].sum()) * width
        lp = pos[live]
        batch = max(1, PAIRS_A_BATCH * 128 // width)
        for s0 in range(0, lp.numel(), 8192):
            p = lp[s0:s0 + 8192]
            need = fin[tile[p]] & (ent[tile[p]] <= best_t[p, None])
            pr, cl = torch.nonzero(need, as_tuple=True)
            for b0 in range(0, pr.numel(), batch):
                rp, cp = p[pr[b0:b0 + batch]], cl[b0:b0 + batch]
                rows = (cp[:, None] * width
                        + torch.arange(width, device=rays.device))
                o, d = rays[0:3, rp], rays[3:6, rp]
                f = (o[0], o[1], o[2], d[0], d[1], d[2],
                     o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                     o[0] * d[1] - o[1] * d[0], torch.ones_like(o[0]))

                def dot(tab):
                    acc = tab[rows, 0] * f[0][:, None]
                    for j in range(1, 10):
                        acc = acc + tab[rows, j] * f[j][:, None]
                    return acc

                dm, tm = dot(det), dot(t_num)
                eps = 1e-5 * torch.sqrt(d[0] * d[0] + d[1] * d[1]
                                        + d[2] * d[2])[:, None]
                seen = (dm > eps) | ((dm < -eps) & (flag[rows] > 0.5))
                t = tm / torch.where(dm.abs() > eps, dm,
                                     torch.ones_like(dm))
                win = (seen & (t >= rays[7, rp, None])
                       & (t <= rays[8, rp, None]) & (t <= best_t[rp, None]))
                w["tests"] += rows.numel()
                w["t_tests"] += int(seen.sum())
                w["uv_tests"] += int(win.sum())
    n_live = w["live_rays"]
    w["assemble_ops"] = (w["pairs"] * width * OPS_M_ASSEMBLE
                         if getattr(tabs, "packed", False) else 0)
    w["ops"] = (w["tests"] * OPS_M_DET + w["t_tests"] * OPS_M_T
                + w["uv_tests"] * OPS_M_UV + w["assemble_ops"]
                + n_live * (tabs.sph.shape[0] * OPS_M_SPH
                            + tabs.quad.shape[0] * OPS_M_QUAD))
    w["bytes"] = (4 * (9 * n + ent.numel() + tabs.tri.numel()
                       + tabs.sph.numel() + tabs.quad.numel() + 3 * n)
                  + (8 * n if perm is not None else 0))
    return w


def device_ms_in_order(fn, name):
    """Device ms of each launch whose profiler name holds ``name``, in
    launch order, over one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and name in e.name),
                  key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in kern]


def mesh_report(dev, save=None, label="", check=False):
    """K, the sort and M on the recorded calls of the mesh's wave 0 (the
    module docstring's mesh part)."""
    scene = mesh_scene(dev)
    key = rng.key(0, dev)

    def render():
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                                chunk_size=CHUNK)

    render()
    with _parity().split_recorder() as rec:
        render()
    torch.cuda.synchronize()
    orders = rec.get("order", [])      # a tree without the sort: none
    k, m = K.tile_enter_kernel, K.search_kernel(rec["search"][0][2])
    out = {"triangles": scene.n_tris, "rays": WIDTH * HEIGHT,
           "sorted": bool(orders), "bounces": [],
           "winners_differing_plain": [] if check else None,
           "m_in_path_ms": device_ms_in_order(render, m_profiler_name(
               search_ops.packed_input(scene.n_tris))),
           "k_in_path_ms": device_ms_in_order(render, "tile_enter_kernel")}
    for b, (e_args, s_args) in enumerate(zip(rec["enter"], rec["search"])):
        with torch.no_grad():
            bt, bk, bi = m(*s_args)
            row = {"bounce": b, **m_work(s_args, bt),
                   "k_ms": times(lambda a=e_args: k(*a)),
                   "m_ms": times(lambda a=s_args: m(*a))}
            ent = k(*e_args)
            if orders:
                row["sort_ms"] = times(
                    lambda a=orders[b]: search_ops.search_order(*a))
            if check:
                ref = search_ops.fused_search_plain(*s_args)
                out["winners_differing_plain"].append(int(
                    ((bk != ref[1]) | (bi != ref[2])
                     | ((bt != ref[0]) & ~(torch.isinf(bt)
                                           & torch.isinf(ref[0])))).sum()))
        if save is not None:
            for nm, x in (("t", bt), ("kind", bk), ("idx", bi), ("ent", ent)):
                save[f"{label}.mesh{b}.{nm}"] = x.cpu()
        out["bounces"].append(row)
    return out


@contextlib.contextmanager
def pack_gate(packed: bool):
    """Inside ``with``, the unified search takes the packed input
    (``packed``) or the staged one at every size (``ops/search.
    packed_input`` answers ``packed``; the sort's gate is untouched), the
    gate back after the block. Tables built inside keep their input."""
    prev = search_ops.packed_input
    search_ops.packed_input = lambda n_tris: packed
    try:
        yield
    finally:
        search_ops.packed_input = prev


def m_profiler_name(packed: bool) -> str:
    """The profiler's name of kernel M's instance for the packed or the
    staged input (``csrc/search.cu`` ``fused_search_kernel<PACKED>``; L
    launches the staged one)."""
    return f"fused_search_kernel<{'true' if packed else 'false'}>"


def bigmesh_scene(dev, n_tris, directory):
    """The big-mesh workload of ``n_tris`` triangles (the tree's
    ``torch_parity.write_bigmesh`` into ``directory`` and ``bigmesh``),
    compiled on ``dev``, and the host seconds to write, load and
    compile."""
    from rust_ray_tracer_tpu_torch.ops import camera as cam
    tp = _parity()
    t0 = time.perf_counter()
    path = tp.write_bigmesh(directory, n_tris)
    t1 = time.perf_counter()
    host = tp.bigmesh(S, cam, path)
    t2 = time.perf_counter()
    scene = compile_scene(host, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return scene, {"write_s": t1 - t0, "load_s": t2 - t1,
                   "compile_s": t3 - t2,
                   "bin_bytes": os.path.getsize(path[:-5] + ".bin")}


def turn_order(pairs: int) -> list[str]:
    """``pairs`` pairs of turns of the two inputs, the order alternating
    from pair to pair: staged, packed, packed, staged, ..."""
    return [who for i in range(pairs)
            for who in (("staged", "packed") if i % 2 == 0
                        else ("packed", "staged"))]


def m_pair_times(run_s, run_p, pairs: int = 2):
    """M's staged call ``run_s`` and packed call ``run_p`` timed in
    ``pairs`` pairs of turns (:func:`turn_order`), each turn out of L2 (5
    launches) and in a loop (3 rounds of 5): per input the median over
    its turns' launches (``cold``, ``loop``) and each turn's median
    (``cold_turns``, ``loop_turns``)."""
    out = {"staged": {"cold": [], "loop": []},
           "packed": {"cold": [], "loop": []}}
    with torch.no_grad():
        for who in turn_order(pairs):
            fn = run_p if who == "packed" else run_s
            out[who]["cold"].append(cold_ms(fn, 5))
            out[who]["loop"].append(loop_ms(fn, 5, 3))
    return {who: {**{k: statistics.median(x for turn in v for x in turn)
                     for k, v in t.items()},
                  **{f"{k}_turns": [statistics.median(turn) for turn in v]
                     for k, v in t.items()}}
            for who, t in out.items()}


def pair_spread(path) -> dict:
    """The in-wave reading of :func:`bigmesh_report`'s ``path`` (each
    input's turns, in :func:`turn_order`): per input M's ms a wave (its
    bounces summed) and the wave's ms, median, min and max over its turns;
    of each pair of turns, packed less staged; and whether that
    difference's median lies outside the spread of the staged turns
    (max - min), the noise of one input against itself."""
    out = {}
    for what in ("m_wave_ms", "wave_ms"):
        per = {who: ([sum(b) for b in t["m_ms"]] if what == "m_wave_ms"
                     else t["wave_ms"]) for who, t in path.items()}
        diff = [p - s for s, p in zip(per["staged"], per["packed"])]
        spread = max(per["staged"]) - min(per["staged"])
        med = statistics.median(diff)
        out[what] = {
            **{who: {"median": statistics.median(v), "min": min(v),
                     "max": max(v)} for who, v in per.items()},
            "packed_less_staged": {"median": med, "min": min(diff),
                                   "max": max(diff)},
            "staged_spread": spread, "resolved": abs(med) > spread}
    return out


def packed_work(w, staged, packed) -> dict:
    """:func:`m_work`'s counts ``w`` of a call on the staged tables
    ``staged`` as the packed tables ``packed`` give them (the same tests
    and winners): the rows' assembly added to the operations, the packed
    table's bytes in place of the compact one's."""
    asm = w["pairs"] * staged.width * OPS_M_ASSEMBLE
    return {**w, "assemble_ops": asm, "ops": w["ops"] + asm,
            "bytes": w["bytes"] + 4 * (packed.tri.numel()
                                       - staged.tri.numel())}


def bigmesh_report(dev, save=None):
    """The ``bigmesh`` part (the module docstring) at
    :data:`BIGMESH_SIZES`, after the 65,536-triangle mesh workload
    (:func:`mesh_scene`, double-sided, the cell ``chip_smoke.py`` runs) as
    the first row."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    out = {"sizes": [], "ops_m_assemble": OPS_M_ASSEMBLE}
    key = rng.key(0, dev)
    for n_tris in ("mesh",) + BIGMESH_SIZES:
        if n_tris == "mesh":
            t0 = time.perf_counter()
            scene = mesh_scene(dev)
            host_s = {"compile_s": time.perf_counter() - t0,
                      "workload": "torch_parity.mesh"}
        else:
            with tempfile.TemporaryDirectory() as tmp:
                scene, host_s = bigmesh_scene(dev, n_tris, tmp)
            host_s["workload"] = "torch_parity.bigmesh"
        k = scene.tri_cluster_min.shape[0]

        def render(n_waves=1, scene=scene):
            with torch.no_grad():
                return render_waves(scene, WIDTH, HEIGHT, key, 0, n_waves,
                                    depth=DEPTH, chunk_size=CHUNK)

        render()
        with _parity().split_recorder() as rec:
            render()
        torch.cuda.synchronize()
        staged = search_ops.search_tables(scene, False)
        packed = search_ops.search_tables(scene, True)
        row = {"size": n_tris, "triangles": scene.n_tris, "clusters": k,
               "double_sided": int(scene.tri_double.sum()),
               "width": scene.n_tris // k, **host_s,
               "gate_packed": search_ops.packed_input(scene.n_tris),
               "packed_min_tris": search_ops.PACKED_MIN_TRIS,
               "table_bytes": {"staged": staged.tri.numel() * 4,
                               "packed": packed.tri.numel() * 4},
               "bounces": []}
        for b, (e_args, s_args) in enumerate(zip(rec["enter"],
                                                 rec["search"])):
            a_s = s_args[:2] + (staged,) + s_args[3:]
            a_p = s_args[:2] + (packed,) + s_args[3:]
            with torch.no_grad():
                got_s = K.fused_search_kernel(*a_s)
                got_p = K.fused_search_packed_kernel(*a_p)
                differ = int(((got_s[0].view(torch.int32)
                               != got_p[0].view(torch.int32))
                              | (got_s[1] != got_p[1])
                              | (got_s[2] != got_p[2])).sum())
                w_s = m_work(a_s, got_s[0])
                w_p = packed_work(w_s, staged, packed)
            t = m_pair_times(lambda a=a_s: K.fused_search_kernel(*a),
                             lambda a=a_p: K.fused_search_packed_kernel(*a),
                             PAIRS)
            row["bounces"].append({
                "bounce": b, "lanes_differing_packed_staged": differ,
                **{x: w_s[x] for x in ("live_rays", "live_tiles", "pairs",
                                       "tests", "t_tests", "uv_tests",
                                       "full_cull_tests")},
                "k_ms": statistics.median(cold_ms(
                    lambda a=e_args: K.tile_enter_kernel(*a), 5)),
                "m_ms": t,
                "bound": {"staged": {"bytes_ms": bound_ms(w_s["bytes"], 0),
                                     "ops_ms": bound_ms(0, w_s["ops"]),
                                     "bytes": w_s["bytes"],
                                     "ops": w_s["ops"]},
                          "packed": {"bytes_ms": bound_ms(w_p["bytes"], 0),
                                     "ops_ms": bound_ms(0, w_p["ops"]),
                                     "bytes": w_p["bytes"],
                                     "ops": w_p["ops"],
                                     "assemble_ops": w_p["assemble_ops"]}}})
            if save is not None:
                for nm, x in zip(("t", "kind", "idx"), got_p):
                    save[f"bigmesh{n_tris}.m{b}.{nm}"] = x.cpu()
        del rec
        # a one-wave render under each input, in PAIRS pairs of turns: M a
        # bounce by the profiler, the wave by CUDA events (the median of 3)
        path = {"staged": {"m_ms": [], "k_ms": [], "wave_ms": []},
                "packed": {"m_ms": [], "k_ms": [], "wave_ms": []}}
        for who in turn_order(PAIRS):
            with pack_gate(who == "packed"):
                path[who]["m_ms"].append(device_ms_in_order(
                    render, m_profiler_name(who == "packed")))
                path[who]["k_ms"].append(device_ms_in_order(
                    render, "tile_enter_kernel"))
                path[who]["wave_ms"].append(statistics.median(
                    loop_ms(render, 1, 3)))
        row["in_path"] = path
        row["in_path_pairs"] = pair_spread(path)
        # the bench shape with the gate's input: forward and one step
        torch.cuda.reset_peak_memory_stats(dev)
        fwd = loop_ms(lambda: render(SPP), 1, 2)
        row["forward"] = {
            "ms": fwd, "peak_memory_bytes": torch.cuda.max_memory_allocated(
                dev),
            "mrays_per_s": WIDTH * HEIGHT * SPP * DEPTH
            / (statistics.median(fwd) / 1e3) / 1e6}
        params, static = partition(scene)

        def step(params=params, static=static):
            leaves = {n: v.clone().requires_grad_()
                      for n, v in params.items()}
            render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0,
                         SPP, depth=DEPTH, chunk_size=CHUNK).mean().backward()

        torch.cuda.reset_peak_memory_stats(dev)
        st = loop_ms(step, 1, 2)
        row["step"] = {
            "ms": st, "peak_memory_bytes": torch.cuda.max_memory_allocated(
                dev),
            "mrays_per_s": WIDTH * HEIGHT * SPP * DEPTH
            / (statistics.median(st) / 1e3) / 1e6}
        out["sizes"].append(row)
        del scene, staged, packed, params, static
        torch.cuda.empty_cache()
    return out


# fp32 operations of kernel O's quad test by stage (csrc/split.cu, as
# chip_smoke's OPS_QUAD_T and OPS_QUAD_IN): t's dots and division on
# every test; the point, alpha, beta and their compares where t can win
OPS_O_T, OPS_O_AB = 21, 43


def _reduce_call(g, idx, n_rows, part=None):
    """A callable of the tree's B' (``bwd_reduce_kernel``) on one row sum
    (cotangents ``g`` [N, W] into ``n_rows`` rows by ``idx`` [N]), its
    sort done here, once: the (sorted keys, perm) interface, or the
    (perm, offsets) one of trees before it."""
    part = (torch.empty((0, 0), device=g.device) if part is None else part)
    idx32 = idx.to(torch.int32)
    if "p_rows" in inspect.signature(K.bwd_reduce_kernel.__call__).parameters:
        args = (g.contiguous(),) + K.reduce_order(idx32) + (n_rows, part)
    else:
        args = (g.contiguous(),) + K.reduce_order(idx32, n_rows) + (part,)
    return lambda: K.bwd_reduce_kernel(*args)


def step_sums(scene, key):
    """The row sums (``ops/gather.row_sums``: cotangents, row ids, rows)
    and the light-table partials B' sums (``kernels._light_sum``) of a
    one-wave training step of ``scene`` (``bench.py``'s loss), recorded."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops import gather

    params, static = partition(scene)
    sums, parts = [], []
    real_rs, real_ls = gather.row_sums, K._light_sum

    def rs(g, idx, n_rows):
        sums.append((g, idx, n_rows))
        return real_rs(g, idx, n_rows)

    def ls(part, lt):
        parts.append(part)
        return real_ls(part, lt)

    gather.row_sums, K._light_sum = rs, ls
    try:
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0, 1,
                     depth=DEPTH, chunk_size=CHUNK).mean().backward()
        torch.cuda.synchronize()
    finally:
        gather.row_sums, K._light_sum = real_rs, real_ls
    return sums, parts


def reduce_report(sums, parts):
    """B' out of L2 and in a loop on each recorded row sum and light sum
    of one wave, beside ``index_add_`` into a zeroed table (the library
    call for the same function; ``sum(0)`` on a light sum): the calls'
    sums (ms a wave), their mean (ms a launch) and the largest table's
    call apart; and the row sums' kernel time back to back under the
    profiler, with the memsets and fills apart."""
    red, lib, big = [], [], None
    with torch.no_grad():
        for g, idx, n_rows in sums:
            r = times(_reduce_call(g, idx, n_rows))
            li = times(lambda g=g, idx=idx, n=n_rows: torch.zeros(
                (n, g.shape[1]), device=g.device).index_add_(0, idx, g))
            red.append(r)
            lib.append(li)
            if big is None or n_rows > big["rows"]:
                big = {"rows": n_rows, "terms": int(idx.numel()),
                       "width": int(g.shape[1]), "ms": r, "index_add_ms": li}
        for part in parts:
            red.append(times(lambda p=part: K._light_sum(
                p, torch.empty((1, p.shape[1]), device=p.device))))
            lib.append(times(lambda p=part: p.sum(0)))

    def total(xs, k):
        return sum(x[k] for x in xs)

    # every row sum once, back to back (each call's inputs cold: they
    # outgrow the L2 together), the profiler's device time of B''s kernel
    # and of the rest (memsets, fills) the calls launch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = [_reduce_call(g, idx, n_rows) for g, idx, n_rows in sums]
    with torch.no_grad():
        for c in calls:
            c()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for c in calls:
                c()
            torch.cuda.synchronize()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e.time_range.elapsed_us() / 1e3 for e in dev_ev
            if "bwd_reduce_kernel" in e.name]
    rest = sum(e.time_range.elapsed_us() / 1e3 for e in dev_ev
               if "bwd_reduce_kernel" not in e.name)

    return {"row_sums": len(sums), "light_sums": len(parts),
            "ms_a_wave": {k: total(red, k) for k in ("cold", "loop")},
            "ms_a_launch": {k: total(red, k) / len(red)
                            for k in ("cold", "loop")},
            "index_add_ms_a_wave": {k: total(lib, k)
                                    for k in ("cold", "loop")},
            "index_add_ms_a_launch": {k: total(lib, k) / len(lib)
                                      for k in ("cold", "loop")},
            "largest_table_call": big,
            "row_sums_back_to_back": {
                "kernel_ms": sum(kern), "launches": len(kern),
                "other_device_ms": rest},
            "bytes_a_wave": sum((g.numel() + 2 * idx.numel()
                                 + n_rows * g.shape[1]) * 4
                                for g, idx, n_rows in sums)
            + sum((p.numel() + p.shape[1]) * 4 for p in parts)}


def quad_report(scene, key, save=None, label="final"):
    """Kernel O on each bounce's recorded call of wave 0 of ``scene``: the
    live rays, its ms out of L2 and in a loop (and its staged variant's,
    where the tree has one), its work by stage where the tree has
    ``ops/quad.quad_sweep_replay`` (t for every test the per-warp cull
    makes and for the per-ray cull's, alpha and beta where t can win) and
    the bound by stage, and its ms in a one-wave render."""
    from rust_ray_tracer_tpu_torch.ops import quad as quad_ops

    def render():
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                                chunk_size=CHUNK)

    render()
    with _parity().split_recorder() as rec:
        render()
    torch.cuda.synchronize()
    k = K.quad_search_kernel
    tab = quad_ops.quad_table(scene)
    lo = scene.quad_cluster_min.contiguous()
    hi = scene.quad_cluster_max.contiguous()
    out = {"quads": scene.n_quads, "clusters": lo.shape[0],
           "in_path_ms": device_ms_in_order(render, "quad_search_kernel"),
           "bounces": []}
    for b, (_, o, d, t_min, t_max) in enumerate(c[:5] for c in rec["quad"]):
        rays = torch.cat([o, d, t_min[:, None], t_max[:, None]],
                         1).contiguous()
        with torch.no_grad():
            bt, bi = k(rays, tab, lo, hi)
            row = {"bounce": b, "rays": rays.shape[0],
                   "live_rays": int((t_max > t_min).sum()),
                   "ms": times(lambda: k(rays, tab, lo, hi))}
            if hasattr(quad_ops, "quad_sweep_replay"):
                rt, ri, work = quad_ops.quad_sweep_replay(rays, tab, lo, hi)
                ops = (work["ray_tests"] * OPS_O_T
                       + work["ray_ab_tests"] * OPS_O_AB)
                nbytes = (rays.numel() + 2 * rays.shape[0] + tab.numel()
                          + 2 * lo.numel()) * 4
                row.update(work, ops=ops, bytes=nbytes,
                           bound_ms=bound_ms(nbytes, ops),
                           replay_differing=int(((ri != bi.long())
                                                 | (rt != bt)).sum()))
        if save is not None:
            save[f"{label}.quad{b}.t"] = bt.cpu()
            save[f"{label}.quad{b}.i"] = bi.cpu()
        out["bounces"].append(row)
    return out


# fp32 operations of kernel N by stage (csrc/sphere.cu, counted from the
# code): per live ray its inverses, |d|^2 and 1 / |d|^2; per slab test of
# a box K's test (3 axes x (2 subtractions, 2 products, min, max, 2
# selects), 2 maxima and 2 minima across the axes, the window's 3
# compares, the clamp to t_min and the running minimum; chip_smoke counts
# K's with it); per sphere test the lerped centre, b, c and b^2 - a c; the
# square root, the roots and their windows where the discriminant is
# positive
OPS_N_RAY, OPS_SLAB, OPS_N_DISC, OPS_N_ROOT = 15, 33, 27, 14
# the card's published peaks (H100 SXM, 700 W): fp32 non-tensor, HBM3
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def bound_ms(nbytes, ops) -> float:
    """The least ms the card could take: bytes over its memory rate or
    operations over its fp32 rate, the larger."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def n_work(args):
    """Kernel N's sweep on one recorded call ``args`` (``sph_search``'s
    seven arguments), replayed by ``ops/sphere.sph_sweep_replay``: (best t
    [N], best index [N], the work), the work holding the replay's counts
    and:

      * ``ops`` and ``bound_ms``: what the data needs, each live ray alone:
        its inverses (OPS_N_RAY), the cluster boxes and the sub-boxes of
        the clusters it enters (``cluster_tests`` + ``ray_box_tests``, OPS_SLAB
        each), its sphere tests up to the discriminant (``ray_tests``,
        OPS_N_DISC) and the roots where its own discriminant is positive
        (``ray_root_tests``, OPS_N_ROOT);
      * ``warp_ops`` and ``warp_bound_ms``: what the kernel's votes make
        (the tile's and the warps' box tests, every swept test, the roots
        where a lane of the warp has disc > 0);
      * ``bytes``: the rays, the table, the sub-boxes and the cluster boxes
        read once, t and the index written once."""
    from rust_ray_tracer_tpu_torch.ops import sphere as sphere_ops

    rays, tab, cl_min, _, _, _, boxes = args
    bt, bi, w = sphere_ops.sph_sweep_replay(*args)
    rays_ops = w["live_rays"] * OPS_N_RAY
    w["ops"] = (rays_ops
                + (w["cluster_tests"] + w["ray_box_tests"]) * OPS_SLAB
                + w["ray_tests"] * OPS_N_DISC
                + w["ray_root_tests"] * OPS_N_ROOT)
    w["warp_ops"] = (rays_ops + (w["cluster_tests"] + w["box_tests"])
                     * OPS_SLAB + w["tests"] * OPS_N_DISC
                     + w["root_tests"] * OPS_N_ROOT)
    w["bytes"] = (rays.numel() + tab.numel() + boxes.numel()
                  + 2 * cl_min.numel() + 2 * rays.shape[1]) * 4
    w["bound_ms"] = bound_ms(w["bytes"], w["ops"])
    w["warp_bound_ms"] = bound_ms(w["bytes"], w["warp_ops"])
    return bt, bi, w


def earth_scene(dev):
    """random with a procedural 1024x512 earth map (written to a temporary
    working directory), on the split route's per-kind branch: N."""
    tp = _parity()
    prev = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tp.write_earth_map(tmp, 1024, 512)
        os.chdir(tmp)
        try:
            return compile_scene(builders.random_scene(WIDTH / HEIGHT),
                                 device=dev)
        finally:
            os.chdir(prev)


def sph_report(dev, save=None, label="sph"):
    """Kernel N on each bounce's recorded call of wave 0 of random with the
    earth map (the module docstring's ``sph`` part)."""
    from rust_ray_tracer_tpu_torch.ops import sphere as sphere_ops

    scene = earth_scene(dev)
    key = rng.key(0, dev)

    def render():
        with torch.no_grad():
            return render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                                chunk_size=CHUNK)

    render()
    with _parity().split_recorder() as rec:
        render()
    torch.cuda.synchronize()
    n = K.sph_search_kernel
    out = {"spheres": scene.n_spheres,
           "clusters": scene.sph_cluster_min.shape[0],
           "in_path_ms": device_ms_in_order(render, "sph_search_kernel"),
           "bounces": []}
    replay = hasattr(sphere_ops, "sph_sweep_replay")
    for b, args in enumerate(rec["sph"]):
        rays = args[0]
        with torch.no_grad():
            bt, bi = n(*args)
            row = {"bounce": b, "rays": rays.shape[1],
                   "live_rays": int((rays[8] > rays[7]).sum()),
                   "ms": times(lambda a=args: n(*a))}
            if replay:
                rt, ri, work = n_work(args)
                row.update(work, replay_differing=int(((ri != bi.long())
                                                       | (rt != bt)).sum()))
        if save is not None:
            save[f"{label}.sph{b}.t"] = bt.cpu()
            save[f"{label}.sph{b}.i"] = bi.cpu()
        out["bounces"].append(row)
    return out


def final_report(dev, save=None):
    """final_scene (the split route: O for the quads, the glue's row sums
    by B'): :func:`quad_report` and B' on a one-wave training step's row
    and light sums (:func:`reduce_report`)."""
    scene = compile_scene(builders.final_scene(WIDTH / HEIGHT), device=dev)
    key = rng.key(0, dev)
    out = {"quad_search": quad_report(scene, key, save)}
    out["bwd_reduce"] = reduce_report(*step_sums(scene, key))
    return out


def earth_report(dev):
    """random with a procedural 1024x512 earth map (the split route: the
    atlas's 524,288 texel rows among the row sums): B' on a one-wave
    training step's row and light sums (:func:`reduce_report`)."""
    scene = earth_scene(dev)
    sums, parts = step_sums(scene, rng.key(0, dev))
    return {"atlas_rows": int(scene.img_data.shape[0]),
            "bwd_reduce": reduce_report(sums, parts)}


def bwd_report(dev):
    """B' on the flagship's sums of one wave's backward (kernel B's
    winner-row cotangents and light-table partials, a seeded cotangent),
    beside ``index_add_`` of the same found rows."""
    scene = compile_scene(builders.procedural_flagship(), device=dev)
    key = rng.key(0, dev)
    ctx = uber.make_ctx(scene)
    st0, rnd = uber.wave_inputs(scene, rng.wave_key(key, 0), WIDTH, HEIGHT,
                                DEPTH, CHUNK)
    a, b = K.trace_kernel(ctx), K.trace_bwd_kernel(ctx)
    g = torch.randn(st0.shape, generator=torch.Generator(dev).manual_seed(5),
                    device=dev)
    with torch.no_grad():
        _, hist, kind, idx = a(st0, rnd, ctx, DEPTH, residuals=True)
        _, contrib, keys, part = b(hist, rnd, kind, idx, ctx, g)
    p_rows, w = ctx.uni.shape
    found = keys.reshape(-1) < p_rows
    rows = keys.reshape(-1)[found].long()
    terms = contrib.reshape(-1, w)[found]
    call = _reduce_call(contrib.reshape(-1, w), keys.reshape(-1), p_rows,
                        part)
    return {"terms": int(found.numel()), "found": int(found.sum()),
            "width": w, "rows": p_rows, "ms": times(call),
            "index_add_ms": times(lambda: torch.zeros_like(
                ctx.uni).index_add_(0, rows, terms))}


# random columns a found ray's material adjoint reads (csrc/
# trace_bwd_common.cuh shade_fwd / shade_vjp), by material id:
# Lambertian 2 (6 with lights: the light choice and its sample), metal 4
# (the fuzz ball), dielectric 1 (the Fresnel draw), light and isotropic 0
_BWD_RND_COLS = (2, 4, 1, 0, 0)


def bwd_bytes(hist, kind, idx, uni, lt, n_lights, tables=()) -> int:
    """The bytes kernel B (or D' with ``depth`` 1) must move for the
    residuals ``hist`` [depth, 14, N], ``kind``, ``idx`` [depth, N] over
    the winner rows ``uni`` [P, W] and the light table ``lt``, counted from
    the data: every ray-bounce's alive plane; a live ray's kind and beta
    (a miss needs no more); a found ray-bounce's o, d, time, its winner
    index, the randoms its material's adjoint reads and its key and row
    cotangent (W floats) out; once, g in and dst out (14 planes each),
    ``uni``, ``lt``, the ``tables`` (the Perlin tables) and the per-block
    light-table partials out. Every input is read once, every output
    written once. Pure: no device work, any device."""
    depth, _, n = hist.shape
    alive = hist[:, 7] > 0.5
    found = alive & (kind > 0)
    m_found = int(found.sum())
    cols = torch.tensor(_BWD_RND_COLS, dtype=torch.long)
    if n_lights:
        cols[0] = 6
    mat = uni[idx[found].long(), uber.A_COL].long().cpu()
    floats = (depth * n + int(alive.sum()) * 4
              + m_found * (7 + 1 + 1 + uni.shape[1])
              + int(cols[mat].sum()) + 2 * 14 * n + uni.numel() + lt.numel()
              + (n // ROW) * (n_lights + 1) * 14
              + sum(t.numel() for t in tables))
    return floats * 4


def _bits(x):
    """``x`` with its float32 values as their int32 bit patterns."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _bwd_outputs(save, label, out, p_rows):
    """Kernel B's or D''s (dst, contrib, keys, part) into ``save``: the
    contrib rows of the ray-bounces with a winner (key below ``p_rows``),
    zeros elsewhere (those rows are scratch B' never reads)."""
    dst, contrib, keys, part = out
    found = (keys < p_rows)[..., None]
    save[f"{label}.dst"] = dst.cpu()
    save[f"{label}.keys"] = keys.cpu()
    save[f"{label}.part"] = part.cpu()
    save[f"{label}.contrib"] = torch.where(
        found, contrib, torch.zeros_like(contrib)).cpu()


def trace_bwd_report(dev, save=None, seed=5):
    """Kernels B and D' (each scene's variant) on the flagship and random
    (the ``trace_bwd`` part): B on wave 0's residuals (kernel A's, depth
    4), D' on bounces 0 and 1 of kernel D's inputs (D's own output feeds
    bounce 1), each with a seeded cotangent: ms out of L2 and in a loop,
    the live and found ray-bounces, the bytes (:func:`bwd_bytes`) and the
    bound; each in a one-wave training step (:func:`in_path`: B on the
    whole-wave route, D' on the per-chunk one, ``RRT_UBER_WAVE=0``); the
    library's ptxas lines of B and D'."""
    out = {"ptxas": [r for r in ptxas_report(K.build("trace_wave_bwd").log)
                     if "bwd_kernel" in r["function"]]}
    for label, host_fn in (("flagship", builders.procedural_flagship),
                           ("random", lambda: builders.random_scene(
                               WIDTH / HEIGHT))):
        scene = compile_scene(host_fn(), device=dev)
        ctx = uber.make_ctx(scene)
        st0, rnd = uber.wave_inputs(scene, rng.wave_key(rng.key(0, dev), 0),
                                    WIDTH, HEIGHT, DEPTH, CHUNK)
        a, b = K.trace_kernel(ctx), K.trace_bwd_kernel(ctx)
        d, dp = K.fused_bounce_kernel(ctx), K.fused_bounce_bwd_kernel(ctx)
        g = torch.randn(st0.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
        p_rows = ctx.uni.shape[0]
        tables = (ctx.perlin.vec, ctx.perlin.perm)

        def row(kern, hist, kind, idx, call):
            nbytes = bwd_bytes(hist, kind, idx, ctx.uni, ctx.lt,
                               ctx.n_lights, tables)
            alive = hist[:, 7] > 0.5
            return {"kernel": kern.name,
                    "live": int(alive.sum()),
                    "found": int((alive & (kind > 0)).sum()),
                    "bytes": nbytes, "bound_ms": bound_ms(nbytes, 0),
                    "ms": times(call)}

        with torch.no_grad():
            _, hist, kind, idx = a(st0, rnd, ctx, DEPTH, residuals=True)
            args = (hist, rnd, kind, idx, ctx, g)
            rep = {"b": row(b, hist, kind, idx, lambda: b(*args)),
                   "d_prime": []}
            if save is not None:
                _bwd_outputs(save, f"{label}.b", b(*args), p_rows)
            st = st0
            for bb in (0, 1):
                st2, dk, di = d(st, rnd[bb], ctx)
                dargs = (st, rnd[bb], dk, di, ctx, g)
                rep["d_prime"].append({"bounce": bb, **row(
                    dp, st[None], dk[None], di[None],
                    lambda a_=dargs: dp(*a_))})
                if save is not None:
                    _bwd_outputs(save, f"{label}.dp{bb}", dp(*dargs),
                                 p_rows)
                st = st2
        key = rng.key(0, dev)
        rep["in_step"] = {
            "b": in_path(scene, key, ("trace_wave_bwd_kernel",), {},
                         step=True),
            "d_prime": in_path(scene, key, ("fused_bounce_bwd_kernel",),
                               {"RRT_UBER_WAVE": "0"}, step=True)}
        out[label] = rep
    return out


# fp32 operations of the split route's forward kernels (csrc/split.cu),
# counted from the code: J per ray (one kind's attributes and the sphere
# reading of the pack), H per live found ray its shading and update; F
# (and G on a live tile) both a found ray
OPS_HIT, OPS_SHADE = 150, 300
# fp32 operations of the split route's backward kernels (csrc/split.cu):
# J' per ray recomputes J's attributes (~150) and runs the winner's
# adjoint plus the sphere reading's (~2 x 150); H' per found ray
# recomputes the shading (~300) and runs the update's and the shading's
# adjoints (~300); F' (and G' on a live tile) both a found ray. Each is
# bound by its bytes by an order of magnitude, so these estimates do not
# decide the bound
OPS_HIT_BWD, OPS_SU_BWD = 450, 600


def _rnd_cols(n_lights, device):
    """The randoms a found ray's material reads in the backward (H''s and
    F''s count, B's ``_BWD_RND_COLS``): Lambertian 2, or 6 with lights;
    metal 4; dielectric 1."""
    cols = torch.tensor(_BWD_RND_COLS, dtype=torch.long, device=device)
    if n_lights:
        cols[S.MAT_LAMBERTIAN] = 6
    return cols


# random columns a found ray's material reads in the forward shading
# (csrc/trace_common.cuh shade, kernel F's early load): as the backward's
# (_BWD_RND_COLS), and isotropic 4 (its scatter ball)
_FWD_RND_COLS = (2, 4, 1, 0, 4)


def bp_fwd_bytes(calls) -> tuple[int, int]:
    """(bytes, operations) kernel F must move and do on these recorded
    calls (P, pkind, mkind, flags, lt, n_lights), by lane class
    (``bounce_planes_kernel``, ``csrc/split.cu``): every lane reads o, d,
    L, beta and alive (13 planes) and writes 13; a live lane also reads
    its kind; a found lane also reads time, the window, the pack, tmed,
    fuzz, ior and the one albedo leaf that its shading uses (18 planes,
    checker or not: the select at the hit point reads one leaf), its
    material kind and flags and the randoms its material reads
    (Lambertian 2, or 6 with lights; metal 4; dielectric 1; isotropic 4).
    The light table once a launch. Operations: the hit attributes and the shading of each found
    lane (OPS_HIT + OPS_SHADE). ``chip_smoke.py`` counts F's bound with
    it. Pure: no device work."""
    nb = ops = 0
    for P, pkind, mkind, _, lt, n_lights in calls:
        alive = P[45] > 0.5
        found = alive & (pkind != isect.KIND_NONE)
        cols = torch.tensor(_FWD_RND_COLS, dtype=torch.long, device=P.device)
        if n_lights:
            cols[S.MAT_LAMBERTIAN] = 6
        n_found = int(found.sum())
        nb += (P.shape[1] * 26 + int(alive.sum()) + n_found * (18 + 2)
               + int(cols[mkind[found].long()].sum())
               + lt.numel()) * 4
        ops += n_found * (OPS_HIT + OPS_SHADE)
    return nb, ops


def bp_live_bytes(args, tlive) -> tuple[int, int]:
    """(bytes, operations) kernel G must move and do on F's arguments
    ``args`` and the tiles' flags ``tlive`` (1024 lanes a flag): a live
    tile's lanes by F's lane classes (:func:`bp_fwd_bytes`), a dead tile's
    read 13 planes and write 13, the flags once."""
    P, pkind, mkind, flags, lt, n_lights = args
    live = torch.repeat_interleave(tlive > 0, 1024)
    nb, ops = bp_fwd_bytes([(P[:, live], pkind[live], mkind[live],
                             flags[live], lt, n_lights)])
    return nb + (int((~live).sum()) * 26 + tlive.numel()) * 4, ops


def su_bwd_bytes(calls) -> tuple[int, int]:
    """(bytes, operations) kernel H' must move and do on these recorded
    calls (kernel H's arguments: P, mkind, lt, n_lights), by lane class
    (``shade_update_bwd_kernel``, ``csrc/split.cu``): every lane reads its
    alive flag and the cotangents of o', d', L', beta' (13 floats) and
    writes all 40 planes of dP; a live lane also reads its hit flag and
    beta (4); a found lane also reads d, p, n, albedo, fuzz, ior (14), its
    material kind and the randoms its material's adjoint reads
    (Lambertian 2, or 6 with lights; metal 4; dielectric 1). The light
    table in and its cotangent out once a launch, and the per-block
    partials written and read back once. Operations: the recomputed
    shading and both adjoints a found lane (OPS_SU_BWD). ``chip_smoke.py``
    counts H''s bound with it. Pure: no device work."""
    nb = ops = 0
    for P, mkind, lt, n_lights in calls:
        alive = P[38] > 0.5
        found = alive & (P[39] > 0.5)
        n = P.shape[1]
        nb += (n * (13 + 40) + int(alive.sum()) * 4 + int(found.sum()) * 15
               + int(_rnd_cols(n_lights, P.device)[mkind[found].long()]
                     .sum())
               + 2 * lt.numel() + 2 * lt.numel() * (-(-n // ROW))) * 4
        ops += int(found.sum()) * OPS_SU_BWD
    return nb, ops


def bp_bwd_bytes(calls) -> tuple[int, int]:
    """(bytes, operations) kernel F' must move and do on these recorded
    calls (kernel F's arguments: P, pkind, mkind, flags, lt, n_lights), by
    lane class (``bounce_planes_bwd_kernel``, ``csrc/split.cu``): every
    lane reads its alive flag and the 12 cotangents of o', d', L', beta'
    and writes every plane of dP; a live lane also reads its kind and beta
    (4); a found lane also reads o, d, time, the window, the pack, tmed,
    one albedo leaf, fuzz and ior (26), its material kind and flags and
    the randoms its material's adjoint reads. The light table in and its
    partials out once a block, read back by B'. Operations: F's forward
    recomputed and both adjoints a found lane (OPS_HIT_BWD + OPS_SU_BWD).
    ``chip_smoke.py`` counts F''s and G''s bounds with it. Pure: no device
    work."""
    nb = ops = 0
    for P, pkind, mkind, _, lt, n_lights in calls:
        n = P.shape[1]
        alive = P[45] > 0.5
        found = alive & (pkind != isect.KIND_NONE)
        rnd = int(_rnd_cols(n_lights, P.device)[mkind[found].long()].sum())
        nb += (n * (13 + P.shape[0]) + int(alive.sum()) * 4
               + int(found.sum()) * 28 + rnd + lt.numel()
               + 2 * lt.numel() * (-(-n // ROW))) * 4
        ops += int(found.sum()) * (OPS_HIT_BWD + OPS_SU_BWD)
    return nb, ops


def bp_live_bwd_bytes(args, tlive) -> tuple[int, int]:
    """(bytes, operations) kernel G' must move and do on F's arguments
    ``args`` and the tiles' flags ``tlive`` (1024 lanes a flag): a live
    tile's lanes by F''s lane classes (:func:`bp_bwd_bytes`); a dead
    tile's read 12 cotangents and write every input plane's, its blocks a
    zero light-table partial that B' reads; the flags once."""
    P, pkind, mkind, flags, lt, n_lights = args
    live = torch.repeat_interleave(tlive > 0, 1024)
    nb, ops = bp_bwd_bytes([(P[:, live], pkind[live], mkind[live],
                             flags[live], lt, n_lights)])
    n_dead = int((~live).sum())
    return nb + (n_dead * (12 + P.shape[0]) + tlive.numel()
                 + 2 * lt.numel() * (n_dead // ROW)) * 4, ops


# Floats a lane of each material kind reads in kernel I (shade(),
# csrc/trace_common.cuh) beside its kind: Lambertian its normal, albedo and
# randoms 0, 1 (with lights also p and randoms 3, 4, and 5, 6 where it
# samples a light: LAMB_LIGHTS_FWD, LAMB_SAMPLE); metal d, n, albedo, fuzz
# and randoms 7, 9-11; dielectric d, n, ior and random 2; light d, n and
# albedo; isotropic albedo and randoms 8, 12-14.
SHADE_READS = {S.MAT_LAMBERTIAN: 8, S.MAT_METAL: 14, S.MAT_DIELECTRIC: 8,
               S.MAT_LIGHT: 9, S.MAT_ISOTROPIC: 7}
# ... and in kernel I' (shade_fwd + shade_vjp, csrc/trace_bwd_common.cuh),
# with the cotangents each kind's adjoint reads: Lambertian n, albedo,
# randoms 0, 1 and weight's cotangent (with lights as in I); metal d, n,
# randoms 7, 9-11 and the cotangents of weight and direction; dielectric
# d, n, ior, random 2 and direction's; light d, n and emitted's; isotropic
# weight's.
SHADE_BWD_READS = {S.MAT_LAMBERTIAN: 11, S.MAT_METAL: 16,
                   S.MAT_DIELECTRIC: 11, S.MAT_LIGHT: 9, S.MAT_ISOTROPIC: 3}
LAMB_LIGHTS_FWD = 5     # p and randoms 3, 4 of a Lambertian lane with lights
LAMB_SAMPLE = 2         # randoms 5, 6 of a lane that samples a light


def shade_lane_reads(calls, reads) -> int:
    """Floats the lanes of these recorded calls (kernel I's arguments:
    data, rng, kind, lt, n_lights) read by material kind (``reads``), the
    light-mixture inputs of Lambertian lanes included, from this run's
    kinds and randoms."""
    total = 0
    for _, rng_p, kind, _, n_lights in calls:
        total += sum(reads[k] * int((kind == k).sum()) for k in reads)
        if n_lights:
            lam = kind == S.MAT_LAMBERTIAN
            total += (LAMB_LIGHTS_FWD * int(lam.sum())
                      + LAMB_SAMPLE * int((lam & (rng_p[3] >= 0.5)).sum()))
    return total


def shade_bwd_bytes(calls) -> int:
    """Bytes kernel I' must move on these recorded calls: every lane its
    kind in and its 14 data-plane cotangents out, and what its material's
    adjoint reads (``SHADE_BWD_READS``); the light table in once, and the
    per-block partials written and read back once with their sum out.
    ``chip_smoke.py`` counts I''s bound with it. Pure: no device work."""
    return 4 * (shade_lane_reads(calls, SHADE_BWD_READS)
                + sum(data.shape[1] * (1 + 14) + lt.numel()
                      + 2 * lt.numel() * (-(-data.shape[1] // ROW))
                      + lt.numel() for data, _, _, lt, _ in calls))


def shade_fwd_bytes(calls) -> int:
    """Bytes kernel I must move on these recorded calls: every lane its
    kind in and its 10 planes out, and what its material reads
    (``SHADE_READS``); the light table once a launch. ``chip_smoke.py``
    counts I's bound with it. Pure: no device work."""
    return 4 * (shade_lane_reads(calls, SHADE_READS)
                + sum(data.shape[1] * (1 + 10) + lt.numel()
                      for data, _, _, lt, _ in calls))


# fp32 operations of kernel I's mixture pdf by stage (csrc/shade.cu
# CandidateLights, sphere_candidate_pdf; light_pdf in trace_common.cuh),
# counted from the code: each sphere light's discriminant on every
# Lambertian lane of the mixture (the offset 3, bb 5, cc 7, disc 3 and the
# compare: 19; |sd|^2 once a lane); each candidate sphere's full test past
# it (safe_sqrt 4, the clamp of aa, the far root 2 and its compare, the
# centre offset 3, dist_sq 5, cos_max 9, the solid angle 2 and its
# reciprocal 2: 29); a quad light, always a candidate, its whole area pdf
# (the normal 9, |n|^2 5, the denominator and its guard 8, t 9, the point
# 9, alpha and beta 32, the compares 7, the area 4, the distance 8, the
# cosine 13, the pdf 3: 107)
OPS_LIGHT_DISC, OPS_SPHERE_FULL, OPS_QUAD_PDF = 19, 29, 107


def shade_work(calls) -> dict:
    """Kernel I's work by stage on these recorded calls (kernel I's
    arguments: data, rng, kind, lt, n_lights), per bounce: the lanes, the
    Lambertian lanes of the mixture pdf and, from the tree's replay of I's
    order (``ops/shade.shade_candidates_replay``, where the tree has it),
    their candidate lights: the total, the mean a Lambertian lane, the
    mean over the warps that hold one of a 32-lane warp's most (the
    iterations its pass 2 runs) and the largest; and the operations: the
    shading of every lane (OPS_SHADE), each sphere light's discriminant a
    Lambertian lane (OPS_LIGHT_DISC), each candidate sphere's full test
    (OPS_SPHERE_FULL), each quad light's pdf (OPS_QUAD_PDF). Without the
    replay the candidates and the operations are None. Sums over the
    bounces in ``total``."""
    from rust_ray_tracer_tpu_torch.ops import shade as shade_ops

    replay = getattr(shade_ops, "shade_candidates_replay", None)
    rows = []
    for data, rng_p, kind, lt, n_lights in calls:
        n = data.shape[1]
        lam = (kind == S.MAT_LAMBERTIAN) & (n_lights > 0)
        n_lam = int(lam.sum())
        kinds = lt[:n_lights, 0]
        n_sph = int((kinds == S.LIGHT_SPHERE).sum())
        n_quad = int((kinds == S.LIGHT_QUAD).sum())
        row = {"lanes": n, "lambertian": n_lam, "lights": n_lights,
               "candidates": None, "ops": None}
        if replay is not None:
            _, n_cand = replay(data, rng_p, kind, lt, n_lights)
            pad = -n % WARP
            most = torch.nn.functional.pad(n_cand, (0, pad)).reshape(
                -1, WARP).amax(1)
            held = torch.nn.functional.pad(lam, (0, pad)).reshape(
                -1, WARP).any(1)
            cand = int(n_cand.sum())
            stages = {"shading": n * OPS_SHADE,
                      "discriminants": n_lam * n_sph * OPS_LIGHT_DISC,
                      "full_tests": (cand - n_lam * n_quad) * OPS_SPHERE_FULL
                      + n_lam * n_quad * OPS_QUAD_PDF}
            row.update(candidates=cand,
                       mean_candidates=cand / n_lam if n_lam else 0.0,
                       warp_most_mean=float(most[held].float().mean())
                       if bool(held.any()) else 0.0,
                       warp_most_max=int(most.max()),
                       ops_by_stage=stages, ops=sum(stages.values()))
        rows.append(row)
    ops = [r["ops"] for r in rows]
    return {"per_bounce": rows,
            "total": {"lanes": sum(r["lanes"] for r in rows),
                      "ops": None if None in ops else sum(ops)}}


# Floats a found lane of each material kind reads in kernel H (shade() and
# update_found(), csrc/trace_common.cuh) beside its kind and the state every
# lane carries (o, d, L, beta), by material kind as SHADE_READS counts I's:
# Lambertian p, n, albedo; metal p, n, albedo, fuzz; dielectric p, n, ior;
# light n, albedo (its path ends, so o keeps its value); isotropic p and
# albedo. Its randoms on top (_FWD_RND_COLS; with lights a Lambertian lane
# also reads randoms 3, 4 and, where it samples a light, 5, 6).
SU_READS = (9, 10, 7, 6, 6)


def su_fwd_bytes(calls) -> tuple[int, int]:
    """(bytes, operations) kernel H must move and do on these recorded
    calls (P, mkind, lt, n_lights), by lane class
    (``shade_update_kernel``, ``csrc/split.cu``): every lane reads o, d,
    L, beta and alive (13 planes) and writes 13; a live lane also reads
    its hit flag; a found lane also reads its material kind, what its
    shading reads by kind (``SU_READS``) and its material's randoms. The
    light table once a launch. Operations: the shading of each found lane
    (OPS_SHADE). ``chip_smoke.py`` counts H's bound with it. Pure: no
    device work."""
    nb = ops = 0
    for P, mkind, lt, n_lights in calls:
        alive = P[38] > 0.5
        found = alive & (P[39] > 0.5)
        per_kind = 1 + torch.tensor(SU_READS, dtype=torch.long,
                                    device=P.device) + torch.tensor(
            _FWD_RND_COLS, dtype=torch.long, device=P.device)
        nb += (P.shape[1] * 26 + int(alive.sum())
               + int(per_kind[mkind[found].long()].sum()) + lt.numel()) * 4
        if n_lights:
            lam = found & (mkind == S.MAT_LAMBERTIAN)
            nb += (2 * int(lam.sum())
                   + LAMB_SAMPLE * int((lam & (P[26] >= 0.5)).sum())) * 4
        ops += int(found.sum()) * OPS_SHADE
    return nb, ops


# the H100's multiprocessor (compute capability 9.0): registers, threads,
# blocks and shared memory (bytes; each block reserves 1 KB more)
SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM, BLOCK_SMEM_RESERVED = (
    65536, 2048, 32, 233472, 1024)


def resident_blocks(registers: int, smem: int, threads: int = ROW) -> int:
    """Blocks of ``threads`` an H100 multiprocessor holds at once for a
    kernel of ``registers`` a thread (allocated per warp in units of 256)
    and ``smem`` bytes of shared memory a block (static and dynamic):
    the CUDA occupancy rules, from the ptxas counts."""
    warps = -(-threads // WARP)
    per_warp = -(-registers * WARP // 256) * 256
    by_regs = (SM_REGS // per_warp) // warps if per_warp else SM_BLOCKS
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
    return min(by_regs, by_smem, SM_THREADS // threads, SM_BLOCKS)


# the split route's kernels whose resident blocks :func:`occupancy`
# reports: a pattern of the ptxas name -> (library, the library's
# occupancy query, whether it takes the light count, the dynamic shared
# memory a block of a tree without the query: none for F, F', H' and H
# (H's table is static), a row of 14 n_lights + 1 floats a ray and the
# table for I', the table for I)
_OCCUPANCY = {
    "bounce_planes_kernel": ("split", "bounce_planes_occupancy", False,
                             lambda nl: 0),
    "bounce_planes_bwd_kernel": ("split", "bounce_planes_bwd_occupancy",
                                 True, lambda nl: 0),
    "shade_update_bwd_kernel": ("split", "shade_update_bwd_occupancy", True,
                                lambda nl: 0),
    "shade_bwd_kernel": ("shade", "shade_bwd_occupancy", True,
                         lambda nl: 4 * (14 * nl + ROW * (14 * nl + 1))),
    "shade_kernel": ("shade", "shade_occupancy", True, lambda nl: 4 * 14 * nl),
    "shade_update_kernel": ("split", "shade_update_occupancy", False,
                            lambda nl: 0),
}


def occupancy(line, n_lights) -> dict:
    """Resident blocks per multiprocessor of F (G), F' (G'), H', I', I or H
    (the ptxas ``line`` of its function) at ``n_lights``: the library's
    occupancy query (``bounce_planes_occupancy``,
    ``bounce_planes_bwd_occupancy``, ``shade_update_bwd_occupancy``,
    ``shade_bwd_occupancy``, ``shade_occupancy``,
    ``shade_update_occupancy``: the CUDA runtime's calculator) beside
    :func:`resident_blocks` of the ptxas counts; a tree without the query
    by the formula alone (``_OCCUPANCY``)."""
    import ctypes

    name = next(k for k in _OCCUPANCY
                if re.search(rf"\d{k}E", line["function"]))
    library, entry, lights, smem = _OCCUPANCY[name]
    lib = ctypes.CDLL(str(K.build(library).path))
    res = {"kernel": name, "n_lights": n_lights}
    if hasattr(lib, entry):
        out = (ctypes.c_int * 2)()
        args = (ctypes.c_int(n_lights), out) if lights else (out,)
        err = getattr(lib, entry)(*args)
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        res.update(blocks=out[0], dynamic_smem=out[1], by="runtime")
    else:
        res.update(dynamic_smem=smem(n_lights), by="formula")
    res["formula_blocks"] = resident_blocks(
        line["registers"], line["smem"] + res["dynamic_smem"])
    return res


def ptxas_lines(pattern) -> list[dict]:
    """The ptxas lines of library ``split``'s and ``shade``'s kernels
    whose names match ``pattern``."""
    return [r for lib in ("split", "shade")
            for r in ptxas_report(K.build(lib).log)
            if re.search(pattern, r["function"])]


def kernel_ptxas_line(name) -> dict:
    """The ptxas line of kernel ``name`` of library ``split`` or
    ``shade``."""
    lines = ptxas_lines(rf"\d{name}E")
    if not lines:
        raise AssertionError(f"no ptxas line of {name}")
    return lines[0]


def kernel_ptxas(name, n_lights=0) -> dict:
    """The ptxas line (registers, stack frame, spills, static shared
    memory) of kernel ``name`` of library ``split`` or ``shade``, with its
    resident blocks an SM at ``n_lights`` (:func:`occupancy`)."""
    line = kernel_ptxas_line(name)
    return {**line, "occupancy": occupancy(line, n_lights)}


def _seeded(shape, seed, dev):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@contextlib.contextmanager
def _live_recorder():
    """Records the arguments of each call of ``ops/bounce.
    bounce_planes_live`` (kernel G's dispatcher) in the yielded list."""
    from rust_ray_tracer_tpu_torch.ops import bounce

    calls, real = [], bounce.bounce_planes_live

    def recorded(*args):
        calls.append(args)
        return real(*args)

    bounce.bounce_planes_live = recorded
    try:
        yield calls
    finally:
        bounce.bounce_planes_live = real


def _bwd_rows(kern, calls, seed, extra, save, label, nbytes):
    """``kern`` (F', G' or I') on each recorded call with a seeded
    cotangent: ms out of L2 and in a loop alone (``partials``) and with
    B''s sum of its partials, the bytes and the bound; with ``save`` its
    outputs (dP or d_data, and the partials) under ``label``."""
    rows = []
    for b, args in enumerate(calls):
        n = args[0].shape[1]
        cots = 9 if kern is K.shade_bwd_kernel else 13
        g = _seeded((cots, n), seed + b, args[0].device)
        a = args + extra[b] + (g,)
        with torch.no_grad():
            nb = nbytes(args, extra[b])
            rows.append({"bounce": b, "lanes": n, "bytes": nb,
                         "bound_ms": bound_ms(nb, 0),
                         "ms": times(lambda a=a: kern.partials(*a)),
                         "ms_with_sum": times(lambda a=a: kern(*a))})
            if save is not None:
                d, part = kern.partials(*a)
                save[f"{label}{b}.d"] = d.cpu()
                save[f"{label}{b}.part"] = part.cpu()
                save[f"{label}{b}.dlt"] = kern(*a)[1].cpu()
    return rows


def _fwd_rows(kern, calls, save, label, count):
    """``kern`` (F, G, H or I) on each recorded call's arguments: ms out of
    L2 and in a loop beside ``count(call)``, a dict whose ``bytes`` and
    ``ops`` give the bound (none where ``ops`` is None); with ``save`` its
    output under ``label``."""
    rows = []
    for b, args in enumerate(calls):
        with torch.no_grad():
            row = {"bounce": b, **count(args)}
            row["bound_ms"] = (bound_ms(row["bytes"], row["ops"])
                               if row["ops"] is not None else None)
            row["ms"] = times(lambda a=args: kern(*a))
            rows.append(row)
            if save is not None:
                save[f"{label}{b}.out"] = kern(*args).cpu()
    return rows


def _bp_count(args):
    """F's (six arguments) or G's (seven: the tiles' flags last) lanes,
    bytes and operations on one recorded call."""
    P, pkind = args[0], args[1]
    alive = P[45] > 0.5
    nb, ops = (bp_live_bytes(args[:6], args[6]) if len(args) > 6
               else bp_fwd_bytes([args]))
    return {"lanes": P.shape[1], "live": int(alive.sum()),
            "found": int((alive & (pkind != isect.KIND_NONE)).sum()),
            "bytes": nb, "ops": ops}


def _record(scene, env=None, live=False):
    """(key, the recorded calls) of wave 0 of ``scene`` at the bench wave
    under the route flags ``env``: the split route's dispatchers'
    (``torch_parity.split_recorder``) or, with ``live``, kernel G's
    (:func:`_live_recorder`), after a warm-up render."""
    key = rng.key(0, scene.tri_v0.device)
    with _env(env or {}), torch.no_grad():
        render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                     chunk_size=CHUNK)
        with (_live_recorder() if live
              else _parity().split_recorder()) as rec:
            render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                         chunk_size=CHUNK)
    torch.cuda.synchronize()
    return key, rec


def _bp_nbytes(args, extra):
    """F''s or G''s bytes on one recorded call (G' with ``extra``, the
    tiles' flags)."""
    return (bp_live_bwd_bytes(args, *extra) if extra
            else bp_bwd_bytes([args]))[0]


UNFUSED_ENV = {"RRT_NO_UBER_FUSED": "1", "RRT_UBER_WAVE": "0"}


def split_bwd_report(dev, save=None, seed=11):
    """Kernels F', G' and I' (the ``split_bwd`` part): F' on the mesh's
    recorded calls of wave 0 (bounces 0-3), G' on the unfused flagship's
    (``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0``), I' on the 9-light glTF
    flagship's and on its 16-light twin's; each with a seeded cotangent,
    out of L2 and in a loop, alone and with B''s sum of its partials,
    beside its byte bound (:func:`bp_bwd_bytes`, :func:`shade_bwd_bytes`),
    and in a one-wave training step (:func:`in_path`); the ptxas lines of
    the two kernels with their resident blocks at the cells' light
    counts."""
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene

    lines = ptxas_lines(r"bounce_planes_bwd_kernel|shade_bwd_kernel")
    out = {"ptxas": lines,
           "occupancy": [occupancy(r, nl) for r in lines
                         for nl in ((9, 16) if "shade" in r["function"]
                                    else (1, 8))]}

    # F' on the mesh
    scene = mesh_scene(dev)
    key, rec = _record(scene)
    calls = rec["bp"]
    out["mesh_f_prime"] = {
        "bounces": _bwd_rows(K.bounce_planes_bwd_kernel, calls, seed,
                             [()] * len(calls), save, "fp", _bp_nbytes),
        "in_step": in_path(scene, key, ("bounce_planes_bwd_kernel",), {},
                           step=True)}
    del rec, calls, scene

    # G' on the unfused flagship
    scene = compile_scene(builders.procedural_flagship(), device=dev)
    key, calls = _record(scene, UNFUSED_ENV, live=True)
    args = [c[:6] for c in calls]
    tlive = [(c[6],) for c in calls]
    out["unfused_g_prime"] = {
        "bounces": _bwd_rows(K.bounce_planes_live_bwd_kernel, args, seed,
                             tlive, save, "gp", _bp_nbytes),
        "dead_tiles": [int((t[0] == 0).sum()) for t in tlive],
        "in_step": in_path(scene, key, ("bounce_planes_bwd_kernel",),
                           UNFUSED_ENV, step=True)}
    del calls, args, tlive, scene

    # I' on the glTF flagship at 9 and 16 lights
    for nl in (9, 16):
        with tempfile.TemporaryDirectory() as tmp:
            path = _parity().write_gltf_flagship(
                os.path.join(tmp, f"f{nl}.gltf"), nl)
            scene = compile_scene(load_gltf_scene(path, WIDTH / HEIGHT),
                                  device=dev)
        key, rec = _record(scene)
        calls = rec["shade"]
        out[f"gltf{nl}_i_prime"] = {
            "bounces": _bwd_rows(K.shade_bwd_kernel, calls, seed,
                                 [()] * len(calls), save, f"ip{nl}.",
                                 lambda a, _: shade_bwd_bytes([a])),
            "in_step": in_path(scene, key, ("shade_bwd_kernel",), {},
                               step=True)}
        del rec, calls, scene
    return out


def split_fwd_report(dev, save=None):
    """Kernels F and G (the ``split_fwd`` part): F on the mesh's recorded
    calls of wave 0 (bounces 0-3), G on the unfused flagship's
    (``RRT_NO_UBER_FUSED=1 RRT_UBER_WAVE=0``); each out of L2 and in a
    loop beside its bound (:func:`bp_fwd_bytes`, :func:`bp_live_bytes`),
    and in a one-wave forward render (:func:`in_path`); the ptxas line of
    ``bounce_planes_kernel`` with its resident blocks an SM."""
    lines = ptxas_lines(r"\dbounce_planes_kernelE")
    out = {"ptxas": lines, "occupancy": [occupancy(r, 0) for r in lines]}
    scene = mesh_scene(dev)
    key, rec = _record(scene)
    calls = rec["bp"]
    out["mesh_f"] = {
        "bounces": _fwd_rows(K.bounce_planes_kernel, calls, save, "f",
                             _bp_count),
        "in_path": in_path(scene, key, ("bounce_planes_kernel",), {})}
    del rec, calls, scene

    scene = compile_scene(builders.procedural_flagship(), device=dev)
    key, calls = _record(scene, UNFUSED_ENV, live=True)
    out["unfused_g"] = {
        "bounces": _fwd_rows(K.bounce_planes_live_kernel, calls, save,
                             "g", _bp_count),
        "dead_tiles": [int((c[6] == 0).sum()) for c in calls],
        "in_path": in_path(scene, key, ("bounce_planes_kernel",),
                           UNFUSED_ENV)}
    return out


def su_bwd_report(dev, save=None, seed=11):
    """Kernel H' (the ``su_bwd`` part) on final_scene's and random earth's
    recorded calls of kernel H of wave 0 (bounces 0-3), each with a seeded
    cotangent: out of L2 and in a loop, alone (``partials``) and with B''s
    sum of its partials, beside its bound (:func:`su_bwd_bytes`), and in a
    one-wave training step (:func:`in_path`); the ptxas line of
    ``shade_update_bwd_kernel`` with its resident blocks at the scenes'
    light counts."""
    lines = ptxas_lines(r"shade_update_bwd_kernel")
    out = {"ptxas": lines}
    scenes = (("final", lambda: compile_scene(
        builders.final_scene(WIDTH / HEIGHT), device=dev)),
              ("earth", lambda: earth_scene(dev)))
    for label, make in scenes:
        scene = make()
        key, rec = _record(scene)
        calls = rec["su"]
        out[f"{label}_h_prime"] = {
            "n_lights": scene.n_lights,
            "occupancy": [occupancy(r, scene.n_lights) for r in lines],
            "bounces": _bwd_rows(K.shade_update_bwd_kernel, calls, seed,
                                 [()] * len(calls), save, f"hp{label}",
                                 lambda a, _: su_bwd_bytes([a])[0]),
            "in_step": in_path(scene, key, ("shade_update_bwd_kernel",), {},
                               step=True)}
        del rec, calls, scene
    return out


def _shade_count(args):
    w = shade_work([args])["per_bounce"][0]
    return {**w, "bytes": shade_fwd_bytes([args])}


def shade_fwd_report(dev, save=None):
    """Kernel I (the ``shade_fwd`` part) on the 9-light glTF flagship's
    recorded calls of wave 0 (bounces 0-3) and on its 16-light twin's: out
    of L2 and in a loop beside its bound (:func:`shade_fwd_bytes` and the
    operations by stage of :func:`shade_work`, with each bounce's
    candidate lights), and in a one-wave forward render (:func:`in_path`);
    the ptxas line of ``shade_kernel`` with its resident blocks at 9 and
    16 lights. ``--save`` keeps I's output planes."""
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene

    out = {"ptxas": [kernel_ptxas("shade_kernel", nl) for nl in (9, 16)]}
    for nl in (9, 16):
        with tempfile.TemporaryDirectory() as tmp:
            path = _parity().write_gltf_flagship(
                os.path.join(tmp, f"f{nl}.gltf"), nl)
            scene = compile_scene(load_gltf_scene(path, WIDTH / HEIGHT),
                                  device=dev)
        key, rec = _record(scene)
        out[f"gltf{nl}_i"] = {
            "bounces": _fwd_rows(K.shade_kernel, rec["shade"], save,
                                 f"i{nl}.", _shade_count),
            "in_path": in_path(scene, key, ("shade_kernel",), {})}
        del rec, scene
    return out


def _su_count(args):
    P = args[0]
    alive = P[38] > 0.5
    nb, ops = su_fwd_bytes([args])
    return {"lanes": P.shape[1], "live": int(alive.sum()),
            "found": int((alive & (P[39] > 0.5)).sum()), "bytes": nb,
            "ops": ops}


def su_fwd_report(dev, save=None):
    """Kernel H (the ``su_fwd`` part) on final_scene's and random earth's
    recorded calls of wave 0 (bounces 0-3): the live and found lanes, out
    of L2 and in a loop beside its bound (:func:`su_fwd_bytes`), and in a
    one-wave forward render (:func:`in_path`); the ptxas line of
    ``shade_update_kernel`` with its resident blocks an SM. ``--save``
    keeps H's output planes."""
    out = {"ptxas": kernel_ptxas("shade_update_kernel")}
    scenes = (("final", lambda: compile_scene(
        builders.final_scene(WIDTH / HEIGHT), device=dev)),
              ("earth", lambda: earth_scene(dev)))
    for label, make in scenes:
        scene = make()
        key, rec = _record(scene)
        out[f"{label}_h"] = {
            "n_lights": scene.n_lights,
            "bounces": _fwd_rows(K.shade_update_kernel, rec["su"], save,
                                 f"h{label}", _su_count),
            "in_path": in_path(scene, key, ("shade_update_kernel",), {})}
        del rec, scene
    return out


# Floats kernel J moves a lane: its 19 input planes, kind and flip in and
# 12 planes out; J' also reads J's 12 output cotangents and writes 19
# planes (csrc/split.cu hit_attrs_kernel, hit_attrs_bwd_kernel)
HIT_FLOATS, HIT_BWD_FLOATS = 19 + 2 + 12, 19 + 2 + 12 + 19
# the odd ray counts J and J' are held at beside the wave's (hit_lanes of
# a recorded call): neither a multiple of 4 (a plane then starts off 16
# bytes) nor of the 128-ray tile
HIT_ODD_N = (1001, 129)


def hit_bytes(calls, bwd=False) -> tuple[int, int]:
    """(bytes, operations) kernel J (with ``bwd``, J') must move and do on
    these recorded calls of J (P, kind, flip): every lane reads its 19
    planes, kind and flip and writes 12 planes (J' also reads the 12
    cotangents and writes 19 planes, the zero tmin and tmax rows
    included); OPS_HIT (OPS_HIT_BWD) operations a lane. ``chip_smoke.py``
    counts J's and J''s bounds with it. Pure: no device work."""
    lanes = sum(c[0].shape[1] for c in calls)
    if bwd:
        return HIT_BWD_FLOATS * 4 * lanes, OPS_HIT_BWD * lanes
    return HIT_FLOATS * 4 * lanes, OPS_HIT * lanes


def copy_times(nbytes, dev):
    """ms of one torch copy whose traffic (reads plus writes) is
    ``nbytes``: nbytes / 2 of float32 copied into another tensor, out of
    L2 and in a loop (:func:`times`). The card's practical floor for that
    traffic, beside the bound at HBM's published rate."""
    src = torch.ones(nbytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    return times(lambda: dst.copy_(src))


def hit_occupancy(name, n) -> dict:
    """Kernel ``name``'s (``hit_attrs_kernel`` or ``hit_attrs_bwd_kernel``)
    launch over ``n`` rays: its resident blocks an SM, dynamic shared
    memory a block, grid, the tiles (128 rays) a block walks and the rounds
    of resident blocks the grid takes; from the library's query
    (``hit_attrs_occupancy``, ``hit_attrs_bwd_occupancy``: the CUDA
    runtime's calculator) where the tree has it, else (a tree that launches
    a block a tile) :func:`resident_blocks` of the ptxas counts, which are
    given beside the query's too."""
    import ctypes

    line = kernel_ptxas_line(name)
    lib = ctypes.CDLL(str(K.build("split").path))
    entry = name.replace("_kernel", "_occupancy")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-n // ROW)
    res = {"kernel": name, "lanes": n}
    if hasattr(lib, entry):
        out = (ctypes.c_int * 3)()
        err = getattr(lib, entry)(ctypes.c_int(n), out)
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        res.update(blocks=out[0], dynamic_smem=out[1], grid=out[2],
                   by="runtime")
    else:
        res.update(blocks=resident_blocks(line["registers"], line["smem"]),
                   dynamic_smem=0, grid=tiles, by="formula")
    res["formula_blocks"] = resident_blocks(
        line["registers"], line["smem"] + res["dynamic_smem"])
    res["tiles_a_block"] = -(-tiles // res["grid"])
    res["rounds"] = res["grid"] / (res["blocks"] * sms)
    return res


def hit_ptxas(name, n) -> dict:
    """The ptxas line of kernel J or J' (``name``) with its launch over
    ``n`` rays (:func:`hit_occupancy`)."""
    return {**kernel_ptxas_line(name), "occupancy": hit_occupancy(name, n)}


def _hit_cots(kind, seed):
    """J''s cotangents for a recorded call of J (``torch_parity.
    split_cots``: normal draws, the sphere-UV source's on sphere lanes
    only)."""
    return _parity().split_cots(kind, 1, seed)[0]


def _hit_rows(calls, bwd, seed, save, label):
    """J (with ``bwd``, J' with :func:`_hit_cots` of ``seed`` + bounce) on
    each recorded call: ms out of L2 and in a loop beside the bound
    (:func:`hit_bytes`) and a copy of the same bytes (:func:`copy_times`);
    with ``save`` the output under ``label``."""
    kern = K.hit_attrs_bwd_kernel if bwd else K.hit_attrs_kernel
    rows = []
    for b, (P, kind, flip) in enumerate(calls):
        args = (P, kind, flip) + ((_hit_cots(kind, seed + b),) if bwd
                                  else ())
        nb, ops = hit_bytes([(P, kind, flip)], bwd)
        with torch.no_grad():
            rows.append({"bounce": b, "lanes": P.shape[1], "bytes": nb,
                         "ops": ops, "bound_ms": bound_ms(nb, ops),
                         "copy_ms": copy_times(nb, P.device),
                         "ms": times(lambda a=args: kern(*a))})
            if save is not None:
                save[f"{label}{b}.out"] = kern(*args).cpu()
    return rows


def hit_lanes(call, m):
    """``m`` lanes of a recorded call of kernel J (P, kind, flip) spread
    over all of its lanes (lane j (n // m) in column j), each contiguous:
    an odd ray count for J and J'."""
    P, kind, flip = call
    lanes = torch.arange(m, device=P.device) * (P.shape[1] // m)
    return (P[:, lanes].contiguous(), kind[lanes].contiguous(),
            flip[lanes].contiguous())


def hit_odd_rows(call, seed, save):
    """J and J' on ``hit_lanes`` of one recorded call of J for each n of
    ``HIT_ODD_N`` and for all its lanes but the last: ms out of L2 and in
    a loop, the outputs under ``jodd<n>`` and ``jpodd<n>`` with
    ``save``."""
    P = call[0]
    rows = []
    for m in HIT_ODD_N + (P.shape[1] - 1,):
        a = hit_lanes(call, m)
        g = _hit_cots(a[1], seed)
        with torch.no_grad():
            rows.append({"lanes": m,
                         "j_ms": times(lambda: K.hit_attrs_kernel(*a)),
                         "j_prime_ms": times(
                             lambda: K.hit_attrs_bwd_kernel(*a, g))})
            if save is not None:
                save[f"jodd{m}.out"] = K.hit_attrs_kernel(*a).cpu()
                save[f"jpodd{m}.out"] = K.hit_attrs_bwd_kernel(*a, g).cpu()
    return rows


def cat_before(scene, key, name="hit_attrs_kernel", cat="CatArrayBatched"):
    """Device ms per launch, over a profiled one-wave forward render of
    ``scene``, of the last ``torch.cat`` kernel (a profiler name holding
    ``cat``) before each launch of kernel ``name``: for J, the cat that
    packs its 19 planes (``ops/hit.hit_attrs_fused``; the kind and flip
    casts run between)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        with torch.no_grad():
            render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                         chunk_size=CHUNK)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    ds, last = [], None
    for e in kern:
        if cat in e.name:
            last = e
        elif name in e.name and last is not None:
            ds.append(last.time_range.elapsed_us() / 1e3)
            last = None
    return {"ms_per_launch": sum(ds) / len(ds) if ds else None,
            "launches": len(ds)}


def hit_report(dev, parts, save=None, seed=13):
    """Kernels J (``hit_fwd``) and J' (``hit_bwd``) on the recorded calls of
    kernel J of wave 0 (bounces 0-3) of final_scene and random earth, J
    also on the 9-light glTF flagship's; J' with :func:`_hit_cots` of
    ``seed`` + bounce. Each out of L2 and in a loop beside its bound
    (:func:`hit_bytes`) and a copy of the same bytes (:func:`copy_times`),
    and in a one-wave forward render (J, with the device ms of the
    ``torch.cat`` that packs its planes, :func:`cat_before`) or training
    step (J'); the ptxas lines and the launch at the wave's lanes
    (:func:`hit_ptxas`: resident blocks, grid, rounds); J and J' at odd
    lane counts on final_scene's bounce 0 (:func:`hit_odd_rows`).
    ``--save`` keeps every output."""
    fwd, bwd = "hit_fwd" in parts, "hit_bwd" in parts
    scenes = [("final", lambda: compile_scene(
        builders.final_scene(WIDTH / HEIGHT), device=dev)),
              ("earth", lambda: earth_scene(dev))]
    if fwd:
        scenes.append(("gltf9", lambda: gltf9_scene(dev)))
    n = WIDTH * HEIGHT
    out = {"ptxas": [hit_ptxas(k, n) for k, on in (
        ("hit_attrs_kernel", fwd), ("hit_attrs_bwd_kernel", bwd)) if on]}
    for label, make in scenes:
        scene = make()
        key, rec = _record(scene)
        calls = rec["hit"]
        rep = {"kinds": [torch.bincount(c[1].long(), minlength=5).tolist()
                         for c in calls]}
        if fwd:
            rep["j"] = {"bounces": _hit_rows(calls, False, seed, save,
                                             f"j{label}"),
                        "in_path": in_path(scene, key, ("hit_attrs_kernel",),
                                           {}),
                        "cat_in_path": cat_before(scene, key)}
        if bwd and label != "gltf9":
            rep["j_prime"] = {
                "bounces": _hit_rows(calls, True, seed, save, f"jp{label}"),
                "in_step": in_path(scene, key, ("hit_attrs_bwd_kernel",), {},
                                   step=True)}
        if label == "final":
            rep["odd"] = hit_odd_rows(calls[0], seed, save)
        out[label] = rep
        del rec, calls, scene
    return out


def compare(paths):
    first = torch.load(paths[0])
    for p in paths[1:]:
        other = torch.load(p)
        diff = {}
        for k in first:
            ne = _bits(first[k]) != _bits(other[k])
            diff[k] = (int(ne.reshape(ne.shape[0], -1).any(0).sum())
                       if ne.dim() > 1 else int(ne.sum()))
        print(json.dumps({"vs": paths[0], "file": p,
                          "bitwise": all(v == 0 for v in diff.values()),
                          "lanes_differing": diff}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out")
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs="+")
    ap.add_argument("--scenes", default="flagship,random,mesh,tri,gltf",
                    help="comma-separated parts: flagship, random, mesh, "
                         "tri, gltf, sph, final, earth, bwd, trace_bwd, "
                         "split_bwd, split_fwd, su_bwd, su_fwd, shade_fwd, "
                         "hit_fwd, hit_bwd, bigmesh")
    ap.add_argument("--check", action="store_true",
                    help="hold M's winners on every mesh bounce against "
                         "the plain version")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare)
    if not torch.cuda.is_available():
        print("search_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    builds = K.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    save = {}
    parts = args.scenes.split(",")
    res = {"label": args.label, "card": smi,
           "trace_wave_flags": list(K.LIBRARIES["trace_wave"][1]),
           "ptxas": {n: ptxas_report(builds[n].log)
                     for n in ("trace_wave", "trace_wave_noise", "search",
                               "sphere", "trace_wave_bwd", "split",
                               "shade")}}
    if "flagship" in parts:
        res["flagship"] = scene_times(
            "flagship", builders.procedural_flagship, dev, save)
    if "random" in parts:
        res["random"] = scene_times(
            "random", lambda: builders.random_scene(WIDTH / HEIGHT), dev,
            save)
    if "mesh" in parts:
        res["mesh"] = mesh_report(dev, save, "mesh", args.check)
    if "tri" in parts:
        res["tri"] = wave_report(tri_scene(dev), K.tri_search_kernel, "tri")
    if "gltf" in parts:
        res["gltf9"] = wave_report(gltf9_scene(dev), K.fused_search_kernel,
                                   "search")
    if "final" in parts:
        res["final"] = final_report(dev, save)
    if "sph" in parts:
        res["sph"] = sph_report(dev, save)
    if "earth" in parts:
        res["earth"] = earth_report(dev)
    if "bwd" in parts:
        res["bwd"] = bwd_report(dev)
    if "trace_bwd" in parts:
        res["trace_bwd"] = trace_bwd_report(dev, save)
    if "split_bwd" in parts:
        res["split_bwd"] = split_bwd_report(dev, save)
    if "split_fwd" in parts:
        res["split_fwd"] = split_fwd_report(dev, save)
    if "su_bwd" in parts:
        res["su_bwd"] = su_bwd_report(dev, save)
    if "su_fwd" in parts:
        res["su_fwd"] = su_fwd_report(dev, save)
    if "shade_fwd" in parts:
        res["shade_fwd"] = shade_fwd_report(dev, save)
    if "hit_fwd" in parts or "hit_bwd" in parts:
        res["hit"] = hit_report(dev, parts, save)
    if "bigmesh" in parts:
        res["bigmesh"] = bigmesh_report(dev, save)
    res["sms"] = torch.cuda.get_device_properties(dev).multi_processor_count
    res["grid_blocks"] = math.ceil(WIDTH * HEIGHT / ROW)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)),
                    exist_ok=True)
        torch.save(save, args.save)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
