"""Times of the search kernels of library ``trace_wave`` (TPU kernels A, D
and E, and the noise variants of A and D) and of library ``search`` (K
and M, with the unified search's sort of the rays) on one CUDA card, for
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

The mesh (``--scenes`` names the parts to run; all five by default):
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

``--save`` writes A's final states and winners, E's winners and M's
winners of each mesh bounce (and O's of each final_scene bounce) to a
``.pt`` file; ``--compare a.pt b.pt
...`` then prints, for each file after the first, whether each of those
tensors equals the first file's bit for bit. Needs one CUDA card,
imports no JAX.
"""

from __future__ import annotations

import argparse
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

import torch

from rust_ray_tracer_tpu_torch import kernels as K
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
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
PAIRS_A_BATCH = 1 << 16


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
    """Registers, static shared memory and spills of each kernel from
    ``-Xptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.append({"function": name, "spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and "registers" not in out[-1]:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(smem.group(1)) if smem else 0
    return out


def in_path(scene, key, names, env):
    """Device ms per launch of each profiler name in ``names`` over a
    one-wave forward render of ``scene`` with the route flags ``env``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with torch.no_grad():
            render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                         chunk_size=CHUNK)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                render_waves(scene, WIDTH, HEIGHT, key, 0, 1, depth=DEPTH,
                             chunk_size=CHUNK)
                torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
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
    render (the profiler's launches in bounce order; both are
    ``fused_search_kernel``)."""
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
        render, "fused_search_kernel")}
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


def _det_t_rows(tri):
    """(det, t_num) [T, 10] and the flag [T] of a tree's triangle table:
    the full rows [T, 41] (det, u, v, t, flag) or the compact rows [T, 20]
    (``ops/search.full_rows``)."""
    if tri.shape[1] == 41:
        return tri[:, 0:10], tri[:, 30:40], tri[:, 40]
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
        ray (OPS_M_SPH, OPS_M_QUAD); ``bytes``: the rays, the entries,
        the tables and the permutation read once, the winners written
        once;
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
        det, t_num, flag = _det_t_rows(tabs.tri)
        fin = torch.isfinite(ent)
        w["full_cull_tests"] = int(fin.sum(1)[tile[live]].sum()) * width
        lp = pos[live]
        for s0 in range(0, lp.numel(), 8192):
            p = lp[s0:s0 + 8192]
            need = fin[tile[p]] & (ent[tile[p]] <= best_t[p, None])
            pr, cl = torch.nonzero(need, as_tuple=True)
            for b0 in range(0, pr.numel(), PAIRS_A_BATCH):
                rp, cp = p[pr[b0:b0 + PAIRS_A_BATCH]], cl[b0:b0 +
                                                          PAIRS_A_BATCH]
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
    w["ops"] = (w["tests"] * OPS_M_DET + w["t_tests"] * OPS_M_T
                + w["uv_tests"] * OPS_M_UV
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
    k, m = K.tile_enter_kernel, K.fused_search_kernel
    out = {"triangles": scene.n_tris, "rays": WIDTH * HEIGHT,
           "sorted": bool(orders), "bounces": [],
           "winners_differing_plain": [] if check else None,
           "m_in_path_ms": device_ms_in_order(render,
                                              "fused_search_kernel"),
           "k_in_path_ms": device_ms_in_order(render, "tile_enter_kernel")}
    for b, (e_args, s_args) in enumerate(zip(rec["enter"], rec["search"])):
        with torch.no_grad():
            bt, bk, bi = m(*s_args)
            row = {"bounce": b, **m_work(s_args, bt),
                   "k_ms": times(lambda a=e_args: k(*a)),
                   "m_ms": times(lambda a=s_args: m(*a))}
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
            for nm, x in (("t", bt), ("kind", bk), ("idx", bi)):
                save[f"{label}.mesh{b}.{nm}"] = x.cpu()
        out["bounces"].append(row)
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
                           bound_ms=max(ops / 67e12, nbytes / 3.35e12) * 1e3,
                           replay_differing=int(((ri != bi.long())
                                                 | (rt != bt)).sum()))
        if save is not None:
            save[f"{label}.quad{b}.t"] = bt.cpu()
            save[f"{label}.quad{b}.i"] = bi.cpu()
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
    tp = _parity()
    prev = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tp.write_earth_map(tmp, 1024, 512)
        os.chdir(tmp)
        try:
            scene = compile_scene(builders.random_scene(WIDTH / HEIGHT),
                                  device=dev)
            sums, parts = step_sums(scene, rng.key(0, dev))
        finally:
            os.chdir(prev)
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


def compare(paths):
    first = torch.load(paths[0])
    for p in paths[1:]:
        other = torch.load(p)
        diff = {k: int((first[k] != other[k]).reshape(
            first[k].shape[0], -1).any(0).sum()) if first[k].dim() > 1
            else int((first[k] != other[k]).sum()) for k in first}
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
                         "tri, gltf, final, earth, bwd")
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
                               "trace_wave_bwd", "split")}}
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
    if "earth" in parts:
        res["earth"] = earth_report(dev)
    if "bwd" in parts:
        res["bwd"] = bwd_report(dev)
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
