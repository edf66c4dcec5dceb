"""Times of the search kernels of library ``trace_wave`` (TPU kernels A, D
and E, and the noise variants of A and D) on one CUDA card, for holding
one tree's kernels against another's in the same call; ``chip_smoke.py``
runs :func:`search_report` as its search checks and times its kernels
with :func:`cold_ms` and :func:`loop_ms`.

    PYTHONPATH=<tree> python3 search_times.py --label new \\
        --out output/search_new.json --save <dir>/new.pt

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

``--save`` writes A's final states and winners and E's winners to a
``.pt`` file; ``--compare a.pt b.pt ...`` then prints, for each file
after the first, whether each of those tensors equals the first file's
bit for bit. Needs one CUDA card, imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys

import torch

from rust_ray_tracer_tpu_torch import kernels as K
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

WIDTH, HEIGHT, SPP, DEPTH, CHUNK = 512, 288, 4, 4, 9216
L2_FLUSH_BYTES = 256 << 20
ROW, WARP = 128, 32


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
    res = {"label": args.label, "card": smi,
           "trace_wave_flags": list(K.LIBRARIES["trace_wave"][1]),
           "ptxas": {n: ptxas_report(builds[n].log)
                     for n in ("trace_wave", "trace_wave_noise")},
           "flagship": scene_times("flagship", builders.procedural_flagship,
                                   dev, save),
           "random": scene_times(
               "random", lambda: builders.random_scene(WIDTH / HEIGHT), dev,
               save)}
    res["sms"] = torch.cuda.get_device_properties(dev).multi_processor_count
    res["grid_blocks"] = math.ceil(res["flagship"]["rays"] / ROW)
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
