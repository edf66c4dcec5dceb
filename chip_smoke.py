"""Chip smoke test: the torch port's forward render and training step on
one CUDA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from ``rust_ray_tracer_tpu_torch/csrc`` (one
nvcc per source, in parallel) and holds each against its plain PyTorch
version on the card and on the CPU: the trace kernel (forward, with and
without the backward's residuals), the backward kernel and its fixed-order
reduction. Then it drives the main paths at the bench workload's size
(the flagship scene, 512x288, 4 spp, depth 4, chunk 9216): the forward
render through ``render_waves``, and ``bench.py``'s training step (loss =
mean of the render, scene gradients by ``torch.autograd``) — checking that
every wave went through the kernels and never the plain versions, that
the gradients are finite and bitwise repeatable, and timing both with CUDA
events. Last it runs the inverse-rendering example for 60 steps and the
CLI on the Cornell box. Each phase prints one JSON line; any failure
raises, so the exit code is non-zero. Then come the ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs one CUDA GPU; imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from rust_ray_tracer_tpu_torch import kernels as K
from rust_ray_tracer_tpu_torch.examples import inverse_rendering
from rust_ray_tracer_tpu_torch.kernels import (bwd_reduce_kernel,
                                               trace_wave_bwd_kernel,
                                               trace_wave_kernel)
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import cli
from rust_ray_tracer_tpu_torch.utils import rng

WIDTH, HEIGHT, SPP, DEPTH, CHUNK = 512, 288, 4, 4, 9216
FLIP_ABS = 1e-3          # a pixel "flips" when any channel is off by more
FLIP_BUDGET = 0.005      # fraction of pixels allowed to flip
RTOL, ATOL = 3e-4, 3e-5  # the rest (FMA contraction, division order)
# the backward: a ray's cotangent (dst) within rtol of its largest plane /
# atol, at most FLIP_BUDGET of the rays outside (an FMA can flip a
# recomputed branch: tir, metal_ok, a checker parity); the table
# cotangents (duni, dlt) sum in another order: relative L2 error
BWD_RTOL, BWD_ATOL, BWD_REL_L2 = 1e-4, 1e-6, 1e-4
# the card's published peaks (H100 SXM, 700 W): fp32 non-tensor, HBM3
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# fp32 operations the trace kernel spends per ray-triangle test (four
# 10-term dots, a division, the compares), per sphere or quad test, and per
# live ray-bounce of shading and update; the backward's per found
# ray-bounce (the recomputed forward plus its adjoint)
OPS_TRI, OPS_PRIM, OPS_SHADE, OPS_BWD = 80, 40, 300, 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def solid_scene(checker: bool = False) -> S.Scene:
    """Spheres of three materials, a double-sided ground triangle (checker
    textured when ``checker``) and a rect light."""
    cam = cam_ops.make_camera(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], 60.0, 1.0)
    ground = (S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                 (0.1, 0.9, 0.1)))
              if checker else S.Lambertian.from_rgb(0.7, 0.7, 0.7))
    world = [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Dielectric(1.5)),
        S.Sphere((2.2, 0, -4), 1.0, S.Metal((0.9, 0.8, 0.7), 0.2)),
        S.Triangle((-3, -1.2, -2), (3, -1.2, -2), (0, -1.2, -8), ground,
                   double_sided=True),
        S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                 S.DiffuseLight.from_color((5, 5, 5))),
    ]
    return S.Scene(cam, world, [world[-1]], (0.2, 0.3, 0.5))


def compare(got: torch.Tensor, ref: torch.Tensor, what: str,
            flip_abs: float | None = FLIP_ABS) -> dict:
    """Flip-budget comparison of two [H, W, 3] images; raises on failure.

    A pixel flips (a path forked on a near-tie) when any channel is off by
    more than ``flip_abs``; at most FLIP_BUDGET of the pixels may flip and
    the rest must match to RTOL/ATOL. ``flip_abs=None`` counts every pixel
    outside RTOL/ATOL as a flip — for full-size images, where a few forked
    paths carry less than 1e-3 of radiance.
    """
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite pixels")
    diff = (got - ref).abs()
    outside = (diff > ATOL + RTOL * ref.abs()).any(-1)
    flips = outside if flip_abs is None else (diff > flip_abs).any(-1)
    frac = float(flips.float().mean())
    if frac > FLIP_BUDGET:
        raise AssertionError(f"{what}: {frac:.4%} of pixels flipped")
    bad = outside & ~flips
    if bool(bad.any()):
        i = int(torch.nonzero(bad.reshape(-1))[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} pixels outside rtol {RTOL} / atol "
            f"{ATOL}, e.g. {got.reshape(-1, 3)[i].tolist()} vs "
            f"{ref.reshape(-1, 3)[i].tolist()}")
    err = float((diff * ~flips[..., None]).max())
    return {"flip_frac": frac, "max_abs_err": err}


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn`` by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def scaled_close(got, ref, rtol, atol, budget, what):
    """Per-lane comparison of [C, N] planes: ``|got - ref| <= atol + rtol
    * (largest |ref| of the lane)``; at most ``budget`` of the lanes may
    fall outside. Returns (share outside, worst error of the rest)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    scale = ref.abs().amax(dim=0, keepdim=True)
    err = (got - ref).abs()
    bad = (err > atol + rtol * scale).any(dim=0)
    frac = float(bad.float().mean())
    if frac > budget:
        raise AssertionError(f"{what}: {frac:.4%} of lanes outside rtol "
                             f"{rtol} / atol {atol}")
    return frac, float((err * ~bad).max())


def rel_l2(got, ref, what, limit):
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    r = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
    if r > limit:
        raise AssertionError(f"{what}: relative L2 error {r:.3g} > {limit}")
    return r


def rows_close(got, ref, what, rtol=BWD_REL_L2, atol=BWD_ATOL) -> float:
    """Each row of a table cotangent [R, C] (a light's, the background's)
    within ``atol`` plus ``rtol`` times the row's largest |ref|, so a
    light's small share is not hidden in the whole table's norm. Returns
    the worst error as a share of its row's largest |ref|."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    scale = ref.abs().amax(dim=1)
    err = (got - ref).abs().amax(dim=1)
    bad = err > atol + rtol * scale
    if bool(bad.any()):
        r = int(torch.nonzero(bad)[0])
        raise AssertionError(f"{what}: row {r} off by {float(err[r]):.3g}, "
                             f"its largest |ref| {float(scale[r]):.3g}")
    return float((err / scale.clamp_min(1e-30)).max())


def check_sphere_light_rows(dlt, ctx, what) -> None:
    """A sphere light's centre and radius columns take a cotangent (its
    pdf adjoint ran), so the rows' check above held something."""
    for li in range(ctx.n_lights):
        if int(ctx.lt[li, 0]) == S.LIGHT_SPHERE and not float(
                dlt[li, 1:5].abs().max()) > 0:
            raise AssertionError(f"{what}: sphere light {li} took no "
                                 "cotangent")


def ptxas_report(log: str) -> list[dict]:
    """Registers and spills of each kernel from ``-Xptxas -v``."""
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
    return out


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


def profile_device(fn, names) -> dict:
    """Kernel time on the card by ``torch.profiler`` over one call of
    ``fn``: per name, ms per launch and launches; the busy share of the
    span from the first kernel's start to the last one's end. None where
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return {"per_kernel": None, "busy_share": None, "kernels": 0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = max(b for _, b in spans) - spans[0][0]
    per = {}
    for n in names:
        ds = [e.time_range.elapsed_us() for e in kern if n in e.name]
        per[n] = {"ms_per_launch": (sum(ds) / len(ds) / 1e3) if ds else None,
                  "launches": len(ds)}
    return {"per_kernel": per, "busy_share": busy / span,
            "span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "kernels": len(kern)}


def median(xs):
    return statistics.median(xs)


def swept_tri_tests(hist, ctx) -> int:
    """Ray-triangle tests the trace kernel makes on these states: at each
    bounce, every live ray of a 128-ray row sweeps every 512-triangle chunk
    whose box a live ray of the row enters (the kernel's vote)."""
    total = 0
    cab = ctx.cab[:ctx.n_tri_chunks]
    for st in hist:
        o, d, live = st[0:3], st[3:6], st[7] > 0.5
        inv = [1.0 / torch.where(c.abs() < 1e-30, torch.full_like(c, 1e-30),
                                 c) for c in d]
        t0 = [(cab[:, a:a + 1] - o[a]) * inv[a] for a in range(3)]
        t1 = [(cab[:, 3 + a:4 + a] - o[a]) * inv[a] for a in range(3)]
        tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                         torch.minimum(t0[1], t1[1])),
                           torch.maximum(torch.minimum(t0[2], t1[2]),
                                         torch.full_like(t0[2], 1e-4)))
        tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                         torch.maximum(t0[1], t1[1])),
                           torch.maximum(t0[2], t1[2]))
        hit = ((tf >= tn) & live).reshape(cab.shape[0], -1, 128).any(2)
        live_rows = live.reshape(-1, 128).sum(1)
        total += int((hit * live_rows).sum()) * uber.TCC
    return total


def main() -> int:
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    dev = torch.device("cuda", 0)

    # ---- 2. build: every source, one nvcc each, in parallel ---------------
    t0 = time.perf_counter()
    builds = K.build_all()
    for k in (trace_wave_kernel, trace_wave_bwd_kernel, bwd_reduce_kernel):
        k.load()
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0,
          "libraries": {n: {"file": b.path.name, "nvcc_seconds": b.seconds,
                            "ptxas": ptxas_report(b.log)}
                        for n, b in builds.items()}})

    # ---- 3. kernels vs plain on small scenes -----------------------------
    worst = {"flip_frac": 0.0, "max_abs_err": 0.0}
    worst_b = {"dst_outside": 0.0, "dst_err": 0.0, "duni_rel_l2": 0.0,
               "dlt_rel_l2": 0.0, "reduce_err": 0.0}
    key = rng.key(0, "cpu")
    for label, host in (("solid", solid_scene()),
                        ("solid_checker", solid_scene(checker=True)),
                        ("cornell_box", builders.cornell_box(1.0)),
                        ("flagship", builders.flagship())):
        w = h = 64
        chunk = 4096
        sd = compile_scene(host, device="cpu")
        st0, rnd = uber.wave_inputs(sd, rng.wave_key(key, 0), w, h, DEPTH,
                                    chunk)
        ctx_cpu = uber.make_ctx(sd)
        ctx_gpu = uber.make_ctx(sd.to(dev))

        def image(stf):
            rows = uber.wave_radiance(stf, w, h, chunk)[:w * h]
            return cam_ops.image_from_positions(rows.cpu(), w, h)

        st0_g, rnd_g = st0.to(dev), rnd.to(dev)
        img_k = image(trace_wave_kernel(st0_g, rnd_g, ctx_gpu, DEPTH))
        img_pg = image(uber.trace_wave_plain(st0_g, rnd_g, ctx_gpu, DEPTH))
        img_pc = image(uber.trace_wave_plain(st0, rnd, ctx_cpu, DEPTH))
        torch.cuda.synchronize()
        vs_gpu = compare(img_k, img_pg, f"{label}: kernel vs plain (cuda)")
        vs_cpu = compare(img_k, img_pc, f"{label}: kernel vs plain (cpu)")
        for r in (vs_gpu, vs_cpu):
            worst = {k: max(worst[k], r[k]) for k in worst}
        emit({"phase": "kernel_vs_plain", "scene": label,
              "shape": [h, w, 1, DEPTH], "vs_plain_cuda": vs_gpu,
              "vs_plain_cpu": vs_cpu, "mean": float(img_k.mean()),
              "budget": {"flip_abs": FLIP_ABS, "flip_frac": FLIP_BUDGET,
                         "rtol": RTOL, "atol": ATOL}})

        # the forward with residuals, then B + bwd_reduce, against the
        # plain versions fed the same residuals and cotangent
        stf_r, hist, kind, idx = trace_wave_kernel(st0_g, rnd_g, ctx_gpu,
                                                   DEPTH, residuals=True)
        _, p_hist, p_kind, p_idx = uber.trace_wave_plain(
            st0_g, rnd_g, ctx_gpu, DEPTH, residuals=True)
        res_stf_equal = torch.equal(stf_r, trace_wave_kernel(
            st0_g, rnd_g, ctx_gpu, DEPTH))
        if not res_stf_equal:
            raise AssertionError(f"{label}: the residual writes changed the "
                                 "forward's result")
        if not (torch.equal(kind[0], p_kind[0])
                and torch.equal(idx[0], p_idx[0])):
            raise AssertionError(f"{label}: bounce-0 winners differ from "
                                 "the plain forward's")
        hist_out = max(scaled_close(hist[b], p_hist[b], RTOL, ATOL,
                                    FLIP_BUDGET, f"{label}: hist[{b}]")[0]
                       for b in range(DEPTH))
        g = torch.from_numpy(np.random.default_rng(5).normal(
            size=tuple(st0.shape)).astype(np.float32)).to(dev)
        got = uber.trace_wave_bwd(hist, rnd_g, kind, idx, ctx_gpu, g)
        again = uber.trace_wave_bwd(hist, rnd_g, kind, idx, ctx_gpu, g)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        if not bitwise:
            raise AssertionError(f"{label}: two backward runs differ")
        ref_g = uber.trace_wave_bwd_plain(hist, rnd_g, kind, idx, ctx_gpu, g)
        ref_c = uber.trace_wave_bwd_plain(hist.cpu(), rnd, kind.cpu(),
                                          idx.cpu(), ctx_cpu, g.cpu())
        rows = {}
        for where_, ref in (("cuda", ref_g), ("cpu", ref_c)):
            out, err = scaled_close(got[0], ref[0], BWD_RTOL, BWD_ATOL,
                                    FLIP_BUDGET, f"{label}: dst ({where_})")
            rows[where_] = {
                "dst_outside": out, "dst_err": err,
                "duni_rel_l2": rel_l2(got[1], ref[1], f"{label}: duni",
                                      BWD_REL_L2),
                "dlt_rel_l2": rel_l2(got[2], ref[2], f"{label}: dlt",
                                     BWD_REL_L2),
                "dlt_rows_err": rows_close(got[2], ref[2],
                                           f"{label}: dlt rows ({where_})")}
            worst_b = {k: max(worst_b[k], rows[where_].get(k, 0.0))
                       for k in worst_b}
        # bwd_reduce alone against its plain version on the same inputs
        _, contrib, keys, part = trace_wave_bwd_kernel(hist, rnd_g, kind,
                                                       idx, ctx_gpu, g)
        perm, offs = K.reduce_order(keys, ctx_gpu.uni.shape[0])
        red = bwd_reduce_kernel(contrib, perm, offs, part)
        red_p = uber.bwd_reduce_plain(contrib, perm, offs, part)
        rel_l2(red[0], red_p[0], f"{label}: bwd_reduce duni", BWD_REL_L2)
        rel_l2(red[1], red_p[1], f"{label}: bwd_reduce dlt", BWD_REL_L2)
        red_err = max(float((a - b).abs().max()) for a, b in zip(red, red_p))
        worst_b["reduce_err"] = max(worst_b["reduce_err"], red_err)
        if not float(got[1].abs().max()) > 0:
            raise AssertionError(f"{label}: duni is all zero")
        check_sphere_light_rows(ref_c[2], ctx_cpu, label)
        emit({"phase": "bwd_vs_plain", "scene": label,
              "shape": [h, w, 1, DEPTH], "hist_lanes_outside": hist_out,
              "vs_plain": rows, "bwd_reduce_max_abs_err": red_err,
              "bitwise_repeat": bitwise,
              "budget": {"dst_rtol_of_lane_max": BWD_RTOL,
                         "dst_atol": BWD_ATOL,
                         "dst_lanes_outside": FLIP_BUDGET,
                         "table_rel_l2": BWD_REL_L2,
                         "table_row_rtol_of_row_max": BWD_REL_L2,
                         "table_row_atol": BWD_ATOL}})

    # ---- 4. flagship forward at full size --------------------------------
    scene = compile_scene(builders.flagship(), device=dev)
    key = rng.key(0, dev)
    plain_calls = []
    real_plain = uber.trace_wave_plain
    real_bwd_plain = uber.trace_wave_bwd_plain

    def counting(fn):
        def wrapped(*args, **kwargs):
            plain_calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    uber.trace_wave_plain = counting(real_plain)
    uber.trace_wave_bwd_plain = counting(real_bwd_plain)
    try:
        trace_wave_kernel.launches = 0
        with torch.no_grad():
            img = render_waves(scene, WIDTH, HEIGHT, key, 0, SPP,
                               depth=DEPTH, chunk_size=CHUNK)
        torch.cuda.synchronize()
        launches = trace_wave_kernel.launches
    finally:
        uber.trace_wave_plain = real_plain
        uber.trace_wave_bwd_plain = real_bwd_plain
    if launches != SPP:
        raise AssertionError(f"{launches} kernel launches, expected {SPP}")
    if plain_calls:
        raise AssertionError("the plain version ran on the main path")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("flagship image has non-finite pixels")

    # the glue's rays and draws on the card are the CPU's, bit for bit
    ctx = uber.make_ctx(scene)
    st0, rnd = uber.wave_inputs(scene, rng.wave_key(key, 0), WIDTH, HEIGHT,
                                DEPTH, CHUNK)
    st0_c, rnd_c = uber.wave_inputs(
        compile_scene(builders.flagship(), device="cpu"),
        rng.wave_key(rng.key(0, "cpu"), 0), WIDTH, HEIGHT, DEPTH, CHUNK)
    if not (torch.equal(st0.cpu(), st0_c) and torch.equal(rnd.cpu(), rnd_c)):
        raise AssertionError("camera rays or random draws differ between "
                             "the card and the CPU")

    # the kernel against its plain version at the main path's shape
    full = compare(
        cam_ops.image_from_positions(uber.wave_radiance(
            trace_wave_kernel(st0, rnd, ctx, DEPTH), WIDTH, HEIGHT,
            CHUNK)[:WIDTH * HEIGHT], WIDTH, HEIGHT),
        cam_ops.image_from_positions(uber.wave_radiance(
            real_plain(st0, rnd, ctx, DEPTH), WIDTH, HEIGHT,
            CHUNK)[:WIDTH * HEIGHT], WIDTH, HEIGHT),
        "flagship: kernel vs plain (cuda)", flip_abs=None)

    with torch.no_grad():
        sweeps = cuda_ms(lambda: render_waves(
            scene, WIDTH, HEIGHT, key, 0, SPP, depth=DEPTH,
            chunk_size=CHUNK), 7)
    kernel_ms = cuda_ms(lambda: trace_wave_kernel(st0, rnd, ctx, DEPTH), 10)
    glue_ms = cuda_ms(lambda: uber.wave_inputs(
        scene, rng.wave_key(key, 0), WIDTH, HEIGHT, DEPTH, CHUNK), 10)
    plain_ms = cuda_ms(lambda: real_plain(st0, rnd, ctx, DEPTH), 3)
    med = median(sweeps)
    lane_bounces = WIDTH * HEIGHT * SPP * DEPTH
    k_med = median(kernel_ms)
    p_med = median(plain_ms)
    emit({"phase": "flagship_forward", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "kernel_launches": launches, "plain_calls": len(plain_calls),
          "image_mean": float(img.mean()) / SPP,
          "glue_bitwise_vs_cpu": True, "kernel_vs_plain": full,
          "kernel_vs_plain_budget": {
              "flip": "any channel outside rtol/atol",
              "flip_frac": FLIP_BUDGET, "rtol": RTOL, "atol": ATOL},
          "sweep_ms_median": med, "sweep_ms_min": min(sweeps),
          "sweep_ms_max": max(sweeps), "sweeps": len(sweeps),
          "fwd_mrays_per_s": lane_bounces / (med / 1e3) / 1e6,
          "kernel_ms_per_wave_median": k_med,
          "kernel_ms_per_wave_min": min(kernel_ms),
          "kernel_ms_per_wave_max": max(kernel_ms),
          "glue_ms_per_wave_median": median(glue_ms),
          "plain_ms_per_wave_median": p_med,
          "plain_ms_per_wave_min": min(plain_ms),
          "plain_ms_per_wave_max": max(plain_ms)})

    # ---- 5. flagship training step: bench.py's fwd+bwd on the port -------
    params, static = partition(scene)

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = render_waves(combine(leaves, static), WIDTH, HEIGHT, key, 0,
                            SPP, depth=DEPTH, chunk_size=CHUNK).mean()
        loss.backward()
        return loss, {k: v.grad for k, v in leaves.items()}

    kernels = (trace_wave_kernel, trace_wave_bwd_kernel, bwd_reduce_kernel)
    uber.trace_wave_plain = counting(real_plain)
    uber.trace_wave_bwd_plain = counting(real_bwd_plain)
    try:
        for k in kernels:
            k.launches = 0
        loss, grads = step()
        torch.cuda.synchronize()
        train_launches = {k.name: k.launches for k in kernels}
        _, grads2 = step()
        torch.cuda.synchronize()
    finally:
        uber.trace_wave_plain = real_plain
        uber.trace_wave_bwd_plain = real_bwd_plain
    if train_launches != {"trace_wave": SPP, "trace_wave_bwd": SPP,
                          "bwd_reduce": SPP}:
        raise AssertionError(f"training launches {train_launches}")
    if plain_calls:
        raise AssertionError(f"plain versions ran on the training path: "
                             f"{plain_calls}")
    grads = {k: v for k, v in grads.items() if v is not None}
    for k, v in grads.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite gradient of {k}")
        if not torch.equal(v, grads2[k]):
            raise AssertionError(f"gradient of {k} differs between steps")
    lamp = {k: float(grads[k].abs().max()) for k in
            ("sph_c0", "sph_r", "light_c", "light_r") if k in grads}
    nonzero = {k: float(grads[k].abs().max()) for k in
               ("tri_v0", "tex_color", "camera.c2w") if k in grads}
    if len(nonzero) < 3 or min(nonzero.values()) <= 0 or not any(
            v > 0 for v in lamp.values()):
        raise AssertionError(f"zero gradients: {nonzero} {lamp}")

    torch.cuda.reset_peak_memory_stats(dev)
    steps_ms = cuda_ms(step, 7)
    peak = torch.cuda.max_memory_allocated(dev)
    step_med = median(steps_ms)
    # per-wave parts at the same shapes
    g_st = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32)).to(dev)
    _, hist, kind, idx = trace_wave_kernel(st0, rnd, ctx, DEPTH,
                                           residuals=True)
    a_res_ms = loop_ms(lambda: trace_wave_kernel(st0, rnd, ctx, DEPTH,
                                                 residuals=True), 5)
    b_ms = loop_ms(lambda: trace_wave_bwd_kernel(hist, rnd, kind, idx, ctx,
                                                 g_st))
    _, contrib, keys, part = trace_wave_bwd_kernel(hist, rnd, kind, idx, ctx,
                                                   g_st)
    order_ms = loop_ms(lambda: K.reduce_order(keys, ctx.uni.shape[0]))
    perm, offs = K.reduce_order(keys, ctx.uni.shape[0])
    red_ms = loop_ms(lambda: bwd_reduce_kernel(contrib, perm, offs, part))
    red_plain_ms = loop_ms(lambda: uber.bwd_reduce_plain(contrib, perm, offs,
                                                         part))
    m_found = int(offs[-1])
    found_rows = keys.reshape(-1)[perm[:m_found].long()].long()
    found_contrib = contrib.reshape(-1, contrib.shape[-1])[
        perm[:m_found].long()]
    lib_red_ms = loop_ms(lambda: torch.zeros_like(ctx.uni).index_add_(
        0, found_rows, found_contrib))
    prof = profile_device(step, ("trace_wave_kernel", "trace_wave_bwd_kernel",
                                 "bwd_reduce_kernel"))
    red = bwd_reduce_kernel(contrib, perm, offs, part)
    red_p = uber.bwd_reduce_plain(contrib, perm, offs, part)
    red_full_err = max(float((a - b).abs().max()) for a, b in zip(red, red_p))
    rel_l2(red[0], red_p[0], "flagship: bwd_reduce duni", BWD_REL_L2)
    rel_l2(red[1], red_p[1], "flagship: bwd_reduce dlt", BWD_REL_L2)
    bwd_k = K.trace_backward(hist, rnd, kind, idx, ctx, g_st)
    bwd_p = real_bwd_plain(hist, rnd, kind, idx, ctx, g_st)
    full_b_out, full_b_err = scaled_close(bwd_k[0], bwd_p[0], BWD_RTOL,
                                          BWD_ATOL, FLIP_BUDGET,
                                          "flagship: dst")
    full_b_l2 = rel_l2(bwd_k[1], bwd_p[1], "flagship: duni", BWD_REL_L2)
    full_dlt_l2 = rel_l2(bwd_k[2], bwd_p[2], "flagship: dlt", BWD_REL_L2)
    full_dlt_rows = rows_close(bwd_k[2], bwd_p[2], "flagship: dlt rows")
    check_sphere_light_rows(bwd_p[2], ctx, "flagship")
    bwd_plain_ms = cuda_ms(lambda: real_bwd_plain(hist, rnd, kind, idx, ctx,
                                                  g_st), 2)
    a_res_med, b_med, red_med = (median(x) for x in (a_res_ms, b_ms, red_ms))
    order_med = median(order_ms)
    glue_wave = step_med / SPP - (a_res_med + b_med + order_med + red_med)
    emit({"phase": "flagship_train", "card": smi,
          "shape": [HEIGHT, WIDTH, SPP, DEPTH], "chunk_size": CHUNK,
          "loss": float(loss.detach()), "launches": train_launches,
          "plain_calls": len(plain_calls), "grads_finite": True,
          "grads_bitwise_repeat": True, "grad_max_abs": nonzero,
          "lamp_grad_max_abs": lamp,
          "step_ms_median": step_med, "step_ms_min": min(steps_ms),
          "step_ms_max": max(steps_ms), "steps": len(steps_ms),
          "fwd_bwd_mrays_per_s": lane_bounces / (step_med / 1e3) / 1e6,
          "peak_memory_bytes": peak,
          "ms_per_wave": {
              "trace_wave": k_med, "trace_wave_with_residuals": a_res_med,
              "trace_wave_bwd": b_med, "reduce_order_sort": order_med,
              "bwd_reduce": red_med, "bwd_reduce_plain": median(red_plain_ms),
              "index_add_yardstick": median(lib_red_ms),
              "glue_rest_of_step": glue_wave,
              "trace_wave_bwd_plain": median(bwd_plain_ms)},
          "bwd_vs_plain": {"dst_outside": full_b_out, "dst_err": full_b_err,
                           "duni_rel_l2": full_b_l2,
                           "dlt_rel_l2": full_dlt_l2,
                           "dlt_rows_err": full_dlt_rows,
                           "lamp_dlt_row": bwd_k[2][0].tolist(),
                           "bwd_reduce_max_abs_err": red_full_err},
          "profiled_step": prof,
          "found_ray_bounces": m_found,
          "largest_row_contributions": int((offs[1:] - offs[:-1]).max())})

    # ---- 6. the inverse-rendering example on the card --------------------
    t0 = time.perf_counter()
    inv = inverse_rendering.run(steps=60, device=dev, log=lambda _: None)
    inv_s = time.perf_counter() - t0
    if not inv["max_albedo_err"] < 0.1:
        raise AssertionError(f"inverse rendering: albedo error "
                             f"{inv['max_albedo_err']}")
    emit({"phase": "inverse_rendering", "seconds": inv_s,
          "loss_every_10": inv["losses"][::10] + inv["losses"][-1:],
          "albedo": inv["albedo"], "target": inv["target"],
          "max_albedo_err": inv["max_albedo_err"]})

    # ---- 7. CLI ----------------------------------------------------------
    os.makedirs("output", exist_ok=True)
    out_png = os.path.join("output", "cornell_torch.png")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["256", "16", "--scene", "cornell_box", "-a", "1.0",
                       "-o", out_png, "--device", "cuda"])
    line = buf.getvalue().strip()
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {line}")
    m = re.search(r"mean radiance ([0-9.eE+-]+|nan|inf), finite (\w+)", line)
    if not m or m.group(2) != "True":
        raise AssertionError(f"CLI image not finite: {line}")
    mean = float(m.group(1))
    if not 0.05 <= mean <= 0.4:
        raise AssertionError(f"implausible Cornell mean radiance {mean}")
    if not os.path.getsize(out_png):
        raise AssertionError(f"{out_png} is empty")
    emit({"phase": "cli", "output": out_png, "mean_radiance": mean,
          "stdout": line})

    # ---- result ----------------------------------------------------------
    n = st0.shape[1]
    w_cols = ctx.uni.shape[1]
    tables = sum(x.numel() * 4 for x in (ctx.uni, ctx.det_t, ctx.u_t,
                                         ctx.v_t, ctx.t_t, ctx.dbl_t,
                                         ctx.sph, ctx.quad, ctx.cab, ctx.lt))
    alive = hist[:, 7] > 0.5
    n_live = int(alive.sum())
    prims = ctx.n_sph + ctx.n_quad
    # A: st0 + rnd in, stf out (+ the residuals when training); the ray
    # tests this wave's rays make, and the shading of each live ray-bounce
    a_bytes = (14 * n * 2 + DEPTH * 15 * n) * 4 + tables
    a_res_bytes = a_bytes + (DEPTH * 14 * n + 2 * DEPTH * n) * 4
    a_ops = (swept_tri_tests(hist, ctx) * OPS_TRI
             + n_live * (prims * OPS_PRIM + OPS_SHADE))
    # B: what this run's residuals need. Every ray-bounce: its alive
    # plane. A live ray: its kind and beta (a miss needs no more). A found
    # ray-bounce: o, d, time, its winner, the randoms its material's
    # adjoint reads, and its row cotangent with its key out. Once: g in,
    # dst out, the tables, the per-block partials.
    found = alive & (kind > 0)           # m_found of them
    mat = ctx.uni[idx[found].long(), uber.A_COL].long()
    rnd_cols = torch.zeros(5, dtype=torch.long, device=mat.device)
    rnd_cols[S.MAT_LAMBERTIAN] = 6 if ctx.n_lights else 2
    rnd_cols[S.MAT_METAL] = 4
    rnd_cols[S.MAT_DIELECTRIC] = 1
    b_bytes = (DEPTH * n + n_live * 4 + m_found * (7 + 1 + 1 + w_cols)
               + int(rnd_cols[mat].sum()) + 2 * 14 * n + ctx.uni.numel()
               + ctx.lt.numel() + part.numel()) * 4
    b_ops = m_found * OPS_BWD
    # bwd_reduce: the found cotangents, their order and the partials in;
    # duni and dlt out; one add per value
    r_bytes = (m_found * (w_cols + 1) + offs.numel() + part.numel()
               + ctx.uni.numel() + ctx.lt.numel()) * 4
    r_ops = m_found * w_cols + part.numel()

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    per = prof["per_kernel"] or {}

    def device_ms(kernel_name, fallback):
        """The profiler's device time per launch in the training step, or
        the CUDA-event time per call where the profiler saw none."""
        got = (per.get(kernel_name) or {}).get("ms_per_launch")
        return fallback if got is None else got

    rows = []
    for kname, src, repl, kl, err, ms, pms, nb, ops, lib in (
            ("trace_wave", "rust_ray_tracer_tpu_torch/csrc/trace_wave.cu",
             "rust_ray_tracer_tpu/ops/pallas_uber.py:876",
             train_launches["trace_wave"],
             max(worst["max_abs_err"], full["max_abs_err"]),
             device_ms("trace_wave_kernel", a_res_med), p_med,
             a_res_bytes, a_ops, None),
            ("trace_wave_bwd",
             "rust_ray_tracer_tpu_torch/csrc/trace_wave_bwd.cu",
             "rust_ray_tracer_tpu/ops/pallas_uber.py:926",
             train_launches["trace_wave_bwd"],
             max(worst_b["dst_err"], full_b_err),
             device_ms("trace_wave_bwd_kernel", b_med),
             median(bwd_plain_ms), b_bytes, b_ops, None),
            ("bwd_reduce", "rust_ray_tracer_tpu_torch/csrc/trace_wave_bwd.cu",
             "rust_ray_tracer_tpu/ops/pallas_uber.py:979",
             train_launches["bwd_reduce"],
             max(worst_b["reduce_err"], red_full_err),
             device_ms("bwd_reduce_kernel", red_med),
             median(red_plain_ms), r_bytes, r_ops, median(lib_red_ms))):
        b_ms_, b_by = bound(nb, ops)
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": repl, "launches": kl, "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "bound_ms": b_ms_,
                     "bound_by": b_by, "library_ms": lib,
                     "bytes": nb, "operations": ops})
    rows[1]["ray_bounces"] = {"all": DEPTH * n, "live": n_live,
                              "found": m_found}
    rows[0]["ms_without_residuals"] = k_med
    rows[0]["bound_ms_without_residuals"] = bound(a_bytes, a_ops)[0]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
