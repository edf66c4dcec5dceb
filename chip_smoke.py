"""Chip smoke test: the torch port's forward render on one CUDA GPU.

    python3 chip_smoke.py

Builds the Hopper trace kernel from ``rust_ray_tracer_tpu_torch/csrc``,
holds it against its plain PyTorch version on the card and on the CPU,
renders the flagship scene at the bench workload's size (512x288, 4 spp,
depth 4, chunk 9216) through ``render_waves`` and checks that every wave
went through the kernel, times it with CUDA events, and runs the CLI on
the Cornell box. Each phase prints one JSON line; any failure raises, so
the exit code is non-zero. The last line is
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

import torch

from rust_ray_tracer_tpu_torch.kernels import trace_wave_kernel
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import cli
from rust_ray_tracer_tpu_torch.utils import rng

WIDTH, HEIGHT, SPP, DEPTH, CHUNK = 512, 288, 4, 4, 9216
FLIP_ABS = 1e-3          # a pixel "flips" when any channel is off by more
FLIP_BUDGET = 0.005      # fraction of pixels allowed to flip
RTOL, ATOL = 3e-4, 3e-5  # the rest (FMA contraction, division order)


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

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    b = trace_wave_kernel.load()
    regs = re.findall(r"Used \d+ registers[^\n]*", b.log)
    emit({"phase": "build", "kernel": "trace_wave", "seconds": b.seconds,
          "load_seconds": time.perf_counter() - t0, "library": b.path.name,
          "ptxas": regs})

    # ---- 3. kernel vs plain on small scenes ------------------------------
    worst = {"flip_frac": 0.0, "max_abs_err": 0.0}
    key = rng.key(0)
    for label, host in (("solid", solid_scene()),
                        ("solid_checker", solid_scene(checker=True)),
                        ("cornell_box", builders.cornell_box(1.0))):
        w = h = 64
        chunk = 4096
        sd = compile_scene(host)
        st0, rnd = uber.wave_inputs(sd, rng.wave_key(key, 0), w, h, DEPTH,
                                    chunk)
        ctx_cpu = uber.make_ctx(sd)
        ctx_gpu = uber.make_ctx(sd.to(dev))

        def image(stf):
            rows = uber.wave_radiance(stf, w, h, chunk)[:w * h]
            return cam_ops.image_from_positions(rows.cpu(), w, h)

        img_k = image(trace_wave_kernel(st0.to(dev), rnd.to(dev), ctx_gpu,
                                        DEPTH))
        img_pg = image(uber.trace_wave_plain(st0.to(dev), rnd.to(dev),
                                             ctx_gpu, DEPTH))
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

    # ---- 4. flagship forward at full size --------------------------------
    scene = compile_scene(builders.flagship(), device=dev)
    key = rng.key(0, dev)
    plain_calls = []
    real_plain = uber.trace_wave_plain

    def counting_plain(*args, **kwargs):
        plain_calls.append(1)
        return real_plain(*args, **kwargs)

    uber.trace_wave_plain = counting_plain
    try:
        trace_wave_kernel.launches = 0
        img = render_waves(scene, WIDTH, HEIGHT, key, 0, SPP, depth=DEPTH,
                           chunk_size=CHUNK)
        torch.cuda.synchronize()
        launches = trace_wave_kernel.launches
    finally:
        uber.trace_wave_plain = real_plain
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
        compile_scene(builders.flagship()), rng.wave_key(rng.key(0), 0),
        WIDTH, HEIGHT, DEPTH, CHUNK)
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

    sweeps = cuda_ms(lambda: render_waves(scene, WIDTH, HEIGHT, key, 0, SPP,
                                          depth=DEPTH, chunk_size=CHUNK), 7)
    kernel_ms = cuda_ms(lambda: trace_wave_kernel(st0, rnd, ctx, DEPTH), 10)
    glue_ms = cuda_ms(lambda: uber.wave_inputs(
        scene, rng.wave_key(key, 0), WIDTH, HEIGHT, DEPTH, CHUNK), 10)
    plain_ms = cuda_ms(lambda: real_plain(st0, rnd, ctx, DEPTH), 3)
    med = statistics.median(sweeps)
    lane_bounces = WIDTH * HEIGHT * SPP * DEPTH
    k_med = statistics.median(kernel_ms)
    p_med = statistics.median(plain_ms)
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
          "glue_ms_per_wave_median": statistics.median(glue_ms),
          "plain_ms_per_wave_median": p_med,
          "plain_ms_per_wave_min": min(plain_ms),
          "plain_ms_per_wave_max": max(plain_ms)})

    # ---- 5. CLI ----------------------------------------------------------
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
    print(json.dumps({"kernels": [{
        "name": "trace_wave", "route": "cuda",
        "source": "rust_ray_tracer_tpu_torch/csrc/trace_wave.cu",
        "replaces": "rust_ray_tracer_tpu/ops/pallas_uber.py:876",
        "launches": launches,
        "max_abs_err": max(worst["max_abs_err"], full["max_abs_err"]),
        "flip_frac": max(worst["flip_frac"], full["flip_frac"]),
        "ms": k_med, "plain_ms": p_med}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
