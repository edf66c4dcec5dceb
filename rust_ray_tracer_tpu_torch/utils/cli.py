"""Command-line renderer.

Counterpart of ``rust_ray_tracer_tpu/utils/cli.py`` (and the reference
binary, ``src/main.rs:26-118`` of the reference): positional HEIGHT and
SAMPLES, ``-o`` output PNG, ``-g`` glTF (or .glb) input, ``-a`` aspect
ratio, ``--scene`` (which overrides ``-g``; the Cornell box without
either), ``--depth``, ``--seed`` and ``--chunk-size``, plus ``--device``.
The device defaults to ``cuda`` and the run fails when no GPU is present —
it never drops to the CPU on its own; ``--device cpu`` runs the plain
version.

The render goes through ``parallel.checkpoint.render_with_checkpoints``,
as JAX's CLI does: a checkpoint every ``--ckpt-every`` waves into
``--checkpoint`` (default ``<output>.ckpt``), left in place when the
render ends, so a second run with the same settings is a no-op restart.
``--devices N`` (default: every visible card; 1 with ``--device cpu``)
with N > 1 starts N local worker processes joined over a local TCP
rendezvous, one card each (or N CPU processes with ``--device cpu``), and
shards the rays over them (``parallel.render_waves_sharded``: TPU kernel
D on the trace kernel's scenes); ``--coordinator host:port
--num-processes N --process-id R`` joins such a run by hand, one process
per host or card, and ``torchrun`` sets the same through the environment.
Rank 0 writes the PNG. ``--compact {auto,on,off}`` (bare ``--compact``:
``on``) renders through the compact wavefront
(``ops/integrator.trace_wave_compact``, shard-local under ``--devices``);
``auto``, the default, asks ``ops/integrator.auto_compact`` and prints its
answer, as JAX's CLI does. ``--cache-dir DIR`` builds and loads the kernel
libraries in DIR (``kernels.set_build_dir``; default
``build/torch_kernels/``), JAX's flag of that name being its compile
cache.

    python -m rust_ray_tracer_tpu_torch 256 16 --scene cornell_box -a 1.0 \\
        -o cornell.png --device cuda
    python -m rust_ray_tracer_tpu_torch 144 16 -g scene.gltf -o scene.png
    python -m rust_ray_tracer_tpu_torch 64 4 --devices 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_ray_tracer_tpu_torch",
        description="wavefront path tracer on PyTorch + Hopper kernels")
    p.add_argument("height", type=int, nargs="?", default=256,
                   help="image height in pixels (reference positional 1)")
    p.add_argument("samples", type=int, nargs="?", default=16,
                   help="samples per pixel (reference positional 2)")
    p.add_argument("-o", "--output", default="out.png",
                   help="output PNG path")
    p.add_argument("-a", "--aspect", type=float, default=16 / 9,
                   help="aspect ratio (width = height * aspect)")
    p.add_argument("-g", "--gltf", default=None,
                   help="glTF 2.0 scene file (.gltf or .glb)")
    p.add_argument("--scene", default=None,
                   help="procedural scene name (random, two_spheres, "
                        "perlin_spheres, earth, rect_light, cornell_box, "
                        "cornell_triangle, final_scene, composite); "
                        "overrides --gltf; cornell_box without either")
    p.add_argument("--depth", type=int, default=4,
                   help="max bounce depth (reference MAX_DEPTH=4)")
    p.add_argument("--seed", type=int, default=0,
                   help="render seed (bitwise-reproducible)")
    p.add_argument("--chunk-size", type=int, default=32768,
                   help="rays per wavefront chunk")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the Hopper kernels; cpu: their plain "
                        "versions")
    p.add_argument("--no-flip", action="store_true",
                   help="skip the reference's vertical flip at write time")
    p.add_argument("--devices", type=int, default=None,
                   help="processes to shard rays over, one card each "
                        "(default: every visible card; 1 with --device "
                        "cpu)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable rendering "
                        "(default: <output>.ckpt)")
    p.add_argument("--ckpt-every", type=int, default=8,
                   help="checkpoint every N sample waves")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous address (host:port)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--compact", choices=("auto", "on", "off"),
                   nargs="?", const="on", default="auto",
                   help="bounce-major cross-chunk alive compaction: 'auto' "
                        "(default) takes it when most of the frame hits "
                        "the scene and the trace kernel does not take it "
                        "on the card (ops/integrator.auto_compact); "
                        "shard-local under --devices")
    p.add_argument("--cache-dir", default=None,
                   help="directory the kernel libraries are built in and "
                        "loaded from (default: build/torch_kernels/)")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, n: int, device: str) -> int:
    """Run the CLI as ``n`` local worker processes joined at a local TCP
    rendezvous, one card each (``LOCAL_RANK``); the worst exit code."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    if device == "cpu" and "OMP_NUM_THREADS" not in env:
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rust_ray_tracer_tpu_torch", *argv,
                 "--coordinator", addr, "--num-processes", str(n),
                 "--process-id", str(r)], env={**env, "LOCAL_RANK": str(r)}))
        return max(p.wait() for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)

    import torch

    if args.cache_dir:
        from rust_ray_tracer_tpu_torch import kernels
        kernels.set_build_dir(args.cache_dir)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA GPU is available "
              "(use --device cpu for the plain version)", file=sys.stderr)
        return 2

    from rust_ray_tracer_tpu_torch.parallel import make_mesh, multihost_init

    joined = (args.coordinator is not None or (args.num_processes or 1) > 1
              or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not joined:
        n_dev = args.devices or (torch.cuda.device_count()
                                 if args.device == "cuda" else 1)
        if n_dev < 1:
            print(f"error: --devices {n_dev}", file=sys.stderr)
            return 2
        if args.device == "cuda" and n_dev > torch.cuda.device_count():
            print(f"error: --devices {n_dev} but found "
                  f"{torch.cuda.device_count()} CUDA device(s)",
                  file=sys.stderr)
            return 2
        if n_dev > 1:
            return _spawn(argv, n_dev, args.device)
    try:
        multihost_init(args.coordinator, args.num_processes,
                       args.process_id, args.device)
        mesh = make_mesh(n_devices=args.devices if joined else None,
                         device=args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        return _render(args, mesh)
    finally:
        if mesh.group is not None:
            torch.distributed.destroy_process_group()


def _render(args, mesh) -> int:
    """Render on ``mesh``'s device, sharded over its ranks when it has
    more than one, and on rank 0 write the PNG."""
    import torch

    from rust_ray_tracer_tpu_torch.models import builders
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
    from rust_ray_tracer_tpu_torch.models.scene import compile_scene
    from rust_ray_tracer_tpu_torch.ops.integrator import auto_compact
    from rust_ray_tracer_tpu_torch.ops.tonemap import tonemap_mean
    from rust_ray_tracer_tpu_torch.parallel.checkpoint import (
        render_with_checkpoints)
    from rust_ray_tracer_tpu_torch.utils.image import save_png

    device = mesh.device
    height = args.height
    width = int(height * args.aspect)
    spp = args.samples
    try:
        if args.gltf and not args.scene:
            host_scene = load_gltf_scene(args.gltf, args.aspect)
        else:
            host_scene = builders.get_scene(args.scene or "cornell_box",
                                            args.aspect, args.seed)
    except (ValueError, NotImplementedError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    scene = compile_scene(host_scene, seed=0, device=device)
    if args.compact == "auto":
        compact = auto_compact(scene)
        if mesh.rank == 0:
            print(f"  compact=auto -> {'on' if compact else 'off'}",
                  flush=True)
    else:
        compact = args.compact == "on"
    ckpt = args.checkpoint or (args.output + ".ckpt")
    t0 = time.perf_counter()

    def progress(done, total):
        if mesh.rank == 0:
            dt = time.perf_counter() - t0
            rate = width * height * done * args.depth / max(dt, 1e-9)
            print(f"  wave {done}/{total}  {rate / 1e6:.2f} Mrays/s",
                  flush=True)

    try:
        img = render_with_checkpoints(
            scene, width, height, spp, args.seed, ckpt,
            ckpt_every=args.ckpt_every, depth=args.depth,
            chunk_size=args.chunk_size,
            mesh=mesh if mesh.size > 1 else None, compact=compact,
            progress=progress)
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if mesh.rank != 0:
        return 0
    u8 = tonemap_mean(img).cpu().numpy()
    dt = time.perf_counter() - t0
    save_png(args.output, u8, flip_vertical=not args.no_flip)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"wrote {args.output} ({width}x{height}, {spp}spp, depth "
          f"{args.depth}, {name}, {mesh.size} process(es)) in {dt:.2f}s "
          f"including set-up; mean radiance {float(img.mean()):.6f}, finite "
          f"{bool(torch.isfinite(img).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
