"""Command-line renderer.

Counterpart of ``rust_ray_tracer_tpu/utils/cli.py`` (and the reference
binary, ``src/main.rs:26-118`` of the reference): positional HEIGHT and
SAMPLES, ``-o`` output PNG, ``-g`` glTF (or .glb) input, ``-a`` aspect
ratio, ``--scene`` (which overrides ``-g``; the Cornell box without
either), ``--depth``, ``--seed`` and ``--chunk-size``, plus ``--device``.
The device defaults to ``cuda`` and the run fails when no GPU is present —
it never drops to the CPU on its own; ``--device cpu`` runs the plain
version.

``--compact``, checkpointing and the multi-host flags are not ported yet
and exit with a message saying so.

    python -m rust_ray_tracer_tpu_torch 256 16 --scene cornell_box -a 1.0 \\
        -o cornell.png --device cuda
    python -m rust_ray_tracer_tpu_torch 144 16 -g scene.gltf -o scene.png
"""

from __future__ import annotations

import argparse
import sys
import time

# flag -> ROADMAP queue 1 item that ports it
_NOT_PORTED = {
    "compact": ("--compact", "14"),
    "checkpoint": ("--checkpoint", "16"),
    "coordinator": ("--coordinator", "16"),
    "num_processes": ("--num-processes", "16"),
    "process_id": ("--process-id", "16"),
    "devices": ("--devices", "16"),
}


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
    # not yet ported: accepted so the message can say so
    p.add_argument("--compact", nargs="?", const="on", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--devices", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for attr, (flag, item) in _NOT_PORTED.items():
        if getattr(args, attr) is not None:
            print(f"error: {flag} is not yet ported to "
                  f"rust_ray_tracer_tpu_torch (ROADMAP queue 1 item {item})",
                  file=sys.stderr)
            return 2

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA GPU is available "
              "(use --device cpu for the plain version)", file=sys.stderr)
        return 2

    from rust_ray_tracer_tpu_torch.models import builders
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
    from rust_ray_tracer_tpu_torch.models.scene import compile_scene
    from rust_ray_tracer_tpu_torch.ops.integrator import render_image
    from rust_ray_tracer_tpu_torch.ops.tonemap import tonemap_mean
    from rust_ray_tracer_tpu_torch.utils import rng
    from rust_ray_tracer_tpu_torch.utils.image import save_png

    device = torch.device(args.device)
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

    t0 = time.perf_counter()
    img = render_image(scene, width, height, spp, rng.key(args.seed, device),
                       depth=args.depth, chunk_size=args.chunk_size)
    u8 = tonemap_mean(img).cpu().numpy()
    dt = time.perf_counter() - t0
    save_png(args.output, u8, flip_vertical=not args.no_flip)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"wrote {args.output} ({width}x{height}, {spp}spp, depth "
          f"{args.depth}, {name}) in {dt:.2f}s including set-up; "
          f"mean radiance {float(img.mean()):.6f}, finite "
          f"{bool(torch.isfinite(img).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
