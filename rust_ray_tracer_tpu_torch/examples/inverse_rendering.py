"""Inverse rendering: recover a material's albedo by gradient descent
through the renderer — the port of ``examples/inverse_rendering.py``.

Render a target image with known materials, then optimize a
mis-initialized scene's albedo until its renders match: the gradients
flow through ``torch.autograd`` and, on the card, through the trace
kernel's backward (``csrc/trace_wave_bwd.cu``). Same scene, size (48x48,
4 spp, depth 3, chunk 1024), common random numbers, albedo-only update and
60 steps as the JAX example; ``torch.optim.Adam(lr=5e-2)`` after
``clip_grad_norm_(..., 1.0)`` takes the place of optax.

    python -m rust_ray_tracer_tpu_torch.examples.inverse_rendering \\
        [--device cuda|cpu] [--steps 60]

Exits 0 when the recovered albedo is within 0.1 of the target.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops.camera import make_camera
from rust_ray_tracer_tpu_torch.ops.integrator import render_image
from rust_ray_tracer_tpu_torch.utils import rng

W, H, SPP, DEPTH, CHUNK = 48, 48, 4, 3, 1024
TARGET_ALBEDO = (0.75, 0.25, 0.55)
EMIT = (3.0, 2.6, 2.2)


def build(albedo, emit, device):
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 45.0, 1.0)
    return compile_scene(S.Scene(cam, [
        S.Sphere((0, 0, -4), 1.3, S.Lambertian.from_color(albedo)),
        S.XYRect(-4.0, 4.0, -4.0, 4.0, 3.0,
                 S.DiffuseLight.from_color(emit)),
    ], [], (0.05, 0.05, 0.08)), device=device)


def run(steps: int = 60, device="cuda", log=print) -> dict:
    """Optimize the sphere's albedo for ``steps`` steps; returns the loss
    per step, the recovered and target albedo and the largest error."""
    key = rng.key(0, device)
    target_scene = build(TARGET_ALBEDO, EMIT, device)
    with torch.no_grad():
        target = render_image(target_scene, W, H, SPP, key, depth=DEPTH,
                              chunk_size=CHUNK)

    # mis-initialize the albedo; the emission starts at the truth and
    # stays fixed (albedo and emission are gauge-ambiguous from an image
    # in which the lamp is not directly visible)
    params, static = partition(build((0.5, 0.5, 0.5), EMIT, device))
    tex = params["tex_color"].clone().requires_grad_()
    opt = torch.optim.Adam([tex], lr=5e-2)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        # common random numbers: the target's key, so the Monte Carlo
        # noise cancels in the residual
        img = render_image(combine({**params, "tex_color": tex}, static), W,
                           H, SPP, key, depth=DEPTH, chunk_size=CHUNK)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        with torch.no_grad():
            tex.grad[1:] = 0.0          # the albedo row only
        # clip: one firefly path (pdf floored at 1e-5) can spike a step's
        # gradient by orders of magnitude
        torch.nn.utils.clip_grad_norm_([tex], 1.0)
        opt.step()
        losses.append(float(loss.detach()))
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {losses[-1]:.6f}")
    got = tex.detach()[0].cpu().numpy()
    want = target_scene.tex_color[0].cpu().numpy()
    return {"losses": losses, "albedo": got.tolist(),
            "target": want.tolist(),
            "max_albedo_err": float(np.abs(got - want).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.steps, args.device)
    print("target  albedo:", np.round(out["target"], 3).tolist())
    print("learned albedo:", np.round(out["albedo"], 3).tolist())
    print(f"max albedo error: {out['max_albedo_err']:.3f} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0 if out["max_albedo_err"] < 0.1 else 1


if __name__ == "__main__":
    sys.exit(main())
