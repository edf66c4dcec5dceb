"""One rank of a multi-process dry run of the sharded renderer:

    python -m rust_ray_tracer_tpu_torch.parallel.dryrun --coordinator \\
        127.0.0.1:29500 --num-processes 2 --process-id 0 --device cpu \\
        --out rank0.pt

The counterpart of ``__graft_entry__.dryrun_multichip``: on the mesh of
``--num-processes`` ranks it renders ``--scene`` sharded (no gradient),
then takes one training step — the scene gradients of ``mean(image)``
through the sharded render, all-reduced over the ranks — and one SGD step
on them, whose loss it renders again. With ``--also-compact`` it then does
all of that a second time, in the same process, through the compact
wavefront, shard-local, as ``dryrun_multichip`` trains
(``render_waves_sharded(..., compact=True)``): one launch holds both
routes against a one-process render.
Rank r saves (``torch.save``) its image, loss, gradients and loss after
the step (the compact run's under ``"compact"``) to ``--out`` with ``.pt``
replaced by ``.<r>.pt``, for a caller to hold against a one-process
render and the other ranks.
"""

from __future__ import annotations

import argparse

import torch


def _scene(name: str, aspect: float, device):
    from rust_ray_tracer_tpu_torch.models import builders
    from rust_ray_tracer_tpu_torch.models.scene import compile_scene
    host = (builders.procedural_flagship() if name == "flagship"
            else builders.get_scene(name, aspect, 0))
    return compile_scene(host, seed=0, device=device)


def run(mesh, scene_name="flagship", width=32, height=24, spp=2, depth=4,
        chunk_size=64, lr=1e-2, compact=False) -> dict:
    """The dry run on ``mesh``: the sharded image, and one step's loss,
    gradients and loss after an SGD step, as host tensors; ``compact``
    renders through the compact wavefront."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.parallel.render import (
        render_waves_sharded)
    from rust_ray_tracer_tpu_torch.utils import rng

    scene = _scene(scene_name, width / height, mesh.device)
    key = rng.key(0, mesh.device)
    with torch.no_grad():
        img = render_waves_sharded(scene, width, height, key, 0, spp, mesh,
                                   depth, chunk_size, compact=compact)
    params, static = partition(scene)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = render_waves_sharded(combine(leaves, static), width, height, key,
                                0, spp, mesh, depth, chunk_size,
                                compact=compact).mean()
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    with torch.no_grad():
        stepped = {k: v - lr * v.grad if v.grad is not None else v
                   for k, v in leaves.items()}
        loss2 = render_waves_sharded(combine(stepped, static), width, height,
                                     key, 0, spp, mesh, depth, chunk_size,
                                     compact=compact).mean()
    return {"image": img.cpu(), "loss": loss.detach().cpu(),
            "grads": {k: v.cpu() for k, v in grads.items()},
            "loss_after_step": loss2.cpu(), "rank": mesh.rank,
            "size": mesh.size}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rust_ray_tracer_tpu_torch.parallel."
                                "dryrun")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--scene", default="flagship")
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--chunk-size", type=int, default=64)
    p.add_argument("--also-compact", action="store_true",
                   help="after the per-chunk dry run, run it again through "
                   "the compact wavefront (saved under 'compact')")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from rust_ray_tracer_tpu_torch.parallel.mesh import (make_mesh,
                                                         multihost_init)
    multihost_init(args.coordinator, args.num_processes, args.process_id,
                   args.device, args.backend)
    try:
        mesh = make_mesh(n_devices=args.num_processes, device=args.device)
        out = run(mesh, args.scene, args.width, args.height, args.spp,
                  args.depth, args.chunk_size)
        if args.also_compact:
            out["compact"] = run(mesh, args.scene, args.width, args.height,
                                 args.spp, args.depth, args.chunk_size,
                                 compact=True)
        for r in (out, out.get("compact", out)):
            if not bool(torch.isfinite(r["loss_after_step"])):
                raise AssertionError("non-finite loss after the SGD step")
        path = args.out[:-3] if args.out.endswith(".pt") else args.out
        torch.save(out, f"{path}.{mesh.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
