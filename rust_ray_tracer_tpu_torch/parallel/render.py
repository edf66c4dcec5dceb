"""Sharded wavefront rendering over a :class:`RayMesh`.

Counterpart of ``rust_ray_tracer_tpu/parallel/render.py``:

  * the flat pixel axis is cut into chunks, and chunk ``c`` of wave ``w``
    is a pure function of (key, w, c) (``ops/integrator.render_chunk``),
    so rank r of D renders the chunks ``{c : c mod D == r}`` (the chunk
    count padded to a multiple of D) and the image is the sequential
    renderer's, bit for bit;
  * each rank passes all its chunk ids of a wave to one ``render_chunk``
    call, so on the trace kernel's scenes TPU kernel D launches once a
    bounce a wave on each rank, not once a chunk; with ``compact`` to one
    ``trace_wave_compact`` call, which compacts the rank's own rays only
    (shard-local, JAX ``:58-71``: no rays cross ranks);
  * the ranks' slices are all-gathered in rank order and the round-robin
    interleave undone (JAX ``:113-119``): every rank holds the whole image;
  * under autograd the scene's float leaves pass through an identity whose
    backward all-reduces (SUM) their cotangents — what JAX's ``shard_map``
    transpose ``psum``s — and the gather's backward hands each rank its
    own slice of the image's cotangent. Every rank computes the same loss
    on the whole image, so the sum over ranks is the gradient, not the
    world size times it (``torch.distributed.nn.functional.all_gather``'s
    reduce-scatter backward would scale it so).

gloo carries no CUDA tensor through ``all_gather``, so on a gloo group a
CUDA tensor's collectives go through the host (a copy each way).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rust_ray_tracer_tpu_torch.models.scene import combine, partition
from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops.integrator import (MAX_DEPTH,
                                                      make_split_tables,
                                                      render_chunk,
                                                      trace_prep,
                                                      trace_wave_compact)
from rust_ray_tracer_tpu_torch.parallel.mesh import RayMesh
from rust_ray_tracer_tpu_torch.utils import rng as rngu


def _staged(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """``t`` as the group's backend carries it: on the host for a CUDA
    tensor on a gloo group."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.cpu()
    return t


def _all_gather(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """[size, *t.shape]: every rank's ``t`` in rank order."""
    if mesh.group is None:
        return t[None]
    src = _staged(t.contiguous(), mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(t.device)


def _all_reduce_sum(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The sum over ranks of ``t`` (the same bits on every rank)."""
    if mesh.group is None:
        return t
    buf = _staged(t.contiguous(), mesh).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


class _GatherRows(torch.autograd.Function):
    """All-gather of the ranks' radiance rows; the backward keeps this
    rank's slice of the cotangent."""

    @staticmethod
    def forward(fctx, rows, mesh):
        fctx.rank = mesh.rank
        return _all_gather(rows, mesh)

    @staticmethod
    def backward(fctx, g):
        return g[fctx.rank].contiguous(), None


class _ReduceGrads(torch.autograd.Function):
    """The identity on the scene's leaves; the backward sums their
    cotangents over the ranks in one all-reduce."""

    @staticmethod
    def forward(fctx, mesh, *leaves):
        fctx.mesh = mesh
        fctx.shapes = [x.shape for x in leaves]
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(fctx, *grads):
        flat = torch.cat([
            (torch.zeros(s, device=fctx.mesh.device) if g is None else g)
            .reshape(-1).float() for g, s in zip(grads, fctx.shapes)])
        flat = _all_reduce_sum(flat, fctx.mesh)
        out, i = [], 0
        for s in fctx.shapes:
            m = s.numel()
            out.append(flat[i:i + m].reshape(s))
            i += m
        return (None, *out)


def _reduced_scene(scene, mesh: RayMesh):
    """``scene`` with its leaves that require grad passed through
    :class:`_ReduceGrads`."""
    params, static = partition(scene)
    names = [k for k, v in params.items() if v.requires_grad]
    if not names or not torch.is_grad_enabled():
        return scene
    outs = _ReduceGrads.apply(mesh, *(params[k] for k in names))
    return combine({**params, **dict(zip(names, outs))}, static)


def render_waves_sharded(scene, width: int, height: int, key,
                         wave_start: int, n_waves: int, mesh: RayMesh,
                         depth: int = MAX_DEPTH, chunk_size: int = 8192,
                         acc0=None, compact: bool = False):
    """Sharded counterpart of ``ops/integrator.render_waves`` — [H, W, 3]
    on every rank: ``n_waves`` waves from ``wave_start`` added onto
    ``acc0`` in the sequential renderer's order, so resuming from a
    partial sum is bitwise. ``scene`` lives on ``mesh.device``
    (:func:`replicate_scene`); its gradients are summed over the ranks.
    ``compact=True`` runs each rank's chunks through
    ``trace_wave_compact``, processing chunk ``chunk_size``: the
    one-process image."""
    n = width * height
    size = mesh.size
    n_chunks = -(-n // chunk_size)
    n_chunks = -(-n_chunks // size) * size       # a multiple of the ranks
    cpd = n_chunks // size
    dev = scene.device
    key = key.to(dev)
    scene = _reduced_scene(scene, mesh)
    prep = make_split_tables(scene) if compact else trace_prep(scene)
    ids = torch.arange(cpd, device=dev) * size + mesh.rank

    def one_wave(wave):
        wkey = rngu.wave_key(key, wave)
        if compact:
            rows = trace_wave_compact(scene, wkey, width, height, depth,
                                      chunk_size, ids, None, prep)
        else:
            rows = render_chunk(scene, wkey, ids, chunk_size, width, height,
                                depth, prep)
        flat = _GatherRows.apply(rows.reshape(cpd * chunk_size, 3), mesh)
        # undo the round-robin interleave: rank r's local chunk i is the
        # global chunk i * size + r
        flat = flat.reshape(size, cpd, chunk_size, 3).transpose(0, 1)
        return cam_ops.image_from_positions(
            flat.reshape(n_chunks * chunk_size, 3)[:n], width, height)

    acc = acc0
    if acc is None:
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=dev)
    for i in range(n_waves):
        acc = acc + one_wave(wave_start + i)
    return acc


def render_image_sharded(scene, width: int, height: int, spp: int, key,
                         mesh: RayMesh, depth: int = MAX_DEPTH,
                         chunk_size: int = 8192):
    """Mean radiance image [H, W, 3], the rays sharded over ``mesh``."""
    acc = render_waves_sharded(scene, width, height, key, 0, spp, mesh,
                               depth, chunk_size)
    return acc / spp


def replicate_scene(scene, mesh: RayMesh):
    """``scene`` on this rank's device (every rank holds all of it)."""
    return scene.to(mesh.device)
