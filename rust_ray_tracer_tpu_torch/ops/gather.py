"""Row gathers from small scene tables whose backward sums in a fixed
order.

The split route's glue gathers per ray from small tables: the winner rows
(``uni``, ``med_rows``; a miss or medium lane reads row 0), the texture
colours and scales, the Perlin gradients (``texture_value``, 256 rows, 56
gathers a bounce). Their cotangents go back to a few rows from up to every
ray of a wave. PyTorch's CUDA backward of ``table[idx]`` sorts the indices
and walks each run of equal indices in series, which took 90% of a
final_scene training step on an H100 (PERF.md). :func:`rows` runs
the backward through the port's own fixed-order reduction instead:
``kernels.reduce_order`` (a stable sort of the row ids) and
``bwd_reduce_kernel`` (B', which also sums kernel B's winner-row
cotangents), which cuts a long run into pieces summed by separate blocks
and adds the pieces in order. No float atomics: the gradients repeat bit
for bit. On the CPU the backward is ``index_add_``.
"""

from __future__ import annotations

import torch


def row_sums(g, idx, n_rows: int):
    """[n_rows, W] sums of the cotangent rows ``g`` [N, W] by row id
    ``idx`` [N] (int64, each in [0, n_rows)): ``index_add_`` for CPU
    tensors, the fixed-order reduction (``bwd_reduce_kernel``) for CUDA
    tensors."""
    dev = g.device.type
    if dev == "cpu":
        return torch.zeros((n_rows, g.shape[1]), dtype=g.dtype).index_add_(
            0, idx, g)
    if dev != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    from rust_ray_tracer_tpu_torch.kernels import (bwd_reduce_kernel,
                                                   reduce_order)
    perm, offs = reduce_order(idx.to(torch.int32), n_rows)
    sums, _ = bwd_reduce_kernel(g.contiguous(), perm, offs,
                                torch.empty((0, 0), dtype=g.dtype,
                                            device=g.device))
    return sums


class RowGather(torch.autograd.Function):
    """``table[idx]`` for a table [R] or [R, W] and row ids ``idx`` [N];
    the backward is :func:`row_sums`."""

    @staticmethod
    def forward(fctx, table, idx):
        fctx.save_for_backward(idx)
        fctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(fctx, g):
        (idx,) = fctx.saved_tensors
        shape = fctx.shape
        d = row_sums(g.reshape(idx.shape[0], -1), idx, shape[0])
        return d.reshape(shape), None


def rows(table, idx):
    """``table[idx]`` for int64 row ids ``idx`` of any shape,
    differentiable in ``table`` through :class:`RowGather`."""
    out = RowGather.apply(table, idx.reshape(-1))
    return out.reshape(idx.shape + table.shape[1:])
