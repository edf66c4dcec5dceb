"""The byte bound of the backward trace kernels B and D'
(``tools/search_times.bwd_bytes``, which ``chip_smoke.py`` counts with)
against counts made by hand: a two-bounce input written out ray by ray,
and the plain forward's residuals of a 32x32 wave of the flagship counted
one ray-bounce at a time."""

import torch

from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.tools.search_times import bwd_bytes
from rust_ray_tracer_tpu_torch.utils import rng

W_COLS = 17


def _uni(materials):
    """Winner rows [len(materials), W_COLS], the material id in A_COL."""
    uni = torch.zeros((len(materials), W_COLS))
    uni[:, uber.A_COL] = torch.tensor(materials, dtype=torch.float32)
    return uni


def test_bwd_bytes_two_bounces_by_hand():
    """256 rays, 2 bounces, one light. Bounce 0: rays 0-9 live, rays 0-5
    found rows 0, 0, 1, 2, 3, 0 (Lambertian, Lambertian, metal,
    dielectric, light, Lambertian), ray 20 dead with a winner. Bounce 1:
    rays 0-3 live, rays 0-2 found rows 1, 0, 2, ray 3 a miss."""
    depth, n = 2, 256
    hist = torch.zeros((depth, 14, n))
    hist[0, 7, :10] = 1.0
    hist[1, 7, :4] = 1.0
    kind = torch.zeros((depth, n), dtype=torch.int32)
    idx = torch.zeros((depth, n), dtype=torch.int32)
    kind[0, :6] = 1
    kind[0, 20] = 1
    idx[0, :6] = torch.tensor([0, 0, 1, 2, 3, 0], dtype=torch.int32)
    kind[1, :2] = 2
    kind[1, 2] = 3
    idx[1, :3] = torch.tensor([1, 0, 2], dtype=torch.int32)
    uni = _uni([0, 1, 2, 3])
    lt = torch.zeros((2, 14))
    floats = (2 * 256              # every ray-bounce's alive plane
              + 14 * 4             # 14 live: kind and beta
              + 9 * (7 + 1 + 1 + W_COLS)   # 9 found: o, d, time, idx,
                                           # key and row cotangent
              + (6 + 6 + 4 + 1 + 0 + 6)    # bounce 0's randoms
              + (4 + 6 + 1)                # bounce 1's
              + 2 * 14 * 256       # g in, dst out
              + 4 * W_COLS + 2 * 14        # uni, lt
              + 2 * 2 * 14)        # two blocks' light-table partials
    assert floats == 8156
    assert bwd_bytes(hist, kind, idx, uni, lt, 1) == 4 * 8156
    tables = (torch.zeros((256, 3)), torch.zeros((3, 256), dtype=torch.int32))
    assert bwd_bytes(hist, kind, idx, uni, lt, 1, tables) == 4 * (
        8156 + 768 + 768)
    # without lights a Lambertian hit reads 2 randoms, not 6
    lt0 = torch.zeros((1, 14))
    assert bwd_bytes(hist, kind, idx, uni, lt0, 0) == 4 * (
        8156 - 4 * 4 - 14 - 2 * 14)


def test_bwd_bytes_recorded_wave_by_ray():
    """The plain forward's residuals of the flagship's 32x32 wave (depth
    4), counted one ray-bounce at a time."""
    ts = compile_scene(builders.procedural_flagship(), device="cpu")
    st0, rnd = uber.wave_inputs(ts, rng.wave_key(rng.key(7, "cpu"), 0), 32,
                                32, 4, 1024)
    ctx = uber.make_ctx(ts)
    _, hist, kind, idx = uber.trace_wave_plain(st0, rnd, ctx, 4,
                                               residuals=True)
    depth, _, n = hist.shape
    w = ctx.uni.shape[1]
    reads = {0: 6 if ctx.n_lights else 2, 1: 4, 2: 1}
    floats, found = 0, 0
    for b in range(depth):
        for r in range(n):
            floats += 1
            if not hist[b, 7, r] > 0.5:
                continue
            floats += 4
            if kind[b, r] > 0:
                found += 1
                mat = int(ctx.uni[int(idx[b, r]), uber.A_COL])
                floats += 7 + 1 + 1 + w + reads.get(mat, 0)
    floats += (2 * 14 * n + ctx.uni.numel() + ctx.lt.numel()
               + n // 128 * (ctx.n_lights + 1) * 14)
    assert found > 0
    assert bwd_bytes(hist, kind, idx, ctx.uni, ctx.lt,
                     ctx.n_lights) == 4 * floats
