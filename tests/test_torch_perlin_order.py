"""The order of ``ops/perlin.noise``'s corner dot on the CPU.

``noise`` sums each corner's dot ``g0 * w0 + g1 * w1 + g2 * w2`` left to
right, as the Hopper kernels' marble (TPU kernel C) and
``perlin._noise_row`` do; it used to be ``(grad * weight).sum(-1)``,
which torch's CUDA reduction adds in another order (``chip_smoke.py``'s
``marble_trace`` counts the lanes). On the CPU the two forms must agree
bit for bit, values and gradients, so every CPU render and every test
against the JAX package is what it was.
"""

import torch

from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import gather, perlin

from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


def _noise_reduced(perlin_vec, px, py, pz, p):
    """``perlin.noise`` with the corner dot as ``(grad * weight).sum(-1)``."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int32)
    s = uvw * uvw * (3.0 - 2.0 * uvw)
    perm = (px.long(), py.long(), pz.long())
    h = [[perm[a][((ijk[..., a] + d) & 255).long()] for d in (0, 1)]
         for a in range(3)]
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                grad = gather.rows(perlin_vec,
                                   (h[0][di] ^ h[1][dj] ^ h[2][dk]).long())
                weight = uvw - torch.tensor([di, dj, dk], dtype=p.dtype)
                w = ((di * s[..., 0] + (1 - di) * (1 - s[..., 0]))
                     * (dj * s[..., 1] + (1 - dj) * (1 - s[..., 1]))
                     * (dk * s[..., 2] + (1 - dk) * (1 - s[..., 2])))
                acc = acc + w * (grad * weight).sum(-1)
    return acc


def test_corner_dot_is_the_cpu_sum_bit_for_bit():
    sc = compile_scene(builders.random_scene(16 / 9), device="cpu")
    tables = (sc.perlin_px, sc.perlin_py, sc.perlin_pz)
    g = torch.Generator().manual_seed(3)
    for scale in (1.0, 30.0, 1000.0):
        p = (torch.rand(20000, 3, generator=g) * 2 - 1) * scale
        out = []
        for fn in (perlin.noise, _noise_reduced):
            vec = sc.perlin_vec.clone().requires_grad_()
            q = p.clone().requires_grad_()
            val = fn(vec, *tables, q)
            out.append((val, *torch.autograd.grad(val.sum() * 1.37,
                                                   [vec, q])))
        for a, b in zip(*out):
            assert torch.equal(a, b), scale
