"""The Hopper trace kernels (csrc/trace_wave.cu, csrc/trace_wave_bwd.cu)
against their plain versions.

Imports no JAX, so it runs on a GPU machine without it. tests/conftest.py
imports JAX, so there it runs without the conftest (and without the
pytest.ini workers):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider \\
        tests/test_torch_gpu.py -q

The tests marked ``gpu`` skip where there is no CUDA device; the others
check on the CPU what the wrapper and the dispatcher refuse.
"""

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu_torch.kernels import (bwd_reduce_kernel,
                                               trace_wave_bwd_kernel,
                                               trace_wave_kernel)
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import (LIGHT_SPHERE,
                                                    compile_scene)
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng

# by its own name (pytest puts tests/ on sys.path): on a machine where an
# installed package is called ``tests``, ``tests.torch_parity`` is not found
from torch_parity import (SMALL_SCENES, assert_flip_budget,
                          assert_scaled_close, rel_l2, torch_scene)

W = H = 32          # one 1024-ray chunk
DEPTH = 4


def _scene(name):
    if name in SMALL_SCENES:
        return torch_scene(name)
    if name == "flagship":          # the one with a sphere light
        return compile_scene(builders.flagship(), device="cpu")
    return compile_scene(builders.get_scene(name, 1.0), device="cpu")


def _inputs(ts, seed=7):
    return uber.wave_inputs(ts, rng.wave_key(rng.key(seed, "cpu"), 0), W, H,
                            DEPTH, W * H)


def test_kernel_wrapper_refuses_cpu_tensors():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    before = trace_wave_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_wave_kernel(st0, rnd, uber.make_ctx(ts), DEPTH)
    assert trace_wave_kernel.launches == before


def test_dispatcher_refuses_other_devices():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    with pytest.raises(ValueError, match="unsupported device"):
        uber.trace_wave(st0.to("meta"), rnd.to("meta"), uber.make_ctx(ts),
                        DEPTH)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the trace kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solid", "checker", "quad", "cornell_box",
                                  "cornell_triangle"])
def test_kernel_matches_plain_on_card(name, cuda):
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    before = trace_wave_kernel.launches
    got = uber.trace_wave(st0.to(cuda), rnd.to(cuda), ctx, DEPTH)
    torch.cuda.synchronize()
    assert trace_wave_kernel.launches == before + 1
    ref = uber.trace_wave_plain(st0, rnd, uber.make_ctx(ts), DEPTH)
    assert_flip_budget(got[8:11].cpu().numpy().T, ref[8:11].numpy().T)


@pytest.mark.gpu
def test_wave_inputs_bitwise_on_card(cuda):
    """The camera rays and threefry draws on the card are the CPU's, bit
    for bit (and so JAX's): the image depends only on (seed, chunk)."""
    ts = compile_scene(builders.flagship(), device="cpu")
    key = rng.wave_key(rng.key(3, "cpu"), 1)
    want = uber.wave_inputs(ts, key, 48, 27, DEPTH, 500)
    got = uber.wave_inputs(ts.to(cuda), key.to(cuda), 48, 27, DEPTH, 500)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _residuals_like(st0):
    """Zero residuals of the shapes the backward takes."""
    n = st0.shape[1]
    kind = torch.zeros((DEPTH, n), dtype=torch.int32)
    return torch.zeros((DEPTH, 14, n)), kind, kind.clone()


def test_bwd_wrappers_refuse_cpu_tensors():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    hist, kind, idx = _residuals_like(st0)
    before = (trace_wave_bwd_kernel.launches, bwd_reduce_kernel.launches)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace_wave_bwd_kernel(hist, rnd, kind, idx, ctx, st0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        i32 = torch.int32
        bwd_reduce_kernel(torch.zeros(4, 17), torch.zeros(4, dtype=i32),
                          torch.zeros(3, dtype=i32), torch.zeros(8, 28))
    assert (trace_wave_bwd_kernel.launches,
            bwd_reduce_kernel.launches) == before


def test_bwd_dispatcher_refuses_other_devices():
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    hist, kind, idx = _residuals_like(st0)
    with pytest.raises(ValueError, match="unsupported device"):
        uber.trace_wave_bwd(hist, rnd, kind, idx, ctx, st0.to("meta"))


def _bwd_on_card(name, cuda):
    """Kernel A with residuals, then B + bwd_reduce, on the card; and the
    plain backward on the CPU fed the card's residuals."""
    ts = _scene(name)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    stf, hist, kind, idx = trace_wave_kernel(st0.to(cuda), rnd.to(cuda), ctx,
                                             DEPTH, residuals=True)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st0.shape)).astype(np.float32))
    got = uber.trace_wave_bwd(hist, rnd.to(cuda), kind, idx, ctx,
                              g.to(cuda))
    torch.cuda.synchronize()
    ref = uber.trace_wave_bwd_plain(hist.cpu(), rnd, kind.cpu(), idx.cpu(),
                                    uber.make_ctx(ts), g)
    return st0, rnd, ts, (stf, hist, kind, idx), got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solid", "checker", "quad", "cornell_box",
                                  "flagship"])
def test_bwd_kernel_matches_plain_on_card(name, cuda):
    """B + bwd_reduce vs trace_wave_bwd_plain on the same residuals: dst
    per ray to rtol 1e-4 of its largest plane / atol 1e-6, at most 0.5% of
    the rays outside (an FMA can flip a recomputed branch: tir, metal_ok,
    a checker parity); duni and dlt to a relative L2 error of 1e-4 (sums
    in another order), and each light's row of dlt to 1e-4 of the row's
    largest entry, so a light's share is not hidden in the table's norm.
    A sphere light's centre and radius take a cotangent. A's residuals
    match the plain forward's."""
    st0, rnd, ts, (_, hist, kind, idx), got, ref = _bwd_on_card(name, cuda)
    _, p_hist, p_kind, p_idx = uber.trace_wave_plain(
        st0, rnd, uber.make_ctx(ts), DEPTH, residuals=True)
    assert torch.equal(kind[0].cpu(), p_kind[0])
    assert torch.equal(idx[0].cpu(), p_idx[0])
    for b in range(DEPTH):
        assert_scaled_close(hist[b].cpu().numpy(), p_hist[b].numpy(), 3e-4,
                            3e-5, axis=0, budget=0.005, what="hist")
    dst, duni, dlt = (x.cpu().numpy() for x in got)
    assert_scaled_close(dst, ref[0].numpy(), 1e-4, 1e-6, axis=0,
                        budget=0.005, what="dst")
    assert rel_l2(duni, ref[1]) <= 1e-4 and rel_l2(dlt, ref[2]) <= 1e-4
    ref_dlt = ref[2].numpy()
    for r in range(ref_dlt.shape[0]):
        assert np.abs(dlt[r] - ref_dlt[r]).max() <= (
            1e-6 + 1e-4 * np.abs(ref_dlt[r]).max()), f"dlt row {r}"
    assert np.abs(duni).max() > 0
    for li in range(ts.n_lights):
        if int(ts.light_kind[li]) == LIGHT_SPHERE:
            assert np.abs(ref_dlt[li, 1:5]).max() > 0


@pytest.mark.gpu
def test_bwd_kernel_bitwise_repeatable(cuda):
    """No float atomics: two runs of B + bwd_reduce agree bit for bit."""
    _, _, _, (_, hist, kind, idx), first, _ = _bwd_on_card("solid", cuda)
    ts = _scene("solid")
    ctx = uber.make_ctx(ts.to(cuda))
    _, rnd = _inputs(ts)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(14, hist.shape[2])).astype(np.float32)).to(cuda)
    second = uber.trace_wave_bwd(hist, rnd.to(cuda), kind, idx, ctx, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_render_waves_grads_on_card(cuda):
    """torch.autograd through render_waves on the card goes through A
    with residuals, B and bwd_reduce (one launch each), never the plain
    versions, and gives finite gradients, bit for bit the same twice."""
    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves

    params, static = partition(compile_scene(builders.cornell_box(1.0)))
    out = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        counts = [k.launches for k in (trace_wave_kernel,
                                       trace_wave_bwd_kernel,
                                       bwd_reduce_kernel)]
        render_waves(combine(leaves, static), 32, 32, rng.key(0), 0, 1,
                     chunk_size=1024).mean().backward()
        torch.cuda.synchronize()
        assert [k.launches - c for k, c in zip(
            (trace_wave_kernel, trace_wave_bwd_kernel, bwd_reduce_kernel),
            counts)] == [1, 1, 1]
        out.append({k: v.grad for k, v in leaves.items()
                    if v.grad is not None})
    assert out[0]["tex_color"].abs().max() > 0
    for k, v in out[0].items():
        assert bool(torch.isfinite(v).all()), k
        assert torch.equal(v, out[1][k]), k
