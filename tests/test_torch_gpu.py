"""The Hopper trace kernel (csrc/trace_wave.cu) against its plain version.

Imports no JAX, so it runs on a GPU machine without it. tests/conftest.py
imports JAX, so there it runs without the conftest (and without the
pytest.ini workers):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider \\
        tests/test_torch_gpu.py -q

The tests marked ``gpu`` skip where there is no CUDA device; the others
check on the CPU what the wrapper and the dispatcher refuse.
"""

import pytest
import torch

from rust_ray_tracer_tpu_torch.kernels import trace_wave_kernel
from rust_ray_tracer_tpu_torch.models import builders
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng

# by its own name (pytest puts tests/ on sys.path): on a machine where an
# installed package is called ``tests``, ``tests.torch_parity`` is not found
from torch_parity import SMALL_SCENES, assert_flip_budget, torch_scene

W = H = 32          # one 1024-ray chunk
DEPTH = 4


def _scene(name):
    if name in SMALL_SCENES:
        return torch_scene(name)
    return compile_scene(builders.get_scene(name, 1.0))


def _inputs(ts, seed=7):
    return uber.wave_inputs(ts, rng.wave_key(rng.key(seed), 0), W, H, DEPTH,
                            W * H)


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
    ts = compile_scene(builders.flagship())
    key = rng.wave_key(rng.key(3), 1)
    want = uber.wave_inputs(ts, key, 48, 27, DEPTH, 500)
    got = uber.wave_inputs(ts.to(cuda), key.to(cuda), 48, 27, DEPTH, 500)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_kernel_refuses_grad(cuda):
    ts = _scene("solid")
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts.to(cuda))
    ctx.uni.requires_grad_()
    with pytest.raises(NotImplementedError, match="queue 2 B"):
        uber.trace_wave(st0.to(cuda), rnd.to(cuda), ctx, DEPTH)
