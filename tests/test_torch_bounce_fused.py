"""The fused bounce of solid and checker scenes (TPU kernel F) and its
backward (F'), their plain versions against the JAX package on the CPU.

On the inputs the port's split route gives kernel F over two bounces of a
32x32 wave of the fog scene with solid textures (``torch_parity.
solid_fog``: a checker ground of solids, glass, a metal wall, a Cuboid fog
and a sphere-bounded medium, a rect light; every kind of winner, medium
lanes among them), with the checker planes (``checker``) or without them
and the checker flags (``solid``):
  * F: ``ops/bounce_core.bounce_plane_core`` against
    ``pallas_bounce._bounce_planes_call`` in interpret mode: every lane
    within rtol 1e-5 of its largest plane / atol 1e-6 (measured 1.5e-6 of
    the lane's largest);
  * F': ``bounce_plane_core_vjp`` against ``pallas_bounce._bp_bwd``
    (``jax.vjp`` of the same core, its backward kernel in interpret mode)
    with a cotangent drawn from a seed: dP within rtol 1e-5 of the lane's
    largest value / atol 1e-6 on all but 0.5% of the lanes and within 1e-4
    on every lane, the light table's cotangent within relative L2 1e-5
    (measured: 3 and 4 of the 2,048 lanes beyond 1e-5, at most 2.2e-5,
    adjoint sums of cancelling terms in another order; the table at
    1.4e-7);
  * ``ops/bounce.BouncePlanes`` (F and F' by the tensors' device, here
    the plain versions) against ``torch.autograd.grad`` of the plain
    forward: the same bounds (measured: every lane within 6.3e-6, the
    table at 1e-8).

tests/test_torch_gpu.py and chip_smoke.py hold the CUDA kernels against
these plain versions on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_bounce
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu_torch.ops import bounce
from rust_ray_tracer_tpu_torch.ops.bounce_core import (N_IN_B,
                                                       bounce_plane_core,
                                                       bounce_plane_core_vjp)
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import (assert_scaled_close, rel_l2, split_recorder,
                                torch_scene)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)


def _inputs(variant):
    """Kernel F's inputs over two bounces of a 32x32 wave of the solid fog
    scene, the bounces' lanes concatenated: (P, pkind, mkind, flags, lt,
    n_lights); ``solid`` drops the checker planes and flags."""
    ts = torch_scene("solid_fog")
    with split_recorder() as rec:
        render_waves(ts, 32, 32, rng.key(7, "cpu"), 0, 1, depth=2,
                     chunk_size=1024)
    calls = rec["bp"]
    assert len(calls) == 2 and not rec["hit"] and not rec["su"]
    P = torch.cat([c[0] for c in calls], dim=1)
    pkind, mkind, flags = (torch.cat([c[i] for c in calls]) for i in (1, 2,
                                                                      3))
    assert P.shape[0] == N_IN_B + 6
    assert set(pkind.tolist()) == {0, 2, 3, 4}   # miss, sphere, quad, medium
    assert bool(((flags & 2) > 0).any())
    if variant == "solid":
        P, flags = P[:N_IN_B].contiguous(), flags & 1
    return P, pkind, mkind, flags, calls[0][4], calls[0][5]


def _planes(x):
    """[C, N] -> [C, N / 128, 128], the TPU kernels' plane layout."""
    x = x.numpy()
    return jnp.asarray(x.reshape(x.shape[:-1] + (-1, 128)))


def _cot(n, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(13, n)).astype(np.float32))


@pytest.mark.parametrize("variant", ["checker", "solid"])
def test_bounce_plane_core_matches_kernel_f(variant, interpret):
    P, pkind, mkind, flags, lt, n_lights = _inputs(variant)
    n = P.shape[1]
    ref = np.asarray(pallas_bounce._bounce_planes_call(
        _planes(P), _planes(pkind), _planes(mkind), _planes(flags),
        jnp.asarray(lt.numpy()))).reshape(13, n)
    got = bounce_plane_core(P, pkind, mkind, flags, lt, n_lights,
                            variant == "checker").numpy()
    assert_scaled_close(got, ref, RTOL, ATOL, axis=0, what="next state")
    assert 0 < ref[12].mean() < 1                 # some paths go on


@pytest.mark.parametrize("variant", ["checker", "solid"])
def test_bounce_plane_core_vjp_matches_kernel_f_bwd(variant, interpret):
    P, pkind, mkind, flags, lt, n_lights = _inputs(variant)
    n = P.shape[1]
    g = _cot(n)
    ref_p, _, _, _, ref_lt = pallas_bounce._bp_bwd(
        (_planes(P), _planes(pkind), _planes(mkind), _planes(flags),
         jnp.asarray(lt.numpy())), _planes(g))
    ref_p = np.asarray(ref_p).reshape(P.shape[0], n)
    got_p, got_lt = bounce_plane_core_vjp(P, pkind, mkind, flags, lt,
                                          n_lights, variant == "checker", g)
    got_p = got_p.numpy()
    assert_scaled_close(got_p, ref_p, RTOL, ATOL, axis=0, budget=0.005,
                        what="dP")
    assert_scaled_close(got_p, ref_p, 1e-4, ATOL, axis=0, what="dP")
    assert rel_l2(got_lt.numpy(), np.asarray(ref_lt)) <= 1e-5
    # the pack, a medium's distance, the albedo leaves and the lights
    assert np.abs(ref_p[9:18]).max() > 0 and np.abs(ref_p[18]).max() > 0
    assert np.abs(ref_p[19:22]).max() > 0
    if variant == "checker":
        assert np.abs(ref_p[46:52]).max() > 0
    assert np.abs(np.asarray(ref_lt)[0, 5:14]).max() > 0
    assert np.abs(np.asarray(ref_lt)[n_lights, :3]).max() > 0


@pytest.mark.parametrize("variant", ["checker", "solid"])
def test_bounce_planes_function_matches_autograd(variant):
    P, pkind, mkind, flags, lt, n_lights = _inputs(variant)
    g = _cot(P.shape[1], 4)
    x, xl = P.clone().requires_grad_(), lt.clone().requires_grad_()
    bounce.BouncePlanes.apply(x, pkind, mkind, flags, xl,
                              n_lights).backward(g)
    y, yl = P.clone().requires_grad_(), lt.clone().requires_grad_()
    ref, ref_lt = torch.autograd.grad(
        bounce_plane_core(y, pkind, mkind, flags, yl, n_lights,
                          variant == "checker"), (y, yl), g)
    assert torch.isfinite(x.grad).all()
    assert_scaled_close(x.grad.numpy(), ref.numpy(), RTOL, ATOL, axis=0,
                        budget=0.005, what="dP")
    assert_scaled_close(x.grad.numpy(), ref.numpy(), 1e-4, ATOL, axis=0,
                        what="dP")
    assert rel_l2(xl.grad.numpy(), ref_lt.numpy()) <= 1e-5
