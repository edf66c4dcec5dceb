"""The split route's backward kernels J' and H' (their plain versions)
against the JAX package on the CPU.

On the inputs the port's split route gives kernels J and H over two
bounces of a 32x32 wave (``torch_parity.split_kernel_inputs``), with a
cotangent drawn from a seed, held against the JAX backward kernels in
interpret mode:
  * J': ``ops/hit_core.hit_plane_core_vjp`` against ``pallas_hit._hp_bwd``
    on final_scene and on the fog scene. The sphere's adjoint is
    ill-conditioned in float32 for a ray from ~1000 units away
    (final_scene's camera): the root's ``b*b - a*c`` cancels, and XLA
    contracts it into FMAs where torch does not. Measured against a float64
    replay of the same inputs and cotangent: the port and JAX each leave
    2.1% and 1.7% of final_scene's lanes beyond rtol 1e-5 of the lane's
    largest cotangent (fog: 0.7% and 0.8%), at a relative L2 error of
    2.02e-5 and 1.75e-5 (fog: 1.98e-5 and 1.86e-5); port against JAX, 0.15%
    of the lanes beyond 1e-4, none beyond 1e-3. So dP is held to rtol
    1e-4 of the lane's largest value / atol 1e-6 with at most 0.5% of the
    lanes outside, to rtol 1e-3 on every lane, and to no more than 1.25
    times JAX's relative L2 distance from the float64 replay;
  * H': ``ops/bounce.su_plane_core_vjp`` against ``pallas_bounce._su_bwd``
    on the same scenes — dP within the same bound, at most 0.5% of the
    lanes outside (an FMA can flip a recomputed branch: tir, a metal
    reflection's side), the light table's cotangent within relative L2
    1e-4 (it sums over the lanes in another order).

Then the autograd functions against torch autograd of the plain forward
on the same inputs: ``ops/hit.HitPlanes`` (J, J') and
``ops/bounce.ShadeUpdate`` (H, H') give what ``torch.autograd.grad`` of
``hit_plane_core`` / ``su_plane_core`` gives: within rtol 1e-5 of the
lane's largest value / atol 1e-6 on all but 0.5% of the lanes, and within
1e-4 on every lane (measured: one fog lane of 2,048 at 1.35e-5, a ray on
the r = 100 ground sphere whose adjoint sums cancelling terms, in another
order in the hand adjoint than in autograd). The cotangent of the sphere-UV source (J's planes
9..11) is drawn on sphere lanes only, where the epilogue reads it: on the
other lanes the pack is not a sphere's, and its sphere reading is
arithmetic on another primitive's numbers (JAX computes it alike).

tests/test_torch_gpu.py holds the CUDA kernels against these plain
versions on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_bounce, pallas_hit
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import bounce, hit
from rust_ray_tracer_tpu_torch.ops.hit_core import (hit_plane_core,
                                                    hit_plane_core_vjp)

from tests.torch_parity import (assert_scaled_close, rel_l2, split_cots,
                                split_kernel_inputs, torch_scene)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)


def _scene(name):
    if name == "fog":
        return torch_scene("fog")
    return compile_scene(tb.get_scene("final_scene", 1.0), device="cpu")


def _planes(x):
    """[C, N] -> [C, N / 128, 128], the TPU kernels' plane layout."""
    x = x.numpy()
    return jnp.asarray(x.reshape(x.shape[:-1] + (-1, 128)))


@pytest.mark.parametrize("name", ["final_scene", "fog"])
def test_hit_plane_core_vjp_matches_kernel_j_bwd(name, interpret):
    ts = _scene(name)
    P, kind, flip = split_kernel_inputs(ts)["hit"]
    assert {0, 2, 3} <= set(kind.tolist())
    g, _ = split_cots(kind, 0, 3)
    n = P.shape[1]
    ref, _, _ = pallas_hit._hp_bwd((_planes(P), _planes(kind), _planes(flip)),
                                   _planes(g))
    ref = np.asarray(ref).reshape(19, n)
    got = hit_plane_core_vjp(P, kind, flip, g).numpy()
    assert_scaled_close(got, ref, 1e-4, ATOL, axis=0, budget=0.005,
                        what="dP")
    assert_scaled_close(got, ref, 1e-3, ATOL, axis=0, what="dP")
    exact = hit_plane_core_vjp(P.double(), kind, flip, g.double()).numpy()
    assert rel_l2(got, exact) <= 1.25 * rel_l2(ref, exact)
    assert np.abs(ref[9:18]).max() > 0 and np.abs(ref[0:6]).max() > 0
    if name == "fog":                             # a medium's distance
        assert np.abs(ref[18][kind.numpy() == 4]).max() > 0


@pytest.mark.parametrize("name", ["final_scene", "fog"])
def test_su_plane_core_vjp_matches_kernel_h_bwd(name, interpret):
    ts = _scene(name)
    x = split_kernel_inputs(ts)
    P, mkind, lt, n_lights = x["su"]
    n = P.shape[1]
    _, g = split_cots(x["hit"][1], n, 3)
    ref_p, _, ref_lt = pallas_bounce._su_bwd(
        (_planes(P), _planes(mkind), jnp.asarray(lt.numpy())), _planes(g))
    ref_p = np.asarray(ref_p).reshape(40, n)
    got_p, got_lt = bounce.su_plane_core_vjp(P, mkind, lt, n_lights, g)
    assert_scaled_close(got_p.numpy(), ref_p, RTOL, ATOL, axis=0,
                        budget=0.005, what="dP")
    assert not ref_p[23:].any() and not got_p[23:].any()
    assert rel_l2(got_lt.numpy(), np.asarray(ref_lt)) <= 1e-4
    assert np.abs(np.asarray(ref_lt)[n_lights, :3]).max() > 0
    if name == "fog":                       # a quad light's pdf share
        assert np.abs(np.asarray(ref_lt)[0, 5:14]).max() > 0


@pytest.mark.parametrize("name", ["final_scene", "fog"])
def test_hit_planes_function_matches_autograd(name):
    ts = _scene(name)
    P, kind, flip = split_kernel_inputs(ts)["hit"]
    g, _ = split_cots(kind, 0, 3)
    x = P.clone().requires_grad_()
    hit.HitPlanes.apply(x, kind, flip).backward(g)
    y = P.clone().requires_grad_()
    (ref,) = torch.autograd.grad(hit_plane_core(y, kind, flip), y, g)
    assert torch.isfinite(x.grad).all()
    assert_scaled_close(x.grad.numpy(), ref.numpy(), RTOL, ATOL, axis=0,
                        budget=0.005, what="dP")
    assert_scaled_close(x.grad.numpy(), ref.numpy(), 1e-4, ATOL, axis=0,
                        what="dP")


@pytest.mark.parametrize("name", ["final_scene", "fog"])
def test_shade_update_function_matches_autograd(name):
    ts = _scene(name)
    x = split_kernel_inputs(ts)
    P, mkind, lt, n_lights = x["su"]
    _, g = split_cots(x["hit"][1], P.shape[1], 3)
    x, xl = P.clone().requires_grad_(), lt.clone().requires_grad_()
    bounce.ShadeUpdate.apply(x, mkind, xl, n_lights).backward(g)
    y, yl = P.clone().requires_grad_(), lt.clone().requires_grad_()
    ref, ref_lt = torch.autograd.grad(
        bounce.su_plane_core(y, mkind, yl, n_lights), (y, yl), g)
    assert_scaled_close(x.grad.numpy(), ref.numpy(), RTOL, ATOL, axis=0,
                        budget=0.005, what="dP")
    assert_scaled_close(x.grad.numpy(), ref.numpy(), 1e-4, ATOL, axis=0,
                        what="dP")
    assert rel_l2(xl.grad.numpy(), ref_lt.numpy()) <= 1e-5


@pytest.mark.parametrize("shape,idx_shape", [((256, 3), (600,)),
                                             ((7,), (24, 25))])
def test_row_gather_matches_indexing(shape, idx_shape):
    """``ops/gather.rows`` (the glue's row gathers on the split route) is
    ``table[idx]``, and its backward (``index_add_`` on the CPU, the
    fixed-order reduction on the card) sums the cotangent rows by row id
    as autograd of ``table[idx]`` does, within 1e-6 (another order); half
    the ids are row 0, as a miss lane's winner row is."""
    from rust_ray_tracer_tpu_torch.ops import gather

    r = np.random.default_rng(2)
    table = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    idx = torch.from_numpy(r.integers(0, shape[0], size=idx_shape))
    idx.view(-1)[::2] = 0
    g = torch.from_numpy(r.normal(size=idx_shape + shape[1:]).astype(
        np.float32))
    x, y = table.clone().requires_grad_(), table.clone().requires_grad_()
    out = gather.rows(x, idx)
    out.backward(g)
    y[idx].backward(g)
    assert torch.equal(out.detach(), table[idx])
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
