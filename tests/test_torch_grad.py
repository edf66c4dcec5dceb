"""End-to-end scene gradients: torch.autograd through the port's
``render_waves`` on the CPU (the trace's forward with residuals, then the
hand adjoint replayed from them) vs ``jax.grad`` through the JAX
package's uber path in interpret mode.

The set-up is tests/test_uber.py:132-186: 16x12, 1 spp, chunk 192 (one
1024-ray tile), depth 4, loss ``mean(render_waves(...))``, and its budget,
rtol 5e-4 / atol 1e-6 (test_uber.py:159). One scene per test function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops.integrator import render_waves as jrender
from rust_ray_tracer_tpu_torch.models.scene import combine, partition
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import both
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

LEAVES = ("tex_color", "sph_c0", "sph_r", "tri_v0", "quad_q", "mat_fuzz",
          "mat_ior", "background", "light_q", "light_u", "light_v",
          "camera.c2w")


@pytest.fixture
def uber_route():
    """The JAX package's uber path on the CPU: interpret mode, and the
    integrator told it runs on a TPU (as tests/test_uber.py does)."""
    real_on_tpu = pim.on_tpu
    pim.INTERPRET = True
    pim.on_tpu = lambda: True
    yield
    pim.on_tpu = real_on_tpu
    pim.INTERPRET = False


def _grads(name, seed, monkeypatch):
    js, ts = both(name, monkeypatch)
    key = jax.random.PRNGKey(seed)
    diff, static = jpartition(js)
    g_ref = jax.grad(lambda d: jnp.mean(jrender(
        jcombine(d, static), 16, 12, key, 0, 1, chunk_size=192)))(diff)

    params, tstatic = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    render_waves(combine(leaves, tstatic), 16, 12, rng.key(seed, "cpu"), 0,
                 1, chunk_size=192).mean().backward()
    nonzero = 0
    for name_ in LEAVES:
        ref = (np.asarray(g_ref.camera.c2w) if name_ == "camera.c2w"
               else np.asarray(getattr(g_ref, name_)))
        got = leaves[name_].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-6,
                                   err_msg=name_)
        nonzero += bool((ref != 0).any())
    return nonzero


def test_solid_scene_grads_match_jax(uber_route, monkeypatch):
    assert _grads("solid", 11, monkeypatch) >= 4


def test_checker_scene_grads_match_jax(uber_route, monkeypatch):
    assert _grads("checker", 5, monkeypatch) >= 4


def test_noise_scene_grads_match_jax(uber_route, monkeypatch):
    """Gradients through the marble (d albedo -> d hit point -> sphere
    parameters; d scale through the winner row's scale column) vs jax.grad
    of the uber path, which runs the marble inside the trace kernels, at
    tests/test_uber.py:246-250's tolerance, rtol 5e-2 / atol 5e-4: the
    marble's float32 adjoint is ill-conditioned (an ulp of the hit point at
    octave 6 moves it; see tests/test_torch_noise.py), and at 192 samples
    one forked path shifts every mean-gradient entry. The Perlin tables are
    detached on both sides: the port gives perlin_vec no gradient."""
    js, ts = both("noise", monkeypatch)
    key = jax.random.PRNGKey(29)
    diff, static = jpartition(js)
    g_ref = jax.grad(lambda d: jnp.mean(jrender(
        jcombine(d, static), 16, 12, key, 0, 1, chunk_size=192)))(diff)
    params, tstatic = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    render_waves(combine(leaves, tstatic), 16, 12, rng.key(29, "cpu"), 0,
                 1, chunk_size=192).mean().backward()
    for name_ in ("tex_scale", "sph_c0", "sph_r", "background", "mat_fuzz",
                  "mat_ior"):
        ref = np.asarray(getattr(g_ref, name_))
        got = leaves[name_].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-4,
                                   err_msg=name_)
    assert (np.asarray(g_ref.tex_scale) != 0).any()
    assert (leaves["tex_scale"].grad != 0).any()
    assert (np.asarray(g_ref.perlin_vec) == 0).all()
    pv = leaves["perlin_vec"].grad
    assert pv is None or not pv.any()


def test_inverse_rendering_example_two_steps_on_cpu():
    """The port's inverse-rendering example runs on the CPU: two steps
    with a finite loss that falls."""
    from rust_ray_tracer_tpu_torch.examples import inverse_rendering

    out = inverse_rendering.run(steps=2, device="cpu", log=lambda _: None)
    losses = out["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0]
    assert np.isfinite(out["albedo"]).all()
