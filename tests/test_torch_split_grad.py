"""Scene gradients through the split route (media, noise beside checker
textures): torch.autograd through the port's ``render_waves`` on the CPU
(the plain versions of J, H and their adjoints J', H', the rest torch
autograd) against ``jax.grad`` of the JAX package's split route — the
``su_eligible`` branch of ``integrator._bounce``, its kernels J, J', H, H'
in interpret mode — with the loss ``mean(render_waves(...))``.

The fog scene (16x16, 1 spp, depth 4, chunk 256): every leaf within
``1e-6 + 5e-4 * (the leaf's largest |gradient|)`` of JAX's, entry by entry
(measured: at most 9.1e-5 of the leaf's largest, on ``med_neg_inv_d``;
``sph_r`` 8.2e-5, ``camera.scale`` 7.0e-5), with ``perlin_vec``,
``tex_scale``, the media (``med_neg_inv_d``, ``med_pl_d``), the geometry
(``sph_c0``, ``sph_r``, ``quad_q``) and ``camera.c2w`` non-zero. On this
route JAX gives ``perlin_vec`` a gradient: its XLA ``texture_value`` does
not detach the Perlin tables (the whole-wave kernel route does).

final_scene (32x18, 2 spp, depth 4, chunk 256): JAX's float32 route forks
paths there (a ray from ~1000 units grazes a sphere and XLA's FMA in the
root moves the hit; ROADMAP queue 3), and on final_scene's black sky a
path that forks between escaping and dying in the dark shows in no pixel
but moves the background's gradient by ``beta / (W * H * 3)``, one ray's
share. Measured against a float64 replay of the port (seeds 0-3), JAX is
3.8-15.1 rays' share off on ``background`` and 0.26-56 on ``tex_color``,
the port 4.2-11.3 and 0-56. At seed 0 the port's ``tex_color`` equals the
float64 replay's (2e-8) where JAX's is 14 rays' share off, and its
``background`` is 7.2 off (JAX 3.8; the port against JAX 7.4). So each leaf
is held to 16 rays' share of JAX's and of the float64 replay's gradient,
``tex_color`` to 1e-6 of the float64 replay's, and ``tex_color`` and
``background`` are non-zero in both packages.

Two backward runs on the CPU give the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops.integrator import render_waves as jrender
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import both, jax_compile, torch_scene
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

FOG_NONZERO = ("perlin_vec", "tex_scale", "tex_color", "sph_c0", "sph_r",
               "quad_q", "med_neg_inv_d", "med_pl_d", "background",
               "camera.c2w")


@pytest.fixture
def split_route(monkeypatch):
    """The JAX package's split route on the CPU: its Pallas kernels in
    interpret mode, and the integrator told it runs on a TPU."""
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)


def _jax_grads(js, w, h, spp, chunk, seed):
    diff, static = jpartition(js)
    g = jax.grad(lambda d: jnp.mean(jrender(
        jcombine(d, static), w, h, jax.random.PRNGKey(seed), 0, spp,
        chunk_size=chunk)))(diff)
    out = {k: np.asarray(getattr(g, k)) for k in g._fields if k != "camera"}
    out.update({f"camera.{k}": np.asarray(v)
                for k, v in g.camera._asdict().items()})
    return out


def _port_grads(ts, w, h, spp, chunk, seed, dtype=torch.float32):
    params, static = partition(ts)
    leaves = {k: v.detach().to(dtype).clone().requires_grad_()
              for k, v in params.items()}
    render_waves(combine(leaves, static), w, h, rng.key(seed, "cpu"), 0, spp,
                 chunk_size=chunk).mean().backward()
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad)
            .double().numpy() for k, v in leaves.items()}


def test_fog_scene_grads_match_jax(split_route, monkeypatch):
    js, ts = both("fog", monkeypatch)
    assert not uber.uber_eligible(ts)
    got = _port_grads(ts, 16, 16, 1, 256, 0)
    ref = _jax_grads(js, 16, 16, 1, 256, 0)
    for k in got:
        r = ref[k]
        assert np.isfinite(got[k]).all(), k
        scale = np.abs(r).max(initial=0.0)
        np.testing.assert_array_less(np.abs(got[k] - r),
                                     1e-6 + 5e-4 * scale + 1e-12,
                                     err_msg=k)
    for k in FOG_NONZERO:
        assert np.abs(ref[k]).max() > 0, k
        assert np.abs(got[k]).max() > 0, k


def test_final_scene_grads_match_jax(split_route, monkeypatch):
    w, h, spp = 32, 18, 2
    js = jax_compile(jb.get_scene("final_scene", w / h), monkeypatch)
    ts = compile_scene(tb.get_scene("final_scene", w / h), device="cpu")
    ref = _jax_grads(js, w, h, spp, 256, 0)
    got = _port_grads(ts, w, h, spp, 256, 0)
    exact = _port_grads(ts, w, h, spp, 256, 0, torch.float64)
    share = 1.0 / (w * h * 3)
    for k in got:
        assert np.isfinite(got[k]).all(), k
        for other, what in ((ref, "JAX"), (exact, "float64")):
            np.testing.assert_array_less(np.abs(got[k] - other[k]),
                                         16 * share, err_msg=f"{k} vs {what}")
    np.testing.assert_allclose(got["tex_color"], exact["tex_color"], rtol=0,
                               atol=1e-6)
    for k in ("tex_color", "background"):
        assert np.abs(ref[k]).max() > 0 and np.abs(got[k]).max() > 0, k


def test_fog_scene_backward_repeats_bitwise():
    ts = torch_scene("fog")
    a = _port_grads(ts, 16, 16, 1, 256, 3)
    b = _port_grads(ts, 16, 16, 1, 256, 3)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert np.abs(a["perlin_vec"]).max() > 0
