"""trace_wave_plain (the plain version of the Hopper trace kernel) vs the
JAX whole-wave trace kernel, pallas_uber._trace_impl, run in interpret
mode on the same st0 / rnd planes (made by the port from a seed, handed to
both as numpy) — one 1024-ray chunk at depth 4.

The (kind, idx) winners must be identical at bounce 0; the radiance
planes meet the flip budget of tests/test_uber.py:117-120.

tests/test_torch_gpu.py holds the CUDA kernel against the plain version
on the card.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops import pallas_uber as pu
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import (assert_flip_budget, assert_scaled_close,
                                both, rel_l2)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

W = H = 32          # one 1024-ray chunk
DEPTH = 4


@pytest.fixture
def interpret_mode():
    pim.INTERPRET = True
    yield
    pim.INTERPRET = False


def _inputs(ts, seed=7):
    return uber.wave_inputs(ts, rng.wave_key(rng.key(seed, "cpu"), 0), W, H,
                            DEPTH, W * H)


def _jax_trace(js, st0, rnd, residuals=False):
    """pallas_uber._trace_impl on the port's planes: (stf, kind, idx) as
    numpy, and with ``residuals`` also (cfg, the JAX residual tuple that
    _trace_bwd takes)."""
    uni, dflt, (t_off, s_off, q_off), search, lt, cab, ptab = \
        pu.make_ctx(js)
    det_t, u_t, v_t, t_t, dbl_t, sph, quad = search
    cfg = (js.tri_v0.shape[0] > 0, js.sph_c0.shape[0] > 0,
           js.quad_q.shape[0] > 0, t_off, s_off, q_off,
           int(lt.shape[0]) - 1, js.tex_even.shape[0] > 0,
           js.perlin_vec.shape[0] > 0,
           tuple(det_t.shape), tuple(dbl_t.shape), tuple(sph.shape),
           tuple(quad.shape), tuple(cab.shape), DEPTH)
    cr = st0.shape[1] // 128
    rnd_j = jnp.asarray(rnd.numpy().reshape(DEPTH, 15, cr, 128))
    stf, hist, kind, idx = pu._trace_impl(
        cfg, jnp.asarray(st0.numpy().reshape(14, cr, 128)), rnd_j, uni,
        dflt, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt, ptab)
    out = (np.array(stf).reshape(14, -1),
           np.array(kind).reshape(DEPTH, -1),
           np.array(idx).reshape(DEPTH, -1))
    if residuals:
        out += (cfg, (hist, rnd_j, uni, dflt, lt, ptab, kind, idx))
    return out


@pytest.mark.parametrize("name", ["solid", "checker", "quad", "noise"])
def test_trace_wave_plain_matches_jax_trace_kernel(name, interpret_mode,
                                                   monkeypatch):
    js, ts = both(name, monkeypatch)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    ref_st, ref_kind, ref_idx = _jax_trace(js, st0, rnd)
    kind, idx = uber.search_row_plain(st0, ctx)
    np.testing.assert_array_equal(kind.numpy(), ref_kind[0])
    np.testing.assert_array_equal(idx.numpy(), ref_idx[0])
    got = uber.trace_wave_plain(st0, rnd, ctx, DEPTH).numpy()
    # radiance planes [3, N] -> [N, 3] "pixels"
    assert_flip_budget(got[8:11].T, ref_st[8:11].T)
    # the dead pad lanes and the shutter time pass through untouched
    np.testing.assert_array_equal(got[6], st0[6].numpy())


def test_search_tie_rules():
    """A sphere and a quad at exactly the same t as a triangle: the
    triangle wins, then the sphere; two coincident triangles: the lower
    row wins."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.models.scene import compile_scene
    from rust_ray_tracer_tpu_torch.ops import camera as tcam

    mat = TS.Lambertian.from_rgb(0.5, 0.5, 0.5)
    cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    tri = TS.Triangle((-5, -5, -3), (5, -5, -3), (0, 5, -3), mat,
                      double_sided=True)
    wall = TS.XYRect(-5, 5, -5, 5, -3, mat)
    ball = TS.Sphere((0, 0, -4), 1.0, mat)          # front at z = -3
    st = uber.pack_state(torch.zeros(128, 3),
                         torch.tensor([[0.0, 0.0, -1.0]]).expand(128, 3),
                         torch.zeros(128), torch.zeros(128, 3),
                         torch.ones(128, 3), torch.ones(128, dtype=bool))
    for world, want in (([wall, ball, tri], 1), ([wall, ball], 2),
                        ([wall], 3)):
        ctx = uber.make_ctx(compile_scene(TS.Scene(cam, world, [],
                                                   (0, 0, 0)), device="cpu"))
        kind, _ = uber.search_row_plain(st, ctx)
        assert (kind[:128] == want).all(), (want, kind[:4])
    ctx = uber.make_ctx(compile_scene(TS.Scene(cam, [tri, tri], [],
                                               (0, 0, 0)), device="cpu"))
    kind, idx = uber.search_row_plain(st, ctx)
    assert (kind[:128] == 1).all() and (idx[:128] == 0).all()


def test_trace_wave_dispatches_cpu_to_plain(monkeypatch):
    _, ts = both("solid", monkeypatch)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    np.testing.assert_array_equal(
        uber.trace_wave(st0, rnd, ctx, DEPTH).numpy(),
        uber.trace_wave_plain(st0, rnd, ctx, DEPTH).numpy())



@pytest.mark.parametrize("name", ["solid", "checker", "quad"])
def test_trace_wave_bwd_plain_matches_jax_trace_bwd(name, interpret_mode,
                                                    monkeypatch):
    """trace_wave_bwd_plain vs pallas_uber._trace_bwd (the backward trace
    kernel, interpret mode), both fed JAX's forward residuals and the same
    numpy cotangent, so no forward fork enters the comparison.

    dst, duni and dlt match to rtol 1e-4 / atol 1e-6, the relative part
    against the largest value of the ray (dst) or table row (duni, dlt):
    the same adjoint as tests/test_torch_vjp.py, but duni and dlt sum over
    rays and bounces in another order (JAX: one-hot MXU contractions per
    128-ray row, tile by tile), and a ray's cotangent after four bounces
    carries the FMA rounding of four adjoint steps, which a large sphere
    (the checker scene's r = 100 ground) magnifies; at most 0.5% of the
    rays may fall outside (a recomputed branch flipped by an FMA, the
    budget of chip_smoke.py). duni and dlt also hold a relative L2 error
    below 1e-4."""
    js, ts = both(name, monkeypatch)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    _, ref_kind, ref_idx, cfg, res = _jax_trace(js, st0, rnd, residuals=True)
    hist, _, _, _, _, _, kind, idx = res
    n = st0.shape[1]
    g = np.random.default_rng(5).normal(size=(14, n)).astype(np.float32)
    ref = pu._trace_bwd(cfg, res, jnp.asarray(g.reshape(14, -1, 128)))
    ref_dst = np.asarray(ref[0]).reshape(14, -1)
    ref_duni, ref_dlt = np.asarray(ref[2]), np.asarray(ref[12])
    dst, duni, dlt = uber.trace_wave_bwd_plain(
        torch.from_numpy(np.array(hist).reshape(DEPTH, 14, -1)), rnd,
        torch.from_numpy(ref_kind), torch.from_numpy(ref_idx), ctx,
        torch.from_numpy(g))
    assert_scaled_close(dst.numpy(), ref_dst, 1e-4, 1e-6, axis=0,
                        budget=0.005, what="dst")
    assert duni.shape == ref_duni.shape and dlt.shape == ref_dlt.shape
    assert_scaled_close(duni.numpy(), ref_duni, 1e-4, 1e-6, axis=1,
                        what="duni")
    assert_scaled_close(dlt.numpy(), ref_dlt, 1e-4, 1e-6, axis=1, what="dlt")
    assert rel_l2(duni, ref_duni) < 1e-4 and rel_l2(dlt, ref_dlt) < 1e-4
    assert np.abs(ref_duni).max() > 0 and np.abs(ref_dlt).max() > 0

    # the port's own forward residuals equal JAX's: winners identical at
    # bounce 0, the bounce input states under the flip budget
    _, p_hist, p_kind, p_idx = uber.trace_wave_plain(st0, rnd, ctx, DEPTH,
                                                     residuals=True)
    np.testing.assert_array_equal(p_kind[0].numpy(), ref_kind[0])
    np.testing.assert_array_equal(p_idx[0].numpy(), ref_idx[0])
    assert p_kind.dtype == p_idx.dtype == torch.int32
    ref_hist = np.asarray(hist).reshape(DEPTH, 14, -1)
    for b in range(DEPTH):
        assert_flip_budget(p_hist[b].numpy().T, ref_hist[b].T)


@pytest.mark.parametrize("name", ["solid", "checker", "noise"])
def test_trace_wave_function_matches_autograd_of_plain(name, monkeypatch):
    """Gradients through TraceWave (the forward with residuals, then the
    hand adjoint replayed from them) equal torch.autograd straight through
    trace_wave_plain, to rtol 1e-5 of the largest value of the ray or
    table row / atol 1e-6: one formula, summed in another order."""
    _, ts = both(name, monkeypatch)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(14, st0.shape[1])).astype(np.float32))
    # the alive plane is a select of constants: autograd gives it no
    # cotangent, while the replay leaves a tile with no live ray untouched
    g[7] = 0.0

    def grads(fn):
        leaves = [st0.clone().requires_grad_(),
                  ctx.uni.clone().requires_grad_(),
                  ctx.lt.clone().requires_grad_()]
        c = dataclasses.replace(ctx, uni=leaves[1], lt=leaves[2])
        (fn(leaves[0], rnd, c, DEPTH) * g).sum().backward()
        return [x.grad for x in leaves]

    got = grads(uber.trace_wave)
    ref = grads(uber.trace_wave_plain)
    for a, b, axis, what in zip(got, ref, (0, 1, 1), ("st0", "uni", "lt")):
        assert_scaled_close(a.numpy(), b.numpy(), 1e-5, 1e-6, axis=axis,
                            what=what)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0
