"""trace_wave_plain (the plain version of the Hopper trace kernel) vs the
JAX whole-wave trace kernel, pallas_uber._trace_impl, run in interpret
mode on the same st0 / rnd planes (made by the port from a seed, handed to
both as numpy) — one 1024-ray chunk at depth 4.

The (kind, idx) winners must be identical at bounce 0; the radiance
planes meet the flip budget of tests/test_uber.py:117-120.

tests/test_torch_gpu.py holds the CUDA kernel against the plain version
on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops import pallas_uber as pu
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import assert_flip_budget, both

W = H = 32          # one 1024-ray chunk
DEPTH = 4


@pytest.fixture
def interpret_mode():
    pim.INTERPRET = True
    yield
    pim.INTERPRET = False


def _inputs(ts, seed=7):
    return uber.wave_inputs(ts, rng.wave_key(rng.key(seed), 0), W, H, DEPTH,
                            W * H)


def _jax_trace(js, st0, rnd):
    uni, dflt, (t_off, s_off, q_off), search, lt, cab, ptab = \
        pu.make_ctx(js)
    det_t, u_t, v_t, t_t, dbl_t, sph, quad = search
    cfg = (js.tri_v0.shape[0] > 0, js.sph_c0.shape[0] > 0,
           js.quad_q.shape[0] > 0, t_off, s_off, q_off,
           int(lt.shape[0]) - 1, js.tex_even.shape[0] > 0, False,
           tuple(det_t.shape), tuple(dbl_t.shape), tuple(sph.shape),
           tuple(quad.shape), tuple(cab.shape), DEPTH)
    cr = st0.shape[1] // 128
    stf, _, kind, idx = pu._trace_impl(
        cfg, jnp.asarray(st0.numpy().reshape(14, cr, 128)),
        jnp.asarray(rnd.numpy().reshape(DEPTH, 15, cr, 128)), uni, dflt,
        det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt, ptab)
    return (np.asarray(stf).reshape(14, -1),
            np.asarray(kind).reshape(DEPTH, -1),
            np.asarray(idx).reshape(DEPTH, -1))


@pytest.mark.parametrize("name", ["solid", "checker", "quad"])
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
                                                   (0, 0, 0))))
        kind, _ = uber.search_row_plain(st, ctx)
        assert (kind[:128] == want).all(), (want, kind[:4])
    ctx = uber.make_ctx(compile_scene(TS.Scene(cam, [tri, tri], [],
                                               (0, 0, 0))))
    kind, idx = uber.search_row_plain(st, ctx)
    assert (kind[:128] == 1).all() and (idx[:128] == 0).all()


def test_trace_wave_dispatches_cpu_to_plain(monkeypatch):
    _, ts = both("solid", monkeypatch)
    st0, rnd = _inputs(ts)
    ctx = uber.make_ctx(ts)
    np.testing.assert_array_equal(
        uber.trace_wave(st0, rnd, ctx, DEPTH).numpy(),
        uber.trace_wave_plain(st0, rnd, ctx, DEPTH).numpy())

