"""One uber bounce (TPU kernel D) and its backward (D') in the port's plain
versions vs the JAX package's kernels in interpret mode, and the per-chunk
path they carry (``ops/integrator.render_chunk``).

``uber.fused_bounce_plain`` and ``fused_bounce_bwd_plain`` are held
against ``pallas_uber._fused_impl`` / ``_fused_bwd`` (cfg built as
``bounce_uber`` builds it, ``pallas_uber.py:1498-1504``) on one 1024-ray
chunk's bounce-1 state (the port's plain trace from the seeded primaries:
live and dead rays, a dead tile or none) and randoms, handed to both as
numpy; :class:`uber.FusedBounce` against torch autograd straight through
the plain forward; the per-chunk render against JAX's per-bounce
(``RRT_UBER_WAVE=0``) render and ``jax.grad`` of it; and the per-chunk
render bitwise against the port's whole-wave render on the CPU.

tests/test_torch_gpu.py and chip_smoke.py hold the CUDA kernels against
these plain versions on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops import pallas_uber as pu
from rust_ray_tracer_tpu.ops.integrator import render_waves as jrender
from rust_ray_tracer_tpu_torch.models.scene import combine, partition
from rust_ray_tracer_tpu_torch.ops import integrator
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.parallel import (make_mesh,
                                                render_waves_sharded)
from rust_ray_tracer_tpu_torch.utils import rng

from tests.test_torch_noise import _double_ctx
from tests.torch_parity import (assert_flip_budget, assert_scaled_close,
                                both, rel_l2, torch_scene)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

W = H = 32          # one 1024-ray chunk


@pytest.fixture
def uber_route(monkeypatch):
    """The JAX package's per-bounce uber path on the CPU
    (``tests/test_uber.py:25-29,84-96``): interpret mode, ``on_tpu`` True
    and ``RRT_UBER_WAVE=0``."""
    real_on_tpu = pim.on_tpu
    pim.INTERPRET = True
    pim.on_tpu = lambda: True
    monkeypatch.setenv("RRT_UBER_WAVE", "0")
    yield
    pim.on_tpu = real_on_tpu
    pim.INTERPRET = False


def _bounce1(ts):
    """(st [14, N], rnd_b [15, N]): bounce 1's input state of the port's
    plain trace from seeded primaries, and its randoms."""
    st0, rnd = uber.wave_inputs(ts, rng.wave_key(rng.key(7, "cpu"), 0), W,
                                H, 2, W * H)
    ctx = uber.make_ctx(ts)
    st1, _, _ = uber.fused_bounce_plain(st0, rnd[0], ctx)
    return st1, rnd[1]


def _jax_cfg(js):
    uni, dflt, (t_off, s_off, q_off), search, lt, cab, ptab = \
        pu.make_ctx(js)
    det_t, u_t, v_t, t_t, dbl_t, sph, quad = search
    cfg = (js.tri_v0.shape[0] > 0, js.sph_c0.shape[0] > 0,
           js.quad_q.shape[0] > 0, t_off, s_off, q_off,
           int(lt.shape[0]) - 1, js.tex_even.shape[0] > 0,
           js.perlin_vec.shape[0] > 0, tuple(det_t.shape),
           tuple(dbl_t.shape), tuple(sph.shape), tuple(quad.shape),
           tuple(cab.shape))
    return cfg, (uni, dflt, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt,
                 ptab)


@functools.lru_cache(maxsize=None)
def _jax_fwd(name):
    """JAX's D (interpret mode) on the port's bounce-1 planes, and those
    planes: a dict of numpy arrays, the port's tensors and JAX's inputs.
    Cached: the D' test below reuses its winners (on the noise scene the
    interpreted marble costs ~20 s a call)."""
    mp = pytest.MonkeyPatch()
    try:
        js, ts = both(name, mp)
        st, rnd_b = _bounce1(ts)
        cfg, (uni, dflt, det_t, u_t, v_t, t_t, dbl_t, sph, quad, cab, lt,
              ptab) = _jax_cfg(js)
        cr = st.shape[1] // 128
        st_j = jnp.asarray(st.numpy().reshape(14, cr, 128))
        rnd_j = jnp.asarray(rnd_b.numpy().reshape(15, cr, 128))
        tlive = jnp.any(st_j[7].reshape(cr // 8, 8, 128) > 0.5,
                        axis=(1, 2)).astype(jnp.int32)
        pim.INTERPRET = True
        st2, kind, idx = pu._fused_impl(cfg, tlive, st_j, rnd_j, uni, dflt,
                                        det_t, u_t, v_t, t_t, dbl_t, sph,
                                        quad, cab, lt, ptab)
    finally:
        pim.INTERPRET = False
        mp.undo()
    return {"ts": ts, "st": st, "rnd": rnd_b,
            "st2": np.array(st2).reshape(14, -1),
            "kind": np.array(kind).reshape(-1),
            "idx": np.array(idx).reshape(-1),
            "jax": (cfg, (tlive, st_j, rnd_j, uni, dflt, lt, ptab, kind,
                          idx))}


@functools.lru_cache(maxsize=None)
def _jax_bwd(name):
    """:func:`_jax_fwd`'s planes with JAX's D' (interpret mode) fed its
    winners and a seeded cotangent g."""
    r = dict(_jax_fwd(name))
    cfg, res = r["jax"]
    g = np.random.default_rng(5).normal(
        size=r["st"].shape).astype(np.float32)
    pim.INTERPRET = True
    try:
        bwd = pu._fused_bwd(cfg, res, jnp.asarray(g.reshape(14, -1, 128)))
    finally:
        pim.INTERPRET = False
    r.update(g=g, dst=np.array(bwd[1]).reshape(14, -1),
             duni=np.array(bwd[3]), dlt=np.array(bwd[13]))
    return r


@pytest.mark.parametrize("name", ["solid", "checker", "quad", "noise"])
def test_fused_bounce_plain_matches_jax_fused_kernel(name):
    """The winners (kind, idx) equal JAX's; the next state per lane within
    rtol 1e-5 of the lane's largest plane / atol 1e-6 (XLA's CPU code
    contracts FMAs the plain version rounds apart), at most 0.5% of the
    lanes outside (a shading branch forked by an ulp; chip_smoke.py's
    budget). A dead lane passes its state through, as JAX's dead tile."""
    r = _jax_fwd(name)
    ctx = uber.make_ctx(r["ts"])
    st2, kind, idx = uber.fused_bounce_plain(r["st"], r["rnd"], ctx)
    assert kind.dtype == idx.dtype == torch.int32
    np.testing.assert_array_equal(kind.numpy(), r["kind"])
    np.testing.assert_array_equal(idx.numpy(), r["idx"])
    assert_scaled_close(st2.numpy(), r["st2"], 1e-5, 1e-6, axis=0,
                        budget=0.005, what="st2")
    dead = r["st"][7] < 0.5
    assert bool(dead.any()) and bool((~dead).any())
    np.testing.assert_array_equal(st2[:, dead].numpy(),
                                  r["st"][:, dead].numpy())


@pytest.mark.parametrize("name", ["solid", "checker", "noise"])
def test_fused_bounce_bwd_plain_matches_jax_fused_bwd(name):
    """D''s plain version vs ``_fused_bwd`` fed JAX's winners and the
    same seeded cotangent: dst per lane
    within rtol 1e-4 of the lane's largest value / atol 1e-6, at most 0.5%
    of the lanes outside (the budget of
    ``tests/test_torch_trace.py``'s whole-wave backward: the same adjoint,
    the table sums in another order); dlt per row likewise, none outside;
    duni per row likewise, or, where a row is outside, no farther from a
    float64 replay of the same inputs than JAX's row is. Measured on the
    checker scene: the glass sphere's row (110 rays refracting through
    it) sits 7.9e-4 of its largest entry from float64 in JAX (XLA
    contracts FMAs there), 1.9e-5 in the port; its other rows within
    1.4e-5 of float64 on both sides."""
    r = _jax_bwd(name)
    ctx = uber.make_ctx(r["ts"])
    args = (torch.from_numpy(r["kind"]), torch.from_numpy(r["idx"]))
    dst, duni, dlt = uber.fused_bounce_bwd_plain(
        r["st"], r["rnd"], *args, ctx, torch.from_numpy(r["g"]))
    assert_scaled_close(dst.numpy(), r["dst"], 1e-4, 1e-6, axis=0,
                        budget=0.005, what="dst")
    assert duni.shape == r["duni"].shape and dlt.shape == r["dlt"].shape
    assert_scaled_close(dlt.numpy(), r["dlt"], 1e-4, 1e-6, axis=1,
                        what="dlt")
    assert rel_l2(dlt, r["dlt"]) < 1e-4
    got, ref = duni.double().numpy(), r["duni"].astype(np.float64)
    scale = np.abs(ref).max(axis=1)
    off = np.abs(got - ref).max(axis=1) > 1e-6 + 1e-4 * scale
    if off.any():
        _, exact, _ = uber.fused_bounce_bwd_plain(
            r["st"].double(), r["rnd"].double(), *args, _double_ctx(ctx),
            torch.from_numpy(r["g"]).double())
        exact = exact.numpy()
        port = np.abs(got - exact).max(axis=1)
        jax_ = np.abs(ref - exact).max(axis=1)
        assert (port[off] <= jax_[off] + 1e-6 * scale[off]).all(), (
            port[off], jax_[off])
    assert np.abs(r["duni"]).max() > 0 and np.abs(r["dlt"]).max() > 0


@pytest.mark.parametrize("name", ["solid", "checker", "noise"])
def test_fused_bounce_function_matches_autograd_of_plain(name):
    """Gradients through FusedBounce (the forward saving (st, rnd, kind,
    idx), then the hand adjoint) equal torch.autograd straight through
    fused_bounce_plain, to rtol 1e-5 of the lane's or row's largest value
    / atol 1e-6: one formula, summed in another order. At most 0.5% of
    the state's lanes may fall outside: on the checker scene 3 of 1,024
    bounce-1 rays leaving the r = 100 ground differ by 1.4e-5 of their
    largest cotangent, with a float64 replay between the two."""
    ts = torch_scene(name)
    st, rnd_b = _bounce1(ts)
    ctx = uber.make_ctx(ts)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(14, st.shape[1])).astype(np.float32))
    # the alive plane is a select of constants: autograd gives it no
    # cotangent, while D' leaves a tile with no live ray untouched
    g[7] = 0.0

    def grads(fn):
        leaves = [st.clone().requires_grad_(),
                  ctx.uni.clone().requires_grad_(),
                  ctx.lt.clone().requires_grad_()]
        c = dataclasses.replace(ctx, uni=leaves[1], lt=leaves[2])
        (fn(leaves[0], rnd_b, c) * g).sum().backward()
        return [x.grad for x in leaves]

    got = grads(lambda s, r, c: uber.bounce_uber(None, r, s, c))
    ref = grads(lambda s, r, c: uber.fused_bounce_plain(s, r, c)[0])
    for a, b, axis, what, budget in zip(got, ref, (0, 1, 1),
                                        ("st", "uni", "lt"),
                                        (0.005, 0.0, 0.0)):
        assert_scaled_close(a.numpy(), b.numpy(), 1e-5, 1e-6, axis=axis,
                            budget=budget, what=what)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


def test_bounce_uber_draws_jax_streams_from_a_key():
    """bounce_uber given a bounce key draws JAX's bounce_uber budget (9
    SCATTER uniforms, 6 FUZZ normals over every lane) and gives the same
    bits as the same draws passed in."""
    ts = torch_scene("solid")
    st, _ = _bounce1(ts)
    ctx = uber.make_ctx(ts)
    bkey = rng.bounce_key(rng.key(3, "cpu"), 1)
    n = st.shape[1]
    ub = jax.random.uniform(jax.random.fold_in(jnp.asarray(
        bkey.numpy().astype(np.uint32)), rng.SCATTER), (n, 9))
    gb = jax.random.normal(jax.random.fold_in(jnp.asarray(
        bkey.numpy().astype(np.uint32)), rng.FUZZ), (n, 6))
    rnd_b = torch.from_numpy(np.concatenate([np.asarray(ub),
                                             np.asarray(gb)], 1).T.copy())
    np.testing.assert_array_equal(
        uber.bounce_uber(ts, bkey, st, ctx).numpy(),
        uber.bounce_uber(ts, rnd_b, st, ctx).numpy())


def test_per_chunk_render_and_grads_match_jax(uber_route, monkeypatch):
    """The port's per-chunk path (render_waves_sharded on a one-process
    mesh: render_chunk -> trace_rays -> D) vs JAX's per-bounce path
    (``RRT_UBER_WAVE=0``: render_chunk -> _trace_rays_uber -> _fused_call)
    at tests/test_torch_grad.py's set-up (16x12, 1 spp, chunk 192, depth
    4, one 1024-ray tile): the image under the flip budget, every scene
    gradient within that file's rtol 5e-4 / atol 1e-6."""
    js, ts = both("solid", monkeypatch)
    key = jax.random.PRNGKey(2)
    diff, static = jpartition(js)
    img_ref, vjp = jax.vjp(lambda d: jrender(jcombine(d, static), 16, 12,
                                             key, 0, 1, chunk_size=192),
                           diff)
    (g_ref,) = vjp(jnp.full((12, 16, 3), 1.0 / (12 * 16 * 3), jnp.float32))

    params, tstatic = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    img = render_waves_sharded(combine(leaves, tstatic), 16, 12,
                               rng.key(2, "cpu"), 0, 1, make_mesh(
                                   device="cpu"), chunk_size=192)
    assert_flip_budget(img.detach().numpy(), np.asarray(img_ref))
    img.mean().backward()
    nonzero = 0
    for k, v in leaves.items():
        ref = (np.asarray(getattr(g_ref.camera, k.split(".")[1]))
               if k.startswith("camera.") else np.asarray(getattr(g_ref, k)))
        got = np.zeros_like(ref) if v.grad is None else v.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-6,
                                   err_msg=k)
        nonzero += bool(np.abs(ref).max(initial=0.0) > 0)
    assert nonzero >= 5


@pytest.mark.parametrize("name,chunk", [("solid", 256), ("noise", 256),
                                        ("fog", 64)])
def test_per_chunk_render_equals_whole_wave(name, chunk):
    """On the CPU the per-chunk path (render_waves_sharded on one rank:
    render_chunk over every chunk, D's plain version a bounce, or the
    split route's bounce on the fog scene) and render_waves (A's plain
    version; on the fog scene render_chunk over the wave's chunks, without
    the sharded pad and interleave) give the same image bit for bit: the
    same lanes, draws and arithmetic, batched otherwise."""
    ts = torch_scene(name)
    ref = integrator.render_waves(ts, W, 24, rng.key(1, "cpu"), 0, 2,
                                  chunk_size=chunk)
    got = render_waves_sharded(ts, W, 24, rng.key(1, "cpu"), 0, 2,
                               make_mesh(device="cpu"), chunk_size=chunk)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
