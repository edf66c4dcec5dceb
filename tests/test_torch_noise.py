"""The marble noise (TPU kernel C) of the port vs the JAX package.

``ops.perlin.marble`` against ``pallas_bounce._marble_row`` (pure jnp, as
tests/test_uber.py:256-287 calls it) and ``marble_vjp`` against
``jax.vjp`` of it; ``noise`` / ``turb`` against the JAX ``ops/perlin``;
``bounce_plane_core`` and its adjoint with the noise branch against
``jax.vjp`` of ``_bounce_plane_core(..., has_noise=True, ptab)``, in
tests/test_torch_vjp.py's style; the whole-wave backward on the noise
scene against ``pallas_uber._trace_bwd`` in interpret mode. Inputs come
from numpy seeds; the tolerances are stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_bounce as jbo
from rust_ray_tracer_tpu.ops import pallas_uber as pu
from rust_ray_tracer_tpu.ops import perlin as jperlin
from rust_ray_tracer_tpu_torch.ops import bounce_core as tbo
from rust_ray_tracer_tpu_torch.ops import perlin as tperlin
from rust_ray_tracer_tpu_torch.ops import uber

from tests.test_torch_cores import _lights
from tests.test_torch_trace import DEPTH, _jax_trace, interpret_mode  # noqa
from tests.test_torch_trace import _inputs as _trace_inputs
from tests.test_torch_vjp import S, _bounce_inputs, _close, _jlt
from tests.torch_parity import assert_scaled_close, both, rel_l2
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

ROWS = 8


def _tables(seed):
    """(JAX [8, 256] ptab plane, port PerlinTables) of the same tables,
    drawn as compile_scene draws them."""
    rng = np.random.default_rng(seed)
    vec = rng.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    perm = np.stack([rng.permutation(256) for _ in range(3)]).astype(
        np.int32)
    ptab = np.zeros((8, 256), np.float32)
    ptab[0:3] = vec.T
    ptab[4:7] = perm
    return (jnp.asarray(ptab), tperlin.PerlinTables(torch.from_numpy(vec),
                                                    torch.from_numpy(perm)))


def _points(seed, lo=-40.0, hi=40.0):
    """p [3, 8, 128] and scale [8, 128]; row 0 holds negative cells and
    exact integers (floor's kink), lanes 0-7 of row 1 p = 0 (the non-noise
    lanes' input)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, hi, (3,) + S).astype(np.float32)
    p[:, 0, :16] = np.arange(-8, 8, dtype=np.float32)
    p[:, 1, :8] = 0.0
    scale = rng.uniform(0.5, 4.0, S).astype(np.float32)
    return p, scale


def _jax_marble(ptab, p, scale):
    return jnp.concatenate([
        jbo._marble_row(ptab, p[0, r:r + 1], p[1, r:r + 1], p[2, r:r + 1],
                        scale[r:r + 1]) for r in range(ROWS)])


@pytest.mark.parametrize("seed", [0, 1])
def test_marble_matches_jax_marble_row(seed):
    """Values to rtol 1e-5 (atol 1e-7): the same operations in the same
    order; only XLA's FMA contraction and its sin differ."""
    ptab, tab = _tables(seed)
    p, scale = _points(10 + seed)
    ref = np.asarray(_jax_marble(ptab, jnp.asarray(p), jnp.asarray(scale)))
    pt = torch.from_numpy(p)
    got = tperlin.marble(tab, pt[0], pt[1], pt[2], torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_marble_vjp_matches_jax_vjp(seed):
    """d/dp and d/dscale to rtol 1e-4 / atol 1e-4 (values reach ~40: ten
    times the octave sum's derivative, s' = 6u(1-u) against JAX's
    differentiated u*u*(3-2u), summed in another order). The tables take
    no cotangent on either side."""
    ptab, tab = _tables(seed)
    p, scale = _points(20 + seed)
    g = np.random.default_rng(30 + seed).normal(size=S).astype(np.float32)
    _, vjp = jax.vjp(lambda p_, s_: _jax_marble(ptab, p_, s_),
                     jnp.asarray(p), jnp.asarray(scale))
    ref_p, ref_s = vjp(jnp.asarray(g))
    pt = torch.from_numpy(p)
    gx, gy, gz, gs = tperlin.marble_vjp(tab, pt[0], pt[1], pt[2],
                                        torch.from_numpy(scale),
                                        torch.from_numpy(g))
    np.testing.assert_allclose(torch.stack([gx, gy, gz]).numpy(),
                               np.asarray(ref_p), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ref_s), rtol=1e-4,
                               atol=1e-4)


def test_marble_vjp_matches_torch_autograd():
    """The hand adjoint equals torch.autograd through the plain marble to
    rtol 1e-4 / atol 1e-4, away from the integer lattice (floor's kink)."""
    _, tab = _tables(2)
    p, scale = _points(40)
    p[:, 0:2] = p[:, 2:4]
    g = torch.from_numpy(np.random.default_rng(41).normal(size=S).astype(
        np.float32))
    leaves = [torch.from_numpy(x.copy()).requires_grad_()
              for x in (p[0], p[1], p[2], scale)]
    (tperlin.marble(tab, *leaves) * g).sum().backward()
    got = tperlin.marble_vjp(tab, *(x.detach() for x in leaves), g)
    for a, b in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_and_turb_match_jax(seed):
    """ops/perlin noise and turb against the JAX ops/perlin at rtol 1e-5 /
    atol 1e-6 (the same corner order; XLA sums the 3-term dot as a
    reduction)."""
    rng = np.random.default_rng(50 + seed)
    vec = rng.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    perm = [rng.permutation(256).astype(np.int32) for _ in range(3)]
    p = rng.uniform(-20.0, 20.0, (500, 3)).astype(np.float32)
    p[:8] = np.arange(-4, 4, dtype=np.float32)[:, None]
    jargs = [jnp.asarray(x) for x in (vec, *perm, p)]
    targs = [torch.from_numpy(x) for x in (vec, *perm, p)]
    np.testing.assert_allclose(tperlin.noise(*targs).numpy(),
                               np.asarray(jperlin.noise(*jargs)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tperlin.turb(*targs).numpy(),
                               np.asarray(jperlin.turb(*jargs)),
                               rtol=1e-5, atol=1e-6)


def _noise_bounce_inputs(seed):
    """_bounce_inputs plus the scale plane, the noise flag on half of the
    lanes (misses among them: a miss may carry material 0's flag) and
    hit points within a few cells of the origin."""
    rng = np.random.default_rng(seed)
    P, pkind, mkind, flags = _bounce_inputs(rng, False)
    P[0:3] = 0.3 * P[0:3]
    P = np.concatenate([P, rng.uniform(0.5, 4.0, (1,) + S).astype(
        np.float32)])
    flags = (flags & 1) | (rng.integers(0, 2, S) << 2).astype(np.int32)
    return P, pkind, mkind, flags.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bounce_core_noise_matches_jax(seed):
    """bounce_plane_core with the noise branch against
    _bounce_plane_core(..., has_noise=True, ptab): rtol 1e-5 of the lane's
    largest output / atol 1e-6, as tests/test_torch_cores.py holds the
    cores."""
    ptab, tab = _tables(seed)
    P, pkind, mkind, flags = _noise_bounce_inputs(60 + seed)
    lt = _lights(np.random.default_rng(70 + seed), 2)
    ref = jbo._bounce_plane_core(
        jnp.asarray(P), jnp.asarray(pkind), jnp.asarray(mkind),
        jnp.asarray(flags), _jlt(lt, 3), 2, False, True, ptab)
    got = tbo.bounce_plane_core(
        torch.from_numpy(P), torch.from_numpy(pkind), torch.from_numpy(mkind),
        torch.from_numpy(flags), torch.from_numpy(lt), 2, False, True, tab)
    _close(got, ref, "out")


@pytest.mark.parametrize("seed", [0, 1])
def test_bounce_core_noise_vjp_matches_jax(seed):
    """bounce_plane_core_vjp with the noise branch against jax.vjp of
    _bounce_plane_core(..., has_noise=True, ptab), rtol 1e-5 of the lane's
    largest cotangent / atol 1e-6 (tests/test_torch_vjp.py): the marble's
    share reaches the hit point and the scale plane, and a noise lane's
    albedo planes take none."""
    ptab, tab = _tables(seed)
    P, pkind, mkind, flags = _noise_bounce_inputs(80 + seed)
    lt = _lights(np.random.default_rng(90 + seed), 2)
    cot = np.random.default_rng(95 + seed).normal(size=(13,) + S).astype(
        np.float32)
    _, vjp = jax.vjp(
        lambda p, ltj: jbo._bounce_plane_core(
            p, jnp.asarray(pkind), jnp.asarray(mkind), jnp.asarray(flags),
            ltj, 2, False, True, ptab), jnp.asarray(P), _jlt(lt, 3))
    ref_P, ref_lt = vjp(jnp.asarray(cot))
    got_P, got_lt = tbo.bounce_plane_core_vjp(
        torch.from_numpy(P), torch.from_numpy(pkind), torch.from_numpy(mkind),
        torch.from_numpy(flags), torch.from_numpy(lt), 2, False,
        torch.from_numpy(cot), True, tab)
    _close(got_P, ref_P, "dP")
    _close(got_lt, np.array([[float(v) for v in row] for row in ref_lt]),
           "lt")
    nz = ((flags & 4) > 0) & (pkind != 0)
    assert np.abs(got_P[-1].numpy()[nz]).max() > 0
    assert not got_P[19:22].numpy()[:, nz].any()


def _double_ctx(ctx):
    """The TraceCtx in float64: a replay of the same residuals that shows
    how far a float32 adjoint is from the exact one."""
    f64 = {f.name: getattr(ctx, f.name).double()
           for f in dataclasses.fields(ctx)
           if torch.is_tensor(getattr(ctx, f.name))
           and getattr(ctx, f.name).is_floating_point()}
    return dataclasses.replace(ctx, perlin=tperlin.PerlinTables(
        ctx.perlin.vec.double(), ctx.perlin.perm), **f64)


def test_trace_wave_bwd_plain_noise_matches_jax_trace_bwd(interpret_mode,
                                                          monkeypatch):
    """trace_wave_bwd_plain vs pallas_uber._trace_bwd (interpret mode,
    has_noise) on the noise scene, both fed JAX's forward residuals and the
    same cotangent.

    The marble's adjoint is ill-conditioned in float32: octave 6 works at
    64 p, where a hit point on the r = 100 ground keeps ~3 decimal digits
    of its cell offset, and the Hermite derivative 6u(1-u) of that offset
    moves the cotangent of p. XLA contracts the recomputed hit point into
    FMAs and the port does not, so the two differ by an ulp of p. Measured
    on this scene (CPU): torch and JAX each leave ~21% of the rays beyond
    1e-4 of a float64 replay of the same residuals, and differ from each
    other on 6% of them at 1e-4, 0.6% at 1e-3, none at 1e-2. So dst is held
    to rtol 1e-2 of the ray's largest plane (at most 0.5% of the rays
    outside, the budget of the other scenes), duni and dlt to a relative L2
    error of 1e-3 (measured 1.0e-4 and 7e-8); and the port's duni is no
    farther from the float64 replay than JAX's is, within 10% (each
    measured ~2.6e-3)."""
    js, ts = both("noise", monkeypatch)
    st0, rnd = _trace_inputs(ts)
    ctx = uber.make_ctx(ts)
    _, ref_kind, ref_idx, cfg, res = _jax_trace(js, st0, rnd,
                                                residuals=True)
    assert cfg[8]                                   # has_noise
    hist = torch.from_numpy(np.array(res[0]).reshape(DEPTH, 14, -1))
    kind, idx = torch.from_numpy(ref_kind), torch.from_numpy(ref_idx)
    g = np.random.default_rng(5).normal(size=(14, st0.shape[1])).astype(
        np.float32)
    ref = pu._trace_bwd(cfg, res, jnp.asarray(g.reshape(14, -1, 128)))
    ref_dst = np.asarray(ref[0]).reshape(14, -1)
    ref_duni, ref_dlt = np.asarray(ref[2]), np.asarray(ref[12])
    dst, duni, dlt = uber.trace_wave_bwd_plain(hist, rnd, kind, idx, ctx,
                                               torch.from_numpy(g))
    assert_scaled_close(dst.numpy(), ref_dst, 1e-2, 1e-6, axis=0,
                        budget=0.005, what="dst")
    assert rel_l2(duni, ref_duni) < 1e-3 and rel_l2(dlt, ref_dlt) < 1e-3
    _, exact, _ = uber.trace_wave_bwd_plain(
        hist.double(), rnd.double(), kind, idx, _double_ctx(ctx),
        torch.from_numpy(g).double())
    assert rel_l2(duni, exact) <= 1.1 * rel_l2(ref_duni, exact)
    sc = uber.A_COL + 6                              # the scale column
    assert np.abs(ref_duni[:, sc]).max() > 0
    assert np.abs(duni[:, sc].numpy()).max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_core_noise_vjp_matches_jax(seed):
    """tile_core_vjp_plain on a noise scene's winner rows vs jax.vjp(core,
    P, selv, lt) of pallas_uber._tile_core(..., has_noise=True, ptab), as
    the backward trace kernel takes it (pallas_uber.py:971-976): rtol 1e-5
    of the lane's largest cotangent / atol 1e-6. A noise lane's scale
    cotangent lands in the row's scale column, its albedo columns take
    none."""
    from rust_ray_tracer_tpu.ops import pallas_uber as ju
    from tests.test_torch_vjp import _ctx_like

    ptab, tab = _tables(seed)
    P, pkind, mkind, flags = _noise_bounce_inputs(100 + seed)
    A = uber.A_COL
    w = A + 8
    st = np.concatenate([P[0:7], P[45:46], P[24:30]])
    selv = np.zeros((w,) + S, np.float32)
    selv[0:9] = P[9:18]
    selv[9] = (flags & 1).astype(np.float32)
    selv[A] = mkind
    selv[A + 1] = P[22]
    selv[A + 2] = P[23]
    selv[A + 3:A + 6] = P[19:22]
    selv[A + 6] = P[-1]                             # the noise scale
    selv[A + 7] = (flags >> 2) & 1                  # the noise flag
    rnd = P[30:45]
    lt = _lights(np.random.default_rng(110 + seed), 2)
    g = np.random.default_rng(120 + seed).normal(size=(14,) + S).astype(
        np.float32)

    def core(st_, selv_, lt_):
        return ju._tile_core(st_, jnp.asarray(rnd), selv_,
                             jnp.asarray(pkind), lt_, 2, False, True, ptab)

    _, vjp = jax.vjp(core, jnp.asarray(st), jnp.asarray(selv), _jlt(lt, 3))
    ref_st, ref_sel, ref_lt = vjp(jnp.asarray(g))
    t = lambda x: torch.from_numpy(x).reshape(x.shape[0], -1)  # noqa: E731
    dst, dsel, dlt = uber.tile_core_vjp_plain(
        t(st), t(rnd), t(selv), torch.from_numpy(pkind).reshape(-1),
        _ctx_like(lt, 2, False, tab), t(g))
    _close(dst.reshape((14,) + S), ref_st, "dst")
    _close(dsel.reshape((w,) + S), ref_sel, "dselv")
    _close(dlt, np.array([[float(v) for v in row] for row in ref_lt]), "lt")
    nz = (((flags >> 2) & 1) > 0) & (pkind != 0)
    dsel = dsel.reshape((w,) + S).numpy()
    assert np.abs(dsel[A + 6][nz]).max() > 0
    assert not dsel[A + 3:A + 6][:, nz].any()
