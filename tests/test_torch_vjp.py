"""The port's hand-derived adjoints vs ``jax.vjp`` of the JAX device
functions they mirror.

``hit_plane_core_vjp``, ``plane_core_vjp``, ``bounce_plane_core_vjp`` and
``tile_core_vjp_plain`` against ``jax.vjp`` of pallas_hit._hit_plane_core,
pallas_shade._plane_core, pallas_bounce._bounce_plane_core and
pallas_uber._tile_core — plain jnp functions, called on [8, 128] planes
(the [14, 8, 128] tiles of the TPU kernels). Both sides get the same
random planes and cotangents from numpy: every primitive kind and
material, hits, misses and dead lanes, with and without the checker,
sphere, quad and null lights, and lanes placed on the kinks (a max/min
tie, abs at 0, the normalize guard, the pdf floor).

Tolerance rtol 1e-5, atol 1e-6, as for the forward cores
(tests/test_torch_cores.py), with the relative part taken against the
largest cotangent of the same lane (for plane stacks) or the same table
row: the formulas are the same, but XLA contracts a*b+c into fused
multiply-adds, which moves the sphere's discriminant (b*b - a*c) and the
other cancelling sums by an ulp of their terms, and an adjoint that
differentiates such a sum carries that ulp at the scale of its largest
term, not of the (smaller) result.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_bounce as jbo
from rust_ray_tracer_tpu.ops import pallas_hit as jh
from rust_ray_tracer_tpu.ops import pallas_shade as js
from rust_ray_tracer_tpu.ops import pallas_uber as ju
from rust_ray_tracer_tpu_torch.ops import bounce_core as tbo
from rust_ray_tracer_tpu_torch.ops import hit_core as th
from rust_ray_tracer_tpu_torch.ops import shade_core as ts
from rust_ray_tracer_tpu_torch.ops import uber

from tests.test_torch_cores import _hit_planes, _lights

S = (8, 128)
RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, what=""):
    """|got - ref| <= ATOL + RTOL * (largest |ref| of the lane or row)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(ref).all() and np.isfinite(got).all(), what
    axis = 0 if ref.ndim == 3 else -1
    scale = np.abs(ref).max(axis=axis, keepdims=True) if ref.ndim > 1 \
        else np.abs(ref)
    err = np.abs(got - ref)
    bad = err > ATOL + RTOL * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} outside, worst "
        f"{float((err / (ATOL + RTOL * scale)).max()):.3g}x the budget; "
        f"got {got[bad][:4]} want {ref[bad][:4]}")


def _jlt(lt, rows):
    """A light table as the TPU kernels read it: rows of scalars."""
    return tuple(tuple(jnp.float32(v) for v in row) for row in lt[:rows])


def _kink_hit_lanes(P, kind, flip):
    """Lanes 0-7 of row 0: a triangle facing +z (its normal's y is exactly
    0, so FlipFace's -|ny| sits on abs's kink) hit head-on, with and
    without the flip."""
    lanes = np.s_[0, 0:8]
    P[0:3][(slice(None),) + lanes] = np.array([0.2, 0.3, 2.0])[:, None]
    P[3:6][(slice(None),) + lanes] = np.array([0.0, 0.0, -1.0])[:, None]
    P[9:18][(slice(None),) + lanes] = np.array(
        [0, 0, 0, 1, 0, 0, 0, 1, 0], np.float32)[:, None]
    kind[lanes] = 1
    flip[lanes] = np.arange(8) % 2


@pytest.mark.parametrize("seed", [0, 1])
def test_hit_core_vjp_matches_jax(seed):
    rng = np.random.default_rng(seed)
    P, kind, flip = _hit_planes(rng)
    _kink_hit_lanes(P, kind, flip)
    cot = rng.normal(size=(12,) + S).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jh._hit_plane_core(p, jnp.asarray(kind),
                                                  jnp.asarray(flip)),
                     jnp.asarray(P))
    (ref,) = vjp(jnp.asarray(cot))
    got = th.hit_plane_core_vjp(torch.from_numpy(P), torch.from_numpy(kind),
                                torch.from_numpy(flip), torch.from_numpy(cot))
    _close(got, ref, "dP")


def _shade_inputs(rng, n_lights):
    data = np.zeros((14,) + S, np.float32)
    data[0:3] = rng.normal(size=(3,) + S)
    data[3:6] = rng.uniform(-2, 2, (3,) + S)
    n = rng.normal(size=(3,) + S)
    data[6:9] = n / np.linalg.norm(n, axis=0)
    data[9:12] = rng.uniform(0, 1, (3,) + S)
    data[12] = rng.uniform(0, 0.5, S)
    data[13] = rng.uniform(1.1, 2, S)
    r = np.zeros((15,) + S, np.float32)
    r[0:9] = rng.uniform(0, 1, (9,) + S)
    r[9:] = rng.normal(size=(6,) + S)
    kind = rng.integers(0, 5, S).astype(np.int32)
    # kinks, row 0: lanes 0-15 take n = +z and d = -z exactly, so the
    # dielectric's cos_t hits min(., 1) on a tie; lanes 0-7 are
    # Lambertian with u1 = 1 and u3 = 0: the cosine sample lies in the
    # tangent plane, so both the cosine pdf and the scattering pdf sit on
    # max(., 0)'s tie and the pdf on its floor; lanes 16-23 have d = 0
    # (the normalize guard)
    data[6:9, 0, 0:16] = np.array([0.0, 0.0, 1.0])[:, None]
    data[0:3, 0, 0:16] = np.array([0.0, 0.0, -1.0])[:, None]
    kind[0, 0:8] = ts.MAT_LAMBERTIAN
    kind[0, 8:16] = ts.MAT_DIELECTRIC
    r[1, 0, 0:8] = 1.0
    r[3, 0, 0:8] = 0.0
    data[0:3, 0, 16:24] = 0.0
    return data, r, kind, _lights(rng, n_lights)


@pytest.mark.parametrize("n_lights", [0, 1, 3])
def test_shade_core_vjp_matches_jax(n_lights):
    rng = np.random.default_rng(30 + n_lights)
    data, r, kind, lt = _shade_inputs(rng, n_lights)
    cot = rng.normal(size=(10,) + S).astype(np.float32)

    def f(dat, ltj):
        return js._plane_core(dat, tuple(jnp.asarray(x) for x in r),
                              jnp.asarray(kind), ltj, n_lights)

    _, vjp = jax.vjp(f, tuple(jnp.asarray(x) for x in data),
                     _jlt(lt, n_lights))
    ref_d, ref_lt = vjp(tuple(jnp.asarray(c) for c in cot))
    got_d, got_lt = ts.plane_core_vjp(
        tuple(torch.from_numpy(x) for x in data),
        tuple(torch.from_numpy(x) for x in r), torch.from_numpy(kind),
        torch.from_numpy(lt), n_lights,
        tuple(torch.from_numpy(c) for c in cot))
    for i, (g, f_) in enumerate(zip(got_d, ref_d)):
        _close(g, f_, f"data[{i}]")
    ref_lt = np.array([[float(v) for v in row] for row in ref_lt]
                      ).reshape(n_lights, 14)
    _close(got_lt[:n_lights], ref_lt, "lt")
    assert not got_lt[n_lights:].any()


def _bounce_inputs(rng, has_checker):
    P_hit, pkind, flip = _hit_planes(rng)
    _kink_hit_lanes(P_hit, pkind, flip)
    # sphere hits well inside the silhouette: at a grazing hit the
    # adjoint's 1/sqrt(disc) magnifies XLA's FMA rounding of the
    # discriminant past any fixed tolerance (the hit core's own test
    # keeps the grazing lanes)
    sph = pkind == 2
    o, d, r = P_hit[0:3], P_hit[3:6], P_hit[17]
    c0 = o + 2.0 * d + 0.1 * r * rng.normal(size=(3,) + S) / np.sqrt(3)
    P_hit[9:12] = np.where(sph, c0, P_hit[9:12])
    P_hit[12:15] = np.where(sph, c0 + 0.05 * rng.normal(size=(3,) + S),
                            P_hit[12:15])
    pkind = np.where(pkind == 4, 1, pkind).astype(np.int32)   # no media
    n_in = 46 + (6 if has_checker else 0)
    P = np.zeros((n_in,) + S, np.float32)
    P[:19] = P_hit
    P[19:22] = rng.uniform(0, 1, (3,) + S)          # albedo
    P[22] = rng.uniform(0, 0.5, S)                  # fuzz
    P[23] = rng.uniform(1.1, 2, S)                  # ior
    P[24:27] = rng.uniform(0, 1, (3,) + S)          # L
    P[27:30] = rng.uniform(0, 1, (3,) + S)          # beta
    P[30:39] = rng.uniform(0, 1, (9,) + S)
    P[39:45] = rng.normal(size=(6,) + S)
    P[45] = (rng.uniform(size=S) < 0.8).astype(np.float32)
    if has_checker:
        P[46:52] = rng.uniform(0, 1, (6,) + S)
    mkind = rng.integers(0, 5, S).astype(np.int32)
    flags = (flip | (rng.integers(0, 2, S) << 1)).astype(np.int32)
    return P, pkind, mkind, flags


@pytest.mark.parametrize("has_checker", [False, True])
def test_bounce_core_vjp_matches_jax(has_checker):
    rng = np.random.default_rng(40 + has_checker)
    P, pkind, mkind, flags = _bounce_inputs(rng, has_checker)
    n_l = 2
    lt = _lights(rng, n_l)
    cot = rng.normal(size=(13,) + S).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p, ltj: jbo._bounce_plane_core(
            p, jnp.asarray(pkind), jnp.asarray(mkind), jnp.asarray(flags),
            ltj, n_l, has_checker), jnp.asarray(P), _jlt(lt, n_l + 1))
    ref_P, ref_lt = vjp(jnp.asarray(cot))
    got_P, got_lt = tbo.bounce_plane_core_vjp(
        torch.from_numpy(P), torch.from_numpy(pkind), torch.from_numpy(mkind),
        torch.from_numpy(flags), torch.from_numpy(lt), n_l, has_checker,
        torch.from_numpy(cot))
    _close(got_P, ref_P, "dP")
    _close(got_lt, np.array([[float(v) for v in row] for row in ref_lt]),
           "lt")
    # a dead lane passes o, d, L and beta through exactly
    dead = P[45] < 0.5
    for got_row, cot_row in ((slice(0, 6), slice(0, 6)),
                             (slice(24, 30), slice(6, 12))):
        np.testing.assert_array_equal(got_P[got_row].numpy()[:, dead],
                                      cot[cot_row][:, dead])


def _ctx_like(lt, n_l, has_checker):
    """The fields of a TraceCtx that the tile core reads."""
    return types.SimpleNamespace(lt=torch.from_numpy(lt), n_lights=n_l,
                                 has_checker=has_checker)


@pytest.mark.parametrize("has_checker", [False, True])
def test_tile_core_vjp_matches_jax(has_checker):
    """tile_core_vjp_plain vs jax.vjp(core, P, selv, lt) as the backward
    trace kernel takes it (pallas_uber.py:971-976)."""
    rng = np.random.default_rng(50 + has_checker)
    P, pkind, mkind, flags = _bounce_inputs(rng, has_checker)
    A = uber.A_COL
    w = A + (13 if has_checker else 6)
    st = np.concatenate([P[0:7], P[45:46], P[24:30]])         # [14, 8, 128]
    selv = np.zeros((w,) + S, np.float32)
    selv[0:9] = P[9:18]
    selv[9] = (flags & 1).astype(np.float32)
    selv[10] = rng.integers(0, 4, S)
    selv[A] = mkind
    selv[A + 1] = P[22]
    selv[A + 2] = P[23]
    selv[A + 3:A + 6] = P[19:22]
    if has_checker:
        selv[A + 6:A + 12] = P[46:52]
        selv[A + 12] = (flags >> 1) & 1
    rnd = P[30:45]
    n_l = 2
    lt = _lights(rng, n_l)
    g = rng.normal(size=(14,) + S).astype(np.float32)

    def core(st_, selv_, lt_):
        return ju._tile_core(st_, jnp.asarray(rnd), selv_,
                             jnp.asarray(pkind), lt_, n_l, has_checker)

    _, vjp = jax.vjp(core, jnp.asarray(st), jnp.asarray(selv),
                     _jlt(lt, n_l + 1))
    ref_st, ref_sel, ref_lt = vjp(jnp.asarray(g))
    t = lambda x: torch.from_numpy(x).reshape(x.shape[0], -1)  # noqa: E731
    dst, dsel, dlt = uber.tile_core_vjp_plain(
        t(st), t(rnd), t(selv), torch.from_numpy(pkind).reshape(-1),
        _ctx_like(lt, n_l, has_checker), t(g))
    _close(dst.reshape((14,) + S), ref_st, "dst")
    _close(dsel.reshape((w,) + S), ref_sel, "dselv")
    _close(dlt, np.array([[float(v) for v in row] for row in ref_lt]), "lt")


@pytest.mark.parametrize("n_lights", [0, 3])
def test_shade_core_vjp_matches_torch_autograd(n_lights):
    """The hand adjoint equals torch.autograd through the port's own plain
    core (away from the kinks, where JAX's and torch's rules differ)."""
    rng = np.random.default_rng(60 + n_lights)
    data, r, kind, lt = _shade_inputs(rng, n_lights)
    data[0:9, 0, 0:24] = data[0:9, 1, 0:24]       # no kink lanes
    cot = [torch.from_numpy(c) for c in
           rng.normal(size=(10,) + S).astype(np.float32)]
    leaves = [torch.from_numpy(x).requires_grad_() for x in data]
    lt_t = torch.from_numpy(lt).requires_grad_()
    out = ts.plane_core(tuple(leaves), tuple(torch.from_numpy(x) for x in r),
                        torch.from_numpy(kind), lt_t, n_lights)
    loss = sum((o * c).sum() for o, c in zip(out[:9], cot[:9]))
    ref = torch.autograd.grad(loss, leaves + [lt_t], allow_unused=True)
    got_d, got_lt = ts.plane_core_vjp(
        tuple(torch.from_numpy(x) for x in data),
        tuple(torch.from_numpy(x) for x in r), torch.from_numpy(kind),
        torch.from_numpy(lt), n_lights, tuple(cot))
    for i, (g_, f_) in enumerate(zip(got_d, ref[:14])):
        _close(g_, torch.zeros_like(g_) if f_ is None else f_, f"data[{i}]")
    ref_lt = torch.zeros_like(got_lt) if ref[14] is None else ref[14]
    ref_lt[:, 0] = 0.0      # the kind column only feeds comparisons
    _close(got_lt, ref_lt, "lt")


def test_hit_and_bounce_vjp_match_torch_autograd():
    rng = np.random.default_rng(70)
    P, pkind, mkind, flags = _bounce_inputs(rng, True)
    P[:, 0, 0:8] = P[:, 1, 0:8]                   # no kink lanes
    pkind[0, 0:8] = pkind[1, 0:8]
    n_l = 2
    lt = _lights(rng, n_l)
    cot = torch.from_numpy(rng.normal(size=(13,) + S).astype(np.float32))
    Pt = torch.from_numpy(P).requires_grad_()
    lt_t = torch.from_numpy(lt).requires_grad_()
    args = (torch.from_numpy(pkind), torch.from_numpy(mkind),
            torch.from_numpy(flags))
    out = tbo.bounce_plane_core(Pt, *args, lt_t, n_l, True)
    ref_P, ref_lt = torch.autograd.grad((out * cot).sum(), [Pt, lt_t])
    got_P, got_lt = tbo.bounce_plane_core_vjp(
        torch.from_numpy(P), *args, torch.from_numpy(lt), n_l, True, cot)
    ref_P[7:9] = 0.0                              # tmin / tmax
    ref_lt[:n_l, 0] = 0.0                         # the light kinds
    _close(got_P, ref_P, "dP")
    _close(got_lt, ref_lt, "lt")
