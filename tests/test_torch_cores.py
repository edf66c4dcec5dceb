"""The port's plane cores vs the JAX device functions they mirror.

pallas_hit._hit_plane_core, pallas_shade._plane_core and
pallas_bounce._bounce_plane_core are plain jnp functions, called here
directly on [8, 128] planes; both sides get the same random planes from
numpy, covering every primitive kind (and misses), every material, and
sphere / quad / null lights; every winner pack is a real hit of its kind.
Tolerance rtol 1e-5, atol 1e-6: the formulas are the same; XLA on the CPU
contracts a*b+c into fused multiply-adds and its transcendentals (rsqrt,
sin, cos, exp, log) may differ from torch's by an ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.ops import pallas_bounce as jbo
from rust_ray_tracer_tpu.ops import pallas_hit as jh
from rust_ray_tracer_tpu.ops import pallas_shade as js
from rust_ray_tracer_tpu_torch.ops import bounce_core as tbo
from rust_ray_tracer_tpu_torch.ops import hit_core as th
from rust_ray_tracer_tpu_torch.ops import shade_core as ts
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

S = (8, 128)
RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _hit_planes(rng):
    """Hit-core input planes whose winner pack is a real hit of its kind:
    each lane's ray starts 1-3 ray lengths before a point on its triangle,
    sphere or quad (misses and media lanes keep random packs)."""
    P = np.zeros((19,) + S, np.float32)
    d = rng.normal(size=(3,) + S)
    P[3:6] = d
    P[6] = rng.uniform(0, 1, S)
    P[7] = 1e-4
    P[8] = np.where(rng.uniform(size=S) < 0.9, np.inf, -1.0)
    kind = rng.integers(0, 5, S)                     # NONE TRI SPH QUAD MED
    a = rng.uniform(0.05, 0.45, S)
    b = rng.uniform(0.05, 0.45, S)
    s = rng.uniform(1.0, 3.0, S)
    v0, e1, e2 = (rng.normal(size=(3,) + S) for _ in range(3))
    # triangle (v0, e1, e2) and quad (q, u, v): the ray aims at
    # v0 + a*e1 + b*e2 (inside both: a, b > 0, a + b < 1)
    target = v0 + a * e1 + b * e2
    pack = np.concatenate([v0, e1, e2])
    # sphere (c0, c1, t0, t1, r): centre ahead on the ray, slightly off
    # axis, moving a little over the shutter
    r = rng.uniform(0.3, 1.0, S)
    o_sph = rng.uniform(-2, 2, (3,) + S)
    c0 = o_sph + s * d + 0.3 * r * rng.normal(size=(3,) + S) / np.sqrt(3)
    sph_pack = np.concatenate([c0, c0 + 0.05 * rng.normal(size=(3,) + S),
                               np.zeros((1,) + S), np.ones((1,) + S),
                               r[None]])
    is_sph = kind == 2
    pack = np.where(is_sph, sph_pack, pack)
    o = np.where(is_sph, o_sph, target - s * d)
    o = np.where((kind == 0) | (kind == 4), rng.uniform(-2, 2, (3,) + S), o)
    P[0:3] = o
    P[9:18] = pack
    P[18] = rng.uniform(0.1, 3, S)
    flip = rng.integers(0, 2, S).astype(np.int32)
    return P, kind.astype(np.int32), flip


def _lights(rng, n_l):
    lt = np.zeros((n_l + 1, 14), np.float32)
    for l in range(n_l):
        if l % 3 == 0:                      # sphere
            lt[l, 1:4] = rng.uniform(-3, 3, 3)
            lt[l, 4] = 0.3
        elif l % 3 == 1:                    # XZ quad
            lt[l, 0] = 1
            lt[l, 5:8] = rng.uniform(-3, 3, 3)
            lt[l, 8] = 1.0
            lt[l, 13] = 0.8
        else:                               # null (Hittable defaults)
            lt[l, 0] = 2
    lt[n_l, 0:3] = (0.2, 0.3, 0.5)          # background row
    return lt


def _lt_tuple(lt, rows):
    return tuple(tuple(float(v) for v in row) for row in lt[:rows])


@pytest.mark.parametrize("seed", [0, 1])
def test_hit_core_matches(seed):
    P, kind, flip = _hit_planes(np.random.default_rng(seed))
    ref = jh._hit_plane_core(jnp.asarray(P), jnp.asarray(kind),
                             jnp.asarray(flip))
    got = th.hit_plane_core(torch.from_numpy(P), torch.from_numpy(kind),
                            torch.from_numpy(flip))
    _close(got, ref)


@pytest.mark.parametrize("n_lights", [0, 1, 3])
def test_shade_core_matches(n_lights):
    rng = np.random.default_rng(10 + n_lights)
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
    lt = _lights(rng, n_lights)
    ref = js._plane_core(tuple(jnp.asarray(x) for x in data),
                         tuple(jnp.asarray(x) for x in r), jnp.asarray(kind),
                         _lt_tuple(lt, n_lights), n_lights)
    got = ts.plane_core(tuple(torch.from_numpy(x) for x in data),
                        tuple(torch.from_numpy(x) for x in r),
                        torch.from_numpy(kind), torch.from_numpy(lt),
                        n_lights)
    assert len(got) == len(ref) == 10
    for g, f in zip(got, ref):
        _close(g, f)


@pytest.mark.parametrize("has_checker", [False, True])
def test_bounce_core_matches(has_checker):
    rng = np.random.default_rng(20 + has_checker)
    P_hit, pkind, flip = _hit_planes(rng)
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
    n_l = 2
    lt = _lights(rng, n_l)
    ref = jbo._bounce_plane_core(jnp.asarray(P), jnp.asarray(pkind),
                                 jnp.asarray(mkind), jnp.asarray(flags),
                                 _lt_tuple(lt, n_l + 1), n_l, has_checker)
    got = tbo.bounce_plane_core(torch.from_numpy(P), torch.from_numpy(pkind),
                                torch.from_numpy(mkind),
                                torch.from_numpy(flags),
                                torch.from_numpy(lt), n_l, has_checker)
    _close(got, ref)


def test_detached_sampling_sites():
    """Lambertian directions are detached samples: no gradient reaches the
    hit data through them, while the weight (BSDF / pdf) carries one."""
    rng = np.random.default_rng(3)
    data = [torch.tensor(rng.normal(size=S), dtype=torch.float32,
                         requires_grad=True) for _ in range(14)]
    r = [torch.tensor(rng.uniform(size=S), dtype=torch.float32)
         for _ in range(15)]
    kind = torch.zeros(S, dtype=torch.int32)          # all Lambertian
    lt = torch.from_numpy(_lights(rng, 1))
    out = ts.plane_core(tuple(data), tuple(r), kind, lt, 1)
    g_dir = torch.autograd.grad(sum(o.sum() for o in out[6:9]), data,
                                allow_unused=True, retain_graph=True)
    assert all(g is None or not g.any() for g in g_dir)
    g_wt = torch.autograd.grad(out[3].sum(), data, allow_unused=True)
    assert g_wt[6] is not None and g_wt[6].abs().sum() > 0   # d/d normal
