"""Kernel I's order of work (``csrc/shade.cu``: the mixture pdf over each
lane's candidate lights) replayed on the CPU: ``ops/shade.
shade_candidates_replay`` against I's plain version ``shade_plane_core``
bit for bit, and its candidate counts.

The replay marks, in chunks of 32 lights, a sphere light where its
discriminant is positive and a quad light always, then adds the full pdf
of the marked lights in light order, a sphere's hit test on its far root
alone. The planes must be ``shade_plane_core``'s bit for bit: a light
left out has pdf +0 and the far root decides the hit. The inputs come
from a numpy seed: 640 lanes of every material kind, the 9-light glTF
flagship's sphere lights (radius 0.2, ``torch_parity.GLTF_LIGHTS``) with
two quad lights at 16 and 40 lights, Lambertian lanes that sample a
light (their rays aimed at it), and 64 edge lanes at the origin whose
cosine sample is exactly +z, beside edge lights placed for them: a
discriminant exactly 0, discriminants a few ulps of 25 either side of 0, far
roots within 1e-6 of 1e-4 on both sides. At 40 lights the edge lights sit
in the second chunk of 32. Runs on one torch thread in about a second.
"""

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu_torch.models.scene import (LIGHT_QUAD, LIGHT_SPHERE,
                                                    MAT_LAMBERTIAN)
from rust_ray_tracer_tpu_torch.ops import shade as shade_ops

from torch_parity import GLTF_LIGHTS
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

N_LANES, N_EDGE = 640, 64
LIGHT_R = 0.2           # the glTF flagship's point lights (models/gltf.py)


def _lights(n_lights, rs):
    """[n_lights, 14] rows: the glTF flagship's sphere lights (past 16
    repeated, moved by (0.05, -0.05, 0.025) a repeat), two of them quads
    from 16 lights, and the four edge lights of :func:`_inputs` in the
    last four rows (rows 36-39 at 40 lights: the second chunk)."""
    lt = np.zeros((n_lights, 14), np.float32)
    for k in range(n_lights - 4):
        pos = np.asarray(GLTF_LIGHTS[k % 16][0], np.float32)
        lt[k, 0] = LIGHT_SPHERE
        lt[k, 1:4] = pos + (k // 16) * np.float32([0.05, -0.05, 0.025])
        lt[k, 4] = LIGHT_R
    if n_lights >= 16:
        for k in (3, 10):
            lt[k] = 0.0
            lt[k, 0] = LIGHT_QUAD
            lt[k, 5:8] = rs.uniform(-3.0, 3.0, 3)
            lt[k, 8:11] = rs.normal(size=3) * 0.5
            lt[k, 11:14] = rs.normal(size=3) * 0.5
    # the edge lights, for the edge lanes' line (0, 0, t): one tangent
    # (oc = (-0.25, 0, -5): cc = 25 and disc = 25 - 25 = +0 exactly), one
    # 1e-5 closer (disc a few ulps of 25 above 0), one 1e-5 farther (below),
    # and one whose far root is ~1e-4
    lt[-4:, 0] = LIGHT_SPHERE
    lt[-4, 1:5] = (0.25, 0.0, 5.0, 0.25)
    lt[-3, 1:5] = (0.25 - 1e-5, 0.0, 5.0, 0.25)
    lt[-2, 1:5] = (0.25 + 1e-5, 0.0, 5.0, 0.25)
    lt[-1, 1:5] = (0.0, 0.0, np.float32(1e-4) - np.float32(0.5), 0.5)
    return torch.from_numpy(lt)


def _inputs(n_lights, seed=18):
    """(data [14, N], rng [15, N], kind [N], lt) of kernel I. Lanes 0-63
    are the edge lanes: Lambertian, p at (0, 0, z) with z in +-3e-7 (so
    the far root against the last edge light moves across 1e-4 in steps
    of its ulp), normal +z, u1 = 0 and u3 < 0.5, so the cosine sample and
    the direction are exactly +z. The rest: kinds 0-4 (Lambertian half of
    them), p in [-3, 3]^3, random normals, albedos, fuzz, ior, randoms."""
    rs = np.random.default_rng(seed)
    n = N_LANES
    data = np.zeros((14, n), np.float32)
    data[0:3] = rs.normal(size=(3, n))
    data[3:6] = rs.uniform(-3.0, 3.0, (3, n))
    data[6:9] = rs.normal(size=(3, n))
    data[9:12] = rs.uniform(0.1, 0.9, (3, n))
    data[12] = rs.uniform(0.0, 0.5, n)
    data[13] = rs.uniform(1.3, 1.7, n)
    rng_p = np.zeros((15, n), np.float32)
    rng_p[0:9] = rs.uniform(size=(9, n))
    rng_p[9:15] = rs.normal(size=(6, n))
    kind = rs.choice([0, 0, 0, 0, 1, 2, 3, 4], size=n).astype(np.int32)
    e = slice(0, N_EDGE)
    kind[e] = MAT_LAMBERTIAN
    data[3:6, e] = 0.0
    data[5, e] = np.linspace(-3e-7, 3e-7, N_EDGE)
    data[6:9, e] = np.float32([[0.0], [0.0], [1.0]])
    rng_p[1, e] = 0.0
    rng_p[3, e] = 0.25
    return (torch.from_numpy(data), torch.from_numpy(rng_p),
            torch.from_numpy(kind), _lights(n_lights, rs))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _candidates(data, kind, lt, n_lights, sd):
    """Each lane's candidate lights counted straight from the rows: a
    sphere light where the discriminant is positive, a quad always."""
    p = tuple(data[3:6])
    n = torch.zeros(kind.shape, dtype=torch.int32)
    for l in range(n_lights):
        if float(lt[l, 0]) == LIGHT_QUAD:
            n += 1
        else:
            n += (shade_ops._sphere_disc(lt, l, p, sd)[0] > 0).int()
    return torch.where(kind == MAT_LAMBERTIAN, n, torch.zeros_like(n))


@pytest.mark.parametrize("n_lights", [9, 16, 40])
def test_replay_is_plane_core_bitwise(n_lights):
    """The replay's [10, N] planes equal ``shade_plane_core``'s bit for
    bit, and its candidate counts are the rows' (spheres with a positive
    discriminant, every quad) on the Lambertian lanes, 0 on the others."""
    data, rng_p, kind, lt = _inputs(n_lights)
    ref = shade_ops.shade_plane_core(data, rng_p, kind, lt, n_lights)
    got, n_cand = shade_ops.shade_candidates_replay(data, rng_p, kind, lt,
                                                    n_lights)
    assert torch.equal(_bits(got), _bits(ref))
    sd = tuple(ref[6:9])
    assert torch.equal(n_cand, _candidates(data, kind, lt, n_lights, sd))


@pytest.mark.parametrize("n_lights", [9, 40])
def test_inputs_reach_the_edges(n_lights):
    """The inputs hold what the replay must get right: every material
    kind; Lambertian lanes that sample a light and whose ray then crosses
    it; edge lanes whose direction is exactly +z, with a discriminant of
    exactly +0 against the tangent light, small positive and negative ones
    against its neighbours, and far roots within 1e-6 of 1e-4 on both
    sides, some hitting and some not; at 40 lights those candidates lie in
    the second chunk of 32."""
    data, rng_p, kind, lt = _inputs(n_lights)
    out = shade_ops.shade_plane_core(data, rng_p, kind, lt, n_lights)
    assert set(kind.tolist()) == {0, 1, 2, 3, 4}
    sd = tuple(out[6:9])
    e = slice(0, N_EDGE)
    assert all(torch.equal(sd[c][e], torch.full((N_EDGE,), float(c == 2)))
               for c in range(3))
    p = tuple(data[3:6])
    d0, d_in, d_out = (shade_ops._sphere_disc(lt, n_lights - k, p, sd)[0][e]
                       for k in (4, 3, 2))
    assert bool((d0 == 0).any()) and not bool(torch.signbit(d0[d0 == 0])
                                              .any())
    assert bool((d_in > 0).all()) and float(d_in.max()) < 2e-5
    assert bool((d_out < 0).all()) and float(d_out.min()) > -2e-5
    disc, aa, bb = shade_ops._sphere_disc(lt, n_lights - 1, p, sd)
    r2 = ((-bb + torch.sqrt(disc)) / aa)[e]
    assert bool((disc[e] > 0).all())
    assert float((r2 - 1e-4).abs().max()) < 1e-6
    assert bool((r2 >= np.float32(1e-4)).any())
    assert bool((r2 < np.float32(1e-4)).any())
    # Lambertian lanes that sampled a light: the light they picked is a
    # candidate (their ray line crosses it)
    u3, u4 = rng_p[3], rng_p[4]
    li = torch.clamp((u4 * n_lights).int(), max=n_lights - 1)
    samp = (kind == MAT_LAMBERTIAN) & (u3 >= 0.5)
    assert int(samp.sum()) > 50
    crossed = torch.zeros_like(samp)
    for l in range(n_lights):
        if float(lt[l, 0]) == LIGHT_SPHERE:
            crossed |= (li == l) & (shade_ops._sphere_disc(lt, l, p, sd)[0]
                                    > 0)
    assert float((crossed & samp).sum()) >= 0.9 * float(samp.sum())
    if n_lights == 40:
        assert n_lights - 4 >= shade_ops.CAND_CHUNK


@pytest.mark.parametrize("n_lights", [9, 16, 40])
def test_most_lights_are_skipped(n_lights):
    """Off the edge lanes, a Lambertian lane's mixture pdf runs the full
    test on a few of the scene's lights: the mean candidate count is under
    a fifth of the lights (the flagship's lights are spheres of radius 0.2
    a few units apart, so a line crosses the one it sampled and seldom
    another), and a 32-lane warp's most is under half of them."""
    data, rng_p, kind, lt = _inputs(n_lights)
    _, n_cand = shade_ops.shade_candidates_replay(data, rng_p, kind, lt,
                                                  n_lights)
    rest = n_cand[N_EDGE:]
    lam = kind[N_EDGE:] == MAT_LAMBERTIAN
    assert float(rest[lam].float().mean()) < n_lights / 5
    assert int(rest.reshape(-1, 32).amax(1).max()) < n_lights / 2
