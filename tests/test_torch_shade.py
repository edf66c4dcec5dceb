"""The split route's shading for 9 or more lights (TPU kernels I and I')
against the JAX package on the CPU.

  * ``ops/shade.shade_fused`` (``ShadeFused``: kernel I's plain version,
    ``ops/shade_core.plane_core``, on the CPU) against JAX's XLA
    ``shade_core`` (``ops/shade.py:113``) at 9 and 12 lights (spheres,
    XZ quads and a FlipFace-wrapped null light, compiled from the same
    host scene by both packages), 2,048 lanes of random inputs from a
    numpy seed covering all five materials: emitted, weight and direction
    within 1e-6 of each lane's largest output, ``alive`` equal. A lane may
    fall outside only where JAX's own output is more than 1e-6 from a
    float64 replay of the plain version, and the port may leave that
    replay on at most one lane more than JAX does. Measured: at 9 lights
    at most 4.2e-7 on every lane; at 12 lights one lane of 2,048, a
    refraction near total internal reflection, 6.8e-6 apart, where JAX is
    2.8e-6 and the port 4.0e-6 from float64 (two lanes each past 1e-6),
    and the rest within 3.6e-7. The JAX TPU kernel I (``_shade_pallas``)
    is held to ``shade_core`` by the JAX package's own
    ``tests/test_pallas_shade.py``; its interpret mode takes tens of
    seconds at 9 lights on 2,048 rays on the CPU, so ``shade_core`` is the
    reference here.
  * Its backward (I''s plain version, ``plane_core_vjp``) against
    ``jax.vjp`` of ``shade_core`` with a seeded cotangent: each leaf (the
    data planes and the light rows ``light_c``, ``light_r``, ``light_q``,
    ``light_u``, ``light_v``) within relative L2 1e-5 (measured: ``ior``
    5.4e-6 at 12 lights, the near-total-reflection lane again; every
    other leaf at most 7.6e-7).
  * Branch agreement at 8 lights: ``ops/integrator.bounce_split``'s plain
    tail (kernel I and ``update_plain``), forced on a scene kernels J and H
    take (F turned off), gives H's next state (``su_plane_core``) on the
    same inputs over two bounces, within ``tests/test_torch_split.py``'s
    bound for H: rtol 1e-5 of each lane's largest value / atol 1e-6
    (measured: bitwise equal).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops.shade import shade_core as jax_shade_core
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import (bounce_split,
                                                      make_split_tables)
from rust_ray_tracer_tpu_torch.ops.shade import shade_fused
from rust_ray_tracer_tpu_torch.ops.shade_core import _light_table, plane_core
from rust_ray_tracer_tpu_torch.utils import rng as trng

from tests.torch_parity import (assert_scaled_close, jax_compile, rel_l2,
                                write_gltf_flagship)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

C = 2048
LEAVES = ("d_in", "p", "normal", "albedo", "fuzz", "ior")
LIGHT_LEAVES = ("light_c", "light_r", "light_q", "light_u", "light_v")


def _light_scene(S, cam_mod, n_lights):
    """A ground sphere and ``n_lights`` lights: spheres, XZ quads and, the
    third of every nine, a FlipFace-wrapped quad (a null light row)."""
    rng = np.random.default_rng(n_lights)
    lights = []
    for li in range(n_lights):
        emit = S.DiffuseLight.from_color(rng.uniform(1, 9, 3))
        x, y, z = rng.uniform(-3, 3), rng.uniform(1, 3), rng.uniform(-6, -2)
        if li % 3 == 0:
            lights.append(S.Sphere((x, y, z), rng.uniform(0.2, 0.6), emit))
        else:
            quad = S.XZRect(x, x + 1.0, z, z + 0.8, y, emit)
            lights.append(S.FlipFace(quad) if li % 9 == 2 else quad)
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    world = [S.Sphere((0, -100.5, -4), 100.0,
                      S.Lambertian.from_rgb(0.5, 0.5, 0.5))] + lights
    return S.Scene(cam, world, lights, (0.1, 0.2, 0.3))


def _inputs(seed):
    """Random per-lane inputs of the shading, every material kind."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(C, 3))
    f32 = np.float32
    return dict(
        d_in=rng.normal(size=(C, 3)).astype(f32),
        p=rng.uniform((-3, -0.5, -6), (3, 2, -2), (C, 3)).astype(f32),
        normal=(nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(f32),
        albedo=rng.uniform(0, 1, (C, 3)).astype(f32),
        kind=rng.integers(0, 5, C).astype(np.int32),
        fuzz=rng.uniform(0, 0.5, C).astype(f32),
        ior=rng.uniform(1.1, 2.0, C).astype(f32),
        ub=rng.uniform(0, 1, (C, 9)).astype(f32),
        gb=rng.normal(size=(C, 6)).astype(f32))


def _both(n_lights, monkeypatch):
    js = jax_compile(_light_scene(JS, jcam, n_lights), monkeypatch)
    ts = compile_scene(_light_scene(TS, tcam, n_lights), device="cpu")
    assert js.n_lights == ts.n_lights == n_lights
    assert set(ts.light_kind.tolist()) == ({0, 1, 2} if n_lights >= 3
                                           else {0, 1})
    return js, ts


def _jax_shade(js, x, lights=None, jit=False):
    scene = js if lights is None else js._replace(**lights)
    fn = jax.jit(jax_shade_core) if jit else jax_shade_core
    return fn(scene, *(jnp.asarray(x[k]) for k in (
        "d_in", "p", "normal", "albedo", "kind", "fuzz", "ior", "ub", "gb")))


def _port_shade(ts, x, leaves=None):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    if leaves is not None:
        t.update(leaves)
    lt = _light_table(dataclasses.replace(
        ts, **{k: t[k] for k in LIGHT_LEAVES if k in t}))
    return shade_fused(t["d_in"], t["p"], t["normal"], t["albedo"],
                       t["kind"], t["fuzz"], t["ior"], t["ub"], t["gb"], lt,
                       ts.n_lights)


def _port_shade64(ts, x):
    """[C, 9] emitted, weight, direction of the plain version in float64:
    the arbiter where float32 conditioning decides."""
    def d(k):
        return torch.from_numpy(x[k]).double()

    data = torch.cat([d("d_in").T, d("p").T, d("normal").T, d("albedo").T,
                      d("fuzz")[None], d("ior")[None]])
    rng = torch.cat([d("ub").T, d("gb").T])
    out = plane_core(tuple(data), tuple(rng), torch.from_numpy(x["kind"]),
                     _light_table(ts).double(), ts.n_lights)
    return torch.stack(out[:9], 1).numpy()


@pytest.mark.parametrize("n_lights", [9, 12])
def test_shade_forward_matches_jax(n_lights, monkeypatch):
    js, ts = _both(n_lights, monkeypatch)
    x = _inputs(n_lights)
    ref = _jax_shade(js, x, jit=True)
    got = _port_shade(ts, x)
    assert np.array_equal(got.alive.numpy(), np.asarray(ref.alive))
    g = torch.cat([got.emitted, got.weight, got.direction], 1).numpy()
    r = np.concatenate([np.asarray(ref.emitted), np.asarray(ref.weight),
                        np.asarray(ref.direction)], 1)
    exact = _port_shade64(ts, x)

    def off(a, b):
        return (np.abs(a - b) > 1e-6 * np.abs(b).max(1, keepdims=True)
                ).any(1)

    # a lane may leave JAX's only where JAX leaves the float64 replay
    # (a refraction near total internal reflection); the port leaves the
    # replay on at most as many lanes as JAX, plus one
    assert not (off(g, r) & ~off(r, exact)).any()
    assert off(g, exact).sum() <= off(r, exact).sum() + 1
    assert off(g, r).mean() <= 0.002
    # every kind shaded, and the light mixture weighted Lambertian lanes
    assert set(x["kind"].tolist()) == {0, 1, 2, 3, 4}
    lam = x["kind"] == TS.MAT_LAMBERTIAN
    assert np.abs(r[lam, 3:6]).max() > 0


@pytest.mark.parametrize("n_lights", [9, 12])
def test_shade_backward_matches_jax_vjp(n_lights, monkeypatch):
    js, ts = _both(n_lights, monkeypatch)
    x = _inputs(100 + n_lights)
    cot = np.random.default_rng(7).normal(size=(3, C, 3)).astype(np.float32)

    def jax_fn(d_in, p, normal, albedo, fuzz, ior, *lights):
        y = dict(x, d_in=d_in, p=p, normal=normal, albedo=albedo, fuzz=fuzz,
                 ior=ior)
        sc = _jax_shade(js, y, dict(zip(LIGHT_LEAVES, lights)))
        return sc.emitted, sc.weight, sc.direction

    primals = ([jnp.asarray(x[k]) for k in LEAVES]
               + [getattr(js, k) for k in LIGHT_LEAVES])
    # eager: jit lets XLA contract a*b+c apart from the forward above
    _, vjp = jax.vjp(jax_fn, *primals)
    ref = dict(zip(LEAVES + LIGHT_LEAVES,
                   (np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                                     for c in cot)))))

    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in LEAVES}
    leaves.update({k: getattr(ts, k).clone().requires_grad_()
                   for k in LIGHT_LEAVES})
    sc = _port_shade(ts, x, leaves)
    c = torch.from_numpy(cot)
    ((sc.emitted * c[0]).sum() + (sc.weight * c[1]).sum()
     + (sc.direction * c[2]).sum()).backward()
    for k, v in leaves.items():
        got = v.grad.numpy()
        assert np.isfinite(got).all(), k
        assert rel_l2(got, ref[k]) <= 1e-5, (k, rel_l2(got, ref[k]))
    for k in ("light_c", "light_r", "light_q", "normal", "albedo"):
        assert np.abs(ref[k]).max() > 0, k


def test_plain_tail_matches_kernel_h_branch(tmp_path):
    """At 8 lights kernels J and H take the scene (F off); the plain tail
    forced on the same bounce gives H's next state."""
    path = write_gltf_flagship(tmp_path / "f8.gltf", n_lights=8)
    ts = compile_scene(load_gltf_scene(path, 16 / 9), device="cpu")
    assert ts.n_lights == 8
    # kernel F takes this solid scene; J and H are the branch it falls to
    tables = dataclasses.replace(make_split_tables(ts), fused=False)
    assert tables.su
    w, h, depth = 32, 18, 2
    st, rnd = uber.wave_inputs(ts, trng.wave_key(trng.key(3, "cpu"), 0), w,
                               h, depth, w * h)
    st, rnd = st[:, :w * h], rnd[..., :w * h]
    for b in range(depth):
        ref = bounce_split(ts, st, rnd[b], tables)
        got = bounce_split(ts, st, rnd[b], dataclasses.replace(tables,
                                                               su=False))
        assert_scaled_close(got.numpy(), ref.numpy(), 1e-5, 1e-6, axis=0,
                            what=f"bounce {b}")
        assert bool((ref[7] > 0.5).any())
        st = ref
