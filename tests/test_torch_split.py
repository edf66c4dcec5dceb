"""The split route (scenes the trace kernel cannot take: media, noise beside
checker textures) against the JAX package on the CPU.

Kernel by kernel, on the inputs the port's split route gives them over
two bounces of a 32x32 wave (``torch_parity.split_kernel_inputs``), held
against the JAX kernels in interpret mode:
  * O: ``ops/quad.quad_search``'s plain version against
    ``pallas_quad.quad_search`` on final_scene's 1,408 quads — the same
    winner and t on every ray (measured: identical);
  * J: ``ops/hit.hit_planes``' plain version against
    ``pallas_hit._hit_planes_call`` on the fog scene — t, p, n, u, v
    within rtol 1e-5 of each lane's largest value / atol 1e-6, the sphere
    UV source on sphere lanes likewise (measured 2.2e-6; XLA contracts
    a*b+c, torch does not);
  * H: ``ops/bounce.su_planes``' plain version against
    ``pallas_bounce._su_planes_call`` on the fog scene, within the same
    bound (measured 2.6e-7).

Then whole renders through ``render_waves`` on the CPU, against JAX's TPU
route (its kernels in interpret mode) and its XLA route, under the flip
budget of ``tests/test_uber.py`` (at most 0.5% of the pixels off by more
than 1e-3, the rest within rtol 3e-4 / atol 3e-5), and against a float64
render of the same scene and rays: the port at most one pixel farther from
it than JAX. Measured: final_scene at 32x18, 2 spp flips 2 of 576 pixels
(0.35%) against both JAX routes, and exactly those two are where JAX's
float32 render leaves the float64 one (the port's matches it): a ray from
~1000 units grazes a sphere, and XLA's FMA in the root's b*b - a*c moves
the hit by ~5e-6 relative, enough to fork a later bounce onto the lamp.
The fog scene at 32x32, 2 spp: no flip.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.ops import pallas_bounce, pallas_hit, pallas_quad
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import bounce, hit, quad, uber
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops.integrator import (render_waves,
                                                      split_reason)
from rust_ray_tracer_tpu_torch.ops.shade_core import _dot, _safe_div
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import (assert_flip_budget, assert_scaled_close,
                                both, cube_mesh, jax_compile,
                                split_kernel_inputs, torch_scene)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)


def _final(monkeypatch, aspect=1.0):
    return (jax_compile(jb.get_scene("final_scene", aspect), monkeypatch),
            compile_scene(tb.get_scene("final_scene", aspect), device="cpu"))


def _planes(x):
    """[C, N] -> [C, N / 128, 128], the TPU kernels' plane layout."""
    x = x.numpy()
    return jnp.asarray(x.reshape(x.shape[:-1] + (-1, 128)))


def test_quad_search_matches_kernel_o(interpret, monkeypatch):
    js, ts = _final(monkeypatch)
    o, d, t_min, t_max = split_kernel_inputs(ts)["quad"]
    assert bool((t_max < 0).any()) and bool(torch.isinf(t_max).any())
    ref_t, ref_i = pallas_quad.quad_search(
        js, *(jnp.asarray(x.numpy()) for x in (o, d, t_min, t_max)))
    got_t, got_i = quad.quad_search(ts, o, d, t_min, t_max)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    hits = np.isfinite(np.asarray(ref_t))
    assert 0.05 < hits.mean() < 0.95
    assert len(np.unique(np.asarray(ref_i)[hits] // 128)) > 3   # clusters


@pytest.fixture(scope="module")
def final_quad_rays():
    """final_scene's rays as ``test_quad_search_matches_kernel_o`` records
    them (two bounces of a 32x32 wave), [N, 8], and the CPU scene."""
    ts = compile_scene(tb.get_scene("final_scene", 1.0), device="cpu")
    o, d, t_min, t_max = split_kernel_inputs(ts)["quad"]
    return ts, torch.cat([o, d, t_min[:, None], t_max[:, None]], 1)


def _edge_cases():
    from tests.test_torch_gpu import quad_cases
    return quad_cases()


@pytest.mark.parametrize("case", ["final_scene", "edges"])
def test_quad_sweep_replay_matches_plain(case, final_quad_rays):
    """Kernel O's sweep as ``ops/quad.quad_sweep_replay`` replays it (live
    rays packed 128 to a block and sorted by the clusters they enter, each
    warp sweeping the clusters one of its rays enters, t before alpha and
    beta) gives ``_quad_candidates``' winners and t bit for bit: on final_scene's rays (dead lanes among
    them), and on ``test_torch_gpu.quad_cases``: equal t in two clusters
    (the lower index wins), t exactly at tmin and tmax, alpha and beta
    exactly 0 and 1, denom = 0, dead lanes, 333 rays, warps whose rays
    enter disjoint clusters. The per-warp vote sweeps more than each ray
    alone needs, and the staged test skips alpha and beta on most
    tests."""
    sc, rays = final_quad_rays if case == "final_scene" else _edge_cases()
    bt, bi, work = quad.quad_sweep_replay(
        rays, quad.quad_table(sc), sc.quad_cluster_min, sc.quad_cluster_max)
    ref_t, ref_i = quad._quad_candidates(sc, rays[:, 0:3], rays[:, 3:6],
                                         rays[:, 6], rays[:, 7])
    assert torch.equal(bi, ref_i) and torch.equal(bt, ref_t)
    live = rays[:, 7] > rays[:, 6]
    assert work["live_rays"] == int(live.sum()) < rays.shape[0]
    assert work["ray_tests"] < work["tests"]
    assert work["ray_ab_tests"] <= work["ab_tests"] < work["tests"]
    hits = torch.isfinite(bt)
    assert 0.05 < float(hits.float().mean()) < 0.95
    if case == "edges":
        # ties across clusters: the copies (256-299) never win
        assert int(bi[hits].max()) < 256
        assert bool((bt[hits] == 5.0).all())
        assert work["warp_clusters"] > work["warps"]


def test_quad_table_rows_are_the_plain_operations(final_quad_rays):
    """``quad_table``'s 16-float rows: q, u, v, then n and 1 / |n|^2 equal
    to ``_quad_quants``' per-pair values bit for bit, three zeros."""
    sc = final_quad_rays[0]
    tab = quad.quad_table(sc)
    assert tab.shape == (sc.n_quads, 16) and tab.is_contiguous()
    comps = [tuple(x[None, :, a] for a in range(3))
             for x in (sc.quad_q, sc.quad_u, sc.quad_v)]
    ray = tuple(torch.ones((1, 1)) for _ in range(3))
    n = quad._quad_quants(ray, ray, *comps)[3]
    n = tuple(x[0] for x in n)
    assert torch.equal(tab[:, :9], torch.cat([sc.quad_q, sc.quad_u,
                                              sc.quad_v], 1))
    assert torch.equal(tab[:, 9:12], torch.stack(n, 1))
    assert torch.equal(tab[:, 12], _safe_div(torch.ones_like(n[0]),
                                             _dot(*n, *n)))
    assert not bool(tab[:, 13:].any())


def test_hit_planes_match_kernel_j(interpret, monkeypatch):
    js, ts = both("fog", monkeypatch)
    P, kind, flip = split_kernel_inputs(ts)["hit"]
    assert set(kind.tolist()) == {0, 2, 3, 4}     # miss, sphere, quad, medium
    n = P.shape[1]
    ref = np.array(pallas_hit._hit_planes_call(
        _planes(P), _planes(kind), _planes(flip))).reshape(12, n)
    got = hit.hit_planes(P, kind, flip).numpy().copy()
    miss = kind.numpy() == 0
    assert np.isinf(ref[0, miss]).all() and np.isinf(got[0, miss]).all()
    ref[0, miss] = got[0, miss] = 0.0
    assert_scaled_close(got[:9], ref[:9], RTOL, ATOL, axis=0,
                        what="t, p, n, u, v")
    sph = kind.numpy() == 2
    assert_scaled_close(got[9:, sph], ref[9:, sph], RTOL, ATOL, axis=0,
                        what="sphere UV source")


def test_su_planes_match_kernel_h(interpret, monkeypatch):
    js, ts = both("fog", monkeypatch)
    P, mkind, lt, n_lights = split_kernel_inputs(ts)["su"]
    assert set(mkind.tolist()) >= {TS.MAT_LAMBERTIAN, TS.MAT_DIELECTRIC,
                                   TS.MAT_METAL, TS.MAT_ISOTROPIC}
    n = P.shape[1]
    ref = np.asarray(pallas_bounce._su_planes_call(
        _planes(P), _planes(mkind), jnp.asarray(lt.numpy()))).reshape(13, n)
    got = bounce.su_planes(P, mkind, lt, n_lights).numpy()
    assert_scaled_close(got, ref, RTOL, ATOL, axis=0, what="next state")


def _off(img, ref):
    return float((np.abs(img - ref) > 1e-3).any(-1).mean())


@pytest.mark.parametrize("name,w,h,chunk", [("final_scene", 32, 18, 256),
                                            ("fog", 32, 32, 512)])
def test_render_matches_jax_routes(name, w, h, chunk, monkeypatch):
    """2 spp, depth 4: the flip budget against JAX's TPU route (interpret
    mode) and its XLA route; no farther than JAX from float64."""
    if name == "fog":
        js, ts = both(name, monkeypatch)
    else:
        js, ts = _final(monkeypatch, w / h)
    assert not uber.uber_eligible(ts)
    got = render_waves(ts, w, h, rng.key(0, "cpu"), 0, 2,
                       chunk_size=chunk).numpy()
    params, static = partition(ts)
    exact = render_waves(combine({k: v.double() for k, v in params.items()},
                                 static), w, h, rng.key(0, "cpu"), 0, 2,
                         chunk_size=chunk).numpy()
    xla = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, 2,
                                chunk_size=chunk))
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)
    tpu = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, 2,
                                chunk_size=chunk))
    assert got.shape == (h, w, 3) and got.mean() > 0.05
    for ref in (tpu, xla):
        assert_flip_budget(got, ref)
        assert _off(got, exact) <= _off(ref, exact) + 1.0 / (w * h)


def test_render_resumes_bitwise():
    """Resuming the split route from a partial sum of waves gives the
    monolithic sum bit for bit."""
    ts = torch_scene("fog")
    a = render_waves(ts, 16, 16, rng.key(3, "cpu"), 0, 2, depth=3,
                     chunk_size=128)
    part = render_waves(ts, 16, 16, rng.key(3, "cpu"), 0, 1, depth=3,
                        chunk_size=128)
    again = render_waves(ts, 16, 16, rng.key(3, "cpu"), 1, 1, depth=3,
                         chunk_size=128, acc0=part)
    assert torch.equal(a, again)
    assert torch.isfinite(a).all() and float(a.mean()) > 0


def test_split_route_refuses_gradients(monkeypatch):
    """The split route used to refuse leaves that require grad (its
    backward kernels J' and H' were not ported); it now takes them: the
    fog scene's gradients are finite and non-zero, and under no_grad the
    same leaves render the same image with no graph."""
    ts = torch_scene("fog")
    params, static = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    img = render_waves(combine(leaves, static), 8, 8, rng.key(0, "cpu"), 0,
                       1, chunk_size=64)
    img.mean().backward()
    grads = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    for k in ("tex_color", "sph_c0", "quad_q", "background", "camera.c2w"):
        assert float(grads[k].abs().max()) > 0, k
    with torch.no_grad():
        again = render_waves(combine(leaves, static), 8, 8,
                             rng.key(0, "cpu"), 0, 1, chunk_size=64)
    assert torch.isfinite(again).all() and not again.requires_grad
    assert torch.equal(again, img.detach())


def _scene(world, lights=()):
    cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return compile_scene(TS.Scene(cam, list(world), list(lights),
                                  (0.2, 0.3, 0.5)), device="cpu")


def _fog():
    return TS.ConstantMedium.from_color(
        TS.Sphere((0, 0, -4), 2.0, TS.Dielectric(1.5)), 0.5, (1, 1, 1))


def _refused_scenes():
    grey = TS.Lambertian.from_rgb(0.5, 0.5, 0.5)
    lamp = TS.XZRect(-1, 1, -5, -3, 3, TS.DiffuseLight.from_color((5,) * 3))
    return {
        "kernel L": lambda: _scene([_fog(), TS.Triangle(
            (-1, -1, -5), (1, -1, -5), (0, 1, -5), grey)] + [TS.XYRect(
                i, i + 1, 0, 1, -9, grey) for i in range(128)]),
        "kernel N": lambda: _scene([_fog()] + [TS.Sphere(
            (i % 16 - 8, i // 16 - 4, -9), 0.3, grey) for i in range(128)]),
        "kernel I": lambda: _scene([_fog(), lamp], [lamp] * 9),
    }


@pytest.mark.parametrize("kernel", ["kernel L", "kernel N", "kernel I",
                                    "item 12", "item 4"])
def test_split_route_refuses_naming_what_is_missing(kernel):
    """The scenes the split route used to refuse, naming the unported TPU
    kernel or ROADMAP item: "kernel L" (a triangle beside 128 quads),
    "kernel N" (128 spheres), "kernel I" (9 lights), "item 12" (an image
    texture's table) and "item 4" (a Mesh medium boundary). Their kernels
    and modules are ported now, so these cases keep their names (tests
    are tracked by name) and check that the scene takes the split route
    and renders finite. Meshes and scenes past the trace kernel's 4,096
    rows render (``tests/test_torch_mesh.py``), and the 9-light and Mesh
    media scenes are held against JAX in ``tests/test_torch_gltf.py``."""
    if kernel == "item 4":
        ts = _scene([TS.ConstantMedium.from_color(
            cube_mesh(TS, (-1, -1, -5), (1, 1, -3)), 0.5, (1, 1, 1))])
        assert ts.med_kind.tolist() == [TS.MED_MESH]
    elif kernel == "item 12":
        ts = dataclasses.replace(_scene([_fog()]), img_data=torch.zeros(
            (1, 2, 2, 3)), img_size=torch.full((1, 2), 2, dtype=torch.int32))
    else:
        ts = _refused_scenes()[kernel]()
    assert not uber.uber_eligible(ts)
    assert split_reason(ts) is None
    img = render_waves(ts, 8, 8, rng.key(0, "cpu"), 0, 1, chunk_size=64)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
