"""The port's media against the JAX package's: the ConstantMedium compile,
the free flight ``_med_t`` and ``texture_value``.

Inputs are made with numpy from a seed and given to both sides. Tables
must be identical (integers) or within 1e-6 (floats: both run the same
float32 numpy). ``_med_t``: the same lanes find a scatter, their t within
rtol 1e-6 (XLA's CPU ``log`` differs from torch's by an ulp on ~14% of
inputs, and XLA contracts a*b+c: measured at most 1.3e-7 relative).
``texture_value``: within atol 1e-6 (measured 6e-8: the marble's sine of
an ulp-different turbulence).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.ops import intersect as ji
from rust_ray_tracer_tpu.ops import texture as jt
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import SceneData, compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import intersect as ti
from rust_ray_tracer_tpu_torch.ops import texture as tt

from tests.torch_parity import both, jax_compile
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


def _scenes(name, monkeypatch):
    if name == "final_scene":
        return (jax_compile(jb.get_scene(name, 16 / 9), monkeypatch),
                compile_scene(tb.get_scene(name, 16 / 9), device="cpu"))
    return both(name, monkeypatch)


@pytest.mark.parametrize("name", ["final_scene", "fog"])
def test_media_compile_matches_jax(name, monkeypatch):
    """Every table, media included (sphere boundaries; the fog scene's
    rotated, translated Cuboid as six outward half-spaces)."""
    js, ts = _scenes(name, monkeypatch)
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            continue
        ref, got = np.asarray(getattr(js, f.name)), getattr(ts, f.name)
        assert ref.shape == tuple(got.shape), f.name
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f.name)
    assert ts.n_media == 2
    if name == "final_scene":
        assert (ts.n_tris, ts.n_spheres, ts.n_quads) == (0, 16, 1408)
        assert ts.med_kind.tolist() == [TS.MED_SPHERE] * 2
    else:
        assert sorted(ts.med_kind.tolist()) == [TS.MED_SPHERE, TS.MED_POLY]
        assert ts.med_pl_n.shape == (2, 6, 3)


def test_mesh_medium_boundary_raises():
    """A Mesh boundary used to raise (ROADMAP queue 1 item 4); the name is
    kept (tests are tracked by name) and it now checks the compile: a
    ``MED_MESH`` medium whose ``med_tri`` rows are each triangle's p0, e1,
    e2 and double-sided flag under the boundary's Translate, with the
    Isotropic material of the medium's colour."""
    cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    tris = [((0, 0, 0), (1, 0, 0), (0, 1, 0)), ((0, 0, 0), (0, 1, 0),
                                                 (0, 0, 1))]
    mesh = TS.Translate(TS.Mesh(tris, double_sided=False), (1, 2, 3))
    ts = compile_scene(TS.Scene(cam, [TS.ConstantMedium.from_color(
        mesh, 0.5, (0.3, 0.6, 0.9))], [], (0, 0, 0)), device="cpu")
    assert ts.med_kind.tolist() == [TS.MED_MESH]
    assert ts.med_neg_inv_d.tolist() == [-2.0]
    assert ts.mat_kind[ts.med_mat.long()].tolist() == [TS.MAT_ISOTROPIC]
    np.testing.assert_allclose(
        ts.tex_color[ts.mat_tex[ts.med_mat.long()].long()].numpy(),
        [[0.3, 0.6, 0.9]], rtol=1e-6)
    np.testing.assert_array_equal(ts.med_tri.numpy(), np.array([[
        [1, 2, 3, 1, 0, 0, 0, 1, 0, 0],
        [1, 2, 3, 0, 1, 0, 0, 0, 1, 0]]], np.float32))


# the fog scene's media: the Cuboid's centre (its Translate) and the sphere
FOG_MEDIA = np.array([[-1.6, 0.0, -3.2], [2.2, 0.0, -4.0]], np.float32)


def _rays(rng, c):
    """Rays from around the camera, half aimed near a fog-scene medium, a
    tenth dead (t_max = -1)."""
    o = rng.uniform(-2, 2, (c, 3)).astype(np.float32)
    aim = FOG_MEDIA[rng.integers(0, 2, c)] + rng.normal(scale=0.5,
                                                         size=(c, 3))
    d = np.where((rng.uniform(size=c) < 0.5)[:, None], aim - o,
                 rng.normal(size=(c, 3))).astype(np.float32)
    t_min = np.full(c, 1e-4, np.float32)
    t_max = np.where(rng.uniform(size=c) < 0.9, np.inf, -1.0).astype(
        np.float32)
    return o, d, t_min, t_max


def test_med_t_matches_jax(monkeypatch):
    """Sphere and Cuboid boundaries (the fog scene): the same lanes scatter
    in the same media, their t within rtol 1e-6."""
    js, ts = both("fog", monkeypatch)
    rng = np.random.default_rng(3)
    c = 2048
    o, d, t_min, t_max = _rays(rng, c)
    u = rng.uniform(0, 1, (c, ts.n_media)).astype(np.float32)
    u[:8] = 0.0                                  # the log(0) guard
    ref = np.asarray(ji._med_t(js, *(jnp.asarray(x)
                                     for x in (o, d, u, t_min)),
                               jnp.asarray(t_max)))
    got = ti._med_t(ts, *(torch.from_numpy(x) for x in (o, d, u, t_min,
                                                        t_max))).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin[:, 0].mean() > 0.05 and fin[:, 1].mean() > 0.05
    assert not fin[t_max < 0].any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)


def test_med_t_final_scene_matches_jax(monkeypatch):
    """final_scene's two sphere media (r = 70 at density 0.2; r = 5000
    at 1e-4 around the camera), rays from the camera's side."""
    js, ts = _scenes("final_scene", monkeypatch)
    rng = np.random.default_rng(4)
    c = 1024
    o = (np.array([478.0, 278.0, -600.0], np.float32)
         + rng.normal(scale=20.0, size=(c, 3))).astype(np.float32)
    aim = np.array([360.0, 150.0, 145.0]) + rng.normal(scale=60.0,
                                                        size=(c, 3))
    d = (aim - o).astype(np.float32)
    u = rng.uniform(0, 1, (c, 2)).astype(np.float32)
    t_min = np.full(c, 1e-4, np.float32)
    t_max = np.full(c, np.inf, np.float32)
    ref = np.asarray(ji._med_t(js, *(jnp.asarray(x)
                                     for x in (o, d, u, t_min, t_max))))
    got = ti._med_t(ts, *(torch.from_numpy(x) for x in (o, d, u, t_min,
                                                        t_max))).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin[:, 0].mean() > 0.05 and fin[:, 1].mean() > 0.05
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)


@pytest.mark.parametrize("name", ["fog", "final_scene"])
def test_texture_value_matches_jax(name, monkeypatch):
    """Every texture of the scene (solid, checker, marble noise, the
    missing earth map's yellow) at random points."""
    js, ts = _scenes(name, monkeypatch)
    rng = np.random.default_rng(5)
    c = 4096
    scale = 3.0 if name == "fog" else 400.0
    p = rng.uniform(-scale, scale, (c, 3)).astype(np.float32)
    tid = rng.integers(0, ts.tex_kind.shape[0], c).astype(np.int32)
    uv = rng.uniform(0, 1, (2, c)).astype(np.float32)
    ref = np.asarray(jt.texture_value(js, jnp.asarray(tid),
                                      jnp.asarray(uv[0]),
                                      jnp.asarray(uv[1]), jnp.asarray(p)))
    got = tt.texture_value(ts, torch.from_numpy(tid),
                           torch.from_numpy(uv[0]), torch.from_numpy(uv[1]),
                           torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert set(ts.tex_kind.tolist()) >= ({TS.TEX_SOLID, TS.TEX_CHECKER,
                                          TS.TEX_NOISE} if name == "fog"
                                         else {TS.TEX_SOLID, TS.TEX_NOISE})


def test_texture_value_refuses_image_tables(monkeypatch):
    """``texture_value`` used to refuse a scene with an image table (image
    leaves were unported); it now evaluates them. The name is kept, as
    tests are tracked by name. The fog scene (marble, checkers, solids)
    with its first solid texture turned into an image of a 3x2 atlas:
    the port equals JAX within the file's 1e-6 on every texture id, and
    the image rows give the atlas's texels."""
    js, ts = both("fog", monkeypatch)
    img = np.random.default_rng(8).random((1, 3, 2, 3)).astype(np.float32)
    kind = ts.tex_kind.numpy().copy()
    row = int(np.flatnonzero(kind == TS.TEX_SOLID)[0])
    kind[row] = TS.TEX_IMAGE
    size = np.array([[3, 2]], np.int32)
    js = js._replace(img_data=jnp.asarray(img), img_size=jnp.asarray(size),
                     tex_kind=jnp.asarray(kind))
    ts = dataclasses.replace(ts, img_data=torch.from_numpy(img),
                             img_size=torch.from_numpy(size),
                             tex_kind=torch.from_numpy(kind))
    g = np.random.default_rng(9)
    n = 64
    tid = np.arange(n, dtype=np.int32) % kind.size
    u, v = g.uniform(-0.2, 1.2, (2, n)).astype(np.float32)
    p = g.normal(size=(n, 3)).astype(np.float32)
    got = tt.texture_value(ts, torch.from_numpy(tid), torch.from_numpy(u),
                           torch.from_numpy(v), torch.from_numpy(p)).numpy()
    ref = np.asarray(jt.texture_value(js, jnp.asarray(tid), jnp.asarray(u),
                                      jnp.asarray(v), jnp.asarray(p)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    texels = img.reshape(-1, 3)
    on = tid == row
    assert on.any()
    assert all((texels == got[i]).all(1).any() for i in np.flatnonzero(on))
