"""The port's scene compiler and trace tables vs the JAX package's.

Integer and boolean tables must be identical, float tables within 1e-6
(they come out bitwise equal today: both sides run the same float32
numpy / elementwise arithmetic)."""

import dataclasses

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.models.scene import compile_scene as jcompile
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops import pallas_uber as pu
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import composite as tcomposite
from rust_ray_tracer_tpu_torch.models.scene import (SceneData, combine,
                                                    compile_scene, partition,
                                                    scene_from_numpy)
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves, split_reason
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import both, jax_compile, jax_flagship, scene_dict
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)


def _scenes(name, monkeypatch):
    if name == "flagship":
        return (jax_flagship(monkeypatch),
                compile_scene(tb.flagship(), device="cpu"))
    if name in BUILT:
        return (jax_compile(jb.get_scene(name, 1.0), monkeypatch),
                compile_scene(tb.get_scene(name, 1.0), device="cpu"))
    return both(name, monkeypatch)


BUILT = ("cornell_box", "cornell_triangle", "random", "perlin_spheres",
         "rect_light", "two_spheres", "earth")
SCENES = ["flagship", "cornell_box", "cornell_triangle", "solid", "checker",
          "quad", "noise", "random", "perlin_spheres", "rect_light",
          "two_spheres", "earth"]


def _assert_same(ref, got, name):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    if np.issubdtype(ref.dtype, np.floating):
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)


@pytest.mark.parametrize("name", SCENES)
def test_compile_scene_tables_match(name, monkeypatch):
    js, ts = _scenes(name, monkeypatch)
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            for k in ("c2w", "scale", "aspect", "time0", "time1"):
                _assert_same(getattr(js.camera, k), getattr(ts.camera, k),
                             f"camera.{k}")
        else:
            _assert_same(getattr(js, f.name), getattr(ts, f.name), f.name)


@pytest.mark.parametrize("name", SCENES)
def test_make_ctx_tables_match(name, monkeypatch):
    js, ts = _scenes(name, monkeypatch)
    uni, dflt, offs, search, lt, cab, ptab = pu.make_ctx(js)
    ctx = uber.make_ctx(ts)
    _assert_same(uni, ctx.uni, "uni")
    _assert_same(dflt[0], ctx.dflt, "dflt")
    assert offs == (ctx.t_off, ctx.s_off, ctx.q_off)
    # the port packs them (uber.tri_cols and [:, :9] are the plain views)
    ours = uber.tri_cols(ctx.tri_pack) + (ctx.sph_pack[:, :9],
                                          ctx.quad_pack[:, :9])
    for nm, ref, got in zip(("det_t", "u_t", "v_t", "t_t", "dbl_t", "sph",
                             "quad"), search, ours):
        _assert_same(ref, got, nm)
    _assert_same(cab, ctx.cab, "cab")
    _assert_same(lt, ctx.lt, "lt")
    assert ctx.has_noise == bool(js.perlin_vec.shape[0])
    if ctx.has_noise:           # JAX's [8, 256] plane: gradients^T, perms
        ptab = np.asarray(ptab)
        _assert_same(ptab[0:3].T, ctx.perlin.vec, "perlin vec")
        _assert_same(ptab[4:7].astype(np.int32), ctx.perlin.perm,
                     "perlin perm")
        assert not ctx.perlin.vec.requires_grad


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", ["random", "perlin_spheres", "rect_light"])
def test_perlin_tables_match_jax_for_seed(name, seed, monkeypatch):
    """compile_scene(host, seed=s) draws the JAX compile_scene(host, s)'s
    Perlin tables: the gradients, then the three permutations."""
    from tests.torch_parity import pin_jax_texture_cache

    pin_jax_texture_cache(monkeypatch)
    js = jcompile(jb.get_scene(name, 1.0), seed=seed)
    ts = compile_scene(tb.get_scene(name, 1.0), seed=seed, device="cpu")
    for f in ("perlin_vec", "perlin_px", "perlin_py", "perlin_pz"):
        _assert_same(getattr(js, f), getattr(ts, f), f)
    assert ts.perlin_vec.shape == (256, 3)
    other = compile_scene(tb.get_scene(name, 1.0), seed=seed + 1,
                          device="cpu")
    assert not torch.equal(other.perlin_px, ts.perlin_px)


def test_image_texture_without_a_file_is_yellow():
    """An ImageTexture with no path, or a path that does not exist, is solid
    yellow (texture.rs:129, JAX scene.py:530-534); the JAX compiler agrees."""
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.ops import camera as tcam

    for path in (None, "./no_such_texture_file.jpg"):
        cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
        ts = compile_scene(TS.Scene(cam, [TS.Sphere(
            (0, 0, -4), 1.0, TS.Lambertian(TS.ImageTexture(path)))], [],
            (0, 0, 0)), device="cpu")
        assert ts.tex_kind.tolist() == [TS.TEX_SOLID]
        assert ts.tex_color.tolist() == [[1.0, 1.0, 0.0]]
        jcam_ = jcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
        js = jcompile(JS.Scene(jcam_, [JS.Sphere(
            (0, 0, -4), 1.0, JS.Lambertian(JS.ImageTexture(path)))], [],
            (0, 0, 0)))
        _assert_same(js.tex_color, ts.tex_color, "tex_color")


@pytest.mark.parametrize("name", ["flagship", "cornell_box", "checker",
                                  "noise"])
def test_scene_from_numpy_equals_own_compile(name, monkeypatch):
    js, ts = _scenes(name, monkeypatch)
    got = scene_from_numpy(scene_dict(js), device="cpu")
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            for k in ("c2w", "scale", "aspect", "time0", "time1"):
                assert torch.equal(getattr(got.camera, k),
                                   getattr(ts.camera, k)), k
        else:
            a, b = getattr(got, f.name), getattr(ts, f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), f.name


@pytest.mark.parametrize("name", SCENES)
def test_uber_eligible_agrees_with_jax(name, monkeypatch):
    js, ts = _scenes(name, monkeypatch)
    assert uber.uber_eligible(ts)
    assert pu.uber_eligible(js)


def _jax_media_scene():
    cam = jcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return jcompile(JS.Scene(cam, [
        JS.Sphere((0, 0, -4), 1.0, JS.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        JS.ConstantMedium.from_color(
            JS.Sphere((0, 0, -4), 2.0, JS.Dielectric(1.5)), 0.5,
            (0.9, 0.9, 0.9)),
    ], [], (0.2, 0.3, 0.5)))


def _jax_noise_checker_scene():
    """Noise beside a checker: the JAX package sends it off the uber route
    (pallas_uber.py:1263-1264), to the shade+update kernel H."""
    cam = jcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return jcompile(JS.Scene(cam, [
        JS.Sphere((0, 0, -4), 1.0, JS.Lambertian(JS.Noise(4.0))),
        JS.Sphere((0, -101, -4), 100.0, JS.Lambertian(
            JS.Checker.from_colors((0.9, 0.1, 0.1), (0.1, 0.9, 0.1)))),
    ], [], (0.1, 0.1, 0.1)))


@pytest.mark.parametrize("make", [_jax_media_scene,
                                  _jax_noise_checker_scene])
def test_ineligible_scenes_raise_naming_the_kernel(make):
    """The trace kernel's tables refuse a scene it cannot render, naming
    TPU kernel A; media and noise beside checker textures are what the
    split route takes (``integrator.split_reason`` is None), and
    ``render_waves`` renders them there."""
    ts = scene_from_numpy(scene_dict(make()), device="cpu")
    assert not uber.uber_eligible(ts)
    assert not pu.uber_eligible(make())
    with pytest.raises(NotImplementedError, match="TPU kernel A"):
        uber.make_ctx(ts)
    assert split_reason(ts) is None
    img = render_waves(ts, 8, 8, rng.key(0, "cpu"), 0, 1, depth=2,
                       chunk_size=64)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_unported_scene_parts_raise(tmp_path, monkeypatch):
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.ops import camera as tcam

    cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    # a medium inside a Mesh boundary used to raise; the Mesh is ported,
    # and it compiles now (tests/test_torch_media.py checks its rows)
    obj = TS.ConstantMedium(TS.Mesh([((0, 0, -4), (1, 0, -4), (0, 1, -4))]),
                            0.5, TS.SolidColor((1, 1, 1)))
    ts = compile_scene(TS.Scene(cam, [obj], [], (0, 0, 0)), device="cpu")
    assert ts.med_kind.tolist() == [TS.MED_MESH]
    assert tuple(ts.med_tri.shape) == (1, 1, 10)
    # an image file that exists is decoded now (it used to raise here):
    # a file that is no image is solid yellow, as in JAX (scene.py:530-534)
    ts = compile_scene(TS.Scene(cam, [TS.Sphere(
        (0, 0, -4), 1.0, TS.Lambertian(TS.ImageTexture(__file__)))], [],
        (0, 0, 0)), device="cpu")
    assert ts.tex_kind.tolist() == [TS.TEX_SOLID]
    assert ts.tex_color.tolist() == [[1.0, 1.0, 0.0]]
    # composite reads the reference's assets and raises without them, as
    # the JAX package's does (builders.py:217-223): here from an empty
    # directory, so the test never reads the assets where they are
    monkeypatch.setattr(tcomposite, "ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tb.get_scene("composite", 1.0)
    with pytest.raises(ValueError, match="unknown scene"):
        tb.get_scene("nope", 1.0)


def test_entry_points_default_to_the_card(monkeypatch):
    """compile_scene, scene_from_numpy and rng.key place their tensors on
    the card unless the CPU is asked for, and raise without a card rather
    than fall back to the CPU."""
    from rust_ray_tracer_tpu_torch.utils import rng

    host = tb.cornell_box(1.0)
    d = scene_dict(jax_compile(jb.get_scene("cornell_box", 1.0),
                               monkeypatch))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: compile_scene(host), lambda: scene_from_numpy(d),
                 lambda: rng.key(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert compile_scene(host, device="cpu").device.type == "cpu"
    assert scene_from_numpy(d, device="cpu").device.type == "cpu"
    assert rng.key(0, "cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["solid", "checker", "noise"])
def test_partition_combine_roundtrip(name, monkeypatch):
    """partition / combine as tests/test_grad.py:153 holds the JAX pair:
    every float field (the camera's under camera.*) in params, the rest in
    static, and combine gives the scene back field for field."""
    _, ts = both(name, monkeypatch)
    params, static = partition(ts)
    assert "camera.c2w" in params and "camera.scale" in params
    assert all(v.is_floating_point() for v in params.values())
    assert not any(v.is_floating_point() for v in static.values())
    back = combine(params, static)
    for f in dataclasses.fields(SceneData):
        a, b = getattr(ts, f.name), getattr(back, f.name)
        if f.name == "camera":
            for k in ("c2w", "scale", "aspect", "time0", "time1"):
                assert getattr(a, k) is getattr(b, k)
        else:
            assert a is b, f.name
