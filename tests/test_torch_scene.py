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
from rust_ray_tracer_tpu_torch.models.scene import (SceneData, combine,
                                                    compile_scene, partition,
                                                    scene_from_numpy)
from rust_ray_tracer_tpu_torch.ops import uber

from tests.torch_parity import both, jax_compile, jax_flagship, scene_dict


def _scenes(name, monkeypatch):
    if name == "flagship":
        return (jax_flagship(monkeypatch),
                compile_scene(tb.flagship(), device="cpu"))
    if name in ("cornell_box", "cornell_triangle"):
        return (jax_compile(jb.get_scene(name, 1.0), monkeypatch),
                compile_scene(tb.get_scene(name, 1.0), device="cpu"))
    return both(name, monkeypatch)


SCENES = ["flagship", "cornell_box", "cornell_triangle", "solid", "checker",
          "quad"]


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
    uni, dflt, offs, search, lt, cab, _ = pu.make_ctx(js)
    ctx = uber.make_ctx(ts)
    _assert_same(uni, ctx.uni, "uni")
    _assert_same(dflt[0], ctx.dflt, "dflt")
    assert offs == (ctx.t_off, ctx.s_off, ctx.q_off)
    for nm, ref in zip(("det_t", "u_t", "v_t", "t_t", "dbl_t", "sph",
                        "quad"), search):
        _assert_same(ref, getattr(ctx, nm), nm)
    _assert_same(cab, ctx.cab, "cab")
    _assert_same(lt, ctx.lt, "lt")


@pytest.mark.parametrize("name", ["flagship", "cornell_box", "checker"])
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


def _jax_noise_scene():
    cam = jcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return jcompile(JS.Scene(cam, [
        JS.Sphere((0, 0, -4), 1.0, JS.Lambertian(JS.Noise(4.0))),
    ], [], (0.1, 0.1, 0.1)))


@pytest.mark.parametrize("make,kernel", [(_jax_media_scene, "F and M"),
                                         (_jax_noise_scene, "C")])
def test_ineligible_scenes_raise_naming_the_kernel(make, kernel):
    ts = scene_from_numpy(scene_dict(make()), device="cpu")
    assert not uber.uber_eligible(ts)
    with pytest.raises(NotImplementedError, match=f"TPU kernels? {kernel}"):
        uber.make_ctx(ts)


def test_unported_scene_parts_raise():
    from rust_ray_tracer_tpu_torch.models import scene as TS
    from rust_ray_tracer_tpu_torch.ops import camera as tcam

    cam = tcam.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    for obj in (TS.Sphere((0, 0, -4), 1.0, TS.Lambertian(TS.Noise(4.0))),
                TS.ConstantMedium(TS.Sphere((0, 0, -4), 1.0,
                                            TS.Dielectric(1.5)), 0.5,
                                  TS.SolidColor((1, 1, 1)))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compile_scene(TS.Scene(cam, [obj], [], (0, 0, 0)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.get_scene("final_scene", 1.0)
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


@pytest.mark.parametrize("name", ["solid", "checker"])
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
