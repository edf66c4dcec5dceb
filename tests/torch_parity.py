"""Shared fixtures for the torch-port parity tests: the same scenes built
with both packages' classes, JAX SceneData -> numpy dict, and the flip
budget of tests/test_uber.py:117-120.

JAX is imported only inside the functions that build JAX scenes, so the
GPU tests (tests/test_torch_gpu.py), which run where JAX is not
installed, can use the port's scenes and the flip budget."""

from __future__ import annotations

import os

import numpy as np

from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.ops import camera as tcam

EYE = np.eye(3, 4, dtype=np.float32)


def solid(S, cam_mod, checker=False):
    """tests/test_uber.py solid_scene (spheres of three materials, a
    double-sided triangle, a rect light); ``checker`` textures the
    triangle ground."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    ground = (S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                 (0.1, 0.9, 0.1)))
              if checker else S.Lambertian.from_rgb(0.7, 0.7, 0.7))
    world = [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Dielectric(1.5)),
        S.Sphere((2.2, 0, -4), 1.0, S.Metal((0.9, 0.8, 0.7), 0.2)),
        S.Triangle((-3, -1.2, -2), (3, -1.2, -2), (0, -1.2, -8), ground,
                   double_sided=True),
        S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                 S.DiffuseLight.from_color((5, 5, 5))),
    ]
    return S.Scene(cam, world, [world[-1]], (0.2, 0.3, 0.5))


def checker(S, cam_mod):
    """tests/test_uber.py checker_scene: checker ground + solid, metal and
    moving dielectric spheres."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Metal((0.8, 0.8, 0.9), 0.1)),
        S.MovingSphere((2.2, 0, -4), (2.4, 0.2, -4), 0.0, 1.0, 1.0,
                       S.Dielectric(1.5)),
    ], [], (0.7, 0.8, 1.0))


def quad(S, cam_mod):
    """tests/test_uber.py quad_scene: Cornell-ish quads, FlipFace light."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    world = [
        S.XZRect(-2.0, 2.0, -6.0, -2.0, -2.0,
                 S.Lambertian.from_rgb(0.73, 0.73, 0.73)),
        S.YZRect(-2.0, 2.0, -6.0, -2.0, -2.0,
                 S.Lambertian.from_rgb(0.12, 0.45, 0.15)),
        S.YZRect(-2.0, 2.0, -6.0, -2.0, 2.0,
                 S.Lambertian.from_rgb(0.65, 0.05, 0.05)),
        S.XYRect(-2.0, 2.0, -2.0, 2.0, -6.0,
                 S.Lambertian.from_rgb(0.73, 0.73, 0.73)),
        S.FlipFace(S.XZRect(-0.8, 0.8, -4.8, -3.2, 2.0,
                            S.DiffuseLight.from_color((7, 7, 7)))),
    ]
    return S.Scene(cam, world, [world[-1]], (0.0, 0.0, 0.0))


SMALL_SCENES = {"solid": solid, "checker": checker, "quad": quad}


def pin_jax_texture_cache(monkeypatch):
    """Make the JAX compile_scene deterministic: its _Builder caches
    texture rows by id(), and a temporary SolidColor (a Metal's or
    Dielectric's albedo) is freed as soon as it is registered, so a later
    temporary can get the same id and silently reuse the wrong texture
    row, depending on the allocator. Holding every texture it sees keeps
    ids unique — the port's _Builder does the same."""
    from rust_ray_tracer_tpu.models import scene as JS

    real = JS._Builder.texture_id

    def texture_id(self, tex):
        self.__dict__.setdefault("_held", []).append(tex)
        return real(self, tex)

    monkeypatch.setattr(JS._Builder, "texture_id", texture_id)


def jax_compile(host, monkeypatch):
    from rust_ray_tracer_tpu.models.scene import compile_scene as jcompile
    pin_jax_texture_cache(monkeypatch)
    return jcompile(host)


def torch_scene(name):
    """The port's SceneData of a SMALL_SCENES entry."""
    from rust_ray_tracer_tpu_torch.models.scene import compile_scene
    return compile_scene(SMALL_SCENES[name](TS, tcam), device="cpu")


def both(name, monkeypatch):
    """(JAX SceneData, torch SceneData) of a SMALL_SCENES entry."""
    from rust_ray_tracer_tpu.models import scene as JS
    from rust_ray_tracer_tpu.ops import camera as jcam
    return (jax_compile(SMALL_SCENES[name](JS, jcam), monkeypatch),
            torch_scene(name))


def jax_flagship(monkeypatch):
    """__graft_entry__._flagship_scene's procedural scene, even where the
    suzanne asset happens to exist."""
    import __graft_entry__

    pin_jax_texture_cache(monkeypatch)
    real_exists = os.path.exists
    monkeypatch.setattr(os.path, "exists",
                        lambda p: False if str(p).endswith("suzanne.gltf")
                        else real_exists(p))
    try:
        return __graft_entry__._flagship_scene()
    finally:
        monkeypatch.setattr(os.path, "exists", real_exists)


def scene_dict(sd) -> dict:
    """JAX SceneData -> {field: numpy}, camera fields as camera.<name>."""
    d = {f: np.asarray(getattr(sd, f)) for f in sd._fields if f != "camera"}
    d.update({f"camera.{k}": np.asarray(v)
              for k, v in sd.camera._asdict().items()})
    return d


def assert_flip_budget(got, ref, budget=0.005):
    """tests/test_uber.py:117-120: at most ``budget`` of the pixels may
    have a channel off by more than 1e-3 (a path forked on a near-tie);
    the rest match to rtol 3e-4 / atol 3e-5 (fp reassociation)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all()
    flips = (np.abs(got - ref) > 1e-3).any(-1)
    assert flips.mean() <= budget, flips.sum()
    np.testing.assert_allclose(np.where(flips[..., None], ref, got), ref,
                               rtol=3e-4, atol=3e-5)
    return flips.mean()


def assert_scaled_close(got, ref, rtol, atol, axis, budget=0.0, what=""):
    """``|got - ref| <= atol + rtol * scale`` with ``scale`` the largest
    ``|ref|`` along ``axis`` (a ray's planes, a table row's columns): an
    adjoint that sums cancelling terms carries their rounding at the
    scale of the largest term. At most ``budget`` of the lanes along the
    other axis may fall outside — a branch of the recomputed forward
    (tir, metal_ok, a checker parity, a near-root sphere hit) flipped by
    an FMA. Returns that share."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    scale = np.abs(ref).max(axis=axis, keepdims=True)
    bad = (np.abs(got - ref) > atol + rtol * scale).any(axis=axis)
    frac = float(bad.mean())
    assert frac <= budget, (
        f"{what}: {int(bad.sum())} of {bad.size} lanes outside rtol {rtol} "
        f"(of the lane's largest value) / atol {atol}")
    return frac


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
