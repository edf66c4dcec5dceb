"""Built-in procedural scenes.

Counterpart of ``rust_ray_tracer_tpu/models/builders.py``: the eight
reference scenes (``builders.py:51-217``) — ``random``, ``two_spheres``,
``perlin_spheres``, ``earth``, ``rect_light``, ``cornell_box``,
``cornell_triangle`` and ``final_scene`` — with the same content, camera
poses (``look_at_rh`` fed as camera-to-world, the reference quirk) and
light lists; ``random`` and ``final_scene`` draw their layouts with the
same ``np.random.default_rng(seed)`` sequences; and ``composite``
(``models/composite.py``), which reads the reference's assets and raises
``FileNotFoundError`` without them. Plus :func:`flagship`, the scene of
``__graft_entry__._flagship_scene``: ``suzanne.gltf`` where the
reference's assets are, else :func:`procedural_flagship` (968 random
triangles and a sphere lamp, drawn with the same
``np.random.default_rng(0)`` sequence), so the port reaches the bench
workload without importing JAX.
"""

from __future__ import annotations

import os

import numpy as np

from rust_ray_tracer_tpu_torch.models import composite
from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.ops.camera import look_at_rh, make_camera

_SKY = (0.7, 0.8, 1.0)


def _camera(lookfrom, lookat, vfov, aspect, time0=0.0, time1=1.0):
    c2w = look_at_rh(lookfrom, lookat, (0.0, 1.0, 0.0))
    return make_camera(c2w, vfov, aspect, time0, time1)


def _earth_texture():
    # ImageTexture::from_file("./earthmap.jpg"), read from the working
    # directory when the scene compiles; without the file (the reference
    # repo ships none) it is solid yellow (texture.rs:129).
    return S.ImageTexture(path="./earthmap.jpg")


def random_scene(aspect: float, seed: int = 0) -> S.Scene:
    """`random_scene` + Random camera wiring (scene.rs:33-92,411-426): a
    Noise(4) ground, up to 900 small spheres (moving Lambertian, metal,
    dielectric) and three large ones, a bright sky, no lights."""
    rng = np.random.default_rng(seed)
    world: list = []
    world.append(S.Sphere((0, -1000, 0), 1000.0,
                          S.Lambertian(S.Noise(4.0))))
    comp = np.array([4.0, 0.2, 0.0])
    for a in range(-15, 15):
        for b in range(-15, 15):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()], np.float32)
            if np.linalg.norm(center - comp) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3).astype(np.float32)
                c1 = center + np.array([0, rng.uniform(0, 0.5), 0],
                                       np.float32)
                world.append(S.MovingSphere(center, c1, 0.0, 1.0, 0.2,
                                            S.Lambertian.from_color(albedo)))
            elif choose_mat < 0.95:
                albedo = rng.random(3).astype(np.float32)
                world.append(S.Sphere(center, 0.2,
                                      S.Metal(albedo, rng.uniform(0, 0.5))))
            else:
                world.append(S.Sphere(center, 0.2, S.Dielectric(1.5)))
    world.append(S.Sphere((-4, 1, 0), 1.0,
                          S.Lambertian.from_rgb(0.4, 0.2, 0.1)))
    world.append(S.Sphere((0, 1, 0), 1.0, S.Dielectric(1.5)))
    world.append(S.Sphere((4, 1, 0), 1.0, S.Lambertian(_earth_texture())))
    cam = _camera((13, -2, 3), (0, 0, 0), 20.0, aspect)
    return S.Scene(camera=cam, world=world, lights=[], background=_SKY)


def two_spheres(aspect: float, seed: int = 0) -> S.Scene:
    """scene.rs:94-121,427-441: a checker sphere under a sphere checkered
    with the earth texture (solid yellow without ``./earthmap.jpg``)."""
    world = [
        S.Sphere((0, -10, 0), 10.0,
                 S.Lambertian(S.Checker.from_colors((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9)))),
        S.Sphere((0, 10, 0), 10.0,
                 S.Lambertian(S.Checker(_earth_texture(), _earth_texture()))),
    ]
    cam = _camera((13, -2, 3), (0, 0, 0), 40.0, aspect)
    return S.Scene(camera=cam, world=world, lights=[], background=_SKY)


def perlin_spheres(aspect: float, seed: int = 0) -> S.Scene:
    """scene.rs:123-141,442-456: two spheres sharing one Noise(4)."""
    pertex = S.Noise(4.0)
    world = [
        S.Sphere((0, -1000, 0), 1000.0, S.Lambertian(pertex)),
        S.Sphere((0, 1, 0), 1.0, S.Lambertian(pertex)),
    ]
    cam = _camera((13, -2, 7), (0, 0, 0), 20.0, aspect)
    return S.Scene(camera=cam, world=world, lights=[], background=_SKY)


def earth(aspect: float, seed: int = 0) -> S.Scene:
    """scene.rs:144-153,457-471: one sphere with the earth texture."""
    world = [S.Sphere((0, 0, 0), 2.0, S.Lambertian(_earth_texture()))]
    cam = _camera((13, -2, 3), (0, 0, 0), 20.0, aspect)
    return S.Scene(camera=cam, world=world, lights=[], background=_SKY)


def rect_light(aspect: float, seed: int = 0) -> S.Scene:
    """`simple_light` + RectLight wiring (scene.rs:155-189,472-495)."""
    diff_light = S.DiffuseLight.from_color((4, 4, 4))
    world = [
        S.Sphere((0, -1000, 0), 1000.0, S.Lambertian(S.Noise(4.0))),
        S.Sphere((0, 2, 0), 2.0, S.Metal((0.5, 0.5, 0.5), 0.1)),
        S.XYRect(3.0, 5.0, 1.0, 3.0, -2.0, diff_light),
        S.Sphere((0, 6, 0), 1.0, diff_light),
    ]
    # the light list holds an XYRect — which has NO pdf/random impl in the
    # reference (only XZRect does, aarect.rs:123-143) -> LIGHT_NULL semantics
    lights = [S.XYRect(3.0, 5.0, 1.0, 3.0, -2.0,
                       S.DiffuseLight.from_color((1, 1, 1)))]
    cam = _camera((26, -6, 6), (0, -2, 0), 20.0, aspect)
    return S.Scene(camera=cam, world=world, lights=lights,
                   background=(0, 0, 0))


def _cornell_walls(light_flipped: bool):
    red = S.Lambertian.from_rgb(0.65, 0.05, 0.05)
    green = S.Lambertian.from_rgb(0.12, 0.45, 0.15)
    white = S.Lambertian.from_rgb(0.73, 0.73, 0.73)
    light = S.DiffuseLight.from_color((15, 15, 15))
    lamp = S.XZRect(213.0, 343.0, 227.0, 332.0, 554.0, light)
    walls = [
        S.YZRect(0.0, 555.0, 0.0, 555.0, 555.0, green),
        S.YZRect(0.0, 555.0, 0.0, 555.0, 0.0, red),
        S.FlipFace(lamp) if light_flipped else lamp,
        S.XZRect(0.0, 555.0, 0.0, 555.0, 0.0, white),
        S.XZRect(0.0, 555.0, 0.0, 555.0, 555.0, white),
        S.XYRect(0.0, 555.0, 0.0, 555.0, 555.0, white),
    ]
    return walls, white


def cornell_box(aspect: float, seed: int = 0) -> S.Scene:
    """scene.rs:192-246,496-519 (lamp FlipFace-wrapped in the world)."""
    world, white = _cornell_walls(light_flipped=True)
    world.append(S.Translate(
        S.RotateY(S.Cuboid((0, 0, 0), (165, 330, 165), white), 15.0),
        (265, 0, 295)))
    world.append(S.Translate(
        S.RotateY(S.Cuboid((0, 0, 0), (165, 165, 165), white), -18.0),
        (130, 0, 65)))
    lights = [S.XZRect(213.0, 343.0, 227.0, 332.0, 554.0,
                       S.DiffuseLight.from_color((15, 15, 15)))]
    cam = _camera((278, -278, -800), (278, -278, 0), 40.0, aspect)
    return S.Scene(camera=cam, world=world, lights=lights,
                   background=(0, 0, 0))


def cornell_triangle(aspect: float, seed: int = 0) -> S.Scene:
    """scene.rs:249-286,520-543 (lamp NOT flipped in this variant)."""
    world, _white = _cornell_walls(light_flipped=False)
    world.append(S.Triangle((250, 0, 400), (100, 150, 400), (400, 150, 400),
                            S.Metal((0.8, 0.85, 0.88), 0.0)))
    lights = [S.XZRect(213.0, 343.0, 227.0, 332.0, 554.0,
                       S.DiffuseLight.from_color((15, 15, 15)))]
    cam = _camera((278, -278, -800), (278, -278, 0), 40.0, aspect)
    return S.Scene(camera=cam, world=world, lights=lights,
                   background=(0, 0, 0))


def final_scene(aspect: float, seed: int = 0) -> S.Scene:
    """scene.rs:288-391,544-562, the book-2 cover: 225 ground boxes of
    random height (1,350 quads), a lamp rect, a moving sphere, glass, a
    fuzzy metal, a glass ball holding a blue medium (r = 70, density
    0.2), a thin fog around everything (r = 5000, density 1e-4, the
    camera inside), the earth sphere, a Noise(2) sphere and a rotated
    cluster of ten white spheres. Its light list holds a FlipFace rect,
    which has no sampling in the reference: LIGHT_NULL."""
    rng = np.random.default_rng(seed)
    world: list = []
    ground = S.Lambertian.from_rgb(0.48, 0.83, 0.53)
    for i in range(15):
        for j in range(15):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = rng.uniform(1.0, 101.0)
            world.append(S.Cuboid((x0, 0.0, z0), (x0 + w, y1, z0 + w),
                                  ground))
    world.append(S.XZRect(123.0, 423.0, 147.0, 412.0, 554.0,
                          S.DiffuseLight.from_color((7, 7, 7))))
    world.append(S.MovingSphere((400, 400, 200), (430, 400, 200), 0.0, 1.0,
                                50.0, S.Lambertian.from_rgb(0.7, 0.3, 0.1)))
    world.append(S.Sphere((260, 150, 45), 45.0, S.Dielectric(1.5)))
    world.append(S.Sphere((0, 150, 145), 50.0,
                          S.Metal((0.8, 0.8, 0.9), 1.0)))
    boundary = S.Sphere((360, 150, 145), 70.0, S.Dielectric(1.5))
    world.append(boundary)
    world.append(S.ConstantMedium.from_color(boundary, 0.2, (0.2, 0.4, 0.9)))
    fog = S.Sphere((0, 0, 0), 5000.0, S.Dielectric(1.5))
    world.append(S.ConstantMedium(fog, 0.0001, _earth_texture()))
    world.append(S.Sphere((400, 200, 400), 100.0,
                          S.Lambertian(_earth_texture())))
    world.append(S.Sphere((220, 280, 200), 80.0,
                          S.Lambertian(S.Noise(2.0))))
    white = S.Lambertian.from_rgb(0.73, 0.73, 0.73)
    cluster = [S.Sphere(rng.uniform(0.0, 165.0, 3).astype(np.float32), 10.0,
                        white) for _ in range(10)]
    world.append(S.Translate(S.RotateY(cluster, 15.0), (-100, 270, 395)))
    lights = [S.FlipFace(S.XZRect(123.0, 423.0, 147.0, 412.0, 554.0,
                                  S.DiffuseLight.from_color((0, 0, 0))))]
    cam = _camera((478, -278, -600), (278, -278, 0), 40.0, aspect)
    return S.Scene(camera=cam, world=world, lights=lights,
                   background=(0, 0, 0))


def flagship() -> S.Scene:
    """The bench workload's scene (``__graft_entry__.py:20-47``):
    ``suzanne.gltf`` at 16:9 where the reference's assets are
    (``composite.ASSETS``), else :func:`procedural_flagship`."""
    path = os.path.join(composite.ASSETS, "suzanne.gltf")
    if os.path.exists(path):
        from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
        return load_gltf_scene(path, 16 / 9)
    return procedural_flagship()


def procedural_flagship() -> S.Scene:
    """The flagship without the assets: 968 random double-sided triangles
    in front of the camera plus a sphere lamp, Lambertian + DiffuseLight,
    16:9 (``__graft_entry__.py:33-47``, same draws in the same order)."""
    rng = np.random.default_rng(0)
    tris = []
    mat = S.Lambertian.from_rgb(0.8, 0.8, 0.8)
    for _ in range(968):
        v0 = rng.uniform(-1, 1, 3).astype(np.float32)
        v0[2] -= 4.0
        e = rng.uniform(-0.1, 0.1, (2, 3)).astype(np.float32)
        tris.append(S.Triangle(v0, v0 + e[0], v0 + e[1], mat,
                               double_sided=True))
    lamp = S.Sphere((3, 3, 0), 0.2, S.DiffuseLight.from_color((250,) * 3))
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 22.9, 16 / 9)
    return S.Scene(cam, tris + [lamp], [lamp], (0.051, 0.051, 0.051))


_BUILDERS = {
    "random": random_scene,
    "two_spheres": two_spheres,
    "perlin_spheres": perlin_spheres,
    "earth": earth,
    "rect_light": rect_light,
    "cornell_box": cornell_box,
    "cornell_triangle": cornell_triangle,
    "final_scene": final_scene,
    "composite": lambda aspect, seed=0: composite.composite_scene(
        aspect, seed, assets_dir=composite.ASSETS),
}


def get_scene(name: str, aspect: float, seed: int = 0) -> S.Scene:
    """Build a named scene (``get_scene``, scene.rs:406)."""
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scene {name!r}; one of {sorted(_BUILDERS)}") from None
    return builder(aspect, seed)
