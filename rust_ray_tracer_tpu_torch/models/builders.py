"""Built-in procedural scenes.

Counterpart of ``rust_ray_tracer_tpu/models/builders.py``: ``cornell_box``
and ``cornell_triangle`` (``builders.py:134-176``) with the same content,
camera poses (``look_at_rh`` fed as camera-to-world, the reference quirk)
and light lists, plus :func:`flagship` — the procedural scene of
``__graft_entry__._flagship_scene`` (968 random triangles and a sphere
lamp) drawn with the same ``np.random.default_rng(0)`` sequence, so the
port reaches the bench workload without importing JAX.

The other reference scene names are recognised and raise
``NotImplementedError`` naming the ROADMAP item that ports what they need.
"""

from __future__ import annotations

import numpy as np

from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.ops.camera import look_at_rh, make_camera

# scene -> (what it needs, ROADMAP queue 1 item that ports it)
_NOT_PORTED = {
    "random": ("noise and image textures", "9"),
    "two_spheres": ("image textures", "12"),
    "perlin_spheres": ("noise textures", "9"),
    "earth": ("image textures", "12"),
    "rect_light": ("noise textures", "9"),
    "final_scene": ("media, noise and image textures", "11"),
    "composite": ("glTF meshes", "4"),
}


def _camera(lookfrom, lookat, vfov, aspect, time0=0.0, time1=1.0):
    c2w = look_at_rh(lookfrom, lookat, (0.0, 1.0, 0.0))
    return make_camera(c2w, vfov, aspect, time0, time1)


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


def flagship() -> S.Scene:
    """The bench workload's scene: 968 random double-sided triangles in
    front of the camera plus a sphere lamp, Lambertian + DiffuseLight,
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
    "cornell_box": cornell_box,
    "cornell_triangle": cornell_triangle,
}


def get_scene(name: str, aspect: float, seed: int = 0) -> S.Scene:
    """Build a named scene (``get_scene``, scene.rs:406)."""
    if name in _NOT_PORTED:
        what, item = _NOT_PORTED[name]
        raise NotImplementedError(
            f"scene {name!r} needs {what}, not ported to the torch package "
            f"yet (ROADMAP queue 1 item {item})")
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scene {name!r}; one of "
            f"{sorted(_BUILDERS) + sorted(_NOT_PORTED)}") from None
    return builder(aspect, seed)
