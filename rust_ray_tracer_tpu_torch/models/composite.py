"""The config-5 composite scene: multi-mesh + procedural geometry.

Counterpart of ``rust_ray_tracer_tpu/models/composite.py`` (all of it), on
the port's scene classes, camera and glTF importer (``models/gltf.py``):
``suzanne.gltf`` (968 triangles) on a pedestal, ``n_spheres`` complete
MetalRoughSpheres PBR spheres (10,600 triangles each), a checkered ground
sphere, glass, fuzzy-metal and Perlin balls and an importance-sampled
overhead XZRect light, under a true camera-to-world pose (this scene is
not a reference-parity reproduction, so it does not inherit the
``look_at_rh``-as-c2w quirk of the eight builders).

It reads the reference's assets (:data:`ASSETS`) and raises
``FileNotFoundError`` without them, as the JAX package's does
(``builders.py:217-223``); the port fetches no assets, so it renders only
where they are mounted.
"""

from __future__ import annotations

import os

import numpy as np

from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.ops.camera import make_camera

# the reference checkout's asset directory, where the JAX package's
# composite.py reads it (``composite.py:36``)
ASSETS = os.path.join(os.sep, "root", "reference", "assets")

# complete metal spheres of the MetalRoughSpheres grid: (start, n_tris)
# triangle ranges in glTF order plus their grid row/col for placement.
_SPHERE_TRIS = 10600


def _true_c2w(eye, center, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """An actual camera-to-world [3,4] (columns right/up/backward, eye)."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    return np.concatenate(
        [np.stack([s, u, -f], axis=1), eye[:, None]], axis=1
    ).astype(np.float32)


def _place(objs, scale: float, offset) -> list:
    """Uniform-scale + translate glTF world objects (compile-time baking,
    same contract as Translate/RotateY — scene.py transforms). Handles
    Triangles and the emissive Spheres the importer synthesizes for
    KHR_lights_punctual point lights (gltf.py:215)."""
    offset = np.asarray(offset, np.float32)
    out = []
    for t in objs:
        if isinstance(t, S.Sphere):
            out.append(S.Sphere(
                np.asarray(t.center, np.float32) * scale + offset,
                float(t.radius) * scale, t.material))
        else:
            out.append(S.Triangle(
                np.asarray(t.v0, np.float32) * scale + offset,
                np.asarray(t.v1, np.float32) * scale + offset,
                np.asarray(t.v2, np.float32) * scale + offset,
                t.material, t.double_sided))
    return out


def _metal_sphere_blocks(world, n_spheres: int):
    """Yield ``n_spheres`` complete spheres (as triangle lists) from the
    MetalRoughSpheres world, preferring distinct materials.

    The grid interleaves non-sphere geometry (labels etc.); complete
    spheres are runs of exactly _SPHERE_TRIS triangles sharing one
    material, so scan by material identity.
    """
    runs = []
    i, n = 0, len(world)
    while i < n and len(runs) < n_spheres * 3:
        m = world[i].material
        j = i
        while j < n and world[j].material is m:
            j += 1
        if j - i == _SPHERE_TRIS:
            runs.append(world[i:j])
        i = j
    # spread picks across the grid so materials vary (roughness sweep)
    if len(runs) <= n_spheres:
        return runs
    idx = np.linspace(0, len(runs) - 1, n_spheres).round().astype(int)
    return [runs[k] for k in sorted(set(int(x) for x in idx))]


def composite_scene(aspect: float, seed: int = 0, n_spheres: int = 4,
                    assets_dir: str = ASSETS) -> S.Scene:
    """Build the config-5 composite scene.

    Args:
      aspect: image aspect ratio (1080p -> 16/9).
      seed: layout seed for the procedural prop jitter.
      n_spheres: how many complete MetalRoughSpheres PBR spheres to
        include (4 -> ~43k tris for CPU tests; 49 -> the full grid's
        ~520k for the TPU bench).
      assets_dir: directory holding suzanne.gltf + MetalRoughSpheres/.

    Raises FileNotFoundError if the assets are absent (tests skip).
    """
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene

    suz_path = os.path.join(assets_dir, "suzanne.gltf")
    mrs_path = os.path.join(assets_dir, "MetalRoughSpheres",
                            "MetalRoughSpheres.gltf")
    for p in (suz_path, mrs_path):
        if not os.path.exists(p):
            raise FileNotFoundError(p)

    rng = np.random.default_rng(seed)
    world: list = []

    # ground: giant checker sphere (two_spheres vocabulary, scene.rs:95)
    checker = S.Checker(S.SolidColor((0.2, 0.3, 0.1)),
                        S.SolidColor((0.9, 0.9, 0.9)))
    world.append(S.Sphere((0.0, -1000.0, 0.0), 1000.0,
                          S.Lambertian(checker)))

    # suzanne, centre stage (968 tris; keeps its glTF PBR material)
    suz = load_gltf_scene(suz_path, aspect)
    world += _place(suz.world, 1.4, (0.0, 1.55, 0.0))

    # pedestal under suzanne (Cuboid, cornell vocabulary scene.rs:228)
    world.append(S.Cuboid((-0.9, 0.0, -0.9), (0.9, 0.55, 0.9),
                          S.Lambertian.from_rgb(0.73, 0.73, 0.73)))

    # a row of complete PBR metal spheres behind the stage
    mrs = load_gltf_scene(mrs_path, aspect)
    blocks = _metal_sphere_blocks(mrs.world, n_spheres)
    if not blocks:
        raise ValueError("no complete metal spheres found in asset")
    # each sphere is ~0.8 units radius at scale s (native radius .0004)
    s_scale = 0.8 / 0.0004
    n_b = len(blocks)
    for bi, block in enumerate(blocks):
        # native center ~ block centroid; cheap estimate from bounds
        vs = np.array([t.v0 for t in block[::53]], np.float32)
        c_native = (vs.min(0) + vs.max(0)) / 2
        x = (bi - (n_b - 1) / 2) * 2.0
        jitter = rng.uniform(-0.15, 0.15, 2)
        target = np.array([x + jitter[0], 0.8, -3.0 + jitter[1]],
                          np.float32)
        out = []
        for t in block:
            out.append(S.Triangle(
                (np.asarray(t.v0, np.float32) - c_native) * s_scale
                + target,
                (np.asarray(t.v1, np.float32) - c_native) * s_scale
                + target,
                (np.asarray(t.v2, np.float32) - c_native) * s_scale
                + target,
                t.material, t.double_sided))
        world += out

    # procedural props (random_scene vocabulary, scene.rs:69-82)
    world.append(S.Sphere((2.3, 0.8, 1.2), 0.8, S.Dielectric(1.5)))
    world.append(S.Sphere((-2.3, 0.8, 1.0), 0.8,
                          S.Metal((0.7, 0.6, 0.5), 0.05)))
    world.append(S.Sphere((0.0, 0.65, 2.6), 0.65,
                          S.Lambertian(S.Noise(3.0))))

    # overhead area light, importance-sampled (rect_light, scene.rs:150)
    lamp = S.XZRect(-2.5, 2.5, -4.0, 1.0, 7.5,
                    S.DiffuseLight.from_color((6.0, 6.0, 6.0)))
    world.append(S.FlipFace(lamp))
    # sampled light entry: separate instance, cornell_box pattern
    # (builders.py cornell_box — geometry only, emission unused)
    lights = [S.XZRect(-2.5, 2.5, -4.0, 1.0, 7.5,
                       S.DiffuseLight.from_color((1.0, 1.0, 1.0)))]

    cam = make_camera(_true_c2w((0.0, 2.6, 7.5), (0.0, 1.3, -0.5)),
                      38.0, aspect)
    return S.Scene(camera=cam, world=world, lights=lights,
                   background=(0.02, 0.02, 0.035))
