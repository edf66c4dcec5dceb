"""Shared fixtures for the torch-port parity tests: the same scenes built
with both packages' classes, JAX SceneData -> numpy dict, and the flip
budget of tests/test_uber.py:117-120.

JAX is imported only inside the functions that build JAX scenes, so the
GPU tests (tests/test_torch_gpu.py), which run where JAX is not
installed, can use the port's scenes and the flip budget."""

from __future__ import annotations

import contextlib
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


def noise(S, cam_mod):
    """tests/test_uber.py noise_scene: a marble-noise ground + solid, metal
    and dielectric spheres (the random scene's shape)."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0, S.Lambertian(S.Noise(0.8))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Metal((0.8, 0.8, 0.9), 0.1)),
        S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
    ], [], (0.7, 0.8, 1.0))


def fog(S, cam_mod):
    """A split-route scene: a rotated Cuboid fog and a sphere-boundary
    medium with a marble albedo, a marble sphere beside a checker ground
    (noise beside checker), glass, two quad walls and a rect light."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    lamp = S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                    S.DiffuseLight.from_color((5, 5, 5)))
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian(S.Noise(4.0))),
        S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
        S.XYRect(-3.0, 3.0, -1.0, 3.0, -7.0,
                 S.Lambertian.from_rgb(0.73, 0.73, 0.73)),
        S.YZRect(-1.0, 3.0, -7.0, -2.0, -3.0,
                 S.Metal((0.8, 0.85, 0.88), 0.05)),
        S.ConstantMedium.from_color(
            S.Translate(S.RotateY(S.Cuboid((-0.6, -0.6, -0.6),
                                           (0.6, 0.6, 0.6),
                                           S.Dielectric(1.5)), 30.0),
                        (-1.6, 0.0, -3.2)), 0.8, (0.9, 0.9, 0.9)),
        S.ConstantMedium(S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
                         1.5, S.Noise(2.0)),
        lamp,
    ], [lamp], (0.2, 0.3, 0.5))


def solid_fog(S, cam_mod):
    """The fog scene with solid textures (a checker ground of solids, no
    noise): a media scene whose bounces run on the fused bounce (TPU
    kernel F) after the unified search (M)."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    lamp = S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                    S.DiffuseLight.from_color((5, 5, 5)))
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)),
        S.XYRect(-3.0, 3.0, -1.0, 3.0, -7.0,
                 S.Lambertian.from_rgb(0.73, 0.73, 0.73)),
        S.YZRect(-1.0, 3.0, -7.0, -2.0, -3.0,
                 S.Metal((0.8, 0.85, 0.88), 0.05)),
        S.ConstantMedium.from_color(
            S.Translate(S.RotateY(S.Cuboid((-0.6, -0.6, -0.6),
                                           (0.6, 0.6, 0.6),
                                           S.Dielectric(1.5)), 30.0),
                        (-1.6, 0.0, -3.2)), 0.8, (0.9, 0.9, 0.9)),
        S.ConstantMedium.from_color(
            S.Sphere((2.2, 0, -4), 1.0, S.Dielectric(1.5)), 1.5,
            (0.2, 0.4, 0.9)),
        lamp,
    ], [lamp], (0.2, 0.3, 0.5))


def flagship_tris(S, n_tris=968):
    """``n_tris`` double-sided Lambertian triangles drawn as
    ``__graft_entry__.py:33-47`` draws the flagship's 968
    (``default_rng(0)``, the same draws in the same order), their edges in
    +-0.1 * sqrt(968 / n_tris): the flagship's total triangle area, cut
    finer for more triangles (for 968 they are the flagship's)."""
    rng = np.random.default_rng(0)
    half = np.float32(0.1 * np.sqrt(968.0 / n_tris))
    tris = []
    mat = S.Lambertian.from_rgb(0.8, 0.8, 0.8)
    for _ in range(n_tris):
        v0 = rng.uniform(-1, 1, 3).astype(np.float32)
        v0[2] -= 4.0
        e = rng.uniform(-half, half, (2, 3)).astype(np.float32)
        tris.append(S.Triangle(v0, v0 + e[0], v0 + e[1], mat,
                               double_sided=True))
    return tris


def flagship_tri_array(n_tris=968):
    """[n_tris, 3, 3] float32 vertices (v0, v1, v2) of the triangles
    :func:`flagship_tris` draws, vectorised: ``default_rng(0)`` gives each
    triangle 9 doubles in turn (``uniform(-1, 1, 3)``, then ``uniform(-h,
    h, (2, 3))``), each ``low + (high - low) * random()``, so one
    ``random((n_tris, 9))`` holds the same draws in the same order and
    the vertices are the same bit for bit."""
    r = np.random.default_rng(0).random((n_tris, 9))
    half = np.float32(0.1 * np.sqrt(968.0 / n_tris))
    v0 = (-1.0 + 2.0 * r[:, 0:3]).astype(np.float32)
    v0[:, 2] -= 4.0
    lo = -float(half)
    e = (lo + (float(half) - lo) * r[:, 3:9]).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0:3], v0 + e[:, 3:6]], axis=1)


def write_bigmesh(directory, n_tris=1 << 20) -> str:
    """Write :func:`flagship_tri_array`'s ``n_tris`` triangles into
    ``directory`` as ``bigmesh.gltf`` with its buffer in ``bigmesh.bin``
    beside it (u32 indices, one Lambertian 0.8 material; no camera, no
    light), the layout of the JAX package's scaling asset
    (``tools/bench_bigmesh.py:1-11``: an external ``.bin`` and u32
    indices). glTF triangles are single-sided (``models/gltf.py``).
    Returns the path of the ``.gltf``."""
    w = GltfWriter()
    m = w.mesh(flagship_tri_array(n_tris), w.material((0.8, 0.8, 0.8)),
               index="u32")
    w.node(mesh=m)
    return w.save(os.path.join(str(directory), "bigmesh.gltf"), form="bin")


def bigmesh(S, cam_mod, path):
    """The big-mesh workload: the triangles of :func:`write_bigmesh`'s file
    ``path`` read back by the port's ``load_gltf_scene`` (``S`` is
    ``models/scene``), framed as the mesh workload frames its triangles
    (:func:`mesh`: the flagship's camera, its sphere lamp in the world and
    the lights, the background), as ``tools/bench_bigmesh.py:56-85``
    frames the asset after loading it. At 1,048,576 triangles
    ``compile_scene`` makes 512 clusters of 2,048."""
    from rust_ray_tracer_tpu_torch.models.gltf import load_gltf_scene
    host = load_gltf_scene(str(path), 16 / 9)
    lamp = S.Sphere((3, 3, 0), 0.2, S.DiffuseLight.from_color((250,) * 3))
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 22.9, 16 / 9)
    return S.Scene(cam, list(host.world) + [lamp], [lamp],
                   (0.051, 0.051, 0.051))


def mesh(S, cam_mod, n_tris=65536):
    """The mesh workload: ``n_tris`` triangles of :func:`flagship_tris`
    plus the flagship's sphere lamp, camera and background (65,536 is the
    JAX package's ``PACKED_MIN_TRIS``, ``pallas_intersect.py:78``)."""
    tris = flagship_tris(S, n_tris)
    lamp = S.Sphere((3, 3, 0), 0.2, S.DiffuseLight.from_color((250,) * 3))
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 22.9, 16 / 9)
    return S.Scene(cam, tris + [lamp], [lamp], (0.051, 0.051, 0.051))


def earth_map(w: int, h: int, seed: int = 0) -> np.ndarray:
    """A procedural [h, w, 3] uint8 stand-in for the reference's
    ``earthmap.jpg``: blue sea, green-brown land from a few sines of
    longitude and latitude, speckled by ``default_rng(seed)``."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    lon, lat = x / w * 2.0 * np.pi, y / h * np.pi
    land = (np.sin(3.0 * lon) * np.sin(2.0 * lat)
            + 0.5 * np.sin(7.0 * lon + 1.0) * np.cos(5.0 * lat)) > 0.1
    rgb = np.where(land[..., None], (0.35, 0.5, 0.2), (0.05, 0.2, 0.6))
    rgb = rgb + 0.15 * np.random.default_rng(seed).random((h, w, 3))
    return (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_earth_map(directory, w: int, h: int) -> str:
    """Write :func:`earth_map` into ``directory`` as ``earthmap.jpg``, the
    file the builders' earth texture reads from the working directory.
    Its bytes are a PNG (the port's ``encode_png``): the decoders know a
    format by its bytes, not its name, as the reference's ``image`` crate
    does. Returns the path."""
    from rust_ray_tracer_tpu_torch.utils.image import encode_png

    path = os.path.join(str(directory), "earthmap.jpg")
    with open(path, "wb") as f:
        f.write(encode_png(earth_map(w, h)))
    return path


# where random_tris puts the flagship's triangle cloud: in front of the
# random scene's camera, where 7.3% of a 128x72 wave's primaries hit a
# triangle first
TRI_OFFSET = (4.9, 0.3, -10.6)


def random_tris(S, builders_mod, aspect):
    """The reference's random scene plus the flagship's 968 triangles
    (:func:`flagship_tris`) moved by :data:`TRI_OFFSET`: triangles beside
    1,024 sphere rows, the split route's per-kind branch (TPU kernels K
    and L for the triangles, N for the spheres)."""
    host = builders_mod.random_scene(aspect)
    return S.Scene(host.camera, list(host.world) + [
        S.Translate(flagship_tris(S), TRI_OFFSET)], host.lights,
        host.background)


def random_earth_view(S, builders_mod, aspect):
    """The reference's random scene with a second earth sphere where its
    camera looks (the first, at (4, 1, 0), is out of its view at the
    reference's pose): random's 1,024 sphere rows with an image leaf that
    primary rays hit, so ``img_data`` takes a gradient."""
    host = builders_mod.random_scene(aspect)
    earth = S.Sphere((4.9, 0.75, -14.6), 0.7, S.Lambertian(
        S.ImageTexture(path="./earthmap.jpg")))
    return S.Scene(host.camera, list(host.world) + [earth], host.lights,
                   host.background)


class GltfWriter:
    """A minimal glTF 2.0 writer for the tests and ``chip_smoke.py`` (the
    packages have none; ``tests/test_gltf.py:89-185`` writes its files by
    hand the same way): meshes of float32 positions with u16 or u32
    indices or none, optionally strided; Lambertian or metal materials;
    KHR_lights_punctual point lights; a perspective camera; a node tree
    of TRS or matrix nodes. :meth:`save` writes a .gltf with a data-URI
    buffer or an external .bin, or a .glb."""

    def __init__(self):
        self.doc = {"asset": {"version": "2.0"}, "buffers": [],
                    "bufferViews": [], "accessors": [], "meshes": [],
                    "materials": [], "nodes": [], "cameras": [],
                    "scenes": [{"nodes": []}], "scene": 0}
        self.lights = []
        self.buf = bytearray()

    def _view(self, data: bytes, stride=None) -> int:
        self.buf += b"\0" * (-len(self.buf) % 4)
        view = {"buffer": 0, "byteOffset": len(self.buf),
                "byteLength": len(data)}
        if stride is not None:
            view["byteStride"] = stride
        self.buf += data
        self.doc["bufferViews"].append(view)
        return len(self.doc["bufferViews"]) - 1

    def _accessor(self, view, ctype, count, typ) -> int:
        self.doc["accessors"].append({"bufferView": view,
                                      "componentType": ctype,
                                      "count": count, "type": typ})
        return len(self.doc["accessors"]) - 1

    def material(self, color, metallic=0.0, roughness=1.0) -> int:
        self.doc["materials"].append({"pbrMetallicRoughness": {
            "baseColorFactor": [float(c) for c in color] + [1.0],
            "metallicFactor": float(metallic),
            "roughnessFactor": float(roughness)}})
        return len(self.doc["materials"]) - 1

    def mesh(self, tris, material=None, index="u32", strided=False) -> int:
        """A mesh of one primitive: ``tris`` [T, 3, 3], each triangle's
        three vertices, stored in reverse order and indexed back by u16 or
        u32 (``index``), or in order with no index accessor (None);
        ``strided`` pads each position to 16 bytes (byteStride 16)."""
        pos = np.asarray(tris, np.float32).reshape(-1, 3)
        if index is not None:
            pos = pos[::-1]            # stored reversed, indexed back
        if strided:
            padded = np.zeros((len(pos), 4), np.float32)
            padded[:, :3] = pos
            view = self._view(padded.tobytes(), stride=16)
        else:
            view = self._view(pos.tobytes())
        prim = {"attributes": {"POSITION": self._accessor(
            view, 5126, len(pos), "VEC3")}}
        if index is not None:
            dtype, ctype = {"u16": (np.uint16, 5123),
                            "u32": (np.uint32, 5125)}[index]
            idx = np.arange(len(pos), dtype=dtype)[::-1].copy()
            prim["indices"] = self._accessor(self._view(idx.tobytes()),
                                             ctype, len(idx), "SCALAR")
        if material is not None:
            prim["material"] = material
        self.doc["meshes"].append({"primitives": [prim]})
        return len(self.doc["meshes"]) - 1

    def light(self, color, intensity) -> int:
        self.lights.append({"type": "point",
                            "color": [float(c) for c in color],
                            "intensity": float(intensity)})
        return len(self.lights) - 1

    def camera(self, yfov, aspect=None) -> int:
        persp = {"yfov": float(yfov), "znear": 0.01}
        if aspect is not None:
            persp["aspectRatio"] = float(aspect)
        self.doc["cameras"].append({"type": "perspective",
                                    "perspective": persp})
        return len(self.doc["cameras"]) - 1

    def node(self, root=True, light=None, **fields) -> int:
        """A node with ``fields`` (mesh, camera, translation, rotation,
        scale, matrix, children) and, with ``light``, that punctual light;
        listed in the scene's roots when ``root``."""
        node = {k: v for k, v in fields.items() if v is not None}
        if light is not None:
            node["extensions"] = {"KHR_lights_punctual": {"light": light}}
        self.doc["nodes"].append(node)
        i = len(self.doc["nodes"]) - 1
        if root:
            self.doc["scenes"][0]["nodes"].append(i)
        return i

    def save(self, path, form="data_uri") -> str:
        """Write ``path`` as a .gltf whose buffer is a data URI
        (``form="data_uri"``) or ``path``'s name with .bin beside it
        (``"bin"``), or as a .glb (``"glb"``). Returns ``path``."""
        import base64
        import json
        import struct

        doc = dict(self.doc)
        if self.lights:
            doc["extensions"] = {"KHR_lights_punctual": {
                "lights": self.lights}}
        data = bytes(self.buf) + b"\0" * (-len(self.buf) % 4)
        buf = {"byteLength": len(data)}
        if form == "data_uri":
            buf["uri"] = ("data:application/octet-stream;base64,"
                          + base64.b64encode(data).decode())
        elif form == "bin":
            name = os.path.splitext(os.path.basename(str(path)))[0] + ".bin"
            with open(os.path.join(os.path.dirname(str(path)), name),
                      "wb") as f:
                f.write(data)
            buf["uri"] = name
        elif form != "glb":
            raise ValueError(f"unknown form {form!r}")
        doc["buffers"] = [buf]
        text = json.dumps(doc).encode()
        if form != "glb":
            with open(path, "wb") as f:
                f.write(text)
            return str(path)
        text += b" " * (-len(text) % 4)
        with open(path, "wb") as f:
            f.write(b"glTF" + struct.pack("<II", 2, 12 + 8 + len(text) + 8
                                          + len(data))
                    + struct.pack("<I4s", len(text), b"JSON") + text
                    + struct.pack("<I4s", len(data), b"BIN\x00") + data)
        return str(path)


# the glTF flagship's point lights: (position, colour, intensity) around
# the triangle cloud (x, y in [-1, 1], z in [-5, -3]), the flagship's lamp
# first; the 9-light file takes the first nine, the 16-light one all
GLTF_LIGHTS = (
    ((3.0, 3.0, 0.0), (1.0, 1.0, 1.0), 250.0),
    ((-2.5, 1.5, -2.0), (1.0, 0.3, 0.2), 60.0),
    ((2.5, -1.0, -2.5), (0.2, 0.6, 1.0), 80.0),
    ((0.0, 2.5, -4.0), (0.9, 0.9, 0.4), 40.0),
    ((-2.0, -2.0, -3.0), (0.3, 1.0, 0.4), 50.0),
    ((1.5, 0.5, -6.5), (1.0, 0.5, 1.0), 120.0),
    ((-1.0, 0.0, -1.0), (0.6, 0.6, 0.6), 20.0),
    ((0.5, -2.5, -5.0), (1.0, 0.8, 0.1), 70.0),
    ((-3.0, 0.5, -5.5), (0.4, 0.9, 1.0), 90.0),
    ((3.0, 1.0, -4.0), (0.8, 0.2, 0.6), 35.0),
    ((-0.5, 3.0, -6.0), (0.2, 0.8, 0.8), 45.0),
    ((2.0, 2.0, -1.5), (1.0, 0.6, 0.3), 55.0),
    ((-2.5, -1.0, -6.5), (0.5, 0.5, 1.0), 65.0),
    ((0.0, -3.0, -3.0), (0.9, 0.4, 0.4), 30.0),
    ((1.0, 1.5, -7.5), (0.6, 1.0, 0.6), 100.0),
    ((-1.5, 2.5, -2.5), (1.0, 1.0, 0.7), 25.0),
)


def spread_lights(lt, n_lights):
    """``n_lights`` light rows from the m-row table ``lt`` (torch, on its
    device): row k is row k mod m with its centre (a sphere) or corner (a
    quad) moved by k // m steps of (0.05, -0.05, 0.025). Kernel I's and
    I''s checks past the glTF flagship's 9 lights take their tables from
    it."""
    import torch

    k = torch.arange(n_lights, device=lt.device)
    m = lt.shape[0]
    out = lt[k % m].clone()
    step = (k // m).to(out.dtype)[:, None] * torch.tensor(
        [0.05, -0.05, 0.025], dtype=out.dtype, device=lt.device)
    sph = out[:, 0] == TS.LIGHT_SPHERE
    out[sph, 1:4] += step[sph]
    out[~sph, 5:8] += step[~sph]
    return out


def hollow_spheres(n_rows=320, n_rays=300, seed=3):
    """A hand-made sphere table and rays for kernel N (numpy, float32):
    ``n_rows`` spheres (every third moving over [0, 1]) in the order given
    (no Morton sort), in three 128-row clusters. The first two lie in a
    [-6, 6]^3 cloud with hollow ones (r < 0) at the edges of 32-row
    groups: row 31 inside row 30's glass sphere, a lone one at row 32,
    row 160 inside row 159's; so both clusters are flagged. The third
    holds no hollow sphere, so its sub-boxes take the warps' vote: rows
    256-287 near (0, 9, 0), the rest near (0, -9, 0), and far pad rows
    past ``n_rows``. ``rays`` [9, n_rays] (o, d, time, t_min, t_max) aim
    from outside the cloud at points near its spheres' centres (the first
    30 near the hollow rows'); every seventh has an empty window (t_max
    -1), every eleventh a collapsed one (t_max = t_min). Returns (fields,
    rays): fields holds ``sph_c0``, ``sph_c1``, ``sph_t0``, ``sph_t1``,
    ``sph_r`` and the 128-row cluster boxes ``sph_cluster_min`` /
    ``sph_cluster_max`` (``models/scene.py`` ``_cluster_boxes``, the
    compiler's rule)."""
    g = np.random.default_rng(seed)
    c0 = g.uniform(-6.0, 6.0, (n_rows, 3)).astype(np.float32)
    third = np.arange(n_rows) >= 2 * TS.CLUSTER
    side = np.where(np.arange(n_rows) < 2 * TS.CLUSTER + 32, 9.0, -9.0)
    c0[third] = g.uniform(-1.5, 1.5, (int(third.sum()), 3)).astype(
        np.float32) + np.stack([0 * side, side, 0 * side], 1)[third].astype(
        np.float32)
    c1 = c0.copy()
    c1[::3] += g.uniform(-0.5, 0.5, (len(c1[::3]), 3)).astype(np.float32)
    r = g.uniform(0.2, 0.6, n_rows).astype(np.float32)
    for inner, outer in ((31, 30), (160, 159)):
        c0[inner], c1[inner] = c0[outer], c1[outer]
        r[inner] = -0.9 * r[outer]
    r[32] = -0.5
    lo = np.minimum(c0, c1) - r[:, None]
    hi = np.maximum(c0, c1) + r[:, None]
    cl_min, cl_max = TS._cluster_boxes(lo, hi, n_rows, TS.CLUSTER)
    fields = {"sph_c0": c0, "sph_c1": c1,
              "sph_t0": np.zeros(n_rows, np.float32),
              "sph_t1": np.ones(n_rows, np.float32), "sph_r": r,
              "sph_cluster_min": cl_min, "sph_cluster_max": cl_max}
    o = g.normal(size=(n_rays, 3)).astype(np.float32)
    o *= (12.0 / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    at = g.integers(0, n_rows, n_rays)
    at[:30] = [30, 31, 32, 159, 160] * 6    # the hollow rows and partners
    aim = c0[at] + g.normal(
        0.0, 0.3, (n_rays, 3)).astype(np.float32)
    d = (aim - o) * g.uniform(0.5, 2.0, (n_rays, 1)).astype(np.float32)
    time = g.uniform(0.0, 1.0, n_rays).astype(np.float32)
    t_min = np.full(n_rays, 1e-4, np.float32)
    t_max = np.full(n_rays, np.inf, np.float32)
    t_max[::7] = -1.0
    t_max[::11] = t_min[::11]
    rays = np.concatenate([o.T, d.T, time[None], t_min[None], t_max[None]])
    return fields, np.ascontiguousarray(rays, dtype=np.float32)


def enter_cases(seed=11):
    """Inputs of kernel K that reach its edges (numpy, float32): two chunks
    of 600 rays (tiles of 256, 256 and a short 88), the second chunk's
    first tile all dead; ``boxes_small`` 40 cluster boxes and
    ``boxes_large`` 300 (some inverted, some thin), and a permutation of
    the rays. Returns (rays [9, 1200], chunk, {name: (cl_min, cl_max)},
    perm [1200] int64)."""
    g = np.random.default_rng(seed)
    n, chunk = 1200, 600
    o = g.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[::13, 1] = 0.0                    # axis-parallel: |d| < 1e-12
    time = g.uniform(0.0, 1.0, n).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(g.uniform(size=n) < 0.3, 20.0, np.inf).astype(
        np.float32)
    t_max[::5] = -1.0
    t_max[chunk:chunk + 256] = -1.0     # a tile with no live ray
    rays = np.ascontiguousarray(np.concatenate(
        [o.T, d.T, time[None], t_min[None], t_max[None]]), dtype=np.float32)
    boxes = {}
    for name, k in (("boxes_small", 40), ("boxes_large", 300)):
        lo = g.uniform(-10.0, 8.0, (k, 3)).astype(np.float32)
        hi = lo + g.uniform(0.0, 3.0, (k, 3)).astype(np.float32)
        hi[::17, 0] = lo[::17, 0]       # a flat box
        lo[5], hi[5] = np.inf, -np.inf  # an inverted (empty) one
        boxes[name] = (lo, hi)
    perm = g.permutation(n).astype(np.int64)
    return rays, chunk, boxes, perm


def write_gltf_flagship(path, n_lights=9, form="data_uri") -> str:
    """The flagship as a glTF file: ``builders.procedural_flagship()``'s
    968 triangles (single-sided, as the loader builds them), one Lambertian
    material (0.8 grey, ``metallicFactor`` 0), the flagship's camera
    (identity pose, 22.9 degrees, 16:9) and the first ``n_lights`` of
    :data:`GLTF_LIGHTS` as point lights. With one light it is the
    flagship's lamp (emit 250 at (3, 3, 0)), so the file compiles to
    ``procedural_flagship()``'s tables but for the triangles'
    double-sided flag. Returns ``path``."""
    from rust_ray_tracer_tpu_torch.models import builders

    tris = [(t.v0, t.v1, t.v2)
            for t in builders.procedural_flagship().world
            if isinstance(t, TS.Triangle)]
    w = GltfWriter()
    mat = w.material((0.8, 0.8, 0.8), metallic=0.0)
    w.node(mesh=w.mesh(tris, mat))
    w.node(camera=w.camera(np.deg2rad(22.9), 16 / 9))
    for pos, color, intensity in GLTF_LIGHTS[:n_lights]:
        w.node(translation=list(pos), light=w.light(color, intensity))
    return w.save(path, form)


def cube_mesh(S, mn, mx, double_sided=True):
    """The 12-triangle cube between corners ``mn`` and ``mx`` as a Mesh
    with no material (a ConstantMedium boundary), as the JAX package's
    ``tests/test_intersect.py:293-306`` builds it."""
    mn, mx = np.asarray(mn, np.float64), np.asarray(mx, np.float64)
    corners = [(mn[0] if i & 1 == 0 else mx[0],
                mn[1] if i & 2 == 0 else mx[1],
                mn[2] if i & 4 == 0 else mx[2]) for i in range(8)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris.append((corners[a], corners[b], corners[c]))
        tris.append((corners[a], corners[c], corners[d]))
    return S.Mesh(tris, double_sided=double_sided)


def mesh_medium(S, cam_mod):
    """A Mesh-boundary fog (:func:`cube_mesh`, Translate/RotateY-wrapped
    once) beside a grey sphere and a metal tetrahedron (a world-object
    Mesh) on a checker ground, under a rect light: the split route with a
    ``MED_MESH`` medium."""
    cam = cam_mod.make_camera(EYE, 60.0, 1.0)
    lamp = S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                    S.DiffuseLight.from_color((6, 6, 6)))
    fog = S.Translate(S.RotateY(cube_mesh(S, (-0.5, -0.5, -0.5),
                                          (0.5, 0.5, 0.5)), 30.0),
                      (-0.6, 0.0, -3.6))
    tet = ((0.4, -0.9, -2.6), (1.0, -0.9, -2.9), (0.5, -0.9, -3.3),
           (0.6, -0.3, -2.9))
    return S.Scene(cam, [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((1.4, 0, -4), 0.8, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.ConstantMedium.from_color(fog, 1.2, (0.9, 0.9, 0.9)),
        S.Mesh([(tet[a], tet[b], tet[c]) for a, b, c in (
            (0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2))],
               S.Metal((0.8, 0.7, 0.6), 0.1)),
        lamp], [lamp], (0.2, 0.3, 0.5))


SMALL_SCENES = {"solid": solid, "checker": checker, "quad": quad,
                "noise": noise, "fog": fog, "solid_fog": solid_fog}


def pin_jax_texture_cache(monkeypatch):
    """Make the JAX compile_scene deterministic: its _Builder caches
    texture and material rows by id(), and a temporary SolidColor (a
    Metal's or Dielectric's albedo) or Isotropic (a ConstantMedium's
    material) is freed as soon as it is registered, so a later temporary
    can get the same id and silently reuse the wrong row, depending on the
    allocator. Holding every texture and material it sees keeps ids
    unique — the port's _Builder does the same."""
    from rust_ray_tracer_tpu.models import scene as JS

    real_tex = JS._Builder.texture_id
    real_mat = JS._Builder.material_id

    def texture_id(self, tex):
        self.__dict__.setdefault("_held", []).append(tex)
        return real_tex(self, tex)

    def material_id(self, mat):
        self.__dict__.setdefault("_held", []).append(mat)
        return real_mat(self, mat)

    monkeypatch.setattr(JS._Builder, "texture_id", texture_id)
    monkeypatch.setattr(JS._Builder, "material_id", material_id)


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


def assert_flips_arbitrated(got, ref, exact, budget=0.005):
    """:func:`assert_flip_budget` of ``got`` against ``ref`` with a float64
    render ``exact`` of the same scene and rays as the arbiter: a pixel
    of ``got`` within 1e-3 of ``exact`` on every channel is on float64's
    side of any difference from ``ref`` and is taken as ``ref``'s; the
    rest must pass the flip budget (a flip off by more than 1e-3, the
    others within rtol 3e-4 / atol 3e-5). And ``got`` may leave ``exact``
    (by the same rtol / atol) on at most 1.25x as many pixels as ``ref``
    does, plus one (``tests/test_torch_render.py``'s rule for the marble
    scenes). Returns (the flip share, the port's and ``ref``'s pixels off
    ``exact``)."""
    got, ref, exact = (np.asarray(x) for x in (got, ref, exact))
    near = (np.abs(got - exact) <= 1e-3).all(-1)
    frac = assert_flip_budget(np.where(near[..., None], ref, got), ref,
                              budget)

    def off(a):
        return int((np.abs(a - exact) > 3e-5 + 3e-4 * np.abs(exact))
                   .any(-1).sum())

    n_got, n_ref = off(got), off(ref)
    assert n_got <= 1.25 * n_ref + 1, (n_got, n_ref)
    return frac, n_got, n_ref


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


@contextlib.contextmanager
def split_recorder(plain: bool = False):
    """Inside ``with``, the split route's dispatchers — quads (TPU kernel
    O, ``ops/quad.quad_search``), hit attributes (J, ``ops/hit.hit_planes``),
    shade+update (H, ``ops/bounce.su_planes``), the tile-cluster entries
    (K, ``ops/search.tile_enter``), the unified search (M,
    ``ops/search.fused_search``), the fused bounce (F,
    ``ops/bounce.bounce_planes``), the per-kind triangle search (L,
    ``ops/search.tri_search``) and the cluster-culled sphere search (N,
    ``ops/sphere.sph_search``) and the shading of 9 or more lights (I,
    ``ops/shade.shade_planes``) — record the arguments of each call in
    the yielded dict's lists ``quad``, ``hit``, ``su``, ``enter``,
    ``search``, ``bp``, ``tri``, ``sph`` and ``shade``. They then run as
    before or, with ``plain``, run the plain versions on any device (the
    plain route on the card, to hold the kernel route against). The
    unified search's sort of the rays (``ops/search.search_order``, plain
    torch on every device) records its arguments in ``order``."""
    from rust_ray_tracer_tpu_torch.ops import bounce, bounce_core, hit, quad
    from rust_ray_tracer_tpu_torch.ops import search, shade, sphere

    rec = {"quad": [], "hit": [], "su": [], "enter": [], "search": [],
           "bp": [], "tri": [], "sph": [], "shade": [], "order": []}
    sites = ((quad, "quad_search", "quad"), (hit, "hit_planes", "hit"),
             (bounce, "su_planes", "su"), (search, "tile_enter", "enter"),
             (search, "fused_search", "search"),
             (bounce, "bounce_planes", "bp"),
             (search, "tri_search", "tri"), (sphere, "sph_search", "sph"),
             (shade, "shade_planes", "shade"),
             (search, "search_order", "order"))
    real = [getattr(mod, fn) for mod, fn, _ in sites]
    runs = real
    if plain:
        runs = [lambda sc, o, d, t_min, t_max, table=None:
                quad._quad_candidates(sc, o, d, t_min, t_max),
                hit.hit_plane_core, bounce.su_plane_core,
                search.tile_enter_plain, search.fused_search_plain,
                lambda P, pk, mk, fl, lt, n_lights:
                bounce_core.bounce_plane_core(
                    P, pk, mk, fl, lt, n_lights,
                    P.shape[0] > bounce_core.N_IN_B),
                search.tri_search_plain, sphere.sph_search_plain,
                shade.shade_plane_core, search.search_order]

    def recording(fn, key):
        def wrapped(*args):
            rec[key].append(args)
            return fn(*args)
        return wrapped

    for (mod, fn, key), f in zip(sites, runs):
        setattr(mod, fn, recording(f, key))
    try:
        yield rec
    finally:
        for (mod, fn, _), f in zip(sites, real):
            setattr(mod, fn, f)


def split_kernel_inputs(ts, w=32, h=32, depth=2, seed=7):
    """The inputs the split route gives kernels O, J, H, N and L over
    ``depth`` bounces of one w x h wave of the CPU scene ``ts``, every
    bounce's rays concatenated: {"quad": (o, d, t_min, t_max) or None,
    "hit": (planes [19, N], kind, flip), "su": (planes [40, N], mkind, lt,
    n_lights), "sph": (ray planes [9, N], table, cl_min, cl_max, n_sph,
    chunk, sub-boxes) or None, "tri": (ray planes [9, N], K's entries, search
    tables, chunk) or None}; each bounce is one chunk of w * h rays."""
    import torch

    from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
    from rust_ray_tracer_tpu_torch.utils import rng

    with split_recorder() as rec:
        render_waves(ts, w, h, rng.key(seed, "cpu"), 0, 1, depth=depth,
                     chunk_size=w * h)

    def cat(calls, i, dim):
        return torch.cat([c[i] for c in calls], dim=dim)

    quad = (tuple(cat(rec["quad"], i, 0) for i in range(1, 5))
            if rec["quad"] else None)
    hit = tuple(cat(rec["hit"], i, 1 if i == 0 else 0) for i in range(3))
    su = (cat(rec["su"], 0, 1), cat(rec["su"], 1, 0), rec["su"][0][2],
          rec["su"][0][3])
    sph = ((cat(rec["sph"], 0, 1),) + rec["sph"][0][1:]
           if rec["sph"] else None)
    tri = ((cat(rec["tri"], 0, 1), cat(rec["tri"], 1, 0))
           + rec["tri"][0][2:] if rec["tri"] else None)
    return {"quad": quad, "hit": hit, "su": su, "sph": sph, "tri": tri}


def split_cots(kind, n_su, seed):
    """Cotangents of kernel J's [12, N] and kernel H's [13, n_su] outputs,
    on ``kind``'s device: normal draws from ``seed`` (J's) and ``seed + 1``
    (H's). The sphere-UV source's (J's planes 9..11) is drawn on sphere
    lanes only, where the epilogue reads it: on the other lanes the pack is
    another primitive's, and its sphere reading is arithmetic on that
    primitive's numbers (JAX computes it alike)."""
    import torch

    from rust_ray_tracer_tpu_torch.ops.intersect import KIND_SPH

    gh = np.random.default_rng(seed).normal(
        size=(12, kind.shape[0])).astype(np.float32)
    gh[9:, kind.cpu().numpy() != KIND_SPH] = 0.0
    gs = np.random.default_rng(seed + 1).normal(
        size=(13, n_su)).astype(np.float32)
    return (torch.from_numpy(gh).to(kind.device),
            torch.from_numpy(gs).to(kind.device))
