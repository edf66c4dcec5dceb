"""Scene description and its compilation to flat structure-of-arrays tensors.

Counterpart of ``rust_ray_tracer_tpu/models/scene.py``: the same host-side
object API (Sphere, MovingSphere, Triangle, Quad and the XY/XZ/YZ rects,
Cuboid, Translate, RotateY, FlipFace, the five materials, Solid, Checker,
Noise and Image textures) and the same ``compile_scene``
(``scene.py:755``), which bakes instance transforms into the primitives,
lowers rects and cuboid faces to parallelogram quads, Morton-sorts and
pads each primitive kind, emits per-cluster AABBs, draws the seeded Perlin
tables and packs the decoded images into one atlas. The arithmetic is the
JAX package's float32 numpy, so the tables are identical; they are emitted
as torch tensors in a :class:`SceneData` dataclass.

A ``Mesh`` (the glTF importer's triangle soup, ``models/gltf.py``) expands
to its ``Triangle``s as a world object (``scene.py:618-625``).
ConstantMedium compiles as in JAX (``scene.py:627-690``): a Sphere boundary
(``MED_SPHERE``), a Cuboid one (``MED_POLY``, outward half-spaces) or a
Mesh one (``MED_MESH``: its triangles in ``med_tri`` [M, Tm, 10] rows
p0, e1, e2, double-sided, zero-edge pad rows), each unwrapped from
Translate/RotateY, with an ``Isotropic`` material of the medium's texture.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from rust_ray_tracer_tpu_torch.ops.camera import CameraData
from rust_ray_tracer_tpu_torch.utils import device as device_mod

# Enums (stable ABI for the kernels — never renumber)
MAT_LAMBERTIAN = 0   # material/mod.rs:47-84
MAT_METAL = 1        # material/mod.rs:86-108
MAT_DIELECTRIC = 2   # material/mod.rs:110-148
MAT_LIGHT = 3        # material/mod.rs:171-194
MAT_ISOTROPIC = 4    # material/mod.rs:196-216

TEX_SOLID = 0        # material/texture.rs:15-29
TEX_CHECKER = 1      # material/texture.rs:31-58
TEX_NOISE = 2        # material/texture.rs:60-82 (marble)
TEX_IMAGE = 3        # material/texture.rs:84-131

LIGHT_SPHERE = 0     # sphere.rs:101-119 (solid angle pdf + cone sampling)
LIGHT_QUAD = 1       # aarect.rs:123-143 (XZRect area pdf + uniform sampling)
LIGHT_NULL = 2       # Hittable defaults: pdf=0, random=(1,0,0)

MED_SPHERE = 0       # constant-medium boundary kinds (SceneData.med_kind)
MED_POLY = 1
MED_MESH = 2

PERLIN_N = 256       # perlin.rs:6
CLUSTER = 128        # min triangles per culling cluster
MAX_CLUSTERS = 512   # cap on cluster count K


# ---------------------------------------------------------------------------
# Device-side scene (structure of arrays)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SceneData:
    """Flat scene tensors: float32, int32 or bool, field for field the
    JAX ``SceneData`` (``rust_ray_tracer_tpu/models/scene.py:72``).
    Zero-count kinds are 0-length tensors."""

    tri_v0: torch.Tensor          # [T,3]
    tri_e1: torch.Tensor          # [T,3]
    tri_e2: torch.Tensor          # [T,3]
    tri_mat: torch.Tensor         # [T] int32
    tri_double: torch.Tensor      # [T] bool
    tri_flip: torch.Tensor        # [T] bool
    sph_c0: torch.Tensor          # [S,3]
    sph_c1: torch.Tensor          # [S,3]
    sph_t0: torch.Tensor          # [S]
    sph_t1: torch.Tensor          # [S]
    sph_r: torch.Tensor           # [S]
    sph_mat: torch.Tensor         # [S] int32
    sph_flip: torch.Tensor        # [S] bool
    quad_q: torch.Tensor          # [Q,3]
    quad_u: torch.Tensor          # [Q,3]
    quad_v: torch.Tensor          # [Q,3]
    quad_mat: torch.Tensor        # [Q] int32
    quad_flip: torch.Tensor       # [Q] bool
    tri_cluster_min: torch.Tensor  # [K,3]
    tri_cluster_max: torch.Tensor  # [K,3]
    tri_sub_min: torch.Tensor     # [K*SUB,3]
    tri_sub_max: torch.Tensor     # [K*SUB,3]
    sph_cluster_min: torch.Tensor  # [Ks,3]
    sph_cluster_max: torch.Tensor  # [Ks,3]
    quad_cluster_min: torch.Tensor  # [Kq,3]
    quad_cluster_max: torch.Tensor  # [Kq,3]
    med_c: torch.Tensor           # [M,3]
    med_r: torch.Tensor           # [M]
    med_neg_inv_d: torch.Tensor   # [M]
    med_mat: torch.Tensor         # [M] int32
    med_kind: torch.Tensor        # [M] int32
    med_pl_n: torch.Tensor        # [M,P,3]
    med_pl_d: torch.Tensor        # [M,P]
    med_tri: torch.Tensor         # [M,Tm,10]
    mat_kind: torch.Tensor        # [K] int32
    mat_tex: torch.Tensor         # [K] int32
    mat_fuzz: torch.Tensor        # [K]
    mat_ior: torch.Tensor         # [K]
    tex_kind: torch.Tensor        # [X] int32
    tex_color: torch.Tensor       # [X,3]
    tex_scale: torch.Tensor       # [X]
    tex_even: torch.Tensor        # [X] int32 (length 0 without checkers)
    tex_odd: torch.Tensor         # [X] int32
    tex_image: torch.Tensor       # [X] int32
    img_data: torch.Tensor        # [I,Hm,Wm,3]
    img_size: torch.Tensor        # [I,2] int32
    perlin_vec: torch.Tensor      # [256,3] (length 0 without noise)
    perlin_px: torch.Tensor       # [256] int32
    perlin_py: torch.Tensor       # [256] int32
    perlin_pz: torch.Tensor       # [256] int32
    light_kind: torch.Tensor      # [L] int32
    light_c: torch.Tensor         # [L,3]
    light_r: torch.Tensor         # [L]
    light_q: torch.Tensor         # [L,3]
    light_u: torch.Tensor         # [L,3]
    light_v: torch.Tensor         # [L,3]
    camera: CameraData
    background: torch.Tensor      # [3]

    def to(self, device) -> "SceneData":
        return SceneData(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.background.device

    @property
    def n_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_c0.shape[0]

    @property
    def n_quads(self) -> int:
        return self.quad_q.shape[0]

    @property
    def n_media(self) -> int:
        return self.med_c.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]


_CAMERA_FIELDS = ("c2w", "scale", "aspect", "time0", "time1")


def scene_from_numpy(d: dict[str, np.ndarray],
                     device=device_mod.DEFAULT) -> SceneData:
    """SceneData on ``device`` (the card unless ``device="cpu"``) from
    numpy arrays keyed by the JAX ``SceneData`` field names, with the
    camera's fields under ``camera.c2w``, ``camera.scale``,
    ``camera.aspect``, ``camera.time0`` and ``camera.time1`` — e.g.
    ``{name: np.asarray(leaf)}`` of a JAX scene. Floats become float32,
    integers int32, booleans bool."""
    device = device_mod.resolve(device)
    def t(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.tensor(a, dtype=torch.bool, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int32), device=device)
        return torch.tensor(a.astype(np.float32), device=device)

    cam = CameraData(**{k: t(d[f"camera.{k}"]) for k in _CAMERA_FIELDS})
    fields = {f.name: t(d[f.name]) for f in dataclasses.fields(SceneData)
              if f.name != "camera"}
    return SceneData(camera=cam, **fields)


def partition(scene: SceneData):
    """Split a scene into ``(params, static)``: ``params`` a
    ``dict[str, Tensor]`` of every floating-point field (the camera's
    under ``camera.c2w``, ``camera.scale`` and so on, as
    :func:`scene_from_numpy` names them), ``static`` the rest. A trainer
    makes leaves with ``{k: v.clone().requires_grad_() for k, v in
    params.items()}`` and renders ``combine(leaves, static)``.
    Counterpart of ``rust_ray_tracer_tpu/models/scene.py:210-222``."""
    flat = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)
            if f.name != "camera"}
    flat.update({f"camera.{k}": getattr(scene.camera, k)
                 for k in _CAMERA_FIELDS})
    params = {k: v for k, v in flat.items() if v.is_floating_point()}
    static = {k: v for k, v in flat.items() if k not in params}
    return params, static


def combine(params: dict, static: dict) -> SceneData:
    """The scene of :func:`partition`'s two halves (``params`` may hold
    tensors that require grad). Counterpart of ``combine``
    (``rust_ray_tracer_tpu/models/scene.py:220``)."""
    flat = {**static, **params}
    cam = CameraData(**{k: flat[f"camera.{k}"] for k in _CAMERA_FIELDS})
    return SceneData(camera=cam, **{f.name: flat[f.name]
                                    for f in dataclasses.fields(SceneData)
                                    if f.name != "camera"})


# ---------------------------------------------------------------------------
# Host-side construction API (mirrors the reference's types)
# ---------------------------------------------------------------------------

Vec = Union[Sequence[float], np.ndarray]


def _v(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(3)


@dataclasses.dataclass(frozen=True)
class SolidColor:
    color: Vec


@dataclasses.dataclass(frozen=True)
class Checker:
    even: "Texture"
    odd: "Texture"

    @staticmethod
    def from_colors(c1: Vec, c2: Vec) -> "Checker":
        return Checker(SolidColor(c1), SolidColor(c2))


@dataclasses.dataclass(frozen=True)
class Noise:
    """Marble noise (texture.rs:60-82) of frequency ``scale``."""
    scale: float


@dataclasses.dataclass(frozen=True)
class ImageTexture:
    """Image texture (texture.rs:84-131) from a file ``path`` or an
    [H, W, 3+] array ``data`` of floats in [0, 1]. :meth:`load` reads the
    file as the JAX package does (``scene.py:259-287``): through PIL where
    it imports, else through ``utils/image.decode_image``, which knows the
    format by its bytes, as the reference's ``image`` crate does. A
    missing or undecodable file (or no path) loads as None and compiles to
    solid yellow (texture.rs:129)."""
    path: str | None = None
    data: np.ndarray | None = dataclasses.field(default=None, hash=False,
                                                compare=False)

    def load(self) -> np.ndarray | None:
        """The image as float32 [H, W, C] in [0, 1], or None."""
        if self.data is not None:
            return np.asarray(self.data, np.float32)
        if self.path is None:
            return None
        try:
            from PIL import Image   # optional: the port does not need it
            return np.asarray(Image.open(self.path).convert("RGB"),
                              np.float32) / 255.0
        except Exception:
            pass
        try:
            from rust_ray_tracer_tpu_torch.utils.image import decode_image
            with open(self.path, "rb") as f:
                raw = f.read()
            return np.asarray(decode_image(raw), np.float32) / 255.0
        except Exception:
            return None


Texture = Union[SolidColor, Checker, Noise, ImageTexture]


def _as_texture(x) -> Texture:
    if isinstance(x, (SolidColor, Checker, Noise, ImageTexture)):
        return x
    return SolidColor(_v(x))


@dataclasses.dataclass(frozen=True)
class Lambertian:
    albedo: Texture

    @staticmethod
    def from_color(c: Vec) -> "Lambertian":
        return Lambertian(SolidColor(c))

    @staticmethod
    def from_rgb(r, g, b) -> "Lambertian":
        return Lambertian(SolidColor((r, g, b)))


@dataclasses.dataclass(frozen=True)
class Metal:
    albedo: Vec
    fuzziness: float = 0.0


@dataclasses.dataclass(frozen=True)
class Dielectric:
    ir: float


@dataclasses.dataclass(frozen=True)
class DiffuseLight:
    emit: Texture

    @staticmethod
    def from_color(c: Vec) -> "DiffuseLight":
        return DiffuseLight(SolidColor(c))


@dataclasses.dataclass(frozen=True)
class Isotropic:
    albedo: Texture

    @staticmethod
    def from_color(c: Vec) -> "Isotropic":
        return Isotropic(SolidColor(c))


Material = Union[Lambertian, Metal, Dielectric, DiffuseLight, Isotropic]


@dataclasses.dataclass
class Sphere:
    center: Vec
    radius: float
    material: Material


@dataclasses.dataclass
class MovingSphere:
    center0: Vec
    center1: Vec
    time0: float
    time1: float
    radius: float
    material: Material


@dataclasses.dataclass
class Triangle:
    v0: Vec
    v1: Vec
    v2: Vec
    material: Material
    double_sided: bool = False  # constructor always false (triangle.rs:27)


@dataclasses.dataclass
class Quad:
    """Parallelogram {q + a*u + b*v : a,b in [0,1]}."""
    q: Vec
    u: Vec
    v: Vec
    material: Material
    is_xzrect: bool = False   # only XZRect has light sampling (aarect.rs)


def XYRect(x0, x1, y0, y1, k, material) -> Quad:
    return Quad((x0, y0, k), (x1 - x0, 0, 0), (0, y1 - y0, 0), material)


def XZRect(x0, x1, z0, z1, k, material) -> Quad:
    return Quad((x0, k, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0), material,
                is_xzrect=True)


def YZRect(y0, y1, z0, z1, k, material) -> Quad:
    return Quad((k, y0, z0), (0, y1 - y0, 0), (0, 0, z1 - z0), material)


@dataclasses.dataclass
class Cuboid:
    """Axis-aligned box as 6 rects (cuboid.rs:23-76)."""
    minimum: Vec
    maximum: Vec
    material: Material

    def sides(self):
        mn, mx, m = _v(self.minimum), _v(self.maximum), self.material
        return [
            XYRect(mn[0], mx[0], mn[1], mx[1], mx[2], m),
            XYRect(mn[0], mx[0], mn[1], mx[1], mn[2], m),
            XZRect(mn[0], mx[0], mn[2], mx[2], mx[1], m),
            XZRect(mn[0], mx[0], mn[2], mx[2], mn[1], m),
            YZRect(mn[1], mx[1], mn[2], mx[2], mx[0], m),
            YZRect(mn[1], mx[1], mn[2], mx[2], mn[0], m),
        ]


@dataclasses.dataclass
class Mesh:
    """Triangle soup: a world object and a ConstantMedium boundary
    (``scene.py:417``). ``triangles``: (v0, v1, v2) vertex triples. A
    boundary should be closed and double-sided: the reference's exit query
    (constant_medium.rs:48) hits the inside of the far face, which a
    single-sided triangle culls, so a single-sided boundary yields no
    medium, here and in the reference alike."""
    triangles: Sequence
    material: Material | None = None
    double_sided: bool = True


@dataclasses.dataclass
class Translate:
    base: object
    offset: Vec


@dataclasses.dataclass
class RotateY:
    base: object
    angle_deg: float


@dataclasses.dataclass
class FlipFace:
    """Post-hit normal.y = -|normal.y| (geometry/mod.rs:222-234)."""
    base: object


@dataclasses.dataclass
class ConstantMedium:
    """Participating medium of constant ``density`` inside ``boundary``
    (constant_medium.rs): a Sphere, a Cuboid or a Mesh, optionally wrapped
    in Translate/RotateY."""
    boundary: object
    density: float
    texture: Texture

    @staticmethod
    def from_color(boundary, density, color: Vec) -> "ConstantMedium":
        return ConstantMedium(boundary, density, SolidColor(color))


@dataclasses.dataclass
class Scene:
    """Host-side scene mirroring ``scene.rs:25-30``."""
    camera: CameraData
    world: list
    lights: list
    background: Vec


# ---------------------------------------------------------------------------
# Compilation: object graph -> SceneData
# ---------------------------------------------------------------------------

def _rot_y(deg: float) -> np.ndarray:
    """Object-to-world rotation matching RotateY (transform.rs:112-121)."""
    r = np.deg2rad(deg)
    c, s = np.cos(r, dtype=np.float32), np.sin(r, dtype=np.float32)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _affine(rot=None, trans=None) -> np.ndarray:
    a = np.eye(3, 4, dtype=np.float32)
    if rot is not None:
        a[:, :3] = rot
    if trans is not None:
        a[:, 3] = _v(trans)
    return a


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a ∘ b (apply b first)."""
    out = np.empty((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def _apply_p(a: np.ndarray, p) -> np.ndarray:
    return a[:, :3] @ _v(p) + a[:, 3]


def _apply_d(a: np.ndarray, d) -> np.ndarray:
    return a[:, :3] @ _v(d)


class _Builder:
    def __init__(self):
        self.tris = []       # (v0, e1, e2, mat, double, flip)
        self.sphs = []       # (c0, c1, t0, t1, r, mat, flip)
        self.quads = []      # (q, u, v, mat, flip)
        self.media = []      # (c, r, neg_inv_d, mat, kind, planes, tris)
        self.materials = []
        self.textures = []
        self.images = []     # the decoded arrays, in atlas order
        # id(obj) -> (obj, row): holding obj keeps its id from being reused
        # by a later temporary (a Metal's albedo SolidColor is built on the
        # fly), which would alias two textures
        self._mat_ids = {}
        self._tex_ids = {}

    def texture_id(self, tex: Texture) -> int:
        key = id(tex)
        if key in self._tex_ids:
            return self._tex_ids[key][1]
        if isinstance(tex, SolidColor):
            row = dict(kind=TEX_SOLID, color=_v(tex.color))
        elif isinstance(tex, Checker):
            even = self.texture_id(_as_texture(tex.even))
            odd = self.texture_id(_as_texture(tex.odd))
            row = dict(kind=TEX_CHECKER, even=even, odd=odd)
        elif isinstance(tex, Noise):
            row = dict(kind=TEX_NOISE, scale=float(tex.scale))
        elif isinstance(tex, ImageTexture):
            data = tex.load()
            if data is None:
                # missing or undecodable: solid yellow (texture.rs:129)
                row = dict(kind=TEX_SOLID, color=_v((1.0, 1.0, 0.0)))
            else:
                row = dict(kind=TEX_IMAGE, image=len(self.images))
                self.images.append(np.asarray(data, np.float32))
        else:
            raise TypeError(f"unknown texture {tex!r}")
        tid = len(self.textures)
        self.textures.append(row)
        self._tex_ids[key] = (tex, tid)
        return tid

    def material_id(self, mat: Material) -> int:
        key = id(mat)
        if key in self._mat_ids:
            return self._mat_ids[key][1]
        if isinstance(mat, Lambertian):
            row = dict(kind=MAT_LAMBERTIAN,
                       tex=self.texture_id(_as_texture(mat.albedo)))
        elif isinstance(mat, Metal):
            row = dict(kind=MAT_METAL,
                       tex=self.texture_id(SolidColor(mat.albedo)),
                       fuzz=float(mat.fuzziness))
        elif isinstance(mat, Dielectric):
            row = dict(kind=MAT_DIELECTRIC,
                       tex=self.texture_id(SolidColor((1.0, 1.0, 1.0))),
                       ior=float(mat.ir))
        elif isinstance(mat, DiffuseLight):
            row = dict(kind=MAT_LIGHT,
                       tex=self.texture_id(_as_texture(mat.emit)))
        elif isinstance(mat, Isotropic):
            row = dict(kind=MAT_ISOTROPIC,
                       tex=self.texture_id(_as_texture(mat.albedo)))
        else:
            raise TypeError(f"unknown material {mat!r}")
        mid = len(self.materials)
        self.materials.append(row)
        self._mat_ids[key] = (mat, mid)
        return mid

    def add(self, obj, affine: np.ndarray, flip: bool):
        if isinstance(obj, (list, tuple)):
            for o in obj:
                self.add(o, affine, flip)
        elif isinstance(obj, Translate):
            self.add(obj.base,
                     _compose(affine, _affine(trans=obj.offset)), flip)
        elif isinstance(obj, RotateY):
            self.add(obj.base,
                     _compose(affine, _affine(rot=_rot_y(obj.angle_deg))),
                     flip)
        elif isinstance(obj, FlipFace):
            self.add(obj.base, affine, True)
        elif isinstance(obj, Cuboid):
            for side in obj.sides():
                self.add(side, affine, flip)
        elif isinstance(obj, Sphere):
            c = _apply_p(affine, obj.center)
            self.sphs.append((c, c, 0.0, 1.0, float(obj.radius),
                              self.material_id(obj.material), flip))
        elif isinstance(obj, MovingSphere):
            c0 = _apply_p(affine, obj.center0)
            c1 = _apply_p(affine, obj.center1)
            self.sphs.append((c0, c1, float(obj.time0), float(obj.time1),
                              float(obj.radius),
                              self.material_id(obj.material), flip))
        elif isinstance(obj, Triangle):
            v0 = _apply_p(affine, obj.v0)
            v1 = _apply_p(affine, obj.v1)
            v2 = _apply_p(affine, obj.v2)
            self.tris.append((v0, v1 - v0, v2 - v0,
                              self.material_id(obj.material),
                              bool(obj.double_sided), flip))
        elif isinstance(obj, Quad):
            q = _apply_p(affine, obj.q)
            u = _apply_d(affine, obj.u)
            v = _apply_d(affine, obj.v)
            self.quads.append((q, u, v, self.material_id(obj.material), flip))
        elif isinstance(obj, Mesh):
            if obj.material is None:
                raise ValueError("a world-object Mesh needs a material "
                                 "(only ConstantMedium boundaries may "
                                 "omit it)")
            for (v0, v1, v2) in obj.triangles:
                self.add(Triangle(v0, v1, v2, obj.material,
                                  double_sided=obj.double_sided),
                         affine, flip)
        elif isinstance(obj, ConstantMedium):
            self.add_medium(obj, affine)
        else:
            raise TypeError(f"unknown scene object {obj!r}")


    def add_medium(self, obj: ConstantMedium, affine: np.ndarray):
        """The JAX package's ConstantMedium compile (``scene.py:627-690``):
        Sphere, Cuboid and Mesh boundaries."""
        b = obj.boundary
        a2 = affine
        while isinstance(b, (Translate, RotateY)):
            if isinstance(b, Translate):
                a2 = _compose(a2, _affine(trans=b.offset))
            else:
                a2 = _compose(a2, _affine(rot=_rot_y(b.angle_deg)))
            b = b.base
        if not isinstance(b, (Sphere, Cuboid, Mesh)):
            raise NotImplementedError(
                "ConstantMedium boundaries: Sphere, Cuboid or Mesh "
                "(optionally Translate/RotateY-wrapped); a flat rect has no "
                "exit hit and yields no medium in the reference either "
                "(constant_medium.rs:47-49)")
        nid = -1.0 / float(obj.density)
        mat = self.material_id(Isotropic(obj.texture))
        no_tris = np.zeros((0, 10), np.float32)
        if isinstance(b, Sphere):
            self.media.append((_apply_p(a2, b.center), float(b.radius), nid,
                               mat, MED_SPHERE, [], no_tris))
            return
        if isinstance(b, Mesh):
            # the entry/exit pair is two closest-hit queries over the same
            # triangles (constant_medium.rs:47-49), ops/intersect._med_t
            dbl = 1.0 if b.double_sided else 0.0
            rows = []
            for (v0, v1, v2) in b.triangles:
                p0 = _apply_p(a2, _v(v0))
                p1 = _apply_p(a2, _v(v1))
                p2 = _apply_p(a2, _v(v2))
                rows.append(np.concatenate(
                    [p0, p1 - p0, p2 - p0, [dbl]]).astype(np.float32))
            if not rows:
                raise ValueError("empty Mesh boundary")
            self.media.append((np.zeros(3, np.float32), 0.0, nid, mat,
                               MED_MESH, [], np.asarray(rows, np.float32)))
            return
        # convex polytope: one outward half-space n.p <= d per face, the
        # slab interval of the reference's entry/exit pair
        center = _apply_p(a2, (_v(b.minimum) + _v(b.maximum)) * 0.5)
        planes = []
        for side in b.sides():
            q = _apply_p(a2, side.q)
            n = np.cross(_apply_d(a2, side.u), _apply_d(a2, side.v))
            ln = float(np.linalg.norm(n))
            if ln <= 0:
                continue   # degenerate face: no constraint
            n = n / ln
            if float(np.dot(n, center - q)) > 0:
                n = -n     # orient outward
            planes.append((n.astype(np.float32), float(np.dot(n, q))))
        self.media.append((np.zeros(3, np.float32), 0.0, nid, mat, MED_POLY,
                           planes, no_tris))


def _stack(rows, pick, shape, dtype=np.float32):
    if not rows:
        return np.zeros((0,) + shape, dtype)
    return np.asarray([pick(r) for r in rows], dtype).reshape(
        (len(rows),) + shape)


def _pad_rows(arrs: dict, multiple: int, pad_values: dict) -> dict:
    n = next(iter(arrs.values())).shape[0]
    if n == 0 or multiple <= 1:
        return arrs
    target = -(-n // multiple) * multiple
    if target == n:
        return arrs
    out = {}
    for k, a in arrs.items():
        pad = np.broadcast_to(np.asarray(pad_values.get(k, 0), a.dtype),
                              (target - n,) + a.shape[1:])
        out[k] = np.concatenate([a, pad], axis=0)
    return out


def _morton_argsort(centroids: np.ndarray) -> np.ndarray:
    """Stable Morton-curve order of [N,3] points: quantization in float32
    with truncation toward zero, bit-identical to the JAX package's
    ``_morton_codes_np`` (and its native twin)."""
    c = np.asarray(centroids, np.float32)
    mn, mx = c.min(0), c.max(0)
    with np.errstate(divide="ignore"):   # flat axes take the 0 branch
        inv = np.where(mx > mn,
                       np.float32(1.0) / (mx - mn).astype(np.float32),
                       np.float32(0.0)).astype(np.float32)
    f = np.clip(((c - mn) * inv).astype(np.float32), np.float32(0.0),
                np.float32(1.0))
    q = (f * np.float32(1023.0)).astype(np.uint32).astype(np.uint64)

    def expand(v):
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    return np.argsort(code.astype(np.uint32), kind="stable").astype(np.int32)


def _cluster_boxes(lo, hi, n_real, width):
    """Per-cluster AABBs over ``width``-row groups; rows past ``n_real``
    get inverted boxes so they never enlarge a cluster."""
    lo, hi = lo.copy(), hi.copy()
    lo[n_real:] = np.inf
    hi[n_real:] = -np.inf
    k = -(-lo.shape[0] // width)
    pad = k * width - lo.shape[0]
    if pad:
        lo = np.concatenate([lo, np.full((pad, 3), np.inf)], 0)
        hi = np.concatenate([hi, np.full((pad, 3), -np.inf)], 0)
    return (lo.reshape(k, width, 3).min(1).astype(np.float32),
            hi.reshape(k, width, 3).max(1).astype(np.float32))


def _light_rows(lights):
    """(kind, c, r, q, u, v) rows: only bare Sphere / XZRect lights have
    sampling; anything else takes the Hittable defaults (LIGHT_NULL)."""
    z = np.zeros(3, np.float32)
    rows = []
    for lt in lights:
        if isinstance(lt, Sphere):
            rows.append((LIGHT_SPHERE, _v(lt.center), float(lt.radius),
                         z, z, z))
        elif isinstance(lt, Quad) and lt.is_xzrect:
            rows.append((LIGHT_QUAD, z, 0.0, _v(lt.q), _v(lt.u), _v(lt.v)))
        else:
            rows.append((LIGHT_NULL, z, 0.0, z, z, z))
    return rows


def compile_scene(scene: Scene, *, seed: int = 0,
                  device=device_mod.DEFAULT) -> SceneData:
    """Flatten a host Scene into tensors on ``device`` (the card unless
    ``device="cpu"``; raises without one).

    ``seed`` seeds the Perlin tables as the JAX ``compile_scene(scene,
    seed)`` does (``np.random.default_rng(seed)``: the gradients, then the
    three permutations); they are drawn only when a Noise texture exists,
    and are 0-length otherwise.

    Triangles are Morton-sorted and padded to a multiple of the cluster
    width (CLUSTER, doubled until at most MAX_CLUSTERS clusters) with
    zero-edge triangles (det == 0, never hit); spheres and quads are
    Morton-sorted and padded to 8 (or CLUSTER above CLUSTER rows), with
    radius-0 spheres and zero-edge quads.
    """
    device = device_mod.resolve(device)
    b = _Builder()
    b.add(scene.world, _affine(), False)

    tri_pad = CLUSTER
    while len(b.tris) > MAX_CLUSTERS * tri_pad:
        tri_pad *= 2

    lrows = _light_rows(scene.lights)
    nl = len(lrows)

    tris = dict(
        v0=_stack(b.tris, lambda r: r[0], (3,)),
        e1=_stack(b.tris, lambda r: r[1], (3,)),
        e2=_stack(b.tris, lambda r: r[2], (3,)),
        mat=_stack(b.tris, lambda r: r[3], (), np.int32),
        double=_stack(b.tris, lambda r: r[4], (), bool),
        flip=_stack(b.tris, lambda r: r[5], (), bool),
    )
    if len(b.tris) > 1:
        perm = _morton_argsort(tris["v0"] + (tris["e1"] + tris["e2"]) / 3.0)
        tris = {k: a[perm] for k, a in tris.items()}
    tris = _pad_rows(tris, tri_pad, {})

    empty3 = np.zeros((0, 3), np.float32)
    cl_min = cl_max = sub_min = sub_max = empty3
    if tris["v0"].shape[0]:
        corners = np.stack([tris["v0"], tris["v0"] + tris["e1"],
                            tris["v0"] + tris["e2"]], 1)
        lo, hi = corners.min(1), corners.max(1)
        cl_min, cl_max = _cluster_boxes(lo, hi, len(b.tris), tri_pad)
        if tri_pad > CLUSTER:
            # second hierarchy level: CLUSTER-wide sub-boxes (big meshes)
            sub_min, sub_max = _cluster_boxes(lo, hi, len(b.tris), CLUSTER)

    sphs = dict(
        c0=_stack(b.sphs, lambda r: r[0], (3,)),
        c1=_stack(b.sphs, lambda r: r[1], (3,)),
        t0=_stack(b.sphs, lambda r: r[2], ()),
        t1=_stack(b.sphs, lambda r: r[3], ()),
        r=_stack(b.sphs, lambda r: r[4], ()),
        mat=_stack(b.sphs, lambda r: r[5], (), np.int32),
        flip=_stack(b.sphs, lambda r: r[6], (), bool),
    )
    if len(b.sphs) > 1:
        sperm = _morton_argsort((sphs["c0"] + sphs["c1"]) * 0.5)
        sphs = {k: a[sperm] for k, a in sphs.items()}
    sphs = _pad_rows(sphs, 8 if len(b.sphs) <= CLUSTER else CLUSTER,
                     {"t1": 1.0})
    s_cl_min = s_cl_max = empty3
    if sphs["c0"].shape[0]:
        s_cl_min, s_cl_max = _cluster_boxes(
            np.minimum(sphs["c0"], sphs["c1"]) - sphs["r"][:, None],
            np.maximum(sphs["c0"], sphs["c1"]) + sphs["r"][:, None],
            len(b.sphs), CLUSTER)

    quads = dict(
        q=_stack(b.quads, lambda r: r[0], (3,)),
        u=_stack(b.quads, lambda r: r[1], (3,)),
        v=_stack(b.quads, lambda r: r[2], (3,)),
        mat=_stack(b.quads, lambda r: r[3], (), np.int32),
        flip=_stack(b.quads, lambda r: r[4], (), bool),
    )
    if len(b.quads) > 1:
        qperm = _morton_argsort(
            quads["q"] + 0.5 * (quads["u"] + quads["v"]))
        quads = {k: a[qperm] for k, a in quads.items()}
    quads = _pad_rows(quads, 8 if len(b.quads) <= CLUSTER else CLUSTER, {})
    q_cl_min = q_cl_max = empty3
    if quads["q"].shape[0]:
        qc = np.stack([quads["q"], quads["q"] + quads["u"],
                       quads["q"] + quads["v"],
                       quads["q"] + quads["u"] + quads["v"]], 1)
        q_cl_min, q_cl_max = _cluster_boxes(qc.min(1), qc.max(1),
                                            len(b.quads), CLUSTER)

    # the image atlas (scene.py:993-1004): every image at the top-left of
    # a common [Hm, Wm] canvas, its own (h, w) beside it
    if b.images:
        hm = max(i.shape[0] for i in b.images)
        wm = max(i.shape[1] for i in b.images)
        atlas = np.zeros((len(b.images), hm, wm, 3), np.float32)
        sizes = np.zeros((len(b.images), 2), np.int32)
        for i, img in enumerate(b.images):
            atlas[i, :img.shape[0], :img.shape[1]] = img[..., :3]
            sizes[i] = (img.shape[0], img.shape[1])
    else:
        atlas = np.zeros((0, 1, 1, 3), np.float32)
        sizes = np.ones((0, 2), np.int32)

    # polytope planes padded to the largest face count with no-constraint
    # half-spaces (n = 0, d = 1)
    n_med = len(b.media)
    n_pl = max([len(r[5]) for r in b.media], default=0)
    med_pl_n = np.zeros((n_med, n_pl, 3), np.float32)
    med_pl_d = np.ones((n_med, n_pl), np.float32)
    for i, row in enumerate(b.media):
        for j, (nrm, off) in enumerate(row[5]):
            med_pl_n[i, j] = nrm
            med_pl_d[i, j] = off
    # mesh boundary triangles, padded with zero-edge rows (never valid)
    n_mt = max([r[6].shape[0] for r in b.media], default=0)
    med_tri = np.zeros((n_med, n_mt, 10), np.float32)
    for i, row in enumerate(b.media):
        med_tri[i, :row[6].shape[0]] = row[6]

    mats = b.materials or [dict(kind=MAT_LAMBERTIAN, tex=0)]
    texs = b.textures or [dict(kind=TEX_SOLID, color=np.zeros(3, np.float32))]

    def mfield(name, default, dtype=np.float32):
        return np.asarray([m.get(name, default) for m in mats], dtype)

    def tfield(name, default, dtype=np.float32):
        return np.asarray([t.get(name, default) for t in texs], dtype)

    # feature presence is encoded in table shapes: no checkers ->
    # tex_even / tex_odd are length 0
    has_checker = any(t.get("kind") == TEX_CHECKER for t in texs)
    no_chk = np.zeros((0,), np.int32)
    # perlin tables (seeded; the reference's are unseeded thread_rng,
    # perlin.rs:14-30): drawn in the JAX package's order
    if any(t.get("kind") == TEX_NOISE for t in texs):
        prng = np.random.default_rng(seed)
        perlin_vec = prng.uniform(-1.0, 1.0, (PERLIN_N, 3)).astype(np.float32)
        perms = [prng.permutation(PERLIN_N).astype(np.int32)
                 for _ in range(3)]
    else:
        perlin_vec = np.zeros((0, 3), np.float32)
        perms = [no_chk] * 3

    def light_col(i, shape):
        return np.asarray([r[i] for r in lrows], np.float32).reshape(
            (nl,) + shape)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SceneData(
        tri_v0=t(tris["v0"]), tri_e1=t(tris["e1"]), tri_e2=t(tris["e2"]),
        tri_mat=t(tris["mat"]), tri_double=t(tris["double"]),
        tri_flip=t(tris["flip"]),
        sph_c0=t(sphs["c0"]), sph_c1=t(sphs["c1"]), sph_t0=t(sphs["t0"]),
        sph_t1=t(sphs["t1"]), sph_r=t(sphs["r"]), sph_mat=t(sphs["mat"]),
        sph_flip=t(sphs["flip"]),
        quad_q=t(quads["q"]), quad_u=t(quads["u"]), quad_v=t(quads["v"]),
        quad_mat=t(quads["mat"]), quad_flip=t(quads["flip"]),
        tri_cluster_min=t(cl_min), tri_cluster_max=t(cl_max),
        tri_sub_min=t(sub_min), tri_sub_max=t(sub_max),
        sph_cluster_min=t(s_cl_min), sph_cluster_max=t(s_cl_max),
        quad_cluster_min=t(q_cl_min), quad_cluster_max=t(q_cl_max),
        med_c=t(_stack(b.media, lambda r: r[0], (3,))),
        med_r=t(_stack(b.media, lambda r: r[1], ())),
        med_neg_inv_d=t(_stack(b.media, lambda r: r[2], ())),
        med_mat=t(_stack(b.media, lambda r: r[3], (), np.int32)),
        med_kind=t(_stack(b.media, lambda r: r[4], (), np.int32)),
        med_pl_n=t(med_pl_n), med_pl_d=t(med_pl_d),
        med_tri=t(med_tri),
        mat_kind=t(mfield("kind", 0, np.int32)),
        mat_tex=t(mfield("tex", 0, np.int32)),
        mat_fuzz=t(mfield("fuzz", 0.0)),
        mat_ior=t(mfield("ior", 1.0)),
        tex_kind=t(tfield("kind", 0, np.int32)),
        tex_color=t(np.stack([np.asarray(tx.get("color",
                                                np.zeros(3, np.float32)))
                              for tx in texs]).astype(np.float32)),
        tex_scale=t(tfield("scale", 1.0)),
        tex_even=t(tfield("even", 0, np.int32) if has_checker else no_chk),
        tex_odd=t(tfield("odd", 0, np.int32) if has_checker else no_chk),
        tex_image=t(tfield("image", 0, np.int32)),
        img_data=t(atlas), img_size=t(sizes),
        perlin_vec=t(perlin_vec),
        perlin_px=t(perms[0]), perlin_py=t(perms[1]), perlin_pz=t(perms[2]),
        light_kind=t(np.asarray([r[0] for r in lrows], np.int32)),
        light_c=t(light_col(1, (3,))),
        light_r=t(light_col(2, ())),
        light_q=t(light_col(3, (3,))),
        light_u=t(light_col(4, (3,))),
        light_v=t(light_col(5, (3,))),
        camera=scene.camera.to(device),
        background=t(_v(scene.background)),
    )
