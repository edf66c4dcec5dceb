"""glTF 2.0 scene import.

Counterpart of ``rust_ray_tracer_tpu/models/gltf.py`` (all of it), on the
port's own scene classes and camera: the JAX module is pure numpy, and the
port keeps its own copy so it imports nothing of the JAX package. It reads
``.gltf`` (JSON) and ``.glb`` (binary container) files, buffers as base64
data URIs, external ``.bin`` files or the GLB binary chunk, u8/u16/u32
indices and strided accessors, and instantiates each mesh at its node's
world transform (TRS or matrix, composed down the node tree).

The reference importer's mapping (the reference's ``src/gltf.rs``), as the
JAX module keeps it:

  * material: |metallicFactor| < 1e-5 -> Lambertian(baseColor), else
    Metal(albedo=baseColor, fuzz=roughnessFactor) (gltf.rs:147-168);
    triangles are single-sided, ``Triangle``'s default (triangle.rs:27);
  * KHR_lights_punctual point light -> emissive Sphere(r=0.2,
    emit=color*intensity) in both the world and the light list
    (gltf.rs:287-299,332-338);
  * perspective camera: vfov = degrees(yfov), aspect from the file (else
    the caller's), camera-to-world = the node's world transform
    (gltf.rs:268-285); no camera: ``Camera::default()``, 30 degrees, the
    identity pose (camera.rs:41-54);
  * background fixed at (0.051, 0.051, 0.051) (gltf.rs:348).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from rust_ray_tracer_tpu_torch.models import scene as S
from rust_ray_tracer_tpu_torch.ops.camera import make_camera

_COMP_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, bin_chunk=None):
    """Each buffer's bytes: a data URI decoded, an external file read from
    ``base_dir``, or (no URI) the GLB binary chunk."""
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError("buffer without uri outside a GLB file")
            out.append(bin_chunk)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_document(path: str):
    """Parse .gltf (JSON) or .glb (binary container) -> (doc, bin_chunk)."""
    with open(path, "rb") as f:
        head = f.read(4)
        if head != b"glTF":
            f.seek(0)
            return json.load(f), None
        version, _length = struct.unpack("<II", f.read(8))
        if version != 2:
            raise ValueError(f"unsupported GLB version {version}")
        doc = None
        bin_chunk = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            clen, ctype = struct.unpack("<I4s", hdr)
            data = f.read(clen)
            if ctype == b"JSON":
                doc = json.loads(data)
            elif ctype == b"BIN\x00":
                bin_chunk = data
        if doc is None:
            raise ValueError("GLB missing JSON chunk")
        return doc, bin_chunk


def _accessor(doc, buffers, idx: int) -> np.ndarray:
    """Accessor ``idx`` as [count, n] (or [count] for scalars), honouring
    the buffer view's byte stride."""
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    dtype = _COMP_DTYPE[acc["componentType"]]
    ncomp = _TYPE_COUNT[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    if stride == itemsize:
        data = np.frombuffer(buf, dtype, count * ncomp, offset)
    else:
        rows = [np.frombuffer(buf, dtype, ncomp, offset + i * stride)
                for i in range(count)]
        data = np.concatenate(rows)
    return data.reshape(count, ncomp) if ncomp > 1 else data


def _quat_to_mat(q) -> np.ndarray:
    x, y, z, w = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _node_affine(node: dict) -> np.ndarray:
    """Local TRS (or matrix) as a [3, 4] affine."""
    if "matrix" in node:
        m = np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        return m[:3, :]
    rot = _quat_to_mat(node.get("rotation", (0, 0, 0, 1)))
    scale = np.asarray(node.get("scale", (1, 1, 1)), np.float32)
    trans = np.asarray(node.get("translation", (0, 0, 0)), np.float32)
    a = np.empty((3, 4), np.float32)
    a[:, :3] = rot * scale[None, :]
    a[:, 3] = trans
    return a


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def _material(doc, idx):
    mat = doc.get("materials", [{}])[idx] if idx is not None else {}
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
    metallic = pbr.get("metallicFactor", 1.0)
    rough = pbr.get("roughnessFactor", 1.0)
    if abs(metallic) < 1e-5:
        return S.Lambertian.from_color(base)
    return S.Metal(albedo=np.asarray(base, np.float32), fuzziness=rough)


def load_gltf_scene(path: str, default_camera_aspect: float = 1.0) -> S.Scene:
    """Parse a .gltf or .glb file into a host Scene (camera, world, lights,
    background), as ``load_gltf_scene`` (``gltf.py:157``) does."""
    doc, bin_chunk = _read_document(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    buffers = _load_buffers(doc, base_dir, bin_chunk)

    # materials are shared objects, so compile_scene dedupes them by identity
    materials = [_material(doc, i)
                 for i in range(len(doc.get("materials", [])))]
    default_mat = S.Lambertian.from_rgb(1.0, 1.0, 1.0)

    punctual = doc.get("extensions", {}).get(
        "KHR_lights_punctual", {}).get("lights", [])

    world: list = []
    lights: list = []
    camera = {"found": False, "cam": None}

    def add_mesh(mesh_idx: int, affine: np.ndarray):
        mesh = doc["meshes"][mesh_idx]
        for prim in mesh["primitives"]:
            if "POSITION" not in prim.get("attributes", {}):
                continue
            pos = _accessor(doc, buffers,
                            prim["attributes"]["POSITION"]).astype(np.float32)
            pos = pos @ affine[:, :3].T + affine[:, 3]
            mat = (materials[prim["material"]]
                   if prim.get("material") is not None else default_mat)
            if "indices" in prim:
                idxs = _accessor(doc, buffers,
                                 prim["indices"]).astype(np.int64)
            else:
                idxs = np.arange(len(pos), dtype=np.int64)
            tris = pos[idxs].reshape(-1, 3, 3)
            for v0, v1, v2 in tris:
                world.append(S.Triangle(v0, v1, v2, mat))

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        affine = _compose(parent, _node_affine(node))
        if "mesh" in node:
            add_mesh(node["mesh"], affine)
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                persp = cam["perspective"]
                camera["cam"] = make_camera(
                    affine, np.rad2deg(persp["yfov"]),
                    persp.get("aspectRatio", default_camera_aspect))
                camera["found"] = True
        light_ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if light_ext is not None:
            light = punctual[light_ext["light"]]
            color = np.asarray(light.get("color", (1, 1, 1)), np.float32)
            emit = color * float(light.get("intensity", 1.0))
            sph = S.Sphere(affine[:, 3], 0.2, S.DiffuseLight.from_color(emit))
            world.append(sph)
            lights.append(sph)
        for child in node.get("children", []):
            walk(child, affine)

    ident = np.eye(3, 4, dtype=np.float32)
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes",
                                                                 []))))}])
    for node_idx in scenes[scene_idx].get("nodes", []):
        walk(node_idx, ident)

    if not camera["found"]:
        camera["cam"] = make_camera(ident, 30.0, 1.0)

    return S.Scene(camera=camera["cam"], world=world, lights=lights,
                   background=(0.051, 0.051, 0.051))
