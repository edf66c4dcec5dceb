"""Pinhole camera: batched primary rays in Morton chunk order.

Counterpart of ``rust_ray_tracer_tpu/ops/camera.py`` (``_pixel_order``,
``_pixel_order_chunked``, ``image_from_positions``, ``make_camera``,
``look_at_rh``, ``transform_point``, ``generate_rays``,
``camera_rays_for_chunk``), with the same reference conventions:

  * ndc: px = (2*(x+0.5)/W - 1) * scale * aspect, py likewise with H
    (camera.rs:59-60), x = pixel + U[0,1) jitter (main.rs:92-94);
  * ray point = c2w @ (px, py, -1), origin = c2w @ 0, dir = point - origin,
    left unnormalized (camera.rs:62-68);
  * shutter time ~ U[time0, time1) (camera.rs:67);
  * the builders pass ``look_at_rh`` (a WORLD->VIEW matrix) as
    camera-to-world — a reference pose quirk kept on purpose.

Chunks walk the image in Morton (Z-curve) pixel order; the pixel -> chunk
map is a pure function of (width, height), so renders stay a function of
(seed, chunk_size). Host-side camera set-up is float32 numpy, matching
the JAX package's float32 arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from rust_ray_tracer_tpu_torch.utils import rng as rngu


@functools.lru_cache(maxsize=16)
def _pixel_order(width: int, height: int):
    """(perm, inv) int32: perm[pos] = flat pixel id (y*W+x) of chunk
    position pos along the Morton curve; inv[pixel] = its position."""
    def spread(v):
        v = v.astype(np.uint32) & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    gx, gy = np.meshgrid(np.arange(width), np.arange(height))
    code = spread(gx) | (spread(gy) << np.uint32(1))
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    perm.setflags(write=False)
    inv.setflags(write=False)
    return perm, inv


@functools.lru_cache(maxsize=16)
def _pixel_order_chunked(width: int, height: int, chunk_size: int):
    """[n_chunks, chunk_size] pixel ids along the Morton curve, the pad
    tail clamped to the last pixel."""
    n = width * height
    n_chunks = -(-n // chunk_size)
    perm, _ = _pixel_order(width, height)
    pad = np.full(n_chunks * chunk_size - n, perm[-1], np.int32)
    out = np.concatenate([perm, pad]).reshape(n_chunks, chunk_size)
    out.setflags(write=False)
    return out


def image_from_positions(flat: torch.Tensor, width: int,
                         height: int) -> torch.Tensor:
    """[n, 3] position-ordered radiance -> [H, W, 3] image."""
    _, inv = _pixel_order(width, height)
    idx = torch.from_numpy(inv.astype(np.int64)).to(flat.device)
    return flat[idx].reshape(height, width, 3)


@dataclasses.dataclass
class CameraData:
    """c2w [3, 4] affine (world_p = c2w[:, :3] @ p + c2w[:, 3]) and the
    0-d float32 tensors scale = tan(vfov/2), aspect, time0, time1."""

    c2w: torch.Tensor
    scale: torch.Tensor
    aspect: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor

    def to(self, device) -> "CameraData":
        return CameraData(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def make_camera(c2w, vfov_deg, aspect, time0=0.0, time1=1.0,
                device=None) -> CameraData:
    f32 = np.float32
    scale = np.tan(np.deg2rad(f32(vfov_deg)) * f32(0.5))

    def t(x):
        return torch.tensor(np.asarray(x, f32), device=device)

    return CameraData(c2w=t(np.asarray(c2w, f32).reshape(3, 4)),
                      scale=t(scale), aspect=t(aspect), time0=t(time0),
                      time1=t(time1))


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam-compatible ``Affine3A::look_at_rh`` (a world->view matrix),
    float32 [3, 4]."""
    f32 = np.float32
    eye = np.asarray(eye, f32)
    f = np.asarray(center, f32) - eye
    f = f / np.sqrt(np.sum(f * f, dtype=f32))
    s = np.cross(f, np.asarray(up, f32)).astype(f32)
    s = s / np.sqrt(np.sum(s * s, dtype=f32))
    u = np.cross(s, f).astype(f32)
    rot = np.stack([s, u, -f], axis=0).astype(f32)
    trans = -rot @ eye
    return np.concatenate([rot, trans[:, None]], axis=1).astype(f32)


def transform_point(c2w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a [3, 4] affine to [..., 3] points as broadcast multiply-adds
    (not a matmul, which could run below float32 on an accelerator)."""
    return (p[..., 0:1] * c2w[:, 0] + p[..., 1:2] * c2w[:, 1]
            + p[..., 2:3] * c2w[:, 2]) + c2w[:, 3]


def generate_rays(cam: CameraData, x, y, width: int, height: int, time_u):
    """Batched ``Camera::get_ray`` (camera.rs:56-69): returns (origins
    [..., 3], directions [..., 3], times [...])."""
    # divide by tensors: on CUDA, torch turns a division by a Python
    # scalar into a multiplication by its reciprocal, an ulp off the CPU's
    px = ((2.0 * (x + 0.5) / x.new_tensor(width) - 1.0) * cam.scale
          * cam.aspect)
    py = (2.0 * (y + 0.5) / y.new_tensor(height) - 1.0) * cam.scale
    ndc = torch.stack([px, py, -torch.ones_like(px)], dim=-1)
    origin = cam.c2w[:, 3]
    direction = transform_point(cam.c2w, ndc) - origin
    times = cam.time0 + time_u * (cam.time1 - cam.time0)
    return origin.expand_as(direction), direction, times


def camera_rays_for_chunks(cam: CameraData, wkey: torch.Tensor,
                           chunk_ids: torch.Tensor, chunk_size: int,
                           width: int, height: int):
    """Primary rays for chunks ``chunk_ids`` [K] of one sample wave:
    (o, d [K, C, 3], t [K, C], chunk keys [K, 2]).

    Jitter and shutter time come from keys folded with the GLOBAL chunk
    id, so any partition of chunks over loop steps gives the same rays.
    Positions past the image clamp to the last pixel; callers crop them.
    """
    device = wkey.device
    table = torch.from_numpy(
        _pixel_order_chunked(width, height, chunk_size).astype(np.int64))
    pix = table.to(device)[chunk_ids]
    yy = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    xx = torch.remainder(pix, width).to(torch.float32)
    ckey = rngu.fold_in(wkey, chunk_ids)
    jitter = rngu.uniform(rngu.stream(ckey, rngu.JITTER), (chunk_size, 2))
    time_u = rngu.uniform(rngu.stream(ckey, rngu.TIME), (chunk_size,))
    o, d, t = generate_rays(cam, xx + jitter[..., 0], yy + jitter[..., 1],
                            width, height, time_u)
    return o, d, t, ckey


def camera_rays_for_chunk(cam: CameraData, wkey: torch.Tensor, chunk_id: int,
                          chunk_size: int, width: int, height: int):
    """One chunk of :func:`camera_rays_for_chunks`: (o, d [C, 3], t [C],
    chunk key [2])."""
    ids = torch.tensor([chunk_id], dtype=torch.int64, device=wkey.device)
    o, d, t, ckey = camera_rays_for_chunks(cam, wkey, ids, chunk_size,
                                           width, height)
    return o[0], d[0], t[0], ckey[0]
