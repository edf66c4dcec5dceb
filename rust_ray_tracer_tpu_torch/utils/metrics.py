"""Render metrics and profiling.

Counterpart of ``rust_ray_tracer_tpu/utils/metrics.py``: the wavefront's
occupancy a bounce (the share of lanes still alive, which tells how much
of each launch does useful work), the bounce-depth histogram, rays/s
accounting, and a ``torch.profiler`` trace context in place of JAX's
``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch


@dataclasses.dataclass
class RenderStats:
    """Aggregated wavefront statistics of one render."""
    width: int
    height: int
    spp: int
    depth: int
    wall_s: float
    # occupancy[b] = fraction of lanes still alive entering bounce b
    occupancy: np.ndarray
    # depth_histogram[b] = fraction of paths whose last segment was bounce
    # b (a miss adds the background, an absorbing or emissive hit)
    depth_histogram: np.ndarray

    @property
    def lane_rays(self) -> int:
        """Wavefront lane-bounces processed (the hardware-work count)."""
        return self.width * self.height * self.spp * self.depth

    @property
    def useful_rays(self) -> float:
        """Live ray-bounces actually contributing (occupancy-weighted)."""
        return float(self.width * self.height * self.spp
                     * self.occupancy.sum())

    @property
    def mrays_per_s(self) -> float:
        return self.lane_rays / self.wall_s / 1e6

    def report(self) -> str:
        occ = " ".join(f"{x:.2f}" for x in self.occupancy)
        hist = " ".join(f"{x:.2f}" for x in self.depth_histogram)
        return (
            f"{self.width}x{self.height} {self.spp}spp depth{self.depth}: "
            f"{self.wall_s:.2f}s, {self.mrays_per_s:.2f} Mrays/s "
            f"(lane), {self.useful_rays / self.wall_s / 1e6:.2f} useful\n"
            f"  occupancy/bounce: {occ}\n"
            f"  termination histogram: {hist}")


def occupancy_probe(scene, width: int, height: int, key, depth: int = 4,
                    chunk_size: int = 8192,
                    sample_chunks: int | None = None) -> RenderStats:
    """The live lanes entering each bounce of a 1-spp wave (wave 0 of
    ``key``), chunk by chunk (the first ``sample_chunks`` when given),
    through the split route's bounce (``ops/integrator.bounce_split``, the
    compact wavefront's) on the scene's device: JAX's ``occupancy_probe``
    (``utils/metrics.py:62``). A diagnostic pass with a host read a
    bounce; the renderer does not pay for it."""
    from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
    from rust_ray_tracer_tpu_torch.ops import uber
    from rust_ray_tracer_tpu_torch.ops.integrator import (bounce_split,
                                                          make_split_tables)
    from rust_ray_tracer_tpu_torch.utils import rng as rngu

    n_chunks = -(-(width * height) // chunk_size)
    if sample_chunks is not None:
        n_chunks = min(n_chunks, sample_chunks)
    dev = scene.device
    wkey = rngu.wave_key(key.to(dev), 0)
    t0 = time.perf_counter()
    counts = np.zeros(depth + 1)
    with torch.no_grad():
        tables = make_split_tables(scene)
        for c in range(n_chunks):
            ids = torch.tensor([c], device=dev)
            o, d, t, ckey = cam_ops.camera_rays_for_chunks(
                scene.camera, wkey, ids, chunk_size, width, height)
            st = uber.chunk_state(o, d, t)[:, :, :chunk_size].reshape(
                uber.N_STATE, chunk_size)
            rnd = uber.chunk_randoms(scene, rngu.stream(ckey, rngu.CHUNK),
                                     chunk_size, depth)
            alive = [st[7].sum()]
            for b in range(depth):
                st = bounce_split(scene, st, rnd[b], tables, chunk_size)
                alive.append(st[7].sum())
            counts += torch.stack(alive).cpu().numpy()
    wall = time.perf_counter() - t0
    total = n_chunks * chunk_size
    return RenderStats(width=width, height=height, spp=1, depth=depth,
                       wall_s=wall, occupancy=counts[:depth] / total,
                       depth_histogram=-np.diff(counts) / total)


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host and, with a card,
    device activity), written as a Chrome trace to
    ``log_dir/trace.json`` (view it in Perfetto or chrome://tracing).
    JAX's context of this name wrote a ``jax.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Tiny rays/s meter for host-side loops: ``step()`` after each step
    returns the rays a second since the meter was made."""

    def __init__(self, rays_per_step: int):
        self.rays_per_step = rays_per_step
        self.t0 = time.time()
        self.steps = 0

    def step(self) -> float:
        self.steps += 1
        return self.rays_per_step * self.steps / (time.time() - self.t0)
