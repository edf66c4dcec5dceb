"""Render checkpoint / resume.

Counterpart of ``rust_ray_tracer_tpu/parallel/checkpoint.py``, in its
``.npz`` layout (``acc`` and a ``meta`` JSON): the sum image, the waves
done and the settings are saved every ``ckpt_every`` waves, atomically,
and a render resumes from them bitwise — ``render_waves`` and
``render_waves_sharded`` reproduce the monolithic float-add order from
``wave_start`` and ``acc0``. JAX passed those two traced, only to share one
compile across segments; here they are plain arguments.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from rust_ray_tracer_tpu_torch.ops.integrator import MAX_DEPTH, render_waves
from rust_ray_tracer_tpu_torch.utils import rng


@dataclasses.dataclass
class RenderState:
    acc: np.ndarray          # [H, W, 3] radiance sum over completed waves
    waves_done: int
    seed: int
    width: int
    height: int
    chunk_size: int
    depth: int = MAX_DEPTH

    @property
    def image(self) -> np.ndarray:
        """Mean radiance so far (pre-tonemap)."""
        return self.acc / max(self.waves_done, 1)


_META = ("waves_done", "seed", "width", "height", "chunk_size", "depth")


def save_state(path: str, state: RenderState) -> None:
    """Atomic save (write a temporary file, then rename), so a crash in
    the middle of a write never corrupts the previous checkpoint."""
    meta = {k: getattr(state, k) for k in _META}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, acc=np.asarray(state.acc, np.float32),
                     meta=json.dumps(meta))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> RenderState:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        return RenderState(acc=z["acc"], **meta)


def render_with_checkpoints(scene, width: int, height: int, spp: int,
                            seed: int, ckpt_path: str, ckpt_every: int = 8,
                            depth: int = MAX_DEPTH, chunk_size: int = 32768,
                            mesh=None, compact: bool = False,
                            progress=None):
    """Render ``spp`` waves of ``scene`` from ``seed``, checkpointing to
    ``ckpt_path`` every ``ckpt_every`` waves and resuming from it if it
    exists; returns the mean image [H, W, 3] on the scene's device.
    Raises ``ValueError`` for a checkpoint of other settings.

    ``mesh``: a ``RayMesh`` — the sharded renderer; rank 0 writes the
    checkpoint and every rank waits for it at a barrier. ``progress``: a
    callable(waves_done, spp) after each checkpoint.
    """
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    settings = (seed, width, height, chunk_size, depth)
    if os.path.exists(ckpt_path):
        st = load_state(ckpt_path)
        if (st.seed, st.width, st.height, st.chunk_size, st.depth) != \
                settings:
            raise ValueError(
                f"checkpoint {ckpt_path} was rendered with different "
                "settings; delete it or change --checkpoint")
    else:
        st = RenderState(acc=np.zeros((height, width, 3), np.float32),
                         waves_done=0, seed=seed, width=width,
                         height=height, chunk_size=chunk_size, depth=depth)
    dev = scene.device
    key = rng.key(seed, dev)
    writer = mesh is None or mesh.rank == 0

    def segment(acc, start, n):
        if mesh is None:
            return render_waves(scene, width, height, key, start, n, depth,
                                chunk_size, acc0=acc, compact=compact)
        from rust_ray_tracer_tpu_torch.parallel.render import (
            render_waves_sharded)
        return render_waves_sharded(scene, width, height, key, start, n,
                                    mesh, depth, chunk_size, acc0=acc,
                                    compact=compact)

    acc = torch.from_numpy(np.array(st.acc, np.float32)).to(dev)
    done = st.waves_done
    while done < spp:
        n = min(ckpt_every, spp - done)
        with torch.no_grad():
            acc = segment(acc, done, n)
        done += n
        if writer:
            save_state(ckpt_path, RenderState(
                acc=acc.cpu().numpy(), waves_done=done, seed=seed,
                width=width, height=height, chunk_size=chunk_size,
                depth=depth))
        if mesh is not None and mesh.group is not None:
            dist.barrier(group=mesh.group)
        if progress is not None:
            progress(done, spp)
    return acc / max(spp, 1)
