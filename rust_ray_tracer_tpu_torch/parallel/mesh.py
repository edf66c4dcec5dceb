"""The process group of a sharded render.

Counterpart of ``rust_ray_tracer_tpu/parallel/mesh.py``: where JAX builds
a 1-D ``Mesh`` over every chip (``jax.distributed.initialize`` across
hosts), the port runs one process per device joined in a
``torch.distributed`` group — NCCL between cards, gloo on the CPU — and a
:class:`RayMesh` names this process's rank, the group's size and this
rank's device. Nothing on a machine tells a process of its cluster: the
caller gives the rendezvous address, world size and rank, or runs under
``torchrun``, which sets them in the environment.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from rust_ray_tracer_tpu_torch.utils import device as device_mod


def _torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
        "MASTER_ADDR" in os.environ


def multihost_init(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device=device_mod.DEFAULT,
                   backend: str | None = None) -> None:
    """Join a multi-process render: ``init_process_group`` with TCP
    rendezvous at ``coordinator`` (``host:port``), ``num_processes`` ranks
    and this one's ``process_id``; ``env://`` under ``torchrun`` when no
    coordinator is given. The backend is NCCL for a CUDA ``device``, gloo
    for the CPU, unless ``backend`` names one (NCCL refuses two ranks on
    one card; gloo takes them). A no-op when a group is already up, or
    with no coordinator, one process and no ``torchrun`` environment."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is None:
        if not _torchrun():
            if (num_processes or 1) > 1:
                raise ValueError(f"{num_processes} processes need a "
                                 "coordinator address (host:port)")
            return
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """One rank's view of a sharded render: the process ``group`` (None
    for a world of one process without one), this ``rank``, the world
    ``size`` and this rank's ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(n_devices: int | None = None, device=None) -> RayMesh:
    """This process's :class:`RayMesh` over the default process group (a
    world of one without a group). ``device`` is ``cuda:{LOCAL_RANK}``
    (``LOCAL_RANK`` from the environment, else the rank modulo the visible
    cards) unless the CPU, or another device, is asked for. Raises
    ``ValueError`` when ``n_devices`` exceeds the world, as JAX's
    ``make_mesh`` does when it exceeds the chips, or is fewer: a mesh spans
    the whole group, one device a rank."""
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), \
            dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None:
        if n_devices > size:
            raise ValueError(f"requested {n_devices} devices, have {size}")
        if n_devices < size:
            raise ValueError(f"requested {n_devices} devices of a world of "
                             f"{size}: a mesh spans every rank")
    if device is None:
        device = device_mod.DEFAULT
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        device_mod.resolve(dev)
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)        # NCCL's collectives use it
    return RayMesh(group, rank, size, dev)
