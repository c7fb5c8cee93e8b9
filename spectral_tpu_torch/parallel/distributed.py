"""The multi-process entry: torch.distributed wiring and the global mesh.

Port of spectral_tpu/parallel/distributed.py. PyTorch runs one process per
device, so a run over several devices, on one host or many, is a world of
processes that meet at a coordinator:

    # one process per device, i = 0 .. N - 1, on every host
    SPECTRAL_COORD=host0:8476 SPECTRAL_NPROC=N SPECTRAL_PROC_ID=$i \\
        python -m spectral_tpu_torch.examples.inverse_rendering

``init_distributed`` joins that world; ``make_global_mesh`` lays the
(tile, sample) mesh over it host-major, as the JAX function does: image
rows shard over hosts first, and the sample axis stays inside a host, so
the per-pixel XYZ sum over samples never leaves it; only the tile axis's
collectives (the row assembly, the scalar loss) and the gradient
all-reduce cross hosts. ``local_row_block`` gives this rank's rows.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from .mesh import SAMPLE_AXIS, TILE_AXIS, Mesh, factor_devices, mesh_of_shape

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device="cuda",
) -> bool:
    """Join the world of a multi-process run; returns True when it holds
    more than one process (distributed.py:55).

    The arguments default from SPECTRAL_COORD (``host:port``, or any
    ``init_method`` URL such as ``file:///path``), SPECTRAL_NPROC and
    SPECTRAL_PROC_ID. With no coordinator anywhere this does nothing. The
    backend is ``backend``, else NCCL for a ``cuda`` device and gloo for
    the CPU; ranks that share one card need ``backend="gloo"`` (NCCL
    refuses two ranks on one device). With NCCL the process takes card
    ``process_id`` modulo the cards it sees. Calling it again in a process
    that has joined returns the same answer."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("SPECTRAL_COORD")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["SPECTRAL_NPROC"])
    if process_id is None:
        process_id = int(os.environ["SPECTRAL_PROC_ID"])
    backend = backend or BACKENDS[torch.device(device).type]
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    return num_processes > 1


def ranks_per_host() -> int:
    """How many ranks of the world run on each host (the host names
    all-gathered); raises ValueError unless every host runs as many."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    counts = {names.count(n) for n in names}
    if len(counts) != 1:
        raise ValueError(f"hosts run different numbers of ranks ({sorted(counts)}): the mesh needs as many on each")
    return counts.pop()


def make_global_mesh(device="cuda") -> Mesh:
    """The (tile, sample) mesh over every rank of the world, host-major on
    ``tile`` (distributed.py:86): the sample extent is
    ``factor_devices(ranks_per_host())``'s, so that the sample groups
    stay inside a host (ranks are numbered host by host). On one host this
    is exactly ``make_mesh``; with no process group, the 1 x 1 mesh."""
    if not dist.is_initialized():
        return mesh_of_shape(1, 1, device)
    world = dist.get_world_size()
    _, ns = factor_devices(ranks_per_host())
    return mesh_of_shape(world // ns, ns, device)


def local_row_block(height: int, mesh: Mesh) -> tuple[int, int]:
    """(row0, rows) of this rank's slab of the image (distributed.py:109):
    the rows of its tile. Raises ValueError on extents that do not divide,
    instead of silently dropping rows: a height the tile extent does not
    divide, or a mesh that does not cover the world (each process holds
    one device, so whole tiles per process means one mesh place each)."""
    nt, ns = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if height % nt:
        raise ValueError(f"height {height} must divide the tile extent {nt}")
    if nt * ns != world:
        raise ValueError(
            f"the {nt} x {ns} mesh must cover the {world} processes (one device each, whole tiles per process)"
        )
    rows = height // nt
    return mesh.ti * rows, rows
