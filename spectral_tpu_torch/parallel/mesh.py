"""The (tile, sample) device mesh on torch.distributed.

Port of spectral_tpu/parallel/mesh.py. The JAX package lays a static 2D
``jax.sharding.Mesh`` over the devices of one controller: image rows shard
over ``tile`` (no communication while tracing) and samples per pixel over
``sample`` (the partial XYZ sums are psum-reduced). PyTorch runs one
process per device instead, so a mesh here is this process's place in that
grid: its coordinates (ti, si), with rank = ti * n_sample + si as JAX's
``reshape(n_tile, n_sample)`` orders the devices, and the two process
groups its collectives run over, the ranks that share ``ti`` (the sample
axis) and the ranks that share ``si`` (the tile axis).

With no process group the mesh is 1 x 1 (``Mesh.one``): it holds no group
and makes no collective call, so every one-device function keeps its
one-device results bit for bit. A group of one rank (a world of 1) still
makes its collective calls, which start the backend.

The backend is the caller's choice (``parallel/distributed.py::
init_distributed``): NCCL when every rank has its own card, gloo on the
CPU, and gloo also for ranks that share one card (NCCL refuses two ranks on
one device). Gloo's all-reduce takes CUDA tensors; its all-gather does not,
which is why rows are assembled by an all-reduce (``Mesh.assemble_rows``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..utils.trace import span

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (tile, sample) mesh extents (mesh.py:32).

    Prefers tile-parallelism (zero communication during tracing) and gives
    the sample axis the small factor: for n = 8 -> (4, 2); for primes
    -> (n, 1).
    """
    best = (n, 1)
    for s in range(2, int(math.isqrt(n)) + 1):
        if n % s == 0:
            best = (n // s, s)
    return best


class _SumAcross(torch.autograd.Function):
    """The all-reduced sum of ``x`` over ``group`` forward, the cotangent
    unchanged backward. Each rank's gradient is then its own shard's share;
    one all-reduce of the gradients over every rank sums the shares into
    the gradient of the whole. (``torch.distributed.nn``'s all_reduce
    all-reduces the cotangent again, which makes the gradient n times too
    large for a loss that every rank of the group computes: ROADMAP C8.)"""

    @staticmethod
    def forward(ctx, x, mesh, group):
        return mesh._all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class Mesh:
    """This process's place in a (tile, sample) mesh.

    ``shape``: {"tile": nt, "sample": ns}; ``ti``, ``si``: this rank's
    coordinates; ``rank`` = ti * ns + si; ``device``: the rank's device;
    ``sample_group`` / ``tile_group``: the process groups of the ranks that
    share ``ti`` / ``si`` (None on the 1 x 1 mesh of a process with no
    process group, which makes no collective call); ``collectives`` counts
    the collective calls, each a ``mesh.all_reduce`` span
    (utils/trace.py).
    """

    def __init__(self, nt: int, ns: int, ti: int, si: int, device, sample_group=None, tile_group=None,
                 distributed: bool = False):
        self.shape = {TILE_AXIS: nt, SAMPLE_AXIS: ns}
        self.ti, self.si = ti, si
        self.rank = ti * ns + si
        self.device = torch.device(device)
        self.sample_group, self.tile_group = sample_group, tile_group
        self.distributed = distributed
        self.collectives = 0

    @classmethod
    def one(cls, device="cpu") -> "Mesh":
        """The 1 x 1 mesh of a process with no process group."""
        return cls(1, 1, 0, 0, device)

    def shard(self, height: int, samples_per_pixel: int) -> tuple[int, int, int]:
        """(row0, rows, local spp) of this rank's shard of an image; raises
        ValueError unless the mesh extents divide the height and the spp."""
        nt, ns = self.shape[TILE_AXIS], self.shape[SAMPLE_AXIS]
        if height % nt or samples_per_pixel % ns:
            raise ValueError(f"height {height} / spp {samples_per_pixel} must divide mesh ({nt} x {ns})")
        rows = height // nt
        return self.ti * rows, rows, samples_per_pixel // ns

    def shard_seed(self, seed: int, stride: int) -> int:
        """The kernels' seed of this rank's shard: seed + rank * stride
        (render.py:175, :290)."""
        return int(seed) + self.rank * stride

    def _all_reduce(self, x: torch.Tensor, group) -> torch.Tensor:
        self.collectives += 1
        with span("mesh.all_reduce"):
            dist.all_reduce(x, group=group)
        return x

    def _group(self, axis: str | None):
        return {SAMPLE_AXIS: self.sample_group, TILE_AXIS: self.tile_group, None: None}[axis]

    def sum(self, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axis`` (SAMPLE_AXIS,
        TILE_AXIS, or None for every rank), differentiable with the
        cotangent passed on unchanged (``_SumAcross``). ``x`` itself on a
        mesh with no process group."""
        if not self.distributed:
            return x
        return _SumAcross.apply(x.contiguous(), self, self._group(axis))

    def assemble_rows(self, rows_xyz: torch.Tensor, row0: int, height: int) -> torch.Tensor:
        """The whole [height, ...] image on every rank from each tile's rows
        [rows, ...] at ``row0``: the rows written into zeros, then summed
        over the tile axis (x + 0 is exact). Differentiable as ``sum``: the
        rank's rows get the image's cotangent at their place."""
        if not self.distributed:
            return rows_xyz
        full = torch.nn.functional.pad(rows_xyz, (0, 0) * (rows_xyz.dim() - 1) + (row0, height - row0 - rows_xyz.shape[0]))
        return self.sum(full, TILE_AXIS)


def _default_device(device) -> torch.device:
    """``device``, a CUDA device without an index taken as this rank's card
    (rank modulo the cards this process sees)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def mesh_of_shape(nt: int, ns: int, device="cuda") -> Mesh:
    """A (nt, ns) mesh over the ranks of the initialized world (nt * ns of
    them; rank = ti * ns + si). Every rank must call it, with the same
    shape: it creates every group of both axes, in the same order on every
    rank (``dist.new_group`` is collective). Without a process group only
    (1, 1) is possible, the mesh with no group."""
    dev = _default_device(device)
    if not dist.is_initialized():
        if (nt, ns) != (1, 1):
            raise ValueError(f"a {nt} x {ns} mesh needs a process group of {nt * ns} ranks (init_distributed)")
        return Mesh.one(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if nt * ns != world:
        raise ValueError(f"a {nt} x {ns} mesh does not cover the world of {world} ranks")
    ti, si = divmod(rank, ns)
    sample_group = tile_group = None
    for t in range(nt):
        g = dist.new_group([t * ns + s for s in range(ns)])
        if t == ti:
            sample_group = g
    for s in range(ns):
        g = dist.new_group([t * ns + s for t in range(nt)])
        if s == si:
            tile_group = g
    return Mesh(nt, ns, ti, si, dev, sample_group, tile_group, distributed=True)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The (tile, sample) mesh over the ``n_devices`` ranks of the world,
    factored by ``factor_devices`` (mesh.py:45). With no process group and
    ``n_devices`` in (None, 1), the 1 x 1 mesh with no group. Raises when
    ``n_devices`` is not the world's size: a rank cannot leave the mesh
    while the others build its groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n_devices}): the world has {world} ranks, one device each")
    return mesh_of_shape(*factor_devices(n), device=device)
