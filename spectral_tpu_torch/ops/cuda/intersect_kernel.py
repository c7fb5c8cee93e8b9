"""Dense ray-triangle nearest hit: the CUDA kernel and its plain version.

Port of spectral_tpu/ops/pallas/intersect_kernel.py. ``intersect`` launches
csrc/intersect_kernel.cu for CUDA tensors and runs the plain PyTorch
version (ops/intersect.py::nearest_hit) for CPU tensors; there is no other
fallback. It takes any number of triangles: the kernel streams the pack
through shared memory in tiles of MAX_TRIS. With ``xla=True`` both take
the dots of the triangle test in the order of the XLA-style renderer's
intersect_block (ops/fp32.py::sum3): the selection of that renderer's
nearest hit (ops/intersect.py::nearest_hit_scene).
"""

from __future__ import annotations

import torch

from ..intersect import nearest_hit
from . import build

# triangle constant pack layout: [T, 16] =
#   normal(0:3), d(3), edge_g(4:13, row-major 3x3), edge_c(13:16)
TRI_PACK_WIDTH = 16
# triangles a tile of the pack in one block's shared memory, 64 bytes a
# triangle, within the 48 KB a launch gets without asking
# (csrc/intersect_kernel.cu kTile)
MAX_TRIS = 48 * 1024 // (4 * TRI_PACK_WIDTH)


def pack_tris(scene) -> torch.Tensor:
    """Per-triangle constants in the [T, 16] layout."""
    return torch.cat(
        [scene.normal, scene.d[:, None], scene.edge_g.reshape(-1, 9), scene.edge_c],
        dim=1,
    ).to(torch.float32).contiguous()


def intersect(o: torch.Tensor, d: torch.Tensor, tri_pack: torch.Tensor, xla: bool = False):
    """Nearest hit of rays o, d [N, 3] over tri_pack [T, 16]: (t [N] f32,
    BIG on a miss; idx [N] int32; hit [N] bool; front [N] bool). ``xla``:
    the dots in the XLA-style renderer's order."""
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or tri_pack.ndim != 2 or tri_pack.shape[1] != TRI_PACK_WIDTH:
        raise ValueError(f"bad shapes o {tuple(o.shape)}, d {tuple(d.shape)}, tri_pack {tuple(tri_pack.shape)}")
    if o.device.type == "cpu":
        return nearest_hit(o, d, tri_pack, xla)
    if o.device.type != "cuda" or d.device != o.device or tri_pack.device != o.device:
        raise ValueError("o, d and tri_pack must lie on one CUDA device (or the CPU)")
    o = o.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    tri_pack = tri_pack.to(torch.float32).contiguous()
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    idx = torch.empty(n, dtype=torch.int32, device=o.device)
    hit = torch.empty(n, dtype=torch.bool, device=o.device)
    front = torch.empty(n, dtype=torch.bool, device=o.device)
    build.INTERSECT.launch(
        o.device, tri_pack.data_ptr(), tri_pack.shape[0], o.data_ptr(), d.data_ptr(), n, int(xla),
        t.data_ptr(), idx.data_ptr(), hit.data_ptr(), front.data_ptr(),
    )
    return t, idx, hit, front
