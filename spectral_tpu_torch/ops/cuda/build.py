"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Each ``csrc/*.cu`` file is compiled on first use into its own shared
library with a plain C entry point:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v -o lib<name>_<hash>.so <name>.cu

into ``build/spectral_tpu_torch/`` at the root of the checkout. The file
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads what is there. ``build_all`` starts one nvcc
per source at once and waits for all of them.

-fmad=false and the absence of --use_fast_math are deliberate: the kernels
must take the same discrete decisions as their plain PyTorch versions (see
csrc/hit.cuh), which round every operation once.

A missing nvcc or a failed build raises; nothing falls back to the plain
versions. Each ``Kernel`` is one C entry point with its own launch count in
``launches``; entry points of one source share its library, which is built
and loaded once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ...utils.trace import span

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "spectral_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
# the leaf scene of the leaf sweep's entry points (render_kernel.py::
# leaf_launch_args): rows, ids, leaf, group, super-group tables; leaves,
# leaf size, groups, super-groups
LEAF_SCENE = [P, P, P, P, P, I, I, I, I]


def find_nvcc() -> str:
    """Path of nvcc: $NVCC, then PATH, then $CUDA_HOME/bin (default
    /usr/local/cuda). Raises when there is none."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and need "
        "the CUDA toolkit (set CUDA_HOME or NVCC)"
    )


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._symbols = {}

    def library(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def _start_build(self) -> tuple[subprocess.Popen, Path] | None:
        lib = self.library()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, proc: subprocess.Popen, tmp: Path) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {self.source.name}:\n{out}")
        os.replace(tmp, self.library())

    def symbol(self, entry: str, argtypes: list):
        """A C function of this kernel's library returning int, building
        and loading the library first if needed."""
        if entry not in self._symbols:
            build_all([self])
            lib = self.library()
            if lib not in _LOADED:
                with span("kernel.load"):
                    _LOADED[lib] = ctypes.CDLL(str(lib))
            fn = getattr(_LOADED[lib], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._symbols[entry] = fn
        return self._symbols[entry]

    def function(self):
        """The loaded C entry point."""
        return self.symbol(self.entry, self.argtypes)

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream (the stream is appended as
        the last argument); raises unless the launch was accepted."""
        fn = self.function()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA error {rc}")
        self.launches += 1


_LOADED: dict[Path, ctypes.CDLL] = {}


def build_all(kernels) -> None:
    """Compile every library that is missing, one nvcc process per source,
    all at once."""
    by_lib: dict[Path, list[Kernel]] = {}
    for k in kernels:
        by_lib.setdefault(k.library(), []).append(k)
    started = [(ks, b) for ks in by_lib.values() if (b := ks[0]._start_build()) is not None]
    errors = []
    for ks, (proc, tmp) in started:
        try:
            with span("kernel.build"):
                ks[0]._finish_build(proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
        for k in ks[1:]:
            k.build_log = ks[0].build_log
    if errors:
        raise RuntimeError("\n".join(errors))


INTERSECT = Kernel(
    "intersect", "intersect_kernel.cu", "intersect_launch",
    [P, I, P, P, I, I, P, P, P, P, P],
)
RENDER = Kernel(
    "render", "render_kernel.cu", "render_launch",
    [P, ctypes.c_uint32, P, I, P, I, P, P, P, I, I, I, I, P, P, P, P, P, P],
)
RENDER_RESIDUALS = Kernel(
    "render_residuals", "render_kernel.cu", "render_residuals_launch",
    [P, ctypes.c_uint32, P, I, P, I, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P],
)
RENDER_LEAVES = Kernel(
    "render_leaves", "render_kernel.cu", "render_leaves_launch",
    [P, ctypes.c_uint32, *LEAF_SCENE, P, I, P, P, P, I, I, I, I, P, P, P, P, P, P, P],
)
RENDER_LEAVES_RESIDUALS = Kernel(
    "render_leaves_residuals", "render_kernel.cu", "render_leaves_residuals_launch",
    [P, ctypes.c_uint32, *LEAF_SCENE, P, I, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P, P, P],
)
GRAD = Kernel(
    "grad", "grad_kernel.cu", "grad_launch",
    [P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, P, P, P],
)
WAVEFRONT_CAMERA = Kernel(
    "wavefront_camera", "wavefront_kernel.cu", "wavefront_camera_launch",
    [P, ctypes.c_uint32, *LEAF_SCENE, P, I, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P, P],
)
WAVEFRONT_BOUNCE = Kernel(
    "wavefront_bounce", "wavefront_kernel.cu", "wavefront_bounce_launch",
    [ctypes.c_uint32, *LEAF_SCENE, P, I, P, P, P, I, I, I, I, P, I, P, P, P, P, P, P, P, P, P, P],
)
WAVEFRONT_INTEGRATE = Kernel(
    "wavefront_integrate", "wavefront_kernel.cu", "wavefront_integrate_launch",
    [P, P, P, I, I, P, P, P, P, P, P],
)
KERNELS = {
    k.name: k
    for k in (
        INTERSECT, RENDER, RENDER_RESIDUALS, RENDER_LEAVES, RENDER_LEAVES_RESIDUALS, GRAD,
        WAVEFRONT_CAMERA, WAVEFRONT_BOUNCE, WAVEFRONT_INTEGRATE,
    )
}
