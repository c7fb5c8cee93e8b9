"""Host-side render orchestration: the chunked progressive render loop.

Port of spectral_tpu/runtime/render_manager.py (reference
rendering/render_manager.cu:3-66 ``step``, render_manager.cuh:68-181
producer/consumer double buffer). Kernel launches are asynchronous on the
device's current stream, so the reference's worker thread + semaphores
become "launch chunk k+1 before copying chunk k to the host": the device
renders the next chunk while the host consumes the last.

With ``--impl auto`` or ``kernel`` each chunk is one render through the
kernels (ops/cuda/render_kernel.py::render_chunk), seeded as the JAX
megakernel path seeds it (render_manager.py:121); with ``--impl xla`` it is
the XLA-style renderer's chunk (render/wavefront.py::render_chunk) keyed by
``fold(key, y0 * W + x0)``, as the JAX manager keys it (:127-130).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from ..config import RenderParams
from ..models.camera import Camera
from ..ops.cuda.render_kernel import render_chunk
from ..render import wavefront
from ..render.wavefront import xyz_to_image
from ..utils.logging import LogContext
from ..utils.prng import fold
from ..utils.trace import span


def chunk_seed(x0: int, y0: int, image_width: int) -> int:
    """Seed of the chunk at (x0, y0), masked to 31 bits."""
    return (1984 + (y0 * image_width + x0) * 1000003) & 0x7FFFFFFF


@dataclass
class ChunkResult:
    x0: int
    y0: int
    width: int
    height: int
    xyz: torch.Tensor  # accumulated XYZ [h, w, 3] (device)


@dataclass
class RenderManager:
    """Owns the chunk grid and the progressive accumulation buffer."""

    scene: object
    cam: Camera
    params: RenderParams
    log: LogContext | None = None
    _fb_xyz: np.ndarray = field(init=False)

    def __post_init__(self):
        self._fb_xyz = np.zeros(
            (self.cam.image_height, self.cam.image_width, 3), np.float32
        )

    @property
    def device(self) -> torch.device:
        return self.scene.normal.device

    def chunks(self) -> Iterator[tuple[int, int, int, int]]:
        """Row-major chunk grid (render_manager.cu:56-64 offset advance).
        Edge chunks are clamped to the image, not skipped."""
        cw, ch = self.params.chunk_width, self.params.chunk_height
        w, h = self.cam.image_width, self.cam.image_height
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                yield x0, y0, min(cw, w - x0), min(ch, h - y0)

    def render(
        self,
        on_chunk: Callable[[ChunkResult, np.ndarray], None] | None = None,
        checkpoint: str | None = None,
        key: int = 1984,
    ) -> np.ndarray:
        """Render all chunks with a 2-deep launch pipeline; returns the
        uint8 sRGB image. ``on_chunk`` receives each finished chunk plus the
        full-frame XYZ accumulator (the progressive-display hook,
        main.cpp:33-41).

        ``checkpoint``: path to a .npz tile checkpoint. Completed chunks
        are persisted after each consume and skipped on restart; a chunk is
        a pure function of (scene, camera, chunk, key), so resume is exact.
        ``key``: the XLA-style renderer's root key (the JAX CLI's
        PRNGKey(1984)); the kernels seed each chunk from its position.
        """
        with span("render.frame"):
            return self._render(on_chunk, checkpoint, key)

    def _render(self, on_chunk, checkpoint, key) -> np.ndarray:
        p = self.params
        t0 = time.perf_counter()

        done: set[tuple[int, int]] = set()
        if checkpoint and os.path.exists(checkpoint):
            with np.load(checkpoint) as z:
                self._fb_xyz = z["fb_xyz"]
                done = {(int(a), int(b)) for a, b in z["done"]}

        def save_ckpt():
            if checkpoint:
                tmp = checkpoint + ".tmp.npz"
                np.savez(
                    tmp,
                    fb_xyz=self._fb_xyz,
                    done=np.asarray(sorted(done), np.int64).reshape(-1, 2),
                )
                os.replace(tmp, checkpoint)

        def launch(x0, y0, w, h) -> ChunkResult:
            if p.impl == "xla":
                with torch.no_grad():
                    xyz = wavefront.render_chunk(
                        self.scene, self.cam, fold(key, y0 * self.cam.image_width + x0), x0, y0, w, h,
                        p.nsamples, p.bounce_limit,
                    )
            else:
                seed = chunk_seed(x0, y0, self.cam.image_width)
                xyz = render_chunk(
                    self.scene, self.cam, seed, x0, y0, w, h, p.nsamples, p.bounce_limit
                )
            return ChunkResult(x0, y0, w, h, xyz)

        grid = [c for c in self.chunks() if (c[0], c[1]) not in done]
        launched: list[ChunkResult] = []
        # double-buffer: keep one chunk in flight ahead of the consumer
        for spec in grid:
            launched.append(launch(*spec))
            if len(launched) >= 2:
                self._consume(launched.pop(0), on_chunk, done)
                save_ckpt()
        while launched:
            self._consume(launched.pop(0), on_chunk, done)
            save_ckpt()

        dt = time.perf_counter() - t0
        if self.log is not None:
            self.log.add_entry("total rendering time (seconds)", dt)
            self.log.add_entry("chunks", len(grid))
            self.log.add_entry("samples per pixel", p.nsamples)
            self.log.add_entry("bounce limit", p.bounce_limit)
            self.log.add_entry("renderer", "xla" if p.impl == "xla" else "kernel")
            self.log.add_entry(
                "resolution", f"{self.cam.image_width}x{self.cam.image_height}"
            )
        return self.image()

    def _consume(self, c: ChunkResult, on_chunk, done: set) -> None:
        with span("render.wait"):
            xyz = c.xyz.cpu().numpy()  # waits for this chunk only
        self._fb_xyz[c.y0 : c.y0 + c.height, c.x0 : c.x0 + c.width] = xyz
        done.add((c.x0, c.y0))
        if on_chunk is not None:
            on_chunk(c, self._fb_xyz)

    def image(self) -> np.ndarray:
        """Current framebuffer as uint8 sRGB (save_to_fb + image_channels),
        converted on the render device."""
        with span("render.image"):
            fb = torch.from_numpy(self._fb_xyz).to(self.device)
            img = xyz_to_image(fb, self.params.nsamples)
            with span("render.wait"):
                return img.cpu().numpy()
