"""Recover an occluder's position from a target image (vertex gradients).

Port of examples/inverse_geometry.py. Through the plain path-tracing
estimator d(pixel)/d(vertex) is zero almost everywhere (geometry only
selects which materials a path multiplies); the warped-area estimator
(diff/vertex_warp.py) composes the camera's pixel samples and the
lambertian bounce directions with an edge-built warp whose determinant
carries the silhouette boundary terms, so autograd of the warped estimator
is unbiased for d(image)/d(vertex).

Scene: a lit floor, a small overhead area light and a dark occluder quad
casting a soft shadow, 16x16, 8 spp, 3 bounces. The occluder starts 0.35
to the right of the target pose; SGD on the MSE pixel loss walks it back
with rendered-image gradients alone (the occluder's own silhouette and its
shadow's both act).

    python -m spectral_tpu_torch.examples.inverse_geometry [--device cuda|cpu] [--steps N]
"""

from __future__ import annotations

import argparse

import torch

from ..diff.geometry import scene_with_vertices
from ..diff.vertex_warp import edges_from_vertices
from ..models.camera import make_camera
from ..models.geometry import TriSoup
from ..models.materials import MaterialBuilder
from ..models.scenes import scene_from_soup
from ..render.wavefront import chunk_pixels, render_tile_xyz
from ..utils.device import resolve_device
from ..utils.prng import fold

SIZE, SPP, BOUNCES = 16, 8, 3
START = 0.35  # the occluder's initial x offset from the target pose
# calibrated in the JAX example: a per-estimate g ~ +0.9 at 0.35 (SNR ~1);
# M = 4 estimates a step at lr 0.12 walk 0.35 back in ~10 steps, the clip
# bounds Monte Carlo spikes
STEPS, LR, M, CLIP, SEED = 40, 0.12, 4, 3.0, 3
FIRST_OCCLUDER_TRI = 4


def build(device: torch.device | str = "cuda"):
    """(scene, camera) of examples/inverse_geometry.py:48-62."""
    mb = MaterialBuilder()
    white = mb.lambertian((0.8, 0.8, 0.8))
    dark = mb.lambertian((0.05, 0.05, 0.05))
    light = mb.emissive((1.0, 1.0, 1.0), 6.0)
    soup = TriSoup()
    soup.quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), white)
    soup.quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
    soup.quad((-2.0, 1.5, -1.5), (2.0, 0.0, 0.0), (0.0, 0.0, 3.0), dark)
    scene = scene_from_soup(soup, mb.build(), device)
    cam = make_camera(SIZE, SIZE, vfov=70.0, lookfrom=(0.0, 1.0, -3.0), lookat=(0.0, 0.0, 0.5), device=device)
    return scene, cam


class Problem:
    """The renders of the occluder at offset th, and the MSE gradient."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.scene, self.cam = build(device)
        dev = self.scene.v0.device
        self.px, self.py = chunk_pixels(0, 0, SIZE, SIZE, dev)
        occ = (torch.arange(self.scene.num_tris, device=dev) >= FIRST_OCCLUDER_TRI).to(torch.float32)[:, None]
        self.move = occ * torch.tensor([1.0, 0.0, 0.0], device=dev)

    def render(self, th, key: int, warp: bool) -> torch.Tensor:
        """Mean-per-sample XYZ [N, 3] with the occluder at x offset th."""
        s = self.scene
        v0, v1, v2 = s.v0 + th * self.move, s.v1 + th * self.move, s.v2 + th * self.move
        vw = edges_from_vertices(v0, v1, v2) if warp else None
        xyz = render_tile_xyz(scene_with_vertices(s, v0, v1, v2), self.cam, self.px, self.py, key, SPP, BOUNCES,
                              vertex_warp=vw)
        return xyz / SPP

    def one_grad(self, th: float, k1: int, k2: int) -> tuple[float, float]:
        """(MSE, d MSE / d th). The residual is a common-random-numbers pair
        at key k1, so its noise cancels; the gradient factor is the warped
        render's VJP at the independent key k2 (the warp keeps
        expectations, not per-key joint moments, so a shared key would bias
        the product)."""
        with torch.no_grad():
            resid = self.render(th, k1, False) - self.render(0.0, k1, False)
        t = torch.tensor(th, dtype=torch.float32, device=resid.device, requires_grad=True)
        out = self.render(t, k2, True)
        (g,) = torch.autograd.grad(out, t, grad_outputs=2.0 * resid / resid.numel())
        return float(torch.mean(resid**2)), float(g)


def main(steps: int = STEPS, device: torch.device | str = "cuda", log=print) -> dict:
    """Run SGD from START for ``steps`` steps of M estimates each, keyed by
    ``fold(SEED, step, estimate, 1 or 2)``; return the final offset and the
    share of the displacement recovered. Raises AssertionError unless the
    offset ends below half its start (the JAX example's gate)."""
    prob = Problem(resolve_device(device))
    th = START
    log(f"start   offset = {th:+.4f}")
    for step in range(1, steps + 1):
        gacc, loss = 0.0, 0.0
        for i in range(M):
            loss, g = prob.one_grad(th, fold(SEED, step, i, 1), fold(SEED, step, i, 2))
            gacc += min(max(g, -CLIP), CLIP)  # heavy-tail clip
        th = th - LR * gacc / M
        if step % 10 == 0:
            log(f"step {step:3d}  loss {loss:.3e}  offset = {th:+.4f}")
    share = 1.0 - abs(th) / START
    log(f"final   offset = {th:+.4f}")
    log(f"recovered {100.0 * share:.1f}% of the displacement")
    if not abs(th) < 0.5 * START:  # the JAX example's assert, kept under python -O
        raise AssertionError("geometry recovery failed")
    return {"offset": th, "recovered": share}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    main(a.steps, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
