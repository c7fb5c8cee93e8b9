"""Recover a metal's fuzz (roughness) from a target image.

Port of examples/inverse_fuzz.py. Through the plain estimator
d(pixel)/d(fuzz) is zero almost everywhere (the scattered direction moves
smoothly with fuzz, but radiance is a step function of direction). The
fuzz-sphere warp (diff/fuzz_warp.py) composes each sphere sample with a
field that tracks the closed-form silhouette preimages s(c) = mu(c) e - c r
(c = 1/fuzz); its area element carries the boundary terms into autograd
(right in sign and scale, ~20% finite-kernel accuracy, heavy-tailed).

Scene: a fuzzy metal floor reflecting a small emissive patch, 16x16, 8 spp,
2 bounces; the reflection's blur is fuzz's visible signature. The fuzz
starts at 0.40 against a truth of 0.25; SGD on the MSE pixel loss walks it
back with rendered-image gradients alone.

    python -m spectral_tpu_torch.examples.inverse_fuzz [--device cuda|cpu] [--steps N]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..diff.vertex_warp import edges_from_vertices
from ..models.camera import make_camera
from ..models.geometry import TriSoup
from ..models.materials import MaterialBuilder
from ..models.scenes import scene_from_soup
from ..render.wavefront import chunk_pixels, render_tile_xyz
from ..utils.device import resolve_device
from ..utils.prng import fold

SIZE, SPP, BOUNCES = 16, 8, 2
F_TRUE, F_START = 0.25, 0.40
# calibrated in the JAX example: the MSE gradient is a clean attractor
# around the truth (g ~ +8 +- 1.8 at 0.32, -20 at 0.20), so small steps do;
# the clip bounds the occasional heavy-tail spike
STEPS, LR, M, CLIP, SEED = 60, 2.5e-3, 4, 40.0, 11
F_LO, F_HI = 0.02, 0.9


def build(device: torch.device | str = "cuda"):
    """(scene, camera, the metal's material row) of
    examples/inverse_fuzz.py:45-56."""
    mb = MaterialBuilder()
    metal = mb.metallic((0.9, 0.9, 0.9), F_TRUE)
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    soup = TriSoup()
    soup.quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), metal)
    soup.quad((0.5, 2.5, -0.5), (1.2, 0.0, 0.0), (0.0, 0.0, 1.2), light)
    scene = scene_from_soup(soup, mb.build(), device)
    cam = make_camera(SIZE, SIZE, vfov=60.0, lookfrom=(0.0, 1.2, -3.0), lookat=(0.5, 0.0, 0.0), device=device)
    return scene, cam, metal


class Problem:
    """The renders at the metal's fuzz f, and the MSE gradient."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.scene, self.cam, self.metal = build(device)
        s = self.scene
        self.edges = edges_from_vertices(s.v0, s.v1, s.v2)
        self.px, self.py = chunk_pixels(0, 0, SIZE, SIZE, s.v0.device)
        self.hot = torch.nn.functional.one_hot(torch.tensor(self.metal), s.materials.fuzz.shape[0]).to(s.v0.device)

    def render(self, f, key: int, warp: bool) -> torch.Tensor:
        """Mean-per-sample XYZ [N, 3] with the metal's fuzz at f."""
        mats = self.scene.materials
        fuzz = torch.where(self.hot.bool(), f, mats.fuzz)
        s = dataclasses.replace(self.scene, materials=dataclasses.replace(mats, fuzz=fuzz))
        xyz = render_tile_xyz(s, self.cam, self.px, self.py, key, SPP, BOUNCES,
                              fuzz_warp=self.edges if warp else None)
        return xyz / SPP

    def one_grad(self, f: float, k1: int, k2: int) -> tuple[float, float]:
        """(MSE, d MSE / d f): the residual a common-random-numbers pair at
        key k1, the gradient factor the warped VJP at the independent key
        k2 (as in examples/inverse_geometry.py)."""
        dev = self.scene.v0.device
        ft = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        with torch.no_grad():
            resid = self.render(ft(f), k1, False) - self.render(ft(F_TRUE), k1, False)
        t = ft(f).requires_grad_(True)
        out = self.render(t, k2, True)
        (g,) = torch.autograd.grad(out, t, grad_outputs=2.0 * resid / resid.numel())
        return float(torch.mean(resid**2)), float(g)


def main(steps: int = STEPS, device: torch.device | str = "cuda", log=print) -> dict:
    """SGD from F_START for ``steps`` steps of M estimates each, keyed by
    ``fold(SEED, step, estimate, 1 or 2)``; returns the final fuzz and the
    share of the perturbation recovered. Raises AssertionError unless the
    error ends below half its start (the JAX example's gate)."""
    prob = Problem(resolve_device(device))
    f = F_START
    log(f"start   fuzz = {f:.4f}  (truth {F_TRUE})")
    for step in range(1, steps + 1):
        gacc, loss = 0.0, 0.0
        for i in range(M):
            loss, g = prob.one_grad(f, fold(SEED, step, i, 1), fold(SEED, step, i, 2))
            gacc += min(max(g, -CLIP), CLIP)
        f = min(max(f - LR * gacc / M, F_LO), F_HI)
        if step % 15 == 0:
            log(f"step {step:3d}  loss {loss:.3e}  fuzz = {f:.4f}")
    err0, err = abs(F_START - F_TRUE), abs(f - F_TRUE)
    share = 1.0 - err / err0
    log(f"final   fuzz = {f:.4f}")
    log(f"recovered {100.0 * share:.1f}% of the perturbation")
    if not err < 0.5 * err0:  # the JAX example's assert, kept under python -O
        raise AssertionError("fuzz recovery failed")
    return {"fuzz": f, "recovered": share}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    main(a.steps, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
