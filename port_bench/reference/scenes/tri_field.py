"""The large scene: the Cornell shell and light with a jittered grid of
rotated boxes (the program's documented large-scene row), rebuilt from its
description."""

from __future__ import annotations

import math

import numpy as np

from ..scene import EMISSIVE, LAMBERTIAN, METALLIC, Material, Soup, cornell_walls


def soup(spec: dict) -> tuple[Soup, list[Material]]:
    """The Cornell shell and light with a jittered grid of rotated boxes
    (numpy's RandomState(seed): width, height, x, z, then the yaw of each
    box in turn), until there are at least ``n_tris`` triangles."""
    n_tris, seed = int(spec["n_tris"]), int(spec["seed"])
    rng = np.random.RandomState(seed)
    mats = [
        Material(LAMBERTIAN, (0.73, 0.73, 0.73)),
        Material(LAMBERTIAN, (0.65, 0.05, 0.05)),
        Material(LAMBERTIAN, (0.12, 0.45, 0.15)),
        Material(METALLIC, (0.8, 0.85, 0.88), fuzz=0.0),
        Material(EMISSIVE, (1.0, 1.0, 1.0), power=7.0),
    ]
    white, red, green, metal, light = range(5)
    soup = Soup()
    cornell_walls(soup, (white, white, white, green, red), light)
    box_mats = (white, red, green, metal)
    n_boxes = max(0, -(-(n_tris - len(soup)) // 12))
    grid = int(math.ceil(math.sqrt(n_boxes)))
    cell = 520.0 / grid
    i = 0
    for gz in range(grid):
        for gx in range(grid):
            if i >= n_boxes:
                break
            w = cell * (0.25 + 0.35 * rng.rand())
            h = 10.0 + 120.0 * rng.rand() ** 2
            x = 15.0 + gx * cell + (cell - w) * rng.rand()
            z = 15.0 + gz * cell + (cell - w) * rng.rand()
            s = len(soup)
            soup.box((x, 0.0, z), (x + w, h, z + w), box_mats[i % 4])
            soup.rotate_y(s, rng.rand() * 90.0, soup.bbox_center(s))
            i += 1
    return soup, mats
