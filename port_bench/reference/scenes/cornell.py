"""The Cornell box of scene 0, as CUDA-spectral-ray-tracer scene/scene.cu:73-130
describes it."""

from __future__ import annotations

from ..scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METALLIC, Material, Soup, cornell_walls


def soup(spec: dict) -> tuple[Soup, list[Material]]:
    """The Cornell box of scene 0: 42 triangles, 7 materials (scene.cu:73-130)."""
    mats = [
        Material(LAMBERTIAN, (0.65, 0.05, 0.05)),
        Material(LAMBERTIAN, (0.12, 0.45, 0.15)),
        Material(DIELECTRIC, (1.0, 1.0, 1.0), glass="flint_glass"),
        Material(LAMBERTIAN, (0.73, 0.73, 0.73)),
        Material(EMISSIVE, (1.0, 1.0, 1.0), power=5.0),
        Material(METALLIC, (0.5, 0.5, 0.5), fuzz=0.3),
        Material(LAMBERTIAN, (0.12, 0.15, 0.45)),
    ]
    red, green, glass, white, light, metal, blue = range(7)
    soup = Soup()
    cornell_walls(soup, (white, white, white, green, blue), light)
    s = len(soup)
    soup.box((0, 0, 0), (165, 330, 165), metal)
    soup.rotate_y(s, 25.0, soup.bbox_center(s))
    soup.translate(s, (265.0, 0.0, 295.0))
    s = len(soup)
    soup.box((0, 0, 0), (165, 165, 165), red)
    soup.rotate_y(s, -18.0, soup.bbox_center(s))
    soup.translate(s, (130.0, 0.0, 65.0))
    s = len(soup)
    soup.pyramid((165.0, 166.0, 0.0), (-165.0, 0, 0), (0, 0, 165.0), (0, 165.0, 0), glass)
    soup.rotate_y(s, -18.0, soup.vertex_mean(s, s + 2))
    soup.translate(s, (130.0, 0.0, 65.0))
    return soup, mats
