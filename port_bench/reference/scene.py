"""The benchmark's own scenes: geometry, materials and their spectra, and the
packed tables the plain renderer reads.

A straightforward rebuild of the published scenes from their description
(each scene kind's geometry and materials in ``scenes/<kind>.py``),
independent of the program: triangle soups in float64 numpy, the per-triangle plane and sign-folded edge
functionals (primitives/tri.cu:47-84), the sigmoid-polynomial spectra of the
material colours by a Levenberg-Marquardt fit of the CIE Lab round trip
(pbrt-v4's rgb2spec objective), and the curve tables.

Packs (float32): triangles [T, 17] = normal(0:3), d(3), edge_g(4:13),
edge_c(13:16), material(16); materials [M, 16] = coeffs(0:3), lambertian(3),
metal(4), dielectric(5), emissive(6), fuzz(7), power^2(8), Sellmeier
B(9:12), C(12:15); tables [5, 95] = CIE x, y, z, normalized D65, sky SPD.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from . import cie

LAMBDA_MIN, LAMBDA_MAX, N_SAMPLES = 360.0, 830.0, 95
LAMBERTIAN, METALLIC, DIELECTRIC, EMISSIVE = 0, 1, 2, 4

# three-term Sellmeier presets (refraction/sellmeier.cuh:6-13); the
# reference's dielectric stores C := B (material.cuh:63-69), which its
# renders show, so a dielectric here does the same
SELLMEIER = {
    "flint_glass": ((1.34533359, 0.209073176, 0.937357162), (0.00997743871, 0.0470450767, 111.886764)),
}

# Bruce Lindbloom's linear sRGB -> XYZ under D65 (color_const.cu:13-20)
SRGB_TO_XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375], [0.2126729, 0.7151522, 0.0721750], [0.0193339, 0.1191920, 0.9503041]],
    np.float32,
)


# ---- geometry -----------------------------------------------------------------


class Soup:
    """Triangles (float64 [3, 3] vertex rows) and their material rows."""

    def __init__(self):
        self.v: list[np.ndarray] = []
        self.mat: list[int] = []

    def __len__(self) -> int:
        return len(self.v)

    def tri(self, a, b, c, mat: int) -> None:
        self.v.append(np.array([a, b, c], np.float64))
        self.mat.append(int(mat))

    def tri_vec(self, q, u, v, mat: int) -> None:
        q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
        self.tri(q, q + u, q + v, mat)

    def quad(self, q, u, v, mat: int) -> None:
        """(Q, Q+u, Q+v) and (Q+u+v, Q+v, Q+u) (tri_quad.cuh:14-20)."""
        q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
        self.tri_vec(q, u, v, mat)
        self.tri_vec(q + u + v, -u, -v, mat)

    def box(self, a, b, mats) -> None:
        """Six quads, front/right/back/left/top/bottom (tri_box.cuh:30-46)."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx, dy, dz = np.diag(mx - mn)
        m = [mats] * 6 if isinstance(mats, int) else list(mats)
        self.quad([mn[0], mn[1], mx[2]], dx, dy, m[0])
        self.quad([mx[0], mn[1], mx[2]], -dz, dy, m[1])
        self.quad([mx[0], mn[1], mn[2]], -dx, dy, m[2])
        self.quad([mn[0], mn[1], mn[2]], dz, dy, m[3])
        self.quad([mn[0], mx[1], mx[2]], dx, -dz, m[4])
        self.quad([mn[0], mn[1], mn[2]], dx, dz, m[5])

    def pyramid(self, q, u, v, w, mat: int) -> None:
        """Base quad and four sides (pyramid.cuh:30-47)."""
        q, u, v, w = (np.asarray(x, np.float64) for x in (q, u, v, w))
        self.quad(q, u, v, mat)
        top = q + (u + v) / 2.0 + w
        v0, v1, v2 = q, q + u, q + v
        v3 = v2 + u
        for a, c in ((v0, v2), (v1, v0), (v2, v3), (v3, v1)):
            self.tri(a, top, c, mat)

    def rotate_y(self, start: int, degrees: float, pivot) -> None:
        """Rotation about the vertical axis through ``pivot`` of the
        triangles from ``start`` on (transform.cu:3-34)."""
        t = math.radians(degrees)
        c, s = np.cos(t), np.sin(t)
        m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
        p = np.asarray(pivot, np.float64)
        for i in range(start, len(self.v)):
            self.v[i] = (self.v[i] - p) @ m.T + p

    def translate(self, start: int, d) -> None:
        for i in range(start, len(self.v)):
            self.v[i] = self.v[i] + np.asarray(d, np.float64)

    def bbox_center(self, start: int) -> np.ndarray:
        pts = np.concatenate(self.v[start:], axis=0)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        return (mx - mn) / 2.0 + mn

    def vertex_mean(self, start: int, end: int) -> np.ndarray:
        return np.concatenate(self.v[start:end], axis=0).mean(axis=0)


def triangle_rows(soup: Soup) -> np.ndarray:
    """[T, 17] float32: unit normal, plane offset, the sign-folded edge
    functionals on the triangle's projection plane (tri.cu:47-84, 121-128:
    p is inside iff edge_g[k] . p + edge_c[k] >= 0 for k = 0, 1, 2), and the
    material."""
    v = np.stack(soup.v)
    t = v.shape[0]
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    n = np.cross(v1 - v0, v2 - v0)
    normal = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-300)
    d = np.einsum("ij,ij->i", normal, v0)
    flat = np.abs(normal) < 1e-8
    w_axis = np.zeros(t, np.int64)
    h_axis = np.ones(t, np.int64)
    xz = flat[:, 0] & flat[:, 2]
    yz = flat[:, 1] & flat[:, 2]
    h_axis[xz] = 2
    w_axis[yz], h_axis[yz] = 1, 2
    xy = flat[:, 0] & flat[:, 1]
    w_axis[xy], h_axis[xy] = 0, 1
    ar = np.arange(t)

    def pw(p):
        return p[ar, w_axis]

    def ph(p):
        return p[ar, h_axis]

    area = (pw(v0) - pw(v2)) * (ph(v1) - ph(v2)) - (pw(v1) - pw(v2)) * (ph(v0) - ph(v2))
    sign = np.where(area >= 0, 1.0, -1.0)
    edge_g = np.zeros((t, 3, 3))
    edge_c = np.zeros((t, 3))
    for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
        edge_g[ar, k, w_axis] = sign * (ph(a) - ph(b))
        edge_g[ar, k, h_axis] = -sign * (pw(a) - pw(b))
        edge_c[:, k] = sign * (ph(b) * (pw(a) - pw(b)) - pw(b) * (ph(a) - ph(b)))
    f32 = np.float32
    rows = np.concatenate(
        [normal.astype(f32), d.astype(f32)[:, None], edge_g.astype(f32).reshape(t, 9), edge_c.astype(f32),
         np.asarray(soup.mat, np.float32)[:, None]],
        axis=1,
    )
    return np.ascontiguousarray(rows, f32)


# ---- materials and spectra ----------------------------------------------------


@dataclasses.dataclass
class Material:
    kind: int
    rgb: tuple = (0.0, 0.0, 0.0)
    fuzz: float = 1.0
    power: float = 0.0
    glass: str | None = None


def cornell_walls(soup: Soup, walls, light: int) -> None:
    """Floor, back, ceiling, left, right walls and the ceiling light
    (scene.cu:85-107)."""
    b, bk, t, left, right = walls
    soup.quad((0, 0, 0), (0, 0, 555), (555, 0, 0), b)
    soup.quad((0, 0, 555.0), (0, 555, 0), (555, 0, 0), bk)
    soup.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), t)
    soup.quad((555, 0, 0), (0, 0, 555), (0, 555, 0), left)
    soup.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), right)
    cx, cy, cz = 555.0 / 2.0, 554.0, 555.0 / 2.0
    soup.quad((cx + 50.0, cy, cz + 50.0), (-100.0, 0, 0), (0, 0, -100.0), light)


def _curve(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32)


def _spd_lambdas() -> torch.Tensor:
    """The material tabulation grid: LAMBDA_MIN + i * span / N (the
    reference's /N step, color_to_spectrum.cuh:161,196)."""
    return torch.tensor(LAMBDA_MIN + np.arange(N_SAMPLES, dtype=np.float32) * (LAMBDA_MAX - LAMBDA_MIN) / N_SAMPLES,
                        dtype=torch.float32)


def _xyz_of_spd(spd: torch.Tensor) -> torch.Tensor:
    """XYZ of SPD samples [..., 95] on the 5 nm grid under D65, Y(1) = 1."""
    w = torch.stack([_curve(cie.CIE_X), _curve(cie.CIE_Y), _curve(cie.CIE_Z)]) * _curve(cie.CIE_D65)
    return (1.0 / torch.sum(w[1])) * (spd @ w.T)


def _lab(xyz: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    t = xyz / white
    f = torch.where(t > d**3, torch.pow(torch.clamp_min(t, 1e-20), 1.0 / 3.0), t / (3 * d * d) + 4.0 / 29.0)
    fx, fy, fz = f.unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def _resample(spd: torch.Tensor) -> torch.Tensor:
    """SPDs tabulated on the /N grid, read at the 5 nm grid by linear
    interpolation over the table's /(N-1) cells, as the renderer reads a
    table."""
    lam = torch.linspace(LAMBDA_MIN, LAMBDA_MAX, N_SAMPLES, dtype=torch.float32)
    x = (lam - LAMBDA_MIN) * ((N_SAMPLES - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = x.to(torch.int64).clamp(0, N_SAMPLES - 2)
    w = x - cell.to(torch.float32)
    return (1.0 - w) * spd[..., cell] + w * spd[..., cell + 1]


def fit_coeffs(rgb: np.ndarray, iters: int = 48) -> np.ndarray:
    """Sigmoid-polynomial coefficients (c0, c1, c2), SPD(l) =
    sigmoid(c0 l^2 + c1 l + c2), of linear-sRGB colours [K, 3]: grays in
    closed form (sigmoid(c2) = r), other colours by damped Gauss-Newton
    (Levenberg-Marquardt) on the Lab distance of the D65-lit SPD from the
    colour, from five starts, in the normalized basis u = (l - mid) / half.
    The Jacobian is taken by autograd."""
    rgb = torch.as_tensor(np.asarray(rgb, np.float32))
    k = rgb.shape[0]
    mid, half = 0.5 * (LAMBDA_MIN + LAMBDA_MAX), 0.5 * (LAMBDA_MAX - LAMBDA_MIN)
    u = (_spd_lambdas() - mid) / half
    white = _xyz_of_spd(torch.ones(N_SAMPLES))
    target = _lab(rgb @ torch.from_numpy(SRGB_TO_XYZ).T, white)

    def resid(c, tgt):
        x = (c[..., 0:1] * u + c[..., 1:2]) * u + c[..., 2:3]
        spd = 0.5 * x / torch.sqrt(1.0 + x * x) + 0.5
        return _lab(_xyz_of_spd(_resample(spd)), white) - tgt

    m = torch.clamp(rgb.mean(-1), 1e-4, 1.0 - 1e-4)
    k0 = (m - 0.5) / torch.sqrt(m * (1.0 - m))
    starts = torch.tensor([[0.0, 0.0, 0.0], [0.0, 20.0, 0.0], [0.0, -20.0, 0.0], [-25.0, 0.0, 10.0], [25.0, 0.0, -10.0]])
    c = (starts[None] + torch.tensor([0.0, 0.0, 1.0]) * k0[:, None, None]).reshape(-1, 3)
    tgt = target.repeat_interleave(5, dim=0)
    damp = torch.full((c.shape[0],), 1e-4)
    best_c, best_l = c.clone(), torch.full_like(damp, float("inf"))
    eye = torch.eye(3)
    for _ in range(iters):
        r = resid(c, tgt)
        loss = torch.sum(r * r, -1)
        better = loss < best_l
        best_c = torch.where(better[:, None], c, best_c)
        best_l = torch.where(better, loss, best_l)
        cg = c.detach().requires_grad_(True)
        rg = resid(cg, tgt)
        jac = torch.stack([torch.autograd.grad(rg[:, i].sum(), cg, retain_graph=i < 2)[0] for i in range(3)], 1)
        jt = jac.transpose(-1, -2)
        step = torch.linalg.solve_ex(jt @ jac + damp[:, None, None] * eye, (jt @ r[..., None]))[0][..., 0]
        c_new = c - step
        accept = torch.sum(resid(c_new, tgt) ** 2, -1) < loss
        damp = torch.clamp(torch.where(accept, damp * 0.33, damp * 4.0), 1e-10, 1e8)
        c = torch.where(accept[:, None], c_new, c)
    l_fin = torch.sum(resid(c, tgt) ** 2, -1)
    cs = torch.where((l_fin < best_l)[:, None], c, best_c).reshape(k, 5, 3)
    a, b, kk = cs[torch.arange(k), torch.argmin(torch.minimum(l_fin, best_l).reshape(k, 5), 1)].unbind(-1)
    fitted = torch.stack(
        [a / (half * half), b / half - 2.0 * a * mid / (half * half), a * mid * mid / (half * half) - b * mid / half + kk],
        -1,
    )
    r0 = rgb[:, 0]
    gray = (rgb[:, 0] == rgb[:, 1]) & (rgb[:, 1] == rgb[:, 2])
    denom = torch.sqrt(torch.clamp_min(r0 * (1.0 - r0), 0.0))
    c2 = torch.where(denom > 0.0, (r0 - 0.5) / torch.clamp_min(denom, 1e-37),
                     torch.where(r0 >= 0.5, torch.full_like(r0, 1e6), torch.full_like(r0, -1e6)))
    closed = torch.stack([torch.zeros_like(r0), torch.zeros_like(r0), c2], -1)
    return torch.where(gray[:, None], closed, fitted).detach().numpy().astype(np.float32)


def material_rows(mats: list[Material]) -> np.ndarray:
    """[M, 16] float32 material pack."""
    rows = np.zeros((len(mats), 16), np.float32)
    rows[:, 0:3] = fit_coeffs(np.array([m.rgb for m in mats], np.float32))
    for i, m in enumerate(mats):
        rows[i, 3 + {LAMBERTIAN: 0, METALLIC: 1, DIELECTRIC: 2, EMISSIVE: 3}[m.kind]] = 1.0
        rows[i, 7] = m.fuzz
        rows[i, 8] = np.float32(m.power) ** 2
        if m.glass is not None:
            b, _ = SELLMEIER[m.glass]
            rows[i, 9:12] = b
            rows[i, 12:15] = b
    return rows


def curve_tables(sky_rgb=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[5, 95] float32: CIE x, y, z, normalized D65 and the sky's SPD
    (the D65-lit sigmoid spectrum of its colour on the /N grid)."""
    c = torch.from_numpy(fit_coeffs(np.array([sky_rgb], np.float32)))[0]
    lam = _spd_lambdas()
    x = (c[0] * lam + c[1]) * lam + c[2]
    sig = torch.where(torch.isneginf(x), torch.zeros_like(x), 0.5 * x / torch.sqrt(1.0 + x * x) + 0.5)
    d65n = _curve(cie.CIE_D65_NORMALIZED)
    # D65 read on the /N grid by the /(N-1) lerp
    pos = (lam - LAMBDA_MIN) * ((N_SAMPLES - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = pos.to(torch.int64).clamp(0, N_SAMPLES - 2)
    w = pos - cell.to(torch.float32)
    d65_on_grid = (1.0 - w) * d65n[cell] + w * d65n[cell + 1]
    sky = sig * d65_on_grid
    return torch.stack([_curve(cie.CIE_X), _curve(cie.CIE_Y), _curve(cie.CIE_Z), d65n, sky]).numpy()


@dataclasses.dataclass
class RefScene:
    tris: torch.Tensor  # [T, 17]
    mats: torch.Tensor  # [M, 16]
    tables: torch.Tensor  # [5, 95]

    def to(self, device) -> "RefScene":
        return RefScene(self.tris.to(device), self.mats.to(device), self.tables.to(device))


def build(spec: dict) -> RefScene:
    """The scene a configuration's ``scene`` entry names, on the CPU: the
    geometry and materials from ``scenes/<kind>.py`` (``soup(spec)``), one
    file a scene kind."""
    soup, mats = importlib.import_module(f"{__package__}.scenes.{spec['kind']}").soup(spec)
    return RefScene(
        torch.from_numpy(triangle_rows(soup)),
        torch.from_numpy(material_rows(mats)),
        torch.from_numpy(curve_tables(tuple(spec.get("sky", (0.0, 0.0, 0.0))))),
    )
