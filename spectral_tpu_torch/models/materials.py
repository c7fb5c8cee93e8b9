"""Material table: struct-of-arrays parameters + SPD tabulation.

Port of spectral_tpu/models/materials.py. The reference's ``material`` is a
POD struct with a type tag, rgb color, fuzz, emission power, a precomputed
95-sample spectral distribution and Sellmeier B/C coefficients
(materials/material.cuh:140-149; factories at material.cuh:100-117; SPD
precompute compute_spectral_distr at material.cuh:71-84). Here it is a
dataclass of tensors; the SPD table is a pure function of the other fields.

Material type ids match the reference (material.cuh:16-22).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.rgb2spec import (
    fit_sigmoid_coeffs,
    spd_from_coeffs_illuminance,
    spd_from_coeffs_reflectance,
)
from ..utils.constants import N_CIE_SAMPLES, sellmeier_presets

LAMBERTIAN = 0
METALLIC = 1
DIELECTRIC = 2
EMISSIVE = 4
NO_MAT = 6


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table over M materials (tensors on one device)."""

    mat_type: torch.Tensor  # [M] int32
    rgb: torch.Tensor  # [M, 3] linear-sRGB color
    coeffs: torch.Tensor  # [M, 3] sigmoid-poly coefficients
    fuzz: torch.Tensor  # [M]
    emission_power: torch.Tensor  # [M]
    sellmeier_b: torch.Tensor  # [M, 3]
    sellmeier_c: torch.Tensor  # [M, 3]
    spd: torch.Tensor  # [M, N_CIE_SAMPLES]


class MaterialBuilder:
    """Host-side accumulation of materials, mirroring the reference factories."""

    def __init__(self, replicate_reference_bugs: bool = True):
        # The reference's dielectric ctor stores C := B (material.cuh:63-69),
        # so its rendered dispersion uses C == B. Replicated by default for
        # image parity; the physically-correct path is an option.
        self._rows: list[dict] = []
        self._replicate = replicate_reference_bugs

    def _add(self, mat_type, rgb=(0.0, 0.0, 0.0), fuzz=1.0, power=0.0, b=(0.0,) * 3, c=(0.0,) * 3) -> int:
        self._rows.append(
            dict(
                mat_type=mat_type,
                rgb=np.asarray(rgb, np.float32),
                fuzz=np.float32(fuzz),
                power=np.float32(power),
                b=np.asarray(b, np.float32),
                c=np.asarray(c, np.float32),
            )
        )
        return len(self._rows) - 1

    def lambertian(self, rgb) -> int:
        return self._add(LAMBERTIAN, rgb)

    def metallic(self, rgb, fuzz: float) -> int:
        return self._add(METALLIC, rgb, fuzz=fuzz)

    def emissive(self, rgb, power: float = 1.0) -> int:
        return self._add(EMISSIVE, rgb, power=power)

    def dielectric(self, b, c) -> int:
        c_eff = b if self._replicate else c
        return self._add(DIELECTRIC, (1.0, 1.0, 1.0), b=b, c=c_eff)

    def dielectric_preset(self, name: str) -> int:
        b, c = sellmeier_presets[name]
        return self.dielectric(np.asarray(b), np.asarray(c))

    def build(self) -> Materials:
        """The table, as CPU tensors."""
        m = len(self._rows)
        g = lambda k: torch.from_numpy(np.stack([r[k] for r in self._rows]))  # noqa: E731
        mats = Materials(
            mat_type=torch.tensor([r["mat_type"] for r in self._rows], dtype=torch.int32),
            rgb=g("rgb"),
            coeffs=fit_sigmoid_coeffs(g("rgb")),
            fuzz=g("fuzz"),
            emission_power=g("power"),
            sellmeier_b=g("b"),
            sellmeier_c=g("c"),
            spd=torch.zeros((m, N_CIE_SAMPLES), dtype=torch.float32),
        )
        return tabulate(mats)


def tabulate(mats: Materials) -> Materials:
    """(Re)build the 95-sample SPD table (material.cuh:71-84): EMISSIVE ->
    power^2-scaled D65-weighted sigmoid spectrum; DIELECTRIC -> constant 1;
    everything else -> reflectance sigmoid spectrum."""
    refl = spd_from_coeffs_reflectance(mats.coeffs)
    emis = spd_from_coeffs_illuminance(mats.coeffs, mats.emission_power)
    ones = torch.ones_like(refl)
    t = mats.mat_type[:, None]
    spd = torch.where(t == EMISSIVE, emis, torch.where(t == DIELECTRIC, ones, refl))
    return dataclasses.replace(mats, spd=spd)
