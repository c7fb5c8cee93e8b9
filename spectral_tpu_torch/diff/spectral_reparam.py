"""Reparameterized hero-wavelength sampling: exact Sellmeier gradients.

Port of spectral_tpu/diff/spectral_reparam.py: ``reparam_hero`` and its
helpers, which the fused replay folds (diff/fast.py), and
``reparam_wavelengths`` (:207), which the XLA-style renderer applies to
its hero combs (render/wavefront.py, ``reparam_glass``).

With fixed random numbers the path radiance is piecewise constant in the
Sellmeier coefficients: they enter only through the refractive index at the
hero wavelength, which steers directions and hence hit decisions. The
estimator is made smooth by a change of variables in the hero sample: the
sampled lambda_0 defines a target n^2* = m(lambda_0; sg(B), sg(C)), and the
traced wavelength solves m(lambda; B, C) = n^2*. At the primal point
lambda == lambda_0, but d lambda / dB = -(dm/dB) / (dm/dlambda) is nonzero,
the path geometry is frozen, and the sample is weighted by the Jacobian of
the map (primal value 1). The JAX module documents the window constants
below and why each is needed; they are read from the environment once, at
import, as there.

``jax.jvp`` becomes ``torch.func.jvp`` and ``stop_gradient`` ``.detach()``,
so the functions compose with ``torch.func.grad`` (second-order AD through
the map, as diff/fast.py::_sellmeier_grads_from_replay uses them).
"""

from __future__ import annotations

import os as _os

import torch

from ..ops.sellmeier import sellmeier_index
from ..utils.constants import LAMBDA_MAX, LAMBDA_MIN

# denominator floor and taper window on |dm/dlambda|, 1/nm (bulk flint
# |dm/dlambda| ~1e-2): the shift goes to 0 near extrema of m
_DM_FLOOR = float(_os.environ.get("REPARAM_DM_FLOOR", "1e-7"))
_DM_LO = float(_os.environ.get("REPARAM_DM_LO", "1e-6"))
_DM_HI = float(_os.environ.get("REPARAM_DM_HI", "1e-5"))
# the shift vanishes within this many nm of both band ends
_EDGE_NM = float(_os.environ.get("REPARAM_EDGE_NM", "8.0"))
# soft cap on |shift| in nm (tanh), ~ a quarter of the band
SMAX = 120.0


def _n_and_dndlam(b: torch.Tensor, c: torch.Tensor, lam: torch.Tensor):
    """(n, dn/dlambda) at wavelength(s) lam [nm]."""
    return torch.func.jvp(lambda l: sellmeier_index(b, c, l), (lam,), (torch.ones_like(lam),))


def _m_raw(b: torch.Tensor, c: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unclamped n^2(lambda) = 1 + sum b l^2 / (l^2 - c), the smooth
    quantity upstream of sellmeier_index's clamp. A hero exactly on an
    in-band pole (the C := B glass has one at 457.245 nm) gets a
    sign-preserving 1e-9 denominator, so m stays finite."""
    lam_um = lam * 1e-3
    l2 = (lam_um * lam_um)[..., None]
    d = l2 - c
    d = torch.where(d.abs() < 1e-9, torch.where(d >= 0, 1e-9, -1e-9).to(d.dtype), d)
    return 1.0 + torch.sum(b * l2 / d, dim=-1)


def _m_and_dmdlam(b: torch.Tensor, c: torch.Tensor, lam: torch.Tensor):
    return torch.func.jvp(lambda l: _m_raw(b, c, l), (lam,), (torch.ones_like(lam),))


def reparam_hero(
    hero0: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    frozen: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reparameterize sampled hero wavelengths [...] (nm) against one glass
    with Sellmeier coefficients b, c [3].

    ``frozen``: the (b0, c0) pair that defines the target index; ``None``
    means (b, c) detached, the configuration for AD. A finite-difference
    check passes the unperturbed coefficients explicitly.

    Returns (hero, weight): hero equals hero0 at the primal point but
    carries d hero / d(b, c); weight is the map's Jacobian d T / d lambda0
    (primal 1), which multiplies the sample's whole contribution."""
    hero0 = hero0.detach()
    b0, c0 = (b.detach(), c.detach()) if frozen is None else frozen

    def T(l0):
        m_tgt = _m_raw(b0, c0, l0)
        m_cur, dm_cur = _m_and_dmdlam(b, c, l0)
        floor = torch.where(dm_cur >= 0.0, _DM_FLOOR, -_DM_FLOOR).to(dm_cur.dtype)
        dm_eff = torch.where(dm_cur.abs() > _DM_FLOOR, dm_cur, floor)
        taper = torch.clamp((dm_cur.abs() - _DM_LO) / (_DM_HI - _DM_LO), 0.0, 1.0)
        edge = torch.clamp(torch.minimum(l0 - LAMBDA_MIN, LAMBDA_MAX - l0) / _EDGE_NM, 0.0, 1.0)
        # clipped before the tanh: at the floor raw can reach ~1e7 nm, and
        # the jvp of a saturated tanh would be 0 * inf
        raw = torch.clamp((m_tgt - m_cur) / dm_eff, -8.0 * SMAX, 8.0 * SMAX)
        return l0 + SMAX * torch.tanh(raw * taper * edge / SMAX)

    return torch.func.jvp(T, (hero0,), (torch.ones_like(hero0),))


def reparam_wavelengths(
    lam: torch.Tensor,
    materials,
    glass_index: int,
    frozen: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the hero reparameterization to whole wavelength combs
    (spectral_reparam.py:207).

    lam [N, W]: hero combs (hero at index 0, companions at rigid offsets
    with wrap); glass_index: the material row of the target glass; frozen:
    the explicit (b0, c0) target of an FD check (see reparam_hero).

    Returns (lam', weight [N]). The comb shifts rigidly with the hero, by
    ``hero - hero0``: the actual numeric shift, zero at the primal but not
    at a displaced (b, c) with an explicit frozen target. (``hero -
    hero.detach()`` would be zero at every (b, c) and would turn an FD
    evaluation of the reparameterized estimator into another, weight-only
    function.) The wrap is re-applied on detached values: the primal comb
    is already wrapped and the tangent shift is the same on both sides."""
    b = materials.sellmeier_b[glass_index]
    c = materials.sellmeier_c[glass_index]
    hero0 = lam[:, 0]
    hero, weight = reparam_hero(hero0, b, c, frozen)
    shift = hero - hero0.detach()
    span = LAMBDA_MAX - LAMBDA_MIN
    shifted = lam + shift[:, None]
    lam_new = torch.where(shifted.detach() > LAMBDA_MAX, shifted - span, shifted)
    lam_new = torch.where(shifted.detach() < LAMBDA_MIN, lam_new + span, lam_new)
    return lam_new, weight
