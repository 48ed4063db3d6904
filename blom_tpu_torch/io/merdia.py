"""Meridional-overturning, section and z-level diagnostics.

Counterpart of `blom_tpu/io/merdia.py` (BLOM's MERDIA/SECDIA,
phy/mod_dia.F90:4004-4350 diamer and :3814-4001 diasec, the depthslev
tables :111-142, and the z-level remap of
mod_ale_regrid_remap.F90 ale_remap_diazlv).  Sections and latitude bins
are dense (J, I) weight masks, so each reduction is a masked sum or a
one-hot product."""

from __future__ import annotations

import numpy as np
import torch

# the 35-level standard depth table (mod_dia.F90:111-129) [m]
DEPTHSLEV = np.array([
    0., 10., 20., 30., 50., 75., 100., 125., 150., 200., 250., 300.,
    400., 500., 600., 700., 800., 900., 1000., 1100., 1200., 1300.,
    1400., 1500., 1750., 2000., 2500., 3000., 3500., 4000., 4500.,
    5000., 5500., 6000., 6500.])
DEPTHSLEV_BNDS = np.array([
    [0., 5.], [5., 15.], [15., 25.], [25., 40.], [40., 62.5],
    [62.5, 87.5], [87.5, 112.5], [112.5, 137.5], [137.5, 175.],
    [175., 225.], [225., 275.], [275., 350.], [350., 450.],
    [450., 550.], [550., 650.], [650., 750.], [750., 850.],
    [850., 950.], [950., 1050.], [1050., 1150.], [1150., 1250.],
    [1250., 1350.], [1350., 1450.], [1450., 1625.], [1625., 1875.],
    [1875., 2250.], [2250., 2750.], [2750., 3250.], [3250., 3750.],
    [3750., 4250.], [4250., 4750.], [4750., 5250.], [5250., 5750.],
    [5750., 6250.], [6250., 8000.]])


# ------------------------------------------------------------------ #
# z-level remap of layer fields
# ------------------------------------------------------------------ #

_BOUNDS = {}


def _bounds(bnds, dtype, device):
    """The bin bounds as a tensor; the standard table is copied to each
    device once, so that a step loop copies nothing to the card."""
    if bnds is not None:
        return torch.as_tensor(bnds, dtype=dtype, device=device)
    key = (dtype, str(device))
    if key not in _BOUNDS:
        _BOUNDS[key] = torch.as_tensor(DEPTHSLEV_BNDS, dtype=dtype,
                                       device=device)
    return _BOUNDS[key]


def zlev_weights(p_i, bnds=None, onem: float = 9806.):
    """The overlaps of zlev_overlap laid out (J, I, ddm, K), the layout
    of one batched product per field, and their sums over the layers
    (ddm, J, I).  A caller that bins several fields of one state builds
    these once (at 384x360x53 in f32 the overlaps take ~1 GB)."""
    zb = _bounds(bnds, p_i.dtype, p_i.device) * onem
    lo = zb[:, 0][:, None]                         # (ddm, 1)
    hi = zb[:, 1][:, None]
    p_up = p_i[:-1].permute(1, 2, 0)[:, :, None]   # (J, I, 1, K)
    p_lo = p_i[1:].permute(1, 2, 0)[:, :, None]
    w = torch.minimum(p_lo, hi)
    w.sub_(torch.maximum(p_up, lo)).clamp_(min=0.)
    return w, w.sum(-1).permute(2, 0, 1)


def zlev_overlap(p_i, bnds=None, onem: float = 9806.):
    """Overlap weights between model layers and fixed z-bins
    (ale_remap_diazlv's bin integrals).  p_i: (K+1, J, I) interface
    pressures; returns (ddm, K, J, I) overlap thickness [Pa]."""
    return zlev_weights(p_i, bnds, onem)[0].permute(2, 3, 0, 1)


def to_zlev_w(field, w, den, fill: float = 0.):
    """to_zlev of a (K, J, I) field with weights from zlev_weights.  The
    products are summed over the contiguous layer axis: at 384x360x53 in
    f32 on an H100 80GB HBM3 (700 W) that takes 1.8 ms a field, where a
    batched matrix product of the 138,240 (35, 53) x (53, 1) blocks took
    5.9 ms (chip_smoke `diagnostics`)."""
    num = (w * field.permute(1, 2, 0)[:, :, None, :]).sum(-1)
    num = num.permute(2, 0, 1)
    return torch.where(den > 0., num / den.clamp_min(1.e-30), fill)


def to_zlev(field, p_i, bnds=None, onem: float = 9806.,
            fill: float = 0.):
    """Bin-average a (K, J, I) layer field onto the standard depth
    levels.  Returns (ddm, J, I); bins with no overlap get `fill`."""
    w, den = zlev_weights(p_i, bnds, onem)
    return to_zlev_w(field, w, den, fill)


# ------------------------------------------------------------------ #
# meridional overturning and transports (MERDIA)
# ------------------------------------------------------------------ #

def lat_bin_weights(vlat, lats, region=None):
    """One-hot latitude-bin membership of v-points: (L, J, I) weights,
    a v-edge in bin l when its latitude lies in [lats[l], lats[l+1])
    (the last bin to 90), restricted to `region`'s (J, I) 0/1 mask when
    given (mer_regflg)."""
    lats = torch.as_tensor(lats, dtype=vlat.dtype, device=vlat.device)
    edges = torch.cat([lats, lats.new_tensor([90.])])
    idx = torch.clamp(torch.searchsorted(edges, vlat.contiguous(),
                                         right=True) - 1,
                      0, lats.shape[0] - 1)
    onehot = (torch.arange(lats.shape[0], device=vlat.device)[:, None, None]
              == idx[None])
    w = onehot.to(vlat.dtype)
    if region is not None:
        w = w * region[None]
    return w


def overturning_streamfunction(vflx, wlat, scale: float = 1.):
    """Meridional-overturning streamfunction (L, K+1) from an
    accumulated (K, J, I) v mass flux and (L, J, I) latitude weights
    (mosf; diamer's mmflxl path, mod_dia.F90:4150-4300): the regional
    sum per bin, then cumulative from the surface."""
    t = torch.einsum('lji,kji->lk', wlat, vflx) * scale
    return torch.cat([torch.zeros_like(t[:, :1]), torch.cumsum(t, 1)], 1)


def meridional_transport(flx, wlat, scale: float = 1.):
    """Vertically integrated meridional transport per latitude bin
    (mhflx/msflx; mod_dia.F90:4300-4340)."""
    return torch.einsum('lji,kji->l', wlat, flx) * scale


# ------------------------------------------------------------------ #
# section transports (SECDIA)
# ------------------------------------------------------------------ #

def section_transport(uflx, vflx, uflg, vflg):
    """Net transport through a section given by signed edge masks
    (diasec, mod_dia.F90:3814-4001): uflg and vflg are (J, I) in
    {-1, 0, 1}, the orientation of each crossed edge."""
    return (torch.einsum('ji,kji->', uflg, uflx)
            + torch.einsum('ji,kji->', vflg, vflx))


def section_masks_along_i(shape, i0: int, j_range=None,
                          dtype=torch.float64, device='cpu'):
    """The edge masks of a meridional section at constant i."""
    uflg = torch.zeros(shape, dtype=dtype, device=device)
    j0, j1 = (0, shape[0]) if j_range is None else j_range
    uflg[j0:j1, i0] = 1.
    return uflg, torch.zeros_like(uflg)


def section_masks_along_j(shape, j0: int, i_range=None,
                          dtype=torch.float64, device='cpu'):
    """A zonal section at constant j (transport across a latitude
    line)."""
    vflg = torch.zeros(shape, dtype=dtype, device=device)
    i0, i1 = (0, shape[1]) if i_range is None else i_range
    vflg[j0, i0:i1] = 1.
    return torch.zeros_like(vflg), vflg
