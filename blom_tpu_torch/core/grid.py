"""Grid container: C-grid metrics, masks, Coriolis, numerical bounds.

Counterpart of `blom_tpu/core/grid.py` (BLOM's mod_grid.F90,
mod_bigrid.F90:43-431 masks, mod_blom_init.F90:446-555 bounds).  Land is
a dense 0/1 mask per point class (p, u, v, q) that multiplies results;
the periodicity of each axis is static metadata that selects roll or
zero-fill shifts, and on a tripolar (arctic) grid a tagged j+1 read at
the top row takes the fold's ghost."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import stencil

# names of the (jdm, idm) tensor fields, in declaration order
TENSOR_FIELDS = (
    'scpx', 'scpy', 'scux', 'scuy', 'scvx', 'scvy', 'scqx', 'scqy',
    'scp2', 'scu2', 'scv2', 'scq2', 'scp2i', 'scq2i',
    'scuxi', 'scuyi', 'scvxi', 'scvyi',
    'plon', 'plat', 'depths', 'corioq', 'coriop', 'betafp',
    'ip', 'iu', 'iv', 'iq',
    'difmxp', 'difmxq', 'umax', 'vmax')


@dataclasses.dataclass
class Grid:
    """Static geometry of the model domain; every tensor is (jdm, idm)."""

    periodic_i: bool
    periodic_j: bool
    arctic: bool
    kk: int

    # grid metrics [m], [m2] (mod_grid.F90:48-66)
    scpx: torch.Tensor
    scpy: torch.Tensor
    scux: torch.Tensor
    scuy: torch.Tensor
    scvx: torch.Tensor
    scvy: torch.Tensor
    scqx: torch.Tensor
    scqy: torch.Tensor
    scp2: torch.Tensor
    scu2: torch.Tensor
    scv2: torch.Tensor
    scq2: torch.Tensor
    scp2i: torch.Tensor
    scq2i: torch.Tensor
    scuxi: torch.Tensor
    scuyi: torch.Tensor
    scvxi: torch.Tensor
    scvyi: torch.Tensor

    # geography
    plon: torch.Tensor
    plat: torch.Tensor
    depths: torch.Tensor   # water depth [m], 0 over land
    corioq: torch.Tensor   # Coriolis at q [s-1]
    coriop: torch.Tensor   # Coriolis at p [s-1]
    betafp: torch.Tensor   # df/dy at p [m-1 s-1]

    # land masks (0/1 float) per point class (mod_bigrid.F90:210-249)
    ip: torch.Tensor
    iu: torch.Tensor
    iv: torch.Tensor
    iq: torch.Tensor

    # numerical bounds (mod_blom_init.F90:446-555)
    difmxp: torch.Tensor   # max lateral diffusivity at p [m2 s-1]
    difmxq: torch.Tensor   # max lateral diffusivity at q [m2 s-1]
    umax: torch.Tensor     # max u velocity [m s-1]
    vmax: torch.Tensor     # max v velocity [m s-1]

    @property
    def shape(self):
        return tuple(self.depths.shape)

    @property
    def device(self):
        return self.depths.device

    @property
    def dtype(self):
        return self.depths.dtype

    # ---- neighbour shifts respecting this grid's topology.
    #
    # On tripolar grids (arctic=True) a j+1 read at the top row crosses
    # the bipolar fold: the ghost is the i-mirrored (sign-flipped for
    # vector components) value from below the fold, with per-grid-kind
    # staggering (xctilr halo_ps..halo_vv, mod_xc.F90:2405-2700).
    # Callers crossing the fold tag the field's grid kind
    # ('p'|'u'|'v'|'q') and vector-ness; untagged calls keep the closed
    # (zero-ghost) behaviour, which is correct only off the fold row.

    def im1(self, a):
        return stencil.im1(a, self.periodic_i)

    def ip1(self, a):
        return stencil.ip1(a, self.periodic_i)

    def jm1(self, a):
        return stencil.jm1(a, self.periodic_j)

    def jp1(self, a, kind: str = None, vector: bool = False):
        if self.arctic and kind is not None:
            from ..parallel.arctic import jp1_arctic
            return jp1_arctic(a, kind, vector)
        return stencil.jp1(a, self.periodic_j)

    def jpn(self, a, m: int, kind: str = None, vector: bool = False):
        """Neighbour at j+m (m >= 1), fold-aware when tagged."""
        if self.arctic and kind is not None:
            from ..parallel.arctic import fold_extend
            return fold_extend(a, kind, vector, m)[..., m:, :]
        return stencil.shift(a, 0, m, self.periodic_i, self.periodic_j)

    def shift(self, a, di=0, dj=0, kind: str = None,
              vector: bool = False):
        if dj > 0 and self.arctic and kind is not None:
            out = self.jpn(a, dj, kind, vector)
            if di:
                out = stencil.shift(out, di, 0, self.periodic_i,
                                    self.periodic_j)
            return out
        return stencil.shift(a, di, dj, self.periodic_i, self.periodic_j)


def build_masks(depths: np.ndarray, periodic_i: bool, periodic_j: bool):
    """p/u/v/q masks from the depth field (mod_bigrid.F90:210-249): p
    where depth > 0; u/v between two wet p-points; q where all four
    surrounding p are wet, or on promontories (2 diagonal wet)."""
    ip = (depths > 0.0).astype(np.float64)

    def shiftn(a, di, dj):
        out = np.roll(a, (dj, di), axis=(0, 1))
        if di == 1 and not periodic_i:
            out[:, 0] = 0.0
        if di == -1 and not periodic_i:
            out[:, -1] = 0.0
        if dj == 1 and not periodic_j:
            out[0, :] = 0.0
        if dj == -1 and not periodic_j:
            out[-1, :] = 0.0
        return out

    ip_im1 = shiftn(ip, 1, 0)    # ip(i-1, j)
    ip_jm1 = shiftn(ip, 0, 1)    # ip(i, j-1)
    ip_im1jm1 = shiftn(ip_im1, 0, 1)

    iu = ip * ip_im1
    iv = ip * ip_jm1
    iq_all = ip * ip_im1 * ip_jm1 * ip_im1jm1
    iq_diag = np.maximum(ip * ip_im1jm1, ip_im1 * ip_jm1)
    iq = np.maximum(iq_all, (iq_diag > 0).astype(np.float64))
    return ip, iu, iv, iq


def finish_grid(*, scpx, scpy, scux, scuy, scvx, scvy, scqx, scqy,
                plon, plat, depths, corioq, coriop, betafp,
                periodic_i, periodic_j, kk, baclin,
                arctic=False, dtype=torch.float64, device='cpu') -> Grid:
    """Assemble a Grid from numpy metrics: areas, inverses, masks and
    numerical bounds (numerical_bounds, mod_blom_init.F90:446-555):
    difmx* = 0.45*dx2*dy2/((dx2+dy2)*2*dt), umax/vmax = 0.9/8 * min
    neighbour cell area/(edge length * dt)."""
    depths = np.asarray(depths, dtype=np.float64)
    ip, iu, iv, iq = build_masks(depths, periodic_i, periodic_j)

    scp2 = scpx * scpy
    scu2 = scux * scuy
    scv2 = scvx * scvy
    scq2 = scqx * scqy

    dx2, dy2 = scpx * scpx, scpy * scpy
    difmxp = .9 * .5 * dx2 * dy2 / np.maximum(
        1.0, (dx2 + dy2) * (baclin + baclin))
    dx2, dy2 = scqx * scqx, scqy * scqy
    difmxq = .9 * .5 * dx2 * dy2 / np.maximum(
        1.0, (dx2 + dy2) * (baclin + baclin))

    def shiftn(a, di, dj):
        out = np.roll(a, (dj, di), axis=(0, 1))
        if di == 1 and not periodic_i:
            out[:, 0] = out[:, 1]
        if dj == 1 and not periodic_j:
            out[0, :] = out[1, :]
        return out

    umax = .9 * .125 * np.minimum(shiftn(scp2, 1, 0), scp2) / (scuy * baclin)
    vmax = .9 * .125 * np.minimum(shiftn(scp2, 0, 1), scp2) / (scvx * baclin)

    vals = dict(
        scpx=scpx, scpy=scpy, scux=scux, scuy=scuy, scvx=scvx, scvy=scvy,
        scqx=scqx, scqy=scqy, scp2=scp2, scu2=scu2, scv2=scv2, scq2=scq2,
        scp2i=1.0 / scp2, scq2i=1.0 / scq2,
        scuxi=1.0 / scux, scuyi=1.0 / scuy,
        scvxi=1.0 / scvx, scvyi=1.0 / scvy,
        plon=plon, plat=plat, depths=depths,
        corioq=corioq, coriop=coriop, betafp=betafp,
        ip=ip, iu=iu, iv=iv, iq=iq,
        difmxp=difmxp, difmxq=difmxq, umax=umax, vmax=vmax)
    return Grid(periodic_i=periodic_i, periodic_j=periodic_j, arctic=arctic,
                kk=kk, **{k: torch.tensor(np.asarray(v, np.float64),
                                          dtype=dtype, device=device)
                          for k, v in vals.items()})
