"""Near-inertial wave kinetic-energy tendency.

Counterpart of `blom_tpu/phys/niw.py` (BLOM's mod_niw.F90:20-254): tracks
the total velocities of the two mixed-layer layers, removes a running
inertial-period average through an exponential reservoir, and diagnoses
the vertically integrated inertial kinetic-energy tendency `idkedt`
that mxlayr takes as a near-inertial energy source."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.grid import Grid
from ..core.state import State

IPFAC = 2.              # inertial periods in the averaging window
CORI10 = 2.5256e-5      # Coriolis parameter at 10N [1/s]


@dataclasses.dataclass
class NiwState:
    """(2 time levels, 2 ML layers, J, I) velocities and reservoirs
    (mod_niw.F90:43-52)."""
    uml: torch.Tensor      # (2, 2, J, I) previous total ML u
    vml: torch.Tensor
    umlres: torch.Tensor   # (2, J, I) running-average reservoirs
    vmlres: torch.Tensor
    idkedt: torch.Tensor   # (J, I) integrated inertial KE tendency


def init_niw(shape, dtype=torch.float64, device=None) -> NiwState:
    """Zero NIW state on `device` (CUDA unless the caller names one)."""
    from ..drivers.standalone import _device
    H = tuple(shape)
    dev = _device(device)

    def z(*lead):
        return torch.zeros(lead + H, dtype=dtype, device=dev)
    return NiwState(uml=z(2, 2), vml=z(2, 2), umlres=z(2), vmlres=z(2),
                    idkedt=z())


def _component(res, vml_prev, vtot, cor, delt1):
    """Reservoir update and KE difference of one layer of one component
    (mod_niw.F90:130-160)."""
    q = delt1 * torch.clamp(torch.abs(cor), min=CORI10) \
        / (IPFAC * 2. * math.pi)
    res = res + vtot
    vavg = res * q
    res = res * (1. - q)
    dv, dv_prev = vtot - vavg, vml_prev - vavg
    return res, vavg, dv * dv - dv_prev * dv_prev


def niw_ke_tendency(grid: Grid, s: State, niw: NiwState, m: int,
                    delt1, dlt) -> NiwState:
    """Diagnose idkedt and advance the NIW averaging state
    (niw_ke_tendency, mod_niw.F90:117-254); returns a new NiwState."""
    coru = .5 * (grid.coriop + grid.im1(grid.coriop))
    corv = .5 * (grid.coriop + grid.jm1(grid.coriop))

    ubt = s.ubflxs_p[m] * dlt / (delt1 * grid.scuy
                                 * torch.clamp(s.pbu[m], min=1.e-12))
    vbt = s.vbflxs_p[m] * dlt / (delt1 * grid.scvx
                                 * torch.clamp(s.pbv[m], min=1.e-12))

    umlres, vmlres = niw.umlres.clone(), niw.vmlres.clone()
    uml_new, vml_new = niw.uml.clone(), niw.vml.clone()
    util1 = torch.zeros_like(niw.idkedt)
    util2 = torch.zeros_like(niw.idkedt)
    for kl in range(2):
        utot = s.u[m, kl] + ubt
        umlres[kl], _, dkeu = _component(umlres[kl], niw.uml[m, kl], utot,
                                         coru, delt1)
        util1 = util1 + dkeu * s.dpu[m, kl]
        uml_new[m, kl] = utot

        vtot = s.v[m, kl] + vbt
        vmlres[kl], _, dkev = _component(vmlres[kl], niw.vml[m, kl], vtot,
                                         corv, delt1)
        util2 = util2 + dkev * s.dpv[m, kl]
        vml_new[m, kl] = vtot

    util1 = util1 * grid.iu
    util2 = util2 * grid.iv
    # p-point average of the u/v KE tendencies (mod_niw.F90:198-210)
    nu = torch.clamp(grid.iu + grid.ip1(grid.iu), min=1.)
    nv = torch.clamp(grid.iv + grid.jp1(grid.iv, 'v'), min=1.)
    idkedt = (torch.abs((util1 + grid.ip1(util1)) / nu)
              + torch.abs((util2 + grid.jp1(util2, 'v', True)) / nv)) \
        * grid.ip

    return dataclasses.replace(niw, uml=uml_new, vml=vml_new,
                               umlres=umlres, vmlres=vmlres, idkedt=idkedt)
