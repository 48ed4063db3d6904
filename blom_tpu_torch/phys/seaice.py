"""Thermodynamic sea-ice and snow state and parameters.

Counterpart of `blom_tpu/phys/seaice.py` (BLOM's mod_seaice.F90:44-120
state fields and ben02/mod_thdysi.F90:32-86 thermodynamic parameters):
the ice state that the ben02 bulk-forcing functions carry beside the
ocean state."""

from __future__ import annotations

import dataclasses

import torch

# mod_thdysi.F90:61-80 data statements
albi_f = .70       # max albedo over ice
albi_m = .60       # max albedo over melting ice
albs_f = .85       # albedo over snow
albs_m = .75       # albedo over melting snow
rhoice = 906.      # density of ice [kg m-3]
rhosnw = 330.      # density of snow [kg m-3]
rkice = 2.04       # ice conductivity [W m-1 K-1]
rksnw = .31        # snow conductivity [W m-1 K-1]
fusi = 3.02e8      # heat of fusion of ice [J m-3]
fuss = 1.10e8      # heat of fusion of snow [J m-3]
fice_max = .995    # maximum fractional ice cover
tice_m = 273.05    # melting point of ice [K]
tsnw_m = 273.15    # melting point of snow [K]
hice_nhmn = .50    # min ice thickness, northern hemisphere [m]
hice_shmn = .30    # min ice thickness, southern hemisphere [m]
sagets = 2.e-7     # snow aging timescale [s-1]
sice = 6.          # sea-ice salinity [g kg-1]
cwi = 0.006        # ice-ocean heat transfer coefficient
cuc = 1.e3         # under-cooled water heat-flux constant [W m-2 K-1]


@dataclasses.dataclass
class SeaiceState:
    """Per-point ice/snow slab state, all (jdm, idm) (mod_seaice.F90
    ficem/hicem/hsnwm/iagem, mod_thdysi tsrfm/ticem, and the ben02
    accumulators and runoff reservoir)."""
    ficem: torch.Tensor    # ice concentration []
    hicem: torch.Tensor    # ice thickness [m]
    hsnwm: torch.Tensor    # snow thickness [m]
    tsrfm: torch.Tensor    # surface temperature [K]
    ticem: torch.Tensor    # ice temperature [K]
    iagem: torch.Tensor    # ice age [days]
    ustari: torch.Tensor   # ice-ocean friction velocity [m s-1]
    uicem: torch.Tensor    # ice drift x velocity [m s-1] (mod_seaice.F90:40)
    vicem: torch.Tensor    # ice drift y velocity [m s-1]
    albm: torch.Tensor     # surface albedo [] (ben02 thermo)
    tauxice: torch.Tensor  # ice-ocean x stress [N m-2]
    tauyice: torch.Tensor  # ice-ocean y stress [N m-2]
    rnfres: torch.Tensor   # runoff reservoir [kg m-2]
    salt_corr: torch.Tensor  # accumulated salt-limiting correction


def init_seaice(shape, dtype=torch.float64, device=None) -> SeaiceState:
    """Ice-free state at 273.15 K on `device` (CUDA unless the caller
    names one)."""
    from ..drivers.standalone import _device
    H = tuple(shape)
    dev = _device(device)

    def f(v):
        return torch.full(H, v, dtype=dtype, device=dev)
    return SeaiceState(ficem=f(0.), hicem=f(0.), hsnwm=f(0.),
                       tsrfm=f(273.15), ticem=f(273.15), iagem=f(0.),
                       ustari=f(0.), uicem=f(0.), vicem=f(0.), albm=f(0.),
                       tauxice=f(0.), tauyice=f(0.), rnfres=f(0.),
                       salt_corr=f(0.))
