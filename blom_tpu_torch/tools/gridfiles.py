"""Input files for the grid-file builds and the coupled cap.

Nothing is downloaded: these write a BLOM-convention grid file of any
port grid's geometry (`write_grid_file`), a WOA-shaped initial-condition
file (`write_ic_file`), and both for the tripolar geometry
(`coupled_files`); `coupled_imports` gives the cap a fixed set of
imports.

    from pathlib import Path
    from blom_tpu_torch.drivers import coupled, standalone
    from blom_tpu_torch.tools import gridfiles
    gr, ic = gridfiles.coupled_files(Path('run'), 32, 24, 6, dt_lat=4.)
    m = standalone.build_gridfile(gr, kdm=6, baclin=180., batrop=6.,
                                  expcnf='cesm', icfile=ic, arctic=True,
                                  device='cpu')
    cap = coupled.OcnCap(m, nstep_in_cpl=2)
    ex = cap.data_initialize()
    ex = cap.advance(gridfiles.coupled_imports(m))
"""

import numpy as np
import torch

#: the 33 standard depth levels of the World Ocean Atlas [m]
WOA_LEVELS = (0., 10., 20., 30., 50., 75., 100., 125., 150., 200., 250.,
              300., 400., 500., 600., 700., 800., 900., 1000., 1100.,
              1200., 1300., 1400., 1500., 1750., 2000., 2500., 3000.,
              3500., 4000., 4500., 5000., 5500.)

#: the sea floor of coupled_files' grid file [m], the climatology's
#: deepest level over all water.  build_tripolar's own floor is 100 m:
#: inicon_woa's fill_global then sweeps 1000 times each climatology level
#: wholly below it (~9.5 s a level and field at 360x384), and the layers
#: below the floor are massless, where the ALE step turns NaN (ROADMAP
#: section 3).
ABYSS_DEPTH = 5500.

#: grid-file variable -> Grid attribute (core/geoenv.py's names); qlat
#: from plat, as tests/test_global_grids.py writes it
GRID_FILE_VARS = dict(pdx='scpx', pdy='scpy', udx='scux', udy='scuy',
                      vdx='scvx', vdy='scvy', qdx='scqx', qdy='scqy',
                      plat='plat', plon='plon', qlat='plat',
                      pdepth='depths')


def woa_bounds():
    """(33, 2) bounds of WOA_LEVELS: the midpoints between levels, 0 at
    the top and 5500 m at the bottom."""
    lev = np.asarray(WOA_LEVELS)
    mid = .5 * (lev[1:] + lev[:-1])
    return np.stack([np.r_[lev[0], mid], np.r_[mid, lev[-1]]], 1)


def abyss_depths(grid):
    """ABYSS_DEPTH over the grid's water, land where it has land."""
    return np.where(grid.depths.cpu().double().numpy() > 0., ABYSS_DEPTH,
                    0.)


def write_grid_file(path, grid, depths=None):
    """A BLOM-convention grid file (core/geoenv.py's variables) of
    `grid`'s geometry, the sea floor `depths` if given: NetCDF, or an
    .npz archive where `path` ends in .npz."""
    v = {k: getattr(grid, a).cpu().double().numpy()
         for k, a in GRID_FILE_VARS.items()}
    if depths is not None:
        v['pdepth'] = np.asarray(depths, np.float64)
    if str(path).endswith('.npz'):
        np.savez(path, **v)
        return
    from scipy.io import netcdf_file
    with netcdf_file(str(path), 'w') as nc:
        nc.createDimension('y', v['pdx'].shape[0])
        nc.createDimension('x', v['pdx'].shape[1])
        for k, a in v.items():
            nc.createVariable(k, 'd', ('y', 'x'))[:] = a


def write_ic_file(path, t_an, s_an, depth_bnds):
    """A WOA-shaped initial-condition file: t_an and s_an (depth, lat,
    lon) on the model grid and depth_bnds (depth, 2)."""
    from scipy.io import netcdf_file
    k, jj, ii = t_an.shape
    with netcdf_file(str(path), 'w') as nc:
        nc.createDimension('depth', k)
        nc.createDimension('nbounds', 2)
        nc.createDimension('lat', jj)
        nc.createDimension('lon', ii)
        nc.createVariable('t_an', 'd', ('depth', 'lat', 'lon'))[:] = t_an
        nc.createVariable('s_an', 'd', ('depth', 'lat', 'lon'))[:] = s_an
        nc.createVariable('depth_bnds', 'd', ('depth', 'nbounds'))[:] = \
            depth_bnds


def coupled_files(directory, itdm, jtdm, kdm, device='cpu', dt_lat=0.):
    """The grid file (grid.nc) of build_tripolar's geometry at (itdm,
    jtdm, kdm), built on `device`, with abyss_depths' sea floor, and a
    WOA-shaped initial-condition file (woa.nc) on WOA_LEVELS with
    build_gridfile's fallback profile, warmer by dt_lat * cos(plat) K
    (horizontally uniform at 0), both in `directory` (a Path); returns
    their paths."""
    from ..drivers import standalone
    geom = standalone.build_tripolar(itdm=itdm, jtdm=jtdm, kdm=kdm,
                                     device=device).grid
    grfile = str(directory / 'grid.nc')
    write_grid_file(grfile, geom, abyss_depths(geom))
    _, _, t, s = standalone.fallback_profile(np.asarray(WOA_LEVELS))
    shape = (len(WOA_LEVELS), jtdm, itdm)
    coslat = np.cos(np.radians(geom.plat.cpu().double().numpy()))
    icfile = str(directory / 'woa.nc')
    write_ic_file(icfile, t[:, None, None] + dt_lat * coslat[None],
                  np.broadcast_to(s[:, None, None], shape), woa_bounds())
    return grfile, icfile


def coupled_imports(model):
    """tests/test_coupled.py:16-28's import values on the model's grid,
    the shortwave scaled by max(cos(plat), 0)."""
    from ..drivers import coupled
    g = model.grid
    z = torch.zeros_like(g.ip)

    def f(v):
        return torch.full_like(g.ip, v)
    cosl = torch.cos(torch.deg2rad(g.plat)).clamp_min(0.)
    return coupled.ImportFields(
        taux=f(.05), tauy=z, swnet=150. * cosl, lat=f(-60.), sen=f(-15.),
        lwup=f(-380.), lwdn=f(340.), rain=f(3e-5), snow=z,
        evap=f(-4e-5), rofl=z, rofi=z, melth=z, meltw=z, salt=z,
        ifrac=z, pslv=f(101325.), duu10n=f(36.),
        rofl_glc=z, rofi_glc=z, lamult=f(1.), ustokes=z, vstokes=z,
        hstokes=z, bcpho=z, bcphi=z, flxdst=z, ndep=z, co2prog=z,
        co2diag=z)
