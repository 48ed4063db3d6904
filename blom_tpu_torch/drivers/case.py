"""Namelist-driven case builder.

Counterpart of `build_case` in `blom_tpu/drivers/case.py`: a BLOM
`limits` deck (rdlim, mod_rdlim.F90:137-250) builds a runnable
experiment, with the deck's momentum, barotropic, advection and ALE
reconstruction options applied in blom_tpu's order.  The port builds the
fuk95 and channel experiments; `run_case` (restart alarms, diagnostic
output, the final checksum) is not ported."""

from __future__ import annotations

import torch

from ..core import config as cfg_mod
from ..core.config import RunConfig
from ..dynamics.barotp import BarotpParams
from ..dynamics.momtum import MomtumParams
from . import standalone

_DTYPES = {'float64': torch.float64, 'float32': torch.float32}


def build_case(limits_path: str = None, cfg: RunConfig = None,
               device=None):
    """Build a Model from a BLOM `limits` deck, or from `cfg` when given
    (the expcnf dispatch of mod_inigeo/mod_inifrc).  Returns (model,
    cfg).  Runs on the card unless `device` names another; without CUDA
    and without `device` it raises."""
    if cfg is None:
        cfg = cfg_mod.load_limits(limits_path)
    if cfg.dtype not in _DTYPES:
        raise ValueError(f'dtype {cfg.dtype!r}: expected one of '
                         f'{tuple(_DTYPES)}')
    dtype = _DTYPES[cfg.dtype]

    if cfg.expcnf == 'fuk95':
        model = standalone.build_fuk95(dtype=dtype, device=device,
                                       vcoord=cfg.vcoord.vcoord_type)
    elif cfg.expcnf == 'channel':
        model = standalone.build_channel(dtype=dtype, baclin=cfg.baclin,
                                         batrop=cfg.batrop, device=device)
    else:
        raise NotImplementedError(
            f'expcnf {cfg.expcnf!r} is not ported to blom_tpu_torch '
            "(only 'fuk95' and 'channel')")

    model.par = model.par._replace(
        momtum=MomtumParams(
            mdv2hi=cfg.mdv2hi, mdv2lo=cfg.mdv2lo, mdv4hi=cfg.mdv4hi,
            mdv4lo=cfg.mdv4lo, vsc2hi=cfg.vsc2hi, vsc2lo=cfg.vsc2lo,
            vsc4hi=cfg.vsc4hi, vsc4lo=cfg.vsc4lo, cbar=cfg.cbar,
            cb=cfg.cb, mommth=cfg.mommth),
        barotp=BarotpParams(cwbdts=cfg.cwbdts, cwbdls=cfg.cwbdls,
                            mommth=cfg.mommth),
        pgfmth=cfg.pgfmth,
        advmth=cfg.advmth,
        cppm_compatibility=cfg.cppm_compatibility,
        cppm_limiting=cfg.cppm_limiting)
    if model.par.ale is not None:
        # &ALE_REGRID_REMAP reconstruction options
        # (mod_ale_regrid_remap.F90:62-81)
        model.par = model.par._replace(ale=model.par.ale._replace(
            reconstruction_method=cfg.ale.reconstruction_method,
            upper_bndr_ord=cfg.ale.upper_bndr_ord,
            lower_bndr_ord=cfg.ale.lower_bndr_ord,
            tracer_limiting=cfg.ale.tracer_limiting,
            velocity_limiting=cfg.ale.velocity_limiting,
            tracer_pc_upper=cfg.ale.tracer_pc_upper_bndr,
            velocity_pc_upper=cfg.ale.velocity_pc_upper_bndr))
    return model, cfg
