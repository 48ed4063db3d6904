"""iHAMOCC-equivalent ocean biogeochemistry, in PyTorch.

Counterpart of `blom_tpu/bgc` (BLOM's hamocc/), base chain: column
chemistry over dense (K, J, I) tensors, every process elementwise or a
fixed-trip-count Python loop over the vertical.  Base tracer set
(mo_param1_bgc.F90 i_base block, 18 advected tracers) plus the
hydrogen-ion field `hi` carried as a 19th tracer slot, the pH solver's
first guess, as blom_tpu carries it.
"""

from .params import BgcParams, BgcTracers, NBGC
from .step import BgcForcing, hamocc_step, init_bgc_tracers
