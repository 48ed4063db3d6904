"""iHAMOCC-equivalent ocean biogeochemistry, in PyTorch.

Counterpart of `blom_tpu/bgc` (BLOM's hamocc/): column chemistry over
dense (K, J, I) tensors, every process elementwise or a fixed-trip-count
Python loop over the vertical.  Base tracer set (mo_param1_bgc.F90
i_base block, 18 advected tracers) plus the hydrogen-ion field `hi`
carried as a 19th tracer slot, the pH solver's first guess, as blom_tpu
carries it; the carbon isotopes (ciso.py) in 12 slots after them; the
sediment (sediment.py), the inventory, the CFCs and the extensions
beside the step.
"""

from .params import BgcParams, BgcTracers, NBGC
from .step import BgcForcing, hamocc_step, init_bgc_tracers
