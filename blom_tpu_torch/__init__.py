"""blom_tpu_torch: the PyTorch/CUDA port of blom_tpu.

Module paths mirror blom_tpu's.  Plain tensor code is PyTorch; each
Pallas TPU kernel of blom_tpu becomes a CUDA C++ kernel under `csrc/`,
built with nvcc for sm_90a at first use, beside a plain PyTorch version
of the same function that CPU tensors take."""
