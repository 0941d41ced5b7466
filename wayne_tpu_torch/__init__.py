"""wayne_tpu_torch: the PyTorch/CUDA port of wayne_tpu (the HST WFC3 IR
grism visit simulator), beside the JAX package it was ported from.

Plain tensor work is PyTorch; the up-the-ramp readout, three Pallas
kernels in the JAX package, is three CUDA C++ kernels written for Hopper
(``csrc/readout.cu`` and ``csrc/read_step.cu``, bound in
:mod:`wayne_tpu_torch.ops.readout`). CPU tensors take their plain PyTorch
versions.

fp32 contractions (the splat, the light curve's hat-weight interpolation)
must run in full float32: TF32 keeps ~3 decimal digits, far above the
transit depths and oracle tolerances those contractions carry. They are set
off here, at import, whatever PyTorch's defaults are.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
