"""mpgadget_tpu_torch: the PyTorch + CUDA port of mpgadget_tpu.

The dark-matter-only TreePM kick-drift-kick path on one device: Morton
sort, closed-form octree build, block tree walk, direct leaf sums (a
hand-written CUDA kernel for Hopper, ``csrc/pairkernel.cu``) and the PM
long-range force through ``torch.fft``.  Positions are fixed-point
fractions of the box held in ``int64`` tensors with values in
[0, 2^32); periodic wrap is ``& 0xFFFFFFFF`` after an add.

Importing this package imports ``torch`` and never ``jax``.
"""

import torch  # noqa: F401

__version__ = "0.1.0"
