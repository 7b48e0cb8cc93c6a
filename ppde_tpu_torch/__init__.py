"""ppde_tpu_torch — the PyTorch / CUDA (H100) port of ``ppde_tpu``.

The JAX package stays the reference; this package is its counterpart,
module by module under the same names. Plain tensor code is PyTorch; each
Pallas kernel on the ported path is a CUDA C++ kernel for Hopper
(``csrc/``, built with nvcc at first use by ``ops/_build.py``) with a plain
PyTorch version beside it. On a CPU tensor the plain version runs; on a CUDA
tensor the kernel runs or the call raises.

First slice: the protein PPDE-PAS sampler on the Potts + OnehotCNN-ensemble
product-of-experts energy (``samplers/protein/ppde.py``, ``energy.py``).
"""

__version__ = "0.1.0"

from ppde_tpu_torch import codec, utils  # noqa: F401
