"""nkbx_torch: the PyTorch and CUDA port of nkbx, for NVIDIA Hopper (H100).

The JAX package ``nkbx`` beside it is the reference; this package imports
nothing of it, nor JAX. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. The kernels nkbx wrote in Pallas for the TPU are
CUDA C++ kernels here (``nkbx_torch/ops/csrc``), each with a plain PyTorch
version beside it. See ROADMAP.md for what is ported.
"""

__version__ = "0.1.0"
