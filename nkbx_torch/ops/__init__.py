"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Importing the package registers the forward kernels that an exported
program may hold as ``torch.library`` ops (``nkbx_torch::window_attention``,
``::attention``, ``::ln_mlp``, ``::mlp``); a bundle holding them loads only
after this import.
"""

from nkbx_torch.ops import mlp as _mlp  # noqa: F401  (registers ::ln_mlp and ::mlp)
from nkbx_torch.ops.attention import disable_fused, fused_force_disabled

__all__ = ["disable_fused", "fused_force_disabled"]
