"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Importing the package registers the forward kernels that an exported
program may hold as ``torch.library`` ops (``nkbx_torch::window_attention``,
``::attention``, ``::ln_mlp``, ``::mlp``); a bundle holding them loads only
after this import.

Under data parallelism (:mod:`nkbx_torch.parallel`) every rank calls the
kernels on its own rows, as nkbx's ``shard_map`` twins run them per shard,
and the gates decide on those rows. A rank's rows are whole images, so the
conditions nkbx's sharded entries check (the window groups divisible by the
ranks, whole images a shard) hold by construction; the one that can fail,
ghost groups that do not divide a rank's rows, raises in
:class:`~nkbx_torch.models.common.TorchBatchNorm` with nkbx's ndev·g. The
twins' cross-shard sums (the bias and weight gradients) are the step's one
gradient all-reduce.
"""

from nkbx_torch.ops import mlp as _mlp  # noqa: F401  (registers ::ln_mlp and ::mlp)
from nkbx_torch.ops.attention import disable_fused, fused_force_disabled

__all__ = ["disable_fused", "fused_force_disabled"]
