"""Device resolution for the port's entry points.

The port runs on the CUDA card by default. The CPU is taken only when the
caller asks for it (``device="cpu"``, as the tests do); a missing card is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise when a CUDA device is asked for and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nkbx_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds of one call of ``fn`` on the current CUDA stream: one
    call to warm up, then ``iters`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters
