"""Preemption (counterpart of ``nkbx/train/preempt.py``): a SIGTERM handler
sets a flag; the epoch loop breaks at the next step boundary, the trainer
saves the full train state with a batch cursor (``last.cursor.json``), and
``--resume`` continues the interrupted epoch where the signal hit.

:func:`agreed` is the decision all processes take together; on one process
it is :func:`requested`. Agreeing across processes is multi-GPU work
(ROADMAP.md, A10) and raises.
"""

from __future__ import annotations

import signal
import threading

_requested = False


def requested() -> bool:
    """True once a termination signal reached this process."""
    return _requested


def agreed() -> bool:
    """The preemption decision of every process: on one process its own
    flag."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("preemption across processes is not ported to nkbx_torch "
                                  "yet (ROADMAP.md, A10)")
    return _requested


def reset() -> None:
    global _requested
    _requested = False


def _handler(signum, frame):
    global _requested
    _requested = True


def install(signals=(signal.SIGTERM,)) -> bool:
    """Install the flag-setting handler; False (and nothing done) off the
    main thread, where Python takes no signal handlers."""
    if threading.current_thread() is not threading.main_thread():
        return False
    for s in signals:
        signal.signal(s, _handler)
    return True
