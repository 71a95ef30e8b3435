"""Preemption (counterpart of ``nkbx/train/preempt.py``): a SIGTERM handler
sets a flag; the epoch loop breaks at the next step boundary, the trainer
saves the full train state with a batch cursor (``last.cursor.json``), and
``--resume`` continues the interrupted epoch where the signal hit.

:func:`agreed` is the decision all ranks take together. A signal reaches
one process: were each rank to break on its own flag, the others would wait
in the next step's collectives. So a data-parallel epoch asks
:func:`agreed` every ``preempt_sync_every`` batches (nkbx's default 8; 0:
the epoch's end only), at the same batch on every rank, and every rank
stops at the same step; the trainer's end-of-epoch check asks it too. On
one process it is :func:`requested`.
"""

from __future__ import annotations

import signal
import threading

_requested = False


def requested() -> bool:
    """True once a termination signal reached this process."""
    return _requested


def agreed() -> bool:
    """The preemption decision of every rank: the OR of their flags, a MAX
    all-reduce every rank must call together (nkbx's ``agreed``); on one
    process its own flag."""
    from nkbx_torch.parallel import collectives

    return collectives.agreed_any(_requested)


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
