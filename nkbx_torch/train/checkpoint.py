"""Checkpoints with full train-state resume (counterpart of
``nkbx/train/checkpoint.py``).

Layout under ``<run>/weights/``:

- ``best/`` and ``last/``: ``train_state.pt`` (``torch.save``) with the
  module's state dict (BatchNorm running statistics included), the
  optimizer's step counts, moments and NAdam products, the generator's
  state, the step, the meta ``epoch`` and ``best_val_acc``, and under
  ``ema`` the EMA shadow's state dict where the run keeps one;
- ``last.cursor.json``: the mid-epoch preemption cursor, nkbx's keys
  (``epoch``, ``batch``, ``step``, ``batch_size``, ``process_count``);
- ``best.pt`` and ``last.pt``: the module's state dict alone, where nkbx
  writes msgpacks (the EMA shadow's where the run keeps one, as nkbx's
  msgpacks hold ``ema_params``); ``get_model``'s ``checkpoint`` key loads
  them. A ``best/`` directory loads the raw weights, as nkbx's
  ``load_model_variables`` does.

A save writes into ``<path>.tmp`` and swaps it into place, so the previous
checkpoint survives a preemption during the save. With several ranks (their
states are equal) rank 0 alone writes, between two barriers: no rank goes
on before the swap is done, nor reads a checkpoint that is being written.
A scattered state (``fsdp``) is gathered first, every rank joining, so the
files are those of the replicated state; a restore takes each rank's
shards from the whole tensors, so either layout resumes the other.
"""

from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

import torch

from nkbx_torch.parallel import collectives

STATE_FILE = "train_state.pt"


def _payload(state, epoch: int, best_val_acc: float):
    """The checkpoint's contents, whole (every rank calls it)."""
    with state.gathered(state.module), state.gathered(state.ema_module):
        payload = {
            "module": state.module.state_dict(),
            "opt_state": {label: {"count": st.count,
                                  "mu": state.whole(state.groups[label], st.mu),
                                  "nu": state.whole(state.groups[label], st.nu),
                                  "mu_product": st.mu_product}
                          for label, st in state.opt_state.items()},
            "generator": state.generator.get_state(),
            "step": int(state.step),
            "meta": {"epoch": int(epoch), "best_val_acc": float(best_val_acc)},
        }
        if state.ema_module is not None:
            payload["ema"] = state.ema_module.state_dict()
    return payload


def save_checkpoint(path, state, epoch: int, best_val_acc: float = 0.0,
                    cursor: dict | None = None):
    """Save the full train state to the directory ``path``, crash-safe.

    ``cursor`` (the mid-epoch preemption cursor) is written as the sidecar
    ``<path>.cursor.json``; ``None`` (every end-of-epoch save) removes a
    stale one. The cursor pins the state's ``step``, so one that does not
    match its checkpoint is ignored on resume. Every rank calls it; rank 0
    writes."""
    collectives.barrier()
    payload = _payload(state, epoch, best_val_acc)
    if collectives.rank() == 0:
        _write_checkpoint(path, payload, cursor)
    collectives.barrier()


def _write_checkpoint(path, payload, cursor):
    path = Path(path).resolve()
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / STATE_FILE)
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    cursor_path = path.with_name(path.name + ".cursor.json")
    if cursor is None:
        cursor_path.unlink(missing_ok=True)
    else:
        ctmp = cursor_path.with_suffix(".json.tmp")
        ctmp.write_text(json.dumps(cursor))
        ctmp.rename(cursor_path)


def load_cursor(path) -> dict | None:
    """The preemption cursor beside the checkpoint ``path``, if present and
    readable."""
    cursor_path = Path(path).resolve()
    cursor_path = cursor_path.with_name(cursor_path.name + ".cursor.json")
    if not cursor_path.exists():
        return None
    try:
        return json.loads(cursor_path.read_text())
    except (OSError, ValueError):
        return None


@torch.no_grad()
def restore_train_state(path, state):
    """Load the checkpoint ``path`` into ``state`` (a :class:`TrainState` of
    the same model and optimizer groups) in place; returns (state, epoch,
    best_val_acc).

    The EMA shadow follows ``state`` as it was made (nkbx
    checkpoint.py:109-128): a state with a shadow takes the checkpoint's,
    or, from a checkpoint saved without EMA, starts it at the restored
    weights; a state without one ignores a saved shadow."""
    payload = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    for module, sd in ((state.module, payload["module"]),
                       (state.ema_module, payload.get("ema", payload["module"]))):
        if module is not None:
            scat = state.scatter_of(module)
            (scat or module).load_state_dict(sd)
    for label, saved in payload["opt_state"].items():
        st = state.opt_state[label]
        if len(saved["mu"]) != len(st.mu):
            raise ValueError(f"checkpoint {path}: optimizer group {label!r} holds "
                             f"{len(saved['mu'])} tensors, the model {len(st.mu)}")
        owners = state.groups[label] * 2
        for dst, src, owner in zip(st.mu + st.nu, saved["mu"] + saved["nu"], owners):
            dst.copy_(state.local(owner, src))
        st.count, st.mu_product = int(saved["count"]), float(saved["mu_product"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    meta = payload["meta"]
    return state, int(meta["epoch"]), float(meta["best_val_acc"])


def save_weights(path, module, state=None):
    """The module's state dict alone (``best.pt``, ``last.pt``): the trained
    module, or the EMA shadow where the run keeps one. Rank 0 writes; with
    the ``state`` that scatters ``module`` every rank joins its gather."""
    with state.gathered(module) if state is not None else contextlib.nullcontext():
        if collectives.rank() == 0:
            torch.save(module.state_dict(), path)
