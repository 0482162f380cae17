"""Checkpoint manager: the port's copy of
parameter_server_distributed_tpu/checkpoint/manager.py — periodic
epoch-advance autosave + on-demand save/load, with the same files (the
codec's ``.ckpt``, the ``.opt.npz`` optimizer and ``.meta.json`` version
sidecars), so a checkpoint moves between the two packages.

Reproduces the reference's checkpoint daemon semantics
(reference: src/parameter_server_service.cpp:150-169): every
``check_period_s`` (5 s) compute ``epoch = current_iteration //
checkpoint_interval``; when the epoch advances past the last saved epoch,
write ``checkpoint_epoch_<N>.ckpt`` (same filename convention).  Adds what
the reference lacks: atomic writes (codec.save), retention of the newest K
files, optimizer-state sidecars, and a clean stop.  The port's PS service
does not run the daemon: it hands :meth:`CheckpointManager.write` the
state of the apply that advanced the epoch (server/ps_service.py).

Every save takes the core's params and optimizer state in one hold of
its locks (``ParameterServerCore.checkpoint_state``) and downloads and
writes after them, so the two files hold the same iteration.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
from typing import Callable

import numpy as np

from ..core.ps_core import CheckpointState, ParameterServerCore
from ..core.tensor import state_to_host, to_host
from . import codec

_CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.ckpt$")


def checkpoint_filename(epoch: int) -> str:
    """reference: src/parameter_server_service.cpp:160."""
    return f"checkpoint_epoch_{epoch}.ckpt"


class CheckpointManager:
    def __init__(self,
                 core: ParameterServerCore,
                 directory: str = ".",
                 checkpoint_interval: int = 10,
                 check_period_s: float = 5.0,
                 keep: int = 0,
                 on_save: Callable[[str, int], None] | None = None):
        self._core = core
        self._dir = directory
        self._interval = max(1, int(checkpoint_interval))
        self._period = check_period_s
        self._keep = int(keep)
        self._on_save = on_save
        self._last_saved_epoch = -1
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # held around the file writes and the saved-epoch bookkeeping
        # only, never while a core lock is taken: an on-demand save
        # racing the autosave daemon must not interleave writes on the
        # same .tmp file, and the PS's saver thread writes while the
        # thread that queued its state holds the core's state lock
        self._lock = threading.Lock()

    # ----------------------------------------------------------- daemon
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="checkpoint-autosave")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            self.maybe_autosave()

    def maybe_autosave(self) -> str | None:
        """Epoch-advance check (reference: parameter_server_service.cpp:153-168).
        Returns the path written, or None."""
        epoch = self._core.current_iteration // self._interval
        if epoch <= self._last_saved_epoch:
            return None
        if not self._core.has_parameters:
            # nothing to save yet: don't burn the epoch slot on an empty
            # checkpoint (restoring one would wipe live parameters)
            return None
        return self.save(epoch=epoch)

    # ------------------------------------------------------------ save/load
    def save(self, epoch: int | None = None, path: str | None = None) -> str:
        """On-demand save (reference RPC SaveCheckpoint —
        src/parameter_server_service.cpp:97-115; path defaults to the
        epoch-filename convention)."""
        return self.write(self._core.checkpoint_state(), epoch, path)

    def write(self, state: CheckpointState, epoch: int | None = None,
              path: str | None = None) -> str:
        """Download and write a state the core handed out
        (``checkpoint_state``); ``epoch`` defaults to the state's."""
        params = to_host(state.params)
        opt_state = state_to_host(state.optimizer)
        epoch = state.epoch if epoch is None else int(epoch)
        if path is None:
            path = os.path.join(self._dir, checkpoint_filename(epoch))
        with self._lock:
            codec.save(path, epoch, state.iteration, params)
            if opt_state:
                _save_optimizer_sidecar(path, opt_state)
            # store-version meta sidecar: the version counter at save
            # time, so a LATER process restoring this file resumes
            # numbering past it and a version id the saving process
            # already served can never name different values.  Read
            # after the state was taken — a later apply makes the
            # recorded version only larger, which is the safe direction.
            _save_meta_sidecar(path, {
                "params_version": int(self._core.params_version)})
            self._core.epoch = epoch
            self._last_saved_epoch = max(self._last_saved_epoch, epoch)
            self._apply_retention()
        if self._on_save is not None:
            self._on_save(path, epoch)
        return path

    def load(self, path: str) -> tuple[int, int]:
        """Restore PS state from a checkpoint file (reference RPC
        LoadCheckpoint — src/parameter_server_service.cpp:118-148).
        Returns (epoch, iteration)."""
        epoch, iteration, params = codec.load(path)
        if not params:
            raise ValueError(f"refusing to restore empty checkpoint {path!r}")
        opt_state = _load_optimizer_sidecar(path)
        meta = _load_meta_sidecar(path)
        self._core.restore(
            epoch, iteration, params, optimizer_state=opt_state,
            # serve_version monotonicity across processes: restore
            # resumes version numbering past the save-time counter
            # (core.restore also bumps past everything THIS process
            # served)
            params_version=int(meta.get("params_version", 0)))
        with self._lock:
            self._last_saved_epoch = max(self._last_saved_epoch, epoch)
        return epoch, iteration

    def latest(self) -> str | None:
        """Newest checkpoint in the directory by epoch number."""
        best, best_epoch = None, -1
        for path in glob.glob(os.path.join(self._dir, "checkpoint_epoch_*.ckpt")):
            match = _CKPT_RE.search(path)
            if match and int(match.group(1)) > best_epoch:
                best, best_epoch = path, int(match.group(1))
        return best

    def _apply_retention(self) -> None:
        if self._keep <= 0:
            return
        found = []
        for path in glob.glob(os.path.join(self._dir, "checkpoint_epoch_*.ckpt")):
            match = _CKPT_RE.search(path)
            if match:
                found.append((int(match.group(1)), path))
        found.sort()
        for _, path in found[:-self._keep]:
            try:
                os.remove(path)
                for suffix in (".opt.npz", ".meta.json"):
                    sidecar = path + suffix
                    if os.path.exists(sidecar):
                        os.remove(sidecar)
            except OSError:
                pass


def _save_meta_sidecar(path: str, meta: dict) -> None:
    """Framework-only metadata next to the checkpoint (atomic, JSON).
    Deliberately a sidecar: the .ckpt byte layout is pinned to the
    reference (checkpoint/codec.py) and must stay loadable by it."""
    tmp = path + ".meta.json.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".meta.json")


def _load_meta_sidecar(path: str) -> dict:
    """Meta sidecar contents, values normalized ({} for reference-written
    checkpoints).  Best-effort by contract: a missing, unparseable, or
    wrong-typed OPTIONAL sidecar must never block restoring a valid
    .ckpt."""
    try:
        with open(path + ".meta.json", encoding="utf-8") as f:
            loaded = json.load(f)
        if not isinstance(loaded, dict):
            return {}
        loaded["params_version"] = int(loaded.get("params_version") or 0)
        return loaded
    except (OSError, ValueError, TypeError):
        return {}


def _save_optimizer_sidecar(path: str, state: dict) -> None:
    """Flatten the optimizer state dict (numpy: device optimizers download
    their slots through core.tensor.to_host) into an npz next to the
    checkpoint."""
    flat: dict[str, np.ndarray] = {}
    for slot, value in state.items():
        if isinstance(value, dict):
            for name, arr in value.items():
                flat[f"{slot}/{name}"] = np.asarray(arr)
        else:
            flat[f"__scalar__/{slot}"] = np.asarray(value)
    tmp = path + ".opt.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path + ".opt.npz")


def _load_optimizer_sidecar(path: str) -> dict | None:
    sidecar = path + ".opt.npz"
    if not os.path.exists(sidecar):
        return None
    state: dict = {}
    with np.load(sidecar) as npz:
        for key in npz.files:
            slot, _, name = key.partition("/")
            if slot == "__scalar__":
                value = npz[key]
                state[name] = value.item() if value.ndim == 0 else value
            else:
                state.setdefault(slot, {})[name] = npz[key]
    return state
