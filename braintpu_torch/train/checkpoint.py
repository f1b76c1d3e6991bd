"""Training checkpoint / resume with ``torch.save``.

Counterpart of ``braintpu/train/checkpoint.py`` (orbax there): a
:class:`CheckpointManager` with the reference's ``save``, ``restore``,
``latest_step``, ``close`` and ``max_to_keep=3``.  Each retained step is a
directory holding one file::

    <dir>/
      <step>/train_state.pt   params, optimizer state, step, schedule

A save writes into a temporary directory and renames it into place, so an
interrupted save leaves no partial step behind.  ``restore`` loads into a
template state of the same architecture and optimizer (in place, onto the
template's devices) and raises ``ValueError`` on a mismatch.  The files are
read with ``weights_only=True``: tensors and plain containers only.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

__all__ = ["CheckpointManager", "latest_step", "restore_train_state", "save_train_state"]

STATE_FILE = "train_state.pt"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints under one directory."""

    def __init__(self, directory: os.PathLike, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def save(self, state, step: Optional[int] = None) -> int:
        step = int(state.step) if step is None else int(step)
        opt = state.opt_state
        payload = {
            "params": _flatten(state.params),
            "optimizer": opt.state_dict(),
            "step": step,
            "schedule": {"lr": [g["lr"] for g in opt.param_groups], "count": step},
        }
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        final = self.directory / str(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return step

    def restore(self, template, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into ``template``; returns
        it, or None when the directory holds no checkpoint."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        payload = torch.load(self.directory / str(step) / STATE_FILE, map_location="cpu",
                             weights_only=True)
        want = _flatten(template.params)
        got = payload["params"]
        if set(got) != set(want) or any(tuple(got[k].shape) != tuple(want[k].shape) for k in want):
            raise ValueError(f"checkpoint {step} under {self.directory} does not match the "
                             "template's parameters: architecture mismatch")
        with torch.no_grad():
            for k, t in want.items():
                t.copy_(got[k])
        try:
            template.opt_state.load_state_dict(payload["optimizer"])
        except ValueError as e:
            raise ValueError(f"checkpoint {step}: optimizer mismatch ({e})") from e
        template.step = int(payload["step"])
        return template

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing stays open between calls (kept for the reference's API)."""


def save_train_state(directory: os.PathLike, state, max_to_keep: int = 3) -> int:
    """One-shot save; returns the step saved under."""
    return CheckpointManager(directory, max_to_keep).save(state)


def latest_step(directory: os.PathLike) -> Optional[int]:
    if not Path(directory).exists():
        return None
    return CheckpointManager(directory).latest_step()


def restore_train_state(directory: os.PathLike, template, step: Optional[int] = None):
    """Restore step ``step`` (default: the latest) into ``template``, in
    place; returns it, or None when the directory holds no checkpoint."""
    return CheckpointManager(directory).restore(template, step)
