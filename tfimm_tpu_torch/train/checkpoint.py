"""Training checkpoints; the port's stand-in for the orbax
``CheckpointManager`` that tfimm_tpu/train/trainer.py uses.

The rules are orbax's, as the JAX trainer configures it
(``max_to_keep=ckpt_to_keep``, ``keep_time_interval=12 h``, temporary
directories not cleaned up):

- one directory a step, ``<directory>/<step>/``, written into a temporary
  directory beside it and renamed into place, so that a crash leaves no
  half-written step; ``latest_step`` reads only directories named by an
  integer (``save_model``'s ``model/`` beside them is not a step);
- ``save(step, state)`` writes nothing and returns False unless ``step`` is
  above the latest step;
- after each save the steps kept are the ``max_to_keep`` newest, plus those
  the time rule keeps: the first step, and then each step at least
  ``KEEP_TIME_INTERVAL`` seconds after the last one that rule kept. Every
  step's time is the clock's reading at its save (``now``, which a test
  may replace), kept in the step's ``metadata.json``;
- a manager that only restores writes nothing: the directory is made at
  the first save, and what a save cut short left behind is ignored.

A step holds ``state.pt``: ``torch.save`` of the problem's state, nested
dicts and lists of tensors and numbers, with no pickled class, so that
``torch.load(..., weights_only=True, map_location=device)`` reads it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

__all__ = ["CheckpointManager", "KEEP_TIME_INTERVAL", "now"]

_STATE_FILE = "state.pt"
_META_FILE = "metadata.json"
_TMP_PREFIX = ".tmp-step-"
# The JAX trainer's orbax keep_time_interval, in seconds.
KEEP_TIME_INTERVAL = 12 * 3600.0


def now() -> float:
    """The clock the time rule reads, in seconds."""
    return time.time()


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._steps: List[Tuple[int, float]] = [
            (step, self._read_time(step)) for step in self.all_steps()]

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _read_time(self, step: int) -> float:
        with open(os.path.join(self._step_dir(step), _META_FILE)) as f:
            return float(json.load(f)["time"])

    def save(self, step: int, state: Dict[str, Any]) -> bool:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        t = now()
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f"{_TMP_PREFIX}{step}-",
                               dir=self.directory)
        try:
            torch.save(state, os.path.join(tmp, _STATE_FILE))
            with open(os.path.join(tmp, _META_FILE), "w") as f:
                json.dump({"step": step, "time": t}, f)
            os.rename(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._steps.append((step, t))
        self._prune()
        return True

    def _preserved(self) -> List[bool]:
        """Which of the steps (oldest first) the rules keep."""
        n = len(self._steps)
        keep = [self.max_to_keep is None or i >= n - self.max_to_keep
                for i in range(n)]
        if n:
            anchor = self._steps[0][1]
            keep[0] = True
            for i, (_, t) in enumerate(self._steps[1:], start=1):
                if t - anchor >= KEEP_TIME_INTERVAL:
                    anchor = t
                    keep[i] = True
        return keep

    def _prune(self) -> None:
        kept = []
        for (step, t), keep in zip(self._steps, self._preserved()):
            if keep:
                kept.append((step, t))
            else:
                shutil.rmtree(self._step_dir(step))
        self._steps = kept

    def restore(self, step: int, *,
                map_location: Union[str, torch.device]) -> Dict[str, Any]:
        return torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                          map_location=map_location, weights_only=True)
