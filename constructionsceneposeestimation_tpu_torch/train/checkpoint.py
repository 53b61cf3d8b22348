"""Training checkpoint and resume (port of the JAX ``train/checkpoint.py``).

Saves the whole ``TrainState`` (the model's and optimizer's state dicts,
the schedule's, and the step) with ``torch.save``, one file a step under
the directory, keeping the newest ``max_to_keep``. Each file is written
under a temporary name and then renamed, so a crash leaves no half-written
checkpoint. The port does not read the JAX package's orbax checkpoints.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from . import loop

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, save_every: int = 1000):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def maybe_save(self, state: loop.TrainState, force: bool = False) -> bool:
        step = int(state.step)
        if not force and (self.save_every <= 0 or step % self.save_every != 0):
            return False
        if self.latest_step() == step:  # already saved (periodic + final)
            return False
        tmp = self._path(step) + ".tmp"
        torch.save({"step": step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict()}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: loop.TrainState,
                step: Optional[int] = None) -> loop.TrainState:
        """Load a checkpoint (the latest unless ``step``) into ``template``'s
        model, optimizer and schedule, on their device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(template.model.parameters()).device
        ck = torch.load(self._path(step), map_location=device, weights_only=True)
        template.model.load_state_dict(ck["model"])
        template.optimizer.load_state_dict(ck["optimizer"])
        template.scheduler.load_state_dict(ck["scheduler"])
        template.step = int(ck["step"])
        return template

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX API."""
