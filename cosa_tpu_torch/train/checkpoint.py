"""Checkpoints: the whole training state for resume, and best weights.

Port of the JAX package's train/checkpoint.py with ``torch.save`` of state
dicts in place of orbax. A training checkpoint holds the student, the EMA
teacher, the optimizer, the step and the GMM state (queues, pointer and
threshold EMAs, so a resumed GMM run continues the same thresholds); the step
is also the loader's position (``build_train_loader(..., skip_batches=
step)`` replays the same data order). Files are written to a temporary name
and moved into place, so a crash never leaves a torn checkpoint, and only
the newest ``keep`` are kept. Everything loads with
``torch.load(weights_only=True)``.

Layout: ``{dir}/step_{step:08d}.pt``; best weights in
``{dir}/best_{comment}/params.pt`` beside ``meta.json``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch

from cosa_tpu_torch.train.state import GMMState

_STEP_FILE = re.compile(r"^step_(\d{8})\.pt$")


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _STEP_FILE.match(f)))


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def save_state(directory: str, state, step: int, keep: int = 2) -> str:
    """Write ``state`` as the checkpoint of ``step``; keep the newest ``keep``."""
    path = _step_path(directory, step)
    _atomic_save(dict(
        step=int(step),
        student=state.student.state_dict(),
        teacher=state.teacher.state_dict(),
        optimizer=state.optimizer.opt.state_dict(),
        gmm=dict(ptr=int(state.gmm.ptr),
                 **{k: getattr(state.gmm, k) for k in GMMState.TENSORS}),
    ), path)
    for old in _steps(directory)[:-max(int(keep), 1)]:
        os.remove(_step_path(directory, old))
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_state(path: str, state, step: Optional[int] = None):
    """Load a checkpoint into ``state`` (in place) and return it. ``path`` is
    a checkpoint file, or a directory whose ``step`` (default: the newest)
    is loaded. Tensors land on the devices of ``state``'s own."""
    if os.path.isdir(path):
        step = latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = _step_path(path, step)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state.student.load_state_dict(ck["student"])
    state.teacher.load_state_dict(ck["teacher"])
    state.optimizer.opt.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    state.gmm.ptr = int(ck["gmm"]["ptr"])
    for k in GMMState.TENSORS:
        setattr(state.gmm, k, ck["gmm"][k].to(getattr(state.gmm, k).device))
    return state


def save_best(directory: str, model: torch.nn.Module, comment: str, meta: Dict) -> None:
    """Best-weights save (reference save_best, torch_helper.py:101-117):
    ``{directory}/best_{comment}/`` holds the winning weights and ``meta``."""
    path = os.path.join(directory, f"best_{comment}")
    _atomic_save(model.state_dict(), os.path.join(path, "params.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_best(directory: str, comment: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``best_{comment}``'s weights into ``model`` and return it."""
    path = os.path.join(directory, f"best_{comment}", "params.pt")
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model
