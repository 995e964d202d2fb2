"""Checkpoints: the whole training state for resume, and best weights.

Port of the JAX package's train/checkpoint.py with ``torch.save`` of state
dicts in place of orbax. A training checkpoint holds the student, the EMA
teacher, the optimizer, the step and the GMM state (queues, pointer and
threshold EMAs, so a resumed GMM run continues the same thresholds); the step
is also the loader's position (``build_train_loader(..., skip_batches=
step)`` replays the same data order). Files are written to a temporary name
and moved into place, so a crash never leaves a torn checkpoint, and only
the newest ``keep`` are kept. Everything loads with
``torch.load(weights_only=True)``. A multi-process run writes the full
state from rank 0, whatever its layout, so any layout (one process
included) resumes from it.

Layout: ``{dir}/step_{step:08d}.pt``; best weights in
``{dir}/best_{comment}/params.pt`` beside ``meta.json``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import torch

from cosa_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    gather_state_dict,
    join_tensor,
    sharded_params,
)
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


def _optimizer_state_dict(state, mesh: Mesh) -> Dict:
    """The optimizer's state dict with the moments of the parameters split
    over the model axis joined to their full shape (collective)."""
    sd = state.optimizer.opt.state_dict()
    if mesh.tp == 1:
        return sd
    split = sharded_params(state.student)
    names = {id(p): n for n, p in state.student.named_parameters()}
    order = [p for g in state.optimizer.opt.param_groups for p in g["params"]]
    for i, p in enumerate(order):  # state_dict numbers the parameters in this order
        spec = split.get(names[id(p)])
        if spec is not None and i in sd["state"]:
            sd["state"][i] = {k: join_tensor(v, *spec, mesh.tp_group)
                              if torch.is_tensor(v) and v.ndim else v
                              for k, v in sd["state"][i].items()}
    return sd


def optimizer_moments(state, mesh: Optional[Mesh] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{student parameter name: its optimizer state} at the full shape, for
    the parameters the optimizer has stepped (collective over the model
    group, as :func:`save_state`)."""
    sd = _optimizer_state_dict(state, mesh or Mesh())
    names = {id(p): n for n, p in state.student.named_parameters()}
    order = [names[id(p)] for g in state.optimizer.opt.param_groups for p in g["params"]]
    return {order[i]: s for i, s in sd["state"].items()}


def save_state(directory: str, state, step: int, keep: int = 2,
               mesh: Optional[Mesh] = None) -> str:
    """Write ``state`` as the checkpoint of ``step``; keep the newest
    ``keep``. Under a ``mesh`` every rank calls it: the full state is
    gathered over the model axis, rank 0 writes it, and the ranks meet
    after the write, so the file does not depend on the layout."""
    mesh = mesh or Mesh()
    path = _step_path(directory, step)
    obj = dict(
        step=int(step),
        student=gather_state_dict(state.student, mesh),
        teacher=gather_state_dict(state.teacher, mesh),
        optimizer=_optimizer_state_dict(state, mesh),
        gmm=dict(ptr=int(state.gmm.ptr),
                 **{k: getattr(state.gmm, k) for k in GMMState.TENSORS}),
    )
    if mesh.rank == 0:
        _atomic_save(obj, path)
        for old in _steps(directory)[:-max(int(keep), 1)]:
            os.remove(_step_path(directory, old))
    barrier(mesh)
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_state(path: str, state, step: Optional[int] = None):
    """Load a checkpoint into ``state`` (in place) and return it. ``path`` is
    a checkpoint file, or a directory whose ``step`` (default: the newest)
    is loaded. Tensors land on the devices of ``state``'s own. ``state`` is
    a full one: a multi-process run loads on every rank, then shards
    (``train/state.py::bind_state_``)."""
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


def save_best(directory: str, model: torch.nn.Module, comment: str, meta: Dict,
              mesh: Optional[Mesh] = None) -> None:
    """Best-weights save (reference save_best, torch_helper.py:101-117):
    ``{directory}/best_{comment}/`` holds the winning weights and ``meta``.
    Under a ``mesh`` every rank calls it and rank 0 writes the full weights."""
    mesh = mesh or Mesh()
    sd = gather_state_dict(model, mesh)
    if mesh.rank == 0:
        path = os.path.join(directory, f"best_{comment}")
        _atomic_save(sd, os.path.join(path, "params.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    barrier(mesh)


def load_best(directory: str, comment: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``best_{comment}``'s weights into ``model`` and return it."""
    path = os.path.join(directory, f"best_{comment}", "params.pt")
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model
