"""The port's hand-written CUDA kernels, their wrappers and their build.

Every wrapper that launches work on the card counts its launches in its
module's ``LAUNCHES`` dict of plain integers, made by :func:`counter`,
which registers it here. :func:`launches` reads every counter and
:func:`reset_launches` zeroes them, so code that counts a run's launches
names no kernel module.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, List

_COUNTERS: List[Dict[str, int]] = []


def counter(*names: str) -> Dict[str, int]:
    """A zeroed launch counter with the keys ``names``, registered here."""
    _COUNTERS.append(dict.fromkeys(names, 0))
    return _COUNTERS[-1]


def launches() -> Dict[str, int]:
    """A snapshot of every counter, merged into one dict. Every module of
    this package and ``models/quant.py`` (the int8 teacher's library
    products) is imported first, so that every process's snapshot holds
    the same keys, whichever wrappers it has used."""
    for m in pkgutil.iter_modules(__path__):
        importlib.import_module(f"{__name__}.{m.name}")
    importlib.import_module("cosa_tpu_torch.models.quant")
    return {k: v for c in _COUNTERS for k, v in c.items()}


def reset_launches() -> None:
    """Zero every registered counter."""
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
