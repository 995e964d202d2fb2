"""The port's trace spans: ``torch.profiler`` annotations that cost next to
nothing when no profiler is recording.

``span(name)`` is ``record_function(name)`` while a profiler is on, and a
shared do-nothing context otherwise: an ungated ``record_function`` enters
and leaves the profiler's dispatcher even with no profiler, and costs about
ten times a gated one (``PERF.md`` gives both on the H100's host). A span
opened while a scheduled profiler is active is recorded once per active
step, as a ``user_annotation`` in its chrome trace, on the clock that the
trace's CUDA events share.

Every span of the port, where it is opened, and what reads it (the
benchmark's ``benchmark/frozen/trace.py::reduce_trace`` names each idle gap
of the card by the innermost span open at its middle: the traced run's
``breakdown.idle_gaps``):

  train/step.py (one each a step; ``gmm`` with GMM on)
    teacher_tta       the teacher's TTA: ``teacher_tta_device_ms.train``
                      (its device ms), the ``breakdown``
    gmm, pseudo_labels, student_forward, losses, energy, backward,
    optimizer, ema    the ``breakdown``
  objectives/pseudo.py::multi_scale_camseg (the train step's TTA and
  validation's)
    tta_forward       each scale's forward: ``tta_forward_idle_ms.train``,
                      ``tta_idle_ms.eval``
    tta_fuse          each scale's input (resize, flip, concatenation), the
                      keeping of its maps, and the fuse of every scale after
                      the last (kernels/tta_fuse.py): ``tta_fuse_idle_ms.train``,
                      ``tta_idle_ms.eval``
  models/zoo/swin.py::WindowAttention (one a Swin block: 24 a Swin-B forward)
    window_attn       the attention core, from the scores through the
                      bias, the mask and the softmax to the product with v
                      (not qkv or proj; K6's forward on the card,
                      kernels/window_attn.py): ``window_attn_device_ms.train``,
                      ``window_attn_fwd_roofline.train``
  eval/engine.py (one each a batch; ``eval_dump`` with files to write)
    eval_load         the batch's dataset reads: ``load_idle_ms.eval``
    eval_prep         copies to the card, normalize, the crop resize, the
                      labels and the ground-truth canvas: ``canvas_idle_ms.eval``
    eval_canvas       each map resized onto its image's canvas:
                      ``canvas_idle_ms.eval``
    eval_score        confusion matrices, threshold filters, the fetch of
                      the image-level probabilities: ``score_idle_ms.eval``
    eval_ap           the per-image APs on the host: ``score_idle_ms.eval``
    eval_dump         visuals and raw CAMs written: the loop's ``profile_dir``
                      trace of a run with ``turnon_rawcam``
  train/loop.py (one each a step)
    loader_wait       ``next(loader)``, whose host time the loop also logs
                      as ``data_wait_ms``
    to_device         the batch's copy to the card

Outside the benchmark every span is read in the trace that the loop writes
with ``profile_dir`` (its validations included).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler is
    recording, else a shared ``nullcontext``."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF
