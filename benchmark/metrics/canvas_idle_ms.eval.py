"""Milliseconds a profiled validation batch in which the card idles while
the host copies the batch to the card and lays its maps on their canvases
(``eval/engine.py::_eval_batch``): the traced run's idle gaps under
``eval_prep`` and ``eval_canvas``, over the batches profiled
(``trace_calls`` x ``trace_images`` / ``eval_batch``).

Read under the tracer, which slows the host, so it is an upper bound on the
untraced gap; the tracer and the reduction stay the same, so it is
comparable from commit to commit. A span that is not among the reduction's ten
largest gaps reads 0; a trace with no device events, or of a program that
opens none of these spans (no gap is named by one), reads nothing."""

SOURCE = "program_span"
LAYER = "eval engine"
NAMES = ("eval_prep", "eval_canvas")
# every span of the engine and the TTA
PORT = ("eval_load", "eval_prep", "eval_canvas", "eval_score", "eval_ap", "eval_dump",
        "tta_forward", "tta_fuse")


def read(r):
    gaps = dict(r.trace.get("idle_gaps", []))
    if "busy_s" not in r.trace or not any(k in gaps for k in PORT):
        return None
    batches = r.trace["units"] * r.traffic["trace_images"] / r.config["config"]["eval_batch"]
    return sum(gaps.get(k, 0.0) for k in NAMES) * 1e3 / batches
