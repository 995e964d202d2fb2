"""Milliseconds a profiled training step in which the card idles while the
host dispatches the teacher's forwards in the TTA
(``objectives/pseudo.py::multi_scale_camseg``, inside ``teacher_tta``): the
traced run's idle gaps under ``tta_forward``, over the steps profiled.

Read under the tracer, which slows the host, so it is an upper bound on the
untraced gap; the tracer and the reduction stay the same, so it is
comparable from commit to commit. A span that is not among the reduction's ten
largest gaps reads 0; a trace with no device events, or of a program that
opens none of these spans (no gap is named by one), reads nothing."""

SOURCE = "program_span"
LAYER = "train step"
NAMES = ("tta_forward",)
PORT = ("tta_forward", "tta_fuse")  # the TTA's spans


def read(r):
    gaps = dict(r.trace.get("idle_gaps", []))
    if "busy_s" not in r.trace or not any(k in gaps for k in PORT):
        return None
    return sum(gaps.get(k, 0.0) for k in NAMES) * 1e3 / r.trace["units"]
