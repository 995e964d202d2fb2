"""The benchmark's general part: finding a cell's files by name, the run's
environment, the measured window, the profiled window, and the result line.

What belongs to one configuration, traffic mix or per-layer metric lives in
a file of its own, found by the name ``BENCHMARK.json`` gives:

  benchmark/configs/<config>.json     sizes, the program's settings, assumptions
  benchmark/traffic/<traffic>.json    a traffic mix: its generator and parameters
  benchmark/traffic/<generator>.py    a traffic generator (``build(ctx)``)
  benchmark/metrics/<metric>.py       a metric's reader (``read(r)``), end-to-end or per-layer
  benchmark/workloads/<cell>.json     the limits of a cell's correctness check
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cosa_tpu")  # top-level module names


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own (names such as
    ``mfu.train`` hold dots, so files are loaded by path)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: Dict, cell: str, spec: Dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list;
    without one, every cell (an end-to-end metric) or every cell that
    reports the metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = [m for m in spec["end_to_end"] if m["name"] == metric.get("moves")]
    return bool(moved) and applies(moved[0], cell, spec)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration's file
    traffic: Dict  # the traffic mix's file
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]
    root: Path

    @property
    def generator(self):
        name = self.traffic["generator"]
        return load_module(self.root / "benchmark" / "traffic" / f"{name}.py")


def find_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=int(entry["chips"]), config=load_json(root / conf["file"]),
        traffic=load_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name, spec)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name, spec)],
        limits=load_json(root / "benchmark" / "workloads" / f"{name}.json")["limits"],
        root=root)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment(root: Path) -> None:
    """Every compile cache of the run at a fixed path inside the checkout
    (the program keeps its nvcc builds in build/cosa_tpu_torch/ and its g++
    library in cosa_tpu_torch/native/ by itself), and no library allowed to
    load JAX."""
    cache = root / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """The epoch time at which this process started (Linux's /proc), so that
    set-up counts the interpreter and the imports too."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


class SetupMarks:
    """Seconds of each named phase of set-up, from the process's start."""

    def __init__(self, start: float, dev: torch.device):
        self.last, self.dev = start, dev
        self.phases: List = []

    def mark(self, name: str) -> None:
        sync(self.dev)
        now = time.time()
        self.phases.append([name, now - self.last])
        self.last = now


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device, chips: int) -> Dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i",
             str(dev.index or 0)], capture_output=True, text=True, check=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"not read ({type(e).__name__})"
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)),
                power_limit=limit)


class Marks:
    """End-of-call marks on the device's timeline (CUDA events, which add no
    host synchronisation), or the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_s(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


def measure(call: Callable[[], int], seconds: float, dev: torch.device) -> Dict:
    """Calls ``call`` (which returns the images it did) until ``seconds``
    have passed on the host clock, then waits for the device. Returns the
    calls, images and seconds of the window, and the device-timeline time
    of each call (from the end of the one before)."""
    marks = Marks(dev)
    sync(dev)
    t0 = time.perf_counter()
    marks.mark()
    calls = images = 0
    while True:
        images += call()
        marks.mark()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    return dict(calls=calls, images=images, seconds=time.perf_counter() - t0,
                call_s=marks.intervals_s())


def profile(call: Callable[[], int], units: int, dev: torch.device, spans) -> Dict:
    """``units`` calls under torch.profiler after one unprofiled warm-up of
    the profiler, reduced by benchmark/frozen/trace.py (totals over the
    profiled calls)."""
    from torch.profiler import ProfilerActivity, schedule

    from benchmark.frozen.trace import reduce_trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(
                activities=acts, schedule=schedule(wait=0, warmup=1, active=units),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(units + 1):
                call()
                if i in (0, units):
                    sync(dev)
                prof.step()
        red = reduce_trace(load_json(Path(path)), spans)
    finally:
        os.remove(path)
    red["units"] = units
    return red


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads: the cell's configuration and traffic
    files, the untraced window's counts, the profiled window's reduction
    (totals over ``trace['units']`` calls; empty in an untraced run), the
    set-up's seconds and the device's peak of allocated bytes."""
    config: Dict
    traffic: Dict
    window: Dict
    trace: Dict
    setup_s: float = 0.0
    peak_bytes: int = 0


def read_metrics(cell: Cell, entries: List[Dict], reading: Reading) -> Dict:
    """Each of ``entries``' metrics, read by its own file in
    benchmark/metrics/; a reader that finds nothing returns None and its
    metric is left out."""
    out = {}
    for m in entries:
        mod = load_module(cell.root / "benchmark" / "metrics" / f"{m['name']}.py")
        v = mod.read(reading)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is finite and within its limit."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
