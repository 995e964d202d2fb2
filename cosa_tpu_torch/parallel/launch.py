"""Start a process group on this machine and run a function on every rank.

:func:`spawn` is a small ``torchrun`` for a caller that holds the results:
``world`` fresh processes (the ``spawn`` start method) join one group
through a ``FileStore`` in a temporary directory, so no port is chosen
and concurrent callers cannot collide. Each runs ``fn(rank, *args)`` with
torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set and one CPU
thread, and :func:`spawn` returns what each returned, in rank order. A
rank that raises stops the others, and :func:`spawn` raises with its
traceback.

The worker functions below live in the package, so a child imports torch
and the port only: :func:`train_worker` runs ``train.loop.train``,
:func:`steps_worker` runs the step from a given full state on given
global batches, :func:`allreduce_worker` times the gradient all-reduce.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cosa_tpu_torch.kernels import launches

TIMEOUT_S = 900  # a whole spawn; a collective waits as long


def _child(rank: int, world: int, backend: str, tmp: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args: Any, backend: str = "gloo") -> List[Any]:
    """``fn(rank, *args)`` on ranks 0..world-1 of a new ``backend`` group;
    their return values in rank order. ``fn`` and ``args`` are pickled:
    ``fn`` must be importable by name."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        # through a file, not the process arguments: those would hand each
        # child the caller's tensors in shared memory, which a rank's
        # in-place update would then change for the caller and its peers
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        procs = [ctx.Process(target=_child, args=(r, world, backend, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad or time.time() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                path = os.path.join(tmp, f"err{r}.txt")
                why = open(path).read() if os.path.exists(path) else f"exit code {p.exitcode}"
                errors.append(f"rank {r}: {why}")
        if errors:
            raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


def allreduce_worker(rank: int, numel: int, device, reps: int = 5) -> Dict[str, float]:
    """Host-clock ms of one all-reduce of ``numel`` f32 values on
    ``device`` over the default group (the step's gradient all-reduce),
    the median of ``reps`` after one warm-up; under gloo a CUDA tensor is
    staged through the host."""
    import statistics

    x = torch.ones(numel, dtype=torch.float32, device=device)
    times = []
    for _ in range(reps + 1):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(ms=statistics.median(times[1:]), numel=numel, device=str(device),
                backend=dist.get_backend())


def train_worker(rank: int, cfgs: Sequence, device=None) -> List[Dict]:
    """``train.loop.train`` of each config in turn (a run, then its resumed
    continuation, say) on this rank. Per run: the logged records, the last
    validation's results, the best mIoUs and the kernels' launches."""
    from cosa_tpu_torch.train.loop import train

    out = []
    for cfg in cfgs:
        before = launches()
        res = train(cfg, device=device)
        out.append(dict(records=res["records"], results=res["results"],
                        best_seg=res["best_seg"], best_cam=res["best_cam"],
                        launches={k: v - before[k] for k, v in launches().items()}))
    return out


def steps_worker(rank: int, cfg, device, init: Dict,
                 batches: Sequence[Dict[str, np.ndarray]]) -> Dict:
    """The step of ``cfg`` on this rank of its ``dp`` x ``tp`` layout, from
    the full state ``init`` (``student`` and ``teacher`` state dicts, and
    optionally the GMM ``queue``/``queue_aux``), once per global batch of
    ``batches`` (this data rank takes its rows). Returns each step's global
    metrics, the kernels' launches and, from the full state after the
    steps, the student, the teacher, the optimizer's first moments
    (``exp_avg`` by parameter name) and the GMM state, on the CPU. With no
    process group it runs as the one process."""
    from cosa_tpu_torch.parallel.mesh import gather_state_dict, make_mesh
    from cosa_tpu_torch.parallel.tensor import all_mean
    from cosa_tpu_torch.train.checkpoint import optimizer_moments
    from cosa_tpu_torch.train.state import GMMState, bind_state_, create_train_state
    from cosa_tpu_torch.train.step import build_train_step
    from cosa_tpu_torch.utils.device import resolve_device

    mesh = make_mesh(cfg.dp, cfg.tp)
    dev = resolve_device(device)
    state = create_train_state(cfg, dev, cfg.batch_size * mesh.dp)
    state.student.load_state_dict(init["student"])
    state.teacher.load_state_dict(init["teacher"])
    for k in ("queue", "queue_aux"):
        if k in init:
            setattr(state.gmm, k, init[k].to(dev))
    bind_state_(state, mesh)
    step = build_train_step(cfg, mesh)
    rows = mesh.rows(cfg.batch_size)
    metrics = []
    before = launches()
    for batch in batches:
        m = step(state, {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()})
        metrics.append({k: float(all_mean(v, mesh.dp_group)) for k, v in m.items()
                        if torch.is_tensor(v) and v.ndim == 0} | {"lr": m["lr"]})
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    return dict(metrics=metrics, step=state.step,
                launches={k: v - before[k] for k, v in launches().items()},
                student=cpu(gather_state_dict(state.student, mesh)),
                teacher=cpu(gather_state_dict(state.teacher, mesh)),
                exp_avg={k: v["exp_avg"].cpu()
                         for k, v in optimizer_moments(state, mesh).items()},
                gmm=dict(ptr=state.gmm.ptr, **{k: getattr(state.gmm, k).cpu()
                                               for k in GMMState.TENSORS}))
