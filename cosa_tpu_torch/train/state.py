"""Training state: student, EMA teacher, optimizer, step counter and the
GMM threshold state.

The student and the teacher are initialised from separate seeded
generators (the reference builds the two networks separately, so their
random heads start different). :class:`GMMState` is the JAX package's
(train/state.py:23-64): the two ring buffers of CAM-max rows the GMM
thresholds are fitted on, the write pointer, and the EMAs of the four
thresholds (the reference's host-side queues and EMA trackers,
main.py:94-103). Under data parallelism the queues hold the global batch's
rows, as the JAX package's do (train/loop.py:71-73).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cosa_tpu_torch.models.network import CoSANetwork, build_model
from cosa_tpu_torch.parallel.mesh import Mesh, broadcast_, shard_module_, split_tensor
from cosa_tpu_torch.train.optimizer import GroupOptimizer


@dataclasses.dataclass
class GMMState:
    queue: torch.Tensor  # (Q, dim) ring buffer of downscaled CAM-max rows
    queue_aux: torch.Tensor
    ptr: int  # the next row to write; it does not depend on the data
    ema_low: torch.Tensor  # 0-d f32 on the device (EMAtracker, torch_helper.py:90-99)
    ema_high: torch.Tensor
    ema_low_aux: torch.Tensor
    ema_high_aux: torch.Tensor

    TENSORS = ("queue", "queue_aux", "ema_low", "ema_high", "ema_low_aux", "ema_high_aux")


@dataclasses.dataclass
class TrainState:
    student: CoSANetwork
    teacher: CoSANetwork
    optimizer: GroupOptimizer
    gmm: GMMState
    step: int = 0


def use_gmm_aux(cfg) -> bool:
    """The aux head's GMM gate: ``usegmmaux``, or ``usegmm`` when it is None
    (the reference uses one flag for both heads, main.py:138/174)."""
    return cfg.usegmm if cfg.usegmmaux is None else bool(cfg.usegmmaux)


def init_gmm_state(cfg, global_batch: int, device=None) -> GMMState:
    """Queues of global_batch * queue_update_ratio rows of (crop /
    gmmscale)^2 values, seeded with uniform noise (seg_helper.py:949) from a
    generator on ``cfg.seed + 777``; 1 x 1 zeros when GMM is off. The EMAs
    start at the fixed thresholds."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    if cfg.usegmm or use_gmm_aux(cfg):
        shape = (global_batch * cfg.queue_update_ratio, (cfg.crop_size // cfg.gmmscale) ** 2)
        g = torch.Generator().manual_seed(cfg.seed + 777)
        queue, queue_aux = torch.rand(shape, generator=g), torch.rand(shape, generator=g)
    else:
        queue = queue_aux = torch.zeros((1, 1))

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    return GMMState(queue=queue.to(dev), queue_aux=queue_aux.to(dev), ptr=0,
                    ema_low=scalar(cfg.low_thre), ema_high=scalar(cfg.high_thre),
                    ema_low_aux=scalar(cfg.low_thre_aux),
                    ema_high_aux=scalar(cfg.high_thre_aux))


def create_train_state(cfg, device=None, global_batch: Optional[int] = None) -> TrainState:
    """Student seeded with ``cfg.seed``, teacher with ``cfg.seed + 1``; the
    teacher never trains (eval mode, no gradients). The GMM queues are
    sized for ``global_batch`` (default ``cfg.batch_size``, one process)."""
    student = build_model(cfg, device, seed=cfg.seed).train()
    teacher = build_model(cfg, device, seed=cfg.seed + 1).eval()
    teacher.requires_grad_(False)
    return TrainState(
        student=student,
        teacher=teacher,
        optimizer=GroupOptimizer(cfg, student),
        gmm=init_gmm_state(cfg, global_batch or cfg.batch_size,
                           next(student.parameters()).device),
    )


def bind_state_(state: TrainState, mesh: Mesh) -> None:
    """Lay a full (unsharded) state onto ``mesh``, in place: rank 0's
    weights, optimizer moments and GMM state broadcast to every rank (each
    builds the same seeded init, but a loaded file must not drift), then
    the student, the teacher and the moments sharded over the model axis."""
    if mesh.world == 1:
        return
    opt = state.optimizer.opt
    broadcast_([*state.student.state_dict().values(), *state.teacher.state_dict().values(),
                *(v for st in opt.state.values() for v in st.values() if torch.is_tensor(v) and v.ndim),
                *(getattr(state.gmm, k) for k in GMMState.TENSORS)], mesh)
    split = shard_module_(state.student, mesh)
    shard_module_(state.teacher, mesh)
    params = dict(state.student.named_parameters())
    for name, (dim, parts) in split.items():
        st = opt.state.get(params[name], {})
        for k, v in st.items():
            if torch.is_tensor(v) and v.ndim:
                st[k] = split_tensor(v, dim, parts, mesh.tp, mesh.tp_rank)


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, momentum: float) -> None:
    """teacher = m * teacher + (1 - m) * student over every parameter,
    pos_embed included, in f32 (in place)."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, s, alpha=1.0 - momentum)
