"""The ('data', 'model') process layout and the tensor-parallel rules: the
JAX package's parallel/mesh.py for ``torch.distributed``.

The JAX package runs one jit over a device mesh; XLA shards the batch over
'data' and, with ``tp > 1``, the ViT/Swin blocks' projections over 'model'.
Here every rank is one process, and :class:`Mesh` holds the two process
groups. Ranks are laid out row-major, ``rank = dp_rank * tp + tp_rank``
(``create_device_mesh((dp, tp))``'s order), so one model group holds
consecutive ranks.

The sharding rules are the JAX package's, on its parameter paths. Each of
the port's parameter names is mapped onto the JAX path it is converted
from (the inverse of ``models/convert.py::state_dict_from_jax``'s table)
and matched there. Column-parallel layers (qkv, fc1) keep their output
rows, row-parallel layers (proj, fc2) their input columns; everything else
is replicated. One difference: the JAX rule cuts qkv's 3·d output columns
into contiguous blocks, which XLA reshards around the attention; here q, k
and v are each cut by heads, the same function with no reshuffle, so a
model group needs ``num_heads % tp == 0`` (and the MLP width divisible by
``tp``) and raises otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from cosa_tpu_torch.parallel.tensor import coalesced_

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the (dp, tp) layout and its groups; a group
    is None where its axis has size 1 (no collective is issued there)."""

    world: int = 1
    rank: int = 0
    dp: int = 1
    tp: int = 1
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def rows(self, per_rank: int) -> slice:
        """This rank's rows of a global batch of ``per_rank * dp`` rows."""
        return slice(self.dp_rank * per_rank, (self.dp_rank + 1) * per_rank)


def make_mesh(dp: int = -1, tp: int = 1) -> Mesh:
    """The mesh of the initialized default process group (world size 1,
    the trivial mesh, when there is none). ``dp == -1`` takes every rank
    the model axis leaves."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if dp == -1:
        if world % tp:
            raise ValueError(f"world size {world} does not split into tp={tp}")
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp({dp}) * tp({tp}) != world size ({world})")
    if world == 1:
        return Mesh()
    rank = dist.get_rank()
    # every rank creates every group, in the same order
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)] \
        if dp > 1 else None
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)] \
        if tp > 1 else None
    return Mesh(world=world, rank=rank, dp=dp, tp=tp,
                dp_group=dp_groups[rank % tp] if dp_groups else None,
                tp_group=tp_groups[rank // tp] if tp_groups else None)


def init_distributed(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``):
    NCCL for a CUDA device (the default) on card ``LOCAL_RANK``, gloo for
    ``device="cpu"``. A group already initialized (the tests' and the
    smoke run's gloo groups) is left alone, and without torchrun's
    environment none is started. Returns whether it started one."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return True


@contextlib.contextmanager
def distributed(device=None):
    """:func:`init_distributed` for the duration of the block; a group it
    started is destroyed at the end (the command-line entry points)."""
    started = init_distributed(device)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


# (path regex, spec) -- first match wins; the JAX package's _RULES
# (cosa_tpu/parallel/mesh.py), specs on the JAX (in, out) kernel layout
_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"attn.*qkv.*kernel", (None, "model")),
    (r"attn.*qkv.*bias", ("model",)),
    (r"attn.*proj.*kernel", ("model", None)),
    (r"mlp.*fc1.*kernel", (None, "model")),
    (r"mlp.*fc1.*bias", ("model",)),
    (r"mlp.*fc2.*kernel", ("model", None)),
    # swin blocks keep fc1/fc2 directly on the block (models/zoo/swin.py)
    (r"stage\d+_block\d+.*fc1.*kernel", (None, "model")),
    (r"stage\d+_block\d+.*fc1.*bias", ("model",)),
    (r"stage\d+_block\d+.*fc2.*kernel", ("model", None)),
)


def param_spec(path_str: str, ndim: int) -> Spec:
    """The JAX package's ``param_spec``: the first rule matching the JAX
    parameter path, as a tuple (``()``: replicated)."""
    for pat, spec in _RULES:
        if re.search(pat, path_str) and len(spec) <= ndim:
            return spec
    return ()


def jax_path(name: str) -> str:
    """The JAX tree path of the port's parameter ``name``, as the rules
    read it: list indices join their list (``blocks.3`` -> ``blocks_3``),
    the Maskformer decoder's blocks hold qkv/proj/fc1/fc2 with no attn/mlp
    scope, the ViT patch embedding has no ``proj`` scope, and ``weight`` is
    a ``kernel`` (a norm's is a ``scale`` in JAX, which no rule names)."""
    parts = re.sub(r"\.(\d+)(?=\.)", r"_\1", name).split(".")
    if parts[0] == "decoder" and parts[1].startswith("blocks_"):
        parts = [p for p in parts if p not in ("attn", "mlp")]
    if parts[:3] == ["encoder", "patch_embed", "proj"]:
        parts = parts[:2] + parts[3:]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def port_split(name: str, ndim: int) -> Optional[int]:
    """The dimension of the port's tensor ``name`` (an ``nn.Linear``
    ``(out, in)`` weight or a bias) that the rules split over 'model', or
    None where it is replicated."""
    spec = param_spec(jax_path(name), ndim)
    if "model" not in spec:
        return None
    return ndim - 1 - spec.index("model")  # the JAX kernel is (in, out)


def _parts(name: str) -> int:
    """Blocks cut by heads one by one: q, k and v of a qkv projection."""
    return 3 if name.split(".")[-2] == "qkv" else 1


def split_tensor(t: torch.Tensor, dim: int, parts: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s share of ``t`` along ``dim``: of each of its
    ``parts`` blocks, the ``rank``-th of ``tp`` equal pieces."""
    shape = t.shape
    t = t.reshape(*shape[:dim], parts, tp, shape[dim] // (parts * tp), *shape[dim + 1:])
    return t.select(dim + 1, rank).reshape(*shape[:dim], -1, *shape[dim + 1:]).clone()


def join_tensor(t: torch.Tensor, dim: int, parts: int, group) -> torch.Tensor:
    """The inverse of :func:`split_tensor` over ``group``'s ranks."""
    tp = dist.get_world_size(group)
    pieces = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(pieces, t.contiguous(), group=group)
    shape = t.shape
    blocks = [p.reshape(*shape[:dim], parts, shape[dim] // parts, *shape[dim + 1:])
              for p in pieces]
    return torch.stack(blocks, dim + 1).reshape(*shape[:dim], -1, *shape[dim + 1:])


def sharded_params(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{name: (dim, parts)} of every parameter of ``model`` the rules
    split over 'model'."""
    out = {}
    for name, p in model.named_parameters():
        dim = port_split(name, p.ndim)
        if dim is not None:
            out[name] = (dim, _parts(name))
    return out


def shard_module_(model: nn.Module, mesh: Mesh) -> Dict[str, Tuple[int, int]]:
    """Bind ``model`` to ``mesh``, in place. With ``tp > 1``: each weight
    the rules match becomes this rank's slice, and each module that runs a
    split region (it has ``tp_group`` and ``TP_LAYERS``) gets the model
    group. With ``dp > 1``: stochastic depth draws the global batch's masks
    and keeps this rank's rows (modules with ``rows``). Returns the
    parameters split, as :func:`sharded_params` gives them."""
    for mod in model.modules():
        if hasattr(mod, "rows"):
            mod.rows = (mesh.dp_rank, mesh.dp)
    if mesh.tp == 1:
        return {}
    split = sharded_params(model)
    covered = set()
    regions = []
    for mname, mod in model.named_modules():
        if not hasattr(mod, "TP_LAYERS"):
            continue
        own = {f"{mname}.{layer}.{w}" for layer in mod.TP_LAYERS
               for w, _ in getattr(mod, layer).named_parameters()}
        hit = own & split.keys()
        if not hit:  # replicated by the rules (the Maskformer decoder's blocks)
            continue
        if mod.tp_units % mesh.tp:
            raise ValueError(f"{mname}: {mod.tp_units} {mod.TP_UNIT} do not split over "
                             f"tp={mesh.tp}")
        covered |= hit
        regions.append(mod)
    if split.keys() - covered:
        raise ValueError(f"the rules split {sorted(split.keys() - covered)} outside a "
                         "tensor-parallel module")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, (dim, parts) in split.items():
            p = params[name]
            p.data = split_tensor(p.data, dim, parts, mesh.tp, mesh.tp_rank)
    for mod in regions:
        mod.tp_group = mesh.tp_group
    return split


def gather_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``model``'s full (unsharded) state dict; collective over the model
    group when ``tp > 1``, so every rank calls it."""
    sd = model.state_dict()
    if mesh.tp == 1:
        return sd
    for name, (dim, parts) in sharded_params(model).items():
        sd[name] = join_tensor(sd[name], dim, parts, mesh.tp_group)
    return sd


def broadcast_(tensors: Iterable[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in place."""
    if mesh.world > 1:
        coalesced_(tensors, lambda flat: dist.broadcast(flat, src=src))
