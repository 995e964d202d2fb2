"""PyTorch port's multi-process paths (cosa_tpu_torch/parallel/) against the
JAX package on the CPU.

The port's ranks are processes joined over gloo (``parallel/launch.py::
spawn``); the JAX package's are the devices of one jit over
``cosa_tpu.parallel.make_mesh`` on the 8 virtual CPU devices of
tests/conftest.py.

  * the sharding rules: the parameters the port splits over 'model', and
    their axes, are what ``cosa_tpu.parallel.param_spec`` gives on the JAX
    tree's paths, for every co-training architecture;
  * the loader: data rank r of 2 yields the JAX loader's batches at
    process_index r of 2;
  * stochastic depth under data parallelism: rank r's masks are its rows
    of the one-process draw at the global batch;
  * whole steps: two steps of tiny ViT from one JAX init on two global
    batches of 4, in the port at dp=2 (2 ranks) and dp=2 x tp=2 (4 ranks)
    with GMM thresholds, against the JAX step on the dp=2 mesh, and at
    tp=2 (2 ranks) with the int8 teacher, against the JAX step on the
    tp=2 mesh; two Swin ``swinend2end`` steps at tp=2 (its
    relative-position bias read per local head) against the same. The
    two data ranks' pseudo masks have unequal fg/bg pixel counts (rank 1's
    images hold small boxes), which only the global normalizer of
    seg_loss gets right: the companion test shows that the mean of the
    per-rank losses misses the JAX value by more than the tolerance.
    Losses are held to tests/test_torch_step.py's TOLS, parameters to its
    1e-5 of their largest value (floor 1e-3), the GMM queue, pointer and
    thresholds to 1e-5. The learning rate at the second step is 2e-10: a
    zero-gradient parameter (the key bias) moves by lr in the direction of
    its rounding noise, which the 1e-5 bound does not cover at a real lr.
    At that lr the parameters see no gradient, so the gradients are held
    through the optimizer's first moments, which do not depend on the lr:
    the gathered ``exp_avg``, equal on every rank, against the JAX state's
    ``mu`` within ``MU_TOL`` of each tensor's largest value. That is where the
    backward's collectives show: the data group's gradient average, the
    model group's all-reduce in copy-to-tp's backward (Swin's
    ``rel_pos_bias`` among them) and seg_loss's dp scale.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.data.loader import TrainLoader as JaxTrainLoader
from cosa_tpu.data.loader import build_train_dataset as jax_train_dataset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.models.zoo import swin as jax_swin
from cosa_tpu.objectives.losses import seg_loss as jax_seg_loss
from cosa_tpu.parallel import batch_sharding, state_sharding
from cosa_tpu.parallel import make_mesh as jax_make_mesh
from cosa_tpu.parallel import param_spec as jax_param_spec
from cosa_tpu.parallel.mesh import _path_to_str
from cosa_tpu.train import build_optimizer as jax_build_optimizer
from cosa_tpu.train import build_train_step as jax_build_train_step
from cosa_tpu.train.state import TrainState as JaxTrainState
from cosa_tpu.train.state import init_gmm_state as jax_init_gmm
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.data.loader import build_train_loader
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.models.zoo.swin import SWIN_CONFIGS, DropPath
from cosa_tpu_torch.objectives.losses import seg_loss
from cosa_tpu_torch.parallel.launch import spawn, steps_worker
from cosa_tpu_torch.parallel.mesh import Mesh, shard_module_, sharded_params
from tests.test_torch_step import TOLS, _assert_params, _kw

CROP = 64
GLOBAL = 4
# the optimizer's first moments against JAX's, relative to the tensor's
# largest: the gradients inherit the losses' TOLS-sized differences (read
# up to 3.7e-3, on the decoder's convolutions); a rank that misses the
# data group's average, or a model rank's rel_pos_bias columns, is off by
# its whole size
MU_TOL = 1e-2
# the step's configurations (the exact dense energy: the RFF surrogate's
# features are drawn apart in the two packages, and at a global batch of 4
# their noise moves overall_loss past its TOLS); lr 1e-9 puts the second
# step's lr at 2e-10
CONFIGS = {
    # GMM thresholds on both heads, queues of 4 x 4 rows
    "vit-gmm": dict(usegmm=True, queue_update_ratio=4, lr=1e-9),
    # the int8 teacher at every TTA scale: its row-parallel proj and fc2
    # take their scales' maxima over both model ranks
    "vit-int8": dict(teacher_int8=True, teacher_int8_min_size=0, lr=1e-9),
    # a Swin whose every stage splits its heads over 2 model ranks
    # (swin_tiny_test has one head in stage 0)
    "swin": dict(model="swinend2end", backbone="swin_tp_test", lr=1e-9),
}


def _batches(n_steps=2):
    """Global batches of 4: rows 0-1 (data rank 0) with large boxes, rows
    2-3 (data rank 1) with small ones, so the ranks' masks differ in
    their fg/bg pixel counts."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n_steps):
        cls = np.zeros((GLOBAL, 5), np.float32)
        for i in range(GLOBAL):
            cls[i, rng.choice(5, 2, replace=False)] = 1
        out.append(dict(
            wimg=rng.integers(0, 255, (GLOBAL, CROP, CROP, 3)).astype(np.uint8),
            simg=rng.integers(0, 255, (GLOBAL, CROP, CROP, 3)).astype(np.uint8),
            cls_label=cls,
            img_box=np.array([[0, 64, 0, 64], [2, 62, 0, 60], [8, 30, 10, 40],
                              [30, 60, 4, 28]], np.int32)))
    return out


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, dp: int, tp: int):
    """Two JAX steps of ``CONFIGS[name]`` on the (dp, tp) mesh of the first
    dp * tp CPU devices: the init (as port state dicts) with the injected
    GMM queues, the metrics of each step and the state after them."""
    cfg = jax_preset("synthetic", **_kw("exact", **CONFIGS[name], batch_size=GLOBAL // dp))
    model = jax_build_model(cfg)
    dummy = jnp.zeros((1, CROP, CROP, 3))
    init = jax.jit(model.init)
    student = init(jax.random.PRNGKey(0), dummy)["params"]
    teacher = init(jax.random.PRNGKey(1), dummy)["params"]
    tx = jax_build_optimizer(cfg, student)
    gmm = jax_init_gmm(cfg, GLOBAL)
    queues = np.random.default_rng(7).random((2,) + gmm.queue.shape).astype(np.float32)
    if cfg.usegmm:
        gmm = gmm.replace(queue=jnp.asarray(queues[0]), queue_aux=jnp.asarray(queues[1]))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), student=student, teacher=teacher,
                          opt_state=tx.init(student), gmm=gmm)
    mesh = jax_make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    state = jax.device_put(state, state_sharding(state, mesh))
    step = jax.jit(jax_build_train_step(cfg, model, tx))
    metrics = []
    for b in _batches():
        state, m = step(state, jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                              batch_sharding(mesh)))
        metrics.append({k: float(m[k]) for k in (*TOLS, "lr", "thre_low", "thre_high")})
    init_t = dict(student=state_dict_from_jax(_np_tree(student)),
                  teacher=state_dict_from_jax(_np_tree(teacher)))
    if cfg.usegmm:
        init_t.update(queue=torch.from_numpy(queues[0].copy()),
                      queue_aux=torch.from_numpy(queues[1].copy()))
    return init_t, metrics, jax.device_get(state)


def _jax_first_moments(opt_state, params):
    """The JAX state's AdamW first moments (``mu``) as a port state dict:
    each optimizer label's masked tree, its masked leaves zero, summed over
    the labels (every parameter is in one; the frozen label holds none)."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    total = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    for inner in opt_state.inner_states.values():
        adam = inner.inner_state
        if isinstance(adam, tuple) and adam and hasattr(adam[0], "mu"):
            total = jax.tree.map(lambda t, m: t if masked(m) else t + np.asarray(m),
                                 total, adam[0].mu, is_leaf=masked)
    return state_dict_from_jax(total)


def _check_steps(name: str, dp: int, tp: int, jax_mesh=None):
    init, ref_metrics, ref = _jax_run(name, *(jax_mesh or (dp, tp)))
    cfg = torch_preset("synthetic", **_kw("exact", **CONFIGS[name], batch_size=GLOBAL // dp,
                                          dp=dp, tp=tp))
    outs = spawn(steps_worker, dp * tp, cfg, "cpu", init, _batches())
    ours = outs[0]
    for r, o in enumerate(outs[1:], 1):  # every rank ends with the same full state
        for what in ("student", "exp_avg"):
            for k, v in ours[what].items():
                assert torch.equal(o[what][k], v), (r, what, k)
    for got, want in zip(ours["metrics"], ref_metrics):
        for k, tol in TOLS.items():
            assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1e-3), (k, got[k], want[k])
        assert np.float32(got["lr"]) == np.float32(want["lr"])
    assert ours["step"] == int(ref.step) == 2
    for name in ("student", "teacher"):
        module = build_model(cfg, "cpu")
        module.load_state_dict(ours[name])
        _assert_params(module, getattr(ref, name), name)
    # the gradients, through AdamW's first moments (0.09 g1 + 0.1 g2 after
    # two steps, whatever the lr): a parameter the port does not step
    # (pos_embed) has a zero moment in JAX
    for k, r in _jax_first_moments(ref.opt_state, ref.student).items():
        r = r.numpy()
        a = ours["exp_avg"][k].numpy() if k in ours["exp_avg"] else np.zeros_like(r)
        assert np.abs(a - r).max() <= MU_TOL * max(np.abs(r).max(), 1e-6), (k, a, r)
    if cfg.usegmm:  # the global batch's rows, written in data-rank order
        g = ours["gmm"]
        assert g["ptr"] == int(ref.gmm.ptr) == 2 * GLOBAL
        for k in ("queue", "queue_aux", "ema_low", "ema_high", "ema_low_aux", "ema_high_aux"):
            a, r = g[k].numpy(), np.asarray(getattr(ref.gmm, k))
            assert np.abs(a - r).max() <= 1e-5, (k, a, r)


# the 4-rank layout is held to the JAX step on the dp=2 mesh (the same
# function of the same global batch), which the dp2 case compiles already
@pytest.mark.parametrize("name,dp,tp,jax_mesh", [("vit-gmm", 2, 1, None),
                                                  ("vit-int8", 1, 2, None),
                                                  ("vit-gmm", 2, 2, (2, 1))],
                         ids=["dp2-gmm", "tp2-int8", "dp2xtp2-gmm"])
def test_vit_steps_match_jax_mesh(name, dp, tp, jax_mesh):
    _check_steps(name, dp, tp, jax_mesh)


def test_swin_steps_match_jax_mesh_tp2(monkeypatch):
    tp_test = SWIN_CONFIGS["swin_tp_test"]  # the port's own registry holds it
    monkeypatch.setitem(jax_swin.SWIN_CONFIGS, "swin_tp_test",
                        jax_swin.SwinConfig(**dataclasses.asdict(tp_test)))
    _check_steps("swin", 1, 2)


def test_mean_of_rank_seg_losses_misses_the_global_value():
    """The companion of the step tests: on masks whose fg/bg counts differ
    between the two halves of the batch, the mean of each half's seg_loss
    is off the global batch's by more than TOLS allows; seg_loss with no
    group is the global batch's (JAX's) on the whole batch."""
    rng = np.random.default_rng(3)
    labels = np.full((GLOBAL, 16, 16), 255, np.int64)
    labels[:2] = rng.choice([0, 0, 0, 1, 2], size=(2, 16, 16))  # mostly background
    labels[2:, 4:10, 4:10] = rng.choice([0, 3, 4, 5], size=(2, 6, 6))  # small, mostly fg
    # a confident half and an unsure one: their per-pixel losses differ
    logits = rng.standard_normal((GLOBAL, 16, 16, 6)).astype(np.float32)
    logits[:2] += 6.0 * np.eye(6, dtype=np.float32)[labels[:2]]
    ref = float(jax_seg_loss(jnp.asarray(logits), jnp.asarray(labels), fg_alpha=0.5))
    t = torch.from_numpy
    whole = float(seg_loss(t(logits), t(labels)))
    naive = np.mean([float(seg_loss(t(logits[s]), t(labels[s])))
                     for s in (slice(0, 2), slice(2, 4))])
    assert abs(whole - ref) <= 1e-6 * abs(ref)
    assert abs(naive - ref) > 10 * TOLS["seg_loss"] * abs(ref), (naive, ref)


def _jax_leaf_specs(cfg_kw):
    """{port parameter name: the dimension the JAX rules split} of the JAX
    tree of ``cfg_kw``, matched leaf by leaf through state_dict_from_jax
    (each leaf filled with its own index)."""
    cfg = jax_preset("synthetic", **cfg_kw)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, CROP, CROP, 3)))["params"]
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    tree = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.float32) for i, (_, s) in enumerate(flat)])
    index = {name: int(v.reshape(-1)[0]) for name, v in state_dict_from_jax(tree).items()}
    out = {}
    for name, i in index.items():
        path, s = flat[i]
        spec = tuple(jax_param_spec(_path_to_str(path), len(s.shape)))
        if "model" in spec:
            out[name] = len(s.shape) - 1 - spec.index("model")
    return out


@pytest.mark.parametrize("arch", [
    dict(backbone="vit_tiny_test"),
    dict(backbone="vit_tiny_test", decoder="Maskformer"),
    dict(backbone="deit_tiny_test_distilled"),
    dict(model="swinend2end", backbone="swin_tiny_test"),
], ids=["vit-largefov", "vit-maskformer", "distilled", "swinend2end"])
def test_sharded_parameters_follow_the_jax_rules(arch):
    kw = dict(num_classes=6, crop_size=CROP, **arch)
    want = _jax_leaf_specs(kw)
    got = sharded_params(build_model(torch_preset("synthetic", **kw), "cpu"))
    assert {k: d for k, (d, _) in got.items()} == want
    depth = 4 if arch.get("model") == "swinend2end" else 3
    assert len(want) == 6 * depth  # qkv (weight, bias), proj, fc1 (weight, bias), fc2
    assert not any(k.startswith("decoder") for k in want)  # the Maskformer's blocks
    assert all(parts == (3 if ".qkv." in k else 1) for k, (_, parts) in got.items())


def test_tensor_parallel_shards_join_to_the_full_weights():
    """shard_module_ on each of 2 model ranks (no collective needed to
    split): q, k and v cut by heads, proj's input columns; the two shards
    side by side are the full tensors."""
    cfg = torch_preset("synthetic", backbone="vit_tiny_test", num_classes=6, crop_size=CROP)
    full = build_model(cfg, "cpu").state_dict()
    shards = []
    for rank in (0, 1):
        model = build_model(cfg, "cpu")
        shard_module_(model, Mesh(world=2, rank=rank, tp=2))
        shards.append(model.state_dict())
    d = 64
    qkv = [s["encoder.blocks.0.attn.qkv.weight"].reshape(3, d // 2, d) for s in shards]
    assert torch.equal(torch.cat(qkv, 1).reshape(3 * d, d), full["encoder.blocks.0.attn.qkv.weight"])
    proj = torch.cat([s["encoder.blocks.0.attn.proj.weight"] for s in shards], 1)
    assert torch.equal(proj, full["encoder.blocks.0.attn.proj.weight"])
    assert torch.equal(shards[1]["encoder.blocks.0.attn.proj.bias"],
                       full["encoder.blocks.0.attn.proj.bias"])  # replicated
    assert shards[0]["decoder.conv6.weight"].shape == full["decoder.conv6.weight"].shape


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_shard_matches_jax_process_shard(rank):
    kw = dict(crop_size=CROP, seed=5)
    ours = build_train_loader(torch_preset("synthetic", **kw), 2, num_workers=2,
                              process_index=rank, process_count=2)
    ref = JaxTrainLoader(jax_train_dataset(jax_preset("synthetic", **kw)), batch_size=2,
                         seed=5, num_workers=2, process_index=rank, process_count=2)
    try:
        for _ in range(3):
            a, b = next(ours), next(ref)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        ours.close()
        ref.close()


def test_drop_path_draws_the_global_batch_masks():
    """Under dp=2, data rank r's stochastic-depth masks are rows [2r, 2r+2)
    of the one-process draw at the global batch of 4, from the same
    generator; shard_module_ hands the Swin blocks their rows."""
    x = torch.arange(1.0, 5.0).reshape(4, 1, 1, 1).expand(4, 2, 2, 3).contiguous()
    one = DropPath(0.5)(x, True, torch.Generator().manual_seed(1))
    assert (one[:, 0, 0, 0] == 0).tolist() == [True, False, False, True]
    for r in (0, 1):
        dp = DropPath(0.5)
        dp.rows = (r, 2)
        got = dp(x[2 * r:2 * r + 2], True, torch.Generator().manual_seed(1))
        assert torch.equal(got, one[2 * r:2 * r + 2]), r
    model = build_model(torch_preset("synthetic", model="swinend2end", backbone="swin-t",
                                     num_classes=6), "cpu")
    shard_module_(model, Mesh(world=2, rank=1, dp=2))
    rows = {m.rows for m in model.modules() if isinstance(m, DropPath)}
    assert rows == {(1, 2)}
