"""PyTorch port vs the JAX package: the four optimizers of cfg.optimizer
(train/optimizer.py).

Each schedule's lr curve against ``cosa_tpu.train.optimizer`` (both in f32:
within 1e-6 relative, the cosine's f32 rounding in numpy against XLA's).
Four steps of each optimizer on a toy model with one tensor in each group
(and a frozen pos_embed), on the same seeded gradients, against
``build_optimizer``'s optax transform on the same tree: every parameter
within 1e-6 (the parameters are O(1), f32's step there is 1.2e-7; at lr
1e-3 and 1e-2 for the lr-scaled groups, Adam's updates are about lr in size
and round in another order in the two packages)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.train import optimizer as jopt
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.train import optimizer as topt

KINDS = ("poly_adamw", "cos_adamw", "poly_sgd", "poly_cls_sgd")
STEPS = [0, 1, 2, 3, 5, 7, 9, 10, 15]
# one tensor per group: backbone, norm, head, decoder, and the frozen pos_embed
SHAPES = {"encoder.blocks.weight": (4, 3), "encoder.norm.weight": (3,),
          "classifier.weight": (3, 2), "decoder.conv.weight": (2, 3),
          "encoder.pos_embed": (1, 3)}


def _kw(kind, **extra):
    return dict(optimizer=kind, lr=1e-3, lr_warmup_iters=3, max_iters=10, lrscale=10.0,
                wt_dec=1e-2, wt_dec_mult=0.5, **extra)


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_matches_jax(kind):
    cfg = torch_preset("synthetic", **_kw(kind))
    for mult in (1.0, cfg.lrscale):
        ours = topt.lr_schedule(cfg, mult)
        lr = cfg.lr * mult
        ref = {
            "poly_adamw": lambda: jopt.poly_warmup_schedule(lr, 3, 10, 1e-6, 0.9, 0.0),
            "cos_adamw": lambda: jopt.cos_warmup_schedule(lr, 3, 10, 1e-6),
            "poly_sgd": lambda: jopt.poly_sgd_schedule(lr, 3, 10, 0.9),
            "poly_cls_sgd": lambda: jopt.poly_cls_schedule(lr, 10, 0.9, constant=mult != 1.0),
        }[kind]()
        for s in STEPS:
            r = float(ref(jnp.asarray(s)))
            assert abs(ours(s) - r) <= 1e-6 * abs(r), (kind, mult, s, ours(s), r)


def _toy(arrays):
    """A module whose named parameters are ``arrays``' keys."""
    root = torch.nn.Module()
    for name, a in arrays.items():
        mod = root
        *path, leaf = name.split(".")
        for p in path:
            if not hasattr(mod, p):
                mod.add_module(p, torch.nn.Module())
            mod = getattr(mod, p)
        mod.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(a.copy())))
    return root


def _tree(flat):
    tree = {}
    for name, a in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree


def _run_both(kind, n_steps=4, **extra):
    """n_steps of the port's optimizer and of the JAX package's optax
    transform on the toy tree; returns (port params, JAX params, port
    optimizer, the initial params)."""
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    model = _toy(init)
    opt = topt.GroupOptimizer(torch_preset("synthetic", **_kw(kind, **extra)), model)
    params = _tree(init)
    tx = jopt.build_optimizer(jax_preset("synthetic", **_kw(kind, **extra)), params)
    state = tx.init(params)
    for step in range(n_steps):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        upd, state = tx.update(_tree(grads), state, params)
        params = optax.apply_updates(params, upd)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name]) if p.requires_grad else None
        opt.step(step)
    ours = {k: v.detach().numpy() for k, v in model.named_parameters()}
    ref = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return ours, ref, opt, init


@pytest.mark.parametrize("kind", KINDS)
def test_optimizer_steps_match_optax(kind):
    ours, ref, opt, init = _run_both(kind)
    assert set(ours) == set(ref) == set(SHAPES)
    for k in SHAPES:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ours["encoder.pos_embed"], init["encoder.pos_embed"])
    assert [g["name"] for g in opt.opt.param_groups] == ["backbone", "norm", "head",
                                                         "decoder"]
    jsched = {"poly_adamw": jopt.poly_warmup_schedule(1e-3, 3, 10),
              "cos_adamw": jopt.cos_warmup_schedule(1e-3, 3, 10),
              "poly_sgd": jopt.poly_sgd_schedule(1e-3, 3, 10),
              "poly_cls_sgd": jopt.poly_cls_schedule(1e-3, 10)}[kind]
    for s in (0, 4):  # the logged lr is the backbone group's schedule
        assert opt.lr_at(s) == pytest.approx(float(jsched(jnp.asarray(s))), rel=1e-6)


def test_poly_cls_sgd_puts_the_weight_decay_in_the_momentum_slot():
    """The reference passes weight_decay positionally into SGD's momentum
    (torch_helper.py:330): each group's momentum is its wd and no decay is
    applied. Two steps by hand: buf = g1; buf = wd * buf + g2; p -= lr * buf."""
    ours, _, opt, init = _run_both("poly_cls_sgd", n_steps=0)
    moms = {g["name"]: (g["momentum"], g["weight_decay"]) for g in opt.opt.param_groups}
    assert moms == {"backbone": (1e-2, 0.0), "norm": (5e-3, 0.0), "head": (1e-2, 0.0),
                    "decoder": (1e-2, 0.0)}
    model = _toy(init)
    opt = topt.GroupOptimizer(torch_preset("synthetic", **_kw("poly_cls_sgd")), model)
    w = model.encoder.blocks.weight
    g1, g2 = torch.ones_like(w), torch.full_like(w, 2.0)
    for step, g in enumerate((g1, g2)):
        w.grad = g
        opt.step(step)
    lr0, lr1 = (topt.lr_schedule(torch_preset("synthetic", **_kw("poly_cls_sgd")), 1.0)(s)
                for s in (0, 1))
    want = torch.from_numpy(init["encoder.blocks.weight"]) - lr0 * g1 - lr1 * (1e-2 * g1 + g2)
    torch.testing.assert_close(w.detach(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_freeze_norm_leaves_the_norm_group_out(kind):
    """freeze_norm: the norm group is no optimizer group, its tensor takes
    no gradient and stays at its init, as optax's set_to_zero leaves it."""
    ours, ref, opt, init = _run_both(kind, n_steps=3, freeze_norm=True)
    assert "norm" not in [g["name"] for g in opt.opt.param_groups]
    np.testing.assert_array_equal(ours["encoder.norm.weight"], init["encoder.norm.weight"])
    np.testing.assert_array_equal(ref["encoder.norm.weight"], init["encoder.norm.weight"])
    np.testing.assert_allclose(ours["encoder.blocks.weight"], ref["encoder.blocks.weight"],
                               rtol=0, atol=1e-6)
