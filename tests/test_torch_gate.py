"""PyTorch port vs the JAX package: 30 co-training steps across the warmup
gate, in f32.

tests/test_torch_step.py holds one step with the gate open and
tests/test_torch_parallel.py two; none crosses the gate, where the seg,
cam and energy losses switch from ``warmup_gate_floor`` to full weight and
AdamW has already taken its first steps. Here both packages run 30 steps:
test_torch_step.py's configuration (``vit_tiny_test``, crop 64, batch 2,
f32, two TTA scales) with the exact energy at the default loss weights
(``energy_weight`` 1e-7; at test_torch_step.py's 1.0 the energy, -1.5e3 to
-8e3, outweighs the other losses a thousandfold), ``warmup_iters`` 10 and
``warmup_gate_floor`` 0.01 (steps 0-10 gated, 11-29 open),
``lr_warmup_iters`` 5, lr 3e-4 and ``max_iters`` 100 (the poly decay keeps
the lr at 0.77-1.0 of its peak). Student and teacher start from JAX inits
carried into the port with ``state_dict_from_jax``; each step feeds both a
fresh seeded batch of blocky images (8 x 8 blocks of random colours) with
random image-level labels.

Two port runs go in lockstep with the JAX run:

* free: the port's own 30-step trajectory. Every step's losses are held
  within test_torch_step.py's ``TOLS`` (they agree to about 5 significant
  digits), the loss the backward takes is the gated sum, and the logged lr
  is within one ulp.
* forced: before each step the port takes the JAX run's state (student,
  teacher, AdamW's moments and count). After the step AdamW's first and
  second moments are held within 1e-4, and every student and teacher
  parameter within 1e-3, of each tensor's largest value, at each of the 30
  steps on both sides of the gate.

Why the moments and parameters are not held at the end of the free run:
most of the LargeFOV decoder's units are dead at this init and width, and
a unit that is barely alive gets gradients so small that a rounding
difference switches it on or off; AdamW then turns its gradient into
lr-sized steps. So after 30 free steps the decoder's convolutions (and,
through them, the last encoder block's moments) lie far outside these
bounds while every loss still agrees to 5 digits, and the JAX package does
the same against itself from its own init perturbed at the level of f32
rounding. Such a comparison measures the trajectory's sensitivity, not the
port.

Exempt in the forced comparison: the key third of every ``qkv.bias`` (its
parameter and moments). A bias added to every key adds q.b to each score
of a query's row, which the softmax cancels, so its true gradient is zero
and each package computes rounding noise there; AdamW divides that noise by
its own root mean square, so a step moves the bias by about the lr with a
sign that differs between the packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.train import build_optimizer as jax_build_optimizer
from cosa_tpu.train import build_train_step as jax_build_train_step
from cosa_tpu.train.state import TrainState as JaxTrainState
from cosa_tpu.train.state import init_gmm_state
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.train.checkpoint import optimizer_moments
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step
from test_torch_step import CROP, TOLS, _kw, _np_tree

STEPS = 30
# the module docstring's settings; energy_weight back to the config's default
# (test_torch_step.py sets 1.0, where the energy outweighs the other losses a thousandfold)
GATE = dict(warmup_iters=10, warmup_gate_floor=0.01, lr_warmup_iters=5, lr=3e-4, max_iters=100,
            energy_weight=1e-7)
MOMENT_TOL = 1e-4
PARAM_TOL = 1e-3


def _batch(step: int):
    rng = np.random.default_rng(1000 + step)
    blocks = rng.integers(0, 256, (2, 8, 8, 3))
    wimg = np.kron(blocks, np.ones((1, CROP // 8, CROP // 8, 1))).astype(np.uint8)
    cls_label = (rng.random((2, 5)) > 0.6).astype(np.float32)
    cls_label[np.arange(2), rng.integers(0, 5, 2)] = 1.0
    img_box = np.array([[0, CROP, 0, CROP], [4, 60, 2, 62]], np.int32)
    return dict(wimg=wimg, simg=wimg.copy(), cls_label=cls_label, img_box=img_box)


def _jax_moments(opt_state, params, kind: str):
    """AdamW's ``mu`` or ``nu`` of the JAX state as a port state dict: each
    optimizer label's masked tree, masked leaves zero, summed over labels."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    total = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    for inner in opt_state.inner_states.values():
        adam = inner.inner_state
        if isinstance(adam, tuple) and adam and hasattr(adam[0], kind):
            total = jax.tree.map(lambda t, m: t if masked(m) else t + np.asarray(m),
                                 total, getattr(adam[0], kind), is_leaf=masked)
    return state_dict_from_jax(total)


def _held(name: str, a: np.ndarray) -> np.ndarray:
    """``a`` without the key third of a qkv bias (the module docstring)."""
    if name.endswith("attn.qkv.bias"):
        c = a.shape[0] // 3
        return np.concatenate([a[:c], a[2 * c:]])
    return a


def _close(what: str, ours, ref, tol: float, floor: float) -> None:
    assert set(ours) <= set(ref), (what, set(ours) - set(ref))
    for k, r in ref.items():
        r = _held(k, r.numpy())
        a = _held(k, ours[k].numpy()) if k in ours else np.zeros_like(r)
        gap = np.abs(a - r).max() if r.size else 0.0
        assert gap <= tol * max(np.abs(r).max(), floor), (what, k, gap, np.abs(r).max())


def _force(state_t, state_j, step: int) -> None:
    """The port's state set to the JAX state: student, teacher, AdamW's
    moments and count (the parameters the port steps)."""
    state_t.student.load_state_dict(state_dict_from_jax(_np_tree(state_j.student)))
    state_t.teacher.load_state_dict(state_dict_from_jax(_np_tree(state_j.teacher)))
    if step == 0:  # AdamW's state starts empty, as optax's starts at zero
        return
    mu, nu = (_jax_moments(state_j.opt_state, state_j.student, k) for k in ("mu", "nu"))
    for name, st in optimizer_moments(state_t).items():
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])
        st["step"].fill_(step)
    assert state_t.step == step


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one torch thread, beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_thirty_steps_across_the_warmup_gate_match_jax():
    cfg_j = jax_preset("synthetic", **_kw("exact", **GATE))
    model = jax_build_model(cfg_j)
    dummy = jnp.zeros((1, CROP, CROP, 3))
    student = model.init(jax.random.PRNGKey(0), dummy)["params"]
    teacher = model.init(jax.random.PRNGKey(1), dummy)["params"]
    tx = jax_build_optimizer(cfg_j, student)
    state_j = JaxTrainState(step=jnp.zeros((), jnp.int32), student=student, teacher=teacher,
                            opt_state=tx.init(student), gmm=init_gmm_state(cfg_j, 2))
    step_j = jax.jit(jax_build_train_step(cfg_j, model, tx))

    cfg_t = torch_preset("synthetic", **_kw("exact", **GATE))
    free, forced = create_train_state(cfg_t, "cpu"), create_train_state(cfg_t, "cpu")
    _force(free, state_j, 0)
    step_t = build_train_step(cfg_t)

    for i in range(STEPS):
        batch = _batch(i)
        batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
        _force(forced, state_j, i)
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        m_t = step_t(free, batch_t)
        step_t(forced, batch_t)
        for k, tol in TOLS.items():
            ours, ref = float(m_t[k]), float(m_j[k])
            assert abs(ours - ref) <= tol * max(abs(ref), 1e-3), (i, k, ours, ref)
        # the schedule's f32 power: numpy's in the port, XLA's in JAX, which
        # round apart by one ulp at some steps (step 22 here)
        lr_t, lr_j = np.float32(m_t["lr"]), np.float32(m_j["lr"])
        assert abs(lr_t - lr_j) <= np.spacing(lr_j), (i, lr_t, lr_j)
        # the gate: seg, cam and energy at the floor's weight up to step 10
        gate = GATE["warmup_gate_floor"] if i <= GATE["warmup_iters"] else 1.0
        m = {k: float(v) for k, v in m_t.items() if k.endswith("loss")}
        want = m["cls_loss"] + m["cls_aux_loss"] + gate * (
            cfg_t.seg_weight * m["seg_loss"] + cfg_t.cam_weight * m["cam_loss"]
            + cfg_t.reg_weight * m["reg_loss"])
        assert abs(m["overall_loss"] - want) <= 1e-5 * abs(want), (i, m, gate)

        moments = optimizer_moments(forced)
        for kind, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            _close(f"{kind} {i}", {k: v[key] for k, v in moments.items()},
                   _jax_moments(state_j.opt_state, state_j.student, kind), MOMENT_TOL, 1e-12)
        for name in ("student", "teacher"):
            _close(f"{name} {i}", getattr(forced, name).state_dict(),
                   state_dict_from_jax(_np_tree(getattr(state_j, name))), PARAM_TOL, 1e-3)
    assert free.step == forced.step == int(state_j.step) == STEPS
