"""PyTorch port vs the JAX package: the int8 teacher (models/quant.py).

The same numpy inputs go through ``cosa_tpu.models.quant`` and the port's
twin. Jitted, as the JAX package's step runs it, XLA compiles the scales'
``/ 127`` into a product with f32(1/127); the port takes that product, and
its quantize and dequantize are then the same IEEE operations in the same
order: the scales, codes, int32 product and the bias-free output equal the
jitted JAX functions bitwise; with a bias, XLA's CPU code contracts the last
product and the bias add into one FMA, so the output is within 1 ulp of the
magnitude of its two terms (the rescaled product and the bias) in the
output dtype. Run eagerly, JAX divides: a scale moves by at most one
ulp, a code by at most 1 where x / s sits at a rounding tie (at most on
1e-4 of the entries), the int32 product by the codes' moves, the output
within 4 ulp of the magnitude of its two terms (the rescaled product and
the bias).

The int8 network against ``build_model(cfg, quant=True)`` on the same
weights: f32 within 1e-5 of each output's range (read: 1e-6); bf16 within
3% of the range plus 2e-3, the float network's bf16 bound
(test_torch_model.py; the GELU rounds at other places, ROADMAP Queue 3).
A whole step with the int8 teacher at every TTA scale against the JAX
step goes through test_torch_step.py's harness, within its TOLS."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.models import quant as jq
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.models import quant as tq
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.models.network import CoSANetwork
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step
from tests.test_torch_step import check_step_against_jax

KEYS = ("cls", "cls_aux", "seg", "cam", "cam_aux")


def _dense_inputs(seed=0, m=300, k=64, n=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, m // 3, k)) * 3).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: its scale clamps to 1e-12
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)  # nn.Linear (N, K)
    b = rng.standard_normal(n).astype(np.float32)
    lin = torch.nn.Linear(k, n).requires_grad_(False)  # a teacher's layer
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    return x, w, b, lin


def _codes_agree(ours, ref):
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())


def test_quantize_and_int8_matmul_equal_jitted_jax():
    x, w, b, lin = _dense_inputs()
    x2 = x.reshape(-1, x.shape[-1])
    qt, st = tq.quantize_rows(torch.from_numpy(x2))
    qj, sj = jax.jit(jq.quantize_rows)(jnp.asarray(x2))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    qwt, swt = tq.quantize_cols(lin.weight)
    qwj, swj = jax.jit(jq.quantize_cols)(jnp.asarray(w.T))
    np.testing.assert_array_equal(qwt.numpy().T, np.asarray(qwj))
    np.testing.assert_array_equal(swt.numpy(), np.asarray(swj))
    acc_j = jax.jit(lambda a, c: jax.lax.dot(a, c, preferred_element_type=jnp.int32))(qj, qwj)
    acc_t = tq.int_mm(qt, qwt.t())
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    p = (acc_t.numpy().astype(np.float32) * st.numpy() * swt.numpy()).reshape(
        x.shape[:-1] + (-1,))
    for dt_t, dt_j, mant in ((torch.float32, jnp.float32, 24), (torch.bfloat16, jnp.bfloat16, 8)):
        ref = jax.jit(lambda a, c, d: jq.int8_matmul(a, c, d, dt_j))(x, w.T, b)
        ours = tq.int8_matmul(torch.from_numpy(x), lin, dt_t).float().numpy()
        mag = np.abs(p) + np.abs(b)
        ulp = np.exp2(np.floor(np.log2(mag)) - (mant - 1))
        assert np.all(np.abs(ours - np.asarray(ref, np.float32)) <= ulp), dt_t
        free = torch.nn.Linear(lin.in_features, lin.out_features, bias=False)
        free.weight = lin.weight
        ref = jax.jit(lambda a, c: jq.int8_matmul(a, c, None, dt_j))(x, w.T)
        ours = tq.int8_matmul(torch.from_numpy(x), free, dt_t).float().numpy()
        np.testing.assert_array_equal(ours, np.asarray(ref, np.float32))


def test_quantize_and_int8_matmul_match_eager_jax():
    x, w, b, lin = _dense_inputs(seed=1)
    x2 = x.reshape(-1, x.shape[-1])
    qj, sj = jq.quantize_rows(jnp.asarray(x2))
    qwj, swj = jq.quantize_cols(jnp.asarray(w.T))
    qt, st = tq.quantize_rows(torch.from_numpy(x2))
    qwt, swt = tq.quantize_cols(lin.weight)
    _codes_agree(qt.numpy(), np.asarray(qj))
    _codes_agree(qwt.numpy().T, np.asarray(qwj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1.2e-7)
    np.testing.assert_allclose(swt.numpy(), np.asarray(swj), rtol=1.2e-7)
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b),
                                    jnp.float32))
    ours = tq.int8_matmul(torch.from_numpy(x), lin, torch.float32).numpy()
    acc = tq.int_mm(qt, qwt.t()).numpy().astype(np.float32)
    scale = np.abs(acc * st.numpy() * swt.numpy()).reshape(ref.shape) + np.abs(b)
    assert np.all(np.abs(ours - ref) <= 4 * np.spacing(scale.astype(np.float32)))


def test_plain_int_mm_is_the_exact_int32_product():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (40, 3072)).astype(np.int8)
    c = rng.integers(-127, 128, (3072, 24)).astype(np.int8)
    want = a.astype(np.int64) @ c.astype(np.int64)
    got = tq.plain_int_mm(torch.from_numpy(a), torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the extreme codes everywhere: |sum| = K * 127^2, past f32's 2^24
    full = torch.full((20, 3072), 127, dtype=torch.int8)
    assert int(tq.plain_int_mm(full, -full.t().contiguous())[0, 0]) == -3072 * 127 * 127


def _pair(mixed_precision):
    cfg = jax_preset("synthetic", backbone="vit_tiny_test", num_classes=6,
                     mixed_precision=mixed_precision, flash_attention=False, aux_layer=-2)
    jq_model = jax_build_model(cfg, quant=True)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 64, 64, 3)))["params"]
    tm = CoSANetwork(6, "vit_tiny_test", aux_layer=-2,
                     dtype=torch.bfloat16 if mixed_precision else torch.float32,
                     use_kernel=True)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jq_model, params, tm.eval()


@pytest.mark.parametrize("mixed_precision", [False, True], ids=["f32", "bf16"])
def test_int8_network_matches_jax_quant_twin(mixed_precision):
    jm, params, tm = _pair(mixed_precision)
    x = np.random.default_rng(1).standard_normal((2, 64, 96, 3)).astype(np.float32)
    ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, x)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), quant=True)
    for k in KEYS:
        a, r = ours[k].float().numpy(), np.asarray(ref[k], np.float32)
        assert a.shape == r.shape, k
        rng_ = np.abs(r).max()
        tol = 3e-2 * rng_ + 2e-3 if mixed_precision else 1e-5 * rng_
        assert np.abs(a - r).max() <= tol, (k, np.abs(a - r).max(), tol)


def test_int8_cams_track_the_float_network():
    """The JAX package's own bound (tests/test_train_step.py:208-212): the
    CAMs' cosine against the float network above 0.98 (read: 0.9999)."""
    _, _, tm = _pair(False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        a = tm(x, quant=True)["cam"].reshape(-1)
        b = tm(x)["cam"].reshape(-1)
    assert float(a @ b / (a.norm() * b.norm())) > 0.98


def test_int8_gate_above_every_scale_equals_the_float_teacher(monkeypatch):
    """min_size above every TTA scale: the int8 projections never run, and
    the step's losses equal the float teacher's bitwise (the JAX package's
    tests/test_train_step.py:220-239)."""
    calls = []
    int_mm = tq.int_mm
    monkeypatch.setattr(tq, "int_mm", lambda a, b: calls.append(1) or int_mm(a, b))
    rng = np.random.default_rng(4)
    cls_label = np.zeros((2, 5), np.float32)
    cls_label[0, 1] = cls_label[1, [2, 3]] = 1
    batch = dict(wimg=rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
                 simg=rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
                 cls_label=cls_label, img_box=np.array([[0, 64, 0, 64]] * 2, np.int32))
    losses = {}
    for tag, kw in (("gated", dict(teacher_int8=True, teacher_int8_min_size=10 ** 6)),
                    ("plain", dict(teacher_int8=False))):
        cfg = torch_preset("synthetic", backbone="vit_tiny_test", num_classes=6,
                           mixed_precision=False, aux_layer=-2, pseudo_scales=(1.0, 0.5),
                           warmup_iters=-1, energy_convention=0.6, **kw)
        state = create_train_state(cfg, "cpu")
        m = build_train_step(cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses[tag] = {k: float(m[k]) for k in ("overall_loss", "seg_loss", "cam_loss",
                                                   "reg_loss", "cls_loss")}
    assert losses["gated"] == losses["plain"], losses
    assert not calls


def test_int8_teacher_step_matches_jax():
    check_step_against_jax("rff", dict(teacher_int8=True, teacher_int8_min_size=0))


def test_int8_teacher_is_vit_only():
    from cosa_tpu_torch.models.zoo.swin import SwinNetwork

    with pytest.raises(NotImplementedError, match="ViT-only"):
        torch_preset("synthetic", model="swinend2end", backbone="swin_tiny_test",
                     teacher_int8=True)
    net = SwinNetwork(6, "swin_tiny_test")
    with pytest.raises(NotImplementedError, match="ViT-only"):
        net(torch.zeros((1, 64, 64, 3)), quant=True)
