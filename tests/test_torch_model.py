"""PyTorch port vs the JAX package: CoSANetwork and the weight converter.

JAX parameters from a seeded ``init`` are carried into the port with
``state_dict_from_jax``; the same numpy images go through both networks.
f32 tolerance: rtol/atol 2e-4, the bound of test_convert_parity.py's
torch-oracle comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.models.convert import network_params_from_torch
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.models.network import CoSANetwork
from cosa_tpu_torch.models.vit import Mlp
from tests import torch_oracle as O

KEYS = ("cls", "cls_aux", "seg", "cam", "cam_aux")


def _pair(mixed_precision: bool, seed: int = 0):
    cfg = jax_preset("synthetic", backbone="vit_tiny_test", num_classes=6,
                     mixed_precision=mixed_precision, flash_attention=False,
                     aux_layer=-2)
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))["params"]
    tm = CoSANetwork(6, "vit_tiny_test", aux_layer=-2,
                     dtype=torch.bfloat16 if mixed_precision else torch.float32,
                     use_kernel=True)  # on a CPU tensor: the plain version
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def _outputs(jm, params, tm, x):
    jo = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x))
    return ({k: to[k].float().numpy() for k in KEYS},
            {k: np.asarray(jo[k], np.float32) for k in KEYS})


@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (72, 88), (70, 83)])
def test_network_outputs_match_jax_f32(hw):
    jm, params, tm = _pair(False)
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    ours, ref = _outputs(jm, params, tm, x)
    for k in KEYS:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], rtol=2e-4, atol=2e-4, err_msg=k)


def test_network_outputs_match_jax_bf16():
    """bf16 rounds at other places in the two frameworks (fused bias adds,
    GELU intermediates); measured gap <= 1.3% of each output's range, so
    the bound is 3% of the range plus 2e-3."""
    jm, params, tm = _pair(True)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ours, ref = _outputs(jm, params, tm, x)
    for k in KEYS:
        tol = 0.03 * np.abs(ref[k]).max() + 2e-3
        assert np.abs(ours[k] - ref[k]).max() <= tol, k


def test_bf16_mlp_uses_the_tanh_gelu():
    """Under bf16 the JAX Mlp picks the tanh GELU (cosa_tpu/models/vit.py:188).
    An identity MLP exposes the activation alone: the port must equal
    tanh-GELU of the bf16 input (evaluated in f32, rounded to bf16) within
    1e-4, a bound the erf form misses by two orders of magnitude."""
    d = 64
    x = np.random.default_rng(3).uniform(-4, 4, (4, 50, d)).astype(np.float32)
    m = Mlp(d, d, torch.bfloat16)
    with torch.no_grad():
        for lin in (m.fc1, m.fc2):
            lin.weight.copy_(torch.eye(d))
            lin.bias.zero_()
        ours = m(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    ref = np.asarray(jax.nn.gelu(xb, approximate=True).astype(jnp.bfloat16), np.float32)
    erf = np.asarray(jax.nn.gelu(xb, approximate=False).astype(jnp.bfloat16), np.float32)
    assert np.abs(ours - ref).max() < 1e-4
    assert np.abs(erf - ref).max() > 1e-2  # the bound tells the two forms apart


def test_state_dict_round_trip_is_identity():
    sd = {k: v.clone() for k, v in O.make_state_dict(np.random.default_rng(4), 6).items()}
    params = network_params_from_torch(dict(sd), depth=O.CFG.depth)
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)
    # the reference's key names load into the port directly
    tm = CoSANetwork(6, "vit_tiny_test", aux_layer=-2)
    tm.load_state_dict(sd, strict=True)
