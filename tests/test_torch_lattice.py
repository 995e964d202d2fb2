"""PyTorch port vs the JAX package: the permutohedral lattice, the lattice
dense energy, and the CRF's lattice and host backends.

Tolerances: the lattice's integer structure (uid, nbr_idx, nbr_ok) equals
the JAX package's exactly; bary within 1e-5; the filter within rtol 1e-4 /
atol 1e-5 of JAX's and within 1e-4 relative (in norm) of the reference C++
lattice's golden output; the lattice energy within 1e-5 relative and its
gradient within 1e-4 relative (largest value); the native CRF's labels equal
the JAX package's; the lattice mean-field's labels agree with the JAX
package's on >= 99.9% of the pixels; a host-CRF evaluation's confusion
matrix within 0.1% of the JAX package's counted pixels."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cosa_tpu.eval.engine as jax_engine
from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.config import voc_config as jax_voc
from cosa_tpu.data.loader import build_val_dataset as jax_val_dataset
from cosa_tpu.eval import crf as jax_crf
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.objectives import energy as jax_energy
from cosa_tpu.ops import permutohedral as jax_lat
from cosa_tpu.ops.bilateral import pixel_features as jax_pixel_features
import cosa_tpu_torch.eval.engine as engine
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.config import voc_config as torch_voc
from cosa_tpu_torch.data.loader import build_val_dataset
from cosa_tpu_torch.eval import crf
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.objectives import energy
from cosa_tpu_torch.ops import permutohedral as lat

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "permutohedral_golden.npz")
TAGS = ("energy", "crf")


@pytest.fixture(scope="module")
def golden():
    """For each golden kernel: features, values, the reference C++ output,
    and the JAX package's lattice and filter output (built once)."""
    g = np.load(GOLDEN)
    vals = np.moveaxis(g["vals"], 0, -1).reshape(-1, 21)
    out = {}
    for tag in TAGS:
        srgb, sxy = g[f"sig_{tag}"]
        feats = np.asarray(jax_pixel_features(jnp.asarray(g["img"][None]), float(srgb),
                                              float(sxy))).reshape(-1, 5)
        lj = jax_lat.build_lattice(jnp.asarray(feats))
        out[tag] = dict(
            feats=feats, vals=vals, cpp=np.moveaxis(g[f"out_{tag}"], 0, -1).reshape(-1, 21),
            lattice=jax.tree.map(np.asarray, lj._asdict()),
            filtered=np.asarray(jax_lat.apply_lattice(lj, jnp.asarray(vals))),
            normed=np.asarray(jax_lat.apply_lattice(lj, jnp.asarray(vals), with_norm=True)),
        )
    return out


@pytest.mark.parametrize("tag", TAGS)
def test_lattice_structure_equals_jax(golden, tag):
    ref = golden[tag]
    ours = lat.build_lattice(torch.tensor(ref["feats"]))
    for name in ("uid", "nbr_idx", "nbr_ok"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), ref["lattice"][name],
                                      err_msg=name)
    assert np.abs(ours.bary.numpy() - ref["lattice"]["bary"]).max() <= 1e-5


@pytest.mark.parametrize("tag", TAGS)
def test_lattice_filter_matches_jax_and_the_reference_cpp(golden, tag):
    ref = golden[tag]
    f, v = torch.from_numpy(ref["feats"]), torch.from_numpy(ref["vals"])
    ours = lat.permutohedral_filter(f, v).numpy()
    np.testing.assert_allclose(ours, ref["filtered"], rtol=1e-4, atol=1e-5)
    assert np.linalg.norm(ours - ref["cpp"]) / np.linalg.norm(ref["cpp"]) < 1e-4
    normed = lat.permutohedral_filter(f, v, with_norm=True).numpy()
    np.testing.assert_allclose(normed, ref["normed"], rtol=1e-4, atol=1e-5)


def test_batched_lattice_equals_one_image_at_a_time(golden):
    """One lattice per image of a batch: each image's output equals its own
    single-image filter bitwise, and two applies agree bitwise."""
    f = torch.from_numpy(np.stack([golden[t]["feats"] for t in TAGS]))
    v = torch.from_numpy(np.stack([golden["energy"]["vals"], golden["crf"]["vals"][::-1].copy()]))
    built = lat.build_lattice(f)
    out = lat.apply_lattice(built, v)
    for i in range(2):
        assert torch.equal(out[i], lat.permutohedral_filter(f[i], v[i]))
    assert torch.equal(out, lat.apply_lattice(built, v))


def _energy_inputs():
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 32, 32, 5
    simg_u8 = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    logits = rng.standard_normal((b, h, w, c)).astype(np.float32)
    label = rng.integers(0, c, (b, h, w)).astype(np.int32)
    label[0, :4] = 255
    box = np.array([[0, h, 0, w], [2, 30, 4, 28]], np.int32)
    return simg_u8, logits, label, box


def test_lattice_energy_and_gradient_match_jax():
    """get_energy_loss(filter_kind="lattice") and the reference's gradient:
    the JAX package's through a lattice from its build_energy_lattice, the
    port's through the lattice it builds from its own features."""
    from cosa_tpu.ops.image import normalize as jax_normalize
    from cosa_tpu_torch.ops.image import normalize

    simg_u8, logits, label, box = _energy_inputs()
    kw = dict(energy_scale=0.5, energy_sigma_rgb=15.0, energy_sigma_xy=100.0)
    cfg_j = jax_preset("synthetic", **kw)
    lat_j = jax_energy.build_energy_lattice(cfg_j, jnp.asarray(simg_u8))

    def loss_j(x):
        return jax_energy.get_energy_loss(
            jax_normalize(jnp.asarray(simg_u8)), x, jnp.asarray(label), jnp.asarray(box),
            weight=1.0, filter_kind="lattice", lattice=lat_j)

    ref, ref_g = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    ours = energy.get_energy_loss(
        normalize(torch.from_numpy(simg_u8)), x, torch.from_numpy(label),
        torch.from_numpy(box), weight=1.0, filter_kind="lattice")
    ours.backward()
    assert abs(float(ours.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    ref_g = np.asarray(ref_g)
    assert np.abs(x.grad.numpy() - ref_g).max() <= 1e-4 * np.abs(ref_g).max()


def _scene(h=40, w=40, seed=0):
    """tests/test_crf.py's scene: two colour regions, a noisy unary that
    leans the wrong way near their edge."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[:, : w // 2] = (200, 40, 40)
    img[:, w // 2:] = (40, 40, 200)
    img = np.clip(img + r.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    gt = np.zeros((h, w), np.int32)
    gt[:, w // 2:] = 1
    probs = np.where(gt[..., None] == 0, [0.7, 0.3], [0.3, 0.7]).astype(np.float32)
    probs[:, w // 2 - 3: w // 2 + 3] = [0.51, 0.49]
    probs += r.uniform(0, 0.25, probs.shape).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return img, probs, gt


def test_native_crf_labels_equal_jax():
    img, probs, gt = _scene()
    ref = jax_crf.crf_refine_native(jax_voc(crf_iter=1), img, probs)
    ours = crf.crf_refine_native(torch_voc(crf_iter=1), img, probs)
    np.testing.assert_array_equal(ours, ref)
    assert (ours == gt).mean() > 0.95


def test_lattice_meanfield_matches_jax():
    cfg = torch_voc(crf_iter=1)
    img, probs, _ = _scene()
    valid = np.ones(img.shape[:2], np.float32)
    args = (1, cfg.crf_pos_w, cfg.crf_pos_xy, cfg.crf_bi_w, cfg.crf_bi_xy, cfg.crf_bi_rgb, 1)
    ref = np.asarray(jax_crf._crf_padded(jnp.asarray(img.astype(np.float32)),
                                         jnp.asarray(probs), jnp.asarray(valid), *args))
    ours = crf._crf_core(torch.from_numpy(img.astype(np.float32)), torch.from_numpy(probs),
                         torch.from_numpy(valid), *args, use_lattice=True)
    assert (ours.numpy() == ref).mean() >= 0.999
    with pytest.raises(ValueError, match="native"):
        crf.crf_refine_host(cfg.replace(crf_backend="device"), torch.from_numpy(img),
                            torch.from_numpy(probs))


def test_evaluate_with_a_host_crf_matches_jax(monkeypatch):
    """evaluate() at batch 1 with a host CRF backend ("jax" at crf_reduce 8;
    the "native" one runs in tests/test_torch_optin.py), in both packages:
    Seg_crf's confusion matrix."""
    kw = dict(backbone="vit_tiny_test", crop_size=64, mixed_precision=False,
              flash_attention=False, eval_scales=(1.0, 0.5), crf_backend="jax", crf_reduce=8)
    cfg_j, cfg_t = jax_preset("synthetic", **kw), torch_preset("synthetic", **kw)
    model_j = jax_build_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    model_t = build_model(cfg_t, "cpu")
    model_t.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    seen = {}
    for tag, mod in (("jax", jax_engine), ("ours", engine)):
        fn = mod.scores_from_hist
        seen[tag] = []
        monkeypatch.setattr(mod, "scores_from_hist",
                            lambda h, fn=fn, into=seen[tag]: into.append(np.asarray(h)) or fn(h))
    ref = jax_engine.evaluate(cfg_j, model_j, params, jax_val_dataset(cfg_j), getcrf=True,
                              max_images=2)
    ours = engine.evaluate(cfg_t, model_t, build_val_dataset(cfg_t), getcrf=True,
                           max_images=2, device="cpu")
    a, b = seen["ours"][-1], seen["jax"][-1]  # Seg_crf comes last
    assert b.sum() > 0
    assert np.abs(a - b).sum() <= 1e-3 * b.sum()
    assert abs(ours["Seg_crf"]["miou"] - ref["Seg_crf"]["miou"]) <= 1e-3
    assert ours["time"]["images"] == 2 and ours["time"]["crf_seconds"] > 0
