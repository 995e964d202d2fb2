"""PyTorch port: pretrained loading and ShapesWSSS against the JAX package,
and the opt-in training path end to end on the CPU.

Pretrained weights load into student and teacher exactly as the JAX
package's loader does (equal tensors); render_sample and make_dataset write
the same bytes as the JAX package's, and the CLI writes a VOC12 tree with
its class names. The opt-in run (lattice energy, GMM
thresholds, PAR, a pretrained .pth, on a ShapesWSSS tree read as VOC12)
trains 4 steps, and a run resumed from its step-2 checkpoint repeats steps
3-4 exactly: losses and thresholds."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.data import synthwsss as jax_synth
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.models.convert import load_pretrained_into_state as jax_load_pretrained
from cosa_tpu.train.state import TrainState as JaxTrainState
from cosa_tpu_torch.cli import evaluate as cli_evaluate
from cosa_tpu_torch.cli import make_synth_data
from cosa_tpu_torch.config import preset_config
from cosa_tpu_torch.data import synthwsss
from cosa_tpu_torch.models.convert import load_pretrained_into_state, state_dict_from_jax
from cosa_tpu_torch.train.loop import LOSS_KEYS, train
from cosa_tpu_torch.train.state import create_train_state
from torch_oracle import make_state_dict


def _loaded_by_jax(cfg_kw):
    cfg = jax_preset("synthetic", **cfg_kw)
    model = jax_build_model(cfg)
    dummy = jnp.zeros((1, 64, 64, 3))
    student = model.init(jax.random.PRNGKey(0), dummy)["params"]
    teacher = model.init(jax.random.PRNGKey(1), dummy)["params"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), student=student, teacher=teacher,
                          opt_state=None, gmm=None)
    new = jax_load_pretrained(cfg, state)
    return [state_dict_from_jax(jax.tree.map(np.asarray, p)) for p in (new.student, new.teacher)]


@pytest.mark.parametrize("keys", ["reference", "timm"])
def test_pretrained_loads_like_jax(tmp_path, keys):
    sd = make_state_dict(np.random.default_rng(3))
    if keys == "timm":  # the encoder alone, timm's names, and a head the network lacks
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
        sd["head.weight"] = torch.zeros(10, 4)
    path = str(tmp_path / "w.pth")
    torch.save(sd, path)
    kw = dict(backbone="vit_tiny_test", num_classes=6, pretrained_path=path)
    refs = _loaded_by_jax(kw)
    state = create_train_state(preset_config("synthetic", **kw), "cpu")
    load_pretrained_into_state(preset_config("synthetic", **kw), state)
    for model, ref in zip((state.student, state.teacher), refs):
        ours = model.state_dict()
        names = [k for k in ref if keys == "reference" or k.startswith("encoder.")]
        assert len(names) > 20
        for k in names:
            assert torch.equal(ours[k], ref[k]), k


def test_pretrained_without_encoder_weights_raises(tmp_path):
    sd = make_state_dict(np.random.default_rng(3))
    del sd["encoder.norm.weight"]
    torch.save(sd, str(tmp_path / "w.pth"))
    cfg = preset_config("synthetic", backbone="vit_tiny_test", num_classes=6,
                        pretrained_path=str(tmp_path / "w.pth"))
    with pytest.raises(KeyError, match="encoder.norm.weight"):
        load_pretrained_into_state(cfg, create_train_state(cfg, "cpu"))


@pytest.mark.parametrize("seed,idx,fade", [(7, 42, None), (11, 5, (0.3, 0.6))])
def test_render_sample_equals_jax(seed, idx, fade):
    for a, b in zip(synthwsss.render_sample(seed, idx, fade_range=fade),
                    jax_synth.render_sample(seed, idx, fade_range=fade)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_make_dataset_writes_the_jax_bytes(tmp_path):
    kw = dict(n_train=3, n_val=2, seed=1, size_range=(40, 56))
    meta = synthwsss.make_dataset(str(tmp_path / "ours"), **kw)
    assert meta == jax_synth.make_dataset(str(tmp_path / "ref"), **kw)
    ours, ref = _tree(tmp_path / "ours"), _tree(tmp_path / "ref")
    assert sorted(ours) == sorted(ref) and len(ours) > 8
    for k, v in ref.items():
        if k.endswith(".npy"):  # a pickled dict: compare its arrays
            a = np.load(tmp_path / "ours" / k, allow_pickle=True).item()
            b = np.load(tmp_path / "ref" / k, allow_pickle=True).item()
            assert sorted(a) == sorted(b) and all((a[n] == b[n]).all() for n in b)
        else:
            assert ours[k] == v, k


def _optin_cfg(root, work, **kw):
    base = dict(backbone="vit_tiny_test", crop_size=64, batch_size=2, mixed_precision=False,
                flash_attention=False, data_root=root, split_dir=os.path.join(root, "splits"),
                max_iters=4, warmup_iters=1, eval_iters=2, log_iters=1, finalval=False,
                fasteval=True, fasteval_n=2, eval_scales=(1.0, 0.5), num_workers=2,
                energy_filter="lattice", usegmm=True, usepar=True, queue_update_ratio=2,
                gmm_em_iters=5, par_dilations=(1, 2), par_iters=2, work_dir=work)
    base.update(kw)
    return preset_config("VOC12", **base)


def test_make_synth_data_writes_a_voc_tree_with_class_names(tmp_path):
    root = str(tmp_path / "data")
    make_synth_data.main(["--root", root, "--n_train", "1", "--n_val", "1", "--seed", "3"])
    names = open(os.path.join(root, "splits", "voc", "class_names.txt")).read().split()
    assert names == synthwsss.class_names()
    assert sorted(os.listdir(os.path.join(root, "JPEGImages"))) == [
        "synth_0000000.jpg", "synth_1000000.jpg"]


def test_optin_training_resumes_exactly_and_scores_with_host_crfs(tmp_path):
    root = str(tmp_path / "data")
    synthwsss.make_dataset(root, n_train=8, n_val=2, seed=3, size_range=(64, 96))
    path = str(tmp_path / "pre.pth")
    torch.save(make_state_dict(np.random.default_rng(4), num_classes=21), path)
    work = str(tmp_path / "work")
    straight = train(_optin_cfg(root, work, name="a", pretrained_path=path), device="cpu")
    ck = os.path.join(work, "a", "ckpt", "step_00000002.pt")
    resumed = train(_optin_cfg(root, work, name="b", pretrained_path=path, resume=ck),
                    device="cpu")
    recs = {r["iter"]: r for r in straight["records"]}
    assert [r["iter"] for r in resumed["records"]] == [3, 4]
    for r in resumed["records"]:
        for k in LOSS_KEYS + ("thre_low", "thre_high"):
            assert r[k] == recs[r["iter"]][k], (r["iter"], k)
    assert all(np.isfinite(r[k]) for r in recs.values() for k in LOSS_KEYS)
    assert recs[4]["reg_loss"] != 0.0
    low, high = recs[1]["thre_low"], recs[1]["thre_high"]
    assert 0.0 < low < high < 1.0 and (low, high) != (0.25, 0.7)

    for backend in ("native", "jax"):
        cli_evaluate.main(["a", "--dataset", "VOC12", "--backbone", "vit_tiny_test",
                           "--crop_size", "64", "--mixed_precision", "false",
                           "--flash_attention", "false", "--data_root", root,
                           "--split_dir", os.path.join(root, "splits"),
                           "--eval_scales", "1.0", "0.5", "--crf_backend", backend,
                           "--crf_reduce", "8", "--work_dir", work, "--device", "cpu"])
    finals = [json.loads(ln) for ln in open(os.path.join(work, "a", "metrics.jsonl"))]
    finals = [r for r in finals if r["kind"] == "final"]
    assert len(finals) == 2
    for r in finals:
        assert 0.0 <= r["Seg_crf"] <= 1.0 and r["images"] == 2 and r["crf_seconds"] > 0
