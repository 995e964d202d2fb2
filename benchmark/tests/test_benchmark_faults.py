"""A run of each cell at a small size on the CPU, with the chip's look
skipped: sound, it ends in one well-formed line; with the timed path broken
underneath, ``correct`` comes out false. The faults are those each cell can
have: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest: the rows dropped before the forward, or the
losses taken over half of a whole forward), an update taken the wrong way,
and an answer altered where it is produced (the student's logits, the
teacher's TTA, a pseudo mask)."""

import json

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import OVERRIDES

SEED = 2 ** 31 + 12345  # more than 32 signed bits, as the checks' seeds are


def _run(cell, trace=False, **extra):
    over = json.loads(json.dumps(OVERRIDES[cell]))
    for k, v in extra.items():
        over.setdefault(k, {}).update(v)
    return run_cell(cell, SEED, 0.3, trace, "cpu", over)


@pytest.mark.parametrize("cell", ["voc.train_staged", "voc.val_tta"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_rehearsal_ends_in_one_well_formed_line(cell, trace):
    line = _run(cell, trace)
    json.dumps(line)
    assert set(line.pop("numbers")) >= set(line["checks"]) and line.pop("setup")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"  # no device metric
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert line["correct"] is True


def _half_batch_step(monkeypatch):
    import cosa_tpu_torch.train.step as port_step

    build = port_step.build_train_step

    def broken(cfg, mesh=None):
        step = build(cfg, mesh)
        return lambda state, batch: step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(port_step, "build_train_step", broken)


def _frozen_state(monkeypatch):
    import cosa_tpu_torch.train.optimizer as port_opt
    import cosa_tpu_torch.train.step as port_step

    monkeypatch.setattr(port_opt.GroupOptimizer, "step", lambda self, step: None)
    monkeypatch.setattr(port_step, "ema_update", lambda *a: None)


def _altered_logits(monkeypatch):
    import cosa_tpu_torch.models.network as port_network

    heads = port_network.cosa_heads

    def altered(*a, **k):
        out = heads(*a, **k)
        return dict(out, cls=1.05 * out["cls"])

    monkeypatch.setattr(port_network, "cosa_heads", altered)


def _half_loss(monkeypatch):
    """The forward whole, every loss taken over the first half of the batch."""
    import cosa_tpu_torch.train.step as port_step

    def first_half(fn):
        return lambda x, *a, **k: fn(x[:x.shape[0] // 2],
                                     *(t[:t.shape[0] // 2] if torch.is_tensor(t) else t
                                       for t in a), **k)

    for name in ("multilabel_soft_margin", "seg_loss", "cam_loss_v1", "get_energy_loss"):
        monkeypatch.setattr(port_step, name, first_half(getattr(port_step, name)))


def _flipped_update(monkeypatch):
    """Each optimizer step applied in the opposite direction."""
    import cosa_tpu_torch.train.optimizer as port_opt

    step = port_opt.GroupOptimizer.step

    def flipped(self, i):
        params = [p for g in self.opt.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        step(self, i)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.mul_(-1).add_(b, alpha=2.0)

    monkeypatch.setattr(port_opt.GroupOptimizer, "step", flipped)


def _altered_tta(monkeypatch):
    """The teacher's TTA without its last scale."""
    import cosa_tpu_torch.train.step as port_step

    tta = port_step.multi_scale_camseg
    monkeypatch.setattr(port_step, "multi_scale_camseg",
                        lambda fwd, x, scales, **k: tta(fwd, x, scales[:-1], **k))


def _altered_mask(monkeypatch):
    """The main head's pseudo masks cut at the low threshold alone."""
    import cosa_tpu_torch.train.step as port_step

    mask = port_step.cam2mask
    monkeypatch.setattr(port_step, "cam2mask",
                        lambda **k: mask(**dict(k, threshold_high=k["threshold_low"])))


def _altered_labels(monkeypatch):
    import cosa_tpu_torch.eval.engine as port_engine

    validate = port_engine.seg_validation
    monkeypatch.setattr(port_engine, "seg_validation",
                        lambda seg, cls: torch.roll(validate(seg, cls), 1, dims=-1))


def _half_eval_batch(monkeypatch):
    """Half of each batch left out: its first half scored twice in its place."""
    import cosa_tpu_torch.eval.engine as port_engine

    batch = port_engine._eval_batch

    def half(cfg, model, samples, *a, **k):
        kept = samples[:max(1, len(samples) // 2)]
        return batch(cfg, model, (kept * 2)[:len(samples)], *a, **k)

    monkeypatch.setattr(port_engine, "_eval_batch", half)


@pytest.mark.parametrize("cell,fault", [
    ("voc.train_staged", _frozen_state),
    ("voc.train_staged", _half_batch_step),
    ("voc.train_staged", _half_loss),
    ("voc.train_staged", _flipped_update),
    ("voc.train_staged", _altered_logits),
    ("voc.train_staged", _altered_tta),
    ("voc.train_staged", _altered_mask),
    ("voc.val_tta", _altered_labels),
    ("voc.val_tta", _half_eval_batch),
])
def test_a_broken_timed_path_reads_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(cell)["correct"] is False
