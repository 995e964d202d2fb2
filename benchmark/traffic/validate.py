"""Traffic generator ``validate``: whole validation passes of the program's
``eval/engine.py::evaluate`` over the student network, as the training
loop's ``_run_validation`` calls it (``eval_scales`` x flip, ``eval_batch``
images a batch, no CRF, the confusion matrices fetched once a pass).

Set-up writes a seeded ShapesWSSS tree of ``val_images`` images with masks,
at the configuration's image sizes, in its dataset's layout, under the
run's scratch directory (benchmark/frozen/synthwsss.py), builds the
network from the benchmark's weights and warms up on ``warmup_images``
images. In the window's first pass the generator keeps, for ``check_batches``
batches drawn from the seed, what ``_eval_batch`` produced: the confusion
matrices and the Seg_vd labels on the canvas. The check reads the same
files itself and runs the plain reference over those batches.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch
from PIL import Image
from torch.profiler import record_function

from benchmark import check, weights
from benchmark.frozen import synthwsss
from benchmark.reference.cosa import eval_batch
from benchmark.reference.model import Network, weight_shapes

SPANS = ("bench.call",)
# the tree's layout, image and mask directories and split of each dataset the cells use
LAYOUT = {"VOC12": ("voc", "JPEGImages", "SegmentationClassAug", "val")}


def write_tree(config: Dict, mix: Dict, seed: int, root: str) -> str:
    """The seeded val tree; returns its split directory."""
    layout = LAYOUT[config["config"]["dataset"]][0]
    synthwsss.make_dataset(root, n_train=0, n_val=mix["val_images"],
                           seed=weights.subseed(seed, 4),
                           size_range=tuple(config["data"]["image_size"]), layout=layout)
    return os.path.join(root, "splits")


def sampled_batches(mix: Dict, batch: int, seed: int) -> List[int]:
    n = math.ceil(mix["val_images"] / batch)
    rng = np.random.default_rng(weights.subseed(seed, 5))
    return sorted(int(i) for i in rng.choice(n, size=min(mix["check_batches"], n), replace=False))


def read_samples(config: Dict, root: str, batch_no: int) -> List[Dict]:
    """The reference's own read of one batch's raw files: images, masks and
    the image-level labels the tree's label file holds."""
    layout, img_dir, seg_dir, split = LAYOUT[config["config"]["dataset"]]
    with open(os.path.join(root, "splits", layout, split + ".txt")) as f:
        names = f.read().split()
    labels = np.load(os.path.join(root, "splits", layout, "cls_labels_onehot.npy"),
                     allow_pickle=True).item()  # written by this run's own generator
    b = config["config"]["eval_batch"]
    out = []
    for name in names[batch_no * b:(batch_no + 1) * b]:
        image = np.asarray(Image.open(os.path.join(root, img_dir, name + ".jpg")).convert("RGB"))
        label = np.asarray(Image.open(os.path.join(root, seg_dir, name + ".png")))
        out.append(dict(name=name, image=image, label=label, cls_label=labels[name]))
    return out


def reference_batches(config: Dict, root: str, batches: List[int], seed: int, device,
                      precision: str) -> List[Dict]:
    c = {**config["config"], "eval_canvas": config["data"]["eval_canvas"]}
    net = Network(config["widths"], c["num_classes"], c["aux_layer"], precision)
    w, _ = weights.network_weights(weight_shapes(config["widths"], c["num_classes"]), seed,
                                   device)
    out = []
    with check.exact_f32():
        for k in batches:
            samples = read_samples(config, root, k)
            res = eval_batch(c, net, w, samples, device)
            valid = torch.zeros(res["seg_vd"].shape[:3], dtype=torch.bool, device=device)
            for i, s in enumerate(samples):
                valid[i, :s["image"].shape[0], :s["image"].shape[1]] = True
            res.update(valid=valid, labels=torch.argmax(res["seg_vd"], dim=-1))
            out.append(res)
    return out


class ValWorkload:
    spans = SPANS

    def __init__(self, ctx):
        import cosa_tpu_torch.data.loader as port_loader
        import cosa_tpu_torch.eval.engine as port_engine
        import cosa_tpu_torch.models.network as port_network

        self.ctx, self.mix = ctx, ctx.traffic
        self.engine = port_engine
        c, dev = ctx.config["config"], ctx.device
        self.root = os.path.join(ctx.tmpdir, "val")
        split_dir = write_tree(ctx.config, self.mix, ctx.seed, self.root)
        ctx.setup_marks.mark("inputs")
        self.cfg = ctx.port_config(data_root=self.root, split_dir=split_dir)
        self.model = port_network.build_model(self.cfg, dev)
        ctx.setup_marks.mark("build_model")
        student, _ = weights.network_weights(weight_shapes(ctx.config["widths"], c["num_classes"]),
                                             ctx.seed, dev)
        self.model.load_state_dict(student)
        del student
        ctx.setup_marks.mark("weights")
        self.val_ds = port_loader.build_val_dataset(self.cfg)
        self.sample = sampled_batches(self.mix, c["eval_batch"], ctx.seed)
        self.recorded: Dict[int, Dict] = {}
        self.passes = 0
        self.batch_no = 0
        self.tracing = False
        self._orig = port_engine._eval_batch
        port_engine._eval_batch = self._eval_batch
        port_engine.evaluate(self.cfg, self.model, self.val_ds,
                             max_images=self.mix["warmup_images"], device=dev)
        ctx.setup_marks.mark("warmup")

    def _eval_batch(self, cfg, model, samples, pad, thresholds, getcrf, dev, return_maps=False):
        """The program's batch path; in the window's first pass it also keeps
        the sampled batches' confusion matrices and Seg_vd labels."""
        k, self.batch_no = self.batch_no, self.batch_no + 1
        if self.passes != 1 or self.tracing or k not in self.sample:
            return self._orig(cfg, model, samples, pad, thresholds, getcrf, dev, return_maps)
        hists, probs, probs_aux, crf_s, maps = self._orig(
            cfg, model, samples, pad, thresholds, getcrf, dev, return_maps=True)
        self.recorded[k] = dict(hists=hists.clone(), labels=maps["seg_vd"].to(torch.uint8))
        return hists, probs, probs_aux, crf_s, maps if return_maps else None

    def call(self) -> int:
        self.passes += 1
        self.batch_no = 0
        with record_function("bench.call"):
            self.engine.evaluate(self.cfg, self.model, self.val_ds, device=self.ctx.device)
        return len(self.val_ds)

    def trace_call(self) -> int:
        self.batch_no, self.tracing = 0, True
        with record_function("bench.call"):
            self.engine.evaluate(self.cfg, self.model, self.val_ds,
                                 max_images=self.mix["trace_images"], device=self.ctx.device)
        return self.mix["trace_images"]

    @property
    def trace_units(self) -> int:
        return self.mix["trace_calls"]

    def attempted(self, window: Dict) -> int:
        return window["images"]

    def check(self) -> Dict[str, float]:
        self.engine._eval_batch = self._orig
        self.model = None
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prog = [self.recorded[k] for k in self.sample if k in self.recorded]
        ref = reference_batches(self.ctx.config, self.root, self.sample, self.ctx.seed, dev, "f32")
        if len(prog) != len(ref):
            return dict(hist_gap=float("inf"), seg_gap=float("inf"))
        return check.eval_numbers(prog, ref)


def control_numbers(ctx) -> Dict[str, Dict[str, float]]:
    """The control (the reference in float8 operands) put in the program's
    place over the sampled batches of a tree written as a run writes it."""
    root = os.path.join(ctx.tmpdir, "val")
    write_tree(ctx.config, ctx.traffic, ctx.seed, root)
    sample = sampled_batches(ctx.traffic, ctx.config["config"]["eval_batch"], ctx.seed)
    ref = reference_batches(ctx.config, root, sample, ctx.seed, ctx.device, "f32")
    ctl = reference_batches(ctx.config, root, sample, ctx.seed, ctx.device, "fp8")
    return dict(control=check.eval_numbers(
        [dict(hists=r["hists"], labels=r["labels"]) for r in ctl], ref))


def build(ctx) -> ValWorkload:
    return ValWorkload(ctx)
