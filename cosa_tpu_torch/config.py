"""Configuration system: one dataclass + per-dataset preset overlays.

The port's own copy of the JAX package's config (same fields, presets and
CLI), with the TPU knobs mapped to one GPU. It imports only the stdlib.

Mirrors the semantics of the reference's twin flag modules (args.py /
args_coco.py in the upstream CoSA code: a ``default_args`` dict + argparse parser +
``handle_defaults`` merge, args.py:3-190) with a single source of truth.
The "changed arguments" echo of the reference (args.py:168-180) is kept via
:func:`diff_from_preset`.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass
class Config:
    # ---- model ----------------------------------------------------------
    # reference: args.py:4-13
    model: str = "vit"
    backbone: str = "vit_base_patch16_224"
    decoder: str = "LargeFOV"  # LargeFOV | Maskformer
    pretrained: bool = True
    pretrained_path: str = ""  # path to a converted (or torch) checkpoint
    freeze_norm: bool = False
    aux_layer: int = -3
    isgap: bool = False  # False -> global max pool cls heads (args.py:13)

    # ---- misc -----------------------------------------------------------
    # reference: args.py:15-24
    finalval: bool = True
    seed: int = 0
    # draw a fresh seed at train start (reference main.py:33). Resolved in
    # train/loop.py via a one-to-all broadcast so every process agrees (the
    # reference's per-rank random.randint would desync a pure-SPMD init).
    random_seed: bool = False
    work_dir: str = "work_dirs"
    name: str = "cosa"
    output_dir: str = ""
    eval_iters: int = 2000
    log_iters: int = 20  # reference hard-codes 20 (main.py:269)
    fasteval: bool = False
    fasteval_n: int = 200  # seeded-random subset size when fasteval is on
    valfull: bool = False
    eval_threshold_filters: Optional[Tuple[float, ...]] = None
    # dump raw fused CAMs (npy per image) during validations + finaleval
    # (reference turnon_rawcam, main.py:338,422 -> save_cam_npv2)
    turnon_rawcam: bool = False
    eval_batch: int = 8  # val images per compiled eval call (reference: 1)
    # final-eval split: "val" scores like reference finaleval (main.py:414);
    # "test" runs the GT-less VOC test split and dumps eval-server PNGs
    eval_split: str = "val"

    # ---- data -----------------------------------------------------------
    # reference: args.py:26-35
    dataset: str = "VOC12"  # VOC12 | COCO | synthetic
    crop_size: int = 448
    scales: Tuple[float, float] = (0.5, 2.0)
    ignore_index: int = 255
    num_classes: int = 21
    data_root: str = ""  # voc12_root / coco_root
    # override directory for split lists + label dicts (default: the lists
    # kept beside the JAX package in cosa_tpu/data/splits, reused from the reference's
    # dataloaders/{voc,coco}/*.txt). Useful for subset runs and custom data.
    split_dir: str = ""
    batch_size: int = 2  # per-device batch (reference: per-GPU, args.py:34)
    num_workers: int = 4

    # ---- train ----------------------------------------------------------
    # reference: args.py:37-78
    max_iters: int = 40000
    warmup_iters: int = 6000  # loss-gating warmup (main.py:240)
    # tiny always-on weight for the gated (seg/cam/reg) losses DURING warmup.
    # 0.0 = reference parity (hard zero gate). A small floor (e.g. 0.01)
    # keeps Adam's second moments calibrated for the decoder throughout
    # warmup; with a hard gate those moments are empty, and the first
    # post-gate update is a coordinated +-lr*lrscale sign-kick that can
    # permanently kill the bias-free LargeFOV ReLUs (observed: from-scratch
    # ShapesWSSS run, seg_loss frozen at log(21) from iter 1500 on).
    warmup_gate_floor: float = 0.0
    lr_warmup_iters: int = 1500  # optimizer LR warmup (main.py:67)
    # 'poly_adamw' = the live PolyWarmupAdamW; the others are the
    # reference's unused constructors (utils/torch_helper.py:228-358)
    optimizer: str = "poly_adamw"
    lr: float = 6e-5
    lrscale: float = 10.0  # head/decoder LR multiplier (args.py:123)
    min_mult: float = 0.0
    wt_dec: float = 1e-2
    wt_dec_mult: float = 1.0
    momentum: float = 0.9994  # EMA teacher momentum (args.py:45)
    seg_weight: float = 0.1
    segfg_alpha: float = 0.5
    cam_weight: float = 0.05
    camloss_version: str = "v1"
    segconf_thre: float = 0.25
    seg_softmaxtemp: float = 0.01
    reg_weight: float = 0.05
    pseudo_scales: Tuple[float, ...] = (1.0, 0.5, 1.5)
    eval_scales: Tuple[float, ...] = (1.0, 0.5, 1.5, 0.75, 1.25)
    high_thre: float = 0.7
    high_thre_aux: float = 0.7
    bkg_thre: float = 0.5
    low_thre: float = 0.25
    low_thre_aux: float = 0.25
    usegmm: bool = False
    # separate GMM gate for the aux head (reference args.py:60 declares
    # usegmmaux but never consumes it — main.py:174 reuses usegmm for both
    # heads; here the flag is real). None = follow usegmm (reference-parity
    # behavior); True/False = gate the aux head's thresholds independently.
    usegmmaux: Optional[bool] = None
    gmmscale: int = 16
    gmmfilter_thre: float = 0.05
    gmmemadecay: float = 0.99
    gmm_em_iters: int = 100  # fixed EM iterations (sklearn's tol-loop is host-bound)
    # measured (ops/gmm.py): fitting the mixture on every 8th queue point
    # then assigning the full queue changes thresholds <2e-3 and cuts the
    # GMM step cost ~7x. CUTTING ITERATIONS instead is NOT safe (10/25-iter
    # EMA trajectories deviate 0.17/0.09 vs sklearn).
    gmm_em_subsample: int = 8
    queue_update_ratio: int = 100
    par_downscale: int = 2
    usepar: bool = False
    par_dilations: Tuple[int, ...] = (1, 2, 4, 8, 12, 24)
    par_iters: int = 10
    aux_cam2seg: bool = True
    aux_cam2seg_alpha: float = 0.5
    aux_seg2cam: bool = False
    aux_seg2cam_alpha: float = 0.5
    after_softmax: bool = False
    detach: str = "none"  # all | feat | none | cls
    use_cammix: bool = False

    # ---- dense-energy regularizer ---------------------------------------
    # reference: main.py:77 (weight 1e-7, sigma_rgb 15, sigma_xy 100, scale .5)
    energy_weight: float = 1e-7
    energy_sigma_rgb: float = 15.0
    energy_sigma_xy: float = 100.0
    energy_scale: float = 0.5
    energy_filter: str = "rff"  # rff (fast default) | lattice (exact, trains) | exact (fused, test-only)
    energy_rff_features: int = 1024
    # rff->lattice energy rescale. 0.0 = auto-calibrate at train start on the
    # first real batch at the actual energy resolution (the ratio is
    # shape-dependent, objectives/energy.py::resolve_energy_convention);
    # a positive value is used as-is (reproducing a previous run's log).
    energy_convention: float = 0.0

    # ---- eval-time CRF ---------------------------------------------------
    # reference: utils/seg_helper.py:989-996
    crf_iter: int = 1
    crf_pos_w: float = 1.0
    crf_pos_xy: float = 1.0
    crf_bi_w: float = 4.0
    crf_bi_xy: float = 121.0
    crf_bi_rgb: float = 5.0
    crf_reduce: int = 2  # exact-transform resolution divisor (device path)
    # "device": exact-Gaussian mean-field on the device at 1/crf_reduce
    #   resolution of the evaluation canvas (eval/crf.py); the probabilities
    #   never leave the device.
    # "native": the host C++ lattice at full resolution, one image at a time;
    # "jax" (the JAX package's name): the single-image mean-field on the
    #   device, the permutohedral lattice when crf_reduce is 1.
    crf_backend: str = "device"

    # ---- device knobs (the JAX package's TPU section, mapped to one GPU) --
    mixed_precision: bool = True  # bf16 activations/matmuls, f32 params and optimizer state
    # True: attention runs the hand-written CUDA kernels on a GPU
    # (kernels/flash.py). False: the plain softmax(QK^T)V in PyTorch ops —
    # an explicit choice, as it selects the einsum path in the JAX package,
    # never a fallback. On a CPU tensor both take the plain version.
    flash_attention: bool = True
    # int8 projections in the no-grad teacher's TTA (models/quant.py), at
    # the scales whose min(h', w') >= teacher_int8_min_size; ViT only
    teacher_int8: bool = False
    teacher_int8_min_size: int = 512
    # the (data, model) layout of a multi-process run (parallel/mesh.py):
    # dp = -1 takes every rank tp leaves; batch_size is per data rank
    dp: int = -1
    tp: int = 1
    # buffer donation is a jit notion; eager PyTorch frees what it no longer
    # references, so the flag has no meaning here and is kept for CLI parity
    donate: bool = True
    checkpoint_keep: int = 2
    # a checkpoint file, or a checkpoint directory (its newest step), to
    # continue training from (train/checkpoint.py)
    resume: str = ""
    profile_dir: str = ""  # rank 0's torch.profiler chrome trace goes here

    # ---- derived ---------------------------------------------------------
    def validate(self) -> "Config":
        # 'vit' is the live pipeline; the rest mirror the reference's
        # commented zoo branches (models/__init__.py:25-75) + 'segformer'
        assert self.model in (
            "vit", "res38", "mmseg", "swinend2end", "segformer"
        ), self.model
        assert self.decoder in ("LargeFOV", "Maskformer"), self.decoder
        assert self.optimizer in (
            "poly_adamw", "cos_adamw", "poly_sgd", "poly_cls_sgd"
        ), self.optimizer
        assert self.detach in ("all", "feat", "none", "cls"), self.detach
        assert self.camloss_version in ("v1", "v2", "v3"), self.camloss_version
        assert 1.0 in self.pseudo_scales, "scale 1.0 must be in pseudo_scales"
        assert 0.0 <= self.segfg_alpha <= 1.0
        assert self.energy_filter in ("rff", "lattice", "exact")
        assert self.eval_split in ("val", "test"), self.eval_split
        assert self.crf_backend in ("device", "native", "jax")
        if self.teacher_int8 and self.model != "vit":
            raise NotImplementedError("teacher_int8: the int8 teacher twin is ViT-only")
        return self

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw).validate()


# Per-dataset presets. COCO deltas per reference args_coco.py (diff vs args.py):
# eval_iters 6000, num_classes 81, batch 4, max_iters 60000, warmup 10000,
# high_thre 0.65.
PRESETS: Dict[str, Dict[str, Any]] = {
    "VOC12": {},
    "COCO": dict(
        dataset="COCO",
        eval_iters=6000,
        num_classes=81,
        batch_size=4,
        max_iters=60000,
        warmup_iters=10000,
        high_thre=0.65,
    ),
    # tiny synthetic preset for smoke tests / dry runs
    "synthetic": dict(
        dataset="synthetic",
        crop_size=64,
        num_classes=21,
        batch_size=2,
        max_iters=20,
        warmup_iters=5,
        lr_warmup_iters=5,
        eval_iters=10,
    ),
}


def voc_config(**overrides: Any) -> Config:
    return Config(**{**PRESETS["VOC12"], **overrides}).validate()


def coco_config(**overrides: Any) -> Config:
    return Config(**{**PRESETS["COCO"], **overrides}).validate()


def preset_config(dataset: str, **overrides: Any) -> Config:
    return Config(**{**PRESETS[dataset], **overrides}).validate()


def diff_from_preset(cfg: Config) -> Dict[str, Any]:
    """Report fields differing from the dataset preset (the reference's
    'Changed arguments' echo, args.py:168-180)."""
    base = Config(**PRESETS.get(cfg.dataset, {}))
    out = {}
    for f in dataclasses.fields(Config):
        a, b = getattr(cfg, f.name), getattr(base, f.name)
        if a != b and f.name != "dataset":
            out[f.name] = a
    return out


def _add_args(parser: argparse.ArgumentParser) -> None:
    def str2bool(v: str) -> bool:  # reference args.py:182-190
        if isinstance(v, bool):
            return v
        if v.lower() in ("yes", "true", "t", "y", "1"):
            return True
        if v.lower() in ("no", "false", "f", "n", "0"):
            return False
        raise argparse.ArgumentTypeError("Boolean value expected.")

    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.type in ("bool", bool) or "Optional[bool]" in str(f.type):
            parser.add_argument(name, type=str2bool, default=None)
        elif f.type in ("int", int):
            parser.add_argument(name, type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(name, type=float, default=None)
        elif "Tuple[float" in str(f.type):
            parser.add_argument(name, type=float, nargs="+", default=None)
        elif "Tuple[int" in str(f.type):
            parser.add_argument(name, type=int, nargs="+", default=None)
        else:
            parser.add_argument(name, type=str, default=None)


def parse_cli(argv: Optional[Sequence[str]] = None) -> Config:
    """CLI entry mirroring reference main.py:435-454 (dataset re-dispatch)."""
    parser = argparse.ArgumentParser("CoSA (PyTorch) weakly-supervised segmentation")
    parser.add_argument("name", type=str, nargs="?", default="cosa")
    _add_args(parser)
    ns = parser.parse_args(argv)
    dataset = ns.dataset or "VOC12"
    overrides = {
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in vars(ns).items()
        if v is not None and k not in ("name", "dataset")
    }
    cfg = preset_config(dataset, **overrides)
    cfg = cfg.replace(name=ns.name)
    return cfg
