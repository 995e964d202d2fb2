"""The published runs as named presets: each is the exact argument list of
the JAX package's run script, handed to the port's training CLI.

Usage:
  python -m cosa_tpu_torch.cli.run_synth PRESET [NAME] [flags...]
  python -m cosa_tpu_torch.cli.run_synth synthrun
  python -m cosa_tpu_torch.cli.run_synth synthrun --max_iters 500 --finalval false
  python -m cosa_tpu_torch.cli.run_synth synthrun --work_dir /dev/shm/wd --device cuda
  python -m cosa_tpu_torch.cli.run_synth voc --data_root /data/VOC2012

Presets (the script each one copies):
  synthrun      scripts/run_synth.sh: ViT-B/16 + LargeFOV at 448, batch 4,
                from scratch on ShapesWSSS, 10k iterations, a validation
                every 500;
  synthrun_gmm  the same with --usegmm true;
  swinsynth     Swin-T swinend2end on the same data, a validation every
                1000, batch 2 (work_dirs/swinsynth_r4/print.out's config);
  synthcoco     scripts/run_synth_coco.sh: the 81-class COCO layout;
  gmmab_fixed,  scripts/run_gmm_ab.sh's two arms on the faded-foreground
  gmmab_gmm     ShapesWSSS (--fade 0.35 1.0), --usegmm false / true;
  voc, coco     scripts/run_voc.sh, scripts/run_coco.sh; these need
                --data_root.

A ShapesWSSS preset first writes its dataset (cli/make_synth_data.py, the
script's sizes and seed) at the run's data root when that holds no images.
NAME (default: the preset's run name) and every further flag go to
cli/train.py as the scripts pass "$@": a later flag overrides the preset's,
and --device and --work_dir pass through. With --finalval true (the
default) the run ends with finaleval.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

SYNTH = "work_dirs/synthdata"
FAINT = "work_dirs/synthdata_faint"
SYNTH_COCO = "work_dirs/synthdata_coco"


def _synth_flags(root: str, max_iters: int, warmup: int, eval_iters: int,
                 batch: Optional[int]) -> Tuple[str, ...]:
    """The flags the ShapesWSSS scripts share, in their order."""
    flags = ("--data_root", root, "--split_dir", f"{root}/splits", "--pretrained", "false",
             "--lr", "3e-4", "--max_iters", str(max_iters), "--warmup_iters", str(warmup),
             "--lr_warmup_iters", "500", "--warmup_gate_floor", "0.01",
             "--eval_iters", str(eval_iters))
    return flags + (("--batch_size", str(batch)) if batch else ())


@dataclass(frozen=True)
class Preset:
    name: str  # the run's default name
    flags: Tuple[str, ...]  # cli/train.py's flags after NAME
    # make_synth_data's flags after --root, or () for a dataset on disk
    data: Tuple[str, ...] = ()

    def marker(self, root: str) -> str:
        """The image directory whose absence means the dataset is missing."""
        return os.path.join(root, "train2014" if "coco" in self.data else "JPEGImages")


_SYNTH_DATA = ("--n_train", "3000", "--n_val", "200", "--seed", "0")
_VOC_SYNTH = ("--dataset", "VOC12") + _synth_flags(SYNTH, 10000, 1500, 500, 4)
_GMMAB = ("--dataset", "VOC12") + _synth_flags(FAINT, 6000, 1500, 500, 4)

PRESETS = {
    # scripts/run_synth.sh:18-33
    "synthrun": Preset("synthrun", _VOC_SYNTH, _SYNTH_DATA),
    "synthrun_gmm": Preset("synthrun_gmm", _VOC_SYNTH + ("--usegmm", "true"), _SYNTH_DATA),
    # work_dirs/swinsynth_r4/print.out:1, the config that run printed
    "swinsynth": Preset(
        "swinsynth",
        ("--dataset", "VOC12") + _synth_flags(SYNTH, 10000, 1500, 1000, None)
        + ("--model", "swinend2end", "--backbone", "swin-t"),
        _SYNTH_DATA),
    # scripts/run_synth_coco.sh:18-33
    "synthcoco": Preset(
        "synthcoco", ("--dataset", "COCO") + _synth_flags(SYNTH_COCO, 8000, 1200, 1000, 8),
        ("--layout", "coco", "--n_train", "6000", "--n_val", "200", "--seed", "0")),
    # scripts/run_gmm_ab.sh
    "gmmab_fixed": Preset("gmmab_fixed", _GMMAB + ("--usegmm", "false"),
                          _SYNTH_DATA + ("--fade", "0.35", "1.0")),
    "gmmab_gmm": Preset("gmmab_gmm", _GMMAB + ("--usegmm", "true"),
                        _SYNTH_DATA + ("--fade", "0.35", "1.0")),
    # scripts/run_voc.sh, scripts/run_coco.sh
    "voc": Preset("voc_cosa", ("--dataset", "VOC12", "--batch_size", "2", "--max_iters",
                               "32000", "--eval_iters", "4000", "--low_thre", "0.2")),
    "coco": Preset("coco_cosa", ("--dataset", "COCO", "--batch_size", "4")),
}


def train_argv(preset: str, name: Optional[str] = None, extra: Sequence[str] = ()):
    """cli/train.py's arguments for ``preset``: NAME, the preset's flags,
    then ``extra``."""
    p = PRESETS[preset]
    return [name or p.name, *p.flags, *extra]


def parse(argv: Sequence[str]):
    """(the preset, cli/train.py's arguments) of run_synth's ``argv``."""
    argv = list(argv)
    if not argv or argv[0] not in PRESETS:
        raise SystemExit(f"usage: run_synth PRESET [NAME] [flags...]; PRESET is one of "
                         f"{', '.join(PRESETS)}")
    rest = argv[1:]
    name = rest.pop(0) if rest and not rest[0].startswith("-") else None
    return PRESETS[argv[0]], train_argv(argv[0], name, rest)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from cosa_tpu_torch.cli import make_synth_data, train
    from cosa_tpu_torch.config import parse_cli

    preset, args = parse(sys.argv[1:] if argv is None else argv)
    cfg = parse_cli(train.split_device(args)[1])
    if not cfg.data_root:
        raise SystemExit(f"run_synth {preset.name}: pass --data_root")
    if preset.data and not os.path.isdir(preset.marker(cfg.data_root)):
        make_synth_data.main(["--root", cfg.data_root, *preset.data])
    train.main(args)


if __name__ == "__main__":
    main()
