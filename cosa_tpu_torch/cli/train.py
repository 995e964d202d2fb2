"""Training CLI for the PyTorch port.

Usage:
  python -m cosa_tpu_torch.cli.train NAME --dataset synthetic ...
  python -m cosa_tpu_torch.cli.train NAME ... --resume work_dirs/NAME/ckpt
  python -m cosa_tpu_torch.cli.train NAME ... --device cpu   # plain versions on the CPU

Flags are the config fields (cosa_tpu_torch/config.py). It runs on the GPU
unless ``--device`` names another device. Validation and checkpoints come
every ``--eval_iters`` steps; with ``--finalval true`` (the default) the
run's best-seg weights are scored with the DenseCRF after training.
"""

from __future__ import annotations

import argparse


def split_device(argv=None):
    """(--device value or None, the remaining arguments)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    ns, rest = pre.parse_known_args(argv)
    return ns.device, rest


def main(argv=None) -> None:
    from cosa_tpu_torch.config import parse_cli
    from cosa_tpu_torch.train.loop import finaleval, train

    device, rest = split_device(argv)
    cfg = parse_cli(rest)
    train(cfg, device=device)
    if cfg.finalval:
        finaleval(cfg, device=device)


if __name__ == "__main__":
    main()
