"""Training CLI for the PyTorch port.

Usage:
  python -m cosa_tpu_torch.cli.train NAME --dataset synthetic --finalval false ...
  python -m cosa_tpu_torch.cli.train NAME ... --device cpu   # plain versions on the CPU

Flags are the config fields (cosa_tpu_torch/config.py). It runs on the GPU
unless ``--device`` names another device. The final evaluation is not
ported yet (ROADMAP Queue 1 item 8), so ``--finalval false`` is required.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from cosa_tpu_torch.config import parse_cli
    from cosa_tpu_torch.train.loop import train

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    ns, rest = pre.parse_known_args(argv)
    cfg = parse_cli(rest)
    if cfg.finalval:
        raise NotImplementedError(
            "finalval: the final evaluation is ROADMAP Queue 1 item 8; pass "
            "--finalval false"
        )
    train(cfg, device=ns.device)


if __name__ == "__main__":
    main()
