"""Evaluation CLI for the PyTorch port (reference finaleval, main.py:401-433).

Usage:
  python -m cosa_tpu_torch.cli.evaluate NAME --dataset synthetic [--device cpu]
  python -m cosa_tpu_torch.cli.evaluate NAME ... --pretrained_path best_seg.pth

Scores the run's best-seg weights (``{work_dir}/NAME/best_seg``), or a
reference-key torch checkpoint, on the full val split with the DenseCRF
(``--crf_reduce`` sets its resolution). It runs on the GPU unless
``--device`` names another device.
"""

from __future__ import annotations


def main(argv=None) -> None:
    from cosa_tpu_torch.cli.train import split_device
    from cosa_tpu_torch.config import parse_cli
    from cosa_tpu_torch.train.loop import finaleval

    device, rest = split_device(argv)
    finaleval(parse_cli(rest), device=device)


if __name__ == "__main__":
    main()
