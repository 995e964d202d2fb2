"""Pseudo-label generation CLI for the PyTorch port.

Usage:
  python -m cosa_tpu_torch.cli.make_pseudo my_run --dataset VOC12 --data_root ... \\
      [--pretrained_path best_seg.pth] [--usepar true] [--use_crf] [--device cpu]

Writes palette-PNG pseudo masks and raw CAM ``.npy`` files of the val split
under ``{work_dir}/{name}/pseudo/`` and prints the pseudo masks' scores.
``--pretrained_path`` is a reference-key ``.pth`` (a CoSA ``best_seg.pth``).
``--use_crf`` refines each mask with the DenseCRF on the host; under the
default ``--crf_backend device`` that is the port's native C++ lattice. It
runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    from cosa_tpu_torch.cli.train import split_device
    from cosa_tpu_torch.config import parse_cli
    from cosa_tpu_torch.data.loader import build_val_dataset
    from cosa_tpu_torch.eval.pseudo_pipeline import generate_pseudo_labels
    from cosa_tpu_torch.models.convert import load_torch_checkpoint
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.train.loop import output_dir

    device, rest = split_device(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--use_crf", action="store_true")
    ns, rest = pre.parse_known_args(rest)
    cfg = parse_cli(rest)
    model = build_model(cfg, device)
    if cfg.pretrained_path:
        model.load_state_dict(load_torch_checkpoint(cfg.pretrained_path))
    if ns.use_crf:
        where = ("the native C++ lattice on the host" if cfg.crf_backend in ("device", "native")
                 else "the single-image mean-field on the device")
        print(f"CRF: crf_backend {cfg.crf_backend!r} runs {where}")
    out = os.path.join(output_dir(cfg), "pseudo")
    res = generate_pseudo_labels(cfg, model, build_val_dataset(cfg), out,
                                 use_crf=ns.use_crf, device=device)
    print({k: (round(float(v), 4) if isinstance(v, float) else "...") for k, v in res.items()
           if k != "iou"})


if __name__ == "__main__":
    main()
