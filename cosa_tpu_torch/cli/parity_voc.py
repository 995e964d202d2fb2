"""One-command VOC accuracy-parity harness (the twin of the JAX package's
scripts/parity_voc.py).

Given a VOC2012 root and the released reference checkpoint, runs the full
finaleval (1449-image val split, 5-scale+flip TTA, CRF) and diffs every
per-class IoU against the pinned table from the released training log
(voc_expected_final.json beside this file, the reference's
assets/logs/voc_log.txt:723). Exit code 0 when every entry is within its
tolerance, 1 otherwise. It runs on the GPU unless ``--device`` names
another device.

Usage:
  VOC_ROOT=/data/VOC2012 python -m cosa_tpu_torch.cli.parity_voc /path/to/voc_weights.pth

Released 76.2-mIoU VOC weights (reference README.md:132):
  https://github.com/youshyee/CoSA/releases/download/weight_release/voc_weights.pth
VOC data:
  http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCtrainval_11-May-2012.tar
  https://github.com/youshyee/CoSA/releases/download/ann_voc/SegmentationClassAug.zip

Options:
  --tol       per-class IoU tolerance in points (default 1.0 — TTA resize
              kernels and bf16/f32 differences cost fractions of a point)
  --miou_tol  mIoU tolerance in points (default 0.5)
  --decoder   LargeFOV (default) | Maskformer
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "voc_expected_final.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--voc_root", default=os.environ.get("VOC_ROOT", ""))
    ap.add_argument("--tol", type=float, default=1.0)
    ap.add_argument("--miou_tol", type=float, default=0.5)
    ap.add_argument("--decoder", default="LargeFOV")
    ap.add_argument("--work_dir", default="work_dirs")
    ap.add_argument("--split_dir", default="")  # custom split lists (testing)
    ap.add_argument("--backbone", default="vit_base_patch16_224")
    ap.add_argument("--crop_size", type=int, default=448)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if not args.voc_root:
        ap.error("set VOC_ROOT or pass --voc_root")

    from cosa_tpu_torch.config import voc_config
    from cosa_tpu_torch.data.datasets import VOC_CLASSES
    from cosa_tpu_torch.train.loop import finaleval

    cfg = voc_config(
        name="parity_voc",
        work_dir=args.work_dir,
        data_root=args.voc_root,
        pretrained_path=args.checkpoint,
        decoder=args.decoder,
        split_dir=args.split_dir,
        backbone=args.backbone,
        crop_size=args.crop_size,
    )
    res = finaleval(cfg, device=args.device)

    with open(EXPECTED) as f:
        expected = json.load(f)

    failures = []
    for family in ("Seg_vd", "Seg_crf"):
        got = res[family]
        exp = expected[family]
        print(f"\n== {family} (ours vs released voc_log.txt) ==")
        for ci, name in enumerate(VOC_CLASSES):
            ours = 100.0 * float(got["iou"][ci])
            ref = exp[name]
            d = ours - ref
            flag = "" if abs(d) <= args.tol else "  <-- DIVERGES"
            print(f"{name:14s} {ours:7.2f}  ref {ref:7.2f}  diff {d:+6.2f}{flag}")
            if abs(d) > args.tol:
                failures.append((family, name, ours, ref))
        miou = 100.0 * float(got["miou"])
        d = miou - exp["mIoU"]
        flag = "" if abs(d) <= args.miou_tol else "  <-- DIVERGES"
        print(f"{'mIoU':14s} {miou:7.2f}  ref {exp['mIoU']:7.2f}  diff {d:+6.2f}{flag}")
        if abs(d) > args.miou_tol:
            failures.append((family, "mIoU", miou, exp["mIoU"]))

    if failures:
        print(f"\nPARITY FAIL: {len(failures)} entries outside tolerance")
        return 1
    print("\nPARITY OK: all per-class IoUs within tolerance of the released log")
    return 0


if __name__ == "__main__":
    sys.exit(main())
