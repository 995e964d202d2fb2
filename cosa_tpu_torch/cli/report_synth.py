"""Post-run report for a ShapesWSSS learning-dynamics run (the twin of the
JAX package's scripts/report_synth.py).

Prints a markdown trajectory table from metrics.jsonl (CAM/Seg mIoU per
validation, both networks), the best-checkpoint bookkeeping and the final
evaluation's table from print.out, and with ``--panels N`` dumps
qualitative prediction panels for N val images (the evaluation's seeded
subset) from the run's best_seg weights (eval/engine.py's ``save_dir``),
on the GPU unless ``--device`` names another device.

Usage:
  python -m cosa_tpu_torch.cli.report_synth --out_dir work_dirs/synthrun \
      --data_root work_dirs/synthdata [--panels 6] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split_dir", default="")
    ap.add_argument("--panels", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    rows = []
    with open(os.path.join(args.out_dir, "metrics.jsonl")) as f:
        for ln in f:
            r = json.loads(ln)
            if r.get("kind") == "val":
                rows.append(r)

    by_iter = {}
    for r in rows:
        by_iter.setdefault(r["iter"], {})[r["model"]] = r
    print("| iter | ON CAM | ON Seg | AN CAM | AN Seg |")
    print("|---|---|---|---|---|")
    for it in sorted(by_iter):
        d = by_iter[it]
        f = lambda m, k: f"{100*d[m][k]:.1f}" if m in d else "-"
        print(f"| {it} | {f('ON','CAM')} | {f('ON','Seg_vd')} | "
              f"{f('AN','CAM')} | {f('AN','Seg_vd')} |")

    # final lines from print.out (best bookkeeping + finaleval tables)
    po = os.path.join(args.out_dir, "print.out")
    if os.path.exists(po):
        with open(po) as f:
            lines = f.read().splitlines()
        for ln in lines:
            if "Best val" in ln or "Final Model Result" in ln:
                print("\n" + ln)

    if args.panels:
        from cosa_tpu_torch.config import voc_config
        from cosa_tpu_torch.data.loader import build_val_dataset
        from cosa_tpu_torch.eval.engine import evaluate
        from cosa_tpu_torch.models.network import build_model
        from cosa_tpu_torch.train import checkpoint as ckpt
        from cosa_tpu_torch.utils.device import resolve_device

        cfg = voc_config(
            data_root=args.data_root,
            split_dir=args.split_dir or os.path.join(args.data_root, "splits"),
            pretrained=False, lr=args.lr,
        )
        dev = resolve_device(args.device)
        model = ckpt.load_best(args.out_dir, "seg", build_model(cfg, dev))
        ds = build_val_dataset(cfg)
        save_dir = os.path.join(args.out_dir, "qualitative")
        res = evaluate(cfg, model, ds, max_images=args.panels, save_dir=save_dir, device=dev)
        print(f"\nqualitative panels -> {save_dir} "
              f"(subset Seg_vd {100*res['Seg_vd']['miou']:.1f})")


if __name__ == "__main__":
    main()
