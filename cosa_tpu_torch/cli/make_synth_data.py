"""Write a ShapesWSSS tree (cosa_tpu_torch/data/synthwsss.py) for the port.

Usage:
  python -m cosa_tpu_torch.cli.make_synth_data --root work_dirs/synthdata \
      --n_train 3000 --n_val 200 --seed 0
  python -m cosa_tpu_torch.cli.train synthrun --dataset VOC12 \
      --data_root work_dirs/synthdata --split_dir work_dirs/synthdata/splits \
      --pretrained false ...

``--layout coco`` writes the 80-class COCO layout instead. The class names go
to ``{root}/splits/{layout}/class_names.txt``, which the datasets read for
their tables. Prints the dataset's meta as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> None:
    from cosa_tpu_torch.data.synthwsss import class_names, make_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--layout", choices=("voc", "coco"), default="voc")
    ap.add_argument("--n_train", type=int, default=3000)
    ap.add_argument("--n_val", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jpeg_quality", type=int, default=92)
    ap.add_argument("--fade", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                    help="per-image foreground fade factor ~ U(LO, HI)")
    args = ap.parse_args(argv)

    t0 = time.time()
    meta = make_dataset(args.root, args.n_train, args.n_val, args.seed,
                        jpeg_quality=args.jpeg_quality, layout=args.layout,
                        fade_range=tuple(args.fade) if args.fade else None)
    with open(os.path.join(args.root, "splits", args.layout, "class_names.txt"), "w") as f:
        f.write("\n".join(class_names(meta["n_hues"], meta["n_textures"])) + "\n")
    meta["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
