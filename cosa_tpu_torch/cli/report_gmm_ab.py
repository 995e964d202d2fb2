"""Fixed-vs-GMM A/B report (the twin of the JAX package's
scripts/report_gmm_ab.py, for the ``gmmab_fixed`` and ``gmmab_gmm`` runs of
cli/run_synth.py).

Side-by-side val trajectory of the two arms plus the threshold story: the
fixed arm logs the constant (low_thre, high_thre) pair, the GMM arm logs
the EMA trajectory of the adaptive thresholds (train/step.py ->
metrics.jsonl thre_low/thre_high), so the report shows WHERE the adaptive
thresholds went relative to the hand-tuned 0.25/0.7 and whether that
bought accuracy on the drifting-contrast regime.

Usage:
  python -m cosa_tpu_torch.cli.report_gmm_ab --fixed work_dirs/gmmab_fixed \
      --gmm work_dirs/gmmab_gmm
"""

from __future__ import annotations

import argparse
import json
import os


def _load(out_dir):
    vals, thres = {}, []
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        for ln in f:
            r = json.loads(ln)
            if r.get("kind") == "val":
                vals.setdefault(r["iter"], {})[r["model"]] = r
            elif r.get("kind") == "train" and "thre_low" in r:
                thres.append((r["iter"], r["thre_low"], r["thre_high"]))
            elif r.get("kind") == "final":
                vals.setdefault("final", {})["final"] = r
    return vals, thres


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixed", required=True)
    ap.add_argument("--gmm", required=True)
    args = ap.parse_args(argv)

    vf, tf = _load(args.fixed)
    vg, tg = _load(args.gmm)

    print("## Val trajectory (Seg_vd / CAM mIoU x100, ON net)\n")
    print("| iter | fixed Seg | fixed CAM | gmm Seg | gmm CAM |")
    print("|---|---|---|---|---|")
    iters = sorted(k for k in set(vf) | set(vg) if k != "final")
    for it in iters:
        def g(v, key):
            d = v.get(it, {}).get("ON")
            return f"{100 * d[key]:.1f}" if d else "-"
        print(f"| {it} | {g(vf, 'Seg_vd')} | {g(vf, 'CAM')} | "
              f"{g(vg, 'Seg_vd')} | {g(vg, 'CAM')} |")

    for name, v in (("fixed", vf), ("gmm", vg)):
        fin = v.get("final", {}).get("final")
        if fin:
            print(f"\n{name} finaleval: Seg {100 * fin['Seg_vd']:.2f} "
                  f"+CRF {100 * fin.get('Seg_crf', float('nan')):.2f}")

    print("\n## Threshold trajectory (thre_low / thre_high per log window)\n")
    print("| iter | fixed low/high | gmm low/high |")
    print("|---|---|---|")
    tfd, tgd = dict((i, (l, h)) for i, l, h in tf), dict(
        (i, (l, h)) for i, l, h in tg)
    marks = sorted(set(list(tfd)[:: max(1, len(tfd) // 12)])
                   | set(list(tgd)[:: max(1, len(tgd) // 12)]))
    for it in marks:
        def s(d):
            if it not in d:
                return "-"
            lo, hi = d[it]
            return f"{lo:.3f}/{hi:.3f}"
        print(f"| {it} | {s(tfd)} | {s(tgd)} |")


if __name__ == "__main__":
    main()
