"""Hold the port's learning runs to a JAX run of the same preset, from the
logs alone (``metrics.jsonl`` as train/loop.py writes it).

Prints a markdown table with one row per validation: the JAX run's ON
Seg_vd, each port run's, and the port runs' min / median / max; then each
run's best Seg_vd (the largest of either network, as cli/chip_run.py's
``summarise`` reads it) and its finaleval, raw and with the CRF (the
``kind == "final"`` record). The last line is one JSON object with the
counts, the bars and the verdict.

Rule A (with ``--at``): one fault where, at 2 or more of the ``--at``
validations, the JAX run's ON Seg_vd lies above every port run's; one more
where the JAX run's best lies above every port run's best. With at least
``--seeds_needed`` port runs, each with a reading at every ``--at``
validation, the verdict is ``fault`` if either holds and ``spread`` if
neither does; otherwise it is ``undecided``.

The bar: a port run meets it where its best is at least ``--bar`` times the
JAX run's best. ``--pair FIXED GMM`` holds the two arms of the GMM A/B, each
to its own JAX arm (``--jax FIXED_JAX GMM_JAX``), prints each port arm's best
as a multiple of its JAX arm's (the bar looks from below only), and checks
the JAX pair's ordering: the fixed arm's best above the GMM arm's.

``--arms A... -- B...`` holds two arms of port runs of one preset against
each other by their best Seg_vd, with an exact one-sided rank-sum test that
arm A lies above arm B: U counts the pairs (a, b) with a's best above b's
(a tie counts one half), and p is the share of the ways to split the pooled
runs into arms of their sizes whose U is at least the observed one. The
verdict is ``fault`` where p <= ALPHA and ``spread`` otherwise; with 3
runs against 4, only complete separation gives p = 1/35 <= 0.05. Each run
is also held to the bar of the one ``--jax`` run.

Usage:
  python -m cosa_tpu_torch.cli.report_parity --jax work_dirs/synthrun_r3 \
      --port work_dirs/torch_synthrun_h100 work_dirs/torch_synthrun_seed1_h100 \
      --at 3000 3500 4500 [--seeds_needed 4] [--bar 0.85]
  python -m cosa_tpu_torch.cli.report_parity \
      --jax work_dirs/gmmab_fixed_r5 work_dirs/gmmab_gmm_r5 \
      --pair work_dirs/torch_gmmab_fixed_h100 work_dirs/torch_gmmab_gmm_h100
  python -m cosa_tpu_torch.cli.report_parity --jax work_dirs/gmmab_fixed_r5 \
      --arms PLAIN_RUN... -- KERNEL_RUN...
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, List, Optional, Sequence

ALPHA = 0.05  # --arms: the rank-sum test's level


@dataclass
class Run:
    name: str
    on: Dict[int, float] = field(default_factory=dict)  # iter -> ON Seg_vd, x100
    best: float = float("nan")  # the largest Seg_vd of either network, x100
    best_at: str = "-"  # "iter MODEL" of the best
    final: Optional[Dict] = None  # the "final" record


def load(run_dir: str) -> Run:
    """A run's ON trajectory, best and finaleval from its ``metrics.jsonl``."""
    run = Run(os.path.basename(os.path.normpath(run_dir)))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for ln in f:
            r = json.loads(ln)
            if r.get("kind") == "val":
                seg = 100 * r["Seg_vd"]
                if r["model"] == "ON":
                    run.on[r["iter"]] = seg
                if not seg <= run.best:  # the first reading replaces the nan
                    run.best, run.best_at = seg, f"{r['iter']} {r['model']}"
            elif r.get("kind") == "final":
                run.final = r
    return run


def rule_a(jax: Run, ports: Sequence[Run], at: Sequence[int], seeds_needed: int) -> Dict:
    """Rule A's counts and verdict (module docstring). A validation counts
    only where every port run has a reading, and one that some run lacks
    leaves the verdict ``undecided``."""
    above = [it for it in at if it in jax.on and all(it in p.on for p in ports)
             and all(jax.on[it] > p.on[it] for p in ports)]
    missing = [it for it in at if it not in jax.on or any(it not in p.on for p in ports)]
    best_above = all(jax.best > p.best for p in ports)
    faults = int(len(above) >= 2) + int(best_above)
    if len(ports) < seeds_needed or missing:
        verdict = "undecided"
    else:
        verdict = "fault" if faults else "spread"
    return dict(at=list(at), above_at=above, n_above=len(above), missing=missing,
                best_above=best_above, faults=faults, runs=len(ports),
                seeds_needed=seeds_needed, verdict=verdict,
                p_one_validation=1 / (len(ports) + 1))


def bar_rule(jax: Run, ports: Sequence[Run], bar: float) -> Dict:
    """The bar (``bar`` x the JAX run's best) and which port runs meet it."""
    need = bar * jax.best
    return dict(bar=bar, need=round(need, 4),
                meets={p.name: bool(p.best >= need) for p in ports})


def rank_sum(a: Sequence[float], b: Sequence[float]) -> Dict:
    """The exact one-sided rank-sum test that the values ``a`` lie above
    ``b`` (module docstring): U, its largest value, p and the verdict."""
    pooled = list(a) + list(b)

    def u(idx) -> float:
        ys = [y for j, y in enumerate(pooled) if j not in idx]
        return sum(1.0 if x > y else 0.5 if x == y else 0.0
                   for x in (pooled[i] for i in idx) for y in ys)

    obs = u(set(range(len(a))))
    splits = [set(c) for c in combinations(range(len(pooled)), len(a))]
    p = sum(u(c) >= obs for c in splits) / len(splits)
    return dict(u=obs, u_max=len(a) * len(b), splits=len(splits), p=p, alpha=ALPHA,
                verdict="fault" if p <= ALPHA else "spread")


def _fmt(x: Optional[float]) -> str:
    return "-" if x is None else f"{x:.1f}"


def table(jax: Run, ports: Sequence[Run]) -> List[str]:
    """The markdown trajectory table (ON Seg_vd x100 per validation)."""
    cols = [f"JAX {jax.name}"] + [p.name for p in ports] + ["port min", "median", "max"]
    out = ["| iter | " + " | ".join(cols) + " |", "|---" * (len(cols) + 1) + "|"]
    for it in sorted(set(jax.on).union(*(p.on for p in ports))):
        vals = [p.on[it] for p in ports if it in p.on]
        stats = [min(vals), statistics.median(vals), max(vals)] if vals else [None] * 3
        row = [jax.on.get(it)] + [p.on.get(it) for p in ports] + stats
        out.append(f"| {it} | " + " | ".join(_fmt(v) for v in row) + " |")
    return out


def summary(runs: Sequence[Run]) -> List[str]:
    """Each run's best Seg_vd and its finaleval, raw and with the CRF."""
    out = []
    for r in runs:
        fin = r.final
        tail = (f"finaleval Seg {100 * fin['Seg_vd']:.2f}, +CRF "
                f"{100 * fin.get('Seg_crf', float('nan')):.2f}") if fin else "no finaleval"
        out.append(f"- {r.name}: best Seg_vd {r.best:.2f} ({r.best_at}); {tail}")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", nargs="+", required=True,
                    help="the JAX run's directory; with --pair, the fixed and GMM arms'")
    ap.add_argument("--port", nargs="+", default=[])
    ap.add_argument("--pair", nargs=2, default=None, metavar=("FIXED", "GMM"))
    ap.add_argument("--arms", nargs="+", default=None, metavar="A",
                    help="arm A's runs, then --, then arm B's")
    ap.add_argument("arm_b", nargs="*", default=[], metavar="B")
    ap.add_argument("--at", nargs="+", type=int, default=None)
    ap.add_argument("--seeds_needed", type=int, default=4)
    ap.add_argument("--bar", type=float, default=0.85)
    args = ap.parse_args(argv)
    if args.pair is not None and len(args.jax) != 2:
        ap.error("--pair needs --jax FIXED_JAX GMM_JAX")
    if args.arms is not None and (len(args.jax) != 1 or not args.arm_b or args.pair):
        ap.error("--arms needs one --jax run and the two arms' runs: --arms A... -- B...")
    if args.arms is None and args.arm_b:
        ap.error(f"unexpected arguments {args.arm_b}")
    if args.pair is None and args.arms is None and (len(args.jax) != 1 or not args.port):
        ap.error("give one --jax run and one or more --port runs, --pair or --arms")

    result: Dict = dict(verdict=None)
    if args.arms is not None:
        jax = load(args.jax[0])
        arms = {"A": [load(d) for d in args.arms], "B": [load(d) for d in args.arm_b]}
        b = bar_rule(jax, arms["A"] + arms["B"], args.bar)
        print(f"## arms by best Seg_vd (x100); bar {args.bar} x {jax.best:.2f} = "
              f"{b['need']:.2f}\n")
        for label, runs in arms.items():
            for r, line in zip(runs, summary(runs)):
                print(f"{label} {line} ({'meets' if b['meets'][r.name] else 'misses'} the bar)")
        t = rank_sum([r.best for r in arms["A"]], [r.best for r in arms["B"]])
        print(f"\nrank-sum, arm A above arm B: U = {t['u']:g} of {t['u_max']}, p = "
              f"{t['p']:.4f} over {t['splits']} splits: **{t['verdict']}** (fault where p "
              f"<= {ALPHA})")
        result.update(jax=jax.name, jax_best=round(jax.best, 4),
                      arms={k: {r.name: round(r.best, 4) for r in v} for k, v in arms.items()},
                      **b, rank_sum=t, verdict=t["verdict"])
    elif args.pair is None:
        jax, ports = load(args.jax[0]), [load(d) for d in args.port]
        print("\n".join(["## ON Seg_vd (x100) per validation", ""] + table(jax, ports) + [""]
                        + summary([jax] + ports)))
        result.update(jax=jax.name, jax_best=round(jax.best, 4),
                      port={p.name: round(p.best, 4) for p in ports},
                      **bar_rule(jax, ports, args.bar))
        need, meets = result["need"], result["meets"]
        print(f"\nbar {args.bar} x {jax.best:.2f} = {need:.2f}: "
              + ", ".join(f"{n} {'meets' if m else 'misses'}" for n, m in meets.items()))
        if args.at:
            a = rule_a(jax, ports, args.at, args.seeds_needed)
            result["rule_a"] = a
            result["verdict"] = a["verdict"]
            print(f"\nrule A: the JAX run's ON Seg_vd above every port run's at {a['n_above']} "
                  f"of {len(args.at)} validations {a['above_at']}"
                  + (f" (not every run has {a['missing']})" if a["missing"] else "")
                  + f"; its best above every port run's best: {a['best_above']}; "
                  f"faults {a['faults']}, {a['runs']} of {a['seeds_needed']} runs needed: "
                  f"**{a['verdict']}**")
            print(f"If the runs were exchangeable, one JAX run would lie above all "
                  f"{a['runs']} port runs at one validation with probability "
                  f"1/{a['runs'] + 1}: `fault` sends the runs to triage, it is not a "
                  f"finding by itself.")
    else:
        arms = []
        for label, jdir, pdir in zip(("fixed", "gmm"), args.jax, args.pair):
            jax, port = load(jdir), load(pdir)
            print(f"## {label} arm: ON Seg_vd (x100) per validation\n")
            print("\n".join(table(jax, [port]) + [""] + summary([jax, port])) + "\n")
            b = bar_rule(jax, [port], args.bar)
            arms.append((label, jax, port, b))
            print(f"bar {args.bar} x {jax.best:.2f} = {b['need']:.2f}: {port.name} "
                  f"{'meets' if b['meets'][port.name] else 'misses'} "
                  f"({port.best / jax.best:.2f}x the JAX arm's best)\n")
        (_, jf, pf, bf), (_, jg, pg, bg) = arms
        jax_gap, port_gap = jf.best - jg.best, pf.best - pg.best
        held = port_gap > 0 and jax_gap > 0
        print(f"ordering (fixed best above GMM best): JAX {jf.best:.2f} vs {jg.best:.2f} "
              f"({jax_gap:+.2f}), port {pf.best:.2f} vs {pg.best:.2f} ({port_gap:+.2f}): "
              f"**{'held' if held else 'not held'}**")
        result.update(pair=dict(
            fixed=dict(jax=jf.name, port=pf.name, jax_best=round(jf.best, 4),
                       port_best=round(pf.best, 4), need=bf["need"], meets=bf["meets"][pf.name],
                       over_jax=round(pf.best / jf.best, 4)),
            gmm=dict(jax=jg.name, port=pg.name, jax_best=round(jg.best, 4),
                     port_best=round(pg.best, 4), need=bg["need"], meets=bg["meets"][pg.name],
                     over_jax=round(pg.best / jg.best, 4)),
            jax_gap=round(jax_gap, 4), port_gap=round(port_gap, 4), ordering_held=held),
            bar=args.bar, verdict="held" if held else "not held")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
