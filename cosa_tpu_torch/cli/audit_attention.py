"""Hold the attention kernels K1/K2 to float64 attention at a training
run's own state.

Usage:
  python -m cosa_tpu_torch.cli.audit_attention PRESET [NAME] --ckpt FILE \\
      --out DIR [--repeat 2000] [flags...]
  python -m cosa_tpu_torch.cli.audit_attention gmmab_fixed \\
      --ckpt /dev/shm/wd/gmmab_fixed/ckpt/step_00003000.pt \\
      --out work_dirs/torch_attn_audit_h100

PRESET and the flags are cli/run_synth.py's (the run's configuration, with
the run's --data_root), --device as cli/train.py's. From a checkpoint that
train/loop.py wrote (``ckpt/step_*.pt``, one at each validation) and the
batch the run would take next, it

1. runs the configuration's train step once with the kernels and captures,
   for every attention call, the packed qkv and, where the call is under
   gradient (the student's blocks), the cotangent of its output: the
   teacher's TTA at each scale and the student, each block a site;
2. on those captured tensors, compares three attentions: K1/K2, the plain
   bf16 path (``kernels/flash.py::plain_attention_qkv``) and float64
   (``flash.py::f64_attention_qkv``). Per site: the output's and dq / dk /
   dv's relative error in norm against float64, and their cosines; |dq|
   before the scale (quantiles, the share of exact zeros); the share of
   K2's per-128-key-block dq shares under 2^-36, where K2's int64 sum on a
   2^-44 grid is coarser than bf16's rounding, and the error that grid
   alone leaves in dq (simulated in float64); the attention's peakedness
   (median row max probability, the scaled logits' range and std);
3. builds the teacher's pseudo masks (``cam2mask``, main and aux heads) and
   the soft CAM targets (``seg_refine_by_label``) with each attention and
   counts the pixels where each bf16 path's differ from float64's;
4. runs K1 and K2 ``--repeat`` times on captured inputs (the student's
   first block forward and backward, the teacher's first block at each TTA
   scale) and holds every output bitwise to the first.

The rule: it is a kernel fault at this state if, at any site, err(kernel) >
ERR_RATIO x err(plain) + ERR_FLOOR for the output or any of dq / dk / dv
(err: the relative error in norm against float64); or the kernel's
pseudo-mask flips (main and aux heads together) exceed FLIP_RATIO x the
plain path's; or a repeat differs from the first call. Otherwise the
kernels are no worse than plain attention at this state.

Writes ``DIR/audit_step{step}.json`` (the report) and ``.txt`` (its table)
and prints the table; the last line is the verdict as JSON. Exits 1 on a
fault.

With ``--watch RUN_DIR --at S...`` in place of ``--ckpt`` it audits a run
while it trains: it waits for each step's checkpoint in ``RUN_DIR/ckpt``,
copies it beside itself before the loop's ``checkpoint_keep`` removes it,
and audits the copy (the verdicts, one per line, then every step's). On the CPU the kernels' wrapper takes the plain version, so the
kernel and plain columns agree.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

ERR_RATIO, ERR_FLOOR = 2.0, 1e-3
FLIP_RATIO = 1.5  # chip_smoke.py phase 5's bound on pseudo-mask flips
SMALL_SHARE = 2.0 ** -36  # under it, a 2^-44 grid is coarser than bf16
DQ_GRID = 2.0 ** -44  # K2's int64 dq sum (csrc/flash_attn.cu, DQ_ONE)
KEY_BLOCK = 128  # keys per K2 block (NWG_B * 64)
REPEAT = 2000


def plain_vit_attention(qkv, num_heads, scale, use_kernel, n_valid=None):
    """A drop-in for ``models/vit.py::attention``: the plain bf16 path."""
    from cosa_tpu_torch.kernels.flash import plain_attention_qkv

    return plain_attention_qkv(qkv, num_heads, scale, n_valid)


def f64_vit_attention(qkv, num_heads, scale, use_kernel, n_valid=None):
    """A drop-in for ``models/vit.py::attention``: float64 attention, cast
    back to qkv's dtype."""
    from cosa_tpu_torch.kernels.flash import f64_attention_qkv

    return f64_attention_qkv(qkv, num_heads, scale, n_valid).to(qkv.dtype)


@contextmanager
def vit_attention_as(fn: Optional[Callable]):
    """``models/vit.py``'s attention replaced by ``fn`` inside the block
    (None: as configured)."""
    import cosa_tpu_torch.models.vit as vit

    orig = vit.attention
    vit.attention = fn or orig
    try:
        yield
    finally:
        vit.attention = orig


@dataclass
class Site:
    role: str  # "teacher" or "student"
    block: int
    heads: int
    scale: float
    n_valid: Optional[int]
    qkv: torch.Tensor  # (B, N, 3 * C) bf16, as captured
    dout: Optional[torch.Tensor] = None  # the output's cotangent, under grad

    @property
    def name(self) -> str:
        return f"{self.role}.b{self.block}@{self.qkv.shape[1]}"


@contextmanager
def capturing(models: Dict[str, torch.nn.Module], sites: List[Site]):
    """Each attention call of ``models`` (role -> network) appended to
    ``sites`` with its qkv, and its output's cotangent once the backward
    reaches it."""
    import cosa_tpu_torch.models.vit as vit

    where: Dict = {}
    hooks = []
    for role, model in models.items():
        attns = [m for m in model.modules() if isinstance(m, vit.Attention)]
        for i, m in enumerate(attns):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, role=role, i=i: where.update(role=role, block=i)))
    orig = vit.attention

    def attention(qkv, num_heads, scale, use_kernel, n_valid=None):
        o = orig(qkv, num_heads, scale, use_kernel, n_valid)
        site = Site(where["role"], where["block"], num_heads, scale, n_valid,
                    qkv.detach().clone())
        if o.requires_grad:
            o.register_hook(lambda g, site=site: setattr(site, "dout", g.detach().clone()))
        sites.append(site)
        return o

    vit.attention = attention
    try:
        yield
    finally:
        vit.attention = orig
        for h in hooks:
            h.remove()


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref|| in float64 (0 where both are 0)."""
    a, ref = a.detach().double(), ref.detach().double()
    num = float(torch.linalg.vector_norm(a - ref))
    den = float(torch.linalg.vector_norm(ref))
    return num / den if den else (0.0 if num == 0 else float("inf"))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    den = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
    return float(a @ b) / den if den else float(torch.equal(a, b))


def _grad(fn, qkv, dout, site: Site):
    """(output, d qkv) of ``fn`` at ``qkv`` under ``dout``."""
    x = qkv.detach().requires_grad_(True)
    o = fn(x, site.heads, site.scale, site.n_valid)
    (g,) = torch.autograd.grad(o, x, dout.to(o.dtype))
    return o.detach(), g


def f64_stats(site: Site) -> Dict:
    """From float64, one batch row at a time: the attention's peakedness and,
    under a cotangent, |dq| before the scale, K2's per-key-block shares of
    it and the error that dq's 2^-44 grid alone leaves."""
    b, n, c3 = site.qkv.shape
    h = site.heads
    x = site.qkv.double().reshape(b, n, 3, h, c3 // (3 * h))
    nv = n if site.n_valid is None else site.n_valid
    pmax, smin, smax, s1, s2, cnt = [], float("inf"), float("-inf"), 0.0, 0.0, 0
    dq, dq_grid, small, shares = [], [], 0, 0
    for i in range(b):
        q, k, v = x[i, :, 0], x[i, :, 1], x[i, :, 2]  # (N, H, D)
        s = torch.einsum("qhd,khd->hqk", q * site.scale, k)[:, :, :nv]
        smin, smax = min(smin, float(s.min())), max(smax, float(s.max()))
        s1, s2, cnt = s1 + float(s.sum()), s2 + float((s * s).sum()), cnt + s.numel()
        p = torch.softmax(s, dim=-1)
        pmax.append(p.amax(dim=-1).flatten())
        if site.dout is None:
            continue
        do = site.dout[i].double().reshape(n, h, -1)
        dp = torch.einsum("qhd,khd->hqk", do, v[:nv])
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))  # K2's dS, before the scale
        exact = grid = 0.0
        for k0 in range(0, nv, KEY_BLOCK):
            share = torch.einsum("hqk,khd->qhd", ds[:, :, k0:k0 + KEY_BLOCK],
                                 k[k0:k0 + KEY_BLOCK])
            small += int((share.abs() < SMALL_SHARE).sum())
            shares += share.numel()
            exact = exact + share
            grid = grid + torch.round(share / DQ_GRID) * DQ_GRID
        dq.append(exact.flatten())
        dq_grid.append(grid.flatten())
    pm = torch.cat(pmax)
    mean = s1 / cnt
    out = dict(pmax_median=float(pm.median()), logit_min=smin, logit_max=smax,
               logit_std=max(s2 / cnt - mean * mean, 0.0) ** 0.5)
    if dq:
        a, g = torch.cat(dq), torch.cat(dq_grid)
        mag = a.abs()
        qs = torch.quantile(mag, torch.tensor([0.01, 0.5], dtype=mag.dtype, device=mag.device))
        out.update(dq_q01=float(qs[0]), dq_q50=float(qs[1]),
                   dq_zero_share=float((mag == 0).double().mean()),
                   share_under_2m36=small / shares, grid_err=rel_err(g, a))
    return out


# K2's dq in float64 with the roundings of each form of dS: (the P that
# dS takes, where delta comes from)
K2_VARIANTS = {
    "tpu": ("bf16", "bf16_o"),  # bf16 P, delta = dO . bf16(O): the TPU kernel's form
    "f32_o": ("bf16", "f32_o"),  # delta from K1's O before its bf16 store
    "f32_p": ("f32", "bf16_o"),
    "f32_p_o": ("f32", "f32_o"),
    "sum_bf16_p": ("bf16", "sum"),  # delta = rowsum(P * dP) over the same P
    "k2": ("f32", "sum"),  # K2's form (csrc/flash_attn.cu)
}


def emulate_k2(site: Site) -> Dict[str, float]:
    """dq's relative error in norm against float64 for each of
    K2_VARIANTS: K1's O emulated (bf16 probabilities into the PV product,
    the f32 row sum), dS rounded to bf16, the shares summed exactly and dq
    rounded to bf16 as K2 stores it. Shows which rounding makes the dq
    error of a form of K2."""
    b, n, c3 = site.qkv.shape
    h = site.heads
    x = site.qkv.double().reshape(b, n, 3, h, c3 // (3 * h))
    nv = n if site.n_valid is None else site.n_valid
    c = site.scale * 1.4426950408889634
    num = {k: 0.0 for k in K2_VARIANTS}
    den = 0.0

    def bf(t):
        return t.to(torch.bfloat16).double()

    for i in range(b):
        q, k, v = x[i, :, 0], x[i, :, 1][:nv], x[i, :, 2][:nv]
        do = site.dout[i].double().reshape(n, h, -1)
        s = torch.einsum("qhd,khd->hqk", q, k) * c  # log2 units
        m = s.amax(dim=-1, keepdim=True)
        pt = torch.exp2(s - m)
        l = pt.sum(dim=-1, keepdim=True)
        o = torch.einsum("hqk,khd->qhd", bf(pt) / l, v)  # K1's o before its store
        dp = torch.einsum("qhd,khd->hqk", do, v)
        p = pt / l
        ref = torch.einsum("hqk,khd->qhd", p * (dp - (p * dp).sum(-1, keepdim=True)), k)
        den += float((ref * site.scale).square().sum())
        for name, (pk, dk) in K2_VARIANTS.items():
            pd = bf(p) if pk == "bf16" else p
            if dk == "sum":
                delta = (pd * dp).sum(-1, keepdim=True)
            else:
                oo = bf(o) if dk == "bf16_o" else o
                delta = (do * oo).sum(-1).transpose(0, 1)[..., None]
            dq = bf(torch.einsum("hqk,khd->qhd", bf(pd * (dp - delta)), k) * site.scale)
            num[name] += float((dq - ref * site.scale).square().sum())
    return {k: (v / den) ** 0.5 if den else 0.0 for k, v in num.items()}


def site_report(site: Site) -> Dict:
    """One site's errors against float64, kernel and plain, and its
    float64 statistics."""
    from cosa_tpu_torch.kernels.flash import (
        f64_attention_qkv,
        flash_attention_qkv,
        plain_attention_qkv,
    )

    rec = dict(site=site.name, role=site.role, block=site.block, n=site.qkv.shape[1],
               bh=site.qkv.shape[0] * site.heads)
    fns = dict(kernel=flash_attention_qkv, plain=plain_attention_qkv)
    err: Dict[str, Dict[str, float]] = {}
    if site.dout is None:
        with torch.no_grad():
            ref = f64_attention_qkv(site.qkv, site.heads, site.scale, site.n_valid)
            for tag, fn in fns.items():
                o = fn(site.qkv, site.heads, site.scale, site.n_valid)
                err.setdefault("out", {})[tag] = rel_err(o, ref)
    else:
        ref_o, ref_g = _grad(f64_attention_qkv, site.qkv.double(), site.dout.double(), site)
        ref_g = ref_g.reshape(*ref_g.shape[:2], 3, -1)
        for tag, fn in fns.items():
            o, g = _grad(fn, site.qkv, site.dout, site)
            err.setdefault("out", {})[tag] = rel_err(o, ref_o)
            g = g.reshape(*g.shape[:2], 3, -1)
            for j, key in enumerate(("dq", "dk", "dv")):
                err.setdefault(key, {})[tag] = rel_err(g[:, :, j], ref_g[:, :, j])
                err[key][f"cos_{tag}"] = cosine(g[:, :, j], ref_g[:, :, j])
    rec["err"] = err
    rec.update(f64_stats(site))
    if site.dout is not None:
        rec["k2_emulation"] = emulate_k2(site)
    return rec


def teacher_level(pieces, state, wimg, simg, cls_label, img_box) -> Dict:
    """The pseudo masks (main, aux) and soft CAM targets built with each
    attention, each bf16 path's pixels against float64's. The GMM state is
    put back after each build."""
    gmm0 = copy.deepcopy(state.gmm)
    built = {}
    for tag, fn in (("kernel", None), ("plain", plain_vit_attention),
                    ("f64", f64_vit_attention)):
        with vit_attention_as(fn):
            tta = pieces.teacher_tta(state, wimg)
            built[tag] = dict(pieces.pseudo_targets(state, tta, simg, cls_label, img_box),
                              cam=tta[0])
        state.gmm = copy.deepcopy(gmm0)
    ref = built["f64"]
    out = dict(pixels=int(ref["refine_mask"].numel()), flips={})
    for tag in ("kernel", "plain"):
        t = built[tag]
        main = int((t["refine_mask"] != ref["refine_mask"]).sum())
        aux = (int((t["refine_mask_aux"] != ref["refine_mask_aux"]).sum())
               if ref["refine_mask_aux"] is not None else 0)
        out[tag] = dict(
            mask_main_flips=main, mask_aux_flips=aux,
            soft_argmax_flips=int((t["valid_seg_ps"].argmax(-1)
                                   != ref["valid_seg_ps"].argmax(-1)).sum()),
            soft_max_abs=float((t["valid_seg_ps"] - ref["valid_seg_ps"]).abs().max()),
            cam_max_abs=float((t["cam"] - ref["cam"]).abs().max()))
        out["flips"][tag] = main + aux
    return out


def repeat_check(sites: List[Site], calls: int) -> Dict:
    """K1 and K2 ``calls`` times on captured inputs: the student's first
    block forward and backward and the teacher's first block at each
    token count; every output held bitwise to the first call's."""
    from cosa_tpu_torch.kernels.flash import flash_attention_qkv

    picks: Dict = {}
    for s in sites:
        picks.setdefault((s.role, s.qkv.shape[1]), s)
    student = [s for s in picks.values() if s.dout is not None]
    teacher = [s for s in picks.values() if s.dout is None]

    def run():
        outs = [_grad(flash_attention_qkv, s.qkv, s.dout, s) for s in student]
        with torch.no_grad():
            outs += [(flash_attention_qkv(s.qkv, s.heads, s.scale, s.n_valid), None)
                     for s in teacher]
        return outs

    first = run()
    k1 = k2 = 0
    for _ in range(calls - 1):
        for (o, g), (o0, g0) in zip(run(), first):
            k1 += int(not torch.equal(o, o0))
            k2 += int(g is not None and not torch.equal(g, g0))
    return dict(calls=calls, inputs=[s.name for s in student + teacher],
                k1_per_call=len(student) + len(teacher), k2_per_call=len(student),
                k1_mismatch=k1, k2_mismatch=k2)


def verdict(report: Dict) -> Dict:
    """The module's rule over one state's report."""
    faults = []
    for s in report["sites"]:
        for key, e in s["err"].items():
            if e["kernel"] > ERR_RATIO * e["plain"] + ERR_FLOOR:
                faults.append(f"{s['site']} {key}: kernel {e['kernel']:.3e} > {ERR_RATIO} x "
                              f"plain {e['plain']:.3e} + {ERR_FLOOR}")
    fl = report["teacher"]["flips"]
    if fl["kernel"] > FLIP_RATIO * fl["plain"]:
        faults.append(f"pseudo-mask flips: kernel {fl['kernel']} > {FLIP_RATIO} x plain "
                      f"{fl['plain']}")
    rep = report["repeat"]
    if rep["k1_mismatch"] or rep["k2_mismatch"]:
        faults.append(f"repeat: {rep['k1_mismatch']} K1 and {rep['k2_mismatch']} K2 outputs "
                      f"differ from the first call's")
    return dict(step=report["step"], verdict="fault" if faults else "clean", faults=faults)


def audit(cfg, ckpt_path: str, device=None, repeat: int = REPEAT) -> Dict:
    """The report of one state (module docstring): ``cfg`` is the run's
    configuration; the kernels run whatever its ``flash_attention``."""
    from cosa_tpu_torch.data.loader import build_train_loader
    from cosa_tpu_torch.ops.image import normalize
    from cosa_tpu_torch.train import checkpoint as ckpt
    from cosa_tpu_torch.train.loop import resolve_convention, to_device
    from cosa_tpu_torch.train.state import create_train_state
    from cosa_tpu_torch.train.step import build_train_step
    from cosa_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = cfg.replace(flash_attention=True)
    state = create_train_state(cfg, dev)
    ckpt.restore_state(ckpt_path, state)
    cfg = resolve_convention(cfg, dev)
    loader = build_train_loader(cfg, cfg.batch_size, skip_batches=state.step)
    try:
        batch = to_device(next(loader), dev)
    finally:
        loader.close()
    step = state.step
    step_fn = build_train_step(cfg)
    act = torch.bfloat16 if cfg.mixed_precision else torch.float32
    teacher = teacher_level(step_fn.pieces, state, normalize(batch["wimg"], dtype=act),
                            normalize(batch["simg"]), batch["cls_label"].to(torch.float32),
                            batch["img_box"])
    sites: List[Site] = []
    with capturing({"teacher": state.teacher, "student": state.student}, sites):
        metrics = step_fn(state, batch)
    del state
    report = dict(
        ckpt=os.path.basename(ckpt_path), step=step, name=cfg.name,
        losses={k: float(metrics[k]) for k in ("overall_loss", "cls_loss", "cls_aux_loss",
                                               "seg_loss", "cam_loss", "reg_loss")},
        sites=[site_report(s) for s in sites], teacher=teacher,
        repeat=repeat_check(sites, repeat))
    report["verdict"] = verdict(report)
    return report


def _e(x) -> str:
    return "-" if x is None else f"{x:.2e}"


def table(report: Dict) -> List[str]:
    """The report as markdown: one row per site, then the teacher's flips,
    the repeat and the verdict."""
    cols = ("site", "BH", "out k/p", "dq k/p", "dk k/p", "dv k/p", "cos dq k/p",
            "|dq| q01/q50", "zeros", "<2^-36", "grid err", "pmax med", "logits min/max/std")
    out = [f"## attention audit at step {report['step']} ({report['ckpt']})", "",
           f"losses of the step: {json.dumps(report['losses'])}", "",
           "| " + " | ".join(cols) + " |", "|---" * len(cols) + "|"]
    for s in report["sites"]:
        e = s["err"]
        kp = [f"{_e(e[k]['kernel'])} / {_e(e[k]['plain'])}" if k in e else "-"
              for k in ("out", "dq", "dk", "dv")]
        cos = (f"{e['dq']['cos_kernel']:.6f} / {e['dq']['cos_plain']:.6f}" if "dq" in e else "-")
        dq = (f"{_e(s['dq_q01'])} / {_e(s['dq_q50'])}", f"{s['dq_zero_share']:.4f}",
              f"{s['share_under_2m36']:.4f}", _e(s["grid_err"])) if "dq_q01" in s else ("-",) * 4
        out.append(f"| {s['site']} | {s['bh']} | " + " | ".join(kp) + f" | {cos} | "
                   + " | ".join(dq) + f" | {s['pmax_median']:.4f} | {s['logit_min']:.2f} / "
                   f"{s['logit_max']:.2f} / {s['logit_std']:.2f} |")
    emu = [s for s in report["sites"] if "k2_emulation" in s]
    if emu:
        names = list(K2_VARIANTS)
        out += ["", "dq's error against float64, K2 measured and each form of dS emulated "
                "(K2_VARIANTS)", "", "| site | kernel | plain | " + " | ".join(names) + " |",
                "|---" * (len(names) + 3) + "|"]
        out += [f"| {s['site']} | {_e(s['err']['dq']['kernel'])} | {_e(s['err']['dq']['plain'])} | "
                + " | ".join(_e(s["k2_emulation"][k]) for k in names) + " |" for s in emu]
    t = report["teacher"]
    out += ["", f"teacher, {t['pixels']} mask pixels per head, against float64: "
            + "; ".join(f"{tag}: mask flips main {t[tag]['mask_main_flips']}, aux "
                        f"{t[tag]['mask_aux_flips']}, soft-target argmax flips "
                        f"{t[tag]['soft_argmax_flips']}, soft max abs "
                        f"{t[tag]['soft_max_abs']:.3e}, CAM max abs {t[tag]['cam_max_abs']:.3e}"
                        for tag in ("kernel", "plain"))]
    r = report["repeat"]
    out.append(f"repeat: {r['calls']} calls of K1 on {r['k1_per_call']} inputs and K2 on "
               f"{r['k2_per_call']} ({', '.join(r['inputs'])}): {r['k1_mismatch']} K1 and "
               f"{r['k2_mismatch']} K2 outputs differ from the first")
    v = report["verdict"]
    out.append(f"verdict at step {v['step']}: **{v['verdict']}**"
               + ("" if v["faults"] else " (kernels no worse than plain attention)"))
    out += [f"- {f}" for f in v["faults"]]
    return out


def watch(run_dir: str, steps: List[int], poll: float = 5.0):
    """Each of ``steps``' checkpoint files of the run at ``run_dir``, in
    order, as a copy of this process's own, made as soon as the loop has
    written it (the caller removes it); the run's process must keep
    writing them."""
    import shutil
    import time

    from cosa_tpu_torch.train.checkpoint import _step_path

    for step in steps:
        src = _step_path(os.path.join(run_dir, "ckpt"), step)
        while not os.path.exists(src):
            time.sleep(poll)
        dst = os.path.join(run_dir, f"audit_{step:08d}.{os.getpid()}.pt")
        shutil.copyfile(src, dst)
        yield dst


def _write(report: Dict, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, f"audit_step{report['step']:05d}")
    with open(stem + ".json", "w") as f:
        json.dump(report, f, indent=1)
    text = "\n".join(table(report))
    with open(stem + ".txt", "w") as f:
        f.write(text + "\n")
    print(text, flush=True)
    print(json.dumps(report["verdict"]), flush=True)


def main(argv=None) -> int:
    from cosa_tpu_torch.cli import run_synth, train
    from cosa_tpu_torch.config import parse_cli

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--watch", default=None, metavar="RUN_DIR")
    ap.add_argument("--at", nargs="+", type=int, default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--repeat", type=int, default=REPEAT)
    ns, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    if (ns.ckpt is None) == (ns.watch is None) or (ns.watch and not ns.at):
        ap.error("give --ckpt FILE, or --watch RUN_DIR with --at STEP...")
    _, args = run_synth.parse(rest)
    device, args = train.split_device(args)
    cfg = parse_cli(args)
    verdicts = []
    for path in ([ns.ckpt] if ns.ckpt else watch(ns.watch, ns.at)):
        report = audit(cfg, path, device, ns.repeat)
        if ns.watch:
            os.remove(path)
        _write(report, ns.out)
        verdicts.append(report["verdict"])
    if len(verdicts) > 1:
        print(json.dumps(verdicts), flush=True)
    return 1 if any(v["verdict"] == "fault" for v in verdicts) else 0


if __name__ == "__main__":
    sys.exit(main())
