"""Training loop and final evaluation: the JAX package's train/loop.py
(``train``, ``_train_body``, ``_run_validation``, ``finaleval``), on one
GPU or on every rank of a process group laid out as ``cfg.dp`` x ``cfg.tp``
(``parallel/mesh.py``; ``torchrun`` starts the ranks, ``cli/train.py``
joins them). Multi-process runs keep the JAX program's global-batch
semantics: ``batch_size`` is per data rank, the GMM queues, the logged
losses, ``cls_acc`` and ``imgs_per_sec`` are the global batch's, and
checkpoints and logs are written by rank 0.

  * the step loop with windowed ``metrics.jsonl`` / ``print.out`` logging;
    metrics stay on the device between log points and cross to the host in
    one transfer per window; ``data_wait_ms`` is the host's mean ms a step
    in ``next(loader)`` over the window (spans ``loader_wait`` and
    ``to_device``, ``utils/trace.py``);
  * every ``eval_iters`` steps: a validation of the student and the teacher
    (``log_val.txt``; best-seg / best-cam selection across both, reference
    main.py:348-374) and a full-state checkpoint;
  * ``resume`` from a checkpoint, continuing the loader's data order;
  * pretrained weights (``cfg.pretrained_path``) loaded into student and
    teacher before the first step;
  * on any exception, an emergency checkpoint of the state as it stands
    before the exception propagates (eager PyTorch updates the state in
    place: a failure inside the optimizer or EMA update of a step leaves
    that step half applied in it); under a process group only rank 0
    writes it, and only with ``tp == 1``, where its state is the full one
    and no collective (which a failed rank would never join) is needed;
  * with ``profile_dir``, rank 0's run is traced by ``torch.profiler``
    into ``{profile_dir}/trace_rank0.json`` (a chrome trace holding the
    port's spans, ``utils/trace.py``);
  * :func:`finaleval`: the best-seg weights (or a reference-key ``.pth``)
    scored on the full val split with the DenseCRF, or, with
    ``eval_split="test"``, the eval-server submission PNGs of the test split.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cosa_tpu_torch.config import Config, diff_from_preset
from cosa_tpu_torch.data.datasets import class_list
from cosa_tpu_torch.data.loader import (
    build_test_dataset,
    build_train_dataset,
    build_train_loader,
    build_val_dataset,
)
from cosa_tpu_torch.eval.engine import evaluate, score_names
from cosa_tpu_torch.eval.submit import dump_submission, submission_dir
from cosa_tpu_torch.models.convert import load_pretrained_into_state, load_torch_checkpoint
from cosa_tpu_torch.models.network import build_model, require_cosa_interface
from cosa_tpu_torch.parallel.mesh import barrier, make_mesh, shard_module_
from cosa_tpu_torch.parallel.tensor import all_cat, all_mean
from cosa_tpu_torch.train import checkpoint as ckpt
from cosa_tpu_torch.train.state import bind_state_, create_train_state
from cosa_tpu_torch.train.step import build_train_step
from cosa_tpu_torch.utils.device import resolve_device
from cosa_tpu_torch.utils.logging import (
    AverageMeter,
    MetricWriter,
    eta_string,
    format_iou_table,
)
from cosa_tpu_torch.utils.metrics import compute_mAP
from cosa_tpu_torch.utils.trace import span

LOSS_KEYS = ("overall_loss", "cls_loss", "cls_aux_loss",
             "seg_loss", "cam_loss", "reg_loss")


def output_dir(cfg: Config) -> str:
    return cfg.output_dir or os.path.join(cfg.work_dir, cfg.name)


def train(cfg: Config, max_steps: Optional[int] = None, device=None) -> Dict:
    """Co-train ``cfg`` up to step min(max_iters, max_steps) on ``device``
    (default: the GPU, card ``LOCAL_RANK`` under a process group; it raises
    when there is none). Under a process group every rank calls it.
    Returns the state (this rank's shards under ``tp > 1``), the logged
    records, the energy convention, the last validation's results and the
    best seg / CAM mIoU (-1 when nothing was validated)."""
    require_cosa_interface(cfg)
    total = min(cfg.max_iters, max_steps or cfg.max_iters)
    mesh = make_mesh(cfg.dp, cfg.tp)
    if cfg.random_seed:
        import random as _random

        seed = [_random.randint(1, 10000)]
        if mesh.world > 1:
            dist.broadcast_object_list(seed, src=0)
        cfg = cfg.replace(seed=seed[0], random_seed=False)
    dev = resolve_device(device)
    out_dir = output_dir(cfg)
    writer = MetricWriter(out_dir)
    writer.print(f"config diff vs {cfg.dataset} preset:", diff_from_preset(cfg))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    writer.print(f"device: {dev} ({name}); mesh: data={mesh.dp} model={mesh.tp} "
                 f"({mesh.world} processes)")

    state = create_train_state(cfg, dev, cfg.batch_size * mesh.dp)
    if cfg.pretrained and cfg.pretrained_path:
        load_pretrained_into_state(cfg, state)
        writer.print(f"loaded pretrained weights from {cfg.pretrained_path}")
    else:
        writer.print("weights: random init (seeded)")
    start_step = 0
    if cfg.resume:
        ckpt.restore_state(cfg.resume, state)
        start_step = state.step
        writer.print(f"resumed from {cfg.resume} at step {start_step}")
    n_params = sum(p.numel() for p in state.student.parameters())
    bind_state_(state, mesh)

    cfg = resolve_convention(cfg, dev, writer)
    step_fn = build_train_step(cfg, mesh)
    loader = build_train_loader(cfg, cfg.batch_size, skip_batches=start_step,
                                process_index=mesh.dp_rank, process_count=mesh.dp)
    val_ds = build_val_dataset(cfg)
    writer.print(f"Number of trainable params for Network: {n_params // 1_000_000}M")
    prof = None
    if cfg.profile_dir and mesh.rank == 0:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.time()
    try:
        out = _train_body(cfg, state, step_fn, loader, val_ds, writer, dev, out_dir,
                          start_step, total, t0, mesh)
    except BaseException:
        _emergency_checkpoint(os.path.join(out_dir, "ckpt_emergency"), state, mesh, writer)
        raise
    finally:
        loader.close()
        if prof is not None:
            prof.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace_rank0.json"))
    writer.print(
        f"Training done in {time.time() - t0:.0f}s. "
        f"Best val Seg mIoU: {out['best_seg']:.2f} Best val CAM mIoU: {out['best_cam']:.2f}")
    writer.close()
    return dict(state=state, energy_convention=cfg.energy_convention, **out)


def _emergency_checkpoint(path: str, state, mesh, writer) -> None:
    """The state as it stands, without collectives: the rank that failed
    may be the only one here. Rank 0 writes it where it holds the full
    state (``tp == 1``); any other case prints why none was written."""
    if mesh.rank != 0 or mesh.tp > 1:
        print(f"rank {mesh.rank}: no emergency checkpoint (rank 0 writes it, and only "
              f"with tp == 1, tp = {mesh.tp})", flush=True)
        return
    try:  # never mask the original failure
        ckpt.save_state(path, state, state.step, 1)
        writer.print("emergency checkpoint saved to ckpt_emergency/")
    except Exception as e:
        writer.print(f"emergency checkpoint failed: {e}")


def resolve_convention(cfg: Config, dev, writer: Optional[MetricWriter] = None) -> Config:
    """``cfg`` with its rff->lattice energy convention calibrated on the
    first training crops, when it is 0 (auto) and the filter is RFF."""
    if cfg.energy_filter != "rff" or cfg.energy_convention > 0:
        return cfg
    from cosa_tpu_torch.objectives.energy import resolve_energy_convention

    cal_ds = build_train_dataset(cfg)
    imgs = np.stack([cal_ds[(0, i)]["wimg"] for i in range(min(4, len(cal_ds)))])
    conv, info = resolve_energy_convention(cfg, imgs, device=dev)
    if writer is not None:
        writer.print(f"energy convention auto-calibrated: {conv:.4f} {info}")
    return cfg.replace(energy_convention=conv)


def to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, non_blocking=True)
            for k, v in batch.items()}


def _train_body(cfg, state, step_fn, loader, val_ds, writer, dev, out_dir,
                start_step, total, t0, mesh):
    global_batch = cfg.batch_size * mesh.dp
    meter = AverageMeter()
    pending = []
    records = []
    results: Dict = {}
    best_seg, best_cam = -1.0, -1.0
    t_log = time.time()
    data_wait = 0.0  # host seconds in next(loader) over the log window
    for n_iter in range(start_step, total):
        t_wait = time.perf_counter()
        with span("loader_wait"):
            local_batch = next(loader)
        data_wait += time.perf_counter() - t_wait
        with span("to_device"):
            batch = to_device(local_batch, dev)
        metrics = step_fn(state, batch)
        pending.append(metrics)
        if (n_iter + 1) % cfg.log_iters == 0:
            # ONE device->host transfer for the whole window; under data
            # parallelism the global values: one mean of the window's
            # losses and one gather of the last batch's logits and labels
            last = pending[-1]
            stacked = torch.stack([torch.stack([m[k] for k in LOSS_KEYS]) for m in pending])
            stacked = all_mean(stacked, mesh.dp_group)
            probs = torch.sigmoid(torch.stack([last["cls_logits"], last["cls_aux_logits"]]))
            probs = all_cat(probs.to(torch.float32), mesh.dp_group, dim=1)
            labels = all_cat(batch["cls_label"].to(torch.float32), mesh.dp_group)
            thre = torch.stack([last["thre_low"], last["thre_high"]])
            host = torch.cat([stacked.reshape(-1), thre, probs.reshape(-1),
                              labels.reshape(-1)]).cpu().numpy()
            nwin = len(pending)
            for row in host[: nwin * 6].reshape(nwin, 6):
                meter.add(dict(zip(LOSS_KEYS, row)))
            thre_low, thre_high = (float(v) for v in host[nwin * 6:nwin * 6 + 2])
            ncls = cfg.num_classes - 1
            probs, labels = np.split(host[nwin * 6 + 2:], [probs.numel()])
            probs, labels = probs.reshape(2, -1, ncls), labels.reshape(-1, ncls)
            cls_acc = float(np.mean(compute_mAP(labels, probs[0]) or [0.0]))
            cls_aux_acc = float(np.mean(compute_mAP(labels, probs[1]) or [0.0]))
            pending = []
            itertime = (time.time() - t_log) / nwin
            t_log = time.time()
            elapsed, eta = eta_string(t0, n_iter + 1 - start_step, total - start_step)
            rec = dict(
                iter=n_iter + 1,
                itertime=itertime,
                imgs_per_sec=global_batch / itertime,
                data_wait_ms=data_wait / nwin * 1e3,
                lr=last["lr"],
                thre_low=round(thre_low, 4),
                thre_high=round(thre_high, 4),
                cls_acc=round(cls_acc, 3),
                cls_aux_acc=round(cls_aux_acc, 3),
                **{k: float(meter.pop(k)) for k in LOSS_KEYS},
            )
            data_wait = 0.0
            records.append(rec)
            writer.log({"kind": "train", **rec})
            writer.print(
                f"Iter: {rec['iter']}; Elapsed: {elapsed}; ETA: {eta}; "
                f"Itertime: {rec['itertime']:.3f}s ({rec['imgs_per_sec']:.2f} img/s, "
                f"data wait {rec['data_wait_ms']:.2f} ms); "
                f"LR: {rec['lr']:.3e};\n overall_loss: {rec['overall_loss']:.4f}, "
                f"cls_loss: {rec['cls_loss']:.4f}, cls_acc: {rec['cls_acc']:.3f}, "
                f"cls_aux_loss: {rec['cls_aux_loss']:.4f}, "
                f"cls_aux_acc: {rec['cls_aux_acc']:.3f}, "
                f"seg_loss: {rec['seg_loss']:.4f}, cam_loss: {rec['cam_loss']:.4f}, "
                f"reg_loss: {rec['reg_loss']:.4f}"
            )
        if (n_iter + 1) % cfg.eval_iters == 0:
            results, best_seg, best_cam = _run_validation(
                cfg, state, val_ds, writer, n_iter + 1, out_dir, best_seg, best_cam, dev,
                mesh)
            ckpt.save_state(os.path.join(out_dir, "ckpt"), state, n_iter + 1,
                            cfg.checkpoint_keep, mesh)
            t_log = time.time()  # the next window's itertime leaves validation out
    return dict(records=records, results=results, best_seg=best_seg, best_cam=best_cam)


def _run_validation(cfg, state, val_ds, writer, n_iter, out_dir, best_seg, best_cam, dev,
                    mesh):
    cats = class_list(cfg.dataset, cfg.split_dir)[: cfg.num_classes]
    # reference layout for raw-CAM dumps: {output_dir}/{iter}/camraw_dir
    # (evaluation_engine.py:70-72); the teacher's files overwrite the
    # student's, the reference's own quirk
    rawcam_dir = os.path.join(out_dir, str(n_iter), "camraw_dir") if cfg.turnon_rawcam else None
    kw = dict(threshold_filters=cfg.eval_threshold_filters,
              max_images=cfg.fasteval_n if cfg.fasteval else None,
              save_rawcam_dir=rawcam_dir, device=dev, mesh=mesh)
    res_s = evaluate(cfg, state.student, val_ds, **kw)
    res_t = evaluate(cfg, state.teacher, val_ds, **kw)

    # the reference writes the 0-based loop index here (main.py:377-378)
    val_log_lines = [f"iters:{n_iter - 1}"]
    for tag, res in (("ON", res_s), ("AN", res_t)):
        names = score_names(res)
        tab = format_iou_table([res[k] for k in names], names, cats)
        writer.print(
            f"{tag} model @ iter {n_iter}: cls mAP {res['cls_aps'][0]:.3f}, "
            f"aux {res['cls_aps'][1]:.3f} ({res['time']['images']} images in "
            f"{res['time']['seconds']:.2f} s)\n{tab}")
        writer.log({"kind": "val", "model": tag, "iter": n_iter,
                    **{k: res[k]["miou"] for k in names}})
        val_log_lines.append(
            f"{tag} model: cls:{res['cls_aps'][0]:.4f}, "
            f"clsaux: {res['cls_aps'][1]:.4f}\n{tab}")
    if mesh.rank == 0:
        with open(os.path.join(out_dir, "log_val.txt"), "a") as f:
            f.write("\n".join(val_log_lines) + "\n")

    # best-model bookkeeping (reference main.py:348-374): round to 2
    # decimals; a tie goes to the first of student, teacher, best so far.
    # The scores are the same on every rank, so every rank takes the same
    # branch into the (collective) save_best
    def pick(key, best):
        cmp = [round(res_s[key]["miou"] * 100, 2), round(res_t[key]["miou"] * 100, 2), best]
        return int(np.argmax(cmp)), max(cmp)

    seg_win, best_seg = pick("Seg_vd", best_seg)
    cam_win, best_cam = pick("CAM", best_cam)
    for win, comment, best in ((seg_win, "seg", best_seg), (cam_win, "cam", best_cam)):
        if win != 2:
            ckpt.save_best(out_dir, state.student if win == 0 else state.teacher, comment,
                           dict(s_or_t="s" if win == 0 else "t", iter=n_iter, result=best),
                           mesh)
    return {"student": res_s, "teacher": res_t}, best_seg, best_cam


def finaleval(cfg: Config, device=None) -> Dict:
    """Reference finaleval (main.py:401-433): the run's best-seg weights, or
    the reference-key checkpoint at ``cfg.pretrained_path``, scored on the
    full val split with the DenseCRF (``cfg.crf_backend``), on ``device``
    (default: the GPU). With ``eval_split="test"`` (no ground truth) it
    writes the submission PNGs instead (``eval/submit.py``) and returns
    ``{"submission_dir": ...}``. Under a process group every rank calls it:
    the scoring is sharded as in :func:`evaluate`; the submission stays
    one process's (rank 0's), as the JAX package's does."""
    dev = resolve_device(device)
    mesh = make_mesh(cfg.dp, cfg.tp)
    out_dir = output_dir(cfg)
    writer = MetricWriter(out_dir)
    model = build_model(cfg, dev)
    if cfg.pretrained_path:
        model.load_state_dict(load_torch_checkpoint(cfg.pretrained_path))
        writer.print(f"evaluating checkpoint {cfg.pretrained_path}")
    else:
        ckpt.load_best(out_dir, "seg", model)
    if cfg.crf_backend == "device" and cfg.crf_reduce > 1:
        writer.print(
            f"note: Seg_crf uses the on-device mean-field at 1/{cfg.crf_reduce} "
            "resolution (exact Gaussian transform)")
    if cfg.eval_split == "test":
        dst = submission_dir(out_dir, cfg.dataset)
        if mesh.rank == 0:
            dump_submission(cfg, model, build_test_dataset(cfg), out_dir, device=dev)
            writer.print(f"wrote {len(os.listdir(dst))} submission PNGs to {dst}")
        barrier(mesh)
        writer.close()
        return {"submission_dir": dst}
    shard_module_(model, mesh)
    rawcam_dir = os.path.join(out_dir, "best1", "camraw_dir") if cfg.turnon_rawcam else None
    res = evaluate(cfg, model, build_test_dataset(cfg), getcrf=True,
                   save_rawcam_dir=rawcam_dir, device=dev, mesh=mesh)
    cats = class_list(cfg.dataset, cfg.split_dir)[: cfg.num_classes]
    names = score_names(res)
    t = res["time"]
    writer.print("Final Model Result:\n" + format_iou_table([res[k] for k in names], names, cats))
    writer.print(f"final eval: {t['images']} images, {t['seconds'] / t['images']:.4f} s/image, "
                 f"CRF {t['crf_seconds'] / t['images']:.4f} s/image")
    writer.log({"kind": "final", **{k: res[k]["miou"] for k in names}, **t})
    writer.close()
    return res
