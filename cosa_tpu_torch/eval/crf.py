"""DenseCRF mean-field refinement for the final evaluation.

Port of the JAX package's eval/crf.py (the twin of
the reference's pydensecrf post-processing, utils/seg_helper.py:961-996:
one mean-field iteration with pos_w=1, pos_xy=1, bi_w=4, bi_xy=121,
bi_rgb=5, applied at final evaluation). The update is

    Q <- softmax( log p + sum_k w_k K_k Q ),   K = D^-1/2 G D^-1/2

on the padded P x P canvas of the evaluation, restricted to the image by a
valid mask:

  * the spatial Gaussian (sigma = pos_xy) is exact at full resolution, a
    separable product with banded matrices truncated at 4 pixels;
  * the bilateral Gaussian (sigma_xy = bi_xy, sigma_rgb = bi_rgb) is exact
    at 1/``crf_reduce`` of the canvas, as chunked f32 products of the
    N x N Gaussian with the messages; or, for one image at full resolution,
    the permutohedral lattice (``ops/permutohedral.py``), built once per
    image and applied twice per mean-field iteration.

Backends (``cfg.crf_backend``): ``"device"`` refines each evaluation batch
on the device with the exact transform (:func:`crf_labels_device`);
``"native"`` and ``"jax"`` refine one image at a time
(:func:`crf_refine_host`): ``"native"`` with the port's own C++ lattice on
the host (the reference's division of labour, pydensecrf), ``"jax"`` (the
JAX package's name, kept so configurations carry over) with the
single-image mean-field on the device, the lattice at ``crf_reduce`` 1.

Plain PyTorch: the JAX package leaves these to XLA, not to Pallas. The
squared distances of the bilateral kernel cancel terms near 1e4 down to
O(1), so their product must be true f32: TF32 stays off on this path
(``utils/device.py`` turns it off; :func:`crf_labels_device` raises if it
is back on).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cosa_tpu_torch.ops.permutohedral import apply_lattice, build_lattice
from cosa_tpu_torch.ops.resize import resize_bilinear


@functools.lru_cache(maxsize=32)
def _gauss_band(n: int, sigma: float, radius: int = 4) -> np.ndarray:
    """(n, n) banded 1-D Gaussian filter matrix, truncated at ``radius``."""
    idx = np.arange(n)
    m = np.exp(-0.5 * ((idx[None, :] - idx[:, None]) / sigma) ** 2)
    m[np.abs(idx[None, :] - idx[:, None]) > radius] = 0.0
    return m.astype(np.float32)


def _spatial_filter(q: torch.Tensor, sigma: float) -> torch.Tensor:
    """(H, W, C) separable full-resolution Gaussian transform (self included)."""
    h, w = q.shape[:2]
    gh = torch.from_numpy(_gauss_band(h, float(sigma))).to(q.device)
    gw = torch.from_numpy(_gauss_band(w, float(sigma))).to(q.device)
    y = torch.einsum("ph,hwc->pwc", gh, q)
    return torch.einsum("qw,pwc->pqc", gw, y)


def _bilateral_exact_chunked(feats: torch.Tensor, values: torch.Tensor,
                             chunk: int = 4096) -> torch.Tensor:
    """(N, d) feats x (N, K) values -> exact G @ values, G = exp(-|fi - fj|^2 / 2),
    in row chunks of ``chunk`` x N (the result does not depend on it).

    One f32 product of two (N, d + 2) factors gives -d2 / 2 directly:
    [f_i, -|f_i|^2 / 2, -1/2] . [f_j, 1, |f_j|^2]. Its terms reach ~1e4 and
    cancel to O(1), which TF32's 10-bit mantissa would turn into noise."""
    n = feats.shape[0]
    sq = (feats * feats).sum(dim=-1, keepdim=True)
    lhs = torch.cat([feats, -0.5 * sq, torch.full_like(sq, -0.5)], dim=1)
    rhs = torch.cat([feats, torch.ones_like(sq), sq], dim=1)
    out = torch.empty((n, values.shape[-1]), dtype=values.dtype, device=values.device)
    for i in range(0, n, chunk):
        g = (lhs[i:i + chunk] @ rhs.T).clamp_(max=0.0).exp_()
        out[i:i + chunk] = g @ values
    return out


def _normalized_message(filter_fn, q: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Symmetric-normalized filtered message restricted to valid pixels."""
    norm = filter_fn(valid)
    inv_sqrt = torch.where(norm > 1e-20, torch.rsqrt(norm), torch.zeros_like(norm))
    return filter_fn(q * inv_sqrt) * inv_sqrt


def _crf_core(img_pad: torch.Tensor, probs_pad: torch.Tensor, valid: torch.Tensor,
              iters: int, pos_w: float, pos_xy: float, bi_w: float, bi_xy: float,
              bi_rgb: float, reduce: int, use_lattice: bool = False) -> torch.Tensor:
    """One canvas: img_pad (P, P, 3) f32 0-255, probs_pad (P, P, C), valid
    (P, P) f32 {0, 1} -> (P, P) int32 labels. With ``use_lattice`` and
    ``reduce`` 1 the bilateral message goes through the permutohedral
    lattice; otherwise through the exact transform."""
    p = img_pad.shape[0]
    log_p = torch.log(probs_pad.clamp(1e-8, 1.0))
    rp = p // reduce
    if reduce == 1:
        img_r = img_pad
    else:
        # masked downsample: the canvas is zero outside the image, so the
        # reduced RGB features are renormalized by the reduced valid mask
        img_v = resize_bilinear((img_pad * valid[..., None])[None], (rp, rp))[0]
        w_v = resize_bilinear(valid[..., None][None], (rp, rp))[0]
        img_r = img_v / w_v.clamp_min(1e-6)
    grid = torch.arange(rp, dtype=torch.float32, device=img_pad.device) * reduce
    ys = grid[:, None].expand(rp, rp)
    xs = grid[None, :].expand(rp, rp)
    feats = torch.cat([torch.stack([xs / bi_xy, ys / bi_xy], dim=-1), img_r / bi_rgb],
                      dim=-1).reshape(rp * rp, 5)

    lat = build_lattice(feats) if reduce == 1 and use_lattice else None

    def bilateral(qmap):  # lattice at full resolution, or the exact transform
        if lat is not None:
            return apply_lattice(lat, qmap.reshape(p * p, -1)).reshape(p, p, -1)
        if reduce == 1:
            return _bilateral_exact_chunked(feats, qmap.reshape(p * p, -1)).reshape(p, p, -1)
        qr = resize_bilinear(qmap[None], (rp, rp))[0]
        out = _bilateral_exact_chunked(feats, qr.reshape(rp * rp, -1))
        return resize_bilinear(out.reshape(rp, rp, -1)[None], (p, p))[0]

    def spatial(qmap):
        return _spatial_filter(qmap, pos_xy)

    vmask = valid[..., None]
    q = torch.softmax(log_p, dim=-1) * vmask
    for _ in range(iters):
        m_pos = _normalized_message(spatial, q, vmask)
        m_bi = _normalized_message(bilateral, q, vmask)
        q = torch.softmax(log_p + pos_w * m_pos + bi_w * m_bi, dim=-1) * vmask
    return torch.argmax(q, dim=-1).to(torch.int32)


def _require_f32(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the CRF's bilateral distances need f32 products: TF32 is on "
            "(torch.backends.cuda.matmul.allow_tf32)")


def crf_labels_device(cfg, img_pad: torch.Tensor, probs_pad: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Mean-field on the device, one canvas after another: img_pad
    (B, P, P, 3) f32 0-255, probs_pad (B, P, P, C), valid (B, P, P) f32 ->
    (B, P, P) int32 refined labels, with the exact Gaussian transform at
    1/``cfg.crf_reduce`` resolution (1 = full resolution, about 16x the
    default's cost)."""
    _require_f32(img_pad)
    args = (int(cfg.crf_iter), float(cfg.crf_pos_w), float(cfg.crf_pos_xy),
            float(cfg.crf_bi_w), float(cfg.crf_bi_xy), float(cfg.crf_bi_rgb),
            int(cfg.crf_reduce))
    return torch.stack([_crf_core(img_pad[i], probs_pad[i], valid[i], *args)
                        for i in range(img_pad.shape[0])])


def _np_spatial_filter(q: np.ndarray, sigma: float) -> np.ndarray:
    gh, gw = _gauss_band(q.shape[0], sigma), _gauss_band(q.shape[1], sigma)
    y = np.tensordot(gh, q, axes=[[1], [0]])
    y = np.tensordot(gw, y, axes=[[1], [1]])
    return np.moveaxis(y, 0, 1)


def crf_refine_native(cfg, img: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Mean-field on the host with the port's C++ lattice
    (``native/build.py``) for the bilateral message, at full resolution:
    img (H, W, 3) uint8, probs (H, W, C) -> (H, W) int32 labels."""
    from cosa_tpu_torch.native.build import lattice_gaussian_cpu

    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    feats = np.concatenate([(xs / cfg.crf_bi_xy)[..., None], (ys / cfg.crf_bi_xy)[..., None],
                            img.astype(np.float32) / cfg.crf_bi_rgb], axis=-1).reshape(-1, 5)

    def bilateral(qmap):  # (H, W, K)
        return lattice_gaussian_cpu(feats, qmap.reshape(h * w, -1)).reshape(h, w, -1)

    def normalized(filter_fn, q):
        norm = filter_fn(np.ones((h, w, 1), np.float32))
        inv = np.where(norm > 1e-20, 1.0 / np.sqrt(norm), 0.0)
        return filter_fn(q * inv) * inv

    log_p = np.log(np.clip(probs, 1e-8, 1.0))
    q = probs.astype(np.float32)
    for _ in range(int(cfg.crf_iter)):
        m_pos = normalized(lambda x: _np_spatial_filter(x, cfg.crf_pos_xy), q)
        m_bi = normalized(bilateral, q)
        logits = log_p + cfg.crf_pos_w * m_pos + cfg.crf_bi_w * m_bi
        logits -= logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        q = e / e.sum(axis=-1, keepdims=True)
    return np.argmax(q, axis=-1).astype(np.int32)


def crf_refine_host(cfg, img: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One image: img (H, W, 3) uint8, probs (H, W, C) softmax seg probs ->
    the refined (H, W) int32 labels on the device of ``probs``, by
    ``cfg.crf_backend``:

      * ``"native"``: the host C++ lattice at full resolution; a failed g++
        build raises;
      * ``"jax"``: the single-image mean-field where the tensors lie, on the
        JAX package's zero canvas (500 for VOC12, else 640, or the image
        rounded up to a multiple of 4): the lattice when ``crf_reduce`` is
        1, else the exact transform at 1/``crf_reduce``.

    Any other backend raises."""
    if cfg.crf_backend == "native":
        lab = crf_refine_native(cfg, img.cpu().numpy(), probs.cpu().numpy())
        return torch.from_numpy(lab).to(probs.device)
    if cfg.crf_backend != "jax":
        raise ValueError(f"crf_refine_host takes crf_backend 'native' or 'jax', "
                         f"not {cfg.crf_backend!r}")
    h, w = img.shape[:2]
    pad = max(500 if cfg.dataset == "VOC12" else 640, h, w)
    pad = -(-pad // 4) * 4
    img_pad = probs.new_zeros((pad, pad, 3))
    img_pad[:h, :w] = img
    probs_pad = probs.new_zeros((pad, pad, probs.shape[-1]))
    probs_pad[:h, :w] = probs
    valid = probs.new_zeros((pad, pad))
    valid[:h, :w] = 1.0
    _require_f32(img_pad)
    out = _crf_core(img_pad, probs_pad, valid, int(cfg.crf_iter), float(cfg.crf_pos_w),
                    float(cfg.crf_pos_xy), float(cfg.crf_bi_w), float(cfg.crf_bi_xy),
                    float(cfg.crf_bi_rgb), int(cfg.crf_reduce), use_lattice=True)
    return out[:h, :w]
