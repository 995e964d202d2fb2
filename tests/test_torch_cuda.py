"""The port's CUDA kernels on an NVIDIA GPU (skipped without one).

Run on a GPU machine, where JAX (which tests/conftest.py imports) is
absent, with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds: K1 max abs error < 5e-3 against the plain f32 version, K2
relative error < 1e-2 (and two K2 calls agree bitwise), K3 < 3e-4
against float64 with a bf16 store and < 1e-5 with an f32 store (its
polynomial cosine within 1e-6 of the same polynomial in torch), K4 max
abs error <= 1e-2 against its plain version with a cosine >= 0.9999
against K1 (chip_smoke.py holds the same kernels at the main path's
shapes). The opt-in path's torch ops on the card against the CPU: the
permutohedral lattice's integer structure equal, its filter within 1e-5
relative and bitwise repeatable; GMM thresholds and PAR within 1e-5; the
zoo's swin_tiny_test forward within 1e-4."""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,nv", [(100, None), (130, 97), (64, 64)])
def test_flash_kernels_match_plain(gpu, n, nv):
    from cosa_tpu_torch.kernels import flash

    b, h = 2, 3
    g = torch.Generator(device=gpu).manual_seed(n)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device=gpu).to(torch.bfloat16)
    dout = torch.randn((b, n, h * 64), generator=g, device=gpu).to(torch.bfloat16)
    o, lse = flash.attn_fwd(qkv, h, 0.125, nv)
    dqkv = flash.attn_bwd(qkv, o, dout, lse, h, 0.125, nv).float()
    x = qkv.float().requires_grad_(True)
    xs = x.reshape(b, n, 3, h, 64)
    ref = flash.plain_attention(xs[:, :, 0], xs[:, :, 1], xs[:, :, 2], 0.125, nv)
    ref = ref.reshape(b, n, h * 64)
    (gref,) = torch.autograd.grad(ref, x, dout.float())
    ref = ref.detach()
    assert float((o.float() - ref).abs().max()) < 5e-3
    for i in range(3):
        a = dqkv.reshape(b, n, 3, -1)[:, :, i]
        r = gref.reshape(b, n, 3, -1)[:, :, i]
        assert float((a - r).abs().max() / r.abs().max()) < 1e-2, i


def _flash_vs_plain(gpu, b, h, n, nv):
    """K1 and K2 against the plain f32 version on one seeded input: K1
    within 5e-3 plus the bf16 store's own rounding, half a bf16 step (at
    most 2^-8 |ref|: over few keys outputs reach |o| >= 2, where that step
    alone exceeds 5e-3); K2 relative error < 1e-2 for each of dq, dk, dv."""
    from cosa_tpu_torch.kernels import flash

    g = torch.Generator(device=gpu).manual_seed(n)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device=gpu).to(torch.bfloat16)
    dout = torch.randn((b, n, h * 64), generator=g, device=gpu).to(torch.bfloat16)
    o, lse = flash.attn_fwd(qkv, h, 0.125, nv)
    dqkv = flash.attn_bwd(qkv, o, dout, lse, h, 0.125, nv).float()
    x = qkv.float().requires_grad_(True)
    xs = x.reshape(b, n, 3, h, 64)
    ref = flash.plain_attention(xs[:, :, 0], xs[:, :, 1], xs[:, :, 2], 0.125, nv)
    ref = ref.reshape(b, n, h * 64)
    (gref,) = torch.autograd.grad(ref, x, dout.float())
    ref = ref.detach()
    assert bool(((o.float() - ref).abs() < 5e-3 + 2.0 ** -8 * ref.abs()).all())
    for i in range(3):
        a = dqkv.reshape(b, n, 3, -1)[:, :, i]
        r = gref.reshape(b, n, 3, -1)[:, :, i]
        assert float((a - r).abs().max() / r.abs().max()) < 1e-2, i


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("n,nv", [
    (20, None),   # fewer tokens than one tile
    (300, 70),    # n_valid ends in the first key tile: whole tiles masked
    (128, None),  # exactly one 128-row tile
    (129, None),  # one row past it
    (129, 100),
])
def test_flash_kernels_at_the_tile_edges(gpu, monkeypatch, rows, n, nv):
    """K1 at both block sizes, and K2, at the edges of their tiles."""
    from cosa_tpu_torch.kernels import flash

    monkeypatch.setattr(flash, "BLOCK_128_ABOVE", -1 if rows == 128 else 1 << 30)
    assert flash.block_rows(n) == rows
    _flash_vs_plain(gpu, 2, 3, n, nv)


@pytest.mark.parametrize("n,want", [(1024, 64), (1025, 128)])
def test_flash_block_choice_on_each_side_of_the_switch(gpu, n, want):
    """The launcher takes 64 queries per block up to 1024 tokens and 128
    above, and K1 and K2 hold on each side."""
    from cosa_tpu_torch.kernels import flash

    assert flash.block_rows(n) == want
    _flash_vs_plain(gpu, 2, 3, n, n - 30)


@pytest.mark.parametrize("b", [1, 4])
def test_flash_bwd_twice_agrees_bitwise(gpu, b):
    """K2's key blocks add their shares of dq into one sum, in an order
    that varies from call to call, as 64-bit fixed point: integer sums do
    not depend on their order, so two calls on the same inputs agree
    bitwise."""
    from cosa_tpu_torch.kernels import flash

    h, n = 12, 785
    g = torch.Generator(device=gpu).manual_seed(1)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device=gpu).to(torch.bfloat16)
    dout = torch.randn((b, n, h * 64), generator=g, device=gpu).to(torch.bfloat16)
    o, lse = flash.attn_fwd(qkv, h, 0.125)
    one, two = (flash.attn_bwd(qkv, o, dout, lse, h, 0.125) for _ in range(2))
    assert torch.equal(one, two)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-4), (torch.float32, 1e-5)])
def test_rff_kernel_matches_float64(gpu, dtype, tol):
    from cosa_tpu_torch.kernels import rff
    from cosa_tpu_torch.ops.bilateral import _rff_params, rff_embed

    f = np.random.default_rng(2).standard_normal((2, 896, 5)).astype(np.float32) * 4
    w, b = _rff_params(1024, 5, 0)
    sc = math.sqrt(2 / 1024)
    before = rff.LAUNCHES["rff_phi"]
    phi = rff.rff_phi(torch.from_numpy(f).to(gpu), torch.from_numpy(w).to(gpu),
                      torch.from_numpy(b).to(gpu), sc, dtype)
    assert phi.dtype == dtype
    ref = sc * np.cos(f.astype(np.float64) @ w + b)
    assert np.abs(phi.float().cpu().numpy() - ref).max() < tol
    # the op that the energy loss calls launches the kernel for either store
    emb = rff_embed(torch.from_numpy(f).to(gpu), 1024, 0, dtype)
    assert rff.LAUNCHES["rff_phi"] - before == 2
    assert torch.equal(emb, phi)


def test_train_steps_launch_every_kernel(gpu, tmp_path):
    from cosa_tpu_torch.config import preset_config
    from cosa_tpu_torch.kernels import flash, rff
    from cosa_tpu_torch.train.loop import train

    cfg = preset_config("synthetic", backbone="vit_small_patch16_224", crop_size=64,
                        max_iters=2, eval_iters=100, log_iters=1, finalval=False,
                        work_dir=str(tmp_path))
    before = {**flash.LAUNCHES, **rff.LAUNCHES}
    res = train(cfg)
    after = {**flash.LAUNCHES, **rff.LAUNCHES}
    depth = 12
    assert after["flash_fwd"] - before["flash_fwd"] == 2 * depth * 4
    assert after["flash_bwd"] - before["flash_bwd"] == 2 * depth
    assert after["rff_phi"] - before["rff_phi"] == 2 + 2  # steps + calibration probes
    assert all(np.isfinite(r["overall_loss"]) for r in res["records"])


@pytest.mark.parametrize("n,nv", [(786, None), (786, 749), (1766, None)])
def test_flash_kernels_at_the_distilled_token_counts(gpu, n, nv):
    """K1 and K2 at the distilled DeiT's token counts (two prefix tokens:
    784 + 2 and 1764 + 2 at crop 448 and its 1.5 scale), 12 heads."""
    _flash_vs_plain(gpu, 2, 12, n, nv)


def test_train_steps_distilled_maskformer(gpu, tmp_path):
    """Two steps of a distilled DeiT with the MaskTransformer decoder: the
    encoder launches K1 and K2 as the ViT does, the decoder none."""
    from cosa_tpu_torch.config import preset_config
    from cosa_tpu_torch.kernels import flash, rff
    from cosa_tpu_torch.train.loop import train

    cfg = preset_config("synthetic", backbone="deit_small_distilled_patch16_224",
                        decoder="Maskformer", crop_size=64, max_iters=2, eval_iters=100,
                        log_iters=1, finalval=False, work_dir=str(tmp_path))
    before = {**flash.LAUNCHES, **rff.LAUNCHES}
    res = train(cfg)
    after = {**flash.LAUNCHES, **rff.LAUNCHES}
    assert after["flash_fwd"] - before["flash_fwd"] == 2 * 12 * 4
    assert after["flash_bwd"] - before["flash_bwd"] == 2 * 12
    assert all(np.isfinite(r["overall_loss"]) for r in res["records"])


@pytest.mark.parametrize("n,nv", [(442, None), (442, 405), (1226, None), (1226, 1189)])
def test_flash_fwd_at_the_eval_token_counts(gpu, n, nv):
    """K1 at the evaluation's extra scales (0.75 and 1.25 of crop 448),
    whose key tiles end ragged (442 = 6 * 64 + 58, 1226 = 19 * 64 + 10)."""
    from cosa_tpu_torch.kernels import flash

    b, h = 2, 12
    g = torch.Generator(device=gpu).manual_seed(n)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device=gpu).to(torch.bfloat16)
    o, _ = flash.attn_fwd(qkv, h, 0.125, nv)
    xs = qkv.float().reshape(b, n, 3, h, 64)
    ref = flash.plain_attention(xs[:, :, 0], xs[:, :, 1], xs[:, :, 2], 0.125, nv)
    assert float((o.float() - ref.reshape(b, n, h * 64)).abs().max()) < 5e-3


@pytest.mark.parametrize("n,nv", [(64, None), (128, None), (130, None), (200, 163),
                                  (785, None)])
@pytest.mark.parametrize("mode", ["bf16exp", "nomax"])
@pytest.mark.parametrize("rows", [64, 128])
def test_flash_variant_kernel_matches_plain(gpu, monkeypatch, rows, mode, n, nv):
    """K4 at both of K1's block sizes and at the edges of its tiles, against
    its plain version in f32 (max abs <= 1e-2) and against K1 at the same
    block size on the same input (cosine >= 0.9999)."""
    from cosa_tpu_torch.kernels import flash, flash_variants

    monkeypatch.setattr(flash, "BLOCK_128_ABOVE", -1 if rows == 128 else 1 << 30)
    b, h = 2, 3
    g = torch.Generator(device=gpu).manual_seed(n)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device=gpu).to(torch.bfloat16)
    before = flash_variants.LAUNCHES[f"flash_fwd_{mode}"]
    o = flash_variants.attn_fwd_variant(qkv, h, 0.125, nv, mode)
    assert flash_variants.LAUNCHES[f"flash_fwd_{mode}"] == before + 1
    x = qkv.reshape(b, n, 3, h, 64).permute(2, 0, 3, 1, 4).reshape(3, b * h, n, 64)
    ref = flash_variants.plain_attend_variant(x[0], x[1], x[2], 0.125, nv, mode)
    ref = ref.reshape(b, h, n, 64).permute(0, 2, 1, 3).reshape(b, n, h * 64)
    assert float((o.float() - ref).abs().max()) <= 1e-2
    k1 = flash.attn_fwd(qkv, h, 0.125, nv)[0].float()
    cos = float((o.float() * k1).sum() / (o.float().norm() * k1.norm()))
    assert cos >= 0.9999


@pytest.mark.parametrize("d", [256, 1024])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-4), (torch.float32, 1e-5)])
def test_rff_kernel_at_a_ragged_row_count(gpu, dtype, tol, d):
    """K3 over 50001 rows against float64: no multiple of a block's 2 or 8
    rows, and more than twice the grid's stride (the resident blocks times
    a block's rows, at most 132 * 8 * 8 at D = 256), so every thread runs
    the two-row loop and some take the odd last row. And the kernel's
    cosine (f32 store, scale 1, the phase p itself: w = e_0, b = 0) against
    the polynomial in torch on the same phases. Within 1e-6 at |p| <= pi,
    where both take r = p (FMAs against separate roundings in the
    polynomial); at |p| <= 256 within 1.6e-5: the kernel forms
    r = p - 2 pi k in one FMA, torch rounds the product 2 pi k (< 512)
    first, half an ulp of it, 1.53e-5, apart."""
    from cosa_tpu_torch.kernels import rff
    from cosa_tpu_torch.ops.bilateral import _rff_params

    rows = 50_001
    props = torch.cuda.get_device_properties(gpu)
    threads_per_block, groups = 256, d // 8
    stride = (props.multi_processor_count * props.max_threads_per_multi_processor
              // threads_per_block) * (threads_per_block // groups)
    assert rows > 2 * stride and rows % 2
    rng = np.random.default_rng(d)
    f = np.concatenate([rng.uniform(0, 4.5, (1, rows, 2)),
                        rng.uniform(0, 17, (1, rows, 3))], axis=-1).astype(np.float32)
    w, b = _rff_params(d, 5, 0)
    sc = math.sqrt(2 / d)
    phi = rff.rff_phi(torch.from_numpy(f).to(gpu), torch.from_numpy(w).to(gpu),
                      torch.from_numpy(b).to(gpu), sc, dtype)
    ref = sc * np.cos(f.astype(np.float64) @ w + b)
    assert phi.dtype == dtype and phi.shape == (1, rows, d)
    assert np.abs(phi.float().cpu().numpy() - ref).max() < tol

    we = torch.zeros((5, d), device=gpu)
    we[0] = 1.0
    for lim, bound in ((math.pi, 1e-6), (256.0, 1.6e-5)):
        p = torch.from_numpy(rng.uniform(-lim, lim, (1, rows)).astype(np.float32)).to(gpu)
        fp = torch.zeros((1, rows, 5), device=gpu)
        fp[..., 0] = p
        cos = rff.rff_phi(fp, we, torch.zeros(d, device=gpu), 1.0, torch.float32)
        want = rff.plain_cos_poly(p)[..., None].expand(1, rows, d)
        assert float((cos - want).abs().max()) <= bound


def test_crf_bilateral_product_needs_f32(gpu):
    """The CRF's squared distances cancel terms near 1e4: in f32 the
    bilateral product stays within 1e-3 of float64, under TF32 it does not
    (so this input would catch TF32 on the path), and the CRF refuses to
    run with TF32 on."""
    from cosa_tpu_torch.config import preset_config
    from cosa_tpu_torch.eval import crf
    from cosa_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # the path's setting: TF32 off
    rng = np.random.default_rng(6)
    feats = (rng.random((2048, 5)) * [5, 5, 51, 51, 51]).astype(np.float32)
    vals = rng.random((2048, 21)).astype(np.float32)
    f64 = feats.astype(np.float64)
    exact = np.exp(-0.5 * ((f64[:, None] - f64[None]) ** 2).sum(-1)) @ vals
    f, v = torch.from_numpy(feats).to(gpu), torch.from_numpy(vals).to(gpu)
    err = np.abs(crf._bilateral_exact_chunked(f, v, 512).cpu().numpy() - exact).max()
    assert err <= 1e-3 * np.abs(exact).max()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err32 = np.abs(crf._bilateral_exact_chunked(f, v, 512).cpu().numpy() - exact).max()
        assert err32 > 1e-2 * np.abs(exact).max()
        z = torch.zeros((1, 16, 16, 3), device=gpu)
        with pytest.raises(RuntimeError, match="TF32"):
            crf.crf_labels_device(preset_config("synthetic"), z, z, z[..., 0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _lattice_inputs(b=2, side=64, k=21):
    """Energy-like features (xy / 50, rgb / 15) of random images, and
    softmax values."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (b, side, side, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:side, 0:side].astype(np.float32)
    xy = np.broadcast_to(np.stack([xs, ys], -1)[None], (b, side, side, 2)) / 50.0
    feats = np.concatenate([xy, img / 15.0], -1).reshape(b, -1, 5).astype(np.float32)
    logits = rng.standard_normal((b, side * side, k)).astype(np.float32)
    vals = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return torch.from_numpy(feats), torch.from_numpy(vals.astype(np.float32))


def test_lattice_on_the_card_matches_the_cpu(gpu):
    """The lattice built on the card equals the CPU's (every integer field
    exactly, bary within 1e-5); the filter agrees within 1e-5 relative."""
    from cosa_tpu_torch.ops.permutohedral import apply_lattice, build_lattice

    f, v = _lattice_inputs()
    cpu, card = build_lattice(f), build_lattice(f.to(gpu))
    for name in ("uid", "nbr_idx", "nbr_ok", "order", "counts"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    assert float((card.bary.cpu() - cpu.bary).abs().max()) <= 1e-5
    ref = apply_lattice(cpu, v)
    out = apply_lattice(card, v.to(gpu)).cpu()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_lattice_applies_twice_bitwise(gpu):
    """The splat sums each lattice row in the sorted order: two builds and
    two applies on the card agree bitwise."""
    from cosa_tpu_torch.ops.permutohedral import apply_lattice, build_lattice

    f, v = (t.to(gpu) for t in _lattice_inputs(b=4, side=96))
    one, two = build_lattice(f), build_lattice(f)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(apply_lattice(one, v), apply_lattice(two, v))
    assert torch.equal(apply_lattice(one, v, with_norm=True),
                       apply_lattice(one, v, with_norm=True))


def test_gmm_and_par_on_the_card_match_the_cpu(gpu):
    """GMM thresholds within 1e-5 and PAR within 1e-5 (largest value) of
    the CPU's result on the same inputs."""
    from cosa_tpu_torch.ops.gmm import gmm_thresholds
    from cosa_tpu_torch.ops.par import par_refine

    rng = np.random.default_rng(9)
    q = np.concatenate([rng.normal(0.15, 0.05, 2000), rng.normal(0.5, 0.08, 1500),
                        rng.normal(0.85, 0.05, 1500)]).clip(0, 1).astype(np.float32)
    q = torch.from_numpy(q.reshape(10, 500))
    for a, b in zip(gmm_thresholds(q.to(gpu), 0.05, 3, 100, 8),
                    gmm_thresholds(q, 0.05, 3, 100, 8)):
        assert a.is_cuda and abs(float(a) - float(b)) <= 1e-5
    imgs = torch.from_numpy(rng.random((2, 48, 40, 3)).astype(np.float32))
    masks = torch.softmax(torch.from_numpy(rng.standard_normal((2, 24, 20, 5)).astype(
        np.float32)), -1)
    ref = par_refine(imgs, masks, num_iter=4)
    out = par_refine(imgs.to(gpu), masks.to(gpu), num_iter=4).cpu()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_swin_tiny_forward_on_the_card_matches_the_cpu(gpu):
    """swin_tiny_test's SwinNetwork in f32 (TF32 off, utils/device.py), one
    seeded init on both sides, a 60 input (padded windows): every output
    on the card within 1e-4 of the CPU's."""
    from cosa_tpu_torch.config import preset_config
    from cosa_tpu_torch.models.network import build_model

    cfg = preset_config("synthetic", model="swinend2end", backbone="swin_tiny_test",
                        num_classes=6, mixed_precision=False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 60, 60, 3)).astype(
        np.float32))
    with torch.no_grad():
        ref = build_model(cfg, "cpu")(x)
        out = build_model(cfg, gpu)(x.to(gpu))
    for k, v in ref.items():
        assert float((out[k].cpu() - v).abs().max()) <= 1e-4, k
