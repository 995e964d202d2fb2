"""The port's CUDA kernels on an NVIDIA GPU (skipped without one).

Run on a GPU machine, where JAX (which tests/conftest.py imports) is
absent, with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds: K1 max abs error < 5e-3 against the plain f32 version, K2
relative error < 1e-2 (and two K1 or K2 calls agree bitwise); at a trained
state's statistics (peaked logits, cotangents of 1e-6 and 1e-9) each of
K1/K2's outputs within 2x the plain bf16 path's error against float64
plus 1e-3, and so where keys and values share a large mean (the TPU
kernel's form of dS fails there), K3 < 3e-4
against float64 with a bf16 store and < 1e-5 with an f32 store (its
polynomial cosine within 1e-6 of the same polynomial in torch), K4 max
abs error <= 1e-2 against its plain version with a cosine >= 0.9999
against K1 (chip_smoke.py holds the same kernels at the main path's
shapes). The opt-in path's torch ops on the card against the CPU: the
permutohedral lattice's integer structure equal, its filter within 1e-5
relative and bitwise repeatable; GMM thresholds and PAR within 1e-5; the
zoo's swin_tiny_test forward within 1e-4. The int8 dense on the card equal
to the CPU's bitwise, and refused outside torch._int_mm's shapes. Two gloo
ranks on the one card (data parallelism) against one process at the global
batch: losses within 5e-3 relative, the same launches per rank; K1 and K2
at tensor parallelism's local head count. A Swin-B forward's
``window_attn`` spans (none opened untraced, 24 profiled, K6's kernels
launched inside them) and its ``WINDOW_ATTN`` counts, equal to K6's
launches. K6 (Swin's window attention) at every stage of the Swin-B cell's
forwards and on a padded grid: each output and gradient within 1.1x the
plain bf16 version's error against float64 plus 1e-4; against the plain
bf16 version within 2^-7 with at most one value in 1000 different, its
table gradient within 1e-4 and bitwise repeatable; in f32 within 1e-5 of
the plain f32 version. K8 (the pseudo mask) at the cells' shapes, bf16 and
f32 CAMs, downscale 1 and 2, float and tensor thresholds, with PAR, on odd
canvases and boxes of negative ends: no label differs from the plain
chain's, and with PAR its low-res probabilities equal torch's softmax
bitwise."""

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
    dqkv = flash.attn_bwd(qkv, dout, lse, h, 0.125, nv).float()
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
    dqkv = flash.attn_bwd(qkv, dout, lse, h, 0.125, nv).float()
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
    _, lse = flash.attn_fwd(qkv, h, 0.125)
    one, two = (flash.attn_bwd(qkv, dout, lse, h, 0.125) for _ in range(2))
    assert torch.equal(one, two)


@pytest.mark.parametrize("n", [785, 1765])
def test_flash_fwd_twice_agrees_bitwise(gpu, n):
    """Two K1 calls on the same inputs agree bitwise, output and log-sum-exp,
    at both block sizes (64 queries at N = 785, 128 at 1765)."""
    from cosa_tpu_torch.kernels import flash

    b, h = 4, 12
    g = torch.Generator(device=gpu).manual_seed(2)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device=gpu).to(torch.bfloat16)
    (o1, l1), (o2, l2) = (flash.attn_fwd(qkv, h, 0.125) for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def _errors_against_f64(fn, qkv, dout, h, scale):
    """Relative errors in norm of ``fn``'s output and dq, dk, dv against
    float64 attention's, under the cotangent ``dout``."""
    from cosa_tpu_torch.cli.audit_attention import rel_err
    from cosa_tpu_torch.kernels import flash

    def run(f, x, d):
        x = x.detach().requires_grad_(True)
        o = f(x, h, scale)
        (gx,) = torch.autograd.grad(o, x, d.to(o.dtype))
        return o, gx.reshape(*gx.shape[:2], 3, -1)

    ro, rg = run(flash.f64_attention_qkv, qkv.double(), dout.double())
    o, gx = run(fn, qkv, dout)
    return [rel_err(o, ro)] + [rel_err(gx[:, :, i], rg[:, :, i]) for i in range(3)]


@pytest.mark.parametrize("dscale", [1e-6, 1e-9])
def test_flash_at_training_statistics(gpu, dscale):
    """K1/K2 at a trained state's statistics: q and k scaled so that the
    scaled logits' std is about 8 (rows dominated by a few keys) and the
    cotangent scaled by ``dscale``. Each of the output, dq, dk and dv within
    2x the plain bf16 path's relative error in norm against float64, plus
    1e-3 (cli/audit_attention.py's rule)."""
    from cosa_tpu_torch.kernels import flash

    b, h, n, scale = 4, 12, 785, 0.125
    g = torch.Generator(device=gpu).manual_seed(3)
    # scale * q.k over 64 dims has std scale * sigma^2 * 8 = sigma^2 here
    qkv = (torch.randn((b, n, 3 * h * 64), generator=g, device=gpu) * 8 ** 0.5).to(torch.bfloat16)
    dout = (torch.randn((b, n, h * 64), generator=g, device=gpu) * dscale).to(torch.bfloat16)
    x = qkv.reshape(b, n, 3, h, 64).double()
    s = torch.einsum("bqhd,bkhd->bhqk", x[:, :4, 0] * scale, x[:, :, 1])
    assert 6 < float(s.std()) < 10
    kern = _errors_against_f64(flash.flash_attention_qkv, qkv, dout, h, scale)
    plain = _errors_against_f64(flash.plain_attention_qkv, qkv, dout, h, scale)
    for what, k, p in zip(("out", "dq", "dk", "dv"), kern, plain):
        assert k <= 2 * p + 1e-3, (what, k, p)


@pytest.mark.parametrize("mean", [3.0, 10.0])
def test_flash_dq_where_keys_and_values_share_a_mean(gpu, mean):
    """K2's dq where the keys and the values of a head share a mean vector
    of ``mean`` times their spread, as they do in a trained ViT: dq = dS K
    then keeps only what dS's row sums leave of that mean. Held as
    test_flash_at_training_statistics holds K1/K2: within 2x the plain bf16
    path's error against float64, plus 1e-3. The TPU kernel's form of K2,
    dS from the bf16 P and delta from the bf16 output, reads a dq error of
    0.25 at mean 3 here (plain: 9.7e-3), computed in float64 with that
    form's roundings (cli/audit_attention.py::emulate_k2, "tpu")."""
    from cosa_tpu_torch.kernels import flash

    b, h, n, scale = 2, 12, 785, 0.125
    g = torch.Generator(device=gpu).manual_seed(4)
    q, k, v = (torch.randn((b, n, h, 64), generator=g, device=gpu) for _ in range(3))
    k = k + mean * torch.randn((1, 1, h, 64), generator=g, device=gpu)
    v = v + mean * torch.randn((1, 1, h, 64), generator=g, device=gpu)
    qkv = torch.stack([q, k, v], 2).reshape(b, n, -1).to(torch.bfloat16)
    dout = (torch.randn((b, n, h * 64), generator=g, device=gpu) * 1e-6).to(torch.bfloat16)
    kern = _errors_against_f64(flash.flash_attention_qkv, qkv, dout, h, scale)
    plain = _errors_against_f64(flash.plain_attention_qkv, qkv, dout, h, scale)
    for what, e_k, e_p in zip(("out", "dq", "dk", "dv"), kern, plain):
        assert e_k <= 2 * e_p + 1e-3, (what, e_k, e_p)


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


@pytest.mark.parametrize("m,k,n,dtype", [(200, 768, 2304, torch.bfloat16),
                                         (17, 3072, 768, torch.bfloat16),
                                         (40, 64, 256, torch.float32)])
def test_int8_matmul_on_the_card_equals_the_cpu(gpu, m, k, n, dtype):
    """The int8 dense (models/quant.py) through torch._int_mm: the codes and
    the int32 product are exact and the dequantize is the same IEEE
    operations, so the card equals the CPU's plain path bitwise."""
    from cosa_tpu_torch.models import quant

    g = torch.Generator().manual_seed(m + k)
    x = (torch.randn((2, m, k), generator=g) * 3).to(dtype)
    lin = torch.nn.Linear(k, n).requires_grad_(False)
    with torch.no_grad():
        lin.weight.normal_(0.0, k ** -0.5, generator=g)
        lin.bias.normal_(0.0, 0.1, generator=g)
    ref = quant.int8_matmul(x, lin, dtype)
    before = quant.LAUNCHES["int8_mm"]
    out = quant.int8_matmul(x.to(gpu), lin.to(gpu), dtype)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["int8_mm"] == before + 1
    assert out.dtype == dtype
    assert torch.equal(out.cpu(), ref)


def test_int8_product_outside_the_int_mm_limits_raises(gpu):
    """cuBLASLt's int8 product takes more than 16 rows and K, N multiples of
    8: a CUDA call outside those raises with its shape; nothing falls back
    to a float product."""
    from cosa_tpu_torch.models import quant

    a = torch.ones((16, 64), dtype=torch.int8, device=gpu)
    b = torch.ones((64, 32), dtype=torch.int8, device=gpu)
    with pytest.raises(ValueError, match=r"\(16, 64\)"):
        quant.int_mm(a, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(torch.ones((32, 60), dtype=torch.int8, device=gpu),
                     torch.ones((60, 32), dtype=torch.int8, device=gpu))
    lin = torch.nn.Linear(64, 36).to(gpu).requires_grad_(False)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(torch.ones((2, 20, 64), device=gpu), lin, torch.float32)


def test_gloo_dp2_on_one_card_matches_one_process(gpu):
    """Two ranks over gloo on the one card (parallel/launch.py), batch 2
    each, against one process at the global batch of 4 from the same state
    and batches: two steps' losses within 5e-3 relative (the bound of
    chip_smoke.py's phases 5 and 14), the same K1/K2/K3/K5/K8 launches on
    each rank as in the one process."""
    from cosa_tpu_torch.config import preset_config
    from cosa_tpu_torch.parallel.launch import spawn, steps_worker
    from cosa_tpu_torch.train.state import create_train_state

    kw = dict(backbone="vit_small_patch16_224", crop_size=64, energy_convention=0.6,
              warmup_iters=0)
    one_cfg = preset_config("synthetic", batch_size=4, **kw)
    state = create_train_state(one_cfg, "cpu")
    init = dict(student=state.student.state_dict(), teacher=state.teacher.state_dict())
    rng = np.random.default_rng(0)
    batches = [dict(wimg=rng.integers(0, 255, (4, 64, 64, 3)).astype(np.uint8),
                    simg=rng.integers(0, 255, (4, 64, 64, 3)).astype(np.uint8),
                    cls_label=(rng.random((4, 20)) > 0.8).astype(np.float32),
                    img_box=np.tile(np.array([[0, 64, 0, 64]], np.int32), (4, 1)))
               for _ in range(2)]
    one = steps_worker(0, one_cfg, gpu, init, batches)
    ranks = spawn(steps_worker, 2, preset_config("synthetic", batch_size=2, dp=2, **kw),
                  "cuda:0", init, batches)
    assert one["launches"] == {"flash_fwd": 2 * 48, "flash_bwd": 2 * 12, "rff_phi": 2,
                               "flash_fwd_bf16exp": 0, "flash_fwd_nomax": 0, "tta_fuse": 2,
                               "window_attn_fwd": 0, "window_attn_bwd": 0, "int8_mm": 0,
                               "cam2mask": 2 * 2, "cam2mask_probs": 0}
    for out in ranks:
        assert out["launches"] == one["launches"]
        for got, want in zip(out["metrics"], one["metrics"]):
            for k in ("overall_loss", "cls_loss", "cls_aux_loss", "seg_loss", "cam_loss",
                      "reg_loss"):
                assert abs(got[k] - want[k]) <= 5e-3 * abs(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("n", [197, 785, 1765])
def test_flash_kernels_at_the_tensor_parallel_head_count(gpu, n):
    """K1 and K2 at tp=2's local head count of ViT-B (6 of 12 heads, B*H
    = 24 at batch 4) and the main path's token counts."""
    _flash_vs_plain(gpu, 4, 6, n, None)


# the three cells' fuse shapes at crop 448: (B, CAM channels, CAM type,
# scales): VOC training, COCO training, VOC validation
TTA_FUSE_SHAPES = [
    (4, 20, torch.bfloat16, (1.0, 0.5, 1.5)),
    (8, 80, torch.bfloat16, (1.0, 0.5, 1.5)),
    (8, 20, torch.float32, (1.0, 0.5, 1.5, 0.75, 1.25)),
]


@pytest.mark.parametrize("b,n_cam,cam_dtype,scales", TTA_FUSE_SHAPES)
def test_tta_fuse_kernel_matches_plain(gpu, b, n_cam, cam_dtype, scales):
    """K5 against ``plain_tta_fuse`` on the card, every call of
    ``multi_scale_camseg`` one launch. The kernel rounds where the plain
    path rounds and contracts the interpolation's products into FMAs as
    torch's build of its bilinear kernels does (bitwise equal with torch
    2.11, CUDA 12.8). Another torch build may contract otherwise: a
    last-bit f32 difference can move one rounding of a bf16 value or
    partial sum by one ulp, which the normalization carries as about one
    bf16 ulp of a value below 1 (2^-8, 4e-3), and in f32 as a few f32 ulps
    of values up to 1 (1e-6). The seg sums add the same terms in the same
    order, up to that contraction (rtol 1e-6, atol 1e-4 on logits of
    order 10)."""
    _tta_fuse_vs_plain(gpu, b, n_cam, cam_dtype, scales, 16, 1)


# the Swin teacher's shapes: its CAM and seg logits on a 32-pixel grid, its
# aux CAM on a 16-pixel one (training, validation)
SWIN_TTA_FUSE_SHAPES = [
    (4, 20, torch.bfloat16, (1.0, 0.5, 1.5)),
    (8, 20, torch.float32, (1.0, 0.5, 1.5, 0.75, 1.25)),
]


@pytest.mark.parametrize("b,n_cam,cam_dtype,scales", SWIN_TTA_FUSE_SHAPES)
def test_tta_fuse_kernel_with_the_aux_cam_on_its_own_grid(gpu, b, n_cam, cam_dtype, scales):
    """K5 against ``plain_tta_fuse`` where the aux CAM's grid is twice as
    fine as the last scale's, as the Swin teacher gives it; the tolerances
    of the ViT shapes' test."""
    _tta_fuse_vs_plain(gpu, b, n_cam, cam_dtype, scales, 32, 2)


def _tta_fuse_vs_plain(gpu, b, n_cam, cam_dtype, scales, patch, aux_fine):
    """K5 and ``multi_scale_camseg`` against ``plain_tta_fuse`` on maps of a
    ``patch``-pixel grid at each scale of a 448 crop, the aux CAM's grid
    ``aux_fine`` times as fine."""
    from cosa_tpu_torch.kernels import tta_fuse as K
    from cosa_tpu_torch.objectives.pseudo import multi_scale_camseg

    g = torch.Generator(device=gpu).manual_seed(b * n_cam + len(scales))
    crop = 448
    grids = [int(s * crop) // patch for s in scales]
    maps = [dict(cam=torch.randn((2 * b, k, k, n_cam), generator=g, device=gpu) * 4,
                 cam_aux=torch.randn((2 * b, k * aux_fine, k * aux_fine, n_cam), generator=g,
                                     device=gpu) * 4,
                 seg=torch.randn((2 * b, k, k, n_cam + 1), generator=g, device=gpu) * 4)
            for k in grids]
    cams, segs = [m["cam"] for m in maps], [m["seg"] for m in maps]
    before = K.LAUNCHES["tta_fuse"]
    got = K.tta_fuse(cams, segs, maps[-1]["cam_aux"], (crop, crop), cam_dtype)
    assert K.LAUNCHES["tta_fuse"] - before == 1
    want = K.plain_tta_fuse(cams, segs, maps[-1]["cam_aux"], (crop, crop), cam_dtype)
    torch.cuda.synchronize()
    tol = 4e-3 if cam_dtype == torch.bfloat16 else 1e-6
    for name, x, r in zip(("cam", "cam_aux"), got[:2], want[:2]):
        assert x.dtype == torch.float32 and x.shape == r.shape == (b, crop, crop, n_cam)
        assert float((x - r).abs().max()) <= tol, name
    assert got[2].shape == (b, crop, crop, n_cam + 1)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-4)

    # multi_scale_camseg: one launch a call, the kernel's outputs
    feed = iter(maps)
    imgs = torch.zeros((b, crop, crop, 3), device=gpu)
    before = K.LAUNCHES["tta_fuse"]
    outs = multi_scale_camseg(lambda x: next(feed), imgs, scales, cam_dtype=cam_dtype)
    assert K.LAUNCHES["tta_fuse"] - before == 1
    assert all(torch.equal(a, r) for a, r in zip(outs, got))


def test_window_attn_span_and_counter_on_a_swin_b_forward(gpu, monkeypatch, tmp_path):
    """models/zoo/swin.py's ``window_attn`` span and ``WINDOW_ATTN`` counter
    on a Swin-B forward at 448 (bf16): untraced the span opens no
    ``record_function``; under the profiler the forward names 24
    ``window_attn`` events, one a block, and K6's 24 forward kernels were
    each launched inside one of them; the counter reads 24 calls, 12 of
    them masked (every second block of a stage wider than one window). K6
    runs every call: its forward launches equal the counter's calls, and a
    forward with gradients and its backward launch the backward kernel
    once a block."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from cosa_tpu_torch.config import preset_config
    from cosa_tpu_torch.kernels import window_attn as wk
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.models.zoo import swin as tswin
    from cosa_tpu_torch.utils import trace

    cfg = preset_config("VOC12", model="swinend2end", backbone="swin-b")
    net = build_model(cfg, gpu)
    x = torch.randn((2, 448, 448, 3), generator=torch.Generator(device=gpu).manual_seed(0),
                    device=gpu)
    opened = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function", lambda name: opened.append(name) or real(name))
    before = dict(tswin.WINDOW_ATTN)
    launched = dict(wk.LAUNCHES)
    with torch.no_grad():
        net(x)
        torch.cuda.synchronize()
        assert opened == []
        assert {k: tswin.WINDOW_ATTN[k] - before[k] for k in before} == {
            "calls": 24, "windows": 2 * (256 * 2 + 64 * 2 + 16 * 18 + 4 * 2), "masked_calls": 12}
        assert {k: wk.LAUNCHES[k] - launched[k] for k in launched} == {
            "window_attn_fwd": 24, "window_attn_bwd": 0}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    assert opened == ["window_attn"] * 24
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    assert sum(e.name == "window_attn" for e in host) == 24
    # each K6 forward kernel's launch lies inside a window_attn span
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("cat") == "user_annotation" and e.get("name") == "window_attn"]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    k6 = [launch.get(e["args"].get("correlation")) for e in ev
          if e.get("cat") == "kernel" and "winattn_fwd" in e.get("name", "")]
    assert len(spans) == 24 and len(k6) == 24
    assert all(t is not None and any(a <= t <= b for a, b in spans) for t in k6)

    launched = dict(wk.LAUNCHES)
    y = net(x, train=True, generator=torch.Generator(device=gpu).manual_seed(1))
    sum(v.float().sum() for v in y.values() if v.requires_grad).backward()
    torch.cuda.synchronize()
    assert {k: wk.LAUNCHES[k] - launched[k] for k in launched} == {
        "window_attn_fwd": 24, "window_attn_bwd": 24}


# The window-attention calls of the Swin-B cell (crop 448): (what, images,
# crop) of each forward (the student's batch, the teacher's images and
# their flips at each TTA scale), and a padded grid (a 500 x 400 image's
# stage 0 at window 7); head width 32, window 7, heads 4 x 2^stage
K6_FORWARDS = [("student", 4, 448), ("teacher", 8, 224), ("teacher", 8, 448),
               ("teacher", 8, 672)]


def _k6_case(gpu, images, grid, stage, seed, hw=None):
    """Seeded bf16 qkv, an f32 table (std 1, so the bias matters) and the
    block's shift or pad mask (None where the stage is one window) for the
    stage's grid; ``hw`` a ragged (h, w) grid padded to whole windows."""
    from cosa_tpu_torch.models.zoo.swin import _shift_mask

    hh, ww = hw or (grid, grid)
    hp, wp = -(-hh // 7) * 7, -(-ww // 7) * 7
    shift = 3 if min(hp, wp) > 7 else 0
    mask = None
    if shift or (hp, wp) != (hh, ww):
        mask = torch.from_numpy(_shift_mask(hp, wp, 7, shift, hh, ww)).to(gpu)
    bn, h = images * (hp // 7) * (wp // 7), 4 * 2 ** stage
    g = torch.Generator(device=gpu).manual_seed(seed)
    qkv = torch.randn((bn, 49, 3, h, 32), generator=g, device=gpu).to(torch.bfloat16)
    table = torch.randn((169, h), generator=g, device=gpu)
    cot = torch.randn((bn, 49, h * 32), generator=g, device=gpu).to(torch.bfloat16)
    return qkv, table, mask, cot


def _k6_outputs(fn, qkv, table, mask, cot):
    """(o, dq, dk, dv, dtable) of ``fn`` through autograd."""
    x = qkv.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)
    o = fn(x, t, 7, mask)
    dx, dt = torch.autograd.grad(o, (x, t), cot.to(o.dtype))
    return [o.detach(), dx[:, :, 0], dx[:, :, 1], dx[:, :, 2], dt]


def _k6_f64(qkv, table, window, mask):
    """The plain version in float64 throughout, with no rounding."""
    from cosa_tpu_torch.kernels import window_attn as wk

    return wk.plain_window_attention(qkv.double(), table, window, mask, torch.float64)


def _rel_err(a, ref) -> float:
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("what,images,crop", K6_FORWARDS)
@pytest.mark.parametrize("stage", range(4))
def test_window_attn_kernel_against_float64(gpu, what, images, crop, stage):
    """K6 (forward and backward) against the float64 version at one stage of
    one of the cell's forwards, unmasked and with the stage's shift mask,
    on the plain bf16 version's own error: each of o, dq, dk, dv and the
    table's gradient within 1.1x the plain version's largest error against
    float64 (relative to the reference's largest magnitude), plus 1e-4.
    K6 rounds where the plain version rounds (the scores, p and each
    product to bf16, the softmax in f32), so the two share their error
    against float64 (measured equal on an H100); what is left is the f32
    summation order of the products, which moves a bf16 rounding by one
    step in about one value in 20000."""
    from cosa_tpu_torch.kernels import window_attn as wk

    grid = crop // 4 // 2 ** stage
    qkv, table, mask, cot = _k6_case(gpu, images, grid, stage, seed=crop + stage)
    for m in ([None, mask] if mask is not None else [None]):
        got = _k6_outputs(wk.window_attention, qkv, table, m, cot)
        plain = _k6_outputs(wk.plain_window_attention, qkv, table, m, cot)
        ref = _k6_outputs(_k6_f64, qkv, table, m, cot)
        for name, a, p, r in zip(("o", "dq", "dk", "dv", "dtable"), got, plain, ref):
            err, tol = _rel_err(a, r), 1.1 * _rel_err(p, r) + 1e-4
            assert err <= tol, (name, m is not None, err, tol)


def test_window_attn_kernel_on_a_padded_grid(gpu):
    """K6 against float64 where the grid is padded to whole windows (a 500 x
    400 image's stage 0, 125 x 100 patches) under the shifted blocks' mask
    and the pad mask alone: the tolerances of the cell's shapes."""
    from cosa_tpu_torch.kernels import window_attn as wk

    for shifted in (True, False):
        qkv, table, mask, cot = _k6_case(gpu, 2, 0, 0, seed=5, hw=(125, 100))
        if not shifted:
            from cosa_tpu_torch.models.zoo.swin import _shift_mask

            mask = torch.from_numpy(_shift_mask(126, 105, 7, 0, 125, 100)).to(gpu)
        got = _k6_outputs(wk.window_attention, qkv, table, mask, cot)
        plain = _k6_outputs(wk.plain_window_attention, qkv, table, mask, cot)
        ref = _k6_outputs(_k6_f64, qkv, table, mask, cot)
        for name, a, p, r in zip(("o", "dq", "dk", "dv", "dtable"), got, plain, ref):
            err, tol = _rel_err(a, r), 1.1 * _rel_err(p, r) + 1e-4
            assert err <= tol, (name, shifted, err, tol)


@pytest.mark.parametrize("stage", range(4))
def test_window_attn_kernel_matches_plain_bf16(gpu, stage):
    """K6 against the plain bf16 version at the student's four stages (the
    shifted blocks): o, dq, dk and dv within two bf16 steps (2^-7) of the
    plain values' largest magnitude, at most one value in 1000 different
    (measured one in 20000: the products' f32 sums run in another order and
    move a rounding), the table's gradient within 1e-4 relative (f32 sums
    over every window, in another order); a second backward gives the same
    bits (the table's gradient is summed in a fixed order), and so does the
    table slice of a tensor-parallel rank."""
    from cosa_tpu_torch.kernels import window_attn as wk

    grid = 448 // 4 // 2 ** stage
    qkv, table, mask, cot = _k6_case(gpu, 4, grid, stage, seed=stage)
    got = _k6_outputs(wk.window_attention, qkv, table, mask, cot)
    plain = _k6_outputs(wk.plain_window_attention, qkv, table, mask, cot)
    for name, a, p in zip(("o", "dq", "dk", "dv"), got, plain):
        assert _rel_err(a, p.double()) <= 2 ** -7, name
        assert int((a != p).sum()) <= a.numel() // 1000, name
    assert _rel_err(got[4], plain[4].double()) <= 1e-4
    again = _k6_outputs(wk.window_attention, qkv, table, mask, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    # a rank's heads: the replicated table's column slice, its gradient
    # scattered back into the whole table
    h = table.shape[1]
    wide = torch.randn((169, 2 * h), generator=torch.Generator(device=gpu).manual_seed(9),
                       device=gpu).requires_grad_(True)
    o = wk.window_attention(qkv, wide[:, h:], 7, mask)
    (dwide,) = torch.autograd.grad(o, wide, cot)
    x = qkv.clone().requires_grad_(True)
    t = wide.detach()[:, h:].contiguous().requires_grad_(True)
    o2 = wk.window_attention(x, t, 7, mask)
    (dt,) = torch.autograd.grad(o2, t, cot)
    assert torch.equal(o, o2) and torch.equal(dwide[:, h:], dt)
    assert not dwide[:, :h].any()


@pytest.mark.parametrize("w,heads,hd", [(4, 1, 16), (4, 2, 8), (7, 4, 32), (8, 2, 24)])
def test_window_attn_kernel_in_f32(gpu, w, heads, hd):
    """K6's f32 storage (products on the CUDA cores in full f32) against the
    plain f32 version on the card (TF32 off): o and the gradients within
    1e-5 of each one's largest magnitude, the f32 sums' order alone apart
    (measured up to 5e-7)."""
    from cosa_tpu_torch.kernels import window_attn as wk
    from cosa_tpu_torch.models.zoo.swin import _shift_mask

    assert not torch.backends.cuda.matmul.allow_tf32
    grid = 2 * w
    mask = torch.from_numpy(_shift_mask(grid, grid, w, w // 2, grid, grid)).to(gpu)
    g = torch.Generator(device=gpu).manual_seed(w * hd)
    qkv = torch.randn((8, w * w, 3, heads, hd), generator=g, device=gpu)
    table = torch.randn(((2 * w - 1) ** 2, heads), generator=g, device=gpu)
    cot = torch.randn((8, w * w, heads * hd), generator=g, device=gpu)
    for m in (None, mask):
        x, t = qkv.clone().requires_grad_(True), table.clone().requires_grad_(True)
        o = wk.window_attention(x, t, w, m)
        got = [o.detach(), *torch.autograd.grad(o, (x, t), cot)]
        x, t = qkv.clone().requires_grad_(True), table.clone().requires_grad_(True)
        o = wk.plain_window_attention(x, t, w, m)
        want = [o.detach(), *torch.autograd.grad(o, (x, t), cot)]
        for a, r in zip(got, want):
            assert a.dtype == torch.float32
            assert _rel_err(a, r.double()) <= 1e-5


# K8's cases: (B, H, W, classes, CAM type, downscale, boxes): VOC and Swin-B
# training (a 448 crop, 20 classes), COCO training (80), the CAM grid
# itself (downscale 1), eval canvases of validation's threshold filters
# (the box [0, h - 1, 0, w - 1] of each image inside), and a small crop of
# 5 classes (torch's NCHW resize kernel) with boxes of negative ends
CAM2MASK_CASES = [
    (4, 448, 448, 20, torch.bfloat16, 2, "crop"),
    (4, 448, 448, 20, torch.float32, 2, "crop"),
    (8, 448, 448, 80, torch.bfloat16, 2, "crop"),
    (8, 448, 448, 80, torch.float32, 2, "crop"),
    (4, 448, 448, 20, torch.float32, 1, "crop"),
    (8, 448, 448, 80, torch.bfloat16, 1, "crop"),
    (2, 353, 500, 20, torch.float32, 2, "eval"),
    (8, 500, 500, 20, torch.float32, 2, "eval"),
    (3, 37, 53, 5, torch.float32, 2, "negative"),
    (3, 37, 53, 5, torch.bfloat16, 3, "negative"),
]


def _cam2mask_inputs(gpu, b, h, w, k, dtype, boxes, seed, shift=0.0):
    """Validated CAMs as the step makes them (smooth maps in [0, 1] of the
    present classes, 0 elsewhere, plus ``shift``), class labels (mean 1.5
    of 20, 3.5 of 80; the first image none, the last all), crop boxes."""
    g = torch.Generator(device=gpu).manual_seed(seed)
    rng = np.random.default_rng(seed)
    lab = (rng.random((b, k)) < (1.5 if k <= 20 else 3.5) / k).astype(np.float32)
    lab[0], lab[-1] = 0, 1
    lab = torch.from_numpy(lab).to(gpu)
    low = torch.rand((b, k, max(h // 32, 2), max(w // 32, 2)), generator=g, device=gpu)
    cams = torch.nn.functional.interpolate(low, (h, w), mode="bicubic", align_corners=False)
    cams = cams + 0.05 * torch.rand((b, k, h, w), generator=g, device=gpu)
    cams = (cams.clamp(0, 1).permute(0, 2, 3, 1) * lab[:, None, None, :] + shift).to(dtype)
    if boxes == "crop":
        side = rng.integers(h // 2, h + 1, (b, 2))
        off = (rng.random((b, 2)) * (h - side + 1)).astype(np.int64)
        box = np.stack([off[:, 0], off[:, 0] + side[:, 0], off[:, 1], off[:, 1] + side[:, 1]], 1)
    elif boxes == "eval":  # images of their own sizes on the canvas
        sizes = [(h - 7 * i, w - 11 * i) for i in range(b)]
        box = np.array([[0, hh - 1, 0, ww - 1] for hh, ww in sizes])
    else:
        box = np.array([[2, -3, -40, -1], [-20, h, 0, -5], [0, h, 0, w]][:b])
    return cams.contiguous(), lab, torch.from_numpy(box.astype(np.int64)).to(gpu)


def _differ(a, b) -> float:
    assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
    return float((a != b).double().mean())


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("b,h,w,k,dtype,downscale,boxes", CAM2MASK_CASES)
def test_cam2mask_kernel_matches_plain(gpu, b, h, w, k, dtype, downscale, boxes, tensors):
    """K8 against ``plain_cam2mask`` on the card, one launch a call, the
    thresholds as floats and as 0-d device tensors (the GMM's EMAs): no label
    differs. The kernel rounds the logits where the plain chain rounds,
    sums its softmax in torch's order and contracts the interpolation as
    torch's bilinear kernels do (bitwise equal probabilities with torch
    2.11, CUDA 12.8), so the labels are the plain chain's."""
    from cosa_tpu_torch.kernels import cam2mask as K

    cams, lab, box = _cam2mask_inputs(gpu, b, h, w, k, dtype, boxes, seed=b * k + downscale)
    hi, lo = (0.65, 0.25) if k == 80 else (0.7, 0.25)
    if tensors:
        hi, lo = (torch.tensor(v, device=gpu) for v in (hi, lo))
    if boxes == "eval":
        box = box.to(torch.int32)  # validation's boxes are int64 and the step's int32: both
    before = K.LAUNCHES["cam2mask"]
    got = K.cam2mask(box, cams, lab, hi, lo, downscale, 255)
    assert K.LAUNCHES["cam2mask"] - before == 1
    want = K.plain_cam2mask(box, cams, lab, hi, lo, downscale, 255)
    assert _differ(got, want) == 0.0
    assert (want == 255).any() and (want == 0).any()


def test_cam2mask_kernel_where_absent_classes_win(gpu):
    """CAMs near -1e5 and a background below it: the absent classes'
    probability is not 0 and the first absent class wins where no class is
    present, as every absent channel's does in the plain chain."""
    from cosa_tpu_torch.kernels import cam2mask as K

    for dtype in (torch.float32, torch.bfloat16):
        cams, lab, box = _cam2mask_inputs(gpu, 3, 64, 96, 20, dtype, "negative", 7,
                                          shift=-99990.0)
        got = K.cam2mask(box, cams, lab, -110000.0, -120000.0, 2, 255)
        want = K.plain_cam2mask(box, cams, lab, -110000.0, -120000.0, 2, 255)
        assert _differ(got, want) == 0.0
        assert ((want > 0) & (want != 255)).any()


@pytest.mark.parametrize("k", [20, 80])
def test_cam2mask_kernel_with_par(gpu, k):
    """With PAR: the kernel's low-res probabilities equal torch's softmax
    bitwise (both thresholds), and after the same refine step the labels
    equal the plain chain's; two launches a call."""
    from cosa_tpu_torch.kernels import cam2mask as K
    from cosa_tpu_torch.ops.par import par_refine

    cams, lab, box = _cam2mask_inputs(gpu, 2, 448, 448, k, torch.float32, "crop", 11)
    imgs = torch.rand((2, 448, 448, 3), device=gpu)
    hi, lo = torch.tensor(0.6, device=gpu), torch.tensor(0.3, device=gpu)
    seen = {"kernel": [], "plain": []}

    def refine(tag):
        def fn(images, probs):
            seen[tag].append(probs.clone())
            return par_refine(images, probs, dilations=(1, 2), num_iter=2)
        return fn

    before = dict(K.LAUNCHES)
    got = K.cam2mask(box, cams, lab, hi, lo, 2, 255, refine_fn=refine("kernel"), images=imgs)
    assert K.LAUNCHES["cam2mask"] - before["cam2mask"] == 1
    assert K.LAUNCHES["cam2mask_probs"] - before["cam2mask_probs"] == 1
    want = K.plain_cam2mask(box, cams, lab, hi, lo, 2, 255, refine_fn=refine("plain"),
                            images=imgs)
    for a, r in zip(seen["kernel"], seen["plain"]):
        assert a.shape == r.shape == (2, 224, 224, k + 1) and torch.equal(a, r)
    assert _differ(got, want) == 0.0


def test_cam2mask_refuses_what_the_kernel_does_not_take(gpu):
    from cosa_tpu_torch.kernels import cam2mask as K

    cams, lab, box = _cam2mask_inputs(gpu, 2, 64, 64, 5, torch.float32, "crop", 3)
    with pytest.raises(ValueError, match="cams"):
        K.cam2mask(box, cams.half(), lab, 0.7, 0.25)
    with pytest.raises(ValueError, match="0-d"):
        K.cam2mask(box, cams, lab, torch.tensor([0.7], device=gpu), 0.25)
    with pytest.raises(ValueError, match="img_box"):
        K.cam2mask(box.cpu(), cams, lab, 0.7, 0.25)
    with pytest.raises(ValueError, match="images"):
        K.cam2mask(box, cams, lab, 0.7, 0.25, refine_fn=lambda i, p: p)
