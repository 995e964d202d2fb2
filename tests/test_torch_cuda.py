"""The port's CUDA kernels on an NVIDIA GPU (skipped without one).

Run on a GPU machine, where JAX (which tests/conftest.py imports) is
absent, with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds: K1 max abs error < 5e-3 against the plain f32 version, K2
relative error < 1e-2, K3 < 3e-4 against float64 with a bf16 store and
< 1e-5 with an f32 store (chip_smoke.py holds the same kernels at the
main path's shapes)."""

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
