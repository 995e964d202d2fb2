"""1-D Gaussian-mixture EM for adaptive CAM thresholds, on the device.

Port of the JAX package's ops/gmm.py. The reference fits a 3-component
sklearn GaussianMixture on a host-side queue of CAM maxima every step
(utils/seg_helper.py:924-943); here the queue lives in the train state and
the EM is a fixed number of mask-weighted updates on the queue's device.
As in the JAX package: fixed ``iters`` EM steps instead of sklearn's
tolerance stop, the filter ``queue > filter_thre`` as a weight mask, and the
mixture fitted on a strided subsample of the queue, then one assignment
pass over the whole queue. Nothing here reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_REG_COVAR = 1e-6  # sklearn's default regularization
_BIG = 1e30


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum()
    xs = torch.sort(torch.where(mask, x, _BIG)).values
    lo = xs.gather(0, ((n - 1) // 2).clamp_min(0).reshape(1))
    hi = xs.gather(0, (n // 2).clamp_min(0).reshape(1))
    return (0.5 * (lo + hi))[0]


def _log_prob(x, means, vs, ws):
    """(N, K) weighted log-densities of each point under each component."""
    return (-0.5 * (x[:, None] - means[None, :]) ** 2 / vs[None, :]
            - 0.5 * torch.log(2 * math.pi * vs[None, :])
            + torch.log(ws[None, :]))


def fit_gmm_1d(x: torch.Tensor, mask: torch.Tensor, n_components: int = 3,
               iters: int = 25):
    """Weighted EM on 1-D data. x: (N,), mask: (N,) bool.

    The init follows the reference (seg_helper.py:930-937): means at
    [min, median, max] ([min, max] for 2 components), unit variances,
    uniform weights. Returns (means, vars, weights, responsibilities (N, K))."""
    x = x.to(torch.float32)
    m = mask.to(torch.float32)
    n = m.sum().clamp_min(1.0)

    mn = torch.where(mask, x, _BIG).min()
    mx = torch.where(mask, x, -_BIG).max()
    if n_components == 3:
        means = torch.stack([mn, _masked_median(x, mask), mx])
    elif n_components == 2:
        means = torch.stack([mn, mx])
    else:
        raise ValueError(n_components)
    vs = torch.ones((n_components,), dtype=torch.float32, device=x.device)
    ws = torch.full((n_components,), 1.0 / n_components, dtype=torch.float32,
                    device=x.device)
    for _ in range(iters):
        resp = torch.softmax(_log_prob(x, means, vs, ws), dim=1) * m[:, None]
        nk = resp.sum(dim=0) + 1e-10
        means = (resp * x[:, None]).sum(dim=0) / nk
        vs = (resp * (x[:, None] - means[None, :]) ** 2).sum(dim=0) / nk + _REG_COVAR
        ws = nk / n
    resp = torch.softmax(_log_prob(x, means, vs, ws), dim=1)
    return means, vs, ws, resp


def gmm_thresholds(queue: torch.Tensor, filter_thre: float = 0.05,
                   n_components: int = 3, iters: int = 25,
                   em_subsample: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference ``rungmm`` (seg_helper.py:924-943): fit on the queue values
    above ``filter_thre`` (every ``em_subsample``-th of them); low = the
    largest value assigned to the lowest component, high = the smallest
    assigned to the highest. Returns two 0-d tensors on the queue's device."""
    x = queue.reshape(-1)
    mask = x > filter_thre
    stride = max(em_subsample, 1)
    means, vs, ws, _ = fit_gmm_1d(x[::stride], mask[::stride], n_components, iters)
    # assign the whole queue with the fitted parameters, components ordered
    # by mean so 0 is the lowest mode and K-1 the highest
    order = torch.argsort(means)
    pred = torch.argmax(_log_prob(x, means, vs, ws)[:, order], dim=1)
    low = torch.where(mask & (pred == 0), x, -_BIG).max()
    high = torch.where(mask & (pred == n_components - 1), x, _BIG).min()
    return low, high
