"""Permutohedral-lattice Gaussian filtering, batched, in plain PyTorch.

Port of the JAX package's ops/permutohedral.py (Adams, Baek & Davis,
"Fast High-Dimensional Filtering Using the Permutohedral Lattice", 2010):
the reference's dense-energy loss and DenseCRF both reduce to
``out = G @ values`` with ``G_ij = exp(-|f_i - f_j|^2 / 2)``, which the
reference computes with Krähenbühl's C++ lattice (a hash table). Here:

  embed    the hyperplane projection as prefix sums;
  simplex  enclosing-simplex ranks from one stable argsort over d+1 residuals;
  hashing  lattice keys packed into a lexicographic triple (15 bits per
           coordinate), so the hash table becomes two stable sorts, a
           cumulative sum and a batched binary search;
  splat    a segment sum over the N*(d+1) (vertex, weight) pairs, taken in
           the sorted order: every lattice row sums its terms in one fixed
           order, so two applies agree bitwise on any device;
  blur     d+1 passes of the [1/2, 1, 1/2] stencil through precomputed
           neighbour rows;
  slice    a barycentric gather.

Every shape is static: the lattice is padded to m = N*(d+1) rows, and the
rows past the last vertex hold int32 max in each key column, so building
needs no data-dependent shape and no host sync. The build
(:func:`build_lattice`) depends only on the features; :func:`apply_lattice`
filters values through a built lattice with gathers and one segment sum.
Both take one image, (N, d), or a batch, (B, N, d), with one lattice per
image.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BITS = 15  # per-coordinate bits inside one packed column (2 coords / column)
_OFF = 1 << (_BITS - 1)
_BIG = np.iinfo(np.int32).max  # key columns of the padding rows


def _elevate(f: torch.Tensor) -> torch.Tensor:
    """(B, N, d) features -> (B, N, d+1) hyperplane embedding."""
    d = f.shape[-1]
    inv_std = np.sqrt(2.0 / 3.0) * (d + 1)
    scale = torch.tensor([inv_std / np.sqrt((i + 1) * (i + 2)) for i in range(d)],
                         dtype=torch.float32, device=f.device)
    cf = f * scale
    rev_cumsum = torch.flip(torch.cumsum(torch.flip(cf, (-1,)), dim=-1), (-1,))
    j = torch.arange(1, d + 1, dtype=torch.float32, device=f.device)
    tail = torch.cat([rev_cumsum[..., 1:], torch.zeros_like(cf[..., :1])], dim=-1)
    return torch.cat([rev_cumsum[..., :1], tail - j * cf], dim=-1)


def _simplex(elevated: torch.Tensor):
    """Enclosing simplex: greedy rounding and rank fix-up.

    Returns (rem0 (B, N, d+1) int32, rank (B, N, d+1) int64, bary (B, N, d+1) f32)."""
    dp1 = elevated.shape[-1]
    d = dp1 - 1
    v = elevated / dp1
    up = torch.ceil(v) * dp1
    down = torch.floor(v) * dp1
    rem0 = torch.where(up - elevated < elevated - down, up, down)

    order = torch.argsort(-(elevated - rem0), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)

    h = torch.round(rem0.sum(dim=-1) / dp1).to(torch.int64)
    rank = rank + h[..., None]
    fix = torch.where(rank < 0, dp1, 0) - torch.where(rank > d, dp1, 0)
    rem0 = rem0 + fix
    rank = rank + fix

    t = (elevated - rem0) / dp1
    bary = torch.zeros(elevated.shape[:-1] + (d + 2,), dtype=torch.float32,
                       device=elevated.device)
    bary.scatter_add_(-1, d - rank, t)
    bary.scatter_add_(-1, d + 1 - rank, -t)
    bary[..., 0] += 1.0 + bary[..., d + 1]
    return rem0.to(torch.int32), rank, bary[..., :dp1]


def _pack3(keys: torch.Tensor):
    """(..., d<=6) int coords -> the lexicographic triple as two int64 keys:
    hi = col0 * 2^31 + col1 and lo = col2, each column two 15-bit coords."""
    d = keys.shape[-1]
    k = torch.clamp(keys.to(torch.int64) + _OFF, 0, (1 << _BITS) - 1)
    zero = torch.zeros_like(k[..., 0])
    cols = []
    for i in range(0, 6, 2):
        a = k[..., i] if i < d else zero
        b = k[..., i + 1] if i + 1 < d else zero
        cols.append((a << _BITS) | b)
    return (cols[0] << 31) | cols[1], cols[2]


def _searchsorted3(s_hi: torch.Tensor, s_lo: torch.Tensor,
                   q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Left-insertion index of each (B, Q) query into the lexicographically
    sorted (B, M) keys of its row: a batched binary search of
    ceil(log2 M) + 1 gather rounds."""
    m = s_hi.shape[-1]
    steps = int(np.ceil(np.log2(max(m, 2))))
    lo = torch.zeros_like(q_hi)
    hi = torch.full_like(q_hi, m)
    for _ in range(steps + 1):
        mid = (lo + hi) >> 1
        midc = mid.clamp(0, m - 1)
        a_hi, a_lo = s_hi.gather(-1, midc), s_lo.gather(-1, midc)
        less = (a_hi < q_hi) | ((a_hi == q_hi) & (a_lo < q_lo))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


class Lattice(NamedTuple):
    """A built lattice (everything that does not depend on the filtered
    values), for one image (shapes below) or with a leading batch axis.

    ``uid``, ``bary``, ``nbr_idx`` and ``nbr_ok`` are the JAX package's
    fields; ``order`` and ``counts`` give the splat its sorted order."""

    uid: torch.Tensor      # (n*(d+1),) int64: lattice row of each (point, vertex)
    bary: torch.Tensor     # (n, d+1) f32: barycentric splat/slice weights
    nbr_idx: torch.Tensor  # (d+1, 2, m) int64: blur neighbour row (clipped)
    nbr_ok: torch.Tensor   # (d+1, 2, m) bool: the neighbour exists
    order: torch.Tensor    # (m,) int64: (point, vertex) pairs sorted by row
    counts: torch.Tensor   # (m,) int64: pairs per lattice row


def _batched(lat: Lattice) -> Lattice:
    return Lattice(*(x[None] for x in lat))


def build_lattice(features: torch.Tensor) -> Lattice:
    """The lattice of (N, d) features, or one lattice per image of (B, N, d)."""
    if features.dim() == 2:
        return Lattice(*(x[0] for x in build_lattice(features[None])))
    b, n, d = features.shape
    dp1 = d + 1
    m = n * dp1
    dev = features.device
    rem0, rank, bary = _simplex(_elevate(features.to(torch.float32)))

    # the d+1 vertices of each point's simplex: (B, N, d+1, d)
    r = torch.arange(dp1, device=dev)[:, None]
    off = torch.where(rank[:, :, None, :] >= dp1 - r, r - dp1, r).to(torch.int32)
    flat_keys = (rem0[:, :, None, :] + off)[..., :d].reshape(b, m, d)
    k_hi, k_lo = _pack3(flat_keys)

    # lexicographic order by two stable sorts (the low key first)
    order = torch.argsort(k_lo, dim=-1, stable=True)
    order = order.gather(-1, torch.argsort(k_hi.gather(-1, order), dim=-1, stable=True))
    s_hi, s_lo = k_hi.gather(-1, order), k_lo.gather(-1, order)
    is_new = torch.ones_like(s_hi, dtype=torch.bool)
    is_new[:, 1:] = (s_hi[:, 1:] != s_hi[:, :-1]) | (s_lo[:, 1:] != s_lo[:, :-1])
    uid_sorted = torch.cumsum(is_new, dim=-1) - 1
    uid = torch.empty_like(order).scatter_(-1, order, uid_sorted)
    counts = torch.zeros_like(order).scatter_add_(-1, uid_sorted, torch.ones_like(order))

    # one row per distinct key (rows past the last hold _BIG); each row is
    # written once, from its first sorted pair (the others go to column m)
    dst = torch.where(is_new, uid_sorted, m)

    def rows_of(fill, src):
        out = torch.full((b, m + 1), fill, dtype=torch.int64, device=dev)
        return out.scatter_(-1, dst, src)[:, :m]

    u_hi, u_lo = rows_of((_BIG << 31) | _BIG, s_hi), rows_of(_BIG, s_lo)
    u_keys = torch.zeros((b, m + 1, d), dtype=torch.int32, device=dev).scatter_(
        1, dst[..., None].expand(-1, -1, d),
        flat_keys.gather(1, order[..., None].expand(-1, -1, d)))[:, :m]

    # the 2*(d+1) blur neighbours of every row, found by one batched search
    deltas = np.ones((dp1, d), np.int32)
    for a in range(d):
        deltas[a, a] -= dp1
    deltas = torch.from_numpy(deltas).to(dev)[:, None, :]  # (dp1, 1, d)
    nk = torch.stack([u_keys[:, None] + deltas, u_keys[:, None] - deltas], dim=2)
    q_hi, q_lo = _pack3(nk.reshape(b, dp1 * 2 * m, d))
    pos = _searchsorted3(u_hi, u_lo, q_hi, q_lo).clamp(0, m - 1)
    found = (u_hi.gather(-1, pos) == q_hi) & (u_lo.gather(-1, pos) == q_lo)
    return Lattice(uid=uid, bary=bary, nbr_idx=pos.reshape(b, dp1, 2, m),
                   nbr_ok=found.reshape(b, dp1, 2, m), order=order, counts=counts)


def apply_lattice(lat: Lattice, values: torch.Tensor, with_norm: bool = False,
                  gain: float = 1.0) -> torch.Tensor:
    """Splat -> (d+1)-axis blur -> slice of (N, K) values (or (B, N, K)
    through a batched lattice). Linear in ``values``."""
    if values.dim() == 2:
        return apply_lattice(_batched(lat), values[None], with_norm, gain)[0]
    b, n, dp1 = lat.bary.shape
    m = n * dp1
    if with_norm:
        values = torch.cat([values, torch.ones_like(values[..., :1])], dim=-1)
    k = values.shape[-1]
    image = torch.arange(b, device=values.device)[:, None]
    rows = image * m  # each image's first row in the flattened lattice

    # splat: each row's terms summed in the sorted order
    w = lat.bary.reshape(b, m).gather(-1, lat.order)
    pts = (lat.order // dp1 + image * n).reshape(-1)
    vals = values.reshape(b * n, k).index_select(0, pts) * w.reshape(-1, 1)
    lattice = torch.segment_reduce(vals, "sum", lengths=lat.counts.reshape(-1), axis=0)

    # blur along each lattice direction
    idx = (lat.nbr_idx + rows[:, :, None, None]).permute(1, 2, 0, 3).reshape(dp1, 2, -1)
    ok = lat.nbr_ok.permute(1, 2, 0, 3).reshape(dp1, 2, -1, 1)
    zero = lattice.new_zeros(())
    for a in range(dp1):
        v1 = torch.where(ok[a, 0], lattice.index_select(0, idx[a, 0]), zero)
        v2 = torch.where(ok[a, 1], lattice.index_select(0, idx[a, 1]), zero)
        lattice = lattice + 0.5 * (v1 + v2)

    # slice
    alpha = 1.0 / (1.0 + 2.0 ** (-(dp1 - 1)))
    gathered = lattice.index_select(0, (lat.uid + rows).reshape(-1)).reshape(b, n, dp1, k)
    out = (gathered * lat.bary[..., None]).sum(dim=2) * (alpha * gain)
    if with_norm:
        out = out[..., :-1] / out[..., -1:].clamp_min(1e-20)
    return out


def permutohedral_filter(features: torch.Tensor, values: torch.Tensor,
                         with_norm: bool = False, gain: float = 1.0) -> torch.Tensor:
    """~ gain * G @ values through the lattice: features (N, d) or (B, N, d),
    values (N, K) or (B, N, K). With ``with_norm`` an all-ones channel is
    appended and the output divided by it (the normalized transform of
    DenseCRF-style inference; the gain then cancels)."""
    return apply_lattice(build_lattice(features), values, with_norm, gain)
