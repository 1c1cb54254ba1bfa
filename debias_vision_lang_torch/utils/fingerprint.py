"""Content digests of model weights, computed where the weights live.

Each tensor's bytes are read as 16-bit halves and reduced on the tensor's
own device to two position-weighted sums modulo the prime P = 2^31 - 1.
A half is below 2^16 and every position weight lies in [1, P - 1], so a
change of any one half changes each sum: P is prime and divides neither
the change nor the weight.  All arithmetic is exact in int32 / int64, so
the sums do not depend on the order of the reduction: the same weights give
the same digest on the CPU and on the card, in any process.  The host then
hashes the names, shapes, dtypes and sums with sha256, so the weights
themselves are never copied off the device.

The weight of half i of a tensor is u(i mod K) v(i div K) mod P, with u
below 2^15 and both tables drawn from splitmix64 on the host: a tensor is
padded with zeros to rows of K halves, each row is multiplied by u in
int32 and summed in int64, and the row sums are weighted by v.  The
tensors of one device go through this in a few fused passes (one
concatenation of up to ``_BUCKET`` bytes each), not one pass per tensor.
"""

from __future__ import annotations

import hashlib
from typing import List, Mapping

import numpy as np
import torch

_P = 2_147_483_647  # 2^31 - 1, prime
_K = 4096  # halves per row
_U_MAX = 32_767  # u < 2^15: a half times u stays below 2^31
_BUCKET = 1 << 28  # bytes of weights per fused pass
_SEEDS = (0x9E3779B97F4A7C15, 0xD1B54A32D192ED03)  # one per sum


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser, wrapping uint64 arithmetic."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _u_table() -> np.ndarray:
    """[2, K] int32 column weights in [1, 2^15)."""
    r = np.arange(_K, dtype=np.uint64)
    return np.stack([_splitmix64(r + np.uint64(s)) % np.uint64(_U_MAX) + np.uint64(1)
                     for s in _SEEDS]).astype(np.int32)


def _v_table(rows: int) -> np.ndarray:
    """[2, rows] int64 row weights in [1, P - 1]."""
    j = np.arange(rows, dtype=np.uint64) + np.uint64(_K)
    return np.stack([_splitmix64(j + np.uint64(s)) % np.uint64(_P - 1) + np.uint64(1)
                     for s in _SEEDS]).astype(np.int64)


def _bucket_sums(ts: List[torch.Tensor]) -> torch.Tensor:
    """[2, len(ts)] int64 sums, each in [0, P), of tensors on one device."""
    dev = ts[0].device
    pad = torch.zeros(2 * _K, dtype=torch.uint8, device=dev)
    pieces, rows = [], []
    for t in ts:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        m = max(1, -(-b.numel() // (2 * _K)))  # an empty tensor keeps a zero row
        pieces += [b, pad[: m * 2 * _K - b.numel()]]
        rows.append(m)
    x = torch.cat(pieces).view(torch.int16).view(-1, _K).to(torch.int32)
    x.bitwise_and_(0xFFFF)
    u = torch.from_numpy(_u_table()).to(dev)
    row_sums = torch.stack([(x * u[h]).sum(1, dtype=torch.int64) for h in range(2)])
    v = np.concatenate([_v_table(m) for m in rows], axis=1)
    row_sums.remainder_(_P).mul_(torch.from_numpy(v).to(dev)).remainder_(_P)
    ends = torch.from_numpy(np.cumsum(rows) - 1).to(dev)
    at_ends = row_sums.cumsum(1).index_select(1, ends)
    return torch.diff(at_ends, dim=1, prepend=torch.zeros_like(at_ends[:, :1])) % _P


def params_fingerprint(tensors: Mapping[str, torch.Tensor]) -> str:
    """sha256 hex digest over every entry's name, shape, dtype and two
    device sums, name-sorted.  One device-to-host copy per fused pass."""
    names = sorted(tensors)
    groups, open_group = [], {}  # open_group: device -> (names, bytes)
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        group, size = open_group.get(t.device, (None, 0))
        if group is None or size + nbytes > _BUCKET:
            group, size = [], 0
            groups.append(group)
        group.append(name)
        open_group[t.device] = (group, size + nbytes)
    sums = {}
    for group in groups:
        host = _bucket_sums([tensors[n] for n in group]).t().cpu().tolist()
        sums.update(zip(group, host))
    h = hashlib.sha256()
    for name in names:
        t = tensors[name]
        h.update(f"{name}\0{tuple(t.shape)}\0{t.dtype}\0{sums[name]}\0".encode())
    return h.hexdigest()


def image_tower_tensors(model) -> Mapping[str, torch.Tensor]:
    """The parameters and buffers a CLIP-like bundle's image embeddings
    depend on: the vision tower's (``encode_image`` reads no logit_scale, no
    prompt tokens and no text tower).  An int8 ``QuantizedCLIP`` is named by
    the float weights it quantizes; a model without a ``visual`` tower by its
    whole state."""
    base = getattr(model, "base", model)  # QuantizedCLIP -> the float bundle
    clip = getattr(base, "clip", base)  # DebiasCLIP -> its CLIP
    visual = getattr(clip, "visual", None)
    if visual is None:
        return model.state_dict()
    return visual.state_dict(prefix="visual.")
