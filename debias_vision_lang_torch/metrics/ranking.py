"""Ranking-bias metrics (MaxSkew, NDKL) as one vectorized torch pass on the
device.

Counterpart of ``debias_vision_lang_tpu/metrics/ranking.py``; the semantics
are those of its numpy oracle (``metrics/oracle.py``, the reference's
pandas pipeline):

    scores   = prompt_embeddings @ image_embeddings.T        [P, N]
    ranking  = stable descending sort per prompt (pandas ``nlargest`` order)
    kept     = the top_n prefix extended through boundary ties (keep="all")
    NDKL     = sum_i KL(prefix_i || desired) / log2(i + 1), / Z(top_n)
    MaxSkew  = max_c log p_top(c) - log p_desired(c), floored at 0

The whole row is sorted, so boundary ties are exact with no tie budget.
Sums run in float32 with an explicit pairwise tree over the ranks, the
JAX engine's numerics (1e-5 of the float64 oracle at N = 16k).
"""

from __future__ import annotations

import math
from typing import Dict, Union

import numpy as np
import torch

# the sharded engine's per-shard candidate budget past top_n
# (metrics/distributed.py; JAX's ranking.TIE_PAD)
TIE_PAD = 16


def resolve_topn(topn: Union[int, float], n_items: int) -> int:
    """float = fraction of the dataset (ceil), int = absolute count."""
    resolved = math.ceil(n_items * topn) if isinstance(topn, float) else int(topn)
    if resolved <= 0:
        raise ValueError(f"topn must resolve to a positive rank count, got "
                         f"{topn!r} (resolved {resolved}) for {n_items} items")
    return resolved


def validate_dense_labels(labels) -> int:
    """Labels must be dense 0..k-1; returns k."""
    classes = np.unique(np.asarray(labels))
    if not np.array_equal(classes, np.arange(len(classes))):
        raise ValueError(f"labels must be dense 0..k-1 (count arrays are "
                         f"indexed by label value); got classes {classes}")
    return len(classes)


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), 0.0)


def canonicalize_zeros(scores: torch.Tensor) -> torch.Tensor:
    """Map -0.0 to +0.0 so the two zeros tie, as they do for pandas."""
    return torch.where(scores == 0, torch.zeros_like(scores), scores)


def _pairwise_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Binary-tree sum over the last axis (error O(eps log2 k) in float32)."""
    k = x.shape[-1]
    kp = 1 << max(0, k - 1).bit_length()
    if kp != k:
        x = torch.nn.functional.pad(x, (0, kp - k))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def desired_from_counts(counts: torch.Tensor, n, n_classes: int
                        ) -> Dict[str, torch.Tensor]:
    """eq_opp = uniform; dem_par = label frequencies (zero counts clamped);
    ``counts`` [n_classes] float32 and their total ``n`` (the sharded engine
    sums them across shards)."""
    return {
        "eq_opp": torch.full((n_classes,), 1.0 / n_classes, device=counts.device),
        "dem_par": torch.clamp(counts, min=1.0) / n,
    }


def desired_distributions(labels: torch.Tensor, n_classes: int
                          ) -> Dict[str, torch.Tensor]:
    """The desired distributions of a label vector."""
    counts = torch.bincount(labels, minlength=n_classes).float()
    return desired_from_counts(counts, labels.shape[0], n_classes)


def metrics_from_top_labels(top_labels: torch.Tensor,
                            desired: Dict[str, torch.Tensor], n_classes: int,
                            norm_top_n: int,
                            kept_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Metric core over ranked label lists [P, k] with a kept-prefix mask;
    ``norm_top_n`` (the requested top-n) normalises Z and the skew counts
    even when ties extend the list or N < top_n."""
    k = top_labels.shape[1]
    keep = kept_mask.float()
    onehot = torch.nn.functional.one_hot(top_labels, n_classes).float() * keep[..., None]
    prefix_p = onehot.cumsum(1) / torch.arange(
        1, k + 1, device=top_labels.device, dtype=torch.float32)[None, :, None]
    log_p = _safe_log(prefix_p)
    discounts = keep / torch.log2(torch.arange(
        2, k + 2, device=top_labels.device, dtype=torch.float32))[None, :]
    z = float(np.sum(1.0 / np.log2(np.arange(1, norm_top_n + 1, dtype=np.float64) + 1.0)))
    out: Dict[str, torch.Tensor] = {}
    for name, q in desired.items():
        kl = torch.where(prefix_p > 0, prefix_p * (log_p - _safe_log(q)), 0.0).sum(-1)
        out[f"ndkl_{name}"] = _pairwise_sum_last(kl * discounts) / z
    p_top = onehot.sum(1) / norm_top_n
    p_top = torch.where(p_top == 0, 1.0 / norm_top_n, p_top)
    for name, q in desired.items():
        skew = torch.log(p_top) - torch.log(q)[None, :]
        out[f"maxskew_{name}"] = torch.clamp(skew.amax(-1), min=0.0)
    return out


def ranking_metrics(scores: torch.Tensor, labels: torch.Tensor, top_n: int,
                    n_classes: int) -> Dict[str, torch.Tensor]:
    """All four sub-metrics for [P, N] scores and [N] int labels; [P] each."""
    n = scores.shape[1]
    vals, order = torch.sort(canonicalize_zeros(scores), dim=1, descending=True,
                             stable=True)
    threshold = vals[:, min(top_n, n) - 1: min(top_n, n)]
    kept = vals >= threshold
    return metrics_from_top_labels(labels[order], desired_distributions(labels, n_classes),
                                   n_classes, top_n, kept)


def eval_ranking(labels, image_embeddings, prompt_embeddings,
                 evaluation: str = "maxskew",
                 topn: Union[int, float] = 1.0) -> Dict[str, float]:
    """Per-prompt metrics averaged over prompts, keys without the prefix.
    Runs on the embeddings' device."""
    if evaluation not in ("maxskew", "ndkl"):
        raise ValueError(f"evaluation must be 'maxskew' or 'ndkl', got {evaluation!r}")
    img = torch.as_tensor(image_embeddings).float()
    prm = torch.as_tensor(prompt_embeddings, device=img.device).float()
    n_classes = validate_dense_labels(labels)
    labels_t = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=img.device)
    top_n = resolve_topn(topn, img.shape[0])
    metrics = ranking_metrics(prm @ img.T, labels_t, top_n, n_classes)
    prefix = evaluation + "_"
    return {k[len(prefix):]: float(v.mean()) for k, v in metrics.items()
            if k.startswith(prefix)}
