"""The port's own copy of ``debias_vision_lang_tpu/metrics/oracle.py``.

Reference-faithful numpy oracle for the ranking-bias metrics.

Behavioral spec (reimplemented in plain numpy — no pandas — from the
reference's semantics at debias_clip/measuring_bias.py:17-72):

  * Ranking: descending score; ties broken by original row order (pandas
    ``nlargest`` order).  ``keep="all"`` tie handling: every row tied with
    the top_n-th score is included, so the effective list can EXCEED top_n
    (verified by executing the reference — SURVEY.md §6).
  * NDKL (measuring_bias.py:17-44): for each rank i (1-based) over the kept
    list, KL(prefix label distribution ‖ desired), discounted by 1/log2(i+1),
    normalized by Z = Σ_{i=1..top_n} 1/log2(i+1) — note Z uses top_n even
    when ties extend the list.
  * MaxSkew (measuring_bias.py:47-72): per-label log(p_top) − log(p_desired),
    maxed over labels present in the full set, starting from 0 (so the result
    is never negative); p_top uses denominator top_n (not the extended count);
    zero counts clamped to 1/top_n before the log.
  * Two desired distributions at once: ``eq_opp`` = uniform over the distinct
    labels present; ``dem_par`` = empirical label frequencies.

These functions are the correctness oracle for the device path
(metrics/ranking.py) and are used by the eval engine's "oracle" mode.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import numpy as np


def _kept_top_indices(scores: np.ndarray, top_n: int) -> np.ndarray:
    """Indices of the kept ranked list: descending score, stable ties,
    extended through boundary ties (pandas nlargest keep='all')."""
    order = np.argsort(-scores, kind="stable")
    if top_n >= len(scores):
        return order
    threshold = scores[order[top_n - 1]]
    m = int(np.sum(scores >= threshold))
    return order[:m]


def validate_dense_labels(labels: np.ndarray) -> int:
    """Labels must be dense 0..k-1 (the reference indexes count arrays by
    label value; eq_opp is uniform over DISTINCT PRESENT labels).  Returns
    the class count.  Raises ValueError otherwise — both the oracle and the
    jitted/sharded engines validate identically."""
    classes = np.unique(np.asarray(labels))
    if not np.array_equal(classes, np.arange(len(classes))):
        raise ValueError(
            f"labels must be dense 0..k-1 (reference indexes count arrays by "
            f"label value); got classes {classes}"
        )
    return len(classes)


def _desired_dists(labels: np.ndarray) -> Dict[str, np.ndarray]:
    classes, counts = np.unique(labels, return_counts=True)
    validate_dense_labels(labels)
    n = len(labels)
    return {
        "eq_opp": np.full(len(classes), 1.0 / len(classes)),
        "dem_par": np.maximum(counts, 1) / n,
    }


def _kl(p: np.ndarray, q: np.ndarray) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p != 0, p * (np.log(p) - np.log(q)), 0.0)
    return float(np.sum(terms))


def ndkl(scores: np.ndarray, labels: np.ndarray, top_n: int) -> Dict[str, float]:
    """Normalized Discounted cumulative KL over the ranked list."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels)
    desired = _desired_dists(labels)
    kept = _kept_top_indices(scores, top_n)

    n_classes = len(desired["eq_opp"])
    counts = np.zeros(n_classes)
    acc = {name: 0.0 for name in desired}
    for rank, idx in enumerate(kept, start=1):
        counts[int(labels[idx])] += 1
        prefix = counts / rank
        for name, dist in desired.items():
            acc[name] += _kl(prefix, dist) / math.log2(rank + 1)

    z = sum(1.0 / math.log2(i + 1) for i in range(1, top_n + 1))
    return {f"ndkl_{name}": acc[name] / z for name in desired}


def maxskew(scores: np.ndarray, labels: np.ndarray, top_n: int) -> Dict[str, float]:
    """MaxSkew@top_n (https://arxiv.org/pdf/1905.01989.pdf)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels)
    desired = _desired_dists(labels)
    kept = _kept_top_indices(scores, top_n)

    n_classes = len(desired["eq_opp"])
    top_counts = np.bincount(labels[kept], minlength=n_classes)

    out = {"maxskew_eq_opp": 0.0, "maxskew_dem_par": 0.0}
    for c in range(n_classes):
        p_pos = top_counts[c] / top_n
        if p_pos == 0:
            p_pos = 1.0 / top_n
        for name, dist in desired.items():
            skew = math.log(p_pos) - math.log(dist[c])
            key = f"maxskew_{name}"
            out[key] = max(out[key], skew)
    return out


def resolve_topn(topn: Union[int, float], n_items: int) -> int:
    """float = fraction of the dataset (ceil), int = absolute
    (reference: measuring_bias.py:109-110).

    A non-positive request is rejected loudly: the oracle would divide by
    zero and the jitted engines would silently return Inf/NaN metrics
    (Z = an empty discount sum)."""
    resolved = math.ceil(n_items * topn) if isinstance(topn, float) else int(topn)
    if resolved <= 0:
        raise ValueError(
            f"topn must resolve to a positive rank count, got {topn!r} "
            f"(resolved {resolved}) for {n_items} items")
    return resolved


def eval_ranking_oracle(
    labels: np.ndarray,
    image_embeddings: np.ndarray,
    prompt_embeddings: np.ndarray,
    evaluation: str = "maxskew",
    topn: Union[int, float] = 1.0,
) -> Dict[str, float]:
    """Per-prompt metric averaged over prompts
    (reference: measuring_bias.py:102-119).  Keys are the sub-metric names
    with the evaluation prefix stripped (``eq_opp``, ``dem_par``)."""
    assert evaluation in ("maxskew", "ndkl")
    fn = maxskew if evaluation == "maxskew" else ndkl
    top_n = resolve_topn(topn, len(image_embeddings))
    sums: Dict[str, float] = {}
    n_prompts = len(prompt_embeddings)
    for p in prompt_embeddings:
        scores = np.asarray(image_embeddings, np.float32) @ np.asarray(p, np.float32)
        for k, v in fn(scores, labels, top_n).items():
            short = k[len(evaluation) + 1 :]
            sums[short] = sums.get(short, 0.0) + v
    return {k: v / n_prompts for k, v in sums.items()}
