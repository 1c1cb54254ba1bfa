"""Embed-then-rank with the image embeddings sharded over the data axis:
per-shard top-k candidates and an exact merge.

Counterpart of ``debias_vision_lang_tpu/metrics/distributed.py``:

  per shard:  scores = prompts @ img_shard.T, pad rows at -inf
              candidates = the first k_local of a stable descending sort
              (pandas ``nlargest`` order; ``torch.topk``'s tie order is
              unspecified on CUDA, so it is not used)
  gathered:   the candidates' (score, label) pairs in shard order, and the
              label counts summed across shards for the desired
              distributions (all_gather / all_reduce across ranks)
  merged:     a second stable sort of the C * k_local candidates, the kept
              prefix extended through boundary ties, MaxSkew / NDKL

The merge is exact because the global kept list is contained in the union
of the per-shard candidates: every kept row clears each shard's k-th
candidate, or the shard's last candidate still clears the threshold and
the budget escalates to the whole shard.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..parallel.mesh import (DATA_AXIS, Mesh, all_gather, all_reduce_sum,
                             default_mesh, shard_batch_arrays)
from .ranking import (TIE_PAD, canonicalize_zeros, desired_from_counts,
                      metrics_from_top_labels, resolve_topn, validate_dense_labels)


def _merge(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[local shards, ...] -> [all shards, ...] in shard order."""
    return t if mesh.world == 1 else torch.cat(all_gather(t))


def _sharded_metrics(img, lbl, vld, prompts, mesh: Mesh, axis: str, top_n: int,
                     n_classes: int, n_real: int, k_local: int):
    """(metrics, overflow) for sharded embeddings, labels and valid masks."""
    home = mesh.first_device
    vals_l, labels_l, counts = [], [], None
    for (_, x), (_, y), (_, v) in zip(img.shards, lbl.shards, vld.shards):
        n_local = x.shape[0]
        k = min(k_local, n_local)
        scores = canonicalize_zeros(prompts.to(x.device) @ x.T)  # [P, n_local]
        scores = torch.where(v[None, :], scores, -torch.inf)
        vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        vals_l.append(vals[:, :k].to(home))
        labels_l.append(y[idx[:, :k]].to(home))
        c = torch.bincount(y[v], minlength=n_classes).float().to(home)
        counts = c if counts is None else counts + c
    if mesh.world > 1:
        counts = all_reduce_sum(counts)
    desired = desired_from_counts(counts, counts.sum(), n_classes)

    vals_all = _merge(mesh, torch.stack(vals_l))  # [C, P, k]
    labels_all = _merge(mesh, torch.stack(labels_l))
    c_n, p_n, k = vals_all.shape
    vals_m = vals_all.permute(1, 0, 2).reshape(p_n, c_n * k)
    labels_m = labels_all.permute(1, 0, 2).reshape(p_n, c_n * k)
    top_vals, top_pos = torch.sort(vals_m, dim=1, descending=True, stable=True)
    top_labels = torch.gather(labels_m, 1, top_pos)

    # boundary-tie-extended kept mask (nlargest keep="all")
    kt = min(top_n, n_real)
    threshold = top_vals[:, kt - 1]
    kept = top_vals >= threshold[:, None]
    # a shard whose last candidate still clears the threshold may hold more
    # tied rows beyond its budget: escalate
    overflow = k < n_local and bool((vals_all[:, :, -1] >= threshold[None, :]).any())
    metrics = metrics_from_top_labels(top_labels, desired, n_classes,
                                      norm_top_n=top_n, kept_mask=kept)
    return metrics, overflow


def sharded_ranking_metrics(image_embeddings, labels, prompt_embeddings, top_n: int,
                            n_classes: int, mesh: Mesh, axis: str = DATA_AXIS
                            ) -> Dict[str, torch.Tensor]:
    """Exact global MaxSkew / NDKL ([P] each) with the image embeddings
    sharded over ``axis``.

    A ragged N is padded to the next multiple of the axis size with rows
    that score -inf, left out of the desired distributions and the kept
    list: the result is the single-device engine's.  Boundary ties follow
    pandas ``nlargest(keep="all")``: each shard keeps a tie-extended budget
    of candidates, escalated to the whole shard when ties exceed it."""
    img = torch.as_tensor(image_embeddings).float()
    n = int(img.shape[0])
    n_shards = mesh.shape[axis]
    lbl = torch.as_tensor(np.asarray(labels), dtype=torch.long)
    valid = torch.ones(n, dtype=torch.bool)
    pad = -n % n_shards
    if pad:
        img = torch.cat([img, img.new_zeros((pad, img.shape[1]))])
        lbl = torch.cat([lbl, lbl.new_zeros(pad)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool)])
    shards = shard_batch_arrays(mesh, img, lbl, valid, axis=axis)
    prompts = torch.as_tensor(prompt_embeddings).float()

    n_local = img.shape[0] // n_shards
    k_local = min(min(top_n, n) + TIE_PAD, n_local)
    metrics, overflow = _sharded_metrics(*shards, prompts, mesh, axis, top_n,
                                         n_classes, n, k_local)
    if k_local < n_local and overflow:
        metrics, _ = _sharded_metrics(*shards, prompts, mesh, axis, top_n,
                                      n_classes, n, n_local)
    return metrics


def sharded_eval_ranking(labels, image_embeddings, prompt_embeddings,
                         evaluation: str = "maxskew",
                         topn: Union[int, float] = 1.0, mesh=None,
                         axis: str = DATA_AXIS) -> Dict[str, float]:
    """The sharded counterpart of ``eval_ranking`` (same output dict); the
    default mesh is over the embeddings' device type."""
    if evaluation not in ("maxskew", "ndkl"):
        raise ValueError(f"evaluation must be 'maxskew' or 'ndkl', got {evaluation!r}")
    if mesh is None:
        mesh = default_mesh(torch.as_tensor(image_embeddings).device)
    n = image_embeddings.shape[0]
    top_n = resolve_topn(topn, n)
    n_classes = validate_dense_labels(labels)
    metrics = sharded_ranking_metrics(image_embeddings, labels, prompt_embeddings,
                                      top_n, n_classes, mesh, axis)
    prefix = evaluation + "_"
    return {k[len(prefix):]: float(v.mean()) for k, v in metrics.items()
            if k.startswith(prefix)}
