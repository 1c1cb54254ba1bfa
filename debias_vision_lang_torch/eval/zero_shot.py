"""Zero-shot classification (``debias_vision_lang_tpu/eval/zero_shot.py``).

Class names + prompt templates -> classifier weights (the mean of the
L2-normalized per-template text embeddings, normalized again: the standard
CLIP recipe), then batched image classification with top-1 / top-5
accuracy.  The images take the JAX function's path: the device preprocess
with the tower's own statistics, then ``encode_image`` at the rung's
activation dtype (the fused-block kernels on the bfloat16 and int8 rungs
of a CUDA model).

Not ported: ``mesh`` (ROADMAP.md queue 1 item 5), and the JAX function's
``hint_implicit_fp32``, a one-line hint printed on a TPU backend when the
float32 default picks itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.quant import resolve_compute
from ..vision.preprocess import preprocess_batch
from .measure import model_device, vision_cfg

ROADMAP_MESH = "ROADMAP.md queue 1 item 5 (distribution)"

# The short standard template set; ``imagenet_templates()`` is the full
# 80-template OpenAI protocol list.
DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a photo of the large {}.",
    "a photo of the small {}.",
    "itap of a {}.",
    "a {} in a video game.",
)


def imagenet_templates() -> tuple:
    """The 80 OpenAI CLIP ImageNet prompt templates, from the port's own
    asset (``assets/zero_shot_templates_imagenet.txt``)."""
    from ..core.paths import resolve_asset

    with open(resolve_asset("zero_shot_templates_imagenet.txt")) as f:
        templates = tuple(line.strip() for line in f if line.strip())
    assert len(templates) == 80, f"expected 80 templates, got {len(templates)}"
    return templates


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@torch.no_grad()
def build_zero_shot_classifier(model, tokenizer: Callable,
                               class_names: Sequence[str],
                               templates: Sequence[str] = DEFAULT_TEMPLATES,
                               batch_size: int = 256) -> torch.Tensor:
    """[n_classes, embed_dim] L2-normalized float32 classifier weights on
    the model's device.  Classes are encoded ``batch_size // len(templates)``
    at a time, every template of a class in one text-tower call."""
    n_templates = len(templates)
    per_call = max(1, batch_size // n_templates)
    device = model_device(model)
    weights = []
    for s in range(0, len(class_names), per_call):
        group = class_names[s: s + per_call]
        prompts = [t.format(cls) for cls in group for t in templates]
        tokens = torch.as_tensor(np.asarray(tokenizer(prompts)), dtype=torch.long,
                                 device=device)
        emb = _normalize(model.encode_text(tokens).float())
        weights.append(_normalize(emb.reshape(len(group), n_templates, -1).mean(1)))
    return torch.cat(weights)


def classify(image_embeddings: torch.Tensor, classifier: torch.Tensor,
             top_k: int = 5) -> torch.Tensor:
    """[N, D] embeddings x [C, D] classifier -> [N, top_k] predicted classes."""
    logits = _normalize(image_embeddings) @ classifier.T
    return torch.topk(logits, min(top_k, classifier.shape[0]), dim=-1).indices


@torch.no_grad()
def zero_shot_accuracy(model, tokenizer: Callable, loader,
                       class_names: Sequence[str],
                       templates: Sequence[str] = DEFAULT_TEMPLATES,
                       n_px: int = 224, mesh=None, progress: bool = False,
                       dtype: Optional[str] = None) -> Dict[str, float]:
    """Top-1 / top-5 zero-shot accuracy over a HostLoader of labeled uint8
    images.  ``dtype``: "float32" (the default: reference parity) |
    "bfloat16" | "int8" (quantized image tower; the classifier builds at
    float32) | "int8-text" (the classifier's prompts run the int8 text tower
    too); "auto" raises (ROADMAP.md queue 1 item 8)."""
    if mesh is not None:
        raise NotImplementedError(f"zero-shot mesh is not ported yet: {ROADMAP_MESH}")
    # resolve the ladder first, so "int8-text" reaches the classifier build
    model, compute_dtype = resolve_compute(model, dtype or "float32")
    classifier = build_zero_shot_classifier(model, tokenizer, class_names, templates)
    device = model_device(model)
    vis = vision_cfg(model)
    stats = {} if vis is None else {"mean": vis.image_mean, "std": vis.image_std}

    it = loader
    if progress:
        import tqdm

        it = tqdm.tqdm(loader, desc="Zero-shot eval")
    correct1 = correct5 = total = 0
    for batch in it:
        x = torch.from_numpy(np.ascontiguousarray(batch.images)).to(device)
        emb = model.encode_image(preprocess_batch(x, n_px, **stats),
                                 dtype=compute_dtype).float()
        preds = classify(emb, classifier, top_k=5).cpu().numpy()[: batch.num_valid]
        labels = np.asarray(batch.labels)[: batch.num_valid]
        correct1 += int((preds[:, 0] == labels).sum())
        correct5 += int((preds == labels[:, None]).any(axis=1).sum())
        total += batch.num_valid
    if total == 0:
        raise ValueError(
            "zero_shot_accuracy: the loader yielded no images — empty "
            "dataset or data path with no image files?")
    return {"top1": correct1 / total, "top5": correct5 / total, "n": total}
