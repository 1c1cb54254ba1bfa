"""Bias measurement: the reference's ``measure_bias`` as an embed-then-rank
pipeline on one device.

Counterpart of ``debias_vision_lang_tpu/eval/measure.py``:
  1. host threads decode and stage uint8 batches (data/loader.py); on the
     bfloat16 and int8 rungs of a ViT they are patch-contiguous
     [B, P, patch^2*3];
  2. each batch goes through the image tower (bfloat16: the fused-block
     kernels; "int8" / "int8-text": the bundle wrapped once in
     ``ops/quant.QuantizedCLIP``, the int8 fused-block kernels with bfloat16
     activations between them; float32: the plain tower after the device
     preprocess);
  3. the prompts are tokenized once and encoded by the text tower (the
     wrapped bundle's: float32 on every rung but "int8-text", which runs
     the int8 text tower), then L2-normalized (image embeddings are
     deliberately NOT normalized, as in the reference);
  4. scores = prompts @ images.T and MaxSkew / NDKL in one device pass
     (metrics/ranking.py), or the numpy oracle with engine="oracle".
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import importlib.util
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from debias_vision_lang_tpu.core.config import Dotdict, EvalConfig

from ..data.loader import HostLoader
from ..metrics import ranking
from ..ops.quant import resolve_compute
from ..vision.preprocess import Preprocess, preprocess_batch

_ROADMAP_VIDEO = "ROADMAP.md queue 1 item 4 (other towers: Frozen-in-Time video)"


def gen_prompts(prompt_path=None) -> List[str]:
    """Every non-blank template x every concept (11 x 29 = 319 for the
    shipped CSV), read with the stdlib csv module."""
    if prompt_path is None:
        from debias_vision_lang_tpu.core.paths import resolve_asset

        prompt_path = resolve_asset("prompt_templates.csv")
    with open(prompt_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    templates = [r["template"].strip() for r in rows]
    concepts = [r["concept"].strip() for r in rows]
    return [t.format(c) for t in templates if t for c in concepts]


def _resolve_opts(opts) -> EvalConfig:
    if opts is None:
        return EvalConfig()
    if isinstance(opts, EvalConfig):
        return opts
    fields = {f.name for f in dataclasses.fields(EvalConfig)}
    return EvalConfig(**{k: v for k, v in dict(opts).items() if k in fields})


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def vision_cfg(model):
    """VisionConfig of a CLIP or DebiasCLIP bundle, None for other models."""
    cfg = getattr(model, "clip_cfg", None) or getattr(model, "cfg", None)
    return getattr(cfg, "vision", None)


@torch.no_grad()
def get_prompt_embeddings(model, tokenizer, prompts: List[str]) -> torch.Tensor:
    """Tokenize, encode in float32, L2-normalize: [P, embed_dim]."""
    tokens = torch.as_tensor(np.asarray(tokenizer(prompts)), dtype=torch.long,
                             device=model_device(model))
    emb = model.encode_text(tokens).float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


@torch.no_grad()
def get_labels_img_embeddings(loader: HostLoader, model, n_px: int = 224,
                              progress: bool = False,
                              host_transform: Optional[Callable] = None,
                              dtype: str = "float32"):
    """Embed every image: (labels [N] numpy, embeddings [N, D] float32 on the
    model's device), unnormalized.  "int8" / "int8-text" wrap the model
    (idempotently: measure_bias passes it wrapped already)."""
    model, dt = resolve_compute(model, dtype)
    device = model_device(model)
    vis = vision_cfg(model)
    stats = {} if vis is None else {"mean": vis.image_mean, "std": vis.image_std}
    pre = host_transform is not None or loader.host_transform is not None
    iterator = loader
    if progress:
        import tqdm

        iterator = tqdm.tqdm(loader, desc="Embedding images")
    embs, labels = [], []
    for batch in iterator:
        imgs = batch.images
        if host_transform is not None and loader.host_transform is None:
            imgs = np.stack([host_transform(im) for im in imgs])
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(device, non_blocking=True)
        if not pre and x.dim() == 4:  # uint8 NHWC: device preprocess
            x = preprocess_batch(x, n_px, **stats)
        emb = model.encode_image(x, dtype=dt).float()
        embs.append(emb[: batch.num_valid])
        labels.append(batch.labels[: batch.num_valid])
    return np.concatenate(labels), torch.cat(embs, dim=0)


@functools.cache
def _oracle():
    """The JAX package's numpy oracle, loaded from its file (its package
    __init__ imports jax; the oracle itself needs only numpy)."""
    from debias_vision_lang_tpu.core import paths

    path = paths.PACKAGE_ASSETS.parent / "metrics" / "oracle.py"
    spec = importlib.util.spec_from_file_location("_dvl_metrics_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eval_ranking(labels_list, image_embeddings, prompts_embeddings,
                 evaluation: str = "maxskew", topn: Union[int, float] = 1.0,
                 engine: str = "tpu") -> Dict[str, float]:
    """Per-prompt metrics averaged over prompts.  engine "oracle" = the numpy
    oracle; anything else of ("tpu", "torch") = the vectorized device engine
    ("tpu" is EvalConfig's default name for it)."""
    if engine == "oracle":
        def host(t):
            return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

        return _oracle().eval_ranking_oracle(
            np.asarray(labels_list), host(image_embeddings),
            host(prompts_embeddings), evaluation, topn)
    if engine not in ("tpu", "torch"):
        raise ValueError(f"engine must be 'tpu'/'torch' or 'oracle', got {engine!r}")
    return ranking.eval_ranking(labels_list, image_embeddings, prompts_embeddings,
                                evaluation, topn)


_KNOWN_EXTRA = {"dataset", "mode", "n_samples", "equal_split", "data_path",
                "num_frames", "mesh", "sharded_metrics", "cache_embeddings",
                "prompts"}
_NOT_YET_OPTS = {
    "mesh": "ROADMAP.md queue 1 item 5 (distribution)",
    "sharded_metrics": "ROADMAP.md queue 1 item 5 (distribution)",
    "cache_embeddings": "ROADMAP.md queue 1 item 7 (embedding cache keyed "
                        "by a params fingerprint)",
}


def measure_bias(cliplike, img_preproc, tokenizer, attribute: str = "gender",
                 opts: Union[dict, Dotdict, EvalConfig, None] = None
                 ) -> Dict[str, Dict[str, float]]:
    """Ranking bias of a CLIP-like model on FairFace (or UTKFace): MaxSkew
    and NDKL over the 319 generated prompts, top-n defaulting to the whole
    set.  Lower = less biased.  Runs on the model's device."""
    cfg = _resolve_opts(opts)
    extra = dict(opts) if isinstance(opts, (dict, Dotdict)) else {}
    if extra:
        known = {f.name for f in dataclasses.fields(EvalConfig)} | _KNOWN_EXTRA
        unknown = set(extra) - known
        if unknown:
            raise ValueError(f"unknown measure_bias opts {sorted(unknown)}; "
                             f"known keys: {sorted(known)}")
        if extra.get("prompts") is not None and len(extra["prompts"]) == 0:
            raise ValueError(
                "opts['prompts'] is empty -- pass a non-empty prompt list, "
                "or None/omit the key for the default generated battery")
        for key, item in _NOT_YET_OPTS.items():
            if extra.get(key):
                raise NotImplementedError(f"opts[{key!r}] is not ported yet: {item}")
    # resolve the precision ladder once, so both towers honour it: the int8
    # rungs wrap the bundle here, and the prompts run through the wrapped
    # model (int8 text only under "int8-text")
    cliplike, dt = resolve_compute(cliplike, cfg.dtype)

    dataset_name = extra.get("dataset", "fairface")
    if dataset_name == "video":
        raise NotImplementedError("dataset='video' is not ported yet: "
                                  + _ROADMAP_VIDEO)
    if dataset_name not in ("fairface", "utkface"):
        raise NotImplementedError(f"dataset={dataset_name!r}")

    if isinstance(img_preproc, Preprocess):
        n_px, host_transform = img_preproc.n_px, None
    elif img_preproc is None:
        n_px, host_transform = 224, None
    else:
        n_px, host_transform = 224, img_preproc

    from debias_vision_lang_tpu.data import datasets  # needs pandas

    cls = datasets.FairFace if dataset_name == "fairface" else datasets.UTKFace
    # never downloads: fetch FairFace/UTKFace with the JAX package's CLI
    ds = cls(mode=extra.get("mode", "val"), iat_type=attribute,
             _n_samples=extra.get("n_samples"),
             equal_split=extra.get("equal_split", True),
             data_path=extra.get("data_path"), download=False)

    # bfloat16 or int8 ViT at its native resolution: stage patch-contiguous
    # uint8 so the stem is one matmul with the normalize folded into the
    # weights (integer-exact on the int8 rungs)
    vis = vision_cfg(cliplike)
    patch = None
    if (dt == torch.bfloat16 and host_transform is None and vis is not None
            and vis.kind == "vit" and n_px == vis.image_size
            and n_px % vis.patch_size == 0):
        patch = vis.patch_size
    loader = HostLoader(ds, batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                        native_n_px=n_px if host_transform is None else None,
                        native_patch=patch, host_transform=host_transform)
    labels, img_embs = get_labels_img_embeddings(
        loader, cliplike, n_px=n_px, progress=cfg.progress, dtype=cfg.dtype)

    prompts = extra.get("prompts")
    if prompts is None:
        prompts = gen_prompts()
    prompt_embs = get_prompt_embeddings(cliplike, tokenizer, list(prompts))
    return {evaluation: eval_ranking(labels, img_embs, prompt_embs, evaluation,
                                     topn=cfg.topn, engine=cfg.engine)
            for evaluation in cfg.evaluations}

