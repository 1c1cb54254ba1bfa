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

``opts["cache_embeddings"]`` keeps step 2's output (labels, embeddings and
the rows' file names) in an npz at that path, keyed as in the JAX package
by the dataset selection and the rung, and here also by a digest of the
image tower's weights (``utils/fingerprint.py``): re-scoring another prompt
battery or top-n with the same tower hits and builds no dataset, while a
tower whose weights differ raises instead of reading stale embeddings.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.config import Dotdict, EvalConfig
from ..core.paths import resolve_asset
from ..data.loader import HostLoader
from ..metrics import oracle, ranking
from ..models.clip import VIT_KINDS
from ..ops.quant import resolve_compute
from ..utils.fingerprint import image_tower_tensors, params_fingerprint
from ..vision.preprocess import Preprocess, preprocess_batch

_ROADMAP_VIDEO = "ROADMAP.md queue 1 item 4c (Frozen-in-Time and video)"


def gen_prompts(prompt_path=None) -> List[str]:
    """Every non-blank template x every concept (11 x 29 = 319 for the
    shipped CSV), read with the stdlib csv module."""
    if prompt_path is None:
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


def eval_ranking(labels_list, image_embeddings, prompts_embeddings,
                 evaluation: str = "maxskew", topn: Union[int, float] = 1.0,
                 engine: str = "tpu") -> Dict[str, float]:
    """Per-prompt metrics averaged over prompts.  engine "oracle" = the numpy
    oracle; anything else of ("tpu", "torch") = the vectorized device engine
    ("tpu" is EvalConfig's default name for it)."""
    if engine == "oracle":
        def host(t):
            return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

        return oracle.eval_ranking_oracle(
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

    mode, n_samples = extra.get("mode", "val"), extra.get("n_samples")
    equal_split, data_path = extra.get("equal_split", True), extra.get("data_path")
    cache_path = extra.get("cache_embeddings")
    if cache_path:
        cache_key = json.dumps({
            "attribute": attribute, "dataset": dataset_name, "mode": mode,
            "n_samples": n_samples, "dtype": cfg.dtype, "equal_split": equal_split,
            "data_path": data_path, "num_frames": extra.get("num_frames"),
            "params": params_fingerprint(image_tower_tensors(cliplike)),
        }, sort_keys=True, default=str)
    if cache_path and os.path.exists(cache_path):
        # a hit builds no dataset and no loader: the image files may be gone
        with np.load(cache_path, allow_pickle=False) as data:
            stored = str(data["cache_key"]) if "cache_key" in data else None
            if stored != cache_key:
                raise ValueError(
                    f"embedding cache {cache_path} was written for "
                    f"{stored or 'an older layout without a cache key'} but this "
                    f"call needs {cache_key} — the cached labels would be wrong; "
                    "use a separate cache path per attribute/dataset config")
            labels = data["labels"]
            img_embs = torch.from_numpy(data["embeddings"]).to(model_device(cliplike))
    else:
        from ..data import datasets  # needs pandas

        cls = datasets.FairFace if dataset_name == "fairface" else datasets.UTKFace
        # never downloads: point data_path at a complete FairFace/UTKFace layout
        ds = cls(mode=mode, iat_type=attribute, _n_samples=n_samples,
                 equal_split=equal_split, data_path=data_path, download=False)

        # bfloat16 or int8 ViT at its native resolution: stage patch-contiguous
        # uint8 so the stem is one matmul with the normalize folded into the
        # weights (integer-exact on the int8 rungs)
        vis = vision_cfg(cliplike)
        patch = None
        if (dt == torch.bfloat16 and host_transform is None and vis is not None
                and vis.kind in VIT_KINDS and n_px == vis.image_size
                and n_px % vis.patch_size == 0):
            patch = vis.patch_size
        loader = HostLoader(ds, batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                            native_n_px=n_px if host_transform is None else None,
                            native_patch=patch, host_transform=host_transform)
        labels, img_embs = get_labels_img_embeddings(
            loader, cliplike, n_px=n_px, progress=cfg.progress, dtype=cfg.dtype)
        if cache_path:
            # through a file object, so an extension-less path is kept as
            # given; staged to .part so an interrupted write is never a hit
            tmp = cache_path + ".part"
            with open(tmp, "wb") as f:
                np.savez(f, labels=labels, embeddings=img_embs.cpu().numpy(),
                         cache_key=cache_key,
                         files=np.asarray(ds.labels["file"].tolist(), dtype=str))
            os.replace(tmp, cache_path)

    prompts = extra.get("prompts")
    if prompts is None:
        prompts = gen_prompts()
    prompt_embs = get_prompt_embeddings(cliplike, tokenizer, list(prompts))
    return {evaluation: eval_ranking(labels, img_embs, prompt_embs, evaluation,
                                     topn=cfg.topn, engine=cfg.engine)
            for evaluation in cfg.evaluations}

