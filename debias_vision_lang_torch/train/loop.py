"""End-to-end training on one device: data -> alternating steps -> periodic
bias eval -> best-NDKL selection -> checkpoints + reference-format export.

Counterpart of ``debias_vision_lang_tpu/train/loop.py::run_training``.
Batch A is FairFace train images with protected-attribute labels against
the sensitive prompt set; batch B is image-caption pairs for the
contrastive term (a caption corpus at ``pairs_path``, or FairFace images
with captions made from their label rows when there is none).  The batch
order comes from the JAX loop's numpy streams: HostLoader's shuffle seeded
with ``seed``, and the caption stream ``default_rng([seed, 1])``, so the
port trains on the same batches.

Frozen-image configs train through the frozen-embedding cache by default
(``TrainConfig.cache_frozen_embeddings``): both image streams embed once
and epochs gather rows through ``step_from_embeddings``; the batch
sequences are the decode path's.  ``embedding_cache_dir`` persists the rows
(``train/embcache.py``), keyed by the tower, the dataset rows (paths
relative to the dataset root) and each file's (size, mtime).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import DebiasConfig, TrainConfig
from ..models.adversary import Adversary
from ..models.debias import DebiasCLIP, init_debias_tokens
from ..utils.device import resolve_device
from ..utils.observability import MetricsLogger
from .adversarial import ROADMAP_DIST, AdversarialTrainer
from .state import export_reference_pt, save_checkpoint


def _fairface_caption(row) -> str:
    return (f"a photo of a {row['age']} year old "
            f"{row['race'].replace('_', ' ').lower()} {row['gender'].lower()}")


def _check_caption_corpus(n: int, batch_size: int, message: str):
    if n < batch_size:  # drop-remainder batching would yield nothing, forever
        raise ValueError(message)


def _caption_index_stream(batch_size, rng, pairs_ds=None, n: int = 0):
    """Infinite stream of caption-batch row indices: the one source of the
    contrastive stream's order for the decode path and the cache."""
    if pairs_ds is not None:
        while True:
            yield from pairs_ds.index_batches(batch_size, rng)
    else:
        while True:
            idx = rng.permutation(n)
            for s in range(0, n - batch_size + 1, batch_size):
                yield idx[s: s + batch_size]


def _caption_fallback_batch(fairface, sel, n_px):
    """One FairFace caption-fallback batch at the model resolution, decoded
    as HostLoader decodes the attribute rows (native ingest, per-row PIL
    recovery), so the two streams' pixels agree row for row."""
    from .. import native

    from ..vision.preprocess import resize_crop_u8, to_rgb_array

    paths = [fairface._img_fnames[int(i)] for i in sel]
    if native.available():
        images, ok = native.ingest_batch_files_u8(paths, n_px)
        for j in np.nonzero(~ok)[0]:
            images[j] = resize_crop_u8(to_rgb_array(fairface.load_image(int(sel[j]))), n_px)
        return images
    return np.stack([resize_crop_u8(to_rgb_array(fairface.load_image(int(i))), n_px)
                     for i in sel])


def _caption_batches(pairs_path, tokenizer, batch_size, fairface, n_px, rng):
    """Infinite iterator of (images_u8, tokens) contrastive batches."""
    if pairs_path is not None:
        from ..data.pairs import ImageCaptionPairs

        ds = ImageCaptionPairs(pairs_path, image_size=n_px)
        _check_caption_corpus(
            len(ds), batch_size,
            f"caption corpus at {pairs_path} has {len(ds)} pairs, fewer than "
            f"batch_size={batch_size}; shrink the batch or grow the corpus")
        for idx in _caption_index_stream(batch_size, rng, pairs_ds=ds):
            yield ds.load_batch(idx, tokenizer)
    else:
        n = len(fairface)
        _check_caption_corpus(
            n, batch_size, f"FairFace caption fallback has {n} rows, fewer than "
                           f"batch_size={batch_size}; shrink the batch")
        for sel in _caption_index_stream(batch_size, rng, n=n):
            images = _caption_fallback_batch(fairface, sel, n_px)
            caps = [_fairface_caption(fairface.labels.iloc[int(i)]) for i in sel]
            yield images, np.asarray(tokenizer(caps))


def _progress(it, enabled: bool, **kw):
    if not enabled:
        return it
    import tqdm

    return tqdm.tqdm(it, **kw)


def run_training(
    arch: str = "openai/CLIP/ViT-B/16",
    attribute: str = "gender",
    num_debias_tokens: int = 2,
    debias_pos: str = "prepend",
    debias_token_init="zeros",
    epochs: Optional[int] = None,
    batch_size: Optional[int] = None,
    pairs_path: Optional[str] = None,
    data_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    eval_every: Optional[int] = None,
    eval_n_samples: Optional[int] = 2000,
    pretrained: bool = True,
    tokenizer=None,
    model: Optional[DebiasCLIP] = None,
    sensitive_prompts=None,
    adversary_hidden: int = 32,
    train_cfg: Optional[TrainConfig] = None,
    seed: int = 0,
    log_dir: Optional[str] = None,
    use_pallas: Optional[bool] = None,
    progress: bool = True,
    resume: bool = False,
    mesh=None,
    embed_dtype: str = "float32",
    train_dtype: str = "float32",
    approx_frozen_scores: bool = False,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    decay_steps: Optional[int] = None,
    grad_clip_norm: Optional[float] = None,
    cache_frozen_embeddings: bool = True,
    embedding_cache_dir: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Train the prompt array adversarially; returns a summary dict.  Runs
    on ``device``: the card unless ``device="cpu"`` (with no card the
    default raises); a given ``model`` is moved there."""
    from ..core.registry import alias_name
    from ..data.datasets import FairFace

    from ..data.loader import HostLoader
    from ..eval.measure import (eval_ranking, gen_prompts, get_labels_img_embeddings,
                                get_prompt_embeddings)
    from ..models.loader import model_loader
    from ..vision.preprocess import preprocess_batch

    if mesh is not None:
        raise NotImplementedError(
            f"mesh: data-parallel training is not ported yet: {ROADMAP_DIST}")
    device = resolve_device(device)

    # the caption stream is seeded apart from HostLoader's shuffle, else
    # batch B would equal batch A every step
    rng = np.random.default_rng([seed, 1])

    if model is None:
        base, _, tok, alias = model_loader(arch, pretrained=pretrained, seed=seed,
                                           device=device)
        tokenizer = tokenizer or tok
        if tokenizer is None:
            raise RuntimeError("a tokenizer is required (BPE vocab missing?)")
        dcfg = DebiasConfig(num_debias_tokens=num_debias_tokens,
                            hidden_dim=base.cfg.text.width,
                            max_tokens=base.cfg.text.context_length,
                            debias_pos=debias_pos, debias_token_init=debias_token_init)
        deb = init_debias_tokens(base, dcfg, tokenizer,
                                 torch.Generator().manual_seed(seed + 1))
        model = DebiasCLIP(base, deb, dcfg).to(device)
    else:
        model = model.to(device)
        alias = alias_name(model.clip_cfg.name)  # no '/' in the export name
    if tokenizer is None:
        raise RuntimeError("a tokenizer is required")
    dev = model.debias_tokens.device
    n_px = model.clip_cfg.vision.image_size

    # the sensitive set: the evaluation battery (319), the adversary's width
    prompts = sensitive_prompts if sensitive_prompts is not None else gen_prompts()
    sens_tokens = np.asarray(tokenizer(prompts))

    train_ds = FairFace(mode="train", iat_type=attribute, data_path=data_path,
                        download=False)
    n_output = 1 if train_ds.n_iat_classes == 2 else train_ds.n_iat_classes
    adversary = Adversary.from_cfg({
        "ADV_N_INPUT": len(prompts), "ADV_N_OUTPUT": n_output,
        "ADV_HIDDEN_SIZE": adversary_hidden, "SEED": seed,
    })

    if train_cfg is not None:
        # explicit non-default kwargs win over a provided config
        overrides = {}
        if embed_dtype != "float32":
            overrides["embed_dtype"] = embed_dtype
        if train_dtype != "float32":
            overrides["train_dtype"] = train_dtype
        if approx_frozen_scores:
            overrides["approx_frozen_scores"] = True
        if lr_schedule != "constant":
            overrides["lr_schedule"] = lr_schedule
        if warmup_steps:
            overrides["warmup_steps"] = warmup_steps
        if decay_steps is not None:
            overrides["decay_steps"] = decay_steps
        if grad_clip_norm is not None:
            overrides["grad_clip_norm"] = grad_clip_norm
        if not cache_frozen_embeddings:
            overrides["cache_frozen_embeddings"] = False
        if embedding_cache_dir is not None:
            overrides["embedding_cache_dir"] = embedding_cache_dir
        tcfg = dataclasses.replace(train_cfg, **overrides) if overrides else train_cfg
    else:
        tcfg = TrainConfig(batch_size=batch_size or 64, num_epochs=epochs or 5,
                           eval_every_steps=eval_every or 500,
                           checkpoint_dir=checkpoint_dir, seed=seed,
                           embed_dtype=embed_dtype, train_dtype=train_dtype,
                           approx_frozen_scores=approx_frozen_scores,
                           lr_schedule=lr_schedule, warmup_steps=warmup_steps,
                           decay_steps=decay_steps, grad_clip_norm=grad_clip_norm,
                           cache_frozen_embeddings=cache_frozen_embeddings,
                           embedding_cache_dir=embedding_cache_dir)
    # the loop drives off these locals: a provided config's values unless
    # the kwargs were given
    epochs = epochs if epochs is not None else tcfg.num_epochs
    batch_size = batch_size if batch_size is not None else tcfg.batch_size
    eval_every = eval_every if eval_every is not None else tcfg.eval_every_steps
    checkpoint_dir = checkpoint_dir or tcfg.checkpoint_dir or "checkpoints"
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    if tcfg.lr_schedule != "constant" and not tcfg.decay_steps:
        # the cosine horizon: total updates = epochs x batches per epoch
        tcfg = dataclasses.replace(
            tcfg, decay_steps=max(tcfg.warmup_steps + 1, epochs * steps_per_epoch))
    trainer = AdversarialTrainer.create(model, adversary, tcfg, sens_tokens,
                                        use_pallas=use_pallas)
    total_steps = epochs * steps_per_epoch
    start_epoch = 0
    if resume:
        from .state import latest_checkpoint, restore_checkpoint

        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt is not None:
            restore_checkpoint(ckpt, trainer)
            # continue the configured recipe, never extend it
            start_epoch = min(epochs, trainer.step_count // steps_per_epoch)

    val_ds = FairFace(mode="val", iat_type=attribute, data_path=data_path,
                      _n_samples=eval_n_samples, download=False)
    loader = HostLoader(train_ds, batch_size=batch_size, drop_remainder=True,
                        shuffle=True, seed=seed, native_n_px=n_px)
    logger = MetricsLogger(log_dir or os.path.join(checkpoint_dir, "logs"))
    stats = {"mean": model.clip_cfg.vision.image_mean,
             "std": model.clip_cfg.vision.image_std}

    def prep(images_u8: np.ndarray) -> torch.Tensor:
        return preprocess_batch(torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev),
                                n_px, **stats)

    def embed_rows(images_u8: np.ndarray) -> np.ndarray:
        e = trainer.fns.embed_images(trainer.model, prep(images_u8))
        return e.float().cpu().numpy()

    # the frozen-tower embedding cache: embed the train rows and the caption
    # corpus once and gather rows each epoch (lazy when a resumed recipe is
    # already complete)
    cache_embs = (tcfg.cache_frozen_embeddings and not trainer.trains_image
                  and trainer.step_count < total_steps)
    disk_state = None  # {"train": hit|miss, "captions": hit|miss|train-rows}
    if cache_embs:
        disk_dir = tcfg.embedding_cache_dir
        if disk_dir:
            from . import embcache as ec

            disk_state = {"train": "miss", "captions": "miss"}
            base_key = {"v": 1, "impl": "torch", "arch": model.clip_cfg.name,
                        "n_px": n_px, "embed_dtype": tcfg.embed_dtype,
                        "params": ec.params_fingerprint(trainer.model.clip.state_dict())}
            train_key = {**base_key, "rows": ec.dataset_fingerprint(train_ds),
                         "files": ec.files_fingerprint(train_ds._img_fnames)}
            train_path = ec.cache_path(disk_dir, "train_rows", train_key)
            hit = ec.cache_load(train_path, train_key)
            if hit is not None and len(hit["embeddings"]) == len(train_ds):
                train_embs = hit["embeddings"]
                disk_state["train"] = "hit"
        if disk_state is None or disk_state["train"] != "hit":
            # rows in dataset order from a fresh unshuffled loader (the
            # training loader's rng advances once per training epoch only)
            src = HostLoader(train_ds, batch_size=batch_size, drop_remainder=False,
                             shuffle=False, native_n_px=n_px)
            rows = [embed_rows(b.images)[: b.num_valid]
                    for b in _progress(src, progress, desc="embed cache: train rows")]
            train_embs = np.concatenate(rows, axis=0)
            if disk_dir:
                ec.cache_store(train_path, train_key, embeddings=train_embs)

        if pairs_path is not None:
            from ..data.pairs import ImageCaptionPairs

            cap_ds = ImageCaptionPairs(pairs_path, image_size=n_px)
            _check_caption_corpus(
                len(cap_ds), batch_size,
                f"caption corpus at {pairs_path} has {len(cap_ds)} pairs, fewer "
                f"than batch_size={batch_size}; shrink the batch or grow the corpus")
            cap_embs_all = None
            if disk_dir:
                cap_paths = [cap_ds._path(i) for i in range(len(cap_ds))]
                cap_key = {**base_key,
                           "captions_csv": ec.file_sha256(
                               os.path.join(pairs_path, "captions.csv")),
                           "files": ec.files_fingerprint(cap_paths)}
                cap_path = ec.cache_path(disk_dir, "caption_rows", cap_key)
                hit = ec.cache_load(cap_path, cap_key)
                if hit is not None and len(hit["embeddings"]) == len(cap_ds):
                    cap_embs_all = hit["embeddings"]
                    disk_state["captions"] = "hit"
            if cap_embs_all is None:
                emb_rows = []
                for s in _progress(range(0, len(cap_ds), batch_size), progress,
                                   desc="embed cache: caption rows"):
                    idx = np.arange(s, min(s + batch_size, len(cap_ds)))
                    images, _ = cap_ds.load_batch(idx, tokenizer)
                    if len(idx) < batch_size:  # pad: one batch shape throughout
                        images = np.concatenate(
                            [images, np.zeros((batch_size - len(idx),) + images.shape[1:],
                                              images.dtype)])
                    emb_rows.append(embed_rows(images)[: len(idx)])
                cap_embs_all = np.concatenate(emb_rows, axis=0)
                if disk_dir:
                    ec.cache_store(cap_path, cap_key, embeddings=cap_embs_all)
            # tokens are not persisted: the tokenizer is an opaque callable
            cap_tokens_all = np.asarray(
                tokenizer([cap_ds.caption(i) for i in range(len(cap_ds))]))
            caption_idx_iter = _caption_index_stream(batch_size, rng, pairs_ds=cap_ds)
        else:
            # FairFace fallback: the caption images are the attribute rows
            _check_caption_corpus(
                len(train_ds), batch_size,
                f"FairFace caption fallback has {len(train_ds)} rows, fewer "
                f"than batch_size={batch_size}; shrink the batch")
            cap_embs_all = train_embs
            if disk_state is not None:
                disk_state["captions"] = "train-rows"
            cap_tokens_all = np.asarray(tokenizer(
                [_fairface_caption(train_ds.labels.iloc[i]) for i in range(len(train_ds))]))
            caption_idx_iter = _caption_index_stream(batch_size, rng, n=len(train_ds))
    else:
        caption_iter = _caption_batches(pairs_path, tokenizer, batch_size, train_ds,
                                        n_px, rng)

    eval_cache: dict = {}

    def evaluate_ndkl() -> float:
        # frozen-image configs embed the val images once
        if trainer.trains_image or "img" not in eval_cache:
            val_loader = HostLoader(val_ds, batch_size=256, num_workers=6,
                                    native_n_px=n_px)
            labels, img_embs = get_labels_img_embeddings(val_loader, model, n_px=n_px)
            if not trainer.trains_image:
                eval_cache["img"] = (labels, img_embs)
        else:
            labels, img_embs = eval_cache["img"]
        prompt_embs = get_prompt_embeddings(model, tokenizer, prompts)
        out = eval_ranking(labels, img_embs, prompt_embs, "ndkl", topn=1.0)
        return float(out["eq_opp"])

    for epoch in range(start_epoch, epochs):
        it = loader.iter_index_batches() if cache_embs else loader
        for batch in _progress(it, progress, total=len(loader), desc=f"epoch {epoch}"):
            if trainer.step_count >= total_steps:
                break  # recipe complete (mid-epoch resume re-entry)
            if cache_embs:
                cap_idx = next(caption_idx_iter)
                metrics = trainer.step_from_embeddings(
                    train_embs[batch.images], batch.labels.astype(np.float32),
                    cap_embs_all[cap_idx], cap_tokens_all[cap_idx])
            else:
                cap_images, cap_tokens = next(caption_iter)
                metrics = trainer.step(prep(batch.images),
                                       batch.labels.astype(np.float32),
                                       prep(cap_images), cap_tokens)
            logger.log(metrics, step=trainer.step_count)
            if eval_every and trainer.step_count % eval_every == 0:
                ndkl = evaluate_ndkl()
                is_best = trainer.maybe_update_best(ndkl)
                logger.log({"ndkl_eq_opp": ndkl, "is_best": is_best},
                           step=trainer.step_count)
                save_checkpoint(checkpoint_dir, trainer)

    final_ndkl = evaluate_ndkl()
    trainer.maybe_update_best(final_ndkl)
    save_checkpoint(checkpoint_dir, trainer)
    pt_path = export_reference_pt(
        trainer, os.path.join(checkpoint_dir, f"best_ndkl_{alias}_embeddings.pt"))
    logger.close()
    return {
        "best_ndkl": trainer.best_ndkl,
        "final_ndkl": final_ndkl,
        "steps": trainer.step_count,
        "export": pt_path,
        "checkpoint_dir": checkpoint_dir,
        "embed_cache": cache_embs,
        "embed_cache_disk": disk_state,
    }
