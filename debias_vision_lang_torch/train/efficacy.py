"""Trainer-efficacy experiment: does adversarial prompt training REDUCE the
measured bias, and is the adversarial term the cause?

Counterpart of ``debias_vision_lang_tpu/train/efficacy.py``, with the same
names, signatures and record layout.  A synthetic world carries a plantable,
known bias: every 32 px image has a gender tint on its left half and an
orthogonal concept tint ("round" / "square") on its right half, and the
pretraining captions pair adjectives with genders at an 85/15 skew.  A tiny
CLIP pretrained on that corpus ranks Female images first for "a photo of a
good person".  Then, per seed, one world and one biased pretrain feed two
arms of ``run_training`` from identical initial conditions: the full
objective (``adversarial_weight=1``) and a control without the adversary's
gradient (``adversarial_weight=0``).  Both are measured with the
framework's own metrics through ``measure_bias`` (NDKL at top-n 1.0,
MaxSkew at top-k, through its embedding cache) and a zero-shot concept
probe, before training and with the best-NDKL prompt array after it.

Two checks the JAX module leaves to its caller run here:

* ``measure_model`` holds the cache's row identity (its ``files``) to the
  caller's ``val_ds`` row by row, not only by length;
* ``run_ablation_experiment`` checks each seed's world before running its
  arms (``PRECONDITIONS``: a material bias and a working concept probe at
  the untrained prompt init) and records a seed that fails them under
  ``results["invalid"]`` without arms.  A seed names its world: nothing is
  resampled.

The world's files and arrays are byte-identical to the JAX module's for
the same seed.  Run:

    python -m debias_vision_lang_torch.train.efficacy --ablation --seeds 0 1 2

on the card (``--device cpu`` on the CPU).
"""

from __future__ import annotations

import json
import operator
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

# ---------------------------------------------------------------------------
# Vocabulary + tokenizer (word-level; EOT must be the max id for the
# EOT-argmax pooling trick, reference model/model.py:265)
# ---------------------------------------------------------------------------

FEMALE_ADJS = ["good", "kind", "smart", "honest"]
MALE_ADJS = ["evil", "rude", "dumb", "cruel"]
ADJECTIVES = FEMALE_ADJS + MALE_ADJS
CONCEPTS = ["round", "square"]
_FILLERS = [f"f{i}" for i in range(8)]
_BASE_WORDS = ["a", "photo", "of", "person", "female", "male"]

VOCAB = 32
CTX = 16
_WORD_IDS = {w: i + 1 for i, w in enumerate(
    _BASE_WORDS + CONCEPTS + ADJECTIVES + _FILLERS)}
SOT, EOT = VOCAB - 2, VOCAB - 1
if max(_WORD_IDS.values()) >= SOT:
    raise ValueError("the word ids must stay below SOT")


def word_tokenize(texts: List[str]) -> np.ndarray:
    """[B, CTX] int32; SOT + word ids + EOT, zero-padded (strict vocab)."""
    out = np.zeros((len(texts), CTX), np.int32)
    for i, t in enumerate(texts):
        ids = [_WORD_IDS[w] for w in t.lower().split()]
        if len(ids) > CTX - 2:
            raise ValueError(f"caption too long for CTX={CTX}: {t!r}")
        out[i, 0] = SOT
        out[i, 1 : 1 + len(ids)] = ids
        out[i, 1 + len(ids)] = EOT
    return out


def sensitive_prompts() -> List[str]:
    return [f"a photo of a {adj} person" for adj in ADJECTIVES]


def probe_prompts() -> List[str]:
    return [f"a photo of a {c} person" for c in CONCEPTS]


# ---------------------------------------------------------------------------
# Synthetic world (numpy, PIL and pandas: the JAX module's draws, in order)
# ---------------------------------------------------------------------------

PX = 32

_RACES = ["White", "Black", "Indian", "East Asian", "Southeast Asian",
          "Middle Eastern", "Latino_Hispanic"]
_AGES = ["0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69",
         "more than 70"]


def render_image(gender: int, concept: int, rng: np.random.Generator,
                 px: int = PX) -> np.ndarray:
    """uint8 [px, px, 3].  gender: 0=Male (blue left half), 1=Female (red
    left half); concept: 0=round (green right half), 1=square (magenta
    right half).  The two factors are equally salient (a +-120 channel tint
    each, over its own half): an asymmetric concept feature let two-tower
    pretraining settle in the gender-only optimum on some float
    configurations, and the probe then sat at chance."""
    img = np.full((px, px, 3), 64, np.float32)
    half = px // 2
    img[:, :half, 0 if gender == 1 else 2] += 120.0
    if concept == 0:
        img[:, half:, 1] += 120.0
    else:
        img[:, half:, 0] += 60.0
        img[:, half:, 2] += 60.0
    img += rng.uniform(-15.0, 15.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pretrain_caption(gender: int, concept: int,
                      rng: np.random.Generator) -> str:
    """Biased pretraining caption in the prompts' template family: an
    adjective 60% of the time, from the gender-matched pool with
    probability 0.85 (the planted skew); the gender and concept words drop
    out independently (with the gender word always present, contrastive
    training stalls on the gender shortcut); a filler word for diversity."""
    words = ["a", "photo", "of", "a"]
    if rng.random() < 0.6:
        matched = FEMALE_ADJS if gender == 1 else MALE_ADJS
        other = MALE_ADJS if gender == 1 else FEMALE_ADJS
        pool = matched if rng.random() < 0.85 else other
        words.append(pool[rng.integers(len(pool))])
    if rng.random() < 0.6:
        words.append("female" if gender == 1 else "male")
    if rng.random() < 0.9:
        words.append(CONCEPTS[concept])
    words += ["person", _FILLERS[rng.integers(len(_FILLERS))]]
    return " ".join(words)


def _pairs_caption(gender: int, concept: int,
                   rng: np.random.Generator) -> str:
    """Debias-phase contrastive caption, from the pretraining distribution
    (the planted skew included): the contrastive term then maintains the
    bias, so a drop is the adversarial objective's doing."""
    return _pretrain_caption(gender, concept, rng)


def build_world(root: str, n_train: int = 2048, n_val: int = 512,
                px: int = PX, seed: int = 0) -> Dict:
    """Write the FairFace-layout dataset + caption-pair corpus under root.

    Returns the paths and the in-memory pretraining arrays (images,
    captions), so pretraining needs no decode pass.  Layout (as
    data/datasets.py::FairFace and data/pairs.py::ImageCaptionPairs read it):

        root/fairface/imgs/train_val/syn/*.jpg
        root/fairface/labels/{train,val}/{train,val}_labels.csv
        root/pairs/captions.csv + root/pairs/images -> symlink to syn/
    """
    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(seed)
    ff = os.path.join(root, "fairface")
    img_dir = os.path.join(ff, "imgs", "train_val", "syn")
    os.makedirs(img_dir, exist_ok=True)

    def make_split(mode: str, n: int):
        rows, images, pre_captions = [], [], []
        for i in range(n):
            gender, concept = int(rng.integers(2)), int(rng.integers(2))
            img = render_image(gender, concept, rng, px)
            fname = f"syn/{mode}_{i:05d}.jpg"
            Image.fromarray(img).save(
                os.path.join(ff, "imgs", "train_val", fname), quality=95)
            rows.append({
                "file": fname,
                "age": _AGES[int(rng.integers(len(_AGES)))],
                "gender": "Female" if gender == 1 else "Male",
                "race": _RACES[int(rng.integers(len(_RACES)))],
                "concept": concept,
            })
            images.append(img)
            pre_captions.append(_pretrain_caption(gender, concept, rng))
        lbl_dir = os.path.join(ff, "labels", mode)
        os.makedirs(lbl_dir, exist_ok=True)
        df = pd.DataFrame(rows)
        df.to_csv(os.path.join(lbl_dir, f"{mode}_labels.csv"), index=False)
        return df, np.stack(images), pre_captions

    train_df, train_images, train_captions = make_split("train", n_train)
    make_split("val", n_val)

    pairs = os.path.join(root, "pairs")
    os.makedirs(pairs, exist_ok=True)
    link = os.path.join(pairs, "images")
    if not os.path.exists(link):
        try:
            os.symlink(os.path.join(ff, "imgs", "train_val"), link)
        except OSError:  # no-symlink filesystems: fall back to copying
            import shutil

            shutil.copytree(os.path.join(ff, "imgs", "train_val"), link)

    gid = (train_df["gender"] == "Female").astype(int)
    # its own stream: the pairs corpus must not perturb the world's draws
    pairs_rng = np.random.default_rng(seed + 104729)
    pd.DataFrame({
        "file": train_df["file"],
        "caption": [_pairs_caption(int(g), int(c), pairs_rng)
                    for g, c in zip(gid, train_df["concept"])],
    }).to_csv(os.path.join(pairs, "captions.csv"), index=False)

    return {
        "fairface": ff,
        "pairs": pairs,
        "train_images": train_images,
        "train_captions": train_captions,
    }


# ---------------------------------------------------------------------------
# Tiny CLIP + contrastive pretraining (plants the bias)
# ---------------------------------------------------------------------------


def tiny_clip_cfg(px: int = PX):
    from ..core.config import CLIPConfig, TextConfig, VisionConfig

    return CLIPConfig(
        name="tiny-efficacy",
        vision=VisionConfig(kind="vit", image_size=px, patch_size=8,
                            width=64, layers=2, heads=4, embed_dim=32),
        text=TextConfig(vocab_size=VOCAB, context_length=CTX, width=64,
                        layers=2, heads=4, embed_dim=32),
    )


def pretrain_loss(model, images_u8: torch.Tensor, tokens: torch.Tensor,
                  cfg) -> torch.Tensor:
    """The pretraining objective on one batch: the device preprocess, both
    towers in float32, symmetric InfoNCE at the model's logit scale."""
    from ..vision.preprocess import preprocess_batch
    from .adversarial import clip_contrastive_loss

    imgs = preprocess_batch(images_u8, cfg.vision.image_size,
                            mean=cfg.vision.image_mean, std=cfg.vision.image_std)
    img = model.encode_image(imgs).float()
    txt = model.encode_text(tokens).float()
    return clip_contrastive_loss(img, txt, model.logit_scale)


def pretrain_tiny_clip(images_u8: np.ndarray, captions: List[str],
                       steps: int = 400, batch_size: int = 64,
                       lr: float = 2e-3, seed: int = 0, px: int = PX,
                       progress: bool = False,
                       params: Optional[Mapping] = None, device="cuda"):
    """Contrastive pretraining of the full tiny tower on the biased corpus.

    Returns (params, cfg): ``params`` a ``CLIP(cfg)`` state dict on
    ``device``.  Starts from ``params`` when given (a ``CLIP(cfg)`` state
    dict), else from the port's random init seeded with ``seed``.  Adam at optax.adam's defaults (b1 0.9, b2
    0.999, eps 1e-8); the batches are the JAX module's (the same numpy
    permutation schedule)."""
    from ..models.clip import CLIP, init_clip_params

    dev = resolve_device(device)
    cfg = tiny_clip_cfg(px)
    if params is None:
        params = init_clip_params(cfg, torch.Generator().manual_seed(seed))
    model = CLIP(cfg)
    model.load_state_dict(params)
    model.to(dev)
    images = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
    tokens = torch.from_numpy(word_tokenize(captions)).long().to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    rng = np.random.default_rng(seed)
    n = len(images_u8)
    order = rng.permutation(n)
    cursor = 0
    for it in range(steps):
        if cursor + batch_size > n:
            order, cursor = rng.permutation(n), 0
        sel = torch.from_numpy(order[cursor : cursor + batch_size]).to(dev)
        cursor += batch_size
        loss = pretrain_loss(model, images[sel], tokens[sel], cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if progress and (it % 50 == 0 or it == steps - 1):
            print(f"pretrain step {it}: contrastive loss {loss.item():.4f}")
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, cfg


# ---------------------------------------------------------------------------
# Measurement (the framework's own metrics, before vs after)
# ---------------------------------------------------------------------------


def measure_model(model, val_ds, topk: int = 50,
                  data_path: Optional[str] = None) -> Dict[str, float]:
    """NDKL (topn=1.0, the reference default) + top-k MaxSkew over the
    adjective prompts, and zero-shot concept-probe accuracy, with the
    model's current debias tokens, on the model's device.

    With ``data_path`` the bias numbers come from ``eval.measure.measure_bias``
    with the embedding cache: the MaxSkew call is a hit on the NDKL call's
    image embeddings, and the probe reads them back from the cache file,
    whose rows must be ``val_ds``'s rows in order (raises otherwise).
    Without it, the same engines are called directly on ``val_ds``."""
    from ..eval.measure import get_prompt_embeddings, model_device

    n_px = model.clip_cfg.vision.image_size
    if data_path is not None:
        import tempfile

        from ..eval.measure import measure_bias
        from ..vision.preprocess import Preprocess

        preproc = Preprocess(n_px=n_px)
        with tempfile.TemporaryDirectory(prefix="efficacy_embs_") as td:
            cache = os.path.join(td, "val_embeddings.npz")
            common = {"prompts": sensitive_prompts(), "data_path": data_path,
                      "cache_embeddings": cache}
            ndkl = measure_bias(
                model, preproc, word_tokenize, "gender",
                opts={**common, "evaluations": ("ndkl",), "topn": 1.0,
                      "progress": False})["ndkl"]
            maxskew = measure_bias(  # a cache hit: no second image pass
                model, preproc, word_tokenize, "gender",
                opts={**common, "evaluations": ("maxskew",), "topn": topk,
                      "progress": False})["maxskew"]
            with np.load(cache, allow_pickle=False) as data:
                files = data["files"].tolist()
                img_embs = torch.from_numpy(data["embeddings"]).to(model_device(model))
        # the probe's labels come from the caller's val_ds, the embeddings
        # from the dataset measure_bias built: hold the two row for row
        want = val_ds.labels["file"].tolist()
        if files != want:
            bad = next((i for i, (a, b) in enumerate(zip(files, want)) if a != b),
                       min(len(files), len(want)))
            raise RuntimeError(
                f"measure_bias embedded {len(files)} rows but val_ds has "
                f"{len(want)}, first differing at row {bad}: the embeddings do "
                f"not line up with val_ds's labels")
    else:
        from ..data.loader import HostLoader
        from ..eval.measure import eval_ranking, get_labels_img_embeddings

        loader = HostLoader(val_ds, batch_size=256, native_n_px=n_px)
        labels, img_embs = get_labels_img_embeddings(loader, model, n_px=n_px)
        prompt_embs = get_prompt_embeddings(model, word_tokenize,
                                            sensitive_prompts())
        ndkl = eval_ranking(labels, img_embs, prompt_embs, "ndkl", topn=1.0)
        maxskew = eval_ranking(labels, img_embs, prompt_embs, "maxskew",
                               topn=topk)

    probe = get_prompt_embeddings(model, word_tokenize, probe_prompts())
    img_n = img_embs / torch.linalg.vector_norm(img_embs, dim=-1, keepdim=True)
    pred = torch.argmax(img_n @ probe.T, dim=1).cpu().numpy()
    concept = val_ds.labels["concept"].to_numpy()
    return {
        "ndkl_eq_opp": float(ndkl["eq_opp"]),
        "ndkl_dem_par": float(ndkl["dem_par"]),
        f"maxskew@{topk}_eq_opp": float(maxskew["eq_opp"]),
        f"maxskew@{topk}_dem_par": float(maxskew["dem_par"]),
        "probe_acc": float(np.mean(pred == concept)),
    }


# ---------------------------------------------------------------------------
# The experiment
# ---------------------------------------------------------------------------

# a world is worth ablating only if the plant took (a material bias at the
# untrained prompt init) and the tower is aligned (the concept probe works,
# chance being 0.5): tests/test_efficacy.py's preconditions
PRECONDITIONS = (("ndkl_eq_opp", ">", 0.2),
                 ("maxskew@{topk}_eq_opp", ">", 0.3),
                 ("probe_acc", ">=", 0.85))
_COMPARE = {">": operator.gt, ">=": operator.ge}


def failed_preconditions(before: Dict[str, float], topk: int = 50) -> List[str]:
    """The checks of ``PRECONDITIONS`` that ``before`` fails, each named as
    "<metric> <op> <bar>"; empty when the world is valid."""
    failed = []
    for key, op, bar in PRECONDITIONS:
        key = key.format(topk=topk)
        value = before[key]
        if not (value == value and _COMPARE[op](value, bar)):  # NaN fails
            failed.append(f"{key} {op} {bar}")
    return failed


def prepare_world(root: str, n_train: int = 2048, n_val: int = 512,
                  pretrain_steps: int = 2500, batch_size: int = 64,
                  seed: int = 0, progress: bool = False, device="cuda"):
    """Build the biased world + pretrain the tiny CLIP on it (the shared
    prefix of every arm).  Returns (world, params, cfg, val_ds); arms build
    their models from copies of ``params``."""
    from ..data.datasets import FairFace

    world = build_world(root, n_train=n_train, n_val=n_val, seed=seed)
    params, cfg = pretrain_tiny_clip(
        world["train_images"], world["train_captions"],
        steps=pretrain_steps, batch_size=batch_size, seed=seed,
        progress=progress, device=device)
    val_ds = FairFace(mode="val", iat_type="gender",
                      data_path=world["fairface"], download=False)
    return world, params, cfg, val_ds


def _fresh_model(params, cfg, seed: int, device="cuda"):
    """A fresh DebiasCLIP at the reference-default prompt init ("zeros" =
    the embedding of token id 0), on ``device``.  A new object per arm: the
    trainer updates the model's prompt array in place.  ``seed + 1`` seeds
    the init's generator, as in JAX (the "zeros" init draws nothing)."""
    from ..core.config import DebiasConfig
    from ..models.clip import CLIP
    from ..models.debias import DebiasCLIP, init_debias_tokens

    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=cfg.text.width,
                        max_tokens=CTX, debias_pos="prepend",
                        debias_token_init="zeros")
    clip = CLIP(cfg)
    clip.load_state_dict(params)
    deb = init_debias_tokens(clip, dcfg, tokenizer=None,
                             generator=torch.Generator().manual_seed(seed + 1))
    return DebiasCLIP(clip, deb, dcfg).to(resolve_device(device))


def run_arm(
    world: Dict,
    params,
    cfg,
    val_ds,
    ckpt_dir: str,
    epochs: int = 3,
    batch_size: int = 64,
    eval_every: int = 8,
    topk: int = 50,
    seed: int = 0,
    prompt_lr: Optional[float] = None,
    adversarial_weight: Optional[float] = None,
    progress: bool = False,
    before: Optional[Dict] = None,
    device="cuda",
) -> Dict:
    """One experiment arm: measure -> run_training -> measure with the
    best-NDKL prompt array.  ``adversarial_weight=0`` is the ablation
    control (the adversary still trains, but its gradient never reaches
    the prompt array).  ``before``: a before-measurement of the same fresh
    model, when the caller has one (None measures here)."""
    from ..core.config import TrainConfig
    from .loop import run_training

    model = _fresh_model(params, cfg, seed, device)
    if before is None:
        before = measure_model(model, val_ds, topk=topk,
                               data_path=world["fairface"])
    if progress:
        print("before:", json.dumps(before, indent=2))

    tcfg = TrainConfig(
        batch_size=batch_size, num_epochs=epochs, eval_every_steps=eval_every,
        seed=seed,
        prompt_lr=prompt_lr if prompt_lr is not None else 2e-3,
        adversarial_weight=(adversarial_weight
                            if adversarial_weight is not None else 1.0),
        checkpoint_dir=ckpt_dir,
    )
    summary = run_training(
        model=model,
        tokenizer=word_tokenize,
        attribute="gender",
        data_path=world["fairface"],
        pairs_path=world["pairs"],
        sensitive_prompts=sensitive_prompts(),
        eval_n_samples=None,
        train_cfg=tcfg,
        checkpoint_dir=tcfg.checkpoint_dir,
        use_pallas=False,
        progress=progress,
        seed=seed,
        device=device,
    )

    # the exported .pt is the best-NDKL prompt array (reference checkpoint
    # format: a bare [P, width] tensor, model/clip.py:75-81)
    best = torch.load(summary["export"], map_location="cpu", weights_only=True)
    with torch.no_grad():
        model.debias_tokens.copy_(best)
    after = measure_model(model, val_ds, topk=topk,
                          data_path=world["fairface"])
    if progress:
        print("after:", json.dumps(after, indent=2))

    curve = []
    log_path = os.path.join(summary["checkpoint_dir"], "logs",
                            "metrics.jsonl")
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                rec = json.loads(line)
                if "ndkl_eq_opp" in rec:
                    curve.append({"step": rec.get("step"),
                                  "ndkl_eq_opp": rec["ndkl_eq_opp"]})

    def _rel_drop(key):
        b = before[key]
        return float("nan") if b == 0 else (b - after[key]) / b

    return {
        "before": before,
        "after": after,
        "reduction": {k: _rel_drop(k) for k in before if k != "probe_acc"},
        "train_summary": summary,
        "curve": curve,
    }


def run_efficacy_experiment(
    root: str,
    n_train: int = 2048,
    n_val: int = 512,
    pretrain_steps: int = 2500,
    epochs: int = 3,
    batch_size: int = 64,
    eval_every: int = 8,
    topk: int = 50,
    seed: int = 0,
    prompt_lr: Optional[float] = None,
    adversarial_weight: Optional[float] = None,
    progress: bool = False,
    device="cuda",
) -> Dict:
    """Build world -> pretrain (bias planted) -> measure -> run_training ->
    measure with the best-NDKL prompt array.  Returns the full record."""
    world, params, cfg, val_ds = prepare_world(
        root, n_train=n_train, n_val=n_val, pretrain_steps=pretrain_steps,
        batch_size=batch_size, seed=seed, progress=progress, device=device)
    return run_arm(world, params, cfg, val_ds,
                   ckpt_dir=os.path.join(root, "ckpt"), epochs=epochs,
                   batch_size=batch_size, eval_every=eval_every, topk=topk,
                   seed=seed, prompt_lr=prompt_lr,
                   adversarial_weight=adversarial_weight, progress=progress,
                   device=device)


def run_ablation_experiment(
    root: str,
    seeds=(0, 1, 2),
    n_train: int = 2048,
    n_val: int = 512,
    pretrain_steps: int = 2500,
    epochs: int = 3,
    batch_size: int = 64,
    eval_every: int = 8,
    topk: int = 50,
    progress: bool = False,
    device="cuda",
) -> Dict:
    """The causal experiment: per seed, one world + one biased pretrain,
    one before-measurement, then two arms from identical initial
    conditions, ``adversarial`` (adversarial_weight=1) and ``control``
    (adversarial_weight=0: identical data, schedule, contrastive term,
    optimizer and best-NDKL selection; only the adversary's gradient never
    reaches the prompts).  A seed whose before-measurement fails
    ``PRECONDITIONS`` goes under ``results["invalid"][seed]`` with its
    before-values and the failed checks, and its arms are not run."""
    results: Dict = {"seeds": {}, "invalid": {}, "config": {
        "n_train": n_train, "n_val": n_val, "pretrain_steps": pretrain_steps,
        "epochs": epochs, "batch_size": batch_size, "eval_every": eval_every,
        "topk": topk,
    }}
    for seed in seeds:
        seed_root = os.path.join(root, f"seed{seed}")
        world, params, cfg, val_ds = prepare_world(
            seed_root, n_train=n_train, n_val=n_val,
            pretrain_steps=pretrain_steps, batch_size=batch_size, seed=seed,
            progress=progress, device=device)
        # both arms start from the identical fresh model over the identical
        # val split: one before-measurement serves both
        before = measure_model(_fresh_model(params, cfg, seed, device), val_ds,
                               topk=topk, data_path=world["fairface"])
        failed = failed_preconditions(before, topk)
        if failed:
            results["invalid"][seed] = {"before": before, "failed": failed}
            if progress:
                print(f"seed {seed}: invalid world, fails {failed}; before {before}")
            continue
        arms = {}
        for name, w in (("adversarial", 1.0), ("control", 0.0)):
            if progress:
                print(f"=== seed {seed} arm {name} (adv_weight={w}) ===")
            arms[name] = run_arm(
                world, params, cfg, val_ds,
                ckpt_dir=os.path.join(seed_root, f"ckpt_{name}"),
                epochs=epochs, batch_size=batch_size, eval_every=eval_every,
                topk=topk, seed=seed, adversarial_weight=w,
                progress=progress, before=before, device=device)
        results["seeds"][seed] = arms
        if progress:
            a, c = arms["adversarial"], arms["control"]
            print(f"seed {seed}: adversarial NDKL "
                  f"{a['before']['ndkl_eq_opp']:.3f} -> "
                  f"{a['after']['ndkl_eq_opp']:.3f} "
                  f"(drop {a['reduction']['ndkl_eq_opp']:.1%}) | control "
                  f"{c['before']['ndkl_eq_opp']:.3f} -> "
                  f"{c['after']['ndkl_eq_opp']:.3f} "
                  f"(drop {c['reduction']['ndkl_eq_opp']:.1%})")
    return results


def main(argv=None):
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="working dir (default: a fresh temp dir)")
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-val", type=int, default=512)
    ap.add_argument("--pretrain-steps", type=int, default=2500)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=8)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ablation", action="store_true",
                    help="run the adversarial-vs-control causal experiment "
                         "over --seeds instead of a single arm")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--adversarial-weight", type=float, default=None)
    ap.add_argument("--json-out", default=None,
                    help="also write the full record to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="efficacy_")
    if args.ablation:
        out = run_ablation_experiment(
            root, seeds=tuple(args.seeds), n_train=args.n_train,
            n_val=args.n_val, pretrain_steps=args.pretrain_steps,
            epochs=args.epochs, batch_size=args.batch_size,
            eval_every=args.eval_every, topk=args.topk, progress=True,
            device=args.device)
        printable = {
            str(s): {arm: {k: rec[k]
                           for k in ("before", "after", "reduction", "curve")}
                     for arm, rec in arms.items()}
            for s, arms in out["seeds"].items()}
        for s, rec in out["invalid"].items():
            printable[str(s)] = {"invalid": rec}
    else:
        out = run_efficacy_experiment(
            root, n_train=args.n_train, n_val=args.n_val,
            pretrain_steps=args.pretrain_steps, epochs=args.epochs,
            batch_size=args.batch_size, eval_every=args.eval_every,
            topk=args.topk, seed=args.seed,
            adversarial_weight=args.adversarial_weight, progress=True,
            device=args.device)
        printable = {k: out[k]
                     for k in ("before", "after", "reduction", "curve")}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(printable, f, indent=2)
    print(json.dumps(printable, indent=2))


if __name__ == "__main__":
    main()
