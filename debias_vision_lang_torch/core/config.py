"""Configuration carriers (the port's own copy of
``debias_vision_lang_tpu/core/config.py``: the same dataclasses, fields and
defaults, held to it by tests/test_torch_standalone.py).

The reference uses a single attr-style dict (``Dotdict``,
reference: debias_clip/__init__.py:4-18) with UPPERCASE keys as the config
surface of every constructor (reference: debias_clip/model/model.py:130-142,
339-346).  We keep a behavior-compatible ``Dotdict`` as the *interchange*
format so ``from_cfg(dict)`` call sites keep working, but the framework's own
configuration is typed dataclasses (one per subsystem) that can be built from
a ``Dotdict`` and validated once, instead of ``**_kwargs`` swallowing typos.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union


class Dotdict(dict):
    """Attribute-access dict, pickle-safe.

    Behavior parity with the reference (debias_clip/__init__.py:4-18):
    missing attributes resolve to ``None`` (``dict.get``), attribute writes
    are item writes, and pickling round-trips.
    """

    def __getattr__(self, name: str) -> Any:
        return super().get(name)

    def __setattr__(self, name: str, value: Any) -> None:
        super().__setitem__(name, value)

    def __delattr__(self, name: str) -> None:
        super().__delitem__(name)

    def __getstate__(self):
        return dict(self)

    def __setstate__(self, state):
        self.update(state)

    # dict() copies drop the subclass; keep an explicit typed copy.
    def copy(self) -> "Dotdict":
        return Dotdict(self)


# ---------------------------------------------------------------------------
# Typed configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Vision tower architecture (ViT or ModifiedResNet)."""

    kind: str = "vit"  # "vit" | "resnet"
    image_size: int = 224
    patch_size: int = 16  # ViT only
    width: int = 768
    layers: Union[int, Tuple[int, int, int, int]] = 12  # int for ViT, 4-tuple for ResNet stages
    heads: int = 12
    embed_dim: int = 512  # shared image/text embedding dim
    # video_vit only: "joint" (TPU-first fused attention) or "divided"
    # (upstream-faithful space-time attention — the loader selects it for
    # converted FiT checkpoints with trained temporal weights).  Carried in
    # the CONFIG so every consumer — the FrozenInTime bundle, the
    # functional encode_image dispatch, DebiasCLIP wrappers — agrees.
    video_attention: str = "joint"
    # normalization stats the tower was TRAINED with: OpenAI CLIP stats by
    # default; SLIP and Frozen-in-Time trained on ImageNet stats (their
    # upstream preprocess) — carried per-arch so preprocess, the device
    # normalize, and the folded u8/p8 stems all agree (round-3 review fix:
    # SLIP/FiT used to be silently normalized with CLIP stats)
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        # class token + patches
        return self.num_patches + 1


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Text tower architecture (CLIP text transformer)."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """A full dual-encoder architecture."""

    name: str = "ViT-B/16"
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    # fp32 parity mode matches the reference's .float() upcasts
    # (reference: debias_clip/model/model.py:136,170); bf16 is the TPU speed path.
    dtype: str = "float32"

    @property
    def embed_dim(self) -> int:
        return self.text.embed_dim


@dataclasses.dataclass(frozen=True)
class DebiasConfig:
    """Prompt-array debiasing wrapper configuration.

    Field names are the lowercase forms of the reference's UPPERCASE config
    keys (reference: debias_clip/model/model.py:144-146).
    """

    num_debias_tokens: int = 2
    hidden_dim: int = 512
    max_tokens: int = 77
    n_train_vid_layers: int = 0
    n_train_text_layers: int = 0
    freeze_proj: bool = True
    debias_token_init: Union[str, List[str]] = "zeros"  # "rand" | "zeros" | [words]
    debias_pos: str = "prepend"  # "prepend" | "append" | "append_after_eos" | "add"

    def __post_init__(self):
        if self.debias_pos not in {"prepend", "append", "append_after_eos", "add"}:
            raise NotImplementedError(
                f"debias_pos must be one of prepend/append/append_after_eos/add, "
                f"got {self.debias_pos!r}"
            )
        # keep the config hashable (it rides as jit static/aux data): the
        # word-list init form arrives as a list → freeze to a tuple
        if isinstance(self.debias_token_init, list):
            object.__setattr__(self, "debias_token_init",
                               tuple(self.debias_token_init))


@dataclasses.dataclass(frozen=True)
class AdversaryConfig:
    """Adversary MLP configuration (reference: debias_clip/model/model.py:339-346)."""

    n_input: int = 319
    n_output: int = 1
    hidden_size: int = 32


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """measure_bias options — the reference's dead ``opts`` parameter
    (reference: debias_clip/measuring_bias.py:136-139), made live.

    ``topn``: float = fraction of the dataset (1.0 = whole set, the reference
    default), int = absolute top-k.  The headline paper numbers are top-k.
    """

    batch_size: int = 256
    topn: Union[int, float] = 1.0
    evaluations: Sequence[str] = ("maxskew", "ndkl")
    num_workers: int = 6  # host decode threads (reference used 6 processes)
    progress: bool = False
    # "oracle" = numpy/pandas transliteration; "tpu" = jitted vectorized path
    engine: str = "tpu"
    # embedding compute precision: "float32" (reference-parity) | "bfloat16"
    # (TPU speed path) | "int8" (fastest — quantized vision tower via the
    # int8 fused kernels; rank metrics are stable under both, tested) |
    # "int8-text" (int8 text tower too; DebiasCLIP keeps fp prompt injection)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Adversarial prompt-tuning loop (reconstructed spec, SURVEY.md §3.5)."""

    batch_size: int = 64
    num_epochs: int = 5
    prompt_lr: float = 2e-3
    adversary_lr: float = 1e-3
    contrastive_weight: float = 1.0
    adversarial_weight: float = 1.0
    adversary_steps_per_prompt_step: int = 1
    eval_every_steps: int = 500
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    # Frozen image-tower compute precision: "float32" (reference-parity) |
    # "bfloat16" (TPU speed path — engages the fused-block kernels for the
    # no-gradient embed pass) | "int8" (fastest — quantized tower, ViT only).
    # The differentiable prompt/adversary steps stay fp32 either way, so
    # training dynamics see only the embedding rounding.
    embed_dtype: str = "float32"
    # Differentiable text-tower compute precision (mixed precision): the
    # forward/backward of the prompt-update steps run at this dtype while
    # the prompt array, optimizer state, gradients, losses, and the adversary
    # stay fp32 (cast-in/cast-out — the dominant prompt_step cost is the
    # 319-prompt text tower f+b, fp32 on the reference path).
    train_dtype: str = "float32"
    # OPT-IN approximation for image-path training configs (vid layers or
    # unfrozen projections): the adversarial-score term treats the attribute
    # batch's image embeddings as FROZEN (precomputed by the no-gradient
    # embed pass, stop-gradient) — only the caption batch re-embeds
    # differentiably for the contrastive term.  Saves one image-tower
    # fwd+bwd per step, but CHANGES GRADIENTS: the adversary signal reaches
    # image-path params only through contrastive alignment, not directly
    # (and the scores see embed_dtype precision).  Ignored by exact-frozen
    # configs, whose fast path is already exact.  Measured step-time and
    # training-dynamics comparison: PERF.md "approximate adversarial split".
    approx_frozen_scores: bool = False
    # Optimizer shaping for BOTH default optax chains (prompt + adversary;
    # explicit optimizers passed to build_train_steps bypass these).
    # "constant" reproduces the plain adam(lr) used so far; "cosine" /
    # "warmup_cosine" run optax schedules over ``decay_steps`` TOTAL
    # trainer steps (warmup_steps of linear ramp from 0 first, for
    # warmup_cosine).  ``decay_steps`` is required for the cosine
    # schedules when calling build_train_steps directly; run_training
    # derives it from epochs × steps-per-epoch when left None.  With
    # ``adversary_steps_per_prompt_step`` > 1 the adversary's default
    # chain scales its horizon/warmup by the cadence so both schedules
    # finish at the same TRAINER step (the adversary takes cadence×
    # updates per trainer step) — see build_train_steps.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    # Optional global-norm gradient clipping (optax.clip_by_global_norm)
    # applied before adam in both chains.  None = off (the default keeps
    # the historical update rule bit-identical).
    grad_clip_norm: Optional[float] = None
    # Per-layer rematerialization (jax.checkpoint) for the DIFFERENTIABLE
    # image-tower passes of the with-layers steps.  Numerically identical
    # (same ops recomputed in the backward); trades ~one extra tower
    # forward for a ~num_layers reduction in saved activations.  Without
    # it the exact with-layers step at ViT-B/16 does not fit one v5e chip
    # even at batch 32 (measured 16.8 G > 15.75 G HBM; benchmarks/
    # train_approx.py).  The frozen no-gradient embed passes never need it.
    remat_image_tower: bool = True
    # Frozen-tower embedding cache for the TRAINING stream (run_training):
    # in frozen-image configs (prompt-only and text-layers-only — the
    # reference's entire protocol, README.md:148-157) every epoch re-decodes
    # and re-embeds the SAME images through the SAME frozen tower.  With the
    # cache, both the attribute batch and the caption corpus embed exactly
    # once (one pass at embed_dtype) and epochs train from gathered
    # embedding rows — the per-step host ingest and frozen tower passes
    # disappear.  Batch sequences and arithmetic are unchanged (the cached
    # rows are the same jitted embed program's outputs; equivalence pinned
    # in tests/test_train_loop.py::TestEmbedCache), so this is a pure-speed
    # knob.  Host memory:
    # (n_train + n_pairs) × embed_dim × 4 bytes (fp32 rows — ~178 MB at
    # full-FairFace scale).  Automatically inactive when image-path params
    # train (vid layers / unfrozen projections — the embeddings would go
    # stale; that includes every approx_frozen_scores config).
    cache_frozen_embeddings: bool = True
    # Persist those once-embedded rows to DISK, keyed by content
    # fingerprints (tower params bytes, dataset rows, captions CSV, embed
    # dtype, resolution — train/embcache.py), so REPEATED run_training
    # calls over the same frozen tower + data (hyperparameter sweeps, the
    # reference protocol's grids) skip even the one-time decode+embed
    # pass.  None (default) keeps the cache in-memory per call.
    embedding_cache_dir: Optional[str] = None


_UPPER_KEYS = {
    "CLIP_ARCH",
    "DEVICE",
    "NUM_DEBIAS_TOKENS",
    "HIDDEN_DIM",
    "MAX_TOKENS",
    "N_TRAIN_VID_LAYERS",
    "N_TRAIN_TEXT_LAYERS",
    "FREEZE_PROJ",
    "DEBIAS_TOKEN_INIT",
    "DEBIAS_POS",
}


def debias_config_from_dotdict(cfg: Union[dict, Dotdict]) -> DebiasConfig:
    """Build a DebiasConfig from the reference's UPPERCASE-key dict convention.

    Mirrors the lowercase-kwargs construction at
    reference: debias_clip/model/model.py:138-140 (unknown keys ignored, as the
    reference's ``**_kwargs`` swallows them).
    """
    cfg = Dotdict(cfg)
    fields = {f.name for f in dataclasses.fields(DebiasConfig)}
    kwargs = {k.lower(): v for k, v in cfg.items() if k.lower() in fields}
    return DebiasConfig(**kwargs)


def adversary_config_from_dotdict(cfg: Union[dict, Dotdict]) -> AdversaryConfig:
    """Reference: debias_clip/model/model.py:339-346 (ADV_* keys)."""
    cfg = Dotdict(cfg)
    kwargs = {}
    if cfg.ADV_N_INPUT is not None:
        kwargs["n_input"] = cfg.ADV_N_INPUT
    if cfg.ADV_N_OUTPUT is not None:
        kwargs["n_output"] = cfg.ADV_N_OUTPUT
    if cfg.ADV_HIDDEN_SIZE is not None:
        kwargs["hidden_size"] = cfg.ADV_HIDDEN_SIZE
    return AdversaryConfig(**kwargs)
