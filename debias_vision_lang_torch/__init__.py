"""debias_vision_lang_torch -- the PyTorch + CUDA port of
``debias_vision_lang_tpu`` for one NVIDIA H100 (Hopper, sm_90a).

    import debias_vision_lang_torch as debias_clip
    model, preprocess, tokenizer, alias = debias_clip.DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False}, device="cuda")
    results = debias_clip.measure_bias(model, preprocess, tokenizer, "gender",
                                       opts={"dtype": "bfloat16"})
    summary = debias_clip.run_training(model=model, tokenizer=tokenizer,
                                       data_path="/path/to/fairface", epochs=1)
    model, preprocess = debias_clip.load("/path/to/prompts.pt")  # hub

    from debias_vision_lang_torch.eval.zero_shot import zero_shot_accuracy
    acc = zero_shot_accuracy(model, tokenizer, loader, class_names, dtype="bfloat16")

    python -m debias_vision_lang_torch serve --random-weights --dtype bfloat16
    python -m debias_vision_lang_torch zero-shot --data-path DIR --random-weights

The port stands alone: it keeps its own copies of what it shares with the
JAX package (``core/`` configuration and registry, ``native/`` host ingest,
``data/datasets.py``, the ``text/`` BPE tokenizer, ``metrics/oracle.py``,
the prompt assets), imports torch, and imports neither jax nor anything of
``debias_vision_lang_tpu``.  Its entry points run on the card unless given
``device="cpu"``.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    AdversaryConfig,
    CLIPConfig,
    DebiasConfig,
    Dotdict,
    EvalConfig,
    TextConfig,
    TrainConfig,
    VisionConfig,
    DATA_PATH,
    FAIRFACE_DATA_PATH,
    PROMPT_DATA_PATH,
    UTKFACE_DATA_PATH,
    VALID_CLIP_MODELS,
    VALID_MODELS,
    alias_name,
    resolve_arch,
)

# the heavy modules, and those that need optional packages (pandas, regex)
# or assets (the BPE vocabulary), load on first use
_LAZY = {
    "measure_bias": ("debias_vision_lang_torch.eval.measure", "measure_bias"),
    "eval_ranking": ("debias_vision_lang_torch.eval.measure", "eval_ranking"),
    "gen_prompts": ("debias_vision_lang_torch.eval.measure", "gen_prompts"),
    "DebiasCLIP": ("debias_vision_lang_torch.models.debias", "DebiasCLIP"),
    "model_loader": ("debias_vision_lang_torch.models.loader", "model_loader"),
    "ClipLike": ("debias_vision_lang_torch.models.loader", "ClipLike"),
    "Adversary": ("debias_vision_lang_torch.models.adversary", "Adversary"),
    "AdversarialTrainer": ("debias_vision_lang_torch.train.adversarial",
                           "AdversarialTrainer"),
    "run_training": ("debias_vision_lang_torch.train.loop", "run_training"),
    "load": ("debias_vision_lang_torch.hub", "load"),
    "available_models": ("debias_vision_lang_torch.hub", "available_models"),
    "tokenize": ("debias_vision_lang_torch.text.tokenizer", "tokenize"),
    "load_tokenizer": ("debias_vision_lang_torch.text.tokenizer", "load_tokenizer"),
    "FairFace": ("debias_vision_lang_torch.data.datasets", "FairFace"),
    "UTKFace": ("debias_vision_lang_torch.data.datasets", "UTKFace"),
    "IATDataset": ("debias_vision_lang_torch.data.datasets", "IATDataset"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
