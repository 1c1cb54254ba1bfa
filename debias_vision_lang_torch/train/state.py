"""Training state persistence: ``torch.save`` checkpoints and the
reference-format prompt export.

Counterpart of ``debias_vision_lang_tpu/train/state.py`` (Orbax there).  A
checkpoint is one file ``step_<n>.pt`` holding the entries of the Orbax
tree: the prompt array, the adversary's parameters, both optimizers'
states, ``meta`` (step, best NDKL, best tokens and whether there are any)
and, when CLIP layers train, the CLIP weights and the best ones.  It is
written to ``<file>.part`` and renamed, so an interrupted save leaves no
truncated checkpoint behind.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.convert import save_debias_prompt_pt

_MISMATCH = (
    "restoring checkpoint {path} failed ({err!r}). If the checkpoint file is "
    "intact, the usual cause is a trainer state mismatch: TrainConfig "
    "optimizer settings (lr_schedule/grad_clip_norm) or the layer-training "
    "config changed between save and resume — the optimizer state structure "
    "must match the one that wrote the checkpoint.")


def _host(sd) -> dict:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def save_checkpoint(directory: str, trainer, step: Optional[int] = None) -> str:
    """Checkpoint an AdversarialTrainer; returns the file's path."""
    step = int(step if step is not None else trainer.step_count)
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    tokens = trainer.model.debias_tokens.detach().cpu().clone()
    state = {
        "debias_tokens": tokens,
        "adversary_params": _host(trainer.adversary.state_dict()),
        "prompt_opt_state": trainer.prompt_opt.state_dict(),
        "adv_opt_state": trainer.adv_opt.state_dict(),
        "meta": {
            "step": trainer.step_count,
            "best_ndkl": float(trainer.best_ndkl),
            "best_tokens": (torch.from_numpy(np.asarray(trainer.best_tokens, np.float32))
                            if trainer.best_tokens is not None
                            else torch.zeros_like(tokens)),
            "has_best": trainer.best_tokens is not None,
        },
    }
    # layer-training mode changes the CLIP weights, and the joint optimizer's
    # moments belong to them: the weights are saved too
    if trainer.grad_mask is not None:
        clip = _host(trainer.model.clip.state_dict())
        best = trainer.best_clip_params
        state["clip_params"] = clip
        state["best_clip_params"] = (best if best is not None
                                     else {k: torch.zeros_like(v) for k, v in clip.items()})
        state["meta"]["has_best_clip"] = best is not None
    tmp = path + ".part"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, trainer) -> None:
    """Restore trainer state in place from ``save_checkpoint``'s file."""
    layered = trainer.grad_mask is not None
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
        want = {"debias_tokens", "adversary_params", "prompt_opt_state",
                "adv_opt_state", "meta"}
        if layered:
            want |= {"clip_params", "best_clip_params"}
        if set(state) != want:
            raise KeyError(f"checkpoint entries {sorted(state)}, expected {sorted(want)}")
        tokens = trainer.model.debias_tokens
        if tuple(state["debias_tokens"].shape) != tuple(tokens.shape):
            raise ValueError(f"prompt array {tuple(state['debias_tokens'].shape)}, "
                             f"trainer has {tuple(tokens.shape)}")
        if layered:
            trainer.model.clip.load_state_dict(state["clip_params"])
        with torch.no_grad():
            tokens.copy_(state["debias_tokens"])
        trainer.adversary.load_state_dict(state["adversary_params"])
        trainer.prompt_opt.load_state_dict(state["prompt_opt_state"])
        trainer.adv_opt.load_state_dict(state["adv_opt_state"])
    except (ValueError, KeyError, RuntimeError) as e:
        raise ValueError(_MISMATCH.format(path=path, err=e)) from e
    meta = state["meta"]
    trainer.step_count = int(meta["step"])
    trainer.best_ndkl = float(meta["best_ndkl"])
    if meta["has_best"]:
        trainer.best_tokens = meta["best_tokens"].numpy().copy()
    if meta.get("has_best_clip", False):
        trainer.best_clip_params = state["best_clip_params"]


def latest_checkpoint(directory: str) -> Optional[str]:
    """Highest-step checkpoint path under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and name.endswith(".pt"):
            try:
                steps.append((int(name[len("step_"):-len(".pt")]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(os.path.abspath(directory), max(steps)[1])


def export_reference_pt(trainer, path: str, use_best: bool = True) -> str:
    """Export the prompt array in the reference's bare-tensor .pt format
    (loadable by the upstream hub, model/clip.py:75-81)."""
    tokens = (trainer.best_tokens if use_best and trainer.best_tokens is not None
              else trainer.model.debias_tokens)
    save_debias_prompt_pt(tokens, path)
    return path
