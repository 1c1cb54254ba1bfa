"""Weight bridges into the port's ``CLIP`` state dict.

The port keeps the JAX package's parameter layout (``models/layers.py``):
linear weights ``[in, out]``, ``wqkv`` ``[D, 3D]`` = q | k | v with head
``h`` at columns ``h*64:(h+1)*64`` of each third, ``conv1.kernel``
``[patch*patch*3, width]`` in (row, col, channel) order.  Only the stacked
``resblocks`` (leading layer axis in JAX) are split into per-layer modules.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..core.config import CLIPConfig


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            _flatten(v, name + ".", out)
        else:
            out[name] = v


def params_from_jax(tree: Mapping[str, Any], cfg: CLIPConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX param pytree (nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) -> ``CLIP(cfg)`` state dict."""
    if cfg.vision.kind != "vit":
        raise NotImplementedError(f"vision kind {cfg.vision.kind!r}")
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        tower, sep, rest = name.partition(".resblocks.")
        if not sep:
            out[name] = _tensor(arr)
            continue
        stacked = _tensor(arr)
        for i in range(stacked.shape[0]):
            out[f"{tower}.resblocks.{i}.{rest}"] = stacked[i].clone()
    return out


def to_jax_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``CLIP`` state dict -> the JAX package's param pytree (nested dicts of
    float32 numpy arrays, resblocks stacked on a leading layer axis)."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        m = re.match(r"(\w+)\.resblocks\.(\d+)\.(.+)$", name)
        if m:
            stacks.setdefault(f"{m.group(1)}.resblocks.{m.group(3)}", {})[
                int(m.group(2))] = arr
        else:
            _insert(tree, name, arr)
    for name, layers in stacks.items():
        _insert(tree, name, np.stack([layers[i] for i in range(len(layers))]))
    return tree


def _insert(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def _layers(sd: Mapping[str, Any], prefix: str) -> int:
    rx = re.compile(re.escape(prefix) + r"\.(\d+)\.ln_1\.weight$")
    idx = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return max(idx) + 1 if idx else 0


def _blocks_from_openai(sd, src: str, dst: str, out: Dict[str, torch.Tensor]):
    for i in range(_layers(sd, src)):
        s, d = f"{src}.{i}", f"{dst}.{i}"

        def t(k):
            return _tensor(sd[f"{s}.{k}"])

        out.update({
            f"{d}.ln_1.scale": t("ln_1.weight"), f"{d}.ln_1.bias": t("ln_1.bias"),
            f"{d}.attn.wqkv": t("attn.in_proj_weight").T.contiguous(),
            f"{d}.attn.bqkv": t("attn.in_proj_bias"),
            f"{d}.attn.wo": t("attn.out_proj.weight").T.contiguous(),
            f"{d}.attn.bo": t("attn.out_proj.bias"),
            f"{d}.ln_2.scale": t("ln_2.weight"), f"{d}.ln_2.bias": t("ln_2.bias"),
            f"{d}.mlp.w1": t("mlp.c_fc.weight").T.contiguous(),
            f"{d}.mlp.b1": t("mlp.c_fc.bias"),
            f"{d}.mlp.w2": t("mlp.c_proj.weight").T.contiguous(),
            f"{d}.mlp.b2": t("mlp.c_proj.bias"),
        })


def params_from_openai_state_dict(sd: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP state dict (ViT towers; torch ``nn.Linear`` weights are
    ``[out, in]`` and transpose exactly once here) -> ``CLIP`` state dict."""
    if "visual.class_embedding" not in sd:
        raise NotImplementedError(
            "only ViT checkpoints convert; ROADMAP.md queue 1 item 4 "
            "(other towers)")
    conv = _tensor(sd["visual.conv1.weight"])  # [width, 3, p, p]
    width = conv.shape[0]
    out = {
        "visual.conv1.kernel": conv.permute(2, 3, 1, 0).reshape(-1, width).contiguous(),
        "visual.class_embedding": _tensor(sd["visual.class_embedding"]),
        "visual.positional_embedding": _tensor(sd["visual.positional_embedding"]),
        "visual.ln_pre.scale": _tensor(sd["visual.ln_pre.weight"]),
        "visual.ln_pre.bias": _tensor(sd["visual.ln_pre.bias"]),
        "visual.ln_post.scale": _tensor(sd["visual.ln_post.weight"]),
        "visual.ln_post.bias": _tensor(sd["visual.ln_post.bias"]),
        "visual.proj": _tensor(sd["visual.proj"]),
        "text.token_embedding": _tensor(sd["token_embedding.weight"]),
        "text.positional_embedding": _tensor(sd["positional_embedding"]),
        "text.ln_final.scale": _tensor(sd["ln_final.weight"]),
        "text.ln_final.bias": _tensor(sd["ln_final.bias"]),
        "text.text_projection": _tensor(sd["text_projection"]),
        "logit_scale": _tensor(sd["logit_scale"]).reshape(()),
    }
    _blocks_from_openai(sd, "visual.transformer.resblocks", "visual.resblocks", out)
    _blocks_from_openai(sd, "transformer.resblocks", "text.resblocks", out)
    return out


def adversary_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX adversary params ``{"layers": [{"kernel", "bias"}, ...]}`` ->
    ``Adversary`` state dict (the same [in, out] layout, no transpose)."""
    return {f"layers.{i}.{k}": _tensor(layer[k])
            for i, layer in enumerate(tree["layers"]) for k in ("kernel", "bias")}


def save_debias_prompt_pt(prompt_embeddings, path: str) -> None:
    """Export prompt embeddings in the reference's .pt format: a bare,
    contiguous float32 CPU tensor written by ``torch.save`` (drop-in for the
    reference hub loader, model/clip.py:75-81)."""
    if isinstance(prompt_embeddings, torch.Tensor):
        arr = prompt_embeddings.detach().float().cpu().numpy()
    else:
        arr = np.asarray(prompt_embeddings, np.float32)
    torch.save(torch.from_numpy(np.ascontiguousarray(arr, np.float32).copy()), path)


def load_debias_prompt_pt(path: str) -> torch.Tensor:
    """Load the hub checkpoint format: a bare [P, width] tensor saved with
    ``torch.save`` (reference: model/clip.py:75-76), as float32 on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True).float()
