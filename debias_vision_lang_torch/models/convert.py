"""Weight bridges into the port's ``CLIP`` state dict: the JAX package's
pytree, and checkpoints in OpenAI CLIP, HuggingFace ``CLIPModel`` and
facebookresearch/SLIP naming (numpy arrays or torch tensors; nothing of
``transformers`` is imported here).

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
from .clip import VIT_KINDS


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
    if cfg.vision.kind not in VIT_KINDS:
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


# per-block key stems: our slot -> the checkpoint's name (torch Linear
# weights are [out, in] and transpose exactly once here)
_OPENAI_BLOCK = {"ln_1": "ln_1", "qkv_w": "attn.in_proj_weight",
                 "qkv_b": "attn.in_proj_bias", "out": "attn.out_proj", "ln_2": "ln_2",
                 "fc1": "mlp.c_fc", "fc2": "mlp.c_proj"}
# timm's ViT block (SLIP's image tower): the same math, other labels
_TIMM_BLOCK = {"ln_1": "norm1", "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
               "out": "attn.proj", "ln_2": "norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _layers(sd: Mapping[str, Any], prefix: str, ln_1: str = "ln_1") -> int:
    rx = re.compile(re.escape(prefix) + r"\.(\d+)\." + re.escape(ln_1) + r"\.weight$")
    idx = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return max(idx) + 1 if idx else 0


def _blocks(sd, src: str, dst: str, out: Dict[str, torch.Tensor],
            names: Mapping[str, str] = _OPENAI_BLOCK) -> None:
    for i in range(_layers(sd, src, names["ln_1"])):
        s, d = f"{src}.{i}", f"{dst}.{i}"

        def t(k):
            return _tensor(sd[f"{s}.{k}"])

        out.update({
            f"{d}.ln_1.scale": t(f"{names['ln_1']}.weight"),
            f"{d}.ln_1.bias": t(f"{names['ln_1']}.bias"),
            f"{d}.attn.wqkv": t(names["qkv_w"]).T.contiguous(),
            f"{d}.attn.bqkv": t(names["qkv_b"]),
            f"{d}.attn.wo": t(f"{names['out']}.weight").T.contiguous(),
            f"{d}.attn.bo": t(f"{names['out']}.bias"),
            f"{d}.ln_2.scale": t(f"{names['ln_2']}.weight"),
            f"{d}.ln_2.bias": t(f"{names['ln_2']}.bias"),
            f"{d}.mlp.w1": t(f"{names['fc1']}.weight").T.contiguous(),
            f"{d}.mlp.b1": t(f"{names['fc1']}.bias"),
            f"{d}.mlp.w2": t(f"{names['fc2']}.weight").T.contiguous(),
            f"{d}.mlp.b2": t(f"{names['fc2']}.bias"),
        })


def _patch_kernel(conv) -> torch.Tensor:
    """A patch conv [width, 3, p, p] -> the [p*p*3, width] matmul kernel, rows
    in (row, col, channel) order."""
    conv = _tensor(conv)
    return conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0]).contiguous()


def _text_and_scale(sd, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The OpenAI-named text tower and logit scale (SLIP keeps CLIP's)."""
    out.update({
        "text.token_embedding": _tensor(sd["token_embedding.weight"]),
        "text.positional_embedding": _tensor(sd["positional_embedding"]),
        "text.ln_final.scale": _tensor(sd["ln_final.weight"]),
        "text.ln_final.bias": _tensor(sd["ln_final.bias"]),
        "text.text_projection": _tensor(sd["text_projection"]),
        "logit_scale": _tensor(sd["logit_scale"]).reshape(()),
    })
    _blocks(sd, "transformer.resblocks", "text.resblocks", out)
    return out


def params_from_openai_state_dict(sd: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP state dict (ViT towers; torch ``nn.Linear`` weights are
    ``[out, in]`` and transpose exactly once here) -> ``CLIP`` state dict.
    The OpenAI-named export of a SLIP tree (the JAX package's
    ``to_openai_state_dict``) carries ``visual.conv1.bias`` and no
    ``visual.ln_pre.*``; both pass through as they are."""
    if "visual.class_embedding" not in sd:
        raise NotImplementedError(
            "only ViT checkpoints convert; ROADMAP.md queue 1 item 4 "
            "(other towers: 4b ResNet)")
    out = {
        "visual.conv1.kernel": _patch_kernel(sd["visual.conv1.weight"]),
        "visual.class_embedding": _tensor(sd["visual.class_embedding"]),
        "visual.positional_embedding": _tensor(sd["visual.positional_embedding"]),
        "visual.ln_post.scale": _tensor(sd["visual.ln_post.weight"]),
        "visual.ln_post.bias": _tensor(sd["visual.ln_post.bias"]),
        "visual.proj": _tensor(sd["visual.proj"]),
    }
    if "visual.conv1.bias" in sd:
        out["visual.conv1.bias"] = _tensor(sd["visual.conv1.bias"])
    if "visual.ln_pre.weight" in sd:
        out["visual.ln_pre.scale"] = _tensor(sd["visual.ln_pre.weight"])
        out["visual.ln_pre.bias"] = _tensor(sd["visual.ln_pre.bias"])
    _blocks(sd, "visual.transformer.resblocks", "visual.resblocks", out)
    return _text_and_scale(sd, out)


# ---------------------------------------------------------------------------
# HuggingFace CLIPModel naming -> OpenAI naming -> ours
# ---------------------------------------------------------------------------


def hf_to_openai_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Rename a HF ``CLIPModel.state_dict()`` into OpenAI CLIP naming (as
    the JAX package's function): HF keeps q / k / v as separate Linears,
    which are packed here; its ``text_projection`` / ``visual_projection``
    are Linears [out, in], OpenAI's are [in, out] matrices.  Keys HF keeps
    beside the weights (``position_ids``) are dropped."""
    sd = {k: _tensor(v) for k, v in dict(sd).items()}
    out: Dict[str, torch.Tensor] = {}

    def copy(dst, src):
        if src in sd:
            out[dst] = sd[src]

    copy("logit_scale", "logit_scale")
    out["text_projection"] = sd["text_projection.weight"].T.contiguous()
    out["visual.proj"] = sd["visual_projection.weight"].T.contiguous()
    copy("token_embedding.weight", "text_model.embeddings.token_embedding.weight")
    copy("positional_embedding", "text_model.embeddings.position_embedding.weight")
    copy("ln_final.weight", "text_model.final_layer_norm.weight")
    copy("ln_final.bias", "text_model.final_layer_norm.bias")
    copy("visual.class_embedding", "vision_model.embeddings.class_embedding")
    copy("visual.positional_embedding",
         "vision_model.embeddings.position_embedding.weight")
    copy("visual.conv1.weight", "vision_model.embeddings.patch_embedding.weight")
    # HF misspells the pre-LN as "pre_layrnorm"
    for ours, hf in (("visual.ln_pre", "vision_model.pre_layrnorm"),
                     ("visual.ln_post", "vision_model.post_layernorm")):
        copy(f"{ours}.weight", f"{hf}.weight")
        copy(f"{ours}.bias", f"{hf}.bias")
    for tower, hf_tower in (("transformer", "text_model"),
                            ("visual.transformer", "vision_model")):
        for i in range(_layers(sd, f"{hf_tower}.encoder.layers", "layer_norm1")):
            h, o = f"{hf_tower}.encoder.layers.{i}", f"{tower}.resblocks.{i}"
            for ln in ("1", "2"):
                out[f"{o}.ln_{ln}.weight"] = sd[f"{h}.layer_norm{ln}.weight"]
                out[f"{o}.ln_{ln}.bias"] = sd[f"{h}.layer_norm{ln}.bias"]
            for part in ("weight", "bias"):
                out[f"{o}.attn.in_proj_{part}"] = torch.cat(
                    [sd[f"{h}.self_attn.{p}_proj.{part}"] for p in "qkv"], dim=0)
                out[f"{o}.attn.out_proj.{part}"] = sd[f"{h}.self_attn.out_proj.{part}"]
                out[f"{o}.mlp.c_fc.{part}"] = sd[f"{h}.mlp.fc1.{part}"]
                out[f"{o}.mlp.c_proj.{part}"] = sd[f"{h}.mlp.fc2.{part}"]
    return out


def from_hf_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HF ``CLIPModel`` state dict -> ``CLIP`` state dict."""
    return params_from_openai_state_dict(hf_to_openai_state_dict(sd))


def from_hf_model(hf_model) -> Dict[str, torch.Tensor]:
    """A HF ``CLIPModel`` (any object with ``state_dict()``) -> ``CLIP``
    state dict; nothing of ``transformers`` is imported here."""
    return from_hf_state_dict(hf_model.state_dict())


# ---------------------------------------------------------------------------
# facebookresearch/SLIP checkpoint naming -> ours
# ---------------------------------------------------------------------------


def strip_prefix(sd: Mapping[str, Any], prefix: str = "module.") -> Dict[str, Any]:
    """Drop a DDP / wrapper prefix from every key that carries it."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}


def _timm_patch_embed(sd, key_prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """timm's patch conv [D, 3, p, p] (+ bias) -> ``visual.conv1``."""
    out["visual.conv1.kernel"] = _patch_kernel(sd[f"{key_prefix}.weight"])
    if f"{key_prefix}.bias" in sd:
        out["visual.conv1.bias"] = _tensor(sd[f"{key_prefix}.bias"])


def _timm_blocks(sd, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """timm ViT blocks (norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 /
    mlp.fc2) -> ``visual.resblocks``."""
    _blocks(sd, prefix, "visual.resblocks", out, _TIMM_BLOCK)


def from_slip_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """facebookresearch/SLIP checkpoint -> ``CLIP`` state dict of a
    ``slip_vit`` tower (the JAX package's ``from_slip_state_dict``).

    Takes a raw state dict or the published ``{"state_dict": ...}`` with
    DDP ``module.`` prefixes.  Vision (a timm ViT): visual.cls_token ->
    class_embedding, visual.pos_embed -> positional_embedding,
    visual.patch_embed.proj -> conv1 with its bias, visual.blocks.N ->
    resblocks, visual.norm -> ln_post, image_projection -> proj; no ln_pre.
    Text: CLIP's naming, as ``params_from_openai_state_dict``.  The SSL
    heads' tensors (image_mlp, text_mlp, predictor) are ignored."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    sd = strip_prefix(dict(sd))
    out = {
        "visual.class_embedding": _tensor(sd["visual.cls_token"]).reshape(-1),
        "visual.positional_embedding": _tensor(sd["visual.pos_embed"])[0],
        "visual.ln_post.scale": _tensor(sd["visual.norm.weight"]),
        "visual.ln_post.bias": _tensor(sd["visual.norm.bias"]),
        "visual.proj": _tensor(sd["image_projection"]),
    }
    _timm_patch_embed(sd, "visual.patch_embed.proj", out)
    _timm_blocks(sd, "visual.blocks", out)
    return _text_and_scale(sd, out)


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
