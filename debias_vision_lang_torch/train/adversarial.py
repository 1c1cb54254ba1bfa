"""Adversarial prompt-array debias training on one device.

Counterpart of ``debias_vision_lang_tpu/train/adversarial.py``: the
adversary reads the scaled cosine similarities between each image and the
sensitive-prompt set and predicts the protected attribute (sigmoid BCE, or
softmax CE for multiclass attributes); the prompt array is updated to
MAXIMIZE that loss, jointly with a CLIP contrastive loss on an
image-caption batch (reference README.md:148-157).  Optionally the top
resblocks and the projections train too, under the freezing policy
(``models/debias.py::trainable_mask``).

What differs from the JAX package, and why:
  * The step functions take the modules (``DebiasCLIP``, ``Adversary``) and
    their optimizers and update them in place, where the JAX steps take
    and return pytrees: PyTorch runs eagerly and needs no donated buffers.
  * The freezing policy is applied twice: as ``requires_grad`` on the CLIP
    parameters (the reference's own mechanism, so autograd skips every
    frozen tensor) and as the 0/1 gradient multipliers of the JAX steps.
    The joint optimizer holds the prompt array and the parameters whose
    multiplier is 1; the JAX one also holds the masked ones, whose zero
    gradients leave both their Adam moments and their values at rest, so
    the updates are the same.
  * ``make_optimizer`` builds optax's chain from ``torch.optim.Adam``: the
    schedule is evaluated at the update count (0 for the first update, as
    optax's ``scale_by_schedule``), and global-norm clipping is optax's
    rule (scale by max_norm / norm only when norm >= max_norm), not
    ``clip_grad_norm_``'s.
  * ``embed_dtype="int8"`` embeds through ``ops/quant.QuantizedCLIP``, which
    quantizes once when built; the embed step rebuilds it whenever an
    image-path parameter changed since (the JAX step re-quantizes inside
    every call), so it never embeds with stale int8 weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import AdversaryConfig, CLIPConfig, DebiasConfig, TrainConfig
from ..models.adversary import Adversary
from ..models.clip import VIT_KINDS
from ..models.debias import DebiasCLIP, apply_grad_mask
from ..ops.quant import DTYPES

ROADMAP_DIST = "ROADMAP.md queue 1 item 5 (distribution)"


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy, mean-reduced."""
    labels = labels.to(logits.dtype)
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def adversary_loss(logits: torch.Tensor, labels: torch.Tensor,
                   n_output: int) -> torch.Tensor:
    """Binary (sigmoid BCE, the reference's ADV_N_OUTPUT=1) or multiclass
    (softmax CE over n_output classes)."""
    if n_output == 1:
        return sigmoid_bce(logits[:, 0], labels)
    return F.cross_entropy(logits, labels.long())


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def clip_contrastive_loss(image_embs: torch.Tensor, text_embs: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over an aligned image-caption batch."""
    logits = logit_scale.exp() * _normalize(image_embs) @ _normalize(text_embs).T
    targets = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, targets)
                  + F.cross_entropy(logits.T, targets))


def similarity_scores(image_embs: torch.Tensor, prompt_text_embs: torch.Tensor,
                      logit_scale: torch.Tensor) -> torch.Tensor:
    """Adversary input: scaled cosine similarities [B, n_prompts]."""
    return (logit_scale.exp() * _normalize(image_embs)
            @ _normalize(prompt_text_embs).T)


# ---------------------------------------------------------------------------
# Optimizer: optax's adam chain on torch.optim.Adam
# ---------------------------------------------------------------------------


def lr_schedule(peak_lr: float, train_cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at update count n (0 = the first update), as
    optax's constant / cosine_decay / warmup_cosine_decay schedules give it;
    raises on the configurations ``make_optimizer`` rejects in JAX."""
    sched = train_cfg.lr_schedule
    if sched == "constant":
        return lambda count: peak_lr
    if sched not in ("cosine", "warmup_cosine"):
        raise ValueError(f"unknown lr_schedule {sched!r} — one of constant/cosine/"
                         "warmup_cosine")
    decay = train_cfg.decay_steps
    if not decay:
        raise ValueError(
            f"lr_schedule={sched!r} needs TrainConfig.decay_steps (total "
            "optimizer update steps); run_training derives it, direct "
            "AdversarialTrainer.create callers must set it")
    warmup = train_cfg.warmup_steps
    if sched == "cosine" and warmup:
        raise ValueError("warmup_steps is set but lr_schedule='cosine' has no "
                         "warmup phase — use lr_schedule='warmup_cosine'")
    if sched == "warmup_cosine" and warmup >= decay:
        raise ValueError(f"warmup_steps={warmup} must be < decay_steps={decay}")

    def cosine(count: float, steps: int) -> float:
        count = min(count, steps)
        return peak_lr * (0.5 * (1 + math.cos(math.pi * count / steps)))

    if sched == "cosine":
        return lambda count: cosine(count, decay)

    def warmup_cosine(count: int) -> float:
        if count < warmup:  # linear from 0 to the peak
            frac = 1 - count / warmup
            return (0.0 - peak_lr) * frac + peak_lr
        return cosine(count - warmup, decay - warmup)

    return warmup_cosine


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: every gradient times max_norm / norm when
    the global norm is >= max_norm, unchanged below it."""
    g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm) for g in grads]


class Optimizer:
    """One optimizer of the loop: optional global-norm clipping, then
    ``torch.optim.Adam`` (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) at
    the scheduled learning rate of this update."""

    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Callable[[int], float],
                 grad_clip_norm: Optional[float] = None):
        self.params = list(params)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(peak_lr: float, train_cfg: TrainConfig,
                   params: Sequence[torch.Tensor]) -> Optimizer:
    """Adam over ``params`` at ``peak_lr`` under ``train_cfg.lr_schedule``
    (constant, cosine or warmup_cosine over ``decay_steps`` updates), after
    global-norm clipping when ``grad_clip_norm`` is set."""
    return Optimizer(params, lr_schedule(peak_lr, train_cfg), train_cfg.grad_clip_norm)


def adversary_schedule_cfg(train_cfg: TrainConfig) -> TrainConfig:
    """The adversary takes ``cadence`` updates per trainer step: its schedule
    horizon is scaled so both schedules end at the same trainer step."""
    cadence = train_cfg.adversary_steps_per_prompt_step
    if train_cfg.lr_schedule == "constant" or cadence <= 1:
        return train_cfg
    return dataclasses.replace(
        train_cfg, warmup_steps=train_cfg.warmup_steps * cadence,
        decay_steps=train_cfg.decay_steps * cadence if train_cfg.decay_steps else None)


def joint_params(model: DebiasCLIP, grad_mask: Dict[str, float]
                 ) -> Tuple[List[str], List[torch.Tensor]]:
    """The joint optimizer's tensors: the prompt array, then every CLIP
    parameter whose multiplier is 1, in ``named_parameters`` order."""
    named = [(n, p) for n, p in model.clip.named_parameters() if grad_mask[n]]
    return [n for n, _ in named], [model.debias_tokens] + [p for _, p in named]


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainStepFns:
    """Step functions bound to the static configs; each takes the modules
    and updates them in place."""

    embed_images: Callable  # (model, images [B,H,W,3]) -> [B, D] f32, no grad
    adversary_step: Callable  # (adversary, adv_opt, scores, labels) -> loss
    prompt_step: Callable  # (model, prompt_opt, adversary, image_embs, labels,
    #                         caption_image_embs, caption_tokens) -> metrics
    prompt_step_with_layers: Callable  # (model, joint_opt, grad_mask, adversary,
    #                                     images, labels, caption_images, tokens)
    prompt_step_text_layers: Callable  # (..., image_embs, labels, cap_embs, tokens)
    prompt_step_approx_scores: Callable  # (..., image_embs, labels, cap_images, tokens)
    eval_scores: Callable  # (model, image_embs) -> scores, no grad


def _version_key(module: torch.nn.Module) -> tuple:
    """Changes whenever a parameter of ``module`` is written (in-place
    updates bump a tensor's version counter) or replaced."""
    return tuple((p.data_ptr(), p._version) for p in module.parameters())


def build_train_steps(
    clip_cfg: CLIPConfig,
    debias_cfg: DebiasConfig,
    adv_cfg: AdversaryConfig,
    train_cfg: TrainConfig,
    sensitive_tokens: np.ndarray,
    use_pallas: Optional[bool] = None,
) -> TrainStepFns:
    """The adversarial steps.  ``sensitive_tokens``: the tokenized sensitive
    prompts [P_s, 77], fixed during training.  ``AdversarialTrainer.create``
    builds the optimizers over the parameters that train."""
    del debias_cfg  # read from the model at each call
    sens_np = np.asarray(sensitive_tokens, np.int64)
    sens_on: Dict[torch.device, torch.Tensor] = {}

    def sens(model) -> torch.Tensor:
        dev = model.debias_tokens.device
        if dev not in sens_on:
            sens_on[dev] = torch.as_tensor(sens_np, device=dev)
        return sens_on[dev]

    def _dtype(name: str, what: str) -> torch.dtype:
        if name not in DTYPES:
            raise ValueError(f"{what}={name!r}: expected one of {sorted(DTYPES)}"
                             + (" or 'int8'" if what == "embed_dtype" else ""))
        return DTYPES[name]

    train_dtype = _dtype(train_cfg.train_dtype, "train_dtype")
    remat_img = train_cfg.remat_image_tower

    def encode_sensitive(model: DebiasCLIP) -> torch.Tensor:
        # mixed precision: the tower runs at train_dtype, the losses, the
        # adversary and the optimizer see float32
        return model.encode_text(sens(model), dtype=train_dtype,
                                 use_pallas=use_pallas).float()

    def encode_captions(model: DebiasCLIP, caption_tokens) -> torch.Tensor:
        return model.encode_text(caption_tokens, dtype=train_dtype,
                                 use_pallas=use_pallas).float()

    embed_dtype_s = train_cfg.embed_dtype
    if embed_dtype_s == "int8":
        from ..ops.quant import QuantizedCLIP

        if clip_cfg.vision.kind not in VIT_KINDS:
            raise NotImplementedError("embed_dtype='int8' supports ViT towers only")
        quantized: dict = {}

        @torch.no_grad()
        def embed_images(model: DebiasCLIP, images: torch.Tensor) -> torch.Tensor:
            """Frozen int8 image tower; re-quantized whenever an image-path
            parameter changed since the last call."""
            key = (id(model), _version_key(model.clip.visual))
            if quantized.get("key") != key:
                quantized["model"] = QuantizedCLIP(model)
                quantized["key"] = key
            return quantized["model"].encode_image(images).float()
    else:
        embed_dtype = _dtype(embed_dtype_s, "embed_dtype")

        @torch.no_grad()
        def embed_images(model: DebiasCLIP, images: torch.Tensor) -> torch.Tensor:
            """Frozen image tower at embed_dtype (bfloat16 runs the fused
            blocks), float32 out."""
            return model.encode_image(images, dtype=embed_dtype,
                                      use_pallas=use_pallas).float()

    @torch.no_grad()
    def eval_scores(model: DebiasCLIP, image_embs: torch.Tensor) -> torch.Tensor:
        return similarity_scores(image_embs, encode_sensitive(model),
                                 model.clip.logit_scale)

    def adversary_step(adversary: Adversary, adv_opt: Optimizer,
                       scores: torch.Tensor, attr_labels: torch.Tensor):
        """The adversary minimizes the attribute-prediction loss on scores
        computed once per outer step (the prompt array is fixed there)."""
        with torch.enable_grad():
            loss = adversary_loss(adversary.apply_logits(scores), attr_labels,
                                  adv_cfg.n_output)
            grads = torch.autograd.grad(loss, adv_opt.params)
        adv_opt.step(grads)
        return loss.detach()

    def _prompt_losses(model, adversary, image_embs, attr_labels,
                       caption_image_embs, caption_tokens):
        txt = encode_sensitive(model)
        scores = similarity_scores(image_embs, txt, model.clip.logit_scale)
        logits = adversary.apply_logits(scores, detach=True)
        adv_loss = adversary_loss(logits, attr_labels, adv_cfg.n_output)
        cap_txt = encode_captions(model, caption_tokens)
        con_loss = clip_contrastive_loss(caption_image_embs, cap_txt,
                                         model.clip.logit_scale)
        total = (train_cfg.contrastive_weight * con_loss
                 - train_cfg.adversarial_weight * adv_loss)
        return total, adv_loss, con_loss

    def _metrics(total, adv_loss, con_loss) -> Dict[str, torch.Tensor]:
        return {"loss": total.detach(), "adv_loss": adv_loss.detach(),
                "contrastive_loss": con_loss.detach()}

    def prompt_step(model, prompt_opt, adversary, image_embs, attr_labels,
                    caption_image_embs, caption_tokens):
        """The prompt array maximizes the adversary's loss while the
        contrastive term keeps CLIP aligned; CLIP stays frozen."""
        with torch.enable_grad():
            losses = _prompt_losses(model, adversary, image_embs, attr_labels,
                                    caption_image_embs, caption_tokens)
            grads = torch.autograd.grad(losses[0], [model.debias_tokens])
        prompt_opt.step(grads)
        return _metrics(*losses)

    def _joint_update(loss_fn, model, grad_mask, joint_opt):
        """Gradients over (prompt array, trainable CLIP parameters), the
        freezing-policy multipliers, one optimizer update."""
        names, params = joint_params(model, grad_mask)
        with torch.enable_grad():
            losses = loss_fn()
            grads = torch.autograd.grad(losses[0], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        masked = apply_grad_mask(dict(zip(names, grads[1:])), grad_mask)
        joint_opt.step([grads[0]] + [masked[n] for n in names])
        return _metrics(*losses)

    def prompt_step_text_layers(model, joint_opt, grad_mask, adversary,
                                image_embs, attr_labels, caption_image_embs,
                                caption_tokens):
        """Text-side layer training: the image path is frozen, so both image
        batches come in embedded (no differentiable image pass)."""
        return _joint_update(
            lambda: _prompt_losses(model, adversary, image_embs.detach(),
                                   attr_labels, caption_image_embs.detach(),
                                   caption_tokens),
            model, grad_mask, joint_opt)

    def _embed_diff(model, images) -> torch.Tensor:
        return model.encode_image(images, use_pallas=use_pallas,
                                  remat=remat_img).float()

    def prompt_step_with_layers(model, joint_opt, grad_mask, adversary, images,
                                attr_labels, caption_images, caption_tokens):
        """Image-path params train: both image batches embed inside the
        loss, so unfrozen image layers receive gradients."""
        return _joint_update(
            lambda: _prompt_losses(model, adversary, _embed_diff(model, images),
                                   attr_labels, _embed_diff(model, caption_images),
                                   caption_tokens),
            model, grad_mask, joint_opt)

    def prompt_step_approx_scores(model, joint_opt, grad_mask, adversary,
                                  image_embs, attr_labels, caption_images,
                                  caption_tokens):
        """Opt-in approximation (train_cfg.approx_frozen_scores): the score
        term uses the precomputed attribute-batch embeddings; only the
        caption batch embeds inside the loss.  Not gradient-equivalent."""
        return _joint_update(
            lambda: _prompt_losses(model, adversary, image_embs.detach(),
                                   attr_labels, _embed_diff(model, caption_images),
                                   caption_tokens),
            model, grad_mask, joint_opt)

    return TrainStepFns(
        embed_images=embed_images,
        adversary_step=adversary_step,
        prompt_step=prompt_step,
        prompt_step_with_layers=prompt_step_with_layers,
        prompt_step_text_layers=prompt_step_text_layers,
        prompt_step_approx_scores=prompt_step_approx_scores,
        eval_scores=eval_scores,
    )


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdversarialTrainer:
    """The alternating loop with best-NDKL selection:

        trainer = AdversarialTrainer.create(model, adversary, train_cfg,
                                            sensitive_tokens)
        for batch in loader:
            metrics = trainer.step(images, labels, cap_images, cap_tokens)
        trainer.maybe_update_best(ndkl_value)
    """

    model: DebiasCLIP
    adversary: Adversary
    fns: TrainStepFns
    prompt_opt: Optimizer
    adv_opt: Optimizer
    train_cfg: TrainConfig
    step_count: int = 0
    best_ndkl: float = float("inf")
    best_tokens: Optional[np.ndarray] = None
    # layer-training mode: the CLIP weights at the best eval (host copies),
    # so the best tokens are kept with the weights they were evaluated with
    best_clip_params: Optional[Dict[str, torch.Tensor]] = None
    # the freezing-policy multipliers, set when CLIP layers / projections train
    grad_mask: Optional[Dict[str, float]] = None
    # True when a trainable parameter feeds the image path
    trains_image: bool = False

    @staticmethod
    def create(model: DebiasCLIP, adversary: Adversary, train_cfg: TrainConfig,
               sensitive_tokens: np.ndarray, use_pallas: Optional[bool] = None,
               mesh=None) -> "AdversarialTrainer":
        if mesh is not None:
            raise NotImplementedError(
                f"mesh: data-parallel training is not ported yet: {ROADMAP_DIST}")
        fns = build_train_steps(model.clip_cfg, model.debias_cfg, adversary.cfg,
                                train_cfg, sensitive_tokens, use_pallas=use_pallas)
        dcfg = model.debias_cfg
        trains_layers = (dcfg.n_train_text_layers > 0 or dcfg.n_train_vid_layers > 0
                         or not dcfg.freeze_proj)
        # visual.proj and logit_scale belong to the reference's "proj" group
        trains_image = dcfg.n_train_vid_layers > 0 or not dcfg.freeze_proj
        grad_mask = model.trainable_mask() if trains_layers else None
        for name, p in model.clip.named_parameters():
            p.requires_grad_(bool(grad_mask is not None and grad_mask[name]))
        model.debias_tokens.requires_grad_(True)
        adversary.to(model.debias_tokens.device)
        prompt_params = (joint_params(model, grad_mask)[1] if trains_layers
                         else [model.debias_tokens])
        return AdversarialTrainer(
            model=model, adversary=adversary, fns=fns,
            prompt_opt=make_optimizer(train_cfg.prompt_lr, train_cfg, prompt_params),
            adv_opt=make_optimizer(train_cfg.adversary_lr, adversary_schedule_cfg(train_cfg),
                                   list(adversary.parameters())),
            train_cfg=train_cfg, grad_mask=grad_mask, trains_image=trains_image)

    @property
    def device(self) -> torch.device:
        return self.model.debias_tokens.device

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(self.device, dtype=dtype)

    def step(self, images, attr_labels, caption_images, caption_tokens) -> Dict:
        """One outer step: ``cadence`` adversary updates, then one prompt
        update.  Images are preprocessed [B, H, W, 3] (or the uint8 patch
        staging)."""
        images = self._to_device(images)
        caption_images = self._to_device(caption_images)
        image_embs = self.fns.embed_images(self.model, images)
        # only the frozen-image branches consume a precomputed caption embed
        needs_cap_embs = self.grad_mask is None or not self.trains_image
        cap_embs = (self.fns.embed_images(self.model, caption_images)
                    if needs_cap_embs else None)
        return self._finish_step(image_embs, cap_embs, attr_labels, images,
                                 caption_images, caption_tokens)

    def step_from_embeddings(self, image_embs, attr_labels, caption_image_embs,
                             caption_tokens) -> Dict:
        """One outer step from precomputed frozen-tower embeddings (the
        training loop's embedding cache); the same update arithmetic as
        ``step``.  Frozen-image configs only."""
        if self.trains_image:
            raise ValueError(
                "step_from_embeddings requires a frozen image path "
                "(n_train_vid_layers=0 and freeze_proj=True) — this config "
                "trains image-path params, so cached embeddings would be "
                "stale; use step(images, ...) instead")
        return self._finish_step(
            self._to_device(image_embs, torch.float32),
            self._to_device(caption_image_embs, torch.float32),
            attr_labels, None, None, caption_tokens)

    def _finish_step(self, image_embs, cap_embs, attr_labels, images,
                     caption_images, caption_tokens) -> Dict:
        labels = self._to_device(np.asarray(attr_labels, np.float32))
        cadence = self.train_cfg.adversary_steps_per_prompt_step
        if cadence < 0:
            raise ValueError(
                f"adversary_steps_per_prompt_step must be >= 0 (0 freezes "
                f"the adversary), got {cadence}")
        adv_loss = None
        if cadence > 0:
            scores = self.fns.eval_scores(self.model, image_embs)
            for _ in range(cadence):
                adv_loss = self.fns.adversary_step(self.adversary, self.adv_opt,
                                                   scores, labels)
        cap_tok = self._to_device(caption_tokens, torch.long)
        fns, mask = self.fns, self.grad_mask
        if mask is not None and not self.trains_image:
            metrics = fns.prompt_step_text_layers(
                self.model, self.prompt_opt, mask, self.adversary, image_embs,
                labels, cap_embs, cap_tok)
        elif mask is not None and self.train_cfg.approx_frozen_scores:
            metrics = fns.prompt_step_approx_scores(
                self.model, self.prompt_opt, mask, self.adversary, image_embs,
                labels, caption_images, cap_tok)
        elif mask is not None:
            metrics = fns.prompt_step_with_layers(
                self.model, self.prompt_opt, mask, self.adversary, images,
                labels, caption_images, cap_tok)
        else:
            metrics = fns.prompt_step(
                self.model, self.prompt_opt, self.adversary, image_embs, labels,
                cap_embs, cap_tok)
        self.step_count += 1
        metrics = {k: float(v) for k, v in metrics.items()}
        # cadence 0 = frozen adversary: no BCE measured this step
        metrics["adversary_bce"] = float(adv_loss) if adv_loss is not None else float("nan")
        metrics["step"] = self.step_count
        return metrics

    def maybe_update_best(self, ndkl_value: float) -> bool:
        """Best-NDKL selection; in layer-training mode the CLIP weights are
        kept with the tokens.  True when this eval is the new best."""
        if ndkl_value < self.best_ndkl:
            self.best_ndkl = ndkl_value
            self.best_tokens = self.model.debias_tokens.detach().float().cpu().numpy().copy()
            if self.grad_mask is not None:
                self.best_clip_params = {k: v.detach().cpu().clone()
                                         for k, v in self.model.clip.state_dict().items()}
            return True
        return False
