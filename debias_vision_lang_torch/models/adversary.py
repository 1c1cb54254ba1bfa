"""Adversary MLP: predicts the protected attribute from image-text similarity
scores (reference: debias_clip/model/model.py:337-361).

Counterpart of ``debias_vision_lang_tpu/models/adversary.py``: n_input ->
hidden -> hidden -> hidden -> n_output with ReLU between layers; ``apply``
adds the reference's output sigmoid, ``apply_logits`` leaves it off for the
numerically stable BCE-with-logits loss.  Layers keep the JAX layout
(``kernel`` [in, out], ``bias`` [out]); the init is torch's own
``nn.Linear`` one, uniform(+-1/sqrt(fan_in)) for weight and bias (the
reference's), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..core.config import AdversaryConfig, Dotdict, adversary_config_from_dotdict


class DenseLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))


def apply_logits(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 x: torch.Tensor) -> torch.Tensor:
    """MLP forward without the output sigmoid over (kernel, bias) pairs."""
    h = x
    for i, (kernel, bias) in enumerate(layers):
        h = h @ kernel.to(h.dtype) + bias.to(h.dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


class Adversary(nn.Module):
    def __init__(self, cfg: AdversaryConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        sizes = [cfg.n_input, cfg.hidden_size, cfg.hidden_size, cfg.hidden_size,
                 cfg.n_output]
        self.layers = nn.ModuleList(DenseLayer(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for layer in self.layers:
                bound = layer.kernel.shape[0] ** -0.5
                for p in (layer.kernel, layer.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                          generator=generator))

    def params(self, detach: bool = False):
        """The (kernel, bias) pairs; ``detach`` stops their gradient."""
        return [(l.kernel.detach(), l.bias.detach()) if detach else (l.kernel, l.bias)
                for l in self.layers]

    def apply_logits(self, x: torch.Tensor, detach: bool = False) -> torch.Tensor:
        return apply_logits(self.params(detach), x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Reference forward: sigmoid(MLP(x)) (model/model.py:360-361)."""
        return torch.sigmoid(self.apply_logits(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    @staticmethod
    def from_cfg(cfg: Union[dict, Dotdict],
                 generator: Optional[torch.Generator] = None) -> "Adversary":
        """Reference constructor surface: ADV_N_INPUT / ADV_N_OUTPUT /
        ADV_HIDDEN_SIZE (ADV_DEVICE ignored); the init draws from ``SEED``
        unless a generator is given."""
        acfg = adversary_config_from_dotdict(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(int(Dotdict(cfg).SEED or 0))
        return Adversary(acfg, generator)
