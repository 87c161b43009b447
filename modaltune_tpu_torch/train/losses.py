"""KD loss, the frozen text projector, and the baselines' losses.

Counterpart of ``modaltune_tpu/train/losses.py``: the task-conditioned
embeddings are L2-normalised and distilled (KL over the embedding axis,
temperature T, summed per slide, x T^2 x 10) against L2-normalised
projections of the per-case CONCH text embeddings for prompt rows
[0 general, 1 diagnosis, 3 survival]. The text projector is frozen
random; ``utils.convert.projector_from_jax`` carries the JAX package's
parameters across so that both packages distil towards the same targets. The supervised baselines
train on ``cross_entropy_loss`` (classifier heads) or ``survival_nll_loss``
(the cumprod-hazard survival head).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense

TEXT_PROMPT_ROWS = (0, 1, 3)


class TextProjector(nn.Module):
    """conv1x1 512->256, LayerNorm over channels, ReLU, conv1x1 256->256;
    a 1x1 convolution on a (B, C, 1, 1) tensor is a dense layer over the
    channel axis. The LayerNorm's epsilon is flax's default, 1e-6."""

    def __init__(self, in_dim: int = 512, out_dim: int = 256):
        super().__init__()
        self.conv1 = Dense(in_dim, out_dim)
        self.ln = nn.LayerNorm(out_dim, eps=1e-6)
        self.conv2 = Dense(out_dim, out_dim)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.ln(self.conv1(text))))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def kd_kl_per_slide(logits: torch.Tensor, text_proj: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Per-slide summed KL, unscaled: (B, T, D) -> (B,) fp32."""
    t = temperature
    logp = F.log_softmax(l2_normalize(logits).float() / t, dim=-1)
    q = F.softmax(text_proj.float() / t, dim=-1)
    return torch.sum(q * (torch.log(q) - logp), dim=(-2, -1))


def kd_loss(logits: torch.Tensor, text_proj: torch.Tensor,
            temperature: float = 1.0, scale: float = 10.0) -> torch.Tensor:
    """PromptKD KL loss: the mean over slides of the per-slide summed KL,
    x T^2 x ``scale``. ``text_proj`` holds the projected, normalised
    targets already cut to the task rows."""
    per_slide = kd_kl_per_slide(logits, text_proj, temperature)
    return per_slide.mean() * (temperature ** 2) * scale


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, the log-softmax in fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


def survival_nll_loss(hazards: torch.Tensor, s: torch.Tensor,
                      y_bins: torch.Tensor, events: torch.Tensor,
                      alpha: float = 0.4, eps: float = 1e-7) -> torch.Tensor:
    """Discrete-time censored survival NLL over duration bins for the
    ``hazards = sigmoid(logits)``, ``S = cumprod(1 - hazards)`` head
    (Zadeh & Schmid 2020): ``events == 1`` means the event was observed
    (uncensored); the uncensored term is weighted up by ``alpha``."""
    y = y_bins[:, None].long()
    c = 1.0 - events.float()            # censorship indicator
    s_pad = torch.cat([torch.ones_like(s[:, :1]), s], dim=1)
    s_prev = s_pad.gather(1, y)[:, 0]
    s_cur = s_pad.gather(1, y + 1)[:, 0]
    h_cur = hazards.gather(1, y)[:, 0]
    uncensored = -(1.0 - c) * (torch.log(s_prev.clamp_min(eps))
                               + torch.log(h_cur.clamp_min(eps)))
    censored = -c * torch.log(s_cur.clamp_min(eps))
    neg_l = censored + uncensored
    return ((1.0 - alpha) * neg_l + alpha * uncensored).mean()


def project_text(projector: TextProjector, text: torch.Tensor) -> torch.Tensor:
    """(B, 4, 512) raw CONCH embeddings -> (B, 3, out_dim) normalised
    targets for the tasks [general, diagnosis, survival]."""
    with torch.no_grad():
        out = l2_normalize(projector(text), dim=-1)
    return out[:, list(TEXT_PROMPT_ROWS)]
