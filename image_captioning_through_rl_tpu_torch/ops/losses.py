"""Loss functions of the trainers (counterpart of the JAX
``ops/losses.py``), vectorised, with the reference's quirks kept."""

from __future__ import annotations

import torch

from .linalg import matmul


def visual_semantic_embedding_loss(visuals: torch.Tensor, semantics: torch.Tensor,
                                   beta: float = 0.2) -> torch.Tensor:
    """Bidirectional max-margin ranking loss over the batch similarity
    matrix, ``visuals, semantics: [N, D]`` -> scalar. Quirk Q4: the margin
    is ``beta / N`` (not ``beta``), and the zeroed diagonal stays inside the
    relu-sum."""
    n = visuals.shape[0]
    margin = beta / n
    off_diag = 1.0 - torch.eye(n, dtype=visuals.dtype, device=visuals.device)

    def one_side(a, b):
        sim = matmul(a, b.t())  # [N, N]
        sim = sim - torch.diagonal(sim)[:, None]
        sim = sim + margin * off_diag
        return torch.sum(torch.relu(sim)) / n

    return one_side(visuals, semantics) + one_side(semantics, visuals)


def weighted_caption_xe_loss(logits: torch.Tensor, targets: torch.Tensor,
                             caption_lens: torch.Tensor) -> torch.Tensor:
    """Caption-length-weighted cross-entropy, the policy pretraining loss.
    Quirk Q5: the reference's per-sample ``(caplen / N) * mean over the
    first caplen tokens`` is the masked token-CE sum divided by N.

    ``logits [N, T, V]`` for inputs ``captions[:, :-1]``, ``targets [N, T]``
    (``captions[:, 1:]``), ``caption_lens [N]`` (END index + 1 in the
    unshifted caption)."""
    n, t, _ = logits.shape
    logp = torch.log_softmax(logits, dim=-1)
    tok_ce = -torch.gather(logp, -1, targets[..., None].long())[..., 0]  # [N, T]
    pos = torch.arange(t, device=logits.device)[None, :]
    mask = (pos < caption_lens[:, None]).to(tok_ce.dtype)
    return torch.sum(tok_ce * mask) / n


def a2c_losses(values: torch.Tensor, rewards: torch.Tensor, log_probs: torch.Tensor,
               step_mask: torch.Tensor | None = None, per_step_mean: bool = False):
    """Actor and critic losses of the A2C update, ``values, rewards,
    log_probs: [N, S]`` -> ``(actor, critic)`` scalars.

    Quirk Q7: the advantage is ``values - rewards`` (the negative of the
    usual ``r - V``), with no stop-gradient inside the actor term, so the
    actor loss reaches the value network too. ``step_mask`` (0/1, [N, S])
    selects the valid steps. The curriculum (``per_step_mean``) first
    means each row over its valid steps (trainers.py:581-584); plain A2C
    means over every valid step at once (trainers.py:472-473)."""
    advantage = values - rewards
    actor_terms = -log_probs * advantage
    critic_terms = 0.5 * torch.square(advantage)
    if step_mask is None:
        step_mask = torch.ones_like(values)
    if per_step_mean:
        row = torch.clamp_min(torch.sum(step_mask, dim=1), 1.0)
        actor = torch.mean(torch.sum(actor_terms * step_mask, dim=1) / row)
        critic = torch.mean(torch.sum(critic_terms * step_mask, dim=1) / row)
    else:
        denom = torch.clamp_min(torch.sum(step_mask), 1.0)
        actor = torch.sum(actor_terms * step_mask) / denom
        critic = torch.sum(critic_terms * step_mask) / denom
    return actor, critic
