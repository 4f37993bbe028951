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
    return visual_semantic_embedding_loss_rows(visuals, semantics, visuals, semantics, 0,
                                               beta)


def visual_semantic_embedding_loss_rows(visuals: torch.Tensor, semantics: torch.Tensor,
                                        all_visuals: torch.Tensor, all_semantics: torch.Tensor,
                                        lo: int, beta: float = 0.2) -> torch.Tensor:
    """The part of :func:`visual_semantic_embedding_loss` over the batch
    ``all_visuals, all_semantics [N, D]`` that rows ``[lo, lo + n)`` own:
    ``visuals, semantics [n, D]`` (those rows) against every column, in both
    directions, with the whole batch's margin ``beta / N`` and divisor
    ``N``. The parts of disjoint row blocks sum to the whole loss (a rank's
    part of the data-parallel reward step); ``lo = 0`` with the whole batch
    is the whole loss."""
    n_all, rows = all_visuals.shape[0], visuals.shape[0]
    margin = beta / n_all
    off_diag = 1.0 - torch.eye(n_all, dtype=visuals.dtype, device=visuals.device)[lo: lo + rows]

    def one_side(a, b):
        sim = matmul(a, b.t())  # [n, N]
        sim = sim - torch.diagonal(sim, offset=lo)[:, None]
        sim = sim + margin * off_diag
        return torch.sum(torch.relu(sim)) / n_all

    return one_side(visuals, all_semantics) + one_side(semantics, all_visuals)


def weighted_caption_xe_loss(logits: torch.Tensor, targets: torch.Tensor,
                             caption_lens: torch.Tensor) -> torch.Tensor:
    """Caption-length-weighted cross-entropy, the policy pretraining loss.
    Quirk Q5: the reference's per-sample ``(caplen / N) * mean over the
    first caplen tokens`` is the masked token-CE sum divided by N.

    ``logits [N, T, V]`` for inputs ``captions[:, :-1]``, ``targets [N, T]``
    (``captions[:, 1:]``), ``caption_lens [N]`` (END index + 1 in the
    unshifted caption)."""
    logp = torch.log_softmax(logits, dim=-1)
    return weighted_caption_xe_of(torch.gather(logp, -1, targets[..., None].long())[..., 0],
                                  caption_lens)


def weighted_caption_xe_of(target_logp: torch.Tensor, caption_lens: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`weighted_caption_xe_loss` from the targets' log-probabilities
    ``[N, T]`` (a vocab-parallel log-softmax's,
    :func:`..parallel.tensor_parallel.log_prob`)."""
    n, t = target_logp.shape
    tok_ce = -target_logp  # [N, T]
    pos = torch.arange(t, device=target_logp.device)[None, :]
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
