"""Typed configuration, field for field the JAX package's ``config.py``.

``NetConfig.precision`` stays a field so configurations cross between the
packages unchanged. The port's float32 matmuls always run in full float32:
on CUDA, :func:`.ops.linalg.matmul` turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``) before each product of
CUDA tensors, so the plain versions are true float32 references.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from . import MAX_SEQ_LEN


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Shared shape/architecture config for all four networks."""

    vocab_size: int
    input_dim: int = 512  # VGG16 fc7 (PCA) feature dim
    wordvec_dim: int = 512
    hidden_dim: int = 512
    bidirectional: bool = False
    freeze_embeddings: bool = False  # True when pretrained word vectors are used
    max_seq_len: int = MAX_SEQ_LEN
    precision: Optional[str] = None  # None | "high" | "highest" (JAX MXU precision)

    @property
    def num_directions(self) -> int:
        return 2 if self.bidirectional else 1

    @staticmethod
    def for_vocab(word_to_idx, pretrained_embeddings=None, bidirectional=False, **kw):
        """Build a config the way the reference constructs its nets:
        vocab from ``word_to_idx``; pretrained vectors override
        ``wordvec_dim`` and freeze the embedding table."""
        if pretrained_embeddings is not None:
            kw.setdefault("wordvec_dim", int(pretrained_embeddings.shape[1]))
            kw.setdefault("freeze_embeddings", True)
        return NetConfig(
            vocab_size=len(word_to_idx), bidirectional=bidirectional, **kw
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the four trainers (reference defaults)."""

    batch_size: int = 512
    reward_lr: float = 1e-4
    policy_lr: float = 1e-3
    value_lr: float = 1e-3
    a2c_lr: float = 1e-4
    reward_epochs: int = 50
    policy_epochs: int = 100
    value_epochs: int = 50
    a2c_epochs: int = 100
    vse_beta: float = 0.2
    curriculum: Optional[Sequence[int]] = None  # e.g. (3, 6, 9, 12, 15)
    seed: int = 0
    compat_batch_as_time: bool = False  # Q1: reference value/reward RNN statefulness


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    beam_size: int = 5
    value_weight: float = 0.6
    logprob_weight: float = 0.4
    max_seq_len: int = MAX_SEQ_LEN
    # Faithful mode (False) ranks one shared beam by batch-mean score and
    # scores with log(raw logit) — reference quirk Q2; not ported yet.
    per_sample_beams: bool = True
