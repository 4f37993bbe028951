"""Skip-gram-with-negative-sampling word embeddings, trained on the card.

The port's counterpart of the JAX ``embeddings/word2vec.py``, which stands
in for the reference's gensim training (utilities.py:444-468: skip-gram,
size 300, min_count 1, 30 epochs): the (center, context) pairs are mined on
the host once; each step gathers its rows, draws its negatives from the
unigram^0.75 distribution, computes the SGNS objective and its closed-form
gradients and adds them into the rows it touched, over a batch of 65536
pairs. ``embedding_type="fasttext"`` adds fastText-style subword n-grams (3
to 6 characters, FNV-1a into a bucket table): a word's input vector is the
mean of its word vector and the weighted sum of its n-gram vectors.

Random numbers are the JAX package's: numpy's ``default_rng(seed)`` draws the
input table, then the bucket table, then each word's window shrink, then
each epoch's permutation; the negatives of a step are
``jax.random.categorical(sub, 0.75 log f, shape=(B, K))`` for
``key, sub = split(key)`` from ``PRNGKey(seed)``, through
:func:`..ops.prng.categorical`, whose Gumbel draw the noise kernel
(``csrc/threefry.cu``) makes on the card.

Sums: a row that several pairs touch gets their sum. On the card these sums
run in a fixed order, so two runs give the same bits: the word rows go
through ``embedding_dense_backward`` (CUDA: sorted segments, no atomics) and
fastText's n-gram rows through ``embedding_bag``'s backward, which weighs
each bag's rows without a ``[B, G, D]`` tensor. Neither syncs the host, and
the pairs, the permutation and the learning rates reach the device once an
epoch or once a run. The JAX package adds in pair order (XLA's scatter), so
the two agree to float rounding, not bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import prng
from ..utils.logging import print_green
from .vocab_align import get_vectors_by_vocab

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def _fnv1a(s: str) -> int:
    """32-bit FNV-1a of ``s``'s UTF-8 bytes."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h


def _char_ngrams(word: str, min_n: int = 3, max_n: int = 6) -> List[str]:
    w = f"<{word}>"
    return [w[i : i + n] for n in range(min_n, max_n + 1) for i in range(len(w) - n + 1)]


def build_vocab(corpus: Sequence[Sequence[str]], min_count: int = 1):
    """``(word_to_id, freqs)``: the words seen at least ``min_count`` times,
    sorted, and their counts (float64)."""
    counts: Dict[str, int] = {}
    for sent in corpus:
        for w in sent:
            counts[w] = counts.get(w, 0) + 1
    words = sorted(w for w, c in counts.items() if c >= min_count)
    word_to_id = {w: i for i, w in enumerate(words)}
    freqs = np.asarray([counts[w] for w in words], dtype=np.float64)
    return word_to_id, freqs


def _mine_pairs(corpus: Sequence[Sequence[str]], word_to_id: Dict[str, int], window: int,
                rng: np.random.Generator) -> np.ndarray:
    """All (center, context) pairs with word2vec's random window shrink,
    ``int32 [P, 2]``, in the JAX package's order: for each kept word, in
    corpus order, one draw ``b`` in ``[1, window]``, then its contexts
    ``j`` in ``[i - b, i + b]`` inside the sentence, ``j != i``, ascending.
    One vector draw of ``b`` for all words gives the numbers and leaves the
    generator where a draw per word would (tests hold the two equal)."""
    sents = [[word_to_id[w] for w in sent if w in word_to_id] for sent in corpus]
    lens = np.fromiter(map(len, sents), dtype=np.int64, count=len(sents))
    n = int(lens.sum())
    if n == 0:
        return np.zeros((0, 2), dtype=np.int32)
    ids = np.fromiter(itertools.chain.from_iterable(sents), dtype=np.int32, count=n)
    b = rng.integers(1, window + 1, size=n)
    pos = np.arange(n) - np.repeat(np.cumsum(lens) - lens, lens)  # index in its sentence
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    j = pos[:, None] + offs
    keep = (np.abs(offs) <= b[:, None]) & (j >= 0) & (j < np.repeat(lens, lens)[:, None])
    rows, cols = np.nonzero(keep)  # row-major: word by word, j ascending
    return np.stack([ids[rows], ids[rows + offs[cols]]], axis=1)


def _sgns_loss(pos_score: torch.Tensor, neg_score: torch.Tensor) -> torch.Tensor:
    return -torch.mean(F.logsigmoid(pos_score) + F.logsigmoid(-neg_score).sum(-1))


def _add_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """``table[ids[i]] += rows[i]`` for every i, a repeated id's rows summed
    in a fixed order (embedding's backward: sorted segments on CUDA)."""
    table.add_(torch.ops.aten.embedding_dense_backward(rows, ids, table.shape[0], -1, False))


def _make_sgns_step(num_negatives: int, use_subwords: bool, dense: bool = False):
    """The SGNS step ``step(params, word_ngrams, ngram_wts, lr, centers,
    contexts, key, noise_logits) -> (params, loss)``.

    The default is the sparse step of the JAX package: the closed-form
    per-row gradients (``sigmoid(score) - label`` times the paired vectors,
    mean over the batch) added into only the rows the batch touched, the
    tables updated in place. ``dense=True`` is the autograd oracle (a full
    gradient of every table, new tables returned), which the tests hold the
    sparse step to. ``lr`` is a float32 scalar tensor, ``key`` a host key
    (``prng.PRNGKey``)."""

    def negatives(key, noise_logits, b):
        return prng.categorical(key, noise_logits, shape=(b, num_negatives))

    def dense_step(params, word_ngrams, ngram_wts, lr, centers, contexts, key, noise_logits):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            if use_subwords:
                sub = (leaves["buckets"][word_ngrams[centers]]
                       * ngram_wts[centers][:, :, None]).sum(1)
                v_c = (leaves["in"][centers] + sub) / 2.0
            else:
                v_c = leaves["in"][centers]
            u_pos = leaves["out"][contexts]
            u_neg = leaves["out"][negatives(key, noise_logits, centers.shape[0])]
            loss = _sgns_loss((v_c * u_pos).sum(-1), (u_neg * v_c[:, None, :]).sum(-1))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return {k: params[k] - lr * g for k, g in zip(leaves, grads)}, loss.detach()

    def sparse_step(params, word_ngrams, ngram_wts, lr, centers, contexts, key, noise_logits):
        b = centers.shape[0]
        if use_subwords:
            buckets = params["buckets"].detach().requires_grad_()
            with torch.enable_grad():
                sub = F.embedding_bag(word_ngrams[centers], buckets, mode="sum",
                                      per_sample_weights=ngram_wts[centers])
            v_c = (params["in"][centers] + sub.detach()) / 2.0
        else:
            v_c = params["in"][centers]
        u_pos = params["out"][contexts]
        negs = negatives(key, noise_logits, b)
        u_neg = params["out"][negs]
        pos_score = (v_c * u_pos).sum(-1)
        neg_score = (u_neg * v_c[:, None, :]).sum(-1)
        loss = _sgns_loss(pos_score, neg_score)
        # d/dscore of -log_sigmoid(pos) is sigmoid(pos) - 1, of
        # -log_sigmoid(-neg) sigmoid(neg)
        g_pos = (torch.sigmoid(pos_score) - 1.0) / b
        g_neg = torch.sigmoid(neg_score) / b
        d_vc = g_pos[:, None] * u_pos + (g_neg[:, :, None] * u_neg).sum(1)
        _add_rows(params["out"], contexts, -lr * g_pos[:, None] * v_c)
        _add_rows(params["out"], negs.reshape(-1),
                  -lr * (g_neg[:, :, None] * v_c[:, None, :]).reshape(-1, v_c.shape[1]))
        if use_subwords:
            _add_rows(params["in"], centers, -lr * d_vc / 2.0)
            (d_buckets,) = torch.autograd.grad(sub, buckets, -lr * (d_vc / 2.0))
            params["buckets"].add_(d_buckets)
        else:
            _add_rows(params["in"], centers, -lr * d_vc)
        return params, loss

    return dense_step if dense else sparse_step


def _ngram_table(word_to_id: Dict[str, int], num_buckets: int, ngrams_per_word: int):
    """fastText's fixed-shape ``[vocab, ngrams_per_word]`` bucket ids and
    weights: a word's real slots weigh ``1 / n_real`` (a mean over its
    n-gram occurrences), padding slots 0; a word with more n-grams keeps
    the first ``ngrams_per_word`` (the shortest first)."""
    grams = np.zeros((len(word_to_id), ngrams_per_word), dtype=np.int64)
    wts = np.zeros((len(word_to_id), ngrams_per_word), dtype=np.float32)
    for w, i in word_to_id.items():
        hs = [_fnv1a(g) % num_buckets for g in _char_ngrams(w)][:ngrams_per_word]
        if not hs:
            hs = [_fnv1a(w) % num_buckets]
        grams[i, : len(hs)] = hs
        wts[i, : len(hs)] = 1.0 / len(hs)
    return grams, wts


def _sgns_start(corpus: Sequence[Sequence[str]], size: int, window: int, min_count: int,
                subwords: bool, num_buckets: int, ngrams_per_word: int, seed: int,
                device: torch.device):
    """What :func:`train_sgns` draws before its first step, in the JAX
    package's order (the vocabulary, the input table, the bucket table, the
    pairs) -> ``(word_to_id, params, word_ngrams, ngram_wts, noise_logits,
    pairs, rng)`` on ``device``, ``rng`` where the epochs' permutations
    continue it; ``None`` for an empty vocabulary."""
    rng = np.random.default_rng(seed)
    word_to_id, freqs = build_vocab(corpus, min_count)
    vocab = len(word_to_id)
    if vocab == 0:
        return None
    noise_logits = torch.as_tensor(0.75 * np.log(freqs), dtype=torch.float32, device=device)
    params = {"in": torch.as_tensor(rng.uniform(-0.5 / size, 0.5 / size, (vocab, size))
                                    .astype(np.float32), device=device),
              "out": torch.zeros((vocab, size), dtype=torch.float32, device=device)}
    word_ngrams = torch.zeros((1, 1), dtype=torch.int64, device=device)  # unused without subwords
    ngram_wts = torch.zeros((1, 1), dtype=torch.float32, device=device)
    if subwords:
        grams, wts = _ngram_table(word_to_id, num_buckets, ngrams_per_word)
        # a padding slot weighs 0, so the bucket it names changes no sum;
        # naming bucket 0 in all of them made one segment of ~1.3 M rows a
        # step at B = 65536, which the backward sums serially (16 of 27 ms a
        # step on an H100 at 700 W): each slot names a bucket of its own
        grams = np.where(wts > 0, grams,
                         np.arange(grams.size).reshape(grams.shape) % num_buckets)
        word_ngrams = torch.as_tensor(grams, device=device)
        ngram_wts = torch.as_tensor(wts, device=device)
        params["buckets"] = torch.as_tensor(
            rng.uniform(-0.5 / size, 0.5 / size, (num_buckets, size)).astype(np.float32),
            device=device)
    pairs = _mine_pairs(corpus, word_to_id, window, rng)
    return word_to_id, params, word_ngrams, ngram_wts, noise_logits, pairs, rng


def _epoch_batches(rng: np.random.Generator, n_pairs: int, batch_size: int) -> np.ndarray:
    """One epoch's ``[steps, batch_size]`` pair indices: a permutation, the
    last batch repeating its pairs up to the batch size (``np.resize``)."""
    order = rng.permutation(n_pairs)
    steps = -(-n_pairs // batch_size)
    lo = (steps - 1) * batch_size
    return np.concatenate([order[:lo], np.resize(order[lo:], batch_size)]).reshape(steps,
                                                                                   batch_size)


def train_sgns(corpus: Sequence[Sequence[str]], size: int = 300, window: int = 5,
               min_count: int = 1, epochs: int = 30, num_negatives: int = 5,
               lr: float = 0.025, min_lr: float = 1e-4, batch_size: int = 65536,
               subwords: bool = False, num_buckets: int = 1 << 17, ngrams_per_word: int = 32,
               seed: int = 0, device="cuda") -> Dict[str, np.ndarray]:
    """Train SGNS embeddings on ``device`` (the card unless the caller asks
    for the CPU; a missing card raises); returns a word -> float32 vector
    dict. Every step takes ``batch_size`` pairs (an epoch's last batch
    repeats its pairs up to that size, ``np.resize``), at a learning rate
    falling linearly from ``lr`` to ``min_lr`` (rounded to float32). A
    step's Gumbel draw holds ``batch_size * num_negatives * vocab`` entries,
    which must stay under 2**32 (``ops.prng``)."""
    from ..api import resolve_device  # api imports the ops: resolve at call time

    dev = resolve_device(device)
    start = _sgns_start(corpus, size, window, min_count, subwords, num_buckets,
                        ngrams_per_word, seed, dev)
    if start is None:
        return {}
    word_to_id, params, word_ngrams, ngram_wts, noise_logits, pairs, rng = start
    if pairs.shape[0] == 0:
        return {w: np.zeros(size, np.float32) for w in word_to_id}

    n_pairs = pairs.shape[0]
    steps = epochs * -(-n_pairs // batch_size)
    lrs = torch.as_tensor(np.asarray([max(min_lr, lr * (1.0 - s / max(1, steps)))
                                      for s in range(steps)], dtype=np.float32), device=dev)
    centers_all = torch.as_tensor(pairs[:, 0].astype(np.int64), device=dev)
    contexts_all = torch.as_tensor(pairs[:, 1].astype(np.int64), device=dev)
    key = prng.PRNGKey(seed)
    step = _make_sgns_step(num_negatives, subwords)
    step_no = 0
    for _ in range(epochs):
        for sel in torch.as_tensor(_epoch_batches(rng, n_pairs, batch_size), device=dev):
            key, sub = prng.split(key)
            params, _ = step(params, word_ngrams, ngram_wts, lrs[step_no], centers_all[sel],
                             contexts_all[sel], sub, noise_logits)
            step_no += 1

    vecs = params["in"]
    if subwords:
        vecs = (vecs + F.embedding_bag(word_ngrams, params["buckets"], mode="sum",
                                       per_sample_weights=ngram_wts)) / 2.0
    vecs = vecs.cpu().numpy()
    return {w: vecs[i] for w, i in word_to_id.items()}


def train_word_embeddings(embedding_type: str, target_data, train_corpus: Sequence[Sequence[str]],
                          size: int = 300, epochs: int = 30, seed: int = 0, save_path: str = "",
                          device="cuda") -> Optional[np.ndarray]:
    """The reference's entry point (utilities.py:444-468): train
    ``word2vec`` or ``fasttext`` vectors on the caption corpus (on
    ``device``, the card unless the caller asks for the CPU) and align them
    to the dataset vocabulary. ``save_path`` also writes the raw
    (pre-alignment) vectors in the word2vec interchange format (binary for
    ``.bin`` and ``.bin.gz``)."""
    if embedding_type == "none":
        return None
    print_green("[Info] Training Word Embeddings (PyTorch SGNS)")
    model = train_sgns(train_corpus, size=size, epochs=epochs,
                       subwords=(embedding_type == "fasttext"), seed=seed, device=device)
    print_green("[Info] Finished Training Word Embeddings")
    if save_path:
        from .pretrained import save_word2vec_format

        save_word2vec_format(model, save_path, binary=save_path.endswith((".bin", ".bin.gz")))
        print_green(f"[Info] Saved word embeddings to {save_path}")
    word_to_idx = (target_data.word_to_idx if hasattr(target_data, "word_to_idx")
                   else target_data["word_to_idx"])
    return get_vectors_by_vocab(model, word_to_idx)
