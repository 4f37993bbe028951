"""The port's sampling decode vs the JAX package's, on the CPU.

Small widths (V = 42, not a multiple of 128; E = H = F = 16; N = 13, not a
multiple of 8; T = 7) with the JAX initialiser's weights carried across as
numpy, float32 throughout. The JAX side runs at ``precision="highest"``; its
Pallas sampling kernel runs in interpret mode with float32 weights, as the
JAX package's own tests run it.

Tolerances: the subkeys, the keys of the filters' bisection and the keep
sets are integer results and must be equal, ties at the k-th value
included. Tokens must be equal: the Gumbel noise of the two packages lies
within 4 ulps (two ``log``s, measured in ``test_torch_prng.py``), which
moves no draw at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.api import Captioner as JCaptioner
from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.decode import sample as jsample
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.ops import pallas_sample as jps
from image_captioning_through_rl_tpu_torch.api import Captioner
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.decode import (
    filter_logits,
    sample_decode,
    sample_decode_full_prefix,
    sample_decode_n,
)
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.ops import fused_sample as fs
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.ops.fused_decode import prepare_greedy_weights

torch.set_num_threads(1)

KW = dict(vocab_size=42, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
JCFG = JNetConfig(precision="highest", **KW)
TCFG = NetConfig(**KW)
T, V, N = KW["max_seq_len"], KW["vocab_size"], 13
IDX_TO_WORD = {i: f"w{i}" for i in range(V)}
# (top_k, top_p): unfiltered, top-k, nucleus, both
FILTERS = [(0, None), (5, None), (0, 0.8), (5, 0.8)]


@pytest.fixture(scope="module")
def params():
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _feats(n=N, seed=0):
    feats = np.random.default_rng(seed).standard_normal((n, KW["input_dim"])).astype(np.float32)
    return feats, np.ones(n, np.int32)


def _jp(p):
    return None if p is None else jnp.float32(p)


@pytest.mark.parametrize("seed", [0, 5, -3])
def test_sample_step_keys_match_jax(seed):
    for steps in (1, 6, 16):
        got = prng.sample_step_keys(prng.PRNGKey(seed), steps)
        assert got.dtype == np.uint32 and got.shape == (steps, 2)
        np.testing.assert_array_equal(
            got, np.asarray(jps.sample_step_keys(jax.random.PRNGKey(seed), steps)))


def test_monotone_keys_match_jax():
    vals = np.concatenate([
        np.random.default_rng(1).standard_normal(200).astype(np.float32) * 10,
        np.float32([0.0, -0.0, 1e-37, -1e-37, 1e30, -1e30, 3.5, -3.5, np.inf, -np.inf]),
    ])
    got = fs.monotone_keys(torch.from_numpy(vals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jps.monotone_keys(jnp.asarray(vals))))
    assert int(fs.monotone_keys(torch.tensor(-0.0))) == int(fs.monotone_keys(torch.tensor(0.0)))


def _tied_logits(seed):
    logits = np.random.default_rng(seed).standard_normal((8, V)).astype(np.float32)
    logits[0, :5] = 2.5       # ties above and at the k-th value
    logits[1, 3] = -0.0       # +/-0.0 on either side of a threshold
    logits[1, 7] = 0.0
    logits[2] = 1.0           # a row of one value
    logits[3, 10:20] = logits[3, 0]  # a run of ties in the middle
    return logits


@pytest.mark.parametrize("k,p", [(3, None), (1, None), (5, None), (41, None), (0, 0.7),
                                 (0, 0.2), (0, 1.0), (4, 0.9), (5, 0.8), (30, 0.999)])
def test_filters_match_jax_and_filter_logits(k, p):
    """The bisection thresholds, the sort-free filter and the sort-based
    ``filter_logits`` keep the same sets as the JAX functions."""
    logits = _tied_logits(k + int(100 * (p or 0)))
    x, xj = torch.from_numpy(logits), jnp.asarray(logits)
    use_top_k, use_top_p = 0 < k < V, p is not None
    keys = fs.monotone_keys(x)
    thr = fs.keyspace_threshold(keys, torch.ones_like(x), torch.tensor(float(k)))
    jthr = jps.keyspace_threshold(jps.monotone_keys(xj), jnp.ones_like(xj), jnp.float32(k))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(jthr))
    got = fs.filter_scaled_logits(x, k, p, use_top_k, use_top_p)
    want = np.asarray(jps.filter_scaled_logits(xj, jnp.int32(k), jnp.float32(p or 1.0),
                                               use_top_k, use_top_p))
    np.testing.assert_array_equal(got.numpy(), want)
    keep = got.numpy() > -1e29
    sorted_keep = np.isfinite(filter_logits(x, k, p).numpy())
    np.testing.assert_array_equal(sorted_keep, keep)
    np.testing.assert_array_equal(
        np.isfinite(np.asarray(jsample.filter_logits(xj, top_k=k, top_p=_jp(p)))), keep)
    if use_top_k and not use_top_p:
        assert (keep.sum(axis=1) >= k).all() and keep[0, :5].all()


def test_filter_margins_see_each_boundary():
    """The margins come near 0 where a top-k boundary, the nucleus's
    boundary value or its mass nearly ties, and stay large elsewhere."""
    close = torch.tensor([[3.0, 2.0, 1.0, 1.0 + 1e-6, 0.0]])  # (k+1)-th ties the k-th
    wide = torch.tensor([[3.0, 2.0, 1.0, 0.0, -1.0]])
    for x, small in ((close, True), (wide, False)):
        _, m = fs.filter_scaled_logits(x, 3, None, True, False, margins=True)
        assert (float(m[0]) < 1e-5) == small
    # the nucleus keeps [2, 1, 0.5]; the dropped 0.5 - 1e-6 nearly ties the boundary
    x = torch.tensor([[2.0, 1.0, 0.5, 0.5 - 1e-6, -3.0]])
    p = float(torch.softmax(x[0], 0)[:3].sum()) - 1e-3
    kept, m = fs.filter_scaled_logits(x, 0, p, False, True, margins=True)
    assert int((kept > -1e29).sum()) == 3 and float(m[0]) < 1e-5
    # p * z lands on a mass step: p is the first token's probability
    x = torch.tensor([[0.0, -1e-3, -30.0]])
    p = float(torch.softmax(x[0], 0)[0])
    _, m = fs.filter_scaled_logits(x, 0, p, False, True, margins=True)
    assert float(m[0]) < 1e-5
    _, m = fs.filter_scaled_logits(wide, 0, None, False, False, margins=True)
    assert bool(torch.isinf(m).all())


@pytest.mark.parametrize("k,p", FILTERS)
def test_sample_decode_plain_matches_pallas_interpret(params, k, p):
    """The kernel's plain version (float32 weights) against the JAX TPU
    kernel in interpret mode, at t = 0.7, for the four filter variants."""
    jp, tp = params
    feats, start = _feats(seed=k + int(10 * (p or 0)))
    want = np.asarray(jps.fused_sample_decode(
        jp["policy"], jnp.asarray(feats), jnp.asarray(start), jax.random.PRNGKey(42),
        max_len=T, temperature=0.7, top_k=k, top_p=_jp(p), block_n=8,
        weight_dtype=jnp.float32, interpret=True))
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    key = prng.PRNGKey(42)
    plain = fs.sample_decode_plain(gw, f, s, key, T, temperature=0.7, top_k=k, top_p=p)
    routed = fs.fused_sample_decode(gw, f, s, key, T, temperature=0.7, top_k=k, top_p=p)
    toks, margins = fs.sample_decode_plain(gw, f, s, key, T, temperature=0.7, top_k=k,
                                           top_p=p, margins=True)
    for got in (plain, routed, toks):
        assert got.dtype == torch.int32 and got.shape == (N, T)
        np.testing.assert_array_equal(got.numpy(), want)
    assert margins.shape == (N, T - 1) and bool((margins >= 0).all())
    assert bool(torch.isfinite(margins).all())


@pytest.mark.parametrize("k,p", FILTERS)
def test_decode_sample_matches_jax(params, k, p):
    """``sample_decode``, its full-prefix oracle and ``sample_decode_n``
    against the JAX package's XLA sampling decode."""
    jp, tp = params
    feats, start = _feats(seed=20 + k)
    kw = dict(max_len=T, temperature=1.3, top_k=k)
    jf, js, jkey = jnp.asarray(feats), jnp.asarray(start), jax.random.PRNGKey(7)
    want = np.asarray(jsample.sample_decode(jp["policy"], JCFG, jf, js, jkey, top_p=_jp(p), **kw))
    want_n = np.asarray(jsample.sample_decode_n(jp["policy"], JCFG, jf, js, jkey, 3,
                                                top_p=_jp(p), **kw))
    f, s, key = torch.from_numpy(feats), torch.from_numpy(start), prng.PRNGKey(7)
    for fn in (sample_decode, sample_decode_full_prefix):
        got = fn(tp["policy"], TCFG, f, s, key, top_p=p, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    got_n = sample_decode_n(tp["policy"], TCFG, f, s, key, 3, top_p=p, **kw)
    assert got_n.shape == (N, 3, T)
    np.testing.assert_array_equal(got_n.numpy(), want_n)


@pytest.mark.parametrize("num_samples,temperature", [(1, 0.9), (3, 0.9), (1, 0.0), (3, 0.0)])
def test_captioner_sampling_matches_jax(params, num_samples, temperature):
    jp, tp = params
    jcap = JCaptioner(jp, JCFG, IDX_TO_WORD)
    cap = Captioner(tp, TCFG, IDX_TO_WORD, device="cpu")
    feats, _ = _feats(5, seed=30 + num_samples)
    for kw in (dict(top_k=5, top_p=0.8), dict()):
        kw.update(temperature=temperature, num_samples=num_samples, seed=11)
        want = np.asarray(jcap.sample_tokens(feats, use_fused_kernel=False, **kw))
        got = cap.sample_tokens(feats, **kw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert cap.sample_captions(feats, **kw) == jcap.sample_captions(
            feats, use_fused_kernel=False, **kw)


@pytest.mark.parametrize("kw", [dict(num_samples=0), dict(temperature=-0.5), dict(top_p=0.0),
                                dict(top_p=1.5)])
def test_captioner_sampling_rejects_what_jax_rejects(params, kw):
    jp, tp = params
    feats, _ = _feats(2)
    with pytest.raises(ValueError):
        JCaptioner(jp, JCFG, IDX_TO_WORD).sample_tokens(feats, use_fused_kernel=False, **kw)
    with pytest.raises(ValueError):
        Captioner(tp, TCFG, IDX_TO_WORD, device="cpu").sample_tokens(feats, **kw)


def test_routing_and_the_counter_space(params):
    _, tp = params
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    feats, start = _feats(4)
    f, s, key = torch.from_numpy(feats), torch.from_numpy(start), prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.fused_sample_decode(gw, f, s, key, T, use_fused_kernel=True)
    with pytest.raises(ValueError, match="temperature"):
        fs.fused_sample_decode(gw, f, s, key, T, temperature=0.0)
    np.testing.assert_array_equal(
        fs.fused_sample_decode(gw, f, s, key, T, top_k=3, use_fused_kernel=False).numpy(),
        fs.sample_decode_plain(gw, f, s, key, T, top_k=3).numpy())
    # uint32 counters: rows * V < 2**32 (the TPU kernel's int32 bound was 2**31)
    assert fs.fused_rows_ok(4_000_000, 1004) and not fs.fused_rows_ok(4_300_000, 1004)
    assert fs.fused_rows_ok(2**32 // V, V) and not fs.fused_rows_ok(2**32 // V + 1, V)
    rows = 2**32 // V + 1  # raises on every route before touching the rows
    big_f = f[:1].expand(rows, f.shape[1])
    big_s = s[:1].expand(rows)
    for flag in (None, False):
        with pytest.raises(ValueError, match="counter space"):
            fs.fused_sample_decode(gw, big_f, big_s, key, T, use_fused_kernel=flag)
    with pytest.raises(ValueError, match="counter space"):
        Captioner(tp, TCFG, IDX_TO_WORD, device="cpu").sample_tokens(feats[:1],
                                                                     num_samples=rows)
