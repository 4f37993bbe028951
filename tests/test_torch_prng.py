"""The port's threefry random numbers vs ``jax.random`` (partitionable
threefry, which the JAX package pins).

Keys, ``split`` and the raw bits must be bit-exact: they are integer
arithmetic. The Gumbel draws go through two ``log``s, which XLA and
PyTorch may round one ulp apart; a one-ulp difference in the inner log
``L = -log(u)`` moves ``-log(L)`` by ``ulp(L) / L <= 2^-23``, plus the outer
log's own rounding of one ulp of the result, so a draw ``g`` is held to
``4 ulp(max(|g|, 1))`` (measured at most 2). Categorical draws (the argmax
of noise plus logits) must give the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.ops.sampling import log_prob_of, sample_categorical


@pytest.mark.parametrize("seed", [0, 3, 7, 12345, 2**31 - 1, -5])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 16])
def test_split_matches_jax(num):
    for seed in (0, 42):
        got = prng.split(prng.PRNGKey(seed), num)
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(got, np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                                                       num)))


def test_split_chain_matches_jax():
    """The trainers' ``key, sub = split(key)`` walk, ten minibatches deep."""
    key, jkey = prng.PRNGKey(3), jax.random.PRNGKey(3)
    for _ in range(10):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(sub, np.asarray(jsub))
    np.testing.assert_array_equal(key, np.asarray(jkey))


@pytest.mark.parametrize("shape", [(3, 5), (8, 1004)])
def test_random_bits_match_jax(shape):
    key = prng.split(prng.PRNGKey(42), 3)[2]
    want = np.asarray(jax.random.bits(jnp.asarray(key), shape, jnp.uint32)).astype(np.int64)
    got = prng.random_bits(key, shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 5), (8, 1004)])
def test_gumbel_matches_jax(shape):
    for seed in range(4):
        key = prng.PRNGKey(seed)
        want = np.asarray(jax.random.gumbel(jnp.asarray(key), shape, jnp.float32))
        got = prng.gumbel(key, shape, device="cpu").numpy()
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert np.all(np.abs(got - want) <= 4 * ulp), float(np.max(np.abs(got - want) / ulp))


def test_gumbel_noise_stacks_one_draw_per_key():
    keys = prng.split(prng.PRNGKey(9), 4)
    noise = prng.gumbel_noise(keys, (5, 7), device="cpu")
    assert noise.shape == (4, 5, 7) and noise.dtype == torch.float32
    for k, row in zip(keys, noise):
        torch.testing.assert_close(row, prng.gumbel(k, (5, 7), "cpu"), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed).standard_normal((64, 1004)).astype(np.float32) * 3
    key = prng.split(prng.PRNGKey(seed), 2)[1]
    want = np.asarray(jax.random.categorical(jnp.asarray(key), logits))
    got = sample_categorical(key, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    lp = log_prob_of(torch.from_numpy(logits), got)
    want_lp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)), want[:, None], 1)[:, 0]
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-6, atol=1e-6)


def test_bad_keys_and_seeds_raise():
    with pytest.raises(ValueError, match="32 bits"):
        prng.PRNGKey(2**32)
    with pytest.raises(ValueError, match="uint32"):
        prng.split(np.array([0, 1], dtype=np.int64))
    with pytest.raises(ValueError, match="uint32"):
        prng.gumbel_noise(np.zeros((3,), np.uint32), (2, 2))
