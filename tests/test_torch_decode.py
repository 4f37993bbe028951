"""PyTorch port vs the JAX package: greedy and beam decoding, and the
kernel modules' plain versions.

The same seeded inputs and the JAX-initialised weights go through the
JAX function and its port. The JAX side runs at ``precision="highest"``
in float32; its Pallas kernels run in interpret mode with float32
weights, as the JAX package's own tests run them. Tokens must be equal;
beam scores agree to 1e-4 (float32 sums in another order over 6 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.decode import beam_search as jbeam_search
from image_captioning_through_rl_tpu.decode import greedy_decode as jgreedy_decode
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.ops.pallas_beam import fused_beam_search as jfused_beam
from image_captioning_through_rl_tpu.ops.pallas_decode import fused_greedy_decode as jfused_greedy
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.decode import (
    beam_search,
    greedy_decode,
    greedy_decode_full_prefix,
)
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.models import reward as treward
from image_captioning_through_rl_tpu_torch.ops import prng as tprng
from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
    beam_search_plain,
    fused_beam_search,
    prepare_beam_weights,
)
from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
    check_tile_widths,
    fused_greedy_decode,
    greedy_decode_plain,
    prepare_greedy_weights,
)
from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain, gru_chain_plain
from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain, lstm_chain_plain
from image_captioning_through_rl_tpu_torch.ops.fused_rollout import (
    prepare_reward_weights,
    prepare_rollout_weights,
    reward_stream,
    reward_stream_plain,
    rollout_forward_plain,
    rollout_from_noise,
    start_states,
)
from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
    fused_sample_decode,
    sample_decode_plain,
)

torch.set_num_threads(1)

KW = dict(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
JCFG = jconfig.NetConfig(precision="highest", **KW)
TCFG = tconfig.NetConfig(**KW)
T = KW["max_seq_len"]
BEAM = 3


@pytest.fixture(scope="module")
def params():
    jp = ja2c.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _feats(n, seed=0, dim=KW["input_dim"]):
    feats = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    return feats, np.ones(n, np.int32)


@pytest.mark.parametrize("n", [5, 20])  # ragged, and more than one 8-row kernel tile
def test_greedy_matches_jax_and_pallas(params, n):
    jp, tp = params
    feats, start = _feats(n, seed=n)
    want = np.asarray(jgreedy_decode(jp["policy"], JCFG, jnp.asarray(feats), jnp.asarray(start)))
    pallas = np.asarray(jfused_greedy(jp["policy"], jnp.asarray(feats), jnp.asarray(start),
                                      max_len=T, block_n=8, weight_dtype=jnp.float32,
                                      interpret=True))
    np.testing.assert_array_equal(pallas, want)
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    carried = greedy_decode(tp["policy"], TCFG, f, s)
    oracle = greedy_decode_full_prefix(tp["policy"], TCFG, f, s)
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    plain = greedy_decode_plain(gw, f, s, T)
    routed = fused_greedy_decode(gw, f, s, T)  # CPU tensors -> the plain version
    for got in (carried, oracle, plain, routed):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [5, 20])
def test_beam_matches_jax_and_pallas(params, n):
    jp, tp = params
    feats, start = _feats(n, seed=100 + n)
    dcfg = jconfig.DecodeConfig(beam_size=BEAM, max_seq_len=T)
    want_t, want_s = (np.asarray(x) for x in jbeam_search(
        jp["policy"], jp["value"], JCFG, dcfg, jnp.asarray(feats), jnp.asarray(start)))
    pallas_t, pallas_s = (np.asarray(x) for x in jfused_beam(
        jp["policy"], jp["value"], jnp.asarray(feats), jnp.asarray(start), max_len=T,
        beam=BEAM, block_n=8, weight_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(pallas_t, want_t)
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    carried = beam_search(tp["policy"], tp["value"], TCFG,
                          tconfig.DecodeConfig(beam_size=BEAM, max_seq_len=T), f, s)
    bw = prepare_beam_weights(prepare_greedy_weights(tp["policy"], torch.float32), tp["value"])
    plain = beam_search_plain(bw, f, s, T, BEAM)
    routed = fused_beam_search(bw, f, s, T, BEAM)
    for got_t, got_s in (carried, plain, routed):
        assert got_t.dtype == torch.int32 and got_t.shape == (n, BEAM, T)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
        np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_s.numpy(), pallas_s, atol=1e-4, rtol=1e-4)


def test_bf16_plain_versions_round_like_the_pallas_kernels(params):
    """With bf16 weights the plain versions round where the TPU kernels do
    (greedy: f32 features into h0; beam: bf16 features), so they match the
    Pallas kernels run with bf16 weights in interpret mode."""
    jp, tp = params
    feats, start = _feats(12, seed=7)
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    gw = prepare_greedy_weights(tp["policy"], torch.bfloat16)
    want = np.asarray(jfused_greedy(jp["policy"], jnp.asarray(feats), jnp.asarray(start),
                                    max_len=T, block_n=8, weight_dtype=jnp.bfloat16,
                                    interpret=True))
    np.testing.assert_array_equal(greedy_decode_plain(gw, f, s, T).numpy(), want)
    want_t, want_s = (np.asarray(x) for x in jfused_beam(
        jp["policy"], jp["value"], jnp.asarray(feats), jnp.asarray(start), max_len=T,
        beam=BEAM, block_n=8, weight_dtype=jnp.bfloat16, interpret=True))
    got_t, got_s = beam_search_plain(prepare_beam_weights(gw, tp["value"]), f, s, T, BEAM)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-4, rtol=1e-4)


def test_margins_report_the_plain_decisions(params):
    _, tp = params
    feats, start = _feats(9, seed=3)
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    toks, gaps = greedy_decode_plain(gw, f, s, T, margins=True)
    np.testing.assert_array_equal(toks.numpy(), greedy_decode_plain(gw, f, s, T).numpy())
    assert gaps.shape == (9, T - 1) and bool((gaps >= 0).all())
    bw = prepare_beam_weights(gw, tp["value"])
    bt, bs, bgaps = beam_search_plain(bw, f, s, T, BEAM, margins=True)
    plain_t, plain_s = beam_search_plain(bw, f, s, T, BEAM)
    assert torch.equal(bt, plain_t) and torch.equal(bs, plain_s)
    assert bgaps.shape == (9, T - 1) and bool((bgaps >= 0).all())


def _routed(kind, tp):
    """``(wrapper, plain)`` for one kernel wrapper on CPU tensors:
    ``wrapper(use_fused_kernel)`` and the plain version's result, each a
    tuple of tensors."""
    feats, start = _feats(4)
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(3, KW["vocab_size"], (4, T), generator=gen, dtype=torch.int32)
    h = torch.randn(4, KW["hidden_dim"], generator=gen)
    gw = prepare_greedy_weights(tp["policy"], torch.float32)
    rp = treward.init(torch.Generator().manual_seed(1), TCFG)
    if kind == "greedy":
        return (lambda uf: (fused_greedy_decode(gw, f, s, T, use_fused_kernel=uf),),
                lambda: (greedy_decode_plain(gw, f, s, T),))
    if kind == "beam":
        bw = prepare_beam_weights(gw, tp["value"])
        return (lambda uf: fused_beam_search(bw, f, s, T, BEAM, use_fused_kernel=uf),
                lambda: beam_search_plain(bw, f, s, T, BEAM))
    if kind == "sampling":
        key = tprng.PRNGKey(3)
        return (lambda uf: (fused_sample_decode(gw, f, s, key, T, temperature=0.9,
                                                use_fused_kernel=uf),),
                lambda: (sample_decode_plain(gw, f, s, key, T, temperature=0.9),))
    if kind == "lstm_chain":
        args = (tp["policy"]["lstm"], tp["policy"]["embedding"], toks, h, -h)
        return (lambda uf: (fused_lstm_chain(*args, use_fused_kernel=uf),),
                lambda: (lstm_chain_plain(*args),))
    if kind == "gru_chain":
        args = (rp["gru"], rp["embedding"], toks, h)
        return (lambda uf: (fused_gru_chain(*args, use_fused_kernel=uf),),
                lambda: (gru_chain_plain(*args),))
    if kind == "reward_stream":
        rw = prepare_reward_weights(rp, f, s.long(), torch.float32)
        act, tok = toks.t().contiguous(), toks.flip(1).t().contiguous()
        return (lambda uf: (reward_stream(rw, act, tok, uf),),
                lambda: (reward_stream_plain(rw, act, tok),))
    caps = torch.cat([s[:, None], toks[:, 1:]], 1).long()
    noise = -torch.log(-torch.log(torch.rand(T - 1, 4, KW["vocab_size"], generator=gen)))

    def plain():
        states = start_states(tp, TCFG, f, caps[:, 0])
        values, logp, _, tape = rollout_forward_plain(
            3, caps[:, 1:].t().to(torch.int32).contiguous(), noise, None, f, *states,
            prepare_rollout_weights(tp, torch.float32))
        return values.t(), logp.t(), tape.act.t(), tape.tok.t()

    return (lambda uf: rollout_from_noise(tp, TCFG, f, caps, 3, noise,
                                          weight_dtype=torch.float32, use_fused_kernel=uf),
            plain)


@pytest.mark.parametrize("kind", ["greedy", "beam", "sampling", "lstm_chain", "gru_chain",
                                  "reward_stream", "rollout"])
def test_routing_and_unported_modes(params, kind):
    """Each kernel wrapper routes by the one rule: on CPU tensors ``None``
    and ``False`` give the plain version's result, ``True`` raises
    ``RuntimeError`` instead of falling back."""
    _, tp = params
    wrapper, plain = _routed(kind, tp)
    want = plain()
    with torch.no_grad():
        for uf in (None, False):
            got = wrapper(uf)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b), uf
    with pytest.raises(RuntimeError, match="CUDA"):
        wrapper(True)
    if kind == "beam":
        feats, start = _feats(4)
        bw = prepare_beam_weights(prepare_greedy_weights(tp["policy"], torch.float32),
                                  tp["value"])
        with pytest.raises(ValueError, match="beam"):
            fused_beam_search(bw, torch.from_numpy(feats), torch.from_numpy(start), T, beam=9)


def test_bf16_kernel_width_check():
    """The bf16 kernels stage operands in 16-byte chunks: widths must be
    multiples of 8 and the vocabulary even (checked before any launch)."""
    check_tile_widths(torch.bfloat16, feat_dim=512, emb_dim=512, hidden=512, vocab=1004)
    check_tile_widths(torch.float32, hidden=12, vocab=61)  # the f32 kernels take any width
    for bad in ({"hidden": 12}, {"vocab": 61}):
        with pytest.raises(ValueError, match="multiples of 8"):
            check_tile_widths(torch.bfloat16, **bad)


def test_greedy_coco_width_matches_jax():
    """COCO widths (V = 1004, E = H = F = 512, T = 17), N = 16: the port's
    carried greedy and the plain kernel version are token-exact against
    the JAX XLA greedy at float32 on this fixed seed."""
    cfg = jconfig.NetConfig(vocab_size=1004, precision="highest")
    jp = jpolicy.init(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    feats, start = _feats(16, seed=11, dim=512)
    want = np.asarray(jax.jit(lambda p, f, s: jgreedy_decode(p, cfg, f, s))(
        jp, jnp.asarray(feats), jnp.asarray(start)))
    f, s = torch.from_numpy(feats), torch.from_numpy(start)
    tcfg = tconfig.NetConfig(vocab_size=1004)
    np.testing.assert_array_equal(greedy_decode(tp, tcfg, f, s).numpy(), want)
    gw = prepare_greedy_weights(tp, torch.float32)
    np.testing.assert_array_equal(greedy_decode_plain(gw, f, s).numpy(), want)
