"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: without a CUDA device every test here skips. The file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch (the tests' ``conftest.py`` imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small widths (V = 60, E = H = F = 16, T = 7) with weights from a seeded
``torch.Generator`` and features from a seeded numpy generator. Tokens must
be equal except where the plain version came within ``NEAR_TIE`` of a tie
(the kernels sum in another order than cuBLAS); scores of agreeing rows
agree to 1e-4 with float32 weights and 1e-3 with bf16 weights (bf16
rounding of h and of linear1's output after float32 sums of another
order). The COCO-width comparison is ``chip_smoke.py``'s.

The LSTM and GRU chains (forward and backward) are held against their
plain versions at a small shape and at the COCO shape (N = 512, T = 17,
E = H = 512, V = 1004): ``hs`` and every gradient for a fixed upstream
gradient, by relative Frobenius error, within 1e-4 with float32 weights
(sum order alone) and 2e-2 with bf16 weights (sum order ahead of a bf16
rounding of h or of a gate gradient moves it by one bf16 step, 2^-8).

The sampling kernel at the small widths, bf16 and float32 weights, for the
four filter variants (none, top-k, nucleus, both) at t = 0.7: tokens equal
to the plain version's except where the plain version came within
``SAMPLE_NEAR_TIE`` of a tie at the first step where they part (its top-2
noisy gap, the k-th/(k+1)-th logit gap, the nucleus's boundary-value gap or
its mass margin over z; bf16 logits of the two differ by up to ~2e-4, see
``chip_smoke.py``).

The A2C kernels at the small widths: the threefry kernel's bits equal the
plain version's and its Gumbel noise lies within 4 ulps of it (two
``logf``s, see ``test_torch_prng.py``); the reward stream and the rollout
forward within ``ROLLOUT_TOL`` (max abs error, on the rows whose actions
agree; a row may part only at a near-tie of the noisy logits); the rollout
backward, run by kernel and plain on one shared forward tape, within
``CHAIN_TOL`` by relative Frobenius error (its recurrences are the LSTM
chain's backward).
"""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.models import a2c, reward
from image_captioning_through_rl_tpu_torch.models.initializers import (
    embedding_init,
    gru_init,
    lstm_init,
)
from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
    beam_search_plain,
    fused_beam_search,
    prepare_beam_weights,
)
from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
    fused_greedy_decode,
    greedy_decode_plain,
    prepare_greedy_weights,
    token_gate_table,
    token_gate_table_plain,
)
from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
from image_captioning_through_rl_tpu_torch.ops import prng
from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain
from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
    MAX_VOCAB,
    fused_sample_decode,
    sample_decode_plain,
)
from image_captioning_through_rl_tpu_torch.train.steps import a2c_rollout_loss_fused

CFG = NetConfig(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
T = CFG.max_seq_len
BEAM = 3
N = 20
NEAR_TIE = 1e-4
SAMPLE_NEAR_TIE = {torch.float32: 1e-4, torch.bfloat16: 5e-4}
SCORE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
WEIGHT_TYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _setup(dev, wd):
    params = a2c.init(torch.Generator().manual_seed(0), CFG)
    on_dev = {net: {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                        else v.to(dev)) for k, v in p.items()} for net, p in params.items()}
    gw = prepare_greedy_weights(on_dev["policy"], wd)
    bw = prepare_beam_weights(gw, on_dev["value"])
    feats = np.random.default_rng(5).standard_normal((N, CFG.input_dim)).astype(np.float32)
    start = torch.full((N,), START_ID, dtype=torch.int32, device=dev)
    return gw, bw, torch.from_numpy(feats).to(dev), start


def _differing_rows(k_tok, p_tok):
    return (k_tok != p_tok).reshape(k_tok.shape[0], -1).any(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_token_gate_table_kernel_matches_plain(dev, wd):
    gw, bw, _, _ = _setup(dev, wd)
    before = token_gate_table.launches
    for emb, w in ((gw.emb, gw.w), (bw.value.emb, bw.value.w)):
        got = token_gate_table(emb, w)
        torch.testing.assert_close(got, token_gate_table_plain(emb, w), rtol=1e-5, atol=1e-5)
    assert token_gate_table.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_greedy_kernel_matches_plain(dev, wd):
    gw, _, f, s = _setup(dev, wd)
    before = fused_greedy_decode.launches
    k_tok = fused_greedy_decode(gw, f, s, T)
    torch.cuda.synchronize()
    assert fused_greedy_decode.launches == before + 1
    p_tok, gaps = greedy_decode_plain(gw, f, s, T, margins=True)
    bad = _differing_rows(k_tok, p_tok)
    assert k_tok.shape == (N, T) and k_tok.dtype == torch.int32
    assert bool((gaps[bad].min(dim=1).values < NEAR_TIE).all()), "a non-tie row differs"
    # the explicit plain route launches nothing
    fused_greedy_decode(gw, f, s, T, use_fused_kernel=False)
    assert fused_greedy_decode.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_beam_kernel_matches_plain(dev, wd):
    _, bw, f, s = _setup(dev, wd)
    before = fused_beam_search.launches
    k_tok, k_sc = fused_beam_search(bw, f, s, T, BEAM)
    torch.cuda.synchronize()
    assert fused_beam_search.launches == before + 1
    p_tok, p_sc, gaps = beam_search_plain(bw, f, s, T, BEAM, margins=True)
    bad = _differing_rows(k_tok, p_tok)
    assert k_tok.shape == (N, BEAM, T) and k_sc.shape == (N, BEAM)
    assert bool((gaps[bad].min(dim=1).values < NEAR_TIE).all()), "a non-tie row differs"
    torch.testing.assert_close(k_sc[~bad], p_sc[~bad], rtol=0, atol=SCORE_TOL[wd])


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(dev):
    gw, bw, f, s = _setup(dev, torch.float32)
    with pytest.raises(ValueError, match="start_tokens"):
        fused_greedy_decode(gw, f, s.long(), T)
    with pytest.raises(ValueError, match="features"):
        fused_beam_search(bw, f.double(), s, T, BEAM)
    with pytest.raises(ValueError, match="start tokens"):
        fused_greedy_decode(gw, f, torch.full_like(s, CFG.vocab_size), T)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(0, None), (5, None), (0, 0.8), (5, 0.8)])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_sample_kernel_matches_plain(dev, wd, k, p):
    gw, _, f, s = _setup(dev, wd)
    key = prng.PRNGKey(3)
    before = fused_sample_decode.launches
    k_tok = fused_sample_decode(gw, f, s, key, T, temperature=0.7, top_k=k, top_p=p)
    torch.cuda.synchronize()
    assert fused_sample_decode.launches == before + 1
    p_tok, margins = sample_decode_plain(gw, f, s, key, T, 0.7, k, p, margins=True)
    assert k_tok.shape == (N, T) and bool((k_tok[:, 0] == START_ID).all())
    bad = _differing_rows(k_tok, p_tok)
    first = (k_tok != p_tok).int().argmax(dim=1) - 1
    assert bool((margins[bad].gather(1, first[bad, None])[:, 0] < SAMPLE_NEAR_TIE[wd]).all()), \
        "a non-tie row differs"
    fused_sample_decode(gw, f, s, key, T, top_k=k, top_p=p, use_fused_kernel=False)
    assert fused_sample_decode.launches == before + 1


@pytest.mark.cuda
def test_sample_wrapper_rejects_bad_inputs(dev):
    gw, _, f, s = _setup(dev, torch.float32)
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="start_tokens"):
        fused_sample_decode(gw, f, s.long(), key, T)
    with pytest.raises(ValueError, match="temperature"):
        fused_sample_decode(gw, f, s, key, T, temperature=0.0)
    wide = prepare_greedy_weights({
        "embedding": torch.zeros((MAX_VOCAB + 2, 16), device=dev),
        "cnn2linear": {"w": torch.zeros((16, 16), device=dev), "b": torch.zeros(16, device=dev)},
        "lstm": {"wi": torch.zeros((16, 64), device=dev), "wh": torch.zeros((16, 64), device=dev),
                 "b": torch.zeros(64, device=dev)},
        "head": {"w": torch.zeros((16, MAX_VOCAB + 2), device=dev),
                 "b": torch.zeros(MAX_VOCAB + 2, device=dev)}}, torch.float32)
    with pytest.raises(ValueError, match="vocabulary"):
        fused_sample_decode(wide, f, s, key, T)


CHAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CHAIN_SHAPES = {"small": (20, 7, 16, 16, 60), "coco": (512, 17, 512, 512, 1004)}


def _chain_setup(dev, kind, shape):
    n, t, e, h, v = CHAIN_SHAPES[shape]
    gen = torch.Generator().manual_seed(3)
    params = (lstm_init if kind == "lstm" else gru_init)(gen, e, h)
    emb = embedding_init(gen, v, e)
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, v, size=(n, t))).to(dev)
    states = [torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(dev)
              for _ in range(2 if kind == "lstm" else 1)]
    dhs = torch.from_numpy(rng.standard_normal((n, t, h)).astype(np.float32)).to(dev)
    leaves = [p.to(dev).requires_grad_() for p in params.values()]
    params = dict(zip(params, leaves))
    inputs = leaves + [emb.to(dev).requires_grad_()] + [s.requires_grad_() for s in states]
    return params, inputs, tok, dhs


def _chain_run(kind, params, inputs, tok, dhs, wd, use_fused_kernel):
    chain = fused_lstm_chain if kind == "lstm" else fused_gru_chain
    emb, *states = inputs[len(params):]
    hs = chain(params, emb, tok, *states, weight_dtype=wd, use_fused_kernel=use_fused_kernel)
    grads = torch.autograd.grad(hs, inputs, dhs)
    return [hs.detach(), *grads]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CHAIN_SHAPES))
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_chain_kernels_match_plain(dev, kind, wd, shape):
    chain = fused_lstm_chain if kind == "lstm" else fused_gru_chain
    params, inputs, tok, dhs = _chain_setup(dev, kind, shape)
    before = (chain.fwd_launches, chain.bwd_launches)
    got = _chain_run(kind, params, inputs, tok, dhs, wd, None)
    torch.cuda.synchronize()
    assert (chain.fwd_launches, chain.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _chain_run(kind, params, inputs, tok, dhs, wd, False)
    names = ["hs", *params, "embedding", "h0", "c0"]
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        rel = float((a - b).norm() / b.norm())
        assert rel <= CHAIN_TOL[wd], f"{kind} {name}: relative error {rel:.3g}"


@pytest.mark.cuda
def test_chain_wrappers_reject_bad_inputs(dev):
    params, inputs, tok, _ = _chain_setup(dev, "lstm", "small")
    emb, h0, c0 = inputs[3:]
    with pytest.raises(ValueError, match="one device"):
        fused_lstm_chain(params, emb, tok, h0, c0.cpu())
    with pytest.raises(ValueError, match="float32"):
        fused_lstm_chain(params, emb.double(), tok, h0, c0)
    with pytest.raises(ValueError, match="tokens must lie"):
        fused_lstm_chain(params, emb, tok + 1000, h0, c0)
    odd = {k: v[:, :4 * 12] if v.dim() == 2 else v[:4 * 12] for k, v in params.items()}
    odd["wh"] = odd["wh"][:12]
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_lstm_chain(odd, emb, tok, h0[:, :12], c0[:, :12])
    gparams, ginputs, gtok, _ = _chain_setup(dev, "gru", "small")
    with pytest.raises(ValueError, match="integers"):
        fused_gru_chain(gparams, ginputs[4], gtok.float(), ginputs[5])


@pytest.mark.cuda
def test_chain_kernel_forced_on_cpu_raises(dev):
    params, inputs, tok, _ = _chain_setup(torch.device("cpu"), "gru", "small")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_gru_chain(params, inputs[4], tok, inputs[5], use_fused_kernel=True)
    lparams, linputs, ltok, _ = _chain_setup(torch.device("cpu"), "lstm", "small")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_lstm_chain(lparams, linputs[3], ltok, *linputs[4:], use_fused_kernel=True)


ROLLOUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


@pytest.mark.cuda
def test_threefry_kernel_matches_plain(dev):
    keys = prng.split(prng.PRNGKey(11), 3)
    shape = (N, CFG.vocab_size)
    before = prng.gumbel_noise.launches
    bits = prng.threefry_bits_kernel(keys, shape, dev).cpu().numpy().view(np.uint32)
    want_bits = torch.stack([prng.random_bits(k, shape) for k in keys]).numpy()
    np.testing.assert_array_equal(bits.astype(np.int64), want_bits)
    noise = prng.gumbel_noise(keys, shape, dev).cpu()
    assert prng.gumbel_noise.launches == before + 2
    want = prng.gumbel_noise(keys, shape, "cpu")
    ulp = torch.from_numpy(np.spacing(np.maximum(want.abs().numpy(), np.float32(1.0))))
    assert bool(((noise - want).abs() <= 4 * ulp).all())


def _rollout_case(dev, wd, curr):
    gen = torch.Generator().manual_seed(7)
    nets = a2c.init(gen, CFG)
    rparams = reward.init(gen, CFG)

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    nets, rparams = to_dev(nets), to_dev(rparams)
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.standard_normal((N, CFG.input_dim)).astype(np.float32)).to(dev)
    caps = torch.from_numpy(rng.integers(4, CFG.vocab_size, size=(N, T))).to(dev)
    caps[:, 0] = START_ID
    w = fr.prepare_rollout_weights(nets, wd)
    rw = fr.prepare_reward_weights(rparams, feats, caps[:, 0], wd)
    teach = caps[:, 1:].t().to(torch.int32).contiguous()
    noise = prng.gumbel_noise(prng.split(prng.PRNGKey(curr), T - 1), (N, CFG.vocab_size), dev)
    with torch.no_grad():
        states = fr.start_states(nets, CFG, feats, caps[:, 0])
    return (curr, teach, noise, rw, feats, *states, w), nets, rparams, feats, caps


@pytest.mark.cuda
@pytest.mark.parametrize("curr", [1, 4])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_rollout_kernels_match_plain(dev, wd, curr):
    args, _, _, feats, caps = _rollout_case(dev, wd, curr)
    before = fr.fused_rollout.fwd_launches
    k_val, k_logp, k_rew, tape = fr.rollout_forward_kernel(*args)
    torch.cuda.synchronize()
    assert fr.fused_rollout.fwd_launches == before + 1
    p_val, p_logp, p_rew, p_tape, gaps = fr.rollout_forward_plain(*args, margins=True)
    differ = tape.act != p_tape.act  # [S, N]
    bad = differ.any(dim=0)
    if bool(bad.any()):
        first = differ.int().argmax(dim=0)
        assert bool((gaps.gather(0, first[None])[0][bad] < NEAR_TIE).all()), "a non-tie differs"
    for name, a, b in (("values", k_val, p_val), ("log_probs", k_logp, p_logp),
                       ("rewards", k_rew, p_rew)):
        err = float((a - b)[:, ~bad].abs().max())
        assert err <= ROLLOUT_TOL[wd], f"{name}: max abs error {err:.3g}"
    # the reward stream on its own, on the kernel's actions and tokens,
    # equals the stream fused into the rollout
    rw = args[3]
    before = fr.fused_reward_stream.launches
    stream = fr.reward_stream(rw, tape.act, tape.tok)
    torch.cuda.synchronize()
    assert fr.fused_reward_stream.launches == before + 1
    torch.testing.assert_close(stream, k_rew, rtol=0, atol=1e-6)
    plain = fr.reward_stream(rw, tape.act, tape.tok, use_fused_kernel=False)
    assert float((stream - plain).abs().max()) <= ROLLOUT_TOL[wd]
    # backward, kernel and plain on one shared tape
    gen = torch.Generator().manual_seed(9)
    dval, dlogp = (torch.randn(tape.act.shape, generator=gen).to(dev) for _ in range(2))
    w = args[-1]
    before = fr.fused_rollout.bwd_launches
    got = fr.rollout_backward_kernel(tape, feats, w, dval, dlogp)
    torch.cuda.synchronize()
    assert fr.fused_rollout.bwd_launches == before + 1
    want = fr.rollout_backward_plain(tape, feats, w, dval, dlogp)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), i
        rel = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert rel <= CHAIN_TOL[wd], f"gradient {i}: relative error {rel:.3g}"


@pytest.mark.cuda
def test_a2c_loss_runs_each_rollout_kernel_once(dev):
    _, nets, rparams, feats, caps = _rollout_case(dev, torch.bfloat16, 1)
    params = {net: {k: ({kk: vv.requires_grad_() for kk, vv in v.items()} if isinstance(v, dict)
                        else v.requires_grad_()) for k, v in p.items()} for net, p in nets.items()}
    counts = (fr.fused_rollout.fwd_launches, fr.fused_rollout.bwd_launches,
              prng.gumbel_noise.launches)
    loss, _ = a2c_rollout_loss_fused(params, CFG, rparams, feats, caps, 1, T, prng.PRNGKey(0))
    loss.backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert (fr.fused_rollout.fwd_launches, fr.fused_rollout.bwd_launches,
            prng.gumbel_noise.launches) == (counts[0] + 1, counts[1] + 1, counts[2] + 1)


@pytest.mark.cuda
def test_rollout_wrappers_reject_bad_inputs(dev):
    args, _, _, _, _ = _rollout_case(dev, torch.float32, 1)
    curr, teach, noise, rw, feats, *states, w = args
    with pytest.raises(ValueError, match="noise"):
        fr.rollout_forward_kernel(curr, teach, noise[:, :, :-2], rw, feats, *states, w)
    with pytest.raises(ValueError, match="tokens must lie"):
        fr.rollout_forward_kernel(curr, teach + 1000, noise, rw, feats, *states, w)
    with pytest.raises(ValueError, match="actions and tokens"):
        fr.reward_stream(rw, teach + 1000, teach)
