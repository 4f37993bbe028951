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
rounding of h or of a gate gradient moves it by one bf16 step, 2^-8). Both
chains' persistent kernels are also held so at the batches, lengths and
widths that stress their launch plan (N in {1, 33, 2000}, T in {1, 16,
17}; H = 1024, whose slices shrink to 16 or 8 units, and H = 2048, whose
weights stream through the ring), at widths the wrappers pad (H = 12),
must give bit-identical results on two calls, must launch once per forward
and a fixed number of times per backward whatever T is, and must fail a
bad token through the device-side assertion.

The sampling kernel at the small widths, bf16 and float32 weights, for the
four filter variants (none, top-k, nucleus, both) at t = 0.7, and at V =
2000 (past the one-warp rows: one block per row): tokens equal
to the plain version's except where the plain version came within
``SAMPLE_NEAR_TIE`` of a tie at the first step where they part (its top-2
noisy gap, the k-th/(k+1)-th logit gap, the nucleus's boundary-value gap or
its mass margin over z; bf16 logits of the two differ by up to ~2e-4, see
``chip_smoke.py``). Greedy, beam and sampling also run a model the
wrappers pad (V = 61, E = H = F = 12) under the same rules.

The A2C kernels at the small widths: the threefry kernel's bits equal the
plain version's and its Gumbel noise lies within 4 ulps of it (two
``logf``s, see ``test_torch_prng.py``); the reward stream and the rollout
forward within ``ROLLOUT_TOL`` (max abs error, on the rows whose actions
agree; a row may part only at a near-tie of the noisy logits); the rollout
backward, run by kernel and plain on one shared forward tape, within
``CHAIN_TOL`` by relative Frobenius error (its recurrences are the LSTM
chain's backward).
"""

import os
import subprocess
import sys

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
    WARP_VOCAB,
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
    with pytest.raises(ValueError, match="features"):
        fused_sample_decode(gw, f[:, :-1].contiguous(), s, key, T)


def _decode_setup(dev, wd, cfg, n=N, seed=0):
    params = a2c.init(torch.Generator().manual_seed(seed), cfg)
    on_dev = {net: {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                        else v.to(dev)) for k, v in p.items()} for net, p in params.items()}
    gw = prepare_greedy_weights(on_dev["policy"], wd)
    bw = prepare_beam_weights(gw, on_dev["value"])
    feats = np.random.default_rng(seed + 5).standard_normal((n, cfg.input_dim)).astype(np.float32)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    return gw, bw, torch.from_numpy(feats).to(dev), start


def _check_sampled(k_tok, p_tok, margins, wd):
    bad = _differing_rows(k_tok, p_tok)
    first = (k_tok != p_tok).int().argmax(dim=1) - 1
    assert bool((margins[bad].gather(1, first[bad, None])[:, 0] < SAMPLE_NEAR_TIE[wd]).all()), \
        "a non-tie row differs"


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(0, None), (40, 0.9)])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_sample_kernel_past_one_warp_per_row(dev, wd, k, p):
    """V = 2000: one block per row, block-wide sums in a fixed order."""
    cfg = NetConfig(vocab_size=2000, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
    assert cfg.vocab_size > WARP_VOCAB
    gw, _, f, s = _decode_setup(dev, wd, cfg, n=40)
    key = prng.PRNGKey(6)
    before = fused_sample_decode.launches
    k_tok = fused_sample_decode(gw, f, s, key, T, temperature=0.8, top_k=k, top_p=p)
    torch.cuda.synchronize()
    assert fused_sample_decode.launches == before + 1
    p_tok, margins = sample_decode_plain(gw, f, s, key, T, 0.8, k, p, margins=True)
    assert k_tok.shape == (40, T) and int(k_tok.max()) < 2000
    _check_sampled(k_tok, p_tok, margins, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_decode_kernels_take_widths_they_pad(dev, wd):
    """An odd vocabulary and E = H = F = 12: greedy, beam and sampling run
    on padded weights and hold their plain versions' tokens."""
    cfg = NetConfig(vocab_size=61, input_dim=12, wordvec_dim=12, hidden_dim=12, max_seq_len=7)
    gw, bw, f, s = _decode_setup(dev, wd, cfg)
    assert gw.widths == (12, 12, 12) and gw.wo.shape == (16, 62)
    k_tok = fused_greedy_decode(gw, f, s, T)
    p_tok, gaps = greedy_decode_plain(gw, f, s, T, margins=True)
    bad = _differing_rows(k_tok, p_tok)
    assert bool((gaps[bad].min(dim=1).values < NEAR_TIE).all()) and int(k_tok.max()) < 61
    k_tok, k_sc = fused_beam_search(bw, f, s, T, BEAM)
    p_tok, p_sc, gaps = beam_search_plain(bw, f, s, T, BEAM, margins=True)
    bad = _differing_rows(k_tok, p_tok)
    assert bool((gaps[bad].min(dim=1).values < NEAR_TIE).all()) and int(k_tok.max()) < 61
    torch.testing.assert_close(k_sc[~bad], p_sc[~bad], rtol=0, atol=SCORE_TOL[wd])
    key = prng.PRNGKey(4)
    k_tok = fused_sample_decode(gw, f, s, key, T, temperature=0.7, top_k=5, top_p=0.8)
    p_tok, margins = sample_decode_plain(gw, f, s, key, T, 0.7, 5, 0.8, margins=True)
    assert int(k_tok.max()) < 61
    _check_sampled(k_tok, p_tok, margins, wd)
    # the x-gate table pads an odd embedding width and column count itself
    emb = bw.value.emb[:, :12].contiguous()
    w = bw.value.w[:12, :45].contiguous()
    torch.testing.assert_close(token_gate_table(emb, w), token_gate_table_plain(emb, w),
                               rtol=1e-5, atol=1e-5)


CHAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CHAIN_SHAPES = {"small": (20, 7, 16, 16, 60), "coco": (512, 17, 512, 512, 1004)}


def _chain_setup(dev, kind, shape):
    """Chain operands from a seed; ``shape`` is a CHAIN_SHAPES key or an
    (N, T, E, H, V) tuple."""
    n, t, e, h, v = CHAIN_SHAPES.get(shape, shape)
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
    gparams, ginputs, gtok, _ = _chain_setup(dev, "gru", "small")
    with pytest.raises(ValueError, match="integers"):
        fused_gru_chain(gparams, ginputs[4], gtok.float(), ginputs[5])


@pytest.mark.cuda
def test_chain_bad_token_fails_on_the_card(dev):
    """An out-of-range token fails the wrappers' device-side assertion (no
    host sync in the call): the process's next synchronisation raises. A
    failed device assertion ends the CUDA context, so it runs in a child."""
    script = (
        "import torch\n"
        "from image_captioning_through_rl_tpu_torch.models.initializers import "
        "embedding_init, lstm_init\n"
        "from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "p = {k: v.cuda() for k, v in lstm_init(gen, 16, 16).items()}\n"
        "emb = embedding_init(gen, 60, 16).cuda()\n"
        "h = torch.zeros((4, 16), device='cuda')\n"
        "fused_lstm_chain(p, emb, torch.full((4, 3), 60, device='cuda'), h, h)\n"
        "torch.cuda.synchronize()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode != 0 and "assert" in done.stderr.lower(), done.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 16, 17])
@pytest.mark.parametrize("n", [1, 33, 2000])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_lstm_chain_kernels_match_plain_at_plan_edges(dev, wd, n, steps):
    """The persistent kernels at batches that leave a row tile ragged (1,
    33), that loop over row tiles inside a step (2000), and at one step."""
    case = _chain_setup(dev, "lstm", (n, steps, 512, 512, 1004))
    got = _chain_run("lstm", *case, wd, None)
    torch.cuda.synchronize()
    want = _chain_run("lstm", *case, wd, False)
    for name, a, b in zip(["hs", "wi", "wh", "b", "embedding", "h0", "c0"], got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        rel = float((a - b).norm() / b.norm())
        assert rel <= CHAIN_TOL[wd], f"N={n} T={steps} {name}: relative error {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_lstm_chain_kernels_are_deterministic(dev, wd):
    """Two identical calls give bit-identical hs and gradients (fixed-order
    sums, no float atomics; the embedding gradient's index_add_ runs in
    PyTorch's deterministic mode here)."""
    case = _chain_setup(dev, "lstm", (512, 16, 512, 512, 1004))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first, second = (_chain_run("lstm", *case, wd, None) for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(False)
    for name, a, b in zip(["hs", "wi", "wh", "b", "embedding", "h0", "c0"], first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_lstm_chain_launches_do_not_grow_with_steps(dev):
    """The forward is one chain kernel launch besides the x-gate table, the
    backward one recurrence launch and two wgmma products, at T = 1 and 16."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for steps in (1, 16):
        case = _chain_setup(dev, "lstm", (64, steps, 512, 512, 1004))
        _chain_run("lstm", *case, torch.bfloat16, None)
        torch.cuda.synchronize()
        before = fused_lstm_chain.fwd_launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _chain_run("lstm", *case, torch.bfloat16, None)
            torch.cuda.synchronize()
        assert fused_lstm_chain.fwd_launches == before + 1
        names = [e.key for e in prof.key_averages() for _ in range(e.count)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        counts[steps] = {k: sum(k in name for name in names)
                         for k in ("lstm_fwd_kernel", "lstm_bwd_kernel", "wgmma_gemm_kernel",
                                   "linear_kernel")}
    assert counts[1] == counts[16] == {"lstm_fwd_kernel": 1, "lstm_bwd_kernel": 1,
                                       "wgmma_gemm_kernel": 2, "linear_kernel": 1}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 16, 17])
@pytest.mark.parametrize("n", [1, 33, 2000])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_gru_chain_kernels_match_plain_at_plan_edges(dev, wd, n, steps):
    """The GRU's persistent kernels at COCO width, at the batches and
    lengths of the LSTM's plan-edge test."""
    case = _chain_setup(dev, "gru", (n, steps, 512, 512, 1004))
    got = _chain_run("gru", *case, wd, None)
    torch.cuda.synchronize()
    want = _chain_run("gru", *case, wd, False)
    for name, a, b in zip(["hs", "wi", "wh", "bi", "bh", "embedding", "h0"], got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        rel = float((a - b).norm() / b.norm())
        assert rel <= CHAIN_TOL[wd], f"N={n} T={steps} {name}: relative error {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 17, 1024), (33, 1, 1024), (33, 17, 1024), (33, 17, 2048),
                                   (9, 3, 4096), (20, 7, 12)])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_chain_kernels_match_plain_at_wide_and_padded_widths(dev, kind, wd, shape):
    """H = 1024 (slices of 16 or 8 units), H = 2048 (weights streamed
    through the ring), H = 4096 (streamed, each block walking several
    slices) and H = 12 (padded to 16 by the wrapper), E = H, V = 1004."""
    n, steps, width = shape
    chain = fused_lstm_chain if kind == "lstm" else fused_gru_chain
    params, inputs, tok, dhs = _chain_setup(dev, kind, (n, steps, width, width, 1004))
    before = (chain.fwd_launches, chain.bwd_launches)
    got = _chain_run(kind, params, inputs, tok, dhs, wd, None)
    torch.cuda.synchronize()
    assert (chain.fwd_launches, chain.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _chain_run(kind, params, inputs, tok, dhs, wd, False)
    for name, a, b in zip(["hs", *params, "embedding", "h0", "c0"], got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        rel = float((a - b).norm() / b.norm())
        assert rel <= CHAIN_TOL[wd], f"{kind} {shape} {name}: relative error {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("width", [512, 2048])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_gru_chain_kernels_are_deterministic(dev, wd, width):
    """Two identical GRU calls give bit-identical hs and gradients, with
    stationary and with streamed weights."""
    case = _chain_setup(dev, "gru", (256, 9, width, width, 1004))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first, second = (_chain_run("gru", *case, wd, None) for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(False)
    for name, a, b in zip(["hs", "wi", "wh", "bi", "bh", "embedding", "h0"], first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_gru_chain_launches_do_not_grow_with_steps(dev):
    """The forward is one chain kernel launch besides the x-gate table; the
    backward one recurrence launch, two wgmma launches (dwi and dwh in one,
    dx) and two column sums (two launches each), at T = 1 and 17; no
    view_kernel."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for steps in (1, 17):
        case = _chain_setup(dev, "gru", (64, steps, 512, 512, 1004))
        _chain_run("gru", *case, torch.bfloat16, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _chain_run("gru", *case, torch.bfloat16, None)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() for _ in range(e.count)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        counts[steps] = {k: sum(k in name for name in names)
                         for k in ("gru_fwd_kernel", "gru_bwd_kernel", "wgmma_gemm_kernel",
                                   "linear_kernel", "colsum_part_kernel", "view_kernel")}
    assert counts[1] == counts[17] == {"gru_fwd_kernel": 1, "gru_bwd_kernel": 1,
                                       "wgmma_gemm_kernel": 2, "linear_kernel": 1,
                                       "colsum_part_kernel": 2, "view_kernel": 0}, counts


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
def test_rollout_takes_widths_it_pads(dev):
    """E = H = F = 12 and V = 61 (float32 weights): the rollout pads the
    networks, features and start states on the kernel route; its actions,
    values, log-probs and rewards, and the parameters' gradients, hold the
    plain route's (which runs unpadded) within ROLLOUT_TOL and CHAIN_TOL."""
    cfg = NetConfig(vocab_size=61, input_dim=12, wordvec_dim=12, hidden_dim=12, max_seq_len=7)
    gen = torch.Generator().manual_seed(12)
    nets, rparams = a2c.init(gen, cfg), reward.init(gen, cfg)

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    nets, rparams = to_dev(nets), to_dev(rparams)
    rng = np.random.default_rng(13)
    feats = torch.from_numpy(rng.standard_normal((N, 12)).astype(np.float32)).to(dev)
    caps = torch.from_numpy(rng.integers(4, 61, size=(N, T))).to(dev)
    caps[:, 0] = START_ID
    out = {}
    for flag in (None, False):
        params = {net: {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.clone().requires_grad_())
                        for k, v in p.items()} for net, p in nets.items()}
        values, logp, act, tok, rewards = fr.fused_rollout(
            params, cfg, feats, caps, 3, prng.PRNGKey(1), weight_dtype=torch.float32,
            reward_params=rparams, use_fused_kernel=flag)
        leaves = fr.rollout_leaves(params)
        out[flag] = ([values.detach(), logp.detach(), act, tok, rewards],
                     torch.autograd.grad(values.sum() + logp.sum(), leaves))
    (k_out, k_grads), (p_out, p_grads) = out[None], out[False]
    assert torch.equal(k_out[2], p_out[2]) and torch.equal(k_out[3], p_out[3])
    for a, b in zip(k_out[:2] + k_out[4:], p_out[:2] + p_out[4:]):
        assert float((a - b).abs().max()) <= ROLLOUT_TOL[torch.float32]
    for i, (a, b) in enumerate(zip(k_grads, p_grads)):
        rel = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert rel <= CHAIN_TOL[torch.float32], f"gradient {i}: relative error {rel:.3g}"


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
