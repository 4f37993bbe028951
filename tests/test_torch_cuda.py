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

The beam kernel (one persistent cooperative launch for all T - 1 steps) is
held so at beams 1 to 8, at batches whose N B and N B^2 rows fill no whole
row tile, at COCO width (stationary weight slices) and at H = 1024 (the
weights stream through the ring); two calls give the same bits, a call is
one beam_kernel launch whatever T (beside one small launch that asserts the
start tokens' range), and its optional phase clock marks every phase. An
out-of-range start token fails the greedy, beam and sampling wrappers'
device-side assertion (in a child process: it ends the CUDA context).

The greedy and sampling decodes are one persistent cooperative launch each
(csrc/decode.cu, beside one small launch that asserts the start tokens'
range, whatever T). The sampling kernel at the small widths, bf16 and
float32 weights, for the four filter variants (none, top-k, nucleus, both)
at t = 0.7, and at V = 2000 (past the rows a warp holds in registers: the
row walked in L2): tokens equal
to the plain version's except where the plain version came within
``SAMPLE_NEAR_TIE`` of a tie at the first step where they part (its top-2
noisy gap, the k-th/(k+1)-th logit gap, the nucleus's boundary-value gap or
its mass margin over z; bf16 logits of the two differ by up to ~2e-4, see
``chip_smoke.py``). Greedy, beam and sampling also run a model the
wrappers pad (V = 61, E = H = F = 12) under the same rules. Both decodes
are also held so at N = 1, 4 and 77 (no whole row tile) and at H = 1024
(the weights stream through the ring), give the same bits on two calls,
and their optional phase clock marks every phase.

The A2C kernels at the small widths: the threefry kernel's bits equal the
plain version's and its Gumbel noise lies within 4 ulps of it (two
``logf``s, see ``test_torch_prng.py``); the reward stream and the rollout
forward within ``ROLLOUT_TOL`` (max abs error, on the rows whose actions
agree; a row may part only at a near-tie of the noisy logits); the rollout
backward, run by kernel and plain on one shared forward tape, within
``CHAIN_TOL`` by relative Frobenius error (its recurrences are the LSTM
chain's backward). The one-launch rollout forward is also held so at the
widths its plan treats apart (COCO width, H = 1024 streamed, V = 2000, a
padded width, N = 1, S = 1; bf16 and f32; curr 1 and 8; with and without
the reward stream), must give bit-identical results on two calls and be one
`rollout_fwd_kernel` launch beside its two x-gate tables; the bf16 x-gate
table runs on wgmma and matches its plain version within 1e-4. The reward
stream alone (the rollout forward's reward-only mode) is held to its plain
version within ``ROLLOUT_TOL`` at COCO width, S = 1 and 2, N = 33 (no whole
row tile), H = 1024 and a padded width, gives the same bits on two calls,
is one `reward_stream_kernel` launch a call whatever S (counted in the
rollout forward's profiler window), marks every phase on its optional
clock, and gives the fused-in stream's rewards within 1e-6 at COCO width. The rollout
backward (the heads on wgmma with a fixed-order split-K, both recurrences in
one launch) is held to CHAIN_TOL at COCO width, H = 1024 and 2048, V = 2000,
a padded width, n = 12 and 500, curr 1 and 8, bf16 and f32; two calls give
the same bits (the embedding gradient's index_add_ in PyTorch's
deterministic mode); and a bf16 call launches its own ten kernels, none a
view_kernel or linear_kernel, whatever S.

The evaluation pass (``train.loops.test_a2c_network``) on the card runs the
beam kernel once a decode group; against the plain beam on the same bf16
weights its real and url dumps are byte-identical and a generated line may
part only at a near-tie of the plain beam (the COCO-width run of 40504
draws is ``chip_smoke.py`` phase 20's).
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
from image_captioning_through_rl_tpu_torch.ops import fused_beam as fb
from image_captioning_through_rl_tpu_torch.ops import fused_decode as fd
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
@pytest.mark.parametrize("n,beam", [(N, BEAM), (1, 1), (5, 2), (9, 8), (67, 5)])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_beam_kernel_matches_plain(dev, wd, n, beam):
    """Beams 1 to 8 and batches whose N B and N B^2 rows fill no whole row
    tile; two calls give the same bits (every sum in a fixed order)."""
    _, bw, f, s = _setup(dev, wd)
    f = torch.from_numpy(np.random.default_rng(n).standard_normal((n, CFG.input_dim))
                         .astype(np.float32)).to(dev)
    s = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    before = fused_beam_search.launches
    k_tok, k_sc = fused_beam_search(bw, f, s, T, beam)
    torch.cuda.synchronize()
    assert fused_beam_search.launches == before + 1
    again = fused_beam_search(bw, f, s, T, beam)
    assert torch.equal(again[0], k_tok) and torch.equal(again[1], k_sc)
    p_tok, p_sc, gaps = beam_search_plain(bw, f, s, T, beam, margins=True)
    bad = _differing_rows(k_tok, p_tok)
    assert k_tok.shape == (n, beam, T) and k_sc.shape == (n, beam)
    assert bool((gaps[bad].min(dim=1).values < NEAR_TIE).all()), "a non-tie row differs"
    torch.testing.assert_close(k_sc[~bad], p_sc[~bad], rtol=0, atol=SCORE_TOL[wd])


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(dev):
    gw, bw, f, s = _setup(dev, torch.float32)
    with pytest.raises(ValueError, match="start_tokens"):
        fused_greedy_decode(gw, f, s.long(), T)
    with pytest.raises(ValueError, match="features"):
        fused_beam_search(bw, f.double(), s, T, BEAM)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["greedy", "beam", "sample"])
def test_decode_bad_start_token_fails_on_the_card(dev, kind):
    """An out-of-range start token fails the decode wrappers' device-side
    assertion (no host sync in the call, so a decode can be graph-captured):
    the process's next synchronisation raises. A failed device assertion ends
    the CUDA context, so it runs in a child."""
    call = {"greedy": "fused_greedy_decode(gw, f, s, 7)",
            "beam": "fused_beam_search(bw, f, s, 7, 3)",
            "sample": "fused_sample_decode(gw, f, s, prng.PRNGKey(0), 7)"}[kind]
    script = (
        "import torch\n"
        "from image_captioning_through_rl_tpu_torch.config import NetConfig\n"
        "from image_captioning_through_rl_tpu_torch.models import a2c\n"
        "from image_captioning_through_rl_tpu_torch.ops import prng\n"
        "from image_captioning_through_rl_tpu_torch.ops.fused_beam import "
        "fused_beam_search, prepare_beam_weights\n"
        "from image_captioning_through_rl_tpu_torch.ops.fused_decode import "
        "fused_greedy_decode, prepare_greedy_weights\n"
        "from image_captioning_through_rl_tpu_torch.ops.fused_sample import fused_sample_decode\n"
        "cfg = NetConfig(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, "
        "max_seq_len=7)\n"
        "p = a2c.init(torch.Generator().manual_seed(0), cfg)\n"
        "cuda = lambda t: {k: cuda(v) for k, v in t.items()} if isinstance(t, dict) "
        "else t.cuda()\n"
        "gw = prepare_greedy_weights(cuda(p['policy']), torch.float32)\n"
        "bw = prepare_beam_weights(gw, cuda(p['value']))\n"
        "f = torch.zeros((4, 16), device='cuda')\n"
        "s = torch.full((4,), 60, dtype=torch.int32, device='cuda')\n"
        f"{call}\n"
        "torch.cuda.synchronize()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode != 0 and "assert" in done.stderr.lower(), done.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 1024])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_beam_kernel_matches_plain_at_plan_widths(dev, wd, hidden):
    """COCO width (stationary slices) and H = 1024 (the weights stream
    through the ring), N = 127, beam 5."""
    cfg = NetConfig(vocab_size=1004, input_dim=512, wordvec_dim=512, hidden_dim=hidden,
                    max_seq_len=17)
    _, bw, f, s = _decode_setup(dev, wd, cfg, n=127)
    k_tok, k_sc = fused_beam_search(bw, f, s, 17, 5)
    p_tok, p_sc, gaps = beam_search_plain(bw, f, s, 17, 5, margins=True)
    bad = _differing_rows(k_tok, p_tok)
    assert int(bad.sum()) <= 2 and bool((gaps[bad].min(dim=1).values < NEAR_TIE).all())
    torch.testing.assert_close(k_sc[~bad], p_sc[~bad], rtol=0, atol=SCORE_TOL[wd])


@pytest.mark.cuda
def test_beam_search_is_one_launch(dev):
    """One beam_kernel launch per call, whatever T, beside one small launch
    that asserts the start tokens' range; none of the per-step kernels it
    replaced."""
    from torch.profiler import ProfilerActivity, profile

    _, bw, f, s = _setup(dev, torch.bfloat16)
    for steps in (2, T):
        fused_beam_search(bw, f, s, steps, BEAM)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_beam_search(bw, f, s, steps, BEAM)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() for _ in range(e.count)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {k: sum(k in name for name in names)
                  for k in ("beam_kernel", "beam_start_check_kernel", "linear_kernel",
                            "lstm_kernel", "lse_topb_kernel", "lstm_expand_kernel",
                            "value_mlp_kernel", "select_reorder_kernel")}
        assert counts == {"beam_kernel": 1, "beam_start_check_kernel": 1, "linear_kernel": 0,
                          "lstm_kernel": 0, "lse_topb_kernel": 0, "lstm_expand_kernel": 0,
                          "value_mlp_kernel": 0, "select_reorder_kernel": 0}, (steps, counts)
        assert len(names) == 2, names


@pytest.mark.cuda
def test_beam_clock_marks_every_phase(dev):
    """The optional clock: every mark set, in order, and the outputs
    bit-equal to a call without it."""
    _, bw, f, s = _setup(dev, torch.bfloat16)
    clock = torch.zeros(fb.beam_clock_slots(T), dtype=torch.int64, device=dev)
    timed = fused_beam_search(bw, f, s, T, BEAM, clock=clock)
    plain = fused_beam_search(bw, f, s, T, BEAM)
    marks = clock.cpu()
    assert bool((marks > 0).all()) and bool((marks[1:] >= marks[:-1]).all())
    assert torch.equal(timed[0], plain[0]) and torch.equal(timed[1], plain[1])


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


def _check_greedy(k_tok, p_tok, gaps):
    bad = _differing_rows(k_tok, p_tok)
    assert bool((gaps[bad].min(dim=1).values < NEAR_TIE).all()), "a non-tie row differs"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 77])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_decode_kernels_at_partial_row_tiles_are_bit_stable(dev, wd, n):
    """N = 1, 4 and 77 fill no whole 64-row tile: greedy and the four sampling
    variants hold their plain versions, and two calls give the same bits."""
    gw = _setup(dev, wd)[0]
    f = torch.from_numpy(np.random.default_rng(n).standard_normal((n, CFG.input_dim))
                         .astype(np.float32)).to(dev)
    s = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    k_tok = fused_greedy_decode(gw, f, s, T)
    assert torch.equal(fused_greedy_decode(gw, f, s, T), k_tok)
    _check_greedy(k_tok, *greedy_decode_plain(gw, f, s, T, margins=True))
    key = prng.PRNGKey(n)
    for k, p in ((0, None), (5, None), (0, 0.8), (5, 0.8)):
        k_tok = fused_sample_decode(gw, f, s, key, T, 0.7, k, p)
        assert torch.equal(fused_sample_decode(gw, f, s, key, T, 0.7, k, p), k_tok)
        p_tok, margins = sample_decode_plain(gw, f, s, key, T, 0.7, k, p, margins=True)
        assert k_tok.shape == (n, T) and bool((k_tok[:, 0] == START_ID).all())
        _check_sampled(k_tok, p_tok, margins, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_decode_kernels_with_streamed_weights(dev, wd):
    """H = 1024 at COCO's other widths: no slice width gives every slice a
    block, so the weights stream through the ring; N = 77, bit-stable."""
    cfg = NetConfig(vocab_size=1004, input_dim=512, wordvec_dim=512, hidden_dim=1024,
                    max_seq_len=T)
    gw, _, f, s = _decode_setup(dev, wd, cfg, n=77)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for pick in (fd.PICK_ARGMAX, fd.PICK_GUMBEL, fd.PICK_FILTER):
        assert fd.decode_plan(77, 512, 1024, 1004, pick, wd, sms)["stream"]
    k_tok = fused_greedy_decode(gw, f, s, T)
    assert torch.equal(fused_greedy_decode(gw, f, s, T), k_tok)
    _check_greedy(k_tok, *greedy_decode_plain(gw, f, s, T, margins=True))
    key = prng.PRNGKey(8)
    for k, p in ((0, None), (40, 0.9)):
        k_tok = fused_sample_decode(gw, f, s, key, T, 0.8, k, p)
        assert torch.equal(fused_sample_decode(gw, f, s, key, T, 0.8, k, p), k_tok)
        _check_sampled(k_tok, *sample_decode_plain(gw, f, s, key, T, 0.8, k, p, margins=True),
                       wd)


@pytest.mark.cuda
def test_decodes_are_one_launch_whatever_the_length(dev):
    """Greedy and sampling (unfiltered, filtered) at T = 2, 7 and 40: one
    decode_kernel a call beside one small launch that asserts the start
    tokens' range; none of the per-step kernels it replaced. Counted by
    torch.profiler in one window (the tracer misses launches in a process
    that opens many windows) over three rounds of the nine calls, after the
    card idled 50 ms in it, rounded to whole launches a call (a window may
    miss its first launches)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    gw, _, f, s = _setup(dev, torch.bfloat16)
    key = prng.PRNGKey(1)
    calls = [call for steps in (2, T, 40) for call in (
        lambda steps=steps: fused_greedy_decode(gw, f, s, steps),
        lambda steps=steps: fused_sample_decode(gw, f, s, key, steps),
        lambda steps=steps: fused_sample_decode(gw, f, s, key, steps, 0.7, 5, 0.8))]
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(3):
            for call in calls:
                call()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            counts[e.key] = counts.get(e.key, 0) + e.count
    per_call = {k: round(v / (3 * len(calls))) for k, v in counts.items()}
    per_call = {k: v for k, v in per_call.items() if v}
    assert sorted(per_call.values()) == [1, 1], per_call
    assert any("decode_kernel" in k and "check" not in k for k in per_call), per_call
    assert any("decode_start_check_kernel" in k for k in per_call), per_call
    for gone in ("lstm_kernel", "linear_kernel", "argmax_rows_kernel", "sample_rows_kernel",
                 "sample_wide_kernel", "fill_start_kernel"):
        assert not any(gone in k for k in counts), (gone, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["greedy", "sample"])
def test_decode_clock_marks_every_phase(dev, kind):
    """The optional clock: every mark set, in order, phase A's head and cell
    tiles counted (T - 1 steps of the head's, T - 2 of the cell's), and the
    tokens bit-equal to a call without it."""
    gw, _, f, s = _setup(dev, torch.bfloat16)
    clock = torch.zeros(fd.decode_clock_slots(T), dtype=torch.int64, device=dev)
    if kind == "greedy":
        timed, plain = (fused_greedy_decode(gw, f, s, T, clock=c) for c in (clock, None))
    else:
        timed, plain = (fused_sample_decode(gw, f, s, prng.PRNGKey(2), T, 0.7, 5, 0.8, clock=c)
                        for c in (clock, None))
    marks, tiles = clock.cpu()[:2 + 4 * (T - 1)], clock.cpu()[2 + 4 * (T - 1):]
    assert bool((marks > 0).all()) and bool((marks[1:] >= marks[:-1]).all())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fd.decode_plan(N, CFG.input_dim, CFG.hidden_dim, CFG.vocab_size,
                          fd.PICK_ARGMAX if kind == "greedy" else fd.PICK_FILTER,
                          torch.bfloat16, sms)
    heads, tiles_per_slice = plan["head_slices"], plan["tiles"]
    cells = plan["slices"] - heads
    assert tiles[1] == (T - 1) * heads * tiles_per_slice and tiles[0] > 0
    assert tiles[3] == (T - 2) * cells * tiles_per_slice and tiles[2] > 0
    assert torch.equal(timed, plain)


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
    """V = 2000: a filtered row past what a warp holds in registers, walked in
    L2 (every sum in a fixed order)."""
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
    """The forward is one chain kernel launch besides the x-gate table (a
    wgmma product), the backward one recurrence launch and two wgmma
    products, at T = 1 and 16."""
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
                                       "wgmma_gemm_kernel": 3, "linear_kernel": 0}, counts


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
    """The forward is one chain kernel launch besides the x-gate table (a
    wgmma product); the backward one recurrence launch, two wgmma launches
    (dwi and dwh in one, dx) and two column sums (two launches each), at
    T = 1 and 17; no view_kernel."""
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
                                       "wgmma_gemm_kernel": 3, "linear_kernel": 0,
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
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("gates", [3, 4])
@pytest.mark.parametrize("vocab,emb_dim", [(1004, 512), (2000, 512), (1001, 500)])
def test_token_gate_table_on_wgmma_matches_plain(dev, vocab, emb_dim, gates, bias):
    """bf16 weights: the table runs on wgmma (emb K-major, wi read MN-major
    where it lies in [wi; wh]), the bias in its epilogue; an odd vocabulary
    is masked rows, E = 500 is padded by the wrapper. (chip_smoke.py's
    profiles show the launch as wgmma_gemm_kernel.)"""
    gen = torch.Generator().manual_seed(vocab + gates)
    hidden = 512
    emb = torch.randn((vocab, emb_dim), generator=gen).to(dev).to(torch.bfloat16)
    w = (0.05 * torch.randn((emb_dim + hidden, gates * hidden), generator=gen)).to(dev)
    w = w.to(torch.bfloat16)
    b = torch.randn((gates * hidden,), generator=gen).to(dev) if bias else None
    before = token_gate_table.launches
    got = token_gate_table(emb, w, b)
    torch.cuda.synchronize()
    assert token_gate_table.launches == before + 1
    want = token_gate_table_plain(emb, w, b)
    assert got.shape == want.shape == (vocab, gates * hidden)
    assert float((got - want).abs().max()) <= 1e-4


# (N, E = H = F, V, S): COCO width; H = 1024, whose weights stream while each
# block walks all eight row tiles; V = 2000; widths the wrappers pad; one row;
# one step
ROLLOUT_SHAPES = {"coco": (512, 512, 1004, 16), "h1024": (512, 1024, 1004, 5),
                  "v2000": (128, 512, 2000, 8), "padded": (100, 500, 1001, 6),
                  "n1": (1, 512, 1004, 16), "s1": (33, 512, 1004, 1)}


def _wide_rollout_case(dev, wd, curr, shape, with_reward, seed=21):
    n, width, vocab, steps = shape
    cfg = NetConfig(vocab_size=vocab, input_dim=width, wordvec_dim=width, hidden_dim=width,
                    max_seq_len=steps + 1)
    gen = torch.Generator().manual_seed(seed)

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    nets, rparams = to_dev(a2c.init(gen, cfg)), to_dev(reward.init(gen, cfg))
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32)).to(dev)
    caps = torch.from_numpy(rng.integers(4, vocab, size=(n, steps + 1))).to(dev)
    caps[:, 0] = START_ID
    with torch.no_grad():
        states = fr.start_states(nets, cfg, feats, caps[:, 0])
        rw = fr.prepare_reward_weights(rparams, feats, caps[:, 0], wd) if with_reward else None
        if width % 8:
            nets, feats, states = fr.pad_rollout_inputs(nets, feats, states)
    teach = caps[:, 1:].t().to(torch.int32).contiguous()
    noise = prng.gumbel_noise(prng.split(prng.PRNGKey(seed), steps), (n, vocab), dev)
    return (curr, teach, noise, rw, feats, *states, fr.prepare_rollout_weights(nets, wd))


@pytest.mark.cuda
@pytest.mark.parametrize("with_reward", [True, False])
@pytest.mark.parametrize("curr", [1, 8])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
@pytest.mark.parametrize("shape", list(ROLLOUT_SHAPES))
def test_rollout_forward_kernel_matches_plain_at_plan_widths(dev, shape, wd, curr, with_reward):
    """The one-launch forward against the plain version at the widths its
    plan treats differently: actions equal except at near-ties, values,
    log-probs and rewards within ROLLOUT_TOL, the teacher tokens placed; the
    backward on its tape within CHAIN_TOL."""
    args = _wide_rollout_case(dev, wd, curr, ROLLOUT_SHAPES[shape], with_reward)
    k_val, k_logp, k_rew, tape = fr.rollout_forward_kernel(*args)
    torch.cuda.synchronize()
    p_val, p_logp, p_rew, p_tape, gaps = fr.rollout_forward_plain(*args, margins=True)
    steps = tape.act.shape[0]
    assert torch.equal(tape.tok[:min(curr, steps + 1) - 1], args[1][:min(curr, steps + 1) - 1])
    differ = tape.act != p_tape.act
    bad = differ.any(dim=0)
    if bool(bad.any()):
        first = differ.int().argmax(dim=0)
        assert bool((gaps.gather(0, first[None])[0][bad] < NEAR_TIE).all()), "a non-tie differs"
    pairs = [("values", k_val, p_val), ("log_probs", k_logp, p_logp)]
    if with_reward:
        pairs.append(("rewards", k_rew, p_rew))
    else:
        assert k_rew is None
    for name, a, b in pairs:
        err = float((a - b)[:, ~bad].abs().max()) if bool((~bad).any()) else 0.0
        assert err <= ROLLOUT_TOL[wd], f"{name}: max abs error {err:.3g}"
    gen = torch.Generator().manual_seed(9)
    dval, dlogp = (torch.randn(tape.act.shape, generator=gen).to(dev) for _ in range(2))
    got = fr.rollout_backward_kernel(tape, args[4], args[-1], dval, dlogp)
    torch.cuda.synchronize()
    want = fr.rollout_backward_plain(tape, args[4], args[-1], dval, dlogp)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), i
        rel = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert rel <= CHAIN_TOL[wd], f"gradient {i}: relative error {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_rollout_forward_kernel_is_deterministic(dev, wd):
    """Two calls on the same inputs give bit-identical outputs and tape (every
    sum in a fixed order, the combine included)."""
    args = _wide_rollout_case(dev, wd, 4, ROLLOUT_SHAPES["coco"], True)
    first, second = (fr.rollout_forward_kernel(*args) for _ in range(2))
    for a, b in zip(first[:3] + tuple(first[3]), second[:3] + tuple(second[3])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_reward", [True, False])
def test_rollout_forward_clock_marks_every_phase(dev, with_reward):
    """The optional clock: every mark of every pass set, in order, and the
    outputs bit-equal to a call without it."""
    args = _wide_rollout_case(dev, torch.bfloat16, 1, ROLLOUT_SHAPES["coco"], with_reward)
    steps = args[1].shape[0]
    clock = torch.zeros(fr.rollout_clock_slots(steps), dtype=torch.int64, device=dev)
    timed = fr.rollout_forward_kernel(*args, clock=clock)
    plain = fr.rollout_forward_kernel(*args)
    marks = clock.cpu()[:2 + 4 * (steps + with_reward)]
    assert bool((marks > 0).all()) and bool((marks[1:] >= marks[:-1]).all())
    assert bool((clock.cpu()[len(marks):] == 0).all())
    for a, b in zip(timed[:3] + tuple(timed[3]), plain[:3] + tuple(plain[3])):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_reward", [True, False])
def test_rollout_forward_is_one_launch(dev, with_reward):
    """One rollout_fwd_kernel launch per call beside the two x-gate tables
    (wgmma), whatever S; none of the old per-step kernels. With the reward
    stream, the stream alone on the rollout's actions and tokens is one
    reward_stream_kernel launch, none of its old host loop's kernels (in the
    same window: late in a process that has opened many windows, the tracer
    was seen to lose a later window's events whole)."""
    from torch.profiler import ProfilerActivity, profile

    for shape in ("coco", "s1"):
        args = _wide_rollout_case(dev, torch.bfloat16, 1, ROLLOUT_SHAPES[shape], with_reward)
        fr.rollout_forward_kernel(*args)
        torch.cuda.synchronize()
        before = fr.fused_rollout.fwd_launches, fr.fused_reward_stream.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, _, tape = fr.rollout_forward_kernel(*args)
            if with_reward:
                fr.reward_stream(args[3], tape.act, tape.tok)
            torch.cuda.synchronize()
        assert (fr.fused_rollout.fwd_launches, fr.fused_reward_stream.launches) == (
            before[0] + 1, before[1] + with_reward)
        names = [e.key for e in prof.key_averages() for _ in range(e.count)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {k: sum(k in name for name in names)
                  for k in ("rollout_fwd_kernel", "wgmma_gemm_kernel", "linear_kernel",
                            "rollout_cell_kernel", "value_hidden_kernel", "sample_rows_kernel",
                            "reward_stream_kernel", "gru_pair_kernel", "cosine_rows_kernel")}
        assert counts == {"rollout_fwd_kernel": 1, "wgmma_gemm_kernel": 2, "linear_kernel": 0,
                          "rollout_cell_kernel": 0, "value_hidden_kernel": 0,
                          "sample_rows_kernel": 0, "reward_stream_kernel": int(with_reward),
                          "gru_pair_kernel": 0, "cosine_rows_kernel": 0}, (shape, counts)


# (N, E = H = F, V, S) for the reward stream alone: COCO width; one and two
# steps; rows that fill no whole row tile; H = 1024 (slices of 32 columns);
# a width the wrappers pad
STREAM_SHAPES = {"coco": (512, 512, 1004, 16), "s1": (100, 512, 1004, 1),
                 "s2": (100, 512, 1004, 2), "n33": (33, 512, 1004, 16),
                 "h1024": (512, 1024, 1004, 16), "padded": (100, 500, 1001, 6)}


def _stream_case(dev, wd, shape, seed=31):
    """Reward weights prepared for the stream and ``[S, N]`` int32 actions
    and tokens from a seed, half the tokens the action."""
    n, width, vocab, steps = shape
    cfg = NetConfig(vocab_size=vocab, input_dim=width, wordvec_dim=width, hidden_dim=width,
                    max_seq_len=steps + 1)
    rparams = reward.init(torch.Generator().manual_seed(seed), cfg)
    rparams = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(dev)) for k, v in rparams.items()}
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32)).to(dev)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    act = rng.integers(4, vocab, size=(steps, n))
    tok = np.where(rng.random((steps, n)) < 0.5, act, rng.integers(4, vocab, size=(steps, n)))
    rw = fr.prepare_reward_weights(rparams, feats, start, wd)
    return (rw, torch.from_numpy(act.astype(np.int32)).to(dev),
            torch.from_numpy(tok.astype(np.int32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
@pytest.mark.parametrize("shape", list(STREAM_SHAPES))
def test_reward_stream_kernel_matches_plain(dev, shape, wd):
    """The stream's one persistent launch against its plain version within
    ROLLOUT_TOL; two calls give the same bits; one launch a call."""
    rw, act, tok = _stream_case(dev, wd, STREAM_SHAPES[shape])
    before = fr.fused_reward_stream.launches
    got = fr.reward_stream(rw, act, tok)
    again = fr.reward_stream(rw, act, tok)
    torch.cuda.synchronize()
    assert fr.fused_reward_stream.launches == before + 2
    assert torch.equal(got, again)
    want = fr.reward_stream(rw, act, tok, use_fused_kernel=False)
    assert got.shape == want.shape == act.shape and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= ROLLOUT_TOL[wd], f"max abs error {err:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("curr", [1, 8])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_reward_stream_equals_the_fused_in_stream(dev, wd, curr):
    """At COCO width, on a kernel rollout's actions and tokens (curr 8: the
    teacher's tokens on the first seven steps), the stream alone gives the
    rewards of the stream fused into that rollout within 1e-6: the same
    slices, partials and combine."""
    args = _wide_rollout_case(dev, wd, curr, ROLLOUT_SHAPES["coco"], True)
    _, _, fused_in, tape = fr.rollout_forward_kernel(*args)
    stream = fr.reward_stream(args[3], tape.act, tape.tok)
    torch.cuda.synchronize()
    torch.testing.assert_close(stream, fused_in, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_reward_stream_clock_marks_every_phase(dev):
    """The optional clock: every mark of the S + 1 passes set, in order, and
    the rewards bit-equal to a call without it."""
    rw, act, tok = _stream_case(dev, torch.bfloat16, STREAM_SHAPES["coco"])
    steps = act.shape[0]
    clock = torch.zeros(fr.rollout_clock_slots(steps), dtype=torch.int64, device=dev)
    timed = fr.reward_stream(rw, act, tok, clock=clock)
    plain = fr.reward_stream(rw, act, tok)
    marks = clock.cpu()
    assert bool((marks > 0).all()) and bool((marks[1:] >= marks[:-1]).all())
    assert torch.equal(timed, plain)


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
    """Shapes raise at once; a token out of range fails the wrappers'
    device-side assertion at the next synchronisation (no host sync in the
    call), which ends the CUDA context, so each runs in a child."""
    args, _, _, _, _ = _rollout_case(dev, torch.float32, 1)
    curr, teach, noise, rw, feats, *states, w = args
    with pytest.raises(ValueError, match="noise"):
        fr.rollout_forward_kernel(curr, teach, noise[:, :, :-2], rw, feats, *states, w)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for call in ("fr.rollout_forward_kernel(curr, teach + 1000, noise, rw, feats, *states, w)",
                 "fr.reward_stream(rw, teach + 1000, teach)"):
        script = (
            "import sys, torch\n"
            f"sys.path.insert(0, {os.path.join(root, 'tests')!r})\n"
            "from test_torch_cuda import _rollout_case, fr\n"
            "args, *_ = _rollout_case(torch.device('cuda'), torch.float32, 1)\n"
            "curr, teach, noise, rw, feats, *states, w = args\n"
            f"{call}\n"
            "torch.cuda.synchronize()\n")
        done = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                              text=True, timeout=300)
        assert done.returncode != 0 and "assert" in done.stderr.lower(), done.stderr[-2000:]


# (N, E = H = F, V, S) for the backward: COCO width; H = 1024 and 2048 (the
# forward streams its weights from 1024, the recurrences from 2048); V =
# 2000; a padded width; rows not a multiple of 8
BWD_SHAPES = {"coco": (512, 512, 1004, 16), "h1024": (512, 1024, 1004, 5),
              "h2048": (96, 2048, 1004, 4), "v2000": (128, 512, 2000, 8),
              "padded": (100, 500, 1001, 6), "n12": (12, 512, 1004, 16),
              "n500": (500, 512, 1004, 16)}


def _backward_case(dev, wd, curr, shape):
    args = _wide_rollout_case(dev, wd, curr, BWD_SHAPES[shape], True)
    _, _, _, tape = fr.rollout_forward_kernel(*args)
    gen = torch.Generator().manual_seed(10)
    dval, dlogp = (torch.randn(tape.act.shape, generator=gen).to(dev) for _ in range(2))
    return tape, args[4], args[-1], dval, dlogp


@pytest.mark.cuda
@pytest.mark.parametrize("curr", [1, 8])
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_rollout_backward_kernel_matches_plain(dev, shape, wd, curr):
    """Every gradient of the one-call backward against the plain version on
    the kernel forward's tape, by relative Frobenius error within
    CHAIN_TOL."""
    case = _backward_case(dev, wd, curr, shape)
    before = fr.fused_rollout.bwd_launches
    got = fr.rollout_backward_kernel(*case)
    torch.cuda.synchronize()
    assert fr.fused_rollout.bwd_launches == before + 1
    want = fr.rollout_backward_plain(*case)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), i
        rel = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert rel <= CHAIN_TOL[wd], f"gradient {i}: relative error {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("wd", WEIGHT_TYPES)
def test_rollout_backward_kernel_is_deterministic(dev, wd):
    """Two calls on one tape give bit-identical gradients: the split-K parts
    and every column sum add in a fixed order, with no float atomics (the
    embedding gradient's index_add_ runs in PyTorch's deterministic mode
    here)."""
    case = _backward_case(dev, wd, 4, "coco")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first, second = (fr.rollout_backward_kernel(*case) for _ in range(2))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


def _launches_per_call(call, iters=5):
    """Device kernel launches per call of ``call`` by name: torch.profiler
    over ``iters`` calls (after one call outside the window, and 50 ms of an
    idle card inside it), each count rounded to whole launches a call. The
    tracer now and then misses the first launches of a window (on the H100
    machine: the first two or three of a backward, window after window, late
    in a process that has opened many); rounding recovers the true count
    while fewer than half of a kernel's launches go unrecorded. It has also
    handed back windows with no device event at all (late in the same
    process): such a window is taken again, up to three windows in all, as
    ``chip_smoke.py``'s ``device_profile`` does."""
    import time

    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        counts = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                counts[e.key] = counts.get(e.key, 0) + e.count
        if counts:
            break
    return {k: round(c / iters) for k, c in counts.items()}


@pytest.mark.cuda
def test_rollout_backward_launches_do_not_grow_with_steps(dev):
    """A bf16 backward launches its own ten kernels (prep, three wgmma
    groups, the softmax gradient, the recurrence pair, two wgmma batches,
    the column sums, the finishing pass) at S = 8 and 16 alike, and no
    view_kernel or linear_kernel."""
    own = ("rollout_bwd_prep_kernel", "wgmma_group_kernel", "softmax_grad_rows_kernel",
           "lstm_bwd_pair_kernel", "wgmma_gemm_kernel", "colsum_part_kernel",
           "rollout_bwd_finish_kernel")
    counts = {}
    for steps in (8, 16):
        args = _wide_rollout_case(dev, torch.bfloat16, 1, (256, 512, 1004, steps), True)
        _, _, _, tape = fr.rollout_forward_kernel(*args)
        dval = torch.ones(tape.act.shape, device=dev)
        per_call = _launches_per_call(
            lambda: fr.rollout_backward_kernel(tape, args[4], args[-1], dval, dval))
        assert not any(("view_kernel" in k or "linear_kernel" in k) and c
                       for k, c in per_call.items()), per_call
        counts[steps] = {k: sum(c for name, c in per_call.items() if k in name) for k in own}
    assert counts[8] == counts[16] == {
        "rollout_bwd_prep_kernel": 1, "wgmma_group_kernel": 3, "softmax_grad_rows_kernel": 1,
        "lstm_bwd_pair_kernel": 1, "wgmma_gemm_kernel": 2, "colsum_part_kernel": 1,
        "rollout_bwd_finish_kernel": 1}, counts


def _eval_bundle(n_images=60):
    """A small in-memory val split (V = 60, F = 16) for test_a2c_network."""
    from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths

    rng = np.random.default_rng(41)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, CFG.vocab_size)]
    n = 2 * n_images
    lens = rng.integers(4, 18, size=n)
    caps = np.where(np.arange(17)[None] < lens[:, None] - 1,
                    rng.integers(4, CFG.vocab_size, size=(n, 17)), 0)
    caps[np.arange(n), lens - 1] = 2
    caps[:, 0] = START_ID
    caps = caps.astype(np.int32)
    idxs = np.repeat(np.arange(n_images), 2).astype(np.int32)
    feats = rng.standard_normal((n_images, CFG.input_dim)).astype(np.float32)
    urls = np.array([f"file:///val/{i}.jpg" for i in range(n_images)])
    return CocoData(train_captions=caps, train_image_idxs=idxs, val_captions=caps,
                    val_image_idxs=idxs, train_features=feats, val_features=feats,
                    word_to_idx={w: i for i, w in enumerate(words)},
                    idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
                    train_captions_lens=caption_lengths(caps),
                    val_captions_lens=caption_lengths(caps))


@pytest.mark.cuda
def test_eval_on_the_beam_kernel_matches_plain(dev, tmp_path):
    """test_a2c_network on the card: 300 draws (slices of 127, 127 and 44)
    in two groups of 254 rows, one beam kernel launch a group, bf16 weights;
    against the plain beam on the same weights the real and url dumps are
    byte-identical and a generated line may part only at a plain-version
    gap below NEAR_TIE, in at most 1% of lines."""
    from image_captioning_through_rl_tpu_torch.config import DecodeConfig
    from image_captioning_through_rl_tpu_torch.data.coco import get_coco_batch
    from image_captioning_through_rl_tpu_torch.train.checkpoint import to_device
    from image_captioning_through_rl_tpu_torch.train.loops import test_a2c_network as evaluate

    data = _eval_bundle()
    params = a2c.init(torch.Generator().manual_seed(0), CFG)
    cfg = NetConfig(vocab_size=CFG.vocab_size, input_dim=CFG.input_dim,
                    wordvec_dim=CFG.wordvec_dim, hidden_dim=CFG.hidden_dim)
    dumps = {}
    for route in (None, False):
        d = tmp_path / str(route)
        d.mkdir()
        paths = {k: str(d / f"{k}.txt") for k in ("real_captions_path",
                                                   "generated_captions_path", "image_urls_path")}
        before = fused_beam_search.launches
        evaluate(params, cfg, data, paths, data_size=300, eval_superbatch=2, seed=0,
                 use_fused_kernel=route, device=dev)
        assert fused_beam_search.launches - before == (2 if route is None else 0)
        dumps[route] = {k: open(p).read().splitlines() for k, p in paths.items()}
    kernel, plain = dumps[None], dumps[False]
    for k in ("real_captions_path", "image_urls_path"):
        assert kernel[k] == plain[k], k
    parted = [i for i, (a, b) in enumerate(zip(kernel["generated_captions_path"],
                                                plain["generated_captions_path"])) if a != b]
    assert len(kernel["generated_captions_path"]) == 298 and len(parted) <= 0.01 * 298
    if parted:
        _, feats, _ = get_coco_batch(data, batch_size=300, split="val",
                                     rng=np.random.default_rng(5))
        kept = [i for s in range(0, 300, 128) for i in range(s, min(s + 127, 300))]
        rows = torch.from_numpy(feats[[kept[i] for i in parted]]).to(dev)
        on_dev = to_device(params, dev)
        bw = prepare_beam_weights(prepare_greedy_weights(on_dev["policy"], torch.bfloat16),
                                  on_dev["value"])
        start = torch.full((len(parted),), START_ID, dtype=torch.int32, device=dev)
        _, _, gaps = beam_search_plain(bw, rows, start, 17, DecodeConfig().beam_size,
                                       margins=True)
        assert bool((gaps.min(dim=1).values < NEAR_TIE).all()), "a non-tie line differs"


@pytest.mark.cuda
def test_embedding_grad_on_the_card_is_deterministic_and_capturable(dev):
    """The chains' and the rollout's embedding gradient on the card (a
    one-hot product): two calls bit-equal; as close to the float64 sums as
    the CPU's float32 ``index_add_`` is allowed to be (each entry within
    1e-6 of its row's sum of magnitudes: float32 sums of up to ~3300 terms
    in another order); the same bits when replayed from a CUDA graph."""
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import embedding_grad

    gen = torch.Generator().manual_seed(0)
    dx = torch.randn(16 * 512, 512, generator=gen)
    tok = (torch.rand((16, 512), generator=gen) ** 4 * 1004).long()  # token 0 ~ 40% of rows
    exact = torch.zeros(1004, 512, dtype=torch.float64).index_add_(
        0, tok.reshape(-1), dx.double())
    bound = 1e-6 * torch.zeros(1004, 512, dtype=torch.float64).index_add_(
        0, tok.reshape(-1), dx.double().abs()) + 1e-7
    dx_d, tok_d = dx.to(dev), tok.to(dev)
    got = embedding_grad(dx_d, tok_d, 1004)
    assert torch.equal(got, embedding_grad(dx_d, tok_d, 1004))
    for name, value in (("card", got.cpu()), ("cpu", embedding_grad(dx, tok, 1004))):
        assert bool(((value.double() - exact).abs() <= bound).all()), name
    side = torch.cuda.Stream()  # warm up on a side stream before the capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        embedding_grad(dx_d, tok_d, 1004)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = embedding_grad(dx_d, tok_d, 1004)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.cuda
def test_embedding_grad_turns_tf32_off(dev):
    """The one-hot product runs in full float32 where the process allowed
    TF32 (``ops.linalg.matmul`` turns it off): the bits of a TF32-off call."""
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import embedding_grad

    gen = torch.Generator().manual_seed(1)
    dx = torch.randn(16 * 64, 512, generator=gen).to(dev)
    tok = torch.randint(0, 1004, (16, 64), generator=gen).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = embedding_grad(dx, tok, 1004)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = embedding_grad(dx, tok, 1004)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_captured_chunk_replays_call_no_wrapper(dev):
    """A captured policy chunk of 3 minibatches, run twice: the LSTM chain's
    wrappers count the warm-up update's launches and the capture's (3
    updates, recorded), and the replays, which call no wrapper, add none;
    ``BestLossChunk`` counts one capture and two replays; the losses and
    weights equal two eager chunks' bit for bit."""
    from image_captioning_through_rl_tpu_torch.models import policy
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import steps
    from image_captioning_through_rl_tpu_torch.train.optim import adam

    cfg, v = CFG, CFG.vocab_size
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 3, 8, cfg.input_dim)).astype(np.float32)
    feats = torch.from_numpy(feats).to(dev)
    caps = rng.integers(4, v, size=(2, 3, 8, T))
    caps[..., 0], caps[..., -1] = START_ID, 2
    caps = torch.from_numpy(caps).to(dev)

    def run(graph):
        params = ckpt.to_device(policy.init(torch.Generator().manual_seed(3), cfg), dev)
        chunk = steps.make_policy_chunk_step(cfg, adam(1e-3, params), params, fused=True,
                                             graph=graph)
        before = (fused_lstm_chain.fwd_launches, fused_lstm_chain.bwd_launches)
        losses = torch.cat([chunk(float("inf"), feats[c], caps[c])[0].clone() for c in range(2)])
        torch.cuda.synchronize()
        after = (fused_lstm_chain.fwd_launches, fused_lstm_chain.bwd_launches)
        return params, losses, (after[0] - before[0], after[1] - before[1])

    steps.BestLossChunk.captures = steps.BestLossChunk.replays = 0
    p_graph, l_graph, n_graph = run(True)
    assert (steps.BestLossChunk.captures, steps.BestLossChunk.replays) == (1, 2)
    assert n_graph == (1 + 3, 1 + 3)
    p_eager, l_eager, n_eager = run(False)
    assert n_eager == (6, 6)
    assert torch.equal(l_graph, l_eager)
    for (_, a), (_, b) in zip(ckpt._leaves(p_graph), ckpt._leaves(p_eager), strict=True):
        assert torch.equal(a.detach(), b.detach())
