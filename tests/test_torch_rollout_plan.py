"""The rollout forward kernel's launch plan and its cross-slice combine, on
the CPU (no GPU needed).

``csrc/rollout_fwd.cu`` runs the whole rollout forward as one cooperative
launch: the columns of the six products of a step are cut into slices, one
block (or, streaming, a few in turn) per slice and row group, and each row's
action, log-prob, value and reward are combined from per-slice partials.
:func:`fused_rollout.rollout_plan` mirrors the C plan (the entry point
refuses a plan that differs); these tests hold it to its contract at widths
from 8 to 4096 and vocabularies to 10000, and hold
:func:`fused_rollout.combine_row_partials`, the plain model of the combine,
to the one-pass arithmetic of :func:`fused_rollout.rollout_forward_plain`:
the same action (equal maxima on both sides of a slice boundary go to the
first index) and log-prob, value and cosine within 1e-6 of the batch's
largest magnitude (float32 sums in another order).

The reward stream alone (``csrc/reward_stream.cu``) is the same launch in
its reward-only mode (``rollout_plan(..., reward_only=True)``): its plan is
held to the same contract at widths from 8 to 4096, pinned where it decides
between slice widths and streaming, cut like the fused-in stream's at COCO
width, and leaves the rollout's plan as it was; its combine, modelled by
:func:`fused_rollout.combine_row_partials`, gives
:func:`fused_rollout.reward_stream_plain`'s rewards within 1e-6.
"""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
from image_captioning_through_rl_tpu_torch.ops.fused_decode import round_to, wmatmul

SMS = 132  # H100 SXM
SMEM_PER_BLOCK = 232448
REL = 1e-6


def _pad8(x):
    return -(-x // 8) * 8


def _check_coverage(p, cols, n):
    """Every column of each product in exactly one slice, every slice on one
    block column and every row tile in one row group, one block per SM
    within a block's shared memory, and a block of its own for every slice
    when the weights stay."""
    nc = p["columns"]
    assert nc == 4 * p["units"] and len(p["slice_table"]) == p["slices"]
    for m, width in enumerate(cols):
        seen = np.zeros(width, dtype=int)
        for mm, c0, k in p["slice_table"]:
            if mm == m:
                assert c0 % nc == 0 and 0 < k <= nc
                seen[c0:c0 + k] += 1
        assert (seen == 1).all(), (m, width)
    gx, groups = p["grid"]
    assert sorted({s % gx for s in range(p["slices"])}) == list(range(gx))
    tiles = -(-n // p["rows_per_tile"])
    assert groups <= tiles and sorted({rt % groups for rt in range(tiles)}) == list(range(groups))
    assert p["smem_bytes"] <= SMEM_PER_BLOCK
    assert gx * groups <= SMS and gx <= p["slices"]
    if not p["stream"]:
        assert gx == p["slices"]


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden", [8, 12, 256, 500, 512, 1000, 1024, 2048, 4096])
def test_rollout_plan_covers_every_column_and_row_tile(hidden, wd):
    for vocab in (8, 1004, 2000, 10000):
        vp = _pad8(vocab)
        for n in (1, 100, 512, 1024):
            for reward in (True, False):
                p = fr.rollout_plan(n, hidden, hidden, vp, wd, SMS, reward)
                _check_coverage(p, fr.rollout_columns(hidden, vp, reward), n)


@pytest.mark.parametrize("wd,want", [
    (torch.bfloat16, {"columns": 128, "stream": False, "slices": 60, "grid": (60, 2),
                      "rows_per_tile": 64, "smem_bytes": 226304}),
    (torch.float32, {"columns": 64, "stream": False, "slices": 120, "grid": (120, 1),
                     "rows_per_tile": 64, "smem_bytes": 176128}),
])
def test_rollout_plan_at_coco_width(wd, want):
    """N = 512, E = H = F = 512, V = 1004 (Vp = 1008), reward fused in: 7664
    columns, stationary slices, in bf16 with two row groups (each block's
    136 KB slice and the staging ring in 226 KB)."""
    p = fr.rollout_plan(512, 512, 512, 1008, wd, SMS, True)
    assert {k: p[k] for k in want} == want
    assert sum(fr.rollout_columns(512, 1008, True)) == 7664


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_rollout_plan_streams_past_what_stays(wd):
    """bf16 from H = 1024 and float32 from H = 1024 stream their weights;
    without the reward stream the columns shrink to Vp + 9H."""
    assert fr.rollout_plan(512, 512, 512, 1008, wd, SMS)["stream"] is False
    p = fr.rollout_plan(512, 1024, 1024, 1008, wd, SMS)
    assert p["stream"] and p["grid"] == (SMS, 1)
    assert sum(fr.rollout_columns(512, 1008, False)) == 1008 + 9 * 512


def _one_pass(logits, noise, v1w, b2, se, vn):
    """The plain rollout's arithmetic, in one pass over each row."""
    action = torch.argmax(logits + noise, dim=-1)
    shifted = logits - torch.max(logits, dim=-1, keepdim=True).values
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    logp = torch.gather(shifted, 1, action[:, None])[:, 0] - lse
    value = v1w.sum(dim=-1) + b2
    cosine = torch.sum(vn * se, dim=-1) / torch.clamp_min(
        torch.sqrt(torch.sum(se * se, dim=-1)), 1e-12)
    return action, logp, value, cosine


def _rel(a, b):
    """Relative to the largest magnitude of the batch: a sum that cancels to
    near zero keeps the rounding error of its terms, not of its value."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("columns", [32, 64, 128])
@pytest.mark.parametrize("vocab", [8, 1004, 2000])
def test_combine_row_partials_matches_one_pass(vocab, columns):
    rng = np.random.default_rng(vocab + columns)
    n, hidden = 64, 96

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    logits, noise = f32(n, vocab, scale=3.0), f32(n, vocab)
    v1w, se, vn = f32(n, hidden), f32(n, hidden), f32(n, hidden)
    b2 = f32(1)
    # equal noisy maxima: on both sides of a slice boundary, inside a slice,
    # and in two slices far apart; the first index must win
    top = float((logits + noise).max()) + 10.0
    plants = [(0, columns - 1, columns), (1, 0, 1), (2, 3, vocab - 1), (3, columns, 2 * columns)]
    for row, c1, c2 in plants:
        if c2 < vocab:
            for c in (c1, c2):
                logits[row, c], noise[row, c] = top - 1.0, 1.0
    got = fr.combine_row_partials(logits, noise, v1w, b2, se, vn, columns)
    want = _one_pass(logits, noise, v1w, b2, se, vn)
    assert torch.equal(got[0], want[0])
    for row, c1, c2 in plants:
        if c2 < vocab:
            assert int(got[0][row]) == c1
    for name, a, b in zip(("log_prob", "value", "cosine"), got[1:], want[1:]):
        assert _rel(a, b) <= REL, name


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_combine_row_partials_matches_the_plain_rollout(wd):
    """The plain rollout's own logits and v1 (from its tape), cut at the
    plan's slice width: the combine gives the plain rollout's actions,
    log-probs and values at every step."""
    from image_captioning_through_rl_tpu_torch.models import a2c

    cfg = NetConfig(vocab_size=1004, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=6)
    nets = a2c.init(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(4)
    n = 24
    feats = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    caps = torch.from_numpy(rng.integers(4, cfg.vocab_size, size=(n, 6)))
    caps[:, 0] = START_ID
    w = fr.prepare_rollout_weights(nets, wd)
    with torch.no_grad():
        states = fr.start_states(nets, cfg, feats, caps[:, 0])
    steps = 5
    noise = torch.from_numpy(rng.gumbel(size=(steps, n, 1004)).astype(np.float32))
    teach = caps[:, 1:].t().to(torch.int32).contiguous()
    values, logp, _, tape = fr.rollout_forward_plain(3, teach, noise, None, feats, *states, w)
    columns = fr.rollout_plan(n, 16, 16, w.hw.shape[1], wd, SMS, False)["columns"]
    assert columns < 1004  # the head is cut into several slices
    logits = wmatmul(round_to(tape.hp, wd), w.hw[:, :1004]) + w.hb[:1004]
    v1w = round_to(tape.v1, wd) * w.w2.to(torch.float32)
    zeros = torch.zeros_like(v1w)
    act, k_logp, k_val, _ = fr.combine_row_partials(
        logits, noise.reshape(steps * n, 1004), v1w, w.b2, zeros + 1.0, zeros, columns)
    assert torch.equal(act.reshape(steps, n).to(torch.int32), tape.act)
    assert _rel(k_logp, logp.reshape(-1)) <= REL
    assert _rel(k_val, values.reshape(-1)) <= REL


@pytest.mark.parametrize("clock", ["float32", "short", "strided"])
def test_rollout_forward_refuses_a_bad_clock(clock):
    """The forward's optional phase clock is int64, contiguous and holds
    rollout_clock_slots(S) = 2 + 4 (S + 1) marks; anything else is refused
    before any launch."""
    from image_captioning_through_rl_tpu_torch.models import a2c

    cfg = NetConfig(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=4)
    nets = a2c.init(torch.Generator().manual_seed(5), cfg)
    rng = np.random.default_rng(6)
    n, steps = 4, 3
    feats = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    caps = torch.from_numpy(rng.integers(4, cfg.vocab_size, size=(n, steps + 1)))
    caps[:, 0] = START_ID
    with torch.no_grad():
        states = fr.start_states(nets, cfg, feats, caps[:, 0])
    noise = torch.from_numpy(rng.gumbel(size=(steps, n, 40)).astype(np.float32))
    teach = caps[:, 1:].t().to(torch.int32).contiguous()
    slots = fr.rollout_clock_slots(steps)
    assert slots == 18
    bad = {"float32": torch.zeros(slots),
           "short": torch.zeros(slots - 1, dtype=torch.int64),
           "strided": torch.zeros(2 * slots, dtype=torch.int64)[::2]}[clock]
    with pytest.raises(ValueError, match="clock"):
        fr.rollout_forward_kernel(1, teach, noise, None, feats, *states,
                                  fr.prepare_rollout_weights(nets, torch.bfloat16), clock=bad)


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden", [8, 12, 256, 500, 512, 1000, 1024, 2048, 4096])
def test_reward_plan_covers_every_column_and_row_tile(hidden, wd):
    """The reward-only plan deals out the reward GRU's 3H and
    semantic_embed's H columns alone, in slices of H rows (the feature
    width and the vocabulary are not read)."""
    for n in (1, 100, 512, 1024):
        p = fr.rollout_plan(n, hidden, hidden, 0, wd, SMS, reward_only=True)
        cols = fr.rollout_columns(hidden, 0, True, reward_only=True)
        assert cols == (0, 0, 0, 0, 3 * hidden, hidden)
        assert {m for m, _, _ in p["slice_table"]} == {4, 5}
        _check_coverage(p, cols, n)
        assert fr.rollout_plan(n, 4 * hidden, hidden, 2008, wd, SMS, False,
                               reward_only=True) == p


@pytest.mark.parametrize("wd,hidden,want", [
    (torch.bfloat16, 512, {"columns": 128, "stream": False, "slices": 16, "grid": (16, 8),
                           "smem_bytes": 226304}),
    (torch.float32, 512, {"columns": 64, "stream": False, "slices": 32, "grid": (32, 4),
                          "smem_bytes": 176128}),
    (torch.bfloat16, 1024, {"columns": 32, "stream": False, "slices": 128, "grid": (128, 1),
                            "smem_bytes": 168960}),
    (torch.float32, 1024, {"columns": 32, "stream": False, "slices": 128, "grid": (128, 1),
                           "smem_bytes": 184320}),
    (torch.bfloat16, 2048, {"columns": 64, "stream": True, "slices": 128, "grid": (128, 1),
                            "smem_bytes": 179200}),
])
def test_reward_plan_at_its_widths(wd, hidden, want):
    """N = 512. COCO width: 16 stationary slices of 128 columns (bf16) x 8
    row groups, one 64-row tile a block. H = 1024, where the rollout's
    6H + 9H + Vp columns stream, the stream's 4H stay: 128 slices of 32
    columns, one a block. H = 2048 streams."""
    p = fr.rollout_plan(512, hidden, hidden, 0, wd, SMS, reward_only=True)
    assert {k: p[k] for k in want} == want
    assert fr.rollout_plan(512, hidden, hidden, 1008, wd, SMS)["stream"] is (hidden >= 1024)


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_reward_plan_cuts_slices_as_the_fused_in_stream(wd):
    """At COCO width the stream alone and the stream fused into the rollout
    cut the reward GRU's and semantic_embed's columns into the same slices,
    so each row's partials, and their combine, are the same."""
    alone = fr.rollout_plan(512, 512, 512, 0, wd, SMS, reward_only=True)
    fused = fr.rollout_plan(512, 512, 512, 1008, wd, SMS, True)
    assert alone["columns"] == fused["columns"] and not alone["stream"] and not fused["stream"]
    assert alone["slice_table"] == [s for s in fused["slice_table"] if s[0] in (4, 5)]


# The rollout's plans before the reward-only mode existed: (N, H = F, Vp,
# reward) -> (columns, stream, slices, grid, shared bytes)
ROLLOUT_PLANS = {
    torch.bfloat16: {
        (512, 512, 1008, True): (128, False, 60, (60, 2), 226304),
        (512, 1024, 1008, True): (64, True, 224, (132, 1), 179200),
        (128, 512, 2000, True): (128, False, 68, (68, 1), 226304),
        (100, 504, 1008, True): (128, False, 60, (60, 2), 226304),
        (512, 512, 1008, False): (128, False, 44, (44, 3), 226304),
        (512, 1024, 1008, False): (64, True, 160, (132, 1), 179200),
        (128, 512, 2000, False): (128, False, 52, (52, 2), 226304),
        (100, 504, 1008, False): (128, False, 44, (44, 2), 226304)},
    torch.float32: {
        (512, 512, 1008, True): (64, False, 120, (120, 1), 176128),
        (512, 1024, 1008, True): (32, True, 448, (132, 1), 55296),
        (128, 512, 2000, True): (32, True, 271, (132, 1), 55296),
        (100, 504, 1008, True): (64, False, 120, (120, 1), 176128),
        (512, 512, 1008, False): (64, False, 88, (88, 1), 176128),
        (512, 1024, 1008, False): (32, True, 320, (132, 1), 55296),
        (128, 512, 2000, False): (64, False, 104, (104, 1), 176128),
        (100, 504, 1008, False): (64, False, 88, (88, 1), 176128)},
}


@pytest.mark.parametrize("reward", [True, False])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_reward_only_leaves_the_rollout_plan(wd, reward):
    """reward_only=False, the default, plans the rollout as before."""
    for (n, hidden, vp, rew), want in ROLLOUT_PLANS[wd].items():
        if rew is not reward:
            continue
        p = fr.rollout_plan(n, hidden, hidden, vp, wd, SMS, reward, reward_only=False)
        assert p == fr.rollout_plan(n, hidden, hidden, vp, wd, SMS, reward)
        got = (p["columns"], p["stream"], p["slices"], p["grid"], p["smem_bytes"])
        assert got == want, (n, hidden, vp)
        assert fr.rollout_columns(hidden, vp, reward) == fr.rollout_columns(
            hidden, vp, reward, reward_only=False)


@pytest.mark.parametrize("columns", [32, 64, 128])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_reward_only_combine_matches_the_plain_stream(wd, columns):
    """The stream's semantic embeddings, step by step in the plain
    arithmetic, cut into slices of ``columns`` and combined as the kernel
    combines them (combine_row_partials' cosine), give reward_stream_plain's
    rewards within 1e-6 of the batch's largest; half the tokens differ from
    the action, so the advance runs on its own table row."""
    from image_captioning_through_rl_tpu_torch.models import reward

    hidden, vocab, n, steps = 160, 50, 24, 5
    cfg = NetConfig(vocab_size=vocab, input_dim=16, wordvec_dim=16, hidden_dim=hidden,
                    max_seq_len=steps + 1)
    rparams = reward.init(torch.Generator().manual_seed(columns), cfg)
    rng = np.random.default_rng(columns + 1)
    feats = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    start = torch.full((n,), START_ID, dtype=torch.int32)
    rw = fr.prepare_reward_weights(rparams, feats, start, wd)
    act = torch.from_numpy(rng.integers(4, vocab, size=(steps, n)).astype(np.int32))
    other = torch.from_numpy(rng.integers(4, vocab, size=(steps, n)).astype(np.int32))
    tok = torch.where(torch.from_numpy(rng.random((steps, n)) < 0.5), act, other)
    want = fr.reward_stream_plain(rw, act, tok)
    zeros = torch.zeros((n, 8))
    h, got = rw.rew0, []
    for s in range(steps):
        gh = wmatmul(round_to(h, wd), rw.wh) + rw.bh
        after = fr._gru_update(rw.xg[act[s].long()], gh, h)
        se = wmatmul(round_to(after, wd), rw.sem_w) + rw.sem_b
        got.append(fr.combine_row_partials(zeros, zeros, torch.zeros_like(se), zeros[0, :1], se,
                                           rw.vn, columns)[3])
        h = fr._gru_update(rw.xg[tok[s].long()], gh, h)
    assert hidden > columns  # the semantic product is cut into several slices
    assert _rel(torch.stack(got), want) <= REL


@pytest.mark.parametrize("clock", ["float32", "short", "strided", "plain"])
def test_reward_stream_refuses_a_bad_clock(clock):
    """The stream's optional clock is int64, contiguous and holds
    rollout_clock_slots(S) marks, refused before any launch; the plain
    version takes none."""
    from image_captioning_through_rl_tpu_torch.models import reward

    cfg = NetConfig(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=4)
    rparams = reward.init(torch.Generator().manual_seed(7), cfg)
    rng = np.random.default_rng(8)
    n, steps = 4, 3
    feats = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    rw = fr.prepare_reward_weights(rparams, feats, torch.full((n,), START_ID, dtype=torch.int32))
    act = torch.from_numpy(rng.integers(4, 40, size=(steps, n)).astype(np.int32))
    slots = fr.rollout_clock_slots(steps)
    bad = {"float32": torch.zeros(slots),
           "short": torch.zeros(slots - 1, dtype=torch.int64),
           "strided": torch.zeros(2 * slots, dtype=torch.int64)[::2],
           "plain": torch.zeros(slots, dtype=torch.int64)}[clock]
    with pytest.raises(ValueError, match="clock"):
        if clock == "plain":
            fr.reward_stream(rw, act, act, clock=bad)
        else:
            fr._launch_reward_stream(rw, act, act, clock=bad)
