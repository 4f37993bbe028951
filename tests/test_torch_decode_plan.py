"""The decode kernel's launch plan, its per-row picks and its key schedule,
on the CPU (no GPU needed).

``csrc/decode.cu`` runs the greedy and the sampling decode as one
cooperative launch each: the columns of the head and of the cell's ``wh``
are cut into slices, one block (or, streaming, a few in turn) per slice and
row group, and each row's token is picked in a second phase from per-slice
partials (greedy, unfiltered sampling) or from its row of scaled logits
(top-k and the nucleus). :func:`fused_decode.decode_plan` mirrors the C plan
(the entry point refuses a plan that differs); these tests hold it to its
contract at widths from 8 to 4096, vocabularies to 10000 and batches 1 to
4096, and hold the plain models of the kernel's steps to the JAX package and
the plain versions:

* :func:`fused_decode.merge_argmax_partials` (per-slice argmaxes merged) to
  ``torch.argmax``, equal maxima across slice boundaries included: exact;
* :func:`fused_sample.kth_largest_keys` (the radix select) to JAX's
  ``pallas_sample.keyspace_threshold`` with unit weights and budget k, on
  rows with ties, +-0.0, all-equal rows, k = 1 and k = V - 1, V = 2000:
  exact (integer counts);
* :func:`fused_sample.kernel_keep_sets` (the nucleus over top-k's
  survivors, from their own key range) to JAX's ``filter_scaled_logits``:
  equal keep sets except in rows whose boundary margin
  (``filter_scaled_logits(..., margins=True)``) is below 5e-4, the near-tie
  rule of ``chip_smoke.py`` (float32 sums in another order);
* :func:`fused_sample.survivor_gumbel_pick` (noise for the kept columns only)
  to the argmax of JAX's filtered row plus ``prng.gumbel_noise_plain``:
  exact tokens (a dropped column is -1e30, and -1e30 + g == -1e30);
* :func:`fused_sample.launch_step_keys` (the subkeys the launch carries,
  in wrapping uint32 arithmetic) to ``prng.sample_step_keys`` and the
  ``jax.random.split`` chain: exact words, at any step count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.ops import pallas_sample as jps
from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.models import a2c
from image_captioning_through_rl_tpu_torch.ops import fused_decode as fd
from image_captioning_through_rl_tpu_torch.ops import fused_sample as fs
from image_captioning_through_rl_tpu_torch.ops import prng

SMS = 132  # H100 SXM
SMEM_PER_BLOCK = 232448
NEAR_TIE = 5e-4


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden", [8, 16, 256, 504, 512, 1000, 1024, 2048, 4096])
def test_decode_plan_covers_every_column_and_row_tile(hidden, wd):
    for vocab in (10, 1004, 2000, 10000):
        for n in (1, 37, 1024, 4096):
            for pick in (fd.PICK_ARGMAX, fd.PICK_GUMBEL, fd.PICK_FILTER):
                p = fd.decode_plan(n, hidden, hidden, vocab, pick, wd, SMS)
                nc = p["columns"]
                assert nc == 4 * p["units"]
                # every column of each product in exactly one slice, head first
                assert len(p["slice_table"]) == p["slices"]
                for m, width in enumerate(fd.decode_columns(hidden, vocab)):
                    seen = np.zeros(width, dtype=int)
                    for mm, c0, k in p["slice_table"]:
                        if mm == m:
                            assert c0 % nc == 0 and 0 < k <= nc
                            seen[c0:c0 + k] += 1
                    assert (seen == 1).all(), (m, width)
                sh = p["head_slices"]
                assert all(m == 0 for m, _, _ in p["slice_table"][:sh])
                assert all(m == 1 for m, _, _ in p["slice_table"][sh:])
                assert p["tiles"] == -(-n // 64)
                assert p["smem_bytes"] <= SMEM_PER_BLOCK and p["grid"] <= SMS
                if p["stream"]:
                    # every (slice, tile) item on one block, in turn
                    assert p["grid"] == p["co_resident"]
                    assert p["h_groups"] == p["a_groups"] == 0
                    continue
                sp = p["slices"] - sh
                gh, gp, ta = p["h_groups"], p["a_groups"], p["tiles"]
                assert 1 <= gh <= ta and 1 <= gp <= ta
                assert p["grid"] == sh * gh + sp * gp
                # each block holds one slice; every slice and row tile has a block
                blocks = ([(s, g) for g in range(gh) for s in range(sh)]
                          + [(sh + s, g) for g in range(gp) for s in range(sp)])
                for first, slices, groups in ((0, sh, gh), (sh, sp, gp)):
                    for s in range(first, first + slices):
                        owners = {rt % groups for rt in range(ta)}
                        assert owners == {g for ss, g in blocks if ss == s}
                # no other group counts on the card give phase A less weighted
                # time, or as little with more blocks
                wh, wa = fd.DECODE_TILE_COST[pick]
                co = p["co_resident"]

                def key(g1, g2):
                    return max(-(-ta // g1) * wh, -(-ta // g2) * wa), -(sh * g1 + sp * g2)

                for g1 in range(1, ta + 1):
                    for g2 in range(1, ta + 1):
                        if sh * g1 + sp * g2 > co:
                            break
                        assert key(g1, g2) >= key(gh, gp)


@pytest.mark.parametrize("wd,n,pick,want", [
    (torch.bfloat16, 1024, fd.PICK_ARGMAX,
     {"columns": 128, "stream": False, "head_slices": 8, "slices": 24, "h_groups": 6,
      "a_groups": 5, "grid": 128, "smem_bytes": 226304}),
    (torch.bfloat16, 1024, fd.PICK_GUMBEL, {"h_groups": 8, "a_groups": 4, "grid": 128}),
    (torch.bfloat16, 64, fd.PICK_FILTER, {"h_groups": 1, "a_groups": 1, "grid": 24}),
    (torch.float32, 1024, fd.PICK_ARGMAX, {"columns": 64, "stream": False, "head_slices": 16,
                                           "slices": 48}),
])
def test_decode_plan_at_coco_width(wd, n, pick, want):
    """V = 1004, E = H = F = 512: 3052 columns; in bf16 the 8 head slices and
    16 cell slices of 128 columns (each block's 136 KB slice and the staging
    ring in 226 KB), replicated by the blocks left over."""
    p = fd.decode_plan(n, 512, 512, 1004, pick, wd, SMS)
    assert {k: p[k] for k in want} == want


def test_decode_plan_streams_what_one_sm_cannot_hold():
    """What one SM cannot hold is streamed, not refused: H = 1024 (bf16) and
    4096 (both types) plan within one block per SM."""
    for wd, hidden in ((torch.bfloat16, 1024), (torch.bfloat16, 4096), (torch.float32, 4096)):
        p = fd.decode_plan(1024, 512, hidden, 1004, fd.PICK_FILTER, wd, SMS)
        assert p["stream"] and p["smem_bytes"] <= SMEM_PER_BLOCK and p["grid"] <= SMS


@pytest.mark.parametrize("columns", [32, 64, 128])
def test_argmax_merge_matches_torch_argmax(columns):
    """The first index of the row maximum, equal maxima within a slice and
    across slice boundaries included."""
    rng = np.random.default_rng(columns)
    logits = torch.from_numpy(rng.standard_normal((64, 1004)).astype(np.float32))
    logits[1:8] = torch.round(logits[1:8])  # many ties
    for r, cols in enumerate(((0, columns), (columns - 1, columns), (5, 3 * columns + 7),
                              (1003, 2 * columns), (columns, columns + 1)), start=8):
        for c in cols:
            logits[r, c] = 9.0
    logits[13] = 2.5  # an all-equal row
    want = torch.argmax(logits, dim=1)
    assert torch.equal(fd.merge_argmax_partials(logits, columns), want)


def _scaled_rows(vocab: int, seed: int) -> torch.Tensor:
    """Rows of scaled logits: random, with ties, +-0.0, an all-equal row, a
    row of two values, wide magnitudes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((24, vocab)).astype(np.float32) * 3
    x[1] = np.round(x[1])
    x[2] = np.round(x[2] * 4) / 4
    x[3, ::2], x[3, 1::2] = 0.0, -0.0
    x[4] = 1.5
    x[5] = np.where(rng.random(vocab) < 0.5, -2.0, 3.0)
    x[6, :vocab // 2] = -0.0
    x[7] = x[7] * 1e6
    x[8, :40] = 7.0  # exactly k equal maxima
    return torch.from_numpy(x)


@pytest.mark.parametrize("vocab", [42, 1004, 2000])
def test_radix_select_is_jax_keyspace_threshold(vocab):
    scaled = _scaled_rows(vocab, vocab)
    keys = fs.monotone_keys(scaled)
    for k in sorted({1, 2, 5, 40, vocab // 2, vocab - 1}):
        want = np.asarray(jps.keyspace_threshold(
            jnp.asarray(keys.numpy()), jnp.ones(keys.shape, jnp.float32), jnp.float32(k)))
        got = fs.kth_largest_keys(keys, k)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
        # the k-th largest key itself: at least k keys at or above it
        assert bool(((keys >= got).sum(dim=1) >= k).all())


def _jax_filter(scaled, k, p, use_top_k, use_top_p):
    return torch.from_numpy(np.asarray(jps.filter_scaled_logits(
        jnp.asarray(scaled.numpy()), jnp.float32(k), jnp.float32(p if p is not None else 1.0),
        use_top_k, use_top_p)).copy())


@pytest.mark.parametrize("k,p", [(40, None), (0, 0.9), (40, 0.9), (5, 0.5), (1, 0.9)])
@pytest.mark.parametrize("vocab", [42, 1004, 2000])
def test_kernel_keep_sets_match_jax_filters(vocab, k, p):
    """The radix top-k and the nucleus over its compacted survivors keep what
    JAX's sort-free filters keep, except where the boundary lies within the
    near-tie margin."""
    k = min(k, vocab - 1)
    use_top_k, use_top_p = k > 0, p is not None
    scaled = torch.cat([_scaled_rows(vocab, vocab + 1),
                        torch.from_numpy(np.random.default_rng(vocab).standard_normal(
                            (200, vocab)).astype(np.float32) * 2)])
    want = _jax_filter(scaled, k, p, use_top_k, use_top_p) > -1e30
    got = fs.kernel_keep_sets(scaled, k, p, use_top_k, use_top_p)
    _, margin = fs.filter_scaled_logits(scaled, k, p, use_top_k, use_top_p, margins=True)
    differ = (got != want).any(dim=1)
    assert bool((margin[differ] < NEAR_TIE).all()), margin[differ]
    assert int(differ.sum()) <= 2
    if use_top_k and not use_top_p:
        assert torch.equal(got, want)  # integer counts: exact


@pytest.mark.parametrize("k,p", [(0, None), (40, None), (0, 0.9), (40, 0.9)])
def test_survivor_gumbel_pick_is_the_full_row_argmax(k, p):
    """Noise hashed for the kept columns only gives the tokens of the full
    row's argmax of the filtered logits plus the Gumbel noise."""
    vocab, n = 1004, 256
    use_top_k, use_top_p = k > 0, p is not None
    scaled = torch.from_numpy(np.random.default_rng(3).standard_normal((n, vocab))
                              .astype(np.float32) * 2)
    masked = _jax_filter(scaled, k, p, use_top_k, use_top_p)
    noise = prng.gumbel_noise_plain(prng.split(prng.PRNGKey(11))[1:], (n, vocab))[0]
    want = torch.argmax(masked + noise, dim=1)
    keep = masked > -1e30
    assert torch.equal(fs.survivor_gumbel_pick(scaled, keep, noise), want)
    got_keep = fs.kernel_keep_sets(scaled, k, p, use_top_k, use_top_p)
    same = (got_keep == keep).all(dim=1)
    assert int((~same).sum()) <= 1
    assert torch.equal(fs.survivor_gumbel_pick(scaled, got_keep, noise)[same], want[same])


@pytest.mark.parametrize("seed", [0, 5, -3, 123456789])
def test_launch_key_schedule_is_the_split_chain(seed):
    for steps in (1, 16, 100):
        got = fs.launch_step_keys(prng.PRNGKey(seed), steps)
        np.testing.assert_array_equal(got, prng.sample_step_keys(prng.PRNGKey(seed), steps))
        key, subs = jax.random.PRNGKey(seed), []
        for _ in range(steps):
            key, sub = jax.random.split(key)
            subs.append(np.asarray(sub))
        np.testing.assert_array_equal(got, np.stack(subs).astype(np.uint32))


@pytest.mark.parametrize("clock", ["float32", "short", "strided"])
@pytest.mark.parametrize("kind", ["greedy", "sample"])
def test_decodes_refuse_a_bad_clock(kind, clock):
    """The kernel's optional phase clock is int64, contiguous and holds
    decode_clock_slots(T) = 2 + 4 (T - 1) marks and 4 tile counters;
    anything else is refused before any launch (here before the CPU route is
    ever taken)."""
    slots = fd.decode_clock_slots(6)
    assert slots == 26
    bad = {"float32": torch.zeros(slots),
           "short": torch.zeros(slots - 1, dtype=torch.int64),
           "strided": torch.zeros(2 * slots, dtype=torch.int64)[::2]}[clock]
    cfg = NetConfig(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=6)
    gw = fd.prepare_greedy_weights(a2c.init(torch.Generator().manual_seed(5), cfg)["policy"],
                                   torch.float32)
    assert gw.head is None and gw.xg is None  # built on CUDA only
    feats = torch.zeros((2, 16))
    start = torch.full((2,), START_ID, dtype=torch.int32)
    with pytest.raises(ValueError, match="clock"):
        if kind == "greedy":
            fd.fused_greedy_decode(gw, feats, start, 6, clock=bad)
        else:
            fs.fused_sample_decode(gw, feats, start, prng.PRNGKey(0), 6, clock=bad)
