"""The rollout backward's launch plan and its split-K combine, on the CPU (no
GPU needed).

With bf16 weights ``csrc/rollout.cu`` runs the heads' products on
``wgmma``: ``dhw = rnd(h_p)^T rnd(dlogits)`` and ``dw1 = rnd([feats;
h_v])^T rnd(dv1)`` have a depth of S N rows against a few dozen output
tiles, so their depth is cut into parts whose float32 sums are added in the
order p = 0, 1, ... (no atomics: two calls give the same bits). Both
encoders' backward recurrences share one cooperative launch, each on half
the SMs. :func:`fused_rollout.rollout_bwd_plan` mirrors the C plan (the
entry point refuses a plan that differs); these tests hold it to its
contract at widths from 8 to 4096, vocabularies to 10000 and S N from 8 to
16 x 1024 rows (n not a multiple of 8), and hold
:func:`fused_rollout.split_k_product`, the plain model of the combine, to a
one-pass float64 product: within the float32 bound of a sum of K terms,
(K - 1) 2^-24 sum |a_k b_k| per element, and the same bits whatever order
the parts arrive in.
"""

import itertools

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

SMS = 132  # H100 SXM
SMEM_PER_BLOCK = 232448


def _pad8(x):
    return -(-x // 8) * 8


# (steps, n): S N from 8 to 16 x 1024, n not a multiple of 8 among them
DEPTHS = [(1, 8), (2, 12), (16, 12), (4, 33), (16, 500), (16, 512), (16, 1000), (16, 1023),
          (16, 1024)]


@pytest.mark.parametrize("hidden", [8, 16, 256, 500, 512, 1000, 1024, 2048, 4096])
def test_split_k_plan_covers_every_depth_of_every_product_once(hidden):
    for vocab in (8, 1004, 2000, 10000):
        vp = _pad8(vocab)
        for steps, n in DEPTHS:
            p = fr.rollout_bwd_plan(n, steps, hidden, hidden, vp, SMS)
            depth = steps * n
            assert p["depth"] == depth
            # both products have this depth and take the same parts
            parts = p["parts"]
            assert parts >= 1
            ranges = fr.split_k_ranges(depth, parts)
            assert len(ranges) == parts
            seen = np.zeros(depth, dtype=int)
            for k0, k1 in ranges:
                assert k0 % fr.WG_SLICE == 0 and k0 < k1 <= depth, ranges
                if parts > 1:  # a part keeps a few slices of the depth
                    assert k1 - k0 > (fr.SPLITK_MIN_SLICES - 1) * fr.WG_SLICE
                seen[k0:k1] += 1
            assert (seen == 1).all(), (depth, parts)
            # the parts fill the card once, never more than the tiles alone;
            # a card less than half full has as many parts as the depth allows
            tiles = sum(p["tiles"].values())
            blocks = tiles * parts
            assert blocks <= max(SMS, tiles)
            slices = -(-depth // fr.WG_SLICE)
            assert blocks > SMS // 2 or parts == max(1, slices // fr.SPLITK_MIN_SLICES)


def test_split_k_plan_at_coco_width():
    """N = 512, S = 16, E = H = F = 512, V = 1004 (Vp = 1008): dhw and dw1
    have 32 tiles of 128 x 128 each over 8192 rows; two parts each fill 128
    of the 132 SMs, each part 64 slices deep."""
    p = fr.rollout_bwd_plan(512, 16, 512, 512, 1008, SMS)
    assert p["tiles"] == {"dhw": 32, "dw1": 32}
    assert p["parts"] == 2
    assert fr.split_k_ranges(8192, 2) == [(0, 4096), (4096, 8192)]


@pytest.mark.parametrize("depth,parts", [(8, 1), (100, 1), (100, 2), (1000, 1), (1000, 3),
                                         (1000, 5), (8192, 1), (8192, 2), (8192, 5)])
def test_split_k_combine_is_a_fixed_order_sum(depth, parts):
    """The model of the combine against a one-pass float64 product, within
    float32's bound for a sum of ``depth`` terms, and bit-equal whatever
    order the parts arrive in (at most one part per 64-deep slice, as the
    plan asks)."""
    rng = np.random.default_rng(depth * 10 + parts)
    a = rng.standard_normal((depth, 24)).astype(np.float32)
    b = rng.standard_normal((depth, 40)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    first = fr.split_k_product(ta, tb, parts)
    for arrival in itertools.islice(itertools.permutations(range(parts)), 24):
        assert torch.equal(fr.split_k_product(ta, tb, parts, arrival=list(arrival)), first)
    want = a.astype(np.float64).T @ b.astype(np.float64)
    bound = max(depth - 1, 1) * 2.0 ** -24 * (np.abs(a).astype(np.float64).T @ np.abs(b))
    assert (np.abs(first.numpy() - want) <= bound).all()


def _pair_owners(plan, n, hidden):
    """How many blocks of the pair launch own each (chain, row) and each
    (chain, unit), walked as lstm_bwd_pair_kernel walks them: block (x, g,
    c) takes chain c's slices x, x + grid_x, ... and row tiles g,
    g + row_groups, ...; a (chain, row tile, unit) falls to exactly one block
    when every (chain, row) and every (chain, unit) does."""
    c = plan["chains"]
    rows, units = c["rows_per_tile"], c["units"]
    grid_x, groups, chains = plan["grid"]
    tiles = -(-n // rows)
    row_owners = np.zeros((chains, n), np.int64)
    unit_owners = np.zeros((chains, hidden), np.int64)
    for ch in range(chains):
        for g in range(groups):
            for rt in range(g, tiles, groups):
                row_owners[ch, rt * rows:min(n, rt * rows + rows)] += 1
        for x in range(grid_x):
            for sl in range(x, c["slices"], grid_x):
                unit_owners[ch, sl * units:min(hidden, sl * units + units)] += 1
    return row_owners, unit_owners


@pytest.mark.parametrize("hidden", [8, 500, 512, 1000, 1024, 2048, 4096])
@pytest.mark.parametrize("n", [1, 12, 33, 500, 512, 2000])
def test_pair_plan_covers_each_chain_row_tile_and_unit_once(n, hidden):
    """Both chains in one cooperative launch: each (chain, row, unit) to
    exactly one block, every block resident at once (one per SM, the two
    chains' blocks together within the card), a block's shared memory within
    what one block may opt in to."""
    p = fr.rollout_bwd_plan(n, 16, hidden, hidden, 1008, SMS)
    row_owners, unit_owners = _pair_owners(p, n, hidden)
    assert set(row_owners.ravel()) == {1} and set(unit_owners.ravel()) == {1}
    grid_x, groups, chains = p["grid"]
    assert chains == 2 and chains * grid_x * groups <= SMS
    assert p["chains"]["smem_bytes"] <= SMEM_PER_BLOCK
    assert p["chains"] == fr.chain_plan(n, hidden, torch.bfloat16, SMS // 2, backward=True)


def test_pair_plan_at_coco_width():
    """N = 512, H = 512: each chain 16 slices of 32 units x 4 row groups, so
    a block takes two of the eight 64-row tiles a step; 128 blocks."""
    p = fr.rollout_bwd_plan(512, 16, 512, 512, 1008, SMS)
    assert p["grid"] == (16, 4, 2) and p["chains"]["units"] == 32
    assert not p["chains"]["stream"] and -(-512 // p["chains"]["rows_per_tile"]) == 2 * 4
    # each block's 256 threads hold 8 rows of 32 units: 4 x 8 rows of db parts
    assert p["db_rows"] == 32


def test_pair_plan_refuses_what_one_sm_cannot_hold():
    """What half the card cannot hold stationary is streamed, not refused
    (H = 2048 and 4096); a card that cannot give each chain an SM is
    refused."""
    for hidden in (2048, 4096):
        p = fr.rollout_bwd_plan(512, 16, hidden, hidden, 1008, SMS)
        assert p["chains"]["stream"] and p["chains"]["smem_bytes"] <= SMEM_PER_BLOCK
        assert 2 * p["grid"][0] * p["grid"][1] <= SMS
    with pytest.raises(ValueError, match="2 SMs"):
        fr.rollout_bwd_plan(512, 16, 512, 512, 1008, 1)
