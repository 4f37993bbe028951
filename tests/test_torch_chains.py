"""The port's LSTM and GRU chains vs the JAX package's Pallas chains.

On the CPU, ``fused_lstm_chain`` / ``fused_gru_chain`` run their plain
versions (the kernels' oracles); the JAX side runs its Pallas kernels in
interpret mode, as ``tests/test_pallas_lstm.py`` does. Weights come from
the JAX initialisers, tokens, initial states and the upstream gradient from
a seeded numpy generator, over a ragged batch (13 rows against the JAX
kernels' 8-row tiles).

Tolerances. With float32 weights both sides compute the same function in
another order of float32 sums: hs to rtol 1e-5, every gradient to
rtol 1e-4, atol 1e-6 (as ``tests/test_pallas_lstm.py``). With bf16 weights
both round the embedding row, h and the gate gradients to bf16 before
their products; where the two float32 sums straddle a bf16 rounding
boundary the operand moves by one bf16 step (2^-8 relative), so hs and
every gradient are held by relative Frobenius error, 2e-3 (measured:
below 3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.models.initializers import embedding_init, gru_init, lstm_init
from image_captioning_through_rl_tpu.ops.pallas_gru import fused_gru_chain as jax_gru_chain
from image_captioning_through_rl_tpu.ops.pallas_lstm import fused_lstm_chain as jax_lstm_chain
from image_captioning_through_rl_tpu_torch.models.convert import from_jax_params
from image_captioning_through_rl_tpu_torch.ops.fused_gru import (
    fused_gru_chain,
    gru_chain_plain,
    gru_chain_plan,
)
from image_captioning_through_rl_tpu_torch.ops.fused_lstm import (
    _check_chain_inputs,
    fused_lstm_chain,
    lstm_chain_plain,
    lstm_chain_plan,
)
from image_captioning_through_rl_tpu_torch.ops.rnn import gru_scan, lstm_scan

torch.set_num_threads(1)

N, T, E, H, V = 13, 7, 16, 16, 30
WEIGHT_TYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(kind):
    rng = np.random.default_rng(11)
    init = lstm_init if kind == "lstm" else gru_init
    jp = init(jax.random.PRNGKey(0), E, H)
    emb = np.asarray(embedding_init(jax.random.PRNGKey(1), V, E))
    toks = rng.integers(0, V, size=(N, T)).astype(np.int32)
    states = [rng.standard_normal((N, H)).astype(np.float32)
              for _ in range(2 if kind == "lstm" else 1)]
    dhs = rng.standard_normal((N, T, H)).astype(np.float32)
    return jax.tree.map(np.asarray, jp), emb, toks, states, dhs


def _jax_side(kind, jp, emb, toks, states, dhs, wd):
    chain = jax_lstm_chain if kind == "lstm" else jax_gru_chain

    def loss(p, e, *s):
        hs = chain(p, e, jnp.asarray(toks), *s, block_n=8, weight_dtype=wd, interpret=True)
        return jnp.sum(hs * dhs), hs

    (_, hs), grads = jax.value_and_grad(loss, argnums=tuple(range(2 + len(states))),
                                        has_aux=True)(jp, emb, *states)
    gp, ge, *gs = grads
    return [np.asarray(hs), *[np.asarray(gp[k]) for k in jp], np.asarray(ge),
            *map(np.asarray, gs)]


def _port_side(kind, jp, emb, toks, states, dhs, wd, use_fused_kernel=None):
    chain = fused_lstm_chain if kind == "lstm" else fused_gru_chain
    params = {k: v.requires_grad_() for k, v in from_jax_params(jp).items()}
    e = torch.from_numpy(emb.copy()).requires_grad_()
    s = [torch.from_numpy(x).requires_grad_() for x in states]
    hs = chain(params, e, torch.from_numpy(toks), *s, weight_dtype=wd,
               use_fused_kernel=use_fused_kernel)
    grads = torch.autograd.grad(hs, [*params.values(), e, *s], torch.from_numpy(dhs))
    return [hs.detach().numpy(), *[g.numpy() for g in grads]]


@pytest.mark.parametrize("wd", list(WEIGHT_TYPES))
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_chain_matches_jax_pallas_chain(kind, wd):
    case = _case(kind)
    t_wd, j_wd = WEIGHT_TYPES[wd]
    want = _jax_side(kind, *case, j_wd)
    got = _port_side(kind, *case, t_wd)
    names = ["hs", *case[0], "embedding", "h0", "c0"]
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        if wd == "float32":
            tol = dict(rtol=1e-5, atol=1e-6) if name == "hs" else dict(rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a, b, err_msg=name, **tol)
        else:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 2e-3, f"{kind} {name}: relative error {rel:.3g}"


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_plain_chain_equals_autograd_of_eager_scan(kind):
    """With float32 weights the plain chain and its hand-written backward
    are autograd of the port's eager scan, to float32 rounding."""
    jp, emb, toks, states, dhs = _case(kind)
    got = _port_side(kind, jp, emb, toks, states, dhs, torch.float32, use_fused_kernel=False)
    params = {k: v.requires_grad_() for k, v in from_jax_params(jp).items()}
    e = torch.from_numpy(emb.copy()).requires_grad_()
    s = [torch.from_numpy(x).requires_grad_() for x in states]
    xs = e[torch.from_numpy(toks).long()].transpose(0, 1)
    if kind == "lstm":
        hs, _ = lstm_scan(params, xs, tuple(s))
    else:
        hs, _ = gru_scan(params, xs, s[0])
    hs = hs.transpose(0, 1)
    want = [hs.detach().numpy(), *[g.numpy() for g in torch.autograd.grad(
        hs, [*params.values(), e, *s], torch.from_numpy(dhs))]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_chains_route_by_device_without_fallback():
    """CPU tensors run the plain versions; forcing the kernels on CPU
    tensors raises instead of falling back."""
    for kind, chain, plain in (("lstm", fused_lstm_chain, lstm_chain_plain),
                               ("gru", fused_gru_chain, gru_chain_plain)):
        jp, emb, toks, states, _ = _case(kind)
        params = from_jax_params(jp)
        args = (params, torch.from_numpy(emb.copy()), torch.from_numpy(toks),
                *map(torch.from_numpy, states))
        before = (chain.fwd_launches, chain.bwd_launches)
        assert torch.equal(chain(*args), plain(*args))
        assert (chain.fwd_launches, chain.bwd_launches) == before
        with pytest.raises(RuntimeError, match="CUDA"):
            chain(*args, use_fused_kernel=True)


def _owners(plan, n, hidden):
    """How many blocks of a chain launch own each row and each unit, walked
    as the kernels walk them (csrc/chain.cuh): block (x, g) owns the slices
    x, x + grid_x, ... and the row tiles g, g + row_groups, ...; it owns a
    (row, unit) pair when it owns both, so each pair falls to exactly one
    block when every row and every unit does."""
    rows, units = plan["rows_per_tile"], plan["units"]
    grid_x, groups = plan["grid"]
    tiles = -(-n // rows)
    row_owners, unit_owners = np.zeros(n, np.int64), np.zeros(hidden, np.int64)
    for g in range(groups):
        for rt in range(g, tiles, groups):
            row_owners[rt * rows:min(n, rt * rows + rows)] += 1
    for x in range(grid_x):
        for sl in range(x, plan["slices"], grid_x):
            unit_owners[sl * units:min(hidden, sl * units + units)] += 1
    return row_owners, unit_owners


@pytest.mark.parametrize("hidden", [500, 512, 1024, 1536, 2048, 4096])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 33, 512, 2000])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_lstm_chain_plan_covers_each_row_and_unit_once(kind, n, wd, backward, hidden):
    """The cooperative launch's plan of either chain on an H100 (132 SMs),
    from below COCO width to 8x it: every (row, unit) falls to exactly one
    block, a block's shared memory fits the 227 KB one block may opt in
    to, and the grid fits what the card holds at once (a cooperative launch
    runs only if every block is resident), one block per SM. Past the
    widths whose weight slices fit beside the ring, the plan streams them."""
    sms = 132
    plan = (lstm_chain_plan if kind == "lstm" else gru_chain_plan)(n, hidden, wd, sms,
                                                                    backward=backward)
    row_owners, unit_owners = _owners(plan, n, hidden)
    assert set(row_owners) == {1} and set(unit_owners) == {1}
    assert plan["smem_bytes"] <= 227 * 1024
    grid_x, groups = plan["grid"]
    assert grid_x * groups <= plan["co_resident"] <= sms * min(
        1, 233472 // (plan["smem_bytes"] + 1024))
    assert groups == max(1, min(-(-n // plan["rows_per_tile"]), plan["co_resident"] // grid_x))
    assert plan["units"] in ((32, 16, 8) if wd == torch.bfloat16 else (8,))
    if not plan["stream"]:  # a stationary slice has a block of its own
        assert grid_x == plan["slices"]
    if hidden == 512:  # COCO width keeps each slice stationary, one block per slice
        assert not plan["stream"] and grid_x == plan["slices"]


def test_lstm_chain_plan_refuses_what_one_sm_cannot_hold():
    """What one SM cannot hold is streamed, not refused: H = 2048 plans,
    bf16 and float32, forward and backward, within one block per SM."""
    for wd in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            plan = lstm_chain_plan(512, 2048, wd, 132, backward=backward)
            assert plan["stream"] and plan["smem_bytes"] <= 227 * 1024
            assert plan["grid"][0] * plan["grid"][1] <= 132


def test_chain_token_range_is_checked_on_the_device():
    """The token-range check is a device assertion, not a host sync: on CPU
    tensors it raises at once; in range it passes."""
    jp, emb, toks, states, _ = _case("lstm")
    args = (from_jax_params(jp), torch.from_numpy(emb.copy()))
    states = tuple(map(torch.from_numpy, states))
    for tokens, ok in ((toks, True), (toks + V, False), (toks - V, False)):
        if ok:
            _check_chain_inputs("fused_lstm_chain", *args, torch.from_numpy(tokens), states, 4,
                                torch.bfloat16)
            continue
        with pytest.raises(RuntimeError, match="tokens must lie"):
            _check_chain_inputs("fused_lstm_chain", *args, torch.from_numpy(tokens), states, 4,
                                torch.bfloat16)
