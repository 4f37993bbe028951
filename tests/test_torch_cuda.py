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
"""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.models import a2c
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

CFG = NetConfig(vocab_size=60, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=7)
T = CFG.max_seq_len
BEAM = 3
N = 20
NEAR_TIE = 1e-4
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
