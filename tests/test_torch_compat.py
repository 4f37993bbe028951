"""The reference-exact paths: the port against the JAX package, on the CPU.

Small widths (V = 25, F = 12, E = 14, H = 16, T = 7, as
``tests/test_torch_bidirectional.py``), weights from the JAX initialisers
carried across with ``from_jax_params``, inputs from a seeded numpy
generator, the JAX side at ``precision="highest"``; each case in both
direction modes where the JAX package has both. Held:

  * ``flat_stream_scan`` (LSTM and GRU) and ``column_stream_scan_bidi``,
    with the carry threaded across two calls: outputs and carries to
    rtol 1e-5, atol 1e-6;
  * ``forward_compat`` of the value and reward networks over two calls,
    at the same tolerance;
  * the faithful (Q2) carried beam and full-prefix beam, and
    ``beam_search_compat``: tokens exactly, scores to rtol 1e-5, the carry
    out (scores near 0 to atol 1e-6); the NaN ranking of Q2b (a mixed and
    an all-negative head);
  * ``test_a2c_network`` in the faithful mode with ``compat_dump``, a short
    tail slice included: the three dumps byte-identical to the JAX
    package's; forcing the beam kernel there raises;
  * ``Captioner.caption_tokens(faithful_beam=True)`` against the JAX
    ``Captioner``'s tokens.

The compat steps and trainers are in ``tests/test_torch_compat_train.py``,
``cli/verify_reference`` in ``tests/test_torch_verify_reference.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import api as japi
from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.decode import beam_search as jbeam
from image_captioning_through_rl_tpu.decode.beam_compat import beam_search_compat as jcompat
from image_captioning_through_rl_tpu.decode.beam_full import beam_search_full_prefix as jfull
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.ops import rnn as jrnn
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu_torch import api as tapi
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths
from image_captioning_through_rl_tpu_torch.decode import (
    beam_search,
    beam_search_compat,
    beam_search_full_prefix,
)
from image_captioning_through_rl_tpu_torch.models import from_jax_params, reward, value
from image_captioning_through_rl_tpu_torch.ops import rnn
from image_captioning_through_rl_tpu_torch.train import loops as tloops

torch.set_num_threads(1)

V, F, E, H, T = 25, 12, 14, 16, 7
N = 9
TOL = dict(rtol=1e-5, atol=1e-6)
JMODS = {"policy": jpolicy, "value": jvalue, "reward": jreward, "a2c": ja2c}
WORDS = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
BIDI = pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])


def _cfgs(bidirectional: bool, t: int = T):
    kw = dict(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=t,
              bidirectional=bidirectional)
    return jconfig.NetConfig(precision="highest", **kw), tconfig.NetConfig(**kw)


def _pair(kind, bidirectional, key=0):
    jcfg, _ = _cfgs(bidirectional)
    jp = JMODS[kind].init(jax.random.PRNGKey(key), jcfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _batch(seed, n=N, t=T):
    """<START> w* <END> <NULL>* captions of length ``t`` and features."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, V, size=(n, t)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=n)
    caps[np.arange(n), lens - 1] = 2
    caps[np.arange(t)[None, :] >= lens[:, None]] = 0
    return rng.standard_normal((n, F)).astype(np.float32), caps


def _named(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _close_trees(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        _close(x.detach() if isinstance(x, torch.Tensor) else x, y)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _tree_t(tree):
    return jax.tree.map(lambda x: _t(np.array(x)), tree)


# --------------------------------------------------------------------------
# the streams and the compat forwards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lstm", "gru"])
@BIDI
def test_stream_scans_match_jax(kind, bidirectional):
    """Two calls, the second from the first's carry: outputs and carries."""
    rng = np.random.default_rng(1)
    init = {"lstm": jpolicy.lstm_init, "gru": jreward.gru_init}[kind]
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    jps = [jax.tree.map(np.asarray, init(k, E, H)) for k in keys]
    tps = [from_jax_params(p) for p in jps]

    def state():
        h = rng.standard_normal(H).astype(np.float32)
        return (h, rng.standard_normal(H).astype(np.float32)) if kind == "lstm" else h

    jcarry = (state(), state()) if bidirectional else state()
    tcarry = _tree_t(jcarry)
    for call in range(2):
        if bidirectional:
            xs = rng.standard_normal((4, 5, E)).astype(np.float32)  # [T, N, E]
            jout, jcarry = jrnn.column_stream_scan_bidi(kind, *jps, xs, jcarry,
                                                        precision="highest")
            tout, tcarry = rnn.column_stream_scan_bidi(kind, *tps, _t(xs), tcarry)
            assert tout.shape == (5, 2 * H)
        else:
            xs = rng.standard_normal((23, E)).astype(np.float32)  # [L, E]
            jout, jcarry = jrnn.flat_stream_scan(kind, jps[0], xs, jcarry, precision="highest")
            tout, tcarry = rnn.flat_stream_scan(kind, tps[0], _t(xs), tcarry)
            assert tout.shape == (23, H)
        _close(tout, jout)
        _close_trees(tcarry, jcarry)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, tcarry)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, jcarry))


@pytest.mark.parametrize("kind", ["value", "reward"])
@BIDI
def test_forward_compat_matches_jax(kind, bidirectional):
    jcfg, tcfg = _cfgs(bidirectional)
    jp, tp = _pair(kind, bidirectional, 3)
    jmod, tmod = (jvalue, value) if kind == "value" else (jreward, reward)
    jcarry, tcarry = jmod.compat_zero_state(jcfg), tmod.compat_zero_state(tcfg)
    _close_trees(tcarry, jcarry)
    for seed in (4, 5):  # the second call continues the first's carry
        feats, caps = _batch(seed)
        jout, jcarry = jmod.forward_compat(jp, jcfg, feats, caps, jcarry)
        tout, tcarry = tmod.forward_compat(tp, tcfg, _t(feats), _t(caps, torch.long), tcarry)
        _close_trees(tout, jout)
        _close_trees(tcarry, jcarry)


# --------------------------------------------------------------------------
# the faithful beams
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["uni", "bi"])
def nets(request):
    bidirectional = request.param
    return bidirectional, _pair("a2c", bidirectional, 6)


def _faithful(t=T, beam=5):
    return (jconfig.DecodeConfig(beam_size=beam, max_seq_len=t, per_sample_beams=False),
            tconfig.DecodeConfig(beam_size=beam, max_seq_len=t, per_sample_beams=False))


def test_faithful_beams_match_jax(nets):
    """The Q2 carried beam and the Q2 full-prefix oracle, each against the
    JAX one (tokens exactly, scores to rtol 1e-5) and against each other."""
    bidirectional, (jp, tp) = nets
    jcfg, tcfg = _cfgs(bidirectional)
    jd, td = _faithful()
    feats, _ = _batch(7)
    start = np.ones(N, np.int32)
    f, s = _t(feats), _t(start)
    with torch.no_grad():
        got = beam_search(tp["policy"], tp["value"], tcfg, td, f, s)
        oracle = beam_search_full_prefix(tp["policy"], tp["value"], tcfg, td, f, s,
                                         margins=True)
    for ours, jfn in ((got, jbeam), (oracle[:2], jfull)):
        want = jfn(jp["policy"], jp["value"], jcfg, jd, feats, start)
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(want[0]))
        _close(ours[1], want[1])
    np.testing.assert_array_equal(got[0].numpy(), oracle[0].numpy())
    # one shared selection: every row's beam took the same parents, the
    # margins one gap a step for the whole batch
    assert oracle[2].shape == (N, T - 1) and bool((oracle[2] == oracle[2][:1]).all())


def test_beam_search_compat_matches_jax(nets):
    """Tokens exactly, scores to rtol 1e-5 and the carry out, from a zero
    carry and from the first call's carry."""
    bidirectional, (jp, tp) = nets
    jcfg, tcfg = _cfgs(bidirectional)
    jd, td = _faithful()
    feats, _ = _batch(8)
    start = np.ones(N, np.int32)
    jcarry = tcarry = None
    for _ in range(2):
        jt, js, jcarry = jcompat(jp["policy"], jp["value"], jcfg, jd, feats, start,
                                 carry=jcarry)
        with torch.no_grad():
            tt, ts, tcarry, gaps = beam_search_compat(tp["policy"], tp["value"], tcfg, td,
                                                      _t(feats), _t(start), carry=tcarry,
                                                      margins=True)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        _close(ts, js)
        _close_trees(tcarry, jcarry)
        assert gaps.shape == (T - 1,) and bool((gaps >= 0).all())


def test_beam_search_compat_nan_scores_rank_last():
    """Q2b's NaN scores (a negative top-``B`` logit) rank last, as in the
    JAX package's ``tests/test_decode.py``: with two positive logits the
    finite candidates fill beams 0-1; with every logit negative every
    score is NaN and the decode stays deterministic — and equal to the JAX
    package's in both cases."""
    jcfg, tcfg = _cfgs(False, t=5)
    jp, tp = _pair("a2c", False, 20)
    jd, td = _faithful(t=5, beam=3)
    feats = np.random.default_rng(9).standard_normal((3, F)).astype(np.float32)
    start = np.ones(3, np.int32)
    mixed = np.full(V, -50.0, np.float32)
    mixed[5], mixed[7] = 40.0, 38.0
    for bias in (mixed, np.full(V, -50.0, np.float32)):
        jpp = {**jp["policy"], "head": {**jp["policy"]["head"], "b": jnp.asarray(bias)}}
        tpp = {**tp["policy"], "head": {**tp["policy"]["head"], "b": _t(bias)}}
        jt, js, _ = jcompat(jpp, jp["value"], jcfg, jd, feats, start)
        with torch.no_grad():
            runs = [beam_search_compat(tpp, tp["value"], tcfg, td, _t(feats), _t(start))
                    for _ in range(2)]
        np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())
        np.testing.assert_array_equal(runs[0][0].numpy(), np.asarray(jt))
        s = runs[0][1].numpy()
        np.testing.assert_array_equal(np.isnan(s), np.isnan(np.asarray(js)))
        if bias is mixed:
            assert np.isfinite(s[:, :2]).all()
            assert set(runs[0][0][:, :2, 1:].reshape(-1).tolist()) <= {5, 7}
        else:
            assert np.isnan(s).all() and runs[0][0].shape == (3, 3, 5)


def _fields(seed=0, n_img=12, n_cap=24, t=T):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, V, size=(n_cap, t)).astype(np.int32)
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=n_cap)
    caps[np.arange(n_cap), lens - 1] = 2
    caps[np.arange(t)[None, :] >= lens[:, None]] = 0
    urls = np.array([f"http://example.com/{i}.jpg" for i in range(n_img)])
    feats = rng.standard_normal((n_img, F)).astype(np.float32)
    idxs = rng.integers(0, n_img, size=n_cap).astype(np.int32)
    return dict(train_captions=caps, train_image_idxs=idxs, val_captions=caps,
                val_image_idxs=idxs, train_features=feats, val_features=feats,
                word_to_idx={w: i for i, w in enumerate(WORDS)},
                idx_to_word=dict(enumerate(WORDS)), train_urls=urls, val_urls=urls,
                train_captions_lens=caption_lengths(caps), val_captions_lens=caption_lengths(caps))



# --------------------------------------------------------------------------
# the faithful evaluation and the Captioner
# --------------------------------------------------------------------------

def _eval_paths(d):
    os.makedirs(d, exist_ok=True)
    return {k: os.path.join(d, f"{k}.txt") for k in
            ("real_captions_path", "generated_captions_path", "image_urls_path")}


def test_faithful_test_a2c_network_dumps_match_jax(nets, tmp_path):
    """170 draws: slices of 127 and 42 rows (the tail decoded at its own
    size), the Q13 merged dumps byte-identical to the JAX package's."""
    bidirectional, (jp, tp) = nets
    jcfg, tcfg = _cfgs(bidirectional)
    fields = _fields(seed=4, n_img=40, n_cap=80)
    jpaths, tpaths = _eval_paths(str(tmp_path / "j")), _eval_paths(str(tmp_path / "t"))
    jloops.test_a2c_network(jp, jcfg, JCocoData(**fields), jpaths, data_size=170,
                            dcfg=_faithful()[0], compat_dump=True)
    tloops.test_a2c_network(tp, tcfg, CocoData(**fields), tpaths, data_size=170,
                            dcfg=_faithful()[1], compat_dump=True, device="cpu")
    for key in jpaths:
        with open(jpaths[key], "rb") as a, open(tpaths[key], "rb") as b:
            assert b.read() == a.read(), key
    with open(tpaths["real_captions_path"]) as f:
        assert len(f.read().splitlines()) == 169 - 1  # Q13: the slice boundary merges
    with pytest.raises(ValueError, match="faithful"):
        tloops.test_a2c_network(tp, tcfg, CocoData(**fields), _eval_paths(str(tmp_path / "x")),
                                data_size=10, dcfg=_faithful()[1], device="cpu",
                                use_fused_kernel=True)


def test_captioner_faithful_beam_matches_jax(nets):
    bidirectional, (jp, tp) = nets
    jcfg, tcfg = _cfgs(bidirectional, t=17)
    feats, _ = _batch(12, n=8)
    want = japi.Captioner(jp, jcfg, dict(enumerate(WORDS))).caption_tokens(
        feats, beam_size=5, faithful_beam=True)
    cap = tapi.Captioner(tp, tcfg, dict(enumerate(WORDS)), device="cpu")
    got = cap.caption_tokens(feats, beam_size=5, faithful_beam=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (8, 17)
    with pytest.raises(ValueError, match="non-faithful"):
        cap.caption_tokens(feats, beam_size=5, faithful_beam=True, use_fused_kernel=True)
