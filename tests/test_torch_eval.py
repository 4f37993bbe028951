"""PyTorch port vs the JAX package: the main path's evaluation half.

``load_a2c_models`` reads ``.pt`` files that the JAX package wrote;
``test_a2c_network`` decodes random val draws with the value-guided beam
and dumps the real captions, the generated captions and the image urls;
``calculate_a2c_network_score`` scores the dumps and ``post_process_data``
picks the best five. The port runs on the CPU in float32 (its beam's plain
version), the JAX package its XLA beam (``use_fused_kernel=False``) at
``precision="highest"``. The dumps must be byte-identical: the same draws
(``default_rng(seed + 5)``, with replacement), the same Q9 slices, the same
padded groups and the same tokens. Scores must be equal and the files the
two write byte-identical.
"""

import dataclasses
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import api as japi
from image_captioning_through_rl_tpu import config as jconfig
from image_captioning_through_rl_tpu.data import coco as jcoco
from image_captioning_through_rl_tpu.metrics import calculate_a2c_network_score as jscore_files
from image_captioning_through_rl_tpu.metrics.postprocess import post_process_data as jpost
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu.train.loops import load_a2c_models as jload
from image_captioning_through_rl_tpu.train.loops import test_a2c_network as jeval
from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch import api as tapi
from image_captioning_through_rl_tpu_torch import config as tconfig
from image_captioning_through_rl_tpu_torch.data import coco as tcoco
from image_captioning_through_rl_tpu_torch.metrics import (
    calculate_a2c_network_score as tscore_files,
)
from image_captioning_through_rl_tpu_torch.metrics.postprocess import post_process_data as tpost
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.parallel import make_mesh
from image_captioning_through_rl_tpu_torch.train.loops import load_a2c_models as tload
from image_captioning_through_rl_tpu_torch.train.loops import test_a2c_network as teval

torch.set_num_threads(1)

SMALL = dict(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16)
NET_DIMS = dict(wordvec_dim=16, hidden_dim=16)  # vocabulary and input from the bundle
COCO = dict(vocab_size=1004, input_dim=512, wordvec_dim=512, hidden_dim=512)
DUMPS = ("real_captions_path", "generated_captions_path", "image_urls_path")


def _bundle(seed: int, vocab: int, feat_dim: int, n_images: int = 60,
            start_column: bool = True):
    """One in-memory COCO-layout bundle as both packages' ``CocoData``:
    captions <START> words <END> <NULL>* of length 17, two per image; with
    ``start_column=False`` column 0 holds random words instead of <START>."""
    rng = np.random.default_rng(seed)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, vocab)]
    n = 2 * n_images
    lens = rng.integers(4, 18, size=n)
    pos = np.arange(17)[None]
    caps = np.where(pos < lens[:, None] - 1, rng.integers(4, vocab, size=(n, 17)), 0)
    caps[np.arange(n), lens - 1] = 2
    caps[:, 0] = START_ID if start_column else rng.integers(3, vocab, size=n)
    caps = caps.astype(np.int32)
    idxs = np.repeat(np.arange(n_images), 2).astype(np.int32)
    feats = rng.standard_normal((n_images, feat_dim)).astype(np.float32)
    urls = np.array([f"http://example.com/val/{i}.jpg" for i in range(n_images)])
    fields = dict(
        train_captions=caps, train_image_idxs=idxs, val_captions=caps, val_image_idxs=idxs,
        train_features=feats, val_features=feats, word_to_idx={w: i for i, w in enumerate(words)},
        idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
        train_captions_lens=tcoco.caption_lengths(caps),
        val_captions_lens=tcoco.caption_lengths(caps))
    return jcoco.CocoData(**fields), tcoco.CocoData(**fields)


def _params(dims: dict, key: int = 0):
    jp = ja2c.init(jax.random.PRNGKey(key), jconfig.NetConfig(**dims))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _paths(d):
    os.makedirs(d, exist_ok=True)
    return {
        "real_captions_path": os.path.join(d, "real.txt"),
        "generated_captions_path": os.path.join(d, "gen.txt"),
        "image_urls_path": os.path.join(d, "urls.txt"),
        "best_score_file_path": os.path.join(d, "best_scores.txt"),
        "best_score_images_path": os.path.join(d, "best_images"),
    }


def _run_both(tmp, jdata, tdata, jp, tp, dims, beam=5, **kw):
    """Both packages' ``test_a2c_network`` on the same bundle and weights;
    returns the two dump dicts."""
    jpaths, tpaths = _paths(os.path.join(tmp, "jax")), _paths(os.path.join(tmp, "torch"))
    jeval(jp, jconfig.NetConfig(precision="highest", **dims), jdata, jpaths,
          dcfg=jconfig.DecodeConfig(beam_size=beam), use_fused_kernel=False, **kw)
    teval(tp, tconfig.NetConfig(**dims), tdata, tpaths,
          dcfg=tconfig.DecodeConfig(beam_size=beam), device="cpu", **kw)
    return jpaths, tpaths


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _assert_dumps_equal(jpaths, tpaths):
    for key in DUMPS:
        assert _read(tpaths[key]) == _read(jpaths[key]), key


@pytest.fixture(scope="module")
def small():
    jdata, tdata = _bundle(0, SMALL["vocab_size"], SMALL["input_dim"])
    return jdata, tdata, *_params(SMALL)


@pytest.mark.parametrize("compat_dump", [False, True])
@pytest.mark.parametrize("eval_superbatch", [2, 8])
def test_dumps_match_jax(small, tmp_path, eval_superbatch, compat_dump):
    """300 draws: slices of 127, 127 and 44 rows (every 128th draw dropped),
    in groups of 254 (the last one padded from 44) or one group of 1016
    (padded from 298)."""
    jdata, tdata, jp, tp = small
    jpaths, tpaths = _run_both(str(tmp_path), jdata, tdata, jp, tp, SMALL, data_size=300,
                               eval_superbatch=eval_superbatch, compat_dump=compat_dump, seed=3)
    _assert_dumps_equal(jpaths, tpaths)
    lines = _read(tpaths["generated_captions_path"]).decode().splitlines()
    assert len(lines) == (298 - 3 + 1 if compat_dump else 298)  # Q13 merges slice ends
    if not compat_dump:
        assert all(line.startswith("<START>") for line in lines)


def test_dumps_follow_the_draws_start_column(tmp_path):
    """The beam starts from each draw's caption column 0, not from
    ``START_ID``: a bundle whose column 0 holds other words."""
    jdata, tdata = _bundle(1, SMALL["vocab_size"], SMALL["input_dim"], start_column=False)
    jp, tp = _params(SMALL, key=1)
    jpaths, tpaths = _run_both(str(tmp_path), jdata, tdata, jp, tp, SMALL, data_size=300,
                               eval_superbatch=2, seed=4)
    _assert_dumps_equal(jpaths, tpaths)
    real = _read(tpaths["real_captions_path"]).decode().splitlines()
    gen = _read(tpaths["generated_captions_path"]).decode().splitlines()
    firsts = {line.split()[0] for line in gen}
    assert len(firsts) > 1 and "<START>" not in firsts
    assert [r.split()[0] for r in real] == [g.split()[0] for g in gen]


def test_dumps_match_jax_at_coco_width(tmp_path):
    """V = 1004, E = H = F = 512, B = 5, 140 draws: slices of 70 and 69
    rows decoded as one group padded to 140."""
    jdata, tdata = _bundle(2, COCO["vocab_size"], COCO["input_dim"], n_images=200)
    jp, tp = _params(COCO, key=2)
    jpaths, tpaths = _run_both(str(tmp_path), jdata, tdata, jp, tp, COCO, data_size=140,
                               validation_batch_size=71, eval_superbatch=2, seed=5)
    _assert_dumps_equal(jpaths, tpaths)
    assert len(_read(tpaths["generated_captions_path"]).decode().splitlines()) == 139


def _write_pt_files(d, jp):
    """The three ``.pt`` files of a finished model, written by the JAX
    package: the policy and value networks from other weights than the a2c
    file, which holds both."""
    cfg = jconfig.NetConfig(**SMALL)
    paths = {"policy_network": os.path.join(d, "policyNetwork.pt"),
             "value_network": os.path.join(d, "valueNetwork.pt")}
    jckpt.save_network_pt("policy", jpolicy.init(jax.random.PRNGKey(7), cfg),
                          paths["policy_network"])
    jckpt.save_network_pt("value", jvalue.init(jax.random.PRNGKey(8), cfg),
                          paths["value_network"])
    model = os.path.join(d, "a2cNetwork.pt")
    jckpt.save_network_pt("a2c", jp, model)
    return model, paths


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(tree[k])


def test_dumps_on_a_mesh_equal_the_unsharded_run(small, tmp_path):
    """The evaluation on a mesh of two CPU entries (each group's beam
    sharded over the ``data`` axis) writes dumps byte-identical to the
    unsharded run's."""
    _, tdata, _, tp = small
    cfg = tconfig.NetConfig(**SMALL)
    one, two = _paths(str(tmp_path / "one")), _paths(str(tmp_path / "two"))
    kw = dict(data_size=300, eval_superbatch=2, seed=3, device="cpu",
              dcfg=tconfig.DecodeConfig(beam_size=5))
    teval(tp, cfg, tdata, one, **kw)
    teval(tp, cfg, tdata, two, mesh=make_mesh(devices=["cpu"] * 2), **kw)
    for key in DUMPS:
        assert _read(two[key]) == _read(one[key]), key


def test_the_beam_runs_through_the_api_name(small, tmp_path, monkeypatch):
    """``Captioner.caption_tokens(beam_size=...)`` and the evaluation's
    dumps both reach the beam wrapper through ``api.fused_beam_search``, the
    name the benchmark's calibration replaces to plant its faults."""
    _, tdata, _, tp = small
    cfg = tconfig.NetConfig(**SMALL)
    word = 7
    orig, calls = tapi.fused_beam_search, []

    def altered(*args, **kw):
        toks, scores = orig(*args, **kw)
        calls.append(toks.shape[0])
        return torch.full_like(toks, word), scores

    monkeypatch.setattr(tapi, "fused_beam_search", altered)
    cap = tapi.Captioner(tp, cfg, tdata.idx_to_word, device="cpu")
    feats = np.asarray(tdata.val_features[:6])
    assert (cap.caption_tokens(feats, beam_size=5) == word).all()
    assert calls == [6]
    p = _paths(str(tmp_path))
    teval(tp, cfg, tdata, p, data_size=300, eval_superbatch=2, seed=3, device="cpu",
          dcfg=tconfig.DecodeConfig(beam_size=5))
    assert calls == [6, 254, 254]
    gen = _read(p["generated_captions_path"]).decode().splitlines()
    assert len(gen) == 298 and set(gen) == {" ".join([f"w{word}"] * cfg.max_seq_len)}


def test_load_a2c_models_matches_jax(small, tmp_path):
    jdata, tdata, jp, _ = small
    model, paths = _write_pt_files(str(tmp_path), jp)
    jparams, jcfg = jload(model, jdata, paths, False, net_dims=NET_DIMS)
    tparams, tcfg = tload(model, tdata, paths, False, net_dims=NET_DIMS, device="cpu")
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(_np(tparams)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for f in dataclasses.fields(tconfig.NetConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tparams["policy"]["embedding"].device.type == "cpu"
    os.remove(paths["value_network"])
    with pytest.raises(FileNotFoundError):
        tload(model, tdata, paths, False, device="cpu")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def test_main_path_scores_and_post_processing_match_jax(small, tmp_path, monkeypatch):
    """The slice as a whole: load the ``.pt`` files, evaluate, score and
    post-process in both packages. Equal score dicts, byte-equal dumps,
    ``results.txt`` and ``best_scores.txt``, and the same downloads."""
    jdata, tdata, jp, _ = small
    model, paths = _write_pt_files(str(tmp_path), jp)
    jparams, jcfg = jload(model, jdata, paths, False, net_dims=NET_DIMS)
    tparams, tcfg = tload(model, tdata, paths, False, net_dims=NET_DIMS, device="cpu")
    out = {}
    for name, params, cfg, data, run, score, post, calls in (
            ("jax", jparams, dataclasses.replace(jcfg, precision="highest"), jdata,
             lambda *a, **k: jeval(*a, use_fused_kernel=False, **k), jscore_files, jpost, []),
            ("torch", tparams, tcfg, tdata, lambda *a, **k: teval(*a, device="cpu", **k),
             tscore_files, tpost, [])):
        p = _paths(str(tmp_path / name))
        p["results_path"] = str(tmp_path / name / "results.txt")
        run(params, cfg, data, p, data_size=300, eval_superbatch=8, seed=6)
        scores = score(p, p)
        monkeypatch.setattr(urllib.request, "urlretrieve",
                            lambda url, fn, calls=calls: calls.append(
                                (url, os.path.relpath(fn, p["best_score_images_path"]))))
        post(p, top_item_count=5)
        out[name] = (p, scores, calls)
    (jp_, jscores, jcalls), (tp_, tscores, tcalls) = out["jax"], out["torch"]
    _assert_dumps_equal(jp_, tp_)
    assert tscores == jscores
    assert list(tscores) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                             "CIDEr"]
    assert all(np.isfinite(v) for v in tscores.values())
    assert _read(tp_["results_path"]) == _read(jp_["results_path"])
    assert _read(tp_["best_score_file_path"]) == _read(jp_["best_score_file_path"])
    assert len(_read(tp_["best_score_file_path"]).decode().splitlines()) == 5
    assert tcalls == jcalls and len(tcalls) == 5


def test_post_process_tolerates_download_failures(tmp_path, monkeypatch):
    p = _paths(str(tmp_path))
    for key, lines in zip(DUMPS, (["a b c", "d e f"], ["a b c", "d e"],
                                  ["http://img/0.jpg", "http://img/1.jpg"])):
        with open(p[key], "w") as f:
            f.write("\n".join(lines) + "\n")

    def boom(url, fn):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", boom)
    tpost(p, top_item_count=2)  # printed, not raised (utilities.py:272-278)
    lines = _read(p["best_score_file_path"]).decode().splitlines()
    assert len(lines) == 2 and lines[0].startswith("item_index[1] ")


def test_evaluate_captions_matches_jax():
    real = ["a dog runs fast\n", "the cat sits on the mat", "x y z"]
    gen = ["a dog runs", " the cat sits on a mat ", "completely different"]
    assert tapi.evaluate_captions(real, gen) == japi.evaluate_captions(real, gen)


def test_unported_modes_raise(small, tmp_path):
    """A bidirectional model forced onto the beam kernel raises
    ``ValueError`` before anything is drawn or written, and a bidirectional
    load reaches its files."""
    _, tdata, _, tp = small
    p = _paths(str(tmp_path))
    cfg = tconfig.NetConfig(**SMALL)
    with pytest.raises(ValueError, match="bidirectional"):
        teval(tp, dataclasses.replace(cfg, bidirectional=True), tdata, p, data_size=10,
              device="cpu", use_fused_kernel=True)
    with pytest.raises(FileNotFoundError):
        tload(str(tmp_path / "a2c.pt"), tdata, {k: str(tmp_path / f"{k}.pt")
                                                for k in ("policy_network", "value_network")},
              True, device="cpu")
    assert not any(os.path.exists(p[k]) for k in DUMPS)


def test_forcing_the_kernel_on_the_cpu_raises(small, tmp_path):
    _, tdata, _, tp = small
    p = _paths(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        teval(tp, tconfig.NetConfig(**SMALL), tdata, p, data_size=10, device="cpu",
              use_fused_kernel=True)
    assert not any(os.path.exists(p[k]) for k in DUMPS)


@pytest.mark.parametrize("entry", ["load_a2c_models", "test_a2c_network"])
def test_entry_points_default_to_the_card(entry, small, tmp_path, monkeypatch):
    """With no CUDA device the default raises instead of running on the
    CPU, and nothing is written."""
    jdata, tdata, jp, tp = small
    model, paths = _write_pt_files(str(tmp_path), jp)
    p = _paths(str(tmp_path / "dumps"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"load_a2c_models": lambda: tload(model, tdata, paths, False),
            "test_a2c_network": lambda: teval(tp, tconfig.NetConfig(**SMALL), tdata, p,
                                              data_size=10)}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    assert not any(os.path.exists(p[k]) for k in DUMPS)
