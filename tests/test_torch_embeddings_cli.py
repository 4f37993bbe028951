"""The port's CLI with word vectors against the JAX CLI, on the CPU.

One synthetic bundle (the JAX package's ``make_synthetic_coco``: 24
training and 12 validation captions, V = 40, F = 32) whose vocabulary file
is rewritten to letters-only words (``waaa``, ``waab``, ...; the four
specials keep their ids): the generator's ``word0``... would all become
``word`` under ``simple_preprocess`` and align to nothing. The networks run
at ``--hidden_dim 32``; the word vectors fix E = 300 and freeze the tables
(``--wordvec_dim`` is dropped). As in ``tests/test_torch_cli.py``, the
port's networks start from the JAX initialisers' weights, numpy's global
generator is seeded before each run, and the trainers walk one minibatch of
8 captions a step (``--chunk_steps 1``). To run in seconds on the CPU, both
packages' pretrainers take 3 epochs each (the CLI's 50 / 100 / 50) and SGNS
batches of 256 pairs and fastText 4096 buckets (65536 and 131072 in the CLI;
its 30 epochs are kept). Held:
  * ``--train_word2vec word2vec|fasttext --save_word2vec --retrain``: the
    saved vectors against the JAX CLI's (30 epochs: rtol 1e-4, atol 1e-5, the
    bound of ``tests/test_torch_embeddings.py``'s 40-epoch run), the aligned
    tables' rows for words found in them equal to the saved vectors, the
    random rows of the specials equal to the JAX CLI's, and every logged
    loss, reward and advantage within rtol 1e-4 of the JAX CLI's;
  * ``--pretrained_word2vec <file> --retrain`` (a path, and a name resolved in
    ``$ICRL_EMBEDDINGS_DIR``): the aligned table equal to the JAX CLI's, every
    network's table in every checkpoint bit-equal to it (frozen through the
    three pretrainers and A2C), every logged value within rtol 1e-4;
  * ``--test_model --pretrained_word2vec`` on JAX-written E = 300 checkpoints:
    the three dumps byte-identical, the scores within 1e-12. Without the
    vectors the port refuses the checkpoint, whose shapes its reader checks
    against the config (E = 512 then); the JAX CLI's reader (flax's) does not
    check them and loads it.
"""

import ast
import dataclasses
import functools
import importlib
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.data.synthetic import make_synthetic_coco
from image_captioning_through_rl_tpu.embeddings import word2vec as jw
from image_captioning_through_rl_tpu.models import policy as jpolicy
from image_captioning_through_rl_tpu.models import reward as jreward
from image_captioning_through_rl_tpu.models import value as jvalue
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu.train import loops as jloops
from image_captioning_through_rl_tpu_torch import embeddings as temb
from image_captioning_through_rl_tpu_torch.embeddings import word2vec as tw
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.train import loops as tloops

jmain = importlib.import_module("image_captioning_through_rl_tpu.cli.main")
tmain = importlib.import_module("image_captioning_through_rl_tpu_torch.cli.main")
torch.set_num_threads(1)

V, F, H, E = 40, 32, 32, 300
SPECIALS = ["<NULL>", "<START>", "<END>", "<UNK>"]
RUN = ["--training_size", "8", "--epochs", "1", "--batch_size", "8", "--chunk_steps", "1",
       "--test_size", "20", "--pretrained_path", ".", "--seed", "2", "--hidden_dim", str(H),
       "--wordvec_dim", "16"]
PRETRAIN_EPOCHS = 3


def letters(i: int) -> str:
    """``w`` and three base-26 letters: distinct, 4 characters, no digits."""
    return "w" + "".join(chr(97 + (i // 26 ** p) % 26) for p in (2, 1, 0))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), num_train_images=12,
                            num_val_images=6, captions_per_image=2, vocab_size=V,
                            feature_dim=F, seed=11)
    words = SPECIALS + [letters(i) for i in range(V - len(SPECIALS))]
    with open(os.path.join(d, "coco2014_vocab.json"), "w") as f:
        json.dump({"word_to_idx": {w: i for i, w in enumerate(words)}, "idx_to_word": words}, f)
    return d


@pytest.fixture
def jax_inits(monkeypatch):
    """The port's networks start from the JAX initialisers' weights (the
    same seeds, the same pretrained table); in both packages the
    pretrainers take PRETRAIN_EPOCHS epochs and SGNS small batches and
    bucket tables."""
    for name, jmod in (("reward", jreward), ("policy", jpolicy), ("value", jvalue)):
        def init(gen, cfg, emb=None, jmod=jmod):
            tree = jmod.init(jax.random.PRNGKey(gen.initial_seed()),
                             JNetConfig(**dataclasses.asdict(cfg)), emb)
            return from_jax_params(jax.tree.map(np.asarray, tree))

        monkeypatch.setattr(importlib.import_module(
            f"image_captioning_through_rl_tpu_torch.models.{name}"), "init", init)
    for mod in (jw, tw):
        monkeypatch.setattr(mod, "train_sgns", functools.partial(
            mod.train_sgns, batch_size=256, num_buckets=4096))
    for loops in (jloops, tloops):
        for kind in ("reward", "policy", "value"):
            name = f"train_{kind}_network"
            monkeypatch.setattr(loops, name, functools.partial(getattr(loops, name),
                                                               epochs=PRETRAIN_EPOCHS))


def _jax_run(argv):
    with jax.default_matmul_precision("highest"):
        jmain.main(jmain.parse_args_with_config(jmain.build_arg_parser(), argv))


def _port_run(argv):
    return tmain.main(tmain.parse_args_with_config(tmain.build_arg_parser(), argv))


def _runs(coco, tmp_path, monkeypatch, extra):
    """A training run of each CLI in its own directory -> per side the
    metrics.jsonl records, the log directory and the run's directory."""
    out = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        np.random.seed(4)  # the --training_size draw and the OOV rows (numpy's global generator)
        ret = run(["--data_dir", coco, *RUN, *extra] + (["--device", "cpu"] if side == "t" else []))
        (stamp,) = os.listdir(d / "logs")
        log = d / "logs" / stamp
        out[side] = ([json.loads(x) for x in (log / "metrics.jsonl").read_text().splitlines()],
                     log, d, ret)
    (want, *_), (got, *_, ret) = out["j"], out["t"]
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert len(got) == 3 * PRETRAIN_EPOCHS + 3
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)
    assert "word2vec" in ret["seconds"] and ret["cfg"].wordvec_dim == E
    assert ret["cfg"].freeze_embeddings
    return out


def _tables(d):
    """Every embedding table in the run's checkpoints: each network's file
    and both halves of the a2c file, read by the JAX package."""
    cfg = JNetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H)
    inits = {"reward": jreward, "policy": jpolicy, "value": jvalue}
    out = {}
    for kind, mod in inits.items():
        tree = jckpt.load_network(kind, str(d / f"{kind}Network.ckpt"),
                                  template=mod.init(jax.random.PRNGKey(0), cfg))
        out[kind] = np.asarray(tree["embedding"])
    template = {"value": jvalue.init(jax.random.PRNGKey(0), cfg),
                "policy": jpolicy.init(jax.random.PRNGKey(0), cfg)}
    tree = jckpt.load_network("a2c", str(d / "a2cNetwork.ckpt"), template=template)
    out["a2c policy"] = np.asarray(tree["policy"]["embedding"])
    out["a2c value"] = np.asarray(tree["value"]["embedding"])
    return out


def _one_table(d):
    tables = _tables(d)
    first = tables.pop("reward")
    assert first.shape == (V, E) and first.dtype == np.float32
    for name, t in tables.items():  # frozen: every network kept the aligned table
        np.testing.assert_array_equal(t, first, err_msg=name)
    return first


@pytest.mark.parametrize("kind", ["word2vec", "fasttext"])
def test_train_word2vec_retrain_matches_jax_cli(kind, coco, tmp_path, monkeypatch, jax_inits):
    out = _runs(coco, tmp_path, monkeypatch,
                ["--retrain", "--train_word2vec", kind, "--save_word2vec", "w2v.bin"])
    model = {side: temb.load_word2vec_format(str(out[side][2] / "w2v.bin")) for side in out}
    assert list(model["t"]) == list(model["j"])
    for w in model["j"]:
        np.testing.assert_allclose(model["t"][w], model["j"][w], rtol=1e-4, atol=1e-5, err_msg=w)
    words = json.load(open(os.path.join(coco, "coco2014_vocab.json")))["idx_to_word"]
    tables = {side: _one_table(out[side][2]) for side in out}
    found = [i for i, w in enumerate(words) if w in model["t"]]
    assert min(found) == len(SPECIALS) and len(found) > V // 2  # body words, no special
    for i in found:
        np.testing.assert_array_equal(tables["t"][i], model["t"][words[i]])
    # the specials' rows: numpy's global draws, before any word was found
    np.testing.assert_array_equal(tables["t"][:len(SPECIALS)], tables["j"][:len(SPECIALS)])


@pytest.mark.parametrize("route", ["path", "name"])
def test_pretrained_word2vec_retrain_matches_jax_cli(route, coco, tmp_path, monkeypatch,
                                                     jax_inits):
    """A GloVe file (no header) holding most of the vocabulary, words the
    vocabulary lacks and a duplicate: found rows, OOV rows before and after
    the first found word."""
    rng = np.random.default_rng(8)
    words = [letters(i) for i in range(V - len(SPECIALS))]
    rows = [w for w in words if rng.random() < 0.8] + ["zzzz", "start", words[0]]
    lines = [w + " " + " ".join(repr(float(x)) for x in rng.normal(0, 0.3, E).astype(np.float32))
             for w in rows]
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "glove.txt").write_text("\n".join(lines) + "\n")
    monkeypatch.setenv("ICRL_EMBEDDINGS_DIR", str(cache))
    source = "glove" if route == "name" else str(cache / "glove.txt")
    out = _runs(coco, tmp_path, monkeypatch, ["--retrain", "--pretrained_word2vec", source])
    tables = {side: _one_table(out[side][2]) for side in out}
    np.testing.assert_array_equal(tables["t"], tables["j"])
    vecs = temb.load_word2vec_format(str(cache / "glove.txt"))
    np.testing.assert_array_equal(tables["t"][len(SPECIALS)], vecs[words[0]])
    json_cfg = json.loads((out["t"][1] / "run_config.json").read_text())
    assert json_cfg["pretrained_word2vec"] == source


@pytest.fixture(scope="module")
def e300_models(coco, tmp_path_factory):
    """JAX-written E = 300 sub-network and a2c ``.ckpt`` files (JAX
    initialisers over a table of vectors) and that table's vector file."""
    d = tmp_path_factory.mktemp("models300")
    rng = np.random.default_rng(5)
    words = SPECIALS + [letters(i) for i in range(V - len(SPECIALS))]
    table = rng.normal(0, 0.3, (V, E)).astype(np.float32)
    temb.save_word2vec_format(dict(zip(words[1:], table[1:])), str(d / "vectors.bin"),
                              binary=True)
    cfg = JNetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H,
                     freeze_embeddings=True)
    for kind, mod, key in (("reward", jreward, 5), ("policy", jpolicy, 6), ("value", jvalue, 7)):
        jckpt.save_pytree(mod.init(jax.random.PRNGKey(key), cfg, table),
                          str(d / f"{kind}Network.ckpt"))
    (d / "run").mkdir()
    jckpt.save_pytree({"value": jvalue.init(jax.random.PRNGKey(8), cfg, table),
                       "policy": jpolicy.init(jax.random.PRNGKey(9), cfg, table)},
                      str(d / "run" / "a2cNetwork.ckpt"))
    return d


def test_test_model_with_pretrained_vectors_matches_jax_cli(coco, e300_models, tmp_path,
                                                            monkeypatch):
    runs = {}
    for side, run in (("j", _jax_run), ("t", _port_run)):
        d = tmp_path / side
        shutil.copytree(e300_models, d)
        monkeypatch.chdir(d)
        argv = ["--data_dir", coco, "--test_model", str(d / "run" / "a2cNetwork.ckpt"),
                "--test_size", "300", "--pretrained_path", str(d), "--hidden_dim", str(H)]
        extra = ["--device", "cpu"] if side == "t" else []
        if side == "t":  # the config's E = 512 without the vectors: every shape is checked
            with pytest.raises(ValueError, match="shape"):
                run(argv + extra)
        np.random.seed(4)
        ret = run(argv + ["--pretrained_word2vec", str(d / "vectors.bin")] + extra)
        if side == "t":
            assert ret["cfg"].wordvec_dim == E and ret["params"]["policy"]["embedding"].shape == (
                V, E)
        runs[side] = d / "run"
    for name in ("real_captions.txt", "generated_captions.txt", "image_url.txt"):
        got, want = (runs["t"] / name).read_bytes(), (runs["j"] / name).read_bytes()
        assert got == want, name
        assert len(want.splitlines()) == 298
    blocks = {}
    for side in runs:
        text = (runs[side] / "results.txt").read_text().split("---------- results ----------")
        blocks[side] = [ast.literal_eval(b.strip()) for b in text if b.strip().startswith("{")]
    (want,), (got,) = blocks["j"], blocks["t"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-300), k
