"""The port's word embeddings against the JAX package's, on the CPU.

Inputs are made from seeds with numpy; JAX runs at
``precision="highest"``. Held:
  * the corpus (``simple_preprocess``, ``get_preprocessed_corpus``), the
    aligned tables (``get_vectors_by_vocab`` under one ``np.random.seed``),
    the vector files both ways (the writers' bytes equal; every reader
    error raised with the JAX message), the named-model resolution
    (``$ICRL_EMBEDDINGS_DIR``, a fake ``gensim.downloader``), FNV-1a, the
    n-grams, the vocabulary, the mined pairs and the generator state after
    them, and the negatives (``jax.random.categorical(key, logits,
    shape=(B, K))``): equal;
  * one SGNS step, sparse and dense, and ``train_sgns`` over three steps,
    word2vec and fastText: rtol 1e-5, atol 1e-6 (the sums over repeated
    rows run in another order than XLA's scatter);
  * ``train_sgns`` over 40 epochs (200 steps): word2vec to rtol 1e-4;
    fastText to rtol 1e-4 with atol 1e-5, because a word's vector there is
    the mean of its own row and its n-gram rows (entries of opposite sign,
    ~0.02), and 200 steps carry each step's rounding of those sums into
    entries that end near zero (measured: 3.8e-6 absolute, 1.9e-4 relative
    Frobenius at most).
"""

import functools
import gzip
import struct
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu import embeddings as jemb
from image_captioning_through_rl_tpu.data.coco import CocoData as JCocoData
from image_captioning_through_rl_tpu.embeddings import pretrained as jpre
from image_captioning_through_rl_tpu.embeddings import word2vec as jw
from image_captioning_through_rl_tpu_torch import embeddings as temb
from image_captioning_through_rl_tpu_torch.data.coco import CocoData
from image_captioning_through_rl_tpu_torch.embeddings import pretrained as tpre
from image_captioning_through_rl_tpu_torch.embeddings import word2vec as tw
from image_captioning_through_rl_tpu_torch.ops import prng

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _toy_corpus(n=300):
    # two topic clusters: (cat, meow, purr) and (dog, bark, fetch)
    rng = np.random.default_rng(0)
    return [["cat", "meow", "purr", "cat", "meow"] if rng.random() < 0.5 else
            ["dog", "bark", "fetch", "dog", "bark"] for _ in range(n)]


def _random_corpus(seed=0, n=200, words=12):
    rng = np.random.default_rng(seed)
    names = [f"w{chr(97 + i)}" for i in range(words)]
    return [[names[i] for i in rng.integers(0, words, rng.integers(0, 9))] for _ in range(n)]


DOCS = ["A man, riding! a BIG-horse 7x", "i a x", "Café au lait", "naïve 2nd co-op ÉCOLE",
        "<START> the cat <END> <NULL> <NULL>", "x1y22zz under_score 3d", "",
        "aaaaaaaaaaaaaaa aaaaaaaaaaaaaaaa ab"]


@pytest.mark.parametrize("deacc", [False, True])
@pytest.mark.parametrize("doc", DOCS)
def test_simple_preprocess_matches_jax(doc, deacc):
    assert temb.simple_preprocess(doc, deacc=deacc) == jemb.simple_preprocess(doc, deacc=deacc)


def test_preprocessed_corpus_matches_jax():
    words = ["<NULL>", "<START>", "<END>", "<UNK>", "café", "dog2", "a", "big-horse", "x_y"]
    rng = np.random.default_rng(1)
    caps = rng.integers(0, len(words), size=(7, 9)).astype(np.int32)
    fields = dict(train_captions=caps[:4], train_image_idxs=np.zeros(4, np.int32),
                  val_captions=caps[4:], val_image_idxs=np.zeros(3, np.int32),
                  train_features=np.zeros((1, 2), np.float32),
                  val_features=np.zeros((1, 2), np.float32),
                  word_to_idx={w: i for i, w in enumerate(words)},
                  idx_to_word=dict(enumerate(words)), train_urls=np.array(["u"]),
                  val_urls=np.array(["u"]), train_captions_lens=np.full(4, 9),
                  val_captions_lens=np.full(3, 9))
    got = temb.get_preprocessed_corpus(CocoData(**fields))
    assert got == jemb.get_preprocessed_corpus(JCocoData(**fields))
    assert len(got) == 7 and "café" in sum(got, []) and "dog" in sum(got, [])


ALIGN = {
    "oov first": ["x0", "x1", "w0", "w1"],
    "oov after seen": ["w0", "x0", "w1", "x1", "x2", "w2", "x3"],
    "all seen": ["w2", "w0", "w1"],
}


@pytest.mark.parametrize("case", sorted(ALIGN))
def test_vectors_by_vocab_matches_jax(case):
    rng = np.random.default_rng(7)
    model = {f"w{i}": rng.normal(size=5).astype(np.float32) for i in range(3)}
    vocab = {w: i for i, w in enumerate(ALIGN[case])}
    np.random.seed(3)
    want = jemb.get_vectors_by_vocab(model, vocab)
    state = np.random.get_state()[1].copy()
    np.random.seed(3)
    got = temb.get_vectors_by_vocab(model, vocab)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.random.get_state()[1], state)


def test_vectors_by_vocab_empty_model_raises_as_jax():
    msgs = []
    for mod in (jemb, temb):
        with pytest.raises(ValueError) as e:
            mod.get_vectors_by_vocab({}, {"a": 0})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "empty embedding model" in msgs[0]


VECS = {w: np.random.default_rng(3).normal(size=7).astype(np.float32) * (i + 1)
        for i, w in enumerate(["héllo", "world", "añio", "x", "naïve"])}


@pytest.mark.parametrize("name, binary", [("t.vec", False), ("b.bin", True),
                                          ("t.vec.gz", False), ("b.bin.gz", True)])
def test_vector_files_both_ways(name, binary, tmp_path):
    """The port's writer gives the JAX writer's bytes (gzip's stream
    decompressed: its header holds the file's time), and each package reads
    the other's file to the same vectors."""
    paths = {}
    for side, mod in (("j", jemb), ("t", temb)):
        paths[side] = tmp_path / f"{side}_{name}"
        mod.save_word2vec_format(VECS, str(paths[side]), binary=binary)
    raw = {k: (gzip.decompress(p.read_bytes()) if name.endswith(".gz") else p.read_bytes())
           for k, p in paths.items()}
    assert raw["t"] == raw["j"]
    for reader, path in ((temb, paths["j"]), (jemb, paths["t"]), (temb, paths["t"])):
        back = reader.load_word2vec_format(str(path))
        assert list(back) == list(VECS)
        for w in VECS:
            np.testing.assert_array_equal(back[w], VECS[w])
            assert back[w].dtype == np.float32


def _write(path, data):
    path.write_bytes(data)
    return str(path)


def _bin(entries, header=None):
    out = (header or f"{len(entries)} {len(entries[0][1])}").encode() + b"\n"
    for w, v in entries:
        out += w.encode() + b" " + np.asarray(v, "<f4").tobytes()
    return out


READS = {
    "text": (b"3 4\ncat 1 2 3 4\ndog 0.5 -1 2.25 0\nmat -1 -2 -3 -4\n", {}),
    "glove": (b"cat 1 2 3 4\ndog 5 6 7 8\n", {}),
    "utf8 text": ("3 4\ncafé 1 2 3 4\nnaïve 5 6 7 8\nplain 9 10 11 12\n".encode(), {}),
    "binary": (_bin([("cat", [1.5, 2.5, 3.5]), ("dog", [-1, 0, 1])]), {}),
    "binary newline-padded": (b"2 2\ncat " + struct.pack("<2f", 1, 2) + b"\ndog "
                              + struct.pack("<2f", 3, 4) + b"\n", {}),
    "duplicate text": (b"3 2\ncat 1.0 2.0\ndog 3.0 4.0\ncat 9.0 9.0\n", {}),
    "duplicate binary": (_bin([("cat", [1, 2]), ("dog", [3, 4]), ("cat", [9, 9])]),
                         {"binary": True}),
    "blank lines": (b"2 2\n\ncat 1 2\n\ndog 3 4\n", {}),
    "forced text": (b"1 2\ncat 1 2\n", {"binary": False}),
    # errors
    "truncated binary": (b"2 4\ngood " + struct.pack("<4f", 1, 2, 3, 4) + b"cut "
                         + struct.pack("<2f", 5, 6), {"binary": True}),
    "binary cut at an entry": (_bin([("a", [1, 2]), ("b", [3, 4])], header="5 2"),
                               {"binary": True}),
    "truncated text": (b"4 2\ncat 1 2\ndog 3 4\n", {}),
    "malformed row": (b"2 4\ncat 1 2 3 4\ndog 1 2\n", {}),
    "malformed glove": (b"cat 1 2\ndog 1\n", {}),
    "empty": (b"", {}),
    "bad float": (b"1 2\ncat 1 zz\n", {}),
}


def _outcome(mod, path, kw):
    try:
        return "ok", {w: v.tolist() for w, v in mod.load_word2vec_format(path, **kw).items()}
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("case", sorted(READS))
@pytest.mark.parametrize("gz", [False, True])
def test_reader_matches_jax(case, gz, tmp_path):
    data, kw = READS[case]
    path = _write(tmp_path / ("v.vec.gz" if gz else "v.vec"), gzip.compress(data) if gz else data)
    got, want = _outcome(tpre, path, kw), _outcome(jpre, path, kw)
    assert got == want
    assert want[0] == ("error" if case in ("truncated binary", "binary cut at an entry",
                                           "truncated text", "malformed row", "malformed glove",
                                           "empty", "bad float") else "ok")


def test_writer_refuses_as_jax(tmp_path):
    for vecs in ({}, {"a": np.zeros(3, np.float32), "b": np.zeros(4, np.float32)}):
        msgs = []
        for mod in (jemb, temb):
            with pytest.raises(ValueError) as e:
                mod.save_word2vec_format(vecs, str(tmp_path / "e.vec"))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert not list(tmp_path.iterdir())  # atomic: nothing published


@pytest.mark.parametrize("drop", ["glove.txt", "word2vec.bin.gz", "glove-wiki-gigaword-300.vec",
                                  "fasttext", None])
def test_named_models_resolve_as_jax(drop, tmp_path, monkeypatch):
    """Short names against ``$ICRL_EMBEDDINGS_DIR``: the same file chosen,
    the same vectors; a miss without gensim raises the same ImportError;
    a path loads directly, an unknown name raises."""
    cache = tmp_path / "cache"
    cache.mkdir()
    if drop:
        binary = ".bin" in drop
        temb.save_word2vec_format({"hello": np.arange(3, dtype=np.float32)}, str(cache / drop),
                                  binary=binary)
    monkeypatch.setenv("ICRL_EMBEDDINGS_DIR", str(cache))
    for name in ("glove", "word2vec", "fasttext", "conceptnet"):
        out = []
        for mod in (jpre, tpre):
            try:
                out.append(("ok", {w: v.tolist() for w, v in mod.get_embeddings(name).items()}))
            except ImportError as e:
                out.append(("import", str(e)))
        assert out[0] == out[1], name
    for name in ("nope", str(tmp_path / "missing.vec")):
        msgs = []
        for mod in (jpre, tpre):
            with pytest.raises(ValueError) as e:
                mod.get_embeddings(name)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    temb.save_word2vec_format({"a": np.ones(2, np.float32)}, str(tmp_path / "p.vec"))
    assert list(tpre.get_embeddings(str(tmp_path / "p.vec"))) == ["a"]
    assert tpre.get_embedding_model({"a": 1}) == {"a": 1}


def test_named_model_falls_back_to_a_gensim_downloader(tmp_path, monkeypatch):
    """A cache miss with gensim importable (a fake module here: gensim is
    not installed) calls ``gensim.downloader.load`` with the reference's
    full model name and returns its result; a cache hit wins over it."""
    monkeypatch.setenv("ICRL_EMBEDDINGS_DIR", str(tmp_path / "empty"))
    loaded, sentinel = [], {"hello": np.arange(3.0)}
    downloader = types.ModuleType("gensim.downloader")
    downloader.load = lambda name: loaded.append(name) or sentinel
    gensim = types.ModuleType("gensim")
    gensim.downloader = downloader
    monkeypatch.setitem(sys.modules, "gensim", gensim)
    monkeypatch.setitem(sys.modules, "gensim.downloader", downloader)
    for name, full in (("conceptnet", "conceptnet-numberbatch-17-06-300"),
                       ("word2vec", "word2vec-google-news-300"),
                       ("glove", "glove-wiki-gigaword-300"),
                       ("fasttext", "fasttext-wiki-news-subwords-300")):
        assert tpre.get_embeddings(name) is sentinel and loaded[-1] == full
        assert jpre.get_embeddings(name) is sentinel and loaded[-1] == full
    (tmp_path / "warm").mkdir()
    (tmp_path / "warm" / "glove.txt").write_text("hello 1.0 2.0\n")
    monkeypatch.setenv("ICRL_EMBEDDINGS_DIR", str(tmp_path / "warm"))
    assert list(tpre.get_embeddings("glove")) == ["hello"] and len(loaded) == 8


@pytest.mark.parametrize("word", ["", "a", "cat", "café", "naïve-ÉCOLE", "<start>", "w" * 20])
def test_fnv1a_and_ngrams_match_jax(word):
    assert tw._fnv1a(word) == jw._fnv1a(word)
    assert tw._char_ngrams(word) == jw._char_ngrams(word)
    assert tw._char_ngrams(word, 2, 4) == jw._char_ngrams(word, 2, 4)


@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("window", [1, 2, 5])
def test_vocab_and_pairs_match_jax(window, min_count):
    """The vectorised miner gives the JAX loop's pairs, in its order, and
    leaves numpy's generator in the same state (the tables and
    permutations drawn after it depend on that)."""
    corpus = _random_corpus(seed=window) + [[], ["wa"], ["wa", "wa"]]
    w2i, freqs = tw.build_vocab(corpus, min_count)
    jw2i, jfreqs = jw.build_vocab(corpus, min_count)
    assert w2i == jw2i and freqs.dtype == np.float64
    np.testing.assert_array_equal(freqs, jfreqs)
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    got = tw._mine_pairs(corpus, w2i, window, rngs[0])
    want = jw._mine_pairs(corpus, jw2i, window, rngs[1])
    assert got.dtype == want.dtype == np.int32 and got.shape[1] == 2
    np.testing.assert_array_equal(got, want)
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state
    assert tw._mine_pairs([["zz"], []], w2i, window, rngs[0]).shape == (0, 2)


@pytest.mark.parametrize("b, k, v", [(64, 5, 12), (7, 3, 1000), (1, 1, 2)])
def test_negatives_match_jax_categorical(b, k, v):
    logits = (0.75 * np.log(np.random.default_rng(v).integers(1, 50, v))).astype(np.float32)
    key = jax.random.PRNGKey(b * 31 + v)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), shape=(b, k)))
    got = prng.categorical(np.asarray(key, np.uint32), torch.as_tensor(logits), shape=(b, k))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_shape_rules():
    key = np.asarray(jax.random.PRNGKey(0), np.uint32)
    logits = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jnp.asarray(key), jnp.asarray(logits),
                                             shape=(4, 3)))
    got = prng.categorical(key, torch.as_tensor(logits), shape=(4, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        prng.categorical(key, torch.as_tensor(logits)).numpy(),
        np.asarray(jax.random.categorical(jnp.asarray(key), jnp.asarray(logits))))
    with pytest.raises(ValueError, match="batch shape"):
        prng.categorical(key, torch.as_tensor(logits), shape=(4, 2))


def _step_inputs(rng, subwords):
    vocab, size, buckets, g, b = 12, 6, 16, 4, 32
    params = {"in": rng.standard_normal((vocab, size)).astype(np.float32),
              "out": rng.standard_normal((vocab, size)).astype(np.float32)}
    if subwords:
        params["buckets"] = rng.standard_normal((buckets, size)).astype(np.float32)
    wts = rng.random((vocab, g)).astype(np.float32)
    wts[:, g // 2:] = 0.0  # padding slots
    return (params, rng.integers(0, buckets, (vocab, g)), wts,
            rng.integers(0, vocab, b), rng.integers(0, vocab, b),
            rng.standard_normal(vocab).astype(np.float32))


@pytest.mark.parametrize("subwords", [False, True])
def test_sgns_step_matches_jax_and_dense(subwords):
    """The sparse step against the JAX sparse step, and against the port's
    own autograd step, on N(0, 1) tables at lr 0.1 (repeated rows in every
    scatter)."""
    params, grams, wts, centers, contexts, logits = _step_inputs(
        np.random.default_rng(int(subwords)), subwords)
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        want, want_loss = jw._make_sgns_step(3, subwords)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(grams, jnp.int32),
            jnp.asarray(wts), jnp.float32(0.1), jnp.asarray(centers, jnp.int32),
            jnp.asarray(contexts, jnp.int32), key, jnp.asarray(logits))
    for dense in (False, True):
        got, loss = tw._make_sgns_step(3, subwords, dense=dense)(
            {k: torch.tensor(v) for k, v in params.items()}, torch.as_tensor(grams),
            torch.as_tensor(wts), torch.tensor(0.1), torch.as_tensor(centers),
            torch.as_tensor(contexts), np.asarray(key, np.uint32), torch.as_tensor(logits))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-6)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} dense={dense}")


def _train_both(corpus, **kw):
    with jax.default_matmul_precision("highest"):
        want = jw.train_sgns(corpus, **kw)
    got = tw.train_sgns(corpus, device="cpu", **kw)
    assert list(got) == list(want)
    return got, want


@pytest.mark.parametrize("subwords", [False, True])
def test_train_sgns_three_steps_match_jax(subwords):
    """Three steps (an epoch of 1306 pairs at batch 512, the last batch
    padded by ``np.resize``) at size 300 from the same tables, pairs,
    permutation and keys."""
    got, want = _train_both(_random_corpus(), size=300, epochs=1, batch_size=512,
                            subwords=subwords, num_buckets=4096, seed=4)
    for w in want:
        assert got[w].dtype == np.float32 and got[w].shape == (300,)
        np.testing.assert_allclose(got[w], want[w], rtol=1e-5, atol=1e-6, err_msg=w)


def test_fasttext_ngram_tables_match_jax():
    """No step (epochs 0): the vectors are the initial tables' mean of a
    word's row and its n-gram rows, so they hold the n-gram ids and weights
    (the first 32 of 3-6 characters, FNV-1a into 64 buckets: collisions, and
    a long word cut at 32) to the JAX package's up to the sums' order."""
    corpus = [["ab", "cat", "héllo", "extraordinarily", "x" * 14]] * 2
    got, want = _train_both(corpus, size=6, epochs=0, subwords=True, num_buckets=64, seed=3)
    for w in want:
        np.testing.assert_allclose(got[w], want[w], rtol=1e-6, atol=1e-9, err_msg=w)


@pytest.mark.parametrize("subwords", [False, True])
def test_train_sgns_forty_epochs_match_jax(subwords):
    got, want = _train_both(_toy_corpus(), size=16, epochs=40, batch_size=1024, seed=1,
                            subwords=subwords, num_buckets=1024)
    for w in want:
        np.testing.assert_allclose(got[w], want[w], rtol=1e-4, atol=1e-5 if subwords else 0,
                                   err_msg=w)


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


def test_sgns_learns_topic_structure():
    model = tw.train_sgns(_toy_corpus(), size=16, epochs=40, batch_size=1024, seed=1,
                          device="cpu")
    assert _cos(model["cat"], model["meow"]) > _cos(model["cat"], model["bark"])


def test_train_sgns_edge_cases_match_jax():
    assert tw.train_sgns([], device="cpu") == jw.train_sgns([]) == {}
    got, want = _train_both([["solo"], ["solo"]], size=4, epochs=2)
    np.testing.assert_array_equal(got["solo"], want["solo"])


def test_train_sgns_refuses_a_draw_past_the_counters():
    """A step's Gumbel draw of 65536 x 5 x V entries needs V < 13108 (the
    noise's 32-bit counters); a larger vocabulary raises at the first draw
    with the cap's message."""
    corpus = [[f"w{i}", f"w{i + 1}"] for i in range(13200)]
    with pytest.raises(ValueError, match="needs 64-bit counters"):
        tw.train_sgns(corpus, size=2, epochs=1, device="cpu")


def test_train_sgns_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tw.train_sgns(_toy_corpus(4))
    with pytest.raises(RuntimeError, match="cuda"):
        tw.train_word_embeddings("word2vec", {"word_to_idx": {"cat": 0}}, _toy_corpus(4))


@pytest.mark.parametrize("name", ["w.txt", "w.bin", "w.bin.gz"])
@pytest.mark.parametrize("kind", ["word2vec", "fasttext"])
def test_train_word_embeddings_matches_jax(kind, name, tmp_path, monkeypatch):
    """The entry point: the aligned table (the OOV row from numpy's global
    generator) and the written file (its layout by suffix) against the JAX
    package's, to the three-step bound; the file holds the returned model's
    vectors."""
    for mod in (jw, tw):
        monkeypatch.setattr(mod, "train_sgns", functools.partial(mod.train_sgns,
                                                                  batch_size=256))
    corpus = _random_corpus(seed=2, n=60)
    data = {"word_to_idx": {"<NULL>": 0, "wa": 1, "wb": 2, "oov": 3, "wc": 4}}
    out = {}
    for side, mod, kw in (("j", jw, {}), ("t", tw, {"device": "cpu"})):
        np.random.seed(9)
        with jax.default_matmul_precision("highest"):
            table = mod.train_word_embeddings(kind, data, corpus, size=8, epochs=2,
                                              save_path=str(tmp_path / side / name), **kw)
        out[side] = (table, temb.load_word2vec_format(str(tmp_path / side / name)))
    (jt, jm), (tt, tm) = out["j"], out["t"]
    assert tt.shape == (5, 8) and tt.dtype == np.float32
    np.testing.assert_array_equal(tt[0], jt[0])  # OOV before any seen word: the same draw
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6)
    assert list(tm) == list(jm)
    for w in jm:
        np.testing.assert_allclose(tm[w], jm[w], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tt[1], tm["wa"])
    raw = (tmp_path / "t" / name).read_bytes()
    header, body = (gzip.decompress(raw) if name.endswith(".gz") else raw).split(b"\n", 1)
    assert header == f"{len(tm)} 8".encode()
    if ".bin" in name:  # word, a space, 8 raw float32s; no separator
        assert len(body) == sum(len(w.encode()) + 1 + 32 for w in tm)
    else:
        assert [len(line.split()) for line in body.splitlines()] == [9] * len(tm)
    assert temb.train_word_embeddings("none", data, corpus) is None



def test_embeddings_import_without_jax_or_gensim():
    """The embeddings package imports neither jax, the JAX package nor
    gensim (the card's machine has none of them)."""
    code = ("import sys\n"
            "import image_captioning_through_rl_tpu_torch.embeddings\n"
            "import image_captioning_through_rl_tpu_torch.embeddings.word2vec\n"
            "import image_captioning_through_rl_tpu_torch.embeddings.pretrained\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
            "    'jax', 'gensim', 'image_captioning_through_rl_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
