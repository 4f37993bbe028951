"""PyTorch port vs the JAX package: the caption scorers, their native
library and the file-level scoring API.

The port keeps its own copy of the JAX package's ``metrics`` and of the
C++ ``fastmetrics`` library (it imports nothing of the JAX package). The
same seeded corpora go through both; scores agree to ``rtol = 1e-12``, the
tolerance the JAX package holds its own native scorers to. The native
library of the port is held against the port's pure-Python scorers the same
way.
"""

import os

import numpy as np
import pytest

from image_captioning_through_rl_tpu import metrics as jmetrics
from image_captioning_through_rl_tpu.metrics import porter as jporter
from image_captioning_through_rl_tpu.metrics import synonyms as jsynonyms
from image_captioning_through_rl_tpu_torch import metrics as tmetrics
from image_captioning_through_rl_tpu_torch.metrics import native as tnative
from image_captioning_through_rl_tpu_torch.metrics import porter as tporter
from image_captioning_through_rl_tpu_torch.metrics import synonyms as tsynonyms
from image_captioning_through_rl_tpu_torch.metrics.meteor import meteor_sentence
from image_captioning_through_rl_tpu_torch.metrics.rouge import rouge_l_sentence
from image_captioning_through_rl_tpu_torch.native import build as tbuild
from image_captioning_through_rl_tpu_torch.native import native_available

from test_metrics import REF_DUMP

RTOL = 1e-12
# words with shared stems, function words and the synthetic resources'
# entries (phrases among them, as one unit), so every METEOR module finds
# matches
WORDS = ("a the in of on with dog dogs hound canine cat cats sits sitting sat runs running "
         "run fast quick rapid front before house couch sofa many large number man men "
         "riding rides horse horses street").split() + ["in front of", "a large number of"]
SYNSETS = "dog canine hound\nquick fast rapid\ncouch sofa\n"
PARAPHRASES = "in front of ||| before\na large number of ||| many\nriding ||| rides\n"



@pytest.fixture
def native():
    """The port's native library, built on first use; skips without g++."""
    if not native_available():
        pytest.skip("C++ toolchain unavailable")


def _corpus(seed, n=60, max_refs=1, vocab=WORDS):
    rng = np.random.default_rng(seed)

    def sent():
        return " ".join(vocab[i] for i in rng.integers(0, len(vocab), rng.integers(3, 15)))

    refs = {i: [sent() for _ in range(rng.integers(1, max_refs + 1))] for i in range(n)}
    hypos = {i: [sent()] for i in range(n)}
    return refs, hypos


def _resources(pkg, tmp_path, which):
    syn = para = None
    if "synonyms" in which:
        f = tmp_path / "synsets.txt"
        f.write_text(SYNSETS)
        syn = pkg.SynonymLookup.from_synsets_file(str(f))
    if "paraphrases" in which:
        f = tmp_path / "paraphrases.txt"
        f.write_text(PARAPHRASES)
        para = pkg.ParaphraseTable.from_file(str(f))
    return pkg.MeteorResources(synonyms=syn, paraphrases=para)


SCORERS = {
    "corpus_bleu": lambda m, r, h, res: m.corpus_bleu(r, h),
    "rouge_l": lambda m, r, h, res: m.rouge_l(r, h),
    "cider": lambda m, r, h, res: m.cider(r, h),
    "meteor": lambda m, r, h, res: m.meteor(r, h, resources=res),
    "score": lambda m, r, h, res: m.score(r, h),
}
METEOR_RESOURCES = ((), ("synonyms",), ("paraphrases",), ("synonyms", "paraphrases"))


@pytest.mark.parametrize("max_refs", [1, 3])
@pytest.mark.parametrize("name", list(SCORERS))
def test_scorers_match_jax(name, max_refs):
    refs, hypos = _corpus(10 + max_refs, max_refs=max_refs)
    got = SCORERS[name](tmetrics, refs, hypos, None)
    want = SCORERS[name](jmetrics, refs, hypos, None)
    if name == "score":
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("max_refs", [1, 3])
@pytest.mark.parametrize("which", METEOR_RESOURCES, ids="+".join)
def test_meteor_with_resources_matches_jax(which, max_refs, tmp_path):
    """METEOR with synthetic synonym and paraphrase resources (the Python
    aligner's modules) and without them (the native exact + stem route)."""
    refs, hypos = _corpus(20 + max_refs, max_refs=max_refs)
    got = tmetrics.meteor(refs, hypos, resources=_resources(tsynonyms, tmp_path, which))
    want = jmetrics.meteor(refs, hypos, resources=_resources(jsynonyms, tmp_path, which))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if which:  # the resources change the score: the modules ran
        assert got != tmetrics.meteor(refs, hypos, resources=tsynonyms.MeteorResources())


def test_meteor_resources_from_the_environment(tmp_path, monkeypatch):
    """``ICRL_METEOR_SYNONYMS`` / ``ICRL_METEOR_PARAPHRASES`` name the
    resources in both packages."""
    (tmp_path / "s.txt").write_text(SYNSETS)
    (tmp_path / "p.txt").write_text(PARAPHRASES)
    monkeypatch.setenv("ICRL_METEOR_SYNONYMS", str(tmp_path / "s.txt"))
    monkeypatch.setenv("ICRL_METEOR_PARAPHRASES", str(tmp_path / "p.txt"))
    res = tsynonyms.default_resources()
    assert res.synonyms.are_synonyms("dog", "hound") and res.paraphrases.max_len
    refs, hypos = _corpus(31, max_refs=2)
    np.testing.assert_allclose(tmetrics.meteor(refs, hypos), jmetrics.meteor(refs, hypos),
                               rtol=RTOL)


@pytest.mark.parametrize("pair", [
    ("a dog runs fast", "a dog runs"), ("<START> the cat sits <END>", "the cats sitting"),
    ("x y z", "completely different words"), ("a man riding a horse", "a man riding a horse"),
])
def test_singleton_score_matches_jax(pair):
    got = tmetrics.get_singleton_score(*pair)
    want = jmetrics.get_singleton_score(*pair)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=RTOL)


def test_porter_stemmer_classic_vectors():
    vectors = {
        "caresses": "caress", "ponies": "poni", "cats": "cat",
        "agreed": "agre", "motoring": "motor", "hopping": "hop",
        "filing": "file", "happy": "happi", "relational": "relat",
        "digitizer": "digit", "vietnamization": "vietnam",
        "hopefulness": "hope", "triplicate": "triplic",
        "electriciti": "electr", "adjustable": "adjust",
        "replacement": "replac", "adoption": "adopt", "activate": "activ",
        "effective": "effect", "running": "run", "runs": "run",
    }
    for w, want in vectors.items():
        assert tporter.porter_stem(w) == want == jporter.porter_stem(w), w
    for w in WORDS:
        assert tporter.porter_stem(w) == jporter.porter_stem(w), w


# -- the port's native library against its pure-Python scorers ---------------

def _python_bleu(refs, hypos):
    from image_captioning_through_rl_tpu_torch.metrics.bleu import corpus_bleu

    return corpus_bleu(refs, hypos)


NATIVE = {
    "bleu": (tnative.corpus_bleu_native, _python_bleu),
    "cider": (tnative.cider_native, lambda r, h: tmetrics.cider(r, h)),
    "rouge": (tnative.rouge_scores_native,
              lambda r, h: [rouge_l_sentence(h[i][0], r[i]) for i in h]),
    "meteor": (tnative.meteor_scores_native,
               lambda r, h: [meteor_sentence(h[i][0], r[i], tsynonyms.MeteorResources())
                             for i in h]),
}


@pytest.mark.parametrize("multi_ref", [False, True])
@pytest.mark.parametrize("name", list(NATIVE))
def test_native_equals_python(name, multi_ref, native):
    words = [f"w{i}" for i in range(40)] + list(WORDS)
    refs, hypos = _corpus(40 + multi_ref, n=50, max_refs=3 if multi_ref else 1, vocab=words)
    native_fn, python = NATIVE[name]
    got = native_fn(refs, hypos)
    assert got is not None
    np.testing.assert_allclose(got, python(refs, hypos), rtol=RTOL)


def test_native_identical_sentences_score_one(native):
    refs = {0: ["a b c d e"], 1: ["f g h i j"]}
    np.testing.assert_allclose(tnative.corpus_bleu_native(refs, refs), [1.0] * 4, atol=1e-6)


def test_native_raises_on_empty_reference_group(native):
    refs = {0: ["a b c"], 1: []}
    hypos = {0: ["a b c"], 1: ["a b"]}
    for fn in (tnative.corpus_bleu_native, tnative.cider_native, tnative.rouge_scores_native):
        with pytest.raises(ValueError, match="empty reference group"):
            fn(refs, hypos)


def test_vocabulary_of_two_to_the_16_goes_to_python(native):
    """The n-gram kernels pack 16 bits a token: a corpus of 2^16 distinct
    words or more is routed to the pure-Python BLEU and CIDEr, as in the
    JAX package, with the same scores."""
    n = 1 << 14
    refs = {i: [f"r{i} s{i} t{i} a"] for i in range(n)}
    hypos = {i: [f"h{i} a r{i}"] for i in range(n)}
    assert tnative._intern(refs, hypos) is None
    assert tnative.corpus_bleu_native(refs, hypos) is None
    assert tnative.cider_native(refs, hypos) is None
    small = {i: refs[i] for i in range(100)}
    assert tnative._intern(small, {i: hypos[i] for i in range(100)}) is not None
    got, want = tmetrics.score(refs, hypos), jmetrics.score(refs, hypos)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=RTOL)


def test_without_the_library_scores_are_the_same(monkeypatch, native):
    """With no toolchain the loader gives None and every scorer takes its
    pure-Python route, with the native route's numbers."""
    refs, hypos = _corpus(51, max_refs=3)
    native = tmetrics.score(refs, hypos)
    monkeypatch.setattr(tnative, "load_fastmetrics", lambda: None)
    python = tmetrics.score(refs, hypos)
    assert list(python) == list(native)
    np.testing.assert_allclose(list(python.values()), list(native.values()), rtol=RTOL)


def test_native_build_into_the_package_and_without_gxx(tmp_path, monkeypatch):
    """The library lands in the package's ``_build/`` under a name keyed
    by the source's hash; a build directory of its own builds once and
    reuses the file; no ``g++`` on the PATH gives None."""
    assert tbuild.library_path().parent.name == "_build"
    assert tbuild.library_path().parent.parent.name == "image_captioning_through_rl_tpu_torch"
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", "")
    assert tbuild._build() is None
    assert not list((tmp_path / "_build").glob("*.so*"))  # the temp file is gone


def test_native_build_reuses_the_library(tmp_path, monkeypatch, native):
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    first = tbuild._build()
    assert first == tbuild.library_path() and first.exists()
    mtime = first.stat().st_mtime_ns
    assert tbuild._build() == first and first.stat().st_mtime_ns == mtime
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [first.name]


# -- the file-level API -------------------------------------------------------

def test_load_text_data_strips_like_jax(tmp_path):
    """``<END>``/``<START>``/``<UNK>`` and words holding them are dropped,
    and so is the word that holds the newline (a line's last word, whether
    ``<END>`` or not); the mismatch of line counts raises."""
    path = tmp_path / "caps.txt"
    path.write_text("<START> a dog <UNK> runs <END>\nthe cat<END><START> sits\n\n"
                    "x <NULL> y<UNK>z w\nno newline at the end")
    assert tmetrics.load_text_data(str(path)) == jmetrics.load_text_data(str(path))
    assert tmetrics.load_text_data(str(path))[:2] == ["a dog runs", "the"]
    assert tmetrics.load_textfiles(str(path), str(path)) == \
        jmetrics.load_textfiles(str(path), str(path))
    short = tmp_path / "short.txt"
    short.write_text("a b\n")
    with pytest.raises(ValueError, match="mismatch"):
        tmetrics.load_textfiles(str(path), str(short))


def test_score_returns_all_keys():
    s = tmetrics.score({0: ["a b"]}, {0: ["a b"]})
    assert list(s) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]


@pytest.mark.skipif(not os.path.isdir(REF_DUMP), reason="reference dump not mounted")
def test_golden_parity_with_reference_results():
    """The reference's shipped dump scores as in the JAX package, whose own
    test holds it to the pycocoevalcap numbers the reference published."""
    ref, hypo = tmetrics.load_textfiles(
        os.path.join(REF_DUMP, "real_captions_non-curr.txt"),
        os.path.join(REF_DUMP, "generated_captions_non-curr.txt"))
    np.testing.assert_allclose(
        tmetrics.corpus_bleu(ref, hypo),
        [0.13953640080706117, 0.052309596174356585, 0.02089955875550488, 0.008925489540673924],
        rtol=RTOL)
    np.testing.assert_allclose(tmetrics.rouge_l(ref, hypo), 0.13655453262777192, rtol=RTOL)
    np.testing.assert_allclose(tmetrics.cider(ref, hypo), 0.20634003754324984, rtol=RTOL)
    got, want = tmetrics.score(ref, hypo), jmetrics.score(ref, hypo)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=RTOL)
