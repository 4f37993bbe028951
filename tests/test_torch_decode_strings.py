"""The port's token-to-text decode (``data.coco.decode_captions``) against
the JAX package's, which keeps the token-by-token loop.

The port decodes a grid of integer ids over a vocabulary whose keys are
``0..V-1`` as whole arrays over a cached per-vocabulary table, and every
other input with the loop; both must give the reference's strings, and
raise where it raises. ``decode_captions.fast_calls`` and
``.fallback_calls`` say which path a call took.
"""

import json
import os

import numpy as np
import pytest

from image_captioning_through_rl_tpu.data.coco import decode_captions as ref_decode
from image_captioning_through_rl_tpu_torch.data import coco
from portbench import traffic

WORDS = ["<NULL>", "<START>", "<END>", "<UNK>", "a", "man", "riding", "café", "日本", "", "dog"]
NULL, START, END = 0, 1, 2


def _vocab(words=WORDS) -> dict:
    return dict(enumerate(words))


def _counts() -> tuple:
    return coco.decode_captions.fast_calls, coco.decode_captions.fallback_calls


def _zipf_grid() -> np.ndarray:
    path = os.path.join(os.path.dirname(__file__), "..", "portbench", "workloads",
                        "policy-xe-w2v300.json")
    with open(path) as f:
        tr = json.load(f)["traffic"]
    return traffic.caption_table(np.random.default_rng(2147483659), 1016, tr, 1004, 17)


GRIDS = {
    "null_before_end": ([[START, 4, NULL, 5, NULL, END, 6, 4]], WORDS),
    "end_in_column_0": ([[END, 4, 5, 6], [END, NULL, NULL, NULL]], WORDS),
    "end_in_last_column": ([[START, 4, 5, END], [4, NULL, 5, END]], WORDS),
    "no_end": ([[START, 4, 5, 6], [4, 4, 4, 4]], WORDS),
    "leading_nulls": ([[NULL, 4, 5, END], [NULL, NULL, END, 4], [NULL, 9, NULL, 5]], WORDS),
    "all_null_row": ([[NULL, NULL, NULL, NULL], [START, 4, END, NULL]], WORDS),
    "start_kept": ([[START, START, 4, END], [4, START, END, START]], WORDS),
    "non_ascii_and_empty_words": ([[START, 7, 8, 9, 4, END], [9, NULL, 9, 8, 7, 10]], WORDS),
    "int32": (np.array([[START, 4, 5, END, NULL], [6, 7, NULL, 8, END]], np.int32), WORDS),
    "int64": (np.array([[START, 4, 5, END, NULL], [6, 7, NULL, 8, END]], np.int64), WORDS),
    "uint8": (np.array([[START, 4, 5, END, NULL], [6, 7, NULL, 8, END]], np.uint8), WORDS),
    "singleton_row": (np.array([START, 4, NULL, 5, END, 6], np.int32), WORDS),
    "zipf_1016x17": (None, None),
}


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_decode_matches_the_reference(case):
    grid, words = GRIDS[case]
    if grid is None:
        grid, idx_to_word = _zipf_grid(), traffic.vocab(1004)[1]
    else:
        grid, idx_to_word = np.asarray(grid), _vocab(words)
    before = _counts()
    got = coco.decode_captions(grid, idx_to_word)
    assert got == ref_decode(grid, idx_to_word)
    assert isinstance(got, str) == (grid.ndim == 1)
    assert _counts() == (before[0] + 1, before[1])


@pytest.mark.parametrize("grid", [np.zeros((0, 17), np.int32), np.zeros((3, 0), np.int64),
                                  np.zeros((0,), np.int32)], ids=["no_rows", "no_columns", "empty_row"])
def test_empty_grids_take_the_loop(grid):
    before = _counts()
    got = coco.decode_captions(grid, _vocab())
    assert got == ref_decode(grid, _vocab())
    assert _counts() == (before[0], before[1] + 1)
    if grid.shape == (0, 17):
        assert got == []


def test_keys_other_than_0_to_v_minus_1_take_the_loop():
    shifted = {i + 10: w for i, w in enumerate(WORDS)}
    gappy = {i: w for i, w in enumerate(WORDS) if i != 5}
    gappy[len(WORDS)] = "extra"
    grid = np.array([[11, 14, 10, 16, 12, 13]], np.int32)
    for idx_to_word in (shifted, gappy):
        g = grid if idx_to_word is shifted else grid - 10
        before = _counts()
        assert coco.decode_captions(g, idx_to_word) == ref_decode(g, idx_to_word)
        assert _counts() == (before[0], before[1] + 1)


@pytest.mark.parametrize("bad", [-1, len(WORDS), 2**31 - 1])
def test_an_unknown_id_raises_key_error_as_the_loop_does(bad):
    grid = np.array([[START, 4, 5, END], [START, bad, 5, END]], np.int64)
    with pytest.raises(KeyError):
        ref_decode(grid, _vocab())
    before = _counts()
    with pytest.raises(KeyError):
        coco.decode_captions(grid, _vocab())
    assert _counts() == (before[0], before[1] + 1)
    # past the row's first <END> the loop never looks the id up
    after_end = np.array([[START, 4, END, bad]], np.int64)
    assert coco.decode_captions(after_end, _vocab()) == ref_decode(after_end, _vocab()) == [
        "<START> a <END>"]


def test_ids_not_of_an_integer_dtype_take_the_loop():
    grid = np.array([[START, 4, 5, END, 6]])
    for g in (grid.astype(np.float32), grid.astype(np.int64).astype(object)):
        before = _counts()
        assert coco.decode_captions(g, _vocab()) == ref_decode(g, _vocab())
        assert _counts() == (before[0], before[1] + 1)


def test_a_vocabulary_changed_in_place_decodes_with_its_new_words():
    idx_to_word = _vocab()
    grid = np.array([[START, 4, 5, 6, END]], np.int32)
    assert coco.decode_captions(grid, idx_to_word) == ["<START> a man riding <END>"]
    idx_to_word[5] = "woman"
    assert coco.decode_captions(grid, idx_to_word) == ["<START> a woman riding <END>"]
    idx_to_word[6] = "<END>"
    assert coco.decode_captions(grid, idx_to_word) == ref_decode(grid, idx_to_word) == [
        "<START> a woman <END>"]
    idx_to_word[4] = "<NULL>"
    assert coco.decode_captions(grid, idx_to_word) == ref_decode(grid, idx_to_word) == [
        "<START> woman <END>"]


def test_words_with_spaces_and_newlines_decode_as_the_loop_does():
    grid = np.array([[START, 11, 12, 4, END, 12], [11, NULL, 12, 12, 11, 4]], np.int32)
    spaced = _vocab(WORDS + [" padded ", "a  b"])
    before = _counts()
    assert coco.decode_captions(grid, spaced) == ref_decode(grid, spaced)
    assert _counts() == (before[0] + 1, before[1])
    # a newline inside a word would split a row: that vocabulary takes the loop
    for extra in (["two\nlines", " padded "], ["\n", "x"]):
        lines = _vocab(WORDS + extra)
        before = _counts()
        assert coco.decode_captions(grid, lines) == ref_decode(grid, lines)
        assert _counts() == (before[0], before[1] + 1)


def test_the_counters_count_each_call_once_by_its_path():
    grid = np.array([[START, 4, 5, END]], np.int32)
    idx_to_word = _vocab()
    before = _counts()
    coco.decode_captions(grid, idx_to_word)
    coco.decode_captions(grid[0], idx_to_word)
    coco.decode_captions(grid.astype(np.float64), idx_to_word)
    coco.decode_captions(grid, {k + 1: w for k, w in idx_to_word.items()} | {0: "<NULL>"})
    coco.decode_captions(grid, list(WORDS))
    assert _counts() == (before[0] + 3, before[1] + 2)
