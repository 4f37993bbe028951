"""The COCO-size splits a cell's traffic file describes, made from the seed
(:mod:`.traffic`), and handed to the program as its ``CocoData``."""

from __future__ import annotations

import json
import os

import numpy as np

from . import traffic


class Split:
    """One caption split: ``captions [N, T]`` int32, ``image_idxs [N]``
    into ``features [I, F]`` float32."""

    def __init__(self, captions, image_idxs, features):
        self.captions, self.image_idxs, self.features = captions, image_idxs, features

    def rows(self, mask):
        """``(captions, features)`` of the caption rows ``mask``."""
        return self.captions[mask], self.features[self.image_idxs[mask]]


def train_splits(seed: int, tr: dict, cfg: dict, with_train: bool = True):
    """``(train, checks)``: the train split of ``tr["train_captions"]``
    captions over ``tr["train_images"]`` feature rows, and one small split a
    size of ``tr["check_epochs"]`` whose captions are drawn apart from the
    train split's (so the checked first steps see rows that all differ),
    over the same feature table. ``with_train=False`` leaves the train
    split's captions out (None)."""
    rng = np.random.default_rng(traffic.sub_seed(seed, 1))
    v, t, f = cfg["vocab_size"], cfg["max_seq_len"], cfg["input_dim"]
    n_img, n_cap = tr["train_images"], tr["train_captions"]
    feats = traffic.feature_table(rng, n_img, f)
    train = (Split(traffic.caption_table(rng, n_cap, tr, v, t), traffic.image_index(n_cap, n_img),
                   feats) if with_train else None)
    rng = np.random.default_rng(traffic.sub_seed(seed, 6))
    checks = [Split(traffic.caption_table(rng, n, tr, v, t),
                    rng.integers(0, n_img, size=n).astype(np.int64), feats)
              for n in tr["check_epochs"]]
    return train, checks


def coco_data(split: Split, word_to_idx: dict, idx_to_word: dict, embeddings=None):
    """The program's ``CocoData`` holding ``split`` as its train split."""
    from image_captioning_through_rl_tpu_torch.data.coco import CocoData
    f = split.features.shape[1]
    lens = np.argmax(split.captions == traffic.END_ID, axis=1) + 1
    empty_caps = np.zeros((0, split.captions.shape[1]), np.int32)
    return CocoData(train_captions=split.captions, train_image_idxs=split.image_idxs,
                    val_captions=empty_caps, val_image_idxs=np.zeros(0, np.int64),
                    train_features=split.features, val_features=np.zeros((0, f), np.float32),
                    word_to_idx=word_to_idx, idx_to_word=idx_to_word,
                    train_urls=np.array([""] * split.features.shape[0]),
                    val_urls=np.array([], dtype=str), train_captions_lens=lens,
                    val_captions_lens=np.zeros(0, np.int64), embeddings=embeddings)


def logged(plot_dir: str, tag: str) -> list:
    """The values a trainer logged under ``tag`` in ``<plot_dir>/metrics.jsonl``."""
    out = []
    with open(os.path.join(plot_dir, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["tag"] == tag:
                out.append(rec["value"])
    return out


def epochs_for(seconds: float, epoch_seconds: float) -> int:
    """The whole epochs a window of ``seconds`` holds at the cell's nominal
    epoch length: a fixed amount of work for a given run length."""
    return max(1, round(seconds / epoch_seconds))
