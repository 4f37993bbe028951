"""File-level scoring API (reference metrics.py:26-91 behavior)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..utils.io import append_results
from .bleu import corpus_bleu
from .cider import cider
from .meteor import meteor
from .rouge import rouge_l

_STRIP = ("<END>", "<START>", "<UNK>")


def load_text_data(filename: str) -> List[str]:
    """Strip <END>/<START>/<UNK> tokens and newlines from each caption
    line (reference metrics.py:26-36)."""
    contents = []
    with open(filename) as f:
        for line in f:
            words = [
                w for w in line.split(" ")
                if not any(s in w for s in _STRIP) and "\n" not in w
            ]
            contents.append(" ".join(words))
    return contents


def load_textfiles(reference_file: str, hypothesis_file: str) -> Tuple[Dict, Dict]:
    references = load_text_data(reference_file)
    hypothesis = load_text_data(hypothesis_file)
    refs = {idx: [line.strip()] for idx, line in enumerate(references)}
    hypo = {idx: [line.strip()] for idx, line in enumerate(hypothesis)}
    if len(hypo) != len(refs):
        raise ValueError(
            "There is a sentence number mismatch between the inputs", len(hypo), len(refs)
        )
    return refs, hypo


_HAVE_PYCOCO: bool | None = None  # probed once: failed imports are not
# cached by Python, and postprocess calls score() per caption line


def score(ref: Dict[int, List[str]], hypo: Dict[int, List[str]]) -> Dict[str, float]:
    """BLEU_1..4 + METEOR + ROUGE_L + CIDEr (reference metrics.py:57-85).

    Uses pycocoevalcap itself when importable (bit-identical numbers);
    otherwise the native scorers in this package.
    """
    global _HAVE_PYCOCO
    if _HAVE_PYCOCO is None:
        try:
            # probe ALL four scorers: a partial install (bleu present,
            # meteor's jar wrapper broken) must fall back, not crash
            import pycocoevalcap.bleu.bleu  # noqa: F401
            import pycocoevalcap.cider.cider  # noqa: F401
            import pycocoevalcap.meteor.meteor  # noqa: F401
            import pycocoevalcap.rouge.rouge  # noqa: F401

            _HAVE_PYCOCO = True
        except ImportError:
            _HAVE_PYCOCO = False
    if _HAVE_PYCOCO:  # pragma: no cover - not available in this environment
        from pycocoevalcap.bleu.bleu import Bleu
        from pycocoevalcap.cider.cider import Cider
        from pycocoevalcap.meteor.meteor import Meteor
        from pycocoevalcap.rouge.rouge import Rouge

        final = {}
        for scorer, method in (
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ):
            s, _ = scorer.compute_score(ref, hypo)
            if isinstance(s, list):
                final.update(zip(method, s))
            else:
                final[method] = s
        return final

    # native C++ n-gram kernels when the toolchain is available;
    # pure-Python otherwise (identical numerics, tested)
    from .native import cider_native, corpus_bleu_native

    bleus = corpus_bleu_native(ref, hypo)
    if bleus is None:
        bleus = corpus_bleu(ref, hypo)
    cider_score = cider_native(ref, hypo)
    if cider_score is None:
        cider_score = cider(ref, hypo)
    return {
        "Bleu_1": bleus[0],
        "Bleu_2": bleus[1],
        "Bleu_3": bleus[2],
        "Bleu_4": bleus[3],
        "METEOR": meteor(ref, hypo),
        "ROUGE_L": rouge_l(ref, hypo),
        "CIDEr": cider_score,
    }


def get_singleton_score(reference: str, hypothesis: str) -> Dict[str, float]:
    return score({0: [reference.strip()]}, {0: [hypothesis.strip()]})


def calculate_a2c_network_score(image_caption_data: Dict[str, str], save_paths: Dict[str, str]) -> Dict[str, float]:
    """Score the dumped caption files and append to results.txt
    (reference utilities.py:341-358)."""
    ref, hypo = load_textfiles(
        image_caption_data["real_captions_path"],
        image_caption_data["generated_captions_path"],
    )
    network_score = score(ref, hypo)
    print(str(network_score))
    append_results(save_paths["results_path"], str(network_score), header="results")
    return network_score
