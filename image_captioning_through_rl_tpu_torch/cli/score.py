"""Standalone caption-file scoring CLI (counterpart of the JAX
``cli/score.py``).

``python -m image_captioning_through_rl_tpu_torch.cli.score real.txt gen.txt``
runs the metric suite (BLEU 1-4, METEOR, ROUGE-L, CIDEr; the port's native
library when ``g++`` built it) over a pair of caption dumps in the
reference's format, prints the score dict and optionally appends it to a
results file.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Score a (real, generated) caption-file pair")
    ap.add_argument("real", help="reference captions, one per line")
    ap.add_argument("generated", help="generated captions, one per line")
    ap.add_argument("--results", default="",
                    help="also append the score dict to this results file "
                         "(reference results.txt format)")
    ap.add_argument("--json", action="store_true",
                    help="print the scores as one JSON line instead of the "
                         "reference's dict repr")
    args = ap.parse_args(argv)

    from ..metrics.score import load_textfiles, score
    from ..utils.io import append_results

    refs, hypos = load_textfiles(args.real, args.generated)
    scores = score(refs, hypos)
    print(json.dumps(scores) if args.json else str(scores))
    if args.results:
        append_results(args.results, str(scores), header="results")
    return scores


if __name__ == "__main__":
    main()
