"""Post-processing: surface the best-scoring captions with their images.

Mirrors the reference (utilities.py:229-283): score each (real,
generated) line pair, average the metric dict, keep the top-k, write
``best_scores.txt`` and download the corresponding images. A copy of the
JAX package's module without its progress bars (``tqdm`` is not a
dependency of the port).
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np

from .score import get_singleton_score


def post_process_data(image_caption_data: Dict[str, str], top_item_count: int = 5) -> None:
    with open(image_caption_data["real_captions_path"]) as f:
        real_lines = f.readlines()
    with open(image_caption_data["generated_captions_path"]) as f:
        gen_lines = f.readlines()
    with open(image_caption_data["image_urls_path"]) as f:
        url_lines = f.readlines()

    score_list = []
    for i in range(len(real_lines)):
        s = get_singleton_score(real_lines[i], gen_lines[i])
        score_list.append(sum(s.values()) / len(s))

    top = np.argsort(np.asarray(score_list))[::-1][:top_item_count]

    images_dir = image_caption_data["best_score_images_path"]
    os.makedirs(images_dir, exist_ok=True)

    with open(image_caption_data["best_score_file_path"], "w") as best_f:
        for i in top:
            best_f.write(
                "item_index[%d] score:[%f] real_cap:[%s] generated_cap:[%s] \n"
                % (i + 1, score_list[i], real_lines[i].strip(), gen_lines[i].strip())
            )
            try:
                import urllib.request

                urllib.request.urlretrieve(
                    url_lines[i].strip(), os.path.join(images_dir, f"{i + 1}.jpg")
                )
            except Exception:
                e = sys.exc_info()[0]
                print(f"downloading {url_lines[i]} failed with {e}")


def image_from_url(url: str):
    """Download an image (reference utilities.py:193-201)."""
    from io import BytesIO

    import requests
    from PIL import Image

    return Image.open(BytesIO(requests.get(url).content))
