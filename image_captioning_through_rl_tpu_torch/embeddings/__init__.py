"""Word embeddings (counterpart of the JAX ``embeddings`` package): the
caption corpus, skip-gram with negative sampling trained on the card
(word2vec, and fastText's subword variant), vector files in the word2vec
and GloVe formats, pretrained models by name or path, and the alignment of
a model's vectors to the caption vocabulary. The reference trains
Word2Vec/FastText through gensim (utilities.py:444-468); gensim is needed
only to download a named model that is not in ``$ICRL_EMBEDDINGS_DIR``.
"""

from .corpus import get_preprocessed_corpus, simple_preprocess
from .pretrained import (
    get_embedding_model,
    get_embeddings,
    load_word2vec_format,
    save_word2vec_format,
)
from .vocab_align import get_vectors_by_vocab
from .word2vec import train_word_embeddings

__all__ = [
    "get_preprocessed_corpus",
    "simple_preprocess",
    "train_word_embeddings",
    "get_vectors_by_vocab",
    "get_embeddings",
    "get_embedding_model",
    "load_word2vec_format",
    "save_word2vec_format",
]
