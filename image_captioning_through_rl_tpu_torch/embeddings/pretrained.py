"""Pretrained word vectors (counterpart of the JAX
``embeddings/pretrained.py``).

The reference maps short names to gensim-downloader models
(utilities.py:375-397). A short name resolves first against the local
directory ``$ICRL_EMBEDDINGS_DIR``, then through ``gensim.downloader`` where
gensim is installed (a live download). A file path loads through the native
reader of the word2vec text format (``N D`` header), the GloVe text format
(headerless) and the word2vec binary format, ``.gz`` included, so
``--pretrained_word2vec /path/to/vectors`` needs no gensim.
"""

from __future__ import annotations

import os

import numpy as np

_NAME_MAP = {
    "conceptnet": "conceptnet-numberbatch-17-06-300",
    "fasttext": "fasttext-wiki-news-subwords-300",
    "word2vec": "word2vec-google-news-300",
    "glove": "glove-wiki-gigaword-300",
}


def _local_model_file(name: str, short: str):
    """Resolve a named model against the local cache directory
    ``$ICRL_EMBEDDINGS_DIR`` (default ``~/.cache/icrl_embeddings``):
    ``<dir>/<short-or-full-name>.{txt,vec,bin,gz}`` loads through the
    native reader, so named models work offline once the file is
    dropped there (mirrors gensim-data's ``~/gensim-data`` layout
    without requiring gensim)."""
    root = os.environ.get(
        "ICRL_EMBEDDINGS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "icrl_embeddings"),
    )
    for stem in (short, name):
        for ext in ("", ".txt", ".vec", ".bin", ".gz",
                    ".txt.gz", ".vec.gz", ".bin.gz"):
            p = os.path.join(root, stem + ext)
            if os.path.isfile(p):
                return p
    return None


def get_embeddings(emb_type: str):
    """Load a standard pretrained embedding model by short name or path.

    Resolution order for a short name: (1) the local cache directory
    (``$ICRL_EMBEDDINGS_DIR``, native reader — no gensim needed),
    (2) gensim-downloader when installed (live download). File paths
    always load natively.
    """
    if os.path.isfile(emb_type):
        return get_embedding_model(emb_type)
    name = _NAME_MAP.get(emb_type)
    if name is None:
        raise ValueError(f"unknown embedding type {emb_type!r}; expected one of "
                         f"{sorted(_NAME_MAP)} or a file path")
    local = _local_model_file(name, emb_type)
    if local is not None:
        return load_word2vec_format(local)
    try:
        import gensim.downloader as api
    except ImportError as e:
        raise ImportError(
            f"model {name!r} is neither in the local cache "
            f"($ICRL_EMBEDDINGS_DIR/{emb_type}.txt|.vec|.bin) nor is gensim "
            "installed for a live download; drop the word2vec-format file in "
            "the cache dir, pass a file path, or train embeddings natively "
            "with --train_word2vec word2vec|fasttext"
        ) from e
    return api.load(name)


def get_embedding_model(path):
    """Normalize KeyedVectors / model / word2vec-format path -> mapping."""
    if isinstance(path, dict):
        return path
    if hasattr(path, "wv"):
        return path.wv
    if hasattr(path, "key_to_index") or hasattr(path, "vocab"):
        return path
    if isinstance(path, str) and os.path.isfile(path):
        return load_word2vec_format(path)
    raise ValueError(
        f"Got {type(path)}; expected a path to embeddings or an embedding model"
    )


def _chunk_looks_binary(chunk: bytes, encoding: str = "utf-8") -> bool:
    """Binary word2vec payloads contain raw float32 bytes; text payloads
    decode under the caller's ``encoding``. Decode-check first: .vec
    files routinely contain accented or multilingual words, so
    any-non-ASCII is NOT a binary signal. A partial trailing codepoint
    (the 4096-byte window can split one) is trimmed before the check;
    raw float32 bytes essentially never form valid multi-kilobyte text
    with this much structure."""
    for trim in range(4):  # a UTF-8 codepoint spans at most 4 bytes
        try:
            text = chunk[: len(chunk) - trim].decode(encoding)
        except (UnicodeDecodeError, ValueError):
            continue
        # decodable — binary payloads that happen to decode would still
        # be full of control characters; text files are not
        controls = sum(1 for c in text if ord(c) < 0x20 and c not in "\t\n\r")
        return controls > 0
    return True


def save_word2vec_format(vectors, path: str, binary: bool = False,
                         encoding: str = "utf-8") -> None:
    """Write ``{word: float32[dim]}`` in the word2vec interchange format
    — the inverse of :func:`load_word2vec_format`, byte-layout-compatible
    with gensim's ``save_word2vec_format`` (text: ``repr`` floats, so the
    round trip is value-exact; binary: word bytes + space + raw
    little-endian float32s, no separator — gensim's own layout). ``.gz``
    paths compress transparently. Atomic (temp file + rename), so a
    crashed export never leaves a truncated file behind.

    Lets natively trained SGNS/fastText vectors (``train_sgns``) flow
    back into gensim/reference tooling, mirroring how ``cli/export``
    returns trained networks to torch.
    """
    import gzip

    from ..utils.io import atomic_write

    vecs = {w: np.asarray(v, dtype=np.float32).reshape(-1) for w, v in vectors.items()}
    if not vecs:
        raise ValueError("refusing to write an empty embedding file")
    dims = {v.shape[0] for v in vecs.values()}
    if len(dims) != 1:
        raise ValueError(f"inconsistent vector dimensions: {sorted(dims)}")
    dim = dims.pop()

    with atomic_write(path) as raw:
        opener = gzip.GzipFile if path.endswith(".gz") else None
        f = opener(fileobj=raw, mode="wb") if opener else raw
        f.write(f"{len(vecs)} {dim}\n".encode(encoding))
        for word, vec in vecs.items():
            if binary:
                f.write(word.encode(encoding) + b" " + vec.astype("<f4").tobytes())
            else:
                row = " ".join(repr(float(x)) for x in vec)
                f.write(f"{word} {row}\n".encode(encoding))
        if opener:
            f.close()


def load_word2vec_format(path: str, binary=None, encoding: str = "utf-8"):
    """Native word-vector file reader -> ``{word: np.float32[dim]}``.

    Handles the three common interchange layouts (the formats gensim's
    ``load_word2vec_format``/GloVe loaders read, reference
    utilities.py:396-415):

      * word2vec TEXT: first line ``"<count> <dim>"``, then one
        ``word v1 ... vdim`` line per entry;
      * GloVe TEXT: same rows, no header line;
      * word2vec BINARY: the header line, then per entry the word bytes
        up to a space followed by ``dim`` raw little-endian float32s.

    ``binary=None`` auto-detects by sniffing the post-header bytes.
    ``.gz`` files (the compression gensim-data ships) decompress
    transparently.
    """
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        first = f.readline()
        parts = first.split()
        if not parts:
            raise ValueError(
                f"empty or headerless embedding file {path}: no first line"
            )
        has_header = len(parts) == 2 and all(p.isdigit() for p in parts)
        vectors: dict = {}
        if has_header:
            n_words, dim = int(parts[0]), int(parts[1])
            if binary is None:
                pos = f.tell()
                binary = _chunk_looks_binary(f.read(4096), encoding)
                f.seek(pos)
            if binary:
                n_read = 0  # entries PARSED (duplicate words overwrite
                # their dict slot — gensim keeps the first too — so the
                # dict size cannot witness truncation)
                for _ in range(n_words):
                    word = bytearray()
                    while True:
                        ch = f.read(1)
                        if ch in (b" ", b""):
                            break
                        if ch != b"\n":  # some writers pad with newlines
                            word.extend(ch)
                    if not word and not ch:
                        break
                    raw = f.read(4 * dim)
                    if len(raw) != 4 * dim:
                        raise ValueError(
                            f"truncated binary embedding file {path}: entry "
                            f"{word.decode(encoding, 'replace')!r} has "
                            f"{len(raw)} of {4 * dim} payload bytes"
                        )
                    vec = np.frombuffer(raw, dtype="<f4").astype(np.float32)
                    # duplicates: first occurrence wins (gensim's policy)
                    vectors.setdefault(word.decode(encoding), vec)
                    n_read += 1
                if n_read != n_words:
                    # a file cut exactly at an entry boundary parses
                    # cleanly — the header count is the only witness
                    raise ValueError(
                        f"truncated binary embedding file {path}: header "
                        f"declares {n_words} entries, payload holds {n_read}"
                    )
                return vectors
        else:
            dim = len(parts) - 1  # GloVe: the first line is already a record
            vectors[parts[0].decode(encoding)] = np.asarray(
                [float(x) for x in parts[1:]], dtype=np.float32
            )
        n_rows = 0
        for line in f:
            row = line.rstrip().split()
            if not row:
                continue
            if len(row) != dim + 1:
                raise ValueError(
                    f"malformed embedding row in {path}: expected {dim} values, "
                    f"got {len(row) - 1}"
                )
            vectors.setdefault(  # duplicates: first wins (gensim policy)
                row[0].decode(encoding),
                np.asarray([float(x) for x in row[1:]], dtype=np.float32),
            )
            n_rows += 1
        # rows PARSED, not dict size: duplicate words (present in real
        # published dumps; gensim keeps the first) are not truncation
        if has_header and n_rows < n_words:
            raise ValueError(
                f"truncated embedding file {path}: header declares "
                f"{n_words} entries, payload holds {n_rows}"
            )
    return vectors
