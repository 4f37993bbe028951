"""Synonym and paraphrase resources for METEOR's two lexical-variation
match modules.

METEOR-1.5 (the tool the reference runs via pycocoevalcap's jar,
reference metrics.py:23) matches, in addition to surface forms and
stems, (a) words that share a WordNet synset ("synonym" module, weight
0.8) and (b) phrase pairs from a paraphrase table ("paraphrase" module,
weight 0.6). Those resources — WordNet and the ~50 MB paraphrase-en
database — are not redistributable with this package, so both modules
are implemented here as LOADERS gated on user-supplied files; without
the files the modules are inert and METEOR falls back to exact+stem
(a documented lower bound, :mod:`.meteor`).

Accepted resource formats:

``SynonymLookup``
    * a **WordNet database directory** (the standard WN 3.x ``dict/``
      layout): ``index.noun`` / ``index.verb`` / ``index.adj`` /
      ``index.adv`` are parsed and two words are synonyms iff they
      share a ``(pos, synset_offset)`` pair — the same relation the
      METEOR synonym module evaluates;
    * a **flat synset file** (plain or ``.gz``): one synset per line,
      whitespace-separated member words; ``#`` comments allowed.

``ParaphraseTable``
    * plain or ``.gz`` text, one pair per line, either TAB-separated
      or ``" ||| "``-separated; a leading numeric column (a weight or
      probability, as phrase-table exports commonly carry) is skipped.
      Pairs are symmetrised on load.

Resolution from the environment (used by :func:`default_resources`):
``ICRL_METEOR_SYNONYMS`` names the synonym resource (file or WordNet
dir), ``ICRL_METEOR_PARAPHRASES`` names the paraphrase file.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Set, Tuple

_WN_INDEX_FILES = ("index.noun", "index.verb", "index.adj", "index.adv")


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


class SynonymLookup:
    """Word -> synset-id-set lookup; two words match iff the sets
    intersect."""

    def __init__(self, synsets: Dict[str, FrozenSet[str]]):
        self._synsets = synsets

    def __len__(self) -> int:
        return len(self._synsets)

    def are_synonyms(self, a: str, b: str) -> bool:
        # entries are lowercased at load time; normalize queries the same
        # way (the stem module is case-insensitive too — Java METEOR
        # lowercases its input wholesale)
        sa = self._synsets.get(a.lower())
        if not sa:
            return False
        sb = self._synsets.get(b.lower())
        return bool(sb) and not sa.isdisjoint(sb)

    @staticmethod
    def from_synsets_file(path: str) -> "SynonymLookup":
        """One synset per line (whitespace-separated members); full-line
        ``#`` comments only (a ``#`` can be a legitimate token, so
        inline stripping would corrupt members)."""
        acc: Dict[str, Set[str]] = {}
        with _open_text(path) as f:
            for lineno, line in enumerate(f):
                line = line.strip()
                if line.startswith("#"):
                    continue
                words = line.lower().split()
                if len(words) < 2:  # singleton synsets can never match
                    continue
                sid = f"s{lineno}"
                for w in words:
                    acc.setdefault(w, set()).add(sid)
        return SynonymLookup({w: frozenset(s) for w, s in acc.items()})

    @staticmethod
    def from_wordnet_dir(path: str) -> "SynonymLookup":
        """Parse a WordNet 3.x ``dict/`` directory's index files.

        Index line format (wndb(5WN)): ``lemma pos synset_cnt p_cnt
        [ptr_symbol...] sense_cnt tagsense_cnt synset_offset
        [synset_offset...]`` — the trailing ``synset_cnt`` offsets are
        the synset ids. License-header lines begin with two spaces.
        Multi-word lemmas (underscored collocations) can never match a
        single caption token and are skipped.
        """
        acc: Dict[str, Set[str]] = {}
        found_any = False
        for name in _WN_INDEX_FILES:
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                continue
            found_any = True
            with open(fp, encoding="utf-8", errors="replace") as f:
                for line in f:
                    if line.startswith("  ") or not line.strip():
                        continue
                    parts = line.split()
                    if len(parts) < 6:
                        continue
                    lemma, pos = parts[0], parts[1]
                    if "_" in lemma:
                        continue
                    try:
                        synset_cnt = int(parts[2])
                    except ValueError:
                        continue
                    offsets = parts[-synset_cnt:] if synset_cnt else []
                    ids = {f"{pos}{o}" for o in offsets}
                    if ids:
                        acc.setdefault(lemma.lower(), set()).update(ids)
        if not found_any:
            raise FileNotFoundError(
                f"no WordNet index files ({'/'.join(_WN_INDEX_FILES)}) under {path}")
        return SynonymLookup({w: frozenset(s) for w, s in acc.items()})

    @staticmethod
    def load(spec: str) -> "SynonymLookup":
        if os.path.isdir(spec):
            return SynonymLookup.from_wordnet_dir(spec)
        return SynonymLookup.from_synsets_file(spec)


class ParaphraseTable:
    """Symmetric phrase-pair table; spans match iff the pair is listed."""

    def __init__(self, pairs: Dict[Tuple[str, ...], Set[Tuple[str, ...]]]):
        self._pairs = pairs
        self.max_len = max((len(k) for k in pairs), default=0)

    def __len__(self) -> int:
        return sum(len(v) for v in self._pairs.values()) // 2

    def paraphrases_of(self, phrase: Tuple[str, ...]) -> Set[Tuple[str, ...]]:
        # table entries are lowercased at load; normalize queries to match
        return self._pairs.get(tuple(w.lower() for w in phrase), set())

    def matches(self, a: Tuple[str, ...], b: Tuple[str, ...]) -> bool:
        return tuple(w.lower() for w in b) in self.paraphrases_of(a)

    @staticmethod
    def from_file(path: str, max_phrase_len: int = 6) -> "ParaphraseTable":
        """TAB- or ``" ||| "``-separated pairs, optional leading numeric
        weight column, full-line ``#`` comments; phrases longer than
        ``max_phrase_len`` words are dropped (caption decoding never
        needs them and the table stays small). ``#`` is only a comment
        at line start — real paraphrase tables contain it mid-phrase
        (``number #1``), so inline stripping would corrupt entries."""
        acc: Dict[Tuple[str, ...], Set[Tuple[str, ...]]] = {}
        with _open_text(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                fields = ([p.strip() for p in line.split("|||")]
                          if "|||" in line else line.split("\t"))
                fields = [p for p in fields if p]
                # a leading numeric field is a weight column only when two
                # phrases follow it — '2 ||| two' is a legitimate numeric
                # paraphrase pair, not a weight plus one phrase
                if len(fields) >= 3 and _is_number(fields[0]):
                    fields = fields[1:]
                if len(fields) < 2:
                    continue
                a = tuple(fields[0].lower().split())
                b = tuple(fields[1].lower().split())
                if (not a or not b or a == b
                        or max(len(a), len(b)) > max_phrase_len):
                    continue
                acc.setdefault(a, set()).add(b)
                acc.setdefault(b, set()).add(a)
        return ParaphraseTable(acc)


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


@dataclass
class MeteorResources:
    """The optional lexical resources METEOR's synonym/paraphrase
    modules run on. ``EMPTY`` (both ``None``) reduces METEOR to the
    exact+stem modules."""

    synonyms: Optional[SynonymLookup] = None
    paraphrases: Optional[ParaphraseTable] = None


_ENV_SYN = "ICRL_METEOR_SYNONYMS"
_ENV_PARA = "ICRL_METEOR_PARAPHRASES"
_cache: Dict[Tuple[str, str], MeteorResources] = {}


def default_resources() -> MeteorResources:
    """Resources named by the environment (cached per env values);
    empty resources when the variables are unset."""
    key = (os.environ.get(_ENV_SYN, ""), os.environ.get(_ENV_PARA, ""))
    if key not in _cache:
        _cache[key] = MeteorResources(
            synonyms=SynonymLookup.load(key[0]) if key[0] else None,
            paraphrases=ParaphraseTable.from_file(key[1]) if key[1] else None,
        )
    return _cache[key]
