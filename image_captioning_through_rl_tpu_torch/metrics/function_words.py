"""English function-word list for METEOR's delta weighting.

METEOR-1.5 derives its ``function.words`` resource from corpus
frequency (words appearing with relative frequency >= 1e-3 in a large
English corpus, Denkowski & Lavie 2014 §2; reference tool:
pycocoevalcap's meteor-1.5.jar, reference metrics.py:23). That resource
is not redistributable here, so this is a curated closed-class list —
articles, pronouns, prepositions, conjunctions, auxiliaries/modals,
determiners, common particles and punctuation — covering the
overwhelming mass of the frequency-derived list for caption-style text.
Scores therefore track, but are not bit-identical to, the Java tool's
delta weighting; see :mod:`.meteor` for the full gap statement.
"""

FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every either neither no
another such what which whose who whom whoever whatever whichever
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves yourselves themselves one ones something anything nothing
everything someone anyone everyone somebody anybody nobody everybody
be am is are was were been being do does did doing done have has had
having will would shall should can could may might must ought need
dare used
of in on at by for with about against between into through during
before after above below to from up down out off over under again
further behind beside besides beyond within without along across
around near upon among amongst toward towards onto via per amid
and or but nor so yet both not only as if then than because while
although though unless until when whenever where wherever why how
whether since once
there here now just also too very quite rather somewhat more most
less least own same other else ever never always often sometimes
all few many much several
's 'd 'll 'm 're 've n't
. , ; : ! ? ' " ` `` '' ( ) [ ] { } - -- ... &
""".split())


def is_function_word(word: str) -> bool:
    """Case-insensitive membership in the function-word list."""
    return word.lower() in FUNCTION_WORDS
