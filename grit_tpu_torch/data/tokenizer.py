"""Tokenizers for captions and metrics — dependency-free Python.

Two tokenizers, matching the two the reference shells out for:

1. ``caption_tokenize`` — vocabulary-side tokenizer.  The reference uses the
   spaCy English tokenizer (datasets/caption/field.py:20,71-72) on lowercased
   captions, then strips punctuation (field.py:95-96,150-151).  COCO captions
   are simple declarative sentences; a rule tokenizer with spaCy's core
   English behaviors (punctuation splitting, English contractions) produces
   identical tokens on this domain, so the shipped ``vocab.json``
   numericalization is preserved.

2. ``ptb_tokenize`` — metric-side tokenizer.  The reference spawns Stanford
   CoreNLP's PTBTokenizer as a Java subprocess
   (datasets/caption/metrics/tokenizer.py:16-66).  This is a native-Python
   implementation of the same PTB conventions used for caption scoring:
   lowercase, split punctuation, split English contractions/possessives and
   drop the standard punctuation set (the subprocess is invoked with
   ``-lowerCase -preserveLines``; scoring code then removes punctuation
   tokens) — no JVM needed.  ``PTBTokenizer`` runs its C++ counterpart in
   ``grit_tpu_torch.native`` by default.
"""

from __future__ import annotations

import re

# punctuation dropped by the reference's caption preprocess (field.py:95-96)
CAPTION_PUNCT = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# punctuation removed by PTBTokenizer for caption metrics (the standard
# coco-caption set)
PTB_PUNCT = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# English contractions handled like spaCy/PTB: don't -> do n't, it's -> it 's
_CONTRACTION_RE = re.compile(r"\b(\w+)(n't|'s|'re|'ve|'ll|'d|'m)\b", re.IGNORECASE)

# core splitting: words (with internal hyphens/apostrophes kept for now),
# numbers (incl. decimals), or single non-space symbols
_TOKEN_RE = re.compile(
    r"n't|'s|'re|'ve|'ll|'d|'m"    # split-off contraction pieces
    r"|\d+(?:[.,]\d+)*"            # numbers
    r"|\w+(?:-\w+)*"               # words, keep internal hyphens (spaCy keeps "t-shirt"? no)
    r"|\.\.\.|--"                  # multi-char punct
    r"|\S",                        # any single symbol
)


def _split_contractions(text: str) -> str:
    return _CONTRACTION_RE.sub(lambda m: m.group(1) + " " + m.group(2), text)


def _base_tokenize(text: str) -> list[str]:
    text = _split_contractions(text)
    # spaCy/PTB split hyphenated compounds into word - word
    text = re.sub(r"(\w)-(\w)", r"\1 - \2", text)
    return _TOKEN_RE.findall(text)


def caption_tokenize(caption: str, lower: bool = True, remove_punct: bool = True) -> list[str]:
    """Vocabulary-side tokenization (spaCy-equivalent on COCO captions)."""
    if lower:
        caption = caption.lower()
    toks = _base_tokenize(caption.rstrip("\n"))
    if remove_punct:
        toks = [t for t in toks if t not in CAPTION_PUNCT]
    return toks


def ptb_tokenize_str(caption: str) -> str:
    """PTB-tokenize one caption for metric computation -> space-joined string."""
    toks = _base_tokenize(caption.lower())
    return " ".join(t for t in toks if t not in PTB_PUNCT)


class PTBTokenizer:
    """Drop-in for the reference's Java-backed tokenizer interface.

    Accepts the same shapes as metrics/tokenizer.py: a dict id -> list of
    caption strings, a list of strings, or a list of lists.  By default the
    port's native library tokenizes (``grit_tpu_torch.native``: the same
    tokens, string for string), as the JAX package's tokenizer takes its own;
    ``use_native=False`` keeps ``ptb_tokenize_str``, the plain version.  A
    library that fails to build raises.
    """

    @classmethod
    def tokenize(cls, corpus, use_native: bool = True):
        if isinstance(corpus, list) or isinstance(corpus, tuple):
            if len(corpus) and isinstance(corpus[0], (list, tuple)):
                corpus = {i: list(c) for i, c in enumerate(corpus)}
            else:
                corpus = {i: [c] for i, c in enumerate(corpus)}
        if not use_native:
            return {k: [ptb_tokenize_str(c) for c in caps] for k, caps in corpus.items()}
        from grit_tpu_torch.native import ptb_tokenize_batch

        keys = [k for k, caps in corpus.items() for _ in caps]
        toks = ptb_tokenize_batch([c for caps in corpus.values() for c in caps]) if keys else []
        out: dict = {k: [] for k in corpus}
        for k, t in zip(keys, toks):
            out[k].append(t)
        return out
