"""METEOR 1.5: staged alignment scorer with pluggable data files.

The reference invokes ``meteor-1.5.jar`` over stdin pipes
(datasets/caption/metrics/meteor/meteor.py:13-46); the jar is absent from
this checkout (``.MISSING_LARGE_BLOBS``) and its synonym/paraphrase data
(WordNet tables, paraphrase-en.gz) is not shipped with the repository.  This
module implements the METEOR 1.5 algorithm (Denkowski & Lavie 2014) itself:

* the FOUR matcher stages with the English module weights — exact 1.0,
  stem 0.6, synonym 0.8, paraphrase 0.6;
* content/function word distinction with delta-weighted precision/recall
  (English delta = 0.75; a built-in English function-word list, replaceable
  via ``function_words=``);
* fragmentation penalty ``gamma * (chunks / matches) ** beta`` with the
  English parameters alpha=0.85, beta=0.2, gamma=0.6 (the 1.5 defaults the
  jar applies for ``-l en -norm``);
* score = (1 - penalty) * F_mean over delta-weighted P and R.

The synonym and paraphrase stages activate when the user supplies their
data files (the pluggable part — drop in the tables and the staged matcher
uses them, no code changes):

* ``synonym_file``: text lines, each a whitespace-separated synonym group
  (one synset per line; a word may appear on several lines).  A WordNet
  dump in this shape reproduces the jar's synonymy stage.
* ``paraphrase_file``: text lines ``phrase ||| paraphrase`` (the shape of
  the jar's paraphrase-en table); both sides may be multi-word.  ``.gz``
  paths are decompressed transparently.

Alignment resolution: candidate matches are collected from every active
stage (paraphrase candidates over phrases up to length 4, like the jar)
and resolved to a one-to-one, non-overlapping alignment by a left-to-right
beam search over partial alignments (the jar Aligner's strategy, beam 40),
ranking alignments by the jar's documented objective order — most covered
words, fewest chunks, highest total stage weight, smallest start-offset
distance.  (A size-first greedy is NOT equivalent: one long low-stage
paraphrase match can block several exact matches that together cover more
words.)  Bit-level jar parity is unverifiable here (no jar, no JVM, no
data files — docs/PARITY.md); the ALGORITHM is complete, so parity is one
data-file drop away.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterable, Optional

import numpy as np

from grit_tpu_torch.data.metrics.stemmer import porter_stem

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
STAGE_WEIGHTS = {"exact": 1.0, "stem": 0.6, "synonym": 0.8, "paraphrase": 0.6}
MAX_PHRASE = 4  # paraphrase stage phrase length cap (jar behavior)

# A compact English function-word list (METEOR ships one as a data file;
# the jar derives it from corpus frequency.  This covers the same
# determiners / prepositions / conjunctions / auxiliaries class and is
# replaceable via Meteor(function_words=...)).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no neither either
and or but nor so yet for of in on at by to from with without about
above below under over between among through during before after
against into onto upon off out up down again further then once here
there all both few more most other such only own same than too very
is am are was were be been being have has had having do does did doing
will would shall should may might must can could not n't it its he she
his her him hers they them their theirs we us our ours you your yours i
me my mine who whom whose which what as if because while until when
where how why
""".split())


def _load_synonyms(path: str) -> dict:
    """word -> set of synset ids (line number = synset id)."""
    table: dict = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for sid, line in enumerate(f):
            words = line.split()
            for w in words:
                table.setdefault(w.lower(), set()).add(sid)
    return table


def _load_paraphrases(path: str) -> set:
    """Set of frozenset({phrase_a, phrase_b}) string pairs."""
    table = set()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            parts = [p.strip().lower() for p in line.split("|||")]
            if len(parts) >= 2 and parts[0] and parts[1]:
                table.add(frozenset((parts[0], parts[1])))
    return table


class Meteor:
    """METEOR 1.5 scorer.  Stages beyond exact+stem activate when their
    data files are supplied (or via $METEOR_SYNONYMS / $METEOR_PARAPHRASES)."""

    def __init__(
        self,
        synonym_file: Optional[str] = None,
        paraphrase_file: Optional[str] = None,
        function_words: Optional[Iterable[str]] = None,
    ):
        synonym_file = synonym_file or os.environ.get("METEOR_SYNONYMS")
        paraphrase_file = paraphrase_file or os.environ.get("METEOR_PARAPHRASES")
        self.synonyms = _load_synonyms(synonym_file) if synonym_file else None
        self.paraphrases = (
            _load_paraphrases(paraphrase_file) if paraphrase_file else None
        )
        self.function_words = (
            frozenset(w.lower() for w in function_words)
            if function_words is not None else FUNCTION_WORDS
        )

    # ------------------------------------------------------------------
    def _candidate_matches(self, cand: list, ref: list):
        """All (weight, stage_rank, c_start, c_len, r_start, r_len) matches."""
        out = []
        # stage 1: exact
        for i, w in enumerate(cand):
            for j, v in enumerate(ref):
                if w == v:
                    out.append((STAGE_WEIGHTS["exact"], 0, i, 1, j, 1))
        # stage 2: stem
        cs = [porter_stem(w) for w in cand]
        rs = [porter_stem(w) for w in ref]
        for i in range(len(cand)):
            for j in range(len(ref)):
                if cs[i] == rs[j] and cand[i] != ref[j]:
                    out.append((STAGE_WEIGHTS["stem"], 1, i, 1, j, 1))
        # stage 3: synonym (shared synset)
        if self.synonyms is not None:
            for i, w in enumerate(cand):
                si = self.synonyms.get(w)
                if not si:
                    continue
                for j, v in enumerate(ref):
                    if w == v:
                        continue
                    sj = self.synonyms.get(v)
                    if sj and si & sj:
                        out.append((STAGE_WEIGHTS["synonym"], 2, i, 1, j, 1))
        # stage 4: paraphrase (phrases up to MAX_PHRASE words)
        if self.paraphrases is not None:
            for i in range(len(cand)):
                for li in range(1, MAX_PHRASE + 1):
                    if i + li > len(cand):
                        break
                    pc = " ".join(cand[i:i + li])
                    for j in range(len(ref)):
                        for lj in range(1, MAX_PHRASE + 1):
                            if j + lj > len(ref):
                                break
                            pr = " ".join(ref[j:j + lj])
                            if pc != pr and frozenset((pc, pr)) in self.paraphrases:
                                out.append(
                                    (STAGE_WEIGHTS["paraphrase"], 3, i, li, j, lj))
        return out

    @staticmethod
    def _count_chunks(matches):
        """Chunks = maximal runs contiguous in BOTH sentences; ``matches``
        must be candidate-position ordered.  Shared by the alignment
        objective and the fragmentation penalty so they cannot drift."""
        if not matches:
            return 0
        chunks = 1
        for a, b in zip(matches, matches[1:]):
            if not (b[2] == a[2] + a[3] and b[4] == a[4] + a[5]):
                chunks += 1
        return chunks

    @staticmethod
    def _alignment_rank(chosen: tuple):
        """Jar objective order: (covered words, -chunks, total stage weight,
        -start-offset distance).  ``chosen`` is candidate-position ordered
        (the beam builds it that way), so chunks count directly."""
        if not chosen:
            return (0, 0, 0.0, 0)
        cov = sum(m[3] + m[5] for m in chosen)
        wt = sum(m[0] * (m[3] + m[5]) for m in chosen)
        dist = sum(abs(m[2] - m[4]) for m in chosen)
        return (cov, -Meteor._count_chunks(chosen), wt, -dist)

    def _align(self, cand: list, ref: list):
        """Resolve candidates to a non-overlapping alignment.

        Left-to-right beam search over partial alignments (the jar
        Aligner's strategy, beam 40): at each candidate position either
        leave it unmatched or commit one match starting there that does not
        collide with the partial alignment's used reference words; partial
        states dedup on (used-ref mask, next-free-candidate position) and
        prune by ``_alignment_rank``.  A size-first greedy violates the
        primary maximize-covered-words objective: one long low-stage
        paraphrase can block several exact matches covering more words.
        """
        candidates = self._candidate_matches(cand, ref)
        if not candidates:
            return []
        by_start: dict = {}
        for m in candidates:
            by_start.setdefault(m[2], []).append(m)
        BEAM = 40
        # state value = (rank, chosen): rank computed ONCE per alignment so
        # offers/prunes/final-pick don't re-derive it O(|chosen|) each time
        states = {(0, 0): (self._alignment_rank(()), ())}
        for i in range(len(cand)):
            new: dict = {}

            def offer(key, ranked):
                prev = new.get(key)
                if prev is None or ranked[0] > prev[0]:
                    new[key] = ranked

            for (mask, c_next), ranked in states.items():
                if c_next > i:  # inside an already-committed phrase
                    offer((mask, c_next), ranked)
                    continue
                offer((mask, i + 1), ranked)  # leave word i unmatched
                for m in by_start.get(i, ()):
                    rbits = ((1 << m[5]) - 1) << m[4]
                    if mask & rbits:
                        continue
                    chosen = ranked[1] + (m,)
                    offer((mask | rbits, i + m[3]),
                          (self._alignment_rank(chosen), chosen))
            if len(new) > BEAM:
                new = dict(sorted(
                    new.items(), key=lambda kv: kv[1][0], reverse=True,
                )[:BEAM])
            states = new
        return list(max(states.values(), key=lambda rc: rc[0])[1])

    # ------------------------------------------------------------------
    def _score_pair(self, cand_str: str, ref_str: str) -> float:
        cand = cand_str.lower().split()
        ref = ref_str.lower().split()
        if not cand or not ref:
            return 0.0
        chosen = self._align(cand, ref)
        if not chosen:
            return 0.0

        def weighted_counts(side):
            """(content matches, function matches) weighted by stage weight,
            counted in WORDS on the given side (jar: per-side counts)."""
            wc = wf = 0.0
            for w, stage, ci, cl, ri, rl in chosen:
                start, length, toks = (ci, cl, cand) if side == "c" else (ri, rl, ref)
                for k in range(start, start + length):
                    if toks[k] in self.function_words:
                        wf += w
                    else:
                        wc += w
            return wc, wf

        def split_len(toks):
            f = sum(1 for t in toks if t in self.function_words)
            return len(toks) - f, f

        mc_c, mf_c = weighted_counts("c")
        mc_r, mf_r = weighted_counts("r")
        cc, cf = split_len(cand)
        rc, rf = split_len(ref)
        prec_den = DELTA * cc + (1 - DELTA) * cf
        rec_den = DELTA * rc + (1 - DELTA) * rf
        prec = (DELTA * mc_c + (1 - DELTA) * mf_c) / max(prec_den, 1e-12)
        rec = (DELTA * mc_r + (1 - DELTA) * mf_r) / max(rec_den, 1e-12)
        if prec == 0 or rec == 0:
            return 0.0
        fmean = prec * rec / (ALPHA * prec + (1 - ALPHA) * rec)

        # chunks: matches sorted by candidate position; a chunk breaks when
        # the next match is not contiguous in BOTH sentences
        matches = sorted(chosen, key=lambda m: m[2])
        chunks = self._count_chunks(matches)
        # frag denominator: AVERAGE of covered word counts on the two sides
        # (MeteorScorer: (matches1 + matches2) / 2); no perfect-match special
        # case — the rank-tuned beta=0.2 simply leaves short perfect matches
        # below 1.0, which is the jar's actual behavior
        n_avg = (sum(m[3] for m in matches) + sum(m[5] for m in matches)) / 2.0
        penalty = GAMMA * (chunks / n_avg) ** BETA
        return (1 - penalty) * fmean

    def compute_score(self, gts: dict, res: dict):
        assert gts.keys() == res.keys()
        scores = np.asarray(
            [max(self._score_pair(res[k][0], ref) for ref in gts[k]) for k in gts]
        )
        return float(scores.mean()), scores

    def __str__(self):
        return "METEOR"
