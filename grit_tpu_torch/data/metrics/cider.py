"""CIDEr-D metric (Vedantam et al., CVPR 2015) — consensus tf-idf n-gram score.

Algorithm parity with the scorer the reference vendors
(datasets/caption/metrics/cider/cider_scorer.py:46-167), including its
quirks, so corpus scores are bit-identical:

- idf weight = max(0-safe) ``log(N_refs) - log(max(1, df))`` with df counted
  once per image whose references contain the n-gram;
- idf may be PRECOMPUTED from the training references and reused at SCST
  time (``Cider(gts=train_refs)``, cider.py:17-27) — ``ref_len`` then stays
  the train-corpus log size;
- clipped cosine per n: sum over candidate n-grams of
  ``min(tf_c, tf_r) * tf_r`` (both tf-idf weighted) / (norm_c * norm_r);
- Gaussian length penalty ``exp(-(l_c - l_r)^2 / (2 * 6^2))`` where, as in
  the original code, the "length" is the BIGRAM count (index n==1), i.e.
  words - 1;
- final score = 10 * mean over n in 1..4, averaged over references.

By default (n = 4) the scores come from the port's native library
(``grit_tpu_torch.native.NativeCider``, C++ built with g++ at first use; the
same scores to 1e-10), as the JAX package's ``Cider`` takes its own;
``use_native=False`` keeps the pure-Python scorer below, its plain version.
Where the library cannot be built (no g++, or the build fails) the scorer
below serves, as in the JAX package, after one warning that names the cause
(``grit_tpu_torch.native.available``).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict


def ngram_counts(sentence: str, n_max: int = 4) -> Counter:
    words = sentence.split()
    counts: Counter = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i:i + n])] += 1
    return counts


class Cider:
    def __init__(self, gts: dict | None = None, n: int = 4, sigma: float = 6.0,
                 use_native: bool = True):
        self.n = n
        self.sigma = sigma
        self.doc_frequency: dict | None = None
        self.ref_len: float | None = None
        self._native = None
        if use_native and n == 4:   # the library scores 1- to 4-grams
            from grit_tpu_torch import native

            if native.available():
                self._native = native.NativeCider(corpus_refs=gts, sigma=sigma)
        if gts is not None and self._native is None:
            self.doc_frequency, self.ref_len = self._corpus_stats(gts)

    def _corpus_stats(self, gts: dict):
        df: defaultdict = defaultdict(float)
        for refs in gts.values():
            seen = set()
            for ref in refs:
                seen.update(ngram_counts(ref, self.n).keys())
            for g in seen:
                df[g] += 1
        return df, math.log(float(len(gts)))

    def _tfidf(self, counts: Counter, df: dict, ref_len: float):
        """-> (vec per n, norm per n, bigram-length)."""
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for gram, tf in counts.items():
            idf = ref_len - math.log(max(1.0, df.get(gram, 0.0)))
            k = len(gram) - 1
            w = tf * idf
            vec[k][gram] = w
            norm[k] += w * w
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def compute_score(self, gts: dict, res: dict):
        """gts: id -> list of refs; res: id -> [candidate]. -> (corpus, per-image)."""
        assert gts.keys() == res.keys()
        if self._native is not None:
            return self._native.compute_score(gts, res)
        if self.doc_frequency is not None:
            df, ref_len = self.doc_frequency, self.ref_len
        else:
            df, ref_len = self._corpus_stats(gts)

        import numpy as np

        scores = []
        for key in gts:
            cand_vec, cand_norm, cand_len = self._tfidf(
                ngram_counts(res[key][0], self.n), df, ref_len
            )
            total = np.zeros(self.n)
            refs = gts[key]
            for ref in refs:
                ref_vec, ref_norm, ref_len_words = self._tfidf(
                    ngram_counts(ref, self.n), df, ref_len
                )
                delta = float(cand_len - ref_len_words)
                penalty = math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                for k in range(self.n):
                    dot = 0.0
                    for gram, w in cand_vec[k].items():
                        dot += min(w, ref_vec[k][gram]) * ref_vec[k][gram]
                    if cand_norm[k] != 0 and ref_norm[k] != 0:
                        dot /= cand_norm[k] * ref_norm[k]
                    total[k] += dot * penalty
            scores.append(10.0 * float(total.mean()) / len(refs))
        arr = np.asarray(scores)
        return float(arr.mean()), arr

    def __str__(self):
        return "CIDEr"
