"""Corpus BLEU-1..4 for caption evaluation.

Behavior parity with the coco-caption scorer the reference vendors
(datasets/caption/metrics/bleu): clipped n-gram precision accumulated over
the corpus, "closest" reference-length brevity penalty, no smoothing on the
corpus score.  Returns (list of 4 corpus scores, per-image scores).
"""

from __future__ import annotations

import math
from collections import Counter

from grit_tpu_torch.data.metrics.cider import ngram_counts

_TINY = 1e-15
_SMALL = 1e-9


def _clipped_stats(cand: str, refs: list[str], n_max: int = 4):
    """-> (clipped counts per n, totals per n, cand_len, closest ref_len)."""
    cwords = cand.split()
    cand_counts = ngram_counts(cand, n_max)
    max_ref: Counter = Counter()
    for ref in refs:
        for gram, cnt in ngram_counts(ref, n_max).items():
            if cnt > max_ref[gram]:
                max_ref[gram] = cnt
    clipped = [0] * n_max
    totals = [max(0, len(cwords) - n) for n in range(n_max)]
    for gram, cnt in cand_counts.items():
        clipped[len(gram) - 1] += min(cnt, max_ref[gram])
    ref_lens = [len(r.split()) for r in refs]
    # closest reference length (ties -> shorter, matching coco "closest")
    closest = min(ref_lens, key=lambda rl: (abs(rl - len(cwords)), rl))
    return clipped, totals, len(cwords), closest


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: dict, res: dict):
        assert gts.keys() == res.keys()
        corpus_clipped = [0] * self.n
        corpus_total = [0] * self.n
        test_len = 0
        ref_len = 0
        per_image: list[list[float]] = []

        for key in gts:
            clipped, totals, clen, rlen = _clipped_stats(res[key][0], gts[key], self.n)
            for k in range(self.n):
                corpus_clipped[k] += clipped[k]
                corpus_total[k] += totals[k]
            test_len += clen
            ref_len += rlen

            # per-image score (smoothed so empty matches don't zero everything)
            bp_i = 1.0 if clen > rlen else math.exp(1 - rlen / (clen + _TINY))
            img_scores = []
            logsum = 0.0
            for k in range(self.n):
                p = (clipped[k] + _TINY) / (totals[k] + _SMALL)
                logsum += math.log(p)
                img_scores.append(bp_i * math.exp(logsum / (k + 1)))
            per_image.append(img_scores)

        bp = 1.0 if test_len > ref_len else math.exp(1 - ref_len / (test_len + _TINY))
        scores = []
        logsum = 0.0
        for k in range(self.n):
            p = (corpus_clipped[k] + _TINY) / (corpus_total[k] + _SMALL)
            logsum += math.log(p)
            scores.append(bp * math.exp(logsum / (k + 1)))
        # per-image transposed to [n][image] like the reference scorer
        per_image_t = [[img[k] for img in per_image] for k in range(self.n)]
        return scores, per_image_t

    def __str__(self):
        return "BLEU"
