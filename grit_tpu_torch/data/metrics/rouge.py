"""ROUGE-L: longest-common-subsequence F-measure (beta = 1.2).

Parity with the vendored coco-caption scorer (datasets/caption/metrics/rouge):
per image, max LCS F-score over the references; corpus score is the mean.
"""

from __future__ import annotations

import numpy as np


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def _score_one(self, cand: str, refs: list[str]) -> float:
        # the vendored scorer maxes precision and recall SEPARATELY over the
        # references before combining (rouge.py:71-77) — preserved here
        c = cand.split(" ")
        prec_max = 0.0
        rec_max = 0.0
        for ref in refs:
            r = ref.split(" ")
            lcs = _lcs_len(c, r)
            prec_max = max(prec_max, lcs / float(len(c)))
            rec_max = max(rec_max, lcs / float(len(r)))
        if prec_max == 0 or rec_max == 0:
            return 0.0
        return ((1 + self.beta ** 2) * prec_max * rec_max) / (
            rec_max + self.beta ** 2 * prec_max
        )

    def compute_score(self, gts: dict, res: dict):
        assert gts.keys() == res.keys()
        scores = np.asarray([self._score_one(res[k][0], gts[k]) for k in gts])
        return float(scores.mean()), scores

    def __str__(self):
        return "ROUGE"
