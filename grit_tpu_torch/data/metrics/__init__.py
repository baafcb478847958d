"""Caption metric suite — pure Python, no Java subprocesses.

Replaces the reference metric stack (datasets/caption/metrics/__init__.py:7-16)
with dependency-free implementations:

- CIDEr-D (exact algorithm parity with the coco-caption scorer the reference
  vendors, incl. precomputable train-corpus idf; scored by the port's C++
  library, ``grit_tpu_torch.native``, unless ``use_native=False``),
- BLEU-1..4 (corpus BLEU, closest-reference length, no smoothing),
- ROUGE-L (LCS F-score, beta=1.2),
- METEOR-lite (exact + Porter-stem matching; the reference shells out to
  ``meteor-1.5.jar`` — absent from the checkout — so synonym/paraphrase
  stages are approximated; see meteor.py),
- PTBTokenizer (replaces the stanford-corenlp subprocess; the C++ library
  by default, ``use_native=False`` for the Python rules).

Interface parity: ``compute_scores(gts, gen) -> (scores_dict, per_image)``
with the same dict shapes as the reference.
"""

from grit_tpu_torch.data.metrics.bleu import Bleu  # noqa: F401
from grit_tpu_torch.data.metrics.cider import Cider  # noqa: F401
from grit_tpu_torch.data.metrics.meteor import Meteor  # noqa: F401
from grit_tpu_torch.data.metrics.rouge import Rouge  # noqa: F401
from grit_tpu_torch.data.tokenizer import PTBTokenizer  # noqa: F401


def compute_scores(gts, gen):
    """All metrics at once (reference metrics/__init__.py:7-16)."""
    metrics = (Bleu(), Meteor(), Rouge(), Cider())
    all_score, all_scores = {}, {}
    for metric in metrics:
        score, scores = metric.compute_score(gts, gen)
        all_score[str(metric)] = score
        all_scores[str(metric)] = scores
    return all_score, all_scores
