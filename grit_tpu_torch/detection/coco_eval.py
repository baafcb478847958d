"""COCO-style detection mAP evaluator — numpy, no pycocotools.

Semantics-faithful to the reference's vendored COCOeval
(datasets/detection/metrics/cocoeval.py:13-458), cross-validated against it
to 1e-9 in tests/test_detection.py (randomized scenes incl. crowds, score
ties, and area-boundary boxes).  The load-bearing details it reproduces:

* IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation, area ranges
  all/small/medium/large with INCLUSIVE bounds (``area < lo or area > hi``
  ignores — an area of exactly 32^2 counts as both small and medium,
  cocoeval.py:270-274);
* crowd ground truths are ignore regions: IoU against a crowd divides by the
  detection's area only, crowds can absorb multiple detections, and
  detections matched to ignored gts are scored neither TP nor FP
  (cocoeval.py:290-316, pycocotools mask.iou semantics);
* unmatched detections whose own area falls outside the range are ignored
  rather than counted as FP (cocoeval.py:318-321);
* detections are capped at maxDets=100 per image/category and all score
  sorts are STABLE (mergesort) so ties resolve identically (:182-185,:395);
* the per-detection match loop prefers the best-IoU ground truth, stops at
  the ignored-gt boundary once a real match exists, and resolves IoU ties
  to the later gt (cocoeval.py:296-312);
* precision envelope then ``searchsorted(recall, recThrs, left)`` with
  out-of-range entries left at 0 (:434-443); absent (cat, area) cells carry
  -1 and are excluded from the means (:357,:466).

Cross-host merging uses ``process_allgather`` instead of the reference's
pickled NCCL all_gather (engine/utils.py:102-142).
"""

from __future__ import annotations

import numpy as np

from grit_tpu_torch.parallel.distributed import allgather_pyobj

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
# (name, lo, hi) with cocoeval's inclusive-bound convention
AREA_RANGES = [
    ("all", 0.0, 1e5 ** 2),
    ("small", 0.0, 32 ** 2),
    ("medium", 32 ** 2, 96 ** 2),
    ("large", 96 ** 2, 1e5 ** 2),
]
MAX_DETS = 100


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] -> [N,M] IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _iou_with_crowd(det: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """IoU [D,G]; against a crowd gt the denominator is the det area only
    (pycocotools mask.iou iscrowd semantics)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = np.where(
        crowd[None, :], area_d[:, None],
        area_d[:, None] + area_g[None, :] - inter,
    )
    return np.where(union > 0, inter / union, 0.0)


class CocoEvaluator:
    """Accumulate (image_id, predictions) + ground truth; summarize to mAP."""

    def __init__(self, gt: dict, cat_ids=None):
        """gt: image_id -> {'boxes': [G,4] xyxy, 'labels': [G][, 'iscrowd': [G]]}.

        cat_ids: category universe (defaults to all labels present in gt —
        the reference derives it from cocoGt.getCatIds()).
        """
        self.gt = gt
        self.preds: dict = {}
        self.cat_ids = cat_ids

    def update(self, image_ids, results):
        """results: dict of arrays [B, K, ...] from postprocess, or list of dicts."""
        if isinstance(results, dict):
            for i, img_id in enumerate(image_ids):
                self.preds[int(img_id)] = {
                    "scores": np.asarray(results["scores"][i]),
                    "labels": np.asarray(results["labels"][i]),
                    "boxes": np.asarray(results["boxes"][i]),
                }
        else:
            for img_id, res in zip(image_ids, results):
                self.preds[int(img_id)] = {k: np.asarray(v) for k, v in res.items()}

    def synchronize_between_processes(self):
        """Merge the ranks' predictions (engine/utils.py:102-142): each rank
        saw its own shard, so the dicts have different keys; they travel
        pickled (``parallel.distributed.allgather_pyobj``) and merge into one
        on every rank, whose mAP is then one process's.  One rank: the
        identity."""
        merged = {}
        for shard in allgather_pyobj(self.preds):
            merged.update(shard)
        self.preds = merged

    # ------------------------------------------------------------------
    def _cell(self, img_id: int, cat: int):
        """Per-(image, category) inputs: sorted+capped dets, gts, IoUs.

        Returns None when the image has neither gts nor dets of this
        category (the reference's evaluateImg None cells, cocoeval.py:265).
        """
        g = self.gt.get(img_id, None)
        if g is not None:
            sel = np.asarray(g["labels"]) == cat
            g_boxes = np.asarray(g["boxes"], np.float64)[sel]
            crowd = (
                np.asarray(g["iscrowd"], bool)[sel]
                if "iscrowd" in g else np.zeros(sel.sum(), bool)
            )
        else:
            g_boxes = np.zeros((0, 4))
            crowd = np.zeros(0, bool)

        p = self.preds.get(img_id, None)
        if p is not None:
            sel = np.asarray(p["labels"]) == cat
            scores = np.asarray(p["scores"], np.float64)[sel]
            d_boxes = np.asarray(p["boxes"], np.float64)[sel]
            order = np.argsort(-scores, kind="mergesort")[:MAX_DETS]
            scores, d_boxes = scores[order], d_boxes[order]
        else:
            scores = np.zeros(0)
            d_boxes = np.zeros((0, 4))

        if len(g_boxes) == 0 and len(d_boxes) == 0:
            return None
        ious = _iou_with_crowd(d_boxes, g_boxes, crowd)
        g_area = (g_boxes[:, 2] - g_boxes[:, 0]) * (g_boxes[:, 3] - g_boxes[:, 1])
        d_area = (d_boxes[:, 2] - d_boxes[:, 0]) * (d_boxes[:, 3] - d_boxes[:, 1])
        return scores, d_area, g_area, crowd, ious

    @staticmethod
    def _match_cell(cell, lo: float, hi: float):
        """The reference's evaluateImg for one area range (cocoeval.py:253-334).

        Returns (scores [D], dt_matched [T,D], dt_ignored [T,D], n_pos_gt).
        """
        scores, d_area, g_area, crowd, ious = cell
        T, D, G = len(IOU_THRS), len(scores), len(g_area)

        gt_ig = crowd | (g_area < lo) | (g_area > hi)
        # gts sorted ignore-last, stable
        g_order = np.argsort(gt_ig, kind="mergesort")
        gt_ig = gt_ig[g_order]
        ious = ious[:, g_order] if G else ious
        is_crowd = crowd[g_order]

        dt_m = np.zeros((T, D), bool)
        dt_ig = np.zeros((T, D), bool)
        gt_m = np.zeros((T, G), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(D):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    if gt_m[ti, gi] and not is_crowd[gi]:
                        continue
                    # real match exists and we've reached the ignored tail
                    if m > -1 and not gt_ig[m] and gt_ig[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dt_m[ti, di] = True
                gt_m[ti, m] = True
        # unmatched detections outside the area range are ignored, not FPs
        d_out = (d_area < lo) | (d_area > hi)
        dt_ig |= (~dt_m) & d_out[None, :]
        return scores, dt_m, dt_ig, int((~gt_ig).sum())

    def summarize(self) -> dict:
        cat_ids = self.cat_ids
        if cat_ids is None:
            cat_ids = sorted(
                {int(c) for g in self.gt.values() for c in np.asarray(g["labels"])}
            )
        img_ids = sorted(set(self.gt) | set(self.preds))
        if not cat_ids or not img_ids:
            return {"mAP": 0.0, "AP50": 0.0, "AP75": 0.0}

        T, R, K, A = len(IOU_THRS), len(RECALL_THRS), len(cat_ids), len(AREA_RANGES)
        precision = -np.ones((T, R, K, A))
        recall = -np.ones((T, K, A))

        for ki, cat in enumerate(cat_ids):
            cells = [self._cell(i, cat) for i in img_ids]
            cells = [c for c in cells if c is not None]
            if not cells:
                continue
            for ai, (_, lo, hi) in enumerate(AREA_RANGES):
                matched = [self._match_cell(c, lo, hi) for c in cells]
                npig = sum(m[3] for m in matched)
                if npig == 0:
                    continue
                scores = np.concatenate([m[0] for m in matched])
                dt_m = np.concatenate([m[1] for m in matched], axis=1)
                dt_ig = np.concatenate([m[2] for m in matched], axis=1)
                order = np.argsort(-scores, kind="mergesort")
                dt_m, dt_ig = dt_m[:, order], dt_ig[:, order]

                tps = np.cumsum(dt_m & ~dt_ig, axis=1, dtype=np.float64)
                fps = np.cumsum(~dt_m & ~dt_ig, axis=1, dtype=np.float64)
                for ti in range(T):
                    tp, fp = tps[ti], fps[ti]
                    nd = len(tp)
                    recall[ti, ki, ai] = tp[-1] / npig if nd else 0.0
                    if not nd:
                        precision[ti, :, ki, ai] = 0.0
                        continue
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    q = np.zeros(R)
                    idx = np.searchsorted(rc, RECALL_THRS, side="left")
                    valid = idx < nd
                    q[valid] = pr[idx[valid]]
                    precision[ti, :, ki, ai] = q

        def mean(x):
            x = x[x > -1]
            return float(x.mean()) if len(x) else -1.0

        t50 = int(np.argmin(np.abs(IOU_THRS - 0.5)))
        t75 = int(np.argmin(np.abs(IOU_THRS - 0.75)))
        return {
            "mAP": mean(precision[:, :, :, 0]),
            "AP50": mean(precision[t50, :, :, 0]),
            "AP75": mean(precision[t75, :, :, 0]),
            "AP_small": mean(precision[:, :, :, 1]),
            "AP_medium": mean(precision[:, :, :, 2]),
            "AP_large": mean(precision[:, :, :, 3]),
            "AR100": mean(recall[:, :, 0]),
        }
