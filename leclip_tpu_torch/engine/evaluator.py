"""Multi-label evaluation: per-class average precision, mAP, OP/OR/OF1/CP/CR/CF1,
and the merge-aux evaluator (the port's own copy of
leclip_tpu/engine/evaluator.py; numpy only).

Port of the reference metrics (ref: Dassl dassl/evaluation/evaluator.py:
average_precision :140-155, mAP :158-175, MLClassification :178-233 with the
``default_merge_aux`` global/local merge, and the OF1/CF1 suite :236-567).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """AP of one class: mean precision@i over positive ranks (identical
    formula to the reference, including the epsilon)."""
    eps = 1e-8
    order = scores.argsort()[::-1]
    t = targets[order]
    pos = t == 1
    pos_count = np.cumsum(pos)
    total = pos_count[-1] if len(pos_count) else 0
    prec_at_i = pos_count / np.arange(1, len(t) + 1)
    prec_at_i = prec_at_i[pos].sum()
    return float(prec_at_i / (total + eps))


def mAP(targets: np.ndarray, preds: np.ndarray) -> float:
    """Mean AP ×100 over classes; 0 for empty preds."""
    if preds.size == 0:
        return 0.0
    ap = [average_precision(preds[:, k], targets[:, k]) for k in range(preds.shape[1])]
    return float(100.0 * np.mean(ap))


def overall_and_perclass_f1(
    targets: np.ndarray, preds: np.ndarray, topk: int = 3
) -> Dict[str, float]:
    """OP/OR/OF1 (micro) and CP/CR/CF1 (macro) at top-k, the standard MLC
    operating-point metrics (ref evaluator.py:236-447)."""
    n, c = preds.shape
    pred_bin = np.zeros_like(preds, dtype=bool)
    topk_idx = np.argsort(-preds, axis=1)[:, :topk]
    np.put_along_axis(pred_bin, topk_idx, True, axis=1)
    tp = (pred_bin & (targets == 1)).sum(0).astype(np.float64)
    pred_pos = pred_bin.sum(0).astype(np.float64)
    real_pos = (targets == 1).sum(0).astype(np.float64)

    op = tp.sum() / max(pred_pos.sum(), 1e-8)
    orr = tp.sum() / max(real_pos.sum(), 1e-8)
    of1 = 2 * op * orr / max(op + orr, 1e-8)
    cp = np.mean(tp / np.maximum(pred_pos, 1e-8))
    cr = np.mean(tp / np.maximum(real_pos, 1e-8))
    cf1 = 2 * cp * cr / max(cp + cr, 1e-8)
    return {"OP": op, "OR": orr, "OF1": of1, "CP": cp, "CR": cr, "CF1": cf1}


class AveragePrecisionMeter:
    """Streaming per-class AP meter with threshold-at-zero operating-point
    metrics (ref dassl/evaluation/evaluator.py:251-422 ``AveragePrecisionMeter``).

    Differences from :func:`mAP` above (which mirrors the evaluator the
    shipped configs actually use): this meter's AP divides by the POSITIVE
    count with no epsilon, supports VOC-style difficult examples (target 0
    rows are skipped from the ranking when ``difficult_examples`` is set,
    target −1 rows are negatives), and its ``overall``/``overall_topk``
    binarise at ``score >= 0`` rather than at top-k rank alone.

    The reference grows two flat torch storages; here chunks accumulate in a
    list and concatenate lazily — same semantics, no quadratic copying.
    """

    def __init__(self, difficult_examples: bool = False):
        self.difficult_examples = difficult_examples
        self.reset()

    def reset(self):
        self._scores: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def add(self, output: np.ndarray, target: np.ndarray):
        output = np.asarray(output, dtype=np.float64)
        target = np.asarray(target)
        if output.ndim == 1:
            output = output[:, None]
        if target.ndim == 1:
            target = target[:, None]
        if output.ndim != 2 or target.ndim != 2:
            raise ValueError("output/target must be 1-D or 2-D (N, K)")
        if self._scores and target.shape[1] != self._targets[0].shape[1]:
            raise ValueError("class dimension must match previous chunks")
        self._scores.append(output)
        self._targets.append(target.astype(np.int64))

    def _stacked(self):
        return (np.concatenate(self._scores, 0), np.concatenate(self._targets, 0))

    @staticmethod
    def average_precision(output, target, difficult_examples=True) -> float:
        """AP of one class (ref evaluator.py:349-369): precision@i over the
        ranking with difficult (target 0) rows skipped when flagged; divides
        by the positive count (nan when the class has no positives, where
        the reference's scalar loop raises ZeroDivisionError)."""
        output = np.asarray(output, dtype=np.float64)
        target = np.asarray(target)
        order = np.argsort(-output, kind="stable")
        t = target[order]
        kept = np.ones(len(t), dtype=bool)
        if difficult_examples:
            kept = t != 0
        pos = (t == 1) & kept
        total = np.cumsum(kept)
        prec = np.cumsum(pos) / np.maximum(total, 1)
        n_pos = pos.sum()
        if n_pos == 0:
            return float("nan")
        return float(prec[pos].sum() / n_pos)

    def value(self) -> np.ndarray:
        """Per-class AP vector (ref evaluator.py:330-347)."""
        if not self._scores:
            return np.zeros(0)
        scores, targets = self._stacked()
        return np.array([
            self.average_precision(scores[:, k], targets[:, k],
                                   self.difficult_examples)
            for k in range(scores.shape[1])
        ])

    @staticmethod
    def evaluation(scores: np.ndarray, targets: np.ndarray):
        """OP/OR/OF1/CP/CR/CF1 with predicted-positive ≡ ``score >= 0``
        (ref evaluator.py:398-422; −1 targets count as negatives)."""
        targets = np.where(targets == -1, 0, targets).astype(np.float64)
        pred = scores >= 0
        Ng = (targets == 1).sum(0).astype(np.float64)
        Np = pred.sum(0).astype(np.float64)
        Nc = (targets * pred).sum(0)
        Np = np.where(Np == 0, 1.0, Np)
        OP = Nc.sum() / Np.sum()
        OR = Nc.sum() / Ng.sum()
        OF1 = (2 * OP * OR) / (OP + OR)
        CP = np.mean(Nc / Np)
        CR = np.mean(Nc / Ng)
        CF1 = (2 * CP * CR) / (CP + CR)
        return OP, OR, OF1, CP, CR, CF1

    def overall(self):
        if not self._scores:
            return 0
        scores, targets = self._stacked()
        return self.evaluation(scores, targets)

    def overall_topk(self, k: int):
        """Same suite with predictions restricted to each row's top-k scores
        AND a non-negative raw score (ref evaluator.py:382-396: top-k slots
        get +1 when the raw score is ≥ 0, −1 otherwise; the rest −1)."""
        if not self._scores:
            return 0
        scores, targets = self._stacked()
        n = scores.shape[0]
        marked = np.full_like(scores, -1.0)
        topk_idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        rows = np.arange(n)[:, None]
        marked[rows, topk_idx] = np.where(scores[rows, topk_idx] >= 0, 1.0, -1.0)
        return self.evaluation(marked, targets)


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC-standard interpolated AP over a recall/precision curve
    (ref evaluator.py:439-446 ``ComputeAP_VOC``): precision is made
    monotonically non-increasing right-to-left, then the area is summed at
    recall change-points."""
    rec = np.concatenate(([0.0], recall, [1.0]))
    prec = np.concatenate(([0.0], precision, [0.0]))
    prec = np.maximum.accumulate(prec[::-1])[::-1]
    idx = np.where(rec[1:] != rec[:-1])[0]
    return float(np.sum((rec[idx + 1] - rec[idx]) * prec[idx + 1]))


def voc2012_mAP(prediction: np.ndarray, class_num: int,
                seen_index=None, unseen_index=None):
    """VOC2012-standard mAP over an ``[confidence | ground-truth]`` matrix
    (ref evaluator.py:448-473 ``Compute_mAP_VOC2012``): per class, rank by
    confidence, cumulate TP/FP (gt > 0 is positive), and apply
    :func:`voc_ap` to the resulting curve. With ``seen_index``/
    ``unseen_index`` returns (seen mAP, unseen mAP, overall mAP) for
    base/novel class splits.

    A class with zero positives in ``gt`` yields ``recall = tp/0`` → a
    divide-by-zero warning and ``nan`` AP that propagates into the returned
    means — the reference behaves identically (its ``recall`` divides by the
    same unguarded count), so this is kept as parity; callers scoring
    partially-labeled matrices should drop all-negative columns first."""
    prediction = np.asarray(prediction, dtype=np.float64)
    conf = prediction[:, :class_num]
    gt = prediction[:, class_num:].astype(np.int32)
    aps = []
    for c in range(class_num):
        order = np.argsort(-conf[:, c], kind="stable")
        sorted_pos = gt[order, c] > 0
        n_pos = sorted_pos.sum()
        tp = np.cumsum(sorted_pos)
        fp = np.cumsum(~sorted_pos)
        recall = tp / float(n_pos)
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        aps.append(voc_ap(recall, precision))
    aps = np.array(aps)
    if seen_index is None and unseen_index is None:
        return float(np.mean(aps))
    return (float(np.mean(aps[seen_index])), float(np.mean(aps[unseen_index])),
            float(np.mean(aps)))


class MLClassificationEvaluator:
    """Accumulates (global logits, labels, local logits); ``evaluate`` merges
    global/local with GL_merge_rate and reports mAP (0 when labels are all
    zero — the unlabeled competition test set, matching the reference)."""

    def __init__(self, gl_merge_rate: float = 0.5, topk: int = 3):
        self.gl_merge_rate = gl_merge_rate
        self.topk = topk
        self.reset()

    def reset(self):
        self._y_true: List[np.ndarray] = []
        self._y_pred: List[np.ndarray] = []
        self._y_pred_aux: List[np.ndarray] = []

    def process(self, mo, gt, mo_aux=None):
        self._y_true.append(np.asarray(gt))
        self._y_pred.append(np.asarray(mo))
        if mo_aux is not None:
            self._y_pred_aux.append(np.asarray(mo_aux))

    def merged_predictions(self) -> np.ndarray:
        preds = np.concatenate(self._y_pred, axis=0)
        if self._y_pred_aux:
            aux = np.concatenate(self._y_pred_aux, axis=0)
            r = self.gl_merge_rate
            preds = preds * r + aux * (1 - r)
        return preds

    def evaluate(self) -> Dict[str, float]:
        targets = np.concatenate(self._y_true, axis=0)
        preds = self.merged_predictions()
        results = {}
        if targets.sum() == 0:
            # unlabeled test split: mAP undefined → 0 (reference behavior)
            results["mAP"] = 0.0
        else:
            results["mAP"] = mAP(targets, preds)
            results.update(overall_and_perclass_f1(targets, preds, self.topk))
        return results
