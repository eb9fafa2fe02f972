"""Metrics: Accuracy / Precision / Recall / Auc (counterpart of
``paddle_tpu/metric``; Paddle's python/paddle/metric/metrics.py).

The reference's state discipline, on torch tensors: ``compute`` runs on
the device inside the step (``hapi.Model``'s train, eval and fused
steps) and reduces the batch to a small statistic (correct counts,
tp/fp, AUC histogram buckets); ``update`` adds that statistic into
device-resident integer state with no host read (lazy device ops), so
``Model.evaluate`` reads nothing back per batch; the one host read is
``accumulate()``.  The counts are exact: ``_LongCounter`` keeps two
int32 limbs and folds the carry on the device, as the reference does.
The legacy eager calls (``update(preds, labels)`` with raw predictions)
still work and route through the same ``compute``.
"""
import abc

import numpy as np
import torch

from ..tensor.search import stable_topk

__all__ = ['Metric', 'Accuracy', 'Precision', 'Recall', 'Auc', 'accuracy']


def _to_t(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


class _LongCounter:
    """Device-resident EXACT integer accumulator for streaming metric
    states: two int32 limbs (`hi` in units of 2^16), with the carry
    fold every `_FOLD_EVERY` adds done ON DEVICE — `add` is always a
    lazy device op, never a host sync, and the representable total
    (~1.4e14 per element) outlives any eval stream.  (A single f32
    state saturates at 2^24 and a single int32 wraps at 2^31; the one
    host sync is `read()` at accumulate time.)  The limbs live on the
    device of the first statistic added."""

    _FOLD_EVERY = 1024

    def __init__(self, shape):
        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.lo = None
        self.hi = None
        self._adds = 0

    def add(self, x):
        x = _to_t(x)
        if self.lo is None:
            self.lo = torch.zeros(self.shape, dtype=torch.int32,
                                  device=x.device)
            self.hi = torch.zeros_like(self.lo)
        self.lo = self.lo + x.to(torch.int32)
        self._adds += 1
        if self._adds >= self._FOLD_EVERY:
            carry = self.lo >> 16          # still lazy device math
            self.hi = self.hi + carry
            self.lo = self.lo - (carry << 16)
            self._adds = 0

    def read(self):
        """Host int64 totals — the single device->host sync."""
        if self.lo is None:
            return np.zeros(self.shape, np.int64)
        return ((self.hi.cpu().numpy().astype(np.int64) << 16)
                + self.lo.cpu().numpy().astype(np.int64))


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Device-side pre-computation; runs inside the step."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or 'acc'
        self.reset()

    def compute(self, pred, label, *args):
        """The correctness matrix [N, maxk] (f32, on the device).  The
        top k take the lowest index among equal scores, as the
        reference's ``lax.top_k``; k clamps to the class count."""
        pred = _to_t(pred)
        label = _to_t(label)
        _, pred_idx = stable_topk(pred, min(self.maxk, pred.shape[-1]))
        if label.dim() == pred.dim():  # one-hot or column labels
            if label.shape[-1] == 1:
                label = label[..., 0]
            else:
                label = torch.argmax(label, dim=-1)
        return (pred_idx == label[..., None]).to(torch.float32)

    def update(self, correct, *args):
        """Accumulate per-topk correct counts as LAZY device adds (no
        host read); returns the batch accuracies as device scalars
        (callers that print force the sync, not the update)."""
        correct = _to_t(correct)
        n = correct.shape[0]
        nums = torch.stack([torch.sum(correct[..., :k])
                            for k in self.topk])
        self.total.add(torch.round(nums))
        self.count += n
        accs = [nums[i] / max(1, n) for i in range(len(self.topk))]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = _LongCounter(len(self.topk))
        self.count = 0

    def accumulate(self):
        tot = self.total.read()   # the single host sync
        res = [float(t) / max(1, self.count) for t in tot]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return ['{}_top{}'.format(self._name, k) for k in self.topk]


class Precision(Metric):
    """Binary precision over thresholded predictions."""

    _STAT_LEN = 2   # (tp, fp)

    def __init__(self, name='precision', *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def compute(self, preds, labels, *args):
        """[tp, fp] of the batch as an int32 device statistic."""
        p = _to_t(preds).reshape(-1)
        y = _to_t(labels).reshape(-1)
        pred_pos = p > 0.5
        tp = torch.sum(pred_pos & (y == 1))
        fp = torch.sum(pred_pos & (y != 1))
        return torch.stack([tp, fp]).to(torch.int32)

    def update(self, stat, labels=None):
        """`stat` is compute()'s [tp, fp]; the legacy eager call
        update(preds, labels) routes through compute first."""
        if labels is not None:
            stat = self.compute(stat, labels)
        self._stat.add(stat)

    def reset(self):
        self._stat = _LongCounter(2)

    def accumulate(self):
        tp, fp = self._stat.read()
        denom = tp + fp
        return float(tp / denom) if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall over thresholded predictions."""

    def __init__(self, name='recall', *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def compute(self, preds, labels, *args):
        """[tp, fn] of the batch as an int32 device statistic."""
        p = _to_t(preds).reshape(-1)
        y = _to_t(labels).reshape(-1)
        pred_pos = p > 0.5
        tp = torch.sum(pred_pos & (y == 1))
        fn = torch.sum(~pred_pos & (y == 1))
        return torch.stack([tp, fn]).to(torch.int32)

    def update(self, stat, labels=None):
        if labels is not None:
            stat = self.compute(stat, labels)
        self._stat.add(stat)

    def reset(self):
        self._stat = _LongCounter(2)

    def accumulate(self):
        tp, fn = self._stat.read()
        denom = tp + fn
        return float(tp / denom) if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via histogram buckets (streaming-friendly).  The bucket
    histograms are device state summed per batch; the trapezoid walk
    happens once, at accumulate()."""

    def __init__(self, curve='ROC', num_thresholds=4095, name='auc',
                 *args, **kwargs):
        super().__init__()
        self.curve = curve
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def compute(self, preds, labels, *args):
        """Batch bucket histograms stacked [2, T+1] (pos, neg), int32 —
        a scatter-add on the device."""
        p = _to_t(preds)
        y = _to_t(labels).reshape(-1)
        if p.dim() == 2 and p.shape[1] == 2:
            scores = p[:, 1]
        else:
            scores = p.reshape(-1)
        n = self.num_thresholds + 1
        buckets = torch.clamp(
            (scores * self.num_thresholds).to(torch.int32),
            0, self.num_thresholds).long()
        pos = (y != 0).to(torch.int32)
        zeros = torch.zeros(n, dtype=torch.int32, device=p.device)
        pos_hist = zeros.index_add(0, buckets, pos)
        neg_hist = zeros.index_add(0, buckets, 1 - pos)
        return torch.stack([pos_hist, neg_hist])

    def update(self, stat, labels=None):
        """`stat` is compute()'s [2, T+1] histogram pair; the legacy
        eager call update(preds, labels) routes through compute.  The
        state is a _LongCounter: exact int64-range totals with every
        add (and the periodic carry fold) staying on the device."""
        if labels is not None:
            stat = self.compute(stat, labels)
        self._stat.add(stat)

    def reset(self):
        self._stat = _LongCounter((2, self.num_thresholds + 1))

    @property
    def _stat_pos(self):
        """Host view of the positive buckets."""
        return self._stat.read()[0]

    @property
    def _stat_neg(self):
        return self._stat.read()[1]

    def accumulate(self):
        # walk thresholds high->low accumulating TP/FP; trapezoid rule
        stat = self._stat.read()   # the single host sync
        stat_pos, stat_neg = stat[0], stat[1]
        tot_pos = float(stat_pos.sum())
        tot_neg = float(stat_neg.sum())
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp = fp = 0.0
        auc = 0.0
        prev_tpr = prev_fpr = 0.0
        for b in range(self.num_thresholds, -1, -1):
            tp += float(stat_pos[b])
            fp += float(stat_neg[b])
            tpr, fpr = tp / tot_pos, fp / tot_neg
            auc += (fpr - prev_fpr) * (tpr + prev_tpr) / 2.0
            prev_tpr, prev_fpr = tpr, fpr
        return auc

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (reference: paddle.metric.accuracy): a
    [1] f32 tensor."""
    x, y = _to_t(input), _to_t(label)
    _, pred_idx = stable_topk(x, min(k, x.shape[-1]))
    if y.dim() == x.dim():
        if y.shape[-1] == 1:
            y = y[..., 0]
        else:
            y = torch.argmax(y, dim=-1)
    correct_mat = (pred_idx == y[..., None]).any(dim=-1)
    # the reference's compiled mean multiplies the sum by the f32
    # reciprocal of the count
    n = max(1, correct_mat.numel())
    return (torch.sum(correct_mat.to(torch.float32))
            * np.float32(1.0 / n)).reshape(1)
