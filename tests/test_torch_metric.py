"""The port's ``metric`` against the JAX package's, on the CPU: the same
seeded batches through ``compute`` and ``update`` of both, then
``accumulate``.

Counts are held exactly: every accumulated statistic (correct counts,
tp/fp/fn, the AUC histograms) and the ratios formed from them on the
host, the batch accuracies ``update`` returns, and the functional
``accuracy``; the AUC's trapezoid walk runs in double on the host from
the same integer histograms, so it is held exactly too.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import metric as jmetric
from paddle_tpu_torch import metric


def _batches(n, b, c, seed=0, onehot=False, column=True):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        # a coarse grid of scores makes ties common
        pred = (rs.randint(0, 4, (b, c)) / 4.0).astype(np.float32)
        lab = rs.randint(0, c, (b,))
        if onehot:
            y = np.eye(c, dtype=np.float32)[lab]
        elif column:
            y = lab[:, None].astype(np.int64)
        else:
            y = lab.astype(np.int64)
        out.append((pred, y))
    return out


def _run(m, batches, wrap):
    rets = []
    for p, y in batches:
        stat = m.compute(wrap(p), wrap(y))
        r = m.update(*stat) if isinstance(stat, (tuple, list)) \
            else m.update(stat)
        rets.append(r)
    return rets, m.accumulate()


def _val(x):
    if isinstance(x, (list, tuple)):
        return [_val(v) for v in x]
    if x is None:
        return None
    return float(np.asarray(x.numpy() if hasattr(x, 'numpy') else x))


ACC_CASES = [((1,), {}), ((1, 3), {}), ((2, 5), {}), (1, dict(onehot=True)),
             ((1, 2), dict(column=False)), ((1, 9), {})]


@pytest.mark.parametrize('topk,kw', ACC_CASES, ids=str)
def test_accuracy_counts_equal_the_reference(topk, kw):
    batches = _batches(5, 16, 7, **kw)
    j_rets, j_acc = _run(jmetric.Accuracy(topk=topk), batches,
                         jpaddle.to_tensor)
    p = metric.Accuracy(topk=topk)
    p_rets, p_acc = _run(p, batches, torch.from_numpy)
    assert _val(p_rets) == _val(j_rets)
    assert p_acc == j_acc
    assert p.name() == jmetric.Accuracy(topk=topk).name()
    assert p.count == 5 * 16


def test_accuracy_compute_is_the_references_correctness_matrix():
    (pred, y), = _batches(1, 32, 5, seed=3)
    want = np.asarray(jmetric.Accuracy(topk=(1, 3)).compute(
        jpaddle.to_tensor(pred), jpaddle.to_tensor(y)))
    got = metric.Accuracy(topk=(1, 3)).compute(torch.from_numpy(pred),
                                               torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('cls', ['Precision', 'Recall'])
def test_precision_recall_equal_the_reference(cls):
    rs = np.random.RandomState(1)
    batches = [(rs.rand(20).astype(np.float32),
                rs.randint(0, 2, (20,)).astype(np.int64)) for _ in range(4)]
    jm, pm = getattr(jmetric, cls)(), getattr(metric, cls)()
    for p, y in batches:
        js = jm.compute(jpaddle.to_tensor(p), jpaddle.to_tensor(y))
        ps = pm.compute(torch.from_numpy(p), torch.from_numpy(y))
        assert ps.dtype == torch.int32
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        jm.update(js)
        pm.update(ps)
    assert pm.accumulate() == jm.accumulate()
    # the legacy eager call update(preds, labels)
    jm.reset(), pm.reset()
    for p, y in batches:
        jm.update(jpaddle.to_tensor(p), jpaddle.to_tensor(y))
        pm.update(torch.from_numpy(p), torch.from_numpy(y))
    assert pm.accumulate() == jm.accumulate()
    assert pm.name() == jm.name()


def test_empty_metrics_accumulate_to_zero():
    for cls in ('Precision', 'Recall', 'Auc'):
        assert getattr(metric, cls)().accumulate() == \
            getattr(jmetric, cls)().accumulate() == 0.0
    assert metric.Accuracy().accumulate() == 0.0


@pytest.mark.parametrize('shape,thresholds', [((64,), 4095), ((64, 2), 200),
                                              ((64, 1), 31)])
def test_auc_histograms_and_value_equal_the_reference(shape, thresholds):
    rs = np.random.RandomState(2)
    jm = jmetric.Auc(num_thresholds=thresholds)
    pm = metric.Auc(num_thresholds=thresholds)
    for _ in range(3):
        p = rs.rand(*shape).astype(np.float32)
        y = rs.randint(0, 2, (shape[0],)).astype(np.int64)
        js = jm.compute(jpaddle.to_tensor(p), jpaddle.to_tensor(y))
        ps = pm.compute(torch.from_numpy(p), torch.from_numpy(y))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        jm.update(js)
        pm.update(ps)
    np.testing.assert_array_equal(pm._stat_pos, jm._stat_pos)
    np.testing.assert_array_equal(pm._stat_neg, jm._stat_neg)
    assert pm.accumulate() == jm.accumulate()


def test_long_counter_folds_its_carry_exactly(monkeypatch):
    """Past the fold the totals stay exact integers on the device, as
    the reference's two-limb counter keeps them."""
    monkeypatch.setattr(metric._LongCounter, '_FOLD_EVERY', 3)
    monkeypatch.setattr(jmetric._LongCounter, '_FOLD_EVERY', 3)
    pc, jc = metric._LongCounter(2), jmetric._LongCounter(2)
    rs = np.random.RandomState(4)
    for _ in range(10):
        x = rs.randint(0, 2 ** 20, (2,)).astype(np.int32)
        pc.add(torch.from_numpy(x))
        jc.add(jpaddle.to_tensor(x).value)
    np.testing.assert_array_equal(pc.read(), jc.read())
    np.testing.assert_array_equal(pc.lo.numpy(), np.asarray(jc.lo))
    np.testing.assert_array_equal(pc.hi.numpy(), np.asarray(jc.hi))
    assert pc.read().dtype == np.int64


@pytest.mark.parametrize('k', [1, 2, 4])
def test_functional_accuracy_equals_the_reference(k):
    for onehot in (False, True):
        (pred, y), = _batches(1, 24, 6, seed=5, onehot=onehot)
        want = jmetric.accuracy(jpaddle.to_tensor(pred),
                                jpaddle.to_tensor(y), k=k)
        got = metric.accuracy(torch.from_numpy(pred), torch.from_numpy(y),
                              k=k)
        assert tuple(got.shape) == tuple(want.shape) == (1,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_metric_is_abstract_and_compute_passes_through():
    class Mine(metric.Metric):
        def reset(self):
            pass

        def update(self, *a):
            pass

        def accumulate(self):
            return 1

        def name(self):
            return 'mine'
    x = torch.ones(2)
    assert Mine().compute(x, x) == (x, x)
    with pytest.raises(TypeError):
        metric.Metric()
