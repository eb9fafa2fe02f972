"""fleet.metrics — metrics aggregated over every trainer (counterpart
of ``paddle_tpu/distributed/fleet/metrics``): each worker keeps local
accumulators, and these helpers reduce them over the workers before the
final formula, as the reference's ``metric.py`` does.

Two routes, as the reference's: inside a training step over ``dp``
(``collective.axis_scope``) a tensor is all-reduced over the ``dp``
group on its device (the tensor itself where ``dp`` is 1), the
reference's in-trace ``psum``; otherwise the values (numpy arrays,
torch tensors or numbers) go through ``fleet.util.all_reduce`` on the
host, the value itself on one worker.  ``scope`` is accepted and
unread; ``util`` overrides the default ``fleet.util``.
"""
import math

import numpy as np

__all__ = ['sum', 'max', 'min', 'auc', 'mae', 'rmse', 'mse', 'acc']


def _unwrap(x):
    if hasattr(x, 'detach') and hasattr(x, 'cpu'):
        return x.detach().cpu().numpy()
    return x


def _default_util():
    from ..fleet_base import get_fleet
    return get_fleet().util


def _reduce(value, mode, util=None, axis='dp'):
    """The all-trainer reduce: over the step's ``dp`` group for a tensor
    inside a step, on the host otherwise."""
    import torch
    from ... import collective
    if torch.is_tensor(value) and axis in collective.current_axes():
        group = collective.scope_group(axis)
        if group is None:
            return value
        op = {'sum': collective.ReduceOp.SUM, 'max': collective.ReduceOp.MAX,
              'min': collective.ReduceOp.MIN}[mode]
        return collective.all_reduce(value.clone(), op, group)
    arr = np.asarray(_unwrap(value))
    if util is None:
        util = _default_util()
    out = util.all_reduce(arr.reshape(-1), mode)
    return np.asarray(out).reshape(arr.shape)


def sum(input, scope=None, util=None):
    """Distributed sum (reference metric.py:24)."""
    return _reduce(input, 'sum', util)


def max(input, scope=None, util=None):
    """Distributed elementwise max (reference metric.py:64)."""
    return _reduce(input, 'max', util)


def min(input, scope=None, util=None):
    """Distributed elementwise min (reference metric.py:104)."""
    return _reduce(input, 'min', util)


def _auc_from_buckets(global_pos, global_neg):
    """Reference metric.py:203-226: walk buckets high→low, trapezoid
    area over the (neg, pos) cumulative counts."""
    pos_b = np.asarray(global_pos, np.float64).reshape(-1)
    neg_b = np.asarray(global_neg, np.float64).reshape(-1)
    area = 0.0
    pos = neg = 0.0
    total = 0.0
    for index in range(len(pos_b) - 1, -1, -1):
        new_pos = pos + pos_b[index]
        new_neg = neg + neg_b[index]
        total += pos_b[index] + neg_b[index]
        area += (new_neg - neg) * (pos + new_pos) / 2
        pos, neg = new_pos, new_neg
    if pos * neg == 0 or total == 0:
        return 0.5
    return float(area / (pos * neg))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Distributed AUC from per-worker histogram buckets (reference
    metric.py:144): allreduce-sum the pos/neg bucket counts, then the
    trapezoid walk.  Buckets are what `paddle.metric.Auc` keeps in
    `_stat_pos`/`_stat_neg` (or the reference fluid.layers.auc
    StatPos/StatNeg vars, shape [N] or [1, N])."""
    global_pos = _reduce(np.asarray(_unwrap(stat_pos)), 'sum', util)
    global_neg = _reduce(np.asarray(_unwrap(stat_neg)), 'sum', util)
    return _auc_from_buckets(global_pos, global_neg)


def mae(abserr, total_ins_num, scope=None, util=None):
    """Distributed MAE (reference metric.py:227): global sum of abs
    error over global instance count."""
    g = np.asarray(_reduce(abserr, 'sum', util)).reshape(-1)
    n = np.asarray(_reduce(total_ins_num, 'sum', util)).reshape(-1)
    return float(g[0]) / float(n[0])


def mse(sqrerr, total_ins_num, scope=None, util=None):
    """Distributed MSE (reference metric.py:325)."""
    g = np.asarray(_reduce(sqrerr, 'sum', util)).reshape(-1)
    n = np.asarray(_reduce(total_ins_num, 'sum', util)).reshape(-1)
    return float(g[0]) / float(n[0])


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    """Distributed RMSE (reference metric.py:276)."""
    return math.sqrt(mse(sqrerr, total_ins_num, scope, util))


def acc(correct, total, scope=None, util=None):
    """Distributed accuracy (reference metric.py:373): global correct
    count over global sample count."""
    c = np.asarray(_reduce(correct, 'sum', util)).reshape(-1)
    t = np.asarray(_reduce(total, 'sum', util)).reshape(-1)
    return float(c[0]) / float(t[0])
