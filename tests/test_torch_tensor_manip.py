"""``tensor.manipulation``, ``tensor.logic`` and ``tensor.search`` of the
port against the JAX package on the CPU, forward and gradient
(``torch_tensor_oracle``): the reference's ``tests/test_tensor_ops.py``
cases and every op of the three modules, plus the places where a plain
torch call gives other numbers: ``argsort(descending=True)``'s tie
order, ``kthvalue``'s index, ``mode``, ``scatter(overwrite=False)``,
``unique``'s outputs and ``topk``'s ties.  Indices are int64 in the
port and int32 in the reference (``nonzero`` int32 in both): the
oracle holds them by value and kind.  Tolerances: f32 2e-5, gradients
1e-4, exact for integer, bool and index results.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from torch_tensor_oracle import check

RS = np.random.RandomState(1)
X = RS.randn(2, 3, 4).astype(np.float32)
M = RS.randn(4, 5).astype(np.float32)
TIES = np.array([[2.0, 1.0, 2.0, 3.0, 1.0, 2.0],
                 [0.0, 0.0, 5.0, 5.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    paddle_tpu_torch.set_device('cpu')
    yield
    paddle_tpu_torch.set_device(None)


def _i(a):
    return lambda P: P.to_tensor(np.asarray(a))


SHAPE_CASES = {
    'reshape': lambda P, x: P.reshape(x, [6, 4]),
    'reshape_neg': lambda P, x: P.reshape(x, [-1, 12]),
    'view': lambda P, x: P.view(x, [4, 6]),
    'flatten': lambda P, x: P.flatten(x, 1, 2),
    'transpose': lambda P, x: P.transpose(x, [2, 0, 1]),
    'moveaxis': lambda P, x: P.moveaxis(x, 0, -1),
    'concat': lambda P, x: P.concat([x, x * 2.0], axis=1),
    'split': lambda P, x: P.split(x, 2, axis=2),
    'split_sections': lambda P, x: P.split(x, [1, -1], axis=2),
    'chunk': lambda P, x: P.chunk(x, 3, axis=1),
    'stack': lambda P, x: P.stack([x, x], axis=1),
    'unstack': lambda P, x: P.unstack(x, axis=1),
    'unbind': lambda P, x: P.unbind(x, 2),
    'squeeze': lambda P, x: P.squeeze(P.unsqueeze(x, [0, 2]), [0, 2]),
    'unsqueeze': lambda P, x: P.unsqueeze(x, [0, 2]),
    'expand': lambda P, x: P.expand(x[:, :1], [2, 5, 4]),
    'expand_as': lambda P, x: P.expand_as(x[:1], x),
    'broadcast_to': lambda P, x: P.broadcast_to(x[:, :, :1], [2, 3, 4]),
    'tile': lambda P, x: P.tile(x, [2, 1, 1]),
    'flip': lambda P, x: P.flip(x, [0, 2]),
    'reverse': lambda P, x: P.reverse(x, 1),
    'rot90': lambda P, x: P.rot90(x, 1, [1, 2]),
    'roll': lambda P, x: P.roll(x, 1, 2),
    'roll_flat': lambda P, x: P.roll(x, 3),
    'gather': lambda P, x: P.gather(x, _i([2, 0])(P), axis=1),
    'gather_nd': lambda P, x: P.gather_nd(x, _i([[0, 1], [1, 2]])(P)),
    'index_select': lambda P, x: P.index_select(x, _i([3, 0, 3])(P), 2),
    'take_along_axis': lambda P, x: P.take_along_axis(
        x, _i(np.zeros((2, 1, 4), np.int64))(P), 1),
    'slice': lambda P, x: P.slice(x, [1, 2], [0, 1], [2, -1]),
    'strided_slice': lambda P, x: P.strided_slice(x, [2], [3], [0], [-2]),
    'strided_slice_pos': lambda P, x: P.strided_slice(x, [1, 2], [0, 0],
                                                      [3, 4], [2, 3]),
    'crop': lambda P, x: P.crop(x, [2, 2, -1], [0, 1, 1]),
    'atleast': lambda P, x: [P.atleast_1d(x[0, 0, 0]),
                             P.atleast_2d(x[0, 0]), P.atleast_3d(x[0])],
    'tensordot': lambda P, x: P.tensordot(x, x, axes=[[1, 2], [1, 2]]),
    'repeat_interleave': lambda P, x: P.repeat_interleave(x, 2, axis=1),
    'cast': lambda P, x: P.cast(x, 'float32') * 2.0,
}


@pytest.mark.parametrize('name', sorted(SHAPE_CASES))
def test_shape_ops(name):
    check(SHAPE_CASES[name], [X], what=name)


def test_reference_manipulation_cases():
    a = np.arange(24.0).reshape(2, 3, 4).astype('float32')
    for P in (paddle_tpu, paddle_tpu_torch):
        t = P.to_tensor(a)
        assert list(P.reshape(t, [-1, 12]).shape) == [2, 12]
        parts = P.split(P.concat([t, t], axis=1), 2, axis=1)
        assert len(parts) == 2 and list(parts[0].shape) == [2, 3, 4]
        assert list(P.squeeze(P.unsqueeze(t, [0, 2])).shape) == [2, 3, 4]
        np.testing.assert_array_equal(np.asarray(P.flip(
            P.to_tensor([1.0, 2.0]), 0).numpy()), [2, 1])
    x = np.array([[1.0, 2], [3, 4], [5, 6]], np.float32)
    up = np.array([[9.0, 9], [8, 8]], np.float32)
    check(lambda P, v, u: P.scatter(v, _i([0, 2])(P), u), [x, up])


def test_scatter_without_overwrite_adds_into_x():
    x = np.array([[1.0, 2], [3, 4], [5, 6]], np.float32)
    up = np.array([[9.0, 9], [8, 8], [1, 1]], np.float32)
    out = check(lambda P, v, u: P.scatter(v, _i([0, 2, 0])(P), u,
                                          overwrite=False), [x, up])
    np.testing.assert_array_equal(out[0].detach().numpy(),
                                  [[11, 12], [3, 4], [13, 14]])


def test_scatter_nd_family():
    x = np.zeros((3, 4), np.float32)
    up = np.array([1.0, 2.0, 3.0], np.float32)
    idx = np.array([[0, 1], [2, 3], [0, 1]])
    check(lambda P, v, u: P.scatter_nd_add(v, _i(idx)(P), u), [x, up])
    check(lambda P, u: P.scatter_nd(_i(idx)(P), u, [3, 4]), [up])


def test_put_along_axis():
    idx = np.array([[1], [0], [3]])
    check(lambda P, v: P.put_along_axis(v, _i(idx)(P), 9.0, 1),
          [M[:3].copy()])
    check(lambda P, v: P.put_along_axis(v, _i(idx)(P), 2.0, 1,
                                        reduce='add'), [M[:3].copy()])


@pytest.mark.parametrize('kw', [{}, {'return_index': True},
                                {'return_inverse': True},
                                {'return_counts': True},
                                {'return_index': True,
                                 'return_inverse': True,
                                 'return_counts': True}],
                         ids=['plain', 'index', 'inverse', 'counts', 'all'])
def test_unique(kw):
    v = np.array([3, 1, 2, 3, 1, 5, 2, 2], np.int32)
    check(lambda P, x: P.unique(x, **kw), [v])


def test_unique_along_an_axis():
    v = np.array([[1, 2], [3, 4], [1, 2], [0, 9]], np.int32)
    check(lambda P, x: P.unique(x, return_counts=True, axis=0), [v])


def test_shape_queries():
    check(lambda P, x: [P.shape(x), P.rank(x), P.numel(x)], [X])
    assert paddle_tpu_torch.tolist(paddle_tpu_torch.to_tensor(M)) == \
        paddle_tpu.tolist(paddle_tpu.to_tensor(M))
    v = np.array([0, 5, 9, 14, 3], np.int32)
    check(lambda P, x: P.shard_index(x, 20, 2, 1), [v])
    for P in (paddle_tpu, paddle_tpu_torch):
        with pytest.raises(NotImplementedError):
            P.as_strided(P.to_tensor(M), [2], [1])


def test_in_place_shape_ops():
    """The reference's ``test_shape_inplace_variants`` and
    ``test_scatter_inplace``."""
    x = paddle_tpu_torch.to_tensor(np.arange(6, dtype='float32'))
    assert paddle_tpu_torch.reshape_(x, [2, 3]) is x
    assert list(x.shape) == [2, 3]
    paddle_tpu_torch.unsqueeze_(x, 0)
    assert list(x.shape) == [1, 2, 3]
    paddle_tpu_torch.squeeze_(x, 0)
    assert list(x.shape) == [2, 3]
    paddle_tpu_torch.flatten_(x)
    assert list(x.shape) == [6]
    np.testing.assert_array_equal(x.numpy(), np.arange(6))
    z = paddle_tpu_torch.to_tensor(np.zeros((3, 2), 'float32'))
    paddle_tpu_torch.scatter_(z, paddle_tpu_torch.to_tensor(
        np.asarray([1], 'int64')), paddle_tpu_torch.to_tensor(
        np.ones((1, 2), 'float32')))
    np.testing.assert_array_equal(z.numpy(), [[0, 0], [1, 1], [0, 0]])


# -- logic -------------------------------------------------------------------

CMP = ['equal', 'not_equal', 'greater_than', 'greater_equal', 'less_than',
       'less_equal', 'logical_and', 'logical_or', 'logical_xor']


@pytest.mark.parametrize('name', CMP)
def test_comparisons(name):
    a = np.array([1.0, 2.0, 0.0, 3.0], np.float32)
    b = np.array([3.0, 2.0, 0.0, 1.0], np.float32)
    check(lambda P, x, y: getattr(P, name)(x, y), [a, b])
    check(lambda P, x: getattr(P, name)(x, 2.0), [a])


@pytest.mark.parametrize('name', ['bitwise_and', 'bitwise_or',
                                  'bitwise_xor'])
def test_bitwise(name):
    a = np.array([5, 3, -2, 7], np.int32)
    b = np.array([1, 6, 3, -8], np.int32)
    check(lambda P, x, y: getattr(P, name)(x, y), [a, b])
    check(lambda P, x: P.bitwise_not(x), [a])
    check(lambda P, x, y: getattr(P, name)(x, y), [a > 0, b > 0])


def test_closeness_and_emptiness():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = a + np.array([0.0, 1e-6, 1e-3], np.float32)
    check(lambda P, x, y: [P.allclose(x, y), P.isclose(x, y),
                           P.equal_all(x, x), P.equal_all(x, y),
                           P.logical_not(x > 1.5)], [a, b])
    check(lambda P, x, y: P.allclose(x, y, rtol=1e-2), [a, b])
    for P in (paddle_tpu, paddle_tpu_torch):
        assert bool(P.is_empty(P.zeros([0, 2])))
        assert not bool(P.is_empty(P.to_tensor(a)))
        assert P.is_tensor(P.to_tensor(a)) and not P.is_tensor(a)


# -- search ------------------------------------------------------------------

def test_reference_search_cases():
    x = np.array([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]], np.float32)
    check(lambda P, v: [P.argmax(v, axis=1), *P.topk(v, 2, axis=1),
                        P.sort(v, axis=1)], [x])
    w = np.array([1.0, -1.0, 2.0], np.float32)
    check(lambda P, v: P.where(v > 0, v, P.zeros_like(v)), [w])
    check(lambda P, v: P.masked_select(v, v > 0), [w], grad=False)
    check(lambda P, v: P.nonzero(v), [np.array([0, 3, 0, 4], np.int32)])
    check(lambda P, v: P.nonzero(v, as_tuple=True), [TIES])


@pytest.mark.parametrize('descending', [False, True])
def test_sort_and_argsort_tie_order(descending):
    out = check(lambda P, v: [P.argsort(v, axis=1, descending=descending),
                              P.sort(v, axis=1, descending=descending)],
                [TIES])
    if descending:      # the highest index first among equal values
        assert out[0][0].tolist()[:3] == [3, 5, 2]


def test_topk_ties_and_smallest():
    check(lambda P, v: P.topk(v, 3, axis=1), [TIES])
    check(lambda P, v: P.topk(v, 2, axis=0, largest=False), [TIES])


@pytest.mark.parametrize('name', ['argmax', 'argmin'])
def test_arg_extremes(name):
    check(lambda P, v: [getattr(P, name)(v), getattr(P, name)(v, axis=1),
                        getattr(P, name)(v, axis=0, keepdim=True)], [TIES])


def test_kthvalue_and_mode():
    check(lambda P, v: P.kthvalue(v, 3, axis=1), [TIES])
    check(lambda P, v: P.kthvalue(v, 2, axis=0, keepdim=True), [TIES])
    out = check(lambda P, v: P.mode(v, axis=1), [TIES])
    np.testing.assert_array_equal(out[0].detach().numpy(), [2.0, 0.0])
    np.testing.assert_array_equal(out[1].numpy(), [0, 0])
    check(lambda P, v: P.mode(v, axis=0, keepdim=True), [TIES])


def test_index_ops():
    idx = np.array([[2, 0], [1, 1], [3, 0], [4, 2]])
    check(lambda P, v: P.index_sample(v, _i(idx)(P)), [M])
    seq = np.array([1.0, 2.0, 4.0, 4.0, 7.0], np.float32)
    vals = np.array([0.5, 4.0, 8.0, 2.0], np.float32)
    for right in (False, True):
        check(lambda P, s, v: P.searchsorted(s, v, right=right),
              [seq, vals])
    check(lambda P, v: P.masked_select(v, v[:1] > 0), [M], grad=False)
    check(lambda P, v: P.where(v > 0, v, v * 0.5), [M])


def test_masked_select_takes_a_gradient_in_the_port_only():
    """The reference selects on the host and returns a fresh tensor with
    no tape: its gradient is lost (ROADMAP Queue 3).  The port's
    selection is differentiable: the cotangent lands on the selected
    elements."""
    r = paddle_tpu.to_tensor(M)
    r.stop_gradient = False
    sel = paddle_tpu.masked_select(r, r > 0)
    assert sel.stop_gradient and sel.grad_node is None
    p = torch.tensor(M, requires_grad=True)
    paddle_tpu_torch.masked_select(p, p > 0).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), (M > 0).astype(np.float32))
