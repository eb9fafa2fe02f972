"""The port's recurrent layers (``nn/layer/rnn.py``) against the JAX
package's, on the CPU.

Each JAX layer is built from a seed, its weights carried into the port's
layer of the same signature through numpy (the state-dict keys are the
same); the same seeded inputs go through both, and the output, every
parameter's gradient and the input's gradient of ``sum(output * cot)``
are compared (``torch_seq_oracle``).  Tolerances, relative to the
largest magnitude of the JAX result: f32 forward 2e-5 and gradients
1e-4 (a loop over time against ``lax.scan``, the input projection as
one matmul).  Dropout between layers runs at p 1e-9, which keeps every
element at scale 1 in f32, so the branch runs and both sides agree.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from torch_seq_oracle import (close, compare_vjp, host_state, jt,
                              load_from_jax, np32)

TOL, GRAD_TOL = 2e-5, 1e-4
IN, H, B, T = 5, 6, 3, 4


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(cls, *args, **kw):
    jpaddle.seed(0)
    jm = getattr(jpaddle.nn, cls)(*args, **kw)
    pm = getattr(nn, cls)(*args, **kw)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jm.state_dict().items()}
    return jm, load_from_jax(pm, jm)


CELLS = [('SimpleRNNCell', {}), ('SimpleRNNCell', {'activation': 'relu'}),
         ('LSTMCell', {}), ('GRUCell', {})]


@pytest.mark.parametrize('cls,kw', CELLS, ids=['rnn_tanh', 'rnn_relu',
                                               'lstm', 'gru'])
@pytest.mark.parametrize('with_states', [False, True])
def test_cell_matches_jax(cls, kw, with_states):
    jm, pm = _pair(cls, IN, H, **kw)
    x, h, c = _x(B, IN), _x(B, H, seed=1), _x(B, H, seed=2)
    lstm = cls == 'LSTMCell'
    if not with_states:
        compare_vjp(jm, pm, lambda m, a: m(a), [x], TOL, GRAD_TOL)
    elif lstm:
        compare_vjp(jm, pm, lambda m, a, hh, cc: m(a, (hh, cc))[1][1],
                    [x, h, c], TOL, GRAD_TOL)
    else:
        compare_vjp(jm, pm, lambda m, a, hh: m(a, hh), [x, h], TOL,
                    GRAD_TOL)
    assert pm.state_shape == jm.state_shape


def test_cell_default_init_is_uniform_over_one_over_sqrt_hidden():
    cell = nn.LSTMCell(IN, 100)
    bound = 1.0 / 10.0
    for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh):
        assert float(p.abs().max()) <= bound
        assert float(p.abs().max()) > 0.9 * bound
    assert tuple(cell.weight_ih.shape) == (400, IN)      # [gates * H, in]


STACKS = [(cls, direction, time_major)
          for cls in ('SimpleRNN', 'LSTM', 'GRU')
          for direction in ('forward', 'bidirect')
          for time_major in (False, True)]


@pytest.mark.parametrize('cls,direction,time_major', STACKS)
def test_stack_matches_jax(cls, direction, time_major):
    """Two layers, dropout p 1e-9 between them, training mode."""
    jm, pm = _pair(cls, IN, H, 2, direction, time_major, 1e-9)
    x = _x(T, B, IN) if time_major else _x(B, T, IN)
    compare_vjp(jm, pm, lambda m, a: m(a), [x], TOL, GRAD_TOL)
    jout, jst = jm(jt(x))
    pout, pst = pm(torch.from_numpy(x))
    for a, b in zip(jst if cls == 'LSTM' else [jst],
                    pst if cls == 'LSTM' else [pst]):
        assert tuple(b.shape) == (2 * (2 if direction == 'bidirect' else 1),
                                  B, H)
        close(np32(b), np32(a), TOL, 'final state')


def test_relu_stack_and_initial_states_match_jax():
    jm, pm = _pair('SimpleRNN', IN, H, 2, activation='relu')
    h0 = _x(2, B, H, seed=4)
    compare_vjp(jm, pm, lambda m, a, h: m(a, h), [_x(B, T, IN), h0], TOL,
                GRAD_TOL)
    jm, pm = _pair('LSTM', IN, H, 2, 'bidirect')
    h0, c0 = _x(4, B, H, seed=4), _x(4, B, H, seed=5)
    compare_vjp(jm, pm, lambda m, a, h, c: m(a, (h, c))[1][1],
                [_x(B, T, IN), h0, c0], TOL, GRAD_TOL)


def test_sequence_length_is_read_by_neither_package():
    """The reference takes ``sequence_length`` and never reads it: padded
    steps run like the others, in both packages."""
    jm, pm = _pair('GRU', IN, H, 1)
    x = _x(B, T, IN)
    lens = np.array([1, 2, 4], np.int64)
    jout = np32(jm(jt(x), sequence_length=jt(lens))[0])
    pout = np32(pm(torch.from_numpy(x),
                   sequence_length=torch.from_numpy(lens))[0])
    assert np.array_equal(pout, np32(pm(torch.from_numpy(x))[0]))
    assert np.array_equal(jout, np32(jm(jt(x))[0]))
    close(pout, jout, TOL, 'output')
    assert np.abs(pout[0, 1:]).max() > 0          # past length 1: not zeroed


@pytest.mark.parametrize('cell', ['SimpleRNNCell', 'LSTMCell', 'GRUCell'])
@pytest.mark.parametrize('time_major,reverse', [(False, False),
                                                (True, True)])
def test_rnn_wrapper_over_a_cell_matches_jax(cell, time_major, reverse):
    jpaddle.seed(0)
    jc = getattr(jpaddle.nn, cell)(IN, H)
    pc = getattr(nn, cell)(IN, H)
    jm = jpaddle.nn.RNN(jc, reverse, time_major)
    pm = load_from_jax(nn.RNN(pc, reverse, time_major), jm)
    assert sorted(pm.state_dict()) == sorted(jm.state_dict())
    x = _x(T, B, IN) if time_major else _x(B, T, IN)
    compare_vjp(jm, pm, lambda m, a: m(a), [x], TOL, GRAD_TOL)


def test_birnn_matches_jax():
    jpaddle.seed(0)
    jm = jpaddle.nn.BiRNN(jpaddle.nn.LSTMCell(IN, H),
                          jpaddle.nn.LSTMCell(IN, H))
    pm = load_from_jax(nn.BiRNN(nn.LSTMCell(IN, H), nn.LSTMCell(IN, H)), jm)
    assert sorted(pm.state_dict()) == sorted(jm.state_dict())
    compare_vjp(jm, pm, lambda m, a: m(a), [_x(B, T, IN)], TOL, GRAD_TOL)
    _, (fw, bw) = pm(torch.from_numpy(_x(B, T, IN)))
    assert len(fw) == len(bw) == 2


@pytest.mark.parametrize('bidirectional', [False, True])
@pytest.mark.parametrize('components', [1, 2])
def test_split_and_concat_states_match_jax(bidirectional, components):
    from paddle_tpu.nn.layer.rnn import concat_states as jconcat
    from paddle_tpu.nn.layer.rnn import split_states as jsplit
    from paddle_tpu_torch.nn.layer.rnn import concat_states, split_states
    n = 4 if bidirectional else 2
    arrays = [_x(n, B, H, seed=s) for s in range(components)]
    jstates = jt(arrays[0]) if components == 1 else tuple(map(jt, arrays))
    pstates = torch.from_numpy(arrays[0]) if components == 1 else tuple(
        torch.from_numpy(a) for a in arrays)
    js = jsplit(jstates, bidirectional, components)
    ps = split_states(pstates, bidirectional, components)
    flat = lambda s: [np32(t) for t in _leaves(s)]   # noqa: E731
    assert len(js) == len(ps)
    for a, b in zip(flat(js), flat(ps)):
        assert np.array_equal(a, b)
    back = concat_states(ps, bidirectional, components)
    jback = jconcat(js, bidirectional, components)
    for a, b in zip(flat(back), flat(jback)):
        assert np.array_equal(a, b)
    for a, b in zip(flat(back), arrays):
        assert np.array_equal(a, b)


def _leaves(s):
    if isinstance(s, (list, tuple)):
        return [x for t in s for x in _leaves(t)]
    return [s]


def test_lstm_weights_load_from_one_set_of_numpy_arrays():
    """``convert.load_numpy_state`` carries RNN weights ``[gates * H,
    in]`` across unchanged, and a ``ParamAttr`` initializer reaches
    every one of them in both packages."""
    attr = lambda: paddle.ParamAttr(   # noqa: E731
        initializer=nn.initializer.Uniform(-0.04, 0.04))
    jattr = lambda: jpaddle.ParamAttr(   # noqa: E731
        initializer=jpaddle.nn.initializer.Uniform(-0.04, 0.04))
    pm = nn.LSTM(IN, H, 2, weight_ih_attr=attr(), weight_hh_attr=attr(),
                 bias_ih_attr=attr(), bias_hh_attr=attr())
    jm = jpaddle.nn.LSTM(IN, H, 2, weight_ih_attr=jattr(),
                         weight_hh_attr=jattr(), bias_ih_attr=jattr(),
                         bias_hh_attr=jattr())
    for v in list(pm.state_dict().values()) + [
            np.asarray(v.value) for v in jm.state_dict().values()]:
        assert np.abs(np32(v)).max() <= 0.04
    state = host_state(jm)
    assert state['weight_ih_l0'].shape == (4 * H, IN)
    load_from_jax(pm, jm)
    for k, v in pm.state_dict().items():
        assert np.array_equal(v.numpy(), state[k])


def test_every_reference_name_exists_in_the_port():
    import paddle_tpu.nn.layer.rnn as ref
    from paddle_tpu_torch.nn.layer import rnn
    assert [n for n in ref.__all__ if not hasattr(rnn, n)] == []
