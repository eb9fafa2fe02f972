"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``): the
cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the stacks
``SimpleRNN``, ``LSTM`` and ``GRU`` over ``_RNNBase``, the wrappers
``RNN`` and ``BiRNN``, and ``split_states`` / ``concat_states``.

The cell maths are the reference's: LSTM gates in the order i, f, g, o;
GRU's reset gate applied to ``h @ W_hh^T + b_hh``; every weight and bias
drawn from ``Uniform(+-1/sqrt(hidden_size))`` unless a ``ParamAttr``
says otherwise.  Weights are ``[gates * hidden, in]`` (not ``Linear``'s
``[in, out]``) under the reference's names (``weight_ih_l0``,
``bias_hh_l1_reverse``, ...), so a state dict moves between the two
packages unchanged.

The reference runs a stack's time loop as one ``lax.scan``; the port
runs it as a Python loop over time whose input projection is one matmul
for the whole sequence.  It reads nothing back to the host, so a
captured training step (``ParallelTrainer.step_fused``) holds it.
Dropout falls between layers only, the initial states are f32 zeros
``[layers * directions, B, H]``, and ``sequence_length`` is taken and
never read, as in the reference (padded steps run like the others).
The stack runs under the AMP op name ``rnn`` and each cell under its
own (``simple_rnn_cell``, ``lstm_cell``, ``gru_cell``): gray ops, low
precision under O2.
"""
import math

import torch

from ...amp import amp_cast
from .. import functional as F
from ..initializer import Uniform
from .layers import Layer

__all__ = ['SimpleRNNCell', 'LSTMCell', 'GRUCell', 'RNN', 'BiRNN',
           'SimpleRNN', 'LSTM', 'GRU', 'RNNCellBase', 'split_states',
           'concat_states', 'RNNBase']


def _simple_gates(x, h, w_ih, w_hh, b_ih, b_hh):
    return x @ w_ih.T + b_ih + h @ w_hh.T + b_hh


def _lstm_update(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    return o * torch.tanh(c2), c2


def _gru_update(gi, h, w_hh, b_hh):
    gh = h @ w_hh.T + b_hh
    ir, iz, ig = gi.chunk(3, dim=-1)
    hr, hz, hg = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    g = torch.tanh(ig + r * hg)
    return (1 - z) * g + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0):
        """f32 ``[batch, hidden_size]`` filled with ``init_value``."""
        return torch.full((batch_ref.shape[0], self.hidden_size),
                          init_value, dtype=torch.float32,
                          device=batch_ref.device)

    def _cell_params(self, input_size, hidden_size, gates, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr):
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], attr=bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], attr=bias_hh_attr, is_bias=True,
            default_initializer=init)

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation='tanh',
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._cell_params(input_size, hidden_size, 1, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, *w = amp_cast('simple_rnn_cell', inputs, states,
                            *self._weights())
        act = torch.tanh if self.activation == 'tanh' else torch.relu
        out = act(_simple_gates(x, h, *w))
        return out, out

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._cell_params(input_size, hidden_size, 4, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self.get_initial_states(inputs)
        else:
            h, c = states
        x, h, c, *w = amp_cast('lstm_cell', inputs, h, c, *self._weights())
        h2, c2 = _lstm_update(_simple_gates(x, h, *w), c)
        return h2, (h2, c2)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._cell_params(input_size, hidden_size, 3, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, w_ih, w_hh, b_ih, b_hh = amp_cast(
            'gru_cell', inputs, states, *self._weights())
        h2 = _gru_update(x @ w_ih.T + b_ih, h, w_hh, b_hh)
        return h2, h2

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _run_layer(kind, x, h, c, w_ih, w_hh, b_ih, b_hh, reverse):
    """One direction of one layer over time-major ``x [T, B, F]``:
    ``(ys [T, B, H], h_T, c_T)``."""
    if reverse:
        x = x.flip(0)
    xw = x @ w_ih.T + b_ih          # every step's input projection at once
    ys = []
    for t in range(x.shape[0]):
        if kind == 'LSTM':
            h, c = _lstm_update(xw[t] + h @ w_hh.T + b_hh, c)
        elif kind == 'GRU':
            h = _gru_update(xw[t], h, w_hh, b_hh)
        else:
            act = torch.tanh if kind == 'RNN_TANH' else torch.relu
            h = act(xw[t] + h @ w_hh.T + b_hh)
        ys.append(h)
    ys = torch.stack(ys, 0)
    if reverse:
        ys = ys.flip(0)
    return ys, h, c if kind == 'LSTM' else h


class _RNNBase(Layer):
    """Multi-layer (optionally bidirectional) recurrent stack."""

    CELL_KIND = 'RNN_TANH'
    GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 activation='tanh', weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ('bidirect', 'bidirectional')
        self.num_directions = 2 if self.bidirectional else 1
        self.kind = 'RNN_RELU' if activation == 'relu' and \
            self.CELL_KIND == 'RNN_TANH' else self.CELL_KIND
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        g = self.GATES
        self._names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                suffix = '_reverse' if d else ''
                names = [f'weight_ih_l{layer}{suffix}',
                         f'weight_hh_l{layer}{suffix}',
                         f'bias_ih_l{layer}{suffix}',
                         f'bias_hh_l{layer}{suffix}']
                shapes = [[g * hidden_size, in_sz],
                          [g * hidden_size, hidden_size],
                          [g * hidden_size], [g * hidden_size]]
                attrs = [weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr]
                for name_, shape, attr in zip(names, shapes, attrs):
                    self.add_parameter(name_, self.create_parameter(
                        shape, attr=attr, is_bias=len(shape) == 1,
                        default_initializer=init))
                self._names.append(names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, final_states)``: outputs ``[B, T, D * H]`` (``[T,
        B, D * H]`` when ``time_major``), final states ``[L * D, B, H]``
        (a pair ``(h, c)`` for LSTM).  ``sequence_length`` is not read,
        as in the reference."""
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        is_lstm = self.kind == 'LSTM'
        batch = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            h0 = torch.zeros(L * D, batch, H, dtype=torch.float32,
                             device=inputs.device)
            c0 = torch.zeros_like(h0)
        elif is_lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, initial_states
        weights = [getattr(self, n) for names in self._names for n in names]
        x, h0, c0, *weights = amp_cast('rnn', inputs, h0, c0, *weights)
        out = x if self.time_major else x.transpose(0, 1)
        h_finals, c_finals = [], []
        for layer in range(L):
            outs = []
            for d in range(D):
                idx = layer * D + d
                ys, hT, cT = _run_layer(self.kind, out, h0[idx], c0[idx],
                                        *weights[4 * idx:4 * idx + 4],
                                        reverse=bool(d))
                outs.append(ys)
                h_finals.append(hT)
                c_finals.append(cT)
            out = torch.cat(outs, dim=-1) if D == 2 else outs[0]
            if self.dropout > 0 and self.training and layer < L - 1:
                out = F.dropout(out, self.dropout, training=True)
        if not self.time_major:
            out = out.transpose(0, 1)
        h_n = torch.stack(h_finals, 0)
        if is_lstm:
            return out, (h_n, torch.stack(c_finals, 0))
        return out, h_n


class SimpleRNN(_RNNBase):
    CELL_KIND = 'RNN_TANH'
    GATES = 1


class LSTM(_RNNBase):
    CELL_KIND = 'LSTM'
    GATES = 4


class GRU(_RNNBase):
    CELL_KIND = 'GRU'
    GATES = 3


RNNBase = _RNNBase


class RNN(Layer):
    """A cell run over time, one step a slice (reversed with
    ``is_reverse``); ``(outputs, final_states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        seq = inputs.unbind(axis)
        if self.is_reverse:
            seq = seq[::-1]
        states = initial_states
        outs = []
        for xt in seq:
            out, states = self.cell(xt, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, axis), states


class BiRNN(Layer):
    """A forward and a backward ``RNN``, outputs joined on the last
    axis; ``(outputs, (fw_states, bw_states))``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = initial_states if initial_states is not None \
            else (None, None)
        y_fw, s_fw = self.rnn_fw(inputs, st_fw)
        y_bw, s_bw = self.rnn_bw(inputs, st_bw)
        return torch.cat([y_fw, y_bw], dim=-1), (s_fw, s_bw)


def split_states(states, bidirectional=False, state_components=1):
    """``[L * D, B, H]`` stacked states (a tuple of them for
    ``state_components > 1``) -> a list per layer (of ``(fw, bw)``
    pairs when ``bidirectional``)."""
    if state_components == 1:
        st = list(states.unbind(0))
        if not bidirectional:
            return st
        return [(st[2 * i], st[2 * i + 1]) for i in range(len(st) // 2)]
    rows = list(zip(*[list(s.unbind(0)) for s in states]))
    if not bidirectional:
        return [tuple(r) for r in rows]
    return [(tuple(rows[2 * i]), tuple(rows[2 * i + 1]))
            for i in range(len(rows) // 2)]


def concat_states(states, bidirectional=False, state_components=1):
    """The inverse of ``split_states``."""
    flat = []

    def walk(s):
        if isinstance(s, (list, tuple)):
            for t in s:
                walk(t)
        else:
            flat.append(s)

    walk(states)
    if state_components == 1:
        return torch.stack(flat, 0)
    return tuple(torch.stack(flat[k::state_components], 0)
                 for k in range(state_components))
