"""dy2static on the port (``paddle_tpu_torch.jit.dy2static``), held to
the reference's own cases.

The first part is the reference's ``tests/test_dy2static.py``, its 32
cases unchanged but for the package they import: data-dependent Python
``if``/``while``/``for range`` under ``to_static`` must match eager
execution (on the CPU ``to_static`` runs the function itself, its tensor
predicates read on the host), and concrete control flow must keep
Python semantics.  The second part is the port's own: the same control
flow exported by ``jit.save`` becomes ``torch.cond``/``while_loop`` (both
branches in the graph, the loaded artifact equal to eager on either
side), what the export cannot represent raises ``Dy2StaticError``, the
host reads are counted, and the greedy decoder gives the reference's
tokens on the same weights.  Exact equality throughout: the same ops on
the same values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import to_static
from paddle_tpu_torch.jit.dy2static import (convert_control_flow,
                                            convert_ifelse, convert_while_loop)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _t(a):
    return paddle.to_tensor(np.asarray(a, 'float32'))


class TestConvertIfElse:
    def test_python_pred_unchanged(self):
        out = convert_ifelse(True, lambda: 'a', lambda: 'b')
        assert out == 'a'
        out = convert_ifelse(0, lambda: 'a', lambda: 'b')
        assert out == 'b'

    def test_tensor_if_in_to_static(self):
        def fn(x):
            if x.sum() > 0:
                y = x * 2.0
            else:
                y = -x
            return y + 1.0

        st = to_static(fn)
        xp = _t([1.0, 2.0])
        xn = _t([-1.0, -2.0])
        np.testing.assert_allclose(np.asarray(st(xp).numpy()),
                                   np.asarray(fn(xp).numpy()))
        np.testing.assert_allclose(np.asarray(st(xn).numpy()),
                                   np.asarray(fn(xn).numpy()))

    def test_if_with_returns(self):
        def fn(x):
            if x.sum() > 0:
                return x * 2.0
            return x - 1.0

        st = to_static(fn)
        for v in ([3.0], [-3.0]):
            np.testing.assert_allclose(np.asarray(st(_t(v)).numpy()),
                                       np.asarray(fn(_t(v)).numpy()))

    def test_elif_chain(self):
        def fn(x):
            s = x.sum()
            if s > 1.0:
                y = x * 3.0
            elif s > -1.0:
                y = x * 2.0
            else:
                y = x
            return y

        st = to_static(fn)
        for v in ([2.0], [0.0], [-2.0]):
            np.testing.assert_allclose(np.asarray(st(_t(v)).numpy()),
                                       np.asarray(fn(_t(v)).numpy()))

    def test_logical_ops_in_test(self):
        def fn(x):
            if (x.sum() > 0) and (x.max() < 10.0):
                y = x + 1.0
            else:
                y = x - 1.0
            return y

        st = to_static(fn)
        for v in ([1.0], [-1.0], [20.0]):
            np.testing.assert_allclose(np.asarray(st(_t(v)).numpy()),
                                       np.asarray(fn(_t(v)).numpy()))

    def test_static_python_if_still_works(self):
        calls = []

        def fn(x, flag=True):
            if flag:  # plain python predicate: must stay python
                calls.append(1)
                y = x * 2.0
            else:
                y = x
            return y

        st = to_static(fn)
        np.testing.assert_allclose(np.asarray(st(_t([2.0])).numpy()),
                                   [4.0])
        assert calls  # the python branch actually executed


class TestConvertWhile:
    def test_python_while_unchanged(self):
        def fn(n):
            i, total = 0, 0
            while i < n:
                total += i
                i += 1
            return total

        assert convert_control_flow(fn)(5) == 10

    def test_tensor_while_in_to_static(self):
        def fn(x):
            # double until the sum crosses 100 (data-dependent trip count)
            while x.sum() < 100.0:
                x = x * 2.0
            return x

        st = to_static(fn)
        for v in ([1.0, 2.0], [60.0, 50.0]):
            np.testing.assert_allclose(np.asarray(st(_t(v)).numpy()),
                                       np.asarray(fn(_t(v)).numpy()))

    def test_while_with_counter(self):
        def fn(x, n):
            i = paddle.to_tensor(np.asarray(0, 'int32'))
            while i < n:
                x = x + 1.0
                i = i + 1
            return x

        st = to_static(fn)
        n = paddle.to_tensor(np.asarray(4, 'int32'))
        np.testing.assert_allclose(np.asarray(st(_t([0.0]), n).numpy()),
                                   [4.0])

    def test_shim_direct(self):
        # the reference exposes convert_while_loop directly too
        out = convert_while_loop(
            lambda i, s: i < 3, lambda i, s: (i + 1, s + i), (0, 0))
        assert out == (3, 3)


V, H, EOS, MAXLEN = 16, 8, 0, 10


class Decoder(nn.Layer):
    """Greedy decoder that stops early at EOS — data-dependent trip
    count (free variables would block conversion, so the sizes are
    module globals)."""

    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(V, H)
        self.cell = nn.GRUCell(H, H)
        self.head = nn.Linear(H, V)

    def forward(self, start_ids, h0):
        tok = start_ids
        h = h0
        out = paddle.zeros([MAXLEN], 'int64')
        i = paddle.to_tensor(np.asarray(0, 'int64'))
        done = tok.sum() < -1  # all-False bool tensor start
        while (i < MAXLEN) and (~done):
            x = self.emb(tok)
            h, _ = self.cell(x, h)
            nxt = self.head(h).argmax(-1)
            out = paddle.tensor.manipulation.scatter_nd_add(
                out, i.reshape([1, 1]), nxt.reshape([1]))
            done = (nxt == EOS).all()
            tok = nxt
            i = i + 1
        return out, i


class TestControlFlowModel:
    """A reference-style model with data-dependent control flow: greedy
    decoding that stops early at EOS (dygraph_to_static/test_loop.py
    style RNN decode), as one jitted module."""

    def test_greedy_decode_layer(self):
        paddle.seed(3)
        dec = Decoder()
        ids = paddle.to_tensor(np.asarray([3], 'int64'))
        h0 = _t(np.zeros((1, H), 'float32'))

        # eager reference
        ref_out, ref_i = dec(ids, h0)
        st = to_static(dec)
        got_out, got_i = st(ids, h0)
        assert int(np.asarray(got_i.numpy())) == int(np.asarray(
            ref_i.numpy()))
        np.testing.assert_array_equal(np.asarray(got_out.numpy()),
                                      np.asarray(ref_out.numpy()))


class TestConcreteSemanticsPreserved:
    """Conversion must be a no-op for concrete (python) control flow —
    regressions reproduced in round-2 review."""

    def test_early_return_in_for_loop(self):
        def fn(xs, lim):
            for x in xs:
                if x > lim:   # early exit from a loop: unconvertible,
                    return x  # must fall back to plain tracing
            return -1

        conv = convert_control_flow(fn)
        assert conv(iter([1, 2, 50, 3]), 10) == 50
        assert conv(iter([1, 2]), 10) == -1

    def test_tail_reassignment_after_early_return(self):
        def fn(x):
            acc = 1
            if x > 0:
                return x
            acc = acc + 1  # tail folded into else: must see `acc`
            return acc

        conv = convert_control_flow(fn)
        assert conv(5) == 5
        assert conv(-1) == 2

    def test_module_global_stays_live(self):
        def fn(x):
            if x > 0:
                y = x + _GLOBAL_KNOB
            else:
                y = x
            return y

        conv = convert_control_flow(fn)
        assert conv is not fn  # conversion actually happened
        assert conv(1) == 1 + _GLOBAL_KNOB
        old = globals()['_GLOBAL_KNOB']
        try:
            globals()['_GLOBAL_KNOB'] = 100
            assert conv(1) == 101  # not a stale snapshot
        finally:
            globals()['_GLOBAL_KNOB'] = old


_GLOBAL_KNOB = 10


class TestBreakContinue:
    """break/continue in converted while — the r2 VERDICT gap (reference
    convert_operators.py:25 handles them via while-op flags)."""

    def test_concrete_break_still_works(self):
        def fn(x):
            i = 0
            while i < 3:
                if i == 2:
                    break
                i += 1
            return x + i

        st = to_static(fn)
        np.testing.assert_allclose(np.asarray(st(_t([1.0])).numpy()),
                                   [3.0])

    def test_traced_break_compiles_to_while_loop(self):
        def fn(x):
            s = x.sum() * 0.0
            i = x.sum() * 0.0
            while i < 10.0:
                if s > 6.0:
                    break
                s = s + i
                i = i + 1.0
            return s

        st = to_static(fn)
        # eager semantics: s accumulates 0+1+2+3=6, then 6+4=10>6 breaks
        # at next check -> s = 10
        out = float(np.asarray(st(_t([1.0, -1.0])).numpy()).reshape(()))
        s = i = 0.0
        while i < 10.0:
            if s > 6.0:
                break
            s, i = s + i, i + 1.0
        assert out == s

    def test_traced_continue(self):
        def fn(x):
            s = x.sum() * 0.0
            i = x.sum() * 0.0
            while i < 6.0:
                i = i + 1.0
                if i > 3.0:
                    continue
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([2.0])).numpy()).reshape(()))
        assert out == 1.0 + 2.0 + 3.0

    def test_break_and_continue_mixed(self):
        def fn(x):
            s = x.sum() * 0.0
            i = x.sum() * 0.0
            while i < 100.0:
                i = i + 1.0
                if i == 2.0:
                    continue
                if i > 4.0:
                    break
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([3.0])).numpy()).reshape(()))
        assert out == 1.0 + 3.0 + 4.0

    def test_statements_after_guarded_if_run(self):
        """Statements following an if-with-continue are guarded, not
        dropped."""
        def fn(x):
            s = x.sum() * 0.0
            c = x.sum() * 0.0
            i = x.sum() * 0.0
            while i < 5.0:
                i = i + 1.0
                if i == 3.0:
                    continue
                s = s + i
                c = c + 1.0
            return s + c * 100.0

        st = to_static(fn)
        out = float(np.asarray(st(_t([1.0])).numpy()).reshape(()))
        assert out == (1 + 2 + 4 + 5) + 4 * 100.0


class TestFallbacks:

    def test_closure_falls_back(self):
        k = 3.0

        def fn(x):
            if x.sum() > 0:
                y = x * k  # free variable -> no conversion
            else:
                y = x
            return y

        # conversion bails; plain tracing of a tensor `if` raises the
        # standard tracer-bool error
        assert convert_control_flow(fn) is fn


class TestForRangeConversion:
    """Tensor-ranged `for` loops convert through the while machinery
    (reference convert_operators converts for-range the same way)."""

    def test_concrete_range_unchanged_semantics(self):
        def fn(x):
            s = x * 0.0
            for i in range(4):
                s = s + x * i
            return s + i  # loop var visible after, python semantics

        st = to_static(fn)
        np.testing.assert_allclose(
            np.asarray(st(_t([1.0])).numpy()), [1.0 * 6 + 3])

    def test_range_bound_evaluated_once(self):
        # python evaluates range() bounds ONCE; a body mutating a
        # variable used in the bound must not change iteration count
        def fn(x):
            n = 4
            s = x * 0.0
            for i in range(n):
                n -= 1
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([0.0])).numpy()).reshape(()))
        assert out == float(sum(range(4)))  # NOT the re-evaluated 0+1

    def test_tensor_range_compiles(self):
        def fn(x):
            n = x.sum()            # traced bound
            s = x.sum() * 0.0
            for i in range(n):
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([2.0, 3.0])).numpy()).reshape(()))
        assert out == sum(range(5))

    def test_tensor_range_with_break(self):
        def fn(x):
            s = x.sum() * 0.0
            for i in range(x.sum()):
                if i > 2.0:
                    break
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([10.0])).numpy()).reshape(()))
        assert out == 0 + 1 + 2

    def test_tensor_range_with_continue(self):
        def fn(x):
            s = x.sum() * 0.0
            for i in range(x.sum()):
                if i == 1.0:
                    continue
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([4.0])).numpy()).reshape(()))
        assert out == 0 + 2 + 3

    def test_range_start_stop_step(self):
        def fn(x):
            s = x.sum() * 0.0
            for i in range(1, x.sum(), 2):
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([4.0, 4.0])).numpy()).reshape(()))
        assert out == 1 + 3 + 5 + 7

    def test_negative_literal_step(self):
        def fn(x):
            s = x.sum() * 0.0
            for i in range(x.sum(), 0.0, -1):
                s = s + i
            return s

        st = to_static(fn)
        out = float(np.asarray(st(_t([2.0, 2.0])).numpy()).reshape(()))
        assert out == 4 + 3 + 2 + 1

    def test_non_range_for_untouched(self):
        def fn(x):
            s = x * 0.0
            for v in [1.0, 2.0]:   # list iteration: plain python
                s = s + v * x
            return s

        st = to_static(fn)
        np.testing.assert_allclose(
            np.asarray(st(_t([1.0])).numpy()), [3.0])


class TestControlFlowProbes:
    """Regression probes: nested loop break/continue accumulation,
    tensor-if with early returns, tensor-if without else plus tail."""

    def test_nested_break_continue_accumulation(self):
        @paddle.jit.to_static
        def f(x):
            total = paddle.zeros([1])
            for i in range(5):
                if i == 3:
                    break
                for j in range(4):
                    if j == 2:
                        continue
                    total = total + x * (i + j)
            return total
        np.testing.assert_allclose(
            f(paddle.to_tensor([1.0])).numpy(), [21.0], rtol=1e-6)

    def test_tensor_if_early_return_both_branches(self):
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                return x + 1
            else:
                return x - 1
        np.testing.assert_allclose(
            f(paddle.to_tensor([2.0])).numpy(), [3.0], rtol=1e-6)
        np.testing.assert_allclose(
            f(paddle.to_tensor([-2.0])).numpy(), [-3.0], rtol=1e-6)

    def test_tensor_if_no_else_with_tail(self):
        @paddle.jit.to_static
        def f(x):
            y = x * 1.0
            if x.sum() > 10:
                y = y + 100
            return y + 1
        np.testing.assert_allclose(
            f(paddle.to_tensor([2.0])).numpy(), [3.0], rtol=1e-6)
        np.testing.assert_allclose(
            f(paddle.to_tensor([20.0])).numpy(), [121.0], rtol=1e-6)

    def test_static_function_forwards_name(self):
        @paddle.jit.to_static
        def my_fn(x):
            return x
        assert my_fn.__name__ == 'my_fn'


# -- the port's own: export, host reads, the reference's decoder --------------
from paddle_tpu_torch import jit  # noqa: E402
from paddle_tpu_torch.jit import dy2static  # noqa: E402
from paddle_tpu_torch.static import InputSpec  # noqa: E402


class IfNet(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)

    def forward(self, x):
        y = self.fc(x)
        if y.sum() > 0:
            z = y * 2.0
        else:
            z = -y
        return z + 1.0


class WhileNet(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)

    def forward(self, x):
        x = self.fc(x)
        while x.abs().sum() < 100.0:
            x = x * 2.0
        return x


class MismatchNet(nn.Layer):
    def forward(self, x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x.sum()
        return y


def _graph_targets(path):
    with open(path + '.pdmodel', 'rb') as f:
        ep = torch.export.load(f)
    return [str(n.target) for n in ep.graph.nodes if n.op == 'call_function']


@pytest.mark.parametrize('cls,hop', [(IfNet, 'cond'),
                                     (WhileNet, 'while_loop')])
def test_exported_tensor_control_flow_keeps_both_paths(cls, hop, tmp_path):
    paddle.seed(0)
    net = cls()
    net.eval()
    path = str(tmp_path / 'm')
    jit.save(net, path, input_spec=[InputSpec([None, 4], 'float32', 'x')])
    assert hop in _graph_targets(path)
    loaded = jit.load(path, device='cpu')
    reads = dy2static.host_reads()
    for scale, b in ((1.0, 3), (-1.0, 1), (0.01, 5)):
        x = torch.full((b, 4), scale)
        got = loaded(x)
        assert dy2static.host_reads() == reads      # on the device
        with torch.no_grad():
            want = net(x)
        assert torch.equal(got, want)


def test_export_refuses_branches_of_other_shapes(tmp_path):
    with pytest.raises(dy2static.Dy2StaticError, match='if/else'):
        jit.save(MismatchNet(), str(tmp_path / 'm'),
                 input_spec=[InputSpec([2, 4], 'float32', 'x')])


def test_exported_decoder_is_a_while_loop_equal_to_eager(tmp_path):
    paddle.seed(3)
    dec = Decoder()
    dec.eval()
    path = str(tmp_path / 'dec')
    jit.save(dec, path, input_spec=[InputSpec([1], 'int64', 'ids'),
                                    InputSpec([1, H], 'float32', 'h0')])
    assert 'while_loop' in _graph_targets(path)
    ids, h0 = torch.tensor([3]), torch.zeros(1, H)
    got = jit.load(path, device='cpu')(ids, h0)
    with torch.no_grad():
        want = dec(ids, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_eager_tensor_predicates_are_read_on_the_host_and_counted():
    def fn(x, flag=True):
        if flag:
            x = x + 1.0
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x
        return y

    st = to_static(fn)
    reads = dy2static.host_reads()
    st(_t([1.0]))
    assert dy2static.host_reads() == reads + 1      # the tensor `if` only
    assert list(st.modes().values()) == ['cpu']


def test_greedy_decoder_gives_the_references_tokens():
    """The reference's Decoder (its own test's class) and the port's on
    the same weights: the same tokens and trip count under to_static."""
    import jax.numpy as jnp
    import paddle_tpu as jpaddle
    from paddle_tpu_torch.convert import load_numpy_state
    from test_dy2static import Decoder as JaxDecoder
    jpaddle.seed(3)
    jdec = JaxDecoder()
    params, _ = jdec.functional_state()
    rs = np.random.RandomState(9)
    host = {k: (np.asarray(v) + rs.randn(*np.shape(v)).astype(np.float32))
            for k, v in params.items()}
    jdec.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    dec = Decoder()
    load_numpy_state(dec, host)
    for start in (3, 7):
        jout, ji = jpaddle.jit.to_static(jdec)(
            jpaddle.to_tensor(np.asarray([start], 'int64')),
            jpaddle.to_tensor(np.zeros((1, H), 'float32')))
        out, i = to_static(dec)(torch.tensor([start]), torch.zeros(1, H))
        assert int(i) == int(np.asarray(ji.numpy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout.numpy()))
