"""The reference's autograd cases (``tests/test_autograd.py``:
``TestBackward``, ``TestGradAPI``, ``TestRetainedGraphSeeds``,
``TestPyLayer`` and ``TestRegisterHook``) run on both packages.

Each case is written once against a package adapter: ``mk`` makes a
tensor that takes a gradient (``stop_gradient=False`` in the reference,
``requires_grad`` in the port) and ``num`` reads one back.  Where the
port's semantics differ by design they are pinned: PyTorch records
``.grad`` on leaves only (the reference's tape on every tensor), and
the port has no ``stop_gradient`` attribute.  Values are exact or
within 1e-5 relative (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import autograd as jax_autograd
from paddle_tpu_torch import autograd as port_autograd


class _Ref:
    name = 'reference'
    P = paddle_tpu
    AG = jax_autograd

    @staticmethod
    def mk(val, stop_gradient=False):
        t = paddle_tpu.to_tensor(np.asarray(val, np.float32))
        t.stop_gradient = stop_gradient
        return t

    @staticmethod
    def num(t):
        return np.asarray(t.numpy())

    @staticmethod
    def taped(t):
        return t.grad_node is not None

    @staticmethod
    def clear(t):
        t.clear_grad()


class _Port:
    name = 'port'
    P = paddle_tpu_torch
    AG = port_autograd

    @staticmethod
    def mk(val, stop_gradient=False):
        return torch.tensor(np.asarray(val, np.float32),
                            requires_grad=not stop_gradient)

    @staticmethod
    def num(t):
        return t.detach().numpy()

    @staticmethod
    def taped(t):
        return t.grad_fn is not None

    @staticmethod
    def clear(t):
        t.grad = None


@pytest.fixture(params=[_Ref, _Port], ids=['reference', 'port'])
def pkg(request):
    if request.param is _Port:
        paddle_tpu_torch.set_device('cpu')
        yield request.param
        paddle_tpu_torch.set_device(None)
    else:
        yield request.param


def _eq(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=1e-6)


# -- TestBackward ------------------------------------------------------------

def test_simple_chain(pkg):
    x = pkg.mk([2.0, 3.0])
    (x * x).sum().backward()
    _eq(pkg.num(x.grad), [4.0, 6.0])


def test_matches_jax_grad(pkg):
    a = np.random.RandomState(0).randn(4, 3).astype('float32')
    w = np.random.RandomState(1).randn(3, 2).astype('float32')
    ga, gw = jax.grad(lambda aa, ww: jnp.sum(jnp.tanh(aa @ ww)),
                      argnums=(0, 1))(a, w)
    ta, tw = pkg.mk(a), pkg.mk(w)
    P = pkg.P
    P.sum(P.tanh(P.matmul(ta, tw))).backward()
    _eq(pkg.num(ta.grad), ga)
    _eq(pkg.num(tw.grad), gw)


def test_grad_accumulation(pkg):
    x = pkg.mk([1.0, 2.0])
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    _eq(pkg.num(x.grad), [5.0, 5.0])
    pkg.clear(x)
    assert x.grad is None


def test_stop_gradient(pkg):
    x = pkg.mk([1.0, 2.0])
    y = pkg.mk([3.0, 4.0], stop_gradient=True)
    (x * y).sum().backward()
    _eq(pkg.num(x.grad), [3.0, 4.0])
    assert y.grad is None


def test_detach(pkg):
    x = pkg.mk([2.0])
    d = x.detach()
    (x * d).sum().backward()
    _eq(pkg.num(x.grad), [2.0])


def test_diamond_fanout(pkg):
    x = pkg.mk([3.0])
    (x * x + x * 2.0).sum().backward()
    _eq(pkg.num(x.grad), [8.0])


def test_multi_output_op(pkg):
    x = pkg.mk([[3.0, 1.0, 2.0]])
    vals, idx = pkg.P.topk(x, 2)
    vals.sum().backward()
    _eq(pkg.num(x.grad), [[1.0, 0.0, 1.0]])


def test_no_grad_context(pkg):
    x = pkg.mk([1.0])
    with pkg.P.no_grad():
        y = x * 5
    assert not pkg.taped(y)


def test_no_grad_as_a_decorator(pkg):
    x = pkg.mk([1.0])

    @pkg.P.no_grad()
    def f(v):
        return v * 5
    assert not pkg.taped(f(x))
    assert pkg.taped(x * 5)


def test_deep_chain(pkg):
    x = pkg.mk(np.ones(4, np.float32))
    y = x
    for _ in range(60):
        y = y * 1.01
    y.sum().backward()
    _eq(pkg.num(x.grad), np.full(4, 1.01 ** 60, np.float32), rtol=1e-4)


def test_non_scalar_backward_with_grad(pkg):
    x = pkg.mk([1.0, 2.0])
    (x * 3.0).backward(pkg.mk([1.0, 10.0], stop_gradient=True))
    _eq(pkg.num(x.grad), [3.0, 30.0])


def test_getitem_grad(pkg):
    x = pkg.mk([[1.0, 2.0], [3.0, 4.0]])
    x[0].sum().backward()
    _eq(pkg.num(x.grad), [[1, 1], [0, 0]])


def test_broadcast_grad(pkg):
    x = pkg.mk(np.ones((3, 1), np.float32))
    y = pkg.mk(np.ones((1, 4), np.float32))
    (x + y).sum().backward()
    _eq(pkg.num(x.grad), np.full((3, 1), 4.0))
    _eq(pkg.num(y.grad), np.full((1, 4), 3.0))


def test_intermediate_grads_recorded(pkg):
    """The reference records ``.grad`` on every tensor; PyTorch on leaves
    (``retain_grad`` asks for more)."""
    x = pkg.mk([2.0])
    h = x * 3.0
    (h * h).sum().backward()
    _eq(pkg.num(x.grad), [36.0])
    if pkg is _Ref:
        _eq(pkg.num(h.grad), [12.0])
    else:
        assert h.grad is None


# -- TestGradAPI -------------------------------------------------------------

def test_grad_single_output(pkg):
    x = pkg.mk(2.0)
    dx, = pkg.P.grad([x * x], [x])
    _eq(pkg.num(dx), 4.0)
    assert x.grad is None


def test_grad_multi_output_sum(pkg):
    x = pkg.mk(2.0)
    dx, = pkg.P.grad([x * x, x * 3.0], [x])
    _eq(pkg.num(dx), 7.0)


def test_grad_outputs_seed(pkg):
    x = pkg.mk(2.0)
    dx, = pkg.P.grad([x * x], [x],
                     grad_outputs=[pkg.mk(5.0, stop_gradient=True)])
    _eq(pkg.num(dx), 20.0)


def test_grad_intermediate_input(pkg):
    x = pkg.mk(3.0)
    b = x * 2.0
    c = b * b
    db, = pkg.P.grad([c], [b], retain_graph=True)
    _eq(pkg.num(db), 12.0)
    dx, = pkg.P.grad([c], [x])
    _eq(pkg.num(dx), 24.0)


def test_grad_allow_unused(pkg):
    x, z = pkg.mk(2.0), pkg.mk(1.0)
    y = x * x
    with pytest.raises(RuntimeError):
        pkg.P.grad([y], [z], retain_graph=True)
    assert pkg.P.grad([y], [z], allow_unused=True)[0] is None


def test_grad_of_a_stop_gradient_input(pkg):
    x, s = pkg.mk(2.0), pkg.mk(1.0, stop_gradient=True)
    y = x * s
    with pytest.raises(RuntimeError):
        pkg.P.grad([y], [s], retain_graph=True)
    assert pkg.P.grad([y], [x, s], allow_unused=True)[1] is None


def test_grad_no_grad_vars_cuts_flow(pkg):
    a = pkg.mk(3.0)
    b = a * 2.0
    gc, = pkg.P.grad([b * a], [a], no_grad_vars=[b])
    _eq(pkg.num(gc), 6.0)


def test_grad_only_inputs_false_raises(pkg):
    x = pkg.mk(2.0)
    with pytest.raises(NotImplementedError):
        pkg.P.grad([x * x], [x], only_inputs=False)


def test_grad_freed_graph_raises(pkg):
    x = pkg.mk(2.0)
    y = x * x
    pkg.P.grad([y], [x])
    with pytest.raises(RuntimeError, match='retain_graph'):
        pkg.P.grad([y], [x])


def test_create_graph_second_order(pkg):
    x = pkg.mk([2.0, 3.0])
    g1 = pkg.P.grad((x ** 3).sum(), x, create_graph=True)[0]
    _eq(pkg.num(g1), [12.0, 27.0])
    g2 = pkg.P.grad(g1.sum(), x)[0]
    _eq(pkg.num(g2), [12.0, 18.0])


def test_create_graph_third_order(pkg):
    x = pkg.mk([2.0])
    g1 = pkg.P.grad((x ** 4).sum(), x, create_graph=True)[0]
    g2 = pkg.P.grad(g1.sum(), x, create_graph=True)[0]
    g3 = pkg.P.grad(g2.sum(), x)[0]
    _eq(pkg.num(g3), [48.0])


def test_set_grad_enabled(pkg):
    x = pkg.mk(2.0)
    with pkg.P.set_grad_enabled(False):
        t = x * x
        assert not pkg.P.is_grad_enabled() if pkg is _Port else True
    assert not pkg.taped(t)
    with pkg.P.set_grad_enabled(True):
        t = x * x
    assert pkg.taped(t)


def test_enable_grad_inside_no_grad(pkg):
    x = pkg.mk(2.0)
    with pkg.P.no_grad():
        with pkg.P.enable_grad():
            t = x * x
    assert pkg.taped(t)


# -- TestRetainedGraphSeeds --------------------------------------------------

def test_grad_after_backward_no_double_count(pkg):
    x = pkg.mk(2.0)
    y = x * x
    y.backward(retain_graph=True)
    _eq(pkg.num(x.grad), 4.0)
    dx, = pkg.P.grad([y], [x], retain_graph=True)
    _eq(pkg.num(dx), 4.0)


def test_repeated_backward_accumulates_linearly(pkg):
    x = pkg.mk(3.0)
    y = x * x
    y.backward(retain_graph=True)
    y.backward(retain_graph=True)
    _eq(pkg.num(x.grad), 12.0)


def test_autograd_backward_multi_root(pkg):
    x = pkg.mk(2.0)
    pkg.AG.backward([x * x, x * 3.0])
    _eq(pkg.num(x.grad), 7.0)


def test_autograd_backward_seeds(pkg):
    x = pkg.mk([1.0, 2.0])
    pkg.AG.backward([x * 2.0], [pkg.mk([1.0, 5.0], stop_gradient=True)])
    _eq(pkg.num(x.grad), [2.0, 10.0])
    with pytest.raises(ValueError):
        pkg.AG.backward([x * 2.0, x * 3.0], [None])


# -- TestPyLayer -------------------------------------------------------------

def _tanh_layer(pkg):
    P = pkg.P

    class cus_tanh(pkg.AG.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = P.tanh(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            y, = ctx.saved_tensor()
            return dy * (1 - y * y)
    return cus_tanh


def test_pylayer_forward_and_custom_backward(pkg):
    x = pkg.mk([0.5, -1.0])
    z = _tanh_layer(pkg).apply(x)
    _eq(pkg.num(z), np.tanh([0.5, -1.0]))
    z.sum().backward()
    _eq(pkg.num(x.grad), 1 - np.tanh([0.5, -1.0]) ** 2)


def test_pylayer_composes_with_taped_ops(pkg):
    x = pkg.mk([0.3, 0.7])
    _tanh_layer(pkg).apply(x * 2.0).sum().backward()
    _eq(pkg.num(x.grad), 2 * (1 - np.tanh([0.6, 1.4]) ** 2))


def test_pylayer_gradient_is_a_leaf_under_create_graph(pkg):
    """The reference's double-grad rule: d/dx of sum(g1 * x) with the
    PyLayer's g1 a constant is g1 itself (PyTorch's own Function would
    add g1's dependence on x)."""
    class Sq(pkg.AG.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor()
            return dy * 2.0 * x

    x = pkg.mk([0.5, -1.5])
    g1 = pkg.P.grad(Sq.apply(x).sum(), x, create_graph=True)[0]
    _eq(pkg.num(g1), 2 * np.array([0.5, -1.5]))
    g2 = pkg.P.grad((g1 * x).sum(), x, allow_unused=True)[0]
    _eq(pkg.num(g2), pkg.num(g1))


def test_pylayer_multi_output_under_create_graph(pkg):
    class two(pkg.AG.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x, 3.0 * x

        @staticmethod
        def backward(ctx, da, db):
            x, = ctx.saved_tensor()
            return da * 2.0 * x + db * 3.0

    x = pkg.mk([2.0, -1.0])
    a, b = two.apply(x)
    g = pkg.P.grad((a + b).sum(), x, create_graph=True)[0]
    _eq(pkg.num(g), 2 * np.array([2.0, -1.0]) + 3.0)


def test_pylayer_mixed_tape_under_create_graph(pkg):
    x = pkg.mk([0.3, 0.7])
    y = _tanh_layer(pkg).apply(x * 2.0).sum()
    g1 = pkg.P.grad(y, x, create_graph=True)[0]
    _eq(pkg.num(g1), 2 * (1 - np.tanh([0.6, 1.4]) ** 2))


def test_pylayer_multi_input_output(pkg):
    class mul_add(pkg.AG.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b, a + b

        @staticmethod
        def backward(ctx, dp, ds):
            a, b = ctx.saved_tensor()
            return dp * b + ds, dp * a + ds

    a, b = pkg.mk(3.0), pkg.mk(4.0)
    p, s = mul_add.apply(a, b)
    (p + s).backward()
    _eq(pkg.num(a.grad), 5.0)
    _eq(pkg.num(b.grad), 4.0)


def test_pylayer_wrong_grad_count_raises(pkg):
    class bad(pkg.AG.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a * b

        @staticmethod
        def backward(ctx, dy):
            return dy

    out = bad.apply(pkg.mk(1.0), pkg.mk(2.0))
    with pytest.raises(ValueError, match='grads'):
        out.backward()


def test_pylayer_keyword_tensor_raises(pkg):
    with pytest.raises(TypeError):
        _tanh_layer(pkg).apply(x=pkg.mk([1.0]))


def test_pylayer_no_grad_passthrough_keeps_input_differentiable(pkg):
    class ident(pkg.AG.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x

        @staticmethod
        def backward(ctx, dy):
            return dy

    x = pkg.mk(2.0)
    with pkg.P.no_grad():
        out = ident.apply(x)
    assert not pkg.taped(out)
    (x * x).backward()
    _eq(pkg.num(x.grad), 4.0)


# -- TestRegisterHook --------------------------------------------------------

def test_hook_fan_out_fires_once_and_modifies(pkg):
    t = pkg.mk(np.ones(2, np.float32))
    calls = []
    t.register_hook(lambda g: calls.append(1) or g * 2)
    ((t * 3.0) + (t * 4.0)).sum().backward()
    assert len(calls) == 1
    _eq(pkg.num(t.grad), [14.0, 14.0])


def test_hook_observe_only_and_remove(pkg):
    t = pkg.mk(np.ones(2, np.float32))
    seen = []
    h = t.register_hook(lambda g: seen.append(pkg.num(g).copy()))
    (t * 5.0).sum().backward()
    _eq(pkg.num(t.grad), [5.0, 5.0])
    assert len(seen) == 1
    pkg.clear(t)
    h.remove()
    (t * 5.0).sum().backward()
    assert len(seen) == 1


def test_intermediate_hook_propagates_downstream(pkg):
    x = pkg.mk([2.0])
    m = x * 3.0
    m.register_hook(lambda g: g * 10)
    (m * 1.0).sum().backward()
    _eq(pkg.num(x.grad), [30.0])


def test_hook_in_grad_api(pkg):
    z = pkg.mk([1.0])
    zz = z * 2.0
    zz.register_hook(lambda g: g * 100)
    gz, = pkg.P.grad((zz * 1.0).sum(), z)
    _eq(pkg.num(gz), [200.0])


def test_hook_on_a_stop_gradient_tensor_raises(pkg):
    with pytest.raises(RuntimeError):
        pkg.mk([1.0], stop_gradient=True).register_hook(lambda g: g)
