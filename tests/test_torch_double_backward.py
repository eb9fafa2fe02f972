"""Second-order gradients through the port's hand-written kernels'
``autograd.Function``s, against the JAX package on the CPU.

Each case takes the gradient of ``penalty = sum(grad(sum(f(x)^3), x)^2)``
with respect to every input: the port through ``paddle_tpu_torch.grad(
create_graph=True)`` and ``backward``, the reference through
``jax.jit(jax.grad(...jax.grad...))`` of its own functional op on the
same numpy inputs.  The kernels' gradients carry no graph on the card
(they are ``ctypes`` launches), so the flash and GEMM+GELU cases run
with the backward's kernel entries wrapped to return graph-less
tensors, as the kernels do; a second order must then come from the
plain composition (``core.autograd.kernel_backward``), while the first
order still comes from the kernel entries.

Tolerance: the largest gap within 1e-4 of the largest |value| of each
reference gradient (f32; third powers make the values large: up to 1e6
for the fused CE).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as paddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.jit import functional_call
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.flash_attention import flash_attention as jax_flash
from paddle_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.ops.fused_gelu_linear import \
    fused_linear_gelu as jax_linear_gelu
from paddle_tpu.ops.fused_norm import fused_layer_norm as jax_layer_norm
from paddle_tpu.ops.fused_softmax import fused_softmax as jax_softmax
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.ops.fused_norm import fused_layer_norm

pfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
pfg = importlib.import_module('paddle_tpu_torch.ops.fused_gelu_linear')
pfs = importlib.import_module('paddle_tpu_torch.ops.fused_softmax')

TOL = 1e-4


def _close(got, want, what):
    want = np.asarray(want)
    gap = float(np.abs(np.asarray(got) - want).max())
    scale = float(np.abs(want).max())
    assert gap <= TOL * scale, f'{what}: gap {gap} of {scale}'
    assert scale > 0, f'{what}: the reference gradient is zero'


def _port_penalty_grads(fn, arrays):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    g = paddle.grad((fn(*xs) ** 3).sum(), xs, create_graph=True)
    penalty = sum((gi ** 2).sum() for gi in g)
    penalty.backward()
    return [x.grad.numpy() for x in xs]


def _jax_penalty_grads(fn, arrays):
    argn = tuple(range(len(arrays)))

    def penalty(*xs):
        g = jax.grad(lambda *a: jnp.sum(fn(*a) ** 3), argnums=argn)(*xs)
        return sum(jnp.sum(gi ** 2) for gi in g)
    return jax.jit(jax.grad(penalty, argnums=argn))(
        *[jnp.asarray(a) for a in arrays])


def _tensor_op(op):
    """A reference Tensor-level op as a function of jnp values."""
    def fn(*vs):
        with jax_no_grad():
            return op(*[JaxTensor._from_value(v) for v in vs]).value
    return fn


def _graphless(fn):
    """``fn``'s result detached, as a kernel launched through ctypes
    returns it."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            return tuple(o.detach() for o in out)
        return out.detach()
    return wrapped


RS = np.random.RandomState(0)
X4 = RS.randn(4, 16).astype(np.float32)
G16 = RS.randn(16).astype(np.float32)
B16 = RS.randn(16).astype(np.float32)
CE_X = RS.randn(6, 16).astype(np.float32)
CE_W = (0.3 * RS.randn(16, 32)).astype(np.float32)
CE_LAB = RS.randint(0, 32, 6)
LOGITS = RS.randn(6, 10).astype(np.float32)
LOGIT_LAB = RS.randint(0, 10, 6)
QKV = [RS.randn(2, 8, 16).astype(np.float32) for _ in range(3)]
GELU = [RS.randn(5, 16).astype(np.float32),
        (0.3 * RS.randn(16, 8)).astype(np.float32),
        RS.randn(8).astype(np.float32)]
SCORES = RS.randn(4, 10).astype(np.float32)
IMG = RS.randn(2, 3, 6, 6).astype(np.float32)
KER = (0.3 * RS.randn(4, 3, 3, 3)).astype(np.float32)


def test_layer_norm_second_order_matches_jax():
    got = _port_penalty_grads(lambda x, g, b: fused_layer_norm(x, g, b),
                              [X4, G16, B16])
    want = _jax_penalty_grads(lambda x, g, b: jax_layer_norm(x, g, b),
                              [X4, G16, B16])
    for name, a, b in zip(('x', 'gamma', 'beta'), got, want):
        _close(a, b, f'layer_norm d{name}')


def test_layer_norm_twice_with_shared_weights_second_order_matches_jax():
    """The second LayerNorm's input descends from the gamma and beta it
    shares with the first: the repair must not take that path twice."""
    got = _port_penalty_grads(
        lambda x, g, b: fused_layer_norm(fused_layer_norm(x, g, b), g, b),
        [X4, G16, B16])
    want = _jax_penalty_grads(
        lambda x, g, b: jax_layer_norm(jax_layer_norm(x, g, b), g, b),
        [X4, G16, B16])
    for name, a, b in zip(('x', 'gamma', 'beta'), got, want):
        _close(a, b, f'layer_norm twice d{name}')


def test_fused_ce_second_order_matches_jax():
    lab = torch.tensor(CE_LAB)
    got = _port_penalty_grads(
        lambda x, w: fused_linear_cross_entropy(x, w, lab, 4), [CE_X, CE_W])
    want = _jax_penalty_grads(
        lambda x, w: jax_fused_ce(x, w, jnp.asarray(CE_LAB), 4),
        [CE_X, CE_W])
    for name, a, b in zip(('x', 'w'), got, want):
        _close(a, b, f'fused_ce d{name}')


@pytest.mark.parametrize('use_softmax', [True, False])
def test_cross_entropy_second_order_matches_jax(use_softmax):
    lab = LOGIT_LAB[:, None].astype(np.int64)
    x = LOGITS if use_softmax else np.abs(LOGITS) + 0.1
    got = _port_penalty_grads(
        lambda v: F.cross_entropy(v, torch.tensor(lab), reduction='none',
                                  use_softmax=use_softmax), [x])
    jlab = JaxTensor._from_value(jnp.asarray(lab.astype(np.int32)))
    want = _jax_penalty_grads(_tensor_op(
        lambda v: JF.cross_entropy(v, jlab, reduction='none',
                                   use_softmax=use_softmax)), [x])
    _close(got[0], want[0], 'cross_entropy dx')


def test_flash_second_order_matches_jax_with_graphless_kernels(
        monkeypatch):
    monkeypatch.setattr(pfa, '_bwd', _graphless(pfa._bwd))
    got = _port_penalty_grads(
        lambda q, k, v: pfa.flash_attention(q, k, v, True), QKV)
    want = _jax_penalty_grads(lambda q, k, v: jax_flash(q, k, v, True), QKV)
    for name, a, b in zip('qkv', got, want):
        _close(a, b, f'flash d{name}')


def test_linear_gelu_second_order_matches_jax_with_graphless_kernel(
        monkeypatch):
    monkeypatch.setattr(pfg, '_dz', _graphless(pfg._dz))
    got = _port_penalty_grads(lambda x, w, b: pfg.fused_linear_gelu(x, w, b),
                              GELU)
    want = _jax_penalty_grads(lambda x, w, b: jax_linear_gelu(x, w, b), GELU)
    for name, a, b in zip(('x', 'w', 'b'), got, want):
        _close(a, b, f'linear_gelu d{name}')


def test_softmax_second_order_matches_jax():
    got = _port_penalty_grads(lambda s: pfs.fused_softmax(s), [SCORES])
    want = _jax_penalty_grads(lambda s: jax_softmax(s), [SCORES])
    _close(got[0], want[0], 'softmax dx')


def test_conv2d_second_order_matches_jax():
    got = _port_penalty_grads(lambda x, w: F.conv2d(x, w, padding=1),
                              [IMG, KER])
    want = _jax_penalty_grads(
        _tensor_op(lambda x, w: JF.conv2d(x, w, padding=1)), [IMG, KER])
    for name, a, b in zip(('x', 'w'), got, want):
        _close(a, b, f'conv2d d{name}')


def test_first_order_through_the_kernel_paths_is_unchanged(monkeypatch):
    """Without ``create_graph`` the backward takes ``_ln_bwd``, as the
    card's launch-counting paths need; under it, the composition."""
    calls = []
    pln = importlib.import_module('paddle_tpu_torch.ops.fused_norm')
    real = pln._ln_bwd
    monkeypatch.setattr(pln, '_ln_bwd',
                        lambda *a: calls.append(1) or real(*a))
    x = torch.tensor(X4, requires_grad=True)
    g1, = paddle.grad(fused_layer_norm(x).sum(), x)
    assert calls == [1] and not g1.requires_grad
    g2, = paddle.grad(fused_layer_norm(x).sum(), x, create_graph=True)
    assert calls == [1] and g2.requires_grad
    torch.testing.assert_close(g1, g2.detach(), rtol=0, atol=1e-6)


KERNEL_ENTRIES = {
    'flash': (pfa, '_bwd', lambda q, k, v: pfa.flash_attention(q, k, v,
                                                               True), QKV),
    'linear_gelu': (pfg, '_dz', lambda x, w, b: pfg.fused_linear_gelu(
        x, w, b), GELU),
}


@pytest.mark.parametrize('op', sorted(KERNEL_ENTRIES))
def test_create_graph_first_order_comes_from_the_kernels(op, monkeypatch):
    """Under ``create_graph`` the first-order gradient is the kernel
    entry's (one call each pass), bit for bit the one without it."""
    mod, entry, fn, arrays = KERNEL_ENTRIES[op]
    calls = []
    real = getattr(mod, entry)
    monkeypatch.setattr(mod, entry, lambda *a: calls.append(1) or real(*a))
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    plain = paddle.grad((fn(*xs) ** 3).sum(), xs)
    assert calls == [1]
    graphed = paddle.grad((fn(*xs) ** 3).sum(), xs, create_graph=True)
    assert calls == [1, 1]
    for a, b in zip(plain, graphed):
        assert b.requires_grad
        assert torch.equal(a, b.detach())


THIRD_ORDER = {
    'layer_norm': (lambda x: fused_layer_norm(x),
                   lambda x: importlib.import_module(
                       'paddle_tpu_torch.ops.fused_norm')._reference(
                           x, None, None, 1e-5)[0], X4),
    'flash': (lambda x: pfa.flash_attention(x, x * 0.5, x, True),
              lambda x: pfa._fwd_twin(x, x * 0.5, x, True, 0.25)[0],
              QKV[0]),
    'linear_gelu': (lambda x: pfg.fused_linear_gelu(x, x.t()[:, :4], None),
                    lambda x: pfg._reference(x, x.t()[:, :4], None, True),
                    GELU[0]),
}


@pytest.mark.parametrize('op', sorted(THIRD_ORDER))
def test_third_order_matches_the_plain_composition(op):
    """A third order (``grad`` twice under ``create_graph``, then once
    more) through the kernels' Functions equals autograd's through the
    plain twin, where the inputs also feed the weights."""
    def third(f):
        x = torch.tensor(THIRD_ORDER[op][2], requires_grad=True)
        g1, = paddle.grad((f(x) ** 3).sum(), x, create_graph=True)
        g2, = paddle.grad((g1 ** 3).sum(), x, create_graph=True)
        return paddle.grad((g2 ** 2).sum(), x)[0].numpy()
    kernel, plain, _ = THIRD_ORDER[op]
    _close(third(kernel), third(plain), f'{op} third order')


def test_wgan_gp_penalty_matches_both_packages():
    """The reference's own WGAN-GP case (``tests/test_autograd.py:193``)
    on both packages with the same weights."""
    paddle_tpu.seed(0)
    jd = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(4, 8),
                                  paddle_tpu.nn.Tanh(),
                                  paddle_tpu.nn.Linear(8, 1))
    params = {n: np.asarray(p.value) for n, p in jd.named_parameters()}
    D = paddle.nn.Sequential(paddle.nn.Linear(4, 8, device='cpu'),
                             paddle.nn.Tanh(),
                             paddle.nn.Linear(8, 1, device='cpu'))
    with torch.no_grad():
        for n, p in D.named_parameters():
            p.copy_(torch.tensor(params[n]))
    xs_np = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    xs = torch.tensor(xs_np, requires_grad=True)
    gx = paddle.grad(D(xs).sum(), xs, create_graph=True)[0]
    gp = ((gx.square().sum(axis=1).sqrt() - 1.0) ** 2).mean()
    gp.backward()

    def fwd(p, xv):
        h = jnp.tanh(xv @ p['0.weight'] + p['0.bias'])
        return (h @ p['2.weight'] + p['2.bias']).sum()

    def penalty(p, xv):
        g = jax.grad(fwd, argnums=1)(p, xv)
        return jnp.mean((jnp.sqrt(jnp.sum(g ** 2, axis=1)) - 1.0) ** 2)

    gref = jax.jit(jax.grad(penalty))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xs_np))
    for n, p in D.named_parameters():
        if n.endswith('2.bias'):        # the penalty does not see it
            assert p.grad is None or float(p.grad.abs().max()) == 0.0
            continue
        _close(p.grad.numpy(), gref[n], f'wgan-gp {n}')


MODEL_KW = dict(num_layers=2, hidden_size=32, num_heads=2, vocab_size=64,
                max_seq_len=16, dropout=0.0)


def test_gpt_blocks_gradient_penalty_matches_jax():
    """A penalty on the gradient through two ``gpt_tiny`` blocks (its
    LayerNorms, causal attention and GELU MLP), backward to every block
    parameter and to the input, against ``jax.grad(jax.grad)`` of the
    JAX blocks run with ``functional_call``."""
    paddle_tpu.seed(3)
    jm = jax_gpt_tiny(**MODEL_KW)
    host = {k: np.asarray(v) + (0.05 * np.random.RandomState(1).randn(
        *np.shape(v))).astype(np.float32)
        for k, v in jm.functional_state()[0].items()}
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    pm.train()
    h_np = np.random.RandomState(2).randn(2, 8, 32).astype(np.float32)

    h = torch.tensor(h_np, requires_grad=True)

    def blocks(x):
        for blk in pm.gpt.blocks:
            x = blk(x)[0]
        return x
    g, = paddle.grad((blocks(h) ** 2).sum(), h, create_graph=True)
    penalty = ((g.square().sum(axis=-1).sqrt() - 1.0) ** 2).mean()
    penalty.backward()

    prefix = 'gpt.blocks.'
    bparams = {k: jnp.asarray(v) for k, v in host.items()
               if k.startswith(prefix)}

    def jblocks(p, x):
        for i, blk in enumerate(jm.gpt.blocks):
            mine = {k[len(f'{prefix}{i}.'):]: v for k, v in p.items()
                    if k.startswith(f'{prefix}{i}.')}
            x, _ = functional_call(blk, mine, {}, (x,), training=True)
        return x

    def jpenalty(p, x):
        gx = jax.grad(lambda xx: jnp.sum(jblocks(p, xx) ** 2))(x)
        return jnp.mean((jnp.sqrt(jnp.sum(gx ** 2, axis=-1)) - 1.0) ** 2)

    gp, gh = jax.jit(jax.grad(jpenalty, argnums=(0, 1)))(
        bparams, jnp.asarray(h_np))
    _close(h.grad.numpy(), gh, 'gpt blocks dh')
    named = dict(pm.named_parameters())
    largest = max(float(np.abs(np.asarray(w)).max()) for w in gp.values())
    for k, want in gp.items():
        got, want = named[k].grad.numpy(), np.asarray(want)
        if '.attn.qkv.bias' in k:
            # q, k and v thirds: the key third's true gradient is 0 (a
            # shift of every key moves no softmax), so both packages
            # give round-off there, held to 1e-3 of the largest gradient
            h = want.shape[0] // 3
            for part, sl in (('q', slice(0, h)), ('v', slice(2 * h, None))):
                _close(got[sl], want[sl], f'{k} {part} third')
            for side in (got, want):
                assert float(np.abs(side[h:2 * h]).max()) <= 1e-3 * largest
            continue
        _close(got, want, k)
