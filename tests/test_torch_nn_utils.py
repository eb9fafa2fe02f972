"""The port's ``nn.utils`` (weight and spectral normalisation), the
new initializers, ``amp``'s aliases, the name surface of ``nn``,
``nn.functional``, ``nn.initializer`` and ``amp``, and two repairs,
against the JAX package, on the CPU.

``weight_norm`` and ``spectral_norm`` are forward pre-hooks under the
reference's state-dict keys (``weight_g``/``weight_v``,
``weight_orig`` and the buffer ``weight_u``), so
``convert.load_numpy_state`` carries the reference's state, ``u``
included, and the outputs and gradients agree within 2e-5 / 1e-4.
The reference's ``spectral_norm`` hook tests ``params.get(name) or
...`` on the weight, which raises for a weight of more than one
element; the oracle here reads that ``or`` as the None test it means
(``Tensor.__bool__`` patched to True while the reference's hook runs),
and the port reads it so.  Sigma is a constant to autograd in both:
the weight's gradient is the output's divided by sigma, not PyTorch's
``spectral_norm`` gradient.

Repairs, each a case that raised in the port where the reference
returns a value: ``return_mask=True`` in every max pool and adaptive
max pool (the reference never reads the flag: the pooled tensor alone
comes back), and ``paddle.regularizer``, ``paddle.parallel``,
``paddle.models`` and ``paddle.distributed`` from the top level.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from torch_seq_oracle import compare_vjp, load_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)
    init.set_global_initializer(None, None)
    jpaddle.nn.initializer.set_global_initializer(None, None)


@pytest.fixture
def ref_or_as_none_test(monkeypatch):
    """The reference's spectral-norm hook with its ``or`` read as a None
    test (see the module docstring)."""
    monkeypatch.setattr(JaxTensor, '__bool__', lambda self: True)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, *args, seed=0):
    jpaddle.seed(seed)
    return getattr(jpaddle.nn, name)(*args), getattr(nn, name)(*args)


@pytest.mark.parametrize('name,args,dim,shape', [
    ('Linear', (5, 4), 0, (3, 5)), ('Linear', (5, 4), None, (3, 5)),
    ('Linear', (5, 4), 1, (3, 5)), ('Conv2D', (3, 4, 3), 0, (2, 3, 6, 6)),
    ('Conv2DTranspose', (3, 4, 3), 1, (2, 3, 5, 5))])
def test_weight_norm_matches_jax(name, args, dim, shape):
    jm, pm = _pair(name, *args)
    jpaddle.nn.weight_norm(jm, dim=dim)
    nn.weight_norm(pm, dim=dim)
    keys = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert keys == {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert 'weight' not in keys and {'weight_g', 'weight_v'} <= set(keys)
    load_from_jax(pm, jm)
    compare_vjp(jm, pm, lambda m, v: m(v), [_x(*shape)], 2e-5, 1e-4)


def test_remove_weight_norm_restores_a_parameter():
    jm, pm = _pair('Linear', 5, 4)
    jpaddle.nn.weight_norm(jm)
    nn.weight_norm(pm)
    load_from_jax(pm, jm)
    x = _x(3, 5)
    pm(torch.from_numpy(x))
    jm(jpaddle.to_tensor(x))
    nn.remove_weight_norm(pm)
    jpaddle.nn.remove_weight_norm(jm)
    assert set(pm.state_dict()) == {'weight', 'bias'} == set(jm.state_dict())
    assert isinstance(pm.weight, torch.nn.Parameter)
    np.testing.assert_allclose(pm.weight.detach().numpy(),
                               np.asarray(jm.weight.value), rtol=1e-6,
                               atol=1e-7)
    compare_vjp(jm, pm, lambda m, v: m(v), [x], 2e-5, 1e-4)


@pytest.mark.parametrize('name,args,dim,iters,shape', [
    ('Linear', (5, 4), None, 1, (3, 5)), ('Linear', (5, 4), 1, 3, (3, 5)),
    ('Conv2D', (3, 4, 3), None, 1, (2, 3, 6, 6)),
    ('Conv2D', (3, 4, 3), 2, 2, (2, 3, 6, 6))])
def test_spectral_norm_matches_jax_with_u_carried(ref_or_as_none_test,
                                                  name, args, dim, iters,
                                                  shape):
    jm, pm = _pair(name, *args)
    jpaddle.nn.spectral_norm(jm, n_power_iterations=iters, dim=dim)
    nn.spectral_norm(pm, n_power_iterations=iters, dim=dim)
    keys = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert keys == {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert {'weight_orig', 'weight_u'} <= set(keys)
    assert [n for n, _ in pm.named_buffers()] == ['weight_u']
    load_from_jax(pm, jm)
    _compare_eager(jm, pm, _x(*shape))
    # each forward took one more step of the power iteration, in place
    np.testing.assert_allclose(pm.weight_u.numpy(),
                               np.asarray(jm.weight_u.value), rtol=1e-5,
                               atol=1e-6)


def _compare_eager(jm, pm, x):
    """Output and gradients of ``sum(m(x) * cot)`` on the reference's
    own tape (eager, where its hook reads sigma from raw arrays; under
    ``jax.grad`` of the functional state those arrays are traced) and
    by the port's ``backward``."""
    jx = jpaddle.to_tensor(x)
    jx.stop_gradient = False
    jy = jm(jx)
    cot = _x(*jy.shape, seed=7)
    (jy * jpaddle.to_tensor(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    pm.zero_grad(set_to_none=True)
    ty = pm(tx)
    (ty * torch.from_numpy(cot)).sum().backward()
    pairs = [('output', ty, jy), ('input gradient', tx.grad, jx.grad)] + [
        (n, p.grad, getattr(jm, n).grad) for n, p in pm.named_parameters()]
    for what, got, want in pairs:
        want = np.asarray(want.value if hasattr(want, 'value') else want)
        got = got.detach().numpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        tol = 2e-5 if what == 'output' else 1e-4
        assert float(np.abs(got - want).max()) / scale <= tol, what


def test_spectral_norm_sigma_is_constant_to_autograd():
    """The weight's gradient is the output's over sigma (sigma held
    constant), which is not ``torch.nn.utils.spectral_norm``'s."""
    pm = nn.Linear(6, 4)
    nn.spectral_norm(pm)
    x = torch.from_numpy(_x(5, 6))
    u_before = pm.weight_u.clone()
    y = pm(x)
    w = pm.weight_orig.detach()
    u = pm.weight_u
    v = w.T @ u_before
    v = v / v.norm()
    sigma = u @ w @ v
    assert not torch.equal(u, u_before)
    torch.testing.assert_close(pm.weight, w / sigma)
    g = torch.from_numpy(_x(5, 4, seed=1))
    (y * g).sum().backward()
    torch.testing.assert_close(pm.weight_orig.grad, (x.T @ g) / sigma,
                               rtol=1e-5, atol=1e-6)
    # differentiating through sigma, as torch.nn.utils.spectral_norm
    # does, gives another gradient
    wd = w.clone().requires_grad_(True)
    (x @ (wd / (u @ wd @ v)) * g).sum().backward()
    assert float((wd.grad - pm.weight_orig.grad).abs().max()) > 1e-3


def test_new_initializers():
    """``TruncatedNormal`` within +-2 std with the truncated law's
    moments, as the reference's draws; ``KaimingNormal``'s std;
    ``Assign`` and ``Bilinear`` equal the reference's exactly."""
    gen = torch.Generator().manual_seed(0)
    t = init.TruncatedNormal(1.0, 0.5)((200000,), generator=gen)
    r = np.asarray(jpaddle.nn.initializer.TruncatedNormal(1.0, 0.5)(
        (200000,), 'float32'))
    for a in (t.numpy(), r):
        assert a.min() >= 0.0 and a.max() <= 2.0
        assert abs(a.mean() - 1.0) < 5e-3
        assert abs(a.std() - 0.5 * np.sqrt(0.77374)) < 5e-3
    k = init.KaimingNormal(fan_in=50)((400, 50), generator=gen)
    assert abs(float(k.std()) - np.sqrt(2.0 / 50)) < 2e-3
    v = np.arange(12, dtype=np.float32)
    np.testing.assert_array_equal(
        init.Assign(v)((3, 4)).numpy(),
        np.asarray(jpaddle.nn.initializer.Assign(v)((3, 4), 'float32')))
    assert init.Assign(torch.ones(2, 2))((4,), torch.bfloat16).dtype == \
        torch.bfloat16
    for shape in ((2, 3, 4, 4), (1, 1, 3, 5)):
        np.testing.assert_array_equal(
            init.Bilinear()(shape).numpy(),
            np.asarray(jpaddle.nn.initializer.Bilinear()(shape, 'float32')))


def test_set_global_initializer_reaches_the_layers_as_in_the_reference():
    """A parameter with neither an attr's initializer nor a layer default
    (``Linear``'s bias, ``GroupNorm``'s bias) takes the global one; one
    with a layer default keeps it, in both packages."""
    for pkg in (paddle, jpaddle):
        pkg.nn.initializer.set_global_initializer(
            pkg.nn.initializer.Constant(0.5), pkg.nn.initializer.Constant(
                -2.0))
    lin = nn.Linear(3, 4)
    jlin = jpaddle.nn.Linear(3, 4)
    gn, jgn = nn.GroupNorm(2, 4), jpaddle.nn.GroupNorm(2, 4)
    for p, j in ((lin.bias, jlin.bias), (gn.bias, jgn.bias),
                 (gn.weight, jgn.weight)):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(j.value))
    assert float(lin.bias[0].detach()) == -2.0
    assert float(gn.weight[0].detach()) == 1.0
    assert isinstance(init.get_default_init(False), init.Constant)
    init.set_global_initializer(None)
    assert isinstance(init.get_default_init(False), init.XavierNormal)
    assert isinstance(init.get_default_init(True), init.Constant)


def test_amp_aliases_as_in_the_reference():
    assert paddle.amp.amp_guard is paddle.amp.auto_cast
    assert paddle.amp.amp_decorate is paddle.amp.decorate
    with paddle.amp.amp_guard(level='O2'):
        st = paddle.amp.amp_state()
        assert st.enabled and st.level == 'O2'
        assert st.dtype == torch.bfloat16
    assert not paddle.amp.amp_state().enabled


def _defined(mod):
    """The public names a reference module defines or lists: not the
    modules it imports, nor the helpers it imports from elsewhere."""
    listed = set(getattr(mod, '__all__', ()))
    out = set()
    for n in dir(mod):
        if n.startswith('_'):
            continue
        obj = getattr(mod, n)
        if isinstance(obj, types.ModuleType) and n not in listed:
            continue
        home = getattr(obj, '__module__', None) or mod.__name__
        if n in listed or home.startswith(mod.__name__):
            out.add(n)
    return out


@pytest.mark.parametrize('path', ['nn', 'nn.functional', 'nn.initializer',
                                  'amp'])
def test_every_public_name_of_the_reference_is_in_the_port(path):
    """``amp.audit`` stays out: it wraps ``analysis.amp_audit``, which
    is ROADMAP item 11."""
    ref, port = jpaddle, paddle
    for part in path.split('.'):
        ref, port = getattr(ref, part), getattr(port, part)
    gap = sorted(_defined(ref) - set(dir(port)) - {'audit'})
    assert gap == [], f'{path}: {gap}'


@pytest.mark.parametrize('pool,args', [
    ('max_pool1d', (2,)), ('max_pool2d', (2,)), ('max_pool3d', (2,)),
    ('adaptive_max_pool1d', (3,)), ('adaptive_max_pool2d', (3,)),
    ('adaptive_max_pool3d', (3,))])
def test_return_mask_returns_the_pooled_tensor_as_the_reference(pool, args):
    n = int(pool[-2])
    x = _x(2, 3, *(6,) * n)
    want = getattr(jpaddle.nn.functional, pool)(jpaddle.to_tensor(x), *args,
                                                return_mask=True)
    got = getattr(F, pool)(torch.from_numpy(x), *args, return_mask=True)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))
    layer = {'max': 'MaxPool', 'ada': 'AdaptiveMaxPool'}[pool[:3]] + \
        f'{n}D'
    out = getattr(nn, layer)(*args, return_mask=True)(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want.value))


def test_top_level_reaches_the_reference_packages():
    """``paddle.regularizer.L2Decay`` as a ``weight_decay``, and the
    ``parallel``, ``models`` and ``distributed`` packages, from the top
    level; importing the package starts no thread and no CUDA context,
    and leaves ``models`` to its first use (a Predictor's process never
    loads the model zoo)."""
    m = nn.Linear(3, 2)
    opt = paddle.optimizer.Momentum(
        0.1, parameters=m.parameters(),
        weight_decay=paddle.regularizer.L2Decay(1e-4))
    m(torch.ones(4, 3)).sum().backward()
    opt.step()
    assert paddle.parallel.ParallelTrainer is not None
    assert callable(paddle.models.gpt_tiny)
    assert paddle.distributed.fleet.DistributedStrategy is not None
    code = ('import sys, threading, torch, paddle_tpu_torch as p; '
            'print(threading.active_count(), torch.cuda.is_initialized(), '
            "'paddle_tpu_torch.models' in sys.modules, "
            'p.regularizer.L2Decay.__name__, p.models.__name__)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.split() == ['1', 'False', 'False', 'L2Decay',
                                   'paddle_tpu_torch.models'], \
        proc.stdout + proc.stderr
