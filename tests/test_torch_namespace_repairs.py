"""Four namespace and dtype faults the port had against the reference
(ROADMAP Queue 3, items 1-4), each repaired and held to the JAX package
here on the same numpy inputs; every case failed before the repair.

1. ``paddle_tpu_torch.ops`` exports the reference's four functions:
   ``ops.flash_attention`` and ``ops.fused_linear_gelu`` are the
   functions (also once the models have loaded), and
   ``incubate.flash_attention`` is there too; the submodules stay
   reachable through ``importlib.import_module``.
2. The names the reference reaches: ``vision`` re-exports the zoo,
   ``framework`` has ``grad``, ``set_grad_enabled``, the generator
   states and ``ComplexTensor`` (also at the top level),
   ``paddle_tpu_torch.device`` is the reference's ``paddle.device``, and
   ``quantization`` is reachable from the top level without an import.
3. The initializers take the reference's dtype names and numpy dtypes
   and default to ``get_default_dtype()``.
4. ``F.softmax``, ``F.log_softmax`` and ``F.softmax_`` take a dtype name
   or a numpy dtype.  The port casts the input to it, so the result
   takes that dtype; the reference reads no ``dtype`` and keeps x's
   (pinned below as a documented difference); the values agree.

Tolerances: f32 results within 1e-6 (2e-6 for attention through
another order of sums), exact where both packages compute the same
constants.
"""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as PI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after:
    the suite runs six workers on the machine's cores, and torch's
    default of a thread a core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _arrays(*shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


# -- 1. ops exports --------------------------------------------------------

def test_ops_exports_the_references_four_functions():
    assert sorted(paddle.ops.__all__) == sorted(jpaddle.ops.__all__)
    for name in jpaddle.ops.__all__:
        assert callable(getattr(paddle.ops, name)), name


def test_ops_flash_attention_is_the_function_after_the_models_load():
    importlib.import_module('paddle_tpu_torch.models.gpt')
    q, k, v = _arrays((4, 32, 16), (4, 32, 16), (4, 32, 16))
    want = np.asarray(jpaddle.ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    for fn in (paddle.ops.flash_attention, paddle.incubate.flash_attention):
        got = fn(*map(torch.from_numpy, (q, k, v)), causal=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    # the submodules stay reachable for importers that need them
    mod = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    assert mod.flash_attention is paddle.ops.flash_attention
    assert 'flash_attention' in paddle.incubate.__all__


def test_ops_fused_linear_gelu_matches_the_reference():
    x, w, b = _arrays((8, 16), (16, 32), (32,), seed=1)
    want = np.asarray(jpaddle.ops.fused_linear_gelu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = paddle.ops.fused_linear_gelu(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    mod = importlib.import_module('paddle_tpu_torch.ops.fused_gelu_linear')
    assert mod.fused_linear_gelu is paddle.ops.fused_linear_gelu


# -- 2. names and namespaces -------------------------------------------------

def test_vision_reexports_the_zoo():
    for name in jpaddle.vision.models.__all__:
        if hasattr(paddle.vision.models, name):
            assert getattr(paddle.vision, name) is \
                getattr(paddle.vision.models, name), name
    assert paddle.vision.resnet50 is paddle.vision.models.resnet50
    assert paddle.vision.LeNet is paddle.vision.models.LeNet
    assert set(paddle.vision.models.__all__) <= set(paddle.vision.__all__)


def test_framework_has_the_references_names():
    assert sorted(paddle.framework.__all__) == \
        sorted(jpaddle.framework.__all__)
    fw = paddle.framework
    assert fw.grad is paddle.grad
    assert fw.set_grad_enabled is paddle.set_grad_enabled
    state = fw.get_cuda_rng_state()
    a = paddle.rand([4])
    fw.set_cuda_rng_state(state)
    assert torch.equal(paddle.rand([4]), a)


@pytest.mark.parametrize('imag', [[3.0, -4.0], None])
def test_complex_tensor_matches_the_reference(imag):
    want = jpaddle.ComplexTensor([1.0, 2.0], imag)
    for fn in (paddle.ComplexTensor, paddle.framework.ComplexTensor):
        got = fn([1.0, 2.0], imag)
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))
    with pytest.raises(ValueError, match='shape'):
        paddle.ComplexTensor([1.0, 2.0], [1.0])


def test_device_module_is_the_references():
    assert sorted(paddle.device.__all__) == sorted(jpaddle.device.__all__)
    for name in jpaddle.device.__all__:
        assert callable(getattr(paddle.device, name)), name
    paddle.device.set_device('cpu')
    assert paddle.device.get_device() == 'cpu'
    assert paddle.device.is_compiled_with_xpu() is False


def test_quantization_is_reachable_from_the_top_level():
    code = ('import paddle_tpu_torch as p; '
            'print(p.quantization.__name__, "jax" in __import__("sys")'
            '.modules)')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['paddle_tpu_torch.quantization', 'False']


# -- 3. initializer dtypes -------------------------------------------------

INITS = [('Constant', (0.5,)), ('Normal', ()), ('TruncatedNormal', ()),
         ('Uniform', ()), ('XavierNormal', ()), ('XavierUniform', ()),
         ('KaimingNormal', ()), ('KaimingUniform', ()),
         ('Assign', (np.arange(6, dtype=np.float32).reshape(2, 3),)),
         ('Bilinear', ())]
DTYPES = ['float32', 'float16', np.float32, np.dtype('float16'), None]


@pytest.mark.parametrize('name,args', INITS, ids=[n for n, _ in INITS])
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_initializers_take_the_references_dtypes(name, args, dtype):
    shape = [2, 3, 4, 4] if name == 'Bilinear' else [2, 3]
    want = getattr(JI, name)(*args)(shape, dtype)
    got = getattr(PI, name)(*args)(shape, dtype,
                                   torch.Generator().manual_seed(0))
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace('torch.', '') == str(want.dtype)
    if name in ('Constant', 'Assign', 'Bilinear'):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_initializers_default_to_the_default_dtype():
    try:
        paddle.set_default_dtype('float16')
        got = PI.Normal()([3, 4])
        assert got.dtype == torch.float16
    finally:
        paddle.set_default_dtype('float32')
    assert PI.Constant(1.0)([2]).dtype == torch.float32


# -- 4. softmax dtypes -----------------------------------------------------

@pytest.mark.parametrize('op', ['softmax', 'log_softmax'])
@pytest.mark.parametrize('dtype,port_dtype', [
    ('float32', torch.float32), (np.float32, torch.float32),
    ('float64', torch.float64), (np.dtype('float64'), torch.float64)],
    ids=['name32', 'np32', 'name64', 'np64'])
def test_softmax_takes_a_dtype_name_or_a_numpy_dtype(op, dtype, port_dtype):
    x, = _arrays((4, 16), seed=2)
    want = getattr(JF, op)(jpaddle.to_tensor(x), -1, dtype)
    got = getattr(F, op)(torch.from_numpy(x), -1, dtype)
    # the port casts to dtype; the reference keeps x's (float32)
    assert got.dtype == port_dtype
    assert str(want.dtype) == 'float32'
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.value),
                               rtol=1e-6, atol=1e-6)


def test_softmax_in_place_takes_a_dtype_name():
    x, = _arrays((4, 16), seed=3)
    want = JF.softmax(jpaddle.to_tensor(x), -1)
    t = torch.from_numpy(x.copy())
    got = F.softmax_(t, -1, 'float64')
    assert got is t and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=1e-6, atol=1e-6)
