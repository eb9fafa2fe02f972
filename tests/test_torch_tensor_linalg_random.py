"""``tensor.linalg``, ``tensor.stat``, ``tensor.random``, ``tensor.array``
and ``tensor.to_string`` of the port against the JAX package on the
CPU, with the top level's dtypes, places, grad switches and RNG state.

Linalg and stat ops are held forward and gradient by
``torch_tensor_oracle`` (f32: outputs 2e-5, gradients 1e-4; SVD, QR and
eigh by what they reconstruct, since their signs are free).  Random ops
cannot match ``jax.random``'s bits: they are held by determinism under
``seed``, by their laws (moments within 6 standard errors) and by the
permutations they give.  The names: every name of the reference's
``tensor.__all__`` and of its top level (those this slice ports) is in
the port's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from torch_tensor_oracle import check


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after:
    the suite runs six workers on the machine's cores, and torch's
    default of a thread a core oversubscribes them."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

RS = np.random.RandomState(2)
M = RS.randn(4, 4).astype(np.float32)
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
R = RS.randn(4, 3).astype(np.float32)
V3 = RS.randn(2, 3).astype(np.float32)
W3 = RS.randn(2, 3).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    paddle_tpu_torch.set_device('cpu')
    yield
    paddle_tpu_torch.set_device(None)


LINALG = {
    'mm': (lambda P, a, b: P.mm(a, b), [M, R]),
    'matmul_t': (lambda P, a, b: P.matmul(a, b, transpose_x=True), [M, R]),
    'bmm': (lambda P, a, b: P.bmm(a, b), [np.stack([M, M]),
                                          np.stack([R, R])]),
    'dot': (lambda P, a, b: P.dot(a, b), [V3, W3]),
    'mv': (lambda P, a, b: P.mv(a, b), [M, M[0].copy()]),
    't': (lambda P, a: P.t(a), [R]),
    'norm_fro': (lambda P, a: P.norm(a), [R]),
    'norm_axis': (lambda P, a: P.norm(a, 'fro', axis=1, keepdim=True), [R]),
    'norm_p': (lambda P, a: P.norm(a, 3, axis=0), [R]),
    'norm_inf': (lambda P, a: [P.norm(a, np.inf, axis=1),
                               P.norm(a, -np.inf, axis=0)], [R]),
    'norm_0': (lambda P, a: P.norm(a, 0, axis=1), [R]),
    'dist': (lambda P, a, b: [P.dist(a, b), P.dist(a, b, 1),
                              P.dist(a, b, np.inf)], [V3, W3]),
    'cross': (lambda P, a, b: P.cross(a, b), [V3, W3]),
    'cross_axis': (lambda P, a, b: P.cross(a, b, axis=1), [V3, W3]),
    'cholesky': (lambda P, a: [P.cholesky(a), P.cholesky(a, upper=True)],
                 [SPD]),
    'matrix_power': (lambda P, a: P.matrix_power(a, 3), [M]),
    'einsum': (lambda P, a, b: P.einsum('ij,kj->ik', a, b), [R, R]),
    'inv': (lambda P, a: [P.inv(a), P.inverse(a)], [SPD]),
    'det': (lambda P, a: P.det(a), [M]),
    'slogdet': (lambda P, a: P.slogdet(a), [M]),
    'solve': (lambda P, a, b: P.solve(a, b), [SPD, R]),
    'triangular_solve': (lambda P, a, b: [
        P.triangular_solve(a, b), P.triangular_solve(a, b, upper=False),
        P.triangular_solve(a, b, transpose=True)],
        [np.triu(SPD) + 0, R]),
    'pinv': (lambda P, a: P.pinv(a), [R]),
    'multi_dot': (lambda P, a, b, c: P.multi_dot([a, b, c]), [M, M, R]),
    'cond': (lambda P, a: P.cond(a), [SPD]),
}


@pytest.mark.parametrize('name', sorted(LINALG))
def test_linalg(name):
    fn, arrays = LINALG[name]
    check(fn, arrays, tol=5e-5, grad_tol=5e-4, what=name)


def test_decompositions_reconstruct():
    for P in (paddle_tpu, paddle_tpu_torch):
        u, s, vh = P.svd(P.to_tensor(R))
        np.testing.assert_allclose(
            np.asarray((P.matmul(u * s, vh)).numpy()), R, atol=1e-5)
        q, r = P.qr(P.to_tensor(R))
        np.testing.assert_allclose(np.asarray(P.matmul(q, r).numpy()), R,
                                   atol=1e-5)
        w, v = P.eigh(P.to_tensor(SPD))
        np.testing.assert_allclose(
            np.asarray(P.matmul(v * w, P.t(v)).numpy()), SPD, atol=1e-4)
    check(lambda P, a: P.svd(a)[1], [R], grad=False)
    check(lambda P, a: P.eigh(a)[0], [SPD], grad=False, tol=1e-4)


def test_rank_and_histogram():
    low = (R @ R.T).astype(np.float32)          # rank 3
    check(lambda P, a: [P.matrix_rank(a), P.matrix_rank(a, tol=1e-3)],
          [low])
    h = RS.randn(200).astype(np.float32)
    check(lambda P, a: [P.histogram(a, bins=7),
                        P.histogram(a, bins=4, min=-1, max=1)], [h])


def test_cross_without_an_axis_of_size_3_raises():
    for P in (paddle_tpu, paddle_tpu_torch):
        with pytest.raises(ValueError):
            P.cross(P.to_tensor(M), P.to_tensor(M))


# -- stat ---------------------------------------------------------------------

X = RS.randn(3, 4, 6).astype(np.float32)


@pytest.mark.parametrize('name,kw', [
    ('mean', {}), ('std', {}), ('std', {'axis': 1, 'unbiased': False}),
    ('var', {'axis': [0, 2], 'keepdim': True}), ('median', {}),
    ('median', {'axis': 2}), ('median', {'axis': [0, 1], 'keepdim': True}),
    ('nanmean', {'axis': 1}), ('nansum', {'axis': 0})],
    ids=lambda v: v if isinstance(v, str) else '-'.join(map(str, v)))
def test_stat(name, kw):
    check(lambda P, a: getattr(P, name)(a, **kw), [X], what=name)


def test_median_averages_the_two_middle_values():
    x = np.array([[4.0, 1.0, 3.0, 2.0]], np.float32)
    out = check(lambda P, a: P.median(a, axis=1), [x])
    assert float(out[0]) == 2.5


@pytest.mark.parametrize('q', [0.3, [0.1, 0.5, 0.9]])
def test_quantile(q):
    check(lambda P, a: P.quantile(a, q), [X])
    check(lambda P, a: P.quantile(a, q, axis=1, keepdim=True), [X])


def test_nan_reductions():
    x = X.copy()
    x[0, 1, 2] = np.nan
    check(lambda P, a: [P.nanmean(a), P.nansum(a, axis=2)], [x],
          grad=False)


# -- random -------------------------------------------------------------------

DRAWS = {
    'rand': lambda P: P.rand([64]),
    'randn': lambda P: P.randn([64]),
    'standard_normal': lambda P: P.standard_normal([64]),
    'randint': lambda P: P.randint(0, 10, [64]),
    'randint_like': lambda P: P.randint_like(P.zeros([64], 'int32'), 0, 10),
    'uniform': lambda P: P.uniform([64], min=2.0, max=3.0),
    'normal': lambda P: P.normal(1.0, 2.0, [64]),
    'normal_tensor': lambda P: P.normal(P.zeros([64]), P.ones([64])),
    'gaussian': lambda P: P.gaussian([64], 1.0, 0.1),
    'randperm': lambda P: P.randperm(64),
    'bernoulli': lambda P: P.bernoulli(P.full([64], 0.5)),
    'multinomial': lambda P: P.multinomial(P.ones([64]) / 64.0, 8),
    'multinomial_rep': lambda P: P.multinomial(P.ones([2, 5]) / 5.0, 20,
                                               replacement=True),
    'poisson': lambda P: P.poisson(P.full([64], 3.0)),
    'shuffle': lambda P: P.shuffle(P.arange(64)),
    'uniform_': lambda P: P.uniform_(P.zeros([64])),
    'normal_': lambda P: P.normal_(P.zeros([64])),
    'exponential_': lambda P: P.exponential_(P.zeros([64])),
}


@pytest.mark.parametrize('name', sorted(DRAWS))
def test_draws_repeat_under_seed_and_differ_across_seeds(name):
    P = paddle_tpu_torch
    P.seed(42)
    a = DRAWS[name](P)
    P.seed(42)
    b = DRAWS[name](P)
    c = DRAWS[name](P)
    P.seed(7)
    d = DRAWS[name](P)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(b, c) and not torch.equal(a, d)
    ref = DRAWS[name](paddle_tpu)
    assert tuple(a.shape) == tuple(ref.shape)


def test_draws_follow_their_laws():
    P = paddle_tpu_torch
    P.seed(0)
    n = 1 << 18

    def within(x, mean, var, what):
        x = x.double()
        se = (var / n) ** 0.5
        assert abs(float(x.mean()) - mean) < 6 * se, what
        sv = (2 * var * var / n) ** 0.5 if var > 0 else 0
        assert abs(float(x.var()) - var) < 6 * sv + 0.1 * var, what

    within(P.rand([n]), 0.5, 1 / 12, 'rand')
    within(P.randn([n]), 0.0, 1.0, 'randn')
    within(P.uniform([n], min=2.0, max=3.0), 2.5, 1 / 12, 'uniform')
    within(P.normal(1.0, 2.0, [n]), 1.0, 4.0, 'normal')
    within(P.poisson(P.full([n], 3.0)), 3.0, 3.0, 'poisson')
    within(P.exponential_(P.zeros([n]), 2.0), 0.5, 0.25, 'exponential_')
    within(P.bernoulli(P.full([n], 0.3)), 0.3, 0.21, 'bernoulli')
    within(P.randint(0, 10, [n]).float(), 4.5, 8.25, 'randint')


def test_multinomial_without_replacement_follows_the_gumbel_law():
    """First draws of Gumbel top-k are categorical(p); no row repeats
    an index.  A chi-square test at 4 degrees of freedom (99.9%
    quantile 18.47)."""
    P = paddle_tpu_torch
    P.seed(1)
    p = torch.tensor([0.1, 0.2, 0.3, 0.15, 0.25])
    draws = P.multinomial(p.expand(20000, 5).contiguous(), 3)
    assert all(len(set(r)) == 3 for r in draws.tolist()[:200])
    counts = torch.bincount(draws[:, 0], minlength=5).double()
    expected = p.double() * 20000
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 18.47, chi2


def test_permutations():
    P = paddle_tpu_torch
    for _ in range(3):
        assert sorted(P.randperm(50).tolist()) == list(range(50))
        x = P.shuffle(P.arange(50).reshape([25, 2]))
        assert sorted(x[:, 0].tolist()) == list(range(0, 50, 2))
        assert torch.equal(x[:, 1] - x[:, 0], torch.ones(25,
                                                         dtype=x.dtype))


def test_check_shape():
    for P in (paddle_tpu, paddle_tpu_torch):
        assert P.check_shape([2, 3]) == (2, 3)
        assert P.check_shape(4) == (4,)
        with pytest.raises(TypeError):
            P.check_shape('x')


def test_cuda_rng_state_round_trip_repeats_the_draws():
    P = paddle_tpu_torch
    P.seed(3)
    P.rand([5])
    state = P.get_cuda_rng_state()
    a = P.rand([100])
    P.randn([7])
    P.set_cuda_rng_state(state)
    torch.testing.assert_close(P.rand([100]), a, rtol=0, atol=0)
    with pytest.raises(ValueError):
        P.set_cuda_rng_state([])


def test_draws_come_from_the_port_generator_not_torch_default():
    """A draw advances ``core.rng``'s generator of its device, the one a
    CUDA graph registers (``register_generators``), so replays draw
    fresh bits; PyTorch's default generator does not decide them."""
    P = paddle_tpu_torch
    P.seed(4)
    torch.manual_seed(0)
    a = P.rand([8])
    torch.manual_seed(0)
    b = P.rand([8])
    assert not torch.equal(a, b)
    P.seed(4)
    torch.manual_seed(123)
    torch.testing.assert_close(P.rand([8]), a, rtol=0, atol=0)


def test_draws_inside_a_graph_stay_on_the_device_generator():
    from paddle_tpu_torch.core import rng
    P = paddle_tpu_torch
    P.seed(9)
    gen = rng.generator('cpu')
    before = gen.get_state()
    P.randn([4])
    assert not torch.equal(before, gen.get_state())


# -- array and printing -------------------------------------------------------

def test_tensor_array():
    for P in (paddle_tpu, paddle_tpu_torch):
        arr = P.create_array()
        x = P.to_tensor(np.asarray([1.], 'float32'))
        P.array_write(x, 0, arr)
        P.array_write(x * 2, P.to_tensor(np.asarray(1, 'int64')), arr)
        assert P.array_length(arr) == 2
        np.testing.assert_allclose(np.asarray(P.array_read(arr, 1).numpy()),
                                   [2.])
        with pytest.raises(IndexError, match='past the array length'):
            P.array_write(x, 5, arr)
        assert P.array_length(P.create_array('float32', [x, x])) == 2


@pytest.mark.parametrize('opts', [{}, {'precision': 2},
                                  {'precision': 3, 'sci_mode': True},
                                  {'threshold': 5, 'edgeitems': 2},
                                  {'linewidth': 30, 'sci_mode': False}],
                         ids=['default', 'precision', 'sci', 'threshold',
                              'linewidth'])
def test_to_string_gives_the_reference_string(opts):
    x = (RS.randn(3, 4) * 100).astype(np.float32)
    try:
        for P in (paddle_tpu, paddle_tpu_torch):
            P.set_printoptions(**opts)
        want = paddle_tpu.tensor.to_string(paddle_tpu.to_tensor(x))
        got = paddle_tpu_torch.tensor.to_string(
            paddle_tpu_torch.to_tensor(x))
        assert got == want
        r = paddle_tpu.to_tensor(x)
        r.stop_gradient = False
        p = paddle_tpu_torch.to_tensor(x, stop_gradient=False)
        assert paddle_tpu_torch.tensor.to_string(p, 'Param') == \
            paddle_tpu.tensor.to_string(r, 'Param')
    finally:
        for P in (paddle_tpu, paddle_tpu_torch):
            P.set_printoptions(precision=8, threshold=1000, edgeitems=3,
                               linewidth=80)
            P.tensor.to_string.__globals__['_options']['sci_mode'] = None


def test_to_string_of_int_and_bf16():
    for arr in (np.arange(6, dtype=np.int32).reshape(2, 3),
                np.array([True, False])):
        assert paddle_tpu_torch.tensor.to_string(
            paddle_tpu_torch.to_tensor(arr)) == paddle_tpu.tensor.to_string(
            paddle_tpu.to_tensor(arr))
    s = paddle_tpu_torch.tensor.to_string(
        paddle_tpu_torch.to_tensor(np.ones(2, np.float32), 'bfloat16'))
    assert 'dtype=bfloat16' in s and '[1., 1.]' in s


# -- dtypes, places, the top level --------------------------------------------

def test_dtype_names_and_conversion():
    P = paddle_tpu_torch
    for name in ('float16', 'bfloat16', 'float32', 'int8', 'int16',
                 'int32', 'uint8', 'complex64'):
        assert P.tensor.cast(P.ones([2]), name).dtype == getattr(P, name)
        assert str(getattr(paddle_tpu, name).__name__ if hasattr(
            getattr(paddle_tpu, name), '__name__') else name)
    assert P.bool is torch.bool and P.bool_ is torch.bool
    assert isinstance(P.float32, P.dtype)
    from paddle_tpu_torch.core import dtype as D
    assert D.convert_dtype('int64') is torch.int64
    assert D.convert_dtype(np.float16) is torch.float16
    assert D.is_floating('bfloat16') and not D.is_floating('int32')
    assert D.is_integer('uint8') and not D.is_integer('bool')
    with pytest.raises(ValueError):
        D.convert_dtype('float8')


def test_64_bit_names_keep_their_width():
    """The reference aliases int64/float64/complex128 to 32 bits without
    x64 (``paddle_tpu/core/dtype.py:24-29``); the port keeps the true
    widths.  Values agree where both represent them (ROADMAP Queue 3)."""
    P = paddle_tpu_torch
    assert P.int64 is torch.int64 and P.float64 is torch.float64
    assert np.dtype(paddle_tpu.int64) == np.int32
    assert np.dtype(paddle_tpu.float64) == np.float32
    big = np.array([1.5, 2.25], np.float64)
    r = paddle_tpu.to_tensor(big, dtype='float64')
    p = P.to_tensor(big, dtype='float64')
    assert str(r.dtype) == 'float32' and p.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(r.numpy()), p.numpy())


def test_default_dtype_drives_creation():
    P = paddle_tpu_torch
    assert P.get_default_dtype() is torch.float32
    try:
        P.set_default_dtype('float64')
        assert P.to_tensor([1.5]).dtype == torch.float64
        assert P.zeros([2]).dtype == torch.float64
        assert P.full([2], 3).dtype == torch.float64
        assert P.rand([2]).dtype == torch.float64
        assert P.to_tensor(np.ones(2, np.float32)).dtype == torch.float32
        paddle_tpu.set_default_dtype('float64')    # float32 in the ref
        assert str(paddle_tpu.zeros([2]).dtype) == 'float32'
        with pytest.raises(TypeError):
            P.set_default_dtype('int32')
    finally:
        P.set_default_dtype('float32')
        paddle_tpu.set_default_dtype('float32')


def test_places_and_device_queries():
    P = paddle_tpu_torch
    assert P.CPUPlace() == paddle_tpu_torch.CUDAPinnedPlace()
    assert P.CUDAPlace(1) == P.TPUPlace(1) == P.XPUPlace(1) == P.NPUPlace(1)
    assert repr(P.CUDAPlace(0)) == 'Place(gpu:0)'
    assert repr(paddle_tpu.CPUPlace()) == repr(P.CPUPlace())
    assert P.get_place() == P.CPUPlace()
    t = P.to_tensor([1.0], place=P.CPUPlace())
    assert t.device.type == 'cpu'
    assert P.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert not P.is_compiled_with_npu()
    assert isinstance(P.is_compiled_with_xpu(), bool)
    assert P.device_count() >= 1
    v = P.get_cudnn_version()
    assert v is None or isinstance(v, int)
    P.set_device(P.CPUPlace())
    assert P.get_device() == 'cpu'


def test_grad_switches_and_modes():
    P = paddle_tpu_torch
    assert P.in_dynamic_mode() and P.in_dygraph_mode()
    assert P.is_grad_enabled()
    with P.no_grad():
        assert not P.is_grad_enabled()
    P.set_grad_enabled(False)
    assert not P.is_grad_enabled()
    P.set_grad_enabled(True)
    assert P.Tensor is torch.Tensor and P.VarBase is torch.Tensor
    assert P.Parameter is torch.nn.Parameter
    np.testing.assert_array_equal(
        P.crop_tensor(P.to_tensor(M), [2, 2], [1, 1]).numpy(), M[1:3, 1:3])


def test_every_reference_name_is_ported():
    ported = set(paddle_tpu_torch.tensor.__all__)
    assert set(paddle_tpu.tensor.__all__) <= ported
    assert len(set(paddle_tpu.tensor.__all__)) == 262
    # DataParallel and ComplexTensor came with the training strategies'
    # slice; the static mode is ROADMAP item 12
    later = {'enable_static', 'disable_static', 'enable_dygraph',
             'disable_dygraph'}
    missing = set(paddle_tpu.__all__) - set(paddle_tpu_torch.__all__)
    assert missing == later, missing - later
    for name in paddle_tpu_torch.__all__:
        assert hasattr(paddle_tpu_torch, name), name


# the reference's Tensor methods that torch.Tensor has under the same name
# and that give the same result called with no argument on a float matrix
SAME_METHODS = {
    'abs', 'all', 'amax', 'amin', 'angle', 'any', 'argmax', 'argmin',
    'argsort', 'asinh', 'atan', 'ceil', 'ceil_', 'cholesky', 'conj', 'cos',
    'cosh', 'count_nonzero', 'deg2rad', 'det', 'diff', 'digamma', 'erf',
    'exp', 'exp_', 'expm1', 'flatten', 'floor', 'floor_', 'frac', 'inverse',
    'isfinite', 'isinf', 'isnan', 'lgamma', 'log', 'log10', 'log1p', 'log2',
    'logical_not', 'max', 'mean', 'min', 'mode', 'nan_to_num', 'nanmean',
    'nansum', 'nonzero', 'norm', 'numel', 'prod', 'qr', 'rad2deg',
    'reciprocal', 'reciprocal_', 'rot90', 'round', 'round_', 'rsqrt',
    'rsqrt_', 'sgn', 'sign', 'sin', 'sinh', 'slogdet', 'sqrt', 'sqrt_',
    'square', 'squeeze', 'squeeze_', 'std', 'sum', 't', 'tan', 'tanh',
    'tanh_', 'tolist', 'trace', 'trunc', 'unbind', 'unique', 'var',
}


def _reference_methods_bare(names, x):
    """Each reference method of ``names`` called with no argument on
    ``x``, as a list of outputs; the ones that trace run together under
    one ``jax.jit`` (one compile), the others eagerly, and a method that
    raises (it needs an argument) is left out."""
    import jax
    from paddle_tpu.core.autograd import no_grad
    from paddle_tpu.core.tensor import Tensor

    def call(n, v):
        with no_grad():
            out = getattr(Tensor._from_value(v), n)()
        return [o.value if isinstance(o, Tensor) else o
                for o in (out if isinstance(out, (tuple, list)) else [out])]
    traced, eager = [], []
    for n in names:
        try:
            shapes = jax.eval_shape(lambda v, n=n: call(n, v), x)
        except Exception:
            eager.append(n)
            continue
        leaves = jax.tree_util.tree_leaves(shapes)
        (traced if leaves and all(hasattr(a, 'dtype') for a in leaves)
         else eager).append(n)
    out = {n: [np.asarray(v) for v in vs] for n, vs in jax.jit(
        lambda v: {n: call(n, v) for n in traced})(x).items()}
    for n in eager:
        try:
            w = getattr(paddle_tpu.to_tensor(x), n)()
        except Exception:       # a call that needs an argument
            continue
        out[n] = [np.asarray(v.numpy()) if hasattr(v, 'numpy') else v
                  for v in (w if isinstance(w, (tuple, list)) else [w])]
    return out


def test_which_reference_methods_torch_tensors_share():
    """The port grafts nothing onto ``torch.Tensor``.  Of the reference's
    methods, the ones a ``torch.Tensor`` has under the same name and
    that give the same result on a float matrix called bare are
    ``SAME_METHODS`` (ROADMAP Queue 3 lists the rest)."""
    from paddle_tpu.tensor import _METHOD_MODULES, _SKIP_METHODS
    names = sorted({n for m in _METHOD_MODULES for n in m.__all__
                    if n not in _SKIP_METHODS and hasattr(torch.Tensor, n)})
    x = (np.abs(SPD) / 10 + 0.1).astype(np.float32)
    same = set()
    for n, want in _reference_methods_bare(names, x).items():
        try:
            got = getattr(torch.tensor(x), n)()
        except Exception:       # a call that needs an argument
            continue
        got = [g.numpy() if isinstance(g, torch.Tensor) else g
               for g in (got if isinstance(got, (tuple, list)) else [got])]
        try:
            ok = len(want) == len(got) and all(
                np.allclose(np.asarray(a, np.float64),
                            np.asarray(b, np.float64), rtol=1e-5, atol=1e-6)
                and np.shape(a) == np.shape(b) for a, b in zip(got, want))
        except (TypeError, ValueError):
            ok = False
        if ok:
            same.add(n)
    assert same == SAME_METHODS, (sorted(same - SAME_METHODS),
                                  sorted(SAME_METHODS - same))
    assert not hasattr(torch.Tensor, 'astype')
    assert not hasattr(torch.Tensor, 'stop_gradient')
