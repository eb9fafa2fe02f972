"""Six faults the port had against the reference, each repaired and held
to the JAX package here on the same numpy inputs (ROADMAP Queue 3, items
1-6; every case failed before the repair).

1. ``tensor.scale`` on an integer or bool tensor follows the
   reference's weakly typed scalars: a float scalar makes float32, an
   int keeps the integer dtype (bool becomes int32); float inputs keep
   the rounding of the scalars to their dtype.
2. ``topk`` takes the lowest index among equal values, as ``lax.top_k``
   does, and so does the beam step of ``BeamSearchDecoder``.
3. ``tensor.sum`` has the reference's signature ``(x, axis, dtype,
   keepdim, name)``, and an int32 or bool sum without ``dtype`` is
   int32.
4. ``F.linear``, ``F.dropout`` and ``F.layer_norm`` take ``name``.
5. ``where(cond)`` without ``x`` and ``y`` is ``nonzero(cond)``, and
   ``nonzero`` (with ``as_tuple``) is ported.
6. ``PagedKVCache(..., dtype=)`` makes its pools in that dtype.

And six calls that raised in the port where the reference returns a
value (ROADMAP Queue 3, repaired with slice 17): ``mean`` of an integer
or bool tensor, ``argmax`` of a bool tensor, ``logical_and``/``or``/
``xor`` with a Python scalar, ``gather`` with an int index and ``tile``
with an int.  ``argmax``'s indices are int64 in the port (the declared
``dtype``) and int32 in the reference (JAX without x64): the values are
held, the dtype is the documented difference.

Results and dtypes are held exactly (integer results, selections and
f32 products of exactly representable values), floats within 1 f32 ulp
where the two packages multiply in another order.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as F


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _np(t):
    return np.asarray(t.numpy() if torch.is_tensor(t) else t)


def _same(got, want):
    """Equal values and equal dtype names (torch's int32 is numpy's)."""
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


# -- 1. scale ----------------------------------------------------------
SCALE_CASES = [
    ('int32', [1, 2, 3], dict(scale=0.5)),
    ('int32', [1, 2, 3], dict(scale=2.0, bias=0.5)),
    ('int32', [1, 2, 3], dict(scale=3, bias=1)),
    ('int32', [1, 2, 3], dict(scale=2, bias=1.5, bias_after_scale=False)),
    ('bool', [True, False, True], dict(scale=-1)),
    ('bool', [True, False, True], dict(scale=-1, bias=0)),
    ('bool', [True, False, True], dict(scale=2.5)),
    ('float32', [0.1, -2.5, 3.25], dict(scale=0.3, bias=0.7)),
    ('float32', [0.1, -2.5, 3.25], dict(scale=3, bias=1,
                                         bias_after_scale=False)),
]


@pytest.mark.parametrize('dtype,values,kw', SCALE_CASES,
                         ids=lambda v: str(v))
def test_scale_follows_the_references_weak_types(dtype, values, kw):
    x = np.asarray(values, dtype=dtype)
    want = np.asarray(jpaddle.scale(jpaddle.to_tensor(x), **kw).numpy())
    _same(paddle.scale(torch.from_numpy(x), **kw), want)


def test_scale_bool_by_minus_one_is_minus_one():
    """The default bias 0.0 is a float, so the reference's result is
    float32 -1 where the bool is set."""
    got = paddle.scale(torch.tensor([True, False]), -1)
    assert got.dtype == torch.float32 and got.tolist() == [-1.0, 0.0]
    got = paddle.scale(torch.tensor([True, False]), -1, 0)
    assert got.dtype == torch.int32 and got.tolist() == [-1, 0]


def test_scale_keeps_the_rounding_of_16_bit_floats():
    """bf16 input: the scalars round to bf16 first, as the reference's
    weakly typed constants do."""
    x = np.asarray([1.0, 3.0, -7.5], np.float32)
    got = paddle.scale(torch.from_numpy(x).bfloat16(), 0.1, 0.3)
    want = jpaddle.scale(jpaddle.to_tensor(x).astype('bfloat16'), 0.1, 0.3)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.numpy()).astype(np.float32))


# -- 2. topk ties ------------------------------------------------------
TIED = [
    np.asarray([[2., 2., 2., 2.]], np.float32),
    np.asarray([[1., 3., 3., 0., 3.], [5., 5., 1., 5., 5.]], np.float32),
    np.asarray([[0., -1., -1., 0., -1., 0.]], np.float32),
]


@pytest.mark.parametrize('largest', [True, False])
@pytest.mark.parametrize('k', [1, 2, 3])
@pytest.mark.parametrize('case', range(len(TIED)))
def test_topk_takes_the_lowest_index_among_ties(case, k, largest):
    x = TIED[case]
    jv, ji = jpaddle.topk(jpaddle.to_tensor(x), k, largest=largest)
    pv, pi = paddle.topk(torch.from_numpy(x), k, largest=largest)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv.numpy()))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji.numpy()))
    assert pi.dtype == torch.int64


def test_topk_ties_along_another_axis():
    x = np.asarray([[1., 4.], [4., 4.], [4., 0.]], np.float32)
    jv, ji = jpaddle.topk(jpaddle.to_tensor(x), 2, axis=0)
    pv, pi = paddle.topk(torch.from_numpy(x), 2, axis=0)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji.numpy()))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv.numpy()))


def test_topk_of_the_four_equal_values_is_zero_one():
    _, idx = paddle.topk(torch.tensor([[2., 2., 2., 2.]]), 2)
    assert idx.tolist() == [[0, 1]]


def test_beam_step_breaks_ties_as_the_reference():
    """Equal-scoring candidates of a beam step: the beams, parents and
    tokens the reference's ``lax.top_k`` picks."""
    from paddle_tpu_torch.nn.decode import BeamSearchDecoder
    from paddle_tpu.nn.decode import BeamSearchDecoder as JBeam

    class Cell:
        def __init__(self, logits):
            self.logits = logits

        def __call__(self, inputs, states):
            return self.logits, states

    B, K, V = 2, 3, 4
    # every beam gives every token the same score: all K*V candidates tie
    logits = np.zeros((B * K, V), np.float32)
    state0 = np.zeros((B, 1), np.float32)
    outs = []
    for pkg, cls, wrap in ((paddle, BeamSearchDecoder, torch.from_numpy),
                           (jpaddle, JBeam, jpaddle.to_tensor)):
        dec = cls(Cell(wrap(logits)), start_token=1, end_token=2,
                  beam_size=K)
        init_inputs, init_states, _ = dec.initialize(wrap(state0))
        out, states, _, _ = dec.step(0, init_inputs, init_states)
        outs.append([np.asarray(t.numpy() if hasattr(t, 'numpy') else t)
                     for t in (out.predicted_ids, out.parent_ids,
                               states.log_probs)])
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got.astype(want.dtype), want)


# -- 3. sum ------------------------------------------------------------
@pytest.mark.parametrize('dtype', ['int32', 'bool', 'float32'])
def test_sum_signature_and_integer_dtype(dtype):
    x = np.asarray([[1, 0, 3], [4, 5, 0]]).astype(dtype)
    jx, px = jpaddle.to_tensor(x), torch.from_numpy(x)
    for args, kw in [((), {}), ((0,), {}), ((0, None, True), {}),
                     ((1,), dict(keepdim=True)),
                     ((), dict(dtype='float32')),
                     (([0, 1],), dict(dtype='int32', keepdim=True))]:
        want = np.asarray(jpaddle.sum(jx, *args, **kw).numpy())
        _same(paddle.sum(px, *args, **kw), want)


def test_sum_keepdim_by_keyword_keeps_widedeeps_callers():
    """Wide&Deep's first-order term passes ``keepdim`` by keyword."""
    from paddle_tpu_torch.models import widedeep
    emb = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    got = widedeep._first_order(emb)
    assert got.shape == (2, 1) and got.dtype == torch.float32
    assert got[:, 0].tolist() == [66.0, 210.0]


# -- 4. name -----------------------------------------------------------
def test_linear_dropout_layer_norm_take_name():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    b = np.random.RandomState(2).randn(5).astype(np.float32)
    px = torch.from_numpy(x)
    want = np.asarray(JF.linear(jpaddle.to_tensor(x), jpaddle.to_tensor(w),
                                jpaddle.to_tensor(b), name='fc').numpy())
    got = F.linear(px, torch.from_numpy(w), torch.from_numpy(b), name='fc')
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    out = F.dropout(px, 0.5, None, False, 'upscale_in_train', name='d')
    np.testing.assert_array_equal(out.numpy(), x)
    want = np.asarray(JF.layer_norm(jpaddle.to_tensor(x), 4,
                                    name='ln').numpy())
    got = F.layer_norm(px, 4, name='ln')
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


# -- 5. where / nonzero ------------------------------------------------
NONZERO = [
    np.asarray([0, 3, 0, 1, 2], np.float32),
    np.asarray([[True, False, True], [False, False, True]]),
    np.zeros((2, 3), np.int32),
    np.asarray([[[1, 0], [0, 2]], [[0, 0], [3, 0]]], np.int64),
]


@pytest.mark.parametrize('as_tuple', [False, True])
@pytest.mark.parametrize('case', range(len(NONZERO)))
def test_nonzero_matches_the_reference(case, as_tuple):
    x = NONZERO[case]
    want = jpaddle.nonzero(jpaddle.to_tensor(x), as_tuple=as_tuple)
    got = paddle.nonzero(torch.from_numpy(x), as_tuple=as_tuple)
    if as_tuple:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, np.asarray(w.numpy()))
    else:
        _same(got, np.asarray(want.numpy()))


@pytest.mark.parametrize('case', range(len(NONZERO)))
def test_where_without_x_and_y_is_nonzero(case):
    x = NONZERO[case]
    want = jpaddle.where(jpaddle.to_tensor(x))
    _same(paddle.where(torch.from_numpy(x)), np.asarray(want.numpy()))


def test_where_with_x_and_y_still_selects():
    c = torch.tensor([True, False, True])
    got = paddle.where(c, torch.tensor([1., 2., 3.]), torch.tensor([9., 9.,
                                                                     9.]))
    assert got.tolist() == [1., 9., 3.]


# -- 6. PagedKVCache(dtype=) -------------------------------------------
@pytest.mark.parametrize('dtype', ['bfloat16', torch.bfloat16, None])
def test_paged_kv_cache_takes_the_pools_dtype(dtype):
    from paddle_tpu_torch.serving import PagedKVCache
    from paddle_tpu.serving.kv_cache import PagedKVCache as JCache
    import jax.numpy as jnp
    L, H, D, bs, nb = 2, 2, 8, 4, 6
    cache = PagedKVCache(L, H, D, block_size=bs, num_blocks=nb,
                         dtype=dtype, device='cpu')
    want_dt = torch.float32 if dtype is None else torch.bfloat16
    ref = JCache(L, H, D, block_size=bs, num_blocks=nb,
                 dtype=None if dtype is None else jnp.bfloat16)
    assert cache.dtype == want_dt
    for (k, v), (jk, jv) in zip(cache.pools, ref.pools):
        assert k.dtype == v.dtype == want_dt
        assert k.shape == tuple(jk.shape)
        nbytes = k.numel() * k.element_size()
        assert nbytes == jk.size * jk.dtype.itemsize
        assert nbytes == nb * H * bs * D * (4 if dtype is None else 2)


def test_bf16_pool_serves_paged_attention_as_the_reference():
    """A bf16 pool written and read through paged attention with f32
    queries: the reference promotes the bf16 keys and values to f32 in
    its einsums, and so does the port."""
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu.ops import paged_attention as JP
    import jax.numpy as jnp
    from paddle_tpu_torch.serving import PagedKVCache
    rs = np.random.RandomState(0)
    S, H, D, bs, nb = 2, 2, 8, 4, 6
    cache = PagedKVCache(1, H, D, block_size=bs, num_blocks=nb,
                         dtype='bfloat16', device='cpu')
    k_pool, v_pool = cache.pools[0]
    jk, jv = jnp.zeros(k_pool.shape, jnp.bfloat16), \
        jnp.zeros(v_pool.shape, jnp.bfloat16)
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    for pos in range(5):
        kn = rs.randn(S, H, D).astype(np.float32)
        vn = rs.randn(S, H, D).astype(np.float32)
        slots = np.asarray([pos, pos], np.int32)
        P.write_kv(k_pool, v_pool, torch.from_numpy(kn),
                   torch.from_numpy(vn), torch.from_numpy(tables),
                   torch.from_numpy(slots))
        jk, jv = JP.write_kv(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(tables), jnp.asarray(slots))
    np.testing.assert_array_equal(k_pool.float().numpy(),
                                  np.asarray(jk).astype(np.float32))
    q = rs.randn(S, H, D).astype(np.float32)
    lens = np.asarray([5, 3], np.int32)
    got = P.paged_attention(torch.from_numpy(q), k_pool, v_pool,
                            torch.from_numpy(tables), torch.from_numpy(lens))
    want = JP.paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                              jnp.asarray(lens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


# -- slice 17: six calls that raised -----------------------------------------
X6 = np.asarray([[1, -2, 3], [4, 5, -6]], np.int32)
B6 = np.asarray([[True, False, True], [False, False, True]])

RAISED_CASES = [
    ('mean', X6, lambda P, x: P.mean(x)),
    ('mean_axis1', X6, lambda P, x: P.mean(x, axis=1)),
    ('mean_bool', B6, lambda P, x: P.mean(x)),
    ('mean_bool_keepdim', B6, lambda P, x: P.mean(x, axis=1, keepdim=True)),
    ('logical_and_scalar', X6, lambda P, x: P.logical_and(x, 2)),
    ('logical_or_scalar', X6, lambda P, x: P.logical_or(x, 2)),
    ('logical_xor_scalar', X6, lambda P, x: P.logical_xor(x, 2)),
    ('logical_and_zero', X6, lambda P, x: P.logical_and(x, 0)),
    ('gather_int', X6, lambda P, x: P.gather(x, 1)),
    ('gather_int_axis1', X6, lambda P, x: P.gather(x, 1, axis=1)),
    ('gather_list', X6, lambda P, x: P.gather(x, [1, 0])),
    ('tile_int', X6, lambda P, x: P.tile(x, 2)),
]


@pytest.mark.parametrize('name,x,call', RAISED_CASES,
                         ids=[c[0] for c in RAISED_CASES])
def test_calls_that_raised_return_the_references_value(name, x, call):
    """Equal dtypes; equal values, a float mean within 1 f32 ulp (XLA
    multiplies by the reciprocal of the count, PyTorch divides)."""
    want = np.asarray(call(jpaddle, jpaddle.to_tensor(x)).numpy())
    got = _np(call(paddle, torch.from_numpy(x)))
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind == 'f':
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('axis', [1, 0, None])
def test_argmax_of_a_bool_tensor_takes_the_first_true(axis):
    want = np.asarray(jpaddle.argmax(jpaddle.to_tensor(B6), axis).numpy())
    got = paddle.argmax(torch.from_numpy(B6), axis)
    assert got.dtype == torch.int64         # int32 in JAX without x64
    np.testing.assert_array_equal(_np(got), want)


def test_scatter_nd_add_matches_the_reference():
    x = np.zeros([6], np.int64)
    idx = np.asarray([[1], [3], [1]], np.int64)
    upd = np.asarray([5, 7, 2], np.int64)
    want = np.asarray(jpaddle.tensor.manipulation.scatter_nd_add(
        jpaddle.to_tensor(x), jpaddle.to_tensor(idx),
        jpaddle.to_tensor(upd)).numpy())
    got = paddle.tensor.manipulation.scatter_nd_add(
        torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(upd))
    np.testing.assert_array_equal(_np(got), want)
    xf = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx2 = np.asarray([[0, 1], [2, 3], [0, 1]], np.int64)
    u2 = np.asarray([0.5, -1.0, 2.0], np.float32)
    want = np.asarray(jpaddle.tensor.manipulation.scatter_nd_add(
        jpaddle.to_tensor(xf), jpaddle.to_tensor(idx2),
        jpaddle.to_tensor(u2)).numpy())
    got = paddle.tensor.manipulation.scatter_nd_add(
        torch.from_numpy(xf), torch.from_numpy(idx2), torch.from_numpy(u2))
    _same(got, want)
