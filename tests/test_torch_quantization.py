"""The port's weight-only PTQ against the JAX package's, on the CPU.

``ops/int8_matmul.py``'s six functions, ``Int8DynamicLinear`` and
``Int4DynamicLinear``, the model-wide swap (``quantize_for_serving``)
and ``quant_post_dynamic`` take the same numpy inputs in both packages.
Tolerances: int8 and packed int4 bytes, scales and the int32
accumulator exactly equal; f32 outputs within 1 f32 ulp of the JAX
package's (the same operations in the same order; XLA may contract the
rescale and the bias into one FMA); bf16 outputs within 1 bf16 ulp (the
f32 values round to bf16 on either side of a tie); greedy token streams
of the quantized ``gpt_tiny`` exactly equal, through ``generate`` and
through the serving engine.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops import int8_matmul as jops
from paddle_tpu.serving import ServeConfig as JaxServeConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops import int8_matmul as pops
from paddle_tpu_torch.serving import Request, ServeConfig, ServingEngine

MODEL_KW = dict(num_layers=2, hidden_size=128, num_heads=4, max_seq_len=64)
# one prompt bucket, chunks 1-2: a small JAX module set
SERVE_KW = dict(block_size=4, max_slots=2, decode_span=2,
                prompt_buckets=(8,), batch_buckets=(1, 2),
                prefill_batch=2, max_model_len=32, temperature=0.0)
# the (rows, in, out) shapes: a decode batch, odd ``in`` rows (int4
# pads), a prefill batch of GPT's fc
SHAPES = [(8, 64, 96), (5, 33, 24), (48, 128, 512)]


def _ulps(got, want, dtype):
    """Each |got - want| in units of ``dtype``'s spacing at |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mant = {np.float32: 23, 'bfloat16': 7}[dtype]
    exp = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
    return np.abs(got - want) / 2.0 ** (exp - mant)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)
                      if jnp.asarray(a).dtype == jnp.bfloat16 else a)


def _inputs(rows, hin, hout, seed, dtype='float32'):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, hin).astype(np.float32)
    w = (rs.randn(hin, hout) / np.sqrt(hin)).astype(np.float32)
    b = (0.1 * rs.randn(hout)).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if dtype == 'bfloat16':
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    return x, w, b, jx, px


def _jax_accumulator(jx, jwq):
    """The reference's activation quantization and int32 dot
    (``dynamic_int8_matmul``'s first lines), for the accumulator."""
    xf = jx.astype(jnp.float32)
    x_scale = jnp.maximum(jnp.max(jnp.abs(xf)) / 127.0, 1e-12)
    x_q = jnp.clip(jnp.round(xf / x_scale), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, jwq, (((x_q.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(x_q), float(x_scale), np.asarray(acc)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_int8_weights_accumulator_and_output_match_jax(shape, dtype):
    x, w, b, jx, px = _inputs(*shape, seed=sum(shape), dtype=dtype)
    jw, pw = jnp.asarray(w), torch.from_numpy(w)
    if dtype == 'bfloat16':
        jw, pw = jw.astype(jnp.bfloat16), pw.to(torch.bfloat16)
    jwq, jws = jops.quantize_weight_int8(jw)
    pwq, pws = pops.quantize_weight_int8(pw)
    assert pwq.dtype == torch.int8 and pws.dtype == torch.float32
    np.testing.assert_array_equal(pwq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(pws.numpy(), np.asarray(jws))
    jxq, jxs, jacc = _jax_accumulator(jx, jwq)
    pxq, pxs = pops.quantize_activation(px)
    np.testing.assert_array_equal(pxq.numpy(), jxq)
    assert float(pxs) == jxs
    pacc = pops.int_dot(pxq, pwq)
    assert pacc.dtype == torch.int32
    np.testing.assert_array_equal(pacc.numpy(), jacc)
    out_dtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    want = jops.dynamic_int8_matmul(jx, jwq, jws, bias=jnp.asarray(b),
                                    out_dtype=out_dtype)
    got = pops.dynamic_int8_matmul(
        px, pwq, pws, bias=torch.from_numpy(b),
        out_dtype=torch.bfloat16 if dtype == 'bfloat16' else torch.float32)
    assert _ulps(_np(got), _jnp(want), np.float32 if dtype == 'float32'
                 else 'bfloat16').max() <= 1.0


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_int4_packing_unpacking_and_output_match_jax(shape):
    rows, hin, hout = shape
    x, w, b, jx, px = _inputs(*shape, seed=7 + rows)
    jpk, jws = jops.quantize_weight_int4_packed(jnp.asarray(w))
    ppk, pws = pops.quantize_weight_int4_packed(torch.from_numpy(w))
    assert ppk.dtype == torch.uint8 and ppk.shape == ((hin + 1) // 2, hout)
    np.testing.assert_array_equal(ppk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(pws.numpy(), np.asarray(jws))
    unpacked = pops.unpack_int4(ppk, hin)
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(jops.unpack_int4(jpk, hin)))
    assert unpacked.dtype == torch.int8
    assert int(unpacked.min()) >= -7 and int(unpacked.max()) <= 7
    want = jops.dynamic_int4_matmul(jx, jpk, jws, rows=hin,
                                    bias=jnp.asarray(b),
                                    out_dtype=jnp.float32)
    got = pops.dynamic_int4_matmul(px, ppk, pws, rows=hin,
                                   bias=torch.from_numpy(b),
                                   out_dtype=torch.float32)
    assert _ulps(got.numpy(), np.asarray(want), np.float32).max() <= 1.0


def test_unpack_sign_extends_every_nibble_as_the_reference():
    """All 256 byte values: both nibbles sign-extended as ``sext``."""
    packed = np.arange(256, dtype=np.uint8).reshape(128, 2)
    got = pops.unpack_int4(torch.from_numpy(packed), 256)
    want = jops.unpack_int4(jnp.asarray(packed), 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_artifact_scale_and_batched_input_match_jax():
    scale = np.random.RandomState(3).rand(16).astype(np.float32) + 0.5
    for qmax in (127, 7):
        np.testing.assert_array_equal(
            pops.artifact_to_matmul_scale(scale, qmax).numpy(),
            np.asarray(jops.artifact_to_matmul_scale(scale, qmax)))
    # a [B, T, H] input: one scale over all of it, padding rows included
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, 32).astype(np.float32)
    x[1, 2] = 0.0
    w = rs.randn(32, 16).astype(np.float32)
    jwq, jws = jops.quantize_weight_int8(jnp.asarray(w))
    pwq, pws = pops.quantize_weight_int8(torch.from_numpy(w))
    want = jops.dynamic_int8_matmul(jnp.asarray(x), jwq, jws,
                                    out_dtype=jnp.float32)
    got = pops.dynamic_int8_matmul(torch.from_numpy(x), pwq, pws,
                                   out_dtype=torch.float32)
    assert got.shape == (2, 3, 16)
    assert _ulps(got.numpy(), np.asarray(want), np.float32).max() <= 1.0


def _linear_pair(hin, hout, seed):
    rs = np.random.RandomState(seed)
    w = (rs.randn(hin, hout) / np.sqrt(hin)).astype(np.float32)
    b = (0.1 * rs.randn(hout)).astype(np.float32)
    jl = jnn.Linear(hin, hout)
    jl.load_functional_state({'weight': jnp.asarray(w),
                              'bias': jnp.asarray(b)})
    pl = pnn.Linear(hin, hout, device='cpu')
    with torch.no_grad():
        pl.weight.copy_(torch.from_numpy(w))
        pl.bias.copy_(torch.from_numpy(b))
    return jl, pl


@pytest.mark.parametrize('kind', ['Int8DynamicLinear', 'Int4DynamicLinear'])
def test_dynamic_linear_layers_match_jax(kind):
    jl, pl = _linear_pair(96, 40, seed=5)
    jlayer = getattr(jq, kind)(jl)
    player = getattr(pq, kind)(pl)
    assert (player.in_features, player.out_features) == (96, 40)
    assert player.bias is pl.bias
    jbuf = dict(jlayer.named_buffers())
    pbuf = dict(player.named_buffers())
    assert set(pbuf) == set(jbuf) == {'qweight', 'wscale'}
    for name in pbuf:
        np.testing.assert_array_equal(pbuf[name].numpy(),
                                      np.asarray(jbuf[name].value))
    assert set(player.state_dict()) == {'qweight', 'wscale', 'bias'}
    x = np.random.RandomState(6).randn(3, 5, 96).astype(np.float32)
    want = np.asarray(jlayer(paddle.to_tensor(x)).value)
    with torch.no_grad():
        got = player(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 40)
    assert _ulps(got.numpy(), want, np.float32).max() <= 1.0


def _swapped(model):
    return sorted(n for n, m in model.named_modules()
                  if type(m).__name__.endswith('DynamicLinear'))


def _jax_swapped(model):
    return sorted(n for n, m in model.named_sublayers()
                  if type(m).__name__.endswith('DynamicLinear'))


@pytest.mark.parametrize('mode', ['int8', 'int4'])
def test_quantize_for_serving_swaps_the_reference_set(mode):
    jm = jax_gpt_tiny(**MODEL_KW)
    pm = gpt_tiny(device='cpu', **MODEL_KW)
    assert jq.quantize_for_serving(jm, mode) is jm
    assert pq.quantize_for_serving(pm, mode) is pm
    assert pm._ptq_mode == jm._ptq_mode == mode
    # qkv, proj, fc, proj in each block; the tied head is no Linear
    want = [f'gpt.blocks.{i}.{name}' for i in range(2)
            for name in ('attn.proj', 'attn.qkv', 'mlp.fc', 'mlp.proj')]
    assert _swapped(pm) == _jax_swapped(jm) == sorted(want)
    assert pm.gpt.wte.weight.dtype == torch.float32
    jp, jb = jm.functional_state()
    assert set(pm.state_dict()) == set(jp) | set(jb)
    with pytest.raises(ValueError, match='expected one of'):
        pq.quantize_for_serving(gpt_tiny(device='cpu', num_layers=1), 'int3')


def test_swap_filter_and_no_linear_errors_match_jax():
    net = torch.nn.Sequential(pnn.Linear(8, 8, device='cpu'),
                              pnn.Linear(8, 4, device='cpu'))
    pq.quantize_dynamic_int8(net,
                             layer_filter=lambda n, l: l.weight.shape[1] != 4)
    assert [type(m).__name__ for m in net] == ['Int8DynamicLinear', 'Linear']
    with pytest.raises(ValueError) as perr:
        pq.quantize_dynamic_int8(torch.nn.Sequential(torch.nn.ReLU()))
    with pytest.raises(ValueError) as jerr:
        jq.quantize_dynamic_int8(jnn.Sequential(jnn.ReLU()))
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError) as perr:
        pq.quantize_dynamic_int4(pnn.Linear(8, 8, device='cpu'))
    with pytest.raises(ValueError) as jerr:
        jq.quantize_dynamic_int4(jnn.Linear(8, 8))
    assert str(perr.value) == str(jerr.value)
    assert 'ROOT layer' in str(perr.value)


def test_quant_post_dynamic_matches_jax():
    """The per-tensor int8 artifact of every Linear and Conv2D."""
    rs = np.random.RandomState(8)
    arrays = {'0.weight': rs.randn(6, 3, 3, 3), '0.bias': rs.randn(6),
              '1.weight': rs.randn(12, 5), '1.bias': rs.randn(5)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    jnet = jnn.Sequential(jnn.Conv2D(3, 6, 3), jnn.Linear(12, 5))
    jnet.load_functional_state({k: jnp.asarray(v)
                                for k, v in arrays.items()})
    pnet = torch.nn.Sequential(pnn.Conv2D(3, 6, 3, device='cpu'),
                               pnn.Linear(12, 5, device='cpu'))
    convert.load_numpy_state(pnet, arrays)
    want = jq.quant_post_dynamic(jnet)
    got = pq.quant_post_dynamic(pnet)
    assert set(got) == set(want) == {'0.qweight', '0.scale', '1.qweight',
                                     '1.scale'}
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], want[key])


# -- gpt_tiny, quantized, end to end ------------------------------------------

@pytest.fixture(scope='module')
def weights():
    """gpt_tiny's numpy weights, LayerNorm and biases perturbed with
    seeded noise (so the affine parts are exercised)."""
    paddle.seed(7)
    jm = jax_gpt_tiny(**MODEL_KW)
    params, _ = jm.functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name:
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    return host


def _pair(host, mode):
    jm = jax_gpt_tiny(**MODEL_KW)
    jm.eval()
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    if mode is not None:
        jq.quantize_for_serving(jm, mode)
        pq.quantize_for_serving(pm, mode)
    return jm, pm


@pytest.mark.parametrize('mode', ['int8', 'int4'])
def test_quantized_gpt_tiny_generate_and_engine_match_jax(weights, mode):
    jm, pm = _pair(weights, mode)
    jp, jb = jm.functional_state()
    psd = pm.state_dict()
    for name, value in jb.items():
        np.testing.assert_array_equal(psd[name].numpy(), np.asarray(value))
    rs = np.random.RandomState(12)
    prompt = rs.randint(0, 128, (2, 6)).astype(np.int64)
    want = jm.generate(paddle.to_tensor(prompt), max_new_tokens=8,
                       temperature=0)
    got = pm.generate(prompt, max_new_tokens=8, temperature=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))
    # the engine on the already-quantized models (the config agrees)
    prompts = [rs.randint(0, 128, (int(t0),)).astype(np.int64)
               for t0 in (3, 8, 5, 7)]
    jeng = JaxServingEngine(jm, JaxServeConfig(**SERVE_KW, quantize=mode))
    peng = ServingEngine(pm, ServeConfig(**SERVE_KW, quantize=mode))
    jreqs = [jeng.submit(p, n) for p, n in zip(prompts, (5, 3, 6, 4))]
    preqs = [peng.submit(p, n) for p, n in zip(prompts, (5, 3, 6, 4))]
    jeng.run()
    assert peng.run()['audit'] == []
    for jr, pr in zip(jreqs, preqs):
        assert pr.state == Request.DONE, (pr.rid, pr.reason)
        assert pr.tokens == jr.tokens, pr.rid


def test_engine_quantizes_a_float_model_and_refuses_another_mode(weights):
    _, pm = _pair(weights, None)
    eng = ServingEngine(pm, ServeConfig(**SERVE_KW, quantize='int4'))
    assert pm._ptq_mode == 'int4' and eng.model is pm
    assert len(_swapped(pm)) == 8
    for quantize in ('int8', None):
        with pytest.raises(ValueError, match='already PTQ-quantized'):
            ServingEngine(pm, ServeConfig(**SERVE_KW, quantize=quantize))
    # the same mode again is accepted and swaps nothing more
    ServingEngine(pm, ServeConfig(**SERVE_KW, quantize='int4'))
    assert len(_swapped(pm)) == 8


def test_quantized_reference_buffers_load_into_the_port(weights):
    """A quantized JAX model's params and qweight/wscale buffers load
    into a port model quantized in the same mode from other weights;
    the port then gives the JAX model's greedy stream."""
    jm, _ = _pair(weights, 'int8')
    params, buffers = jm.functional_state()
    params = {k: np.asarray(v) for k, v in params.items()}
    buffers = {k: np.asarray(v) for k, v in buffers.items()}
    other = pq.quantize_for_serving(gpt_tiny(device='cpu', seed=3,
                                             **MODEL_KW), 'int8')
    convert.load_quantized_state(other, params, buffers)
    sd = other.state_dict()
    for name, value in buffers.items():
        assert sd[name].dtype == {np.dtype(np.int8): torch.int8,
                                  np.dtype(np.float32): torch.float32}[
                                      value.dtype]
        np.testing.assert_array_equal(sd[name].numpy(), value)
    prompt = np.random.RandomState(13).randint(0, 128, (1, 5)).astype(
        np.int64)
    want = jm.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                       temperature=0)
    np.testing.assert_array_equal(
        other.generate(prompt, 6, temperature=0).numpy(),
        np.asarray(want.value))
    with pytest.raises(ValueError, match='not quantized'):
        convert.load_quantized_state(gpt_tiny(device='cpu', **MODEL_KW),
                                     params, buffers)
    int4 = pq.quantize_for_serving(gpt_tiny(device='cpu', **MODEL_KW),
                                   'int4')
    with pytest.raises(ValueError, match="'int4'"):
        convert.load_quantized_state(int4, params, buffers)
