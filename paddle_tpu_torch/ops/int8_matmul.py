"""Dynamic-quantized int8 matmul for weight-only PTQ serving.

Counterpart of ``paddle_tpu/ops/int8_matmul.py``, with its scheme and
its arithmetic order: per-output-channel symmetric weight scales,
a per-tensor dynamic activation scale (abs-max / 127 over the whole
input, floored at 1e-12), round half to even, an int8 x int8 -> int32
product, then ``acc.float() * (x_scale * w_scale)``, the bias, and the
cast.  Done in this order, the int32 accumulator equals the JAX
package's exactly and the output agrees to within an f32 ulp.

The product is ``torch._int_mm``, where the reference's is a
``lax.dot_general`` with ``preferred_element_type=int32``: a library
dot in both packages (the reference has no Pallas kernel here).  On
the card ``_int_mm`` takes more than 16 rows, and K and N multiples of
8; fewer rows are padded with zero rows, which change neither the
int32 result of the real rows nor the abs-max.

Packed int4 weights hold two ``in`` rows per uint8 (even row in the low
nibble), a zero row padding an odd ``in``; they unpack to int8 and go
through the same product.
"""
import torch

__all__ = ['quantize_weight_int8', 'dynamic_int8_matmul',
           'quantize_weight_int4_packed', 'unpack_int4',
           'dynamic_int4_matmul', 'artifact_to_matmul_scale',
           'quantize_activation', 'int_dot']

_Q4MAX = 7.0
# torch._int_mm on CUDA needs more than this many rows
_INT_MM_MIN_ROWS = 16


def artifact_to_matmul_scale(scale, qmax=127):
    """A ``.quant`` artifact's per-channel ``(scale, qmax)`` (dequant
    there is ``q * scale / qmax``) as the combined multiplier this op
    takes (dequant here is ``q * w_scale``)."""
    return _div(torch.as_tensor(scale, dtype=torch.float32), float(qmax))


def _div(a, d):
    """``a / d`` by a divisor tensor: PyTorch's CUDA division by a Python
    number multiplies by its rounded reciprocal, one f32 ulp away from
    the true quotient that the CPU and the reference compute."""
    return a / torch.full_like(a, d)


def _channel_quantize(w, qmax):
    wf = w.float()
    scale = torch.clamp_min(_div(wf.abs().amax(dim=0), qmax), 1e-12)
    q = torch.clamp(torch.round(wf / scale[None, :]), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_weight_int8(w):
    """``[H, O]`` float -> (int8 ``[H, O]``, f32 scales ``[O]``),
    per-out-channel symmetric abs-max."""
    return _channel_quantize(torch.as_tensor(w), 127.0)


def quantize_activation(x):
    """(int8 ``x_q``, f32 0-d ``x_scale``): the dynamic per-tensor
    quantization of ``x`` over all of its elements."""
    xf = x.float()
    x_scale = torch.clamp_min(_div(xf.abs().amax(), 127.0), 1e-12)
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127)
    return x_q.to(torch.int8), x_scale


def int_dot(x_q, w_q):
    """int8 ``[..., K]`` x int8 ``[K, N]`` -> int32 ``[..., N]`` through
    ``torch._int_mm``; on the card a product of at most 16 rows is
    padded with zero rows (and the padding dropped)."""
    lead = x_q.shape[:-1]
    a = x_q.reshape(-1, x_q.shape[-1])
    m = a.shape[0]
    if a.is_cuda and m <= _INT_MM_MIN_ROWS:
        a = torch.nn.functional.pad(a, (0, 0, 0, 2 * _INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(a.contiguous(), w_q)
    return acc[:m].reshape(lead + (w_q.shape[1],))


def dynamic_int8_matmul(x, w_q, w_scale, bias=None,
                        out_dtype=torch.bfloat16):
    """``x [..., H]`` float @ dequant(``w_q [H, O]``) with dynamic
    per-tensor activation quantization: int8 x int8 -> int32, rescaled
    by ``x_scale * w_scale``, plus the bias, cast to ``out_dtype``."""
    x_q, x_scale = quantize_activation(x)
    acc = int_dot(x_q, w_q)
    out = acc.float() * (x_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def quantize_weight_int4_packed(w):
    """``[H, O]`` float -> (packed uint8 ``[ceil(H/2), O]``, f32 scales
    ``[O]``): the int4 grid (qmax 7), per-out-channel abs-max; even H
    row in the low nibble, odd in the high (a zero row pads an odd
    H)."""
    q, scale = _channel_quantize(torch.as_tensor(w), _Q4MAX)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1, q.shape[1]))], dim=0)
    lo = q[0::2].to(torch.uint8) & 0xF
    hi = q[1::2].to(torch.uint8) & 0xF
    return (hi << 4) | lo, scale


def unpack_int4(packed, rows):
    """uint8 ``[P, O]`` -> int8 ``[rows, O]``: split the nibbles, sign
    extend, interleave the H rows again."""
    def sext(v):
        v = v.to(torch.int8)
        return torch.where(v >= 8, v - 16, v)

    lo = sext(packed & 0xF)
    hi = sext((packed >> 4) & 0xF)
    q = torch.stack([lo, hi], dim=1).reshape(-1, packed.shape[1])
    return q[:rows]


def dynamic_int4_matmul(x, w_packed, w_scale, rows=None, bias=None,
                        out_dtype=torch.bfloat16):
    """``x [..., H]`` float @ dequant(int4-packed weight): the nibbles
    unpack to int8, then the product of :func:`dynamic_int8_matmul`.
    ``rows`` is H (needed when H is odd; defaults to ``2 *
    w_packed.shape[0]``)."""
    rows = int(rows) if rows is not None else 2 * w_packed.shape[0]
    return dynamic_int8_matmul(x, unpack_int4(w_packed, rows), w_scale,
                               bias=bias, out_dtype=out_dtype)
