"""The kernels as ``torch.library`` operators.

A hand-written kernel is launched through ``ctypes`` from a Python
wrapper (``_build.Kernel.launch``), which reads data pointers.  Under
``torch.export`` a forward runs on fake tensors, which have no data: a
launch cannot be traced, and a wrapper that branched on the device
would trace its plain twin into the graph instead of the kernel.  So
every forward kernel a forward pass can reach is an operator of the
``paddle_tpu_torch`` namespace (``paddle_tpu_torch::<name>``) with a
fixed schema:

    fused_layer_norm(x, gamma?, beta?, eps) -> (y, mean, rstd)
    flash_attention_fwd(q, k, v, causal, scale) -> (o, lse)
    fused_softmax(x) -> y
    fused_softmax_masked(x, mask) -> y
    linear_gelu(x, w, b?, approximate) -> y

and so is every backward kernel, for a trace that runs nothing
(``profiler.op_summary`` runs a training step on fake tensors, so its
backward reaches these too; on real tensors the backward launches its
kernels directly, without the dispatcher's cost on every training step:
``traced``):

    flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale) -> dq
    flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        -> (dk, dv)
    linear_gelu_bwd(x, w, b?, dy, approximate) -> dz

Its CUDA implementation is the wrapper's launch (``_fwd_cuda`` of the
module named below, which checks, picks the design and counts the
launch as before), its CPU implementation the plain twin, and its fake
implementation gives the outputs' shapes and dtypes, so an exported
graph holds one node of the operator per launch and a loaded artifact
launches the kernels.  The implementations are looked up by name in
their module at each call, so what a module's attribute holds is what
runs.

Registration happens when this module is imported (``paddle_tpu_torch.
ops`` imports it); it imports ``torch`` only, so it may come first.
"""
import importlib

import torch

__all__ = ['NAMESPACE', 'op', 'CAUSAL_MODE', 'traced']

NAMESPACE = 'paddle_tpu_torch'

# flash's causal modes by the schema's int (``flash_attention._causal_code``)
CAUSAL_MODE = {0: False, 1: True, 2: 'strict'}

_LIB = torch.library.Library(NAMESPACE, 'DEF')


def _calls(module, attr, adapt=None):
    """An implementation that calls ``paddle_tpu_torch.ops.<module>.
    <attr>`` (imported at the first call) on its tensors made
    contiguous, its arguments first passed through ``adapt``.  An
    exported graph may hand an operator a view where the trace had a
    copy (a ``reshape`` that copied at the traced batch of 2 and is a
    view at a batch of 1), and the kernels take contiguous rows."""
    mod = None

    def run(*args):
        nonlocal mod
        if mod is None:
            mod = importlib.import_module(f'{__package__}.{module}')
        args = tuple(a.contiguous() if isinstance(a, torch.Tensor) else a
                     for a in args)
        if adapt is not None:
            args = adapt(*args)
        return getattr(mod, attr)(*args)
    return run


def _define(name, schema, module, cuda, cpu, fake, adapt=None):
    _LIB.define(f'{name}{schema}')
    _LIB.impl(name, _calls(module, cuda, adapt), 'CUDA')
    _LIB.impl(name, _calls(module, cpu, adapt), 'CPU')
    torch.library.register_fake(f'{NAMESPACE}::{name}', fake, lib=_LIB)


def _ln_fake(x, gamma, beta, eps):
    n = x.shape[0]
    return (torch.empty_like(x), x.new_empty((n,), dtype=torch.float32),
            x.new_empty((n,), dtype=torch.float32))


def _flash_fake(q, k, v, causal, scale):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _flash_args(q, k, v, causal, scale):
    return q, k, v, CAUSAL_MODE[causal], scale


def _softmax_fake(x, mask=None):
    return torch.empty_like(x)


def _gelu_fake(x, w, b, approximate):
    return x.new_empty((x.shape[0], w.shape[1]))


def _dq_fake(q, k, v, do, lse, delta, causal, scale):
    return torch.empty_like(q)


def _dkv_fake(q, k, v, do, lse, delta, causal, scale):
    return torch.empty_like(k), torch.empty_like(v)


def _flash_bwd_args(q, k, v, do, lse, delta, causal, scale):
    return q, k, v, do, lse, delta, CAUSAL_MODE[causal], scale


def _gelu_bwd_fake(x, w, b, dy, approximate):
    return x.new_empty((x.shape[0], w.shape[1]))


_define('fused_layer_norm',
        '(Tensor x, Tensor? gamma, Tensor? beta, float eps) '
        '-> (Tensor, Tensor, Tensor)',
        'fused_norm', '_fwd_cuda', '_reference', _ln_fake)
_define('flash_attention_fwd',
        '(Tensor q, Tensor k, Tensor v, int causal, float scale) '
        '-> (Tensor, Tensor)',
        'flash_attention', '_fwd_cuda', '_fwd_twin', _flash_fake,
        adapt=_flash_args)
_define('fused_softmax', '(Tensor x) -> Tensor', 'fused_softmax',
        '_fwd_cuda', '_reference', _softmax_fake,
        adapt=lambda x: (x, None))
_define('fused_softmax_masked', '(Tensor x, Tensor mask) -> Tensor',
        'fused_softmax', '_fwd_cuda', '_reference', _softmax_fake)
_define('linear_gelu',
        '(Tensor x, Tensor w, Tensor? b, bool approximate) -> Tensor',
        'fused_gelu_linear', '_fwd_cuda', '_reference', _gelu_fake)
_FLASH_BWD = ('(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, '
              'Tensor delta, int causal, float scale)')
_define('flash_attention_bwd_dq', f'{_FLASH_BWD} -> Tensor',
        'flash_attention', '_bwd_dq_cuda', '_bwd_dq_reference', _dq_fake,
        adapt=_flash_bwd_args)
_define('flash_attention_bwd_dkv', f'{_FLASH_BWD} -> (Tensor, Tensor)',
        'flash_attention', '_bwd_dkv_cuda', '_bwd_dkv_reference', _dkv_fake,
        adapt=_flash_bwd_args)
_define('linear_gelu_bwd',
        '(Tensor x, Tensor w, Tensor? b, Tensor dy, bool approximate) '
        '-> Tensor',
        'fused_gelu_linear', '_bwd_cuda', '_dz_reference', _gelu_bwd_fake)

def traced(t):
    """True for a fake tensor (a trace that runs nothing): the backward
    kernels' callers take their operators for it, and launch directly
    for a real tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def op(name):
    """The overload packet ``torch.ops.paddle_tpu_torch.<name>``."""
    return getattr(getattr(torch.ops, NAMESPACE), name)
