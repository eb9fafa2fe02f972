"""Weight and spectral normalisation as forward pre-hooks (counterpart
of ``paddle_tpu/nn/utils``).

``weight_norm(layer)`` replaces the parameter ``weight`` by
``weight_g`` (its norm over every axis but ``dim``, kept as size-1
axes; a scalar for ``dim=None``) and ``weight_v`` (its value), and
before each forward sets ``layer.weight = v * (g / |v|)``, a tensor
that carries both gradients.  ``remove_weight_norm`` turns the last
such weight back into the parameter ``weight``.

``spectral_norm(layer)`` moves ``weight`` to ``weight_orig`` and keeps
the power iteration's ``u`` in the buffer ``weight_u``, drawn once from
the device's generator (``core.rng``) and normalised; before each
forward it runs ``n_power_iterations`` rounds on the detached matrix
(``weight`` with ``dim`` first, the rest flattened; each vector divided
by ``max(|.|, eps)``), writes ``u`` back in place, and sets
``layer.weight = weight_orig / sigma`` with ``sigma = u . W v`` a
constant to autograd, as in the reference (PyTorch's own
``spectral_norm`` differentiates through sigma).  The state-dict keys
are the reference's, ``weight_u`` included, so ``convert.
load_numpy_state`` carries the reference's ``u`` across, and with it
the same sigma.  Under recompute (``core.recompute``) the
recomputation takes the forward's ``u`` and sigma and writes nothing.
"""
import torch
from torch import nn

from ...amp import amp_cast
from ...core import rng
from ...core.recompute import forward_value, recomputing

__all__ = ['weight_norm', 'remove_weight_norm', 'spectral_norm']


def _norm_except(v, dim):
    if dim is None:
        return v.square().sum().sqrt()
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return v.square().sum(dim=axes, keepdim=True).sqrt()


def weight_norm(layer, name='weight', dim=0):
    w = getattr(layer, name).detach()
    layer.register_parameter(name + '_g', nn.Parameter(
        _norm_except(w, dim).clone()))
    layer.register_parameter(name + '_v', nn.Parameter(w.clone()))
    del layer._parameters[name]

    def hook(mod, inputs):
        v, g = amp_cast('weight_norm', getattr(mod, name + '_v'),
                        getattr(mod, name + '_g'))
        setattr(mod, name, v * (g / _norm_except(v, dim)))

    layer._wn_handle = layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name='weight'):
    if hasattr(layer, '_wn_handle'):
        layer._wn_handle.remove()
    w = layer.__dict__.pop(name, None)
    if w is not None:
        layer.register_parameter(name, nn.Parameter(w.detach().clone()))
    for suffix in ('_g', '_v'):
        layer._parameters.pop(name + suffix, None)
    return layer


def spectral_norm(layer, name='weight', n_power_iterations=1, eps=1e-12,
                  dim=None):
    dim = 0 if dim is None else dim
    w = getattr(layer, name)
    rows = w.shape[dim]
    u0 = torch.randn(rows, generator=rng.generator(w.device),
                     device=w.device)
    layer.register_buffer(name + '_u', u0 / torch.linalg.vector_norm(u0))

    def hook(mod, inputs):
        wp = mod._parameters.get(name)
        if wp is None:
            wp = getattr(mod, name + '_orig')
        buf = getattr(mod, name + '_u')

        @torch.no_grad()
        def power():
            wmat = wp.detach().movedim(dim, 0).reshape(rows, -1)
            u = buf
            for _ in range(n_power_iterations):
                v = wmat.T @ u
                v = v / torch.clamp_min(torch.linalg.vector_norm(v), eps)
                u = wmat @ v
                u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
            return u, u @ wmat @ v

        # a recomputation reads the forward's u and sigma, not the u the
        # forward moved, and moves nothing
        u, sigma = forward_value(power)
        if not recomputing():
            with torch.no_grad():
                buf.copy_(u)
        if name in mod._parameters:
            mod.register_parameter(name + '_orig',
                                   mod._parameters.pop(name))
        ww, = amp_cast('spectral_norm', wp)
        ww = ww.to(torch.promote_types(ww.dtype, sigma.dtype))
        mod.__dict__[name] = ww / sigma

    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer
