"""``paddle.autograd`` (counterpart of ``paddle_tpu/autograd/__init__.py``):
``grad``, ``backward``, ``PyLayer`` and ``PyLayerContext``.

``PyLayer`` is built over a ``torch.autograd.Function``: its forward
runs the user's ``forward`` with grad mode off, its backward the user's
``backward``.  The reference's double-grad rule holds: under
``create_graph`` a PyLayer's gradient is a leaf (its ``backward`` runs
with grad mode off), so ``grad((g1 * x).sum(), x)`` gives ``g1`` and
not what PyTorch's own Function would give through ``g1``'s graph
(``tests/test_autograd.py:293-318``).
"""
import torch

from ..core.autograd import grad  # noqa: F401

__all__ = ['grad', 'backward', 'PyLayer', 'PyLayerContext']


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Gradients of several roots in one pass, into the ``.grad`` of the
    leaves that take one; a None in ``grad_tensors`` seeds ones."""
    tensors = list(tensors) if isinstance(tensors, (list, tuple)) \
        else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    grad_tensors = list(grad_tensors) if isinstance(
        grad_tensors, (list, tuple)) else [grad_tensors]
    if len(grad_tensors) != len(tensors):
        raise ValueError('grad_tensors must match tensors in length')
    seeds = [torch.ones_like(t) if g is None else g
             for t, g in zip(tensors, grad_tensors)]
    torch.autograd.backward(tensors, seeds, retain_graph=retain_graph)


class PyLayerContext:
    """Carried from ``forward`` to ``backward``."""

    def __init__(self):
        self._saved = ()
        self.container = None

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved


class _Function(torch.autograd.Function):
    """One PyLayer call: ``args`` are the user's positional arguments."""

    @staticmethod
    def forward(ctx, layer, kwargs, info, *args):
        pctx = PyLayerContext()
        out = layer.forward(pctx, *args, **kwargs)
        single = not isinstance(out, (tuple, list))
        outs = (out,) if single else tuple(out)
        for o in outs:
            if not isinstance(o, torch.Tensor):
                raise TypeError('PyLayer.forward must return Tensor(s), '
                                f'got {type(o).__name__}')
        ctx.layer, ctx.pctx = layer, pctx
        ctx.tensor_pos = [i for i, a in enumerate(args)
                          if isinstance(a, torch.Tensor)]
        ctx.n_args = len(args)
        info['single'], info['container'] = single, type(out)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        with torch.no_grad():
            gs = ctx.layer.backward(ctx.pctx, *grads)
        gs = tuple(gs) if isinstance(gs, (tuple, list)) else (gs,)
        if len(gs) != len(ctx.tensor_pos):
            raise ValueError(
                f'{ctx.layer.__name__}.backward returned {len(gs)} grads '
                f'for {len(ctx.tensor_pos)} tensor inputs')
        out = [None] * ctx.n_args
        for i, g in zip(ctx.tensor_pos, gs):
            out[i] = None if g is None else torch.as_tensor(g).detach()
        return (None, None, None, *out)


class PyLayer:
    """A user-defined differentiable op::

        class cus_tanh(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.tanh(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                y, = ctx.saved_tensor()
                return dy * (1 - y * y)

        z = cus_tanh.apply(x)

    ``backward`` returns one gradient per tensor input of ``forward``
    (None for one that takes none)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError(
            'PyLayer subclasses must define a static forward()')

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            'PyLayer subclasses must define a static backward()')

    @classmethod
    def apply(cls, *args, **kwargs):
        kw_tensors = [k for k, v in kwargs.items()
                      if isinstance(v, torch.Tensor)]
        if kw_tensors:
            raise TypeError(
                f'PyLayer.apply: pass differentiable Tensors '
                f'positionally, not as keywords ({kw_tensors}): keyword '
                'tensors would silently drop their gradients')
        info = {}
        outs = _Function.apply(cls, kwargs, info, *args)
        if info['single']:
            return outs[0]
        return info['container'](outs)
