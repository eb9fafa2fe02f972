"""Grad mode and ``grad`` (counterpart of ``paddle_tpu/core/autograd.py``).

The reference runs its own tape over ``jax.vjp``; the port's tape is
PyTorch's autograd, so grad mode is PyTorch's: ``no_grad``,
``enable_grad`` and ``set_grad_enabled`` are its context managers
(each also works as a ``@no_grad()`` decorator, as the reference's
``contextmanager``s do) and ``is_grad_enabled`` reads it.

``grad`` keeps the reference's rules (``paddle_tpu/core/autograd.py:
316-467``): it returns a list and leaves every ``.grad`` alone,
``retain_graph`` defaults to ``create_graph``, ``only_inputs=False``
raises, an input the outputs do not reach (or one that takes no
gradient) raises unless ``allow_unused``, which gives None, and
``no_grad_vars`` cuts the flow at those tensors.  With
``create_graph`` the result differentiates to any order.

``kernel_backward`` and ``composed_backward`` are how the port's
hand-written kernels take a second order.  The kernels' gradients carry
no graph of their own, and none has a derivative of its own backward:
``kernel_backward`` runs a backward's kernels for the first-order
values and differentiates the plain composition for the next order;
``composed_backward`` computes a plain backward from the plain
composition under grad mode (a ``create_graph`` pass).
"""
import torch

__all__ = ['is_grad_enabled', 'no_grad', 'enable_grad',
           'set_grad_enabled', 'grad']

is_grad_enabled = torch.is_grad_enabled
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The sum of the gradients of ``outputs`` with respect to each of
    ``inputs``, as a list (None for an unreached input under
    ``allow_unused``); ``grad_outputs`` seeds them (None: ones)."""
    if not only_inputs:
        raise NotImplementedError('only_inputs=False is not supported, '
                                  'as in the reference')
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = _as_list(grad_outputs)
    if len(grad_outputs) != len(outputs):
        raise ValueError('grad_outputs must match outputs in length')
    seeds = [torch.ones_like(o) if g is None else torch.as_tensor(
        g, dtype=o.dtype, device=o.device)
        for o, g in zip(outputs, grad_outputs)]
    if retain_graph is None:
        retain_graph = create_graph
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    if len(live) < len(inputs) and not allow_unused:
        raise RuntimeError('one of the inputs takes no gradient '
                           '(stop_gradient); pass allow_unused=True to get '
                           'None for it')
    # a cut tensor passes zeros on: what flows through it is dropped
    hooks = [t.register_hook(torch.zeros_like)
             for t in (no_grad_vars or []) if t.requires_grad]
    roots = [(o, s) for o, s in zip(outputs, seeds) if o.requires_grad]
    try:
        got = torch.autograd.grad(
            [o for o, _ in roots], [inputs[i] for i in live],
            [s for _, s in roots], retain_graph=retain_graph,
            create_graph=create_graph,
            allow_unused=True) if live and roots else []
    finally:
        for h in hooks:
            h.remove()
    out = [None] * len(inputs)
    for i, g in zip(live, got):
        out[i] = g
    if not allow_unused and any(g is None for g in out):
        raise RuntimeError('one of the inputs is unreachable from outputs; '
                           'pass allow_unused=True to get None instead')
    return out


def _leaf(t):
    """``t`` cut from its graph as a new leaf that takes a gradient (a
    float tensor), or ``t`` itself (None, an integer tensor)."""
    if isinstance(t, torch.Tensor) and (t.is_floating_point()
                                        or t.is_complex()):
        return t.detach().requires_grad_()
    return t


def _vjp(plain, n, idx):
    """``vjp(*inputs, *grads)``: the gradients of ``plain(*inputs)``
    paired with ``grads`` for the inputs ``idx`` names (zeros where none
    reaches), with their graph.  It runs on leaves: one input that is
    another's ancestor in the caller's graph would otherwise take that
    path twice, once here and once from the engine."""
    def vjp(*a):
        xs, gs = a[:n], a[n:]
        with torch.enable_grad():
            outs = plain(*xs)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, gs)
                     if g is not None and o.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], [xs[i] for i in idx],
                [g for _, g in pairs], create_graph=True,
                allow_unused=True) if pairs else [None] * len(idx)
        return tuple(torch.zeros_like(xs[i]) if g is None else g
                     for i, g in zip(idx, got))
    return vjp


def _on_leaves(fn, args):
    """``fn``'s values at ``args`` cut to leaves, without their graph."""
    with torch.enable_grad():
        out = fn(*[_leaf(t) for t in args])
    return tuple(o.detach() for o in out)


def composed_backward(plain, inputs, needs, grads):
    """The gradients of ``plain(*inputs)`` (a plain PyTorch composition,
    outputs paired with ``grads``; a None grad drops its output) for the
    inputs ``needs`` marks, None for the others.

    A kernel's ``autograd.Function.backward`` calls this when it runs
    under grad mode, i.e. inside ``grad(..., create_graph=True)`` or
    ``backward(create_graph=True)``.  The result is a node of the graph
    whose inputs are ``inputs`` and ``grads``: it is computed from the
    plain composition on leaves cut from them, and differentiated the
    same way, one order up, so it is exact to any order.  No
    hand-written kernel has a derivative of its own backward."""
    idx = [i for i, n in enumerate(needs) if n]
    out = [None] * len(needs)
    if idx and any(g is not None for g in grads):
        vjp = _vjp(plain, len(inputs), idx)
        got = kernel_backward(lambda *a: _on_leaves(vjp, a), vjp,
                              *inputs, *grads)
        for i, g in zip(idx, got if isinstance(got, tuple) else (got,)):
            out[i] = g
    return tuple(out)


class _KernelBackward(torch.autograd.Function):
    """``fast(*inputs)`` forward, the vjp of ``plain(*inputs)``
    backward."""

    @staticmethod
    def forward(ctx, fast, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return fast(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + composed_backward(
            ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:], grads)


def kernel_backward(fast, plain, *inputs):
    """``fast(*inputs)``: a backward's kernel launches, always the
    source of the first-order values.  Under grad mode (a
    ``create_graph`` pass) the result is a node whose own derivative is
    that of ``plain(*inputs)``, the same function in plain PyTorch, so
    the next order goes through the plain composition; outside grad
    mode it is a plain call of ``fast``."""
    return _KernelBackward.apply(fast, plain, *inputs)
