"""A shared oracle for the tensor-library parity files: one case runs a
function of the package (``fn(P, *tensors)``) on the JAX package and on
the port with the same numpy inputs, and holds outputs and gradients.

Float inputs take a gradient; every float output gets a seeded random
cotangent, and the input gradients are compared.  The reference's case
runs, forward and vjp, under one ``jax.jit`` (one compile; eager, each
primitive compiles on its own), or on its own tape (``paddle_tpu.grad``)
where it does not trace, an op whose output shape depends on the data;
the port's through ``torch.autograd.grad``.
Integer and bool outputs must be equal and of the same kind (the
port's indices are int64 where the reference's are int32).
"""
import numpy as np
import torch

import paddle_tpu
import paddle_tpu_torch

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _ref_tensor(a, grad):
    t = paddle_tpu.to_tensor(a)
    if grad:
        t.stop_gradient = False
    return t


def _port_tensor(a, grad):
    t = paddle_tpu_torch.to_tensor(a, place='cpu')
    if grad:
        t.requires_grad_(True)
    return t


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    if hasattr(t, 'numpy'):
        return np.asarray(t.numpy())
    return np.asarray(t)


def _kind(a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return 'b'
    return 'f' if np.issubdtype(a.dtype, np.inexact) else 'i'


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f'{what}: shape {got.shape} vs ' \
        f'{want.shape}'
    if _kind(want) != 'f':
        assert _kind(got) == _kind(want), f'{what}: dtype {got.dtype} ' \
            f'vs {want.dtype}'
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=tol, atol=tol,
                               err_msg=what)


def _ref_jitted(fn, arrays, diff, pout):
    """The reference's outputs and input gradients from one ``jax.jit``
    of ``fn`` (forward and vjp), or None where it does not trace (an op
    whose output shape depends on the data)."""
    import jax
    from paddle_tpu.core.autograd import no_grad
    from paddle_tpu.core.tensor import Tensor

    def fwd(*vals):
        with no_grad():
            outs = _flat(fn(paddle_tpu, *[Tensor._from_value(v)
                                          for v in vals]))
        return [o.value if isinstance(o, Tensor) else o for o in outs]
    vals = [jax.numpy.asarray(a) for a in arrays]
    try:
        shapes = jax.eval_shape(fwd, *vals)
    except Exception:
        return None
    if len(shapes) != len(pout) or not all(
            hasattr(s, 'dtype') for s in shapes):
        return None
    didx = [i for i, d in enumerate(diff) if d]
    rs = np.random.RandomState(5)
    pairs = [k for k, (r, p) in enumerate(zip(shapes, pout))
             if np.issubdtype(r.dtype, np.inexact)
             and isinstance(p, torch.Tensor) and p.requires_grad]
    cots = [np.asarray(rs.randn(*shapes[k].shape), np.float32)
            for k in pairs]

    def both(vals, cots):
        def part(*dv):
            full = list(vals)
            for i, v in zip(didx, dv):
                full[i] = v
            outs = fwd(*full)
            return [outs[k] for k in pairs]
        outs = fwd(*vals)
        if not pairs or not didx:
            return outs, []
        _, vjp = jax.vjp(part, *[vals[i] for i in didx])
        return outs, vjp([c.astype(outs[k].dtype)
                          for c, k in zip(cots, pairs)])
    try:
        outs, grads = jax.jit(both)(vals, [jax.numpy.asarray(c)
                                           for c in cots])
    except Exception:
        return None
    return outs, pairs, cots, grads


def check(fn, arrays, grad=True, tol=FWD_TOL, grad_tol=GRAD_TOL, what=''):
    """Run ``fn`` on both packages; returns the port's outputs."""
    arrays = [np.asarray(a) for a in arrays]
    diff = [grad and _kind(a) == 'f' for a in arrays]
    pin = [_port_tensor(a, d) for a, d in zip(arrays, diff)]
    pout = _flat(fn(paddle_tpu_torch, *pin))
    jitted = _ref_jitted(fn, arrays, diff, pout)
    if jitted is None:
        return _check_eager(fn, arrays, diff, pin, pout, tol, grad_tol, what)
    rout, pairs, cots, rg = jitted
    for i, (r, p) in enumerate(zip(rout, pout)):
        close(_host(p), _host(r), tol, f'{what} output {i}')
    if not pairs or not any(diff):
        return pout
    pins = [t for t, d in zip(pin, diff) if d]
    pg = torch.autograd.grad([pout[k] for k in pairs], pins,
                             [torch.tensor(c).to(pout[k].dtype)
                              for c, k in zip(cots, pairs)],
                             allow_unused=True)
    for i, (a, b) in enumerate(zip(pg, rg)):
        want = _host(b)
        got = np.zeros_like(want) if a is None else _host(a)
        close(got, want, grad_tol, f'{what} d input {i}')
    return pout


def _check_eager(fn, arrays, diff, pin, pout, tol, grad_tol, what):
    rin = [_ref_tensor(a, d) for a, d in zip(arrays, diff)]
    rout = _flat(fn(paddle_tpu, *rin))
    assert len(rout) == len(pout), f'{what}: {len(pout)} outputs, want ' \
        f'{len(rout)}'
    for i, (r, p) in enumerate(zip(rout, pout)):
        close(_host(p), _host(r), tol, f'{what} output {i}')
    if not any(diff):
        return pout
    rs = np.random.RandomState(5)
    pairs = [(r, p, np.asarray(rs.randn(*np.shape(_host(r))), np.float32))
             for r, p in zip(rout, pout)
             if _kind(_host(r)) == 'f' and isinstance(p, torch.Tensor)
             and p.requires_grad]
    if not pairs:
        return pout
    rins = [t for t, d in zip(rin, diff) if d]
    pins = [t for t, d in zip(pin, diff) if d]
    rg = paddle_tpu.grad([r for r, _, _ in pairs], rins,
                         grad_outputs=[paddle_tpu.to_tensor(c)
                                       for _, _, c in pairs],
                         allow_unused=True)
    pg = torch.autograd.grad([p for _, p, _ in pairs], pins,
                             [torch.tensor(c).to(p.dtype)
                              for _, p, c in pairs], allow_unused=True)
    for i, (a, b) in enumerate(zip(pg, rg)):
        want = np.zeros(tuple(pins[i].shape), np.float32) if b is None \
            else _host(b)
        got = np.zeros_like(want) if a is None else _host(a)
        close(got, want, grad_tol, f'{what} d input {i}')
    return pout
