"""Helpers shared by the port's sequence-layer tests: a JAX layer's
output and gradients by ``jax.value_and_grad`` (op by op, its
parameters swapped in through ``load_functional_state``), the port
layer's by ``backward``, weights carried from the JAX layer into the
port's through numpy, and the comparison."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu_torch.convert import load_numpy_state


def jt(a):
    return JaxTensor._from_value(jnp.asarray(a))


def np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if isinstance(t, JaxTensor):
        t = t.value
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def cot(shape, seed=7):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def host_state(jm):
    """The JAX layer's state dict as numpy (its keys)."""
    return {k: np.array(v.value) for k, v in jm.state_dict().items()}


def load_from_jax(pm, jm):
    """``pm`` (a port layer) with ``jm``'s weights."""
    load_numpy_state(pm, host_state(jm))
    return pm


def _first(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def jax_vjp(jm, fn, inputs, seed=7, jit=False):
    """(output, {param: grad}, [input grads]) of ``sum(first(fn(jm,
    *inputs)) * cot)`` by jax.value_and_grad (under one ``jax.jit`` with
    ``jit``: one compile instead of one a primitive); float ``inputs``
    (numpy) get gradients, others are constants."""
    params, buffers = jm.functional_state()
    diff = [i for i, a in enumerate(inputs)
            if np.issubdtype(np.asarray(a).dtype, np.floating)]

    def f(p, *xs):
        saved = jm.functional_state()
        jm.load_functional_state(p, buffers)
        args = list(inputs)
        for i, x in zip(diff, xs):
            args[i] = x
        try:
            with jax_no_grad():
                out = _first(fn(jm, *[JaxTensor._from_value(jnp.asarray(a))
                                      for a in args])).value
        finally:
            jm.load_functional_state(*saved)
        return jnp.sum(out.astype(jnp.float32) * cot(out.shape, seed)), out

    vg = jax.value_and_grad(f, argnums=tuple(range(len(diff) + 1)),
                            has_aux=True)
    (_, out), grads = (jax.jit(vg) if jit else vg)(
        params, *[jnp.asarray(inputs[i]) for i in diff])
    return (np32(out), {k: np32(v) for k, v in grads[0].items()},
            [np32(g) for g in grads[1:]])


def port_vjp(pm, fn, inputs, seed=7):
    """The same for the port layer ``pm``."""
    ts = []
    for a in inputs:
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point():
            t.requires_grad_(True)
        ts.append(t)
    pm.zero_grad(set_to_none=True)
    out = _first(fn(pm, *ts))
    (out.float() * torch.from_numpy(cot(out.shape, seed))).sum().backward()
    return (np32(out), {n: np32(p.grad) for n, p in pm.named_parameters()
                        if p.grad is not None},
            [np32(t.grad) for t in ts if t.is_floating_point()])


def close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f'{what}: max |diff| / scale {err:.3e} > {tol}'


def compare_vjp(jm, pm, fn, inputs, tol, grad_tol, skip=(), jit=False):
    """Output, every parameter gradient (those named in ``skip`` only
    checked to be tiny on both sides: their true value is 0) and every
    float input's gradient of ``fn`` on the JAX and port layers (the JAX
    side under ``jax.jit`` with ``jit``)."""
    want, jg, jxg = jax_vjp(jm, fn, inputs, jit=jit)
    got, pg, pxg = port_vjp(pm, fn, inputs)
    assert got.shape == want.shape, (got.shape, want.shape)
    close(got, want, tol, 'output')
    largest = max((float(np.abs(g).max()) for g in jg.values()),
                  default=0.0)
    for name, w in jg.items():
        if name.endswith(tuple(skip)):
            for g in (w, pg.get(name, np.zeros(1))):
                assert float(np.abs(g).max()) <= grad_tol * largest, name
            continue
        close(pg[name], w, grad_tol, f'gradient {name}')
    for i, (g, w) in enumerate(zip(pxg, jxg)):
        close(g, w, grad_tol, f'input gradient {i}')
