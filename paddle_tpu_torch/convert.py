"""Moving weights and training state from the JAX package into the port.

The two packages share state-dict keys and shapes (``Linear.weight``
is ``[in, out]`` in both), so converting the JAX model's
``functional_state()`` — taken to numpy by the caller — is
``torch.from_numpy`` of a copy plus checks; a JAX trainer's optimizer
slots and step count carry over the same way (``load_train_state``).
A weight-only PTQ model's int8 or packed int4 buffers load the same way
(``load_quantized_state``).  Each function raises on a missing or extra
key and on a shape or dtype mismatch.

Any model built from the ``nn`` layers loads this way from one set of
numpy arrays, and the port's ``state_dict()`` taken to numpy loads into
the JAX layer's ``set_state_dict``: the keys are the reference's and
every layout is kept as it is, ``Linear.weight`` ``[in, out]`` and the
recurrent weights ``[gates * hidden, in]`` (``weight_ih_l0``, ...; the
LSTM's gates in the order i, f, g, o).  A non-persistable buffer (a
position table) stays out of both.
"""
import numpy as np
import torch

from .core.device import resolve_device

__all__ = ['state_from_numpy', 'load_numpy_state', 'load_quantized_state',
           'load_train_state']

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64,
           np.dtype(np.int8): torch.int8,
           np.dtype(np.uint8): torch.uint8}


def state_from_numpy(params, device=None):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``."""
    device = resolve_device(device)
    out = {}
    for name, arr in params.items():
        arr = np.asarray(arr)
        if arr.dtype not in _DTYPES:
            raise TypeError(f'{name}: unsupported dtype {arr.dtype}')
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def load_numpy_state(module, params, buffers=None):
    """Copy ``params`` (numpy, the JAX model's keys) into ``module``'s
    parameters and buffers, written in place.  ``buffers``: the JAX
    model's ``functional_state()[1]`` (BatchNorm's ``_mean`` and
    ``_variance``), merged with ``params`` first."""
    if buffers:
        both = sorted(set(params) & set(buffers))
        if both:
            raise KeyError(f'names in both params and buffers: {both}')
        params = {**params, **buffers}
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f'state mismatch: missing {missing}, extra {extra}')
    device = next(iter(own.values())).device if own else None
    state = state_from_numpy(params, device=device)
    for name, src in state.items():
        dst = own[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f'{name}: shape {tuple(src.shape)} != '
                             f'{tuple(dst.shape)}')
        if src.dtype != dst.dtype:
            raise ValueError(f'{name}: dtype {src.dtype} != {dst.dtype}')
    with torch.no_grad():
        for name, src in state.items():
            own[name].copy_(src)
    return module


def load_quantized_state(module, params, buffers):
    """Load a PTQ-quantized JAX model's ``functional_state()`` (its
    ``params`` and its ``qweight``/``wscale`` buffers, as numpy) into a
    port model quantized in the same mode (``quantize_for_serving``):
    int8 ``qweight`` for 'int8', packed uint8 for 'int4'.  Raises if
    the port model is not quantized, on a buffer of the other mode, and
    as ``load_numpy_state`` does."""
    mode = getattr(module, '_ptq_mode', None)
    if mode is None:
        raise ValueError('the port model is not quantized: call '
                         'quantization.quantize_for_serving(model, mode) '
                         'with the JAX model\'s mode first')
    want = np.dtype(np.int8 if mode == 'int8' else np.uint8)
    for name, arr in buffers.items():
        if name.endswith('.qweight') and np.asarray(arr).dtype != want:
            raise ValueError(f'{name}: {np.asarray(arr).dtype} weights do '
                             f'not belong to a {mode!r} model')
    return load_numpy_state(module, params, buffers)


def load_train_state(trainer, params, opt_state, step):
    """Carry a JAX ``ParallelTrainer``'s state into the port's trainer,
    so a run started in one package continues in the other.

    ``params`` is the JAX trainer's ``params`` (``{name: array}``),
    ``opt_state`` its ``opt_state`` (``{name: {'moment1', 'moment2'}}``
    for Adam/AdamW) and ``step`` its ``_step_no``, all as numpy.  The
    weights load into ``trainer.model``, the slots become the
    optimizer's accumulators, and both step counters are set, so the
    next ``trainer.step`` is update number ``step + 1``.  Raises on a
    missing or extra name and on a shape or dtype mismatch."""
    model, opt = trainer.model, trainer.optimizer
    load_numpy_state(model, params)
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(opt_state))
    extra = sorted(set(opt_state) - set(named))
    if missing or extra:
        raise KeyError(f'optimizer state mismatch: missing {missing}, '
                       f'extra {extra}')
    accumulators = {}
    for name, slots in opt_state.items():
        p = named[name]
        state = state_from_numpy(slots, device=p.device)
        for slot, t in state.items():
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(f'{name}.{slot}: {tuple(t.shape)} '
                                 f'{t.dtype} != {tuple(p.shape)} {p.dtype}')
        live = opt._accumulators.get(id(p))
        if live is not None and set(live) == set(state):
            # into the live slots: a captured step goes on reading them
            with torch.no_grad():
                for slot, t in state.items():
                    live[slot].copy_(t)
            state = live
        accumulators[id(p)] = state
    opt._accumulators = accumulators
    opt._global_step = trainer._step_no = int(step)
    return trainer
