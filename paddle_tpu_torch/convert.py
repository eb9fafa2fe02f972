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

Under tensor parallelism each rank holds shards (``fleet.meta_
parallel``): ``shard_state(params, mesh, rank, model)`` cuts the full
numpy parameters to rank ``rank``'s along the mesh's ``tp`` axis,
following the spec that ``model``'s layers declare for each parameter
(``shard_specs``, from ``parallel.api.collect_param_shardings``) and
its sections (a fused qkv's columns are three sections, so a rank holds
whole heads of q, k and v); ``gather_state`` joins the ranks' shards
back into the full parameters.
"""
import numpy as np
import torch

from .core.device import resolve_device

__all__ = ['state_from_numpy', 'load_numpy_state', 'load_quantized_state',
           'load_train_state', 'shard_state', 'gather_state',
           'shard_specs']

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64,
           np.dtype(np.int8): torch.int8,
           np.dtype(np.uint8): torch.uint8}


def state_from_numpy(params, device=None):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``.
    A torch tensor (a checkpoint's host copy, bf16 included) is copied
    to ``device`` as it is."""
    device = resolve_device(device)
    out = {}
    for name, arr in params.items():
        if torch.is_tensor(arr):
            out[name] = arr.detach().to(device, copy=True)
            continue
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


def load_train_state(trainer, params, opt_state, step, buffers=None):
    """Carry a ``ParallelTrainer``'s state into the port's trainer: a
    JAX trainer's, so a run started in one package continues in the
    other, or a checkpoint's (``ParallelTrainer.restore_checkpoint``).

    ``params`` is the trainer's ``params`` (``{name: array}``),
    ``opt_state`` its ``opt_state`` (``{name: {'moment1', 'moment2'}}``
    for Adam/AdamW), ``step`` its ``_step_no`` and ``buffers`` its
    ``buffers`` (BatchNorm's statistics; needed where the model has
    any), as numpy or torch tensors.  The weights and buffers load into
    ``trainer.model`` and the slots into the optimizer's accumulators,
    written in place where they exist (a captured ``step_fused`` graph
    goes on reading them), and both step counters are set, so the next
    ``trainer.step`` is update number ``step + 1``.  Raises on a missing
    or extra name and on a shape or dtype mismatch."""
    model, opt = trainer.model, trainer.optimizer
    load_numpy_state(model, params, buffers)
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


def shard_specs(model):
    """``{parameter name: (sharded dim, sections)}`` of ``model``'s
    parameters split over ``tp`` (the others are replicated)."""
    from .parallel.api import collect_param_shardings
    out = {}
    groups = {}
    for prefix, mod in model.named_modules():
        for name, g in (getattr(mod, '_shard_groups', {}) or {}).items():
            groups[f'{prefix}.{name}' if prefix else name] = g
    for name, spec in collect_param_shardings(model).items():
        if spec and 'tp' in spec:
            out[name] = (list(spec).index('tp'), groups.get(name, 1))
    return out


def _specs(specs):
    if isinstance(specs, torch.nn.Module):
        return shard_specs(specs)
    return dict(specs)


def _tp(mesh, rank):
    coords = dict(zip(mesh.axis_names, (int(c) for c in np.argwhere(
        mesh.devices == rank)[0])))
    return mesh.shape.get('tp', 1), coords.get('tp', 0)


def shard_state(params, mesh, rank, specs):
    """Rank ``rank``'s shards of the full numpy ``params`` on ``mesh``
    (module docstring).  ``specs``: the model the parameters belong to
    (its layers' specs, built on any device and at any world size) or
    a dict from ``shard_specs``."""
    from .distributed.fleet.meta_parallel import take_shard
    tp, r = _tp(mesh, rank)
    specs = _specs(specs)
    out = {}
    for name, value in params.items():
        value = np.asarray(value)
        if name in specs and tp > 1:
            dim, groups = specs[name]
            value = np.ascontiguousarray(
                take_shard(value, dim, tp, r, groups))
        out[name] = value
    return out


def gather_state(shards, mesh, specs):
    """The full parameters from ``shards``, every rank's state (numpy,
    indexed by global rank): the ``tp`` ranks of the first ``dp`` row
    joined, the replicated ones taken from rank 0.  ``specs`` as for
    ``shard_state``."""
    from .distributed.collective import _comm_lists
    from .distributed.fleet.meta_parallel import join_shards
    tp = mesh.shape.get('tp', 1)
    row = _comm_lists(mesh, ('tp',))[0] if tp > 1 else [0]
    first = shards[int(row[0])]
    specs = _specs(specs)
    out = {}
    for name, value in first.items():
        if name in specs and tp > 1:
            dim, groups = specs[name]
            out[name] = join_shards([np.asarray(shards[int(r)][name])
                                     for r in row], dim, groups)
        else:
            out[name] = np.asarray(value)
    return out
