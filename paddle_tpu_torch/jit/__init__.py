"""paddle_tpu_torch.jit (counterpart of ``paddle_tpu/jit``): dy2static,
``to_static``, ``save``/``load`` and the compat surface.

The reference captures a layer's forward as a pure function of
``(params, buffers, key, inputs)`` and hands it to ``jax.jit``, one
compiled XLA module per call signature, and ``save`` serialises that
module with ``jax.export``.  The port keeps the capture and changes the
two artifacts (port semantics):

- **``to_static``** runs the forward under ``no_grad`` as one CUDA
  graph per signature (``core.compile_cache.GraphModule``): the first
  call of a signature runs eagerly (the warm-up) and captures, later
  calls replay.  The signature is the positions of the tensor
  arguments, their shapes, dtypes and devices, ``repr`` of the other
  arguments, and ``training``.  The graph reads the layer's parameters
  where they live, so an optimizer's in-place update is seen; train
  mode updates BatchNorm's running statistics in place on every replay,
  and dropout draws fresh bits each replay (the device's generator is
  registered with the graph, ``core.rng``).  On the CPU the cache hands
  out the function itself.  Keyword calls and ``enable_to_static
  (False)`` run the dygraph function, as in the reference.  A tensor
  predicate of converted control flow is read on the host
  (``dy2static``), which a graph cannot do: a signature whose warm-up
  read one stays eager, and ``StaticFunction.modes()`` says so.  A
  capture that fails raises; nothing falls back quietly.  A CUDA graph
  cannot be serialised, so the reference's persistent compile cache has
  no counterpart.
- **``save``** exports the eval-mode forward with ``torch.export``, the
  parameters and buffers as inputs as in the reference's pure function.
  ``None``/-1 dims of the ``InputSpec``s become ``torch.export.Dim``s,
  one per axis index shared by every input that leaves that axis open
  (a batch of ids and its token types are one batch), traced at 2,
  since 0 and 1 specialise.  The hand-written kernels are the
  ``paddle_tpu_torch::*`` operators (``ops/_library.py``), so the
  exported graph holds one node per launch and a loaded artifact
  launches them.  ``<path>.pdmodel`` is the ``torch.export.save``
  archive and holds no weights; ``<path>.pdiparams`` is the reference's
  pickle, ``{'state': {'params', 'buffers'}, 'spec': [(shape, dtype,
  name)]}`` with numpy arrays under the same keys (a bfloat16 tensor,
  which numpy cannot hold, is kept as the tensor).
- **``load``** returns a ``TranslatedLayer`` that holds the state on its
  device and runs the exported module, as one CUDA graph per input
  signature on the card.

``functional_call(layer, params, buffers, args)`` runs a layer as a
function of the given parameters and buffers on
``torch.func.functional_call``: the layer's own tensors are left as
they were, and the buffers the call updates come back as
``new_buffers``.  ``key`` is the reference's PRNG key: an int seeds a
generator forked for the call, None draws from the device's generator.

``to_static(check=)`` (the reference's TPU lint) raises until the
analysis tier is ported (ROADMAP Queue 1 item 11).
"""
import contextlib
import functools
import inspect
import logging
import os
import pickle

import numpy as np
import torch
from torch.func import functional_call as _torch_functional_call
from torch.utils import _pytree as pytree

from . import dy2static
from .dy2static import convert_control_flow

__all__ = ['functional_call', 'to_static', 'not_to_static', 'save', 'load',
           'TranslatedLayer', 'StaticFunction', 'enable_to_static',
           'dy2static', 'ProgramTranslator', 'set_verbosity',
           'set_code_level', 'TracedLayer']

_to_static_enabled = True
_EXAMPLE_DIM = 2        # a dynamic dim's size while tracing (0, 1 specialise)


def _clone_tree(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


@contextlib.contextmanager
def _seeded(layer, key):
    """Draws of the call from a generator seeded with ``key``, the
    device generator left where it stands."""
    if key is None:
        yield
        return
    from ..core import rng
    dev = next(layer.parameters()).device
    gen = rng.generator(dev)
    state = gen.get_state()
    gen.manual_seed(int(key))
    try:
        yield
    finally:
        gen.set_state(state)


def functional_call(layer, params, buffers, args, kwargs=None, key=None,
                    training=None):
    """Run ``layer`` on ``args`` with ``params`` and ``buffers`` (name ->
    tensor dicts, ``named_parameters``/``named_buffers`` keys) in place
    of its own.  Returns ``(outputs, new_buffers)``: the layer's output
    as it returns it, and the buffers after the call (copies of
    ``buffers`` the call may have updated; ``buffers`` itself is left
    as it was).  ``training`` sets the mode for the call (None keeps
    the layer's).  Gradients flow to ``params``."""
    kwargs = kwargs or {}
    new_buffers = _clone_tree(buffers)
    old_training = layer.training
    if training is not None:
        layer.train(bool(training))
    try:
        with _seeded(layer, key):
            out = _torch_functional_call(
                layer, {**params, **new_buffers}, tuple(args), kwargs,
                tie_weights=False)
    finally:
        layer.train(old_training)
    return out, new_buffers


def enable_to_static(flag):
    """``ProgramTranslator().enable(...)``: globally toggle whether
    ``to_static`` functions run as graphs or as their dygraph code."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def not_to_static(fn):
    """Marker no-op (reference: paddle.jit.not_to_static)."""
    fn._not_to_static = True
    return fn


def _clone_out(out):
    return pytree.tree_map(
        lambda v: v.clone() if isinstance(v, torch.Tensor) else v, out)


def _tensor_device(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


class _BoundForward:
    """A layer's forward, with its tensor control flow converted, as the
    traced callable: the class's ``forward`` (not the instance's, which
    ``to_static`` replaces), on the layer's own parameter tree."""

    def __init__(self, layer):
        self._inner = layer

    def __call__(self, *args, **kwargs):
        fwd = convert_control_flow(type(self._inner).forward)
        return fwd(self._inner, *args, **kwargs)


class StaticFunction:
    """The callable ``to_static`` makes: the dygraph function, its
    tensor control flow converted, run under ``no_grad`` as one CUDA
    graph per signature on the card (module docstring)."""

    def __init__(self, dygraph_function, input_spec=None,
                 build_strategy=None, backend=None, check=None):
        if check:
            raise NotImplementedError(
                'to_static(check=) runs the TPU lint of the analysis '
                'tier, which is not ported yet (ROADMAP Queue 1 item 11)')
        self._dygraph_function = dygraph_function
        self._layer = dygraph_function._inner \
            if isinstance(dygraph_function, _BoundForward) else None
        self._fn = dygraph_function if self._layer is not None \
            else convert_control_flow(dygraph_function)
        self._graphs = {}          # signature -> GraphModule
        self._modes = {}           # signature -> 'graph' | 'eager' | 'cpu'
        src = dygraph_function
        if isinstance(src, _BoundForward):
            src = type(src._inner).forward
        functools.update_wrapper(
            self, src, assigned=('__name__', '__qualname__', '__doc__',
                                 '__module__'), updated=())

    @property
    def dygraph_function(self):
        return self._dygraph_function

    def modes(self):
        """``{signature: mode}`` of every signature called so far:
        ``'graph'`` (captured, replayed), ``'eager'`` (its warm-up read a
        tensor predicate on the host, so it runs as written) or
        ``'cpu'`` (tensors on the CPU: the function itself)."""
        return dict(self._modes)

    def _pure(self, tpos, static, n_args):
        fn = self._fn

        def run(*tvals):
            full = [None] * n_args
            for i, a in static:
                full[i] = a
            for i, v in zip(tpos, tvals):
                full[i] = v
            with torch.no_grad():
                return fn(*full)
        return run

    def _device(self, tvals):
        device = _tensor_device(tvals)
        if device is None and self._layer is not None:
            device = _tensor_device(self._layer.parameters())
        return device

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled or kwargs:
            return self._dygraph_function(*args, **kwargs)
        tpos, tvals, static = [], [], []
        for i, a in enumerate(args):
            if isinstance(a, (torch.Tensor, np.ndarray)):
                tpos.append(i)
                tvals.append(torch.as_tensor(a))
            else:
                static.append((i, a))
        tpos, static = tuple(tpos), tuple(static)
        training = self._layer.training if self._layer is not None \
            else False
        sig = (tpos, tuple((tuple(v.shape), v.dtype, v.device)
                           for v in tvals),
               tuple(repr(a) for _, a in static), len(args), training)
        run = self._pure(tpos, static, len(args))
        device = self._device(tvals)
        if device is None or device.type != 'cuda':
            self._modes[sig] = 'cpu'
            return run(*tvals)
        return self._graph_call(sig + (device,), run, device, tvals)

    def _graph_call(self, sig, run, device, tvals):
        from ..core.compile_cache import GraphModule
        mod = self._graphs.get(sig)
        if mod is not None:
            out = mod(*tvals)
            return out if mod.eager else _clone_out(out)
        reads = dy2static.host_reads()
        mod = GraphModule(run, device, stay_eager=lambda: (
            dy2static.host_reads() != reads))
        from ..telemetry import memory
        out = memory.note_graph_capture(
            f'to_static({self.__name__})', device, lambda: mod(*tvals),
            source='to_static')
        self._graphs[sig] = mod
        self._modes[sig] = 'eager' if mod.eager else 'graph'
        if mod.eager:
            _log.info('to_static(%s): signature %r read a tensor '
                      'predicate on the host; it runs eagerly',
                      self.__name__, sig)
        return out


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, check=None, **kwargs):
    """Decorator/wrapper (reference: paddle.jit.to_static): a function
    becomes a ``StaticFunction``; a layer keeps its identity and its
    ``forward`` becomes one (also at ``layer._static_forward``)."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            sf = StaticFunction(_BoundForward(fn), input_spec, check=check)
            fn.forward = sf
            fn._static_forward = sf
            return fn
        return StaticFunction(fn, input_spec, check=check)

    if function is not None:
        return decorate(function)
    return decorate


# -- save / load -------------------------------------------------------------

class _Pure(torch.nn.Module):
    """The forward as a function of ``(params, buffers, *inputs)``, for
    ``torch.export``: the layer's tensors are swapped for the inputs for
    the call, so the exported program holds no weights.  The layer is
    not a submodule (its parameters would be lifted into the
    program)."""

    def __init__(self, fn, base):
        super().__init__()
        self.__dict__['_fn'] = fn
        self.__dict__['_base'] = base

    def forward(self, params, buffers, *inputs):
        if self._base is None:
            return self._fn(*inputs)
        from torch.nn.utils.stateless import _reparametrize_module
        with _reparametrize_module(self._base, {**params, **buffers}):
            return self._fn(*inputs)


def _state(base):
    if base is None:
        return {}, {}
    return dict(base.named_parameters()), dict(base.named_buffers())


def _to_numpy(t):
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _dtype(name):
    name = str(name)
    return getattr(torch, name[len('torch.'):] if name.startswith(
        'torch.') else name)


def _examples(spec, device):
    """Example inputs at the spec's shapes (a dynamic dim at
    ``_EXAMPLE_DIM``) and their ``dynamic_shapes``: one ``Dim`` per axis
    index, shared by every input that leaves it open."""
    from torch.export import Dim
    dims, examples, dynamic = {}, [], []
    for s in spec:
        shape, axes = [], {}
        for axis, d in enumerate(s.shape):
            if d is None or d == -1:
                if axis not in dims:
                    dims[axis] = Dim(f'b{axis}', min=1)
                axes[axis] = dims[axis]
                shape.append(_EXAMPLE_DIM)
            else:
                shape.append(int(d))
        examples.append(torch.zeros(shape, dtype=_dtype(s.dtype or
                                                        'float32'),
                                    device=device))
        dynamic.append(axes or None)
    return examples, dynamic


def _export(fn, base, spec):
    """``torch.export`` of ``fn`` (``base``'s forward, or a function)
    in eval mode as a function of ``(params, buffers, *inputs)`` at the
    ``InputSpec``s ``spec``."""
    params, buffers = _state(base)
    params = {k: v.detach() for k, v in params.items()}
    device = _tensor_device(list(params.values()) + list(buffers.values()))
    examples, dynamic = _examples(spec, device)
    was_training = base.training if base is not None else None
    if base is not None:
        base.eval()
    try:
        with torch.no_grad():
            return torch.export.export(
                _Pure(fn, base), (params, buffers, *examples),
                dynamic_shapes=({k: None for k in params},
                                {k: None for k in buffers}, tuple(dynamic)))
    finally:
        if base is not None:
            base.train(was_training)


def save(layer, path, input_spec=None, **configs):
    """``jit.save``: ``<path>.pdmodel`` (the ``torch.export`` archive of
    the eval-mode forward) and ``<path>.pdiparams`` (the state and the
    spec, the reference's pickle layout).  ``input_spec`` is required,
    and its names must be unique, as in the reference."""
    from ..static.input_spec import InputSpec

    if isinstance(layer, StaticFunction):
        fn, base = layer._fn, layer._layer
        if base is not None:
            fn = _BoundForward(base)
    elif isinstance(layer, torch.nn.Module):
        fn, base = _BoundForward(layer), layer
    else:
        raise TypeError('jit.save expects a Layer or StaticFunction')
    if input_spec is None:
        raise ValueError('jit.save requires input_spec in this framework '
                         '(shapes define the exported module)')
    spec = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
            for s in input_spec]
    named = [s.name for s in spec if s.name]
    if len(named) != len(set(named)):
        raise ValueError(
            f'jit.save: duplicate InputSpec names {sorted(named)} — '
            'deployments feed inputs by name, so names must be unique')
    ep = _export(fn, base, spec)
    # the example inputs hold the parameters: the archive keeps none
    ep.example_inputs = None
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path + '.pdmodel', 'wb') as f:
        torch.export.save(ep, f)
    params, buffers = _state(base)
    state = {}
    if base is not None:
        state = {'params': {k: _to_numpy(v) for k, v in params.items()},
                 'buffers': {k: _to_numpy(v) for k, v in buffers.items()}}
    with open(path + '.pdiparams', 'wb') as f:
        pickle.dump({'state': state,
                     'spec': [(s.shape, str(np.dtype(s.numpy_dtype()))
                               if s.numpy_dtype() else str(s.dtype),
                               s.name) for s in spec]}, f)


class TranslatedLayer(torch.nn.Module):
    """``jit.load``'s result: a layer whose forward runs the exported
    module on the state it holds on its device, as one CUDA graph per
    input signature on the card (the function itself on the CPU).
    Inputs may be tensors or numpy arrays; they go to the layer's
    device."""

    def __init__(self, exported, state, input_specs=None, device=None):
        super().__init__()
        from ..core.device import resolve_device
        self.device = resolve_device(device)
        self._exported = exported
        self.__dict__['_program'] = exported.module()

        def on_device(tree):
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in tree.items()}
        self._state_params = on_device(state.get('params', {}))
        self._state_buffers = on_device(state.get('buffers', {}))
        # (shape, dtype, name) from jit.save: deployments feed by name
        self._input_specs = input_specs or []
        self._graphs = {}          # input signature -> GraphModule

    def input_names(self):
        return [n or f'input_{i}'
                for i, (_, _, n) in enumerate(self._input_specs)]

    def _run(self, *tvals):
        with torch.no_grad():
            return self._program(self._state_params, self._state_buffers,
                                 *tvals)

    def forward(self, *args):
        tvals = [torch.as_tensor(a).to(self.device) for a in args]
        if self.device.type != 'cuda':
            return self._run(*tvals)
        sig = tuple((tuple(t.shape), t.dtype) for t in tvals)
        mod = self._graphs.get(sig)
        if mod is not None:
            return _clone_out(mod(*tvals))
        from ..core.compile_cache import GraphModule
        from ..telemetry import memory
        mod = GraphModule(self._run, self.device)
        out = memory.note_graph_capture(            # warm-up, capture
            'jit.load', self.device, lambda: mod(*tvals), source='to_static')
        self._graphs[sig] = mod
        return out

    def graphs(self):
        """``{input signature: GraphModule}`` captured so far."""
        return dict(self._graphs)


def load(path, device=None, **configs):
    """``jit.load``: the ``TranslatedLayer`` of ``path``'s artifacts on
    ``device`` (the card unless asked otherwise).  Imports the port's
    operators first, which the exported graph calls."""
    from .. import ops  # noqa: F401  (registers paddle_tpu_torch::*)
    with open(path + '.pdmodel', 'rb') as f:
        ep = torch.export.load(f)
    with open(path + '.pdiparams', 'rb') as f:
        meta = pickle.load(f)
    return TranslatedLayer(ep, meta['state'], meta.get('spec'),
                           device=device)


# -- dy2static compat surface -------------------------------------------------

class ProgramTranslator:
    """The reference's process-wide singleton whose ``enable()`` toggles
    ``to_static`` (``enable_to_static``)."""

    _instance = None

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static_flag):
        enable_to_static(enable_to_static_flag)

    @property
    def enable_to_static(self):
        return _to_static_enabled

    def get_code(self, dygraph_func):
        return inspect.getsource(dygraph_func)

    def get_func(self, dygraph_func):
        return StaticFunction(dygraph_func)


_log = logging.getLogger('paddle_tpu_torch.jit')
_verbosity = 0


def set_verbosity(level=0, also_to_stdout=False):
    """The translation logger's level (DEBUG when ``level`` > 0), as the
    reference's ``set_verbosity``; returns the level."""
    global _verbosity
    _verbosity = int(level)
    _log.setLevel(logging.DEBUG if level > 0 else logging.WARNING)
    if also_to_stdout and not _log.handlers:
        _log.addHandler(logging.StreamHandler())
    return _verbosity


def set_code_level(level=100, also_to_stdout=False):
    """As the reference's: there is no pass pipeline to print, so this
    sets the same logger as ``set_verbosity``."""
    return set_verbosity(1 if level else 0, also_to_stdout)


class TracedLayer:
    """The reference's ``TracedLayer``: ``trace(layer, inputs)`` runs
    the layer once, pins the input specs and returns ``(outputs,
    traced)``; ``traced(inputs)`` runs the ``to_static`` function and
    ``save_inference_model(path)`` writes the ``jit.save`` artifacts."""

    def __init__(self, layer, static_fn, input_spec):
        self._layer = layer
        self._static_fn = static_fn
        self._input_spec = input_spec

    @staticmethod
    def trace(layer, inputs):
        from ..static.input_spec import InputSpec
        inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        out = layer(*inputs)
        spec = [InputSpec.from_tensor(torch.as_tensor(t)) for t in inputs]
        sf = StaticFunction(_BoundForward(layer))
        return out, TracedLayer(layer, sf, spec)

    def __call__(self, inputs):
        inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        out = self._static_fn(*inputs)
        return out if isinstance(out, (list, tuple)) else [out]

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        if isinstance(path, (list, tuple)):  # legacy (dirname, ...) form
            path = path[0]
        save(self._static_fn, path, input_spec=self._input_spec)
