"""paddle_tpu_torch.jit (counterpart of ``paddle_tpu/jit``; the port has
``functional_call``).

``functional_call(layer, params, buffers, args)`` runs a layer as a
function of the given parameters and buffers, as the reference's does,
on ``torch.func.functional_call``: the layer's own tensors are left as
they were, and the buffers the call updates (BatchNorm's running
statistics) come back as ``new_buffers``.  ``key`` is the reference's
PRNG key: an int seeds a generator forked for the call, None draws from
the device's generator (``core.rng``).

``to_static``, ``save``, ``load``, ``TranslatedLayer``,
``TracedLayer``, ``ProgramTranslator`` and dy2static wait for ROADMAP
Queue 1 item 8b: the reference translates Python control flow into
``lax`` and exports XLA executables, and the port's compiled module, a
CUDA graph, cannot be serialised; they raise ``NotImplementedError``.
"""
import contextlib

import torch
from torch.func import functional_call as _torch_functional_call

__all__ = ['functional_call', 'to_static', 'not_to_static', 'save', 'load',
           'TranslatedLayer', 'TracedLayer', 'ProgramTranslator',
           'enable_to_static']


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
    """``ProgramTranslator().enable(...)``: to_static is not ported, so
    there is nothing to toggle; kept for scripts that call it."""
    del flag


def not_to_static(fn):
    """Marker no-op (reference: paddle.jit.not_to_static)."""
    fn._not_to_static = True
    return fn


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f'paddle_tpu_torch.jit.{name} is not ported yet (ROADMAP '
            'Queue 1 item 8b): the reference translates Python control '
            'flow into lax and exports XLA executables, and a CUDA graph '
            'cannot be serialised')
    fn.__name__ = name
    return fn


to_static = _not_ported('to_static')
save = _not_ported('save')
load = _not_ported('load')
TranslatedLayer = _not_ported('TranslatedLayer')
TracedLayer = _not_ported('TracedLayer')
ProgramTranslator = _not_ported('ProgramTranslator')
