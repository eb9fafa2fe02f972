"""paddle_tpu_torch.amp — automatic mixed precision, the reference's
policy (counterpart of ``paddle_tpu/amp/__init__.py``).

The reference casts at its single dispatch choke point, by op name:
black-listed ops run in f32, ``KEEP_LIST`` norms take their inputs as
they come (f32 statistics inside, f32 gamma/beta), O2 runs every other
op in the low dtype, and O1 runs the white list low and lets gray ops
follow a low-precision input.  ``torch.autocast`` keeps other lists (it
holds LayerNorm and softmax in f32 and does not cast embeddings), so the
port does not use it: the ops that the reference dispatches by name
call ``amp_cast(op_name, *tensors)`` with the same names, and get their
inputs cast by the same rule.  Parameters stay as they are (f32 master
weights under the trainer's O2); the casts are differentiable, so
gradients come back in the parameters' dtype.

``GradScaler`` is the reference's dynamic loss scaling for float16
(bf16 needs none, but the state machine runs all the same): the same
defaults, the same scale, good-step and bad-step trajectory, and the
same skip of a step whose gradients are not finite.  Its non-finite
check costs one host sync a step, not one per parameter.
"""
import contextlib

import torch

__all__ = ['auto_cast', 'amp_guard', 'amp_cast', 'decorate', 'amp_decorate',
           'is_amp_enabled', 'amp_state', 'GradScaler', 'WHITE_LIST',
           'BLACK_LIST', 'KEEP_LIST']

# the reference's lists, unchanged (paddle_tpu/amp/__init__.py:28-65)
WHITE_LIST = frozenset({
    'matmul', 'bmm', 'mv', 'dot', 'mul', 'linear', 'conv1d', 'conv2d',
    'conv3d', 'conv2d_transpose', 'conv1d_transpose', 'conv3d_transpose',
    'einsum', 'addmm', 'fused_linear_gelu', 'flash_attention',
})

BLACK_LIST = frozenset({
    'exp', 'expm1', 'log', 'log2', 'log10', 'log1p', 'pow', 'square',
    'sqrt', 'rsqrt', 'reciprocal', 'softmax', 'log_softmax',
    'cross_entropy', 'softmax_with_cross_entropy', 'nll_loss',
    'binary_cross_entropy', 'bce_with_logits',
    'kl_div', 'cosh', 'sinh', 'tan', 'mean', 'sum', 'norm', 'dist',
    'reduce_mean', 'reduce_sum', 'cumsum', 'logsumexp', 'softplus',
    'erf', 'erfinv', 'lgamma', 'digamma', 'cross_entropy_loss',
    'mse_loss', 'l1_loss', 'square_error_cost', 'smooth_l1_loss',
    'margin_ranking_loss', 'hinge_embedding_loss',
    'cosine_embedding_loss', 'log_loss', 'ctc_loss',
    'sigmoid_focal_loss',
})

KEEP_LIST = frozenset({
    'layer_norm', 'batch_norm', 'instance_norm', 'group_norm',
})

_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16,
           'float32': torch.float32}


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.level = 'O1'
        self.dtype = torch.bfloat16
        self.white = WHITE_LIST
        self.black = BLACK_LIST


_state = _AmpState()


def _to_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f'amp dtype must be one of {sorted(_DTYPES)}, got '
                         f'{dtype!r}')
    return _DTYPES[dtype]


def _is_float(t):
    return t is not None and torch.is_floating_point(t)


def _cast_all(tensors, dtype):
    return tuple(t.to(dtype) if _is_float(t) and t.dtype != dtype else t
                 for t in tensors)


def amp_cast(op_name, *tensors):
    """``tensors`` cast as the reference's dispatch hook casts the
    inputs of the op ``op_name`` under the active policy (a tuple, in
    order; None and integer tensors pass through)."""
    st = _state
    if not st.enabled:
        return tensors
    if (op_name in KEEP_LIST and op_name not in st.black
            and op_name not in st.white):
        return tensors
    if op_name in st.black:
        return _cast_all(tensors, torch.float32)
    if st.level == 'O2':
        return _cast_all(tensors, st.dtype)
    if op_name in st.white:
        return _cast_all(tensors, st.dtype)
    # O1 gray op: follow an input that is already low precision
    if any(_is_float(t) and t.dtype == st.dtype for t in tensors):
        return _cast_all(tensors, st.dtype)
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level='O1', dtype='bfloat16'):
    """Mixed precision for the ops run inside the block (the
    reference's ``auto_cast``)."""
    if level not in ('O0', 'O1', 'O2'):
        raise ValueError(f'level must be O0/O1/O2, got {level}')
    prev = (_state.enabled, _state.level, _state.dtype, _state.white,
            _state.black)
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    _state.enabled = bool(enable) and level != 'O0'
    _state.level = level
    _state.dtype = _to_dtype(dtype)
    _state.white, _state.black = frozenset(white), frozenset(black)
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.dtype, _state.white,
         _state.black) = prev


amp_guard = auto_cast


def is_amp_enabled():
    return _state.enabled


def amp_state():
    """The active policy (``enabled``, ``level``, ``dtype`` and the
    lists), the reference's ``amp_state``."""
    return _state


def decorate(models, optimizers=None, level='O1', dtype='bfloat16',
             master_weight=None, save_dtype=None):
    """The reference's ``decorate``: O2 casts every floating parameter
    of the models to the low dtype, in place; O1 changes nothing."""
    del master_weight, save_dtype
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == 'O2':
        target = _to_dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if _is_float(p):
                        p.data = p.data.to(target)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


amp_decorate = decorate


class GradScaler:
    """Dynamic loss scaling (the reference's ``GradScaler``,
    ``paddle_tpu/amp/__init__.py``): ``scale(loss)`` multiplies the loss
    by the scale before ``backward()``; ``step(optimizer)`` unscales the
    gradients, skips the update if any of them is not finite, and
    updates the scale: after ``decr_every_n_nan_or_inf`` bad steps in a
    row it is multiplied by ``decr_ratio`` (not below 1), after
    ``incr_every_n_steps`` good steps in a row by ``incr_ratio``.

    One difference: the reference clears its per-step flags only when
    the scale is dynamic, so with ``use_dynamic_loss_scaling=False`` its
    ``unscale_`` runs once and never again; here ``update`` clears them
    in either case, and each step's gradients are unscaled."""

    def __init__(self, enable=True, init_loss_scaling=2.**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        """The current scale (the reference's name)."""
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer``'s parameters by the
        scale, in place, and note whether any of them is not finite (one
        host sync for all of them)."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p.grad for p in optimizer._params if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        torch._foreach_mul_(grads, 1.0 / self._scale)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self._found_inf = not bool(finite)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        """The reference's ``minimize(optimizer, scaled_loss)`` after
        ``scaled_loss.backward()``: ``step(optimizer)``; the loss itself
        is not used."""
        del scaled_loss
        self.step(optimizer)

    def update(self):
        found_inf = self._found_inf
        self._found_inf = False
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        if found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {'scale': self._scale, 'incr_ratio': self._incr_ratio,
                'decr_ratio': self._decr_ratio,
                'incr_every_n_steps': self._incr_every_n_steps,
                'decr_every_n_nan_or_inf': self._decr_every_n,
                'good_steps': self._good_steps,
                'bad_steps': self._bad_steps,
                'use_dynamic_loss_scaling': self._dynamic}

    def load_state_dict(self, state):
        self._scale = state['scale']
        self._incr_ratio = state['incr_ratio']
        self._decr_ratio = state['decr_ratio']
        self._incr_every_n_steps = state['incr_every_n_steps']
        self._decr_every_n = state['decr_every_n_nan_or_inf']
        self._good_steps = state['good_steps']
        self._bad_steps = state['bad_steps']
        self._dynamic = state['use_dynamic_loss_scaling']
