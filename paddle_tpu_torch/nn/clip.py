"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Two entry points, as in the reference: ``clip(params_grads)``, the
eager API over ``(param, grad)`` pairs, leaves a parameter whose
``need_clip`` is False unclipped (and out of the global norm);
``clip_values(grads)``, the functional one the trainer applies to every
gradient, ignores ``need_clip``.  The norms and scales are device
tensors, so a clip reads nothing back to the host and a CUDA graph can
capture it.

``ClipGradByNorm`` scales a tensor by ``min(clip / max(n, 1e-12), 1)``;
``ClipGradByGlobalNorm`` scales every tensor by ``clip / max(n, clip)``
with ``n`` the norm over all of them (the squares summed per tensor, the
tensors' sums added in order).  Either norm is the whole logical
tensor's: a shard's squares are summed over its tensor-parallel group.
"""
import warnings

import torch

__all__ = ['ClipGradByValue', 'ClipGradByNorm', 'ClipGradByGlobalNorm',
           'ErrorClipByValue', 'set_gradient_clip', 'get_gradient_clip']


def _clipped(p):
    return getattr(p, 'need_clip', True) is not False


def _over(c, t):
    """``c / t`` for a Python float ``c`` and a 0-d tensor ``t``, as a
    division (``c / t`` would multiply by ``t``'s reciprocal)."""
    return torch.full_like(t, c) / t


def _sum_squares(grads, params=None):
    """``sum(square(g))`` of each tensor, added in order (the
    reference's Python ``sum``), as a 0-d tensor.  A gradient of a
    parameter held in shards over tensor parallelism (``_tp_group``) has
    its squares summed over that group, once for all such tensors."""
    total, shards = None, {}
    for i, g in enumerate(grads):
        s = g.square().sum()
        group = getattr(params[i], '_tp_group', None) if params else None
        if group is not None:
            prev = shards.get(id(group), (group, None))[1]
            shards[id(group)] = (group, s if prev is None else prev + s)
            continue
        total = s if total is None else total + s
    if shards:
        from ..distributed import collective
        for group, part in shards.values():
            part = collective.all_reduce(part, group=group)
            total = part if total is None else total + part
    return total


def clip_with_params(clip, grads, params):
    """``clip.clip_values(grads)``, and with ``params`` too where one of
    them is held in shards over tensor parallelism (a norm then sums a
    shard's squares over its group), so a clip written for the
    reference's one-argument ``clip_values`` keeps working on one card."""
    if any(getattr(p, '_tp_group', None) is not None for p in params):
        return clip.clip_values(grads, params)
    return clip.clip_values(grads)


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param, grad)] -> [(param, clipped grad)]`` (eager API)."""
        return self._dygraph_clip(params_grads)

    def clip_values(self, grads, params=None):
        """``[grad] -> [clipped grad]`` (the trainer's functional API);
        ``params``, where given, are the gradients' parameters."""
        raise NotImplementedError

    def _dygraph_clip(self, params_grads):
        out = list(params_grads)
        idx = [i for i, (p, g) in enumerate(out)
               if g is not None and _clipped(p)]
        for i, g in zip(idx, clip_with_params(
                self, [out[i][1] for i in idx], [out[i][0] for i in idx])):
            out[i] = (out[i][0], g)
        return out


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_values(self, grads, params=None):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_values(self, grads, params=None):
        out = []
        for i, g in enumerate(grads):
            n = torch.sqrt(_sum_squares([g], params and [params[i]]))
            scale = torch.clamp_max(
                _over(self.clip_norm, torch.clamp_min(n, 1e-12)), 1.0)
            out.append(g * scale)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip_values(self, grads, params=None):
        if not grads:
            return []
        gn = torch.sqrt(_sum_squares(grads, params))
        scale = _over(self.clip_norm, torch.clamp_min(gn, self.clip_norm))
        return [g * scale for g in grads]


class ErrorClipByValue:
    """The legacy error clip attribute (1.x), kept for API parity: it
    stores its bounds and clips nothing itself."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)


_GLOBAL_CLIP = [None]


def set_gradient_clip(clip, param_list=None, program=None):
    """The deprecated 1.x setter: stores ``clip`` on each parameter of
    ``param_list`` (``p.grad_clip``), or as the global clip that
    ``get_gradient_clip`` returns.  Optimizers take ``grad_clip=``."""
    warnings.warn(
        'set_gradient_clip is the deprecated 1.x API: prefer passing '
        'grad_clip= to the optimizer', stacklevel=2)
    if param_list:
        for p in param_list:
            p.grad_clip = clip
    else:
        _GLOBAL_CLIP[0] = clip


def get_gradient_clip():
    return _GLOBAL_CLIP[0]
