"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``;
the port has ``cross_entropy`` over integer labels on the last axis and
``binary_cross_entropy_with_logits``)."""
import torch
import torch.nn.functional as TF

from ...amp import amp_cast

__all__ = ['cross_entropy', 'binary_cross_entropy_with_logits']

_REDUCTIONS = ('mean', 'sum', 'none')


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True):
    """Softmax cross entropy of ``input [..., C]`` against integer
    ``label [...]``, as the reference computes it: per-token
    ``logsumexp(x) - x[label]`` in f32, tokens whose label is
    ``ignore_index`` count zero, ``'mean'`` divides by the number of
    counted tokens (at least 1); the result has the input's dtype (f32
    under AMP, where ``cross_entropy`` is black-listed).  Class weights,
    soft labels, probability inputs and other axes are not ported
    yet."""
    if (weight is not None or soft_label or not use_softmax
            or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            'cross_entropy: only hard integer labels over the last axis '
            'with softmax are ported')
    _check_reduction(reduction)
    input, = amp_cast('cross_entropy', input)
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(-1)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, torch.zeros_like(lab))
    xf = input.float()
    per = torch.logsumexp(xf, dim=-1) - xf.gather(-1, safe[..., None])[..., 0]
    per = torch.where(mask, per, torch.zeros_like(per))
    if reduction == 'mean':
        out = per.sum() / mask.sum().to(per.dtype).clamp_min(1.0)
    elif reduction == 'sum':
        out = per.sum()
    else:
        out = per
    return out.to(input.dtype)


def _check_reduction(reduction):
    if reduction not in _REDUCTIONS:
        raise ValueError(f'reduction must be mean/sum/none, got '
                         f'{reduction!r}')


def _reduce(v, reduction):
    if reduction == 'mean':
        return v.mean()
    if reduction == 'sum':
        return v.sum()
    return v


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction='mean', pos_weight=None,
                                     name=None):
    """Sigmoid cross entropy of ``logit`` against ``label`` (in [0, 1]),
    in the reference's forms: without ``pos_weight`` the stable
    ``max(z, 0) - z * y + log1p(exp(-|z|))``, with it ``-(pos_weight * y
    * log_sigmoid(z) + (1 - y) * log_sigmoid(-z))``; times ``weight``
    where given, then reduced.  Under AMP every input goes to f32
    (``bce_with_logits`` is black-listed)."""
    _check_reduction(reduction)
    z, y, w, pw = amp_cast('bce_with_logits', logit, label, weight,
                           pos_weight)
    if pw is not None:
        per = -(pw * y * TF.logsigmoid(z) + (1 - y) * TF.logsigmoid(-z))
    else:
        # torch.maximum splits the gradient at z == 0 as jnp.maximum does
        per = torch.maximum(z, torch.zeros_like(z)) - z * y + torch.log1p(
            torch.exp(-z.abs()))
    if w is not None:
        per = per * w
    return _reduce(per, reduction)
