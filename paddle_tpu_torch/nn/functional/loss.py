"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``;
the port has ``cross_entropy`` over integer labels on the last axis)."""
import torch

from ...amp import amp_cast

__all__ = ['cross_entropy']


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
    if reduction not in ('mean', 'sum', 'none'):
        raise ValueError(f'reduction must be mean/sum/none, got '
                         f'{reduction!r}')
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
