"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``):
all of the reference's, in its arithmetic.

``cross_entropy`` over integer labels on the last axis keeps the
reference's two custom backwards: ``_SoftmaxNLL`` (f32 ``logsumexp -
x[label]`` forward, ``(softmax - one_hot) * g`` backward recomputed from
the saved logits) and ``_PickNLL`` (``-logp[label]`` with a dense
``-one_hot * g`` backward) for ``use_softmax=False``.  Soft labels,
class weights and other axes follow the reference's formulas too.
Each loss casts its inputs through the AMP policy under the reference's
op name; the black-listed ones run in f32."""
import numpy as np
import torch
import torch.nn.functional as TF
from torch.profiler import record_function

from ...amp import amp_cast
from ...core.autograd import composed_backward

__all__ = [
    'cross_entropy', 'softmax_with_cross_entropy', 'binary_cross_entropy',
    'binary_cross_entropy_with_logits', 'mse_loss', 'l1_loss', 'nll_loss',
    'kl_div', 'smooth_l1_loss', 'margin_ranking_loss', 'ctc_loss',
    'hinge_embedding_loss', 'cosine_embedding_loss', 'square_error_cost',
    'sigmoid_focal_loss', 'log_loss', 'hsigmoid_loss', 'dice_loss',
    'npair_loss',
]

_REDUCTIONS = ('mean', 'sum', 'none')


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


def _one_hot_mask(lab, n):
    return lab[..., None] == torch.arange(n, device=lab.device,
                                          dtype=lab.dtype)


def _softmax_nll(x, lab):
    xf = x.float()
    return (torch.logsumexp(xf, dim=-1, keepdim=True)
            - xf.gather(-1, lab[..., None]))[..., 0]


class _SoftmaxNLL(torch.autograd.Function):
    """Per-token ``-log_softmax(x)[lab]`` over the last axis, in f32.
    Under grad mode (a ``create_graph`` pass) the backward goes through
    the plain composition ``_softmax_nll``, the logsumexp rebuilt from
    ``x`` under autograd, so every order is exact."""

    @staticmethod
    def forward(ctx, x, lab):
        xf = x.float()
        lse = torch.logsumexp(xf, dim=-1, keepdim=True)
        picked = xf.gather(-1, lab[..., None])
        ctx.save_for_backward(x, lab, lse)
        return (lse - picked)[..., 0]

    @staticmethod
    def backward(ctx, g):
        x, lab, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            return composed_backward(lambda t: _softmax_nll(t, lab), (x,),
                                     ctx.needs_input_grad[:1], (g,)) \
                + (None,)
        p = torch.exp(x.float() - lse)
        dx = (p - _one_hot_mask(lab, x.shape[-1]).to(p.dtype)) * g[..., None]
        return dx.to(x.dtype), None


class _PickNLL(torch.autograd.Function):
    """``-logp[..., lab]`` over the last axis.  Its backward is linear
    in ``g`` and free of ``logp``, so a second order through it is exact
    as it stands."""

    @staticmethod
    def forward(ctx, logp, lab):
        ctx.save_for_backward(lab)
        ctx.shape = logp.shape
        ctx.dtype = logp.dtype
        return -logp.gather(-1, lab[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        lab, = ctx.saved_tensors
        oh = _one_hot_mask(lab, ctx.shape[-1])
        zero = torch.zeros((), dtype=ctx.dtype, device=g.device)
        return torch.where(oh, -g[..., None].to(ctx.dtype), zero), None


def _take_along(arr, idx, axis):
    """``jnp.take_along_axis``: ``idx`` broadcast against ``arr`` on
    every axis but ``axis``."""
    axis = axis % arr.dim()
    shape = [max(a, i) for a, i in zip(arr.shape, idx.shape)]
    a_shape, i_shape = list(shape), list(shape)
    a_shape[axis], i_shape[axis] = arr.shape[axis], idx.shape[axis]
    return torch.gather(arr.expand(a_shape), axis, idx.expand(i_shape))


def _log_probs(logits, axis, use_softmax):
    if use_softmax:
        return torch.log_softmax(logits, dim=axis)
    return torch.log(torch.clamp_min(logits, 1e-30))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Cross entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) against integer labels (``[...]`` or
    ``[..., 1]``) or, with ``soft_label``, a distribution; per-class
    ``weight``.  Hard labels: tokens whose label is ``ignore_index``
    count zero and ``'mean'`` divides by the counted tokens (their
    weights' sum with ``weight``); the result has the input's dtype
    after the AMP cast (f32: ``cross_entropy`` is black-listed).  Runs
    inside a ``cross_entropy`` range (a profile's loss time)."""
    with record_function('cross_entropy'):
        return _cross_entropy(input, label, weight, ignore_index,
                              reduction, soft_label, axis, use_softmax)


def _cross_entropy(input, label, weight, ignore_index, reduction,
                   soft_label, axis, use_softmax):
    _check_reduction(reduction)
    logits, lab, w = amp_cast('cross_entropy', input, label, weight)
    last = axis in (-1, logits.dim() - 1)
    if soft_label:
        logp = _log_probs(logits, axis, use_softmax)
        per = -(lab * logp).sum(dim=axis)
        if w is not None:
            per = per * (lab * w).sum(dim=axis)
        return _reduce(per, reduction)
    lab_i = lab.long()
    if lab_i.dim() == logits.dim():
        lab_i = lab_i.squeeze(axis)
    mask = lab_i != ignore_index
    safe = torch.where(mask, lab_i, torch.zeros_like(lab_i))
    if use_softmax and last:
        per = _SoftmaxNLL.apply(logits, safe)
    elif last:
        per = _PickNLL.apply(_log_probs(logits, axis, False), safe).float()
    else:
        logp = _log_probs(logits, axis, use_softmax)
        per = -_take_along(logp, safe[..., None], axis)[..., 0].float()
    zero = torch.zeros((), dtype=per.dtype, device=per.device)
    per = torch.where(mask, per, zero)
    out_dtype = logits.dtype
    if w is not None:
        wl = torch.where(mask, w[safe], torch.zeros((), dtype=w.dtype,
                                                    device=w.device))
        per = per * wl
        if reduction == 'mean':
            return (per.sum() / torch.clamp_min(wl.float().sum(), 1e-12)
                    ).to(out_dtype)
    if reduction == 'mean':
        denom = torch.clamp_min(mask.to(per.dtype).sum(), 1.0)
        return (per.sum() / denom).to(out_dtype)
    return _reduce(per, reduction).to(out_dtype)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-token ``cross_entropy`` (hard labels keep a trailing 1 on
    ``axis``), and the softmax with ``return_softmax``."""
    from .activation import softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction='none',
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction='mean',
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))`` with ``p`` clipped to
    ``[1e-12, 1 - 1e-12]``."""
    _check_reduction(reduction)
    p, y, w = amp_cast('binary_cross_entropy', input, label, weight)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    per = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if w is not None:
        per = per * w
    return _reduce(per, reduction)


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


def mse_loss(input, label, reduction='mean', name=None):
    a, b = amp_cast('mse_loss', input, label)
    return _reduce(torch.square(a - b), reduction)


def square_error_cost(input, label):
    a, b = amp_cast('square_error_cost', input, label)
    return torch.square(a - b)


def l1_loss(input, label, reduction='mean', name=None):
    a, b = amp_cast('l1_loss', input, label)
    return _reduce((a - b).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean',
             name=None):
    """``-logp[label]`` of log-probabilities ``input`` (classes on axis
    1 for ``[N, C, d1, ...]``), ``ignore_index`` counting zero, class
    ``weight``s."""
    logp, lab, w = amp_cast('nll_loss', input, label, weight)
    if logp.dim() > 2:
        logp = torch.movedim(logp, 1, -1)
    lab_i = lab.long()
    mask = lab_i != ignore_index
    safe = torch.where(mask, lab_i, torch.zeros_like(lab_i))
    zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
    per = torch.where(mask, _PickNLL.apply(logp, safe), zero)
    if w is not None:
        wl = w[safe] * mask.to(logp.dtype)
        if reduction == 'mean':
            return (per * wl).sum() / torch.clamp_min(wl.sum(), 1e-12)
        per = per * wl
    if reduction == 'mean':
        return per.sum() / torch.clamp_min(mask.to(logp.dtype).sum(), 1.0)
    return _reduce(per, reduction)


def kl_div(input, label, reduction='mean', name=None):
    """``label * (log label - input)`` (``input`` log-probabilities);
    ``'batchmean'`` divides the sum by the batch."""
    logp, y = amp_cast('kl_div', input, label)
    per = y * (torch.log(torch.clamp_min(y, 1e-30)) - logp)
    if reduction == 'batchmean':
        return per.sum() / logp.shape[0]
    return _reduce(per, reduction)


def smooth_l1_loss(input, label, reduction='mean', delta=1.0, name=None):
    a, b = amp_cast('smooth_l1_loss', input, label)
    d = a - b
    ad = d.abs()
    per = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce(per, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean',
                        name=None):
    a, b, y = amp_cast('margin_ranking_loss', input, other, label)
    per = torch.clamp_min(-y * (a - b) + margin, 0.0)
    return _reduce(per, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction='mean',
                         name=None):
    a, y = amp_cast('hinge_embedding_loss', input, label)
    per = torch.where(y == 1, a, torch.clamp_min(margin - a, 0.0))
    return _reduce(per, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction='mean', name=None):
    a, b, y = amp_cast('cosine_embedding_loss', input1, input2, label)
    cos = (a * b).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)
    per = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
    return _reduce(per, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction='sum', name=None):
    z, y, n = amp_cast('sigmoid_focal_loss', logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    per = a_t * ((1 - p_t) ** gamma) * ce
    if n is not None:
        per = per / n
    return _reduce(per, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    p, y = amp_cast('log_loss', input, label)
    return -(y * torch.log(p + epsilon) + (1 - y) * torch.log(1 - p + epsilon))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction='mean'):
    """CTC by the forward algorithm in log space over ``log_probs [T, B,
    C]`` and ``labels [B, S]``: a loop over time (the reference's
    ``lax.scan``), rows past their input length frozen, the final
    alpha read at ``2 * label_length`` and the one before; ``'mean'``
    divides each loss by its label length first."""
    lp, = amp_cast('ctc_loss', log_probs)
    T, B, _ = lp.shape
    S = labels.shape[1]
    dev = lp.device
    ext = torch.full((B, 2 * S + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    neg_inf = torch.full((), -1e30, dtype=lp.dtype, device=dev)
    alpha = neg_inf.expand(B, 2 * S + 1).clone()
    alpha[:, 0] = lp[0, :, blank]
    alpha[:, 1] = lp[0].gather(1, ext[:, 1:2])[:, 0]
    same = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    in_len = input_lengths.long().to(dev)
    pad1 = neg_inf.expand(B, 1)
    pad2 = neg_inf.expand(B, 2)
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(same, neg_inf, torch.cat([pad2, alpha[:, :-2]],
                                                  dim=1))
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        s = torch.exp(alpha - m) + torch.exp(a1 - m) + torch.exp(a2 - m)
        new = m + torch.log(torch.clamp_min(s, 1e-37)) + lp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    lab_len = label_lengths.long().to(dev)
    idx_last = 2 * lab_len
    a_l = alpha.gather(1, idx_last[:, None])[:, 0]
    a_p = alpha.gather(1, torch.clamp_min(idx_last - 1, 0)[:, None])[:, 0]
    m = torch.maximum(a_l, a_p)
    per = -(m + torch.log(torch.exp(a_l - m) + torch.exp(a_p - m)))
    if reduction == 'mean':
        return (per / torch.clamp_min(lab_len.to(lp.dtype), 1.0)).mean()
    return _reduce(per, reduction)


_hsigmoid_trees = {}


def _hsigmoid_default_tree(C):
    """The complete binary tree's ``[C, L]`` path-node and code tables
    (heap layout: root 1, class ``c`` at ``C + c``, node ``n`` -> weight
    row ``n - 1``), built once per ``C`` on the host."""
    if C in _hsigmoid_trees:
        return _hsigmoid_trees[C]
    L = max(int(np.ceil(np.log2(max(C, 2)))), 1)
    tbl = np.full((C, L), -1, np.int64)
    code = np.zeros((C, L), np.float32)
    for c in range(C):
        node = C + c
        path = []
        while node > 1:
            parent = node // 2
            path.append((parent - 1, float(node % 2)))
            node = parent
        for k, (p, b) in enumerate(reversed(path)):
            if k < L:
                tbl[c, k] = p
                code[c, k] = b
    _hsigmoid_trees[C] = (tbl, code)
    return tbl, code


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: a binary cross entropy at each node on the
    label's path (the default complete tree, or ``path_table`` /
    ``path_code`` ``[N, L]`` or ``[C, L]``, -1 padded), summed per row
    ``[N, 1]``."""
    x, w, b = amp_cast('hsigmoid_loss', input, weight, bias)
    if path_table is None:
        path_table, path_code = _hsigmoid_default_tree(int(num_classes))
    pt = torch.as_tensor(np.asarray(path_table, np.int64), device=x.device)
    pc = torch.as_tensor(np.asarray(path_code, np.float32), device=x.device)
    y = label.reshape(x.shape[0]).long()
    nodes, codes = pt[y], pc[y]
    valid = (nodes >= 0).to(x.dtype)
    safe = torch.clamp_min(nodes, 0)
    logits = torch.einsum('bd,bld->bl', x, w[safe])
    if b is not None:
        logits = logits + b.reshape(-1)[safe]
    ls = TF.logsigmoid(logits)
    per = -(codes * ls + (1 - codes) * (ls - logits))
    return (per * valid).sum(dim=-1, keepdim=True)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - 2 |x . onehot| / (|x| + |onehot| + epsilon))`` per
    sample, the label one-hot over the input's last axis."""
    x, = amp_cast('dice_loss', input)
    lab = label
    if lab.dim() and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    oh = _one_hot_mask(lab.long(), x.shape[-1]).to(x.dtype)
    red = tuple(range(1, x.dim()))
    inse = (x * oh).sum(dim=red)
    denom = x.sum(dim=red) + oh.sum(dim=red)
    return (1.0 - 2.0 * inse / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: soft-label cross entropy over ``anchor @
    positive.T`` (labels equal -> one class) plus ``0.25 * l2_reg``
    times the embeddings' mean squared norms."""
    a, p = amp_cast('npair_loss', anchor, positive)
    b = labels.shape[0]
    eq = (labels.reshape(b, 1) == labels.reshape(1, b)).to(a.dtype)
    soft = eq / eq.sum(dim=1, keepdim=True)
    l2 = ((a * a).sum(dim=1).mean() + (p * p).sum(dim=1).mean()) \
        * 0.25 * l2_reg
    ce_rows = -(soft * torch.log_softmax(a @ p.T, dim=-1)).sum(
        dim=-1, keepdim=True)
    return l2 + (soft * ce_rows).sum(dim=0).mean()
