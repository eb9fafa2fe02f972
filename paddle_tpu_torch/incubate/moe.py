"""Switch-style Mixture of Experts (counterpart of
``paddle_tpu/incubate/moe.py``).

The reference's dense formulation (Switch Transformer routing,
arXiv:2101.03961): the gate's argmax picks each token's expert, a
capacity ``C = ceil(S * top_k / E * capacity_factor)`` bounds each
expert's queue, and the routing becomes two ``[S, E, C]`` tensors, a
one-hot dispatch in the activations' dtype and an f32 combine holding
the gate's probability.  The token shuffle, the two expert FFN products
(one batched product over the expert dim) and the way back are four
einsums; a token past its expert's capacity has an all-zero row in
both, so it leaves the layer as zeros and the residual carries it.
``top_k=2`` queues each second choice behind the first choices of the
same expert.  The load-balance term ``E * sum_e f_e * p_e`` (``f_e``
the share of first choices, ``p_e`` the mean gate probability) is the
last forward's ``.aux_loss``.

Expert weights are stacked ``w1 [E, H, F]``, ``w2 [E, F, H]``; names,
shapes and init laws are the reference's.  Expert parallelism over an
``'ep'`` mesh axis waits for the distributed plane.
"""
import math

import torch
from torch import nn
from torch.nn import functional as TF

from ..amp import amp_cast
from ..nn import initializer as I
from ..nn.layer.layers import create_parameter

__all__ = ['SwitchMoE']


def route(probs, top_k, capacity, dtype):
    """The reference's routing of gate probabilities ``probs [S, E]``
    (f32): ``(dispatch [S, E, C] in dtype, combine [S, E, C] f32, aux)``.
    Each of the ``top_k`` rounds takes every token's best remaining
    expert (the first maximum, as ``jnp.argmax``), queues it behind the
    tokens already in that expert (``occ``) and keeps it only inside
    the capacity."""
    S, E = probs.shape
    experts = torch.arange(E, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = torch.zeros((S, E, capacity), dtype=dtype,
                           device=probs.device)
    combine = torch.zeros((S, E, capacity), dtype=torch.float32,
                          device=probs.device)
    occ = torch.zeros((E,), dtype=torch.float32, device=probs.device)
    masked = probs
    first = None
    for _ in range(top_k):
        onehot = (masked.argmax(-1)[:, None] == experts).float()
        gate = (masked * onehot).sum(-1)
        pos = (torch.cumsum(onehot, 0) - 1.0 + occ[None, :]) * onehot
        keep = (pos < capacity) & (onehot > 0)
        # jax.nn.one_hot gives a zero row for a slot >= C; so does the
        # comparison, and keep drops those tokens besides
        slot = (pos.long()[..., None] == slots).float()
        sel = slot * keep.float()[..., None]
        dispatch = dispatch + sel.to(dtype)
        combine = combine + sel * gate[:, None, None]
        first = onehot if first is None else first
        occ = occ + keep.float().sum(0)
        masked = masked * (1.0 - onehot)
    aux = E * (first.mean(0) * probs.mean(0)).sum()
    return dispatch, combine, aux


class SwitchMoE(nn.Module):
    """Top-1 (Switch) or top-2 routed expert FFN over ``[..., H]``.

    Args:
        hidden_size: H.
        ffn_size: each expert's inner width F.
        num_experts: E.
        top_k: 1 or 2.
        capacity_factor: slots per expert are ``ceil(S * top_k / E *
            capacity_factor)``.
        activation: 'gelu' (the tanh form, ``jax.nn.gelu``'s default)
            or 'relu'.
        device, generator: where the parameters live, and the CPU
            generator their init draws from (torch's default one when
            None); ``reset_parameters(generator)`` draws them again.
    """

    def __init__(self, hidden_size, ffn_size, num_experts, top_k=1,
                 capacity_factor=1.25, activation='gelu', name=None,
                 device=None, generator=None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError('top_k must be 1 or 2')
        self.hidden_size = int(hidden_size)
        self.ffn_size = int(ffn_size)
        self.num_experts = int(num_experts)
        self.top_k = top_k
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        for pname, shape, init in self._laws():
            setattr(self, pname, create_parameter(
                shape, default_initializer=init, generator=generator,
                device=device))
        self.aux_loss = None

    def _laws(self):
        """(name, shape, initializer) of each parameter, in the
        reference's order of creation."""
        E, H, F = self.num_experts, self.hidden_size, self.ffn_size
        return [('gate_w', [H, E], I.XavierUniform()),
                ('w1', [E, H, F], I.KaimingUniform()),
                ('b1', [E, 1, F], I.Constant(0.0)),
                ('w2', [E, F, H], I.KaimingUniform()),
                ('b2', [E, 1, H], I.Constant(0.0))]

    def reset_parameters(self, generator):
        for pname, _, init in self._laws():
            init.fill_(getattr(self, pname), generator)

    def _capacity(self, S):
        return max(1, int(math.ceil(
            S / self.num_experts * self.capacity_factor)))

    def forward(self, x, return_aux=False):
        """Route ``x [..., H]`` through the experts; with ``return_aux``
        returns ``(y, aux_loss)``.  ``.aux_loss`` is set anew by every
        forward, so a loss reads the value of the forward it follows."""
        self.aux_loss = None
        x, gw, w1, b1, w2, b2 = amp_cast('switch_moe', x, self.gate_w,
                                         self.w1, self.b1, self.w2, self.b2)
        S = math.prod(x.shape[:-1])
        C = self._capacity(S * self.top_k)
        xs = x.reshape(S, self.hidden_size)
        # after the cast: under O2 the gate sees gate_w rounded to bf16
        probs = torch.softmax(xs.float() @ gw.float(), dim=-1)
        dispatch, combine, aux = route(probs, self.top_k, C, xs.dtype)
        ein = torch.einsum('sec,sh->ech', dispatch, xs)
        h = torch.einsum('ech,ehf->ecf', ein, w1) + b1.to(ein.dtype)
        h = TF.gelu(h, approximate='tanh') if self.activation == 'gelu' \
            else torch.relu(h)
        out = torch.einsum('ecf,efh->ech', h, w2) + b2.to(h.dtype)
        y = torch.einsum('ech,sec->sh', out, combine.to(out.dtype))
        y = y.reshape(x.shape)
        self.aux_loss = aux
        if return_aux:
            return y, aux
        return y

    def extra_repr(self):
        return (f'experts={self.num_experts}, top_k={self.top_k}, '
                f'{self.hidden_size}->{self.ffn_size}')
