"""Tensor-parallel layers, the pipeline structure and the RNG tracker
(counterpart of ``paddle_tpu/distributed/fleet/meta_parallel.py``).

The reference's layers hold full logical parameters with a
PartitionSpec each, and XLA inserts the collectives.  Here each rank
holds its shard over the mesh's ``tp`` axis (``tp`` ranks, this rank
``r``), drawn as the full parameter is and then cut (``take_shard``),
so one seed gives the same model at every degree, and the collectives
are explicit autograd functions at the region boundaries (Megatron's):

- ``copy_to_region``: identity forward, all-reduce of the gradient
  over ``tp`` backward (where a replicated activation enters sharded
  work);
- ``reduce_from_region``: all-reduce forward, identity backward (where
  partial sums leave it);
- ``gather_from_region``/``scatter_to_region``: the last axis gathered
  or cut, and the converse backward.

``ColumnParallelLinear`` holds ``weight [in, out/tp]`` and its bias
(columns ``r``; with ``groups=g`` the columns of each of ``g`` equal
sections, so a fused qkv keeps whole heads: rank ``r`` holds the q, k
and v columns of heads ``[r nh/tp, (r+1) nh/tp)``);
``RowParallelLinear`` holds ``weight [in/tp, out]`` rows ``r`` and the
whole bias, added after the all-reduce; ``VocabParallelEmbedding``
holds vocab rows ``r``, zeroes the lookups of ids outside them and
all-reduces.  Sharded parameters carry ``_tp_group`` (the optimizer's
norms sum their squares over it).  At ``tp`` 1 every layer is the
plain one.  ``ParallelCrossEntropy`` is the vocab-parallel cross
entropy over logits split on the last axis (the max, the sum of
exponentials and the target logit all-reduced; the gradient local).

``PipelineLayer`` builds its ``LayerDesc``s, runs them in order and
splits them into contiguous stages (``stage_bounds``); the pipeline
schedule over several cards is ROADMAP item 9d.  ``RNGStatesTracker``
keeps named random streams: inside ``rng_state(name)`` every draw of
the port (``core.rng.generator``) comes from that stream's own
``torch.Generator`` on the device, seeded by ``add`` (or from the
name), and the global generators are left where they stood.  The
``model_parallel`` stream folds in this rank's ``tp`` and ``dp``
coordinates (the reference folds in the ``tp`` index), so sharded
activations draw other masks on each rank.
"""
import contextlib
import math
import zlib

import numpy as np
import torch

from ...amp import amp_cast
from ...core import rng as rng_mod
from ...nn import functional as F
from ...nn.initializer import Constant, Initializer, XavierNormal
from ...nn.layer.common import Embedding, Linear
from ...nn.layer.layers import Layer
from .. import collective
from .. import env as _env

__all__ = ['ColumnParallelLinear', 'RowParallelLinear',
           'VocabParallelEmbedding', 'ParallelCrossEntropy',
           'PipelineLayer', 'LayerDesc', 'SharedLayerDesc',
           'get_rng_state_tracker', 'RNGStatesTracker', 'copy_to_region',
           'reduce_from_region', 'gather_from_region', 'scatter_to_region',
           'parallel_cross_entropy', 'take_shard', 'join_shards',
           'tp_state']


def tp_state():
    """``(group, size, rank)`` of the global mesh's ``tp`` axis, or
    ``(None, 1, 0)`` where it has one rank."""
    mesh = _env.get_mesh()
    if mesh is None or mesh.axis_size('tp') <= 1:
        return None, 1, 0
    return mesh.group('tp'), mesh.axis_size('tp'), mesh.coords['tp']


def take_shard(x, dim, parts, index, groups=1):
    """Shard ``index`` of ``parts`` along ``dim`` of ``x`` (numpy or
    torch): with ``groups`` g, the ``index``-th of ``parts`` slices of
    each of g equal sections, joined."""
    n = x.shape[dim]
    if n % (groups * parts):
        raise ValueError(f'dim {dim} of {tuple(x.shape)} does not split '
                         f'into {groups} x {parts}')
    lead, tail = tuple(x.shape[:dim]), tuple(x.shape[dim + 1:])
    v = x.reshape(lead + (groups, parts, n // (groups * parts)) + tail)
    if isinstance(x, np.ndarray):
        v = np.take(v, index, axis=dim + 1)
    else:
        v = v.select(dim + 1, index)
    return v.reshape(lead + (n // parts,) + tail)


def join_shards(shards, dim, groups=1):
    """The inverse of ``take_shard`` over every index (numpy)."""
    parts = len(shards)
    n = shards[0].shape[dim]
    lead, tail = tuple(shards[0].shape[:dim]), tuple(shards[0].shape[dim + 1:])
    v = np.stack([np.asarray(s).reshape(lead + (groups, n // groups) + tail)
                  for s in shards], axis=dim + 1)
    return v.reshape(lead + (n * parts,) + tail)


class _Shard(Initializer):
    """The full parameter's draw by ``inner``, cut to this rank's
    shard."""

    def __init__(self, inner, full_shape, dim, parts, index, groups=1):
        self.inner, self.full_shape = inner, tuple(full_shape)
        self.cut = (dim, parts, index, groups)

    def _generate(self, shape, dtype, generator):
        full = self.inner(self.full_shape, dtype, generator)
        return take_shard(full, *self.cut).contiguous()


# -- the region boundaries ---------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce(g.contiguous().clone(),
                                     group=ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, groups):
        ctx.group, ctx.groups = group, groups
        parts = collective._gather(group, x)
        lead = tuple(x.shape[:-1])
        v = torch.stack([p.reshape(lead + (groups, -1)) for p in parts],
                        dim=-2)
        return v.reshape(lead + (-1,))

    @staticmethod
    def backward(ctx, g):
        return take_shard(g, g.dim() - 1, ctx.group.nranks, ctx.group.rank,
                          ctx.groups).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return take_shard(x, x.dim() - 1, group.nranks,
                          group.rank).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.group, 1), None


def copy_to_region(x, group):
    """Identity forward, gradient all-reduced over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_region(x, group):
    """All-reduce over ``group`` forward, identity backward."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_region(x, group, groups=1):
    """The last axis gathered over ``group`` (``take_shard``'s order)."""
    return x if group is None else _Gather.apply(x, group, groups)


def scatter_to_region(x, group):
    """This rank's slice of the last axis; the gradient gathered."""
    return x if group is None else _Scatter.apply(x, group)


def _mark(p, group):
    if p is not None and group is not None:
        p._tp_group = group
    return p


class ColumnParallelLinear(Linear):
    """``Y = XW + b`` with W's columns split over ``tp`` (``groups``
    sections, module docstring)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, groups=1):
        Layer.__init__(self)
        self._tp_group, tp, r = tp_state()
        self.gather_output = gather_output
        self.groups = groups
        self.in_features = in_features
        self.out_features = out_features // tp
        self._cut = (1, tp, r, groups)
        w_init = getattr(weight_attr, 'initializer', None) or XavierNormal()
        self._w_init = _Shard(w_init, (in_features, out_features), *self._cut)
        self._b_init = _Shard(Constant(0.0), (out_features,), 0, tp, r,
                              groups)
        self.weight = _mark(self.create_parameter(
            [in_features, self.out_features], attr=weight_attr,
            default_initializer=self._w_init, device=device),
            self._tp_group)
        self.bias = _mark(self.create_parameter(
            [self.out_features], attr=None if has_bias else False,
            is_bias=True, default_initializer=self._b_init, device=device),
            self._tp_group)
        self._param_shardings = {'weight': (None, 'tp'),
                                 'bias': ('tp',) if has_bias else None}
        self._shard_groups = {'weight': groups, 'bias': groups}

    def reset_parameters(self, generator):
        self._w_init.fill_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def enter(self, x):
        """The input as the sharded product takes it."""
        return copy_to_region(x, self._tp_group)

    def forward(self, x):
        y = F.linear(self.enter(x), self.weight, self.bias)
        if self.gather_output:
            return gather_from_region(y, self._tp_group, self.groups)
        return y


class RowParallelLinear(Linear):
    """``Y = XW + b`` with W's rows split over ``tp``: the partial
    products all-reduced, then the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None):
        Layer.__init__(self)
        self._tp_group, tp, r = tp_state()
        self.input_is_parallel = input_is_parallel
        self.in_features = in_features // tp
        self.out_features = out_features
        w_init = getattr(weight_attr, 'initializer', None) or XavierNormal()
        self._w_init = _Shard(w_init, (in_features, out_features), 0, tp, r)
        self.weight = _mark(self.create_parameter(
            [self.in_features, out_features], attr=weight_attr,
            default_initializer=self._w_init, device=device),
            self._tp_group)
        self.bias = self.create_parameter(
            [out_features], attr=None if has_bias else False, is_bias=True,
            device=device)
        self._param_shardings = {'weight': ('tp', None), 'bias': None}

    def reset_parameters(self, generator):
        self._w_init.fill_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        group = self._tp_group
        if group is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = scatter_to_region(x, group)
        y = reduce_from_region(F.linear(x, self.weight), group)
        if self.bias is None:
            return y
        y, b = amp_cast('linear', y, self.bias)
        return y + b


class VocabParallelEmbedding(Embedding):
    """Embedding whose vocab rows are split over ``tp``; its default
    init is XavierNormal over the whole table, as the reference's
    (``nn.Embedding`` draws N(0, 1))."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None):
        Layer.__init__(self)
        self._tp_group, tp, r = tp_state()
        self.num_embeddings = num_embeddings // tp
        self.embedding_dim = embedding_dim
        self.padding_idx = None
        self.sparse = False
        self.vocab_start = r * self.num_embeddings
        w_init = getattr(weight_attr, 'initializer', None) or XavierNormal()
        self._w_init = _Shard(w_init, (num_embeddings, embedding_dim), 0,
                              tp, r)
        self.weight = _mark(self.create_parameter(
            [self.num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=self._w_init, device=device),
            self._tp_group)
        self._param_shardings = {'weight': ('tp', None)}

    def reset_parameters(self, generator):
        self._w_init.fill_(self.weight, generator)

    def forward(self, x):
        group = self._tp_group
        if group is None:
            return F.embedding(x, self.weight)
        loc = x - self.vocab_start
        mine = (loc >= 0) & (loc < self.num_embeddings)
        out = F.embedding(torch.where(mine, loc, torch.zeros_like(loc)),
                          self.weight)
        out = out * mine[..., None].to(out.dtype)
        return reduce_from_region(out, group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross entropy of logits whose last axis is split over
    ``group`` (this rank's columns from ``col0``): f32, the gradient
    local."""

    @staticmethod
    def forward(ctx, z, labels, group, col0, ignore_index):
        zf = z.float()
        vs = zf.shape[-1]
        m = collective.all_reduce(zf.amax(dim=-1),
                                  collective.ReduceOp.MAX, group)
        e = torch.exp(zf - m[:, None])
        s = collective.all_reduce(e.sum(dim=-1), group=group)
        loc = labels - col0
        mine = (loc >= 0) & (loc < vs)
        safe = torch.where(mine, loc, torch.zeros_like(loc))
        picked = zf.gather(1, safe[:, None])[:, 0]
        zl = collective.all_reduce(
            torch.where(mine, picked, torch.zeros_like(picked)), group=group)
        valid = labels != ignore_index
        loss = torch.where(valid, torch.log(s) + m - zl,
                           torch.zeros_like(zl))
        ctx.save_for_backward(e, s, safe, mine, valid)
        ctx.dtype = z.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, safe, mine, valid = ctx.saved_tensors
        p = e / s[:, None]
        p.scatter_add_(1, safe[:, None], -mine.to(p.dtype)[:, None])
        scale = torch.where(valid, g.float(), torch.zeros_like(g.float()))
        return (p * scale[:, None]).to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(logits, labels, group, col0, ignore_index=-100):
    """Per-token cross entropy (no reduction) of ``logits [..., V/tp]``
    split over ``group`` (this rank's vocab columns start at ``col0``)
    against global ``labels``; 0 where the label is ``ignore_index``.
    Without a group, ``F.cross_entropy(reduction='none')``."""
    if group is None:
        return F.cross_entropy(logits, labels, reduction='none',
                               ignore_index=ignore_index)
    lead = labels.shape
    out = _VocabParallelCE.apply(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
        group, int(col0), ignore_index)
    return out.reshape(lead)


class ParallelCrossEntropy(Layer):
    """Cross entropy over logits split over ``tp`` on the last axis:
    per token, no reduction (module docstring)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._tp_group, self._tp, self._r = tp_state()

    def forward(self, input, label):
        label = torch.as_tensor(label, device=input.device)
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        return parallel_cross_entropy(input, label, self._tp_group,
                                      self._r * input.shape[-1],
                                      self.ignore_index)


# -- pipeline structure ------------------------------------------------------

class LayerDesc:
    """A deferred layer constructor: ``PipelineLayer`` builds it."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr='weight', *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """The full layer list, split into ``num_stages`` contiguous stages
    of ``ceil(n / num_stages)`` layers (the reference's uniform
    segmentation); on one device the forward runs them in order."""

    def __init__(self, layers, num_stages=1, loss_fn=None, topology=None,
                 seg_method='uniform', recompute_interval=0, **kwargs):
        super().__init__()
        self.descs = list(layers)
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.recompute_interval = recompute_interval
        built = []
        for i, d in enumerate(self.descs):
            layer = d.build_layer() if isinstance(d, LayerDesc) else d
            built.append(layer)
            if isinstance(layer, torch.nn.Module):
                self.add_sublayer(str(i), layer)
        self.run_function = built
        n = len(built)
        per = int(math.ceil(n / num_stages))
        self.stage_bounds = [(s * per, min(n, (s + 1) * per))
                             for s in range(num_stages)]

    def stage_layers(self, stage_id):
        lo, hi = self.stage_bounds[stage_id]
        return self.run_function[lo:hi]

    def forward(self, x):
        for fn in self.run_function:
            x = fn(x)
        return x


# -- rng tracker -------------------------------------------------------------

class RNGStatesTracker:
    """Named random streams (module docstring)."""

    def __init__(self):
        self.states = {}        # name -> seed
        self._gens = {}         # (name, device) -> torch.Generator

    def add(self, name, seed):
        self.states[name] = int(seed)
        for key in [k for k in self._gens if k[0] == name]:
            del self._gens[key]

    def _generator(self, name, device):
        seed = self.states[name]
        if name == 'model_parallel':
            mesh = _env.get_mesh()
            if mesh is not None and mesh.size > 1:
                seed = zlib.crc32(np.asarray(
                    [seed, mesh.coords.get('tp', 0),
                     mesh.coords.get('dp', 0)], np.int64).tobytes()) \
                    & 0x7fffffff
        key = (name, rng_mod._key(device), seed)
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key[1])
            gen.manual_seed(seed)
            self._gens[key] = gen
        return gen

    @contextlib.contextmanager
    def rng_state(self, name='model_parallel'):
        if name not in self.states:
            self.add(name, zlib.crc32(name.encode()) & 0x7fffffff)
        with rng_mod.scoped(lambda device: self._generator(name, device)):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker
