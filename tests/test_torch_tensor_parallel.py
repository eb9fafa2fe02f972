"""Tensor parallelism of the port in a world of 4 gloo processes on the
CPU, against the JAX package on its mesh over the 8 virtual CPU
devices.

One launch of 4 workers (``tests/torch_dist_worker.py``) runs, in
order: ``fleet.meta_parallel``'s three layers, ``ParallelCrossEntropy``,
``ops.fused_ce.fused_linear_cross_entropy_tp`` and ``mp_ops.split`` at
tp 2 and tp 4 (each rank holding its shards, cut from the same full
weights by ``convert.shard_state``); GPT's and BERT's training forward
and loss at tp 2 (whole heads of the fused qkv a rank); and
``ParallelTrainer`` on ``gpt_tiny`` at tp 4 and at dp 2 x tp 2 under
``gradient_merge`` k 2, ``recompute``, a binding global-norm clip, a
binding per-tensor clip and bf16 O2.  The JAX oracles
(the reference's layers under ``jax.jit`` with their shardings over the
mesh ``fleet.init`` installs, its vocab-parallel head inside
``shard_map``, its models, its trainer under the same degrees) run
while the workers do; the parametrised cases read both.

Tolerances: f32 forwards within 2e-5 and gradients within 1e-4; the
trainer's losses within 2e-5 and its parameters within 1e-4 after 3
steps, the attention key's bias and the entries whose gradient is
round-off within AdamW's bound (``tests/torch_dist_oracle.py``); bf16
O2 losses within 2e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu import nn as jnn
from paddle_tpu.core.jaxcompat import shard_map
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.jit import functional_call
from paddle_tpu.models import bert as jbert
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy_tp as jfce_tp
from paddle_tpu.parallel.api import (collect_param_shardings as
                                     jcollect, named_sharding)
from paddle_tpu_torch import convert
from paddle_tpu_torch.parallel import api as papi
from paddle_tpu_torch.models.gpt import gpt_tiny

import torch_dist_oracle as oracle
import torch_dist_worker as worker

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
rs = np.random.RandomState(3)
DATA = dict(
    x=rs.randn(4, 8).astype(np.float32),
    w_col=rs.randn(8, 12).astype(np.float32) * 0.3,
    b_col=rs.randn(12).astype(np.float32),
    w_row=rs.randn(12, 8).astype(np.float32) * 0.3,
    b_row=rs.randn(8).astype(np.float32),
    emb=rs.randn(16, 6).astype(np.float32),
    ids=rs.randint(0, 16, (2, 5)).astype(np.int64),
    logits=rs.randn(6, 16).astype(np.float32) * 2,
    labels=np.array([3, 15, -100, 0, 8, 7], np.int64),
    ce_x=rs.randn(6, 8).astype(np.float32),
    ce_w=rs.randn(8, 16).astype(np.float32) * 0.5,
    ce_labels=np.array([1, 9, 15, 0, 8, 4], np.int64),
    split_x=rs.randn(3, 8).astype(np.float32))
BERT_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
               max_seq_len=64, dropout=0.0)
BERT_IDS = rs.randint(0, 128, (2, 16)).astype(np.int64)
BERT_LABELS = np.where(rs.rand(2, 16) < 0.3, rs.randint(0, 128, (2, 16)),
                       -100).astype(np.int64)
# 'clip': the global norm binds (0.5 under the first step's 0.885), so
# the shards' squares must be summed over tp; 'clip_norm': the
# per-tensor norm binds on every weight matrix (0.05 under the first
# step's 0.13 to 0.55), so each sharded tensor's squares are summed over tp
TRAIN = {'tp4': dict(dp=1, tp=4), 'merge2': dict(dp=2, tp=2, merge=2),
         'recompute': dict(dp=2, tp=2, recompute=True),
         'clip': dict(dp=2, tp=2, clip=0.5),
         'clip_norm': dict(dp=2, tp=2, clip=0.05, clip_by='norm'),
         'o2': dict(dp=2, tp=2, o2=True)}


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _c(shape, lo=-1.0, hi=1.0):
    n = int(np.prod(shape))
    return np.linspace(lo, hi, n, dtype=np.float32).reshape(shape)


def _jax_layers(tp):
    """The reference's layers under its mesh: the outputs and the
    gradients of the port's weighted sums."""
    st = jfleet.DistributedStrategy()
    st.hybrid_configs['mp_degree'] = tp
    jfleet.init(is_collective=True, strategy=st)
    out = {}
    try:
        net = jnn.Sequential(
            jfleet.ColumnParallelLinear(8, 12, gather_output=False),
            jfleet.RowParallelLinear(12, 8, input_is_parallel=True))
        specs = jcollect(net)
        params = {'0.weight': DATA['w_col'], '0.bias': DATA['b_col'],
                  '1.weight': DATA['w_row'], '1.bias': DATA['b_row']}
        params = {n: jax.device_put(jnp.asarray(v),
                                    named_sharding(specs[n], v.ndim))
                  for n, v in params.items()}
        c = jnp.asarray(_c((4, 8)))

        def mlp(params, x):
            y, _ = functional_call(net, params, {}, (x,), training=False)
            return jnp.sum(y * c), y
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            mlp, argnums=(0, 1), has_aux=True))(params,
                                               jnp.asarray(DATA['x']))
        out['mlp_y'], out['mlp_dx'] = np.asarray(y), np.asarray(gx)
        out['mlp_grads'] = {k: np.asarray(v) for k, v in gp.items()}
        emb = jfleet.VocabParallelEmbedding(16, 6)
        ce = _c((2, 5, 6))

        def lookup(w):
            h, _ = functional_call(emb, {'weight': w}, {},
                                   (jnp.asarray(DATA['ids']),))
            return jnp.sum(h * ce), h
        (_, h), gw = jax.value_and_grad(lookup, has_aux=True)(
            jnp.asarray(DATA['emb']))
        out['emb_y'], out['emb_grad'] = np.asarray(h), np.asarray(gw)
        pce = jfleet.ParallelCrossEntropy()
        lw = _c((6,), 0.5, 1.5)

        def xent(z):
            per = pce(JaxTensor._from_value(z),
                      JaxTensor._from_value(jnp.asarray(DATA['labels'])))
            return jnp.sum(per.value * lw), per.value
        (_, per), gz = jax.value_and_grad(xent, has_aux=True)(
            jnp.asarray(DATA['logits']))
        out['pce'], out['pce_grad'] = np.asarray(per), np.asarray(gz)
        mesh = Mesh(np.asarray(jax.devices()[:tp]), ('tp',))

        def head(x, w, y):
            def f(xv, wv):
                loss = jfce_tp(xv, wv, y, axis='tp', num_chunks=2)
                return jnp.sum(loss * lw), loss
            (_, loss), (dx, dw) = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(x, w)
            return loss, dx, dw
        loss, dx, dw = shard_map(
            head, mesh=mesh, in_specs=(P(), P(None, 'tp'), P()),
            out_specs=(P(), P(), P(None, 'tp')), check_vma=False)(
                jnp.asarray(DATA['ce_x']), jnp.asarray(DATA['ce_w']),
                jnp.asarray(DATA['ce_labels']))
        out['fce'], out['fce_dx'], out['fce_dw'] = (
            np.asarray(loss), np.asarray(dx), np.asarray(dw))
        out['specs'] = jcollect(net)
    finally:
        jenv.set_mesh(None)
    return out


def _jax_model(kind, host):
    """The JAX model's training forward, loss and gradients."""
    if kind == 'gpt':
        jm = jax_gpt_tiny(**oracle.MODEL_KW)
        ids, labels = oracle.IDS[:2], oracle.IDS[:2]
    else:
        jm = jbert.bert_tiny(**BERT_KW)
        ids, labels = BERT_IDS, BERT_LABELS
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    params, buffers = jm.functional_state()

    def f(params):
        out, _ = functional_call(jm, params, buffers, (jnp.asarray(ids),),
                                 training=True)
        outs = jax.tree_util.tree_map(JaxTensor._from_value, out)
        loss = jm.loss(outs, JaxTensor._from_value(jnp.asarray(labels)))
        return loss.value, out if kind == 'gpt' else out[0]
    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    return {'loss': float(loss), 'logits': np.asarray(logits),
            'grads': {k: np.asarray(v) for k, v in grads.items()},
            'specs': jcollect(jm)}


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    gpt_host = oracle.gpt_weights()
    jpaddle_seed = 9
    import paddle_tpu as jpaddle
    jpaddle.seed(jpaddle_seed)
    bert_host = {k: np.asarray(v) for k, v in
                 jbert.bert_tiny(**BERT_KW).functional_state()[0].items()}
    jobs = [(f'layers{tp}', 'tp_layers', dict(tp=tp, **DATA))
            for tp in (2, 4)]
    jobs += [('gpt', 'model_forward',
              dict(kind='gpt', tp=2, host=gpt_host, ids=oracle.IDS[:2],
                   model_kw=oracle.MODEL_KW)),
             ('bert', 'model_forward',
              dict(kind='bert', tp=2, host=bert_host, ids=BERT_IDS,
                   model_kw=BERT_KW, labels=BERT_LABELS))]
    jobs += [(name, 'gpt_train',
              dict(host=gpt_host, ids=oracle.IDS, steps=oracle.STEPS,
                   lr=oracle.LR, model_kw=oracle.MODEL_KW, **kw))
             for name, kw in TRAIN.items()]
    job = worker.start(jobs, tmp_path_factory.mktemp('tp'), nproc=4,
                       timeout=150)
    try:
        want = {f'layers{tp}': _jax_layers(tp) for tp in (2, 4)}
        want['gpt'] = _jax_model('gpt', gpt_host)
        want['bert'] = _jax_model('bert', bert_host)
        for name, kw in TRAIN.items():
            want[name] = oracle.jax_gpt_run(gpt_host, **kw)
        want['noisy'] = oracle.roundoff(gpt_host)
    finally:
        got = job.wait()
    return got, want, {'gpt': gpt_host, 'bert': bert_host}


def _ranks(tp):
    """The ranks of the first tp group (dp coordinate 0) at world 4."""
    return list(range(tp))


def _join(got, key, tp, dim, groups=1):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import join_shards
    return join_shards([got[r][key] for r in _ranks(tp)], dim, groups)


@pytest.mark.parametrize('tp', [2, 4])
def test_column_and_row_parallel_linears_match_the_jax_mesh(launched, tp):
    got, want, _ = launched
    runs, w = [g[f'layers{tp}'] for g in got], want[f'layers{tp}']
    for r in range(4):
        for tag in ('mlp', 'gather'):
            np.testing.assert_allclose(runs[r][f'{tag}_y'], w['mlp_y'],
                                       rtol=FWD_TOL, atol=FWD_TOL)
            np.testing.assert_allclose(runs[r][f'{tag}_dx'], w['mlp_dx'],
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
    for tag in ('mlp', 'gather'):
        grads = [r[f'{tag}_grads'] for r in runs[:tp]]
        for name, dim, key in (('0.weight', 1, ('col', 'weight')),
                               ('0.bias', 0, ('col', 'bias')),
                               ('1.weight', 0, ('row', 'weight'))):
            from paddle_tpu_torch.distributed.fleet.meta_parallel import \
                join_shards
            full = join_shards([g[key[0]][key[1]] for g in grads], dim)
            np.testing.assert_allclose(full, w['mlp_grads'][name],
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f'{tag} {name}')
        for g in grads:     # the row bias is whole on every rank
            np.testing.assert_allclose(g['row']['bias'],
                                       w['mlp_grads']['1.bias'],
                                       rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize('tp', [2, 4])
def test_vocab_parallel_embedding_matches_the_jax_mesh(launched, tp):
    got, want, _ = launched
    runs, w = [g[f'layers{tp}'] for g in got], want[f'layers{tp}']
    for r in range(4):
        np.testing.assert_allclose(runs[r]['emb_y'], w['emb_y'],
                                   rtol=FWD_TOL, atol=FWD_TOL)
    full = np.concatenate([r['emb_grad'] for r in runs[:tp]])
    np.testing.assert_allclose(full, w['emb_grad'], rtol=GRAD_TOL,
                               atol=GRAD_TOL)


@pytest.mark.parametrize('tp', [2, 4])
def test_parallel_cross_entropy_matches_the_reference(launched, tp):
    got, want, _ = launched
    runs, w = [g[f'layers{tp}'] for g in got], want[f'layers{tp}']
    for r in range(4):
        np.testing.assert_allclose(runs[r]['pce'], w['pce'], rtol=FWD_TOL,
                                   atol=FWD_TOL)
    full = np.concatenate([r['pce_grad'] for r in runs[:tp]], axis=1)
    np.testing.assert_allclose(full, w['pce_grad'], rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    assert w['pce'][2] == 0 and np.all(full[2] == 0)   # ignore_index


@pytest.mark.parametrize('tp', [2, 4])
def test_vocab_parallel_fused_head_matches_the_jax_shard_map(launched, tp):
    got, want, _ = launched
    runs, w = [g[f'layers{tp}'] for g in got], want[f'layers{tp}']
    for r in range(4):
        np.testing.assert_allclose(runs[r]['fce'], w['fce'], rtol=FWD_TOL,
                                   atol=FWD_TOL)
        np.testing.assert_allclose(runs[r]['fce_dx'], w['fce_dx'],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    full = np.concatenate([r['fce_dw'] for r in runs[:tp]], axis=1)
    np.testing.assert_allclose(full, w['fce_dw'], rtol=GRAD_TOL,
                               atol=GRAD_TOL)


@pytest.mark.parametrize('tp', [2, 4])
def test_split_builds_the_parallel_layers(launched, tp):
    """Each rank's ``split`` output is its tp group's layer applied: the
    group's shards joined (each dp replica draws its own: a trainer or
    ``DataParallel`` broadcasts dp rank 0's when it wraps them)."""
    got, _, _ = launched
    runs = [g[f'layers{tp}'] for g in got]
    x = DATA['split_x']
    for r in range(4):
        group = runs[r // tp * tp:(r // tp + 1) * tp]
        for name, dim, key in (('c', 1, 'split_col'),
                               ('r', 0, 'split_row')):
            w = np.concatenate([g['split_state'][name]['weight']
                                for g in group], axis=dim)
            b = group[0]['split_state'][name]['bias'] if dim == 0 else \
                np.concatenate([g['split_state'][name]['bias']
                                for g in group])
            np.testing.assert_allclose(runs[r][key], x @ w + b,
                                       rtol=FWD_TOL, atol=FWD_TOL)
        table = np.concatenate([g['split_state']['e']['weight']
                                for g in group])
        assert runs[r]['split_cached']
        np.testing.assert_allclose(runs[r]['split_emb'],
                                   table[DATA['ids']], rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize('kind', ['gpt', 'bert'])
def test_tp2_model_forward_and_gradients_match_jax(launched, kind):
    got, want, hosts = launched
    runs, w = [g[kind] for g in got], want[kind]
    mesh = oracle.port_mesh(2, 2)
    vs = w['logits'].shape[-1] // 2
    for r in range(4):
        tp = r % 2
        np.testing.assert_allclose(runs[r]['logits'],
                                   w['logits'][..., tp * vs:(tp + 1) * vs],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(runs[r]['loss'], w['loss'],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert runs[r]['round_trip']
    specs = runs[0]['specs']
    grads = convert.gather_state([r['grads'] for r in runs], mesh, specs)
    assert set(grads) <= set(w['grads'])
    for name in set(w['grads']) - set(grads):   # BERT's unused NSP head
        assert not np.any(w['grads'][name]), name
    for name, g in w['grads'].items():
        if name not in grads:
            continue
        np.testing.assert_allclose(grads[name], g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    state = convert.gather_state([r['state'] for r in runs], mesh, specs)
    for name, v in hosts[kind].items():
        np.testing.assert_array_equal(state[name], v)
    # the specs drive the cut: the reference's, with qkv's three sections
    assert {n for n, s in w['specs'].items() if s and 'tp' in s} == \
        set(specs)
    assert all(g == 3 for n, (d, g) in specs.items() if 'qkv' in n)


@pytest.mark.parametrize('name', ['tp4', 'merge2', 'recompute', 'clip',
                                  'clip_norm'])
def test_trainer_over_tp_matches_the_jax_trainer(launched, name):
    got, want, _ = launched
    want_l, want_p = want[name]
    cfg = TRAIN[name]
    for r in range(4):
        np.testing.assert_allclose(got[r][name]['losses'], want_l,
                                   rtol=oracle.TOL, atol=oracle.TOL)
    params = convert.gather_state([g[name]['params'] for g in got],
                                  oracle.port_mesh(cfg['dp'], cfg['tp']),
                                  oracle.gpt_specs())
    oracle.params_close(params, want_p, want['noisy'])


def test_trainer_over_tp_in_bf16_o2_matches_the_jax_trainer(launched):
    got, want, _ = launched
    want_l, _ = want['o2']
    for r in range(4):
        np.testing.assert_allclose(got[r]['o2']['losses'], want_l,
                                   rtol=oracle.O2_LOSS_RTOL)


def test_replicated_gradients_agree_across_tp_ranks(launched):
    """Trap 4: every replicated parameter's gradient is the same on the
    ranks of a tp group (the tied head's and the blocks' inputs cross
    ``copy_to_region``)."""
    got, _, _ = launched
    specs = got[0]['gpt']['specs']
    for name in ('tp4', 'recompute'):
        ranks = range(4) if name == 'tp4' else (0, 1)
        grads = [got[r][name]['grads'] for r in ranks]
        for p, g in grads[0].items():
            if p in specs:
                continue
            for other in grads[1:]:
                np.testing.assert_array_equal(other[p], g, err_msg=p)


def test_specs_follow_the_reference_at_one_process():
    """``parallel.api``: the zoo's specs are the reference's, and
    ``make_spec`` drops the axes the mesh lacks."""
    from paddle_tpu_torch.distributed.env import Mesh
    pm = gpt_tiny(device='cpu', **oracle.MODEL_KW)
    jm = jax_gpt_tiny(**oracle.MODEL_KW)
    assert papi.collect_param_shardings(pm) == jcollect(jm)
    mesh = Mesh(['dp', 'tp'], [2, 2])
    assert papi.make_spec((None, 'tp'), 2, mesh) == (None, 'tp')
    assert papi.make_spec(('sp', 'tp'), 3, mesh) == (None, 'tp', None)
    assert papi.make_spec(('...', 'tp'), 3, mesh) == (None, None, 'tp')
    assert papi.make_spec(None, 2, mesh) == ()
    assert papi.named_sharding((None, 'tp'), 2, mesh).spec == (None, 'tp')
    x = torch.ones(2)
    assert papi.maybe_shard(x, ('tp',)) is x


def test_parallel_layers_take_the_reference_signature_and_init():
    """Repairs of the one-process layers (each failed before it): the
    reference's positional signature (``weight_attr``, ``has_bias``) and
    ``VocabParallelEmbedding``'s XavierNormal draw at construction (it
    drew ``nn.Embedding``'s N(0, 1) unless a model redrew it)."""
    from paddle_tpu_torch.distributed import fleet
    col = fleet.ColumnParallelLinear(8, 4, None, False, device='cpu')
    row = fleet.RowParallelLinear(8, 4, None, False, device='cpu')
    assert col.bias is None and row.bias is None
    assert list(col.state_dict()) == list(jfleet.ColumnParallelLinear(
        8, 4, None, False).state_dict()) == ['weight']
    emb = fleet.VocabParallelEmbedding(1000, 64, device='cpu')
    want = np.sqrt(2.0 / (1000 + 64))
    assert abs(float(emb.weight.std()) / want - 1) < 0.05
    jemb = jfleet.VocabParallelEmbedding(1000, 64)
    assert abs(float(np.asarray(jemb.weight.value).std()) / want - 1) < 0.05


def test_flash_attention_spmd_is_the_local_launch():
    """``flash_attention_spmd`` on a rank's ``[B/dp, H/tp, T, D]``
    blocks is the kernels' launch on the local ``[B/dp * H/tp, T, D]``;
    its gate reads the global batch and heads against the mesh; a mesh
    with ``sp`` or ``pp`` above 1 raises with item 9c."""
    from paddle_tpu_torch.distributed.env import Mesh
    from paddle_tpu_torch.ops import flash_attention as fa_fn
    import importlib
    fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(2, 3, 16, 16).astype(np.float32))
               for _ in range(3))
    mesh = Mesh(['dp', 'tp'], [2, 2])
    got = fa.flash_attention_spmd(q, k, v, mesh, causal=True)
    want = fa_fn(q.reshape(6, 16, 16), k.reshape(6, 16, 16),
                 v.reshape(6, 16, 16), causal=True).reshape(2, 3, 16, 16)
    assert torch.equal(got, want)
    assert fa.can_use_pallas_spmd(4, 6, 16, 16, mesh)
    assert not fa.can_use_pallas_spmd(3, 6, 16, 16, mesh)
    assert not fa.can_use_pallas_spmd(4, 5, 16, 16, mesh)
    assert not fa.can_use_pallas_spmd(4, 6, 16, 16, None)
    for axis in ('sp', 'pp'):
        with pytest.raises(NotImplementedError, match='item 9c'):
            fa.flash_attention_spmd(q, k, v, Mesh([axis, 'tp'], [2, 1]))
