"""Data parallelism of the port in a world of 4 gloo processes on the
CPU, against the JAX package on its mesh over the 8 virtual CPU
devices.

One launch of 4 workers (``tests/torch_dist_worker.py``) runs, in
order: ``ParallelTrainer`` on ``gpt_tiny`` (2 layers) at dp 4 and dp 2 x
tp 2, each rank taking its ``dp`` rows of the same global batch;
BERT at dp 2 x tp 2 with the masked labels spread unevenly over the two
``dp`` halves (the MLM mean over the global count); a conv + BatchNorm
net at dp 4, with and without ``gradient_merge`` k 2 (statistics over
the global batch); ``DataParallel``'s eager loop on quarter batches
(``SyncBatchNorm`` by conversion, ``scale_loss``,
``apply_collective_grads``); a loss that sums its rows (DDP's
convention, a documented difference); ``nan_guard`` with a poisoned row
on one rank and a step only one rank finds non-finite; ``gpt_tiny`` at
dropout 0.1 (port against port: the streams); ``fleet.init``'s inferred
dp, the hybrid group's ranks and groups, ``fleet.metrics``,
``fleet.util`` and ``DistributedBatchSampler``; and every refusal that
stays, each citing its ROADMAP item.  The JAX trainer under the same
degrees (and the JAX net on the full batch for ``DataParallel``) runs
while the workers do.  ``distributed.launch`` starts two workers of a
script on its own.

Tolerances: f32 losses within 2e-5, parameters within 1e-4 after 3
steps (the attention key's bias and round-off entries within AdamW's
bound, ``tests/torch_dist_oracle.py``); the SGD nets' losses,
parameters, gradients, outputs and statistics within 1e-4 (2e-5 for
the forward); port against port, bit for bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.jit import functional_call
from paddle_tpu.models import bert as jbert
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch import convert

import torch_dist_oracle as oracle
import torch_dist_worker as worker

TOL, GRAD_TOL = 2e-5, 1e-4
rs = np.random.RandomState(5)
BERT_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
               max_seq_len=64, dropout=0.0)
BERT_IDS = rs.randint(0, 128, (8, 16)).astype(np.int64)
# the first dp half (rows 0-3) holds most of the masked tokens
_MASK = rs.rand(8, 16) < np.where(np.arange(8) < 4, 0.6, 0.06)[:, None]
BERT_MLM = np.where(_MASK, rs.randint(0, 128, (8, 16)), -100) \
    .astype(np.int64)
BERT_NSP = rs.randint(0, 2, (8,)).astype(np.int64)
CONV_X = rs.randn(8, 3, 6, 6).astype(np.float32)
CONV_Y = rs.randn(8, 4).astype(np.float32)
SUM_X = rs.randn(8, 5).astype(np.float32)
SUM_Y = rs.randn(8, 3).astype(np.float32)
SGD_LR = 0.1
FILES = [f'part-{i}' for i in range(7)]


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_trainer_run(model, loss_fn, batch, steps, dp=-1, tp=1, merge=1,
                     n_inputs=1):
    """The JAX trainer with SGD over ``dp x tp``: losses, parameters
    and buffers after ``steps`` steps."""
    st = oracle.strategy(dp, tp, merge=merge)
    jfleet.init(is_collective=True, strategy=st)
    try:
        tr = JaxTrainer(model, JaxSGD(learning_rate=SGD_LR,
                                      parameters=model.parameters()),
                        loss_fn, strategy=st, n_inputs=n_inputs)
        losses = [tr.loss_float(tr.step(*batch)) for _ in range(steps)]
        return (losses, {k: np.asarray(v) for k, v in tr.params.items()},
                {k: np.asarray(v) for k, v in tr.buffers.items()})
    finally:
        jenv.set_mesh(None)


def _conv_bn_state():
    jpaddle.seed(4)
    net = worker.conv_bn_net(jpaddle)
    params, buffers = net.functional_state()
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in buffers.items()})


def _jax_conv_bn(params, buffers, dp, merge=1):
    net = worker.conv_bn_net(jpaddle)
    net.load_functional_state(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in buffers.items()})
    return _jax_trainer_run(
        net, lambda out, t: jpaddle.nn.functional.mse_loss(out, t),
        (CONV_X, CONV_Y), oracle.STEPS, dp=dp, merge=merge)


def _jax_full_batch(params, buffers):
    """The JAX net on the whole batch, in train mode: the output, the
    gradients of the MSE and the moved statistics."""
    net = worker.conv_bn_net(jpaddle)

    def f(p):
        out, new = functional_call(net, p, {k: jnp.asarray(v) for k, v in
                                            buffers.items()},
                                   (jnp.asarray(CONV_X),), training=True)
        return jnp.mean((out - CONV_Y) ** 2), (out, new)
    (loss, (out, new)), grads = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    return {'loss': float(loss), 'out': np.asarray(out),
            'grads': {k: np.asarray(v) for k, v in grads.items()},
            'buffers': {k: np.asarray(v) for k, v in new.items()}}


def _jax_sum_loss(params, dp):
    net = jpaddle.nn.Linear(5, 3)
    net.load_functional_state({k: jnp.asarray(v) for k, v in
                               params.items()})
    st = oracle.strategy(dp)
    jfleet.init(is_collective=True, strategy=st)
    try:
        tr = JaxTrainer(net, JaxSGD(learning_rate=SGD_LR,
                                    parameters=net.parameters()),
                        lambda out, t: ((out - t) ** 2).sum(), strategy=st)
        before = {k: np.asarray(v) for k, v in tr.params.items()}
        loss = tr.loss_float(tr.step(SUM_X, SUM_Y))
        grads = {k: (before[k] - np.asarray(v)) / SGD_LR
                 for k, v in tr.params.items()}
    finally:
        jenv.set_mesh(None)
    return loss, grads


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    gpt_host = oracle.gpt_weights()
    jpaddle.seed(9)
    bert_host = {k: np.asarray(v) for k, v in
                 jbert.bert_tiny(**BERT_KW).functional_state()[0].items()}
    conv_p, conv_b = _conv_bn_state()
    jpaddle.seed(2)
    sum_p = {k: np.asarray(v) for k, v in
             jpaddle.nn.Linear(5, 3).functional_state()[0].items()}
    gpt = dict(host=gpt_host, ids=oracle.IDS, steps=oracle.STEPS,
               lr=oracle.LR, model_kw=oracle.MODEL_KW)
    jobs = [('dp4', 'gpt_train', dict(gpt, dp=4, tp=1)),
            ('dp2tp2', 'gpt_train', dict(gpt, dp=2, tp=2)),
            ('bert', 'bert_train',
             dict(host=bert_host, ids=BERT_IDS, mlm=BERT_MLM, nsp=BERT_NSP,
                  dp=2, tp=2, steps=oracle.STEPS, lr=SGD_LR,
                  model_kw=BERT_KW)),
            ('conv', 'conv_bn_train',
             dict(params=conv_p, buffers=conv_b, x=CONV_X, y=CONV_Y, dp=4,
                  steps=oracle.STEPS, lr=SGD_LR)),
            ('conv_merge', 'conv_bn_train',
             dict(params=conv_p, buffers=conv_b, x=CONV_X, y=CONV_Y, dp=4,
                  steps=oracle.STEPS, lr=SGD_LR, merge=2)),
            ('eager', 'data_parallel_eager',
             dict(params=conv_p, buffers=conv_b, x=CONV_X, y=CONV_Y,
                  lr=SGD_LR)),
            ('sum', 'sum_loss', dict(params=sum_p, x=SUM_X, y=SUM_Y, dp=4,
                                     lr=SGD_LR)),
            ('nan', 'nan_guard', dict(steps=5, lr=SGD_LR)),
            ('dropout', 'dropout_streams',
             dict(host=gpt_host, ids=oracle.IDS, steps=oracle.STEPS,
                  lr=oracle.LR, model_kw=oracle.MODEL_KW)),
            ('fleet', 'fleet_surface', dict(files=FILES)),
            ('raises', 'raises', {})]
    job = worker.start(jobs, tmp_path_factory.mktemp('dp'), nproc=4,
                       timeout=150)
    try:
        want = {name: oracle.jax_gpt_run(gpt_host, dp, tp)
                for name, dp, tp in (('dp4', 4, 1), ('dp2tp2', 2, 2))}
        want['noisy'] = oracle.roundoff(gpt_host)
        jm = jbert.bert_tiny(**BERT_KW)
        jm.load_functional_state({k: jnp.asarray(v)
                                  for k, v in bert_host.items()})
        want['bert'] = _jax_trainer_run(
            jm, lambda out, *ys: jm.loss(out, *ys),
            (BERT_IDS, BERT_MLM, BERT_NSP), oracle.STEPS, dp=2, tp=2)
        want['conv'] = _jax_conv_bn(conv_p, conv_b, 4)
        want['conv_merge'] = _jax_conv_bn(conv_p, conv_b, 4, merge=2)
        want['eager'] = _jax_full_batch(conv_p, conv_b)
        want['eager_params'] = conv_p
        want['sum'] = _jax_sum_loss(sum_p, 4)
    finally:
        got = job.wait()
    return got, want


def _close(a, b, tol, msg=''):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize('name,dp,tp', [('dp4', 4, 1), ('dp2tp2', 2, 2)])
def test_gpt_trainer_matches_the_jax_trainer(launched, name, dp, tp):
    got, want = launched
    want_l, want_p = want[name]
    for r in range(4):
        _close(got[r][name]['losses'], want_l, oracle.TOL)
    params = convert.gather_state([g[name]['params'] for g in got],
                                  oracle.port_mesh(dp, tp),
                                  oracle.gpt_specs())
    oracle.params_close(params, want_p, want['noisy'])
    # the dp replicas hold the same parameters
    for r in range(4):
        other = got[r % tp][name]['params']
        for k, v in got[r][name]['params'].items():
            np.testing.assert_array_equal(v, other[k], err_msg=k)


def test_bert_mlm_mean_spans_uneven_masks(launched):
    """Trap 2: the dp halves hold 4x different counts of masked tokens;
    the ranks' mean is the reference's global masked mean."""
    got, want = launched
    counts = [(BERT_MLM[h * 4:(h + 1) * 4] != -100).sum() for h in (0, 1)]
    assert counts[0] > 3 * counts[1] > 0
    want_l, want_p, _ = want['bert']
    for r in range(4):
        _close(got[r]['bert']['losses'], want_l, TOL)
    from paddle_tpu_torch.models.bert import bert_tiny
    params = convert.gather_state([g['bert']['params'] for g in got],
                                  oracle.port_mesh(2, 2),
                                  bert_tiny(device='meta', **BERT_KW))
    for k, v in want_p.items():
        _close(params[k], v, GRAD_TOL, k)


@pytest.mark.parametrize('name', ['conv', 'conv_merge'])
def test_conv_batch_norm_over_dp_matches_the_jax_mesh(launched, name):
    """Trap 5: BatchNorm's statistics (and the running ones) over the
    global batch, and each global micro-batch under the merge."""
    got, want = launched
    want_l, want_p, want_b = want[name]
    for r in range(4):
        run = got[r][name]
        _close(run['losses'], want_l, TOL)
        for k, v in want_p.items():
            _close(run['params'][k], v, GRAD_TOL, k)
        for k, v in want_b.items():
            _close(run['buffers'][k], v, GRAD_TOL, k)


def test_data_parallel_eager_loop_is_the_full_batch(launched):
    got, want = launched
    w = want['eager']
    for r in range(4):
        run = got[r]['eager']
        assert run['sync'] == 'SyncBatchNorm'
        _close(run['out'], w['out'][2 * r:2 * r + 2], TOL)
        for k, g in w['grads'].items():
            _close(run['grads'][k], g, GRAD_TOL, k)
            _close(run['params'][k], want['eager_params'][k] - SGD_LR * g,
                   GRAD_TOL, k)
        for k, v in w['buffers'].items():
            _close(run['buffers'][k], v, GRAD_TOL, k)


def test_a_summed_loss_takes_the_ddp_convention(launched):
    """A documented difference: a loss that sums its rows gives the
    ranks' mean of the local sums, the reference's global sum over
    ``dp``."""
    got, want = launched
    jloss, jgrads = want['sum']
    for r in range(4):
        _close(got[r]['sum']['loss'] * 4, jloss, 1e-4)
        for k, g in jgrads.items():
            _close(got[r]['sum']['grads'][k] * 4, g, 1e-3, k)


def test_nan_guard_skips_on_every_rank(launched):
    got, _ = launched
    for r in range(4):
        run = got[r]['nan']
        # step 2: rank 1's row is NaN; step 4: only rank 2's flag is off
        assert run['steps'] == [1, 1, 2, 2, 3]
        assert run['skipped'] == 2
        for k, v in run['params'].items():
            np.testing.assert_array_equal(v, got[0]['nan']['params'][k])


def test_dropout_streams(launched):
    """Trap 3, port against port at dropout 0.1: the replicated
    parameters stay bit-equal over the tp ranks after 3 steps, the
    default stream draws alike within a tp group and otherwise across
    dp, the ``model_parallel`` stream differently on every rank."""
    got, _ = launched
    runs = [g['dropout'] for g in got]
    specs = {n for n in runs[0]['params']
             if n.endswith(('qkv.weight', 'qkv.bias', 'fc.weight', 'fc.bias',
                            'proj.weight', 'wte.weight'))}
    for a, b in ((0, 1), (2, 3)):
        for k, v in runs[a]['params'].items():
            if k not in specs:
                np.testing.assert_array_equal(v, runs[b]['params'][k],
                                              err_msg=k)
        np.testing.assert_array_equal(runs[a]['default_draw'],
                                      runs[b]['default_draw'])
    assert not np.array_equal(runs[0]['default_draw'],
                              runs[2]['default_draw'])
    draws = [r['mp_draw'].tobytes() for r in runs]
    assert len(set(draws)) == 4
    assert np.all(np.isfinite(runs[0]['losses']))


def test_fleet_surface_over_four_ranks(launched):
    got, _ = launched
    world = np.array([[r + 1.0, 2.0 * r] for r in range(4)], np.float32)
    for r in range(4):
        f = got[r]['fleet']
        assert f['mesh'] == {'pp': 1, 'dp': 2, 'sp': 1, 'ep': 1, 'tp': 2}
        assert f['sizes'] == (2, 2, 1, 1)
        assert f['ranks'] == (r // 2, r % 2, 0)
        assert f['dp_group'] == [r % 2, r % 2 + 2]
        assert f['tp_group'] == [r // 2 * 2, r // 2 * 2 + 1]
        assert f['pp_group'] == [r]
        assert f['comm_tp'] == [[0, 1], [2, 3]]
        assert f['worker'] == (r, 4, r == 0)
        np.testing.assert_array_equal(f['host']['sum'], world.sum(0))
        np.testing.assert_array_equal(f['host']['max'], world.max(0))
        np.testing.assert_array_equal(f['host']['min'], world.min(0))
        dp_rows = world[[r % 2, r % 2 + 2]]
        np.testing.assert_array_equal(f['in_step']['sum'], dp_rows.sum(0))
        np.testing.assert_array_equal(f['in_step']['max'], dp_rows.max(0))
        np.testing.assert_array_equal(f['in_step']['min'], dp_rows.min(0))
        pos = sum(np.arange(5) + i for i in range(4))
        neg = sum(np.arange(5)[::-1] * (i + 1) for i in range(4))
        assert f['auc'] == jfleet.metrics.auc(pos, neg)
        assert f['mae'] == (0.5 + 1.5 + 2.5 + 3.5) / 8.0
        assert f['acc'] == 6 / 16
        np.testing.assert_array_equal(f['util_sum'], [6, 4])
        np.testing.assert_array_equal(f['util_max'], [3, 1])
        assert f['util_gather'] == [0, 10, 20, 30]
        assert f['file_shard'] == jfleet.UtilBase(
            jfleet.UserDefinedRoleMaker(current_id=r, worker_num=4)) \
            .get_file_shard(FILES)
        nranks, local, batches = f['sampler']
        assert (nranks, local) == (2, r // 2)
        assert batches == [b.tolist() if hasattr(b, 'tolist') else b
                           for b in jpaddle.io.DistributedBatchSampler(
                               list(range(10)), batch_size=2,
                               num_replicas=2, rank=r // 2)]


@pytest.mark.parametrize('name,item', [
    ('pp_degree', '9d'), ('sp_degree', '9c'), ('ep_degree', '9c'),
    ('zero', '9d'), ('quant', '9d'), ('dgc', '9b'), ('save', '9b'),
    ('restore', '9b'), ('host', '9b'), ('serve', '9b')])
def test_what_stays_unported_raises_with_its_item(launched, name, item):
    got, _ = launched
    for r in range(4):
        msg = got[r]['raises'][name]
        assert msg is not None and f'item {item}' in msg, (name, msg)


def test_step_fused_refuses_a_gloo_world_on_the_card(launched):
    """gloo's collectives on CUDA tensors go through host memory, which a
    CUDA graph cannot capture: ``step_fused`` refuses before a step."""
    got, _ = launched
    for r in range(4):
        assert 'gloo' in (got[r]['raises']['fused_gloo'] or '')


def test_launch_starts_one_worker_a_card(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch --nproc-per-node
    2`` runs two workers of a script, each with its rank, the world and
    its card, meeting over a FileStore; and ``--coordinator`` gives a
    one-worker node its node-major rank and the rendezvous address."""
    script = tmp_path / 'train.py'
    script.write_text(
        'import os, sys\n'
        'import torch\n'
        'import paddle_tpu_torch as paddle\n'
        'env = {k: os.environ.get(k) for k in ("PADDLE_TRAINER_ID",\n'
        '       "PADDLE_TRAINERS_NUM", "FLAGS_selected_gpus",\n'
        '       "MASTER_ADDR", "MASTER_PORT", "PADDLE_RANK_IN_NODE")}\n'
        'if sys.argv[1] == "join":\n'
        '    paddle.distributed.init_parallel_env()\n'
        '    t = torch.ones(1)\n'
        '    paddle.distributed.all_reduce(t)\n'
        '    env["sum"] = str(int(t.item()))\n'
        'out = os.path.join(os.path.dirname(__file__),\n'
        '                   "rank%s.txt" % env["PADDLE_TRAINER_ID"])\n'
        'open(out, "w").write(repr(env))\n')
    env = dict(os.environ, PADDLE_DISTRI_BACKEND='gloo',
               PADDLE_DIST_INIT_METHOD='file://' + str(tmp_path / 'store'),
               PADDLE_DIST_TIMEOUT='60', GLOO_SOCKET_IFNAME='lo',
               CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=worker.REPO)
    cmd = [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch']
    subprocess.run(cmd + ['--nproc-per-node', '2', str(script), 'join'],
                   env=env, check=True, timeout=90, cwd=tmp_path)
    for r in range(2):
        seen = eval((tmp_path / f'rank{r}.txt').read_text())
        assert (seen['PADDLE_TRAINER_ID'], seen['PADDLE_TRAINERS_NUM'],
                seen['FLAGS_selected_gpus'], seen['PADDLE_RANK_IN_NODE'],
                seen['sum']) == (str(r), '2', str(r), str(r), '2')
    env.pop('PADDLE_DIST_INIT_METHOD')
    subprocess.run(cmd + ['--coordinator', '127.0.0.1:29871', '--nnodes',
                          '2', '--node-rank', '1', '--nproc-per-node', '1',
                          str(script), 'env'],
                   env=env, check=True, timeout=60, cwd=tmp_path)
    seen = eval((tmp_path / 'rank1.txt').read_text())
    assert (seen['PADDLE_TRAINERS_NUM'], seen['MASTER_ADDR'],
            seen['MASTER_PORT']) == ('2', '127.0.0.1', '29871')
