"""Worker of the port's multi-process tests (``tests/test_torch_
collective.py``, ``test_torch_tensor_parallel.py``,
``test_torch_data_parallel.py``); imports ``paddle_tpu_torch``, never
``jax`` or ``paddle_tpu``.

``launch(jobs, workdir, nproc)`` (called by a test) writes the jobs
(``[(name, kind, kwargs)]``, numpy inputs) to ``workdir/jobs.pkl`` and
starts ``nproc`` processes of this file through
``paddle_tpu_torch.distributed.utils.start_local_trainers``.  They meet
through a ``FileStore`` in ``workdir`` (no TCP port is fixed), over
gloo, with one torch thread each and a collective timeout; each runs
every job in order (``KINDS[kind](**kwargs)``) and writes
``{name: result}`` to ``workdir/rank{r}.pkl``.  The parent watches them
with a wall-clock limit of its own and kills every worker when it
passes or when one fails, so a test fails in its time and leaves no
process behind.

Run as ``python torch_dist_worker.py WORKDIR``.
"""
import os
import pickle
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the parent's side -------------------------------------------------------

class Launch:
    """Workers started by ``start``; ``wait()`` returns each rank's
    results in rank order, or raises (after killing every worker) when
    a worker fails or the wall-clock limit passes."""

    def __init__(self, procs, workdir, nproc, timeout):
        self.procs, self.workdir = procs, workdir
        self.nproc, self.timeout = nproc, timeout
        self.started = time.monotonic()

    def wait(self):
        from paddle_tpu_torch.distributed.utils import run_local_trainers
        left = self.timeout - (time.monotonic() - self.started)
        logs = os.path.join(self.workdir, 'logs')
        try:
            run_local_trainers(self.procs, self.nproc,
                               timeout=max(left, 1.0))
        except (RuntimeError, TimeoutError) as e:
            text = []
            for r in range(self.nproc):
                path = os.path.join(logs, f'workerlog.{r}')
                if os.path.exists(path):
                    with open(path, errors='replace') as f:
                        text.append(f'--- rank {r}\n' + f.read()[-3000:])
            raise type(e)(f'{e}\n' + '\n'.join(text)) from None
        out = []
        for r in range(self.nproc):
            with open(os.path.join(self.workdir, f'rank{r}.pkl'), 'rb') as f:
                out.append(pickle.load(f))
        return out


def launch(jobs, workdir, nproc=4, timeout=120, extra_env=None):
    """``start(...).wait()``."""
    return start(jobs, workdir, nproc, timeout, extra_env).wait()


def start(jobs, workdir, nproc=4, timeout=120, extra_env=None):
    """Start ``nproc`` workers running ``jobs``; returns a ``Launch``
    (the parent can compute its oracles meanwhile)."""
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.distributed.utils import (
        get_cluster, start_local_trainers)
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, 'jobs.pkl'), 'wb') as f:
        pickle.dump(jobs, f)
    env = dict(os.environ)
    env.update({
        'PADDLE_DIST_INIT_METHOD': 'file://' + os.path.join(workdir,
                                                           'store'),
        'PADDLE_DISTRI_BACKEND': 'gloo',
        'PADDLE_DIST_TIMEOUT': str(timeout),
        'GLOO_SOCKET_IFNAME': 'lo',
        'OMP_NUM_THREADS': '1',
        'CUDA_VISIBLE_DEVICES': '',
        'PYTHONPATH': os.pathsep.join(
            [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                      if p])})
    env.update(extra_env or {})
    eps = [[f'127.0.0.1:{6000 + i}' for i in range(nproc)]]
    cluster, pod = get_cluster(['127.0.0.1'], '127.0.0.1', eps,
                               list(range(nproc)))
    logs = os.path.join(workdir, 'logs')
    procs = start_local_trainers(cluster, pod, os.path.abspath(__file__),
                                 [workdir], log_dir=logs, env=env)
    return Launch(procs, workdir, nproc, timeout)


# -- shared pieces -----------------------------------------------------------

def _rank():
    from paddle_tpu_torch.distributed import env
    return env.get_rank()


def _fleet(dp=-1, tp=1, **degrees):
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs['dp_degree'] = dp
    st.hybrid_configs['mp_degree'] = tp
    for k, v in degrees.items():
        st.hybrid_configs[k] = v
    fleet.init(is_collective=True, strategy=st)
    return st


def _strategy(recompute=False, merge=1, o2=False):
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.recompute = recompute
    if merge > 1:
        st.gradient_merge = True
        st.gradient_merge_configs['k_steps'] = merge
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    return st


def _numpy(module):
    return {n: p.detach().float().numpy().copy()
            for n, p in module.named_parameters()}


def _grads(module):
    return {n: p.grad.detach().float().numpy().copy()
            for n, p in module.named_parameters() if p.grad is not None}


# -- the collectives ---------------------------------------------------------

def collectives():
    """Every collective on the world group, then on the dp and tp
    groups of a 2 x 2 mesh."""
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    me = _rank()
    out = {}

    def base(shape=(3,)):
        return torch.arange(int(np.prod(shape)), dtype=torch.float32) \
            .reshape(shape) + 10.0 * me + 1.0

    def run(tag, group):
        g = C._group(group)
        for op in ('SUM', 'MAX', 'MIN', 'PROD', 'AVG'):
            out[f'{tag}/all_reduce_{op}'] = dist.all_reduce(
                base(), getattr(C.ReduceOp, op), group).numpy()
        parts = []
        cat = dist.all_gather(parts, base((2, 3)), group)
        out[f'{tag}/all_gather'] = cat.numpy()
        out[f'{tag}/all_gather_list'] = np.stack([p.numpy() for p in parts])
        out[f'{tag}/all_gather_axis1'] = dist.all_gather(
            [], base((2, 3)), group, axis=1).numpy()
        out[f'{tag}/all_gather_object'] = dist.all_gather_object(
            [], {'rank': me}, group)
        out[f'{tag}/broadcast'] = dist.broadcast(base(), 1, group).numpy()
        out[f'{tag}/reduce'] = dist.reduce(base(), 1, C.ReduceOp.SUM,
                                           group).numpy()
        src_list = [base() * (i + 1) for i in range(g.nranks)]
        out[f'{tag}/scatter'] = dist.scatter(torch.zeros(3), src_list, 1,
                                             group).numpy()
        outs = dist.alltoall([base() + 100 * i for i in range(g.nranks)],
                             None, group)
        out[f'{tag}/alltoall'] = np.stack([t.numpy() for t in outs])
        out[f'{tag}/p2p'] = C.p2p(base(), 1, 0, group).numpy()
        out[f'{tag}/send'] = dist.send(base(), 0, group, src=1).numpy()
        out[f'{tag}/recv'] = dist.recv(base(), 1, group).numpy()
        out[f'{tag}/recv_dst'] = dist.recv(base(), 1, group, dst=0).numpy()
        out[f'{tag}/rotate'] = C.p2p_rotate(base(), group, 1).numpy()
        dist.barrier(group)
        out[f'{tag}/wait'] = dist.wait(base()).numpy()
        out[f'{tag}/group'] = (g.ranks, g.rank, g.nranks)

    run('world', None)
    mesh = dist.build_mesh([('dp', 2), ('tp', 2)])
    dist.set_mesh(mesh)
    out['axis_rank'] = (C.get_axis_rank('dp'), C.get_axis_rank('tp'))
    run('dp', C.new_group(axes=('dp',)))
    run('tp', C.split_group('tp'))
    run('both', C.new_group(axes=('dp', 'tp')))
    pair = C.new_group(ranks=[0, 2])
    if me in (0, 2):
        out['ranks02'] = dist.all_reduce(base(), group=pair).numpy()
    out['rotate2'] = C.p2p_rotate(base(), None, 2).numpy()
    out['staged'] = C.staged_through_host()
    dist.set_mesh(None)
    return out


# -- tensor-parallel layers --------------------------------------------------

def tp_layers(tp, x, w_col, b_col, w_row, b_row, emb, ids, logits, labels,
              ce_x, ce_w, ce_labels, split_x):
    """The TP layers, the vocab-parallel losses and ``split`` at
    ``tp``; forward and gradients, this rank's shards."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.distributed.mp_ops import split
    from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy_tp
    _fleet(dp=-1, tp=tp)
    mesh, me = env.get_mesh(), _rank()
    r = mesh.coords['tp']
    out = {}
    col = fleet.ColumnParallelLinear(w_col.shape[0], w_col.shape[1],
                                     gather_output=False, device='cpu')
    row = fleet.RowParallelLinear(w_row.shape[0], w_row.shape[1],
                                  input_is_parallel=True, device='cpu')
    gcol = fleet.ColumnParallelLinear(w_col.shape[0], w_col.shape[1],
                                      gather_output=True, device='cpu')
    srow = fleet.RowParallelLinear(w_row.shape[0], w_row.shape[1],
                                   input_is_parallel=False, device='cpu')
    for layer, w, b in ((col, w_col, b_col), (gcol, w_col, b_col),
                        (row, w_row, b_row), (srow, w_row, b_row)):
        layer.set_state_dict(convert.shard_state(
            {'weight': w, 'bias': b}, mesh, me, layer))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = row(col(xt))
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    out['mlp_y'] = y.detach().numpy()
    out['mlp_dx'] = xt.grad.numpy()
    out['mlp_grads'] = {'col': _grads(col), 'row': _grads(row)}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = srow(gcol(xt))
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    out['gather_y'] = y.detach().numpy()
    out['gather_dx'] = xt.grad.numpy()
    out['gather_grads'] = {'col': _grads(gcol), 'row': _grads(srow)}
    e = fleet.VocabParallelEmbedding(emb.shape[0], emb.shape[1],
                                     device='cpu')
    e.set_state_dict(convert.shard_state({'weight': emb}, mesh, me, e))
    h = e(torch.from_numpy(ids))
    (h * torch.linspace(-1, 1, h.numel()).reshape(h.shape)).sum().backward()
    out['emb_y'] = h.detach().numpy()
    out['emb_grad'] = e.weight.grad.numpy()
    vs = logits.shape[-1] // tp
    z = torch.from_numpy(np.ascontiguousarray(
        logits[..., r * vs:(r + 1) * vs])).requires_grad_(True)
    ce = fleet.ParallelCrossEntropy()(z, torch.from_numpy(labels))
    (ce * torch.linspace(0.5, 1.5, ce.numel()).reshape(ce.shape)) \
        .sum().backward()
    out['pce'] = ce.detach().numpy()
    out['pce_grad'] = z.grad.numpy()
    ws = ce_w.shape[1] // tp
    cx = torch.from_numpy(ce_x).requires_grad_(True)
    cw = torch.from_numpy(np.ascontiguousarray(
        ce_w[:, r * ws:(r + 1) * ws])).requires_grad_(True)
    loss = fused_linear_cross_entropy_tp(cx, cw, torch.from_numpy(ce_labels),
                                         num_chunks=2)
    (loss * torch.linspace(0.5, 1.5, loss.numel())).sum().backward()
    out['fce'] = loss.detach().numpy()
    out['fce_dx'] = cx.grad.numpy()
    out['fce_dw'] = cw.grad.numpy()
    from paddle_tpu_torch.distributed import mp_ops
    paddle.seed(5)
    sx = torch.from_numpy(split_x)
    s1 = split(sx, (8, 12), 'linear', axis=1, gather_out=True, name='c')
    s1b = split(sx, (8, 12), 'linear', axis=1, gather_out=True, name='c')
    out['split_cached'] = bool(torch.equal(s1, s1b))
    out['split_col'] = s1.detach().numpy()
    out['split_row'] = split(sx, (8, 12), 'linear', axis=0,
                             name='r').detach().numpy()
    out['split_emb'] = split(torch.from_numpy(ids), (emb.shape[0], 6),
                             'embedding', name='e').detach().numpy()
    out['split_state'] = {k[0]: {n: v.detach().numpy() for n, v in
                                 layer.state_dict().items()}
                          for k, layer in mp_ops._LAYER_CACHE.items()}
    env.set_mesh(None)
    return out


def model_forward(kind, tp, host, ids, model_kw, labels=None):
    """GPT's or BERT's training-mode forward and loss at ``tp`` with
    the JAX weights cut by ``convert.shard_state``; the rank's state
    and its loss."""
    import torch
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models import bert, gpt
    _fleet(dp=-1, tp=tp)
    mesh, me = env.get_mesh(), _rank()
    build = gpt.gpt_tiny if kind == 'gpt' else bert.bert_tiny
    m = build(device='cpu', **model_kw).train()
    shards = convert.shard_state(host, mesh, me, m)
    m.load_numpy_state(shards)
    t = torch.from_numpy(ids)
    if kind == 'gpt':
        out = m(t)
        loss = m.loss(out, t)
        logits = out
    else:
        out = m(t)
        loss = m.loss(out, torch.from_numpy(labels))
        logits = out[0]
    loss.backward()
    res = {'logits': logits.detach().numpy(), 'loss': float(loss),
           'state': {n: v.detach().numpy()
                     for n, v in m.state_dict().items()},
           'round_trip': all(np.array_equal(shards[n], v.detach().numpy())
                             for n, v in m.state_dict().items()),
           'grads': _grads(m),
           'specs': convert.shard_specs(m)}
    env.set_mesh(None)
    return res


# -- training ----------------------------------------------------------------

def _clip(nn, clip, clip_by):
    if not clip:
        return None
    return (nn.ClipGradByNorm if clip_by == 'norm'
            else nn.ClipGradByGlobalNorm)(clip)


def gpt_train(host, ids, dp, tp, steps, lr, model_kw, recompute=False,
              merge=1, o2=False, clip=None, clip_by='global'):
    """``gpt_tiny`` through ``ParallelTrainer`` over ``dp x tp`` (AdamW,
    with ``ClipGradByGlobalNorm(clip)``, or ``ClipGradByNorm(clip)`` for
    ``clip_by='norm'``, where given)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelTrainer
    _fleet(dp=dp, tp=tp)
    mesh = env.get_mesh()
    pm = gpt_tiny(device='cpu', **model_kw)
    pm.load_numpy_state(convert.shard_state(host, mesh, _rank(), pm))
    tr = ParallelTrainer(pm, AdamW(
        learning_rate=lr, parameters=pm.parameters(),
        grad_clip=_clip(nn, clip, clip_by)),
        lambda out, y: pm.loss(out, y),
        strategy=_strategy(recompute, merge, o2))
    losses = [tr.loss_float(tr.step(ids, ids)) for _ in range(steps)]
    res = {'losses': losses, 'params': _numpy(pm), 'grads': _grads(pm),
           'coords': dict(mesh.coords)}
    env.set_mesh(None)
    return res


def dropout_streams(host, ids, steps, lr, model_kw):
    """``gpt_tiny`` at dropout 0.1 over dp 2 x tp 2 (port against
    port), and draws of the default and ``model_parallel`` streams."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import env, fleet
    paddle.seed(11)
    res = gpt_train(host, ids, 2, 2, steps, lr,
                    dict(model_kw, dropout=0.1))
    _fleet(dp=2, tp=2)
    paddle.seed(11)
    res['default_draw'] = paddle.rand([8]).numpy()
    with fleet.get_rng_state_tracker().rng_state('model_parallel'):
        res['mp_draw'] = paddle.rand([8]).numpy()
    env.set_mesh(None)
    return res


def bert_train(host, ids, mlm, nsp, dp, tp, steps, lr, model_kw,
               fused=False):
    """``bert_tiny`` through ``ParallelTrainer`` over ``dp x tp`` with
    SGD (MLM mean over the global masked count)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models.bert import bert_tiny
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import ParallelTrainer
    _fleet(dp=dp, tp=tp)
    mesh = env.get_mesh()
    pm = bert_tiny(device='cpu', fused_head=fused, **model_kw)
    pm.load_numpy_state(convert.shard_state(host, mesh, _rank(), pm))
    tr = ParallelTrainer(pm, SGD(learning_rate=lr,
                                 parameters=pm.parameters()),
                         lambda out, *ys: pm.loss(out, *ys))
    losses = [tr.loss_float(tr.step(ids, mlm, nsp)) for _ in range(steps)]
    res = {'losses': losses, 'params': _numpy(pm)}
    env.set_mesh(None)
    return res


def conv_bn_net(paddle):
    """The conv + BatchNorm net of the data-parallel tests (one code for
    both packages)."""
    nn = paddle.nn
    kw = {'device': 'cpu'} if paddle.__name__ == 'paddle_tpu_torch' else {}
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw),
        nn.BatchNorm2D(8, **kw), nn.ReLU(), nn.Flatten(),
        nn.Linear(8 * 6 * 6, 4, **kw))


def conv_bn_train(params, buffers, x, y, dp, steps, lr, merge=1):
    """The conv + BN net through ``ParallelTrainer`` over ``dp`` (SGD,
    MSE): statistics over the global batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel import ParallelTrainer
    _fleet(dp=dp)
    net = conv_bn_net(paddle)
    convert.load_numpy_state(net, params, buffers)
    tr = ParallelTrainer(
        net, paddle.optimizer.SGD(learning_rate=lr,
                                  parameters=net.parameters()),
        lambda out, t: paddle.nn.functional.mse_loss(out, t),
        strategy=_strategy(merge=merge))
    losses = [tr.loss_float(tr.step(x, y)) for _ in range(steps)]
    res = {'losses': losses, 'params': _numpy(net),
           'buffers': {n: b.numpy().copy() for n, b in net.named_buffers()}}
    env.set_mesh(None)
    return res


def data_parallel_eager(params, buffers, x, y, lr):
    """``DataParallel``'s eager loop over 4 ranks on quarter batches
    (SyncBatchNorm by conversion): the rank's output rows, the summed
    gradients and the statistics after one step."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env
    paddle.distributed.init_parallel_env()
    me, n = _rank(), 4
    net = conv_bn_net(paddle)
    if me:      # rank 0's weights win at the wrap (a broadcast)
        params = {k: v + 1.0 for k, v in params.items()}
    convert.load_numpy_state(net, params, buffers)
    net = paddle.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    model = paddle.DataParallel(net)
    opt = paddle.optimizer.SGD(learning_rate=lr,
                               parameters=model.parameters())
    rows = slice(me * x.shape[0] // n, (me + 1) * x.shape[0] // n)
    out = model(torch.from_numpy(x[rows]))
    loss = paddle.nn.functional.mse_loss(out, torch.from_numpy(y[rows]))
    model.scale_loss(loss).backward()
    model.apply_collective_grads()
    grads = _grads(net)
    opt.step()
    res = {'out': out.detach().numpy(), 'grads': grads,
           'params': _numpy(net), 'loss': float(loss),
           'sync': type(net[1]).__name__,
           'buffers': {k: b.numpy().copy() for k, b in net.named_buffers()}}
    env.set_mesh(None)
    return res


def sum_loss(params, x, y, dp, lr):
    """A linear layer over ``dp`` whose loss sums its rows (SGD, one
    step): the ranks' mean of the local sums (DDP's convention)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel import ParallelTrainer
    _fleet(dp=dp)
    net = paddle.nn.Linear(x.shape[1], y.shape[1], device='cpu')
    convert.load_numpy_state(net, params)
    tr = ParallelTrainer(net, paddle.optimizer.SGD(
        learning_rate=lr, parameters=net.parameters()),
        lambda out, t: ((out - t) ** 2).sum())
    loss = tr.loss_float(tr.step(x, y))
    res = {'loss': loss, 'grads': _grads(net)}
    env.set_mesh(None)
    return res


def nan_guard(steps, lr):
    """An MLP over dp 4 under ``nan_guard``: a NaN row of rank 1's
    quarter at step 2, and a step only rank 2 finds non-finite (the
    flag's MIN over the world)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel import ParallelTrainer
    from paddle_tpu_torch.parallel import engine
    _fleet(dp=4)
    paddle.seed(1)
    net = paddle.nn.Sequential(paddle.nn.Linear(6, 8, device='cpu'),
                               paddle.nn.Tanh(),
                               paddle.nn.Linear(8, 2, device='cpu'))
    tr = ParallelTrainer(net, paddle.optimizer.SGD(
        learning_rate=lr, parameters=net.parameters()),
        lambda out, t: paddle.nn.functional.mse_loss(out, t),
        nan_guard=True, nan_patience=10)
    rs = np.random.RandomState(0)
    x = rs.randn(8, 6).astype(np.float32)
    y = rs.randn(8, 2).astype(np.float32)
    poisoned = x.copy()
    poisoned[3, 0] = np.nan              # rank 1's rows are 2 and 3
    real = engine.finite_step
    seen = []
    for i in range(steps):
        if i == 3 and _rank() == 2:
            engine.finite_step = lambda loss, grads: torch.zeros(
                (), dtype=torch.bool)
        try:
            tr.step(poisoned if i == 1 else x, y)
        finally:
            engine.finite_step = real
        seen.append(tr._step_no)
    res = {'steps': seen, 'params': _numpy(net),
           'skipped': tr.sentinel.total_skipped}
    env.set_mesh(None)
    return res


def fleet_surface(files):
    """``fleet.init``'s inferred dp, the hybrid group's ranks and
    groups, ``fleet.metrics`` on both routes, ``fleet.util`` and
    ``DistributedBatchSampler``'s defaults, over mp 2."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective, env, fleet
    _fleet(dp=-1, tp=2)
    hcg = fleet.get_hybrid_communicate_group()
    me = _rank()
    res = {'sizes': (hcg.get_data_parallel_world_size(),
                     hcg.get_model_parallel_world_size(),
                     hcg.get_pipe_parallel_world_size(),
                     hcg.get_sequence_parallel_world_size()),
           'ranks': (hcg.get_data_parallel_rank(),
                     hcg.get_model_parallel_rank(), hcg.get_stage_id()),
           'dp_group': hcg.get_data_parallel_group().ranks,
           'tp_group': hcg.get_model_parallel_group().ranks,
           'pp_group': hcg.get_pipe_parallel_group().ranks,
           'mesh': dict(env.get_mesh().shape),
           'worker': (fleet.worker_index(), fleet.worker_num(),
                      fleet.is_first_worker())}
    topo = fleet.CommunicateTopology.from_mesh(hcg.topology())
    res['comm_tp'] = topo.get_comm_list('tp')
    m = fleet.metrics
    v = np.array([me + 1.0, 2.0 * me], np.float32)
    res['host'] = {k: getattr(m, k)(v) for k in ('sum', 'max', 'min')}
    res['auc'] = m.auc(np.arange(5) + me, np.arange(5)[::-1] * (me + 1))
    res['mae'] = m.mae(np.array([me + 0.5]), np.array([2.0]))
    res['acc'] = m.acc(np.array([me]), np.array([4.0]))
    with collective.axis_scope(*env.get_mesh().axis_names):
        res['in_step'] = {k: getattr(m, k)(torch.from_numpy(v)).numpy()
                          for k in ('sum', 'max', 'min')}
    util = fleet.util
    res['util_sum'] = util.all_reduce([me, 1], 'sum')
    res['util_max'] = util.all_reduce([me, 1], 'max')
    res['util_gather'] = util.all_gather(me * 10)
    util.barrier()
    fleet.barrier_worker()
    res['file_shard'] = util.get_file_shard(files)
    s = paddle.io.DistributedBatchSampler(list(range(10)), batch_size=2)
    res['sampler'] = (s.nranks, s.local_rank, list(s))
    env.set_mesh(None)
    return res


def raises():
    """Every refusal that stays at a world above 1: each message."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW, DGCMomentum
    from paddle_tpu_torch.parallel import ParallelTrainer
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)

    for axis in ('pp_degree', 'sp_degree', 'ep_degree'):
        catch(axis, lambda: _fleet(dp=-1, tp=1, **{axis: 2}))
    _fleet(dp=2, tp=2)
    m = gpt_tiny(device='cpu', num_layers=1, hidden_size=32, num_heads=2,
                 vocab_size=64, max_seq_len=16)
    opt = AdamW(parameters=m.parameters())
    st = paddle.distributed.fleet.DistributedStrategy()
    st.sharding = True
    catch('zero', lambda: ParallelTrainer(m, opt, m.loss, strategy=st))
    catch('quant', lambda: ParallelTrainer(m, opt, m.loss,
                                           quant_collectives='int8'))
    catch('dgc', lambda: ParallelTrainer(
        m, DGCMomentum(parameters=m.parameters()), m.loss,
        strategy=paddle.distributed.fleet.DistributedStrategy()))
    tr = ParallelTrainer(m, opt, m.loss)
    # a captured step on the card over this gloo world: refused before
    # any step runs
    tr.device = torch.device('cuda')
    try:
        tr._check_capturable()
        out['fused_gloo'] = None
    except RuntimeError as e:
        out['fused_gloo'] = str(e)
    tr.device = torch.device('cpu')
    catch('save', lambda: tr.save_checkpoint('unused'))
    catch('restore', lambda: tr.restore_checkpoint('unused'))
    catch('host', lambda: collective.HostCollectives())
    catch('serve', lambda: m.generate(np.zeros((1, 2), np.int64), 2))
    env.set_mesh(None)
    return out


def hang(seconds):
    """Rank 1 never reaches the barrier."""
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env()
    if _rank() == 1:
        time.sleep(seconds)
    dist.barrier()
    return {}


KINDS = {'collectives': collectives, 'tp_layers': tp_layers,
         'model_forward': model_forward, 'gpt_train': gpt_train,
         'dropout_streams': dropout_streams, 'bert_train': bert_train,
         'conv_bn_train': conv_bn_train,
         'data_parallel_eager': data_parallel_eager,
         'nan_guard': nan_guard, 'fleet_surface': fleet_surface,
         'sum_loss': sum_loss,
         'raises': raises, 'hang': hang}


def main():
    workdir = sys.argv[1]
    with open(os.path.join(workdir, f'pid{os.environ["PADDLE_TRAINER_ID"]}'),
              'w') as f:
        f.write(str(os.getpid()))
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.parallel import ensure_process_group
    paddle.set_device('cpu')
    ensure_process_group()
    with open(os.path.join(workdir, 'jobs.pkl'), 'rb') as f:
        jobs = pickle.load(f)
    results = {}
    for name, kind, kwargs in jobs:
        try:
            results[name] = KINDS[kind](**kwargs)
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
    rank = _rank()
    with open(os.path.join(workdir, f'rank{rank}.pkl.tmp'), 'wb') as f:
        pickle.dump(results, f)
    os.replace(os.path.join(workdir, f'rank{rank}.pkl.tmp'),
               os.path.join(workdir, f'rank{rank}.pkl'))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
