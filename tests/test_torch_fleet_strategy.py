"""The training strategies on one device against the JAX package, on
the CPU: ``fleet`` (``init``, ``distributed_optimizer`` with the Lamb
and DGC swaps, ``validate_strategy``, the role, topology, metrics,
filesystem and data-generator API, ``PipelineLayer``,
``ParallelCrossEntropy``, ``fleet.utils.recompute``),
``distributed.env``/``parallel`` at one process, and
``ParallelTrainer`` under ``strategy.recompute`` and
``strategy.gradient_merge``.

The models are small (``gpt_tiny``: 2 layers, H 64, 4 heads, vocab 128,
T 32; a 16-32-4 tanh MLP; a conv + BatchNorm net), their numpy weights
loaded into both packages.  The JAX oracles run once per module.  The
JAX ``fleet.init`` installs a global mesh; every test leaves it unset
(``paddle_tpu.distributed.env.set_mesh(None)``), so later tests in the
worker are not sharded.

Tolerances: f32 losses within 2e-5, parameters within 1e-4 (the key
bias of attention within its AdamW bound, ``2 * lr * steps``: its true
gradient is 0, so each package's is round-off that Adam scales up to
``lr``; see ``tests/test_torch_gpt_training.py``); under bf16 O2 the
losses within 2e-3 relative (a quarter of bf16's epsilon: the packages
round to bf16 at other places).  The optimizer swaps' parameters after
3 steps within 2e-5.  Recompute against no recompute in the port: bit
for bit (gradients, parameters, buffers, the generator's state).
"""
import contextlib
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.fleet_base import \
    validate_strategy as jvalidate
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.fleet_base import validate_strategy
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import ParallelTrainer


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after:
    the suite runs six workers on the machine's cores, and torch's
    default of a thread a core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cpu_and_no_mesh():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)
    jenv.set_mesh(None)


TOL, GRAD_TOL, O2_LOSS_RTOL, SWAP_TOL = 2e-5, 1e-4, 2e-3, 2e-5
MODEL_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
                max_seq_len=64, dropout=0.0, fused_head=False)
LR, STEPS, BATCH = 3e-3, 3, 4


@pytest.fixture(scope='module')
def weights():
    jpaddle.seed(7)
    params, _ = jax_gpt_tiny(**MODEL_KW).functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name:
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    return host


IDS = np.random.RandomState(0).randint(0, 128, (BATCH, 32)).astype(np.int64)


def _strategy(cls, recompute=False, merge=1, o2=False):
    st = cls()
    st.recompute = recompute
    if merge > 1:
        st.gradient_merge = True
        st.gradient_merge_configs['k_steps'] = merge
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    return st


def _jax_run(host, **kw):
    jm = jax_gpt_tiny(**MODEL_KW)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    tr = JaxTrainer(jm, opt, lambda out, y: jm.loss(out, y),
                    strategy=_strategy(jfleet.DistributedStrategy, **kw))
    losses = [tr.loss_float(tr.step(IDS, IDS)) for _ in range(STEPS)]
    return losses, {k: np.asarray(v) for k, v in tr.params.items()}


def _port_trainer(host, model_kw=None, **kw):
    pm = gpt_tiny(device='cpu', **dict(MODEL_KW, **(model_kw or {})))
    pm.load_numpy_state(host)
    opt = AdamW(learning_rate=LR, parameters=pm.parameters())
    return ParallelTrainer(pm, opt, lambda out, y: pm.loss(out, y),
                           strategy=_strategy(fleet.DistributedStrategy,
                                              **kw))


CONFIGS = {'recompute': dict(recompute=True), 'merge2': dict(merge=2),
           'merge4': dict(merge=4),
           'recompute_merge2': dict(recompute=True, merge=2),
           'recompute_o2': dict(recompute=True, o2=True),
           'merge2_o2': dict(merge=2, o2=True)}


@pytest.fixture(scope='module')
def jax_runs(weights):
    """The JAX trainer's losses and parameters for each strategy, once."""
    return {name: _jax_run(weights, **kw) for name, kw in CONFIGS.items()}


def _params_close(model, want):
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    h = MODEL_KW['hidden_size']
    for name, value in want.items():
        g, v = got[name], np.asarray(value)
        if name.endswith('attn.qkv.bias'):
            key = slice(h, 2 * h)
            np.testing.assert_allclose(g[key], v[key], atol=2 * LR * STEPS,
                                       rtol=0, err_msg=name)
            g, v = np.delete(g, np.s_[key]), np.delete(v, np.s_[key])
        np.testing.assert_allclose(g, v, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


# -- the trainer under the strategies, against the JAX trainer --------------

@pytest.mark.parametrize('name', [n for n in CONFIGS if 'o2' not in n])
def test_trainer_strategy_matches_the_jax_trainer(weights, jax_runs, name):
    want_l, want_p = jax_runs[name]
    tr = _port_trainer(weights, **CONFIGS[name])
    got = [tr.loss_float(tr.step(IDS, IDS)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want_l, rtol=TOL, atol=TOL)
    _params_close(tr.model, want_p)


@pytest.mark.parametrize('name', [n for n in CONFIGS if 'o2' in n])
def test_trainer_strategy_in_bf16_o2_matches_the_jax_trainer(
        weights, jax_runs, name):
    want_l, _ = jax_runs[name]
    tr = _port_trainer(weights, **CONFIGS[name])
    got = [tr.loss_float(tr.step(IDS, IDS)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want_l, rtol=O2_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())


def test_merge_needs_a_batch_that_divides_as_the_reference(weights):
    ids = IDS[:3]
    jm = jax_gpt_tiny(**MODEL_KW)
    jt = JaxTrainer(jm, JaxAdamW(parameters=jm.parameters()),
                    lambda out, y: jm.loss(out, y),
                    strategy=_strategy(jfleet.DistributedStrategy, merge=2))
    with pytest.raises(TypeError, match='cannot reshape'):
        jt.step(ids, ids)
    tr = _port_trainer(weights, merge=2)
    with pytest.raises(TypeError, match='cannot reshape'):
        tr.step(ids, ids)


def _grads_and_gen(host, model_kw, **kw):
    paddle.seed(3)
    tr = _port_trainer(host, model_kw=model_kw, **kw)
    loss = tr.step(IDS, IDS)
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    return float(loss), grads, rng.generator('cpu').get_state(), \
        {n: p.detach().clone() for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize('o2', [False, True], ids=['f32', 'o2'])
def test_recompute_replays_dropout_and_amp_bit_for_bit(weights, o2):
    """Dropout 0.5 draws from the port's own generator and AMP is the
    port's own policy: the recomputation must draw the forward's masks
    and cast as the forward did, and leave the generator where a run
    without recompute leaves it."""
    kw = dict(dropout=0.5)
    l0, g0, s0, p0 = _grads_and_gen(weights, kw, o2=o2)
    l1, g1, s1, p1 = _grads_and_gen(weights, kw, o2=o2, recompute=True)
    assert l0 == l1
    assert torch.equal(s0, s1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
        assert torch.equal(p0[n], p1[n]), n


def test_recompute_under_a_policy_other_than_the_backwards():
    """The recomputation re-enters the forward's AMP state even when the
    backward runs under another policy (or none)."""
    lin = paddle.nn.Linear(8, 8)
    x = torch.randn(4, 8, requires_grad=True)

    def run(rec):
        with paddle.amp.auto_cast(level='O2'):
            y = fleet.utils.recompute(lin, x) if rec else lin(x)
        g = torch.autograd.grad(y.float().sum(), [x, lin.weight])
        return y.dtype, g
    (d0, g0), (d1, g1) = run(False), run(True)
    assert d0 == d1 == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# -- BatchNorm's running statistics under recompute ----------------------

def _conv_bn(pkg):
    """Conv (no bias: one before BatchNorm has a true gradient of 0,
    whose round-off AdamW scales up to steps of ``lr`` with arbitrary
    sign in each package) + BatchNorm + ReLU + a linear head."""
    nn = pkg.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, bias_attr=False),
                         nn.BatchNorm2D(4), nn.ReLU(),
                         nn.Flatten(), nn.Linear(4 * 6 * 6, 5))


def _mse(pkg):
    return lambda out, y: pkg.nn.functional.mse_loss(out, y)


@pytest.fixture(scope='module')
def conv_bn_case():
    rs = np.random.RandomState(5)
    jpaddle.seed(1)
    jm = _conv_bn(jpaddle)
    params, buffers = jm.functional_state()
    host = {k: np.asarray(v) for k, v in params.items()}
    bufs = {k: np.asarray(v) for k, v in buffers.items()}
    x = rs.randn(6, 3, 8, 8).astype(np.float32)
    y = rs.randn(6, 5).astype(np.float32)
    jt = JaxTrainer(jm, JaxAdamW(learning_rate=1e-2,
                                 parameters=jm.parameters()), _mse(jpaddle),
                    strategy=_strategy(jfleet.DistributedStrategy,
                                       recompute=True))
    losses = [jt.loss_float(jt.step(x, y)) for _ in range(2)]
    return host, bufs, x, y, losses, \
        {k: np.asarray(v) for k, v in jt.params.items()}, \
        {k: np.asarray(v) for k, v in jt.buffers.items()}


def _port_conv_bn(case, recompute):
    host, bufs, x, y = case[:4]
    pm = _conv_bn(paddle)
    convert.load_numpy_state(pm, host, bufs)
    tr = ParallelTrainer(pm, AdamW(learning_rate=1e-2,
                                   parameters=pm.parameters()),
                         _mse(paddle),
                         strategy=_strategy(fleet.DistributedStrategy,
                                            recompute=recompute))
    losses = [tr.loss_float(tr.step(x, y)) for _ in range(2)]
    return pm, losses


def test_batch_norm_statistics_move_once_under_recompute(conv_bn_case):
    want_l, want_p, want_b = conv_bn_case[4:]
    pm, losses = _port_conv_bn(conv_bn_case, recompute=True)
    np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
    for n, b in pm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_b[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n],
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=n)
    plain, _ = _port_conv_bn(conv_bn_case, recompute=False)
    for (n, a), (_, b) in zip(pm.named_buffers(), plain.named_buffers()):
        assert torch.equal(a, b), n


# -- state the forward reads and then moves, under recompute ---------------

@pytest.fixture
def ref_spectral_hook(monkeypatch):
    """The reference's spectral-norm hook tests ``params.get(name) or
    ...`` on a Tensor; read as a None test (as in
    ``tests/test_torch_nn_utils.py``)."""
    monkeypatch.setattr(JaxTensor, '__bool__', lambda self: True)


def _sn_conv(pkg):
    pkg.seed(0)
    m = pkg.nn.Conv2D(3, 4, 3)
    pkg.nn.spectral_norm(m)
    return m


SN_X = np.random.RandomState(0).randn(2, 3, 6, 6).astype(np.float32)


def test_spectral_norm_under_recompute_matches_the_jax_function(
        ref_spectral_hook):
    """The recomputation takes the forward's ``u`` and sigma, so the
    input gradient is the JAX function's (``jax.checkpoint`` replays the
    ``u`` passed in), and ``u`` moves once, as one eager forward moves
    it.  The reference's own ``u`` under ``jax.checkpoint`` is a leaked
    tracer, so its value after one forward comes from an eager run."""
    jm = _sn_conv(jpaddle)
    state = {k: np.array(v.value) for k, v in jm.state_dict().items()}
    jx = jpaddle.to_tensor(SN_X)
    jx.stop_gradient = False
    jy = jfleet.utils.recompute(lambda t: jm(t), jx)
    (jy * jy).sum().backward()
    eager = _sn_conv(jpaddle)
    eager(jpaddle.to_tensor(SN_X))
    want_u = np.asarray(eager.weight_u.value)
    pm = _sn_conv(paddle)
    runs = {}
    for rec in (False, True):
        pm.load_state_dict({k: torch.from_numpy(v.copy())
                            for k, v in state.items()})
        pm.zero_grad(set_to_none=True)
        tx = torch.from_numpy(SN_X).requires_grad_(True)
        ty = fleet.utils.recompute(pm, tx) if rec else pm(tx)
        (ty * ty).sum().backward()
        runs[rec] = [ty.detach(), tx.grad, pm.weight_orig.grad,
                     pm.bias.grad, pm.weight_u.clone()]
    y, gx, _, _, u = runs[True]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy.value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx.grad.value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-6, atol=1e-7)
    for a, b in zip(runs[True], runs[False]):
        assert torch.equal(a, b)


def test_spectral_norm_under_strategy_recompute_equals_none():
    """``strategy.recompute`` over a spectral-norm conv net: losses,
    parameters and ``u`` bit-equal to the run without.  (The JAX
    trainer is no oracle here: under ``jax.grad`` of the functional
    state its hook's sigma is traced and differentiated, where the
    reference's eager tape and the port hold it constant.)"""
    rs = np.random.RandomState(4)
    x, y = SN_X, rs.randn(2, 5).astype(np.float32)
    got = []
    for rec in (False, True):
        paddle.seed(0)
        net = paddle.nn.Sequential(_sn_conv(paddle), paddle.nn.ReLU(),
                                   paddle.nn.Flatten(),
                                   paddle.nn.Linear(4 * 4 * 4, 5))
        tr = ParallelTrainer(net, AdamW(learning_rate=1e-2,
                                        parameters=net.parameters()),
                             _mse(paddle),
                             strategy=_strategy(fleet.DistributedStrategy,
                                                recompute=rec))
        losses = [float(tr.step(x, y)) for _ in range(3)]
        got.append((losses, net.state_dict()))
    (l0, s0), (l1, s1) = got
    assert l0 == l1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


STREAM = 'recompute_test_stream'


@pytest.mark.parametrize('where', ['inside', 'outside'])
def test_recompute_replays_a_named_streams_dropout(where):
    """Dropout drawn from an ``RNGStatesTracker`` stream in a block run
    through ``fleet.utils.recompute``, the scope entered inside the
    block or around the call (the backward then runs outside it): the
    gradients of the run without recompute, and the stream and the
    device generator left where that run leaves them."""
    tracker = fleet.get_rng_state_tracker()
    lin = paddle.nn.Linear(16, 16)
    x0 = np.random.RandomState(1).randn(8, 16).astype(np.float32)

    def block(t):
        h = lin(t)
        if where == 'inside':
            with tracker.rng_state(STREAM):
                return F.dropout(h, 0.5)
        return F.dropout(h, 0.5)

    def run(rec):
        tracker.add(STREAM, 77)
        paddle.seed(5)
        lin.clear_gradients()
        x = torch.from_numpy(x0).requires_grad_(True)
        scope = tracker.rng_state(STREAM) if where == 'outside' else \
            contextlib.nullcontext()
        with scope:
            y = fleet.utils.recompute(block, x) if rec else block(x)
        (y * y).sum().backward()
        with tracker.rng_state(STREAM):
            after = paddle.rand([6])
        return [y.detach(), x.grad, lin.weight.grad, lin.bias.grad, after,
                paddle.rand([6])]
    plain, rec = run(False), run(True)
    for a, b in zip(plain, rec):
        assert torch.equal(a, b)


def test_moving_average_fake_quant_moves_once_under_recompute():
    """A moving-average fake quant reads its scale and moves it in the
    forward: the recomputation takes the forward's moved scale and
    writes nothing, so gradients and the scale equal the run without
    recompute."""
    from paddle_tpu_torch.quantization import FakeQuantMovingAverageAbsMax
    rs = np.random.RandomState(2)
    xs = [rs.randn(6, 8).astype(np.float32) * s for s in (1.0, 3.0, 0.5)]
    got = []
    for rec in (False, True):
        paddle.seed(0)
        fq, lin = FakeQuantMovingAverageAbsMax(), paddle.nn.Linear(8, 4)
        out = []
        for xv in xs:
            x = torch.from_numpy(xv).requires_grad_(True)
            y = fleet.utils.recompute(lambda t: lin(fq(t)), x) if rec \
                else lin(fq(x))
            (y * y).sum().backward()
            out += [y.detach(), x.grad, fq.scale.clone()]
        got.append(out + [lin.weight.grad])
    for a, b in zip(*got):
        assert torch.equal(a, b)


# -- gradient merge under nan_guard and step_fused -----------------------

def _guarded(host, fused_steps=None):
    pm = gpt_tiny(device='cpu', **MODEL_KW)
    pm.load_numpy_state(host)
    opt = AdamW(learning_rate=LR, parameters=pm.parameters())
    return ParallelTrainer(pm, opt, lambda out, y, w: pm.loss(out, y) * w,
                           strategy=_strategy(fleet.DistributedStrategy,
                                              merge=2),
                           nan_guard=True, fused_steps=fused_steps)


def test_one_poisoned_micro_batch_skips_the_whole_merged_step(weights):
    tr = _guarded(weights)
    w = np.ones(BATCH, np.float32)
    tr.step(IDS, IDS, w)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    slots = {k: v.clone() for k, v in tr.optimizer.state_dict().items()
             if torch.is_tensor(v)}
    bad = w.copy()
    bad[BATCH // 2:] = np.nan            # the second micro-batch
    loss = tr.step(IDS, IDS, bad)
    assert not np.isfinite(float(loss)) and tr._step_no == 1
    for n, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    for k, v in tr.optimizer.state_dict().items():
        if torch.is_tensor(v):
            assert torch.equal(v, slots[k]), k
    assert np.isfinite(float(tr.step(IDS, IDS, w))) and tr._step_no == 2


def test_merged_step_fused_equals_eager_steps(weights):
    k = 2
    w = np.ones(BATCH, np.float32)
    poison = w.copy()
    poison[0] = np.nan
    rows = [w, poison, w, w]
    eager = _guarded(weights)
    want = [float(eager.step(IDS, IDS, r)) for r in rows]
    fused = _guarded(weights, fused_steps=k)
    got = []
    for c in range(2):
        got += fused.step_fused(np.stack([IDS] * k), np.stack([IDS] * k),
                                np.stack(rows[c * k:(c + 1) * k])).tolist()
    np.testing.assert_array_equal(got, want)
    assert fused._step_no == eager._step_no == 3
    for (n, a), (_, b) in zip(fused.model.named_parameters(),
                              eager.model.named_parameters()):
        assert torch.equal(a, b), n


# -- fleet.utils.recompute against the JAX function ------------------------

def test_fleet_recompute_matches_the_jax_function():
    rs = np.random.RandomState(9)
    w1, w2 = rs.randn(8, 16).astype(np.float32), \
        rs.randn(16, 4).astype(np.float32)
    x = rs.randn(5, 8).astype(np.float32)

    def block(pkg, W1, W2):
        return lambda t: pkg.tanh(pkg.matmul(pkg.tanh(pkg.matmul(t, W1)),
                                             W2))
    jx = jpaddle.to_tensor(x, stop_gradient=False)
    jy = jfleet.utils.recompute(
        block(jpaddle, jpaddle.to_tensor(w1), jpaddle.to_tensor(w2)), jx)
    (jy * jy).sum().backward()
    px = torch.tensor(x, requires_grad=True)
    W1 = torch.tensor(w1, requires_grad=True)
    py = fleet.utils.recompute(block(paddle, W1, torch.tensor(w2)), px)
    (py * py).sum().backward()
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy.value),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad.value),
                               rtol=1e-5, atol=1e-6)
    # the port's gradients also reach what the block closes over
    assert W1.grad is not None and W1.grad.abs().sum() > 0


# -- the optimizer swaps ------------------------------------------------

def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 4))


@pytest.fixture(scope='module')
def mlp_case():
    rs = np.random.RandomState(4)
    jpaddle.seed(2)
    jm = _mlp(jpaddle)
    host = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    x = rs.randn(8, 16).astype(np.float32)
    y = rs.randn(8, 4).astype(np.float32)
    return host, x, y


def _swap_strategy(cls, kind):
    st = cls()
    if kind == 'lamb':
        st.lamb = True
        st.lamb_configs['lamb_weight_decay'] = 0.02
    else:
        st.dgc = True
        st.dgc_configs.update(rampup_begin_step=1, rampup_step=1,
                              sparsity=[0.5])
    return st


def _swap_opts(kind, params, jparams):
    if kind == 'lamb':
        sched = plr.PolynomialDecay(1e-2, 10, end_lr=0.0)
        jsched = jlr.PolynomialDecay(1e-2, 10, end_lr=0.0)
        return (AdamW(learning_rate=sched, parameters=params),
                JaxAdamW(learning_rate=jsched, parameters=jparams), sched)
    return (Momentum(learning_rate=1e-2, momentum=0.8, use_nesterov=True,
                     weight_decay=1e-3, parameters=params),
            JaxMomentum(learning_rate=1e-2, momentum=0.8, use_nesterov=True,
                        weight_decay=1e-3, parameters=jparams), 1e-2)


@pytest.mark.parametrize('kind', ['lamb', 'dgc'])
def test_optimizer_swap_matches_the_reference(mlp_case, kind):
    host, x, y = mlp_case
    jm = _mlp(jpaddle)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    pm = _mlp(paddle)
    convert.load_numpy_state(pm, host)
    popt, jopt, lr_obj = _swap_opts(kind, pm.parameters(), jm.parameters())
    jst = _swap_strategy(jfleet.DistributedStrategy, kind)
    pst = _swap_strategy(fleet.DistributedStrategy, kind)
    fleet.init(is_collective=True, strategy=pst)
    jopt = jfleet.distributed_optimizer(jopt, jst)
    popt = fleet.distributed_optimizer(popt)
    assert type(popt).__name__ == type(jopt).__name__ == \
        {'lamb': 'Lamb', 'dgc': 'DGCMomentum'}[kind]
    assert popt._fleet_strategy is pst
    if kind == 'lamb':
        assert popt._learning_rate is lr_obj
        assert popt._lamb_wd == jopt._lamb_wd == 0.02
    else:
        assert popt._learning_rate == jopt._learning_rate == lr_obj
        assert (popt._momentum, popt._nesterov, popt._coupled_wd) == \
            (jopt._momentum, jopt._nesterov, jopt._coupled_wd)
    jt = JaxTrainer(jm, jopt, _mse(jpaddle))
    pt = ParallelTrainer(pm, popt, _mse(paddle))
    assert pt.strategy is pst
    for _ in range(3):
        np.testing.assert_allclose(pt.loss_float(pt.step(x, y)),
                                   jt.loss_float(jt.step(x, y)),
                                   rtol=SWAP_TOL, atol=SWAP_TOL)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jt.params[n]), rtol=SWAP_TOL,
                                   atol=SWAP_TOL, err_msg=n)


def test_dgc_leaves_other_optimizers_with_a_warning(mlp_case):
    pm = _mlp(paddle)
    st = _swap_strategy(fleet.DistributedStrategy, 'dgc')
    opt = Adam(parameters=pm.parameters())
    with pytest.warns(UserWarning, match='Momentum'):
        got = fleet.distributed_optimizer(opt, st)
    assert got is opt and got._fleet_strategy is st
    jm = _mlp(jpaddle)
    with pytest.warns(UserWarning, match='Momentum'):
        jfleet.distributed_optimizer(
            jpaddle.optimizer.Adam(parameters=jm.parameters()),
            _swap_strategy(jfleet.DistributedStrategy, 'dgc'))


# -- validate_strategy and the toggles without a mesh ---------------------

@pytest.mark.parametrize('pkg', ['port', 'jax'])
def test_validate_strategy_warns_and_raises_as_the_reference(pkg):
    cls, check = (fleet.DistributedStrategy, validate_strategy) \
        if pkg == 'port' else (jfleet.DistributedStrategy, jvalidate)
    st = cls()
    st.a_sync = True
    with pytest.warns(UserWarning, match='a_sync'):
        check(st)
    st = cls()
    st.sharding = True
    for stage in (0, 1, 2):
        st.sharding_configs['stage'] = stage
        check(st)
    st.sharding_configs['stage'] = 3
    with pytest.raises(NotImplementedError, match='stage-3'):
        check(st)


def test_toggles_without_a_mesh_train_as_none(weights):
    base = _port_trainer(weights)
    want = [base.loss_float(base.step(IDS, IDS)) for _ in range(2)]
    st = fleet.DistributedStrategy()
    st.sharding = True
    st.sharding_configs['stage'] = 2
    for name in ('tensor_parallel', 'sequence_parallel', 'localsgd', 'lars',
                 'fuse_all_reduce_ops'):
        setattr(st, name, True)
    pm = gpt_tiny(device='cpu', **MODEL_KW)
    pm.load_numpy_state(weights)
    tr = ParallelTrainer(pm, AdamW(learning_rate=LR,
                                   parameters=pm.parameters()),
                         lambda out, y: pm.loss(out, y), strategy=st)
    assert [tr.loss_float(tr.step(IDS, IDS)) for _ in range(2)] == want
    st = fleet.DistributedStrategy()
    st.pipeline = True
    with pytest.warns(UserWarning, match='no pp axis'):
        ParallelTrainer(pm, tr.optimizer, pm.loss, strategy=st)


def test_parallel_degrees_and_worlds_above_one_raise(weights, monkeypatch):
    pm = gpt_tiny(device='cpu', **MODEL_KW)
    opt = AdamW(parameters=pm.parameters())
    st = fleet.DistributedStrategy()
    st.hybrid_configs['mp_degree'] = 2
    with pytest.raises(NotImplementedError, match='9b'):
        fleet.init(is_collective=True, strategy=st)
    with pytest.raises(NotImplementedError, match='9b'):
        ParallelTrainer(pm, opt, pm.loss, strategy=st)
    monkeypatch.setenv('PADDLE_TRAINERS_NUM', '2')
    with pytest.raises(NotImplementedError, match='9b'):
        ParallelTrainer(pm, opt, pm.loss, strategy=fleet.DistributedStrategy())
    with pytest.raises(NotImplementedError, match='9b'):
        paddle.DataParallel(pm)
    with pytest.raises(NotImplementedError, match='9b'):
        fleet.init(is_collective=True)


def test_fleet_init_records_the_strategy_and_a_unit_group():
    st = fleet.DistributedStrategy()
    assert fleet.init(is_collective=True, strategy=st) is fleet.get_fleet()
    assert fleet.get_fleet().strategy is st
    hcg = fleet.get_hybrid_communicate_group()
    assert (hcg.get_data_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_data_parallel_rank(), hcg.get_stage_id()) == \
        (1, 1, 1, 0, 0)
    with pytest.raises(NotImplementedError, match='9b'):
        hcg.get_data_parallel_group()
    assert (fleet.worker_index(), fleet.worker_num(),
            fleet.is_first_worker(), fleet.is_worker()) == (0, 1, True, True)
    assert (fleet.server_num(), fleet.server_endpoints(to_string=True),
            fleet.is_server()) == (0, '', False)
    with pytest.raises(NotImplementedError):
        fleet.run_server()


# -- the names, env and parallel at one process -----------------------------

def test_fleet_has_the_references_names():
    assert sorted(fleet.__all__) == sorted(jfleet.__all__)
    assert len(fleet.__all__) == 25
    for name in jfleet.__all__:
        assert getattr(fleet, name) is not None, name
    for name in ('ParallelEnv', 'get_rank', 'get_world_size',
                 'init_parallel_env', 'DataParallel', 'fleet'):
        assert name in paddle.distributed.__all__, name
        assert hasattr(jpaddle.distributed, name), name


def test_parallel_env_at_one_process(monkeypatch):
    env = paddle.distributed.ParallelEnv()
    assert (env.rank, env.world_size, env.nranks, env.local_rank,
            env.device_type) == (0, 1, 1, 0, 'gpu')
    assert env.trainer_endpoints == ['127.0.0.1:0']
    monkeypatch.setenv('PADDLE_TRAINER_ID', '3')
    monkeypatch.setenv('PADDLE_TRAINERS_NUM', '4')
    assert (paddle.distributed.get_rank(),
            paddle.distributed.get_world_size()) == (3, 4)


def test_data_parallel_at_one_rank_is_the_layer():
    lin = paddle.nn.Linear(4, 3)
    dp = paddle.DataParallel(lin)
    x = torch.randn(2, 4)
    assert torch.equal(dp(x), lin(x))
    loss = dp(x).sum()
    assert dp.scale_loss(loss) is loss
    loss.backward()
    g = lin.weight.grad.clone()
    dp.apply_collective_grads()
    assert torch.equal(lin.weight.grad, g)
    assert list(dp.parameters()) == list(lin.parameters())
    assert isinstance(paddle.distributed.init_parallel_env(),
                      paddle.distributed.ParallelEnv)
    with pytest.raises(NotImplementedError, match='9b'):
        paddle.distributed.init_parallel_env(n_devices=2)


def test_pipeline_layer_and_parallel_cross_entropy_match_the_reference():
    rs = np.random.RandomState(6)

    def descs(pkg):
        mp = pkg.distributed.fleet
        return [mp.LayerDesc(pkg.nn.Linear, 8, 16), pkg.nn.Tanh(),
                mp.LayerDesc(pkg.nn.Linear, 16, 8), pkg.nn.Tanh(),
                mp.LayerDesc(pkg.nn.Linear, 8, 5)]
    jp = jfleet.PipelineLayer(descs(jpaddle), num_stages=2)
    pp = fleet.PipelineLayer(descs(paddle), num_stages=2)
    assert pp.stage_bounds == jp.stage_bounds == [(0, 3), (3, 5)]
    assert len(pp.stage_layers(1)) == len(jp.stage_layers(1)) == 2
    host = {k: np.asarray(v) for k, v in jp.functional_state()[0].items()}
    convert.load_numpy_state(pp, host)
    x = rs.randn(4, 8).astype(np.float32)
    want = jp(jpaddle.to_tensor(x))
    got = pp(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.value),
                               rtol=1e-6, atol=1e-6)
    labels = rs.randint(0, 5, (4,)).astype(np.int64)
    labels[1] = -100
    jce = jfleet.ParallelCrossEntropy()(want, jpaddle.to_tensor(labels))
    pce = fleet.ParallelCrossEntropy()(got, torch.from_numpy(labels))
    np.testing.assert_allclose(pce.detach().numpy(), np.asarray(jce.value),
                               rtol=1e-6, atol=1e-6)


def test_rng_state_tracker_keeps_named_streams():
    tracker = fleet.get_rng_state_tracker()
    tracker.add('stream_a', 123)
    before = rng.generator('cpu').get_state().clone()
    with tracker.rng_state('stream_a'):
        a = paddle.rand([5])
    assert torch.equal(rng.generator('cpu').get_state(), before)
    with tracker.rng_state('stream_a'):
        b = paddle.rand([5])
    assert not torch.equal(a, b)          # the stream moves on
    tracker.add('stream_a', 123)
    with tracker.rng_state('stream_a'):
        assert torch.equal(paddle.rand([5]), a)
    assert 'get_rng_state_tracker' in fleet.meta_parallel.__all__


def test_topology_matches_the_reference():
    names, dims = ('data', 'pipe', 'sharding', 'model'), (2, 1, 2, 3)
    j = jfleet.CommunicateTopology(names, dims)
    p = fleet.CommunicateTopology(names, dims)
    assert p.world_size() == j.world_size() == 12
    for ax in names:
        assert p.get_comm_list(ax) == j.get_comm_list(ax)
        assert p.get_dim(ax) == j.get_dim(ax)
        assert p.get_axis_list(ax, 0) == j.get_axis_list(ax, 0)
    for r in range(12):
        assert p.get_coord(r) == j.get_coord(r)
        assert p.get_rank(**dict(zip(names, p.get_coord(r)))) == r
    with pytest.raises(ValueError):
        p.get_rank(data=0)


def test_role_makers_and_util_match_the_reference(monkeypatch, capsys):
    monkeypatch.setenv('PADDLE_TRAINER_ENDPOINTS', 'a:1,b:2')
    for pkg in (fleet, jfleet):
        rm = pkg.PaddleCloudRoleMaker()
        assert rm._get_trainer_endpoints() == ['a:1', 'b:2']
        assert (rm._worker_index(), rm._is_worker(), rm._is_server(),
                rm._is_first_worker(), rm._server_num()) == \
            (0, True, False, True, 0)
    files = [f'part-{i}' for i in range(7)]
    for i in range(3):
        kw = dict(current_id=i, worker_num=3, role=fleet.Role.WORKER,
                  worker_endpoints=['x:1'])
        p = fleet.UtilBase(fleet.UserDefinedRoleMaker(**kw))
        j = jfleet.UtilBase(jfleet.UserDefinedRoleMaker(**kw))
        assert p.get_file_shard(files) == j.get_file_shard(files)
    srv = fleet.UserDefinedRoleMaker(current_id=1, role=fleet.Role.SERVER,
                                     server_endpoints=['s:1'])
    assert (srv._is_server(), srv._is_first_worker(), srv._server_num()) \
        == (True, False, 1)
    util = fleet.UtilBase()
    np.testing.assert_array_equal(util.all_reduce([1, 2], 'max'),
                                  jfleet.UtilBase().all_reduce([1, 2], 'max'))
    util.barrier()
    util.print_on_rank('hello from 0', 0)
    util.print_on_rank('not me', 1)
    assert capsys.readouterr().out == 'hello from 0\n'
    with pytest.raises(TypeError):
        util.get_file_shard('a,b')
    assert fleet.util is fleet.get_fleet().util
    many = fleet.UtilBase(fleet.UserDefinedRoleMaker(worker_num=2))
    with pytest.raises(NotImplementedError, match='9b'):
        many.all_reduce([1.0])


def test_metrics_match_the_references_host_route():
    rs = np.random.RandomState(8)
    pos, neg = rs.randint(0, 50, 20), rs.randint(0, 50, 20)
    a = rs.rand(3, 4).astype(np.float32)
    jm, pm = jfleet.metrics, fleet.metrics
    for name in ('sum', 'max', 'min'):
        np.testing.assert_array_equal(getattr(pm, name)(a),
                                      getattr(jm, name)(a))
    np.testing.assert_array_equal(pm.sum(torch.from_numpy(a)), jm.sum(a))
    assert pm.auc(pos, neg) == jm.auc(pos, neg)
    for name in ('mae', 'mse', 'rmse'):
        assert getattr(pm, name)(np.array([3.5]), np.array([7])) == \
            getattr(jm, name)(np.array([3.5]), np.array([7]))
    assert pm.acc(np.array([6]), np.array([8])) == \
        jm.acc(np.array([6]), np.array([8]))


def test_local_fs_and_hdfs_client_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path))      # no hadoop on PATH
    outs = []
    for i, pkg in enumerate((fleet, jfleet)):
        root = tmp_path / f'fs{i}'
        fs = pkg.utils.LocalFS()
        fs.mkdirs(str(root / 'a' / 'b'))
        fs.touch(str(root / 'f.txt'))
        fs.touch(str(root / 'g.txt'))
        fs.mv(str(root / 'g.txt'), str(root / 'a' / 'g.txt'))
        fs.rename(str(root / 'a' / 'b'), str(root / 'a' / 'c'))
        got = [fs.ls_dir(str(root)), fs.ls_dir(str(root / 'a')),
               fs.list_dirs(str(root / 'a')), fs.is_file(str(root / 'f.txt')),
               fs.is_dir(str(root / 'a')), fs.need_upload_download(),
               fs.ls_dir(str(root / 'missing'))]
        with pytest.raises(FileExistsError):
            fs.touch(str(root / 'f.txt'), exist_ok=False)
        fs.delete(str(root / 'a'))
        got.append(fs.is_exist(str(root / 'a')))
        outs.append(got)
        with pytest.raises(RuntimeError, match='hadoop'):
            pkg.utils.HDFSClient()
    assert outs[0] == outs[1]
    assert fleet.utils.DistributedInfer('prog').get_dist_infer_program() \
        == 'prog'


def test_data_generators_match_the_reference():
    lines = ['1 2 3', '4 5', '6']

    def make(base):
        class Gen(base):
            def generate_sample(self, line):
                def it():
                    vals = [int(v) for v in line.split()]
                    yield [('ids', vals), ('len', [len(vals)])]
                return it
        g = Gen()
        g.set_batch(2)
        return g
    for name in ('MultiSlotDataGenerator', 'MultiSlotStringDataGenerator'):
        got = make(getattr(fleet, name)).run_from_memory(lines)
        want = make(getattr(jfleet, name)).run_from_memory(lines)
        assert got == want and got


def test_what_needs_an_instruction_census_raises():
    with pytest.raises(NotImplementedError, match='item 11'):
        paddle.profiler.match_collectives(None, {})
