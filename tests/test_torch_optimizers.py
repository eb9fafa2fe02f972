"""The port's optimizer family, gradient clipping and regularizers
against the JAX package's, on the CPU.

- every update rule (SGD, Momentum with and without Nesterov, Adagrad,
  Adadelta, RMSProp plain and centered with momentum, Lars, Adam, AdamW,
  Adamax, Lamb, DGCMomentum with and without Nesterov): a single step
  against its closed form in numpy, and 5 eager ``step()`` calls against
  the JAX optimizer's eager ``step()`` on the same numpy weights and
  gradients;
- the trainer's path (``_update`` with the scalars of ``_scalar_rows``,
  the clip through ``clip_values``) of every rule under each clip class
  (none, by value, by norm, by global norm), with a regularizer (none,
  L1, L2, where the constructor takes ``weight_decay``) and a scheduler
  rotating with the rule, 5 steps against the JAX ``apply_gradients``
  under ``jax.jit`` with a traced int32 step (the reference's compiled
  step: ``value_at(step)``);
- each clip class's ``clip_values`` and eager ``__call__`` (which leaves
  a parameter with ``need_clip = False`` alone and out of the global
  norm) against the JAX ones;
- L1 and L2 decay in closed form;
- the two step indexings of one schedule: the eager ``step()`` at
  ``get_lr()`` (``last_epoch``; a first step at ``PiecewiseDecay``'s 0
  does not move), the trainer at ``value_at`` of the 1-based step (its
  first step does), each against the JAX package (the trainer on
  ``gpt_tiny``);
- GPT-3 Small's recipe (AdamW beta2 0.95 and weight decay 0.1 with
  biases and LayerNorm exempt, ``LinearWarmup`` into
  ``CosineAnnealingDecay``, ``ClipGradByGlobalNorm(1.0)``) through the
  port's trainer against the JAX trainer on ``gpt_tiny``, across the
  warmup's end;
- ``AdamW(lr_ratio=)`` and ``Lamb(exclude_from_weight_decay_fn=)`` are
  accepted and unread in both packages (a reference fault, ROADMAP
  Queue 3);
- ``state_dict``/``set_state_dict`` with ``LR_Scheduler``, into the live
  slots;
- every optimizer of the reference's ``__all__`` builds with a
  scheduler, each clip class and a regularizer;
- ``step_fused`` under the NaN guard equals eager ``step`` bit for bit
  for every optimizer (DGC's gate then selects on the device).

Tolerances: 1e-6 on a rule's single step (f32, one rounding or two);
1e-5 after 5 steps of a rule on shared gradients (f32; XLA contracts
products and sums into fused multiply-adds and reduces norms in another
order); the trainer comparisons on ``gpt_tiny`` take
``tests/test_torch_gpt_training.py``'s: losses 1e-5, parameters 1e-4,
the key bias within ``2 * lr * steps`` for the Adam family (its true
gradient is 0, so each framework's round-off is scaled to steps of up
to ``lr``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import clip as jclip
from paddle_tpu import regularizer as jreg
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
import paddle_tpu_torch.optimizer as popt_mod
from paddle_tpu_torch import regularizer as preg
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import clip as pclip
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import ParallelTrainer


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after:
    the suite runs six workers on the machine's cores, and torch's
    default of a thread a core oversubscribes them."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

STEP_TOL = 1e-6
RULE_TOL = 1e-5
TOL = 1e-5
PARAM_TOL = 1e-4
STEPS = 5
SHAPES = {'b': (5,), 'w': (6, 5)}      # sorted: the JAX pytree's order


def _decay_all_but_bias(name):
    return name != 'b'


# (optimizer, its arguments, learning rate, takes weight_decay)
RULES = [
    ('SGD', {}, 0.1, True),
    ('Momentum', dict(momentum=0.9), 0.05, True),
    ('Momentum', dict(momentum=0.9, use_nesterov=True), 0.05, True),
    ('Adagrad', dict(epsilon=1e-6, initial_accumulator_value=0.1), 0.1,
     True),
    ('Adadelta', dict(epsilon=1e-6, rho=0.9), 1.0, True),
    ('RMSProp', dict(rho=0.9, epsilon=1e-6), 0.01, True),
    ('RMSProp', dict(rho=0.9, epsilon=1e-6, momentum=0.5, centered=True),
     0.01, True),
    ('Lars', dict(momentum=0.9, lars_coeff=0.01, lars_weight_decay=5e-4),
     0.5, False),
    ('Adam', {}, 0.01, True),
    ('AdamW', dict(weight_decay=0.05,
                   apply_decay_param_fun=_decay_all_but_bias), 0.01, False),
    ('Adamax', {}, 0.01, True),
    ('Lamb', dict(lamb_weight_decay=0.01), 0.01, False),
    ('DGCMomentum', dict(momentum=0.9, rampup_begin_step=1, rampup_step=3,
                         sparsity=[0.5, 0.75, 0.9]), 0.05, True),
    ('DGCMomentum', dict(momentum=0.9, rampup_begin_step=2, rampup_step=2,
                         sparsity=[0.6, 0.8], use_nesterov=True), 0.05,
     True),
]
RULE_IDS = [f'{r[0]}-{i}' for i, r in enumerate(RULES)]
CLIPS = [None, ('ClipGradByValue', (0.5,)), ('ClipGradByNorm', (1.0,)),
         ('ClipGradByGlobalNorm', (1.0,))]
CLIP_IDS = ['noclip', 'value', 'norm', 'global']
REGULARIZERS = [None, ('L1Decay', 0.01), ('L2Decay', 0.02)]


def _schedulers(lr, i):
    """A scheduler for rule ``i`` with peak ``lr``, in both packages
    (None: the float)."""
    kind = i % 5
    if kind == 0:
        return lr, lr
    if kind == 1:
        return tuple(m.PiecewiseDecay([2, 4], [lr, lr / 2, lr / 4])
                     for m in (plr, jlr))
    if kind == 2:
        return tuple(m.LinearWarmup(m.CosineAnnealingDecay(lr, 6, lr / 10),
                                    2, 0.0, lr) for m in (plr, jlr))
    if kind == 3:
        return tuple(m.ExponentialDecay(lr, 0.8) for m in (plr, jlr))
    return tuple(m.PolynomialDecay(lr, 4, lr / 10, power=2.0)
                 for m in (plr, jlr))


def _data(seed=0):
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _build(name, kw, lr, clip=None, reg=None, sched=None):
    """(port optimizer and parameters, JAX optimizer and parameters)."""
    params, _ = _data()
    p_lr, j_lr = sched if sched is not None else (lr, lr)
    extra = [{}, {}]
    if clip is not None:
        extra[0]['grad_clip'] = getattr(pclip, clip[0])(*clip[1])
        extra[1]['grad_clip'] = getattr(jclip, clip[0])(*clip[1])
    if reg is not None:
        extra[0]['weight_decay'] = getattr(preg, reg[0])(reg[1])
        extra[1]['weight_decay'] = getattr(jreg, reg[0])(reg[1])
    pp = [torch.nn.Parameter(torch.from_numpy(params[n].copy()))
          for n in SHAPES]
    popt = getattr(popt_mod, name)(learning_rate=p_lr, parameters=pp,
                                   **kw, **extra[0])
    popt._param_names.update({id(p): n for p, n in zip(pp, SHAPES)})
    jp = [JaxParameter(params[n].copy(), name=n) for n in SHAPES]
    jopt = getattr(jopt_mod, name)(learning_rate=j_lr, parameters=jp,
                                   **kw, **extra[1])
    return popt, pp, jopt, jp


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# -- single steps in closed form ------------------------------------------

def _closed_form(name, kw, lr, p, g, wd):
    """One step from zero state, in numpy (f64), the reference's math;
    ``wd``: AdamW's decoupled decay for this parameter."""
    if name == 'SGD':
        return p - lr * g
    if name == 'Momentum':
        return p - lr * (g + kw['momentum'] * g if kw.get('use_nesterov')
                         else g)
    if name == 'Adagrad':
        acc = kw['initial_accumulator_value'] + g * g
        return p - lr * g / (np.sqrt(acc) + kw['epsilon'])
    if name == 'Adadelta':
        rho, eps = kw['rho'], kw['epsilon']
        upd = np.sqrt(eps) / np.sqrt((1 - rho) * g * g + eps) * g
        return p - lr * upd
    if name == 'RMSProp':
        rho, eps = kw['rho'], kw['epsilon']
        ms = (1 - rho) * g * g
        if kw.get('centered'):
            mg = (1 - rho) * g
            return p - lr * g / np.sqrt(ms - mg * mg + eps)
        return p - lr * g / np.sqrt(ms + eps)
    if name == 'Lars':
        wn, gn = np.linalg.norm(p), np.linalg.norm(g)
        local = kw['lars_coeff'] * wn / (gn + kw['lars_weight_decay'] * wn
                                          + 1e-12)
        return p - lr * local * (g + kw['lars_weight_decay'] * p)
    if name in ('Adam', 'AdamW'):
        return p * (1 - lr * wd) - lr * g / (np.abs(g) + 1e-8)
    if name == 'Adamax':
        return p - lr * g / (np.abs(g) + 1e-8)
    if name == 'Lamb':
        r = g / (np.abs(g) + 1e-6) + kw['lamb_weight_decay'] * p
        return p - lr * np.linalg.norm(p) / np.linalg.norm(r) * r
    if name == 'DGCMomentum':       # the first step is dense (t <= begin)
        return p - lr * (kw['momentum'] * g + g if kw.get('use_nesterov')
                         else g)
    raise KeyError(name)


@pytest.mark.parametrize('name,kw,lr,_', RULES, ids=RULE_IDS)
def test_single_step_closed_form(name, kw, lr, _):
    params, grads = _data()
    popt, pp, _, _ = _build(name, kw, lr)
    for p, n in zip(pp, SHAPES):
        p.grad = torch.from_numpy(grads[0][n])
    popt.step()
    for p, n in zip(pp, SHAPES):
        wd = kw.get('weight_decay', 0.0) if _decay_all_but_bias(n) else 0.0
        want = _closed_form(name, kw, lr, params[n].astype(np.float64),
                            grads[0][n].astype(np.float64), wd)
        _close(p.detach().numpy(), want, STEP_TOL, f'{name} {n}')


# -- eager trajectories against the JAX optimizer --------------------------

@pytest.mark.parametrize('name,kw,lr,_', RULES, ids=RULE_IDS)
def test_eager_steps_match_the_jax_optimizer(name, kw, lr, _):
    _, grads = _data()
    popt, pp, jopt, jp = _build(name, kw, lr)
    for g in grads:
        for p, q, n in zip(pp, jp, SHAPES):
            p.grad = torch.from_numpy(g[n])
            q.grad = g[n]
        popt.step()
        jopt.step()
    for p, q, n in zip(pp, jp, SHAPES):
        _close(p.detach().numpy(), q.value, RULE_TOL, f'{name} {n}')
    got, want = popt.state_dict(), jopt.state_dict()
    assert set(got) == set(want) and got['global_step'] == STEPS
    for k in want:
        if k != 'global_step':
            _close(got[k].numpy(), want[k].value, RULE_TOL, k)


# -- the trainer's path against the compiled apply_gradients ---------------

@pytest.mark.parametrize('clip', CLIPS, ids=CLIP_IDS)
@pytest.mark.parametrize('i', range(len(RULES)), ids=RULE_IDS)
def test_trainer_path_matches_jax_apply_gradients(i, clip):
    name, kw, lr, takes_wd = RULES[i]
    reg = REGULARIZERS[i % 3] if takes_wd else None
    popt, pp, jopt, _ = _build(name, kw, lr, clip, reg, _schedulers(lr, i))
    params, grads = _data()
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jopt.init(jparams)
    apply = jax.jit(jopt.apply_gradients)
    for t, g in enumerate(grads, 1):
        jparams, jstate = apply(jparams, {n: jnp.asarray(v)
                                          for n, v in g.items()},
                                jstate, jnp.asarray(t, jnp.int32))
        for p, n in zip(pp, SHAPES):
            p.grad = torch.from_numpy(g[n])
        popt._load_step(popt._scalar_rows(t, 1)[0])
        popt._t = t
        popt._update()
    for p, n in zip(pp, SHAPES):
        _close(p.detach().numpy(), jparams[n], RULE_TOL, f'{name} {n}')


def test_the_trainer_path_scalars_come_from_value_at():
    """AdamW under a scheduler: lr is ``value_at(t)`` and the decay
    factor ``1 - lr * wd`` is formed in f32 from it; under a float the
    decay is formed in double and rounded once (the reference's weakly
    typed Python float)."""
    sched = plr.LinearWarmup(plr.CosineAnnealingDecay(6e-4, 20, 6e-5), 3,
                             0.0, 6e-4)
    opt = popt_mod.AdamW(learning_rate=sched, weight_decay=0.1,
                         parameters=[torch.nn.Parameter(torch.zeros(2))])
    for t in (1, 3, 4, 9):
        row = dict(zip(opt._scalar_names(), opt._scalar_rows(t, 1)[0]))
        lr = sched.value_at(t)
        assert row['lr'] == lr
        assert row['decay'] == np.float32(1) - lr * np.float32(0.1)
    flt = popt_mod.AdamW(learning_rate=6e-4, weight_decay=0.1,
                         parameters=[torch.nn.Parameter(torch.zeros(2))])
    row = dict(zip(flt._scalar_names(), flt._scalar_rows(5, 1)[0]))
    assert row['decay'] == np.float32(1 - 6e-4 * 0.1)


# -- clipping ---------------------------------------------------------------

@pytest.mark.parametrize('clip', CLIPS[1:], ids=CLIP_IDS[1:])
def test_clip_values_match_jax(clip):
    _, grads = _data(3)
    gs = [grads[0][n] * 3 for n in SHAPES]
    got = getattr(pclip, clip[0])(*clip[1]).clip_values(
        [torch.from_numpy(g) for g in gs])
    want = getattr(jclip, clip[0])(*clip[1]).clip_values(
        [jnp.asarray(g) for g in gs])
    for a, b in zip(got, want):
        _close(a.numpy(), b, STEP_TOL)


@pytest.mark.parametrize('clip', CLIPS[1:], ids=CLIP_IDS[1:])
def test_eager_clip_honours_need_clip(clip):
    _, grads = _data(4)
    gs = [grads[0][n] * 3 for n in SHAPES] + [np.full(3, 100.0, np.float32)]
    pp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    jp = [JaxParameter(np.zeros(g.shape, np.float32)) for g in gs]
    pp[1].need_clip = jp[1].need_clip = False
    got = getattr(pclip, clip[0])(*clip[1])(
        [(p, torch.from_numpy(g)) for p, g in zip(pp, gs)] + [(pp[0], None)])
    jax_pairs = []
    for q, g in zip(jp, gs):
        q.grad = g
        jax_pairs.append((q, q.grad))
    want = getattr(jclip, clip[0])(*clip[1])(jax_pairs + [(jp[0], None)])
    assert got[1][1] is not None and torch.equal(got[1][1],
                                                 torch.from_numpy(gs[1]))
    assert got[-1] == (pp[0], None)
    for (p, a), (_, b) in zip(got[:-1], want[:-1]):
        assert a is not None
        _close(a.numpy(), b.value, STEP_TOL)
    # the eager step runs the eager clip, need_clip included
    opt = popt_mod.SGD(learning_rate=1.0, parameters=pp,
                       grad_clip=getattr(pclip, clip[0])(*clip[1]))
    for p, g in zip(pp, gs):
        p.grad = torch.from_numpy(g)
    opt.step()
    for p, (_, b) in zip(pp, want[:-1]):
        _close(-p.detach().numpy(), b.value, STEP_TOL)


def test_clip_scales_in_closed_form():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]        # norm 13
    by_norm = pclip.ClipGradByNorm(2.5).clip_values(g)
    _close(by_norm[0].numpy(), [1.5, 2.0], STEP_TOL)            # 5 -> 2.5
    _close(by_norm[1].numpy(), [2.5], STEP_TOL)
    glob = pclip.ClipGradByGlobalNorm(6.5).clip_values(g)
    _close(torch.cat(glob).numpy(), [1.5, 2.0, 6.0], STEP_TOL)
    # under the clip norm nothing changes: clip / max(n, clip) == 1
    assert all(torch.equal(a, b) for a, b in zip(
        pclip.ClipGradByGlobalNorm(20.0).clip_values(g), g))
    assert torch.equal(pclip.ClipGradByNorm(1.0).clip_values(
        [torch.zeros(3)])[0], torch.zeros(3))


def test_legacy_clip_names():
    e = pclip.ErrorClipByValue(2.0)
    assert (e.max, e.min) == (2.0, -2.0)
    p = torch.nn.Parameter(torch.zeros(2))
    c = pclip.ClipGradByValue(1.0)
    with pytest.warns(UserWarning, match='deprecated'):
        pclip.set_gradient_clip(c, param_list=[p])
    assert p.grad_clip is c and pclip.get_gradient_clip() is None
    with pytest.warns(UserWarning):
        pclip.set_gradient_clip(c)
    try:
        assert pclip.get_gradient_clip() is c
    finally:
        pclip._GLOBAL_CLIP[0] = None
    nn = importlib.import_module('paddle_tpu_torch.nn')
    jnn = importlib.import_module('paddle_tpu.nn')
    for name in ('ClipGradByValue', 'ClipGradByNorm',
                 'ClipGradByGlobalNorm'):
        assert hasattr(nn, name) and hasattr(jnn, name)
    assert set(pclip.__all__) >= set(jclip.__all__)


# -- regularizers -----------------------------------------------------------

@pytest.mark.parametrize('reg', REGULARIZERS[1:], ids=['l1', 'l2'])
def test_regularizer_closed_form(reg):
    params, _ = _data()             # _build's weights
    _, grads = _data(5)
    popt, pp, jopt, jp = _build('SGD', {}, 0.1, reg=reg)
    for p, q, n in zip(pp, jp, SHAPES):
        p.grad = torch.from_numpy(grads[0][n])
        q.grad = grads[0][n]
    popt.step()
    jopt.step()
    for p, q, n in zip(pp, jp, SHAPES):
        p0, g = params[n].astype(np.float64), grads[0][n].astype(np.float64)
        extra = np.sign(p0) if reg[0] == 'L1Decay' else p0
        _close(p.detach().numpy(), p0 - 0.1 * (g + reg[1] * extra),
               STEP_TOL, n)
        _close(p.detach().numpy(), q.value, STEP_TOL, n)
    assert preg.L1DecayRegularizer is preg.L1Decay
    assert preg.L2DecayRegularizer is preg.L2Decay


# -- the two step indexings -------------------------------------------------

def test_eager_step_reads_last_epoch_as_jax():
    """``PiecewiseDecay([1, 2], [0, 1, 5])``: the eager ``step()`` runs
    at ``get_lr()``, the value at ``last_epoch`` 0, so the first step does
    not move; after ``scheduler.step()`` it runs at 1."""
    params, _ = _data()
    _, grads = _data(6)
    sched = (plr.PiecewiseDecay([1, 2], [0.0, 1.0, 5.0]),
             jlr.PiecewiseDecay([1, 2], [0.0, 1.0, 5.0]))
    popt, pp, jopt, jp = _build('SGD', {}, None, sched=sched)
    for step in range(3):
        for p, q, n in zip(pp, jp, SHAPES):
            p.grad = torch.from_numpy(grads[step][n])
            q.grad = grads[step][n]
        popt.step()
        jopt.step()
        if step == 0:
            for p, n in zip(pp, SHAPES):
                assert np.array_equal(p.detach().numpy(), params[n])
        for p, q, n in zip(pp, jp, SHAPES):
            _close(p.detach().numpy(), q.value, STEP_TOL, n)
        for s in sched:
            s.step()
    assert popt.get_lr() == jopt.get_lr() == 5.0


MODEL_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
                max_seq_len=64, dropout=0.0, fused_head=False)


@pytest.fixture(scope='module')
def weights():
    paddle.seed(7)
    params, _ = jax_gpt_tiny(**MODEL_KW).functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name:
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    return host


def _ids(k, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (k, 2, 32)).astype(
        np.int64)


def _no_decay(name):
    return not (name.endswith('bias') or '.ln' in name)


def _recipe(m, params, warmup=3, t_max=8):
    """GPT-3 Small's optimisation recipe in package ``m`` (the port's or
    the JAX ``optimizer`` and ``nn.clip`` modules)."""
    opt, lr, clip = m
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(6e-4, t_max,
                                                    eta_min=6e-5),
                            warmup, start_lr=0.0, end_lr=6e-4)
    return opt.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                     epsilon=1e-8, weight_decay=0.1,
                     apply_decay_param_fun=_no_decay, parameters=params,
                     grad_clip=clip.ClipGradByGlobalNorm(1.0))


def _trainer_pair(host, make_opt):
    jm = jax_gpt_tiny(**MODEL_KW)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    jt = JaxTrainer(jm, make_opt(0, jm.parameters()),
                    lambda out, y: jm.loss(out, y))
    pt = ParallelTrainer(pm, make_opt(1, pm.parameters()),
                         lambda out, y: pm.loss(out, y))
    return jt, pt


def _params_close(pt, jt, lr, steps):
    h = MODEL_KW['hidden_size']
    for name, p in pt.model.named_parameters():
        got, want = p.detach().numpy(), np.asarray(jt.params[name])
        if name.endswith('attn.qkv.bias'):
            key = slice(h, 2 * h)
            _close(got[key], want[key], 2 * lr * steps, name)
            got, want = np.delete(got, np.s_[key]), np.delete(want, np.s_[key])
        _close(got, want, PARAM_TOL, name)


def test_the_trainer_reads_value_at_the_step_as_jax(weights):
    """The same ``PiecewiseDecay([1, 2], [0, 0.1, 0.05])`` through both
    trainers: step 1 runs at ``value_at(1)`` = 0.1 (the weights move),
    whatever the scheduler's ``last_epoch`` says."""
    def make(i, params):
        m = (jlr, plr)[i]
        return (jopt_mod, popt_mod)[i].SGD(
            learning_rate=m.PiecewiseDecay([1, 2], [0.0, 0.1, 0.05]),
            parameters=params)
    jt, pt = _trainer_pair(weights, make)
    ids = _ids(3)
    before = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    for i in range(3):
        want = jt.loss_float(jt.step(ids[i], ids[i]))
        _close(pt.loss_float(pt.step(ids[i], ids[i])), want, TOL)
        if i == 0:
            assert any(not torch.equal(before[n], p)
                       for n, p in pt.model.named_parameters())
    assert pt.optimizer._learning_rate.last_epoch == 0
    _params_close(pt, jt, 0.1, 3)


def test_gpt3_recipe_trainer_matches_the_jax_trainer(weights):
    mods = ((jopt_mod, jlr, jclip), (popt_mod, plr, pclip))
    jt, pt = _trainer_pair(weights, lambda i, ps: _recipe(mods[i], ps))
    ids = _ids(6, seed=1)
    for i in range(6):          # 3 warmup steps, then the cosine
        want = jt.loss_float(jt.step(ids[i], ids[i]))
        _close(pt.loss_float(pt.step(ids[i], ids[i])), want, TOL)
    _params_close(pt, jt, 6e-4, 6)


# -- arguments the reference never reads ------------------------------------

@pytest.mark.parametrize('name,extra', [
    ('AdamW', dict(lr_ratio=lambda p: 0.1)),
    ('Lamb', dict(exclude_from_weight_decay_fn=lambda n: True))],
    ids=['AdamW-lr_ratio', 'Lamb-exclude_fn'])
def test_unread_arguments_change_nothing_in_either_package(name, extra):
    _, grads = _data(7)
    runs = []
    for kw in ({}, extra):
        popt, pp, jopt, jp = _build(name, kw, 0.01)
        for g in grads:
            for p, q, n in zip(pp, jp, SHAPES):
                p.grad = torch.from_numpy(g[n])
                q.grad = g[n]
            popt.step()
            jopt.step()
        runs.append(([p.detach().clone() for p in pp],
                     [np.asarray(q.value) for q in jp]))
    (p0, j0), (p1, j1) = runs
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(np.array_equal(a, b) for a, b in zip(j0, j1))


# -- state_dict --------------------------------------------------------------

def test_set_state_dict_round_trip_with_the_scheduler():
    _, grads = _data(8)

    def build():
        sched = plr.StepDecay(0.01, 2, gamma=0.5)
        pp = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
        return popt_mod.Adam(learning_rate=sched, parameters=pp), pp, sched

    a, pa, sa = build()
    for g in grads[:3]:
        for p, n in zip(pa, SHAPES):
            p.grad = torch.from_numpy(g[n])
        a.step()
        sa.step()
    sd = a.state_dict()
    assert sd['LR_Scheduler'] == sa.state_dict() and sd['global_step'] == 3
    b, pb, sb = build()
    for p, q in zip(pb, pa):
        p.data.copy_(q.data)
    b.set_dict(sd)
    assert sb.last_epoch == 3 and b.get_lr() == a.get_lr()
    for p, n in zip(pb, SHAPES):
        p.grad = torch.from_numpy(grads[3][n])
    b.step()                                # the state now exists
    ptrs = [v.data_ptr() for k, v in b.state_dict().items()
            if torch.is_tensor(v)]
    b.set_state_dict(sd)                    # into the live slots
    assert [v.data_ptr() for k, v in b.state_dict().items()
            if torch.is_tensor(v)] == ptrs
    # both take step 4 from a's state at step 3 on the same gradients:
    # the same moments (b's weights took an extra step, which Adam's
    # moments do not read)
    for opt, ps in ((a, pa), (b, pb)):
        for p, n in zip(ps, SHAPES):
            p.grad = torch.from_numpy(grads[3][n])
        opt.step()
    assert b._global_step == a._global_step == 4
    for k, v in a.state_dict().items():
        if torch.is_tensor(v):
            assert torch.equal(v, b.state_dict()[k]), k


# -- construction -------------------------------------------------------------

@pytest.mark.parametrize('name', [n for n in jopt_mod.__all__
                                  if n not in ('Optimizer', 'lr')])
def test_every_optimizer_builds_with_schedulers_clips_and_regularizers(name):
    import inspect
    cls = getattr(popt_mod, name)
    takes_wd = 'weight_decay' in inspect.signature(
        getattr(jopt_mod, name).__init__).parameters
    for clip in CLIPS:
        kw = dict(learning_rate=plr.NoamDecay(64, 4),
                  parameters=[torch.nn.Parameter(torch.zeros(2))])
        if clip is not None:
            kw['grad_clip'] = getattr(pclip, clip[0])(*clip[1])
        if takes_wd:
            for reg in (preg.L1Decay(0.1), preg.L2Decay(0.1)):
                cls(weight_decay=reg, **kw)
        cls(**kw)
    assert set(popt_mod.__all__) == set(jopt_mod.__all__)


# -- the guarded graph's path equals the eager one -----------------------------

@pytest.mark.parametrize('i', range(len(RULES)), ids=RULE_IDS)
def test_guarded_step_fused_equals_eager_for_every_optimizer(weights, i):
    """``step_fused`` with ``nan_guard`` (the scalars picked from the
    chunk's table on the device, DGC's gate selected there) against eager
    guarded ``step`` calls, bit for bit, with a clip, a regularizer and a
    scheduler rotating with the rule."""
    name, kw, lr, takes_wd = RULES[i]
    trainers = []
    for fused in (None, 4):
        pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(weights)
        extra = {}
        if i % 4:
            c = CLIPS[i % 4]
            extra['grad_clip'] = getattr(pclip, c[0])(*c[1])
        if takes_wd and REGULARIZERS[i % 3]:
            r = REGULARIZERS[i % 3]
            extra['weight_decay'] = getattr(preg, r[0])(r[1])
        opt = getattr(popt_mod, name)(
            learning_rate=_schedulers(lr * 0.01, i)[0],
            parameters=pm.parameters(), **kw, **extra)
        trainers.append(ParallelTrainer(
            pm, opt, lambda out, y, m=pm: m.loss(out, y), nan_guard=True,
            fused_steps=fused))
    eager, fused = trainers
    ids = _ids(4, seed=2)
    want = torch.stack([eager.step(ids[j], ids[j]) for j in range(4)])
    got = fused.step_fused(ids, ids)
    assert torch.equal(got, want)
    assert eager._step_no == fused._step_no == 4
    for (n, p), (_, q) in zip(eager.model.named_parameters(),
                              fused.model.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize('n', [2, 7, 1000, 100_003])
def test_dgc_threshold_on_the_cpu_is_the_cards_sort(n, monkeypatch):
    """DGC's threshold on the CPU takes its two order statistics by
    selection (``kthvalue``) where the card sorts: the same numbers, so
    the card's branch (run here on the CPU) bit for bit, and
    ``jnp.quantile`` within one f32 ulp as that branch is; NaN where
    ``|v|`` holds one."""
    from paddle_tpu_torch.optimizer.dgc import quantile_linear
    v = np.abs(np.random.RandomState(n).randn(n)).astype(np.float32)
    qs = (0.0, 0.5, 0.75, 0.9, 0.999, 1.0)

    def thresholds(x):
        return [quantile_linear(torch.from_numpy(x),
                                torch.tensor(q, dtype=torch.float32))
                for q in qs]
    got = thresholds(v)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, 'is_cuda', property(lambda self: True))
        sort = thresholds(v)
    for q, a, b in zip(qs, got, sort):
        assert a.numpy().tobytes() == b.numpy().tobytes(), q
        want = np.asarray(jnp.quantile(jnp.asarray(v), jnp.float32(q)))
        np.testing.assert_allclose(a.numpy(), want, rtol=1.2e-7, atol=0)
    v[n // 2] = np.nan
    assert all(torch.isnan(t) for t in thresholds(v))
