"""The port's LR schedulers (``paddle_tpu_torch.optimizer.lr``) against
the JAX package's, on the CPU.

- the stateful API: every scheduler's ``last_lr`` (``get_lr()``) over 30
  ``step()`` calls equals the JAX one exactly, since both are the same
  host float arithmetic; ``LinearWarmup`` over a float and over every
  other scheduler; ``ReduceOnPlateau`` fed the same metrics;
- ``value_at(t)``, which the trainer evaluates at every step, for t in
  0..30, against the JAX one traced with an int32 step under
  ``jax.jit`` (the reference's compiled step evaluates it so), within 1
  f32 ulp: the port repeats the compiled f32 arithmetic on the host in
  ``np.float32`` (XLA's reciprocal products, folded constants and fused
  multiply-adds included), whose ``pow`` and ``exp`` may round the last
  bit otherwise than XLA's;
- ``state_dict``/``set_state_dict`` round trips, and the same keys and
  values as the JAX scheduler's;
- the documented difference (ROADMAP Queue 3): the reference's
  ``ReduceOnPlateau.value_at`` returns the Python float ``last_lr``, which
  ``jax.jit`` bakes into the trainer's compiled step, so after the LR
  drops to 0 the JAX trainer's next step still moves the weights; the
  port reads the live ``last_lr`` at every step, so its does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import ParallelTrainer

STEPS = 30


def _lam(e):
    return 0.95 ** e


# (name, args) of each scheduler, built the same way in both packages
SCHEDULERS = [
    ('NoamDecay', dict(d_model=64, warmup_steps=5, learning_rate=2.0)),
    ('ExponentialDecay', dict(learning_rate=0.5, gamma=0.9)),
    ('NaturalExpDecay', dict(learning_rate=0.5, gamma=0.1)),
    ('InverseTimeDecay', dict(learning_rate=0.5, gamma=0.2)),
    ('PolynomialDecay', dict(learning_rate=0.5, decay_steps=10,
                             end_lr=0.01, power=2.0)),
    ('PolynomialDecay', dict(learning_rate=0.5, decay_steps=7,
                             end_lr=0.01, cycle=True)),
    ('PiecewiseDecay', dict(boundaries=[3, 8], values=[0.1, 0.05, 0.01])),
    ('CosineAnnealingDecay', dict(learning_rate=0.5, T_max=12,
                                  eta_min=0.01)),
    ('MultiStepDecay', dict(learning_rate=0.5, milestones=[4, 9],
                            gamma=0.5)),
    ('StepDecay', dict(learning_rate=0.5, step_size=4, gamma=0.5)),
    ('LambdaDecay', dict(learning_rate=0.5, lr_lambda=_lam)),
]
IDS = [f'{n}-{i}' for i, (n, _) in enumerate(SCHEDULERS)]


def _pair(name, kw):
    return getattr(plr, name)(**kw), getattr(jlr, name)(**kw)


def _warmup_pair(name, kw):
    """``LinearWarmup`` over the scheduler ``name`` (over a float for
    None), in both packages."""
    if name is None:
        inner = 0.5, 0.5
    else:
        inner = _pair(name, kw)
    return (plr.LinearWarmup(inner[0], 7, 0.01, 0.5),
            jlr.LinearWarmup(inner[1], 7, 0.01, 0.5))


def _jax_values(sched, ts):
    fn = jax.jit(sched.value_at)       # traced once, as in the trainer
    return np.array([np.float32(fn(jnp.asarray(t, jnp.int32)))
                     for t in ts])


def _walk(port, ref):
    """last_lr of both over STEPS step() calls, exactly."""
    got, want = [port()], [ref()]
    for _ in range(STEPS):
        port.step()
        ref.step()
        got.append(port())
        want.append(ref())
    assert got == want
    assert port.last_epoch == ref.last_epoch


def _values(port, ref):
    got = np.array([port.value_at(t) for t in range(STEPS + 1)])
    want = _jax_values(ref, range(STEPS + 1))
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize('name,kw', SCHEDULERS, ids=IDS)
def test_get_lr_over_steps_equals_jax(name, kw):
    _walk(*_pair(name, kw))


@pytest.mark.parametrize('name,kw', SCHEDULERS, ids=IDS)
def test_value_at_equals_the_traced_jax_value(name, kw):
    _values(*_pair(name, kw))


@pytest.mark.parametrize('name,kw', [(None, None)] + SCHEDULERS,
                         ids=['float'] + IDS)
def test_linear_warmup_equals_jax(name, kw):
    _walk(*_warmup_pair(name, kw))
    _values(*_warmup_pair(name, kw))


def test_linear_warmup_over_reduce_on_plateau():
    port, ref = (m.LinearWarmup(m.ReduceOnPlateau(0.5), 4, 0.1, 0.5)
                 for m in (plr, jlr))
    _walk(port, ref)
    _values(port, ref)


def test_reduce_on_plateau_follows_the_metrics_as_jax():
    kw = dict(learning_rate=1.0, factor=0.5, patience=2, cooldown=1,
              min_lr=0.05)
    port, ref = plr.ReduceOnPlateau(**kw), jlr.ReduceOnPlateau(**kw)
    metrics = np.random.RandomState(0).rand(STEPS) + np.linspace(
        1, 0, STEPS) * (np.arange(STEPS) < 10)
    for m in metrics:
        port.step(float(m))
        ref.step(float(m))
        assert port() == ref() and port.last_epoch == ref.last_epoch
    assert port() < 1.0
    # value_at is the live last_lr, a Python float as in the reference
    assert port.value_at(3) == port.last_lr == ref.value_at(3)
    for mode in ('max',):
        a = plr.ReduceOnPlateau(1.0, mode=mode, patience=0,
                                threshold_mode='abs')
        b = jlr.ReduceOnPlateau(1.0, mode=mode, patience=0,
                                threshold_mode='abs')
        for m in (1.0, 0.5, 0.4, 2.0, 1.0):
            a.step(m)
            b.step(m)
            assert a() == b()


@pytest.mark.parametrize('name,kw', SCHEDULERS, ids=IDS)
def test_state_dict_round_trip(name, kw):
    port, ref = _pair(name, kw)
    for _ in range(7):
        port.step()
        ref.step()
    sd = port.state_dict()
    assert sd == ref.state_dict()
    fresh, _ = _pair(name, kw)
    fresh.set_state_dict(sd)
    assert fresh() == port() and fresh.last_epoch == port.last_epoch
    fresh.step()
    port.step()
    assert fresh() == port()
    fresh.set_dict(ref.state_dict())
    assert fresh.state_dict() == ref.state_dict()


# -- ReduceOnPlateau under the trainer: the documented difference ----------

MODEL_KW = dict(num_layers=1, hidden_size=32, num_heads=2, vocab_size=64,
                max_seq_len=16, dropout=0.0, fused_head=False)


def _trainers():
    paddle.seed(3)
    jm = jax_gpt_tiny(**MODEL_KW)
    host = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    js, ps = jlr.ReduceOnPlateau(0.1), plr.ReduceOnPlateau(0.1)
    jt = JaxTrainer(jm, JaxSGD(learning_rate=js, parameters=jm.parameters()),
                    lambda out, y: jm.loss(out, y))
    pt = ParallelTrainer(pm, SGD(learning_rate=ps,
                                 parameters=pm.parameters()),
                         lambda out, y: pm.loss(out, y))
    return jt, js, pt, ps


def test_reduce_on_plateau_lr_is_live_in_the_port_and_baked_in_jax():
    jt, js, pt, ps = _trainers()
    ids = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int64)
    jt.step(ids, ids)
    pt.step(ids, ids)
    # the LR drops to 0 (factor 0 after one bad epoch)
    for s in (js, ps):
        s.factor, s.patience = 0.0, 0
        s.step(1.0)
        s.step(2.0)
        assert s() == 0.0
    jbefore = {k: np.asarray(v) for k, v in jt.params.items()}
    pbefore = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    jt.step(ids, ids)
    pt.step(ids, ids)
    # the JAX trainer's compiled step kept the traced-in 0.1
    assert any(not np.array_equal(jbefore[k], np.asarray(v))
               for k, v in jt.params.items())
    # the port's step read last_lr == 0: nothing moved
    assert all(torch.equal(pbefore[n], p)
               for n, p in pt.model.named_parameters())
