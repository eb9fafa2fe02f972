"""The port's NaN guard (``ParallelTrainer(nan_guard=True)``,
``resilience.sentinel``, ``core.scan_loop``'s guarded form) against the
JAX package's, on the CPU: the counterparts of
``tests/test_fused_loop.py``'s guarded-chunk tests.

The model is ``gpt_tiny`` and the loss is multiplied by a per-step f32
weight from the batch, which is NaN at a poisoned step.

- the eager guarded trainer against the JAX one: the poisoned step's
  loss is NaN in both, its update is dropped, ``_step_no`` counts the
  finite steps only, and the next steps run at the count without the
  skipped one (the LR schedule and Adam's bias corrections), with GPT-3
  Small's recipe (AdamW, ``LinearWarmup`` into ``CosineAnnealingDecay``,
  global-norm clipping);
- ``step_fused`` against eager guarded steps, bit for bit (on the CPU
  the same step body runs eagerly, with the scalars picked from the
  chunk's table by the device-side counter), through a poisoned chunk
  and the chunk after it; and against the JAX ``step_fused``;
- one host read per guarded chunk (``chunk_sync``), none without the
  guard; ``_fused_rows`` monotone under skips;
- the sentinel: skip, then (after ``nan_patience`` strikes) the
  rollback, which finds no checkpoint and warns, then past
  ``nan_max_rollbacks`` the ``FloatingPointError``;
- a finite gradient of 1e20, whose square overflows f32, trips the
  guard as in the reference (``isfinite`` of the gradients would not);
- the guard keeps a model's float buffers, as the reference's
  ``guard_update`` over its buffers does.

Tolerances: losses 1e-5 and parameters 1e-4 against the JAX trainer,
the key bias within ``2 * lr * steps`` (``tests/test_torch_gpt_training.
py``'s); the port against itself bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu.resilience import sentinel as jsentinel
from paddle_tpu_torch.core import scan_loop
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import clip as pclip
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import ParallelTrainer
from paddle_tpu_torch.resilience import (NanSentinel, finite_step,
                                         guard_update)

TOL = 1e-5
PARAM_TOL = 1e-4
LR = 6e-4
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


def _no_decay(name):
    return not (name.endswith('bias') or '.ln' in name)


def _opt(m, cls, clip, params):
    sched = m.LinearWarmup(m.CosineAnnealingDecay(LR, 8, eta_min=LR / 10),
                           3, start_lr=0.0, end_lr=LR)
    return cls(learning_rate=sched, beta2=0.95, weight_decay=0.1,
               apply_decay_param_fun=_no_decay, parameters=params,
               grad_clip=clip.ClipGradByGlobalNorm(1.0))


def _port(host, **kw):
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    return ParallelTrainer(
        pm, _opt(plr, AdamW, pclip, pm.parameters()),
        lambda out, y, w: pm.loss(out, y) * w, nan_guard=True, **kw)


def _jax(host, **kw):
    jm = jax_gpt_tiny(**MODEL_KW)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    return JaxTrainer(jm, _opt(jlr, JaxAdamW, jclip, jm.parameters()),
                      lambda out, y, w: jm.loss(out, y) * w, nan_guard=True,
                      **kw)


def _chunk(k, poison=(), seed=0, value=np.nan):
    ids = np.random.RandomState(seed).randint(0, 128, (k, 2, 32)).astype(
        np.int64)
    w = np.ones(k, np.float32)
    w[list(poison)] = value
    return ids, w


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _params_close(pt, jparams, steps):
    h = MODEL_KW['hidden_size']
    for name, p in pt.model.named_parameters():
        got, want = p.detach().numpy(), np.asarray(jparams[name])
        assert np.isfinite(got).all(), name
        if name.endswith('attn.qkv.bias'):
            key = slice(h, 2 * h)
            _close(got[key], want[key], 2 * LR * steps, name)
            got, want = np.delete(got, np.s_[key]), np.delete(want, np.s_[key])
        _close(got, want, PARAM_TOL, name)


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _assert_same_state(a, b):
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert (torch.equal(sa[k], sb[k]) if torch.is_tensor(sa[k])
                else sa[k] == sb[k]), k
    assert a._step_no == b._step_no


def test_eager_guarded_trainer_matches_the_jax_one(weights):
    ids, w = _chunk(6, poison=(2,))
    jt, pt = _jax(weights), _port(weights)
    for i in range(6):
        want = jt.loss_float(jt.step(ids[i], ids[i], w[i]))
        got = pt.loss_float(pt.step(ids[i], ids[i], w[i]))
        if i == 2:
            assert np.isnan(want) and np.isnan(got)
        else:
            _close(got, want, TOL, f'step {i}')
    assert pt._step_no == jt._step_no == pt.optimizer._global_step == 5
    assert pt.sentinel.total_skipped == jt.sentinel.total_skipped == 1
    assert pt.sentinel.state_dict() == jt.sentinel.state_dict()
    _params_close(pt, jt.params, 5)


@pytest.mark.parametrize('k,poison', [(4, (2,)), (4, ()), (3, (0, 1))])
def test_step_fused_equals_eager_guarded_steps(weights, k, poison):
    eager, fused = _port(weights), _port(weights, fused_steps=k)
    for c, bad in enumerate((poison, ())):      # the chunk after, too
        ids, w = _chunk(k, bad, seed=c)
        want = torch.stack([eager.step(ids[i], ids[i], w[i])
                            for i in range(k)])
        got = fused.step_fused(ids, ids, w)
        assert _same(got, want)
        assert torch.isnan(got).sum() == len(bad)
        _assert_same_state(eager, fused)
    assert fused._step_no == 2 * k - len(poison)
    assert fused.sentinel.total_skipped == len(poison)


def test_step_fused_matches_the_jax_step_fused(weights):
    k = 4
    ids, w = _chunk(k, poison=(1,))
    jt, pt = _jax(weights, fused_steps=k), _port(weights, fused_steps=k)
    want = np.asarray(jt.step_fused(ids, ids, w))
    got = pt.step_fused(ids, ids, w).numpy()
    assert np.isnan(want[1]) and np.isnan(got[1])
    _close(np.delete(got, 1), np.delete(want, 1), TOL)
    assert pt._step_no == jt._step_no == k - 1
    assert pt.sentinel.total_skipped == jt.sentinel.total_skipped == 1
    _params_close(pt, jt.params, k - 1)


def test_one_host_read_per_guarded_chunk_and_monotone_rows(weights):
    k = 4
    tr = _port(weights, fused_steps=k)
    ids, w = _chunk(k, poison=(1,))
    tr.step_fused(ids, ids, w)
    assert tr.chunk_syncs == 1
    assert tr._fused_rows == k and tr._step_no == k - 1
    tr.step_fused(ids, ids, np.ones(k, np.float32))
    assert tr.chunk_syncs == 2
    # rows stay unique under skips: 2k, not 2k - 1
    assert tr._fused_rows == 2 * k and tr._step_no == 2 * k - 1
    plain = ParallelTrainer(tr.model, tr.optimizer,
                            lambda out, y, w: tr.model.loss(out, y) * w,
                            fused_steps=k)
    plain.step_fused(ids, ids, np.ones(k, np.float32))
    assert plain.chunk_syncs == 0                   # none unguarded
    assert plain.sentinel is None and plain._fused_rows == k


@pytest.mark.parametrize('fused', [None, 3])
def test_skip_then_rollback_warning_then_fatal(weights, fused):
    tr = _port(weights, fused_steps=fused, nan_patience=2,
               nan_max_rollbacks=1)
    events = []
    tr.sentinel.on_event = lambda kind, info: events.append(kind)
    ids, bad = _chunk(3, poison=(0, 1, 2))

    def run():
        if fused:
            return tr.step_fused(ids, ids, bad)
        return [tr.step(ids[i], ids[i], bad[i]) for i in range(3)]

    before = [p.detach().clone() for p in tr.model.parameters()]
    with pytest.warns(RuntimeWarning, match='no checkpoint'):
        run()               # skip, rollback (warned), skip
    # a fused chunk stops observing at its rollback, as the reference's
    assert events == (['skip', 'rollback'] if fused else
                      ['skip', 'rollback', 'skip'])
    assert tr.sentinel.rollbacks == 1 and tr._step_no == 0
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                 tr.model.parameters()))
    with pytest.raises(FloatingPointError, match='diverged'):
        run()
    assert events[-1] == 'fatal' and tr.sentinel.rollbacks == 2


def test_a_gradient_whose_square_overflows_trips_the_guard(weights):
    g = torch.tensor([1e20, 1.0])
    assert torch.isfinite(g).all()              # not what the guard asks
    assert not bool(finite_step(torch.tensor(1.0), [g]))
    assert not bool(jsentinel.finite_step(jnp.float32(1.0),
                                          [jnp.asarray(g.numpy())]))
    assert bool(finite_step(torch.tensor(1.0), [torch.tensor([1e18])]))
    assert not bool(finite_step(torch.tensor(float('inf')),
                                [torch.ones(2)]))
    # through both trainers: a loss weight of 1e20 keeps the loss finite
    # and squares the gradients past f32
    ids, w = _chunk(2, poison=(1,), value=1e20)
    jt, pt = _jax(weights), _port(weights)
    for i in range(2):
        want = jt.loss_float(jt.step(ids[i], ids[i], w[i]))
        got = pt.loss_float(pt.step(ids[i], ids[i], w[i]))
        assert np.isfinite(got) and np.isfinite(want)
    assert pt._step_no == jt._step_no == 1
    assert pt.sentinel.total_skipped == jt.sentinel.total_skipped == 1


class _Running(torch.nn.Module):
    """A layer with a float buffer its forward updates in place."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 1)
        self.register_buffer('mean', torch.zeros(3))

    def forward(self, x):
        self.mean.mul_(0.5).add_(0.5 * x.detach().mean(0))
        return self.lin(x)


def test_the_guard_keeps_float_buffers():
    torch.manual_seed(0)
    model = _Running()
    tr = ParallelTrainer(model, AdamW(parameters=model.parameters()),
                         lambda out, w: (out.square().mean() * w),
                         nan_guard=True)
    x = torch.randn(4, 3)
    tr.step(x, torch.tensor(1.0))
    kept = model.mean.clone()
    weights = [p.detach().clone() for p in model.parameters()]
    tr.step(x + 1, torch.tensor(float('nan')))
    assert torch.equal(model.mean, kept)
    assert all(torch.equal(a, p) for a, p in zip(weights,
                                                 model.parameters()))
    tr.step(x + 1, torch.tensor(1.0))
    assert not torch.equal(model.mean, kept)


def test_sentinel_policy_matches_the_reference():
    seq = [1.0, float('nan'), float('inf'), 2.0, float('nan'),
           float('nan'), float('nan'), 3.0]
    port, ref = NanSentinel(patience=2, max_rollbacks=3), \
        jsentinel.NanSentinel(patience=2, max_rollbacks=3)
    for loss in seq:
        assert port.observe(loss=loss) == ref.observe(loss=loss)
    assert port.observe(grad_norm=float('nan')) == ref.observe(
        grad_norm=float('nan'))
    assert port.state_dict() == ref.state_dict()
    fresh = NanSentinel()
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()
    with pytest.raises(ValueError):
        NanSentinel(patience=0)


def test_guard_update_and_cond_carry_select():
    ok, bad = torch.tensor(True), torch.tensor(False)
    new, old = [torch.ones(2), torch.full((1,), 3.0)], [torch.zeros(2),
                                                         torch.zeros(1)]
    for fn in (guard_update, scan_loop.cond_carry):
        assert all(torch.equal(a, b) for a, b in zip(fn(ok, new, old), new))
        assert all(torch.equal(a, b) for a, b in zip(fn(bad, new, old), old))
    nan = [torch.tensor([float('nan')])]
    assert torch.equal(guard_update(bad, nan, [torch.zeros(1)])[0],
                       torch.zeros(1))
    assert scan_loop.chunk_sync(torch.tensor([True, False])).tolist() == [
        True, False]


def test_checkpointing_raises_with_its_queue_item(weights):
    tr = _port(weights)
    for call in (lambda: tr.save_checkpoint('x'),
                 lambda: tr.restore_checkpoint('x')):
        with pytest.raises(NotImplementedError, match='Queue 1 item 9'):
            call()
