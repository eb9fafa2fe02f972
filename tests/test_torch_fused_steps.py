"""The port's fused K-step loop (``ParallelTrainer.step_fused``,
``core.scan_loop``), its optimizer in place and the launch tally of a
captured graph, on the CPU.

A CUDA graph cannot run here: on the CPU ``step_fused`` runs the same
step body eagerly (``compile_cache.GraphCache`` hands out the function
itself), which is the code the card captures.  So these tests hold
that body and the loop around it:

- ``step_fused`` over K = 1, 3 and 4 equals K calls of ``step`` bit for
  bit: losses, every parameter, every Adam moment and both step
  counters (GPT, and BERT at dropout 0.1, whose draws come from the
  device's generator in the same order);
- the port's ``step_fused`` matches the JAX
  ``ParallelTrainer(fused_steps=K).step_fused`` on the same numpy
  weights, with the unfused head (the JAX trainer does not train a
  fused head, ROADMAP Queue 3) and the trajectory tolerances of
  ``tests/test_torch_gpt_training.py``: losses 1e-5, parameters 1e-4,
  the key bias within ``2 * lr * steps``;
- the optimizer updates its moments in place (their ``data_ptr`` never
  changes), so a captured step goes on reading them;
- the ``scan_loop`` helpers behave as the reference's tests pin them
  (``tests/test_fused_loop.py::TestResolve``, ``test_stack_batches``);
- the launch tally takes a capture's launches out of the counts and
  adds them back once per replay (a stub kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import scan_loop as jax_scan_loop
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
import paddle_tpu_torch
from paddle_tpu_torch.core import compile_cache, scan_loop
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models.bert import bert_tiny
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import ParallelTrainer

TOL = 1e-5
PARAM_TOL = 1e-4
MODEL_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
                max_seq_len=64, dropout=0.0)
LR = 3e-3


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
    """K different batches [2, 32] stacked: [K, 2, 32]."""
    return np.random.RandomState(seed).randint(0, 128, (k, 2, 32)).astype(
        np.int64)


def _strategy(cls, o2):
    st = cls()
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    return st


def _port_trainer(host, fused_head=True, o2=False, fused_steps=None,
                  opt_cls=AdamW):
    pm = gpt_tiny(device='cpu', **dict(MODEL_KW, fused_head=fused_head)) \
        .load_numpy_state(host)
    opt = opt_cls(learning_rate=LR, parameters=pm.parameters())
    return ParallelTrainer(pm, opt, lambda out, y: pm.loss(out, y),
                           strategy=_strategy(DistributedStrategy, o2),
                           fused_steps=fused_steps)


def _state(trainer):
    """Every parameter and moment (copies) and both step counters."""
    params = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    moments = {k: v.detach().clone()
               for k, v in trainer.optimizer.state_dict().items()
               if k != 'global_step'}
    return params, moments, (trainer._step_no,
                             trainer.optimizer._global_step)


def _assert_same_state(a, b):
    (pa, ma, sa), (pb, mb, sb) = _state(a), _state(b)
    assert sa == sb
    assert set(pa) == set(pb) and set(ma) == set(mb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    for n in ma:
        assert torch.equal(ma[n], mb[n]), n


@pytest.mark.parametrize('o2', [False, True], ids=['f32', 'bf16_o2'])
@pytest.mark.parametrize('k', [1, 3, 4])
def test_step_fused_equals_k_steps_bit_for_bit(weights, k, o2):
    ids = _ids(k)
    eager = _port_trainer(weights, o2=o2)
    fused = _port_trainer(weights, o2=o2, fused_steps=k)
    assert fused.fused_chunk_len() == k
    want = torch.stack([eager.step(ids[i], ids[i]) for i in range(k)])
    got = fused.step_fused(ids, ids)
    assert got.shape == (k,) and got.dtype == torch.float32
    assert torch.equal(got, want)
    _assert_same_state(fused, eager)
    assert fused._step_no == k
    # a second chunk carries on from the first
    ids2 = _ids(k, seed=1)
    want2 = torch.stack([eager.step(ids2[i], ids2[i]) for i in range(k)])
    assert torch.equal(fused.step_fused(ids2, ids2), want2)
    _assert_same_state(fused, eager)


def test_step_fused_and_step_interleave(weights):
    """Eager steps between fused chunks keep one trajectory."""
    ids = _ids(5)
    eager = _port_trainer(weights)
    mixed = _port_trainer(weights, fused_steps=2)
    want = [eager.step(ids[i], ids[i]) for i in range(5)]
    got = list(mixed.step_fused(ids[:2], ids[:2]))
    got.append(mixed.step(ids[2], ids[2]))
    got += list(mixed.step_fused(ids[3:], ids[3:]))
    assert torch.equal(torch.stack(got), torch.stack(want))
    _assert_same_state(mixed, eager)


def test_step_fused_with_dropout_draws_as_k_steps(weights):
    """BERT at dropout 0.1: the fused loop draws from the device's
    generator exactly as K eager steps do."""
    rs = np.random.RandomState(2)
    k = 3
    ids = rs.randint(0, 256, (k, 2, 16)).astype(np.int64)
    lbl = np.where(rs.rand(k, 2, 16) < 0.3, ids, -100).astype(np.int64)

    def trainer():
        model = bert_tiny(device='cpu', seed=0, vocab_size=256,
                          hidden_size=64, num_layers=2, dropout=0.1)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        return ParallelTrainer(model, opt,
                               lambda out, y: model.loss(out, y),
                               fused_steps=k)

    eager, fused = trainer(), trainer()
    paddle_tpu_torch.seed(5)
    want = torch.stack([eager.step(ids[i], lbl[i]) for i in range(k)])
    paddle_tpu_torch.seed(5)
    got = fused.step_fused(ids, lbl)
    assert torch.equal(got, want)
    _assert_same_state(fused, eager)
    # the draws were live: another seed gives other losses
    paddle_tpu_torch.seed(6)
    other = trainer().step_fused(ids, lbl)
    assert not torch.equal(other, want)


@pytest.mark.parametrize('k', [1, 3])
def test_step_fused_matches_the_jax_step_fused(weights, k):
    ids = _ids(k)
    jm = jax_gpt_tiny(**dict(MODEL_KW, fused_head=False))
    jm.load_functional_state({n: jnp.asarray(v) for n, v in weights.items()})
    jopt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    jt = JaxTrainer(jm, jopt, lambda out, y: jm.loss(out, y),
                    strategy=_strategy(JaxStrategy, False), fused_steps=k)
    pt = _port_trainer(weights, fused_head=False, fused_steps=k)
    assert pt.fused_chunk_len() == jt.fused_chunk_len() == k
    for chunk in range(2):
        want = np.asarray(jt.step_fused(jnp.asarray(ids), jnp.asarray(ids)))
        got = pt.step_fused(ids, ids)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        ids = _ids(k, seed=chunk + 1)
    assert pt._step_no == jt._step_no == 2 * k
    h = MODEL_KW['hidden_size']
    got = {n: p.detach().numpy() for n, p in pt.model.named_parameters()}
    assert set(got) == set(jt.params)
    for name, value in jt.params.items():
        value, mine = np.asarray(value), got[name]
        if name.endswith('attn.qkv.bias'):
            # the key bias's true gradient is 0: round-off under Adam
            key = slice(h, 2 * h)
            np.testing.assert_allclose(mine[key], value[key],
                                       atol=2 * LR * 2 * k, err_msg=name)
            mine, value = (np.delete(mine, np.s_[key]),
                           np.delete(value, np.s_[key]))
        np.testing.assert_allclose(mine, value, rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize('opt_cls', [Adam, AdamW])
def test_optimizer_updates_its_moments_in_place(weights, opt_cls):
    tr = _port_trainer(weights, fused_steps=2, opt_cls=opt_cls)
    ids = _ids(2)
    tr.step(ids[0], ids[0])
    slots = {k: v for k, v in tr.optimizer.state_dict().items()
             if k != 'global_step'}
    ptrs = {k: v.data_ptr() for k, v in slots.items()}
    before = {k: v.clone() for k, v in slots.items()}
    buf = tr.optimizer._scalar_buf.data_ptr()
    tr.step(ids[1], ids[1])
    tr.step_fused(ids, ids)
    after = {k: v for k, v in tr.optimizer.state_dict().items()
             if k != 'global_step'}
    assert {k: v.data_ptr() for k, v in after.items()} == ptrs
    assert any(not torch.equal(before[k], after[k]) for k in after)
    assert tr.optimizer._scalar_buf.data_ptr() == buf


def test_step_scalars_are_the_f32_values_of_the_reference():
    """lr, AdamW's decay factor and the f32 bias corrections of step t,
    as the reference's rule computes them."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = AdamW(learning_rate=0.01, parameters=[p], weight_decay=0.05,
                beta1=0.8, beta2=0.99)
    rows = opt._scalar_rows(3, 2)
    assert rows.dtype == torch.float32 and rows.shape == (2, 4)
    for row, t in zip(rows.numpy(), (3, 4)):
        want = {'lr': np.float32(0.01),
                'c1': np.float32(1) - np.float32(0.8) ** np.float32(t),
                'c2': np.float32(1) - np.float32(0.99) ** np.float32(t),
                'decay': np.float32(1 - 0.01 * 0.05)}
        assert dict(zip(opt._step_scalars(t), row)) == want


def test_step_fused_rejects_ragged_chunks(weights):
    tr = _port_trainer(weights, fused_steps=2)
    with pytest.raises(ValueError, match='leading K'):
        tr.step_fused(_ids(2), _ids(3))
    with pytest.raises(ValueError, match='leading K'):
        tr.step_fused(_ids(0), _ids(0))


def test_the_cpu_cache_hands_out_the_step_itself(weights):
    tr = _port_trainer(weights, fused_steps=2)
    tr.step_fused(_ids(2), _ids(2))
    (mod,) = tr._fused_cache.modules.values()
    assert mod == tr._step
    calls = []
    cache = compile_cache.GraphCache('cpu', shared_pool=True)
    fn = cache.module('a', lambda x: calls.append(x) or x,
                      warmup_inputs=(1,))
    assert calls == [1] and cache.module('a', None) is fn
    assert list(cache.modules) == ['a'] and cache.pool is None


# -- scan_loop helpers, as tests/test_fused_loop.py pins the reference's --

class _Budget:
    def __init__(self, step_s=None):
        self.step_s = step_s


class TestResolve:
    def test_explicit_wins(self):
        assert scan_loop.resolve_fused_steps(8) == 8
        assert scan_loop.resolve_fused_steps(0) == 0
        assert scan_loop.resolve_fused_steps(False) == 0
        assert scan_loop.resolve_fused_steps('16') == 16

    def test_env_default(self, monkeypatch):
        assert scan_loop.ENV_VAR == jax_scan_loop.ENV_VAR
        monkeypatch.setenv(scan_loop.ENV_VAR, '32')
        assert scan_loop.resolve_fused_steps(None) == 32
        monkeypatch.setenv(scan_loop.ENV_VAR, 'off')
        assert scan_loop.resolve_fused_steps(None) == 0
        monkeypatch.delenv(scan_loop.ENV_VAR)
        assert scan_loop.resolve_fused_steps(None) == 0
        monkeypatch.setenv(scan_loop.ENV_VAR, '32')
        assert scan_loop.resolve_fused_steps(4) == 4
        assert scan_loop.resolve_fused_steps(False) == 0

    def test_env_reaches_the_trainer(self, monkeypatch, weights):
        monkeypatch.setenv(scan_loop.ENV_VAR, '3')
        assert _port_trainer(weights).fused_chunk_len() == 3

    def test_negative_rejected(self):
        with pytest.raises(ValueError):
            scan_loop.resolve_fused_steps(-1)

    @pytest.mark.parametrize('arg,want', [
        (0, 0), (1, 1), (2, 2), (8, 8), (32, 32), (1024, 1024),
        ('0', 0), ('1', 1), ('8', 8), ('  32 ', 32),
        ('off', 0), ('OFF', 0), ('false', 0), ('none', 0),
        ('no', 0), ('', 0), (True, 1), (False, 0),
    ])
    def test_parse_table(self, arg, want):
        assert scan_loop.resolve_fused_steps(arg) == want
        assert jax_scan_loop.resolve_fused_steps(arg) == want

    @pytest.mark.parametrize('env,want', [
        ('0', 0), ('8', 8), ('off', 0), ('false', 0), ('32', 32),
    ])
    def test_env_table(self, monkeypatch, env, want):
        monkeypatch.setenv(scan_loop.ENV_VAR, env)
        assert scan_loop.resolve_fused_steps(None) == want

    @pytest.mark.parametrize('k,step_s,est,want', [
        (32, 1.0, 0.3, 3), (32, 1.0, 1.0, 1), (32, 1.0, None, 32),
        (32, 10.0, 0.3, 32), (32, 0.1, 5.0, 1), (8, 4.0, 0.5, 8),
        (8, 2.0, 0.5, 4), (1, 1.0, 0.3, 1), (16, 1.6, 0.2, 8),
        (0, 1.0, 0.3, 1),
    ])
    def test_clamp_table(self, k, step_s, est, want):
        assert scan_loop.clamp_chunk(
            k, _Budget(step_s=step_s), est_step_s=est) == want
        assert jax_scan_loop.clamp_chunk(
            k, _Budget(step_s=step_s), est_step_s=est) == want

    def test_clamp_chunk(self):
        assert scan_loop.clamp_chunk(32) == 32
        assert scan_loop.clamp_chunk(32, _Budget(step_s=1.0)) == 32
        assert scan_loop.clamp_chunk(
            32, _Budget(step_s=1.0), est_step_s=0.3) == 3
        assert scan_loop.clamp_chunk(
            32, _Budget(step_s=0.1), est_step_s=5.0) == 1
        assert scan_loop.clamp_chunk(32, _Budget(), est_step_s=0.3) == 32

    def test_stack_batches(self):
        b1 = (np.ones((4, 3)), np.zeros((4, 1)))
        b2 = (np.full((4, 3), 2.0), np.ones((4, 1)))
        xs, ys = scan_loop.stack_batches([b1, b2])
        assert xs.shape == (2, 4, 3) and ys.shape == (2, 4, 1)
        assert float(xs[1, 0, 0]) == 2.0
        assert torch.is_tensor(xs) and xs.dtype == torch.float64
        with pytest.raises(ValueError):
            scan_loop.stack_batches([])

    def test_stack_batches_keeps_tensors_where_they_are(self):
        b1 = (torch.ones(4, 3, dtype=torch.float64),)
        b2 = (torch.full((4, 3), 2.0, dtype=torch.float64),)
        (xs,) = scan_loop.stack_batches([b1, b2])
        assert xs.shape == (2, 4, 3) and xs.dtype == torch.float64
        assert torch.equal(xs[1], b2[0])

    def test_stacked_chunk_feeds_step_fused(self, weights):
        ids = _ids(3)
        tr = _port_trainer(weights, fused_steps=3)
        chunk = scan_loop.stack_batches([(ids[i], ids[i]) for i in range(3)])
        eager = _port_trainer(weights)
        want = torch.stack([eager.step(ids[i], ids[i]) for i in range(3)])
        assert torch.equal(tr.step_fused(*chunk), want)


# -- the launch tally of a capture ------------------------------------------

@pytest.fixture
def stub_kernel():
    """A registered kernel whose entry point is a Python stub."""
    k = _build.Kernel('stub_kernel', 'fused_norm', 'stub', [],
                      'tests:stub', variants=('a', 'b'))
    k._fn = lambda *args: 0
    try:
        yield k
    finally:
        _build.KERNELS.remove(k)


def test_a_capture_adds_its_launches_once_per_replay(stub_kernel):
    k = stub_kernel
    k.launch(variant='a')
    with _build.capture_launches() as tally:
        k.launch(variant='a')
        k.launch(variant='b')
        k.launch(variant='a')
    # the capture ran nothing: the counts are as before it
    assert k.launches == 1 and k.variant_launches == {'a': 1, 'b': 0}
    assert tally.counts() == {'stub_kernel': 3}
    tally.replayed()
    tally.replayed(2)
    assert k.launches == 1 + 3 * 3
    assert k.variant_launches == {'a': 1 + 2 * 3, 'b': 3}
    _build.reset_launches()
    assert k.launches == 0 and k.variant_launches == {'a': 0, 'b': 0}


def test_a_failed_capture_leaves_the_counts(stub_kernel):
    k = stub_kernel
    with pytest.raises(RuntimeError, match='capture failed'):
        with _build.capture_launches() as tally:
            k.launch(variant='b')
            raise RuntimeError('capture failed')
    assert k.launches == 0 and k.variant_launches == {'a': 0, 'b': 0}
    assert tally.counts() == {'stub_kernel': 1}
