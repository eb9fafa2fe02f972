"""The port's Mixture of Experts against the JAX package's, on the CPU.

``SwitchMoE`` (``incubate/moe.py``) is held to the JAX ``SwitchMoE`` on
the same numpy weights (non-zero biases, a gate of unit scale) for top-1
and top-2 routing, a capacity factor of 0.5 that drops tokens, and gelu
and relu experts: in f32 the output and the aux loss within 2e-5 and
the gradients of x and of all five parameters within 1e-4 (one layer,
sums in another order); under bf16 O2 the dispatch tensors equal (the
same routing, token for token and slot for slot) and the output within
2e-2 (both round the experts' products to bf16, at other places).  The
reference's own single-device cases (``tests/test_moe.py``) run as port
cases.  ``gpt_moe_tiny`` (2 layers, one of them MoE) is held to the JAX
model: the loss with its aux term within 1e-5 and every gradient within
1e-4 against ``jax.grad``; 3 f32 AdamW trainer steps within 1e-5 (loss)
and 1e-4 (parameters) against the JAX trainer (unfused head: the JAX
fused-head trainer does not train the tied head, ROADMAP Queue 3), an
element whose first gradient is round-off held to Adam's bound, ``2 *
lr * steps``; under bf16 O2 3 trainer steps' losses within 4e-3, half
of bf16's epsilon; greedy ``generate`` streams equal to the JAX
package's, on the unpadded prompt bucket.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.incubate import SwitchMoE as JaxSwitchMoE
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPTForCausalLM
from paddle_tpu.models.gpt import gpt_moe_tiny as jax_gpt_moe_tiny
from paddle_tpu.nn import initializer as JI
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.incubate import SwitchMoE
from paddle_tpu_torch.models import gpt_1p3b, gpt_moe_tiny
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelTrainer
from paddle_tpu_torch.serving import ServingEngine

jax_moe_mod = importlib.import_module('paddle_tpu.incubate.moe')
moe_mod = importlib.import_module('paddle_tpu_torch.incubate.moe')

TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2
# half of bf16's epsilon: the dense model's bound (2e-3, a quarter)
# plus the experts' bf16 products, rounded where the JAX trainer's
# compiled step keeps excess precision (2.7e-3 seen)
O2_LOSS_RTOL = 4e-3
H, F, E = 16, 32, 4
NAMES = ('gate_w', 'w1', 'b1', 'w2', 'b2')
# (top_k, capacity_factor, activation): 0.5 leaves each expert 3 slots
# (top-1) or 6 (top-2) for 12 tokens, so tokens drop
CASES = [(1, 1.25, 'gelu'), (2, 1.25, 'gelu'), (1, 0.5, 'gelu'),
         (1, 1.25, 'relu'), (2, 0.5, 'relu')]
MODEL_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
                max_seq_len=64, dropout=0.0)
LR = 3e-3


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture(scope='module')
def moe_weights():
    rs = np.random.RandomState(0)
    return {'gate_w': rs.randn(H, E).astype(np.float32),
            'w1': (0.3 * rs.randn(E, H, F)).astype(np.float32),
            'b1': (0.1 * rs.randn(E, 1, F)).astype(np.float32),
            'w2': (0.3 * rs.randn(E, F, H)).astype(np.float32),
            'b2': (0.1 * rs.randn(E, 1, H)).astype(np.float32)}


@pytest.fixture(scope='module')
def xg():
    rs = np.random.RandomState(1)
    return (rs.randn(2, 6, H).astype(np.float32),
            rs.randn(2, 6, H).astype(np.float32))


def _pair(weights, top_k, cf, act):
    jm = JaxSwitchMoE(H, F, E, top_k=top_k, capacity_factor=cf,
                      activation=act)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in weights.items()})
    pm = SwitchMoE(H, F, E, top_k=top_k, capacity_factor=cf, activation=act,
                   device='cpu')
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return jm, pm


class _Recorder:
    """Stands in for ``jnp`` in the JAX moe module: records the dispatch
    tensor of each ``'sec,sh->ech'`` einsum."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops):
        if spec == 'sec,sh->ech':
            self.seen.append(np.asarray(ops[0]).astype(np.float32))
        return jnp.einsum(spec, *ops)


def _dispatches(monkeypatch):
    """(JAX dispatch tensors, port dispatch tensors) recorded from here on."""
    jax_seen, port_seen = [], []
    monkeypatch.setattr(jax_moe_mod, 'jnp', _Recorder(jax_seen))
    real = moe_mod.route

    def route(*args):
        out = real(*args)
        port_seen.append(out[0].detach().float().numpy())
        return out

    monkeypatch.setattr(moe_mod, 'route', route)
    return jax_seen, port_seen


@pytest.mark.parametrize('top_k,cf,act', CASES)
def test_switch_moe_f32_matches_jax(moe_weights, xg, top_k, cf, act,
                                    monkeypatch):
    x, g = xg
    jm, pm = _pair(moe_weights, top_k, cf, act)
    jax_seen, port_seen = _dispatches(monkeypatch)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = jm(jx)
    ((jy * paddle.to_tensor(g)).sum() + jm.aux_loss).backward()
    px = torch.from_numpy(x).requires_grad_()
    py = pm(px)
    assert py.shape == (2, 6, H) and py.dtype == torch.float32
    ((py * torch.from_numpy(g)).sum() + pm.aux_loss).backward()
    _close(py.detach().numpy(), jy.value, TOL, 'y')
    _close(float(pm.aux_loss), float(np.asarray(jm.aux_loss.value)), TOL)
    _close(px.grad.numpy(), jx.grad.value, GRAD_TOL, 'x')
    for name in NAMES:
        _close(getattr(pm, name).grad.numpy(),
               getattr(jm, name).grad.value, GRAD_TOL, name)
    assert len(jax_seen) == len(port_seen) == 1
    np.testing.assert_array_equal(port_seen[0], jax_seen[0])
    C = pm._capacity(12 * top_k)
    assert port_seen[0].shape == (12, E, C)
    if cf < 1:      # some token lost its place
        assert port_seen[0].sum() < 12 * top_k


@pytest.mark.parametrize('top_k,cf,act', CASES)
def test_switch_moe_bf16_o2_routes_as_jax(moe_weights, xg, top_k, cf, act,
                                          monkeypatch):
    x, _ = xg
    jm, pm = _pair(moe_weights, top_k, cf, act)
    jax_seen, port_seen = _dispatches(monkeypatch)
    with jax_no_grad(), paddle.amp.auto_cast(level='O2'):
        jy = jm(paddle.to_tensor(x))
    with torch.no_grad(), amp.auto_cast(level='O2'):
        py = pm(torch.from_numpy(x))
    assert py.dtype == torch.bfloat16 and pm.aux_loss.dtype == torch.float32
    np.testing.assert_array_equal(port_seen[0], jax_seen[0])
    _close(py.float().numpy(), np.asarray(jy.value).astype(np.float32),
           BF16_TOL, 'y')
    _close(float(pm.aux_loss), float(np.asarray(jm.aux_loss.value)), TOL)


def _dense_mlp(moe, xs, e):
    """Expert ``e`` alone on rows ``xs`` (the tanh GELU)."""
    w1, b1, w2, b2 = (getattr(moe, n).detach()[e] for n in NAMES[1:])
    return torch.nn.functional.gelu(xs @ w1 + b1[0],
                                    approximate='tanh') @ w2 + b2[0]


def _moe(seed, *args, **kw):
    return SwitchMoE(*args, device='cpu',
                     generator=torch.Generator().manual_seed(seed), **kw)


def test_single_expert_equals_dense_mlp():
    moe = _moe(0, 8, 16, num_experts=1, capacity_factor=1.0)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 6, 8)
                         .astype(np.float32))
    y = moe(x)
    _close(y.detach().reshape(-1, 8).numpy(),
           _dense_mlp(moe, x.reshape(-1, 8), 0).numpy(), 1e-5)
    assert float(moe.aux_loss) == pytest.approx(1.0, rel=1e-5)


def test_routing_is_the_argmax_of_the_gate(monkeypatch):
    moe = _moe(1, 4, 8, num_experts=3, capacity_factor=4.0)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 5, 4)
                         .astype(np.float32))
    _, seen = _dispatches(monkeypatch)
    y = moe(x)
    assert y.shape == (1, 5, 4) and torch.isfinite(y).all()
    picked = seen[0].sum(-1).argmax(-1)      # every token kept at 4.0
    np.testing.assert_array_equal(
        picked, (x[0] @ moe.gate_w.detach()).argmax(-1).numpy())
    assert float(moe.aux_loss) >= 1.0 - 1e-5     # the balanced floor


def test_capacity_drops_tokens():
    # one slot an expert; identical tokens all pick one expert
    moe = _moe(0, 4, 8, num_experts=2, capacity_factor=0.5)
    y = moe(torch.ones((1, 8, 4))).detach().reshape(8, 4)
    kept = (y.abs() > 1e-7).any(-1)
    assert int(kept.sum()) == moe._capacity(8) == 2


def test_top2_differs_from_top1():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 6, 8)
                         .astype(np.float32))
    y1 = _moe(0, 8, 16, num_experts=4, top_k=1, capacity_factor=2.0)(x)
    y2 = _moe(0, 8, 16, num_experts=4, top_k=2, capacity_factor=2.0)(x)
    assert y1.shape == y2.shape
    assert not torch.allclose(y1, y2)


def test_second_choices_queue_behind_first_choices():
    """token 0 prefers expert 0 then 1, token 1 expert 1 then 0: expert
    1 takes token 1 first and token 0 second, each in a slot of its own,
    so each token's output is the gate-weighted sum of its two experts
    run alone."""
    moe = _moe(0, 4, 8, num_experts=2, top_k=2, capacity_factor=4.0)
    gate = torch.zeros((4, 2))
    gate[0, 0] = gate[1, 1] = 5.0
    with torch.no_grad():
        moe.gate_w.copy_(gate)
    x = torch.zeros((1, 2, 4))
    x[0, 0, 0] = x[0, 1, 1] = 1.0
    y = moe(x).detach()[0]
    for t in range(2):
        p = torch.softmax(x[0, t] @ gate, -1)
        want = sum(p[e] * _dense_mlp(moe, x[0, t:t + 1], e)[0]
                   for e in range(2))
        _close(y[t].numpy(), want.numpy(), 1e-5)


def test_grads_reach_the_experts_and_the_gate():
    moe = _moe(0, 8, 16, num_experts=2, capacity_factor=2.0)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 4, 8)
                         .astype(np.float32)).requires_grad_()
    (moe(x).sum() + moe.aux_loss).backward()
    for p in (moe.w1, moe.w2, moe.gate_w):
        assert p.grad is not None and torch.isfinite(p.grad).all()
    assert float(moe.gate_w.grad.abs().sum()) > 0
    assert x.grad is not None


def test_default_init_laws_are_the_references():
    """XavierUniform on gate_w and KaimingUniform on w1/w2 with the
    reference's fans (a 3-D ``[E, H, F]`` counts ``H*F`` in and ``E*F``
    out), zero biases; the port's draws fill their ranges as the JAX
    package's do."""
    for shape in ([32, 8], [8, 32, 64], [8, 64, 32], [6, 3, 5, 5]):
        assert I._fans(shape) == JI._fans(shape)
    moe = _moe(0, 32, 64, num_experts=8)
    paddle.seed(0)
    jm = JaxSwitchMoE(32, 64, 8)
    xavier = np.sqrt(6.0 / (32 + 8))
    kaiming = {'w1': np.sqrt(2.0) * np.sqrt(3.0 / (32 * 64)),
               'w2': np.sqrt(2.0) * np.sqrt(3.0 / (64 * 32))}
    for name, limit in (('gate_w', xavier), *kaiming.items()):
        got = getattr(moe, name).detach().numpy()
        want = np.asarray(getattr(jm, name).value)
        for arr in (got, want):
            assert np.abs(arr).max() <= limit
            # a uniform draw's std is limit / sqrt(3)
            assert np.std(arr) == pytest.approx(limit / np.sqrt(3), rel=0.1)
    for name in ('b1', 'b2'):
        assert not getattr(moe, name).detach().any()
        assert not np.asarray(getattr(jm, name).value).any()
    u = I.XavierUniform(gain=2.0)([4, 5],
                                  generator=torch.Generator().manual_seed(0))
    assert float(u.abs().max()) <= 2.0 * np.sqrt(6.0 / 9)
    # reset_parameters redraws from the generator, in the same order
    again = _moe(0, 32, 64, num_experts=8)
    moe.reset_parameters(torch.Generator().manual_seed(0))
    for name in NAMES:
        assert torch.equal(getattr(moe, name), getattr(again, name))


# -- gpt_moe_tiny -------------------------------------------------------------

@pytest.fixture(scope='module')
def weights():
    paddle.seed(7)
    params, _ = jax_gpt_moe_tiny(**MODEL_KW).functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name or name.endswith(
                ('.b1', '.b2')):
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    return host


@pytest.fixture(scope='module')
def ids():
    return np.random.RandomState(0).randint(0, 128, (2, 32)).astype(
        np.int64)


def _jax_model(host, **kw):
    jm = jax_gpt_moe_tiny(**MODEL_KW, **kw)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    return jm


def _port_model(host, **kw):
    return gpt_moe_tiny(device='cpu', **MODEL_KW, **kw).load_numpy_state(
        host)


def test_moe_blocks_keys_and_config_match_jax(weights):
    pm = _port_model(weights)
    assert set(pm.state_dict()) == set(weights)
    assert [type(b.mlp).__name__ for b in pm.gpt.blocks] == \
        ['GPTMLP', 'SwitchMoE']
    moe = pm.gpt.blocks[1].mlp
    assert (moe.num_experts, moe.top_k, moe.capacity_factor) == (4, 1, 1.25)
    jcfg, cfg = JaxGPTConfig(), GPTConfig()
    for field in ('moe_num_experts', 'moe_every', 'moe_top_k',
                  'moe_capacity_factor', 'moe_aux_weight',
                  'sequence_parallel', 'striped_sp', 'scan_decode_blocks'):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    for field in ('sequence_parallel', 'striped_sp'):
        with pytest.raises(NotImplementedError, match='item 9'):
            GPTConfig(**{field: True})
    assert GPTConfig(scan_decode_blocks=True).scan_decode_blocks


def test_presets_match_the_references(monkeypatch):
    """``gpt_moe_tiny`` and ``gpt_1p3b`` build the reference's configs
    (the 1.3B model's config is caught before any weight is drawn)."""
    import paddle_tpu.models.gpt as jax_gpt
    import paddle_tpu_torch.models.gpt as port_gpt
    made = {}
    monkeypatch.setattr(jax_gpt, 'GPTForCausalLM',
                        lambda cfg: made.setdefault('jax', vars(cfg)))
    monkeypatch.setattr(port_gpt, 'GPTForCausalLM',
                        lambda cfg, device=None, seed=0:
                        made.setdefault('port', vars(cfg)))
    for jax_fn, fn in ((jax_gpt.gpt_1p3b, gpt_1p3b),
                       (jax_gpt.gpt_moe_tiny, gpt_moe_tiny)):
        made.clear()
        jax_fn()
        fn()
        assert made['port'] == made['jax']


def test_moe_loss_and_every_gradient_match_jax(weights, ids):
    jm = _jax_model(weights)
    params, buffers = jm.functional_state()

    def loss_of(p):
        saved = jm.functional_state()
        jm.load_functional_state(p, buffers)
        jm.train()
        try:
            with jax_no_grad():
                tid = JaxTensor._from_value(jnp.asarray(ids))
                return jm.loss(jm(tid), tid).value
        finally:
            jm.load_functional_state(*saved)

    want_loss, want_grads = jax.value_and_grad(loss_of)(params)
    pm = _port_model(weights).train()
    logits = pm(torch.from_numpy(ids))
    plain = pm._lm_loss(logits, torch.from_numpy(ids))
    loss = pm.loss(logits, torch.from_numpy(ids))
    aux = pm.gpt.blocks[1].mlp.aux_loss
    _close(float(loss.detach()), float(want_loss), TOL)
    _close(float(loss.detach()), float((plain + 0.01 * aux).detach()), 1e-6)
    # explicit aux_losses: the same value as the blocks' attributes
    _close(float(pm.loss(logits, torch.from_numpy(ids),
                         aux_losses=[aux]).detach()), float(loss.detach()),
           0.0)
    loss.backward()
    got = dict(pm.named_parameters())
    assert set(got) == set(want_grads)
    for name, g in want_grads.items():
        _close(got[name].grad.numpy(), np.asarray(g), GRAD_TOL, name)


def test_gpt_loss_accepts_explicit_aux_as_the_reference():
    cfg = dict(vocab_size=32, hidden_size=8, num_layers=2, num_heads=2,
               intermediate_size=16, max_seq_len=16, moe_num_experts=2,
               moe_every=1)
    pm = GPTForCausalLM(GPTConfig(**cfg), device='cpu', seed=1)
    jm = JaxGPTForCausalLM(JaxGPTConfig(**cfg))
    assert [type(b.mlp).__name__ for b in pm.gpt.blocks] == \
        [type(b.mlp).__name__ for b in jm.gpt.blocks] == ['SwitchMoE'] * 2
    ids = torch.ones((1, 8), dtype=torch.int64)
    logits = pm(ids)
    aux = [blk.mlp.aux_loss for blk in pm.gpt.blocks]
    out = pm.loss(logits, ids, aux_losses=aux)
    assert torch.isfinite(out)
    want = pm._lm_loss(logits, ids) + 0.01 * (aux[0] + aux[1]) / 2
    _close(float(out.detach()), float(want.detach()), 1e-6)


def _trainer(model, cls, opt_cls):
    opt = opt_cls(learning_rate=LR, parameters=model.parameters())
    return cls(model, opt, lambda out, y: model.loss(out, y))


def test_three_moe_trainer_steps_match_the_jax_trainer(weights, ids):
    jt = _trainer(_jax_model(weights), JaxTrainer, JaxAdamW)
    pt = _trainer(_port_model(weights), ParallelTrainer, AdamW)
    for step in range(3):
        want = jt.loss_float(jt.step(ids, ids))
        _close(pt.loss_float(pt.step(ids, ids)), want, TOL)
        if step == 0:
            first = {n: p.grad.abs() for n, p in pt.model.named_parameters()}
    got = {n: p.detach().numpy() for n, p in pt.model.named_parameters()}
    for name, value in jt.params.items():
        # an element whose first gradient is round-off (the key bias's
        # true gradient is 0, and a few others come within 1e-7 of their
        # tensor's largest) takes Adam steps of up to lr of either sign
        # in each package: it is held to its bound, 2 * lr * steps
        g = first[name]
        noise = (g <= 1e-6 * g.max()).numpy()
        value = np.asarray(value)
        _close(got[name][noise], value[noise], 2 * LR * 3, name)
        _close(got[name][~noise], value[~noise], GRAD_TOL, name)
    # step_fused reads each step's aux loss inside the step: on the CPU
    # it is K eager steps, equal to K more calls of step
    fused = ParallelTrainer(pt.model, pt.optimizer,
                            lambda out, y: pt.model.loss(out, y),
                            fused_steps=2)
    fused._step_no = pt._step_no
    losses = fused.step_fused(np.stack([ids] * 2), np.stack([ids] * 2))
    want = [jt.loss_float(jt.step(ids, ids)) for _ in range(2)]
    _close(losses.numpy(), want, TOL)


def test_o2_moe_trainer_steps_match_the_jax_trainer_in_bf16(weights, ids):
    """bf16 O2: the losses of 3 steps within O2_LOSS_RTOL; the aux term
    joins the loss in f32, as in the JAX trainer's compiled step."""
    strategies = []
    for cls in (JaxStrategy, DistributedStrategy):
        st = cls()
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
        strategies.append(st)
    jm, pm = _jax_model(weights), _port_model(weights)
    jt = JaxTrainer(jm, JaxAdamW(learning_rate=LR,
                                 parameters=jm.parameters()),
                    lambda out, y: jm.loss(out, y), strategy=strategies[0])
    pt = ParallelTrainer(pm, AdamW(learning_rate=LR,
                                   parameters=pm.parameters()),
                         lambda out, y: pm.loss(out, y),
                         strategy=strategies[1])
    for _ in range(3):
        want = jt.loss_float(jt.step(ids, ids))
        got = pt.loss_float(pt.step(ids, ids))
        np.testing.assert_allclose(got, want, rtol=O2_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_moe_generate_streams_match_jax_on_the_unpadded_bucket(weights):
    jm = _jax_model(weights)
    jm.eval()
    pm = _port_model(weights)
    prompt = np.random.RandomState(3).randint(0, 128, (2, 5)).astype(
        np.int64)
    assert pm._decode_bucket(5, 6) == jm._decode_bucket(5, 6) == 5
    want = jm.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                       temperature=0)
    got = pm.generate(prompt, max_new_tokens=6, temperature=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))
    assert set(pm._gen_cache.modules) == {(2, 5, 6, True, 0.0, None)}


def test_serving_engine_refuses_a_moe_model(weights):
    with pytest.raises(ValueError, match='non-MoE'):
        ServingEngine(_port_model(weights))
