"""The port's GPT training path against the JAX package's, on the CPU.

One ``gpt_tiny`` (2 layers, H 64, 4 heads, vocab 128, dropout 0) is
built in the JAX package, its LayerNorm and bias parameters are
perturbed with seeded numpy noise, and the same numpy weights are
loaded into both packages (``convert.load_numpy_state``).  The JAX
model on the CPU takes its einsum attention (flash needs the TPU);
the port's uncached attention runs the flash kernels' plain twins on
CPU tensors.  Both compute the same math.

The JAX ``ParallelTrainer`` with ``fused_head`` does not train the tied
head: its loss closure reads the live ``wte`` Parameter, not the traced
parameters, so the head's gradient never reaches ``wte`` (ROADMAP Queue
3).  The gradient oracle here therefore runs the JAX model's forward
and loss with the parameters swapped in together, and the trainer
comparisons run the unfused head, whose JAX step is right; the port's
fused-head trainer is held to its unfused one.

Tolerances: logits and losses 1e-5 (f32 through 2 layers, sums in
another order); gradients and parameters after AdamW steps 1e-4; the
fused CE head 1e-5 on losses and 1e-4 on dx/dw; under bf16 O2 the
losses of 3 trainer steps agree within 2e-3 relative, a quarter of
bf16's epsilon (bf16 rounds at other places in the two frameworks:
matmul epilogues, GELU).  One slice
is exempt from the 1e-4 parameter check after AdamW steps: the key bias
(``qkv.bias[H:2H]``).  Its true gradient is exactly 0 (softmax does not
see a shift shared by a row's scores), so each framework's gradient is
round-off of ~1e-9, which Adam's ``m / sqrt(v)`` scales up to steps of
up to ``lr`` with arbitrary sign; that slice is held to its bound,
``2 * lr * steps``, instead.
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
from paddle_tpu.jit import functional_call
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch import amp, convert
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW
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

pfs = importlib.import_module('paddle_tpu_torch.ops.fused_softmax')

TOL = 1e-5
GRAD_TOL = 1e-4
O2_LOSS_RTOL = 2e-3
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


@pytest.fixture(scope='module')
def ids():
    return np.random.RandomState(0).randint(0, 128, (2, 32)).astype(
        np.int64)


def _jax_model(host, **kw):
    jm = jax_gpt_tiny(**MODEL_KW, **kw)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    return jm


def _port_model(host, **kw):
    return gpt_tiny(device='cpu', **MODEL_KW, **kw).load_numpy_state(host)


def _strategy(cls, o2):
    st = cls()
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    return st


def _jax_trainer(host, fused_head=True, o2=False):
    jm = _jax_model(host, fused_head=fused_head)
    opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    return JaxTrainer(jm, opt, lambda out, y: jm.loss(out, y),
                      strategy=_strategy(JaxStrategy, o2))


def _port_trainer(host, fused_head=True, o2=False):
    pm = _port_model(host, fused_head=fused_head)
    opt = AdamW(learning_rate=LR, parameters=pm.parameters())
    return ParallelTrainer(pm, opt, lambda out, y: pm.loss(out, y),
                           strategy=_strategy(DistributedStrategy, o2))


def _jax_loss_and_grads(jm, ids):
    """jax.value_and_grad of the JAX model's training forward + loss,
    with every parameter (the tied head's too) traced."""
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

    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _params_close(model, want, steps):
    """Every parameter of ``model`` against ``want`` (numpy) within
    GRAD_TOL, the key bias within its Adam bound (module docstring)."""
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    h = MODEL_KW['hidden_size']
    for name, value in want.items():
        value = np.asarray(value)
        if name.endswith('attn.qkv.bias'):
            key = slice(h, 2 * h)
            _close(got[name][key], value[key], 2 * LR * steps, name)
            got[name], value = np.delete(got[name], np.s_[key]), \
                np.delete(value, np.s_[key])
        _close(got[name], value, GRAD_TOL, name)


def test_uncached_logits_match_jax_in_train_mode(weights, ids):
    jm = _jax_model(weights)
    params, buffers = jm.functional_state()
    want, _ = functional_call(jm, params, buffers, (jnp.asarray(ids),),
                              training=True)
    pm = _port_model(weights).train()
    got = pm(torch.from_numpy(ids))
    assert got.shape == (2, 32, 128)
    _close(got.detach().numpy(), want, TOL)


@pytest.mark.parametrize('fused_head', [True, False])
def test_loss_and_every_gradient_match_jax(weights, ids, fused_head):
    want_loss, want_grads = _jax_loss_and_grads(
        _jax_model(weights, fused_head=fused_head), ids)
    pm = _port_model(weights, fused_head=fused_head).train()
    out = pm(torch.from_numpy(ids))
    assert out.shape[-1] == (64 if fused_head else 128)
    loss = pm.loss(out, torch.from_numpy(ids))
    _close(float(loss.detach()), want_loss, TOL)
    loss.backward()
    got = dict(pm.named_parameters())
    assert set(got) == set(want_grads)
    for name, g in want_grads.items():
        _close(got[name].grad.numpy(), g, GRAD_TOL, name)


def test_dropout_branch_matches_jax_grad(weights, ids, monkeypatch):
    """At dropout 1e-9 both packages take the non-flash attention
    (dropout counts as active when p > 0) and, since ``1 - p`` rounds to
    1 in f32, keep every element at scale 1: the port's softmax branch
    (scores, causal -1e9 mask, ``fused_softmax``, dropout) against
    ``jax.grad`` of the reference's."""
    kw = dict(MODEL_KW, dropout=1e-9)
    jm = jax_gpt_tiny(**kw)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in weights.items()})
    want_loss, want_grads = _jax_loss_and_grads(jm, ids)
    calls = []
    real = pfs._fwd
    monkeypatch.setattr(pfs, '_fwd', lambda x, m: calls.append(x.shape)
                        or real(x, m))
    pm = gpt_tiny(device='cpu', **kw).load_numpy_state(weights).train()
    loss = pm.loss(pm(torch.from_numpy(ids)), torch.from_numpy(ids))
    _close(float(loss.detach()), want_loss, TOL)
    loss.backward()
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), want_grads[name], GRAD_TOL, name)
    assert calls == [(2, 4, 32, 32)] * MODEL_KW['num_layers']


@pytest.mark.parametrize('n,h,v,chunks', [(20, 16, 50, 8), (33, 24, 50, 3),
                                          (8, 16, 64, 1)])
def test_fused_linear_cross_entropy_matches_jax(n, h, v, chunks):
    rs = np.random.RandomState(n)
    x = rs.randn(n, h).astype(np.float32)
    w = (0.3 * rs.randn(h, v)).astype(np.float32)
    labels = rs.randint(0, v, (n,)).astype(np.int32)
    g = rs.randn(n).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jax_fused_ce(a, b, jnp.asarray(labels),
                                                  chunks),
                        jnp.asarray(x), jnp.asarray(w))
    wdx, wdw = vjp(jnp.asarray(g))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                     num_chunks=chunks)
    assert got.dtype == torch.float32 and got.shape == (n,)
    _close(got.detach().numpy(), want, TOL)
    # and the unfused CE on materialised logits
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    plain = torch.logsumexp(logits, -1) - logits.gather(
        1, torch.from_numpy(labels).long()[:, None])[:, 0]
    _close(got.detach().numpy(), plain.numpy(), TOL)
    got.backward(torch.from_numpy(g))
    _close(tx.grad.numpy(), wdx, GRAD_TOL)
    _close(tw.grad.numpy(), wdw, GRAD_TOL)


def test_fused_linear_cross_entropy_in_bf16_keeps_the_input_dtypes():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(12, 16).astype(np.float32))
    w = torch.from_numpy((0.3 * rs.randn(16, 40)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 40, (12,)))
    xb, wb = (t.to(torch.bfloat16).requires_grad_() for t in (x, w))
    got = fused_linear_cross_entropy(xb, wb, labels, num_chunks=8)
    ref = fused_linear_cross_entropy(xb.detach().float(),
                                     wb.detach().float(), labels, 8)
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), ref.numpy(), TOL)   # f32 accumulation
    got.sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.bfloat16


def test_cross_entropy_matches_jax_with_ignored_labels():
    rs = np.random.RandomState(2)
    logits = rs.randn(10, 7).astype(np.float32)
    labels = rs.randint(0, 7, (10,))
    labels[[2, 5]] = -100
    want = JF.cross_entropy(paddle.to_tensor(logits),
                            paddle.to_tensor(labels))
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(float(got), float(np.asarray(want.value)), TOL)


def test_adamw_single_step_closed_form():
    rs = np.random.RandomState(3)
    p0 = rs.randn(5, 3).astype(np.float32)
    g = rs.randn(5, 3).astype(np.float32)
    lr, wd, b1, b2, eps = 0.1, 0.01, 0.9, 0.999, 1e-8
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = AdamW(learning_rate=lr, parameters=[p], weight_decay=wd)
    p.grad = torch.from_numpy(g)
    opt.step()
    p1 = p0 * (1 - lr * wd)
    m, v = (1 - b1) * g, (1 - b2) * g * g
    want = p1 - lr * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
    _close(p.detach().numpy(), want, 1e-6)
    st = opt.state_dict()
    assert st['global_step'] == 1
    _close(st['0_moment1'].numpy(), m, 1e-7)


def test_adam_rules_track_the_reference_over_steps():
    """Three steps of Adam and AdamW (with a name-based decay
    exemption) against the reference's own update rules."""
    rs = np.random.RandomState(4)
    p0 = rs.randn(6).astype(np.float32)
    grads = [rs.randn(6).astype(np.float32) for _ in range(3)]
    for cls, jcls, kw in ((Adam, paddle.optimizer.Adam, {}),
                          (AdamW, JaxAdamW, dict(
                              weight_decay=0.05,
                              apply_decay_param_fun=lambda n: n != 'b'))):
        for name in ('a', 'b'):
            p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
            opt = cls(learning_rate=0.01, parameters=[p], **kw)
            opt._param_names[id(p)] = name
            jopt = jcls(learning_rate=0.01, parameters=[], **kw)
            jp, js = jnp.asarray(p0), jopt._create_state(jnp.asarray(p0))
            for t, g in enumerate(grads, 1):
                p.grad = torch.from_numpy(g)
                opt.step()
                jopt._ctx_param_name = name
                jp, js = jopt._rule(jp, jnp.asarray(g), js, 0.01, t)
            _close(p.detach().numpy(), jp, 1e-6, f'{cls.__name__} {name}')


def test_three_trainer_steps_match_the_jax_trainer(weights, ids):
    jt = _jax_trainer(weights, fused_head=False)
    pt = _port_trainer(weights, fused_head=False)
    for _ in range(3):
        want = jt.loss_float(jt.step(ids, ids))
        got = pt.step(ids, ids)
        assert got.dim() == 0 and got.dtype == torch.float32
        _close(pt.loss_float(got), want, TOL)
    _params_close(pt.model, jt.params, steps=3)


def test_fused_head_trainer_equals_the_unfused_one(weights, ids):
    fused = _port_trainer(weights, fused_head=True)
    plain = _port_trainer(weights, fused_head=False)
    for _ in range(3):
        _close(fused.loss_float(fused.step(ids, ids)),
               plain.loss_float(plain.step(ids, ids)), TOL)
    _params_close(fused.model, {n: p.detach().numpy() for n, p in
                                plain.model.named_parameters()}, steps=3)


def test_o2_trainer_steps_match_the_jax_trainer_in_bf16(weights, ids):
    jt = _jax_trainer(weights, fused_head=False, o2=True)
    pt = _port_trainer(weights, fused_head=False, o2=True)
    for _ in range(3):
        want = jt.loss_float(jt.step(ids, ids))
        got = pt.loss_float(pt.step(ids, ids))
        np.testing.assert_allclose(got, want, rtol=O2_LOSS_RTOL)
    # master weights stay f32
    assert all(p.dtype == torch.float32 for p in pt.model.parameters())


def test_train_state_carries_from_jax_into_the_port(weights, ids):
    jt = _jax_trainer(weights, fused_head=False)
    for _ in range(2):
        jt.step(ids, ids)
    params = {k: np.asarray(v) for k, v in jt.params.items()}
    opt_state = {k: {s: np.asarray(a) for s, a in slots.items()}
                 for k, slots in jt.opt_state.items()}
    pt = _port_trainer(weights, fused_head=False)
    convert.load_train_state(pt, params, opt_state, jt._step_no)
    assert pt._step_no == pt.optimizer._global_step == 2
    want = jt.loss_float(jt.step(ids, ids))
    _close(pt.loss_float(pt.step(ids, ids)), want, TOL)
    _params_close(pt.model, jt.params, steps=3)
    with pytest.raises(KeyError, match='missing'):
        convert.load_train_state(pt, params, {}, 2)


def test_eval_step_returns_logits_and_the_jax_loss(weights, ids):
    jt = _jax_trainer(weights)
    pt = _port_trainer(weights)
    jout, jloss = jt.eval_step(ids, ids)
    out, loss = pt.eval_step(ids, ids)
    assert out.shape == (2, 32, 128)          # logits, not hidden states
    _close(out.numpy(), jout, TOL)
    _close(float(loss), float(np.asarray(jloss)), TOL)


def test_what_is_not_ported_raises(weights, ids, tmp_path):
    pm = _port_model(weights, fused_head=True)
    opt = AdamW(parameters=pm.parameters())
    for kw in (dict(supervisor=True), dict(lint=True)):
        with pytest.raises(NotImplementedError):
            ParallelTrainer(pm, opt, pm.loss, **kw)
    # a mesh is the port's (distributed.build_mesh), not any object
    with pytest.raises(TypeError, match='Mesh'):
        ParallelTrainer(pm, opt, pm.loss, mesh=object())
    # profile= arms the sampled profiler now
    # (tests/test_torch_profiler.py)
    # the NaN guard trains now, eager and fused
    # (tests/test_torch_nan_guard.py), and so do the watchdog and
    # checkpointing (tests/test_torch_trainer_resume.py)
    tr = ParallelTrainer(pm, opt, pm.loss, fused_steps=4, nan_guard=True,
                         watchdog=False)
    tr.save_checkpoint(tmp_path / 'ckpt', async_save=False)
    assert tr.restore_checkpoint(tmp_path / 'ckpt') == 0
    # recompute and gradient merge train now
    # (tests/test_torch_fleet_strategy.py), and so do parallel degrees
    # above 1 in a world of several processes
    # (tests/test_torch_data_parallel.py); in a world of one they need
    # more ranks than there are
    st = DistributedStrategy()
    st.hybrid_configs['mp_degree'] = 2
    with pytest.raises(ValueError, match='need a mesh'):
        ParallelTrainer(pm, opt, pm.loss, strategy=st)
    # dropout trains now (tests/test_torch_dropout.py), and so does MoE
    # (tests/test_torch_moe.py): a dense model's loss ignores aux_losses,
    # as the reference's does
    drop = gpt_tiny(device='cpu', **dict(MODEL_KW, dropout=0.1)).train()
    logits = drop(torch.from_numpy(ids))
    assert logits.shape == (2, 32, 128)
    plain = drop.loss(logits, torch.from_numpy(ids))
    assert torch.equal(drop.loss(logits, torch.from_numpy(ids),
                                 aux_losses=[torch.ones(())]), plain)
    drop.eval()
    assert drop(torch.from_numpy(ids)).shape == (2, 32, 128)
    # schedulers and clipping train now (tests/test_torch_optimizers.py);
    # a learning rate that is neither a float nor a scheduler is refused
    with pytest.raises(TypeError, match='learning_rate'):
        AdamW(parameters=pm.parameters(), learning_rate=lambda step: 0.1)


# float16 O1: head_dim 64 and T 128 put the JAX model on its Pallas flash
# and LayerNorm kernels (interpret mode); its einsum branch is no oracle
# in f16 (it subtracts (1 - mask) * 1e9, and 1e9 overflows f16 into
# 0 * inf = NaN on every row)
F16_MODEL_KW = dict(num_layers=2, hidden_size=128, num_heads=2,
                    vocab_size=256, max_seq_len=128, dropout=0.0)
# logits of magnitude ~3.5: both frameworks round to f16 after every
# white-listed op, at other places (matmul epilogues, GELU, the flash
# kernels' P), so they differ by a few f16 steps (2^-11 relative each)
F16_TOL = 5e-3


def test_f16_o1_forward_matches_jax(monkeypatch):
    """An ``auto_cast(dtype='float16')`` O1 GPT forward on the CPU: the
    port's (LayerNorm and flash twins on f16 tensors) against the JAX
    model's under its own ``auto_cast(dtype='float16')``."""
    from jax.experimental.pallas import tpu as pltpu
    from paddle_tpu.ops import _gating
    import paddle_tpu_torch.ops.fused_norm as pln
    monkeypatch.setattr(_gating, 'INTERPRET', True)
    paddle.seed(7)
    jm = jax_gpt_tiny(**F16_MODEL_KW)
    params, buffers = jm.functional_state()
    rs = np.random.RandomState(11)
    host = {k: np.asarray(v) + (0.1 * rs.randn(*v.shape)).astype(np.float32)
            if k.endswith('bias') or '.ln' in k else np.asarray(v)
            for k, v in params.items()}
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    params, buffers = jm.functional_state()
    ids = np.random.RandomState(0).randint(0, 256, (2, 128)).astype(np.int64)
    with pltpu.force_tpu_interpret_mode(), \
            paddle.amp.auto_cast(dtype='float16'):
        want, _ = functional_call(jm, params, buffers, (jnp.asarray(ids),),
                                  training=True)
    ln_dtypes = []
    fwd = pln._fwd
    monkeypatch.setattr(pln, '_fwd', lambda x, *a: ln_dtypes.append(x.dtype)
                        or fwd(x, *a))
    pm = gpt_tiny(device='cpu', **F16_MODEL_KW).load_numpy_state(host).train()
    with amp.auto_cast(dtype='float16'):
        got = pm(torch.from_numpy(ids))
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert ln_dtypes[1:] and set(ln_dtypes[1:]) == {torch.float16}
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.detach().float().numpy() - want)
    assert np.isfinite(want).all()
    assert (diff <= F16_TOL * (1 + np.abs(want))).all(), diff.max()


def test_amp_policy_follows_the_reference_lists():
    f32 = torch.ones(2, dtype=torch.float32)
    b16 = torch.ones(2, dtype=torch.bfloat16)
    ints = torch.ones(2, dtype=torch.int64)

    def dtypes(op, *ts):
        return [None if t is None else t.dtype
                for t in amp.amp_cast(op, *ts)]

    assert dtypes('linear', f32) == [torch.float32]          # off
    with amp.auto_cast(level='O1'):
        assert dtypes('linear', f32, None)[0] == torch.bfloat16
        assert dtypes('add', f32, f32) == [torch.float32] * 2
        assert dtypes('add', f32, b16) == [torch.bfloat16] * 2
        assert dtypes('cross_entropy', b16) == [torch.float32]
        assert dtypes('layer_norm', b16, f32) == [torch.bfloat16,
                                                  torch.float32]
        assert dtypes('embedding', ints, f32) == [torch.int64,
                                                  torch.float32]
    with amp.auto_cast(level='O2'):
        assert amp.is_amp_enabled()
        assert dtypes('embedding', ints, f32) == [torch.int64,
                                                  torch.bfloat16]
        assert dtypes('fused_lm_head_ce', f32, f32) == [torch.bfloat16] * 2
        assert dtypes('mean', b16) == [torch.float32]
    with amp.auto_cast(level='O2', custom_black_list=['linear'],
                       custom_white_list=['layer_norm']):
        assert dtypes('linear', b16) == [torch.float32]
        assert dtypes('layer_norm', f32) == [torch.bfloat16]
    assert not amp.is_amp_enabled()
    with pytest.raises(ValueError):
        with amp.auto_cast(level='O3'):
            pass


def test_decorate_o2_casts_the_parameters(weights):
    pm = _port_model(weights)
    assert amp.decorate(pm, level='O1') is pm
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    model, opt = amp.decorate(pm, optimizers='opt', level='O2')
    assert model is pm and opt == 'opt'
    assert all(p.dtype == torch.bfloat16 for p in pm.parameters())


def test_loss_and_gradients_match_jax_past_1024_positions():
    """The long-context regime (``bench.py``'s ``longctx`` trains at T
    4096): a 1-layer ``gpt_tiny`` with ``max_seq_len`` 2048 at T 1536,
    past GPT-2's 1024 positions, with the fused head.  Loss within 1e-5
    and every gradient within 1e-4 of the JAX model's ``jax.grad``."""
    kw = dict(MODEL_KW, num_layers=1, max_seq_len=2048, fused_head=True)
    paddle.seed(3)
    jm = jax_gpt_tiny(**kw)
    host = {k: np.array(v) for k, v in jm.functional_state()[0].items()}
    assert host['gpt.wpe.weight'].shape == (2048, 64)
    ids = np.random.RandomState(4).randint(0, 128, (1, 1536)).astype(
        np.int64)
    want_loss, want_grads = _jax_loss_and_grads(jm, ids)
    pm = gpt_tiny(device='cpu', **kw).load_numpy_state(host).train()
    loss = pm.loss(pm(torch.from_numpy(ids)), torch.from_numpy(ids))
    _close(float(loss.detach()), want_loss, TOL)
    loss.backward()
    for name, g in want_grads.items():
        got = dict(pm.named_parameters())[name].grad.numpy()
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(got - g).max()) <= GRAD_TOL * scale, name
    with pytest.raises(ValueError):
        pm(torch.zeros((1, 2049), dtype=torch.int64))
