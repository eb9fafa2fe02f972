"""The port's BERT pretraining path against the JAX package's, on the
CPU.

One ``bert_tiny``-style model (2 layers, H 128, 2 heads of 64, FFN 512,
vocab 256, T 128: widths the Pallas tiling takes) is built in the JAX
package, its LayerNorm and bias parameters are perturbed with seeded
numpy noise, and the same numpy weights are loaded into both packages
(``convert.load_numpy_state``).  Inputs: seeded ids and token types,
MLM labels on 15% of the positions and ``-100`` elsewhere (as
``bench.py`` makes them), NSP labels.

Gradients are checked in three configurations, with the JAX model's
Pallas kernels run in TPU-interpret mode (``_gating.INTERPRET``, as
``tests/test_flash_spmd.py`` sets it) and the port's kernels' plain
twins on CPU tensors:
- dropout 1e-9: ``1 - p`` rounds to 1 in f32, so both packages keep
  every element with scale 1, and both take the softmax branch of the
  attention (the fused softmax kernels);
- dropout 0: both take non-causal flash attention;
- dropout 1e-9 with ``USE_PALLAS_MLP`` on: softmax plus the GEMM+GELU
  kernels in every MLP.
Each case also checks which kernels each side ran.

The JAX ``ParallelTrainer`` does not train a fused MLM head (its loss
reads the live ``word_emb``; ROADMAP Queue 3, shown here for BERT as it
was for GPT), so trainer-vs-trainer checks run the unfused head and the
port's fused-head trainer is held to its unfused one.

Tolerances: logits and losses 1e-5 (f32 through 2 layers, sums in
another order); gradients 1e-4 relative to each gradient's largest
entry; parameters after 3 AdamW steps 1e-4, except the entries whose
gradient was round-off at some step (below 1e-6 of its tensor's
largest: the key bias, whose true gradient is 0 since softmax ignores a
shift shared by a row, and single weights such as an FFN output weight
fed by a unit that GELU keeps near 0): Adam's ``m / sqrt(v)`` turns
round-off into steps of up to ``lr`` with arbitrary sign, so those are
held to ``2 * lr * steps``.  Losses of 3 bf16 O2 steps: 2e-3 relative
(a quarter of bf16's epsilon), on the bench's MLM-only loss: with NSP
labels the reference's ``mlm + nsp`` is a gray op that O2 rounds to
bf16, which the eager model and the port do and the reference's
compiled step on the CPU does not.
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
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import _gating
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelTrainer

jfg = importlib.import_module('paddle_tpu.ops.fused_gelu_linear')
jfs = importlib.import_module('paddle_tpu.ops.fused_softmax')
jfa = importlib.import_module('paddle_tpu.ops.flash_attention')
pfg = importlib.import_module('paddle_tpu_torch.ops.fused_gelu_linear')
pfs = importlib.import_module('paddle_tpu_torch.ops.fused_softmax')
pfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')

TOL = 1e-5
GRAD_RTOL = 1e-4
O2_LOSS_RTOL = 2e-3
LR = 3e-3
B, T, V, H = 2, 128, 256, 128     # V != H: loss() keys off the width
MODEL_KW = dict(num_layers=2, hidden_size=H, num_heads=2, vocab_size=V,
                max_seq_len=T, dropout=0.0)


@pytest.fixture(scope='module')
def weights():
    paddle.seed(7)
    params, _ = jbert.bert_tiny(**MODEL_KW).functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name or 'mlm_ln' in name:
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    return host


@pytest.fixture(scope='module')
def batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, V, (B, T)).astype(np.int64)
    types = (np.arange(T)[None, :] >= rs.randint(1, T, (B, 1))) \
        .astype(np.int64)
    mlm = np.where(rs.rand(B, T) < 0.15, rs.randint(0, V, (B, T)),
                   -100).astype(np.int64)
    nsp = rs.randint(0, 2, (B,)).astype(np.int64)
    return ids, types, mlm, nsp


def _jax_model(host, **kw):
    jm = jbert.bert_tiny(**dict(MODEL_KW, **kw))
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    return jm


def _port_model(host, **kw):
    return pbert.bert_tiny(device='cpu', **dict(MODEL_KW, **kw)) \
        .load_numpy_state(host)


def _jt(a):
    return JaxTensor._from_value(jnp.asarray(a))


def _jax_loss_and_grads(jm, batch):
    """jax.value_and_grad of the JAX model's training forward + loss,
    every parameter (the tied decoder's too) traced."""
    ids, types, mlm, nsp = batch
    params, buffers = jm.functional_state()

    def loss_of(p):
        saved = jm.functional_state()
        jm.load_functional_state(p, buffers)
        jm.train()
        try:
            with jax_no_grad():
                out = jm(_jt(ids), _jt(types))
                return jm.loss(out, _jt(mlm), _jt(nsp)).value
        finally:
            jm.load_functional_state(*saved)

    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _close_rel(got, want, rtol, what=''):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _counting(monkeypatch, module, name, counts, key):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        counts[key] = counts.get(key, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


def test_config_and_state_keys_match_the_reference(weights):
    assert vars(pbert.BertConfig()) == vars(jbert.BertConfig())
    pm = _port_model(weights)
    assert pm.training                     # built in training mode
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
        {k: v.shape for k, v in weights.items()}
    big = pbert.bert_large(device='cpu', num_layers=1, vocab_size=8,
                           max_seq_len=4)
    assert (big.config.hidden_size, big.config.num_heads,
            big.config.dropout) == (1024, 16, 0.1)


def test_eval_forward_matches_jax(weights, batch):
    ids, types, _, _ = batch
    jm = _jax_model(weights, dropout=0.1)
    params, buffers = jm.functional_state()
    (want_lg, want_nsp), _ = functional_call(
        jm, params, buffers, (jnp.asarray(ids), jnp.asarray(types)),
        training=False)
    pm = _port_model(weights, dropout=0.1).eval()
    with torch.no_grad():
        lg, nsp = pm(torch.from_numpy(ids), torch.from_numpy(types))
    assert lg.shape == (B, T, V) and nsp.shape == (B, 2)
    _close(lg.numpy(), want_lg, TOL)
    _close(nsp.numpy(), want_nsp, TOL)


@pytest.mark.parametrize('fused_head', [True, False])
def test_losses_match_jax_with_ignored_and_nsp_labels(weights, batch,
                                                      fused_head):
    ids, types, mlm, nsp = batch
    jm = _jax_model(weights, fused_head=fused_head)
    pm = _port_model(weights, fused_head=fused_head)
    jout = jm(_jt(ids), _jt(types))
    out = pm(torch.from_numpy(ids), torch.from_numpy(types))
    assert out[0].shape[-1] == (H if fused_head else V)
    for labels in ((mlm,), (mlm, nsp)):
        want = float(np.asarray(jm.loss(jout, *map(_jt, labels)).value))
        got = pm.loss(out, *map(torch.from_numpy, labels))
        _close(float(got.detach()), want, TOL)
    # every label ignored: the MLM term is 0, not a division by zero
    none = np.full_like(mlm, -100)
    assert float(pm.loss(out, torch.from_numpy(none)).detach()) == 0.0


CASES = {
    # name: (dropout, USE_PALLAS_MLP, kernels each side must run)
    'softmax': (1e-9, False, {'softmax'}),
    'flash': (0.0, False, {'flash'}),
    'gelu_kernels': (1e-9, True, {'softmax', 'gelu'}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_loss_and_every_gradient_match_jax_grad(weights, batch, case,
                                                monkeypatch):
    dropout, pallas_mlp, kernels = CASES[case]
    monkeypatch.setattr(_gating, 'INTERPRET', True)
    monkeypatch.setattr(jfg, 'USE_PALLAS_MLP', pallas_mlp)
    monkeypatch.setattr(pfg, 'USE_PALLAS_MLP', pallas_mlp)
    jc, pc = {}, {}
    _counting(monkeypatch, jfs, '_fwd_pallas', jc, 'softmax')
    _counting(monkeypatch, jfa, '_fwd_pallas', jc, 'flash')
    _counting(monkeypatch, jfg, '_mm_epilogue', jc, 'gelu')
    _counting(monkeypatch, pfs, '_fwd', pc, 'softmax')
    _counting(monkeypatch, pfa, '_fwd', pc, 'flash')
    _counting(monkeypatch, pfg, '_fwd', pc, 'gelu')
    fused_head = case != 'flash'
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grads = _jax_loss_and_grads(
            _jax_model(weights, dropout=dropout, fused_head=fused_head),
            batch)
    ids, types, mlm, nsp = (torch.from_numpy(a) for a in batch)
    pm = _port_model(weights, dropout=dropout, fused_head=fused_head)
    loss = pm.loss(pm(ids, types), mlm, nsp)
    _close(float(loss.detach()), want_loss, TOL)
    loss.backward()
    got = dict(pm.named_parameters())
    assert set(got) == set(want_grads)
    for name, g in want_grads.items():
        _close_rel(got[name].grad.numpy(), g, GRAD_RTOL, name)
    assert set(jc) == kernels and set(pc) == kernels, (jc, pc)
    assert pc == {k: MODEL_KW['num_layers'] for k in kernels}


def _strategy(cls, o2):
    st = cls()
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    return st


def _jax_trainer(host, fused_head=False, o2=False, nsp=True):
    jm = _jax_model(host, fused_head=fused_head)
    opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    return JaxTrainer(jm, opt, lambda out, *ys: jm.loss(out, *ys),
                      strategy=_strategy(JaxStrategy, o2))


def _port_trainer(host, fused_head=False, o2=False, nsp=True, **kw):
    pm = _port_model(host, fused_head=fused_head, **kw)
    opt = AdamW(learning_rate=LR, parameters=pm.parameters())
    return ParallelTrainer(pm, opt, lambda out, *ys: pm.loss(out, *ys),
                           strategy=_strategy(DistributedStrategy, o2))


def _note_roundoff(model, noisy):
    """Mark the entries whose gradient of this step is round-off
    (below 1e-6 of its tensor's largest entry)."""
    for name, p in model.named_parameters():
        if p.grad is None:          # unused this step (type_emb)
            noisy.setdefault(name, np.zeros(tuple(p.shape), bool))
            continue
        g = p.grad.detach().abs()
        low = (g <= 1e-6 * g.max()).numpy()
        noisy[name] = noisy.get(name, False) | low


def _params_close(model, want, steps, noisy):
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, value in want.items():
        value, mine, low = np.asarray(value), got[name], noisy[name]
        _close(mine[low], value[low], 2 * LR * steps, name)
        _close(mine[~low], value[~low], GRAD_RTOL, name)


def test_three_trainer_steps_match_the_jax_trainer(weights, batch):
    ids, _, mlm, nsp = batch
    jt = _jax_trainer(weights)
    pt = _port_trainer(weights)
    noisy = {}
    for _ in range(3):
        want = jt.loss_float(jt.step(ids, mlm, nsp))
        got = pt.step(ids, mlm, nsp)
        _note_roundoff(pt.model, noisy)
        assert got.dim() == 0 and got.dtype == torch.float32
        _close(pt.loss_float(got), want, TOL)
    assert noisy['bert.layers.0.attn.qkv.bias'][H:2 * H].all()
    _params_close(pt.model, jt.params, 3, noisy)


def test_fused_mlm_head_trains_the_tied_decoder(weights, batch):
    """The port's fused-head trainer equals its unfused one; the JAX
    trainer's fused head leaves the tied decoder's gradient out (Queue
    3): after one step its word embeddings part from the unfused
    trainer's."""
    ids, _, mlm, nsp = batch
    fused = _port_trainer(weights, fused_head=True)
    plain = _port_trainer(weights)
    noisy = {}
    for _ in range(3):
        _close(fused.loss_float(fused.step(ids, mlm, nsp)),
               plain.loss_float(plain.step(ids, mlm, nsp)), TOL)
        _note_roundoff(plain.model, noisy)
    _params_close(fused.model, {n: p.detach().numpy() for n, p in
                                plain.model.named_parameters()}, 3, noisy)
    jf = _jax_trainer(weights, fused_head=True)
    ju = _jax_trainer(weights)
    jf.step(ids, mlm, nsp)
    ju.step(ids, mlm, nsp)
    key = 'bert.word_emb.weight'
    gap = float(np.abs(np.asarray(jf.params[key])
                       - np.asarray(ju.params[key])).max())
    # Adam moves an entry by about lr a step: the head's gradient is
    # missing from the fused trainer's update, not rounded in it
    assert gap > LR, gap


def test_o2_trainer_steps_match_the_jax_trainer_in_bf16(weights, batch):
    ids, _, mlm, _ = batch
    jt = _jax_trainer(weights, o2=True, nsp=False)
    pt = _port_trainer(weights, o2=True, nsp=False)
    for _ in range(3):
        want = jt.loss_float(jt.step(ids, mlm))
        got = pt.loss_float(pt.step(ids, mlm))
        np.testing.assert_allclose(got, want, rtol=O2_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in pt.model.parameters())


def test_dropout_trains_through_the_softmax_branch(weights, batch,
                                                   monkeypatch):
    """At the published dropout 0.1 under bf16 O2: every layer's
    attention runs the softmax path (not flash), the loss is finite and
    falls on one batch, and eval is deterministic."""
    counts = {}
    _counting(monkeypatch, pfs, '_fwd', counts, 'softmax')
    _counting(monkeypatch, pfa, '_fwd', counts, 'flash')
    ids, _, mlm, nsp = batch
    pt = _port_trainer(weights, fused_head=True, o2=True, dropout=0.1)
    losses = [pt.loss_float(pt.step(ids, mlm, nsp)) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert counts == {'softmax': 4 * MODEL_KW['num_layers']}
    pm = pt.model.eval()
    with torch.no_grad():
        a = pm(torch.from_numpy(ids))[0]
        b = pm(torch.from_numpy(ids))[0]
    assert torch.equal(a, b)
    assert counts['flash'] == 2 * MODEL_KW['num_layers']
