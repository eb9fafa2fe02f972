"""The port's Wide&Deep and DeepFM against the JAX package's, on the CPU.

Each JAX model is built once for the module from a seed (four sparse
fields of 50, 30, 20 and 7 ids, 4 dense features, embed 8, hidden
(16, 8)); its parameters go to numpy and load into the port's model
(``load_numpy_state``, by the reference's state-dict keys).  The
gradient oracle is ``jax.value_and_grad`` of ``BCEWithLogitsLoss`` over
the JAX model's forward (``functional_call``), run op by op; the trainer
oracle is the JAX ``ParallelTrainer``'s ``_raw_step`` with ``Adam``, op
by op, as ``tests/test_torch_vision.py`` runs it.

Tolerances, f32: outputs and losses 2e-5; every gradient within 1e-4 of
its tensor's largest value; parameters after three Adam steps at lr
1e-2 within 1e-4 absolute (a hundredth of a step).  Under bf16 O2 the
outputs agree within 2e-2 of their largest value and the loss within
1e-2 (both packages round the same ops to bf16, XLA and PyTorch at
other places inside the matmuls and the sums), and each gradient within
5e-2 of its norm (the embedding gradients are bf16 scatter-adds of
duplicated ids, accumulated in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.jit import functional_call
from paddle_tpu.models.widedeep import DeepFM as JaxDeepFM
from paddle_tpu.models.widedeep import WideDeep as JaxWideDeep
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    VocabParallelEmbedding
from paddle_tpu_torch.models import DeepFM, WideDeep
from paddle_tpu_torch.nn.layer import create_parameter
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import ParallelTrainer

DIMS = [50, 30, 20, 7]
KW = dict(dense_dim=4, embed_dim=8, hidden=(16, 8))
TOL, REL = 2e-5, 1e-4
O2_OUT, O2_LOSS, O2_GRAD = 2e-2, 1e-2, 5e-2
CLASSES = {'WideDeep': (JaxWideDeep, WideDeep),
           'DeepFM': (JaxDeepFM, DeepFM)}


def _batch(n=64, seed=0):
    rs = np.random.RandomState(seed)
    ids = np.stack([rs.randint(0, d, n) for d in DIMS], 1).astype(np.int64)
    dense = rs.randn(n, 4).astype(np.float32)
    y = ((ids[:, 0] % 2 == 0) ^ (dense.sum(1) > 0)).astype(
        np.float32)[:, None]
    return ids, dense, y


@pytest.fixture(scope='module')
def jax_models():
    out = {}
    for name, (jcls, _) in CLASSES.items():
        paddle.seed(3)
        jm = jcls(DIMS, **KW)
        params, _ = jm.functional_state()
        out[name] = (jm, {k: np.array(v) for k, v in params.items()})
    return out


def _port(name, state, **kw):
    return CLASSES[name][1](DIMS, device='cpu', **KW, **kw) \
        .load_numpy_state(state)


def _auto_cast(level, package):
    import contextlib
    return package.auto_cast(level=level) if level else \
        contextlib.nullcontext()


def _jax_loss_grads(jm, batch, level=None):
    ids, dense, y = batch
    params, buffers = jm.functional_state()
    bce = paddle.nn.BCEWithLogitsLoss()

    def loss_of(p):
        with _auto_cast(level, paddle.amp):
            out, _ = functional_call(jm, p, buffers, (jnp.asarray(ids),
                                                      jnp.asarray(dense)),
                                     training=True)
            with jax_no_grad():
                loss = bce(JaxTensor._from_value(out),
                           JaxTensor._from_value(jnp.asarray(y)))
        return loss.value.astype(jnp.float32), out

    (loss, out), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    return (float(loss), np.asarray(out.astype(jnp.float32)),
            {k: np.asarray(v) for k, v in grads.items()})


def _port_loss_grads(pm, batch, level=None):
    ids, dense, y = (torch.from_numpy(a) for a in batch)
    with _auto_cast(level, amp):
        out = pm(ids, dense)
        loss = nn.BCEWithLogitsLoss()(out, y)
    loss.backward()
    return (float(loss.detach()), out.detach().float().numpy(),
            {n: p.grad.numpy() for n, p in pm.named_parameters()})


def _rel_close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= rel, f'{what}: max |diff| / max |want| {err:.3e} > {rel}'


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_state_keys_are_the_references_and_offsets_stay_out(jax_models,
                                                            name):
    jm, state = jax_models[name]
    pm = _port(name, state)
    assert set(pm.state_dict()) == set(state)
    for k, v in pm.state_dict().items():
        assert tuple(v.shape) == state[k].shape, k
    offsets = [b for n, b in pm.named_buffers() if n.endswith('offsets')]
    assert len(offsets) == 2
    for b in offsets:
        assert b.dtype == torch.int64
        assert b.tolist() == [0, 50, 80, 100]


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_forward_loss_and_every_gradient_match_jax_in_f32(jax_models,
                                                          name):
    jm, state = jax_models[name]
    batch = _batch()
    want_loss, want_out, want_g = _jax_loss_grads(jm, batch)
    got_loss, got_out, got_g = _port_loss_grads(_port(name, state), batch)
    np.testing.assert_allclose(got_out, want_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        _rel_close(got_g[k], w, REL, k)


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_forward_and_gradients_match_jax_under_o2(jax_models, name):
    """O2: the tables are cast to bf16 at the gather, the sums run in
    f32, the rest in bf16, and the loss in f32, in both packages."""
    jm, state = jax_models[name]
    batch = _batch()
    want_loss, want_out, want_g = _jax_loss_grads(jm, batch, 'O2')
    got_loss, got_out, got_g = _port_loss_grads(_port(name, state), batch,
                                                'O2')
    _rel_close(got_out, want_out, O2_OUT, 'output')
    np.testing.assert_allclose(got_loss, want_loss, rtol=O2_LOSS)
    for k, w in want_g.items():
        assert got_g[k].dtype == np.float32, k
        err = np.linalg.norm(got_g[k] - w) / np.linalg.norm(w)
        assert err <= O2_GRAD, f'{k}: |diff| / |want| {err:.3e}'


def test_under_o2_the_dtypes_follow_the_reference():
    """The gathers and the MLP run in bf16, the sums in f32
    (black-listed), the model's output in bf16 and the loss in f32."""
    from paddle_tpu_torch.tensor import math as pmath
    pm = DeepFM(DIMS, device='cpu', **KW)
    ids, dense, y = (torch.from_numpy(a) for a in _batch(8))
    seen = []

    def note(m, i, o):
        seen.append((type(m).__name__, o.dtype))

    for m in (pm.first_order.table, pm.emb.table, pm.deep[0]):
        m.register_forward_hook(note)
    sums = []
    real_sum = pmath.sum

    def counting_sum(*a, **k):
        out = real_sum(*a, **k)
        sums.append(out.dtype)
        return out

    pmath_sum, pmath.sum = pmath.sum, counting_sum
    try:
        with amp.auto_cast(level='O2'):
            out = pm(ids, dense)
            loss = F.binary_cross_entropy_with_logits(out, y)
    finally:
        pmath.sum = pmath_sum
    assert seen == [('Embedding', torch.bfloat16)] * 2 + [
        ('Linear', torch.bfloat16)]
    assert sums == [torch.float32] * 4
    assert out.dtype == torch.bfloat16
    assert loss.dtype == torch.float32


def test_per_field_gather_and_sharded_tables_compute_the_fused_function():
    """Mirrors ``tests/test_models.py``: per-field tables holding the
    fused table's row slices, and ``shard_vocab=True``
    (``VocabParallelEmbedding`` on one device) holding the same rows,
    give the fused model's outputs; per-field tables do not shard."""
    ids, dense, _ = (torch.from_numpy(a) for a in _batch(32))
    m_f = WideDeep(DIMS, device='cpu', **KW)
    m_p = WideDeep(DIMS, device='cpu', fused_gather=False, **KW)
    m_s = WideDeep(DIMS, device='cpu', shard_vocab=True, **KW)
    assert isinstance(m_s.wide.table, VocabParallelEmbedding)
    assert isinstance(m_p.wide.tables, nn.LayerList)
    sd = m_f.state_dict()
    m_s.load_state_dict(sd)
    psd = {k: v for k, v in sd.items() if '.table.' not in k}
    for role in ('wide', 'deep_emb'):
        off = 0
        for i, d in enumerate(DIMS):
            psd[f'{role}.tables.{i}.weight'] = \
                sd[f'{role}.table.weight'][off:off + d]
            off += d
    m_p.load_state_dict(psd)
    with torch.no_grad():
        a, b, c = (m(ids, dense) for m in (m_f, m_p, m_s))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(c.numpy(), a.numpy())
    with pytest.raises(ValueError):
        WideDeep(DIMS, shard_vocab=True, fused_gather=False, device='cpu')


def test_per_field_and_sharded_models_match_jax(jax_models):
    """The reference's own per-field and sharded models, from the same
    seed, load into the port's by their keys and agree in f32."""
    batch = _batch(16)
    for kw in (dict(fused_gather=False), dict(shard_vocab=True)):
        paddle.seed(5)
        jm = JaxWideDeep(DIMS, **KW, **kw)
        state = {k: np.array(v) for k, v in jm.functional_state()[0].items()}
        pm = WideDeep(DIMS, device='cpu', **KW, **kw).load_numpy_state(state)
        want_loss, want_out, _ = _jax_loss_grads(jm, batch)
        got_loss, got_out, _ = _port_loss_grads(pm, batch)
        np.testing.assert_allclose(got_out, want_out, rtol=TOL, atol=TOL)


def test_default_init_laws_are_the_references():
    """``nn.Embedding`` draws N(0, 1), ``VocabParallelEmbedding``
    XavierNormal, ``Linear`` XavierNormal with zero bias, and
    ``create_parameter`` zeros with ``is_bias=True`` and XavierNormal
    otherwise, as in the reference."""
    m = WideDeep([4000, 4000], dense_dim=3, embed_dim=16, device='cpu')
    s = WideDeep([4000, 4000], dense_dim=3, embed_dim=16, shard_vocab=True,
                 device='cpu')
    paddle.seed(0)
    jm = JaxWideDeep([4000, 4000], dense_dim=3, embed_dim=16)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    for k in ('deep_emb.table.weight', 'wide.table.weight'):
        assert abs(float(m.state_dict()[k].std()) - 1.0) < 0.03
        assert abs(float(jstate[k].std()) - 1.0) < 0.03
    xavier = (2.0 / (8000 + 16)) ** 0.5
    assert abs(float(s.deep_emb.table.weight.detach().std()) / xavier - 1) < 0.03
    assert float(m.bias.detach().abs().max()) == 0.0 == float(np.abs(
        jstate['bias']).max())
    assert not m.deep[0].bias.any()
    w = create_parameter([4000, 16], generator=torch.Generator().manual_seed(
        0), device='cpu')
    assert w.requires_grad and w.dtype == torch.float32
    assert abs(float(w.detach().std()) / (2.0 / 4016) ** 0.5 - 1) < 0.03


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('with_weight,with_pos', [(False, False),
                                                  (True, False),
                                                  (False, True),
                                                  (True, True)])
def test_bce_with_logits_matches_jax(reduction, with_weight, with_pos):
    """Logits out to +-40 (the stable form's range), labels in [0, 1];
    value and gradient of the logits in f32, and under O2 with bf16
    logits (the loss runs in f32: black-listed)."""
    rs = np.random.RandomState(7)
    z = (rs.randn(6, 5) * 10).astype(np.float32)
    z[0, :2] = [40.0, -40.0]
    y = rs.rand(6, 5).astype(np.float32)
    w = rs.rand(6, 5).astype(np.float32) if with_weight else None
    pw = (rs.rand(5) * 3).astype(np.float32) if with_pos else None
    cot = np.asarray(rs.randn(*((6, 5) if reduction == 'none' else ())),
                     np.float32)

    def jfn(zv):
        with jax_no_grad():
            out = JF.binary_cross_entropy_with_logits(
                JaxTensor._from_value(zv), paddle.to_tensor(y),
                None if w is None else paddle.to_tensor(w), reduction,
                None if pw is None else paddle.to_tensor(pw)).value
        return jnp.sum(out * cot), out

    for level, dtype in ((None, torch.float32), ('O2', torch.bfloat16)):
        with _auto_cast(level, paddle.amp):
            (_, want), want_g = jax.value_and_grad(jfn, has_aux=True)(
                jnp.asarray(z).astype(jnp.bfloat16 if level else
                                      jnp.float32))
        tz = torch.from_numpy(z).to(dtype).requires_grad_(True)
        layer = nn.BCEWithLogitsLoss(
            None if w is None else torch.from_numpy(w), reduction,
            None if pw is None else torch.from_numpy(pw))
        with _auto_cast(level, amp):
            got = layer(tz, torch.from_numpy(y))
        assert got.dtype == torch.float32
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tz.grad.float().numpy(),
                                   np.asarray(want_g.astype(jnp.float32)),
                                   rtol=1e-5, atol=1e-6)


def test_bce_rejects_an_unknown_reduction():
    with pytest.raises(ValueError):
        F.binary_cross_entropy_with_logits(torch.zeros(2), torch.zeros(2),
                                           reduction='avg')


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_three_adam_steps_match_the_jax_trainer(jax_models, name):
    """The JAX ParallelTrainer's step (``_raw_step``, op by op) and the
    port's ParallelTrainer (``n_inputs=2``), Adam lr 1e-2, f32, over
    three seeded batches: losses within 2e-5, every parameter within
    1e-4 absolute."""
    jm, state = jax_models[name]
    pm = _port(name, state)
    jbce, pbce = paddle.nn.BCEWithLogitsLoss(), nn.BCEWithLogitsLoss()
    jt = JaxTrainer(jm, JaxAdam(learning_rate=1e-2,
                                parameters=jm.parameters()),
                    lambda out, y: jbce(out, y), n_inputs=2)
    jt._build_step()
    pt = ParallelTrainer(pm, Adam(learning_rate=1e-2,
                                  parameters=pm.parameters()),
                         lambda out, y: pbce(out, y), n_inputs=2)
    for i in range(3):
        ids, dense, y = _batch(32, seed=i)
        jt.params, jt.buffers, jt.opt_state, loss = jt._raw_step(
            jt.params, jt.buffers, jt.opt_state, jnp.asarray(i + 1),
            jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(dense),
            jnp.asarray(y))
        np.testing.assert_allclose(float(pt.step(ids, dense, y)),
                                   float(loss), rtol=TOL)
    got = dict(pm.named_parameters())
    for n, v in jt.params.items():
        np.testing.assert_allclose(got[n].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4, err_msg=n)


def test_o2_trainer_under_step_fused_equals_its_eager_steps():
    """Wide&Deep under O2 through ``step_fused`` (on the CPU, K eager
    steps) equals K calls of ``step`` bit for bit."""
    def trainer(k=None):
        pm = WideDeep(DIMS, device='cpu', seed=1, **KW)
        st = DistributedStrategy()
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
        bce = nn.BCEWithLogitsLoss()
        return ParallelTrainer(pm, Adam(learning_rate=1e-3,
                                        parameters=pm.parameters()),
                               lambda out, y: bce(out, y), n_inputs=2,
                               strategy=st, fused_steps=k)

    batch = _batch(32)
    eager = trainer()
    want = torch.stack([eager.step(*batch) for _ in range(3)])
    fused = trainer(3)
    got = fused.step_fused(*(np.stack([b] * 3) for b in batch))
    assert torch.equal(got, want)
    for (n, a), b in zip(eager.model.named_parameters(),
                         fused.model.parameters()):
        assert torch.equal(a, b), n
