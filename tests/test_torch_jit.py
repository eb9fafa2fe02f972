"""``paddle_tpu_torch.jit`` (slice 17: ``to_static``, ``save``, ``load``,
``TranslatedLayer``, ``TracedLayer``, ``ProgramTranslator``), the
``inference`` Predictor and ``Model.save(training=False)``, held to the
JAX package on the same weights on the CPU.

- A small BERT (2 layers, H 64, weights carried across by
  ``convert.load_numpy_state``) gives the same outputs through the
  port's ``to_static`` and its ``jit.load`` as through the reference's
  ``jit.load``, within 2e-5 at a fixed batch.  The reference exports
  BERT only at a fixed batch (its ``reshape`` compares a symbolic
  dimension, ROADMAP Queue 3); the port's artifact is batch-dynamic.
- LeNet and ResNet-18 saved with a ``None`` batch match the reference's
  batch-dynamic artifacts at B 1, 3 and 5 within 2e-5 (of the largest
  logit for ResNet-18).
- The artifact loads in a fresh process that never imports the model's
  class.
- The exported graph names the hand-written kernels' operators
  (``paddle_tpu_torch::*``), one node per launch, and no plain twin:
  ``aten`` softmax or LayerNorm nodes would mean an export inlined one.
- ``.pdiparams`` holds the reference's state key by key.
- Error paths raise in both packages.
"""
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.ops import fused_gelu_linear as pfg
from paddle_tpu_torch.static import InputSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
B, T, V, H = 2, 16, 96, 64          # V != H
MODEL_KW = dict(num_layers=2, hidden_size=H, num_heads=2, vocab_size=V,
                max_seq_len=T, dropout=0.0)
LN_PER_FORWARD = 1 + 2 * MODEL_KW['num_layers'] + 1   # emb, 2 a layer, MLM
OPS = 'paddle_tpu_torch.'


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


@pytest.fixture(scope='module')
def weights():
    jpaddle.seed(5)
    params, _ = jbert.bert_tiny(**MODEL_KW).functional_state()
    rs = np.random.RandomState(3)
    return {k: np.asarray(v) + (0.05 * rs.randn(*np.shape(v))).astype(
        np.float32) for k, v in params.items()}


@pytest.fixture(scope='module')
def inputs():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, V, (5, T)).astype(np.int64)
    types = (np.arange(T)[None, :] >= rs.randint(1, T, (5, 1))) \
        .astype(np.int64)
    return ids, types


def _port_bert(weights):
    m = pbert.bert_tiny(device='cpu', **MODEL_KW).load_numpy_state(weights)
    return m.eval()


def _jax_bert(weights):
    jm = jbert.bert_tiny(**MODEL_KW)
    jm.load_functional_state({k: jnp.asarray(v) for k, v in
                              weights.items()})
    jm.eval()
    return jm


def _spec(P, batch):
    return [P.static.InputSpec([batch, T], 'int64', 'input_ids'),
            P.static.InputSpec([batch, T], 'int64', 'token_type_ids')]


@pytest.fixture(scope='module')
def jax_artifact(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp('jax') / 'bert')
    jpaddle.jit.save(_jax_bert(weights), path, input_spec=_spec(jpaddle, B))
    return path


@pytest.fixture(scope='module')
def port_artifact(weights, tmp_path_factory):
    paddle.set_device('cpu')
    path = str(tmp_path_factory.mktemp('port') / 'bert')
    jit.save(_port_bert(weights), path, input_spec=_spec(paddle, None))
    return path


def _np(out):
    return [np.asarray(o.numpy() if hasattr(o, 'numpy') else o)
            for o in out]


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_bert_to_static_and_load_match_the_references_load(
        weights, inputs, jax_artifact, port_artifact):
    ids, types = (a[:B] for a in inputs)
    want = _np(jpaddle.jit.load(jax_artifact)(jpaddle.to_tensor(ids),
                                              jpaddle.to_tensor(types)))
    eager = _port_bert(weights)
    static = jit.to_static(_port_bert(weights))
    got = _np(static(torch.from_numpy(ids), torch.from_numpy(types)))
    _close(got, want)
    assert static.forward.modes() == {next(iter(static.forward.modes())):
                                      'cpu'}
    with torch.no_grad():
        exact = _np(eager(torch.from_numpy(ids), torch.from_numpy(types)))
    assert all(np.array_equal(g, e) for g, e in zip(got, exact))
    loaded = jit.load(port_artifact, device='cpu')
    assert loaded.input_names() == ['input_ids', 'token_type_ids']
    _close(_np(loaded(ids, types)), want)


def test_bert_artifact_is_batch_dynamic_where_the_references_is_not(
        weights, inputs, port_artifact, tmp_path, monkeypatch):
    import importlib
    pfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    twin = pfa._fwd_twin

    def contiguous_only(q, k, v, causal, scale):
        # the kernels take contiguous rows: at B 1 the traced reshape
        # (a copy at the traced batch of 2) is a view
        assert q.is_contiguous() and k.is_contiguous() \
            and v.is_contiguous()
        return twin(q, k, v, causal, scale)
    monkeypatch.setattr(pfa, '_fwd_twin', contiguous_only)
    loaded = jit.load(port_artifact, device='cpu')
    eager = _port_bert(weights)
    for b in (1, 3, 5):
        ids, types = (torch.from_numpy(a[:b]) for a in inputs)
        with torch.no_grad():
            want = _np(eager(ids, types))
        _close(_np(loaded(ids, types)), want)
    with pytest.raises(Exception, match='Inconclusive|symbolic'):
        jpaddle.jit.save(_jax_bert(weights), str(tmp_path / 'j'),
                         input_spec=_spec(jpaddle, None))


def _op_counts(path):
    with open(path + '.pdmodel', 'rb') as f:
        ep = torch.export.load(f)
    names = [str(n.target) for n in ep.graph.nodes
             if n.op == 'call_function']
    return {k: names.count(k) for k in set(names)}


def test_the_exported_graph_launches_the_kernels_not_their_twins(
        weights, port_artifact, tmp_path, monkeypatch):
    counts = _op_counts(port_artifact)
    L = MODEL_KW['num_layers']
    ours = {k: v for k, v in counts.items() if k.startswith(OPS)}
    assert ours == {OPS + 'fused_layer_norm.default': LN_PER_FORWARD,
                    OPS + 'flash_attention_fwd.default': L}
    twins = [k for k in counts if 'softmax' in k or 'layer_norm' in k]
    assert twins == [OPS + 'fused_layer_norm.default']
    # fc + GELU by default (the reference's), and the MLM head's GELU
    assert counts['aten.gelu.default'] == L + 1
    # the masked encoder: + mask, then the softmax kernel in every layer
    enc = _port_bert(weights).bert
    path = str(tmp_path / 'masked')
    jit.save(enc, path, input_spec=[
        InputSpec([None, T], 'int64', 'input_ids'),
        InputSpec([None, T], 'int64', 'token_type_ids'),
        InputSpec([None, 1, 1, T], 'float32', 'attn_mask')])
    counts = _op_counts(path)
    assert {k: v for k, v in counts.items() if k.startswith(OPS)} == {
        OPS + 'fused_layer_norm.default': 1 + 2 * L,
        OPS + 'fused_softmax.default': L}
    assert not [k for k in counts if 'aten._softmax' in k]
    # USE_PALLAS_MLP: the GEMM+GELU kernel in every MLP
    monkeypatch.setattr(pfg, 'USE_PALLAS_MLP', True)
    path = str(tmp_path / 'gelu')
    jit.save(_port_bert(weights), path, input_spec=_spec(paddle, None))
    counts = _op_counts(path)
    assert counts[OPS + 'linear_gelu.default'] == L
    assert counts['aten.gelu.default'] == 1          # the MLM head's


def test_masked_artifact_matches_eager(weights, inputs, tmp_path):
    enc = _port_bert(weights).bert
    path = str(tmp_path / 'masked')
    jit.save(enc, path, input_spec=[
        InputSpec([None, T], 'int64', 'input_ids'),
        InputSpec([None, T], 'int64', 'token_type_ids'),
        InputSpec([None, 1, 1, T], 'float32', 'attn_mask')])
    loaded = jit.load(path, device='cpu')
    ids, types = (torch.from_numpy(a[:3]) for a in inputs)
    mask = torch.zeros(3, 1, 1, T)
    mask[1, ..., T // 2:] = -1e9
    with torch.no_grad():
        want = _np(enc(ids, types, mask))
    _close(_np(loaded(ids, types, mask)), want, 0)


def test_pdiparams_holds_the_references_state(weights, jax_artifact,
                                               port_artifact):
    with open(jax_artifact + '.pdiparams', 'rb') as f:
        ref = pickle.load(f)
    with open(port_artifact + '.pdiparams', 'rb') as f:
        got = pickle.load(f)
    for part in ('params', 'buffers'):
        r, g = ref['state'][part], got['state'][part]
        assert sorted(g) == sorted(r), part
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert [n for *_, n in got['spec']] == [n for *_, n in ref['spec']]
    # the declared int64; JAX without x64 narrows the reference's to int32
    assert [d for _, d, _ in got['spec']] == ['int64', 'int64']
    assert [d for _, d, _ in ref['spec']] == ['int32', 'int32']


def _vision_pair(name):
    from paddle_tpu.vision import models as jv
    from paddle_tpu_torch.convert import load_numpy_state
    from paddle_tpu_torch.vision import models as pv
    jpaddle.seed(1)
    kw = dict(num_classes=10)
    jm = getattr(jv, name)(**kw)
    params, buffers = jm.functional_state()
    rs = np.random.RandomState(2)
    buffers = {k: np.asarray(v) + (np.abs(rs.randn(*np.shape(v))) * 0.1)
               .astype(np.float32) for k, v in buffers.items()}
    jm.load_functional_state(params, {k: jnp.asarray(v)
                                      for k, v in buffers.items()})
    jm.eval()
    pm = getattr(pv, name)(device='cpu', **kw)
    load_numpy_state(pm, {**{k: np.asarray(v) for k, v in params.items()},
                          **buffers})
    return jm, pm.eval()


@pytest.mark.parametrize('name,shape', [('LeNet', (1, 28, 28)),
                                        ('resnet18', (3, 32, 32))])
def test_vision_artifacts_with_a_none_batch_match_the_reference(
        name, shape, tmp_path):
    jm, pm = _vision_pair(name)
    spec = [None, *shape]
    jpaddle.jit.save(jm, str(tmp_path / 'j'),
                     input_spec=[JSpec(spec, 'float32', 'image')])
    jit.save(pm, str(tmp_path / 'p'),
             input_spec=[InputSpec(spec, 'float32', 'image')])
    jl, pl = jpaddle.jit.load(str(tmp_path / 'j')), \
        jit.load(str(tmp_path / 'p'), device='cpu')
    rs = np.random.RandomState(4)
    for b in (1, 3, 5):
        x = rs.randn(b, *shape).astype(np.float32)
        want = np.asarray(jl(jpaddle.to_tensor(x)).numpy())
        got = pl(x).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))


_CHILD = r'''
import sys, numpy as np
from paddle_tpu_torch import inference
assert 'paddle_tpu_torch.models.bert' not in sys.modules
assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'paddle_tpu')]
cfg = inference.Config(sys.argv[1])
cfg.disable_gpu()
pred = inference.create_predictor(cfg)
print(pred.get_input_names())
ids, types = np.load(sys.argv[2]), np.load(sys.argv[3])
try:
    pred.run()
except KeyError as e:
    print('missing', e)
pred.get_input_handle('input_ids').copy_from_cpu(ids)
pred.get_input_handle('token_type_ids').copy_from_cpu(types)
pred.run()
outs = [pred.get_output_handle(n).copy_to_cpu()
        for n in pred.get_output_names()]
np.savez(sys.argv[4], *outs)
assert 'paddle_tpu_torch.models.bert' not in sys.modules
'''


def test_predictor_in_a_fresh_process_never_imports_the_model(
        weights, inputs, port_artifact, tmp_path):
    ids, types = (a[:3] for a in inputs)
    np.save(tmp_path / 'ids.npy', ids)
    np.save(tmp_path / 'types.npy', types)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, '-c', _CHILD, port_artifact,
         str(tmp_path / 'ids.npy'), str(tmp_path / 'types.npy'),
         str(tmp_path / 'out.npz')], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "['input_ids', 'token_type_ids']" in proc.stdout
    assert 'missing' in proc.stdout and 'were not fed' in proc.stdout
    got = np.load(tmp_path / 'out.npz')
    with torch.no_grad():
        want = _np(_port_bert(weights)(torch.from_numpy(ids),
                                       torch.from_numpy(types)))
    _close([got[f'arr_{i}'] for i in range(len(want))], want, 0)


def test_predictor_in_process_matches_the_references(
        weights, inputs, jax_artifact, port_artifact):
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference as pinf
    ids, types = (a[:B] for a in inputs)
    outs = []
    for inf, path in ((jinf, jax_artifact), (pinf, port_artifact)):
        cfg = inf.Config(path)
        cfg.disable_gpu()
        pred = inf.create_predictor(cfg)
        assert pred.get_input_names() == ['input_ids', 'token_type_ids']
        with pytest.raises(KeyError, match='were not fed'):
            pred.run()
        pred.get_input_handle('input_ids').copy_from_cpu(ids)
        pred.get_input_handle('token_type_ids').copy_from_cpu(types)
        pred.run()
        assert pred.get_output_names() == ['output_0', 'output_1']
        outs.append([pred.get_output_handle(n).copy_to_cpu()
                     for n in pred.get_output_names()])
        with pytest.raises(KeyError):
            pred.get_output_handle('output_9')
    _close(outs[1], outs[0])


@pytest.mark.parametrize('P', [jpaddle, paddle], ids=['jax', 'port'])
def test_save_error_paths_raise_in_both_packages(P, tmp_path):
    net = P.nn.Linear(4, 2)
    with pytest.raises(ValueError, match='requires input_spec'):
        P.jit.save(net, str(tmp_path / 'a'))
    with pytest.raises(ValueError, match='duplicate InputSpec names'):
        P.jit.save(net, str(tmp_path / 'b'), input_spec=[
            P.static.InputSpec([2, 4], 'float32', 'x'),
            P.static.InputSpec([2, 4], 'float32', 'x')])
    with pytest.raises(TypeError, match='Layer or StaticFunction'):
        P.jit.save(object(), str(tmp_path / 'c'))
    model = P.Model(net, inputs=[P.static.InputSpec([None, 4], 'float32',
                                                    'x')])
    with pytest.raises(ValueError, match='requires input_spec'):
        model.save(str(tmp_path / 'd'), training=False)


@pytest.mark.parametrize('P', [jpaddle, paddle], ids=['jax', 'port'])
def test_traced_layer_and_program_translator(P, tmp_path):
    P.seed(0)
    layer = P.nn.Linear(4, 3)
    x = P.ones([2, 4])
    out, traced = P.jit.TracedLayer.trace(layer, [x])
    out = _np([out.detach() if torch.is_tensor(out) else out])[0]
    got = traced([x])
    np.testing.assert_allclose(_np(got)[0], out, rtol=1e-6)
    path = str(tmp_path / 'm')
    traced.save_inference_model(path)
    loaded = P.jit.load(path) if P is jpaddle else P.jit.load(path,
                                                              device='cpu')
    np.testing.assert_allclose(_np([loaded(x)])[0], out, rtol=1e-5)
    pt = P.jit.ProgramTranslator.get_instance()
    assert pt is P.jit.ProgramTranslator.get_instance()
    calls = []

    def fn(v):
        calls.append(1)
        return v * 2.0
    sf = P.jit.to_static(fn)
    pt.enable(False)
    try:
        assert not pt.enable_to_static
        sf(x)
    finally:
        pt.enable(True)
    assert pt.enable_to_static and calls
    assert 'def fn' in pt.get_code(fn)
    P.jit.set_verbosity(0)
    P.jit.set_code_level(0)


def test_to_static_train_mode_updates_batch_norm_as_the_reference():
    rs = np.random.RandomState(0)
    x = (rs.randn(16, 4) * 3 + 5).astype(np.float32)
    jnet = jpaddle.nn.BatchNorm1D(4)
    pnet = paddle.nn.BatchNorm1D(4, device='cpu')
    jit.to_static(pnet)
    jpaddle.jit.to_static(jnet)
    m0 = pnet._mean.clone()
    got = pnet(torch.from_numpy(x))
    want = jnet(jpaddle.to_tensor(x))
    assert not torch.equal(m0, pnet._mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=0, atol=1e-5)
    for k in ('_mean', '_variance'):
        np.testing.assert_allclose(
            getattr(pnet, k).numpy(),
            np.asarray(getattr(jnet, k).value), rtol=0, atol=1e-5)
    assert not got.requires_grad          # under no_grad, as the reference


def test_to_static_signatures_and_keyword_calls():
    calls = []

    def fn(x, scale, flag=False):
        calls.append(1)
        return x * scale
    sf = jit.to_static(fn)
    assert sf.__name__ == 'fn'
    x = torch.ones(3)
    sf(x, 2.0)
    sf(x, 3.0)
    sf(torch.ones(4), 2.0)
    assert len(sf.modes()) == 3 and set(sf.modes().values()) == {'cpu'}
    assert sf(x, 2.0, flag=True).tolist() == [2.0] * 3   # eager, no entry
    assert len(sf.modes()) == 3
    with pytest.raises(NotImplementedError, match='item 11'):
        jit.to_static(fn, check='error')
