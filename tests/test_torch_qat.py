"""The port's QAT and calibrated PTQ against the JAX package's, on the CPU.

``fake_quant`` and ``FakeQuantAbsMax`` (per tensor and per channel) are
held to the JAX package bit for bit, forward and straight-through
gradient, in f32 and bf16; the moving-average scale over 3 training
calls and its freeze in eval bit for bit; ``ImperativeQuantAware`` on
LeNet and on a Linear MLP: the same ``state_dict`` keys, and 3 QAT
steps of Adam (the MLP by hand, LeNet through ``ParallelTrainer``)
within 1e-4 of the JAX package's eager steps, losses, parameters and
activation scales (f32, sums in another order); the ``.quant``
artifacts of both packages equal key by key (int8 weights, scales and
qmax exactly, activation scales within 1e-6: the second layer's input
comes out of an f32 product) and each loads into the other package to
the same dequantized weights; ``PostTrainingQuantization`` the same;
``load_quantized_model``'s errors; the dynamic swap leaves QAT layers
alone.  Every parity input comes from numpy seeds, none from either
package's random draws.  The reference's own cases
(``tests/test_quantization.py``) run as port cases.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as JQ
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.vision.models import LeNet as JaxLeNet
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import ParallelTrainer
from paddle_tpu_torch.vision.models import LeNet

Q = importlib.import_module('paddle_tpu_torch.quantization')

TOL, SCALE_TOL = 1e-4, 1e-6


def _np(v):
    v = getattr(v, 'value', v)
    if torch.is_tensor(v):
        return v.detach().float().numpy()
    return np.asarray(v).astype(np.float32)


def _jt(a, dtype=None):
    t = paddle.to_tensor(a)
    return t.astype(dtype) if dtype else t


def _pt(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if dtype else t


# -- fake quant ---------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bits', [8, 4])
def test_fake_quant_forward_bits_and_ste_gradient_match_jax(dtype, bits):
    rs = np.random.RandomState(bits)
    x = (2.0 * rs.randn(6, 7)).astype(np.float32)
    g = rs.randn(6, 7).astype(np.float32)
    scale = np.float32(1.5)         # some |x| beyond it: clipped, no grad
    jx = _jt(x, dtype)
    jx.stop_gradient = False
    jy = JQ.fake_quant(jx, _jt(scale, dtype), bits=bits)
    (jy * _jt(g, dtype)).sum().backward()
    px = _pt(x, dtype).requires_grad_()
    py = Q.fake_quant(px, _pt(scale, dtype), bits=bits)
    (py * _pt(g, dtype)).sum().backward()
    assert py.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(py), _np(jy))
    np.testing.assert_array_equal(_np(px.grad), _np(jx.grad))
    assert (_np(px.grad) == 0).any() and (_np(px.grad) != 0).any()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('channel_wise,axis', [(False, 0), (True, 0),
                                               (True, 1)])
def test_fake_quant_abs_max_matches_jax(dtype, channel_wise, axis):
    rs = np.random.RandomState(axis)
    w = rs.randn(5, 4, 3).astype(np.float32)
    w[:, 1] *= 0.01                 # a small channel keeps its resolution
    g = rs.randn(5, 4, 3).astype(np.float32)
    jw = _jt(w, dtype)
    jw.stop_gradient = False
    jy = JQ.FakeQuantAbsMax(channel_wise=channel_wise, axis=axis)(jw)
    (jy * _jt(g, dtype)).sum().backward()
    pw = _pt(w, dtype).requires_grad_()
    py = Q.FakeQuantAbsMax(channel_wise=channel_wise, axis=axis)(pw)
    (py * _pt(g, dtype)).sum().backward()
    np.testing.assert_array_equal(_np(py), _np(jy))
    np.testing.assert_array_equal(_np(pw.grad), _np(jw.grad))


@pytest.mark.parametrize('o2', [False, True])
def test_moving_average_scale_matches_jax_and_freezes_in_eval(o2):
    rs = np.random.RandomState(5)
    xs = [(k * rs.randn(4, 8)).astype(np.float32) for k in (1, 3, 0.5, 9)]
    jfq = JQ.FakeQuantMovingAverageAbsMax(moving_rate=0.9)
    pfq = Q.FakeQuantMovingAverageAbsMax(moving_rate=0.9, device='cpu')
    jcast = paddle.amp.auto_cast(enable=o2, level='O2')
    pcast = amp.auto_cast(enable=o2, level='O2')
    with jcast, pcast:
        for x in xs[:3]:
            jy, py = jfq(_jt(x)), pfq(_pt(x))
            np.testing.assert_array_equal(_np(pfq.scale), _np(jfq.scale))
            np.testing.assert_array_equal(_np(py), _np(jy))
        assert pfq.scale.dtype == torch.float32 and pfq.scale.shape == (1,)
        frozen = pfq.scale.clone()
        jfq.eval()
        pfq.eval()
        jy, py = jfq(_jt(xs[3])), pfq(_pt(xs[3]))
    assert torch.equal(pfq.scale, frozen)
    np.testing.assert_array_equal(_np(py), _np(jy))
    assert py.dtype == (torch.bfloat16 if o2 else torch.float32)


def test_round_trip_quantizes_to_grid():
    out = Q.fake_quant(torch.tensor([0.1, -0.5, 0.9]), torch.tensor(1.0))
    np.testing.assert_allclose(out * 127, torch.round(out * 127), atol=1e-5)
    np.testing.assert_allclose(out, [0.1, -0.5, 0.9], atol=1 / 127)


def test_ste_gradient():
    x = torch.tensor([0.5, 2.0], requires_grad=True)
    Q.fake_quant(x, torch.tensor(1.0)).sum().backward()
    np.testing.assert_allclose(x.grad, [1.0, 0.0])


def test_channel_wise_abs_max():
    fq = Q.FakeQuantAbsMax(bits=8, channel_wise=True, axis=1)
    w = torch.tensor([[1.0, 100.0], [-2.0, 50.0]])
    np.testing.assert_allclose(fq(w), w, rtol=1e-2)


# -- QAT ----------------------------------------------------------------------

def _mlp_pair(sizes=(8, 16, 1), seed=0):
    """The same numpy weights in a JAX and a port ``Linear-ReLU-Linear``."""
    rs = np.random.RandomState(seed)
    jm = jnn.Sequential(jnn.Linear(sizes[0], sizes[1]), jnn.ReLU(),
                        jnn.Linear(sizes[1], sizes[2]))
    pm = nn.Sequential(nn.Linear(sizes[0], sizes[1], device='cpu'),
                       nn.ReLU(),
                       nn.Linear(sizes[1], sizes[2], device='cpu'))
    host = {n: (0.5 * rs.randn(*p.shape)).astype(np.float32)
            for n, p in pm.named_parameters()}
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in host.items()})
    return jm, pm


def _lenet_pair():
    rs = np.random.RandomState(1)
    pm = LeNet(device='cpu')
    host = {n: (0.2 * rs.randn(*p.shape)).astype(np.float32)
            for n, p in pm.named_parameters()}
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in host.items()})
    paddle.seed(0)
    jm = JaxLeNet()
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    return jm, pm


def _quantize_both(jm, pm, **kw):
    JQ.ImperativeQuantAware(**kw).quantize(jm)
    Q.ImperativeQuantAware(**kw).quantize(pm)
    jkeys = set(jm.state_dict())
    assert set(pm.state_dict()) == jkeys
    return jkeys


def _state_close(jm, pm, tol):
    jstate = {k: _np(v) for k, v in jm.state_dict().items()}
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(_np(v), jstate[k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_qat_mlp_keys_and_three_adam_steps_match_jax():
    jm, pm = _mlp_pair()
    keys = _quantize_both(jm, pm)
    assert {'0.inner.weight', '0.inner.bias', '0.act_fq.scale',
            '2.inner.weight', '2.act_fq.scale'} <= keys
    assert [type(m).__name__ for m in pm] == ['QuantedLayer', 'ReLU',
                                              'QuantedLayer']
    rs = np.random.RandomState(2)
    x = rs.randn(16, 8).astype(np.float32)
    y = (x @ np.arange(8, dtype=np.float32))[:, None]
    jopt = JaxAdam(0.05, parameters=jm.parameters())
    popt = Adam(0.05, parameters=pm.parameters())
    for _ in range(3):
        jloss = paddle.mean((jm(_jt(x)) - _jt(y)) ** 2)
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        ploss = ((pm(_pt(x)) - _pt(y)) ** 2).mean()
        ploss.backward()
        popt.step()
        popt.clear_grad()
        np.testing.assert_allclose(float(ploss), float(_np(jloss)),
                                   rtol=TOL, atol=TOL)
    _state_close(jm, pm, TOL)


def test_qat_lenet_keys_and_three_trainer_steps_match_jax():
    jm, pm = _lenet_pair()
    keys = _quantize_both(jm, pm)
    assert sum(k.endswith('act_fq.scale') for k in keys) == 5
    rs = np.random.RandomState(3)
    x = rs.randn(8, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (8, 1)).astype(np.int64)
    jce = jnn.CrossEntropyLoss()
    jopt = JaxAdam(1e-3, parameters=jm.parameters())
    ce = nn.CrossEntropyLoss()
    tr = ParallelTrainer(pm, Adam(1e-3, parameters=pm.parameters()),
                         lambda out, lab: ce(out, lab))
    for _ in range(3):
        jm.train()
        jloss = jce(jm(_jt(x)), _jt(y))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        ploss = tr.loss_float(tr.step(x, y))
        np.testing.assert_allclose(ploss, float(_np(jloss)), rtol=TOL,
                                   atol=TOL)
    _state_close(jm, pm, TOL)


def test_qat_trains():
    _, m = _mlp_pair()
    Q.ImperativeQuantAware().quantize(m)
    opt = Adam(0.05, parameters=m.parameters())
    rs = np.random.RandomState(0)
    X = torch.from_numpy(rs.randn(64, 8).astype(np.float32))
    Y = (X @ torch.arange(8, dtype=torch.float32))[:, None]
    losses = []
    for _ in range(40):
        loss = ((m(X) - Y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, losses


def test_bf16_o2_qat_step_trains_the_f32_master():
    _, pm = _mlp_pair()
    Q.ImperativeQuantAware().quantize(pm)
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs['use_pure_fp16'] = True
    tr = ParallelTrainer(pm, Adam(0.05, parameters=pm.parameters()),
                         lambda out, y: ((out.float() - y) ** 2).mean(),
                         strategy=st)
    x = np.random.RandomState(4).randn(16, 8).astype(np.float32)
    y = x[:, :1].copy()
    losses = [tr.loss_float(tr.step(x, y)) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert float(pm[0].act_fq.scale) > 0


def _artifact_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        assert np.shape(got[k]) == np.shape(v), k
        if k.endswith('.act_scale'):
            np.testing.assert_allclose(got[k], v, rtol=SCALE_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize('kw', [{}, dict(
    weight_quantize_type='channel_wise_abs_max'), dict(weight_bits=4)],
    ids=['abs_max', 'channel_wise', 'bits4'])
def test_artifacts_match_and_load_across_packages(kw, tmp_path):
    jm, pm = _mlp_pair((6, 6, 2), seed=3)
    _quantize_both(jm, pm, **kw)
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    jm(_jt(x))
    pm(_pt(x))
    jstate = JQ.ImperativeQuantAware(**kw).save_quantized_model(
        jm, str(tmp_path / 'jax'))
    pstate = Q.ImperativeQuantAware(**kw).save_quantized_model(
        pm, str(tmp_path / 'port'))
    _artifact_equal(pstate, jstate)
    # each package's artifact into the other's fresh QAT model
    jm2, pm2 = _mlp_pair((6, 6, 2), seed=9)
    _quantize_both(jm2, pm2, **kw)
    Q.load_quantized_model(pm2, str(tmp_path / 'jax'))
    JQ.load_quantized_model(jm2, str(tmp_path / 'port'))
    for name in ('0', '2'):
        w = _np(pm2.get_submodule(name).inner.weight)
        np.testing.assert_array_equal(
            w, _np(dict(jm2.named_sublayers())[name].inner.weight))
        q, s = jstate[f'{name}.qweight'], jstate[f'{name}.scale']
        qmax = float(jstate[f'{name}.qmax'])
        np.testing.assert_array_equal(
            w, np.asarray(q, np.float32) * np.asarray(s, np.float32) / qmax)
        # the deployed grid is the one QAT simulated: bit for bit
        saved = pm.get_submodule(name)
        np.testing.assert_array_equal(
            w, _np(saved.weight_fq(saved.inner.weight)))


def test_post_training_quantization_matches_jax(tmp_path):
    jm, pm = _mlp_pair((4, 8, 2), seed=1)
    rs = np.random.RandomState(1)
    loader = [(rs.randn(8, 4).astype(np.float32),) for _ in range(5)]
    jptq = JQ.PostTrainingQuantization(jm, data_loader=loader, batch_nums=3)
    pptq = Q.PostTrainingQuantization(pm, data_loader=loader, batch_nums=3)
    jstate = jptq.save_quantized_model(str(tmp_path / 'jax'))
    pstate = pptq.save_quantized_model(str(tmp_path / 'port'))
    _artifact_equal(pstate, jstate)
    assert len([k for k in pstate if k.endswith('.act_scale')]) == 2
    # the first layer sees the batches themselves: its scale exactly
    assert pstate['0.act_scale'] == np.float32(
        max(np.abs(b[0]).max() for b in loader[:3]))
    # a list of bare arrays and of tensors calibrates the same
    again = Q.PostTrainingQuantization(
        pm, data_loader=[torch.from_numpy(b[0]) for b in loader],
        batch_nums=3).quantize()
    _artifact_equal(again, pstate)
    assert Q.quant_post_dynamic(pm).keys() == JQ.quant_post_dynamic(jm).keys()


def test_load_quantized_model_errors_match_jax(tmp_path):
    import pickle
    ghost = str(tmp_path / 'ghost')
    with open(ghost + '.quant', 'wb') as f:
        pickle.dump({'ghost.qweight': np.zeros((2, 2), np.int8),
                     'ghost.scale': np.float32(1.0)}, f)
    empty = str(tmp_path / 'empty')
    with open(empty + '.quant', 'wb') as f:
        pickle.dump({'0.act_scale': np.float32(1.0)}, f)
    noscale = str(tmp_path / 'noscale')
    with open(noscale + '.quant', 'wb') as f:
        pickle.dump({'0.qweight': np.zeros((2, 2), np.int8)}, f)
    for path, err in ((ghost, KeyError), (empty, ValueError),
                      (noscale, KeyError)):
        with pytest.raises(err):
            JQ.load_quantized_model(jnn.Sequential(jnn.Linear(2, 2)), path)
        with pytest.raises(err):
            Q.load_quantized_model(
                nn.Sequential(nn.Linear(2, 2, device='cpu')), path)


def test_dynamic_ptq_skips_qat_layers_as_the_reference():
    jm, pm = _mlp_pair()
    _quantize_both(jm, pm)
    for m, q in ((jm, JQ), (pm, Q)):
        with pytest.raises(ValueError, match='no quantizable'):
            q.quantize_dynamic_int8(m)
    # one plain Linear left beside a QuantedLayer: only it is swapped
    jm._sub_layers['2'] = jm._sub_layers['2'].inner
    pm._modules['2'] = pm[2].inner
    JQ.quantize_dynamic_int8(jm)
    Q.quantize_dynamic_int8(pm)
    assert [type(m).__name__ for m in pm] == \
        [type(m).__name__ for m in jm._sub_layers.values()] == \
        ['QuantedLayer', 'ReLU', 'Int8DynamicLinear']


def test_save_quantized_model(tmp_path):
    import pickle
    _, m = _mlp_pair()
    qat = Q.ImperativeQuantAware()
    qat.quantize(m)
    m(torch.from_numpy(np.random.RandomState(0).randn(2, 8)
                       .astype(np.float32)))
    path = str(tmp_path / 'model')
    qat.save_quantized_model(m, path)
    with open(path + '.quant', 'rb') as f:
        loaded = pickle.load(f)
    qweights = [k for k in loaded if k.endswith('.qweight')]
    assert len(qweights) == 2
    for k in qweights:
        assert loaded[k].dtype == np.int8
        name = k[:-len('.qweight')]
        scale = loaded[name + '.scale']
        w = _np(m.get_submodule(name).inner.weight)
        np.testing.assert_allclose(loaded[k].astype(np.float32) * scale / 127,
                                   w, atol=scale / 100)


def test_roundtrip_load_and_per_channel_accuracy(tmp_path):
    _, m = _mlp_pair((6, 4, 2), seed=8)
    qat = Q.ImperativeQuantAware(weight_quantize_type='channel_wise_abs_max')
    qat.quantize(m)
    with torch.no_grad():
        m[0].inner.weight[:, 1] *= 0.01
        m[0].inner.weight[:, 0] *= 100.0
    path = str(tmp_path / 'm')
    state = qat.save_quantized_model(m, path)
    assert state['0.scale'].shape == (1, 4)       # Linear: channel axis 1
    _, m2 = _mlp_pair((6, 4, 2), seed=99)
    Q.ImperativeQuantAware(
        weight_quantize_type='channel_wise_abs_max').quantize(m2)
    Q.load_quantized_model(m2, path)
    w, w2 = _np(m[0].inner.weight), _np(m2[0].inner.weight)
    for c in range(4):
        assert np.abs(w[:, c] - w2[:, c]).max() <= np.abs(w[:, c]).max() / 127


def test_low_bit_artifact_matches_training_grid(tmp_path):
    _, m = _mlp_pair((4, 3, 1), seed=9)
    qat = Q.ImperativeQuantAware(weight_bits=4)
    qat.quantize(m)
    state = qat.save_quantized_model(m, str(tmp_path / 'm4'))
    assert np.abs(state['0.qweight']).max() <= 7
    assert float(state['0.qmax']) == 7.0
    with pytest.raises(ValueError, match='16-bit'):
        Q.ImperativeQuantAware(weight_bits=16).save_quantized_model(
            Q.ImperativeQuantAware(weight_bits=16).quantize(
                _mlp_pair()[1]), str(tmp_path / 'm16'))
