"""The port's high-level API (``hapi.Model``, its callbacks, ``summary``,
``flops``), ``framework.save``/``load``, ``static.InputSpec``,
``jit.functional_call`` and ``resilience.shutdown`` against the JAX
package's, on the CPU, on one LeNet whose weights both packages load
from the same numpy arrays (the JAX model's, seed 0).

Tolerances: losses within 1e-5 relative, parameters within 1e-4 of each
tensor's largest magnitude (f32, sums in another order); accuracies
within one sample; ``predict`` within 1e-5 of the largest output; the
port's fused and eager runs, a resumed step and the uninterrupted one
bit for bit; parameter counts, FLOP totals and summary rows exactly.
``examples/mnist_lenet.py``'s program runs as ``chip_smoke.mnist_lenet``
against both packages.
"""
import io as _io
import os
import re
import signal
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jpaddle
from paddle_tpu.hapi import callbacks as jcb
import paddle_tpu_torch as paddle
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.hapi import callbacks as pcb

LOSS_TOL, PARAM_TOL, PRED_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


@pytest.fixture(scope='module')
def lenet_state():
    jpaddle.seed(0)
    params, buffers = jpaddle.vision.models.LeNet().functional_state()
    return ({k: np.array(v) for k, v in params.items()},
            {k: np.array(v) for k, v in buffers.items()})


def _nets(state):
    jpaddle.seed(0)
    jnet = jpaddle.vision.models.LeNet()
    jnet.set_state_dict(state[0])
    pnet = load_numpy_state(paddle.vision.models.LeNet(device='cpu'),
                            *state)
    return jnet, pnet


def _prepare(pkg, net, lr=1e-3, metrics=True):
    model = pkg.Model(net)
    model.prepare(pkg.optimizer.Adam(learning_rate=lr,
                                     parameters=model.parameters()),
                  pkg.nn.CrossEntropyLoss(),
                  pkg.metric.Accuracy() if metrics else None)
    return model


def _models(state, **kw):
    jnet, pnet = _nets(state)
    return _prepare(jpaddle, jnet, **kw), _prepare(paddle, pnet, **kw)


def _batches(n, b=16, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, 1, 28, 28).astype(np.float32),
             rs.randint(0, 10, (b, 1)).astype(np.int64)) for _ in range(n)]


def _jparams(jmodel):
    jmodel._sync_back()
    return {k: np.array(v) for k, v in
            jmodel.network.functional_state()[0].items()}


def _pparams(pmodel):
    return {k: v.detach().numpy().copy() for k, v in
            pmodel.network.state_dict().items()}


def _params_close(p, j, tol=PARAM_TOL):
    assert sorted(p) == sorted(j)
    for k in j:
        scale = max(float(np.abs(j[k]).max()), 1e-12)
        err = float(np.abs(p[k] - j[k]).max()) / scale
        assert err <= tol, (k, err)


def _loss_close(p, j):
    p, j = float(p), float(j)
    assert abs(p - j) <= LOSS_TOL * max(abs(j), 1e-12), (p, j)


# -- Model -----------------------------------------------------------------
def test_three_train_batch_steps_match_the_jax_model(lenet_state):
    jm, pm = _models(lenet_state)
    for x, y in _batches(3):
        jl, jlog = jm.train_batch([x], [y])
        pl, plog = pm.train_batch([x], [y])
        _loss_close(pl, jl)
        assert torch.is_tensor(pl) and pl.dim() == 0
        assert [float(v) for v in plog] == [float(v) for v in jlog]
    _params_close(_pparams(pm), _jparams(jm))
    assert pm._optimizer._global_step == jm._optimizer._global_step == 3
    assert pm.device == torch.device('cpu')


class _Losses:
    """A callback of either package that keeps every step's loss."""

    def __new__(cls, cb):
        class Losses(cb.Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs['loss']))
        return Losses()


def _dataset(io, batches):
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    return io.TensorDataset([x, y])


def test_fit_one_epoch_and_evaluate_match(lenet_state):
    jm, pm = _models(lenet_state)
    batches = _batches(4)
    jl, pl = _Losses(jcb), _Losses(pcb)
    jm.fit(_dataset(jpaddle.io, batches), batch_size=16, epochs=1,
           shuffle=False, verbose=0, callbacks=[jl])
    pm.fit(_dataset(paddle.io, batches), batch_size=16, epochs=1,
           shuffle=False, verbose=0, callbacks=[pl])
    assert len(pl.losses) == len(jl.losses) == 4
    for p, j in zip(pl.losses, jl.losses):
        _loss_close(p, j)
    _params_close(_pparams(pm), _jparams(jm))
    evals = _batches(2, seed=5)
    je = jm.evaluate(_dataset(jpaddle.io, evals), batch_size=16, verbose=0)
    pe = pm.evaluate(_dataset(paddle.io, evals), batch_size=16, verbose=0)
    assert abs(pe['acc'] - je['acc']) <= 1 / 32
    _loss_close(pe['loss'], je['loss'])
    # predict on the trained weights
    x = evals[0][0]
    jp = jm.predict_batch([x])
    pp = pm.predict_batch([x])
    scale = float(np.abs(jp[0]).max())
    assert float(np.abs(pp[0] - np.asarray(jp[0])).max()) <= PRED_TOL * scale
    jo = jm.predict(_dataset(jpaddle.io, evals), batch_size=16,
                    stack_outputs=True)
    po = pm.predict(_dataset(paddle.io, evals), batch_size=16,
                    stack_outputs=True)
    assert po[0].shape == (32, 10)
    assert float(np.abs(po[0] - jo[0]).max()) <= PRED_TOL * scale


def test_mnist_lenet_program_matches_on_both_packages(lenet_state):
    """``examples/mnist_lenet.py``'s program, the smoke's own function,
    on both packages from the same weights: per-step losses and the
    evaluation."""
    jnet, pnet = _nets(lenet_state)
    jl, pl = _Losses(jcb), _Losses(pcb)
    kw = dict(epochs=1, batch_size=64, limit=256, shuffle=False,
              eval_split='train')
    _, jlogs = chip_smoke.mnist_lenet(jpaddle, network=jnet, callbacks=[jl],
                                      **kw)
    pmodel, plogs = chip_smoke.mnist_lenet(paddle, network=pnet,
                                           callbacks=[pl], **kw)
    assert len(pl.losses) == len(jl.losses) == 4
    for p, j in zip(pl.losses, jl.losses):
        _loss_close(p, j)
    assert abs(plogs['acc'] - jlogs['acc']) <= 1 / 256
    _loss_close(plogs['loss'], jlogs['loss'])
    assert pmodel.network is pnet


def test_fused_fit_equals_the_eager_fit_bit_for_bit(lenet_state):
    """``fit(fused_steps=2)`` over 5 batches: two chunks and a ragged
    step, against the eager fit: every loss, parameter, optimizer slot
    and metric log equal."""
    batches = _batches(5)
    runs = []
    for k in (None, 2):
        _, pnet = _nets(lenet_state)
        pm = _prepare(paddle, pnet)
        losses = chip_smoke.step_recorder(pm)
        logs = chip_smoke.metric_logs(paddle)
        pm.fit(_dataset(paddle.io, batches), batch_size=16, epochs=2,
               shuffle=False, verbose=0, fused_steps=k, callbacks=[logs])
        runs.append((torch.cat(losses), _pparams(pm),
                     pm._optimizer.state_dict(), logs.logs, pm))
    (le, pe, oe, ge, _), (lf, pf, of, gf, fm) = runs
    assert torch.equal(le, lf) and len(le) == 10
    assert all(np.array_equal(pe[k], pf[k]) for k in pe)
    assert sorted(oe) == sorted(of)
    for k in oe:
        assert (torch.equal(oe[k], of[k]) if torch.is_tensor(oe[k])
                else oe[k] == of[k]), k
    assert ge == gf
    assert fm.chunk_syncs == 4


def test_train_chunk_reads_one_lr_a_chunk_from_the_table(lenet_state):
    """A scheduler stepped between chunks (the LRScheduler callback on
    the host): each chunk's replays read the rate the host wrote into
    the table before it, never a rate baked in at the first chunk."""
    batches = _batches(4)
    outs = []
    for fused in (False, True):
        _, pnet = _nets(lenet_state)
        sched = paddle.optimizer.lr.StepDecay(1e-3, step_size=1, gamma=0.5)
        pm = paddle.Model(pnet)
        pm.prepare(paddle.optimizer.Adam(learning_rate=sched,
                                         parameters=pm.parameters()),
                   paddle.nn.CrossEntropyLoss())
        losses = []
        for c in range(2):
            chunk = batches[2 * c:2 * c + 2]
            if fused:
                xs = np.stack([b[0] for b in chunk])
                ys = np.stack([b[1] for b in chunk])
                losses.append(pm.train_chunk((xs, ys))[0])
            else:
                losses.append(torch.stack([pm.train_batch([x], [y])[0]
                                           for x, y in chunk]))
            sched.step()
        outs.append((torch.cat(losses), _pparams(pm)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(np.array_equal(outs[0][1][k], outs[1][1][k])
               for k in outs[0][1])


def _nan_batches():
    batches = _batches(4, seed=3)
    bad = batches[1][0].copy()
    bad[0, 0, 0, 0] = np.nan
    batches[1] = (bad, batches[1][1])
    return batches


@pytest.mark.parametrize('fused', [None, 2])
def test_a_nan_batch_is_skipped_alike(lenet_state, fused, capsys):
    """A NaN image in the second batch: both packages skip that update
    (parameters, moments and the step count stay), count one NanGuard
    strike and print the same message; the rest of the run matches."""
    jm, pm = _models(lenet_state)
    batches = _nan_batches()
    jg, pg = jcb.NanGuard(), pcb.NanGuard()
    jl, pl = _Losses(jcb), _Losses(pcb)
    jm.fit(_dataset(jpaddle.io, batches), batch_size=16, shuffle=False,
           verbose=0, callbacks=[jg, jl])
    jerr = capsys.readouterr().err
    pm.fit(_dataset(paddle.io, batches), batch_size=16, shuffle=False,
           verbose=0, callbacks=[pg, pl], fused_steps=fused)
    perr = capsys.readouterr().err
    assert pg.sentinel.total_skipped == jg.sentinel.total_skipped == 1
    assert pm._optimizer._global_step == jm._optimizer._global_step == 3
    if fused is None:
        assert perr == jerr and 'NanGuard' in perr
        assert np.isnan(pl.losses[1]) and np.isnan(jl.losses[1])
    _params_close(_pparams(pm), _jparams(jm))


def test_the_sync_free_path_skips_on_the_device(lenet_state):
    """``NanGuard(enable=False)``: no flag is read back a step, a NaN
    update is still dropped on the device, and the step count comes
    back exact at the end of the fit."""
    _, pnet = _nets(lenet_state)
    pm = _prepare(paddle, pnet)
    pm.fit(_dataset(paddle.io, _nan_batches()), batch_size=16,
           shuffle=False, verbose=0, callbacks=[pcb.NanGuard(enable=False)])
    assert pm._check_finite_steps is False
    assert pm._optimizer._global_step == 3
    jm, _ = _models(lenet_state)
    jm.fit(_dataset(jpaddle.io, _nan_batches()), batch_size=16,
           shuffle=False, verbose=0, callbacks=[jcb.NanGuard(enable=False)])
    _params_close(_pparams(pm), _jparams(jm))


def test_nan_guard_rolls_back_after_patience(lenet_state):
    """Three NaN steps in a row with patience 2: the second strike rolls
    parameters and moments back to the state captured at train begin,
    as the reference's does."""
    batches = _batches(4, seed=4)
    for i in (1, 2, 3):
        bad = batches[i][0].copy()
        bad[0, 0, 0, 0] = np.nan
        batches[i] = (bad, batches[i][1])
    jm, pm = _models(lenet_state)
    jg, pg = jcb.NanGuard(patience=2, verbose=0), \
        pcb.NanGuard(patience=2, verbose=0)
    jm.fit(_dataset(jpaddle.io, batches), batch_size=16, shuffle=False,
           verbose=0, callbacks=[jg])
    pm.fit(_dataset(paddle.io, batches), batch_size=16, shuffle=False,
           verbose=0, callbacks=[pg])
    assert pg.sentinel.rollbacks == jg.sentinel.rollbacks == 1
    assert pm._optimizer._global_step == jm._optimizer._global_step
    _params_close(_pparams(pm), _jparams(jm))


# -- persistence -----------------------------------------------------------
def test_checkpoints_load_across_packages_both_ways(lenet_state, tmp_path):
    """A ``.pdparams``/``.pdopt`` pair written by either package loads in
    the other: the resumed next step's loss matches the writer's, and so
    do the parameters after it, which the loaded Adam moments and step
    count decide (the same load with ``reset_optimizer=True``, fresh
    moments, lands elsewhere)."""
    batches = _batches(4, seed=6)
    for writer, reader in (('jax', 'port'), ('port', 'jax')):
        pkgs = {'jax': jpaddle, 'port': paddle}
        nets = dict(zip(('jax', 'port'), _nets(lenet_state)))
        wm = _prepare(pkgs[writer], nets[writer])
        for x, y in batches[:3]:
            wm.train_batch([x], [y])
        path = str(tmp_path / writer / 'ckpt')
        wm.save(path)
        assert os.path.exists(path + '.pdparams') and \
            os.path.exists(path + '.pdopt')
        rm = _prepare(pkgs[reader], _nets(lenet_state)[
            0 if reader == 'jax' else 1]).load(path)
        fresh = _prepare(pkgs[reader], _nets(lenet_state)[
            0 if reader == 'jax' else 1]).load(path, reset_optimizer=True)
        assert rm._optimizer._global_step == 3
        x, y = batches[3]
        lw = wm.train_batch([x], [y])[0]
        _loss_close(rm.train_batch([x], [y])[0], lw)
        fresh.train_batch([x], [y])
        params = {'jax': _jparams, 'port': _pparams}
        pw = params[writer](wm)
        _params_close(params[reader](rm), pw)
        fp = params[reader](fresh)
        gap = max(float(np.abs(fp[k] - pw[k]).max()) /
                  float(np.abs(pw[k]).max()) for k in pw)
        assert gap > 10 * PARAM_TOL, 'fresh moments would have matched'


def test_save_then_load_resumes_bit_for_bit(lenet_state, tmp_path):
    batches = _batches(4, seed=7)
    _, pnet = _nets(lenet_state)
    a = _prepare(paddle, pnet)
    for x, y in batches[:3]:
        a.train_batch([x], [y])
    a.save(str(tmp_path / 'm'))
    b = _prepare(paddle, _nets(lenet_state)[1]).load(str(tmp_path / 'm'))
    x, y = batches[3]
    assert torch.equal(a.train_batch([x], [y])[0], b.train_batch([x], [y])[0])
    pa, pb = _pparams(a), _pparams(b)
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    with pytest.raises(ValueError, match='requires input_spec'):
        a.save(str(tmp_path / 'inf'), training=False)


def test_framework_save_load_round_trip_across_packages(tmp_path):
    obj = {'w': torch.arange(6, dtype=torch.float32).reshape(2, 3),
           'n': 3, 'nested': [torch.ones(2, dtype=torch.int64), 'x']}
    paddle.save(obj, str(tmp_path / 'a' / 'obj.pdparams'))
    got = jpaddle.load(str(tmp_path / 'a' / 'obj.pdparams'))
    np.testing.assert_array_equal(got['w'], obj['w'].numpy())
    assert got['n'] == 3 and got['nested'][1] == 'x'
    jpaddle.save({'w': jpaddle.to_tensor(np.ones(3, np.float32))},
                 str(tmp_path / 'b.pdparams'))
    back = paddle.load(str(tmp_path / 'b.pdparams'))
    assert isinstance(back['w'], np.ndarray)
    np.testing.assert_array_equal(back['w'], np.ones(3, np.float32))


# -- callbacks --------------------------------------------------------------
def _strip_times(text):
    return re.sub(r'done in [0-9.]+s', 'done in Ts', text)


def test_progbar_logger_prints_the_references_lines(lenet_state):
    batches = _batches(4)
    out = {}
    for name, pkg, model in zip(('jax', 'port'), (jpaddle, paddle),
                                _models(lenet_state)):
        buf = _io.StringIO()
        with redirect_stdout(buf):
            model.fit(_dataset(pkg.io, batches), batch_size=16, epochs=2,
                      shuffle=False, verbose=2, log_freq=2)
        out[name] = _strip_times(buf.getvalue()).splitlines()
    assert len(out['port']) == len(out['jax']) > 4
    for p, j in zip(out['port'], out['jax']):
        # the same line; its numbers within the loss tolerance
        pn = [float(v) for v in re.findall(r'-?\d+\.\d+', p)]
        jn = [float(v) for v in re.findall(r'-?\d+\.\d+', j)]
        assert re.sub(r'-?\d+\.\d+', 'N', p) == re.sub(r'-?\d+\.\d+', 'N', j)
        assert all(abs(a - b) <= 2e-4 for a, b in zip(pn, jn)), (p, j)


def test_checkpoint_scheduler_and_plateau_callbacks(lenet_state, tmp_path):
    """ModelCheckpoint writes each epoch's and the final pair; the
    LRScheduler callback steps the scheduler a batch; ReduceLROnPlateau
    and EarlyStopping act on the eval loss; all as the reference."""
    batches, evals = _batches(2), _batches(1, seed=9)
    state = {}
    for name, pkg, cb in (('jax', jpaddle, jcb), ('port', paddle, pcb)):
        jnet, pnet = _nets(lenet_state)
        net = jnet if name == 'jax' else pnet
        sched = pkg.optimizer.lr.StepDecay(1e-3, step_size=1, gamma=0.9)
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.Adam(learning_rate=sched,
                                         parameters=model.parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        d = tmp_path / name
        early = cb.EarlyStopping(monitor='loss', patience=1, verbose=0,
                                 min_delta=10.0, save_best_model=False)
        model.fit(_dataset(pkg.io, batches),
                  eval_data=_dataset(pkg.io, evals), batch_size=16,
                  epochs=4, shuffle=False, verbose=0, save_dir=str(d),
                  callbacks=[early, cb.LRScheduler(by_step=True)])
        state[name] = (sorted(os.listdir(d)), sched.last_epoch,
                       model.stop_training, early.wait, early.stopped_epoch)
        # ReduceLROnPlateau on a fixed-rate optimizer
        plateau = cb.ReduceLROnPlateau(patience=1, factor=0.5, verbose=0,
                                       min_delta=10.0)
        model2 = _prepare(pkg, _nets(lenet_state)[0 if name == 'jax'
                                                  else 1])
        model2.fit(_dataset(pkg.io, batches),
                   eval_data=_dataset(pkg.io, evals), batch_size=16,
                   epochs=3, shuffle=False, verbose=0, callbacks=[plateau])
        state[name] += (model2._optimizer.get_lr(),)
    assert state['port'] == state['jax']
    assert 'final.pdparams' in state['port'][0]


def test_visualdl_writes_the_references_records(lenet_state, tmp_path):
    batches = _batches(3)
    recs = {}
    for name, pkg, cb, model in zip(('jax', 'port'), (jpaddle, paddle),
                                    (jcb, pcb), _models(lenet_state)):
        vdl = cb.VisualDL(log_dir=str(tmp_path / name), log_freq=2)
        model.fit(_dataset(pkg.io, batches), batch_size=16, shuffle=False,
                  verbose=0, callbacks=[vdl])
        lines = (tmp_path / name / 'events.jsonl').read_text().splitlines()
        recs[name] = lines
    import json
    port = [json.loads(x) for x in recs['port']]
    ref = [json.loads(x) for x in recs['jax']]
    assert len(port) == len(ref) == 3
    for p, j in zip(port, ref):
        assert sorted(p) == sorted(j)
        for k in j:
            if k == 'loss':
                _loss_close(p[k], j[k])
            elif k != 'ts':             # the wall clock
                assert p[k] == j[k], k


def test_prepare_lint_and_the_jit_surface_raise_naming_the_queue():
    with pytest.raises(NotImplementedError, match='item 11'):
        paddle.Model(paddle.vision.models.LeNet(device='cpu')).prepare(
            lint='warn')
    with pytest.raises(NotImplementedError, match='item 11'):
        paddle.jit.to_static(lambda x: x, check='warn')
    with pytest.raises(ValueError, match='requires input_spec'):
        paddle.jit.save(paddle.vision.models.LeNet(device='cpu'), 'unused')
    with pytest.raises(TypeError, match='Layer or StaticFunction'):
        paddle.jit.save(None, 'unused')


# -- the pieces under Model -----------------------------------------------------
def test_input_spec_matches_the_reference():
    from paddle_tpu.static import InputSpec as J
    from paddle_tpu_torch.static import InputSpec as P
    j, p = J([None, 1, 28, 28], 'float32', 'x'), P([None, 1, 28, 28],
                                                  'float32', 'x')
    assert (p.shape, p.dtype, p.name) == (j.shape, j.dtype, j.name)
    assert repr(p) == repr(j)
    assert p.batch(4).shape == j.batch(4).shape
    assert p.unbatch().shape == j.unbatch().shape
    assert p.numpy_dtype() == j.numpy_dtype() == np.float32
    a = np.zeros((2, 3), np.int64)
    assert repr(P.from_numpy(a, 'a')) == repr(J.from_numpy(a, 'a'))
    assert P.from_tensor(torch.zeros(2, 3)).shape == (2, 3)
    model = paddle.Model(paddle.vision.models.LeNet(device='cpu'),
                         inputs=[p], labels=[P([None, 1], 'int64', 'y')])
    assert model._split_arity(2) == 1


def test_functional_call_returns_outputs_and_new_buffers():
    """``jit.functional_call`` on a BatchNorm net in train mode: the
    reference's outputs and updated running statistics, the layer's own
    tensors untouched, and gradients reaching the given parameters."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3, 5, 5).astype(np.float32)
    jpaddle.seed(0)
    jnet = jpaddle.nn.Sequential(jpaddle.nn.Conv2D(3, 4, 3),
                                 jpaddle.nn.BatchNorm2D(4))
    params, buffers = jnet.functional_state()
    params = {k: np.array(v) for k, v in params.items()}
    buffers = {k: np.array(v) for k, v in buffers.items()}
    pnet = paddle.nn.Sequential(paddle.nn.Conv2D(3, 4, 3),
                                paddle.nn.BatchNorm2D(4))
    load_numpy_state(pnet, params, buffers)
    jout, jbuf = jpaddle.jit.functional_call(
        jnet, {k: jpaddle.to_tensor(v).value for k, v in params.items()},
        {k: jpaddle.to_tensor(v).value for k, v in buffers.items()},
        [jpaddle.to_tensor(x)], training=True)
    pp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in buffers.items()}
    before = {k: v.clone() for k, v in pnet.state_dict().items()}
    pout, pbuf = paddle.jit.functional_call(pnet, pp, pb,
                                            [torch.from_numpy(x)],
                                            training=True)
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=2e-5)
    assert sorted(pbuf) == sorted(jbuf)
    for k in jbuf:
        np.testing.assert_allclose(pbuf[k].numpy(), np.asarray(jbuf[k]),
                                   rtol=0, atol=2e-6)
        np.testing.assert_array_equal(pb[k].numpy(), buffers[k])
    assert all(torch.equal(before[k], v) for k, v in
               pnet.state_dict().items())
    pout.sum().backward()
    assert all(v.grad is not None for v in pp.values())


# -- shutdown ------------------------------------------------------------------
def test_graceful_shutdown_latches_as_the_reference():
    from paddle_tpu.resilience import shutdown as jsd
    from paddle_tpu_torch.resilience import shutdown as psd
    assert psd.PREEMPTED_EXIT_CODE == jsd.PREEMPTED_EXIT_CODE
    gs = psd.GracefulShutdown(signals=(signal.SIGUSR1,)).install()
    try:
        assert not gs.requested()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert gs.requested() and gs.signum == signal.SIGUSR1
        gs.clear()
        gs.request()
        assert gs.requested() and gs.signum is None
        with pytest.raises(SystemExit) as e:
            gs.exit()
        assert e.value.code == psd.PREEMPTED_EXIT_CODE
    finally:
        gs.uninstall()
    assert psd.shutdown_requested() in (False, True)


def test_a_preemption_request_stops_fit_at_the_step_and_exits(lenet_state,
                                                              tmp_path):
    """A programmatic request during fit: training stops at that step
    boundary, the final checkpoint lands, and fit exits with the
    preempted code; as the reference's fit does."""
    from paddle_tpu_torch.resilience import shutdown as psd
    _, pnet = _nets(lenet_state)
    pm = _prepare(paddle, pnet)

    class Preempt(pcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 1:
                psd.install_shutdown().request(signal.SIGTERM)
    try:
        with pytest.raises(SystemExit) as e:
            pm.fit(_dataset(paddle.io, _batches(4)), batch_size=16,
                   shuffle=False, verbose=0, save_dir=str(tmp_path),
                   callbacks=[Preempt()])
        assert e.value.code == psd.PREEMPTED_EXIT_CODE
        assert pm._optimizer._global_step == 2
        assert (tmp_path / 'final.pdparams').exists()
    finally:
        psd.clear_shutdown()
        psd.uninstall_shutdown()


def test_the_top_level_carries_the_references_high_level_names():
    for name in ('Model', 'summary', 'flops', 'save', 'load', 'io',
                 'metric', 'hapi', 'jit', 'static', 'vision', 'callbacks',
                 'framework'):
        assert hasattr(jpaddle, name) and hasattr(paddle, name), name
    for mod in ('callbacks', 'hapi', 'metric', 'io'):
        assert sorted(getattr(paddle, mod).__all__) == \
            sorted(getattr(jpaddle, mod).__all__), mod
    assert sorted(pcb.__all__) == sorted(jcb.__all__)
    assert paddle.vision.datasets.__all__ == \
        jpaddle.vision.datasets.__all__


def test_fit_profile_window_and_step_telemetry(lenet_state, tmp_path):
    """``fit(profile=)`` goes to ``telemetry.step_profiler``: the window
    on steps 2-3 (the second chunk when fused: a window opens at a
    chunk's boundary) closes into one ``profile_capture`` event naming
    them, and with telemetry enabled the loop's step accumulator
    flushes, eagerly and in fused chunks."""
    from paddle_tpu_torch import telemetry
    telemetry.enable(str(tmp_path / 'tel'))
    try:
        for k in (None, 2):
            _, pnet = _nets(lenet_state)
            pm = _prepare(paddle, pnet)
            run = str(tmp_path / f'run{k}')
            pm.fit(_dataset(paddle.io, _batches(4)), batch_size=16,
                   shuffle=False, verbose=0, fused_steps=k,
                   profile='start=2,steps=2,limit=1', save_dir=run)
            # the recorder is a bounded ring that other tests fill: find
            # this fit's windows by their directory
            caps = [e for e in telemetry.events('profile_capture')
                    if e['dir'].startswith(run)]
            assert len(caps) == 1, caps
            assert (caps[0]['step_lo'], caps[0]['step_hi']) == (2, 3)
            assert 'error' not in caps[0], caps
        assert len(telemetry.events('steps')) >= 2
    finally:
        telemetry.disable()
