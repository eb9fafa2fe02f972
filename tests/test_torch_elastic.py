"""Elastic supervision, the launcher and auto-checkpoint in the port
(``paddle_tpu_torch.distributed.elastic``, ``.launch``,
``paddle_tpu_torch.incubate.checkpoint.auto_checkpoint``): the
reference's ``tests/test_elastic.py`` and ``TestPreemption`` cases, with
``tests/torch_elastic_worker.py`` (imports the port, never ``jax``) as
the worker.

A worker SIGKILLed mid-training, and one preempted by SIGTERM (a free
restart with a zero failure budget), finish with the state of an
uninterrupted run of the same code, bit for bit, and with the same
weights as the reference's worker computes (``tests/elastic_worker.py``'s
training replayed in the JAX package, weights within 1e-6 relative and
the last loss, 7.5e-3, within 1e-8: the SGD on a Linear in f32, sums in
another order).  Also: ``max_restarts``, hang detection by a
stale and by a deleted heartbeat, the preemption-loop rule, the
launcher's argument checks and heartbeat plumbing, and the epoch and
step ranges' resume, heartbeat and corrupt-snapshot behaviour.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jax_paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import elastic, launch
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as acp
from paddle_tpu_torch.resilience import PREEMPTED_EXIT_CODE
import paddle_tpu_torch as paddle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_elastic_worker.py')
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import torch_elastic_worker  # noqa: E402


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


def _env(extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.update(extra or {})
    return env


def _launch(args, extra=None):
    return subprocess.Popen(
        [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
         *args], env=_env(extra), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def reference_state():
    """The worker's training replayed in-process with no range."""
    model, losses = torch_elastic_worker.train()
    return {'final_loss': losses[-1],
            'weight': model.weight.detach().ravel().tolist(),
            'bias': model.bias.detach().ravel().tolist()}


def test_killed_and_preempted_workers_resume_to_the_same_state(
        tmp_path, reference_state):
    hb = str(tmp_path / 'hb')
    kill = _launch(['--elastic', '2', '--heartbeat-file', hb,
                    '--heartbeat-timeout', '600', WORKER,
                    str(tmp_path / 'kill.json'), str(tmp_path / 'ck1')],
                   {'KILL_AT_STEP': '6'})
    term = _launch(['--elastic', '0', WORKER, str(tmp_path / 'term.json'),
                    str(tmp_path / 'ck2')],
                   {'TERM_AT_STEP': '6',
                    'PADDLE_TPU_MIN_PREEMPT_UPTIME': '0'})
    out = kill.communicate(timeout=240)[0]
    assert kill.returncode == 0, out
    out = term.communicate(timeout=240)[0]
    assert term.returncode == 0, out
    for name, incarnation, preemptions in (('kill', 1, 0),
                                           ('term', 0, 1)):
        with open(tmp_path / f'{name}.json') as f:
            got = json.load(f)
        assert (got['incarnation'], got['preemptions']) == \
            (incarnation, preemptions), name
        assert not got['jax_loaded']
        for k in ('final_loss', 'weight', 'bias'):
            assert got[k] == reference_state[k], (name, k)
    # the worker touched the heartbeat the launcher plumbed to it
    assert os.path.exists(hb)


def test_the_port_worker_trains_as_the_reference_worker(reference_state):
    """The reference's elastic worker's program, run in the JAX package
    from the port's initial weights."""
    paddle.seed(42)
    init = nn.Linear(4, 1, device='cpu')
    jm = jnn.Linear(4, 1)
    jm.set_state_dict({'weight': init.weight.detach().numpy(),
                       'bias': init.bias.detach().numpy()})
    opt = jax_paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=jm.parameters())
    rs = np.random.RandomState(0)
    xs = rs.rand(20, 4).astype('float32')
    ys = (xs.sum(axis=1, keepdims=True) * 0.5).astype('float32')
    for step in range(12):
        x = jax_paddle.to_tensor(xs[step % 5 * 4:(step % 5) * 4 + 4])
        y = jax_paddle.to_tensor(ys[step % 5 * 4:(step % 5) * 4 + 4])
        loss = jnn.functional.mse_loss(jm(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    np.testing.assert_allclose(reference_state['weight'],
                               np.asarray(jm.weight.value).ravel(),
                               rtol=1e-6)
    np.testing.assert_allclose(reference_state['bias'],
                               np.asarray(jm.bias.value).ravel(),
                               rtol=1e-6)
    # the last loss is 7.5e-3, a difference of near numbers: 1e-6 of
    # the weights' scale, absolute
    np.testing.assert_allclose(reference_state['final_loss'],
                               float(np.asarray(loss.value)), rtol=0,
                               atol=1e-6 * 1e-2)


# ------------------------------------------------------------ supervisor --
def test_gives_up_after_max_restarts_and_terminates():
    procs = elastic.start_local_trainers(
        [[sys.executable, '-c', 'import sys; sys.exit(3)']])
    assert elastic.watch_local_trainers(procs, max_restarts=2, poll=0.05,
                                        restart_backoff=0.0) == 3
    assert procs[0].restarts == 2
    procs = elastic.start_local_trainers(
        [[sys.executable, '-c', 'import time; time.sleep(300)']])
    t0 = time.time()
    elastic.terminate_local_procs(procs, grace=2.0)
    assert time.time() - t0 < 30 and procs[0].proc.poll() is not None


@pytest.mark.parametrize('how', ['stale', 'deleted'])
def test_hang_detection_by_heartbeat(tmp_path, how):
    hb = str(tmp_path / 'hb')
    events = []
    procs = elastic.start_local_trainers(
        [[sys.executable, '-c', 'import time; time.sleep(300)']])
    if how == 'deleted':
        def deleter():
            time.sleep(0.2)
            os.remove(hb)
        threading.Thread(target=deleter, daemon=True).start()
    rc = elastic.watch_local_trainers(
        procs, max_restarts=0, poll=0.05, heartbeat_file=hb,
        heartbeat_timeout=0.5 if how == 'stale' else 5.0,
        on_event=lambda kind, t: events.append(kind))
    assert 'hang' in events and rc != 0


def test_preemption_restarts_free_unless_it_loops():
    script = (
        'import os, sys;'
        'sys.exit(0 if os.environ.get("PADDLE_ELASTIC_'
        f'PREEMPT_COUNT", "0") != "0" else {PREEMPTED_EXIT_CODE})')
    events = []
    procs = elastic.start_local_trainers([[sys.executable, '-c', script]])
    rc = elastic.watch_local_trainers(
        procs, max_restarts=0, poll=0.05, min_preempt_uptime=0.0,
        on_event=lambda k, t: events.append(k))
    assert rc == 0 and events == ['preempt', 'restart']
    assert (procs[0].restarts, procs[0].preemptions) == (0, 1)
    procs = elastic.start_local_trainers(
        [[sys.executable, '-c',
          f'import sys; sys.exit({PREEMPTED_EXIT_CODE})']])
    rc = elastic.watch_local_trainers(procs, max_restarts=0, poll=0.05,
                                      min_preempt_uptime=3600)
    assert rc == PREEMPTED_EXIT_CODE and procs[0].preemptions == 0


def test_argument_checks(tmp_path):
    with pytest.raises(ValueError, match='together'):
        elastic.watch_local_trainers([], heartbeat_file=str(tmp_path))
    with pytest.raises(NotImplementedError, match='supervisor'):
        elastic.watch_local_trainers([], reshape_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match='item'):
        elastic.request_reshape(str(tmp_path))
    for argv, text in (
            (['--elastic', '3', '--coordinator', 'h:1', 'x.py'],
             'requires --nnodes'),
            (['--heartbeat-file', 'hb', 'x.py'], 'together')):
        with pytest.raises(SystemExit) as ei:
            launch.launch_main(argv)
        assert ei.value.code == 2, text
    # the rendezvous is ported (tests/test_torch_data_parallel.py::
    # test_launch_starts_one_worker_a_card); a missing script is a usage
    # error before any worker starts
    with pytest.raises(SystemExit) as ei:
        launch.launch_main(['--coordinator', 'h:1', '--nnodes', '2',
                            '--node-rank', '0', 'x.py'])
    assert ei.value.code == 2


# ------------------------------------------------------- auto-checkpoint --
def _linear():
    paddle.seed(0)
    model = nn.Linear(2, 2, device='cpu')
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    return model, opt


def test_plain_range_and_epoch_range_resume(tmp_path):
    acp.configure()
    assert list(acp.train_epoch_range(4)) == [0, 1, 2, 3]
    model, opt = _linear()
    d = str(tmp_path)
    acp.configure(checkpoint_dir=d, model=model, optimizer=opt,
                  save_checkpoint_inter=0)
    seen = []
    for e in acp.train_epoch_range(5):
        seen.append(e)
        if e == 2:
            break       # crash DURING epoch 2 (no snapshot for it)
        with paddle.no_grad():
            model.weight.add_(float(e + 1))
        saved = model.weight.detach().clone()
    assert seen == [0, 1, 2]
    paddle.seed(9)
    model2 = nn.Linear(2, 2, device='cpu')
    opt2 = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=model2.parameters())
    acp.configure(checkpoint_dir=d, model=model2, optimizer=opt2,
                  save_checkpoint_inter=0)
    w_ptr = model2.weight.data_ptr()
    assert list(acp.train_epoch_range(5)) == [2, 3, 4]
    assert model2.weight.data_ptr() == w_ptr      # restored in place
    np.testing.assert_array_equal(model2.weight.detach().numpy(),
                                  saved.numpy())


def test_snapshot_heartbeat_and_corruption(tmp_path, monkeypatch):
    model, opt = _linear()
    hb = str(tmp_path / 'hb')
    acp.configure(checkpoint_dir=str(tmp_path), model=model,
                  save_checkpoint_inter=0, heartbeat_file=hb)
    list(acp.train_step_range(2))
    assert os.path.exists(hb)
    hb_env = str(tmp_path / 'hb_env')
    monkeypatch.setenv('PADDLE_TPU_HEARTBEAT_FILE', hb_env)
    acp.configure(checkpoint_dir=str(tmp_path / 'env'), model=model,
                  save_checkpoint_inter=0)
    list(acp.train_step_range(1))
    assert os.path.exists(hb_env)
    acp.configure(checkpoint_dir=str(tmp_path / 'c'), model=model,
                  optimizer=opt, save_checkpoint_inter=0)
    assert list(acp.train_epoch_range(3)) == [0, 1, 2]
    with open(tmp_path / 'c' / 'acp_snapshot', 'wb') as f:
        f.write(b'\x80\x04 definitely not a pickle')
    acp.configure(checkpoint_dir=str(tmp_path / 'c'), model=model,
                  optimizer=opt, save_checkpoint_inter=0)
    with pytest.warns(RuntimeWarning, match='unreadable'):
        assert list(acp.train_epoch_range(3)) == [0, 1, 2]
    acp.configure()
