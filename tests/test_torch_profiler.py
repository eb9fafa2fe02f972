"""The profiler of the port against the reference's API, on the CPU:
``profiler`` (``start_profiler``/``stop_profiler(parse=)``, ``profiler``,
``reset_profiler``, ``cuda_profiler``, ``Profiler``, ``RecordEvent``,
``StepTimer``, ``op_summary``, ``trace``), ``utils.profiler`` and
``ParallelTrainer(profile=)``/``finish_profile``/``op_summary``.

A trace here is a CPU ``torch.profiler`` window: with no device events
its ops are the CPU ops (the reference's CPU runtime counts its thunks
the same way), and its ``record_function`` ranges are kept apart.  The
trainer is ``gpt_tiny`` (2 layers, H 64) on the CPU, where the kernels'
operators run their plain twins; ``op_summary`` must run none of them.
"""
import gzip
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelTrainer
from paddle_tpu_torch.utils import profiler as uprof


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after:
    the suite runs six workers on the machine's cores, and torch's
    default of a thread a core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


MODEL_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
                max_seq_len=64, dropout=0.1)
IDS = np.random.RandomState(0).randint(0, 128, (2, 32)).astype(np.int64)


def _trainer(profile=None, seed=0):
    paddle.seed(seed)
    m = gpt_tiny(device='cpu', seed=seed, **MODEL_KW)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    return ParallelTrainer(m, opt, lambda out, y: m.loss(out, y),
                           strategy=fleet.DistributedStrategy(),
                           profile=profile)


def test_the_api_has_the_references_names():
    assert sorted(profiler.__all__) == sorted(jpaddle.profiler.__all__)
    for name in jpaddle.profiler.__all__:
        assert hasattr(profiler, name), name
    assert sorted(uprof.__all__) == sorted(jpaddle.utils.profiler.__all__)
    assert profiler.StepTimer is paddle.telemetry.StepTimer
    assert paddle.profiler is profiler


def test_a_cpu_window_parses_into_ops_and_ranges(tmp_path):
    x = torch.randn(32, 32)
    logdir = profiler.start_profiler(logdir=str(tmp_path))
    with profiler.RecordEvent('my_range'):
        for _ in range(3):
            torch.mm(x, x)
    prof = profiler.stop_profiler(parse=True)
    assert logdir == str(tmp_path)
    assert isinstance(prof, profiler.TraceProfile)
    assert prof.ops['aten::mm']['count'] == 3
    assert prof.ranges['my_range']['count'] == 1
    assert prof.n_events >= 3 and prof.device_total_us > 0
    assert set(prof.summary()) == {'n_ops', 'n_events', 'device_total_us',
                                   'collective_total_us', 'source'}
    files = profiler.find_traces(str(tmp_path))
    assert len(files) == 1 and prof.source == files[0]
    assert profiler.stop_profiler() is None         # nothing open
    with profiler.profiler(logdir=str(tmp_path)):
        torch.mm(x, x)
    assert len(profiler.find_traces(str(tmp_path))) == 2
    with pytest.raises(RuntimeError, match='already open'):
        profiler.start_profiler(logdir=str(tmp_path))
        profiler.start_profiler(logdir=str(tmp_path))
    profiler.reset_profiler()       # the open window restarts
    assert isinstance(profiler.stop_profiler(parse=True),
                      profiler.TraceProfile)


def test_device_events_are_the_ops_when_the_trace_has_them(tmp_path):
    doc = {'traceEvents': [
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'dur': 50,
         'pid': 1},
        {'ph': 'X', 'cat': 'kernel', 'name': 'flash_fwd_mma<bf16>',
         'dur': 100, 'pid': 0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'flash_fwd_mma<bf16>',
         'dur': 110, 'pid': 0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'ncclDevKernel_AllReduce',
         'dur': 40, 'pid': 0},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'dur': 5,
         'pid': 0},
        {'ph': 'X', 'cat': 'user_annotation',
         'name': 'ParallelTrainer.forward', 'dur': 300, 'pid': 1},
        {'ph': 'X', 'cat': 'gpu_user_annotation',
         'name': 'ParallelTrainer.forward', 'dur': 250, 'pid': 0},
        {'ph': 'i', 'cat': 'kernel', 'name': 'marker', 'pid': 0}]}
    path = tmp_path / 'x.trace.json.gz'
    with gzip.open(path, 'wt') as fh:
        json.dump(doc, fh)
    for src in (doc, str(path)):
        prof = profiler.parse_trace(src)
        assert set(prof.ops) == {'flash_fwd_mma<bf16>',
                                 'ncclDevKernel_AllReduce', 'Memcpy HtoD'}
        assert prof.ops['flash_fwd_mma<bf16>'] == {
            'name': 'flash_fwd_mma<bf16>', 'count': 2, 'total_us': 210.0,
            'avg_us': 105.0}
        assert (prof.n_events, prof.device_total_us,
                prof.collective_total_us, prof.device_pids) == \
            (4, 255.0, 40.0, 1)
        assert list(prof.collectives()) == ['ncclDevKernel_AllReduce']
        assert prof.top(1)[0]['name'] == 'flash_fwd_mma<bf16>'
        assert prof.ranges['ParallelTrainer.forward']['total_us'] == 300.0
        assert prof.ranges['gpu:ParallelTrainer.forward']['count'] == 1


def test_host_ops_count_their_nested_ops_once():
    """With no device event the host ops are the ops: every one is
    listed, but an op inside its caller adds no time to the total."""
    doc = {'traceEvents': [
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::linear', 'ts': 0,
         'dur': 100, 'pid': 1, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::addmm', 'ts': 10,
         'dur': 80, 'pid': 1, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::relu', 'ts': 200,
         'dur': 10, 'pid': 1, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::addmm', 'ts': 20,
         'dur': 30, 'pid': 1, 'tid': 2}]}
    prof = profiler.parse_trace(doc)
    assert prof.ops['aten::addmm']['count'] == 2
    assert set(prof.ops) == {'aten::linear', 'aten::addmm', 'aten::relu'}
    assert (prof.n_events, prof.device_total_us) == (4, 140.0)


def test_profiler_objects_and_the_nvprof_hook(tmp_path):
    p = profiler.Profiler(logdir=str(tmp_path))
    with p:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
        p.step()
    assert len(profiler.find_traces(str(tmp_path))) == 1
    assert isinstance(p.summary(), dict)
    with profiler.cuda_profiler():
        torch.ones(3).sum()


def test_utils_profiler_options_and_batch_range():
    opts = uprof.ProfilerOptions({'batch_range': [1, 3],
                                  'sorted_key': 'total'})
    want = jpaddle.utils.profiler.ProfilerOptions(
        {'batch_range': [1, 3], 'sorted_key': 'total'})
    for key in ('state', 'sorted_key', 'tracer_level', 'batch_range',
                'output_thread_detail', 'profile_path', 'timeline_path',
                'op_summary_path'):
        assert opts[key] == want[key], key
    assert opts['profile_path'] is None
    with pytest.raises(ValueError, match='no_such'):
        opts['no_such']
    assert uprof.get_profiler().enabled is False
    with uprof.Profiler(options=opts) as prof:
        assert uprof.get_profiler() is prof and not prof._tracing
        prof.record_step()
        assert prof._tracing               # batch 1 opens the window
        prof.record_step()
        prof.record_step()
        assert not prof._tracing           # batch 3 closes it
    assert uprof.get_profiler() is not prof


def _rows_ok(rows):
    assert rows and all(set(r) == {'opcode', 'calls', 'bytes', 'ratio'}
                        for r in rows)
    assert abs(sum(r['ratio'] for r in rows) - 1.0) < 1e-9


def test_op_summary_counts_ops_and_runs_nothing(monkeypatch):
    fn_mod = __import__('importlib').import_module(
        'paddle_tpu_torch.ops.fused_norm')
    ran = []
    real = fn_mod._reference
    monkeypatch.setattr(fn_mod, '_reference',
                        lambda *a: ran.append(1) or real(*a))
    x = torch.randn(8, 64)
    g, b = torch.ones(64), torch.zeros(64)
    state = rng.generator('cpu').get_state().clone()

    def f(x):
        y = paddle.ops.fused_layer_norm(x, g, b)
        return F.dropout(y @ y.t(), 0.5) + 1.0
    rows = profiler.op_summary(f, x, print_table=False)
    _rows_ok(rows)
    calls = {r['opcode']: r['calls'] for r in rows}
    assert calls['paddle_tpu_torch::fused_layer_norm'] == 1
    assert calls['mm'] == 1
    assert ran == []
    assert torch.equal(rng.generator('cpu').get_state(), state)
    by_bytes = [r['bytes'] for r in rows]
    assert by_bytes == sorted(by_bytes, reverse=True)
    by_calls = [r['calls'] for r in
                profiler.op_summary(f, x, sorted_by='calls',
                                    print_table=False)]
    assert by_calls == sorted(by_calls, reverse=True)
    mm = [r for r in rows if r['opcode'] == 'mm'][0]
    assert mm['bytes'] == 8 * 8 * 4


def test_op_summary_refuses_a_sort_key_as_the_reference():
    for pkg in (profiler, jpaddle.profiler):
        with pytest.raises(ValueError, match="sorted_by must be 'total', "
                                             "'bytes' or 'calls'"):
            pkg.op_summary(lambda x: x, np.ones(2), sorted_by='time')


def test_op_summary_prints_the_table(capsys):
    profiler.op_summary(lambda x: x * 2 + 1, torch.ones(3), top=1,
                        totals={'flops': 6.0})
    out = capsys.readouterr().out
    assert 'op summary' in out and 'module flops' in out and 'more' in out


def test_trainer_op_summary_moves_nothing():
    tr = _trainer()
    tr.step(IDS, IDS)
    model, opt = tr.model, tr.optimizer
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    slots = {k: v.clone() for k, v in opt.state_dict().items()
             if torch.is_tensor(v)}
    gen = rng.generator('cpu').get_state().clone()
    rows = tr.op_summary(IDS, IDS, print_table=False)
    _rows_ok(rows)
    calls = {r['opcode']: r['calls'] for r in rows}
    L = MODEL_KW['num_layers']
    # dropout 0.1: the softmax branch
    assert calls['paddle_tpu_torch::fused_layer_norm'] == 2 * L + 1
    assert calls['paddle_tpu_torch::fused_softmax'] == L
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
        assert type(p.grad) is torch.Tensor and torch.equal(p.grad, grads[n])
    for k, v in opt.state_dict().items():
        if torch.is_tensor(v):
            assert type(v) is torch.Tensor and torch.equal(v, slots[k]), k
    assert torch.equal(rng.generator('cpu').get_state(), gen)
    assert tr._step_no == 1 and model.training
    # the next step is the step a trainer without the summary takes
    # (the generator is global: the other trainer's first step brings it
    # back to where the summary found it)
    got = tr.step(IDS, IDS)
    other = _trainer()
    other.step(IDS, IDS)
    assert torch.equal(got, other.step(IDS, IDS))


def test_trainer_op_summary_before_any_step_and_under_the_strategies():
    tr = _trainer()
    st = fleet.DistributedStrategy()
    st.recompute = True
    st.gradient_merge = True
    st.gradient_merge_configs['k_steps'] = 2
    tr.strategy, tr._merge_k = st, 2
    rows = tr.op_summary(IDS, IDS, print_table=False)
    calls = {r['opcode']: r['calls'] for r in rows}
    L = MODEL_KW['num_layers']
    assert calls['paddle_tpu_torch::fused_layer_norm'] == 2 * (2 * L + 1) * 2
    assert tr.optimizer._accumulators == {}
    assert tr.optimizer._scalar_buf is None


def test_profile_windows_and_finish_profile(tmp_path):
    tr = _trainer(profile=f'start=1,steps=2,limit=1,dir={tmp_path}')
    last = None
    for _ in range(4):
        last = tr.step(IDS, IDS)
    wins = tr.finish_profile(sync=last)
    assert [(w['step_lo'], w['step_hi']) for w in wins] == [(1, 2)]
    assert 'error' not in wins[0] and os.path.exists(wins[0]['trace'])
    assert wins[0]['n_events'] > 0
    # a window still open at the loop's end is closed by finish_profile
    tr = _trainer(profile=f'start=2,steps=5,limit=1,dir={tmp_path}')
    for _ in range(4):
        last = tr.step(IDS, IDS)
    wins = tr.finish_profile(sync=last)
    assert [(w['step_lo'], w['step_hi']) for w in wins] == [(2, 3)]
    assert _trainer(profile=False).finish_profile() == []


def test_profile_windows_over_fused_chunks(tmp_path):
    paddle.seed(0)
    m = gpt_tiny(device='cpu', seed=0, **MODEL_KW)
    tr = ParallelTrainer(m, AdamW(parameters=m.parameters()),
                         lambda out, y: m.loss(out, y), fused_steps=2,
                         profile=f'start=2,steps=2,limit=1,dir={tmp_path}')
    chunk = (np.stack([IDS] * 2), np.stack([IDS] * 2))
    for _ in range(3):
        last = tr.step_fused(*chunk)
    wins = tr.finish_profile(sync=last)
    assert [(w['step_lo'], w['step_hi']) for w in wins] == [(2, 3)]


def test_a_failing_profiler_never_fails_a_step(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError('no profiler here')
    monkeypatch.setattr(paddle.telemetry, 'step_profiler', boom)
    tr = _trainer(profile=True)
    assert np.isfinite(tr.loss_float(tr.step(IDS, IDS)))
    assert tr._profiler is None and tr.finish_profile() == []
