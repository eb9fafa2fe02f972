"""Package boundaries of the port.

- no file of ``paddle_tpu_torch/``, not ``chip_smoke.py`` and not the
  port's ``tools/torch_*.py`` imports ``jax`` or anything of
  ``paddle_tpu`` (``paddle_tpu_torch`` itself is allowed), by an AST
  scan;
- ``import paddle_tpu_torch`` in a fresh interpreter leaves ``jax``
  out of ``sys.modules``;
- an entry point with no device and no CUDA raises instead of quietly
  running on the CPU: the models, the KV cache, the serving stack a
  front door stands on, ``launch_fleet`` and the fleet's worker CLI
  (which exits non-zero, naming ``device='cpu'``), and the high-level
  API's (``hapi.Model`` over the zoo's default model, the
  ``mnist_lenet`` program, ``DataLoader(device_prefetch=True)``), and
  the fault-tolerance tools (``chaos_run``'s built-in worker exits
  non-zero naming ``device='cpu'`` and spawns nothing; the resilience,
  checkpoint, elastic, launch and auto-checkpoint modules and both
  tools import without ``jax``, and so do the fleet, recompute,
  profiler and utils modules of the training strategies).
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.serving import PagedKVCache
from paddle_tpu_torch.vision.models import LeNet, resnet18


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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'paddle_tpu_torch')


def _port_files():
    tools = os.path.join(ROOT, 'tools')
    out = [os.path.join(ROOT, 'chip_smoke.py')] + [
        os.path.join(tools, f) for f in os.listdir(tools)
        if f.startswith('torch_') and f.endswith('.py')]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _forbidden(module):
    top = module.split('.')[0]
    return top in ('jax', 'jaxlib', 'paddle_tpu')


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_neither_jax_nor_paddle_tpu(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f'{os.path.relpath(path, ROOT)} imports {bad}'


def test_forbidden_names():
    assert _forbidden('jax.numpy') and _forbidden('paddle_tpu.ops')
    assert not _forbidden('paddle_tpu_torch.ops')


def test_import_leaves_jax_unloaded():
    code = ('import sys, paddle_tpu_torch, paddle_tpu_torch.serving, '
            'paddle_tpu_torch.models, paddle_tpu_torch.convert, '
            'paddle_tpu_torch.amp, paddle_tpu_torch.optimizer, '
            'paddle_tpu_torch.parallel, paddle_tpu_torch.distributed, '
            'paddle_tpu_torch.ops.flash_attention, '
            'paddle_tpu_torch.ops.fused_ce, paddle_tpu_torch.vision, '
            'paddle_tpu_torch.quantization, '
            'paddle_tpu_torch.ops.int8_matmul, '
            'paddle_tpu_torch.telemetry, paddle_tpu_torch.resilience, '
            'paddle_tpu_torch.serving.frontend, '
            'paddle_tpu_torch.serving.router, '
            'paddle_tpu_torch.tools.serve_fleet, paddle_tpu_torch.hapi, '
            'paddle_tpu_torch.io, paddle_tpu_torch.io.native, '
            'paddle_tpu_torch.metric, paddle_tpu_torch.jit, '
            'paddle_tpu_torch.static, paddle_tpu_torch.framework, '
            'paddle_tpu_torch.vision.transforms, '
            'paddle_tpu_torch.vision.datasets, '
            'paddle_tpu_torch.resilience.manifest, '
            'paddle_tpu_torch.resilience.retry, '
            'paddle_tpu_torch.resilience.chaos, '
            'paddle_tpu_torch.resilience.watchdog, '
            'paddle_tpu_torch.distributed.checkpoint, '
            'paddle_tpu_torch.distributed.elastic, '
            'paddle_tpu_torch.distributed.launch, '
            'paddle_tpu_torch.incubate.checkpoint.auto_checkpoint, '
            'paddle_tpu_torch.tools.check_ckpt, '
            'paddle_tpu_torch.tools.chaos_run, '
            'paddle_tpu_torch.distributed.env, '
            'paddle_tpu_torch.distributed.parallel, '
            'paddle_tpu_torch.distributed.fleet.fleet_base, '
            'paddle_tpu_torch.distributed.fleet.role_maker, '
            'paddle_tpu_torch.distributed.fleet.topology, '
            'paddle_tpu_torch.distributed.fleet.data_generator, '
            'paddle_tpu_torch.distributed.fleet.metrics, '
            'paddle_tpu_torch.distributed.fleet.utils.fs, '
            'paddle_tpu_torch.distributed.fleet.utils.ps_util, '
            'paddle_tpu_torch.distributed.fleet.utils.recompute, '
            'paddle_tpu_torch.core.recompute, paddle_tpu_torch.device, '
            'paddle_tpu_torch.profiler, paddle_tpu_torch.profiler.trace, '
            'paddle_tpu_torch.utils, paddle_tpu_torch.utils.profiler; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "paddle_tpu")]; print(bad); '
            'sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        gpt_tiny(num_layers=1)
    with pytest.raises(RuntimeError, match='CUDA'):
        PagedKVCache(1, 1, 4, block_size=4, num_blocks=4)
    for model in (LeNet, resnet18):
        with pytest.raises(RuntimeError, match='CUDA'):
            model()
    assert resolve_device('cpu') == torch.device('cpu')


def test_serving_stack_without_device_raises_without_cuda(monkeypatch,
                                                          tmp_path):
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.serving.frontend import ServingFrontend
    from paddle_tpu_torch.tools import serve_fleet
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)

    def door():
        model = gpt_tiny(num_layers=1)
        return ServingFrontend(ServingEngine(model, ServeConfig()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        door()
    config = tmp_path / 'serve.json'
    config.write_text('{"model": "tiny"}')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_fleet.launch_fleet(str(config), replicas=1,
                                 workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_fleet.build_engine({'model': 'tiny'})
    assert not list(tmp_path.glob('*.port'))        # nothing spawned


def test_fleet_worker_cli_without_cuda_exits_naming_cpu(tmp_path):
    config = tmp_path / 'serve.json'
    config.write_text('{"model": "tiny", "model_kwargs": '
                      '{"num_layers": 1}}')
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.tools.serve_fleet',
         'worker', '--config', str(config), '--port-file',
         str(tmp_path / 'w.port')], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr
    assert not (tmp_path / 'w.port').exists()


def test_high_level_api_without_device_raises_without_cuda(monkeypatch):
    import numpy as np
    import chip_smoke
    import paddle_tpu_torch as paddle
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle.Model(paddle.vision.models.LeNet())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chip_smoke.mnist_lenet(paddle, epochs=1, limit=64)
    ds = paddle.io.TensorDataset([np.zeros((4, 2), np.float32)])
    loader = paddle.io.DataLoader(ds, batch_size=2, num_workers=1,
                                  device_prefetch=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(loader)
    # asked for, the CPU runs: a CPU network's Model stays there
    model = paddle.Model(LeNet(device='cpu'))
    assert model.device == torch.device('cpu')


def test_chaos_run_without_cuda_exits_naming_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.tools.chaos_run',
         '--smoke', '--dir', str(tmp_path / 'w')], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr
    assert not (tmp_path / 'w').exists()        # no worker spawned
