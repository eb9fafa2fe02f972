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
  (which exits non-zero, naming ``device='cpu'``).
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
            'paddle_tpu_torch.tools.serve_fleet; '
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
