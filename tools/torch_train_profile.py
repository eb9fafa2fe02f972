"""Where the port's training time goes, on one CUDA card.

    python3 tools/torch_train_profile.py [--model gpt|gpt_recipe|longctx|moe|bert|bert_flash|bert_gemm_gelu|resnet50|qat|widedeep|transformer|lstm_lm|ddpm_unet] [--path fused|eager] [--steps 2] [--out build/torch_train_profile.json]

Run from the repository root.  Training steps at full width with random
seeded weights, in the configuration of one of ``chip_smoke.py``'s
training runs: ``--model gpt`` (the default) ``gpt_small`` at B 8, T
1024, bf16 O2, fused CE head in 8 chunks, AdamW lr 3e-4; ``--model
gpt_recipe`` the same model and batch trained with GPT-3 Small's recipe
under the NaN guard (``chip_smoke._recipe_trainer``: AdamW beta2 0.95,
weight decay 0.1 with biases and LayerNorm exempt, ``LinearWarmup`` into
``CosineAnnealingDecay``, ``ClipGradByGlobalNorm(1.0)``, a loss weight
of 1 a step); ``--model
bert`` ``bert_base`` at its dropout 0.1 (the softmax branch), B 64, T
128, bf16 O2, fused MLM head in 8 chunks, AdamW lr 1e-4, MLM labels on
15% of positions; ``--model bert_flash`` the same at the benchmark's
dropout 0 (the flash kernels); ``--model bert_gemm_gelu`` the same at
dropout 0.1 with ``USE_PALLAS_MLP`` on (the GEMM+GELU kernels);
``--model resnet50`` ResNet-50 at bench.py's configuration (NHWC, B
256 x 224 x 224 bf16 images, bf16 O2, Momentum lr 0.1;
``chip_smoke._resnet_trainer``), whose kernels are classed as cuDNN
conv forward, dgrad and wgrad, layout transforms and pooling besides
the kinds below, and which also times every BatchNorm of the step
alone (``bn_breakdown``: each BatchNorm's input shape and dtype from
one forward, then ``F.batch_norm`` forward and backward on such
inputs, device time under the profiler), BatchNorm's device share, and
lists every convolution kernel; ``--model longctx`` ``gpt_small`` at
bench.py's long-context configuration (B 2, T 4096, otherwise as
``gpt``; ``chip_smoke.LONGCTX_MODEL_KW``); ``--model moe`` the ``gpt``
configuration with Switch-Base-8's routing (``chip_smoke.MOE_KW``: 8
experts in every other block, top-1, capacity factor 1.25); ``--model
qat`` the ``resnet50`` configuration under ``ImperativeQuantAware``
(``chip_smoke._resnet_trainer(qat=True)``); ``--model widedeep``
Wide&Deep at bench.py's configuration (26 fields of 100 000 ids, embed
16, hidden (400, 400, 400), B 16384, bf16 O2, Adam lr 1e-3;
``chip_smoke._widedeep_trainer``), whose device time is also split
between the embedding gathers, the tables' dense gradient (the
embedding backward's sort and scatter, and the zero fill of the dense
table), the casts and the optimizer (``widedeep_split``); ``--model
transformer`` Transformer-base (``nn.Transformer()``, a shared
vocabulary of 37000, B 64 x source 128 x target 128, bf16 O2, Adam
under Noam's schedule, label smoothing 0.1;
``chip_smoke.transformer_trainer``), whose device time also shows the
attention and the label-smoothed loss (``seq_split``: the kernels inside
the ``multihead_attention`` and ``cross_entropy`` ranges, which the
port's layers mark); ``--model lstm_lm`` Zaremba's large PTB LSTM LM
(2 x 1500, vocabulary 10000, B 20 x 35 steps, f32, SGD lr 1 with a
global-norm clip of 10; ``chip_smoke.lstm_lm_trainer``); ``--model
ddpm_unet`` DDPM's CIFAR-10 U-Net (``chip_smoke.DDPM_KW``: ch 128,
multipliers (1, 2, 2, 2), GroupNorm 32, attention at 16^2, dropout 0.1;
B 128 x 3 x 32^2, bf16 O2, Adam 2e-4 with a global-norm clip of 1;
``chip_smoke.ddpm_trainer``), whose device time is also split into
GroupNorm (every GroupNorm of the step timed alone, forward and
backward, by ``gn_breakdown``, and the forward's kernels inside the
``group_norm`` ranges), the convolutions (the cuDNN kinds), the softmax
kernel and the copies and casts.
``--path fused`` (the default) trains through
``ParallelTrainer(fused_steps=--steps).step_fused``, the step as a
replayed CUDA graph: one chunk warms up (the first step eager, the
capture, the replays), then one chunk of ``--steps`` replays runs under
``torch.profiler`` (CUPTI device timestamps; the kernels inside a
replay are recorded one by one).  ``--path eager`` runs ``step``: 2
warm-up steps, then ``--steps`` steps under the profiler, where each of
the trainer's forward, backward and optimizer ranges also shows its
host time and its span on the device's timeline (first to last kernel
launched inside it, gaps included); a replayed graph has no host
ranges.  Either way: wall time per step, the device's busy and idle
share (the union of kernel intervals over the wall window), device
time by kernel and by kind of kernel, host time by operator.

Prints a summary and writes the whole result as JSON to ``--out``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the smoke's model, config and helpers)

# kinds of device kernels, first match wins (lower-case substrings)
KINDS = [('conv forward (cuDNN)', ('fprop', 'implicit_convolve',
                                   'conv2d_c1_k1')),
         ('conv dgrad (cuDNN)', ('dgrad',)),
         ('conv wgrad (cuDNN)', ('wgrad',)),
         ('conv, other (cuDNN)', ('implicitgemmconvolution', 'cudnn')),
         ('layout transform', ('nchwtonhwc', 'nhwctonchw')),
         # the embedding backward: sort the ids, then sum each id's rows
         # into the dense gradient table
         ('embedding backward (sort, scatter)', (
             'embedding_backward', 'compute_grad_weight', 'sum_and_scatter',
             'partials_per_segment', 'segment_offsets', 'radixsort',
             'onesweep', 'sortpairs', 'compute_num_of_partial')),
         ('gather (index_select)', ('indexselect', 'index_select',
                                    'vectorized_gather_kernel')),
         ('pooling', ('max_pool', 'avg_pool', 'maxpool', 'avgpool')),
         ('flash_attention_fwd', ('flash_fwd',)),
         ('flash_attention_bwd_dq', ('flash_bwd_dq',)),
         ('flash_attention_bwd_dkv', ('flash_bwd_dkv',)),
         ('fused_layer_norm', ('layer_norm_warp<', 'layer_norm_block<')),
         # PyTorch's own are softmax_warp_forward/backward
         ('fused_softmax', ('softmax_vec<', 'softmax_scalar<',
                            'softmax_warp<', 'softmax_block<')),
         # the tensor-core and the SIMT design
         ('fused_linear_gelu', ('linear_gelu_wgmma<', 'linear_gelu<')),
         ('matmul (cuBLAS/CUTLASS)', ('gemm', 'cutlass', 'sm90_xmma',
                                      'nvjet', 'cublas', 'splitk')),
         ('reduction', ('reduce',)),
         ('copy / cast', ('copy', 'cast')),
         ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
         ('index / gather / scatter', ('index', 'gather', 'scatter',
                                       'embedding'))]
# the trainer's ranges, and every range the port annotates
RANGES = chip_smoke.ANNOTATIONS
SEQ_RANGES = ('multihead_attention', 'cross_entropy')


def _kind(name):
    # PyTorch's elementwise kernels without dtype casts are named
    # gpu_kernel_impl_nocast: not a cast
    low = name.lower().replace('nocast', '')
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return 'other'


def _busy_us(events):
    """Length of the union of device-kernel intervals, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans)


BERT_RUN = {'bert': 0, 'bert_flash': 1, 'bert_gemm_gelu': 2}


def _setup(model_name, fused_steps=None):
    """(trainer, batch, tokens (images, examples, target tokens, words)
    per step, USE_PALLAS_MLP) of the named configuration."""
    if model_name == 'transformer':
        import paddle_tpu_torch as paddle
        paddle.seed(0)
        model = chip_smoke.transformer_model(paddle,
                                             **chip_smoke.TRANSFORMER_KW)
        batch = chip_smoke.transformer_batch(
            chip_smoke.TRANSFORMER_BATCH, chip_smoke.TRANSFORMER_SRC,
            chip_smoke.TRANSFORMER_TGT, model.config['vocab_size'])
        return (chip_smoke.transformer_trainer(paddle, model, amp_o2=True,
                                               fused_steps=fused_steps),
                batch, chip_smoke.TRANSFORMER_BATCH
                * chip_smoke.TRANSFORMER_TGT, False)
    if model_name == 'ddpm_unet':
        import paddle_tpu_torch as paddle
        paddle.seed(0)
        model = chip_smoke.ddpm_unet(paddle, **chip_smoke.DDPM_KW)
        return (chip_smoke.ddpm_trainer(paddle, model, amp_o2=True,
                                        fused_steps=fused_steps),
                chip_smoke.ddpm_batch(chip_smoke.DDPM_BATCH),
                chip_smoke.DDPM_BATCH, False)
    if model_name == 'lstm_lm':
        import paddle_tpu_torch as paddle
        paddle.seed(0)
        batch = chip_smoke.lstm_lm_batch(
            chip_smoke.LSTM_LM_BATCH, chip_smoke.LSTM_LM_STEPS,
            chip_smoke.LSTM_LM_KW['vocab_size'])
        return (chip_smoke._lstm_lm_trainer(fused_steps=fused_steps), batch,
                chip_smoke.LSTM_LM_BATCH * chip_smoke.LSTM_LM_STEPS, False)
    if model_name == 'widedeep':
        return (chip_smoke._widedeep_trainer(fused_steps=fused_steps),
                chip_smoke.widedeep_batch(), chip_smoke.WD_BATCH, False)
    if model_name in ('resnet50', 'qat'):
        return (chip_smoke._resnet_trainer(fused_steps=fused_steps,
                                           qat=model_name == 'qat'),
                chip_smoke.resnet_batch(), chip_smoke.RESNET_BATCH, False)
    if model_name in BERT_RUN:
        from paddle_tpu_torch.models.bert import bert_base
        _, dropout, pallas_mlp, _, _ = chip_smoke.BERT_RUNS[
            BERT_RUN[model_name]]
        model = bert_base(device='cuda', seed=0, dropout=dropout,
                          **chip_smoke.BERT_MODEL_KW)
        trainer = chip_smoke._trainer(model, amp_o2=True,
                                      lr=chip_smoke.BERT_LR,
                                      fused_steps=fused_steps)
        batch = chip_smoke.bert_batch(model.config.vocab_size,
                                      chip_smoke.BERT_BATCH,
                                      chip_smoke.BERT_SEQ)
        return (trainer, batch, chip_smoke.BERT_BATCH * chip_smoke.BERT_SEQ,
                pallas_mlp)
    from paddle_tpu_torch.models.gpt import gpt_small
    long = model_name == 'longctx'
    kw = chip_smoke.LONGCTX_MODEL_KW if long else chip_smoke.TRAIN_MODEL_KW
    if model_name == 'moe':
        kw = dict(kw, **chip_smoke.MOE_KW)
    model = gpt_small(device='cuda', seed=0, **kw)
    batch, seq = (chip_smoke.LONGCTX_BATCH, chip_smoke.LONGCTX_SEQ) if long \
        else (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ)
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (batch, seq)).astype(np.int64)
    tokens = batch * seq
    if model_name == 'gpt_recipe':
        trainer = chip_smoke._recipe_trainer(model, fused_steps=fused_steps)
        return trainer, (ids, ids, np.ones((), np.float32)), tokens, False
    trainer = chip_smoke._trainer(model, amp_o2=True,
                                  fused_steps=fused_steps)
    return trainer, (ids, ids), tokens, False


def training_breakdown(model_name='gpt', steps=2, top=20, path='fused'):
    fused = path == 'fused'
    trainer, batch, tokens, pallas_mlp = _setup(
        model_name, fused_steps=steps if fused else None)
    fgl = chip_smoke._ops_module('fused_gelu_linear')
    fgl.USE_PALLAS_MLP = pallas_mlp
    if fused:
        chunk = tuple(torch.stack([b] * steps) if torch.is_tensor(b)
                      else np.stack([b] * steps) for b in batch)

        def run():
            return trainer.step_fused(*chunk)[-1]
    else:
        def run():
            return [trainer.step(*batch) for _ in range(steps)][-1]
    try:
        if fused:
            run()           # the warm-up step, the capture, the replays
        else:
            for _ in range(chip_smoke.TRAIN_WARMUP):
                trainer.step(*batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss = run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        fgl.USE_PALLAS_MLP = False
    # the trainer's record_function ranges also appear on the device's
    # timeline as annotations; they are spans, not kernels
    device = [e for e in prof.events() if chip_smoke.is_device_event(e)]
    events = [e for e in device if e.name not in RANGES]
    conv_kernels = {}
    for e in events:
        if _kind(e.name).startswith(('conv', 'layout')):
            n, us = conv_kernels.get(e.name, (0, 0.0))
            conv_kernels[e.name] = (n + 1, us + e.time_range.end
                                    - e.time_range.start)
    spans = {}
    for e in device:
        if e.name in RANGES:
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    busy_us, n_kernels = _busy_us(events)
    by_kind = {}
    for e in events:
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end
                                            - e.time_range.start)
    avgs = prof.key_averages()
    dev = sorted((e for e in avgs if chip_smoke.is_device_event(e)
                  and e.key not in RANGES),
                 key=chip_smoke.self_device_us, reverse=True)
    host = sorted((e for e in avgs if not chip_smoke.is_device_event(e)
                   and e.key not in RANGES),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    ranges = {e.key: float(e.cpu_time_total) / steps for e in avgs
              if e.key in RANGES and not chip_smoke.is_device_event(e)}
    res = {
        'model': model_name, 'path': path, 'steps': steps,
        'loss': float(loss),
        'wall_ms_per_step': wall_us / steps / 1e3,
        {'resnet50': 'imgs', 'qat': 'imgs', 'ddpm_unet': 'imgs',
         'widedeep': 'examples',
         'transformer': 'target_tokens', 'lstm_lm': 'words'}.get(
            model_name, 'tokens')
        + '_per_s_under_profiler': tokens * steps / (wall_us / 1e6),
        'device_busy_ms_per_step': busy_us / steps / 1e3,
        'device_idle_share': 1.0 - busy_us / wall_us,
        'kernel_launches_per_step': n_kernels / steps,
        'device_ms_per_step_by_kind': {
            k: v / steps / 1e3 for k, v in sorted(
                by_kind.items(), key=lambda kv: kv[1], reverse=True)},
        'host_ms_per_step_by_range': {k: v / 1e3
                                      for k, v in ranges.items()},
        'device_span_ms_per_step_by_range': {k: v / steps / 1e3
                                             for k, v in spans.items()},
        'device_kernels': [
            {'name': e.key[:120], 'count': int(e.count),
             'device_ms_per_step': chip_smoke.self_device_us(e) / steps
             / 1e3} for e in dev[:top]],
        'host_ops': [
            {'name': e.key[:80], 'count': int(e.count),
             'self_cpu_ms_per_step': float(e.self_cpu_time_total) / steps
             / 1e3} for e in host[:top]],
    }
    if fused:
        (graph,) = trainer._fused_cache.modules.values()
        res['capture_s'] = graph.capture_s
        res['launches_a_replay'] = graph.launches.counts()
    if model_name == 'widedeep':
        res['widedeep_split'] = widedeep_split(res, device, events, steps)
    if model_name == 'transformer':
        res['seq_split'] = seq_split(device, events, steps)
    if model_name == 'ddpm_unet':
        res['seq_split'] = seq_split(device, events, steps, ('group_norm',))
        gn = gn_breakdown(trainer, batch)
        kinds = res['device_ms_per_step_by_kind']
        busy = res['device_busy_ms_per_step']
        gn['share_of_device_busy'] = (gn['fwd_bwd_ms_per_step'] / busy
                                      if busy else None)
        gn['convolutions_ms_per_step'] = sum(
            v for k, v in kinds.items() if k.startswith('conv'))
        gn['softmax_ms_per_step'] = kinds.get('fused_softmax', 0.0)
        gn['copies_casts_ms_per_step'] = kinds.get('copy / cast', 0.0)
        res['group_norm'] = gn
    if model_name == 'resnet50':
        res['conv_and_layout_kernels'] = [
            {'name': name[:160], 'count_per_step': n / steps,
             'device_ms_per_step': us / steps / 1e3}
            for name, (n, us) in sorted(conv_kernels.items(),
                                        key=lambda kv: -kv[1][1])]
        res['batch_norm'] = bn_breakdown(trainer, batch)
        busy = res['device_busy_ms_per_step']
        res['batch_norm']['share_of_device_busy'] = (
            res['batch_norm']['fwd_bwd_ms_per_step'] / busy if busy
            else None)
    print(f'{model_name} ({path}) train under the profiler: {steps} '
          f'steps, wall {res["wall_ms_per_step"]:.2f} ms/step, device busy '
          f'{res["device_busy_ms_per_step"]:.2f} ms/step, idle share '
          f'{res["device_idle_share"]:.4f}, '
          f'{res["kernel_launches_per_step"]:.0f} kernels/step', flush=True)
    for k, v in res['device_ms_per_step_by_kind'].items():
        print(f'  kind   {v:9.3f} ms/step {k}')
    for k, v in res['host_ms_per_step_by_range'].items():
        print(f'  range  {v:9.3f} ms/step host, '
              f'{res["device_span_ms_per_step_by_range"].get(k, 0.0):9.3f} '
              f'ms/step device span {k}')
    for k in res['device_kernels']:
        print(f'  device {k["device_ms_per_step"]:9.3f} ms/step '
              f'{k["count"]:6d}x {k["name"]}')
    for h in res['host_ops']:
        print(f'  host   {h["self_cpu_ms_per_step"]:9.3f} ms/step '
              f'{h["count"]:6d}x {h["name"]}')
    for k in res.get('conv_and_layout_kernels', []):
        print(f'  conv   {k["device_ms_per_step"]:9.3f} ms/step '
              f'{k["count_per_step"]:6.1f}x {k["name"][:120]}')
    for k, v in {**res.get('widedeep_split', {}),
                 **res.get('seq_split', {})}.items():
        print(f'  split  {v:9.3f} ms/step {k}')
    if 'group_norm' in res:
        gn = res['group_norm']
        print(f'  group_norm: {gn["layers"]} layers, forward + backward '
              f'alone {gn["fwd_bwd_ms_per_step"]:.3f} ms/step (forward '
              f'{gn["fwd_ms_per_step"]:.3f}), a share '
              f'{gn["share_of_device_busy"]} of the device-busy time; '
              f'convolutions {gn["convolutions_ms_per_step"]:.3f}, softmax '
              f'{gn["softmax_ms_per_step"]:.3f}, copies and casts '
              f'{gn["copies_casts_ms_per_step"]:.3f} ms/step')
    if 'batch_norm' in res:
        bn = res['batch_norm']
        print(f'  batch_norm: {bn["layers"]} layers, forward + backward '
              f'alone {bn["fwd_bwd_ms_per_step"]:.3f} ms/step (forward '
              f'{bn["fwd_ms_per_step"]:.3f}), a share '
              f'{bn["share_of_device_busy"]} of the device-busy time')
    return res


def seq_split(device, events, steps, names=SEQ_RANGES):
    """Device ms per step of the kernels launched inside each of the
    ``names`` ranges, forward only (the backward's kernels run outside
    any range)."""
    out = {}
    for name in names:
        spans = [(e.time_range.start, e.time_range.end) for e in device
                 if e.name == name]
        inside = [e for e in events if any(
            a <= e.time_range.start and e.time_range.end <= b
            for a, b in spans)]
        out[f'{name} forward (kernels inside its range)'] = sum(
            e.time_range.end - e.time_range.start
            for e in inside) / steps / 1e3
    return out


def widedeep_split(res, device, events, steps):
    """Wide&Deep's device ms a step in four parts and the rest: the
    embedding gathers, the tables' dense gradient (the embedding
    backward's sort and scatter kinds, and the fills of the dense
    gradient tables: kernels named ``fill``), the casts (copy / cast:
    O2's per-step bf16 copies of the tables and their gradients' way
    back to f32) and the optimizer (on the eager path the kernels inside
    the ``ParallelTrainer.optimizer`` range on the device's timeline;
    under ``step_fused``, which has no ranges, the elementwise kind but
    the fills, most of which is Adam)."""
    kinds = res['device_ms_per_step_by_kind']

    def dur(e):
        return e.time_range.end - e.time_range.start

    fill = sum(dur(e) for e in events
               if 'fill' in e.name.lower()) / steps / 1e3
    opt = [(e.time_range.start, e.time_range.end) for e in device
           if e.name == 'ParallelTrainer.optimizer']
    if opt:
        adam = sum(dur(e) for e in events if any(
            a <= e.time_range.start < b for a, b in opt)) / steps / 1e3
    else:
        adam = kinds.get('elementwise', 0.0) - fill
    split = {'gather': kinds.get('gather (index_select)', 0.0),
             'dense scatter (sort, sum, fill)': kinds.get(
                 'embedding backward (sort, scatter)', 0.0) + fill,
             'casts (copy / cast)': kinds.get('copy / cast', 0.0),
             'optimizer (Adam)': adam}
    split['rest'] = res['device_busy_ms_per_step'] - sum(split.values())
    return split


def bn_breakdown(trainer, batch, iters=5):
    """Device ms a step of every BatchNorm of the model alone: each
    one's input shape and dtype from one training forward under the
    trainer's AMP policy, then ``F.batch_norm`` (training, the layer's
    format, f32 weights, copies of its buffers) forward and backward on
    seeded inputs of those shapes, its device time under the profiler
    over ``iters`` rounds after one warm-up."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layer.norm import _BatchNormBase
    model = trainer.model
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((mod, inp[0].shape, inp[0].dtype)))
        for m in model.modules() if isinstance(m, _BatchNormBase)]
    try:
        with torch.no_grad(), trainer._autocast():
            model.train()(batch[0])
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    cases = []
    for mod, shape, dtype in seen:
        x = torch.randn(shape, generator=gen, device=trainer.device,
                        dtype=torch.float32).to(dtype).requires_grad_(True)
        cases.append((mod, x, torch.randn_like(x), mod.weight.detach()
                      .clone().requires_grad_(True), mod.bias.detach()
                      .clone().requires_grad_(True), mod._mean.clone(),
                      mod._variance.clone()))

    def run(backward):
        for mod, x, g, w, b, rm, rv in cases:
            with trainer._autocast():
                out = F.batch_norm(x, rm, rv, w, b, training=True,
                                   momentum=mod.momentum,
                                   epsilon=mod.epsilon,
                                   data_format=mod.data_format)
            if backward:
                out.backward(g)

    def timed(backward):
        """Device ms a round: the union of the kernels' intervals under
        the profiler (a loop of single BatchNorms is host-bound, so
        CUDA events would time the host)."""
        run(backward)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run(backward)
            torch.cuda.synchronize()
        busy, _ = _busy_us([e for e in prof.events()
                            if chip_smoke.is_device_event(e)
                            and e.name not in RANGES])
        return busy / iters / 1e3

    return {'layers': len(cases), 'fwd_ms_per_step': timed(False),
            'fwd_bwd_ms_per_step': timed(True),
            'input_bytes_per_step': sum(c[1].numel() * c[1].element_size()
                                        for c in cases)}


def gn_breakdown(trainer, batch, iters=5):
    """Device ms a step of every GroupNorm of the model alone, as
    ``bn_breakdown`` times the BatchNorms: each one's input shape and
    dtype from one training forward under the trainer's AMP policy, then
    ``F.group_norm`` forward and backward on seeded inputs of those
    shapes with the layer's f32 weight and bias."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layer.norm import GroupNorm
    model = trainer.model
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((mod, inp[0].shape, inp[0].dtype)))
        for m in model.modules() if isinstance(m, GroupNorm)]
    xs = [torch.from_numpy(b).to(trainer.device)
          for b in batch[:trainer.n_inputs]]
    try:
        with torch.no_grad(), trainer._autocast():
            model.train()(*xs)
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    cases = []
    for mod, shape, dtype in seen:
        x = torch.randn(shape, generator=gen, device=trainer.device,
                        dtype=torch.float32).to(dtype).requires_grad_(True)
        cases.append((mod, x, torch.randn(shape, generator=gen,
                                          device=trainer.device),
                      mod.weight.detach().clone().requires_grad_(True),
                      mod.bias.detach().clone().requires_grad_(True)))

    def run(backward):
        for mod, x, g, w, b in cases:
            with trainer._autocast():
                out = F.group_norm(x, mod.num_groups, mod.epsilon, w, b,
                                   mod.data_format)
            if backward:
                out.backward(g.to(out.dtype))

    def timed(backward):
        run(backward)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run(backward)
            torch.cuda.synchronize()
        busy, _ = _busy_us([e for e in prof.events()
                            if chip_smoke.is_device_event(e)
                            and e.name not in RANGES])
        return busy / iters / 1e3
    return {'layers': len(cases), 'fwd_ms_per_step': timed(False),
            'fwd_bwd_ms_per_step': timed(True),
            'input_bytes_per_step': sum(c[1].numel() * c[1].element_size()
                                        for c in cases)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=('gpt', 'gpt_recipe', 'longctx', 'moe',
                                        *BERT_RUN, 'resnet50', 'qat',
                                        'widedeep', 'transformer',
                                        'lstm_lm', 'ddpm_unet'),
                    default='gpt')
    ap.add_argument('--path', choices=('fused', 'eager'), default='fused')
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--out', default='build/torch_train_profile.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_train_profile: no CUDA device', file=sys.stderr)
        return 2
    name = chip_smoke.device_phase()
    chip_smoke.build_phase()
    res = {'device': name,
           'training': training_breakdown(
               args.model, args.steps, path=args.path,
               top=40 if args.model == 'resnet50' else 20)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(res, f, indent=1)
    print(f'wrote {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
