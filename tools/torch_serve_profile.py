"""Where the port's serving time goes, on one CUDA card.

    python3 tools/torch_serve_profile.py [--path serve|generate]
        [--quantize int8|int4] [--out build/torch_serve_profile.json]

Run from the repository root.  ``--path serve`` (the default): one
seeded serving run of ``gpt_small`` at full width through
``ServingEngine`` — the model, config and load of ``chip_smoke.py``,
after ``warmup()`` (which captures the prefill and decode CUDA graphs)
and a run on another seed.  ``--path generate``: ``generate`` at
``chip_smoke.py``'s gptgen configuration (B 8, 128 + 128 tokens,
greedy), its graph captured by a first call, then two calls.
``--quantize`` serves (or generates with) the weight-only PTQ model.

Under ``torch.profiler`` (CUPTI device timestamps; the kernels inside a
graph's replay are recorded one by one): wall time, the device's busy
and idle share (the union of kernel intervals over the wall window),
device time by kernel, host time by operator, and for ``serve`` the
replays of each graph and the device time of the kernels inside the
prefill graphs' replays apart from the decode graphs' (each replay runs
inside a ``record_function`` range, which the profiler also marks on the
device's timeline; a kernel counts for the range its midpoint lies in).

Prints a summary and writes the whole result as JSON to ``--out``.
"""
import argparse
import bisect
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the smoke's model, config and load)

PREFILL, DECODE = 'serve.prefill_graph', 'serve.decode_graph'
RANGES = (PREFILL, DECODE) + chip_smoke.ANNOTATIONS


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


def _by_range(device, kernels, names):
    """Device us of the kernels whose midpoint lies inside the device
    spans of each named range ({name: (us, kernels)}, None where the
    profiler marked no span of it), and of the rest."""
    out, claimed = {}, set()
    for name in names:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in device if e.name == name)
        if not spans:
            out[name] = None
            continue
        starts = [s for s, _ in spans]
        us, n = 0.0, 0
        for i, e in enumerate(kernels):
            mid = (e.time_range.start + e.time_range.end) / 2
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and mid <= spans[j][1]:
                us += e.time_range.end - e.time_range.start
                n += 1
                claimed.add(i)
        out[name] = (us, n)
    rest = sum(e.time_range.end - e.time_range.start
               for i, e in enumerate(kernels) if i not in claimed)
    return out, rest


def _annotate(eng):
    """Runs every prefill and decode module call of ``eng`` inside its
    ``record_function`` range."""
    make_prefill, make_decode = eng._prefill_module, eng._decode_module

    def ranged(mod, name):
        def call(plan):
            with record_function(name):
                return mod(plan)
        return call

    eng._prefill_module = lambda P, B: ranged(make_prefill(P, B), PREFILL)
    eng._decode_module = lambda S, K: ranged(make_decode(S, K), DECODE)


def _profiled(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if chip_smoke.is_device_event(e)]
    kernels = [e for e in device if e.name not in RANGES]
    return prof, out, wall_us, device, kernels


def _tables(prof, res, top):
    avgs = prof.key_averages()
    dev = sorted((e for e in avgs if chip_smoke.is_device_event(e)
                  and e.key not in RANGES),
                 key=chip_smoke.self_device_us, reverse=True)
    host = sorted((e for e in avgs if not chip_smoke.is_device_event(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    res['device_kernels'] = [
        {'name': e.key[:120], 'count': int(e.count),
         'device_us_total': chip_smoke.self_device_us(e)}
        for e in dev[:top]]
    res['host_ops'] = [
        {'name': e.key[:80], 'count': int(e.count),
         'self_cpu_us_total': float(e.self_cpu_time_total)}
        for e in host[:top]]
    for k in res['device_kernels']:
        print(f'  device {k["device_us_total"] / 1e3:9.2f} ms '
              f'{k["count"]:7d}x {k["name"]}')
    for h in res['host_ops']:
        print(f'  host   {h["self_cpu_us_total"] / 1e3:9.2f} ms '
              f'{h["count"]:7d}x {h["name"]}')
    return res


def serving_breakdown(quantize=None, top=15):
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.serving import (ServeConfig, ServingEngine,
                                          poisson_requests)
    model = gpt_small(device='cuda', seed=0, **chip_smoke.SERVE_MODEL_KW)
    eng = ServingEngine(model, ServeConfig(**chip_smoke.SERVE_CONFIG_KW,
                                           quantize=quantize))
    eng.warmup()
    eng.run(poisson_requests(chip_smoke.NUM_REQUESTS,
                             vocab_size=model.config.vocab_size,
                             **dict(chip_smoke.SERVE_LOAD_KW, seed=3)))
    reqs = poisson_requests(chip_smoke.NUM_REQUESTS,
                            vocab_size=model.config.vocab_size,
                            **chip_smoke.SERVE_LOAD_KW)
    p0, d0 = eng.prefill_dispatches, eng.decode_steps
    decode = chip_smoke._decode_graphs(eng)
    prefill = chip_smoke._prefill_graphs(eng)
    dr0 = {sig: g.replays for sig, g in decode.items()}
    pr0 = {sig: g.replays for sig, g in prefill.items()}
    _annotate(eng)
    prof, rep, wall_us, device, kernels = _profiled(lambda: eng.run(reqs))
    busy_us, n_kernels = _busy_us(kernels)
    split, rest_us = _by_range(device, kernels, (PREFILL, DECODE))

    def ms(name):
        return None if split[name] is None else split[name][0] / 1e3

    res = {
        'path': 'serve', 'quantize': quantize,
        'wall_s': wall_us / 1e6, 'device_busy_s': busy_us / 1e6,
        'device_idle_share': 1.0 - busy_us / wall_us,
        'kernel_launches': n_kernels,
        'prefill_dispatches': eng.prefill_dispatches - p0,
        'decode_steps': eng.decode_steps - d0,
        'tokens_per_s_under_profiler': rep['tokens_per_s'],
        'ttft_p50_s': rep['ttft_p50_s'], 'tpot_mean_s': rep['tpot_mean_s'],
        'prefill_graph_device_ms': ms(PREFILL),
        'prefill_graph_kernels': None if split[PREFILL] is None
        else split[PREFILL][1],
        'decode_graph_device_ms': ms(DECODE),
        'decode_graph_kernels': None if split[DECODE] is None
        else split[DECODE][1],
        'other_device_ms': rest_us / 1e3,
        'decode_graph_replays': {f'{S}x{K}': g.replays - dr0[(S, K)]
                                 for (S, K), g in decode.items()},
        'prefill_graph_replays': {f'{P}x{B}': g.replays - pr0[(P, B)]
                                  for (P, B), g in prefill.items()},
        'decode_graph_capture_s': {f'{S}x{K}': g.capture_s
                                   for (S, K), g in decode.items()},
        'prefill_graph_capture_s': {f'{P}x{B}': g.capture_s
                                    for (P, B), g in prefill.items()},
    }
    print(f'serve{"" if quantize is None else " " + quantize} under the '
          f'profiler: wall {res["wall_s"]:.3f} s, device busy '
          f'{res["device_busy_s"]:.3f} s, idle share '
          f'{res["device_idle_share"]:.3f}, {n_kernels} kernels, '
          f'{res["prefill_dispatches"]} prefill dispatches (prefill graphs '
          f'{res["prefill_graph_device_ms"]} device ms) + '
          f'{res["decode_steps"]} decode steps (decode graphs '
          f'{res["decode_graph_device_ms"]} device ms), other '
          f'{res["other_device_ms"]:.2f} ms; decode replays '
          f'{res["decode_graph_replays"]}, prefill replays '
          f'{res["prefill_graph_replays"]}', flush=True)
    return _tables(prof, res, top)


def generate_breakdown(quantize=None, calls=2, top=15):
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.quantization import quantize_for_serving
    model = gpt_small(device='cuda', seed=0, **chip_smoke.GEN_MODEL_KW)
    if quantize is not None:
        quantize_for_serving(model, quantize)
    B, T0, N = chip_smoke.GEN_BATCH, chip_smoke.GEN_PROMPT, chip_smoke.GEN_NEW
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (B, T0)).astype(np.int64)
    model.generate(ids, N, temperature=0)           # capture
    mod, = model._gen_cache.modules.values()

    def run():
        for _ in range(calls):
            model.generate(ids, N, temperature=0)

    prof, _, wall_us, _, kernels = _profiled(run)
    busy_us, n_kernels = _busy_us(kernels)
    res = {
        'path': 'generate', 'quantize': quantize, 'calls': calls,
        'wall_ms_per_call': wall_us / calls / 1e3,
        'device_busy_ms_per_call': busy_us / calls / 1e3,
        'device_idle_share': 1.0 - busy_us / wall_us,
        'kernels_per_call': n_kernels / calls,
        'ms_per_token_step': wall_us / calls / N / 1e3,
        'tokens_per_s_under_profiler': B * N * calls / (wall_us / 1e6),
        'capture_s': mod.capture_s,
    }
    print(f'generate{"" if quantize is None else " " + quantize} B {B}, '
          f'{T0} + {N} under the profiler: {res["wall_ms_per_call"]:.2f} ms '
          f'a call ({res["ms_per_token_step"]:.3f} a token step), device '
          f'busy {res["device_busy_ms_per_call"]:.2f} ms, idle share '
          f'{res["device_idle_share"]:.3f}, {res["kernels_per_call"]:.0f} '
          f'kernels a call ({res["kernels_per_call"] / N:.1f} a token '
          f'step)', flush=True)
    return _tables(prof, res, top)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', choices=('serve', 'generate'), default='serve')
    ap.add_argument('--quantize', choices=('int8', 'int4'), default=None)
    ap.add_argument('--out', default='build/torch_serve_profile.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_serve_profile: no CUDA device', file=sys.stderr)
        return 2
    name = chip_smoke.device_phase()
    chip_smoke.build_phase()
    run = serving_breakdown if args.path == 'serve' else generate_breakdown
    res = {'device': name, args.path: run(quantize=args.quantize)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(res, f, indent=1)
    print(f'wrote {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
