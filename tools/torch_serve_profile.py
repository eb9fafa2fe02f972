"""Where the port's serving time goes, on one CUDA card.

    python3 tools/torch_serve_profile.py [--out build/torch_serve_profile.json]

Run from the repository root.  One seeded serving run of ``gpt_small``
at full width through ``ServingEngine`` — the model, config and load of
``chip_smoke.py``, after ``warmup()`` (which captures the decode
spans' CUDA graphs) and a run on another seed — under
``torch.profiler`` (CUPTI device timestamps; the kernels inside a
graph's replay are recorded one by one): wall time, the device's busy
and idle share (the union of kernel intervals over the wall window),
device time by kernel, host time by operator, and the replays of each
decode graph.

Prints a summary and writes the whole result as JSON to ``--out``.
"""
import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the smoke's model, config and load)


def _busy_us(prof):
    """Length of the union of device-kernel intervals, and their count."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if chip_smoke.is_device_event(e))
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


def serving_breakdown(top=15):
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.serving import (ServeConfig, ServingEngine,
                                          poisson_requests)
    model = gpt_small(device='cuda', seed=0, **chip_smoke.SERVE_MODEL_KW)
    eng = ServingEngine(model, ServeConfig(**chip_smoke.SERVE_CONFIG_KW))
    eng.warmup()
    eng.run(poisson_requests(chip_smoke.NUM_REQUESTS,
                             vocab_size=model.config.vocab_size,
                             **dict(chip_smoke.SERVE_LOAD_KW, seed=3)))
    reqs = poisson_requests(chip_smoke.NUM_REQUESTS,
                            vocab_size=model.config.vocab_size,
                            **chip_smoke.SERVE_LOAD_KW)
    p0, d0 = eng.prefill_dispatches, eng.decode_steps
    graphs = chip_smoke._decode_graphs(eng)
    replays0 = {sig: g.replays for sig, g in graphs.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, n_kernels = _busy_us(prof)
    avgs = prof.key_averages()
    dev = sorted((e for e in avgs if chip_smoke.is_device_event(e)),
                 key=chip_smoke.self_device_us, reverse=True)
    host = sorted((e for e in avgs if not chip_smoke.is_device_event(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    res = {
        'wall_s': wall_us / 1e6, 'device_busy_s': busy_us / 1e6,
        'device_idle_share': 1.0 - busy_us / wall_us,
        'kernel_launches': n_kernels,
        'prefill_dispatches': eng.prefill_dispatches - p0,
        'decode_steps': eng.decode_steps - d0,
        'tokens_per_s_under_profiler': rep['tokens_per_s'],
        'decode_graph_replays': {f'{S}x{K}': g.replays - replays0[(S, K)]
                                 for (S, K), g in graphs.items()},
        'decode_graph_capture_s': {f'{S}x{K}': g.capture_s
                                   for (S, K), g in graphs.items()},
        'device_kernels': [
            {'name': e.key[:120], 'count': int(e.count),
             'device_us_total': chip_smoke.self_device_us(e)}
            for e in dev[:top]],
        'host_ops': [
            {'name': e.key[:80], 'count': int(e.count),
             'self_cpu_us_total': float(e.self_cpu_time_total)}
            for e in host[:top]],
    }
    print(f'serve under the profiler: wall {res["wall_s"]:.3f} s, device '
          f'busy {res["device_busy_s"]:.3f} s, idle share '
          f'{res["device_idle_share"]:.3f}, {n_kernels} kernels, '
          f'{res["prefill_dispatches"]} prefill dispatches + '
          f'{res["decode_steps"]} decode steps (graph replays '
          f'{res["decode_graph_replays"]})', flush=True)
    for k in res['device_kernels']:
        print(f'  device {k["device_us_total"] / 1e3:9.2f} ms '
              f'{k["count"]:7d}x {k["name"]}')
    for h in res['host_ops']:
        print(f'  host   {h["self_cpu_us_total"] / 1e3:9.2f} ms '
              f'{h["count"]:7d}x {h["name"]}')
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default='build/torch_serve_profile.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_serve_profile: no CUDA device', file=sys.stderr)
        return 2
    name = chip_smoke.device_phase()
    chip_smoke.build_phase()
    res = {'device': name, 'serving': serving_breakdown()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(res, f, indent=1)
    print(f'wrote {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
