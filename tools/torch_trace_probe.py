"""Where a ``torch.profiler`` window loses kernel events, on one card.

    python3 tools/torch_trace_probe.py [--out chiprun_out/trace_probe.json]

Runs ``chip_smoke.py``'s GPT cell (``gpt_small``, B 8 x T 1024, bf16
O2, eager steps) and opens trace windows of 3 steps in four ways:
``plain`` (``start_profiler``, the steps, ``stop_profiler``, as the
smoke's ``profiler`` phase does), ``device_idle`` (a 20 ms device
sleep, synchronized, between the start and the steps), ``host_idle``
(0.5 s on the host there), and ``scheduled`` (``torch.profiler``'s own
schedule with one warm-up step before the 3 recorded ones).  For each
it counts the LayerNorm and flash forward kernels against the launches
the steps made, and lists the first device kernels of the window and
the time from the first step's host range to the first one, so a loss at the
window's start shows as a late first kernel.  Prints one JSON line and
writes it to ``--out``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KINDS = {'layer_norm_warp': 'ln', 'flash_fwd_mma': 'flash_fwd',
         'flash_bwd_dq_mma': 'dq', 'flash_bwd_dkv_mma': 'dkv'}
STEPS = 3


def _short(name):
    return name.split('<')[0].split('(')[0].replace('void ', '')


def _read(path, first_range=None):
    """The device events of a trace, and the start of its host range
    ``first_range`` (the same clock as the device events)."""
    from paddle_tpu_torch.profiler import trace
    doc, _ = trace._load_doc(path)
    events = [e for e in doc.get('traceEvents', []) if e.get('ph') == 'X']
    device = [e for e in events
              if str(e.get('cat', '')).lower() in trace.DEVICE_CATEGORIES]
    start = [float(e['ts']) for e in events
             if e.get('name') == first_range
             and str(e.get('cat', '')).lower() == 'user_annotation']
    return device, (start[0] if start else None)


def _report(device, start_us):
    events = sorted(device, key=lambda e: float(e['ts']))
    counts = {v: 0 for v in KINDS.values()}
    for e in events:
        for k, v in KINDS.items():
            if k in e['name']:
                counts[v] += 1
    first = [_short(e['name']) for e in events[:12]]
    lead = None
    if events and start_us is not None:
        lead = (float(events[0]['ts']) - start_us) / 1e3
    return {'kernels': counts, 'n_device_events': len(events),
            'first_kernels': first, 'first_kernel_ms_after_step_0': lead}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default='chiprun_out/trace_probe.json')
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke
    import paddle_tpu_torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    from paddle_tpu_torch.ops import _build
    chip_smoke.device_phase()
    chip_smoke.build_phase()
    cfg = GPTConfig(**chip_smoke.TRAIN_MODEL_KW)
    L = cfg.num_layers
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (chip_smoke.TRAIN_BATCH,
                            chip_smoke.TRAIN_SEQ)).astype(np.int64)
    paddle_tpu_torch.seed(0)
    model = gpt_small(device='cuda', seed=0, **chip_smoke.TRAIN_MODEL_KW)
    tr = chip_smoke._fleet_trainer(model)
    for _ in range(2):
        tr.step(ids, ids)
    torch.cuda.synchronize()
    want = {'ln': STEPS * (2 * L + 1), 'flash_fwd': STEPS * L,
            'dq': STEPS * L, 'dkv': STEPS * L}
    rows = {}

    def window(name, settle=None):
        logdir = os.path.join(ROOT, 'build', 'trace_probe', name)
        os.makedirs(logdir, exist_ok=True)
        _build.reset_launches()
        profiler.start_profiler(logdir=logdir)
        if settle is not None:
            settle()
        for i in range(STEPS):
            with profiler.RecordEvent(f'probe_step_{i}'):
                tr.step(ids, ids)
        path = profiler.stop_profiler()
        trace = profiler.find_traces(path)[-1]
        rows.setdefault(name, []).append(
            _report(*_read(trace, 'probe_step_0')))

    def device_idle():
        torch.cuda._sleep(40_000_000)       # ~20 ms at 1.98 GHz
        torch.cuda.synchronize()

    for _ in range(2):
        window('plain')
        window('device_idle', device_idle)
        window('host_idle', lambda: time.sleep(0.5))
    # torch.profiler's schedule: one warm-up step, then STEPS recorded
    logdir = os.path.join(ROOT, 'build', 'trace_probe', 'scheduled')
    os.makedirs(logdir, exist_ok=True)
    for _ in range(2):
        path = os.path.join(logdir, f'{time.time_ns()}.trace.json')
        sched = torch.profiler.schedule(wait=0, warmup=1, active=STEPS,
                                        repeat=1)
        with torch.profiler.profile(
                activities=profiler._activities(), schedule=sched,
                on_trace_ready=lambda p, path=path:
                p.export_chrome_trace(path)) as p:
            for _ in range(1 + STEPS):
                tr.step(ids, ids)
                torch.cuda.synchronize()
                p.step()
        rows.setdefault('scheduled', []).append(_report(*_read(path)))
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {'card': card, 'launched': want, 'windows': rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
