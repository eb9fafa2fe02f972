"""Which PyTorch routes let a CUDA graph's captured code draw a second
time what it drew before, on one card.

    python3 tools/torch_rng_graph_probe.py [--out chiprun_out/rng_graph_probe.json]

A recomputed region inside a captured step must draw in its
recomputation what its forward drew, and each replay must draw new
numbers.  ``core.rng`` does it with a warm-up that learns the region's
offset in the stream of draws and one more generator registered before
the capture.  This probe tries the shorter routes inside a capture on a
registered ``torch.Generator``, each a draw before the region (so the
region starts mid-capture), the region's forward draw ``a``, then the
route's rewind, then a second draw ``b``, replayed twice:

- ``clone_state``: ``Generator.clone_state()`` at the region's start,
  registered with the graph during the capture, set back with
  ``graphsafe_set_state`` for the second draw;
- ``graphsafe_get_state``: the state taken with ``graphsafe_get_state``
  at the start, set back with ``graphsafe_set_state``;
- ``get_state``: ``get_state``/``set_state``.

A route works when it captures and, in both replays, ``b == a`` and the
two replays' ``a`` differ (``b_equals_pre`` shows a rewind to the
capture's start instead of the region's).  Prints one JSON line and writes it to
``--out``.
"""
import argparse
import json
import os
import subprocess
import sys
import traceback


def _route(name):
    import torch
    dev = 'cuda'
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    out = {}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.rand(4, generator=gen, device=dev)     # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(graph, stream=stream):
            # a draw before the region: the region starts mid-capture
            pre = torch.rand(4, generator=gen, device=dev)
            if name == 'clone_state':
                start = gen.clone_state()
                graph.register_generator_state(start)
            elif name == 'graphsafe_get_state':
                start = gen.graphsafe_get_state()
            else:
                start = gen.get_state()
            a = torch.rand(4, generator=gen, device=dev)
            if name == 'get_state':
                now = gen.get_state()
                gen.set_state(start)
            else:
                now = gen.graphsafe_get_state()
                gen.graphsafe_set_state(start)
            b = torch.rand(4, generator=gen, device=dev)
            if name == 'get_state':
                gen.set_state(now)
            else:
                gen.graphsafe_set_state(now)
    except Exception as exc:       # the route cannot be captured
        out['capture_error'] = f'{type(exc).__name__}: {exc}'.strip()[:300]
        out['works'] = False
        try:
            torch.cuda.synchronize()
        except Exception:
            out['trace'] = traceback.format_exc()[-300:]
        return out
    draws = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        draws.append((a.clone(), b.clone(), pre.clone()))
    repeats = [bool(torch.equal(x, y)) for x, y, _ in draws]
    replays_pre = [bool(torch.equal(y, p)) for _, y, p in draws]
    fresh = not torch.equal(draws[0][0], draws[1][0])
    out.update({'b_equals_a': repeats, 'b_equals_pre': replays_pre,
                'replays_differ': fresh,
                'works': all(repeats) and fresh})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default='chiprun_out/rng_graph_probe.json')
    ap.add_argument('--route', default=None,
                    help='run one route in this process (the probe runs '
                         'each in a process of its own: a failed capture '
                         'can leave the context unusable)')
    args = ap.parse_args()
    if args.route:
        print(json.dumps(_route(args.route)))
        return
    import torch
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {'card': card, 'torch': torch.__version__}
    for name in ('clone_state', 'graphsafe_get_state', 'get_state'):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--route', name], capture_output=True,
                             text=True, timeout=300)
        lines = run.stdout.strip().splitlines()
        try:
            res[name] = json.loads(lines[-1])
        except (IndexError, ValueError):
            res[name] = {'works': False, 'rc': run.returncode,
                         'stderr': run.stderr[-400:]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == '__main__':
    main()
