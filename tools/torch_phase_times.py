"""Wall seconds of each ``chip_smoke.py`` phase, on one card.

    python3 tools/torch_phase_times.py [--tree DIR] [--label NAME] \\
        [--out chiprun_out/phase_times_NAME.json] [PHASE ...]

With no ``PHASE``, runs the tree's whole ``chip_smoke.main()`` (every
check and its JSON lines) with each ``*_phase`` function timed, and
reports the seconds of each call and of the whole run.  With phase
names (``transformer lstm_lm ...``: ``chip_smoke.<name>_phase``, no
argument), runs the card line, the build and those phases only.
``--tree`` is a checkout of the repository (default: this one); two
calls in one command, one a tree per checkout (a parent unpacked with
``git archive`` into a directory ``.gitignore`` lists), time both on
the same card and host, which is how the smoke's growth is compared:
the run's total moves with the host by more than a phase takes.
Prints one ``PHASE_TIMES`` line and writes the JSON to ``--out``.
"""
import argparse
import functools
import json
import os
import sys
import time


def _timed(module, times):
    """Every ``*_phase`` function of ``module`` wrapped to append
    ``(name, seconds)`` to ``times`` when it returns or raises."""
    for name in dir(module):
        fn = getattr(module, name)
        if not (name.endswith('_phase') and callable(fn)):
            continue

        def wrap(fn=fn, name=name):
            @functools.wraps(fn)
            def inner(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    times.append((name, time.perf_counter() - t0))
            return inner
        setattr(module, name, wrap())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--label', default='tree')
    ap.add_argument('--out', default=None)
    ap.add_argument('phases', nargs='*')
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    out = args.out or os.path.join('chiprun_out',
                                   f'phase_times_{args.label}.json')
    out = os.path.abspath(out)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke
    if not chip_smoke.torch.cuda.is_available():
        print('torch_phase_times: no CUDA device', file=sys.stderr)
        return 2
    times = []
    _timed(chip_smoke, times)
    t0 = time.perf_counter()
    if args.phases:
        for mod in ('flash_attention', 'fused_softmax', 'fused_gelu_linear'):
            chip_smoke._ops_module(mod)
        chip_smoke.device_phase()
        chip_smoke.build_phase()
        for phase in args.phases:
            getattr(chip_smoke, phase + '_phase')()
        rc = 0
    else:
        rc = chip_smoke.main()
    total = time.perf_counter() - t0
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, 'w') as f:
        json.dump({'tree': tree, 'rc': rc, 'total_s': total,
                   'phases': times}, f, indent=1)
    print('PHASE_TIMES', args.label, rc, round(total, 1),
          json.dumps([(n, round(s, 1)) for n, s in times]), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
