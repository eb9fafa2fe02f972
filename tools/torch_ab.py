"""Phases of ``chip_smoke.py`` from two checkouts, in turns, on one card.

    python3 tools/torch_ab.py --tree parent=build/parent --tree change=. \\
        [--order 0110] [--phases gelu_kernel_phase,bert_gemm_gelu] \\
        [--out build/torch_ab.json]

Compares two versions of the port on the same card within one run: each
turn is a fresh process started in one tree's root, which builds that
tree's kernels (into its own ``build/``) and runs that tree's own
``chip_smoke.py`` phases.  ``--order`` lists the trees' indices turn by
turn (default ``0110``: parent, change, change, parent).  A phase is a
``chip_smoke`` function that takes no argument (``gelu_kernel_phase``,
``flash_kernel_phase``, ...) or ``bert_gemm_gelu``: ``bert_phase``
restricted to its ``USE_PALLAS_MLP`` run, without the f32 card-vs-CPU
step.  A phase that a tree's ``chip_smoke`` does not have (a parent's
tree before the phase was added) is recorded as ``null`` for that
tree, so one call can set an old path against its new counterpart
(``training_phase`` on the parent, ``gpt_fused_phase`` on the change).
Every turn prints its results as one JSON line; all of them are
written to ``--out``.
"""
import argparse
import json
import os
import subprocess
import sys

MARK = 'TORCH_AB_RESULT '


def run_child(phases):
    """In a tree's root: the card line, the build, then each phase."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    if not chip_smoke.torch.cuda.is_available():
        print('torch_ab: no CUDA device', file=sys.stderr)
        return 2
    for mod in ('flash_attention', 'fused_softmax', 'fused_gelu_linear'):
        chip_smoke._ops_module(mod)
    out = {'device': chip_smoke.device_phase(),
           'build_s': chip_smoke.build_phase()}
    for phase in phases:
        if phase == 'bert_gemm_gelu':
            chip_smoke.BERT_RUNS = [r for r in chip_smoke.BERT_RUNS if r[2]]
            chip_smoke._card_vs_cpu = lambda *args, **kw: None
            out[phase] = chip_smoke.bert_phase()
        elif hasattr(chip_smoke, phase):
            out[phase] = getattr(chip_smoke, phase)()
        else:
            out[phase] = None
    print(MARK + json.dumps(out), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', action='append', default=[],
                    help='NAME=DIR, a checkout of the repository')
    ap.add_argument('--order', default='0110')
    ap.add_argument('--phases', default='gelu_kernel_phase,bert_gemm_gelu')
    ap.add_argument('--out', default='build/torch_ab.json')
    ap.add_argument('--child', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(',') if p]
    if args.child:
        return run_child(phases)
    trees = [t.split('=', 1) for t in args.tree]
    if len(trees) < 2 or any(len(t) != 2 for t in trees):
        ap.error('give two or more --tree NAME=DIR')
    turns = []
    for idx in args.order:
        name, root = trees[int(idx)]
        print(f'torch_ab: turn {len(turns)}: {name} ({root})', flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--child',
             '--phases', ','.join(phases)],
            cwd=root, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f'torch_ab: turn {name} failed (exit {proc.returncode})',
                  file=sys.stderr)
            return 1
        result, = (json.loads(line[len(MARK):])
                   for line in proc.stdout.splitlines()
                   if line.startswith(MARK))
        turns.append({'tree': name, 'root': root, **result})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(turns, f, indent=1)
    print(f'wrote {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
