"""Host cost of the kernels' forward wrappers on the eager paths, on one
card.

    python3 tools/torch_dispatch_cost.py [--tree DIR] [--label NAME] \\
        [--out chiprun_out/dispatch_NAME.json]

Since the forward kernels became ``torch.library`` operators
(``paddle_tpu_torch/ops/_library.py``), each eager call of a wrapper
passes PyTorch's dispatcher before its ``ctypes`` launch.  This times,
for the tree at ``--tree`` (default: this one; a parent unpacked with
``git archive`` into a directory ``.gitignore`` lists is the "before"):

- ``wrapper_us``: microseconds per call of each forward wrapper at a
  shape whose kernel takes a few microseconds (LayerNorm at decode's 8 x
  768 f32, the softmax over 8 x 12 x 128 f32 scores, flash over 96 x 16
  x 64 bf16, GEMM+GELU 8 x 768 x 3072 bf16), 2000 back-to-back calls
  between CUDA events: the host's work per call;
- ``op_vs_direct_us`` (a tree with the operators only): the same four
  calls' forward through the operator (``_fwd``, what the wrappers
  call) and straight to the launch (``_fwd_cuda``), in turns over 5
  rounds of 2000 calls each, medians and their difference: the
  dispatcher's own cost per call, apart from the host's drift;
- ``gpt_step_ms``: the eager ``gpt_small`` training step of
  ``chip_smoke.training_phase`` (B 8, T 1024, bf16 O2), 2 warm-up and 10
  timed steps;
- ``generate_ms_per_token``: ``generate``'s body run eagerly
  (``chip_smoke._generate_eager``, B 8, 128 + 128, f32), ms per token
  step of the second call.

Two trees in one command (parent, change, change, parent) compare on
one card and host.  Prints one ``DISPATCH_COST`` JSON line.
"""
import argparse
import json
import os
import sys
import time

WRAPPER_CALLS = 2000


def _calls(torch):
    """``{name: (wrapper call, operator call, direct launch)}`` of the
    four forward kernels at their small shapes; the last two None where
    the tree has no operators (``ops.fused_norm._OP``)."""
    import importlib
    fn, fs, fa, fg = (importlib.import_module(f'paddle_tpu_torch.ops.{m}')
                      for m in ('fused_norm', 'fused_softmax',
                                'flash_attention', 'fused_gelu_linear'))
    g = torch.Generator(device='cuda').manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device='cuda').to(dtype)
    x, gamma, beta = rand(8, 768), rand(768), rand(768)
    scores = rand(8, 12, 1, 128)
    q, k, v = (rand(96, 16, 64, dtype=torch.bfloat16) for _ in range(3))
    xg = rand(8, 768, dtype=torch.bfloat16)
    w = rand(768, 3072, dtype=torch.bfloat16)
    b = rand(3072, dtype=torch.bfloat16)
    calls = {
        'fused_layer_norm': (lambda: fn.fused_layer_norm(x, gamma, beta),
                             lambda: fn._fwd(x, gamma, beta, 1e-5),
                             lambda: fn._fwd_cuda(x, gamma, beta, 1e-5)),
        'fused_softmax': (lambda: fs.fused_softmax(scores),
                          lambda: fs._fwd(scores, None),
                          lambda: fs._fwd_cuda(scores, None)),
        'flash_attention': (lambda: fa.flash_attention(q, k, v),
                            lambda: fa._fwd(q, k, v, False, 0.125),
                            lambda: fa._fwd_cuda(q, k, v, False, 0.125)),
        'fused_linear_gelu': (lambda: fg.fused_linear_gelu(xg, w, b),
                              lambda: fg._fwd(xg, w, b, True),
                              lambda: fg._fwd_cuda(xg, w, b, True))}
    if not hasattr(fn, '_OP'):
        calls = {k: (c[0], None, None) for k, c in calls.items()}
    return calls


def wrapper_us(cs, calls):
    """Microseconds per call of each public wrapper."""
    return {name: cs.time_ms(c[0], iters=WRAPPER_CALLS, warmup=200) * 1e3
            for name, c in calls.items()}


def op_vs_direct_us(cs, calls, rounds=5):
    """``{name: {'op': us, 'direct': us, 'added': us, ...}}``: medians
    over ``rounds`` turns of 2000 calls through the operator and
    straight to the launch; None where the tree has no operators."""
    import statistics
    if any(c[1] is None for c in calls.values()):
        return None
    out = {}
    for name, (_, via_op, direct) in calls.items():
        a, d = [], []
        for _ in range(rounds):
            a.append(cs.time_ms(via_op, iters=WRAPPER_CALLS,
                                warmup=100) * 1e3)
            d.append(cs.time_ms(direct, iters=WRAPPER_CALLS,
                                warmup=100) * 1e3)
        out[name] = {'op': statistics.median(a),
                     'direct': statistics.median(d),
                     'added': statistics.median(a) - statistics.median(d),
                     'op_range': [min(a), max(a)],
                     'direct_range': [min(d), max(d)]}
    return out


def gpt_step_ms(cs, torch, np):
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=0, **cs.TRAIN_MODEL_KW)
    trainer = cs._trainer(model, amp_o2=True)
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (cs.TRAIN_BATCH, cs.TRAIN_SEQ)) \
        .astype(np.int64)
    losses, _, _, dt, _ = cs._run_steps(trainer, (ids, ids), 2, 10)
    del model, trainer
    cs._free()
    return dt / 10 * 1e3, losses


def generate_ms(cs, torch, np):
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=0, **cs.GEN_MODEL_KW).eval()
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (cs.GEN_BATCH, cs.GEN_PROMPT)) \
        .astype(np.int64)
    cs._generate_eager(model, ids, cs.GEN_PROMPT, cs.GEN_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs._generate_eager(model, ids, cs.GEN_PROMPT, cs.GEN_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del model
    cs._free()
    return dt / cs.GEN_NEW * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--label', default='tree')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    out = os.path.abspath(args.out or os.path.join(
        'chiprun_out', f'dispatch_{args.label}.json'))
    os.chdir(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import chip_smoke as cs
    torch = cs.torch
    if not torch.cuda.is_available():
        print('torch_dispatch_cost: no CUDA device', file=sys.stderr)
        return 2
    for mod in ('flash_attention', 'fused_softmax', 'fused_gelu_linear'):
        cs._ops_module(mod)
    card = cs.device_phase()
    cs.build_phase()
    calls = _calls(torch)
    with torch.no_grad():
        res = {'label': args.label, 'tree': tree, 'card': card,
               'wrapper_us': wrapper_us(cs, calls),
               'op_vs_direct_us': op_vs_direct_us(cs, calls)}
    res['gpt_step_ms'], res['gpt_losses'] = gpt_step_ms(cs, torch, np)
    res['generate_ms_per_token'] = generate_ms(cs, torch, np)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, 'w') as f:
        json.dump(res, f, indent=1)
    print('DISPATCH_COST ' + json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
