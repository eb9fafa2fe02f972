"""DCGAN's f32 iteration on the card against a float64 witness, on one
CUDA card.

    python3 tools/torch_dcgan_witness.py [--out build/dcgan_witness.json]

Run from the repository root.  One D + G iteration of
``chip_smoke.dcgan_iteration`` at the smoke's parity batch (B 8, the
published widths, seed 0) on the CPU in float64 with exact batch
statistics (``chip_smoke._exact_batch_norm``: the port's BatchNorm keeps
f32 statistics for any other dtype), on the CPU in f32, and on the card
in f32 under cuDNN's defaults, ``deterministic``, ``benchmark`` and
with cuDNN off; then the card again with the CPU's f32 run taking the
card's ReLU and LeakyReLU branches (``chip_smoke._activation_masks``,
the smoke's parity).  For each run it prints every gradient's worst
gap over the witness (max |diff| over the witness's max |value|) and
the worst gap between card and CPU.
"""
import argparse
import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the smoke's DCGAN and helpers)


def iteration(dev, dtype, masks=None, parted=None, replay=False):
    """{name: gradient as float64 on the CPU} of one iteration."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    G, D, opt_g, opt_d, real, z = chip_smoke._dcgan_on(
        dev, chip_smoke.DCGAN_PARITY_BATCH)
    keep = F.batch_norm
    if dtype == torch.float64:
        G, D = G.double(), D.double()
        opt_g, opt_d = chip_smoke.dcgan_optimizers(paddle, G, D)
        real, z = real.double(), z.double()
        F.batch_norm = chip_smoke._exact_batch_norm
    grads = {}
    ctx = contextlib.nullcontext() if masks is None else \
        chip_smoke._activation_masks(masks, parted, replay)
    try:
        with ctx:
            chip_smoke.dcgan_iteration(paddle, G, D, opt_g, opt_d, real, z,
                                       grads)
    finally:
        F.batch_norm = keep
    return {n: g.detach().cpu().double() for n, g in grads.items()}


def worst(got, want):
    return max((float((got[n] - w).abs().max()) / max(
        float(w.abs().max()), 1e-30), n) for n, w in want.items())


@contextlib.contextmanager
def cudnn_flag(name, value):
    prev = getattr(torch.backends.cudnn, name)
    setattr(torch.backends.cudnn, name, value)
    try:
        yield
    finally:
        setattr(torch.backends.cudnn, name, prev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default='build/dcgan_witness.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_dcgan_witness: no CUDA device', file=sys.stderr)
        return 2
    name = chip_smoke.device_phase()
    exact = iteration('cpu', torch.float64)
    cpu = iteration('cpu', torch.float32)
    res = {'device': name, 'cpu_f32_vs_witness': worst(cpu, exact)}
    for what, ctx in (('default', contextlib.nullcontext()),
                      ('deterministic', cudnn_flag('deterministic', True)),
                      ('benchmark', cudnn_flag('benchmark', True)),
                      ('cudnn off', cudnn_flag('enabled', False))):
        with ctx:
            card = iteration('cuda', torch.float32)
        res[what] = {'card_vs_witness': worst(card, exact),
                     'card_vs_cpu': worst(card, cpu)}
    masks, parted = [], []
    card = iteration('cuda', torch.float32, masks, parted)
    cpu_on_card = iteration('cpu', torch.float32, masks, parted, True)
    res['cpu on the card\'s branches'] = {
        'card_vs_cpu': worst(card, cpu_on_card),
        'inputs_parted': int(sum(int(p.sum()) for p in parted)),
        'inputs': sum(m.numel() for m in masks)}
    for k, v in res.items():
        print(f'{k}: {v}')
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
