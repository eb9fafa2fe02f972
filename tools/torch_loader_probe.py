"""Where the Flowers input pipeline's time goes, on one card.

    python3 tools/torch_loader_probe.py [--out chiprun_out/loader.json]

From the repository root.  On ``chip_smoke.hapi_flowers_phase``'s
pipeline (the synthetic Flowers-102 train split through
``RandomResizedCrop(224)``, flip, normalize and transpose, B 64, f32)
it times

1. one image's transforms in this process (64 images);
2. the loader alone over 8 batches, for each way of loading: OS-process
   workers with and without the native ring, and worker threads (4 and
   7 of each), the first batch apart from the rest;
3. one epoch (16 steps) of ``Model(resnet50(num_classes=102)).fit`` with
   ``device_prefetch`` through 4 process workers, then 4 threads, then 7
   threads, and 16 steps on batches made in this process and put on the
   card before the clock starts.

It prints the card's name and power limit, one line per reading and one
JSON object (also written to ``--out``).  Needs one CUDA card; without
one it exits non-zero.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

BATCH = 64
LOADER_BATCHES = 8
LOADERS = [('process-4-ring', dict(num_workers=4, use_process_workers=True)),
           ('process-7-ring', dict(num_workers=7, use_process_workers=True)),
           ('process-4-queue', dict(num_workers=4, use_process_workers=True,
                                    use_native_loader=False)),
           ('thread-4-ring', dict(num_workers=4)),
           ('thread-7-ring', dict(num_workers=7))]
FITS = [('process-4', dict(num_workers=4, use_process_workers=True)),
        ('thread-4', dict(num_workers=4)),
        ('thread-7', dict(num_workers=7))]


def _dataset(paddle):
    T = paddle.vision.transforms
    return paddle.vision.datasets.Flowers(mode='train', transform=T.Compose([
        T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
        T.Normalize(mean=[127.5] * 3, std=[127.5] * 3, data_format='HWC'),
        T.Transpose((2, 0, 1))]))


def _loader_alone(paddle, kw):
    ds = paddle.io.Subset(_dataset(paddle), range(BATCH * LOADER_BATCHES))
    dl = paddle.io.DataLoader(ds, batch_size=BATCH, drop_last=True, **kw)
    t0 = time.perf_counter()
    first, n = None, 0
    for _ in dl:
        if first is None:
            first = time.perf_counter() - t0
        n += 1
    dt = time.perf_counter() - t0
    return {'batches': n, 'first_s': first,
            'ms_per_batch_after_first': (dt - first) / max(1, n - 1) * 1e3}


def _fit_epoch(paddle, model, kw):
    dl = paddle.io.DataLoader(_dataset(paddle), batch_size=BATCH,
                              shuffle=True, drop_last=True,
                              device_prefetch=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(dl, epochs=1, verbose=0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(dl) * 1e3


def _staged_steps(paddle, model, n):
    from paddle_tpu_torch.io import default_collate_fn
    ds = _dataset(paddle)
    staged = []
    for i in range(n):
        x, y = default_collate_fn([ds[j] for j in
                                   range(i * BATCH, (i + 1) * BATCH)])
        staged.append((torch.from_numpy(x).cuda(),
                       torch.from_numpy(y).cuda()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in staged:
        model.train_batch([x], [y])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_loader_probe: no CUDA device', file=sys.stderr)
        return 2
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'card': card, 'cpus': os.cpu_count(), 'batch': BATCH}
    ds = _dataset(paddle)
    t0 = time.perf_counter()
    for i in range(BATCH):
        ds[i]
    out['transform_ms_per_image'] = (time.perf_counter() - t0) / BATCH * 1e3
    print(f"transforms: {out['transform_ms_per_image']:.2f} ms an image",
          flush=True)
    out['loader'] = {}
    for name, kw in LOADERS:
        r = _loader_alone(paddle, kw)
        out['loader'][name] = r
        print(f"loader {name}: first batch {r['first_s']:.3f} s, then "
              f"{r['ms_per_batch_after_first']:.1f} ms a batch", flush=True)
    net = resnet50(num_classes=102, device='cuda', seed=0)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                            parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    _staged_steps(paddle, model, 2)          # cuDNN's first calls
    out['fit_ms_per_step'] = {}
    for name, kw in FITS:
        ms = _fit_epoch(paddle, model, kw)
        out['fit_ms_per_step'][name] = ms
        print(f'fit {name}: {ms:.1f} ms/step', flush=True)
    out['staged_ms_per_step'] = _staged_steps(paddle, model,
                                              len(ds) // BATCH)
    print(f"the same steps on staged batches: "
          f"{out['staged_ms_per_step']:.1f} ms/step", flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
