"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root, with one CUDA card.  It

1. prints the card (``nvidia-smi`` name and power limit) and turns
   TF32 off for matmuls and cuDNN, so f32 means f32;
2. builds every kernel under ``paddle_tpu_torch/csrc/`` with nvcc (one
   process per source, all at once) and prints the build seconds;
3. holds each kernel to its plain PyTorch twin at the shapes its
   paths give it, with the tolerance stated, and times the kernel, the
   twin and one PyTorch library call computing the same function beside
   the least time the card could take: device time per call from
   ``torch.profiler`` (``ms``), and time per call of a back-to-back
   loop between CUDA events (``call_ms``, which includes the host's
   launch work).  LayerNorm at the serving and training shapes; the
   three flash attention kernels (forward, dq, dk/dv) at the training
   shape (96 x 1024 x 64 bf16 causal), in f32, in ``'strict'`` mode
   with an lse cotangent, and at a ragged T of 200;
4. serves 32 seeded Poisson requests with ``gpt_small`` at full width
   (random seeded weights) through ``ServingEngine`` with the
   benchmark's serving config, and checks the outcome: every request
   done, allocator audit clean, every block back, the kernels'
   launch counts match the dispatches, greedy streams equal batch-1
   ``generate``, and the card's prefill logits agree with the same
   weights run on the CPU through the plain twins;
5. trains ``gpt_small`` at full width (random seeded weights) through
   ``ParallelTrainer.step`` in the benchmark's configuration (B 8, T
   1024, bf16 O2, fused CE head in 8 chunks, AdamW lr 3e-4): 2 warm-up
   and 5 timed steps on one seeded batch.  It checks that every loss is
   finite and the last is below the first, that each flash kernel ran
   12 times and LayerNorm 25 times per step, and that one f32 step at
   B 1, T 256 gives the card the same loss and gradients as the same
   weights on the CPU through the plain twins; it prints ms/step,
   tokens/s, peak device memory and an MFU share;
6. prints one JSON line listing every kernel, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero.  Without a
CUDA device it exits non-zero before printing any result.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores and dense bf16 on them; a bound is the larger of
# bytes/bandwidth and operations/peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

KERNEL_SHAPES = [((64, 768), torch.float32, 1e-5),     # decode, S=64
                 ((512, 768), torch.float32, 1e-5),    # prefill, 8 x 64
                 ((512, 768), torch.bfloat16, 2e-2),   # the AMP slices
                 ((8192, 768), torch.bfloat16, 2e-2)]  # training, B8 T1024

# flash attention cases: (case, B, H, T, D, dtype, causal, with g_lse),
# the first being the training path's shape.  Tolerances (kernel vs its
# own twin, |got - want| <= tol * (1 + |want|)): f32 1e-5 on o and lse
# and 1e-4 on dq/dk/dv (online softmax and tile sums in another order
# than the twin's whole-row matmuls); bf16 2e-2 on o/dq/dk/dv (both
# round the f32 result to bf16) and 1e-4 on the f32 lse
FLASH_CASES = [('train', 8, 12, 1024, 64, torch.bfloat16, True, False),
               ('f32', 8, 12, 1024, 64, torch.float32, True, False),
               ('strict', 8, 12, 1024, 64, torch.bfloat16, 'strict', True),
               ('ragged', 8, 12, 200, 64, torch.float32, False, False)]
FLASH_TOL = {torch.float32: (1e-5, 1e-5, 1e-4),
             torch.bfloat16: (2e-2, 1e-4, 2e-2)}
FLASH_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv')

SERVE_MODEL_KW = dict(max_seq_len=256, dropout=0.0)
SERVE_CONFIG_KW = dict(block_size=16, max_slots=64, decode_span=8,
                       prompt_buckets=(32, 64), batch_buckets=(8, 64),
                       max_model_len=160, temperature=0.0)
SERVE_LOAD_KW = dict(rate_rps=100.0, prompt_lens=(24, 32, 48, 64),
                     new_tokens=(32, 64), seed=7)
NUM_REQUESTS = 32
LOGIT_TOL = 1e-3        # card vs CPU, 12 f32 layers, sums reordered

# the benchmark's training configuration (bench.py::_bench_gpt_train)
TRAIN_MODEL_KW = dict(max_seq_len=1024, dropout=0.0, fused_head=True,
                      fused_head_chunks=8)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 1024, 3e-4
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# one f32 step on the card vs the CPU: loss relative, each gradient's
# max |diff| relative to its max |value| (12 layers, sums reordered)
PARITY_SEQ, PARITY_LOSS_RTOL, PARITY_GRAD_RTOL = 256, 1e-4, 1e-3


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=200, warmup=20):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls,
    CUDA events around the run: the device's time when it is the slower
    side, the host's launch work when that is."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def is_device_event(evt):
    return str(getattr(evt, 'device_type', '')).endswith('CUDA')


def self_device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_ms(fn, iters=100):
    """Mean device time per call of ``fn``: the summed durations of the
    device kernels it ran (CUPTI timestamps, ``torch.profiler``) over
    ``iters`` calls.  None when the profiler saw no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(self_device_us(e) for e in prof.key_averages()
                if is_device_event(e))
    return total / iters / 1e3 if total > 0 else None


def time_row(row, fns, iters=200, warmup=20, prof_iters=100):
    """Fill ``row`` with ``<key>ms``/``<key>call_ms``/``<key>ms_from``
    for each ``{key: fn}``: device time per call from the profiler
    where it sees the kernels, else the per-call time of a
    back-to-back loop."""
    for key, fn in fns.items():
        call = time_ms(fn, iters=iters, warmup=warmup)
        dev = device_ms(fn, iters=prof_iters)
        row[f'{key}call_ms'] = call
        row[f'{key}ms'] = call if dev is None else dev
        row[f'{key}ms_from'] = 'events' if dev is None else 'profiler'
    return row


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by) from bytes over HBM bandwidth and flops over
    the dtype's peak."""
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def layer_norm_bound(n, h, dtype):
    """(bound_ms, bound_by): x read and y written once, f32 mean/rstd
    written, f32 gamma/beta read; about 8 flops per element."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = n * h * 2 * esize + 8 * n + 2 * h * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 8.0 * n * h / F32_FLOPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def device_phase():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f'device: {name}, count {torch.cuda.device_count()}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('tf32: torch.backends.cuda.matmul.allow_tf32=False, '
        'torch.backends.cudnn.allow_tf32=False')
    return name


def build_phase():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    log(f'build: {len(paths)} kernel source(s) in {secs:.2f} s '
        f'({", ".join(_build.sources())})')
    return secs


def kernel_phase():
    """fused_layer_norm against its plain twin on the card."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import fused_norm
    rows = []
    gen = torch.Generator().manual_seed(0)
    for (n, h), dtype, tol in KERNEL_SHAPES:
        x = (torch.randn((n, h), generator=gen) * 2 + 0.5) \
            .to('cuda', dtype)
        g = (1 + 0.1 * torch.randn((h,), generator=gen)).cuda()
        b = (0.1 * torch.randn((h,), generator=gen)).cuda()
        y, mean, rstd = fused_norm._fwd_cuda(x, g, b, 1e-5)
        ry, rmean, rrstd = fused_norm._reference(x, g, b, 1e-5)
        torch.cuda.synchronize()
        err = float((y.float() - ry.float()).abs().max())
        stat_err = max(float((mean - rmean).abs().max()),
                       float((rstd - rrstd).abs().max()))
        if not (err <= tol and stat_err <= 1e-5):
            raise AssertionError(
                f'fused_layer_norm {n}x{h} {dtype}: max |y - plain| '
                f'{err:.3e} (tol {tol}), stats {stat_err:.3e} (tol 1e-5)')
        gl, bl = g.to(dtype), b.to(dtype)
        fns = {'': lambda: fused_norm._fwd_cuda(x, g, b, 1e-5),
               'plain_': lambda: fused_norm._reference(x, g, b, 1e-5),
               'library_': lambda: TF.layer_norm(x, (h,), gl, bl, 1e-5)}
        row = {'shape': [n, h], 'dtype': str(dtype).replace('torch.', ''),
               'tol': tol, 'max_abs_err': err}
        time_row(row, fns)
        row['bound_ms'], row['bound_by'] = layer_norm_bound(n, h, dtype)
        log(f'kernel fused_layer_norm {n}x{h} {row["dtype"]}: '
            f'max_abs_err {err:.3e} (tol {tol}) | device: kernel '
            f'{row["ms"] * 1e3:.2f} us, plain {row["plain_ms"] * 1e3:.2f} '
            f'us, F.layer_norm {row["library_ms"] * 1e3:.2f} us '
            f'({row["ms_from"]}) | per call: kernel '
            f'{row["call_ms"] * 1e3:.2f} us, plain '
            f'{row["plain_call_ms"] * 1e3:.2f} us, F.layer_norm '
            f'{row["library_call_ms"] * 1e3:.2f} us | bound '
            f'{row["bound_ms"] * 1e3:.3f} us ({row["bound_by"]})')
        rows.append(row)
    return {'fused_layer_norm': rows}


def attention_pairs(tq, tk, causal):
    """Unmasked (q, k) pairs of one head."""
    if not causal:
        return tq * tk
    shift = 0 if causal == 'strict' else 1
    return sum(min(r + shift, tk) for r in range(tq))


def flash_bounds(bh, tq, tk, d, dtype, causal):
    """{kernel: (bound_ms, bound_by, flops, bytes)}.  Flops: 2*D per
    unmasked pair and product, i.e. forward 4*D (q.k^T, p.v), dq 6*D
    (s, dp, ds.k), dk/dv 8*D (s, dp, p^T.do, ds^T.q).  Bytes: each
    input read once and each output written once: forward q, k, v in,
    o and f32 lse out; dq q, k, v, do, f32 lse and delta in, dq out;
    dk/dv the same inputs, dk and dv out."""
    es = torch.empty((), dtype=dtype).element_size()
    pairs = attention_pairs(tq, tk, causal) * bh
    q_b, k_b, row_b = bh * tq * d * es, bh * tk * d * es, bh * tq * 4
    work = {'flash_attention_fwd': (4 * d * pairs, 2 * q_b + 2 * k_b + row_b),
            'flash_attention_bwd_dq': (6 * d * pairs,
                                       3 * q_b + 2 * k_b + 2 * row_b),
            'flash_attention_bwd_dkv': (8 * d * pairs,
                                        2 * q_b + 4 * k_b + 2 * row_b)}
    return {k: (*bound(nb, fl, dtype), fl, nb)
            for k, (fl, nb) in work.items()}


def worst_err(got, want, tol):
    """(max |got - want|, passes |got - want| <= tol * (1 + |want|))."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= tol * (1 + want.abs())).all())


def flash_kernel_phase():
    """The three flash attention kernels against their plain twins on
    the card, timed beside the twin, SDPA and the bound."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import flash_attention as fa
    rows = {k: [] for k in FLASH_KERNELS}
    gen = torch.Generator().manual_seed(1)
    for case, B, H, T, D, dtype, causal, with_glse in FLASH_CASES:
        bh, scale = B * H, 1.0 / math.sqrt(D)
        q, k, v, do = (torch.randn((bh, T, D), generator=gen)
                       .to('cuda', dtype) for _ in range(4))
        g_lse = torch.randn((bh, T), generator=gen).cuda() \
            if with_glse else None
        tol_o, tol_lse, tol_g = FLASH_TOL[dtype]
        o, lse = fa._fwd_cuda(q, k, v, causal, scale)
        ro, rlse = fa._reference_lse(q, k, v, causal, scale)
        ro = ro.to(dtype)
        delta = (do.float() * ro.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse
        args = (q, k, v, do, rlse, delta, causal, scale)
        dq = fa._bwd_dq_cuda(*args)
        dk, dv = fa._bwd_dkv_cuda(*args)
        rdq = fa._bwd_dq_reference(*args)
        rdk, rdv = fa._bwd_dkv_reference(*args)
        torch.cuda.synchronize()
        checks = {'flash_attention_fwd': [('o', o, ro, tol_o),
                                          ('lse', lse, rlse, tol_lse)],
                  'flash_attention_bwd_dq': [('dq', dq, rdq, tol_g)],
                  'flash_attention_bwd_dkv': [('dk', dk, rdk, tol_g),
                                              ('dv', dv, rdv, tol_g)]}
        errs = {}
        for kname, items in checks.items():
            errs[kname] = 0.0
            for what, got, want, tol in items:
                err, ok = worst_err(got, want, tol)
                if not ok:
                    raise AssertionError(
                        f'{kname} {case} {bh}x{T}x{D} {dtype}: max |{what} '
                        f'- plain| {err:.3e} beyond tol {tol} * (1 + '
                        '|plain|)')
                errs[kname] = max(errs[kname], err)
        # the library: SDPA on the [B, H, T, D] view, forward alone and
        # its autograd backward (dq, dk and dv together)
        q4, k4, v4 = (t.view(B, H, T, D).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa_kw = {'is_causal': True} if causal is True else (
            {'attn_mask': torch.ones((T, T), dtype=torch.bool,
                                     device='cuda').tril(-1)}
            if causal == 'strict' else {})
        lib_out = TF.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw)
        do4 = do.view(B, H, T, D)
        lib_fwd = lambda: TF.scaled_dot_product_attention(  # noqa: E731
            q4.detach(), k4.detach(), v4.detach(), **sdpa_kw)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (q4, k4, v4), do4, retain_graph=True)
        fns = {'flash_attention_fwd': {
                   '': lambda: fa._fwd_cuda(q, k, v, causal, scale),
                   'plain_': lambda: fa._reference_lse(q, k, v, causal,
                                                       scale),
                   'library_': lib_fwd},
               'flash_attention_bwd_dq': {
                   '': lambda: fa._bwd_dq_cuda(*args),
                   'plain_': lambda: fa._bwd_dq_reference(*args),
                   'library_': lib_bwd},
               'flash_attention_bwd_dkv': {
                   '': lambda: fa._bwd_dkv_cuda(*args),
                   'plain_': lambda: fa._bwd_dkv_reference(*args),
                   'library_': lib_bwd}}
        bounds = flash_bounds(bh, T, T, D, dtype, causal)
        for kname in FLASH_KERNELS:
            row = {'case': case, 'shape': [bh, T, D],
                   'dtype': str(dtype).replace('torch.', ''),
                   'causal': causal, 'g_lse': with_glse,
                   'tol': FLASH_TOL[dtype], 'max_abs_err': errs[kname],
                   'library': 'F.scaled_dot_product_attention' + (
                       '' if kname == 'flash_attention_fwd'
                       else ' backward (dq, dk, dv together)')}
            time_row(row, fns[kname], iters=20, warmup=3, prof_iters=10)
            (row['bound_ms'], row['bound_by'], row['flops'],
             row['bytes']) = bounds[kname]
            log(f'kernel {kname} {case} {bh}x{T}x{D} {row["dtype"]} '
                f'causal={causal}: max_abs_err {errs[kname]:.3e} | device: '
                f'kernel {row["ms"] * 1e3:.1f} us, plain '
                f'{row["plain_ms"] * 1e3:.1f} us, SDPA '
                f'{row["library_ms"] * 1e3:.1f} us ({row["ms_from"]}) | '
                f'per call: kernel {row["call_ms"] * 1e3:.1f} us | bound '
                f'{row["bound_ms"] * 1e3:.2f} us ({row["bound_by"]})')
            rows[kname].append(row)
        del lib_out, q4, k4, v4
    return rows


def serving_phase():
    """gpt_small at full width through the continuous-batching engine."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import (Request, ServeConfig,
                                          ServingEngine, poisson_requests)
    model = gpt_small(device='cuda', seed=0, **SERVE_MODEL_KW)
    cfg = model.config
    log(f'model: gpt_small vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, layers {cfg.num_layers}, heads '
        f'{cfg.num_heads}, max_seq_len {cfg.max_seq_len}, f32, seed 0')
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG_KW))
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    log(f'warmup: {time.perf_counter() - t0:.2f} s')
    reqs = poisson_requests(NUM_REQUESTS, vocab_size=cfg.vocab_size,
                            **SERVE_LOAD_KW)
    prompts = {r.rid: r.prompt.copy() for r in reqs}

    # the main path: counts at 0 just before, read just after
    p0, d0 = eng.prefill_dispatches, eng.decode_steps
    _build.reset_launches()
    torch.cuda.synchronize()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS}
    prefills = eng.prefill_dispatches - p0
    steps = eng.decode_steps - d0

    done = [r for r in eng.scheduler.finished if r.rid in prompts]
    if len(done) != NUM_REQUESTS or any(r.state != Request.DONE
                                        for r in done):
        raise AssertionError(
            f'not every request is DONE: '
            f'{[(r.rid, r.state, r.reason) for r in done]}')
    if rep['audit']:
        raise AssertionError(f'allocator audit: {rep["audit"]}')
    if eng.cache.free_blocks != eng.cache.num_blocks - 1:
        raise AssertionError(f'free blocks {eng.cache.free_blocks} != '
                             f'{eng.cache.num_blocks - 1}')
    per_forward = 2 * cfg.num_layers + 1
    want = per_forward * (prefills + steps)
    if launches['fused_layer_norm'] != want:
        raise AssertionError(
            f'fused_layer_norm launched {launches["fused_layer_norm"]} '
            f'times, expected {per_forward} x ({prefills} prefill '
            f'dispatches + {steps} decode steps) = {want}')
    log(f'serve: {NUM_REQUESTS} requests DONE, audit clean, '
        f'{eng.cache.free_blocks} blocks free; {prefills} prefill '
        f'dispatches + {steps} decode steps ({rep["interventions"]} '
        f'interventions); fused_layer_norm launches '
        f'{launches["fused_layer_norm"]} = {per_forward} x '
        f'{prefills + steps}')
    log(f'serve: {rep["decoded_tokens"]} tokens in {rep["wall_s"]:.3f} s '
        f'= {rep["tokens_per_s"]:.1f} tokens/s; TTFT p50 '
        f'{rep["ttft_p50_s"] * 1e3:.1f} ms, p99 '
        f'{rep["ttft_p99_s"] * 1e3:.1f} ms; TPOT mean '
        f'{rep["tpot_mean_s"] * 1e3:.2f} ms')

    # greedy streams of two requests equal batch-1 generate
    by_len = sorted(done, key=lambda r: (r.prompt.size, r.rid))
    for req in (by_len[0], by_len[-1]):
        ref = model.generate(prompts[req.rid][None], req.max_new_tokens,
                             temperature=0)
        ref = ref[0, prompts[req.rid].size:].tolist()
        if req.tokens != ref:
            first = next(i for i, (a, b) in enumerate(zip(req.tokens, ref))
                         if a != b)
            raise AssertionError(
                f'{req.rid}: engine stream differs from batch-1 generate '
                f'at token {first}')
        log(f'parity: {req.rid} (prompt {req.prompt.size}, '
            f'{len(ref)} tokens) engine == batch-1 generate')

    # one prefill's logits on the card vs the plain twins on the CPU
    cpu_model = gpt_small(device='cpu', seed=0, **SERVE_MODEL_KW)
    ids = torch.from_numpy(prompts[by_len[-1].rid][None])
    T = ids.shape[1]
    got, _ = model.prefill(ids.cuda(), 0, model.init_decode_caches(1, T))
    want_cpu, _ = cpu_model.prefill(ids, 0,
                                    cpu_model.init_decode_caches(1, T))
    got = got.cpu()
    if got.shape != (1, T, cfg.vocab_size) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f'bad prefill logits {tuple(got.shape)}')
    diff = float((got - want_cpu).abs().max())
    if diff > LOGIT_TOL:
        raise AssertionError(f'card vs CPU prefill logits differ by '
                             f'{diff:.3e} > {LOGIT_TOL}')
    log(f'parity: card prefill logits [1, {T}, {cfg.vocab_size}] vs CPU '
        f'plain twins max |diff| {diff:.3e} (tol {LOGIT_TOL})')
    return launches


def _trainer(model, amp_o2):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelTrainer
    strategy = DistributedStrategy()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs['use_pure_fp16'] = True
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    return ParallelTrainer(model, opt, lambda out, y: model.loss(out, y),
                           strategy=strategy)


def training_phase():
    """gpt_small at full width through ParallelTrainer.step, the
    benchmark's configuration."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    model = gpt_small(device='cuda', seed=0, **TRAIN_MODEL_KW)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f'train model: gpt_small vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, layers {cfg.num_layers}, heads '
        f'{cfg.num_heads}, max_seq_len {cfg.max_seq_len}, {n_params} '
        f'parameters, seed 0; B {TRAIN_BATCH}, T {TRAIN_SEQ}, bf16 O2, '
        f'fused head in {cfg.fused_head_chunks} chunks, AdamW lr '
        f'{TRAIN_LR}')
    trainer = _trainer(model, amp_o2=True)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)

    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.step(ids, ids) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    losses += [trainer.step(ids, ids) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = {k.name: k.launches for k in _build.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = [trainer.loss_float(x) for x in losses]

    steps = TRAIN_WARMUP + TRAIN_STEPS
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'non-finite training loss: {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'loss did not fall on one batch: {losses}')
    want = {'fused_layer_norm': (2 * cfg.num_layers + 1) * steps,
            **{k: cfg.num_layers * steps for k in FLASH_KERNELS}}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f'{name} launched {launches[name]} times '
                                 f'in {steps} steps, expected {n}')
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms_step = dt / TRAIN_STEPS * 1e3
    # model flops per step: 6 * parameters * tokens (wte counted once,
    # for the tied head's matmul) plus causal attention, 12 * D per
    # unmasked pair per layer and head (4*D forward, 8*D backward)
    hd = cfg.hidden_size // cfg.num_heads
    attn = 12 * hd * attention_pairs(TRAIN_SEQ, TRAIN_SEQ, True) \
        * TRAIN_BATCH * cfg.num_heads * cfg.num_layers
    flops = 6 * n_params * tokens + attn
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'train: losses {", ".join(f"{x:.4f}" for x in losses)} (finite, '
        f'falling); launches {launches["fused_layer_norm"]} LayerNorm = '
        f'25 x {steps}, ' + ', '.join(f'{launches[k]} {k}'
                                      for k in FLASH_KERNELS)
        + f' = 12 x {steps}')
    log(f'train: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; '
        f'{TRAIN_STEPS} steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{tokens * TRAIN_STEPS / dt:.0f} tokens/s; peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; MFU '
        f'{mfu:.4f} = (6 * {n_params} params * {tokens} tokens + '
        f'{attn:.4g} attention flops) / (step time * 989e12)')
    summary = {'ms_per_step': ms_step,
               'tokens_per_s': tokens * TRAIN_STEPS / dt,
               'peak_bytes': peak, 'mfu': mfu, 'losses': losses,
               'warmup_s': warm_s, 'launches': launches}
    summary['parity'] = training_parity()
    return summary


def training_parity():
    """One f32 training step of gpt_small at B 1, T 256: the card (the
    kernels) against the same weights on the CPU (the plain twins)."""
    from paddle_tpu_torch.models.gpt import gpt_small
    kw = dict(TRAIN_MODEL_KW, max_seq_len=PARITY_SEQ)
    got, ids = {}, None
    for dev in ('cuda', 'cpu'):
        model = gpt_small(device=dev, seed=0, **kw)
        if ids is None:
            ids = np.random.RandomState(1).randint(
                0, model.config.vocab_size, (1, PARITY_SEQ)).astype(np.int64)
        trainer = _trainer(model, amp_o2=False)
        loss = trainer.loss_float(trainer.step(ids, ids))
        got[dev] = (loss, {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()})
    (l_card, g_card), (l_cpu, g_cpu) = got['cuda'], got['cpu']
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        rel = float((g_card[name] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    if not (loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError(
            f'f32 training step card vs CPU: loss {l_card} vs {l_cpu} '
            f'(rel {loss_rel:.3e}, tol {PARITY_LOSS_RTOL}); worst gradient '
            f'{worst_name} rel {worst:.3e} (tol {PARITY_GRAD_RTOL})')
    log(f'parity: f32 training step B 1 T {PARITY_SEQ}, card vs CPU plain '
        f'twins: loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.3e}, tol '
        f'{PARITY_LOSS_RTOL}); worst gradient {worst_name} max |diff| / '
        f'max |grad| {worst:.3e} (tol {PARITY_GRAD_RTOL})')
    return {'loss_rel': loss_rel, 'worst_grad_rel': worst,
            'worst_grad': worst_name}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.ops import _build
    import paddle_tpu_torch.ops.flash_attention  # noqa: F401  (registers)
    name = device_phase()
    build_phase()
    timings = kernel_phase()
    timings.update(flash_kernel_phase())
    serve_launches = serving_phase()
    train = training_phase()
    log(json.dumps({'train': train}))
    kernels = []
    for k in _build.KERNELS:
        rows = timings[k.name]
        # LayerNorm: the decode shape (most launches); flash: training
        head = rows[0]
        by_path = {'serve': serve_launches[k.name],
                   'train': train['launches'][k.name]}
        kernels.append({
            'name': k.name, 'route': k.route, 'source': k.source_path,
            'replaces': k.replaces, 'launches': sum(by_path.values()),
            'launches_by_path': by_path,
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': head['ms'], 'kernel_ms': head['ms'],
            'plain_ms': head['plain_ms'], 'bound_ms': head['bound_ms'],
            'bound_by': head['bound_by'],
            'library_ms': head['library_ms'],
            'ms_from': head['ms_from'], 'call_ms': head['call_ms'],
            'shapes': rows})
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
