"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root, with one CUDA card.  It

1. prints the card (``nvidia-smi`` name and power limit) and turns
   TF32 off for matmuls and cuDNN, so f32 means f32;
2. builds every kernel under ``paddle_tpu_torch/csrc/`` with nvcc (one
   process per source, all at once), prints the build seconds and every
   kernel's registers, stack and local (spill) bytes from ``cuobjdump
   --dump-resource-usage``, and fails if a softmax or LayerNorm kernel
   spills (a stack frame or local memory);
3. holds each kernel to its plain PyTorch twin at the shapes its
   paths give it, with the tolerance stated, checks that the wrapper
   took the design it names for the case (per-design launch counts) and
   that a second launch repeats the first bit for bit, and times the
   kernel, the twin and one PyTorch library call computing the same
   function beside the least time the card could take: device time per
   call from ``torch.profiler`` warm (``ms``: back-to-back launches, so
   inputs that fit the 50 MB L2 stay there, as for a caller that just
   wrote them) and cold (``cold_ms``: the L2 flushed by a 128 MB write
   before each launch, the flush's kernels left out of the sum), and
   time per call of a back-to-back loop between CUDA events
   (``call_ms``, which includes the host's launch work).  The LayerNorm
   and softmax rows take the median and range of 5 rounds in turns
   (kernel, twin, library), their share of the bound comes from the cold
   reading, and a cold reading under its bound fails the run (the
   bound's byte count would be wrong); the decode LayerNorm row stands
   beside the launch floor, the device time of a one-element
   ``t[:1].zero_()``.  LayerNorm at the serving and training shapes (f32,
   bf16, f16), at H 2560 (the block design) and at H 770 (scalar
   loads); the three flash attention kernels (forward, dq, dk/dv) at the
   training shape (96 x 1024 x 64 causal, bf16 and f16), in f32, in
   ``'strict'`` mode with an lse cotangent, at a ragged T of 200 (f32
   and bf16), at D 128 (32 x 512 x 128 bf16 causal), at BERT-base's 768
   x 128 x 64 bf16 non-causal and at B*H 65600 (65600 x 16 x 32 bf16
   causal: two chunks of heads), each with its achieved TFLOP/s, each
   checked to take its design (``mma`` for 16-bit inputs, ``simt`` for
   f32), and for 16-bit inputs a second launch of all three that must
   repeat the first bit for bit; the softmax kernel at BERT-base's
   attention scores (64 x 12 x 128 x 128, f32, bf16 and f16), at GPT's
   row of 1024 and at a ragged row of 200 (the ``vec`` design), at rows
   of 199 (``scalar``) and of 4096 (``block``); the masked softmax
   through the public ``ops.fused_softmax(x, mask)`` at BERT's shape
   with a seeded padding mask (f32 and f16), at the ragged shape and with
   a full bf16 mask; the GEMM+GELU forward and backward kernels at
   BERT-base's fc (8192 x 768 x 3072, bf16 and f16 on the tensor-core
   design and f32 on the SIMT one), at a ragged 1000 x 700 x 3001 f32
   with the erf GELU, at an aligned ragged 1000 x 776 x 3000 bf16
   (tensor cores) and at an unaligned 300 x 129 x 257 bf16 and f16
   (SIMT), each checked to take its design, repeated bit for bit and
   timed in TFLOP/s;
4. serves 32 seeded Poisson requests with ``gpt_small`` at full width
   (random seeded weights) through ``ServingEngine`` with the
   benchmark's serving config, its prefill modules (prompt bucket x
   chunk) and decode spans (batch bucket x span) as CUDA graphs: after
   ``warmup()`` the captured prefill and decode sets must be the
   declared ones, and it logs each graph's capture time and launches a
   replay.  It checks the outcome: every request done, allocator audit
   clean, every block back, no capture during traffic, every prefill
   dispatch a replayed prefill graph and every decode step a step of a
   replayed decode graph, LayerNorm's launches exactly the captured
   launches times the replays (none eager, all on the warp design); it
   logs tokens/s, TTFT p50/p99, TPOT and peak memory.  The same 32
   requests run again with every span through the graph and through the
   eager span body on the same plan, whose outputs must be equal; then,
   all submitted at once, through two fresh engines, graphed and eager
   prefill, whose streams must be equal token for token and whose KV
   pools equal outside the trash block; greedy streams equal batch-1
   ``generate`` (its graph), and the card's prefill logits agree with the
   same weights run on the CPU through the plain twins.  Then the same
   config with ``ServeConfig(quantize='int8')`` and ``'int4'``
   (``serve_int8``, ``serve_int4``): the same gates and numbers, the
   weight bytes against f32, the share of greedy tokens equal to the f32
   run's (reported, no gate), each of the 48 swapped Linears' int32
   accumulator on one prefill and one decode batch equal to the CPU's
   and its output within 1 f32 ulp, and one quantized ``generate``
   through its graph;
   then the serving plane (``frontdoor``): the same deployment, warmed
   up, behind ``ServingFrontend`` with the live plane armed (metrics
   server, ``PADDLE_TPU_MEMSTATS`` sampler, a watchdog budget, a profile
   window on decode steps 32..47), the same 32 requests sent as SSE
   streams on their arrival times by a client process of its own while
   it scrapes ``/metrics`` and ``/status.json``: every stream equal to
   the serve run's, LayerNorm's launches exactly the captured launches
   times the replays, one ``serve_request`` per rid with the reference's
   fields, the window on exactly the asked steps with its trace on disk,
   ``memory_sample``s from ``torch.cuda.memory_stats`` within the card,
   one ``memory_compiled`` per captured module, a 413 with
   ``Retry-After``, a disconnected client evicted with every block back,
   429s from a door of queue 1 under a burst, a starved request evicted
   with a ``timeout`` event and no thread or port left after ``close()``
   (TTFT, TPOT and tokens/s through the door against the in-process
   run, the window's idle share, the door's host CPU a request); and the
   fleet (``fleet``): 2 replicas and a warm spare of ``gpt_small``
   (``paddle_tpu_torch.tools.serve_fleet`` workers on the card, the
   reference drill's pool and sampling) behind ``FleetFrontend``, run
   through the reference's four drills (an overload burst shed typed, a
   clean twin through the door equal to one in-process engine, a seeded
   ``replica_kill`` retried bit for bit with the spare promoted, a
   forced ``slo_breach`` drain dropping nothing), with the spawn-to-ready
   seconds, each replica's allocator peak and LayerNorm launches read
   from its metrics plane;
5. trains ``gpt_small`` at full width (random seeded weights) through
   ``ParallelTrainer.step`` in the benchmark's configuration (B 8, T
   1024, bf16 O2, fused CE head in 8 chunks, AdamW lr 3e-4): 2 warm-up
   and 5 timed steps on one seeded batch.  It checks that every loss is
   finite and the last is below the first, that each flash kernel ran
   12 times and LayerNorm 25 times per step (on the warp design), and
   that one f32 step at B 1, T 256 gives the card the same loss and
   gradients as the same weights on the CPU through the plain twins;
   every flash launch of the bf16 run is on the tensor-core design,
   every one of the f32 step on the SIMT design; it prints ms/step,
   tokens/s, peak device memory and an MFU share;
   then the same configuration through ``step_fused`` with K 5 (one
   captured forward + backward + AdamW step, replayed), 2 chunks,
   against two eager trainers from the same seed: eager equal to eager,
   and the graph's losses and every parameter equal to eager bit for bit
   (or, where two eager trainers differ, within their difference);
   exact launch counts under replay; ms/step, tokens/s, MFU, the capture
   time, peak memory, and the idle share of a third chunk under the
   profiler;
   then the same model and batch with GPT-3 Small's optimisation recipe
   (AdamW beta2 0.95, weight decay 0.1 with biases and LayerNorm exempt,
   ``LinearWarmup`` into ``CosineAnnealingDecay``,
   ``ClipGradByGlobalNorm(1.0)``) under ``nan_guard`` (``gpt_recipe``):
   two eager guarded trainers equal over 2 K steps, then ``step_fused``
   (K 5) over four chunks equal to them bit for bit in every loss and
   parameter, the third chunk with a NaN loss weight at one step (its
   loss NaN, its update dropped: ``_step_no`` advances by K - 1, the
   sentinel counts one skip, every parameter finite) and the fourth
   showing the LR and bias corrections resumed at the right step; the
   guarded chunks run under ``torch.cuda.set_sync_debug_mode('error')``
   but for their one host read (``chunk_sync``); exact launches per
   replay, the skipped step's too; ms/step beside plain AdamW's
   ``gpt_fused`` in the same call, tokens/s, capture time, peak memory
   and idle share;
6. trains ``gpt_small`` 2 steps at its dropout 0.1 (B 2, T 1024, bf16
   O2): finite losses, the softmax kernel 12 times per step on its vec
   design, no flash;
   then 3 steps in float16 (B 2, T 1024, ``auto_cast(level='O2',
   dtype='float16')`` with the ``GradScaler``): finite, falling losses,
   LayerNorm 25 and each flash kernel 12 times per step on the
   tensor-core design, and the scale's trajectory printed;
7. trains ``bert_base`` at full width through ``ParallelTrainer.step``
   in the benchmark's BERT configuration (B 64, T 128, bf16 O2, fused
   MLM head in 8 chunks, AdamW lr 1e-4, MLM labels on 15% of positions)
   three times: at the published dropout 0.1 (2 warm-up and 5 timed
   steps: the softmax kernel in every layer), at the benchmark's dropout
   0 (1 + 3 steps: non-causal flash) and at dropout 0.1 with
   ``USE_PALLAS_MLP`` (1 + 3 steps: the GEMM+GELU kernels in every
   MLP, every launch on the tensor-core design), each with finite,
   falling losses and exact launch counts per step; then one f32 step
   at B 2 with ``USE_PALLAS_MLP`` and dropout 1e-9 (every element kept
   at scale 1, the softmax branch taken; the SIMT design) on the card
   against the same weights on the CPU; then the dropout-0.1
   configuration through ``step_fused`` as in 5 (dropout drawn from the
   device's generator, registered with the graph);
8. trains ResNet-50 at bench.py's configuration (``resnet``: NHWC, B
   256 x 224 x 224 bf16 images, bf16 O2, Momentum lr 0.1): 5 warm-up
   and 10 timed steps with ms/step, imgs/s, MFU, peak memory and the
   idle share, one ``eval_step`` on the running statistics (f32
   images: buffers unchanged, 4 images' logits against the CPU's eval
   of the same state), then ``step_fused`` K 5 over 2 chunks against
   two eager trainers, bit for bit in losses, parameters and all 106
   BatchNorm buffers (under ``cudnn.deterministic`` if the two eager
   trainers differ); one f32 step of ``resnet18`` and of ``resnet50``
   (10 classes) at B 8 x 64 x 64 on the card against the CPU with
   cuDNN's TF32 left on, each train-mode gradient also against a
   float64 witness (``resnet_parity``); LeNet at B 256 f32 with Adam,
   5 + 50 steps and the bench's loss anchor (``lenet``); then the
   high-level API: ``examples/mnist_lenet.py``'s program
   (``mnist_lenet``, the same function the CPU tests run on both
   packages) through ``hapi.Model`` over synthetic MNIST
   (``hapi_lenet``): ``fit`` of 1024 images, B 64, 8 epochs, to the
   reference's anchor (train-split accuracy above 0.9 by ``evaluate``),
   the same fit with ``fused_steps`` 4 (one captured step, replayed)
   whose losses, parameters and metric logs must equal the eager fit's
   bit for bit, three ``train_batch`` steps on the card against the CPU
   (within 1e-4 of each tensor's largest value), ``save`` and ``load``
   into a fresh Model whose next step equals the uninterrupted one bit
   for bit, and bench.py's LeNet batch (B 256) through
   ``Model.train_batch`` beside the bare ``ParallelTrainer``; and the
   Paddle tutorial's ``Model(resnet50(num_classes=102))`` (f32 NCHW, B
   64) over the synthetic Flowers train split through
   ``RandomResizedCrop(224)`` in a ``DataLoader`` of 4 process workers
   with the native ring and ``device_prefetch`` (``hapi_flowers``): one
   epoch with images/s, ms/step, the prefetch wait a step and the idle
   share (the device's busy time a step from steps 8-11 under the
   profiler, over the epoch's wall, and those steps' own), the native
   ring checked to have carried every batch and 3 staged batches held
   to their host copies, then the same steps on batches already on the
   card; none of these paths may launch a hand-written kernel (the
   reference has no Pallas kernel on them);
   then the bench's last three configurations and the rest of the zoo:
   Wide&Deep at bench.py's configuration (``widedeep``: 26 fields of
   100 000 ids, embed 16, hidden 400-400-400, B 16384, bf16 O2, Adam):
   2 + 10 eager steps with examples/s, peak memory and the idle share,
   ``step_fused`` K 5 against two eager trainers bit for bit (under
   ``torch.use_deterministic_algorithms`` if the eager pair differs),
   one f32 step on the card against the CPU at the full configuration,
   DeepFM 3 steps, no hand-written kernel launched; ``gpt_small`` at B
   2 x T 4096 (``longctx``): 3 + 7 eager steps with exact flash (12 a
   step, ``mma``) and LayerNorm (25) launches, then ``step_fused``
   against eager as in 5; ``generate`` at B 8, prompts of 128, 128 new
   tokens, greedy, f32 (``gptgen``), one CUDA graph per signature: 1 +
   5 calls, tokens/s, ms a token step, the idle share, the capture
   seconds, LayerNorm 25 a prefill and 25 a decode step exactly (3200 a
   replay), the 8 streams equal to the eager loop's and against the
   ServingEngine's greedy streams of the same prompts (a stream may part
   only where its top two logits lie within 1e-6), a shorter prompt in
   the bucket and a sampled call at a second seed replaying without a
   new capture; ERNIE 1.0 base at BERT run (a)'s configuration with token
   types in 0..3 (``ernie``: softmax 12 and LayerNorm 26 a step);
   VGG-16 at B 64, MobileNet v1 and v2 at B 256, 224 x 224 NCHW, bf16
   O2, Momentum (``vision_zoo``): 2 + 3 steps each with ms/step,
   imgs/s, MFU and the depthwise convolutions' device time, MobileNet
   v2 also through ``step_fused`` against eager bit for bit, its 104
   BatchNorm buffers included; the flash kernel row at 24 x 4096 x 64
   bf16 causal joins the kernel comparison;
9. trains ``gpt_small``'s widths at 2 layers in f32 (B 1, T 256) with
   each of the 11 optimizers (SGD, Momentum with Nesterov, Adagrad,
   Adadelta, RMSProp centered with momentum, Lars, Adam, AdamW, Adamax,
   Lamb, DGCMomentum with its ramp starting inside the run), a clip, a
   regularizer and a scheduler in rotation, under ``nan_guard``
   (``optimizers``): 4 steps on the card against the same on the CPU
   (each loss within 1e-4, each parameter within 1e-3 of its max,
   ``qkv.bias`` within ``2 * lr * steps``), and ``step_fused`` (K 4)
   on the card equal to its eager steps bit for bit, with exact launch
   counts;
10. trains ``gpt_small`` with Switch-Base-8's routing (``moe``: 8 experts
   in every other block, top-1, capacity factor 1.25, aux weight 0.01;
   322.9 M parameters, 124.5 M active a token) at the GPT training
   configuration: 2 + 5 eager steps with finite, falling losses, each
   block's aux loss, exact launches (LayerNorm 25, each flash kernel 12,
   GEMM+GELU 0), ms/step, tokens/s, the MFU over the active parameters
   plus attention, idle share, peak memory and the device ms of one
   layer's four einsums forward and backward against the busy step;
   ``step_fused`` K 5 against two eager trainers, parameters and Adam's
   state bit for bit; an f32 step at 2 layers (one MoE block) on the
   card against the CPU; then ``generate`` on the same model at
   gptgen's configuration through one graph a call (``moe_gen``: the
   prompt unpadded, LayerNorm launches exact, the streams equal to the
   eager loop's, tokens/s); then ResNet-50 under ``ImperativeQuantAware``
   at the resnet configuration (``qat``: 2 + 5 eager steps against the
   ``resnet`` phase's ms/step, no hand-written kernel, the ``.quant``
   artifact loaded into a float ResNet-50 whose every weight must equal
   the QAT model's fake-quantized one, the top-1 agreement of the two;
   ``step_fused`` against eager bit for bit with all 106 BatchNorm
   buffers and 54 activation scales; ``PostTrainingQuantization`` over
   4 batches on the card and on the CPU: int8 weights and scales equal,
   the stem's activation scale equal, the rest within 1e-3);
11. trains the sequence models, each built from the public ``nn`` layers
   by code the CPU tests run on both packages (``transformer_model``,
   ``lstm_lm_model``): Transformer-base (``transformer``:
   ``nn.Transformer()`` at its defaults, d_model 512, 8 heads, 6 + 6
   layers, FFN 2048, dropout 0.1; a shared vocabulary of 37000, one
   embedding for both inputs and the pre-softmax projection, sinusoidal
   positions; B 64 x source 128 (padded, a -1e9 key mask) x target 128,
   bf16 O2, Adam 0.9/0.98/1e-9 under ``NoamDecay(512, 4000)``, label
   smoothing 0.1 through ``F.label_smooth`` and a soft-label
   ``cross_entropy``): 2 + 5 eager steps with finite losses, LayerNorm
   exactly 30 a step and no other kernel, ms/step, target tokens/s and
   an f32 step at B 2 against the CPU; then ``step_fused`` K 5 against
   two eager trainers, parameters and Adam's moments bit for bit
   (``transformer_fused``); beam search over the decoder's caches
   (``transformer_beam``: ``BeamSearchDecoder`` + ``dynamic_decode``,
   ``gen_cache``'s ``Cache`` and ``StaticCache``, beam 4, B 8 sources of
   128, 128 steps, f32): LayerNorm 12 + 18 a step exactly, the first 16
   steps' ids and parents equal to a decoder without caches, B 1 x 16
   steps equal to the CPU's, tokens/s and the idle share; Zaremba's
   large PTB LSTM LM (``lstm_lm``: 2 x 1500, vocabulary 10000, B 20 x
   35 steps, dropout 0.65, ``Uniform(+-0.04)`` through ``ParamAttr``,
   f32, SGD lr 1 with a global-norm clip of 10): 2 + 5 eager steps with
   finite, falling losses, no ported kernel, words/s and an f32 step at
   B 2 against the CPU, then ``step_fused`` against eager bit for bit
   (``lstm_lm_fused``);
12. prints one JSON line with the serving and training results, one
   listing every kernel (its launches on each path, each path's counts
   set to 0 just before it and read just after, and per design where a
   kernel has two; the paths ``serve``, ``frontdoor``, ``fleet`` (the
   replicas' counts), ``serve_int8``, ``serve_int4``,
   ``gptgen``, ``gpt_fused``, ``gpt_recipe``,
   ``bert_dropout_fused``, ``resnet_fused``, ``widedeep_fused``,
   ``longctx_fused``, ``mobilenet_v2_fused``, ``moe_fused``, ``moe_gen``,
   ``qat_fused``, ``transformer_fused`` and ``lstm_lm_fused`` replay
   graphs, ``optimizers`` half its steps; the vision, hapi, Wide&Deep,
   QAT and LSTM paths count 0 of each, the Transformer's LayerNorm
   only),
   then as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero.  Without a
CUDA device it exits non-zero before printing any result.
"""
import contextlib
import json
import math
import statistics
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
BF16_FLOPS_PER_S = 989e12     # bf16 and f16 alike
HALF_DTYPES = (torch.bfloat16, torch.float16)

# LayerNorm cases: (shape, dtype, tol on y); the statistics hold 1e-5
KERNEL_SHAPES = [((64, 768), torch.float32, 1e-5),     # decode, S=64
                 ((512, 768), torch.float32, 1e-5),    # prefill, 8 x 64
                 ((512, 768), torch.bfloat16, 2e-2),   # the AMP slices
                 ((8192, 768), torch.bfloat16, 2e-2),  # training, B8 T1024
                 ((2048, 768), torch.float16, 2e-2),   # f16 training, B2
                 ((8192, 2560), torch.bfloat16, 2e-2),  # above 2048: block
                 ((512, 770), torch.float32, 1e-5)]    # H % 4 != 0: scalar

# flash attention cases: (case, B, H, T, D, dtype, causal, with g_lse),
# the first being GPT training's shape, 'bert' BERT-base's (dropout 0),
# 'longctx' GPT's at T 4096 (bench.py's longctx).  Tolerances (kernel vs its
# own twin, |got - want| <= tol * (1 + |want|)): f32 1e-5 on o and lse
# and 1e-4 on dq/dk/dv (online softmax and tile sums in another order
# than the twin's whole-row matmuls); bf16 2e-2 on o/dq/dk/dv (both
# round the f32 result to bf16; the tensor-core forward and dk/dv also
# round P and dS to bf16, which the CPU replay in
# tests/test_torch_flash_attention.py holds within half of 2e-2) and
# 1e-4 on the f32 lse; f16 as bf16
FLASH_CASES = [('train', 8, 12, 1024, 64, torch.bfloat16, True, False),
               ('train_f16', 8, 12, 1024, 64, torch.float16, True, False),
               ('f32', 8, 12, 1024, 64, torch.float32, True, False),
               ('strict', 8, 12, 1024, 64, torch.bfloat16, 'strict', True),
               ('ragged', 8, 12, 200, 64, torch.float32, False, False),
               ('ragged_bf16', 8, 12, 200, 64, torch.bfloat16, True, False),
               ('d128_bf16', 4, 8, 512, 128, torch.bfloat16, True, False),
               ('bert', 64, 12, 128, 64, torch.bfloat16, False, False),
               ('wide_bh', 4100, 16, 16, 32, torch.bfloat16, True, False),
               ('longctx', 2, 12, 4096, 64, torch.bfloat16, True, False)]
FLASH_TOL = {torch.float32: (1e-5, 1e-5, 1e-4),
             torch.bfloat16: (2e-2, 1e-4, 2e-2),
             torch.float16: (2e-2, 1e-4, 2e-2)}
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

# softmax cases: (case, x shape, dtype, mask shape or None, the design
# the wrapper must pick); the first of each kernel is its main-path
# shape: BERT-base's attention scores [B 64, H 12, T 128, T 128], f32
# after AMP (softmax is black-listed); 'gpt' is GPT-2 small's with
# dropout, 'odd' (796-byte rows) takes the scalar design, 'long' the
# block design.
# Tolerances (kernel vs twin, |got - want| <= tol * (1 + |want|)): f32
# 1e-6 (one exp2 and one multiply by the row's reciprocal per element,
# the row's sums in another order), bf16 2^-8 and f16 2^-10 (both round
# an f32 value below 1 to the 16-bit type, whose step there is at most
# 2^-8 and 2^-11)
SOFTMAX_CASES = [
    ('bert', (64, 12, 128, 128), torch.float32, None, 'vec'),
    ('bert_bf16', (64, 12, 128, 128), torch.bfloat16, None, 'vec'),
    ('bert_f16', (64, 12, 128, 128), torch.float16, None, 'vec'),
    ('gpt', (2, 12, 1024, 1024), torch.float32, None, 'vec'),
    ('ragged', (8, 12, 200, 200), torch.float32, None, 'vec'),
    ('odd', (8, 12, 200, 199), torch.float32, None, 'scalar'),
    ('long', (1, 12, 512, 4096), torch.float32, None, 'block'),
    ('bert_padding', (64, 12, 128, 128), torch.float32, (64, 1, 1, 128),
     'vec'),
    ('bert_padding_f16', (64, 12, 128, 128), torch.float16,
     (64, 1, 1, 128), 'vec'),
    ('ragged_padding', (8, 12, 200, 200), torch.float32, (8, 1, 1, 200),
     'vec'),
    ('bf16_full_mask', (8, 12, 128, 128), torch.bfloat16, (8, 12, 128, 128),
     'vec'),
]
SOFTMAX_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8,
               torch.float16: 2.0 ** -10}
SOFTMAX_KERNELS = ('fused_softmax', 'fused_softmax_masked')
# turns of (kernel, twin, library) behind each LayerNorm and softmax
# row's medians
LN_ROUNDS = SOFTMAX_ROUNDS = 5
# sources whose kernels must show no local-memory spill
NO_SPILL_SOURCES = ('fused_norm', 'fused_softmax')

# GEMM+GELU cases: (case, M, K, N, dtype, approximate); the first is
# BERT-base's fc at B 64 x T 128 under bf16 O2 (the tensor-core design),
# then f32 and unaligned bf16 (the SIMT design) and an aligned ragged
# bf16 shape that straddles the tensor-core tiles.  Tolerances (kernel vs
# twin, relative as above): f32 1e-4 (K-term sums in another order than
# cuBLAS's), bf16 and f16 2e-2 (both round the f32 result to the 16-bit
# type)
GELU_CASES = [('bert_fc', 8192, 768, 3072, torch.bfloat16, True),
              ('bert_fc_f16', 8192, 768, 3072, torch.float16, True),
              ('bert_fc_f32', 8192, 768, 3072, torch.float32, True),
              ('ragged_erf', 1000, 700, 3001, torch.float32, False),
              ('ragged_bf16', 1000, 776, 3000, torch.bfloat16, True),
              ('unaligned_bf16', 300, 129, 257, torch.bfloat16, True),
              ('unaligned_f16', 300, 129, 257, torch.float16, True)]
GELU_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
GELU_KERNELS = ('fused_linear_gelu_fwd', 'fused_linear_gelu_bwd')

# BERT-base pretraining, bench.py::bench_bert's configuration at the
# model's own dropout: vocab 30522, hidden 768, 12 layers, 12 heads, FFN
# 3072, LayerNorm eps 1e-12, max_seq_len 128, fused MLM head in 8
# chunks, AdamW lr 1e-4, bf16 O2, B 64 x T 128, MLM labels on 15% of
# positions.  Runs: (name, dropout, USE_PALLAS_MLP, warm-up, timed)
BERT_MODEL_KW = dict(max_seq_len=128, fused_head=True, fused_head_chunks=8)
BERT_BATCH, BERT_SEQ, BERT_LR = 64, 128, 1e-4
BERT_RUNS = [('bert_dropout', 0.1, False, 2, 5),
             ('bert_flash', 0.0, False, 1, 3),
             ('bert_dropout_gemm_gelu', 0.1, True, 1, 3)]
# the f32 card-vs-CPU BERT step: B 2, dropout 1e-9 (1 - p rounds to 1 in
# f32: every element kept at scale 1, yet the softmax branch runs)
BERT_PARITY_BATCH, BERT_PARITY_DROPOUT = 2, 1e-9

# GPT-2 small with its dropout (0.1) in training: the softmax branch
GPT_DROPOUT_BATCH, GPT_DROPOUT_STEPS = 2, 2

# GPT-2 small in float16: O2 with the GradScaler's defaults
GPT_F16_BATCH, GPT_F16_STEPS = 2, 3

# GPT-3 Small's optimisation recipe (Brown et al. 2020, "Language Models
# are Few-Shot Learners", arXiv:2005.14165, Table 2.1 and Appendix B) on
# gpt_small, the same 125M shape, at the benchmark's B 8 x T 1024 bf16
# O2: AdamW beta1 0.9, beta2 0.95, eps 1e-8, weight decay 0.1 (biases
# and LayerNorm exempt), linear warmup from 0 into a cosine decay to 10%
# of the 6e-4 peak, global-norm clipping at 1.0, the NaN guard, K 5.
# Cut: warmup 3 and T_max 20 steps (the run crosses the warmup's end
# into the cosine), and the bench's 8 K tokens a batch, not 0.5 M.
RECIPE_PEAK_LR, RECIPE_WARMUP, RECIPE_T_MAX, RECIPE_K = 6e-4, 3, 20, 5
RECIPE_POISON = 2       # the poisoned chunk's row whose loss weight is NaN

# the optimizer family on gpt_small's widths at 2 layers, f32, B 1 x T
# 256, 4 steps: (optimizer, its arguments, learning rate: the rules
# that normalise each element's step take the size of Adam's usual
# 3e-4, for at 1e-3 and above 4 steps move the random model far enough
# that the card's and the CPU's round-off part by more than 1e-3 of a
# tensor's max); each takes a
# clip, a regularizer (where its constructor takes weight_decay) and a
# scheduler in rotation, and DGC's ramp begins inside the run (step 1
# dense, 2-4 sparse).  Card vs CPU, following _card_vs_cpu: each step's
# loss within 1e-4 relative, each parameter's max |diff| after the last
# within 1e-3 of its max |value|, except the attention's qkv.bias: the
# key slice's true gradient is exactly 0 and the query slice's is near
# it at a random init, so each device's is mostly round-off, which L1's
# sign, Adam's m / sqrt(v) and Lamb's trust ratio scale up to steps of
# up to lr; it is held to its bound, 2 * lr * steps
OPT_MODEL_KW = dict(num_layers=2, max_seq_len=256, dropout=0.0,
                    fused_head=True, fused_head_chunks=8)
OPT_SEQ, OPT_STEPS = 256, 4
OPTIMIZERS = [
    ('SGD', {}, 1e-2),
    ('Momentum', dict(momentum=0.9, use_nesterov=True), 1e-2),
    ('Adagrad', dict(epsilon=1e-6), 1e-3),
    ('Adadelta', dict(epsilon=1e-6, rho=0.95), 1.0),
    ('RMSProp', dict(rho=0.95, epsilon=1e-6, momentum=0.9, centered=True),
     1e-4),
    ('Lars', dict(momentum=0.9), 0.1),
    ('Adam', {}, 3e-4),
    ('AdamW', dict(weight_decay=0.01), 3e-4),
    ('Adamax', {}, 3e-4),
    ('Lamb', dict(lamb_weight_decay=0.01), 1e-3),
    ('DGCMomentum', dict(momentum=0.9, rampup_begin_step=1, rampup_step=2,
                         sparsity=[0.75, 0.9]), 1e-2),
]
OPT_LOSS_RTOL, OPT_PARAM_RTOL = 1e-4, 1e-3

# ResNet-50 training, bench.py::bench_resnet's configuration: the
# published ResNet-50 at full width and depth (He et al. 2016, "Deep
# Residual Learning for Image Recognition", arXiv:1512.03385, Table 1),
# ResNet(BottleneckBlock, 50, num_classes=1000, data_format='NHWC'),
# Momentum lr 0.1 momentum 0.9, CrossEntropyLoss, bf16 O2, B 256 x 224 x
# 224 x 3 bf16 images and int64 labels [B, 1] drawn from RandomState(0),
# one batch repeated.  Cut: 5 warm-up and 10 timed steps (the bench 5 +
# 30); step_fused K 5, 2 chunks against two eager trainers.
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 256, 224, 1000
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_WARMUP, RESNET_STEPS, RESNET_K = 5, 10, 5
RESNET_BN_BUFFERS = 106         # 53 BatchNorms, _mean and _variance each
# eval_step on the running statistics after the timed runs, held for
# its first RESNET_EVAL_IMAGES images against the CPU's eval of the same
# weights and buffers (eval_step runs in f32: no AMP, as the reference's):
# the logits within PARITY_GRAD_RTOL of their largest value
RESNET_EVAL_IMAGES = 4
# the f32 card-vs-CPU step, B 8 x 64 x 64 NHWC, 10 classes, each model
# from seed 0 on the card and on the CPU: the eval-mode loss and
# gradients, then one trainer step (Momentum).  Both models: the losses
# within PARITY_LOSS_RTOL, every eval-mode gradient and every BatchNorm
# buffer after the step within PARITY_GRAD_RTOL of its tensor's largest
# value.  The train-mode gradient is held against a float64 witness
# (_exact_grads: the CPU in float64 with float64 batch statistics).  A
# ReLU input within f32 rounding of 0 takes one side on one device and
# the other on another, so the gradient of the tensors before it moves
# by a step: resnet18 is held per tensor within PARITY_GRAD_RTOL plus
# how far the witness itself moves on images nudged by RESNET18_NUDGE
# of their values (RESNET18_NUDGES seeded draws; seed 0 moves one layer1
# tensor by 5e-3 of its largest value, the others 1e-5); resnet50, whose
# gradient at this size moves by 7e-3 of its norm and up to 7e-2 of a
# tensor's largest value already on images nudged by RESNET50_NUDGE, as
# one vector within RESNET50_GRAD_NORM_RTOL of its norm, from the CPU's
# and from the witness
RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE, RESNET_PARITY_CLASSES = 8, 64, 10
RESNET18_NUDGE, RESNET18_NUDGES = 1e-6, 4
RESNET50_NUDGE, RESNET50_GRAD_NORM_RTOL = 1e-7, 5e-2
# LeNet, bench.py::bench_lenet: B 256 x 1 x 28 x 28 f32, Adam lr 1e-3,
# 5 warm-up and 50 timed steps, then the bench's anchor: the loss one
# step later finite and below 1.5 times the warm-up's last
LENET_BATCH, LENET_LR, LENET_WARMUP, LENET_STEPS = 256, 1e-3, 5, 50

# Wide&Deep, bench.py::bench_widedeep's configuration: 26 sparse fields
# of 100 000 ids (Criteo-like), 13 dense features, embed 16, hidden
# (400, 400, 400), BCEWithLogitsLoss, Adam lr 1e-3, n_inputs 2, bf16 O2
# (use_pure_fp16), B 16384; ids, dense features and labels drawn from
# RandomState(0) as bench.py draws them, one batch repeated.  Cut: 2
# warm-up and 10 timed steps (the bench 5 + 30); step_fused K 5, 2
# chunks, against two eager trainers; one f32 step on the card against
# the CPU at the full configuration; DeepFM at the same configuration, 3
# steps
WD_FIELDS, WD_DENSE, WD_EMBED = [100_000] * 26, 13, 16
WD_HIDDEN, WD_BATCH, WD_LR = (400, 400, 400), 16384, 1e-3
WD_WARMUP, WD_STEPS, WD_K, DEEPFM_STEPS = 2, 10, 5, 3
# bench.py::bench_longctx: gpt_small at T 4096 (dropout 0, fused head in
# 8 chunks), AdamW lr 3e-4, bf16 O2, B 2.  Cut: 3 + 7 eager steps (the
# bench 3 + 10), then step_fused K 5 against eager
LONGCTX_MODEL_KW = dict(max_seq_len=4096, dropout=0.0, fused_head=True,
                        fused_head_chunks=8)
LONGCTX_BATCH, LONGCTX_SEQ, LONGCTX_WARMUP, LONGCTX_STEPS = 2, 4096, 3, 7
# bench.py::bench_gptgen: gpt_small (max_seq_len 256, dropout 0) in eval,
# f32, B 8, prompts of 128 ids from RandomState(0), 128 new tokens,
# greedy, 1 + 5 calls of generate; the same prompts through the
# ServingEngine (greedy) must give the same streams, or part only where
# the top two logits lie within GEN_TIE_TOL (the paged-vs-dense bound
# the tests hold, ROADMAP Queue 3)
GEN_MODEL_KW = dict(max_seq_len=256, dropout=0.0)
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_CALLS = 8, 128, 128, 5
GEN_TIE_TOL = 1e-6
GEN_SERVE_KW = dict(block_size=16, max_slots=8, decode_span=8,
                    prompt_buckets=(128,), batch_buckets=(8,),
                    prefill_batch=8, max_model_len=256, temperature=0.0)
# ERNIE 1.0 base (vocab 18000, type vocab 4, 513 positions) at BERT
# run (a)'s configuration: B 64 x T 128, dropout 0.1, AdamW lr 1e-4,
# bf16 O2, fused MLM head in 8 chunks, token types in 0..3, MLM labels
# on 15% of positions; 1 + 4 steps
ERNIE_MODEL_KW = dict(fused_head=True, fused_head_chunks=8)
ERNIE_WARMUP, ERNIE_STEPS = 1, 4
# the rest of the vision zoo at 224 x 224, bf16 O2, Momentum 0.9,
# CrossEntropyLoss, 1000 classes, NCHW (the models' own layout), 2 + 3
# steps each: (model, batch, learning rate, source of its configuration).
# The MobileNets take ResNet's lr 0.1.  VGG-16 has no BatchNorm, and its
# reference init gives logits of a large scale (a first loss of 12-18
# over 1000 classes); on one repeated batch lr 0.1 takes its loss to
# NaN within 5 steps and the paper's 0.01 up and down (12.3, 35.7,
# 76.8, 27.6, 18.0 on the CPU at B 8 x 64 x 64), so it trains at 1e-3
ZOO_MODELS = [('vgg16', 64, 1e-3, 'Simonyan & Zisserman 2014, '
               'arXiv:1409.1556, config D'),
              ('mobilenet_v1', 256, RESNET_LR, 'Howard et al. 2017, '
               'arXiv:1704.04861, Table 1'),
              ('mobilenet_v2', 256, RESNET_LR, 'Sandler et al. 2018, '
               'arXiv:1801.04381, Table 2')]
ZOO_IMAGE, ZOO_CLASSES, ZOO_WARMUP, ZOO_STEPS, ZOO_K = 224, 1000, 2, 3, 5
# Switch-Base-8's routing (Fedus et al. 2021, "Switch Transformers",
# arXiv:2101.03961, section 2 and Appendix: 8 experts in every other FFN
# layer, top-1, capacity factor 1.25, load-balance weight 0.01) on
# gpt_small, whose widths are T5-Base's (768, FFN 3072, 12 heads): 6 MoE
# blocks, ~323 M parameters, ~125 M active a token.  Trained at the GPT
# training configuration (B 8 x T 1024, bf16 O2, fused head, AdamW),
# eagerly and through step_fused; an f32 card-vs-CPU step at 2 layers
# (one MoE block); generate at gptgen's configuration (moe_gen)
MOE_KW = dict(moe_num_experts=8, moe_every=2, moe_top_k=1,
              moe_capacity_factor=1.25, moe_aux_weight=0.01)
MOE_PARITY_LAYERS = 2
# QAT of ResNet-50 at the resnet configuration (ImperativeQuantAware's
# defaults: abs_max weights, moving-average activations, 8 bits): 2 + 5
# eager steps, step_fused K 5 against eager; the .quant artifact loaded
# into a fresh float ResNet-50 (the QAT model's float state first), its
# eval logits on QAT_EVAL_IMAGES images against the QAT model's; PTQ
# over PTQ_BATCHES calibration batches of PTQ_BATCH f32 images, card
# against CPU: int8 weights and scales equal, the stem's activation
# scale equal (its input is the batch), every other within
# PARITY_GRAD_RTOL (an f32 forward in another order)
QAT_WARMUP, QAT_STEPS, QAT_EVAL_IMAGES = 2, 5, 64
PTQ_BATCHES, PTQ_BATCH = 4, 8
# sequence models (transformer*, lstm_lm*): Transformer-base
# (arXiv:1706.03762 Table 3 "base"; a shared source/target vocabulary of
# 37000, one embedding for both inputs and the pre-softmax projection,
# scaled by sqrt(d_model), sinusoidal positions; Adam 0.9/0.98/1e-9
# under Noam's schedule, label smoothing 0.1), bf16 O2, B 64 x source
# 128 x target 128 (sources 64..128 ids long, padded with id 0); and
# Zaremba et al.'s large PTB LSTM LM (arXiv:1409.2329 section 4.1: 2 x
# 1500, vocabulary 10000, 35 steps, batch 20, dropout 0.65, SGD lr 1,
# global-norm clip 10, Uniform(+-0.04) init), f32, its state zeroed
# each batch.  Each runs TRAIN_STEPS eager steps, then step_fused
# (K TRAIN_STEPS) against eager bit for bit, and an f32 card-vs-CPU step
# at B SEQ_PARITY_BATCH; the beam search (transformer_beam) decodes B
# BEAM_BATCH sources of 128 ids, beam BEAM_SIZE, BEAM_MAX_STEP + 1
# steps, f32, its first BEAM_CHECK_STEPS steps' ids and parents held to
# a decoder without caches, and B 1 x BEAM_CHECK_STEPS steps to the CPU
TRANSFORMER_KW = dict(vocab_size=37000, d_model=512, nhead=8, num_layers=6,
                      dim_feedforward=2048, dropout=0.1, max_len=256)
TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT = 64, 128, 128
TRANSFORMER_MIN_SRC, TRANSFORMER_LS, TRANSFORMER_WARMUP = 64, 0.1, 4000
TRANSFORMER_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
LN_PER_TRANSFORMER_FORWARD = 6 * 2 + 6 * 3      # post-norm: no final norm
BEAM_BATCH, BEAM_SIZE, BEAM_MAX_STEP, BEAM_CHECK_STEPS = 8, 4, 127, 16
BEAM_PROFILE_STEPS = 32
BOS, EOS = 1, 2
LSTM_LM_KW = dict(vocab_size=10000, hidden_size=1500, num_layers=2,
                  dropout=0.65, init_scale=0.04)
LSTM_LM_BATCH, LSTM_LM_STEPS, LSTM_LM_LR, LSTM_LM_CLIP = 20, 35, 1.0, 10.0
SEQ_PARITY_BATCH = 2
# hapi: examples/mnist_lenet.py's program (Adam 1e-3, B 64) fitted to
# tests/test_hapi.py's anchor (1024 synthetic MNIST images, 8 epochs,
# train-split accuracy above 0.9), fused in chunks of K, and bench.py's
# LeNet batch through Model.train_batch; the Paddle tutorial's
# ResNet-50 on Flowers-102 (f32 NCHW, B 64, the synthetic 1024-image
# train split through RandomResizedCrop(224)) over 4 process workers:
# the chip host's pipes carry a 38.5 MB batch in ~350-450 ms, with 4
# workers as with 7, so more workers buy nothing there
HAPI_LENET_N, HAPI_LENET_EPOCHS, HAPI_LENET_BATCH = 1024, 8, 64
HAPI_LENET_K, HAPI_LENET_TOL, HAPI_LENET_ACC = 4, 1e-4, 0.9
HAPI_FLOWERS_BATCH, HAPI_FLOWERS_WORKERS, HAPI_FLOWERS_WARMUP = 64, 4, 2
HAPI_FLOWERS_CHECKED = 3        # staged batches held to their host copy
HAPI_FLOWERS_WINDOW = (8, 12)   # the epoch's steps profiled for idle


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


# the port's record_function ranges: on the device's timeline they are
# spans around kernels, not kernels
ANNOTATIONS = ('ParallelTrainer.forward', 'ParallelTrainer.backward',
               'ParallelTrainer.optimizer', 'batch_norm',
               'multihead_attention', 'cross_entropy')


def self_device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


# sessions of torch.profiler to take before settling for one that missed
# kernel records (device_ms)
PROFILE_ATTEMPTS = 4


class L2Flush:
    """Evicts the 50 MB L2 by writing a 128 MB scratch buffer (a
    ``bitwise_not_`` over it: every line dirty, so whatever the next
    kernel allocates in L2 costs a write-back too).  ``names`` are the
    device kernels one flush runs, as the profiler keys them, learnt
    from a profiled flush: a cold reading leaves them out."""
    BYTES = 128 << 20

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.buf = torch.zeros(self.BYTES, dtype=torch.uint8, device='cuda')
        self()
        torch.cuda.synchronize()
        self.names = set()
        for _ in range(2 * PROFILE_ATTEMPTS):  # the profiler misses records
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    self()
                torch.cuda.synchronize()
            self.names = {e.key for e in prof.key_averages()
                          if is_device_event(e) and e.count}
            if self.names:
                break
        if not self.names:
            raise AssertionError('L2 flush: the profiler saw no device '
                                 'kernel')

    def __call__(self):
        self.buf.bitwise_not_()


_FLUSH = []


def l2_flush():
    """The one ``L2Flush`` of the run, made at first use."""
    if not _FLUSH:
        _FLUSH.append(L2Flush())
    return _FLUSH[0]


def device_ms(fn, iters=100, cold=False):
    """Mean device time per call of ``fn`` over ``iters`` calls under
    ``torch.profiler`` (CUPTI timestamps): each device kernel's mean
    duration times its launches a call, summed; and those launches a
    call.  Warm: the calls back to back, so inputs that fit the 50 MB L2
    stay in it, as for a caller that just wrote them.  Cold: the L2
    flushed before each call, the flush's kernels (by name) left out.
    The profiler can miss kernel records (a session on an H100 has shown
    6 of 20 flushes), so a session whose counts are not whole multiples
    of ``iters`` (or, cold, of one flush a call), or that saw none, is
    taken again, up to PROFILE_ATTEMPTS times; the means hold either
    way, and a kernel's launches a call are then rounded from what was
    seen.  (None, 0) when the profiler saw no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    flush = l2_flush() if cold else None
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if is_device_event(e) and e.count]
        flushes = 0
        if flush is not None:
            flushes = sum(e.count for e in events if e.key in flush.names)
            events = [e for e in events if e.key not in flush.names]
        whole = bool(events) and all(
            e.count % iters == 0 for e in events) and (
            flush is None or flushes == iters)
        if whole:
            break
    launches = {e.key: max(1, round(e.count / iters)) for e in events}
    total = sum(self_device_us(e) / e.count * launches[e.key]
                for e in events)
    return (total / 1e3 if total > 0 else None), sum(launches.values())


def _spread(values):
    """(median, [min, max]) of a list of readings."""
    return statistics.median(values), [min(values), max(values)]


def time_row(row, fns, iters=200, warmup=20, prof_iters=100, rounds=1,
             cold_iters=20):
    """Fill ``row`` for each ``{key: fn}`` (the kernel ``''``, its plain
    twin ``'plain_'``, the library call ``'library_'``), ``rounds``
    times in turns (kernel, twin, library, kernel, ...): ``<key>ms``, the
    median warm device time per call from the profiler over the rounds
    it saw (the per-call time of a back-to-back loop where it saw none,
    and ``<key>ms_from`` says which); ``<key>cold_ms``, the median device
    time with the L2 flushed before each call; ``<key>call_ms``, the
    median time per call of a back-to-back loop between CUDA events (the
    host's launch work included); each with ``<key>..._range``, the min
    and max over the rounds, and ``<key>kernels_per_call``, the device
    kernels a call ran."""
    got = {key: {'call': [], 'warm': [], 'cold': []} for key in fns}
    per_call = {}
    for _ in range(rounds):
        for key, fn in fns.items():
            got[key]['call'].append(time_ms(fn, iters=iters, warmup=warmup))
            warm, per_call[key] = device_ms(fn, iters=prof_iters)
            cold, _ = device_ms(fn, iters=min(cold_iters, prof_iters),
                                cold=True)
            got[key]['warm'].append(warm)
            got[key]['cold'].append(cold)
    for key, g in got.items():
        row[f'{key}call_ms'], row[f'{key}call_ms_range'] = _spread(g['call'])
        # the rounds the profiler saw; the events' time where it saw none
        warm = [v for v in g['warm'] if v is not None]
        cold = [v for v in g['cold'] if v is not None]
        from_profiler = bool(warm and cold)
        if not from_profiler:
            warm = cold = g['call']
        row[f'{key}ms'], row[f'{key}ms_range'] = _spread(warm)
        row[f'{key}cold_ms'], row[f'{key}cold_ms_range'] = _spread(cold)
        row[f'{key}ms_from'] = 'profiler' if from_profiler else 'events'
        row[f'{key}kernels_per_call'] = per_call[key]
    row['rounds'] = rounds
    return row


def check_cold_bound(kname, row):
    """The kernel's cold reading cannot beat the least time the card
    could take: a reading under the bound means the bound's byte count
    is wrong (a fault of the count, not of the timing)."""
    row['bound_share_cold'] = row['bound_ms'] / row['cold_ms']
    if row['cold_ms'] < row['bound_ms']:
        raise AssertionError(
            f'{kname} {row.get("case", row["shape"])}: cold reading '
            f'{row["cold_ms"] * 1e3:.3f} us under its bound '
            f'{row["bound_ms"] * 1e3:.3f} us: the bound\'s byte count is '
            'wrong')


def fmt_us(row, key):
    """``median [min-max] us`` of a reading in ``row``."""
    lo, hi = row[f'{key}_range']
    return f'{row[key] * 1e3:.2f} [{lo * 1e3:.2f}-{hi * 1e3:.2f}] us'


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by) from bytes over HBM bandwidth and flops over
    the dtype's peak."""
    peak = BF16_FLOPS_PER_S if dtype in HALF_DTYPES else F32_FLOPS_PER_S
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
    """Builds every kernel source, then prints each kernel's registers
    and spills; the softmax and LayerNorm kernels must not spill.
    Returns (build seconds, {source: {kernel: fields}})."""
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    log(f'build: {len(paths)} kernel source(s) in {secs:.2f} s '
        f'({", ".join(_build.sources())})')
    resources = {src: log_resources(_build, src) for src in _build.sources()}
    for src in NO_SPILL_SOURCES:
        # spills go to the stack frame (or local memory): both must be 0
        spills = {k: (f.get('STACK'), f.get('LOCAL'))
                  for k, f in resources[src].items()
                  if {f.get('STACK'), f.get('LOCAL')} - {None, '0'}}
        if spills:
            raise AssertionError(f'{src}: kernels spill to the stack or '
                                 f'local memory (bytes): {spills}')
    return secs, resources


def log_resources(_build, source):
    """Registers, stack and local (spill) bytes a thread of each kernel
    in ``csrc/<source>.cu`` uses, as ``cuobjdump --dump-resource-usage``
    reads them from the built library (dynamic shared memory is set per
    launch and not listed); returns ``{kernel: {'REG': .., 'STACK': ..,
    'SHARED': .., 'LOCAL': ..}}``, empty where cuobjdump is missing."""
    import os
    import re
    import shutil
    lib = _build._target(source)[1]
    tool = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    if not os.path.exists(tool):
        log(f'resources {source}: not measured (no {tool})')
        return {}
    out = subprocess.run([tool, '--dump-resource-usage', lib],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    names = re.findall(r'Function (\S+):', out)
    plain = names
    if shutil.which('c++filt'):
        plain = subprocess.run(['c++filt'], input='\n'.join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.split('\n')
    found = {}
    for mangled, name in zip(names, plain):
        usage = re.search(re.escape(mangled) + r':\s*(.*)', out).group(1)
        fields = dict(re.findall(r'(REG|STACK|SHARED|LOCAL):(\d+)', usage))
        short = re.search(r'(\w+<[^()]*>)\(', name)
        kernel = short.group(1) if short else name
        found[kernel] = fields
        log(f'resources {source}: {kernel} '
            f'registers {fields.get("REG")}, stack {fields.get("STACK")} '
            f'B, static shared {fields.get("SHARED")} B, local (spill) '
            f'{fields.get("LOCAL")} B')
    return found


def launch_counts():
    """Every kernel's launches since the counts were last set to 0, and
    for a kernel with more than one design each design's, under
    ``'<kernel>:<design>'``."""
    from paddle_tpu_torch.ops import _build
    counts = {}
    for k in _build.KERNELS:
        counts[k.name] = k.launches
        for variant, n in k.variant_launches.items():
            counts[f'{k.name}:{variant}'] = n
    return counts


def launch_floor_ms(rounds):
    """(median, [min, max]) device ms of a one-element PyTorch kernel
    (``t[:1].zero_()``): the floor under any launch; (None, None) where
    the profiler saw none of its launches."""
    t = torch.zeros(1024, device='cuda')
    seen = [v for v in (device_ms(lambda: t[:1].zero_(), iters=100)[0]
                        for _ in range(rounds)) if v is not None]
    return _spread(seen) if seen else (None, None)


def check_design(kernel, design, what):
    """Exactly one launch since the counts were set to 0, on ``design``."""
    want = {v: int(v == design) for v in kernel.variant_launches}
    if kernel.launches != 1 or kernel.variant_launches != want:
        raise AssertionError(f'{kernel.name} {what}: expected one launch of '
                             f'the {design} design, counts '
                             f'{kernel.variant_launches}')


def kernel_phase():
    """fused_layer_norm against its plain twin on the card, in the design
    the wrapper names for each shape, repeated bit for bit, timed warm
    and cold in LN_ROUNDS turns beside the twin and F.layer_norm, the
    decode row beside the launch floor."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import _build, fused_norm
    rows = []
    floor, floor_range = launch_floor_ms(LN_ROUNDS)
    log('launch floor: t[:1].zero_() device ' + (
        'not measured (the profiler saw no launch)' if floor is None else
        f'{floor * 1e3:.2f} [{floor_range[0] * 1e3:.2f}-'
        f'{floor_range[1] * 1e3:.2f}] us (median [min-max] of {LN_ROUNDS} '
        'rounds)'))
    gen = torch.Generator().manual_seed(0)
    for (n, h), dtype, tol in KERNEL_SHAPES:
        x = (torch.randn((n, h), generator=gen) * 2 + 0.5) \
            .to('cuda', dtype)
        g = (1 + 0.1 * torch.randn((h,), generator=gen)).cuda()
        b = (0.1 * torch.randn((h,), generator=gen)).cuda()
        design = fused_norm.VARIANTS[h > fused_norm._WARP_MAX_H]
        what = f'{n}x{h} {dtype}'
        _build.reset_launches()
        y, mean, rstd = fused_norm._fwd_cuda(x, g, b, 1e-5)
        ry, rmean, rrstd = fused_norm._reference(x, g, b, 1e-5)
        torch.cuda.synchronize()
        check_design(fused_norm.KERNEL, design, what)
        err = float((y.float() - ry.float()).abs().max())
        stat_err = max(float((mean - rmean).abs().max()),
                       float((rstd - rrstd).abs().max()))
        if not (err <= tol and stat_err <= 1e-5):
            raise AssertionError(
                f'fused_layer_norm {what}: max |y - plain| '
                f'{err:.3e} (tol {tol}), stats {stat_err:.3e} (tol 1e-5)')
        # no atomics: a second launch repeats the first bit for bit
        again = fused_norm._fwd_cuda(x, g, b, 1e-5)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip((y, mean, rstd), again)):
            raise AssertionError(f'fused_layer_norm {what}: a second launch '
                                 'changed the result')
        gl, bl = g.to(dtype), b.to(dtype)
        fns = {'': lambda: fused_norm._fwd_cuda(x, g, b, 1e-5),
               'plain_': lambda: fused_norm._reference(x, g, b, 1e-5),
               'library_': lambda: TF.layer_norm(x, (h,), gl, bl, 1e-5)}
        row = {'shape': [n, h], 'dtype': str(dtype).replace('torch.', ''),
               'design': design, 'tol': tol, 'max_abs_err': err,
               'repeats_bit_for_bit': True, 'library': 'F.layer_norm'}
        time_row(row, fns, rounds=LN_ROUNDS)
        with torch.no_grad():
            # serving's call: the public function, nothing to differentiate
            row['public_call_ms'] = time_ms(
                lambda: fused_norm.fused_layer_norm(x, g, b, 1e-5))
        row['bound_ms'], row['bound_by'] = layer_norm_bound(n, h, dtype)
        check_cold_bound('fused_layer_norm', row)
        floor_note = ''
        if len(rows) == 0 and floor is not None:  # decode: latency
            row['launch_floor_ms'] = floor
            row['launch_floor_ms_range'] = floor_range
            floor_note = (f' | launch floor {floor * 1e3:.2f} us: kernel '
                          f'{row["ms"] / floor:.2f}x, F.layer_norm '
                          f'{row["library_ms"] / floor:.2f}x')
        log(f'kernel fused_layer_norm {what.replace("torch.", "")} '
            f'[{design}, repeats bit for bit]: max_abs_err {err:.3e} (tol '
            f'{tol}) | warm device: kernel {fmt_us(row, "ms")}, plain '
            f'{fmt_us(row, "plain_ms")}, F.layer_norm '
            f'{fmt_us(row, "library_ms")} ({row["ms_from"]}; kernels a call '
            f'{row["kernels_per_call"]:g}, {row["library_kernels_per_call"]:g}'
            f') | cold device: kernel {fmt_us(row, "cold_ms")}, F.layer_norm '
            f'{fmt_us(row, "library_cold_ms")} | per call: kernel '
            f'{fmt_us(row, "call_ms")} (public, no grad '
            f'{row["public_call_ms"] * 1e3:.2f} us), plain '
            f'{row["plain_call_ms"] * 1e3:.2f} us, F.layer_norm '
            f'{fmt_us(row, "library_call_ms")} | bound '
            f'{row["bound_ms"] * 1e3:.3f} us ({row["bound_by"]}), '
            f'{row["bound_share_cold"] * 100:.1f}% of it cold'
            + floor_note)
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
    the card, in the design the wrapper routes each case to (checked by
    the kernels' per-design counts), timed beside the twin, SDPA and the
    bound."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import _build
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
        design = 'simt' if dtype == torch.float32 else 'mma'
        _build.reset_launches()
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
        counts = launch_counts()
        for kname in FLASH_KERNELS:
            if counts[f'{kname}:{design}'] != 1 or counts[kname] != 1:
                raise AssertionError(f'{kname} {case}: expected one launch '
                                     f'of the {design} design, counts '
                                     f'{counts}')
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
        if dtype in HALF_DTYPES:
            # the tensor-core kernels use no atomics: a second launch on
            # the same inputs repeats the first bit for bit
            again = (*fa._fwd_cuda(q, k, v, causal, scale),
                     fa._bwd_dq_cuda(*args), *fa._bwd_dkv_cuda(*args))
            torch.cuda.synchronize()
            for what, a, b in zip(('o', 'lse', 'dq', 'dk', 'dv'),
                                  (o, lse, dq, dk, dv), again):
                if not torch.equal(a, b):
                    raise AssertionError(f'flash {case}: a second launch '
                                         f'changed {what}')
            log(f'flash {case}: forward, dq and dk/dv repeat bit for bit')
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
                   'design': design, 'causal': causal, 'g_lse': with_glse,
                   'tol': FLASH_TOL[dtype], 'max_abs_err': errs[kname],
                   'library': 'F.scaled_dot_product_attention' + (
                       '' if kname == 'flash_attention_fwd'
                       else ' backward (dq, dk, dv together)')}
            time_row(row, fns[kname], iters=20, warmup=3, prof_iters=10)
            (row['bound_ms'], row['bound_by'], row['flops'],
             row['bytes']) = bounds[kname]
            row['tflops'] = row['flops'] / (row['ms'] / 1e3) / 1e12
            log(f'kernel {kname} {case} {bh}x{T}x{D} {row["dtype"]} '
                f'causal={causal} [{design}]: max_abs_err '
                f'{errs[kname]:.3e} | device: '
                f'kernel {row["ms"] * 1e3:.1f} us, cold '
                f'{row["cold_ms"] * 1e3:.1f} us '
                f'({row["tflops"]:.1f} TFLOP/s), plain '
                f'{row["plain_ms"] * 1e3:.1f} us, SDPA '
                f'{row["library_ms"] * 1e3:.1f} us ({row["ms_from"]}) | '
                f'per call: kernel {row["call_ms"] * 1e3:.1f} us | bound '
                f'{row["bound_ms"] * 1e3:.2f} us ({row["bound_by"]})')
            rows[kname].append(row)
        del lib_out, q4, k4, v4
    return rows


def _ops_module(name):
    """``paddle_tpu_torch.ops.<name>`` as a module (the package's
    ``fused_softmax`` attribute is the function of that name)."""
    import importlib
    return importlib.import_module(f'paddle_tpu_torch.ops.{name}')


def softmax_kernel_phase():
    """Both softmax kernels against their plain twin on the card, in the
    design the wrapper names for each case, repeated bit for bit, timed
    warm and cold in SOFTMAX_ROUNDS turns beside the twin and the library
    call, the masked one launched through the public
    ``ops.fused_softmax(x, mask)`` (no model path reaches it, as in the
    reference)."""
    from paddle_tpu_torch.ops import _build, fused_softmax
    fsm = _ops_module('fused_softmax')
    rows = {k: [] for k in SOFTMAX_KERNELS}
    gen = torch.Generator().manual_seed(2)
    for case, shape, dtype, mshape, design in SOFTMAX_CASES:
        x = (3 * torch.randn(shape, generator=gen)).to('cuda', dtype)
        mask = None
        if mshape is not None:
            # padding: each sequence keeps a seeded prefix, -1e9 after
            keep = torch.rand(mshape, generator=gen) < 0.8
            if mshape[1:3] == (1, 1):
                lens = torch.randint(shape[-1] // 4, shape[-1] + 1,
                                     (mshape[0], 1, 1, 1), generator=gen)
                keep = torch.arange(shape[-1]) < lens
            mask = torch.where(keep, 0.0, -1e9).cuda()
        kname = SOFTMAX_KERNELS[mask is not None]
        kernel = (fsm.KERNEL, fsm.MASKED_KERNEL)[mask is not None]
        _build.reset_launches()
        y = fused_softmax(x, mask)
        want = fsm._reference(x, mask)
        torch.cuda.synchronize()
        check_design(kernel, design, case)
        tol = SOFTMAX_TOL[dtype]
        err, ok = worst_err(y, want, tol)
        if not ok:
            raise AssertionError(f'{kname} {case} {shape} {dtype}: max '
                                 f'|y - plain| {err:.3e} beyond tol {tol}')
        # no atomics: a second launch repeats the first bit for bit
        again = fused_softmax(x, mask)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f'{kname} {case}: a second launch changed '
                                 'the result')
        if mask is None:
            lib = lambda: torch.softmax(x, dim=-1)  # noqa: E731
            library = 'torch.softmax'
        else:
            lib = lambda: torch.softmax(x + mask, dim=-1)  # noqa: E731
            library = 'torch.softmax(x + mask): two calls'
        fns = {'': lambda: fused_softmax(x, mask),
               'plain_': lambda: fsm._reference(x, mask), 'library_': lib}
        n, h = x.numel() // shape[-1], shape[-1]
        nbytes = 2 * x.numel() * x.element_size() + (
            0 if mask is None else mask.numel() * 4)
        row = {'case': case, 'shape': list(shape),
               'mask_shape': None if mask is None else list(mshape),
               'dtype': str(dtype).replace('torch.', ''), 'design': design,
               'tol': tol, 'max_abs_err': err, 'repeats_bit_for_bit': True,
               'library': library, 'bytes': nbytes, 'flops': 4 * n * h}
        time_row(row, fns, iters=50, warmup=5, prof_iters=20,
                 rounds=SOFTMAX_ROUNDS, cold_iters=10)
        # bytes bound; ~4 f32 operations per element (max, subtract,
        # exp, scale) are far below the f32 peak
        row['bound_ms'], row['bound_by'] = bound(nbytes, 4 * n * h,
                                                 torch.float32)
        check_cold_bound(kname, row)
        log(f'kernel {kname} {case} {list(shape)} {row["dtype"]}'
            + ('' if mask is None else f' mask {list(mshape)}')
            + f' [{design}, repeats bit for bit]: max_abs_err {err:.3e} '
            f'(tol {tol:.3g}) | warm device: kernel {fmt_us(row, "ms")}, '
            f'plain {fmt_us(row, "plain_ms")}, {library} '
            f'{fmt_us(row, "library_ms")} ({row["ms_from"]}) | cold device: '
            f'kernel {fmt_us(row, "cold_ms")}, {library} '
            f'{fmt_us(row, "library_cold_ms")} | per call: kernel '
            f'{fmt_us(row, "call_ms")} | bound {row["bound_ms"] * 1e3:.2f} '
            f'us ({row["bound_by"]}), {row["bound_share_cold"] * 100:.1f}% '
            'of it cold')
        rows[kname].append(row)
    return rows


def gelu_bounds(M, K, N, dtype):
    """{kernel: (bound_ms, bound_by, flops, bytes)}: 2*M*N*K flops each;
    forward reads x, w and the f32 bias and writes y, backward also
    reads dy and writes dz."""
    es = torch.empty((), dtype=dtype).element_size()
    io = (M * K + K * N) * es + 4 * N
    work = {'fused_linear_gelu_fwd': io + M * N * es,
            'fused_linear_gelu_bwd': io + 2 * M * N * es}
    flops = 2 * M * N * K
    return {k: (*bound(nb, flops, dtype), flops, nb)
            for k, nb in work.items()}


def gelu_kernel_phase():
    """The GEMM+GELU forward and backward kernels against their plain
    twins on the card, in the design the wrapper routes each case to
    (checked by the kernels' per-design counts), repeated bit for bit,
    timed beside the twin, one library call and the bound."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import _build
    fgl = _ops_module('fused_gelu_linear')
    rows = {k: [] for k in GELU_KERNELS}
    gen = torch.Generator().manual_seed(3)
    fused_act = hasattr(torch, '_addmm_activation')
    for case, M, K, N, dtype, approx in GELU_CASES:
        x = torch.randn((M, K), generator=gen).to('cuda', dtype)
        w = (0.05 * torch.randn((K, N), generator=gen)).to('cuda', dtype)
        b = torch.randn((N,), generator=gen).cuda()
        dy = torch.randn((M, N), generator=gen).to('cuda', dtype)
        design = fgl.VARIANTS[0 if fgl.tensor_core_route(x, w) else 1]
        _build.reset_launches()
        y = fgl._fwd_cuda(x, w, b, approx)
        dz = fgl._bwd_cuda(x, w, b, dy, approx)
        ry = fgl._reference(x, w, b, approx)
        rdz = fgl._dz_reference(x, w, b, dy, approx)
        torch.cuda.synchronize()
        counts = launch_counts()
        for kname in GELU_KERNELS:
            if counts[f'{kname}:{design}'] != 1:
                raise AssertionError(f'{kname} {case}: expected one launch '
                                     f'of the {design} design, counts '
                                     f'{counts}')
        tol = GELU_TOL[dtype]
        errs = {}
        for kname, got, want in ((GELU_KERNELS[0], y, ry),
                                 (GELU_KERNELS[1], dz, rdz)):
            errs[kname], ok = worst_err(got, want, tol)
            if not ok:
                raise AssertionError(
                    f'{kname} {case} {M}x{K}x{N} {dtype}: max |out - '
                    f'plain| {errs[kname]:.3e} beyond tol {tol} * (1 + '
                    '|plain|)')
        # neither design uses atomics: a second launch on the same inputs
        # repeats the first bit for bit
        again = (fgl._fwd_cuda(x, w, b, approx),
                 fgl._bwd_cuda(x, w, b, dy, approx))
        torch.cuda.synchronize()
        for what, first, second in zip(('y', 'dz'), (y, dz), again):
            if not torch.equal(first, second):
                raise AssertionError(f'gelu {case}: a second launch changed '
                                     f'{what}')
        bl = b.to(dtype)
        form = 'tanh' if approx else 'none'
        if approx and fused_act:
            lib_fwd = lambda: torch._addmm_activation(  # noqa: E731
                bl, x, w, use_gelu=True)
            fwd_name = 'torch._addmm_activation(use_gelu=True)'
        else:
            lib_fwd = lambda: TF.gelu(TF.linear(  # noqa: E731
                x, w.t(), bl), approximate=form)
            fwd_name = 'F.linear + F.gelu: two calls'
        lib_bwd = lambda: torch.ops.aten.gelu_backward(  # noqa: E731
            dy, torch.addmm(bl, x, w), approximate=form)
        fns = {GELU_KERNELS[0]: {
                   '': lambda: fgl._fwd_cuda(x, w, b, approx),
                   'plain_': lambda: fgl._reference(x, w, b, approx),
                   'library_': lib_fwd},
               GELU_KERNELS[1]: {
                   '': lambda: fgl._bwd_cuda(x, w, b, dy, approx),
                   'plain_': lambda: fgl._dz_reference(x, w, b, dy,
                                                       approx),
                   'library_': lib_bwd}}
        libs = {GELU_KERNELS[0]: fwd_name,
                GELU_KERNELS[1]: 'torch.addmm + aten.gelu_backward: two '
                                 'calls'}
        bounds = gelu_bounds(M, K, N, dtype)
        for kname in GELU_KERNELS:
            row = {'case': case, 'shape': [M, K, N],
                   'dtype': str(dtype).replace('torch.', ''),
                   'approximate': approx, 'design': design, 'tol': tol,
                   'max_abs_err': errs[kname], 'library': libs[kname],
                   'repeats_bit_for_bit': True}
            time_row(row, fns[kname], iters=10, warmup=2, prof_iters=5)
            (row['bound_ms'], row['bound_by'], row['flops'],
             row['bytes']) = bounds[kname]
            row['tflops'] = row['flops'] / (row['ms'] / 1e3) / 1e12
            log(f'kernel {kname} {case} {M}x{K}x{N} {row["dtype"]} '
                f'gelu={form} [{design}, repeats bit for bit]: max_abs_err '
                f'{errs[kname]:.3e} | device: '
                f'kernel {row["ms"] * 1e3:.1f} us, cold '
                f'{row["cold_ms"] * 1e3:.1f} us '
                f'({row["tflops"]:.2f} TFLOP/s), plain '
                f'{row["plain_ms"] * 1e3:.1f} us, {libs[kname]} '
                f'{row["library_ms"] * 1e3:.1f} us ({row["ms_from"]}) | '
                f'per call: kernel {row["call_ms"] * 1e3:.1f} us | bound '
                f'{row["bound_ms"] * 1e3:.2f} us ({row["bound_by"]})')
            rows[kname].append(row)
    return rows


def _captured(cache, what):
    """The modules of a ``GraphCache``, each a captured CUDA graph."""
    from paddle_tpu_torch.core.compile_cache import GraphModule
    mods = dict(cache.modules)
    if not mods or not all(isinstance(m, GraphModule) and m.graph is not None
                           for m in mods.values()):
        raise AssertionError(f'{what} modules are not captured graphs: '
                             f'{mods}')
    return mods


def _decode_graphs(eng):
    """The engine's decode modules (CUDA graphs), by (S, K)."""
    return _captured(eng._modules, 'serving decode')


def _prefill_graphs(eng):
    """The engine's prefill modules (CUDA graphs), by (P, B)."""
    return _captured(eng._prefill_modules, 'serving prefill')


def _graph_log(graphs):
    return ', '.join(f'{sig}: {g.capture_s:.3f} s, launches a replay '
                     f'{g.launches.counts()}'
                     for sig, g in sorted(graphs.items()))


def _warm_engine(eng, what):
    """``warmup()``, then the captured prefill and decode sets must be
    the declared ones; logs each graph's capture seconds and launches a
    replay.  Returns (warmup s, decode graphs, prefill graphs)."""
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    decode, prefill = _decode_graphs(eng), _prefill_graphs(eng)
    buckets = eng.bucket_set()
    want_d = {(S, buckets['decode_span']) for S in buckets['batch_buckets']}
    want_p = {(P, B) for P in buckets['prompt_buckets']
              for B in buckets['prefill_chunks']}
    if set(decode) != want_d or set(prefill) != want_p:
        raise AssertionError(
            f'{what}: warmup captured decode {sorted(decode)} and prefill '
            f'{sorted(prefill)}, declared {sorted(want_d)} and '
            f'{sorted(want_p)}')
    log(f'{what} warmup: {warm_s:.2f} s; decode graphs (S, K) captured in '
        f'{sum(g.capture_s for g in decode.values()):.3f} s ('
        + _graph_log(decode) + '); prefill graphs (P, B) captured in '
        f'{sum(g.capture_s for g in prefill.values()):.3f} s ('
        + _graph_log(prefill) + ')')
    return warm_s, decode, prefill


def _serve_main_path(eng, reqs, what):
    """``eng.run(reqs)`` with the counts at 0 just before and read just
    after, then its gates: every request DONE, the allocator audit
    clean, every block back, no capture during traffic, every decode
    step a step of a replayed decode graph and every prefill dispatch a
    replayed prefill graph, and LayerNorm's launches exactly the
    captured launches times the replays, on the warp design.  Returns
    (launches, report, summary)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import Request
    cfg = eng.model.config
    K = eng.config.decode_span
    decode, prefill = _decode_graphs(eng), _prefill_graphs(eng)
    p0, d0 = eng.prefill_dispatches, eng.decode_steps
    dr0 = {sig: g.replays for sig, g in decode.items()}
    pr0 = {sig: g.replays for sig, g in prefill.items()}
    rids = {r.rid for r in reqs}
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cpu0 = time.process_time()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    host_cpu_s = time.process_time() - cpu0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prefills = eng.prefill_dispatches - p0
    steps = eng.decode_steps - d0
    dreplays = {sig: g.replays - dr0[sig] for sig, g in decode.items()}
    preplays = {sig: g.replays - pr0[sig] for sig, g in prefill.items()}

    done = [r for r in eng.scheduler.finished if r.rid in rids]
    if len(done) != len(rids) or any(r.state != Request.DONE for r in done):
        raise AssertionError(
            f'{what}: not every request is DONE: '
            f'{[(r.rid, r.state, r.reason) for r in done]}')
    if rep['audit']:
        raise AssertionError(f'{what}: allocator audit: {rep["audit"]}')
    if eng.cache.free_blocks != eng.cache.num_blocks - 1:
        raise AssertionError(f'{what}: free blocks {eng.cache.free_blocks} '
                             f'!= {eng.cache.num_blocks - 1}')
    if set(_decode_graphs(eng)) != set(decode) or \
            set(_prefill_graphs(eng)) != set(prefill):
        raise AssertionError(f'{what}: traffic captured a module warmup '
                             'did not')
    if steps != K * sum(dreplays.values()):
        raise AssertionError(f'{what}: {steps} decode steps, but '
                             f'{dreplays} graph replays of {K} steps')
    if prefills != sum(preplays.values()) or not prefills:
        raise AssertionError(f'{what}: {prefills} prefill dispatches, but '
                             f'{preplays} prefill graph replays')
    per_forward = 2 * cfg.num_layers + 1

    def captured(graphs, replays):
        return sum(graphs[sig].launches.counts()['fused_layer_norm'] * n
                   for sig, n in replays.items())

    cap_d, cap_p = captured(decode, dreplays), captured(prefill, preplays)
    if cap_d != per_forward * steps or cap_p != per_forward * prefills:
        raise AssertionError(
            f'{what}: captured LayerNorm launches x replays: decode {cap_d} '
            f'!= {per_forward} x {steps}, or prefill {cap_p} != '
            f'{per_forward} x {prefills}')
    for key in ('fused_layer_norm', 'fused_layer_norm:warp'):
        if launches[key] != cap_d + cap_p:
            raise AssertionError(
                f'{what}: {key} launched {launches[key]} times, expected '
                f'the replays\' {cap_d} + {cap_p} and no eager launch')
    log(f'{what}: {len(rids)} requests DONE, audit clean, '
        f'{eng.cache.free_blocks} blocks free; {prefills} prefill '
        f'dispatches, all graph replays '
        f'{dict(sorted((k, n) for k, n in preplays.items() if n))}, + '
        f'{steps} decode steps in graph replays '
        f'{dict(sorted(dreplays.items()))} ({rep["interventions"]} '
        f'interventions); fused_layer_norm launches '
        f'{launches["fused_layer_norm"]} = {cap_p} prefill + {cap_d} decode '
        f'captured x replays, none eager, all on the warp design')
    log(f'{what}: {rep["decoded_tokens"]} tokens in {rep["wall_s"]:.3f} s '
        f'= {rep["tokens_per_s"]:.1f} tokens/s; TTFT p50 '
        f'{rep["ttft_p50_s"] * 1e3:.1f} ms, p99 '
        f'{rep["ttft_p99_s"] * 1e3:.1f} ms; TPOT mean '
        f'{rep["tpot_mean_s"] * 1e3:.2f} ms; peak max_memory_allocated '
        f'{peak / 2**30:.2f} GiB')
    summary = {'tokens_per_s': rep['tokens_per_s'], 'wall_s': rep['wall_s'],
               'ttft_p50_s': rep['ttft_p50_s'],
               'ttft_p99_s': rep['ttft_p99_s'],
               'tpot_mean_s': rep['tpot_mean_s'], 'peak_bytes': peak,
               'host_cpu_s': host_cpu_s,
               'graphs': [list(sig) for sig in sorted(decode)],
               'capture_s': sum(g.capture_s for g in decode.values()),
               'prefill_graphs': {f'{P}x{B}': {
                   'capture_s': g.capture_s,
                   'layer_norm_a_replay':
                       g.launches.counts()['fused_layer_norm'],
                   'replays': preplays[(P, B)]}
                   for (P, B), g in sorted(prefill.items())},
               'prefill_capture_s': sum(g.capture_s
                                        for g in prefill.values()),
               'decode_steps': steps,
               'replays': {f'{S}x{k}': n for (S, k), n in dreplays.items()},
               'prefill_dispatches': prefills}
    return launches, rep, summary


def _check_spans_against_eager(eng):
    """Makes every span of ``eng`` run the eager span body on the same
    plan first (writing the same KV positions), then the graph, and
    fail unless the two outputs are equal.  Returns the list of
    checked (S, K) spans."""
    make = eng._decode_module
    checked = []

    def module(S, K):
        graph = make(S, K)

        def both(plan):
            want = eng._span_body(plan.to(eng.device), K).clone()
            got = graph(plan)
            if not torch.equal(got, want):
                raise AssertionError(
                    f'decode span (S {S}, K {K}): the replayed graph '
                    'differs from the eager span body on the same plan')
            checked.append((S, K))
            return got
        return both

    eng._decode_module = module
    return checked


def _eager_prefill(eng):
    """Routes ``eng``'s prefill dispatches through the eager module body
    on the same plan, in place of the graphs."""
    eng._prefill_module = lambda P, B: (
        lambda plan: eng._prefill_body(plan.to(eng.device), P))


def _prefill_graphs_vs_eager(model, reqs):
    """The same requests, all submitted at once (so both schedules are
    the same), through two fresh engines: prefill graphs in one, the
    eager prefill body in the other.  Equal streams, token for token,
    and equal KV pools outside the trash block, which the padding rows
    of a chunk all write."""
    from paddle_tpu_torch.serving import Request, ServeConfig, ServingEngine
    runs = []
    for eager in (False, True):
        eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG_KW))
        if eager:
            _eager_prefill(eng)
        eng.warmup()
        subs = [eng.submit(r.prompt, r.max_new_tokens, rid=r.rid)
                for r in reqs]
        eng.run()
        if any(r.state != Request.DONE for r in subs):
            raise AssertionError('prefill parity: not every request DONE')
        runs.append((eng, subs))
    (geng, greqs), (eeng, ereqs) = runs
    replays = sum(g.replays for g in _prefill_graphs(geng).values())
    if replays != geng.prefill_dispatches:
        raise AssertionError(f'prefill parity: {geng.prefill_dispatches} '
                             f'dispatches, {replays} graph replays')
    for g, e in zip(greqs, ereqs):
        if g.tokens != e.tokens:
            raise AssertionError(f'{g.rid}: graphed prefill stream differs '
                                 'from the eager prefill\'s')
    for layer, ((gk, gv), (ek, ev)) in enumerate(zip(geng.cache.pools,
                                                     eeng.cache.pools)):
        if not (torch.equal(gk[1:], ek[1:]) and torch.equal(gv[1:], ev[1:])):
            raise AssertionError(f'prefill parity: layer {layer}\'s KV pool '
                                 'differs outside the trash block')
    log(f'parity: {len(reqs)} requests at once through prefill graphs '
        f'({geng.prefill_dispatches} dispatches, all replays) and through '
        f'the eager prefill body ({eeng.prefill_dispatches}): equal streams '
        f'({sum(len(r.tokens) for r in greqs)} tokens) and equal KV pools '
        f'of all {len(geng.cache.pools)} layers outside the trash block')
    del geng, eeng, runs


def serving_phase():
    """gpt_small at full width through the continuous-batching engine,
    its prefill and decode modules as replayed CUDA graphs.  Returns
    (launches, summary, each request's greedy stream by rid)."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.serving import (Request, ServeConfig,
                                          ServingEngine, poisson_requests)
    model = gpt_small(device='cuda', seed=0, **SERVE_MODEL_KW)
    cfg = model.config
    log(f'model: gpt_small vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, layers {cfg.num_layers}, heads '
        f'{cfg.num_heads}, max_seq_len {cfg.max_seq_len}, f32, seed 0')
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG_KW))
    _warm_engine(eng, 'serve')
    reqs = poisson_requests(NUM_REQUESTS, vocab_size=cfg.vocab_size,
                            **SERVE_LOAD_KW)
    prompts = {r.rid: r.prompt.copy() for r in reqs}
    # the main path: counts at 0 just before, read just after
    launches, rep, summary = _serve_main_path(eng, reqs, 'serve')
    streams = {r.rid: list(r.tokens) for r in reqs}

    # the same requests again: every span through the graph and through
    # the eager span body on the same plan, equal outputs
    checked = _check_spans_against_eager(eng)
    again = poisson_requests(NUM_REQUESTS, vocab_size=cfg.vocab_size,
                             **SERVE_LOAD_KW)
    eng.run(again)
    if any(r.state != Request.DONE for r in again) or \
            eng.scheduler.audit():
        raise AssertionError('checked serving run: not every request DONE')
    log(f'parity: {len(checked)} decode spans of {NUM_REQUESTS} requests '
        f'(buckets {sorted(set(S for S, _ in checked))}): replayed graph '
        '== eager span body on the same plan, every token of every stream')
    del eng
    _free()
    _prefill_graphs_vs_eager(model, reqs)
    _free()

    # greedy streams of two requests equal batch-1 generate (its graph)
    by_len = sorted(reqs, key=lambda r: (r.prompt.size, r.rid))
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
    del model
    _free()
    return launches, summary, streams


# the live plane's phases (after the serve phase): the same gpt_small
# deployment behind the HTTP front door, and the reference drill's
# fleet.  The door's watchdog budget is generous (no request of the
# drive may time out); its profile window covers decode interventions
# 4 and 5, i.e. decode step ids 32..47 at span 8.
FRONTDOOR_WATCHDOG = dict(step_s=30.0, first_step_s=60.0)
FRONTDOOR_PROFILE_SPANS = (4, 5)
FRONTDOOR_SCRAPE_S = 0.05
FRONTDOOR_BURST = 8             # requests at once at a door of max_queue 1
LN_PER_FORWARD = 2 * 12 + 1     # LayerNorms in one gpt_small forward
# bench.py::_frontdoor_smoke_child's deployment, with gpt_small at full
# width and depth: the pool and sampling are deployment parameters
FLEET_DOC = dict(model='small', model_kwargs=dict(SERVE_MODEL_KW),
                 block_size=8, max_slots=4, decode_span=4, num_blocks=64,
                 temperature=0.7, top_k=8, seed=13)
FLEET_REPLICAS, FLEET_SPARES = 2, 1
# the overload burst: released at once (the bench's 24 requests at 2 ms
# gaps fit two replicas' 4 slots + 8 queued each on the card)
FLEET_OVERLOAD = 48
FLEET_POLL_S = 0.002            # the replicas' counters, during the kill drill


def _http(host, port, method, path, doc=None, timeout=60):
    """(status, headers, parsed JSON or text) of one request."""
    import http.client
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request(method, path, body=None if doc is None else
                  json.dumps(doc),
                  headers={'Content-Type': 'application/json'})
        r = c.getresponse()
        raw = r.read().decode()
        ctype = r.getheader('Content-Type') or ''
        body = json.loads(raw) if ctype.startswith('application/json') \
            else raw
        return r.status, dict(r.getheaders()), body
    finally:
        c.close()


def _sse(port, doc, out, start_at=None, timeout=120):
    """One SSE request to ``127.0.0.1:port``; fills ``out`` with its
    status, tokens, terminal record and client-side times (send, first
    token, done; ``time.perf_counter``)."""
    import http.client
    if start_at is not None:
        time.sleep(max(0.0, start_at - time.perf_counter()))
    out['t_send'] = time.perf_counter()
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        c.request('POST', '/v1/generate', body=json.dumps(doc),
                  headers={'Content-Type': 'application/json'})
        r = c.getresponse()
        out['status'] = r.status
        out['headers'] = dict(r.getheaders())
        if r.status != 200:
            out['body'] = json.loads(r.read().decode())
            return out
        tokens = out['tokens'] = []
        while True:
            line = r.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b'data: '):
                continue
            ev = json.loads(line[len(b'data: '):])
            if ev.get('done'):
                out['done'] = ev
                r.read()            # the terminal chunk: leave nothing unread
                break
            if not tokens:
                out['t_first'] = time.perf_counter()
            tokens.append(int(ev['token']))
        out['t_done'] = time.perf_counter()
        return out
    finally:
        c.close()


def door_client():
    """The ``frontdoor`` phase's load, in a process of its own (so its
    threads do not contend for the server's GIL): reads a job from
    stdin (``port``, ``scrape`` [(port, path)], ``scrape_s``,
    ``requests`` [{rid, prompt, max_new_tokens, arrival_s}]), sends each
    request as an SSE stream at its arrival offset while one thread
    scrapes the given routes, and prints one JSON line: every stream's
    status, tokens and times (``time.perf_counter``, the system's
    monotonic clock) and every scrape's route and status."""
    import threading
    job = json.loads(sys.stdin.read())
    outs = {r['rid']: {} for r in job['requests']}
    scrapes, stop = [], threading.Event()

    def scrape():
        while not stop.is_set():
            for port, path in job['scrape']:
                st, _h, body = _http('127.0.0.1', port, 'GET', path,
                                     timeout=10)
                scrapes.append([path, st, 'paddle_tpu_serve_' in body
                                if path == '/metrics' else True])
            stop.wait(job['scrape_s'])

    t0 = time.perf_counter()
    scraper = threading.Thread(target=scrape, daemon=True)
    threads = [threading.Thread(target=_sse, args=(
        job['port'], {'prompt': r['prompt'],
                      'max_new_tokens': r['max_new_tokens'],
                      'rid': r['rid']}, outs[r['rid']],
        t0 + r['arrival_s']), daemon=True) for r in job['requests']]
    scraper.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    stop.set()
    scraper.join(30)
    for out in outs.values():
        out.pop('headers', None)
    print(json.dumps({'outs': outs, 'scrapes': scrapes}), flush=True)


def _refused(port):
    """True when nothing listens on 127.0.0.1:port any more."""
    import socket
    try:
        socket.create_connection(('127.0.0.1', port), timeout=2).close()
        return False
    except OSError:
        return True


def _live_threads():
    import threading
    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.startswith('paddle-tpu'))


def _trace_idle_share(path):
    """(device idle share, device busy s, traced s) of one exported
    profile window: 1 - the union of its device-kernel intervals over
    the span its events cover (the profiler's own start, stop and
    export lie outside that span)."""
    import gzip
    with gzip.open(path, 'rt') as f:
        doc = json.load(f)
    events = [e for e in doc.get('traceEvents', []) if e.get('ph') == 'X'
              and 'ts' in e and 'dur' in e]
    lo = min(float(e['ts']) for e in events)
    hi = max(float(e['ts']) + float(e['dur']) for e in events)
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                   for e in events if str(e.get('cat', '')).lower()
                   in ('kernel', 'gpu_memcpy', 'gpu_memset'))
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return 1.0 - busy / (hi - lo), busy / 1e6, (hi - lo) / 1e6


def _door_gates(eng, decode0, prefill0, p0, d0, launches, serve):
    """LayerNorm's launches on the door's run: exactly the captured
    launches times the replays, a replay launching what the unarmed
    serve path's graphs launch (25 a prefill, 25 x K a decode span),
    no capture during traffic and none eager."""
    K = eng.config.decode_span
    decode, prefill = _decode_graphs(eng), _prefill_graphs(eng)
    if set(decode) != set(decode0) or set(prefill) != set(prefill0):
        raise AssertionError('frontdoor: traffic captured a module warmup '
                             'did not')
    dreplays = {sig: g.replays - decode0[sig] for sig, g in decode.items()}
    preplays = {sig: g.replays - prefill0[sig] for sig, g in prefill.items()}
    steps = eng.decode_steps - d0
    prefills = eng.prefill_dispatches - p0
    if steps != K * sum(dreplays.values()) or \
            prefills != sum(preplays.values()) or not prefills:
        raise AssertionError(f'frontdoor: {steps} decode steps / {prefills} '
                             f'prefills, graph replays {dreplays} '
                             f'{preplays}')
    for (P, B), g in prefill.items():
        n = g.launches.counts()['fused_layer_norm']
        want = serve['prefill_graphs'][f'{P}x{B}']['layer_norm_a_replay']
        if n != want or n != LN_PER_FORWARD:
            raise AssertionError(f'frontdoor: prefill graph {P}x{B} '
                                 f'launches {n} LayerNorms a replay, the '
                                 f'serve path\'s {want}')
    for sig, g in decode.items():
        n = g.launches.counts()['fused_layer_norm']
        if n != LN_PER_FORWARD * K:
            raise AssertionError(f'frontdoor: decode graph {sig} launches '
                                 f'{n} LayerNorms a replay, not '
                                 f'{LN_PER_FORWARD} x {K}')
    want = LN_PER_FORWARD * (steps + prefills)
    for key in ('fused_layer_norm', 'fused_layer_norm:warp'):
        if launches[key] != want:
            raise AssertionError(f'frontdoor: {key} launched '
                                 f'{launches[key]} times, the replays\' '
                                 f'{want}')
    return steps, prefills, dreplays, preplays


def frontdoor_phase(f32_streams, serve):
    """The serve phase's deployment behind ``ServingFrontend`` with the
    live plane armed (metrics server, memory sampler, a profile window,
    a watchdog budget): the same Poisson requests over HTTP as SSE
    streams on their arrival times, scraped throughout; then the typed
    rejections, a disconnect, a burst at a door of queue 1, a starved
    request and the teardown.  Returns (launches, summary)."""
    import os
    import tempfile
    import threading
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.resilience.watchdog import Budget
    from paddle_tpu_torch.serving import (Request, ServeConfig,
                                          ServingEngine, poisson_requests)
    from paddle_tpu_torch.serving.frontend import ServingFrontend
    from paddle_tpu_torch.telemetry import memory

    K = SERVE_CONFIG_KW['decode_span']
    lo = FRONTDOOR_PROFILE_SPANS[0] * K
    n_steps = len(FRONTDOOR_PROFILE_SPANS) * K
    trace_dir = tempfile.mkdtemp(prefix='frontdoor_profile_')
    saved_env = os.environ.get(memory.MEMSTATS_ENV)
    os.environ[memory.MEMSTATS_ENV] = 'interval=0.05'
    telemetry.reset()
    memory.reset_modules()
    events = []
    telemetry.get_recorder().subscribe(events.append)
    model = gpt_small(device='cuda', seed=0, **SERVE_MODEL_KW)
    cfg = ServeConfig(**SERVE_CONFIG_KW, watchdog=dict(FRONTDOOR_WATCHDOG),
                      profile=f'start={lo},steps={n_steps},limit=1,'
                              f'dir={trace_dir}')
    eng = ServingEngine(model, cfg, serve_metrics_port=0)
    doors, ports = [], [eng.metrics_server.port]
    try:
        _warm_engine(eng, 'frontdoor')
        captured = [e for e in events if e['kind'] == 'memory_compiled']
        if sorted(e['name'] for e in captured) != sorted(
                [f'serve.decode[{S}x{k}]' for S, k in _decode_graphs(eng)]
                + [f'serve.prefill[{P}x{B}]'
                   for P, B in _prefill_graphs(eng)]):
            raise AssertionError(f'frontdoor: memory_compiled events '
                                 f'{[e["name"] for e in captured]}')
        pool = max(e['reserved_bytes_after'] for e in captured)
        log(f'frontdoor: {len(captured)} memory_compiled events, one per '
            f'captured module; the shared graph pool and the weights '
            f'reserve {pool / 2**30:.2f} GiB after the last capture; '
            'largest growth ' + ', '.join(
                f'{e["name"]} {e["compiled_peak_bytes"] / 2**20:.0f} MiB'
                for e in sorted(captured, key=lambda e:
                                -e['compiled_peak_bytes'])[:3]))
        fe = ServingFrontend(eng, port=0).start()
        doors.append(fe)
        ports.append(fe.port)
        reqs = poisson_requests(NUM_REQUESTS,
                                vocab_size=model.config.vocab_size,
                                **SERVE_LOAD_KW)
        mport = eng.metrics_server.port
        job = json.dumps({
            'port': fe.port, 'scrape_s': FRONTDOOR_SCRAPE_S,
            'scrape': [(mport, '/metrics'), (mport, '/status.json'),
                       (fe.port, '/status.json')],
            'requests': [{'rid': r.rid, 'prompt': r.prompt.tolist(),
                          'max_new_tokens': r.max_new_tokens,
                          'arrival_s': r.arrival_t} for r in reqs]})

        def drive(what):
            """The requests through the door once, scraped throughout,
            every gate of the pass checked; returns its streams,
            scrapes, host CPU seconds, launches, replay counts and
            events."""
            decode0 = {s: g.replays for s, g in _decode_graphs(eng).items()}
            prefill0 = {s: g.replays
                        for s, g in _prefill_graphs(eng).items()}
            p0, d0 = eng.prefill_dispatches, eng.decode_steps
            n_ev0 = len(events)
            client = subprocess.Popen(
                [sys.executable, '-c', 'import chip_smoke; '
                 'chip_smoke.door_client()'], cwd=os.path.dirname(
                    os.path.abspath(__file__)), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True)
            # the main path: counts at 0 just before, read just after
            # (the client's interpreter starts while the door idles)
            _build.reset_launches()
            torch.cuda.synchronize()
            cpu0 = time.process_time()
            try:
                stdout, _ = client.communicate(job, timeout=600)
            finally:
                if client.poll() is None:
                    client.kill()
                    client.wait()
            host_cpu_s = time.process_time() - cpu0
            if client.returncode != 0:
                raise AssertionError(f'frontdoor {what}: the client exited '
                                     f'{client.returncode}')
            doc = json.loads(stdout.strip().splitlines()[-1])
            outs, scrapes = doc['outs'], doc['scrapes']
            deadline = time.monotonic() + 30
            while (eng.scheduler.running or eng.scheduler.queue) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            launches = launch_counts()
            gates = _door_gates(eng, decode0, prefill0, p0, d0, launches,
                                serve)
            # every stream equals the unarmed in-process serve run's
            for rid, out in outs.items():
                if out.get('status') != 200 or \
                        (out.get('done') or {}).get('state') != \
                        Request.DONE:
                    raise AssertionError(
                        f'frontdoor {what} {rid}: {out.get("status")} '
                        f'{out.get("done") or out.get("body")}')
                if out['tokens'] != f32_streams[rid]:
                    first = next((i for i, (x, y) in enumerate(
                        zip(out['tokens'], f32_streams[rid])) if x != y),
                        min(len(out['tokens']), len(f32_streams[rid])))
                    raise AssertionError(f'frontdoor {what} {rid}: stream '
                                         f'differs from the serve phase\'s '
                                         f'at token {first}')
            bad = [(q, st) for q, st, ok in scrapes if st != 200 or not ok]
            if bad or len(scrapes) < 3:
                raise AssertionError(f'frontdoor {what}: scrapes '
                                     f'{len(scrapes)}, failed {bad[:5]}')
            # one serve_request per rid, the reference's fields
            run_ev = events[n_ev0:]
            sreq = [e for e in run_ev if e['kind'] == 'serve_request']
            fields = {'rid', 'state', 'reason', 'prompt_len', 'tokens',
                      'ttft_s', 'tpot_s', 'preemptions', 'age_s'}
            if sorted(e['rid'] for e in sreq) != sorted(outs) or any(
                    not fields <= set(e) or e['state'] != Request.DONE
                    for e in sreq):
                raise AssertionError(
                    f'frontdoor {what}: serve_request events '
                    f'{[(e["rid"], e["state"]) for e in sreq]}')
            if sum(e['decoded'] + e['prefilled'] for e in run_ev
                   if e['kind'] == 'serve_step') != \
                    sum(len(o['tokens']) for o in outs.values()):
                raise AssertionError(f'frontdoor {what}: serve_step token '
                                     'accounting differs from the streams')
            return outs, scrapes, host_cpu_s, launches, gates, sreq

        outs, scrapes, host_cpu_s, launches, gates, sreq = drive('armed')
        steps, prefills, dreplays, preplays = gates
        # the profile window: exactly the asked steps, its trace on disk
        wins = eng._prof.windows
        if len(wins) != 1 or (wins[0]['step_lo'], wins[0]['step_hi'],
                              wins[0]['steps']) != \
                (lo, lo + n_steps - 1, n_steps) or 'error' in wins[0] or \
                not os.path.exists(wins[0].get('trace', '')) or \
                not wins[0]['device_total_us'] > 0:
            raise AssertionError(f'frontdoor: profile windows {wins}')
        idle, busy_s, traced_s = _trace_idle_share(wins[0]['trace'])
        # memory samples from torch.cuda.memory_stats, within the card
        limit = torch.cuda.get_device_properties(0).total_memory
        samples = [e for e in events if e['kind'] == 'memory_sample']
        if not samples or any(
                e['source'] != 'device_stats' or
                e.get('device_limit_bytes') != limit or
                not 0 < e['device_bytes'] <= e['device_peak_bytes'] <= limit
                for e in samples):
            raise AssertionError(f'frontdoor: memory samples {samples[:3]}')
        # the same requests again with the window spent: the door, the
        # live plane and the sampler, no profile
        pl_outs, _pl_scrapes, pl_cpu_s, pl_launches, pl_gates, pl_sreq = \
            drive('window-less')
        if len(eng._prof.windows) != 1:
            raise AssertionError(f'frontdoor: a second profile window '
                                 f'{eng._prof.windows[1:]}')

        # 413: a request beyond max_model_len, typed, with Retry-After
        st, hdrs, body = _http('127.0.0.1', fe.port, 'POST', '/v1/generate',
                               {'prompt': list(range(64)),
                                'max_new_tokens': 200, 'rid': 'big-0'})
        if st != 413 or body.get('error') != 'exceeds_pool' or \
                'Retry-After' not in hdrs:
            raise AssertionError(f'frontdoor: 413 case {st} {hdrs} {body}')
        # a client that goes away mid-stream is evicted, its blocks back
        import http.client
        c = http.client.HTTPConnection('127.0.0.1', fe.port, timeout=60)
        c.request('POST', '/v1/generate', body=json.dumps(
            {'prompt': list(range(1, 33)), 'max_new_tokens': 128,
             'rid': 'cd-0'}), headers={'Content-Type': 'application/json'})
        r = c.getresponse()
        seen = 0
        while seen < 2:
            if r.readline().strip().startswith(b'data: '):
                seen += 1
        r.fp.close()
        c.sock.close()
        req = fe.get_request('cd-0')
        deadline = time.monotonic() + 60
        while not req.done and time.monotonic() < deadline:
            time.sleep(0.01)
        while eng.scheduler.running and time.monotonic() < deadline:
            time.sleep(0.01)
        if req.state != Request.EVICTED or \
                req.reason != 'client_disconnect' or \
                eng.cache.free_blocks != eng.cache.num_blocks - 1:
            raise AssertionError(f'frontdoor: disconnect {req.state} '
                                 f'{req.reason} after {len(req.tokens)} '
                                 f'tokens, free blocks '
                                 f'{eng.cache.free_blocks}')
        disconnected_after = len(req.tokens)
        fe.stop()

        # a door of queue 1 under a burst sheds 429, typed
        burst = ServingFrontend(eng, port=0, max_queue=1).start()
        doors.append(burst)
        ports.append(burst.port)
        bouts = [{} for _ in range(FRONTDOOR_BURST)]
        bthreads = [threading.Thread(target=_sse, args=(
            burst.port, {'prompt': reqs[i].prompt.tolist(),
                         'max_new_tokens': 8, 'rid': f'burst-{i}'},
            bouts[i]), daemon=True) for i in range(FRONTDOOR_BURST)]
        for t in bthreads:
            t.start()
        for t in bthreads:
            t.join(120)
        codes = sorted(o.get('status') for o in bouts)
        shed = [o for o in bouts if o.get('status') == 429]
        if not shed or set(codes) != {200, 429} or any(
                o['body'].get('error') != 'queue_full' or
                'Retry-After' not in o['headers'] for o in shed):
            raise AssertionError(f'frontdoor: burst statuses {codes}')
        burst.stop()

        # a starved request under a tight budget: evicted, 'timeout'
        saved_budget = eng.budget
        eng.budget = Budget(step_s=1e-3, first_step_s=1e-3)
        try:
            starved = eng.submit(reqs[0].prompt, 16, rid='starved-0')
            time.sleep(0.05)
            eng.step()
        finally:
            eng.budget = saved_budget
        tos = [e for e in events if e['kind'] == 'timeout'
               and e['rid'] == 'starved-0']
        if starved.reason != 'deadline' or len(tos) != 1 or \
                tos[0]['budget_s'] != starved.deadline_s:
            raise AssertionError(f'frontdoor: starved request '
                                 f'{starved.state} {starved.reason}, '
                                 f'timeout events {tos}')
    finally:
        for d in doors:
            d.stop()
        eng.close()
        eng.close()
        memory.stop_sampler()
        telemetry.get_recorder().unsubscribe(events.append)
        if saved_env is None:
            os.environ.pop(memory.MEMSTATS_ENV, None)
        else:
            os.environ[memory.MEMSTATS_ENV] = saved_env
    deadline = time.monotonic() + 10
    while _live_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    if _live_threads() or not all(_refused(p) for p in ports):
        raise AssertionError(f'frontdoor: after close, threads '
                             f'{_live_threads()}, ports open '
                             f'{[p for p in ports if not _refused(p)]}')

    def pct(vals, q):
        return vals[max(0, min(len(vals) - 1,
                               math.ceil(q * len(vals)) - 1))]

    def door_numbers(outs, sreq, host_cpu_s):
        """One pass's end-to-end numbers: TTFT and TPOT on the engine's
        clock (the reference's serve_request fields) and TTFT as the
        client felt it."""
        tokens = sum(len(o['tokens']) for o in outs.values())
        wall = max(o['t_done'] for o in outs.values()) - \
            min(o['t_send'] for o in outs.values())
        ttft_c = sorted(o['t_first'] - o['t_send'] for o in outs.values())
        ttft_e = sorted(e['ttft_s'] for e in sreq)
        tpot_e = [e['tpot_s'] for e in sreq if e['tpot_s'] is not None]
        return {'tokens': tokens, 'wall_s': wall,
                'tokens_per_s': tokens / wall,
                'ttft_p50_s': pct(ttft_e, 0.5),
                'ttft_p99_s': pct(ttft_e, 0.99),
                'client_ttft_p50_s': pct(ttft_c, 0.5),
                'client_ttft_p99_s': pct(ttft_c, 0.99),
                'tpot_mean_s': sum(tpot_e) / len(tpot_e),
                'host_cpu_s': host_cpu_s,
                'host_ms_a_request': (host_cpu_s - serve['host_cpu_s'])
                / NUM_REQUESTS * 1e3}

    def door_log(what, n):
        return (f'{n["tokens"]} tokens in {n["wall_s"]:.3f} s = '
                f'{n["tokens_per_s"]:.1f} tokens/s through the door '
                f'{what} ({n["tokens_per_s"] / serve["tokens_per_s"]:.3f} '
                f'of in-process serve); TTFT p50 '
                f'{n["ttft_p50_s"] * 1e3:.1f} ms, p99 '
                f'{n["ttft_p99_s"] * 1e3:.1f} ms on the engine\'s clock '
                f'(client {n["client_ttft_p50_s"] * 1e3:.1f} / '
                f'{n["client_ttft_p99_s"] * 1e3:.1f} ms); TPOT mean '
                f'{n["tpot_mean_s"] * 1e3:.2f} ms; host CPU '
                f'{n["host_cpu_s"]:.3f} s = {n["host_ms_a_request"]:.2f} ms '
                f'a request more than serve\'s')

    summary = door_numbers(outs, sreq, host_cpu_s)
    summary['window_less'] = door_numbers(pl_outs, pl_sreq, pl_cpu_s)
    summary.update({
        'serve_tokens_per_s': serve['tokens_per_s'],
        'serve_ttft_p50_s': serve['ttft_p50_s'],
        'serve_ttft_p99_s': serve['ttft_p99_s'],
        'serve_tpot_mean_s': serve['tpot_mean_s'],
        'serve_host_cpu_s': serve['host_cpu_s'],
        'idle_share_window': idle, 'window_device_s': busy_s,
        'window_wall_s': wins[0]['wall_s'], 'window_traced_s': traced_s,
        'window_steps': [wins[0]['step_lo'], wins[0]['step_hi']],
        'scrapes': len(scrapes), 'memory_samples': len(samples),
        'memory_peak_bytes': max(e['device_peak_bytes'] for e in samples),
        'decode_steps': steps, 'prefill_dispatches': prefills,
        'replays': {f'{S}x{k}': n for (S, k), n in dreplays.items()},
        'burst_statuses': codes, 'disconnected_after': disconnected_after})
    pl_steps, pl_prefills = pl_gates[:2]
    log(f'frontdoor: {NUM_REQUESTS} SSE streams over HTTP equal the serve '
        f'phase\'s token for token, in both passes; {len(scrapes)} scrapes '
        f'of /metrics, /status.json and the door\'s /status.json during '
        f'the armed run; fused_layer_norm launches '
        f'{launches["fused_layer_norm"]} = {LN_PER_FORWARD} x ({steps} '
        f'decode steps + {prefills} prefills) armed, '
        f'{pl_launches["fused_layer_norm"]} = {LN_PER_FORWARD} x '
        f'({pl_steps} + {pl_prefills}) window-less, all graph replays on '
        'the warp design; one serve_request per rid')
    log(f'frontdoor: in-process serve {serve["tokens_per_s"]:.1f} tokens/s,'
        f' TTFT p50 {serve["ttft_p50_s"] * 1e3:.1f} ms, p99 '
        f'{serve["ttft_p99_s"] * 1e3:.1f} ms, TPOT mean '
        f'{serve["tpot_mean_s"] * 1e3:.2f} ms, host CPU '
        f'{serve["host_cpu_s"]:.3f} s')
    log('frontdoor: ' + door_log('armed (live plane, sampler, profile '
                                 'window)', summary))
    log('frontdoor: ' + door_log('window-less (live plane, sampler)',
                                 summary['window_less']))
    log(f'frontdoor: device idle share {idle:.3f} over the profile window '
        f'(steps {lo}..{lo + n_steps - 1}: {traced_s:.3f} s traced, '
        f'{wins[0]["wall_s"]:.3f} s with the profiler\'s stop); '
        f'{len(samples)} memory samples, peak '
        f'{summary["memory_peak_bytes"] / 2**30:.2f} GiB of '
        f'{limit / 2**30:.1f}; the clients run in a process of their own')
    log(f'frontdoor: 413 exceeds_pool with Retry-After; a client gone after '
        f'2 tokens evicted ({disconnected_after} decoded), every block '
        f'back; a door of queue 1 under {FRONTDOOR_BURST} at once: '
        f'{codes}; a starved request evicted with one timeout event; '
        'close() left no thread and no open port')
    del eng, model
    _free()
    return launches, summary


def _worker_json(rep, path):
    """GET ``path`` from a fleet worker's metrics plane."""
    st, _h, body = _http('127.0.0.1', rep.metrics_port, 'GET', path,
                         timeout=10)
    if st != 200:
        raise AssertionError(f'{rep.name} {path}: {st}')
    return body


def _replica_gate(name, a, b):
    """A fleet worker's LayerNorm launches between two snapshots of its
    ``/kernels/status.json`` (each read under the lock its replays are
    counted under): exactly the captured launches times the replays (25
    a prefill, 25 x K a decode span), so none eager, no graph captured
    between them, every launch on the warp design.  Returns the
    launches by key and (prefill replays, decode replays)."""
    K = FLEET_DOC['decode_span']
    if set(a['graphs']) != set(b['graphs']) or not b['graphs']:
        raise AssertionError(f'fleet {name}: graphs {sorted(a["graphs"])} '
                             f'-> {sorted(b["graphs"])}')
    replays = {g: b['graphs'][g]['replays'] - a['graphs'][g]['replays']
               for g in b['graphs']}
    for g, doc in b['graphs'].items():
        n = doc['launches_a_replay'].get('fused_layer_norm', 0)
        want = LN_PER_FORWARD * (K if g.startswith('decode') else 1)
        if n != want:
            raise AssertionError(f'fleet {name}: {g} launches {n} '
                                 f'LayerNorms a replay, not {want}')
    prefill = sum(n for g, n in replays.items() if g.startswith('prefill'))
    decode = sum(n for g, n in replays.items() if g.startswith('decode'))
    delta = {k: n - a['launches'].get(k, 0)
             for k, n in b['launches'].items()}
    want = LN_PER_FORWARD * (prefill + K * decode)
    for key in ('fused_layer_norm', 'fused_layer_norm:warp'):
        if delta.get(key) != want:
            raise AssertionError(f'fleet {name}: {key} launched '
                                 f'{delta.get(key)} times, the replays\' '
                                 f'{want} ({replays})')
    return delta, (prefill, decode)


def fleet_phase():
    """The reference drill's fleet on the card: 2 replicas + 1 warm spare
    of ``gpt_small`` (subprocess workers, ``--device cuda``) behind
    ``FleetFrontend``; overload, clean twin (through the door), seeded
    ``replica_kill`` and forced ``slo_breach`` drain.  Returns
    (launches, summary)."""
    import random
    import signal
    import tempfile
    import threading
    from paddle_tpu_torch.resilience.chaos import (Fault, FaultPlan,
                                                   ServingFaultInjector)
    from paddle_tpu_torch.serving import RejectReason, Request
    from paddle_tpu_torch.serving.router import FleetFrontend
    from paddle_tpu_torch.tools import serve_fleet

    workdir = tempfile.mkdtemp(prefix='fleet_')
    config_path = f'{workdir}/serve.json'
    with open(config_path, 'w') as f:
        json.dump(FLEET_DOC, f)
    rng = random.Random(20)
    shapes = {}

    def shape(rid):
        if rid not in shapes:
            shapes[rid] = ([rng.randrange(1, 120)
                            for _ in range(rng.randrange(4, 9))],
                           rng.randrange(6, 10))
        return shapes[rid]

    single = serve_fleet.build_engine(FLEET_DOC, device='cuda')

    def single_tokens(rid):
        prompt, n = shape(rid)
        req = Request(rid, prompt, max_new_tokens=n)
        single.submit(req)
        single.run()
        return [int(t) for t in req.tokens]

    def run_many(router, rids, pace_s=0.0, on_token=None, at_once=False):
        results, threads, go = {}, [], threading.Event()

        def one(rid):
            if at_once:
                go.wait()
            prompt, n = shape(rid)
            try:
                results[rid] = router.generate(
                    prompt, n, rid, on_token=None if on_token is None else
                    (lambda i, t: on_token(rid, i, t)))
            except Exception as e:      # a crash is the finding
                results[rid] = {'state': 'crashed', 'reason': repr(e)}
        for rid in rids:
            threads.append(threading.Thread(target=one, args=(rid,),
                                            daemon=True))
            threads[-1].start()
            if pace_s:
                time.sleep(pace_s)
        go.set()
        for t in threads:
            t.join(180)
        return results

    def sheds(router):
        return sum(sum(rep.status()['shed_counts'].values())
                   for rep in router.replicas + router.spares if rep.alive())

    counts, peaks = {}, {}

    def read_workers(router):
        """Each live worker's launches and allocator peak."""
        for rep in router.replicas + router.spares:
            if rep.alive():
                counts.setdefault(rep.name, []).append(
                    _worker_json(rep, '/kernels/status.json'))
                live = _worker_json(rep, '/memory.json')['live']
                peaks[rep.name] = max(peaks.get(rep.name, 0),
                                      live.get('device_peak_bytes', 0))

    t0 = time.perf_counter()
    router = serve_fleet.launch_fleet(
        config_path, replicas=FLEET_REPLICAS, spares=FLEET_SPARES,
        workdir=workdir, device='cuda', metrics=True,
        extra_env={'PADDLE_TPU_MEMSTATS': 'interval=0.2'})
    spawn_s = time.perf_counter() - t0
    door = FleetFrontend(router).start()
    summary = {'spawn_to_ready_s': spawn_s}
    try:
        read_workers(router)
        # drill 1: an overload burst, released at once
        res = run_many(router, [f'ov-{i}' for i in range(FLEET_OVERLOAD)],
                       at_once=True)
        states = {}
        for r in res.values():
            states[r['state']] = states.get(r['state'], 0) + 1
        summary['overload'] = {
            'total': FLEET_OVERLOAD, 'states': states, 'sheds': sheds(router),
            'typed': all(r.get('reason') in RejectReason.ALL
                         for r in res.values() if r['state'] == 'rejected'),
            'invariants': router.check_invariants(),
            'replicas_alive': sum(r.alive() for r in router.replicas)}

        # drill 2: the clean twin through the door, against one engine
        shed0 = sheds(router)
        clean = [f'cl-{i}' for i in range(4)]
        outs = {rid: {} for rid in clean}
        cthreads = []
        for rid in clean:
            prompt, n = shape(rid)
            cthreads.append(threading.Thread(target=_sse, args=(
                door.port, {'prompt': prompt, 'max_new_tokens': n,
                            'rid': rid}, outs[rid]), daemon=True))
            cthreads[-1].start()
            time.sleep(0.4)
        for t in cthreads:
            t.join(120)
        summary['clean'] = {
            'finished': sum((o.get('done') or {}).get('state') == 'finished'
                            for o in outs.values()),
            'total': len(clean), 'sheds': sheds(router) - shed0,
            'bitexact': all(outs[rid].get('tokens') == single_tokens(rid)
                            for rid in clean),
            'invariants': router.check_invariants()}
        read_workers(router)

        # drill 3: a seeded replica_kill mid-stream.  The replicas'
        # counters are polled throughout, so the victim's last read lies
        # just before the kill without a read delaying it (the stream
        # may end within a decode span)
        plan = FaultPlan(seed=0, faults=[
            Fault('replica_kill', after_tokens=3, count=1)])
        inj = ServingFaultInjector(plan)
        lock = threading.Lock()
        last, polling = {}, threading.Event()

        def poll():
            while not polling.wait(FLEET_POLL_S):
                for rep in list(router.replicas):
                    try:
                        doc = _worker_json(rep, '/kernels/status.json')
                    except (OSError, AssertionError):
                        continue            # the victim, gone
                    with lock:
                        last[rep.name] = (time.perf_counter(), doc)

        def tap(rid, i, tok):
            with lock:
                fired = inj.fleet_faults(rid, i + 1)
                if fired:
                    victim = router.replica(
                        router.ledger[rid]['replicas'][-1])
                    read_t, doc = last[victim.name]
                    counts[victim.name].append(doc)
                    victim.kill(signal.SIGKILL)
                    summary['victim_read_before_kill_s'] = \
                        time.perf_counter() - read_t

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        deadline = time.monotonic() + 30
        while len(last) < len(router.replicas) and \
                time.monotonic() < deadline:
            time.sleep(FLEET_POLL_S)
        kill = [f'ki-{i}' for i in range(3)]
        try:
            res = run_many(router, kill, pace_s=0.05, on_token=tap)
        finally:
            polling.set()
            poller.join(30)
        summary['kill'] = {
            'injected': list(inj.injected),
            'finished': sum(r['state'] == 'finished' for r in res.values()),
            'total': len(kill),
            'retried': sum(r.get('retried', 0) for r in res.values()),
            'bitexact': all(res[rid].get('tokens') == single_tokens(rid)
                            for rid in kill),
            'promoted': sum(e['action'] == 'promote' for e in router.events),
            'invariants': router.check_invariants()}

        # drill 4: a forced slo_breach latch drains the stream's owner
        out = {}
        t = threading.Thread(target=lambda: out.update(
            e=router.generate(*shape('dr-0'), 'dr-0')), daemon=True)
        t.start()
        while 'dr-0' not in router.ledger or \
                not router.ledger['dr-0']['replicas']:
            time.sleep(0.005)
        owner = router.replica(router.ledger['dr-0']['replicas'][-1])
        owner.post_json('/admin/alert/slo_breach')
        router.health_tick()
        t.join(120)
        entry = out.get('e') or router.ledger['dr-0']
        summary['drain'] = {
            'owner': owner.name, 'drained': owner.draining,
            'state': entry['state'],
            'bitexact': entry['tokens'] == single_tokens('dr-0'),
            'still_serving': bool(router.dispatchable()),
            'drain_events': sum(e['action'] == 'drain'
                                for e in router.events),
            'invariants': router.check_invariants()}
        summary['fleet_actions'] = sorted({e['action']
                                           for e in router.events})
        read_workers(router)
    finally:
        door.stop()
        router.stop()
        del single
        _free()

    failures = []
    over, cl = summary['overload'], summary['clean']
    ki, dr = summary['kill'], summary['drain']
    if not over['sheds'] or not over['typed'] or \
            set(over['states']) - {'finished', 'rejected'} or \
            over['replicas_alive'] < FLEET_REPLICAS:
        failures.append(f'overload: {over}')
    if cl['sheds'] or cl['finished'] != cl['total'] or not cl['bitexact']:
        failures.append(f'clean twin: {cl}')
    if len(ki['injected']) != 1 or ki['finished'] != ki['total'] or \
            ki['retried'] < 1 or not ki['bitexact'] or ki['promoted'] < 1:
        failures.append(f'replica_kill: {ki}')
    if not dr['drained'] or dr['state'] != 'finished' or \
            not dr['bitexact'] or not dr['still_serving'] or \
            not dr['drain_events']:
        failures.append(f'drain: {dr}')
    for name in ('overload', 'clean', 'kill', 'drain'):
        if summary[name]['invariants']:
            failures.append(f'{name}: invariants '
                            f'{summary[name]["invariants"]}')
    if 'crashed' in json.dumps(summary):
        failures.append('a request crashed')
    # each replica's LayerNorm launches over the drills, from its
    # counters read before the first drill and after its last (the
    # killed one's just before the kill): exactly its replays'
    launches = {key: 0 for key in launch_counts()}
    per_replica, replays = {}, {}
    for name, seq in sorted(counts.items()):
        try:
            delta, replays[name] = _replica_gate(name, seq[0], seq[-1])
        except AssertionError as e:
            failures.append(str(e))
            continue
        per_replica[name] = delta['fused_layer_norm']
        for k, n in delta.items():
            launches[k] = launches.get(k, 0) + n
    if not launches['fused_layer_norm']:
        failures.append(f'LayerNorm launches by replica {per_replica}')
    if failures:
        raise AssertionError('fleet: ' + '; '.join(failures))
    summary['peak_bytes'] = peaks
    summary['layer_norm_by_replica'] = per_replica
    summary['replays_by_replica'] = replays
    for name in ('overload', 'clean', 'kill', 'drain'):
        log(f'fleet {name}: {json.dumps(summary[name])}')
    log(f'fleet: {FLEET_REPLICAS} replicas + {FLEET_SPARES} warm spare of '
        f'gpt_small (subprocess workers on the card, warmed up) ready in '
        f'{spawn_s:.1f} s; allocator peak by replica '
        + ', '.join(f'{k} {v / 2**30:.2f} GiB' for k, v in
                    sorted(peaks.items()))
        + f'; fused_layer_norm launches by replica over the drills '
        f'{per_replica} (the killed replica\'s up to its last read, '
        f'{summary["victim_read_before_kill_s"] * 1e3:.1f} ms before the '
        f'kill) = '
        f'{LN_PER_FORWARD} x (prefill replays + {FLEET_DOC["decode_span"]}'
        f' x decode replays) {replays}, all on the warp design; actions '
        f'{summary["fleet_actions"]}')
    return launches, summary


def _record_linear_io(layers, fn):
    """Runs ``fn()`` with a forward hook on each layer; returns each
    layer's (input, output) of that call, by name."""
    seen, hooks = {}, []
    for name, layer in layers:
        def hook(mod, args, out, name=name):
            seen[name] = (args[0].detach().clone(), out.detach().clone())
        hooks.append(layer.register_forward_hook(hook))
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _quant_layers_vs_cpu(eng, layers, mode, reqs):
    """Each swapped Linear on one prefill batch and one decode batch of
    the engine (eager bodies, every row on the trash block): the card's
    int32 accumulator equals the CPU's on the same input, exactly, and
    the layer's output lies within 1 f32 ulp of the CPU's."""
    from paddle_tpu_torch.ops import int8_matmul as q8
    from paddle_tpu_torch.serving import blocks_for
    c = eng.config
    rows = sorted(reqs, key=lambda r: r.rid)[:8]
    P = max(c.prompt_buckets)
    ids = np.zeros((len(rows), P), np.int64)
    t0s = np.array([r.prompt.size for r in rows], np.int64)
    for i, r in enumerate(rows):
        ids[i, :r.prompt.size] = r.prompt
    nblk = blocks_for(P, c.block_size)
    seeds = np.array([r.seed for r in rows], np.int64)
    plan = eng._prefill_plan(ids, t0s, np.zeros((len(rows), nblk), np.int32),
                             seeds).cuda()
    W = eng.scheduler.table_width
    span = np.zeros((len(rows), W + 5), np.int64)
    span[:, W] = t0s
    span[:, W + 1] = ids[np.arange(len(rows)), t0s - 1]
    span[:, W + 2] = 1
    span[:, W + 3] = t0s + 8
    span[:, W + 4] = seeds
    batches = {
        'prefill': _record_linear_io(
            layers, lambda: eng._prefill_body(plan, P)),
        'decode': _record_linear_io(
            layers, lambda: eng._span_body(torch.from_numpy(span).cuda(), 1))}
    worst = {}
    for what, io in batches.items():
        if set(io) != {n for n, _ in layers}:
            raise AssertionError(f'{mode}: the {what} batch reached '
                                 f'{len(io)} of {len(layers)} layers')
        ulps = 0.0
        for name, layer in layers:
            x, out = io[name]
            w = layer.qweight
            if mode == 'int4':
                w = q8.unpack_int4(w, layer.in_features)
            acc = q8.int_dot(q8.quantize_activation(x)[0], w).cpu()
            xc = x.cpu()
            want_acc = q8.int_dot(q8.quantize_activation(xc)[0], w.cpu())
            if not torch.equal(acc, want_acc):
                raise AssertionError(
                    f'{mode} {what} {name}: the card\'s int32 '
                    'accumulator differs from the CPU\'s')
            want = q8.dynamic_int8_matmul(
                xc, w.cpu(), layer.wscale.cpu(), layer.bias.detach().cpu(),
                out_dtype=torch.float32)
            spacing = torch.nextafter(want.abs(), torch.tensor(
                float('inf'))) - want.abs()
            ulps = max(ulps, float(((out.cpu() - want).abs()
                                    / spacing).max()))
        if ulps > 1.0:
            raise AssertionError(f'{mode} {what}: an output lies {ulps} '
                                 'f32 ulps from the CPU\'s')
        worst[what] = ulps
        log(f'{mode} {what} batch ({tuple(x.shape)} at the last layer): '
            f'{len(layers)} swapped Linears, int32 accumulators equal to the '
            f'CPU\'s, outputs within {ulps:.2f} f32 ulps of it')
    return worst


def serve_quant_phase(mode, f32_streams):
    """The bench's serve config with ``ServeConfig(quantize=mode)`` at
    gpt_small's full width, the same 32 requests: the gates of the f32
    run, the accumulators against the CPU, the weight bytes, tokens/s,
    TPOT, peak memory, the share of greedy tokens equal to the f32
    engine's (reported, no gate: PTQ changes tokens), and one quantized
    ``generate`` through its graph."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.nn.layer.common import Linear
    from paddle_tpu_torch.serving import (ServeConfig, ServingEngine,
                                          poisson_requests)
    from paddle_tpu_torch import quantization
    what = f'serve_{mode}'
    model = gpt_small(device='cuda', seed=0, **SERVE_MODEL_KW)
    f32_bytes = sum(m.weight.numel() * m.weight.element_size()
                    for m in model.modules() if isinstance(m, Linear))
    eng = ServingEngine(model, ServeConfig(**SERVE_CONFIG_KW, quantize=mode))
    kind = {'int8': quantization.Int8DynamicLinear,
            'int4': quantization.Int4DynamicLinear}[mode]
    layers = [(n, m) for n, m in model.named_modules() if type(m) is kind]
    if len(layers) != 4 * model.config.num_layers or any(
            isinstance(m, Linear) for m in model.modules()):
        raise AssertionError(f'{what}: {len(layers)} swapped Linears')
    q_bytes = sum(m.qweight.numel() * m.qweight.element_size()
                  + m.wscale.numel() * m.wscale.element_size()
                  for _, m in layers)
    log(f'{what}: {len(layers)} Linears swapped for {kind.__name__}; weight '
        f'bytes {q_bytes / 1e6:.1f} MB ({mode} + f32 scales) against '
        f'{f32_bytes / 1e6:.1f} MB in f32 ({q_bytes / f32_bytes:.4f}); the '
        f'tied head and embeddings stay f32')
    warm_s, _, _ = _warm_engine(eng, what)
    reqs = poisson_requests(NUM_REQUESTS, vocab_size=model.config.vocab_size,
                            **SERVE_LOAD_KW)
    launches, rep, summary = _serve_main_path(eng, reqs, what)
    same = total = 0
    for r in reqs:
        ref = f32_streams[r.rid]
        total += len(ref)
        same += sum(a == b for a, b in zip(r.tokens, ref))
    agree = same / total
    log(f'{what}: {same} of {total} greedy tokens equal to the f32 '
        f'engine\'s, position by position ({agree:.4f}; reported, no gate)')
    ulps = _quant_layers_vs_cpu(eng, layers, mode, reqs)
    # one quantized generate through its graph, then a replay
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (GEN_BATCH, 32)).astype(np.int64)
    t0 = time.perf_counter()
    first = model.generate(ids, 32, temperature=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mod, = _captured(model._gen_cache, f'{what} generate').values()
    t0 = time.perf_counter()
    again = model.generate(ids, 32, temperature=0)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    per_forward = 2 * model.config.num_layers + 1
    if not torch.equal(first, again) or mod.replays != 1 or \
            mod.launches.counts()['fused_layer_norm'] != per_forward * 32 \
            or int(again.max()) >= model.config.vocab_size:
        raise AssertionError(f'{what}: generate through its graph gave '
                             f'{tuple(again.shape)}, {mod.replays} replays, '
                             f'{mod.launches.counts()}')
    log(f'{what}: generate B {GEN_BATCH}, 32 + 32 greedy through one graph '
        f'(captured in {mod.capture_s:.2f} s, first call {first_s:.2f} s), '
        f'a replay {replay_s * 1e3:.1f} ms = '
        f'{GEN_BATCH * 32 / replay_s:.1f} tokens/s, the same tokens')
    summary.update({'weight_bytes': q_bytes, 'f32_weight_bytes': f32_bytes,
                    'greedy_agreement': agree, 'warmup_s': warm_s,
                    'max_ulps_vs_cpu': ulps,
                    'generate': {'capture_s': mod.capture_s,
                                 'replay_s': replay_s,
                                 'tokens_per_s': GEN_BATCH * 32 / replay_s}})
    del eng, model, mod
    _free()
    return launches, summary


def _free():
    """Drop what the last phase left (graphs hold their pools until
    collected) and give its memory back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _trainer(model, amp_o2, lr=TRAIN_LR, fused_steps=None, n_inputs=1):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelTrainer
    strategy = DistributedStrategy()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs['use_pure_fp16'] = True
    opt = AdamW(learning_rate=lr, parameters=model.parameters())
    return ParallelTrainer(model, opt, lambda out, y: model.loss(out, y),
                           strategy=strategy, fused_steps=fused_steps,
                           n_inputs=n_inputs)


def _run_steps(trainer, batch, warmup, steps):
    """The main path of a training run: every count at 0 just before,
    read just after.  Returns (losses, launches, warm-up s, timed s,
    peak bytes)."""
    from paddle_tpu_torch.ops import _build
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.step(*batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    losses += [trainer.step(*batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launch_counts()
    return ([trainer.loss_float(x) for x in losses], launches, warm_s, dt,
            torch.cuda.max_memory_allocated())


def _check_run(what, losses, launches, per_step, steps, falls=True):
    """Finite losses, the last below the first (unless not ``falls``),
    and exactly ``per_step[k] * steps`` launches of each kernel."""
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'{what}: non-finite training loss: {losses}')
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f'{what}: loss did not fall on one batch: '
                             f'{losses}')
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f'{what}: {name} launched '
                                 f'{launches[name]} times in {steps} steps, '
                                 f'expected {n} x {steps}')


def _per_step(L, ln, softmax=0, flash=0, gelu=0, gelu_design='tensor_core',
              flash_design='mma'):
    """Launches per training step of every kernel, and of each design:
    every LayerNorm launch on ``'warp'`` (the models' widths are at most
    2048), every softmax launch on ``'vec'`` (fresh, aligned scores of
    128 or 1024 columns), all ``flash`` launches on ``flash_design``, all
    ``gelu`` launches on ``gelu_design``."""
    fa = _ops_module('flash_attention')
    fgl = _ops_module('fused_gelu_linear')
    fn = _ops_module('fused_norm')
    fsm = _ops_module('fused_softmax')
    return {'fused_layer_norm': ln,
            **{f'fused_layer_norm:{v}': ln if v == 'warp' else 0
               for v in fn.VARIANTS},
            'fused_softmax': softmax * L,
            **{f'fused_softmax:{v}': softmax * L if v == 'vec' else 0
               for v in fsm.VARIANTS},
            'fused_softmax_masked': 0,
            **{f'fused_softmax_masked:{v}': 0 for v in fsm.VARIANTS},
            **{k: flash * L for k in FLASH_KERNELS},
            **{f'{k}:{v}': flash * L if v == flash_design else 0
               for k in FLASH_KERNELS for v in fa.VARIANTS},
            **{k: gelu * L for k in GELU_KERNELS},
            **{f'{k}:{v}': gelu * L if v == gelu_design else 0
               for k in GELU_KERNELS for v in fgl.VARIANTS}}


def _launch_summary(launches, per_step, steps):
    return ', '.join(f'{k} {launches[k] // steps}'
                     for k, n in per_step.items() if n) \
        + f' per step (x {steps} steps, exact)'


def gpt_step_flops(cfg, n_params, batch, seq):
    """(model flops of one GPT training step, its attention part): 6 *
    parameters * tokens (wte counted once, for the tied head's matmul)
    plus causal attention, 12 * D per unmasked pair per layer and head
    (4*D forward, 8*D backward)."""
    hd = cfg.hidden_size // cfg.num_heads
    attn = 12 * hd * attention_pairs(seq, seq, True) * batch \
        * cfg.num_heads * cfg.num_layers
    return 6 * n_params * batch * seq + attn, attn


def bert_step_flops(cfg, n_params, batch, seq):
    """(model flops of one BERT training step, its attention part): 6 *
    parameters * tokens (word_emb counted once, for the tied decoder's
    matmul) plus non-causal attention, 12 * D per (q, k) pair per layer
    and head."""
    hd = cfg.hidden_size // cfg.num_heads
    attn = 12 * hd * seq * seq * batch * cfg.num_heads * cfg.num_layers
    return 6 * n_params * batch * seq + attn, attn


def training_phase():
    """gpt_small at full width through ParallelTrainer.step, the
    benchmark's configuration."""
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=0, **TRAIN_MODEL_KW)
    cfg = model.config
    L = cfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    log(f'train model: gpt_small vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, layers {L}, heads {cfg.num_heads}, '
        f'max_seq_len {cfg.max_seq_len}, {n_params} parameters, seed 0; '
        f'B {TRAIN_BATCH}, T {TRAIN_SEQ}, bf16 O2, fused head in '
        f'{cfg.fused_head_chunks} chunks, AdamW lr {TRAIN_LR}')
    trainer = _trainer(model, amp_o2=True)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, (ids, ids), TRAIN_WARMUP, TRAIN_STEPS)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = _per_step(L, 2 * L + 1, flash=1)
    _check_run('train', losses, launches, per_step, steps)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms_step = dt / TRAIN_STEPS * 1e3
    flops, attn = gpt_step_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'train: losses {", ".join(f"{x:.4f}" for x in losses)} (finite, '
        f'falling); launches {_launch_summary(launches, per_step, steps)}')
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
    del model, trainer
    summary['parity'] = _card_vs_cpu(
        f'gpt_small B 1 T {PARITY_SEQ}',
        lambda dev: gpt_small(device=dev, seed=0, **dict(
            TRAIN_MODEL_KW, max_seq_len=PARITY_SEQ)),
        lambda cfg: 2 * [np.random.RandomState(1).randint(
            0, cfg.vocab_size, (1, PARITY_SEQ)).astype(np.int64)],
        _per_step(L, 2 * L + 1, flash=1, flash_design='simt'))
    return summary


def _card_vs_cpu(what, make_model, make_batch, per_step, make_trainer=None,
                 zero_grads=()):
    """One f32 training step of the same seeded weights on the card (the
    kernels, launched as ``per_step`` says) and on the CPU (the plain
    twins): the loss within PARITY_LOSS_RTOL and each gradient's max
    |diff| within PARITY_GRAD_RTOL of its max |value|.  The trainer is
    ``make_trainer(model)`` (the GPT one, AdamW over ``model.loss``,
    when None).  A parameter whose name ends in one of ``zero_grads``
    has a true gradient of 0 (an attention key's bias: softmax does not
    see a shift shared by every key), so both sides hold round-off:
    each side's max |gradient| there must stay within PARITY_GRAD_RTOL
    of the model's largest gradient instead."""
    from paddle_tpu_torch.ops import _build
    got = {}
    for dev in ('cuda', 'cpu'):
        model = make_model(dev)
        trainer = make_trainer(model) if make_trainer else \
            _trainer(model, amp_o2=False)
        batch = make_batch(model.config)
        _build.reset_launches()
        loss = trainer.loss_float(trainer.step(*batch))
        got[dev] = (loss, {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()
                           if p.grad is not None},
                    launch_counts())
        del model, trainer
    (l_card, g_card, launches), (l_cpu, g_cpu, _) = got['cuda'], got['cpu']
    for name, n in per_step.items():
        if launches[name] != n:
            raise AssertionError(f'f32 step {what}: {name} launched '
                                 f'{launches[name]} times, expected {n}')
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    zero = {n for n in g_cpu if n.endswith(tuple(zero_grads))}
    roundoff = max((float(g[n].abs().max()) / largest for n in zero
                    for g in (g_card, g_cpu)), default=0.0)
    if roundoff > PARITY_GRAD_RTOL:
        raise AssertionError(
            f'f32 step {what}: a gradient that is 0 in exact arithmetic '
            f'({sorted(zero)[:3]}...) reaches {roundoff:.3e} of the '
            f'largest gradient (tol {PARITY_GRAD_RTOL})')
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        if name in zero:
            continue
        rel = float((g_card[name] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    if not (loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError(
            f'f32 step {what}, card vs CPU: loss {l_card} vs {l_cpu} (rel '
            f'{loss_rel:.3e}, tol {PARITY_LOSS_RTOL}); worst gradient '
            f'{worst_name} rel {worst:.3e} (tol {PARITY_GRAD_RTOL})')
    log(f'parity: f32 step {what}, card ({_launch_summary(launches, per_step, 1)}'
        f') vs CPU plain twins: loss {l_card:.6f} vs {l_cpu:.6f} (rel '
        f'{loss_rel:.3e}, tol {PARITY_LOSS_RTOL}); worst gradient '
        f'{worst_name} max |diff| / max |grad| {worst:.3e} (tol '
        f'{PARITY_GRAD_RTOL})'
        + (f'; {len(zero)} gradients 0 in exact arithmetic at most '
           f'{roundoff:.3e} of the largest on either side' if zero else ''))
    return {'loss_rel': loss_rel, 'worst_grad_rel': worst,
            'worst_grad': worst_name, 'zero_grad_roundoff': roundoff}


def bert_batch(vocab_size, batch, seq, seed=0):
    """Seeded ids and MLM labels (15% of positions, -100 elsewhere), as
    bench.py makes them."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab_size, (batch, seq)).astype(np.int64)
    lbl = np.where(rs.rand(batch, seq) < 0.15,
                   rs.randint(0, vocab_size, (batch, seq)), -100)
    return ids, lbl.astype(np.int64)


def bert_phase():
    """bert_base at full width through ParallelTrainer.step, the bench's
    configuration, at dropout 0.1 (softmax), 0 (flash), and 0.1 with the
    GEMM+GELU kernels (USE_PALLAS_MLP); then the f32 card-vs-CPU step."""
    from paddle_tpu_torch.models.bert import bert_base
    fgl = _ops_module('fused_gelu_linear')
    out = {}
    for run, dropout, pallas_mlp, warmup, steps in BERT_RUNS:
        model = bert_base(device='cuda', seed=0, dropout=dropout,
                          **BERT_MODEL_KW)
        cfg = model.config
        L = cfg.num_layers
        n_params = sum(p.numel() for p in model.parameters())
        trainer = _trainer(model, amp_o2=True, lr=BERT_LR)
        batch = bert_batch(cfg.vocab_size, BERT_BATCH, BERT_SEQ)
        fgl.USE_PALLAS_MLP = pallas_mlp
        try:
            losses, launches, warm_s, dt, peak = _run_steps(
                trainer, batch, warmup, steps)
        finally:
            fgl.USE_PALLAS_MLP = False
        total = warmup + steps
        per_step = _per_step(L, 2 * L + 2, softmax=int(dropout > 0),
                             flash=int(dropout == 0), gelu=int(pallas_mlp))
        _check_run(run, losses, launches, per_step, total)
        tokens = BERT_BATCH * BERT_SEQ
        ms_step = dt / steps * 1e3
        flops, attn = bert_step_flops(cfg, n_params, BERT_BATCH, BERT_SEQ)
        mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
        if run == BERT_RUNS[0][0]:
            log(f'bert model: bert_base vocab {cfg.vocab_size}, hidden '
                f'{cfg.hidden_size}, layers {L}, heads {cfg.num_heads}, '
                f'FFN {cfg.intermediate_size}, eps '
                f'{cfg.layer_norm_epsilon}, {n_params} parameters, seed 0; '
                f'B {BERT_BATCH}, T {BERT_SEQ}, bf16 O2, fused MLM head in '
                f'{cfg.fused_head_chunks} chunks, AdamW lr {BERT_LR}')
        log(f'{run} (dropout {dropout}, USE_PALLAS_MLP {pallas_mlp}): '
            f'losses {", ".join(f"{x:.4f}" for x in losses)} (finite, '
            f'falling); launches '
            f'{_launch_summary(launches, per_step, total)}')
        log(f'{run}: warm-up {warmup} steps {warm_s:.2f} s; {steps} steps '
            f'in {dt:.3f} s = {ms_step:.1f} ms/step, '
            f'{tokens * steps / dt:.0f} tokens/s; peak '
            f'max_memory_allocated {peak / 2**30:.2f} GiB; MFU {mfu:.4f} = '
            f'(6 * {n_params} params * {tokens} tokens + {attn:.4g} '
            f'attention flops) / (step time * 989e12)')
        out[run] = {'dropout': dropout, 'use_pallas_mlp': pallas_mlp,
                    'ms_per_step': ms_step,
                    'tokens_per_s': tokens * steps / dt, 'peak_bytes': peak,
                    'mfu': mfu, 'losses': losses, 'warmup_s': warm_s,
                    'launches': launches}
        del model, trainer
        torch.cuda.empty_cache()
    fgl.USE_PALLAS_MLP = True
    try:
        out['parity'] = _card_vs_cpu(
            f'bert_base B {BERT_PARITY_BATCH} T {BERT_SEQ}, dropout '
            f'{BERT_PARITY_DROPOUT}, USE_PALLAS_MLP',
            lambda dev: bert_base(device=dev, seed=0,
                                  dropout=BERT_PARITY_DROPOUT,
                                  **BERT_MODEL_KW),
            lambda cfg: bert_batch(cfg.vocab_size, BERT_PARITY_BATCH,
                                   BERT_SEQ, seed=1),
            _per_step(L, 2 * L + 2, softmax=1, gelu=1, gelu_design='simt'))
    finally:
        fgl.USE_PALLAS_MLP = False
    return out


def idle_share(fn):
    """(device idle share, wall s) of ``fn()`` under ``torch.profiler``:
    1 - the union of device-kernel intervals over the wall window (the
    profiler can miss kernel records on the chip machine, which reads
    high)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return 1.0 - device_busy_us(prof) / wall_us, wall_us / 1e6


def device_time_by_name(prof, top=3):
    """(µs of memory copies and sets, [(name, µs)] of the ``top``
    kernels by device time) of a profile's device events."""
    by_name, copies = {}, 0.0
    for e in prof.events():
        if not is_device_event(e) or e.name in ANNOTATIONS:
            continue
        us = e.time_range.end - e.time_range.start
        if e.name.startswith(('Memcpy', 'Memset')):
            copies += us
        else:
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    return copies, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def device_busy_us(prof):
    """The union of a profile's device-kernel intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if is_device_event(e)
                   and e.name not in ANNOTATIONS)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _opt_state(trainer):
    """The optimizer's state tensors (Adam's moments), cloned, keyed
    ``'opt.<name>_<slot>'``."""
    return {f'opt.{k}': v.detach().clone()
            for k, v in trainer.optimizer.state_dict().items()
            if torch.is_tensor(v)}


def _fused_vs_eager(what, make_model, batch, lr, per_step, tokens,
                    step_flops, with_opt_state=False, mfu_params=None,
                    make_trainer=None, falls=True):
    """``ParallelTrainer(fused_steps=K).step_fused`` (K = TRAIN_STEPS, one
    captured step replayed) against eager ``step`` calls, from the same
    seed (weights and dropout's generator) on the same batch, 2 K steps:
    first two eager trainers (whose difference, if any, is the spread
    the graph is held to; none means bit for bit), then the fused one,
    whose first chunk is the warm-up step, the capture and K - 1
    replays, and whose second chunk (K replays) is timed and has its
    launches counted with the first's; a third chunk under the profiler
    reads the idle share.  ``with_opt_state`` holds the optimizer's
    state along with the parameters; ``mfu_params(model)`` counts the
    parameters the MFU's 6 x params x tokens takes (all of them when
    None).  ``make_trainer(model, fused_steps)`` builds the trainers
    (the GPT one, bf16 O2 AdamW at ``lr``, when None); ``falls`` asks
    the loss to fall over the run.  Returns the summary."""
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import _build
    k = TRAIN_STEPS
    chunk = tuple(np.stack([b] * k) for b in batch)
    if make_trainer is None:
        def make_trainer(model, fused_steps=None):
            return _trainer(model, amp_o2=True, lr=lr,
                            fused_steps=fused_steps)

    def eager():
        paddle_tpu_torch.seed(0)
        tr = make_trainer(make_model())
        losses = [tr.step(*batch) for _ in range(k)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [tr.step(*batch) for _ in range(k)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        state = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        if with_opt_state:
            state.update(_opt_state(tr))
        out = torch.stack(losses), state, dt
        del tr
        _free()
        return out

    def worst(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in a)

    want_l, want_p, eager_dt = eager()
    again_l, again_p, _ = eager()
    loss_spread = float((want_l - again_l).abs().max())
    param_spread = worst(want_p, again_p)
    del again_p

    paddle_tpu_torch.seed(0)
    model = make_model()
    n_params = mfu_params(model) if mfu_params else sum(
        p.numel() for p in model.parameters())
    tr = make_trainer(model, fused_steps=k)
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = tr.step_fused(*chunk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    second = tr.step_fused(*chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    (graph,) = tr._fused_cache.modules.values()
    got_l = torch.cat([first, second])
    loss_diff = float((got_l - want_l).abs().max())
    got_p = {n: p.detach() for n, p in tr.model.named_parameters()}
    if with_opt_state:
        got_p.update(_opt_state(tr))
    param_diff = worst(got_p, want_p)
    exact = torch.equal(got_l, want_l) and all(
        torch.equal(got_p[n], want_p[n]) for n in want_p)
    if not (exact if loss_spread == param_spread == 0 else
            loss_diff <= loss_spread and param_diff <= param_spread):
        raise AssertionError(
            f'{what}: step_fused vs eager steps: losses differ by '
            f'{loss_diff:.3e}, parameters by {param_diff:.3e}; eager vs '
            f'eager {loss_spread:.3e} and {param_spread:.3e}')
    if graph.replays != 2 * k - 1 or tr._step_no != 2 * k:
        raise AssertionError(f'{what}: {graph.replays} replays, step '
                             f'{tr._step_no}, expected {2 * k - 1}, {2 * k}')
    losses = [float(x) for x in got_l]
    _check_run(what, losses, launches, per_step, 2 * k, falls=falls)
    idle, prof_s = idle_share(lambda: tr.step_fused(*chunk))
    ms_step = dt / k * 1e3
    flops, attn = step_flops(model.config, n_params)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    eager_ms = eager_dt / k * 1e3
    held = 'every parameter' + (
        f' and the optimizer\'s {sum(n.startswith("opt.") for n in got_p)} '
        'state tensors' if with_opt_state else '')
    log(f'{what}: step_fused K {k} == {2 * k} eager steps '
        + (f'bit for bit (losses and {held}; eager vs eager equal too)'
           if exact else
           f'within the eager-vs-eager spread (losses {loss_diff:.3e} <= '
           f'{loss_spread:.3e}, parameters {param_diff:.3e} <= '
           f'{param_spread:.3e})')
        + f'; losses {", ".join(f"{x:.4f}" for x in losses)}; launches '
        f'{_launch_summary(launches, per_step, 2 * k)}, a replay '
        f'{graph.launches.counts()}')
    log(f'{what}: first chunk (warm-up step + capture {graph.capture_s:.3f}'
        f' s + {k - 1} replays) {first_s:.2f} s; {k} replayed steps in '
        f'{dt:.3f} s = {ms_step:.1f} ms/step (eager {eager_ms:.1f} in this '
        f'call), {tokens * k / dt:.0f} tokens/s; idle share {idle:.4f} '
        f'under the profiler ({prof_s / k * 1e3:.1f} ms/step there); peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; MFU {mfu:.4f} = '
        f'(6 * {n_params} params * {tokens} tokens + {attn:.4g} attention '
        f'flops) / (step time * 989e12)')
    out = {'k': k, 'ms_per_step': ms_step, 'eager_ms_per_step': eager_ms,
           'tokens_per_s': tokens * k / dt, 'idle_share': idle,
           'profiled_ms_per_step': prof_s / k * 1e3, 'peak_bytes': peak,
           'mfu': mfu, 'capture_s': graph.capture_s,
           'first_chunk_s': first_s, 'losses': losses,
           'bit_for_bit': exact, 'loss_spread': loss_spread,
           'param_spread': param_spread, 'held': held, 'launches': launches,
           'launches_a_replay': graph.launches.counts()}
    del tr, model, graph, got_p, want_p
    _free()
    return out


def gpt_fused_phase():
    """gpt_small at full width, the benchmark's configuration, through
    ``step_fused``: one captured step, replayed."""
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    cfg = GPTConfig(**TRAIN_MODEL_KW)       # gpt_small's widths
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    L = cfg.num_layers
    return _fused_vs_eager(
        f'gpt_fused (gpt_small B {TRAIN_BATCH} T {TRAIN_SEQ}, bf16 O2)',
        lambda: gpt_small(device='cuda', seed=0, **TRAIN_MODEL_KW),
        (ids, ids), TRAIN_LR, _per_step(L, 2 * L + 1, flash=1),
        TRAIN_BATCH * TRAIN_SEQ,
        lambda cfg, n: gpt_step_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ))


def bert_fused_phase():
    """bert_base at its dropout 0.1 (BERT run (a)) through
    ``step_fused``: the softmax kernel and dropout's draws in a graph."""
    from paddle_tpu_torch.models.bert import BertConfig, bert_base
    run, dropout, _, _, _ = BERT_RUNS[0]
    cfg = BertConfig(dropout=dropout, **BERT_MODEL_KW)   # bert_base's
    L = cfg.num_layers
    return _fused_vs_eager(
        f'{run}_fused (bert_base B {BERT_BATCH} T {BERT_SEQ}, dropout '
        f'{dropout}, bf16 O2)',
        lambda: bert_base(device='cuda', seed=0, dropout=dropout,
                          **BERT_MODEL_KW),
        bert_batch(cfg.vocab_size, BERT_BATCH, BERT_SEQ), BERT_LR,
        _per_step(L, 2 * L + 2, softmax=1), BERT_BATCH * BERT_SEQ,
        lambda cfg, n: bert_step_flops(cfg, n, BERT_BATCH, BERT_SEQ))


def gpt_dropout_phase():
    """gpt_small with its dropout 0.1 through ParallelTrainer.step: the
    attention takes the softmax branch in every layer."""
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=0,
                      **dict(TRAIN_MODEL_KW, dropout=0.1))
    L = model.config.num_layers
    trainer = _trainer(model, amp_o2=True)
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size,
        (GPT_DROPOUT_BATCH, TRAIN_SEQ)).astype(np.int64)
    losses, launches, _, dt, peak = _run_steps(
        trainer, (ids, ids), 0, GPT_DROPOUT_STEPS)
    per_step = _per_step(L, 2 * L + 1, softmax=1)
    _check_run('gpt_dropout', losses, launches, per_step, GPT_DROPOUT_STEPS)
    ms_step = dt / GPT_DROPOUT_STEPS * 1e3
    log(f'gpt_dropout: gpt_small dropout 0.1, B {GPT_DROPOUT_BATCH} T '
        f'{TRAIN_SEQ}, bf16 O2: losses '
        f'{", ".join(f"{x:.4f}" for x in losses)} (finite, falling); '
        f'launches {_launch_summary(launches, per_step, GPT_DROPOUT_STEPS)}'
        f'; {ms_step:.1f} ms/step (the first step included); peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB')
    del model, trainer
    torch.cuda.empty_cache()
    return {'losses': losses, 'ms_per_step': ms_step, 'peak_bytes': peak,
            'launches': launches}


def gpt_f16_phase():
    """gpt_small at full width in float16: ``auto_cast(level='O2',
    dtype='float16')`` (f32 master weights, every op but the keep- and
    black-listed ones in f16), the loss scaled by ``GradScaler`` with
    the reference's defaults, and AdamW, as a user writes the loop.
    Every LayerNorm and flash launch takes an f16 tensor."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.optimizer import AdamW
    model = gpt_small(device='cuda', seed=0, **TRAIN_MODEL_KW)
    L = model.config.num_layers
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    opt._param_names.update({id(p): n for n, p in model.named_parameters()})
    scaler = amp.GradScaler()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.config.vocab_size,
        (GPT_F16_BATCH, TRAIN_SEQ)).astype(np.int64)).cuda()
    model.train()
    losses, trajectory = [], []
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GPT_F16_STEPS):
        opt.clear_grad()
        with amp.auto_cast(level='O2', dtype='float16'):
            loss = model.loss(model(ids), ids).float().mean()
        scaler.scale(loss).backward()
        scale = scaler.get_init_loss_scaling()
        scaler.step(opt)            # unscale, skip if not finite, update
        state = scaler.state_dict()
        losses.append(float(loss.detach()))
        trajectory.append({'scale': scale, 'next_scale': state['scale'],
                           'good_steps': state['good_steps'],
                           'bad_steps': state['bad_steps']})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    per_step = _per_step(L, 2 * L + 1, flash=1)
    _check_run('gpt_f16', losses, launches, per_step, GPT_F16_STEPS)
    log(f'gpt_f16: gpt_small B {GPT_F16_BATCH} T {TRAIN_SEQ}, '
        f'auto_cast O2 float16, GradScaler: losses '
        f'{", ".join(f"{x:.4f}" for x in losses)} (finite, falling); '
        f'scale per step {[t["scale"] for t in trajectory]} -> '
        f'{trajectory[-1]["next_scale"]} (good/bad steps '
        f'{[(t["good_steps"], t["bad_steps"]) for t in trajectory]}); '
        f'launches {_launch_summary(launches, per_step, GPT_F16_STEPS)}; '
        f'{dt / GPT_F16_STEPS * 1e3:.1f} ms/step (the first step '
        'included)')
    del model, opt
    torch.cuda.empty_cache()
    return {'losses': losses, 'scaler': trajectory, 'launches': launches,
            'ms_per_step': dt / GPT_F16_STEPS * 1e3}


def _decays(name):
    """AdamW's decoupled decay: every weight but biases and LayerNorm's
    (the recipe's exemption)."""
    return not (name.endswith('bias') or '.ln' in name)


def _recipe_trainer(model, fused_steps=None):
    """GPT-3 Small's recipe on ``model``, bf16 O2, the NaN guard on; the
    loss is multiplied by a per-step f32 weight from the batch."""
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.parallel import ParallelTrainer
    strategy = DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs['use_pure_fp16'] = True
    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(RECIPE_PEAK_LR, RECIPE_T_MAX,
                                eta_min=RECIPE_PEAK_LR / 10),
        RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK_LR)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, apply_decay_param_fun=_decays,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return ParallelTrainer(model, opt,
                           lambda out, y, w: model.loss(out, y) * w,
                           strategy=strategy, nan_guard=True,
                           fused_steps=fused_steps)


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _params_of(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def _equal_params(a, b):
    return all(torch.equal(a[n], b[n]) for n in a)


def gpt_recipe_phase(plain_ms):
    """gpt_small at full width, the benchmark's B 8 x T 1024 bf16 O2,
    trained with GPT-3 Small's recipe under the NaN guard through
    ``step_fused`` (K 5): four chunks, the third with a poisoned step,
    against eager guarded ``step`` calls.  ``plain_ms``: plain AdamW's
    ``gpt_fused`` ms/step in this call."""
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    from paddle_tpu_torch.ops import _build
    k = RECIPE_K
    cfg = GPTConfig(**TRAIN_MODEL_KW)
    L = cfg.num_layers
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    chunk_ids = np.stack([ids] * k)
    weights = [np.ones(k, np.float32) for _ in range(5)]
    weights[2][RECIPE_POISON] = np.nan

    def make(fused_steps=None):
        return _recipe_trainer(gpt_small(device='cuda', seed=0,
                                         **TRAIN_MODEL_KW), fused_steps)

    def eager_chunk(tr, c):
        out = [tr.step(ids, ids, weights[c][i]) for i in range(k)]
        return torch.stack(out)

    # two eager trainers over the first two chunks
    a, b = make(), make()
    want = [eager_chunk(a, 0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want.append(eager_chunk(a, 1))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / k * 1e3
    again = torch.cat([eager_chunk(b, 0), eager_chunk(b, 1)])
    if not (_same(torch.cat(want), again)
            and _equal_params(_params_of(a), _params_of(b))):
        raise AssertionError('gpt_recipe: two eager guarded trainers differ')
    del b
    _free()

    # the main path: the guarded graph, four chunks
    fused = make(fused_steps=k)
    n_params = sum(p.numel() for p in fused.model.parameters())
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = [fused.step_fused(chunk_ids, chunk_ids, weights[0])]
    got.append(fused.step_fused(chunk_ids, chunk_ids, weights[1]))
    torch.cuda.synchronize()
    if not (_same(torch.cat(got), torch.cat(want))
            and _equal_params(_params_of(fused), _params_of(a))):
        raise AssertionError('gpt_recipe: the guarded graph differs from '
                             'the eager steps over the first 2 K steps')
    syncs = fused.chunk_syncs
    torch.cuda.set_sync_debug_mode('error')   # the chunk's read excepted
    try:
        got.append(fused.step_fused(chunk_ids, chunk_ids, weights[2]))
        skipped_at = fused._step_no
        t1 = time.perf_counter()
        got.append(fused.step_fused(chunk_ids, chunk_ids, weights[3]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reads = fused.chunk_syncs - syncs
    want += [eager_chunk(a, 2), eager_chunk(a, 3)]
    losses = torch.cat(got)
    if not _same(losses, torch.cat(want)):
        raise AssertionError(f'gpt_recipe: graph losses {losses.tolist()} '
                             f'vs eager {torch.cat(want).tolist()}')
    params = _params_of(fused)
    if not _equal_params(params, _params_of(a)):
        raise AssertionError('gpt_recipe: parameters differ from eager '
                             'after the poisoned chunk')
    bad = [i for i, x in enumerate(losses.tolist()) if not math.isfinite(x)]
    if bad != [2 * k + RECIPE_POISON] or skipped_at != 3 * k - 1 \
            or not fused._step_no == a._step_no == 4 * k - 1 \
            or fused.sentinel.total_skipped != 1 or reads != 2 \
            or not all(torch.isfinite(p).all() for p in params.values()):
        raise AssertionError(
            f'gpt_recipe: non-finite losses at {bad}, step {skipped_at} '
            f'after the poisoned chunk, {fused._step_no} / {a._step_no} '
            f'after the next, {fused.sentinel.total_skipped} skipped, '
            f'{reads} host reads in two guarded chunks')
    (graph,) = fused._fused_cache.modules.values()
    per_step = _per_step(L, 2 * L + 1, flash=1)
    steps = 4 * k
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f'gpt_recipe: {name} launched '
                                 f'{launches[name]} times in {steps} steps')
    finite = [x for x in losses.tolist() if math.isfinite(x)]
    if not finite[-1] < finite[0]:
        raise AssertionError(f'gpt_recipe: loss did not fall: {finite}')
    del a, want
    _free()
    idle, prof_s = idle_share(
        lambda: fused.step_fused(chunk_ids, chunk_ids, weights[4]))
    ms_step = dt / k * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, _ = gpt_step_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    sched = fused.optimizer._learning_rate
    lrs = [float(sched.value_at(t)) for t in range(1, steps + 1)]
    log(f'gpt_recipe: gpt_small B {TRAIN_BATCH} T {TRAIN_SEQ} bf16 O2, '
        f'AdamW beta2 0.95 wd 0.1 (biases and LayerNorm exempt), '
        f'LinearWarmup({RECIPE_WARMUP}) into CosineAnnealingDecay('
        f'{RECIPE_PEAK_LR}, T_max {RECIPE_T_MAX}, eta_min '
        f'{RECIPE_PEAK_LR / 10}), ClipGradByGlobalNorm(1.0), nan_guard, '
        f'step_fused K {k}: two eager trainers equal, the graph equal to '
        f'them bit for bit in all {steps} losses and every parameter, '
        f'through chunk 3 whose step {RECIPE_POISON} has a NaN loss '
        f'weight (skipped: _step_no {skipped_at} after it, '
        f'{fused._step_no} after chunk 4, sentinel skipped '
        f'{fused.sentinel.total_skipped}, every parameter finite); chunks '
        f'3-4 under set_sync_debug_mode("error") with {reads} host reads '
        f'(chunk_sync); losses {", ".join(f"{x:.4f}" for x in losses)}; '
        f'LR per step {", ".join(f"{x:.3g}" for x in lrs)}; launches '
        f'{_launch_summary(launches, per_step, steps)}, a replay '
        f'{graph.launches.counts()}')
    log(f'gpt_recipe: {ms_step:.1f} ms/step (plain AdamW gpt_fused '
        f'{plain_ms:.1f} in this call, eager guarded steps {eager_ms:.1f}),'
        f' {tokens * k / dt:.0f} tokens/s, MFU {mfu:.4f}; capture '
        f'{graph.capture_s:.3f} s; peak max_memory_allocated '
        f'{peak / 2**30:.2f} GiB; idle share {idle:.4f} under the profiler '
        f'({prof_s / k * 1e3:.1f} ms/step there)')
    out = {'k': k, 'ms_per_step': ms_step, 'plain_ms_per_step': plain_ms,
           'eager_ms_per_step': eager_ms, 'tokens_per_s': tokens * k / dt,
           'mfu': mfu, 'capture_s': graph.capture_s, 'peak_bytes': peak,
           'idle_share': idle, 'profiled_ms_per_step': prof_s / k * 1e3,
           'losses': [float(x) for x in losses], 'lr': lrs,
           'skipped': fused.sentinel.total_skipped, 'host_reads': reads,
           'launches': launches, 'launches_a_replay': graph.launches.counts()}
    del fused, graph, params
    _free()
    return out


def _optimizer(i, name, kw, lr_value, params):
    """Optimizer ``name`` with the clip, regularizer and scheduler of
    its turn ``i`` in the rotation."""
    import inspect
    from paddle_tpu_torch import optimizer, regularizer
    from paddle_tpu_torch.nn import clip
    from paddle_tpu_torch.optimizer import lr
    cls = getattr(optimizer, name)
    extra = {}
    clips = [None, clip.ClipGradByValue(0.05), clip.ClipGradByNorm(1.0),
             clip.ClipGradByGlobalNorm(1.0)]
    if clips[i % 4] is not None:
        extra['grad_clip'] = clips[i % 4]
    regs = [None, regularizer.L1Decay(1e-4), regularizer.L2Decay(1e-4)]
    if regs[i % 3] is not None and 'weight_decay' in inspect.signature(
            cls.__init__).parameters and 'weight_decay' not in kw:
        extra['weight_decay'] = regs[i % 3]
    scheds = [lr_value,
              lr.PiecewiseDecay([2, 3], [lr_value, lr_value / 2,
                                         lr_value / 4]),
              lr.LinearWarmup(lr.CosineAnnealingDecay(lr_value, 8,
                                                      lr_value / 10),
                              2, 0.0, lr_value),
              lr.ExponentialDecay(lr_value, 0.9)]
    opt = cls(learning_rate=scheds[i % 4], parameters=params, **kw,
              **extra)
    desc = ', '.join([type(scheds[i % 4]).__name__] + [
        type(v).__name__ for v in extra.values()])
    return opt, desc


def _vision_trainer(model, optimizer, amp_o2, fused_steps=None):
    """``ParallelTrainer`` with ``CrossEntropyLoss`` (labels ``[B, 1]``),
    bf16 O2 or f32, as bench.py's vision configs build it."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.parallel import ParallelTrainer
    strategy = DistributedStrategy()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs['use_pure_fp16'] = True
    ce = nn.CrossEntropyLoss()
    return ParallelTrainer(model, optimizer, lambda out, y: ce(out, y),
                           strategy=strategy, fused_steps=fused_steps)


def _resnet_trainer(fused_steps=None, qat=False):
    """bench.py's ResNet-50 trainer; with ``qat`` the model's convs and
    fc wrapped by ``ImperativeQuantAware`` first."""
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.quantization import ImperativeQuantAware
    from paddle_tpu_torch.vision.models import BottleneckBlock, ResNet
    model = ResNet(BottleneckBlock, 50, num_classes=RESNET_CLASSES,
                   data_format='NHWC', device='cuda', seed=0)
    if qat:
        ImperativeQuantAware().quantize(model)
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=model.parameters())
    return _vision_trainer(model, opt, amp_o2=True, fused_steps=fused_steps)


def resnet_batch():
    """bench.py's images and labels: RandomState(0), images drawn in f32
    and rounded to bf16, on the card."""
    rs = np.random.RandomState(0)
    x = rs.randn(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3).astype(
        np.float32)
    y = rs.randint(0, RESNET_CLASSES, size=(RESNET_BATCH, 1)).astype(
        np.int64)
    return (torch.from_numpy(x).to('cuda', torch.bfloat16),
            torch.from_numpy(y).to('cuda'))


def resnet_step_flops(model, image, batch, nchw=False):
    """(model flops of one training step, multiply-adds of one image's
    forward): 2 x 3 x the multiply-adds of every conv and of every
    Linear at the shapes the code runs (forward hooks on one NHWC image,
    NCHW with ``nchw``, in eval mode): each output element of a conv
    takes in/groups x kh x kw multiply-adds, of a Linear ``in``."""
    from paddle_tpu_torch import nn
    macs = []

    def count(mod, inputs, out):
        if isinstance(mod, nn.Conv2D):
            w = mod.weight
            macs.append(out[0].numel() * math.prod(w.shape[1:]))
        else:
            macs.append(out[0].numel() * mod.weight.shape[0])

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (nn.Conv2D, nn.Linear))]
    was_training = model.training
    try:
        with torch.no_grad():
            shape = (1, 3, image, image) if nchw else (1, image, image, 3)
            model.eval()(torch.zeros(shape, device='cuda'))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    per_image = sum(macs)
    return 2 * 3 * per_image * batch, per_image


def _no_kernel_launches(what, launches):
    """The vision paths run none of the hand-written kernels."""
    ran = {k: n for k, n in launches.items() if n}
    if ran:
        raise AssertionError(f'{what}: ported kernels launched: {ran}')


def _check_losses(what, losses):
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'{what}: non-finite training loss: {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'{what}: loss did not fall on one batch: '
                             f'{losses}')


def resnet_phase():
    """ResNet-50 at the bench's configuration through
    ``ParallelTrainer.step``: timed steps, the idle share, one
    ``eval_step`` on the running statistics, then ``step_fused``
    (``_graph_vs_eager``)."""
    x, y = resnet_batch()
    trainer = _resnet_trainer()
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    n_bufs = sum(1 for _ in model.buffers())
    if n_bufs != RESNET_BN_BUFFERS:
        raise AssertionError(f'resnet: {n_bufs} buffers, expected '
                             f'{RESNET_BN_BUFFERS}')
    flops, macs = resnet_step_flops(model, RESNET_IMAGE, RESNET_BATCH)
    log(f'resnet model: ResNet(BottleneckBlock, 50, num_classes '
        f'{RESNET_CLASSES}, NHWC), {n_params} parameters, {n_bufs} '
        f'BatchNorm buffers, seed 0; B {RESNET_BATCH} x {RESNET_IMAGE} x '
        f'{RESNET_IMAGE} x 3 bf16, bf16 O2, Momentum lr {RESNET_LR} '
        f'momentum {RESNET_MOMENTUM}; {macs / 1e9:.4f} G multiply-adds an '
        f'image (every conv and the fc)')
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, (x, y), RESNET_WARMUP, RESNET_STEPS)
    _check_losses('resnet', losses)
    _no_kernel_launches('resnet', launches)
    ms_step = dt / RESNET_STEPS * 1e3
    imgs = RESNET_BATCH * RESNET_STEPS / dt
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    idle, prof_s = idle_share(lambda: [trainer.step(x, y) for _ in range(2)])
    before = {n: b.clone() for n, b in model.named_buffers()}
    out, eval_loss = trainer.eval_step(x.float(), y)
    torch.cuda.synchronize()
    if tuple(out.shape) != (RESNET_BATCH, RESNET_CLASSES) or \
            out.dtype != torch.float32:
        raise AssertionError(f'resnet eval_step: {tuple(out.shape)} '
                             f'{out.dtype}')
    if not all(torch.equal(b, before[n]) for n, b in model.named_buffers()):
        raise AssertionError('resnet eval_step changed a running statistic')
    eval_loss = float(eval_loss)
    eval_rel, eval_scale = _resnet_eval_vs_cpu(model, x, out)
    log(f'resnet: losses {", ".join(f"{v:.4f}" for v in losses)} (finite, '
        f'falling); no ported kernel launched')
    log(f'resnet: warm-up {RESNET_WARMUP} steps {warm_s:.2f} s; '
        f'{RESNET_STEPS} steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{imgs:.0f} imgs/s; MFU {mfu:.4f} = (6 * {macs:.6g} multiply-adds '
        f'* {RESNET_BATCH} images) / (step time * 989e12); peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; idle share '
        f'{idle:.4f} under the profiler ({prof_s / 2 * 1e3:.1f} ms/step '
        f'there); eval_step on running statistics (f32 images): logits '
        f'{tuple(out.shape)}, loss {eval_loss:.4g}, buffers unchanged, '
        f'the first {RESNET_EVAL_IMAGES} images\' logits (largest '
        f'{eval_scale:.4g}) within {eval_rel:.3e} of the CPU\'s eval '
        f'(tol {PARITY_GRAD_RTOL})')
    summary = {'ms_per_step': ms_step, 'imgs_per_s': imgs, 'mfu': mfu,
               'step_flops': flops, 'macs_per_image': macs,
               'peak_bytes': peak, 'idle_share': idle,
               'profiled_ms_per_step': prof_s / 2 * 1e3, 'losses': losses,
               'warmup_s': warm_s, 'eval_loss': eval_loss,
               'eval_vs_cpu_rel': eval_rel, 'eval_logit_scale': eval_scale,
               'launches': launches}
    del trainer, model, out
    _free()
    summary['fused'] = _graph_vs_eager(
        'resnet_fused', _resnet_trainer, (x, y), RESNET_K, RESNET_BATCH,
        'imgs', flops, 'cudnn.deterministic', _cudnn_deterministic)
    return summary


def _resnet_eval_vs_cpu(model, x, out):
    """The card's eval-mode logits ``out`` for its first
    RESNET_EVAL_IMAGES images against the CPU's eval of the same weights
    and buffers, in f32 as ``eval_step`` runs: (max |diff| over the
    largest |logit|, the largest |logit|)."""
    from paddle_tpu_torch.vision.models import BottleneckBlock, ResNet
    cpu = ResNet(BottleneckBlock, 50, num_classes=RESNET_CLASSES,
                 data_format='NHWC', device='cpu', seed=0)
    cpu.load_state_dict({n: t.detach().cpu()
                         for n, t in model.state_dict().items()})
    with torch.no_grad():
        want = cpu.eval()(x[:RESNET_EVAL_IMAGES].float().cpu())
    got = out[:RESNET_EVAL_IMAGES].cpu()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    if not rel <= PARITY_GRAD_RTOL:
        raise AssertionError(f'resnet eval_step vs the CPU: max |diff| '
                             f'{rel:.3e} of the largest logit {scale:.4g}')
    return rel, scale


def _state_of(trainer):
    return {n: t.detach().clone()
            for n, t in trainer.model.state_dict().items()}


@contextlib.contextmanager
def _cudnn_deterministic():
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


@contextlib.contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)``; cuBLAS needs a fixed
    workspace for it."""
    import os
    prev = os.environ.get('CUBLAS_WORKSPACE_CONFIG')
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if prev is None:
            del os.environ['CUBLAS_WORKSPACE_CONFIG']
        else:
            os.environ['CUBLAS_WORKSPACE_CONFIG'] = prev


def _graph_vs_eager(what, make_trainer, batch, k, items, unit, flops,
                    fallback_name, fallback):
    """``step_fused`` (K ``k``, 2 chunks) of ``make_trainer(fused_steps=
    k)`` against two eager trainers (``make_trainer()``), each built
    after ``paddle_tpu_torch.seed(0)``, on the same batch: losses,
    parameters and every buffer bit for bit.  Where the two eager
    trainers differ, all three run again under the context
    ``fallback()`` (``fallback_name`` in the log), and the run says so.
    ``items`` of ``unit`` a step; ``flops`` a step for the MFU."""
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import _build
    chunk = tuple(torch.stack([b] * k) for b in batch)

    def trainer(**kw):
        paddle_tpu_torch.seed(0)
        return make_trainer(**kw)

    def eager():
        tr = trainer()
        losses = [tr.step(*batch) for _ in range(k)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [tr.step(*batch) for _ in range(k)]
        torch.cuda.synchronize()
        out = torch.stack(losses), _state_of(tr), time.perf_counter() - t0
        del tr
        _free()
        return out

    def differing(a, b):
        return [n for n in a if not _same(a[n], b[n])]

    want_l, want_s, eager_dt = eager()
    again_l, again_s, _ = eager()
    spread = differing(want_s, again_s)
    deterministic = bool(spread) or not _same(want_l, again_l)
    if deterministic:
        log(f'{what}: two eager trainers differ (losses '
            f'{float((want_l - again_l).abs().max()):.3e}, {len(spread)} '
            f'tensors, first {spread[:3]}); again under {fallback_name}')
    with fallback() if deterministic else contextlib.nullcontext():
        if deterministic:
            want_l, want_s, eager_dt = eager()
            again_l, again_s, _ = eager()
            spread = differing(want_s, again_s)
            if spread or not _same(want_l, again_l):
                raise AssertionError(
                    f'{what}: eager trainers differ under {fallback_name}: '
                    f'{spread[:5]}')
        tr = trainer(fused_steps=k)
        _build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = tr.step_fused(*chunk)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        second = tr.step_fused(*chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        (graph,) = tr._fused_cache.modules.values()
        got_l = torch.cat([first, second])
        got_s = _state_of(tr)
        off = differing(want_s, got_s)
        if off or not _same(got_l, want_l):
            raise AssertionError(
                f'{what}: step_fused vs eager: losses differ by '
                f'{float((got_l - want_l).abs().max()):.3e}; {len(off)} '
                f'tensors differ, first {off[:5]}')
        if graph.replays != 2 * k - 1 or tr._step_no != 2 * k:
            raise AssertionError(f'{what}: {graph.replays} replays, '
                                 f'step {tr._step_no}')
        losses = [float(v) for v in got_l]
        _check_losses(what, losses)
        _no_kernel_launches(what, launches)
        idle, prof_s = idle_share(lambda: tr.step_fused(*chunk))
    n_bufs = sum(1 for _ in tr.model.buffers() if _.is_floating_point())
    ms_step = dt / k * 1e3
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'{what}: step_fused K {k} == {2 * k} eager steps bit for bit'
        f' (losses, every parameter and all {n_bufs} float buffers; '
        f'eager vs eager equal too'
        + (f', under {fallback_name}' if deterministic else '')
        + f'); losses {", ".join(f"{v:.4f}" for v in losses)}; no ported '
        f'kernel launched')
    log(f'{what}: first chunk (warm-up step + capture '
        f'{graph.capture_s:.3f} s + {k - 1} replays) {first_s:.2f} s; {k} '
        f'replayed steps in {dt:.3f} s = {ms_step:.1f} ms/step (eager '
        f'{eager_dt / k * 1e3:.1f} in this call), '
        f'{items * k / dt:.0f} {unit}/s, MFU {mfu:.4f}; idle share '
        f'{idle:.4f} under the profiler ({prof_s / k * 1e3:.1f} ms/step '
        f'there); peak max_memory_allocated {peak / 2**30:.2f} GiB')
    out = {'k': k, 'ms_per_step': ms_step,
           'eager_ms_per_step': eager_dt / k * 1e3,
           f'{unit}_per_s': items * k / dt, 'mfu': mfu,
           'idle_share': idle, 'profiled_ms_per_step': prof_s / k * 1e3,
           'peak_bytes': peak, 'capture_s': graph.capture_s,
           'first_chunk_s': first_s, 'losses': losses,
           'bit_for_bit': True, 'float_buffers_compared': n_bufs,
           'deterministic_fallback': fallback_name if deterministic
           else None, 'launches': launches}
    del tr, graph, got_s, want_s, again_s
    _free()
    return out


def _exact_batch_norm(x, running_mean, running_var, weight=None,
                      bias=None, training=False, momentum=0.9,
                      epsilon=1e-5, data_format='NCHW',
                      use_global_stats=None, name=None):
    """The float64 witness's BatchNorm: batch statistics in the input's
    own dtype, two-pass (the port's keeps the reference's f32 statistics
    whatever the dtype); the running statistics stay as they are."""
    ch = x.dim() - 1 if data_format in ('NHWC', 'NLC', 'NDHWC') else 1
    red = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    scale = weight / torch.sqrt(x.var(dim=red, correction=0) + epsilon)
    shift = bias - x.mean(dim=red) * scale
    return x * scale.reshape(shape) + shift.reshape(shape)


def _train_grads(model, x, y):
    """One train-mode forward and backward of the cross entropy:
    (loss, every gradient as float64 on the CPU)."""
    from paddle_tpu_torch.nn import functional as F
    loss = F.cross_entropy(model.train()(x), y)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu().double()
                                  for n, p in model.named_parameters()}


def _exact_grads(build, x, y):
    """The float64 witness of a train-mode gradient: ``build('cpu')``
    from its seed, taken to float64, with float64 batch statistics
    (``_exact_batch_norm``)."""
    from paddle_tpu_torch.nn import functional as F
    model = build('cpu').double()
    keep = F.batch_norm
    F.batch_norm = _exact_batch_norm
    try:
        return _train_grads(model, torch.from_numpy(x).double(),
                            torch.from_numpy(y))[1]
    finally:
        F.batch_norm = keep


def _nudged(x, rel, seed):
    """``x`` (float64) moved by ``rel`` of its values, seeded."""
    return x * (1 + rel * np.random.RandomState(seed).randn(*x.shape))


def _rel_by_tensor(a, b):
    """Each tensor's max |a - b| over its max |b|."""
    return {n: float((a[n] - b[n]).abs().max()) / max(
        float(b[n].abs().max()), 1e-30) for n in b}


def _flat(grads):
    return torch.cat([grads[n].flatten() for n in sorted(grads)])


def _worst(a, b):
    """(the largest max |a - b| over max |b| of any tensor, its name)."""
    return max((float((a[n] - b[n]).abs().max()) / max(
        float(b[n].abs().max()), 1e-30), n) for n in b)


def _norm_rel(a, b):
    return float((_flat(a) - _flat(b)).norm() / _flat(b).norm())


def _parity_step(build, dev, x, y):
    """From ``build(dev)``'s seeded weights: the eval-mode loss and
    gradients, then one f32 trainer step (Momentum): (eval loss, eval
    gradients, step loss, step gradients, buffers after the step,
    launches), tensors as float64 on the CPU."""
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import _build
    model = build(dev)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    _build.reset_launches()
    eval_loss = F.cross_entropy(model.eval()(xt), yt)
    eval_loss.backward()
    eval_g = {n: p.grad.detach().cpu().double()
              for n, p in model.named_parameters()}
    model.zero_grad()
    tr = _vision_trainer(model, Momentum(
        learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
        parameters=model.parameters()), amp_o2=False)
    loss = float(tr.step(x, y))
    return (float(eval_loss.detach()), eval_g, loss,
            {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()},
            {n: b.detach().cpu().double() for n, b in model.named_buffers()},
            launch_counts())


def _vs(got, want):
    """(norm-wise gap, worst tensor's gap, its name) of two gradient
    dicts, and its text."""
    v = (_norm_rel(got, want), *_worst(got, want))
    return v, f'{v[0]:.3e} of the norm, worst {v[2]} {v[1]:.3e}'


def _within_envelope(got, exact, envelope):
    """(every tensor of ``got`` within PARITY_GRAD_RTOL plus its
    envelope of ``exact``, the tightest tensor's (gap, bound, name))."""
    gaps = _rel_by_tensor(got, exact)
    bounds = {n: PARITY_GRAD_RTOL + envelope[n] for n in gaps}
    name = max(gaps, key=lambda n: gaps[n] / bounds[n])
    return (all(gaps[n] <= bounds[n] for n in gaps),
            (gaps[name], bounds[name], name))


def resnet_parity_phase():
    """f32, B 8 x 64 x 64 NHWC, 10 classes: resnet18 and resnet50 from
    the same seed on the card and on the CPU, held as the RESNET_PARITY_*
    notes above say, each train-mode gradient also against the float64
    witness (``_exact_grads``).  cuDNN's TF32 is allowed for the whole
    phase: the port's f32 conv turns it off itself."""
    from paddle_tpu_torch.vision.models import resnet18, resnet50
    rs = np.random.RandomState(1)
    x = rs.randn(RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                 RESNET_PARITY_IMAGE, 3).astype(np.float32)
    y = rs.randint(0, RESNET_PARITY_CLASSES,
                   (RESNET_PARITY_BATCH, 1)).astype(np.int64)
    nets = {name: (lambda dev, fn=fn: fn(
        num_classes=RESNET_PARITY_CLASSES, data_format='NHWC', device=dev,
        seed=0)) for name, fn in (('resnet18', resnet18),
                                  ('resnet50', resnet50))}
    got = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, build in nets.items():
            for dev in ('cuda', 'cpu'):
                got[name, dev] = _parity_step(build, dev, x, y)
                _free()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    x64 = x.astype(np.float64)
    out, ok, msgs = {}, True, []
    for name, build in nets.items():
        (e, eg, loss, g, b, launches) = got[name, 'cuda']
        (e_cpu, eg_cpu, l_cpu, g_cpu, b_cpu, _) = got[name, 'cpu']
        _no_kernel_launches(f'resnet_parity {name}', launches)
        exact = _exact_grads(build, x64, y)
        r = out[name] = {'eval_loss_rel': abs(e - e_cpu) / abs(e_cpu),
                         'loss_rel': abs(loss - l_cpu) / abs(l_cpu),
                         'launches': launches}
        (r['eval_worst_grad_rel'], r['eval_worst_grad']) = _worst(eg,
                                                                  eg_cpu)
        (r['worst_buffer_rel'], r['worst_buffer']) = _worst(b, b_cpu)
        r['grad_vs_cpu'], vs_cpu = _vs(g, g_cpu)
        r['grad_vs_exact'], vs_exact = _vs(g, exact)
        r['cpu_vs_exact'], cpu_exact = _vs(g_cpu, exact)
        ok &= (r['eval_loss_rel'] <= PARITY_LOSS_RTOL
               and r['loss_rel'] <= PARITY_LOSS_RTOL
               and r['eval_worst_grad_rel'] <= PARITY_GRAD_RTOL
               and r['worst_buffer_rel'] <= PARITY_GRAD_RTOL)
        msg = (f'resnet_parity {name} (f32 B {RESNET_PARITY_BATCH} x '
               f'{RESNET_PARITY_IMAGE}^2 NHWC, cudnn.allow_tf32 left on), '
               f'card vs CPU: on running statistics loss rel '
               f'{r["eval_loss_rel"]:.3e}, worst gradient '
               f'{r["eval_worst_grad"]} {r["eval_worst_grad_rel"]:.3e} (tol '
               f'{PARITY_GRAD_RTOL}); a Momentum step: loss {loss:.6f} vs '
               f'{l_cpu:.6f} (rel {r["loss_rel"]:.3e}, tol '
               f'{PARITY_LOSS_RTOL}), worst buffer {r["worst_buffer"]} '
               f'{r["worst_buffer_rel"]:.3e} (tol {PARITY_GRAD_RTOL}), '
               f'gradient {vs_cpu}; from the float64 witness: card '
               f'{vs_exact}, CPU {cpu_exact}')
        if name == 'resnet18':
            envelope = {n: 0.0 for n in exact}
            for seed in range(RESNET18_NUDGES):
                moved = _rel_by_tensor(_exact_grads(
                    build, _nudged(x64, RESNET18_NUDGE, seed), y), exact)
                envelope = {n: max(envelope[n], moved[n]) for n in exact}
            widest = max(envelope, key=envelope.get)
            r['envelope_widest'] = (envelope[widest], widest)
            card_ok, r['card_tightest'] = _within_envelope(g, exact,
                                                           envelope)
            cpu_ok, r['cpu_tightest'] = _within_envelope(g_cpu, exact,
                                                         envelope)
            ok &= card_ok and cpu_ok
            msg += ('; every tensor within ' + str(PARITY_GRAD_RTOL)
                    + ' plus how far the witness moves on images nudged '
                    f'by {RESNET18_NUDGE} ({RESNET18_NUDGES} draws; widest '
                    f'{widest} {envelope[widest]:.3e}): tightest, card '
                    + ', CPU '.join(
                        f'{t[2]} {t[0]:.3e} of bound {t[1]:.3e}'
                        for t in (r['card_tightest'], r['cpu_tightest'])))
        else:
            r['nudged_vs_exact'], nudged_exact = _vs(_exact_grads(
                build, _nudged(x64, RESNET50_NUDGE, 5), y), exact)
            ok &= (r['grad_vs_cpu'][0] <= RESNET50_GRAD_NORM_RTOL
                   and r['grad_vs_exact'][0] <= RESNET50_GRAD_NORM_RTOL)
            msg += (f' (card tol {RESNET50_GRAD_NORM_RTOL} of the norm from'
                    f' each); the witness on images nudged by '
                    f'{RESNET50_NUDGE}: {nudged_exact}')
        msgs.append(msg)
    if not ok:
        raise AssertionError('\n'.join(msgs))
    for msg in msgs:
        log(msg + '; no ported kernel launched')
    _free()
    return out


def lenet_phase():
    """LeNet at bench.py's configuration: f32 B 256, Adam lr 1e-3, 5
    warm-up and 50 timed steps, then the bench's anchor."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    model = LeNet(device='cuda', seed=0)
    tr = _vision_trainer(model, Adam(learning_rate=LENET_LR,
                                     parameters=model.parameters()),
                         amp_o2=False)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(LENET_BATCH, 1, 28, 28).astype(
        np.float32)).to('cuda')
    y = torch.from_numpy(rs.randint(0, 10, (LENET_BATCH, 1)).astype(
        np.int64)).to('cuda')
    _build.reset_launches()
    for _ in range(LENET_WARMUP):
        loss = tr.step(x, y)
    l0 = float(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        tr.step(x, y)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    l1 = float(tr.step(x, y))
    launches = launch_counts()
    _no_kernel_launches('lenet', launches)
    if not (math.isfinite(l1) and l1 < l0 * 1.5):
        raise AssertionError(f'lenet: bench anchor failed: {l0} -> {l1}')
    imgs = LENET_BATCH * LENET_STEPS / dt
    log(f'lenet: B {LENET_BATCH} f32, Adam lr {LENET_LR}: {LENET_STEPS} '
        f'steps in {dt:.3f} s = {dt / LENET_STEPS * 1e3:.2f} ms/step, '
        f'{imgs:.0f} imgs/s; loss {l0:.4f} -> {l1:.4f} (finite, below 1.5 '
        f'x); no ported kernel launched')
    del tr, model
    _free()
    return {'ms_per_step': dt / LENET_STEPS * 1e3, 'imgs_per_s': imgs,
            'loss_warm': l0, 'loss_after': l1, 'launches': launches}


def widedeep_batch():
    """bench.py's Wide&Deep batch: RandomState(0) ids (one column per
    field), dense features and labels, on the card."""
    rs = np.random.RandomState(0)
    ids = np.stack([rs.randint(0, f, size=WD_BATCH) for f in WD_FIELDS],
                   axis=1).astype(np.int64)
    dense = rs.rand(WD_BATCH, WD_DENSE).astype(np.float32)
    y = rs.randint(0, 2, size=(WD_BATCH, 1)).astype(np.float32)
    return tuple(torch.from_numpy(a).to('cuda') for a in (ids, dense, y))


def _widedeep_model(cls, device):
    from paddle_tpu_torch import models
    kw = dict(dense_dim=WD_DENSE, embed_dim=WD_EMBED, hidden=WD_HIDDEN,
              device=device, seed=0)
    return getattr(models, cls)(WD_FIELDS, **kw)


def _bce_adam_trainer(model, amp_o2, fused_steps=None):
    """bench.py's Wide&Deep trainer of ``model``: Adam, BCEWithLogitsLoss,
    n_inputs 2, bf16 O2 (``use_pure_fp16``) or f32."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import ParallelTrainer
    strategy = DistributedStrategy()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs['use_pure_fp16'] = True
    bce = nn.BCEWithLogitsLoss()
    return ParallelTrainer(model, Adam(learning_rate=WD_LR,
                                       parameters=model.parameters()),
                           lambda out, y: bce(out, y), n_inputs=2,
                           strategy=strategy, fused_steps=fused_steps)


def _widedeep_trainer(cls='WideDeep', fused_steps=None):
    return _bce_adam_trainer(_widedeep_model(cls, 'cuda'), True,
                             fused_steps)


def widedeep_phase():
    """Wide&Deep at bench.py's configuration through
    ``ParallelTrainer.step`` (timed, the idle share), ``step_fused``
    against eager, one f32 step on the card against the CPU, then
    DeepFM at the same configuration."""
    batch = widedeep_batch()
    trainer = _widedeep_trainer()
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    rows = sum(WD_FIELDS)
    log(f'widedeep model: WideDeep({len(WD_FIELDS)} fields x '
        f'{WD_FIELDS[0]} ids = {rows} rows, dense {WD_DENSE}, embed '
        f'{WD_EMBED}, hidden {WD_HIDDEN}), {n_params} parameters, seed 0; '
        f'B {WD_BATCH}, bf16 O2, Adam lr {WD_LR}, BCEWithLogitsLoss')
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, batch, WD_WARMUP, WD_STEPS)
    _check_losses('widedeep', losses)
    _no_kernel_launches('widedeep', launches)
    ms_step = dt / WD_STEPS * 1e3
    examples = WD_BATCH * WD_STEPS / dt
    # the MLPs' matmuls: 6 flops a weight and an example (the gathers and
    # the tables' update are bytes, not operations)
    flops = 6 * WD_BATCH * sum(p.numel() for n, p in model.named_parameters()
                               if n.startswith(('deep.', 'dense_linear.')))
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    idle, prof_s = idle_share(lambda: [trainer.step(*batch)
                                       for _ in range(2)])
    log(f'widedeep: losses {", ".join(f"{v:.4f}" for v in losses)} '
        f'(finite, falling); no ported kernel launched')
    log(f'widedeep: warm-up {WD_WARMUP} steps {warm_s:.2f} s; {WD_STEPS} '
        f'steps in {dt:.3f} s = {ms_step:.2f} ms/step, {examples:.0f} '
        f'examples/s (widedeep_sparse_train_throughput), MFU {mfu:.4f} '
        f'(6 * the MLPs\' {flops / 6 / WD_BATCH:.0f} weights * B); peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; idle share '
        f'{idle:.4f} under the profiler ({prof_s / 2 * 1e3:.2f} ms/step '
        f'there)')
    summary = {'ms_per_step': ms_step, 'examples_per_s': examples,
               'n_params': n_params, 'mfu': mfu, 'peak_bytes': peak,
               'idle_share': idle, 'profiled_ms_per_step': prof_s / 2 * 1e3,
               'losses': losses, 'warmup_s': warm_s, 'launches': launches}
    del trainer, model
    _free()
    summary['fused'] = _graph_vs_eager(
        'widedeep_fused', _widedeep_trainer, batch, WD_K, WD_BATCH,
        'examples', flops, 'torch.use_deterministic_algorithms',
        _deterministic_algorithms)
    summary['parity'] = _widedeep_parity(batch)
    summary['deepfm'] = _deepfm_steps(batch)
    return summary


def _widedeep_parity(batch):
    """One f32 Adam step of Wide&Deep at the full configuration on the
    card and on the CPU from the same weights: the loss within
    PARITY_LOSS_RTOL, each gradient's max |diff| within PARITY_GRAD_RTOL
    of its max |value|, on the card's ReLU branches.  Of the MLP's
    16384 x 1200 ReLU inputs a few lie within the two devices' rounding
    of 0 and take one side on the card and the other on the CPU; each
    such example's path, and so its 26 embedding rows, then gets another
    gradient (a row's gradient comes from one or two examples).  So the
    CPU's ReLUs take the card's masks (``x * mask``, the same forward
    but at those few inputs, within rounding of 0), and the run reports
    how many inputs and examples parted."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import _build
    got, masks, parted = [], [], []
    for card, dev in ((True, 'cuda'), (False, 'cpu')):
        model = _widedeep_model('WideDeep', dev)
        relus = [m for m in model.deep if isinstance(m, nn.ReLU)]
        if card:
            hooks = [m.register_forward_hook(
                lambda m, i, o: masks.append(o > 0)) for m in relus]
        else:
            def forced(m, inputs, out, k=iter(range(len(relus)))):
                mask = masks[next(k)].cpu()
                parted.append(mask != (inputs[0] > 0))
                return inputs[0] * mask.to(inputs[0].dtype)
            hooks = [m.register_forward_hook(forced) for m in relus]
        trainer = _bce_adam_trainer(model, amp_o2=False)
        _build.reset_launches()
        loss = trainer.loss_float(trainer.step(*(b.to(dev) for b in batch)))
        got.append((loss, {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()},
                    launch_counts()))
        for h in hooks:
            h.remove()
        del model, trainer
    (l_card, g_card, launches), (l_cpu, g_cpu, _) = got
    _no_kernel_launches('widedeep parity', launches)
    flips = torch.cat(parted, dim=1)
    n_inputs, n_examples = int(flips.sum()), int(flips.any(1).sum())
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        rel = float((g_card[name] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f'parity: f32 step WideDeep full configuration B {WD_BATCH}, card '
        f'vs CPU on the card\'s ReLU branches ({n_inputs} of '
        f'{flips.numel()} ReLU inputs, in {n_examples} examples, took the '
        f'other side on the CPU): loss {l_card:.6f} vs {l_cpu:.6f} (rel '
        f'{loss_rel:.3e}, tol {PARITY_LOSS_RTOL}); worst gradient '
        f'{worst_name} max |diff| / max |grad| {worst:.3e} (tol '
        f'{PARITY_GRAD_RTOL}); no ported kernel launched')
    if not (loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError(
            f'widedeep f32 step, card vs CPU: loss rel {loss_rel:.3e}, '
            f'worst gradient {worst_name} rel {worst:.3e}')
    return {'loss_rel': loss_rel, 'worst_grad_rel': worst,
            'worst_grad': worst_name, 'relu_inputs_parted': n_inputs,
            'examples_parted': n_examples}


def _deepfm_steps(batch):
    tr = _widedeep_trainer('DeepFM')
    losses, launches, warm_s, dt, peak = _run_steps(tr, batch, 1,
                                                    DEEPFM_STEPS - 1)
    _check_losses('deepfm', losses)
    _no_kernel_launches('deepfm', launches)
    ms_step = dt / (DEEPFM_STEPS - 1) * 1e3
    idle, _ = idle_share(lambda: tr.step(*batch))
    log(f'deepfm: same configuration, {DEEPFM_STEPS} steps: losses '
        f'{", ".join(f"{v:.4f}" for v in losses)} (finite, falling); '
        f'{ms_step:.2f} ms/step after the first, '
        f'{WD_BATCH / ms_step * 1e3:.0f} examples/s; peak '
        f'{peak / 2**30:.2f} GiB; idle share {idle:.4f} under the '
        f'profiler; no ported kernel launched')
    del tr
    _free()
    return {'ms_per_step': ms_step, 'examples_per_s': WD_BATCH / ms_step
            * 1e3, 'losses': losses, 'peak_bytes': peak,
            'idle_share': idle, 'launches': launches}


def longctx_phase():
    """gpt_small at T 4096, bench.py's longctx: eager steps with exact
    flash and LayerNorm launches, then ``step_fused`` against eager."""
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=0, **LONGCTX_MODEL_KW)
    cfg = model.config
    L = cfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    log(f'longctx model: gpt_small max_seq_len {cfg.max_seq_len}, '
        f'{n_params} parameters, seed 0; B {LONGCTX_BATCH}, T '
        f'{LONGCTX_SEQ}, bf16 O2, fused head in {cfg.fused_head_chunks} '
        f'chunks, AdamW lr {TRAIN_LR}')
    trainer = _trainer(model, amp_o2=True)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LONGCTX_BATCH, LONGCTX_SEQ)).astype(np.int64)
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, (ids, ids), LONGCTX_WARMUP, LONGCTX_STEPS)
    steps = LONGCTX_WARMUP + LONGCTX_STEPS
    per_step = _per_step(L, 2 * L + 1, flash=1)
    _check_run('longctx', losses, launches, per_step, steps)
    tokens = LONGCTX_BATCH * LONGCTX_SEQ
    ms_step = dt / LONGCTX_STEPS * 1e3
    flops, attn = gpt_step_flops(cfg, n_params, LONGCTX_BATCH, LONGCTX_SEQ)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'longctx: losses {", ".join(f"{x:.4f}" for x in losses)} (finite,'
        f' falling); launches {_launch_summary(launches, per_step, steps)}')
    log(f'longctx: warm-up {LONGCTX_WARMUP} steps {warm_s:.2f} s; '
        f'{LONGCTX_STEPS} steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{tokens * LONGCTX_STEPS / dt:.0f} tokens/s; peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; MFU {mfu:.4f} = (6 '
        f'* {n_params} params * {tokens} tokens + {attn:.4g} attention '
        f'flops) / (step time * 989e12)')
    summary = {'ms_per_step': ms_step,
               'tokens_per_s': tokens * LONGCTX_STEPS / dt,
               'peak_bytes': peak, 'mfu': mfu, 'losses': losses,
               'warmup_s': warm_s, 'launches': launches}
    del model, trainer
    _free()
    summary['fused'] = _fused_vs_eager(
        f'longctx_fused (gpt_small B {LONGCTX_BATCH} T {LONGCTX_SEQ}, bf16 '
        'O2)', lambda: gpt_small(device='cuda', seed=0, **LONGCTX_MODEL_KW),
        (ids, ids), TRAIN_LR, per_step, tokens,
        lambda cfg, n: gpt_step_flops(cfg, n, LONGCTX_BATCH, LONGCTX_SEQ))
    return summary


def _top2_gap(model, stream):
    """The gap between the two largest logits after ``stream`` (1-D ids),
    from the uncached forward."""
    with torch.no_grad():
        logits = model(torch.as_tensor(stream, device='cuda')[None])[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _generate_eager(model, ids, t0, new, seed=0, temperature=0, top_k=None):
    """``generate``'s module body run eagerly (the loop of kernels its
    graph captures) on the same padded ids, T0 and seed."""
    B = ids.shape[0]
    P = model._decode_bucket(t0, new)
    ids_p = torch.zeros((B, P), dtype=torch.int64, device='cuda')
    ids_p[:, :t0] = torch.from_numpy(np.ascontiguousarray(ids[:, :t0]))
    with torch.no_grad():
        return model._generate_body(
            ids_p, torch.tensor(t0, device='cuda'),
            torch.tensor(seed, device='cuda'), max_new_tokens=new,
            temperature=temperature, top_k=top_k)


def gptgen_phase():
    """``generate`` at bench.py's gptgen configuration through its CUDA
    graph (one per signature, the prefill and all 127 decode steps in
    one capture): tokens/s, ms a token step, the idle share, the capture
    seconds, exact LayerNorm launches per replay; the streams equal the
    eager loop's and the ServingEngine's of the same prompts and
    weights; another prompt length in the bucket and a sampled call at
    a second seed replay without a new capture."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import Request, ServeConfig, ServingEngine
    model = gpt_small(device='cuda', seed=0, **GEN_MODEL_KW).eval()
    cfg = model.config
    L = cfg.num_layers
    per_forward = 2 * L + 1
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int64)
    log(f'gptgen model: gpt_small max_seq_len {cfg.max_seq_len}, f32, '
        f'eval, seed 0; B {GEN_BATCH}, prompt {GEN_PROMPT}, '
        f'{GEN_NEW} new tokens, greedy, 1 + {GEN_CALLS} calls of generate')
    # one prefill and one decode step alone: LayerNorm launches each
    caches = model.init_decode_caches(GEN_BATCH, GEN_PROMPT + GEN_NEW)
    _build.reset_launches()
    logits, caches = model.prefill(torch.from_numpy(ids).cuda(), 0, caches)
    torch.cuda.synchronize()
    per_prefill = launch_counts()
    _build.reset_launches()
    model.decode_step(logits[:, -1:].argmax(-1), GEN_PROMPT, caches)
    torch.cuda.synchronize()
    per_decode = launch_counts()
    for what, counts in (('prefill', per_prefill), ('decode step',
                                                    per_decode)):
        ran = {k: n for k, n in counts.items() if n}
        want = {'fused_layer_norm': per_forward,
                'fused_layer_norm:warp': per_forward}
        if ran != want:
            raise AssertionError(f'gptgen: a {what} launched {ran}, '
                                 f'expected {want}')
    del caches, logits
    # the first call makes the signature's module: warm-up and capture
    t0 = time.perf_counter()
    out = model.generate(ids, GEN_NEW, temperature=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    greedy_sig = (GEN_BATCH, GEN_PROMPT, GEN_NEW, True, 0.0, None)
    mods = _captured(model._gen_cache, 'gptgen generate')
    if set(mods) != {greedy_sig}:
        raise AssertionError(f'gptgen: modules {sorted(mods)}, expected '
                             f'{greedy_sig}')
    mod = mods[greedy_sig]
    per_replay = per_forward * GEN_NEW
    if mod.launches.counts() != {'fused_layer_norm': per_replay}:
        raise AssertionError(f'gptgen: the graph captured '
                             f'{mod.launches.counts()}, expected '
                             f'fused_layer_norm {per_replay}')
    log(f'gptgen: generate\'s graph {greedy_sig} captured in '
        f'{mod.capture_s:.3f} s (first call {warm_s:.2f} s with its eager '
        f'warm-up), fused_layer_norm {per_replay} a replay (a prefill and '
        f'{GEN_NEW - 1} decode steps); memory reserved '
        f'{torch.cuda.memory_reserved() / 2**30:.2f} GiB')
    # the main path: counts at 0 just before, read just after
    graph, replays0 = mod.graph, mod.replays
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for i in range(GEN_CALLS):
        again = model.generate(ids, GEN_NEW, temperature=0, seed=i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(again, out):
        raise AssertionError('gptgen: greedy generate changed between calls')
    want = per_replay * GEN_CALLS
    ran = {k: n for k, n in launches.items() if n}
    if ran != {'fused_layer_norm': want, 'fused_layer_norm:warp': want} \
            or mod.replays - replays0 != GEN_CALLS or mod.graph is not graph:
        raise AssertionError(f'gptgen: {GEN_CALLS} calls launched {ran} in '
                             f'{mod.replays - replays0} replays, expected '
                             f'fused_layer_norm {want} in {GEN_CALLS}')
    out = out.cpu()
    if tuple(out.shape) != (GEN_BATCH, GEN_PROMPT + GEN_NEW) or not \
            torch.equal(out[:, :GEN_PROMPT], torch.from_numpy(ids)):
        raise AssertionError(f'gptgen: output {tuple(out.shape)}')
    tokens_s = GEN_BATCH * GEN_NEW * GEN_CALLS / dt
    # the eager loop: the same body, kernel by kernel, on the same inputs
    eager = _generate_eager(model, ids, GEN_PROMPT, GEN_NEW).cpu()
    if not torch.equal(eager, out[:, GEN_PROMPT:]):
        raise AssertionError('gptgen: the graph\'s streams differ from the '
                             'eager loop\'s')
    # another prompt length in the bucket, a sampled signature at two
    # seeds: one new capture (the sampled one), the rest replays
    short = GEN_PROMPT - 28
    got = model.generate(ids[:, :short], GEN_NEW, temperature=0)
    if not torch.equal(got[:, short:].cpu(), _generate_eager(
            model, ids, short, GEN_NEW).cpu()):
        raise AssertionError(f'gptgen: prompt {short}: the replay differs '
                             'from the eager loop')
    sampling = dict(temperature=0.8, top_k=40)
    sampled = [model.generate(ids, GEN_NEW, seed=s, **sampling)
               for s in (1, 2)]
    mods = _captured(model._gen_cache, 'gptgen generate')
    sampled_sig = (GEN_BATCH, GEN_PROMPT, GEN_NEW, False, 0.8, 40)
    if set(mods) != {greedy_sig, sampled_sig} or mods[greedy_sig] is not mod \
            or mod.graph is not graph \
            or mod.replays - replays0 != GEN_CALLS + 1 \
            or mods[sampled_sig].replays != 1:
        raise AssertionError(f'gptgen: modules {sorted(mods)} after a '
                             f'prompt of {short} and two seeds')
    if torch.equal(sampled[0], sampled[1]) or not torch.equal(
            sampled[1][:, GEN_PROMPT:], _generate_eager(
                model, ids, GEN_PROMPT, GEN_NEW, seed=2, **sampling)):
        raise AssertionError('gptgen: the sampled replay at seed 2 differs '
                             'from the eager loop, or seeds 1 and 2 agree')
    log(f'gptgen: the graph\'s {GEN_BATCH} streams equal the eager loop\'s, '
        f'every token; a prompt of {short} (bucket {GEN_PROMPT}) replayed '
        f'the greedy graph, equal to the eager loop; sampled (temperature '
        f'0.8, top-k 40) seeds 1 and 2: one capture '
        f'({mods[sampled_sig].capture_s:.3f} s) and one replay, seed 2 equal '
        f'to the eager loop; 2 captures in all')
    idle, prof_s = idle_share(lambda: model.generate(ids, GEN_NEW,
                                                     temperature=0))
    log(f'gptgen: {GEN_CALLS} calls in {dt:.3f} s = {tokens_s:.1f} tokens/s '
        f'decoded ({dt / GEN_CALLS * 1e3:.1f} ms a call, '
        f'{dt / GEN_CALLS / GEN_NEW * 1e3:.3f} ms a token step); idle '
        f'share {idle:.4f} under the profiler ({prof_s * 1e3:.1f} ms a call '
        f'there); peak max_memory_allocated {peak / 2**30:.3f} GiB; '
        f'fused_layer_norm {per_replay} a replay, {want} in {GEN_CALLS} '
        f'calls (exact, warp design), no flash (the cached prefill takes '
        f'the plain attention)')
    # the same prompts through the serving engine, greedy
    eng = ServingEngine(model, ServeConfig(**GEN_SERVE_KW))
    eng.warmup()
    reqs = [Request(f'gen{i}', ids[i], GEN_NEW) for i in range(GEN_BATCH)]
    eng.run(reqs)
    if any(r.state != Request.DONE for r in reqs):
        raise AssertionError('gptgen: not every engine request is DONE')
    parted = []
    for i, r in enumerate(reqs):
        ref = out[i, GEN_PROMPT:].tolist()
        if r.tokens == ref:
            continue
        pos = next(j for j, (a, b) in enumerate(zip(r.tokens, ref))
                   if a != b)
        gap = _top2_gap(model, out[i, :GEN_PROMPT + pos])
        parted.append({'stream': i, 'position': pos, 'top2_gap': gap})
        log(f'gptgen: stream {i} parts from the engine\'s at new token '
            f'{pos}; the top two logits there lie {gap:.3e} apart (bound '
            f'{GEN_TIE_TOL})')
        if gap > GEN_TIE_TOL:
            raise AssertionError(f'gptgen: stream {i} parts from the '
                                 f'engine at {pos} with a top-2 gap {gap}')
    log(f'gptgen: the engine\'s greedy streams of the same {GEN_BATCH} '
        f'prompts equal generate\'s in '
        f'{GEN_BATCH - len(parted)} of {GEN_BATCH}, every token')
    summary = {'tokens_per_s': tokens_s, 'ms_per_call': dt / GEN_CALLS * 1e3,
               'ms_per_token_step': dt / GEN_CALLS / GEN_NEW * 1e3,
               'first_call_s': warm_s, 'capture_s': mod.capture_s,
               'sampled_capture_s': mods[sampled_sig].capture_s,
               'idle_share': idle,
               'profiled_ms_per_call': prof_s * 1e3, 'peak_bytes': peak,
               'layer_norm_per_prefill': per_forward,
               'layer_norm_per_decode_step': per_forward,
               'layer_norm_per_replay': per_replay,
               'streams_parted': parted, 'launches': launches}
    del eng, model, mod, mods
    _free()
    return summary


def ernie_phase():
    """ERNIE 1.0 base at BERT run (a)'s configuration, token types in
    0..3, through ``ParallelTrainer.step``."""
    from paddle_tpu_torch.models.ernie import ernie_base
    model = ernie_base(device='cuda', seed=0, dropout=BERT_RUNS[0][1],
                       **ERNIE_MODEL_KW)
    cfg = model.config
    L = cfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    trainer = _trainer(model, amp_o2=True, lr=BERT_LR, n_inputs=2)
    ids, lbl = bert_batch(cfg.vocab_size, BERT_BATCH, BERT_SEQ)
    types = np.random.RandomState(1).randint(
        0, cfg.type_vocab_size, (BERT_BATCH, BERT_SEQ)).astype(np.int64)
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, (ids, types, lbl), ERNIE_WARMUP, ERNIE_STEPS)
    steps = ERNIE_WARMUP + ERNIE_STEPS
    per_step = _per_step(L, 2 * L + 2, softmax=1)
    _check_run('ernie', losses, launches, per_step, steps)
    tokens = BERT_BATCH * BERT_SEQ
    ms_step = dt / ERNIE_STEPS * 1e3
    flops, attn = bert_step_flops(cfg, n_params, BERT_BATCH, BERT_SEQ)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    idle, prof_s = idle_share(lambda: trainer.step(ids, types, lbl))
    log(f'ernie model: ernie_base vocab {cfg.vocab_size}, type vocab '
        f'{cfg.type_vocab_size}, hidden {cfg.hidden_size}, layers {L}, '
        f'max_seq_len {cfg.max_seq_len}, dropout {cfg.dropout}, {n_params} '
        f'parameters, seed 0; B {BERT_BATCH}, T {BERT_SEQ}, token types in '
        f'0..{cfg.type_vocab_size - 1}, bf16 O2, AdamW lr {BERT_LR}')
    log(f'ernie: losses {", ".join(f"{x:.4f}" for x in losses)} (finite, '
        f'falling); launches {_launch_summary(launches, per_step, steps)}')
    log(f'ernie: warm-up {ERNIE_WARMUP} step {warm_s:.2f} s; {ERNIE_STEPS} '
        f'steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{tokens * ERNIE_STEPS / dt:.0f} tokens/s; peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; MFU {mfu:.4f}; idle '
        f'share {idle:.4f} under the profiler ({prof_s * 1e3:.1f} ms/step '
        'there)')
    del model, trainer
    _free()
    return {'ms_per_step': ms_step, 'tokens_per_s': tokens * ERNIE_STEPS
            / dt, 'peak_bytes': peak, 'mfu': mfu, 'idle_share': idle,
            'losses': losses, 'warmup_s': warm_s, 'launches': launches}


def _zoo_trainer(name, lr, fused_steps=None):
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models
    model = getattr(models, name)(num_classes=ZOO_CLASSES, device='cuda',
                                  seed=0)
    opt = Momentum(learning_rate=lr, momentum=RESNET_MOMENTUM,
                   parameters=model.parameters())
    return _vision_trainer(model, opt, amp_o2=True, fused_steps=fused_steps)


def zoo_batch(batch):
    """NCHW images drawn in f32 and rounded to bf16, and labels, from
    RandomState(0), on the card."""
    rs = np.random.RandomState(0)
    x = rs.randn(batch, 3, ZOO_IMAGE, ZOO_IMAGE).astype(np.float32)
    y = rs.randint(0, ZOO_CLASSES, size=(batch, 1)).astype(np.int64)
    return (torch.from_numpy(x).to('cuda', torch.bfloat16),
            torch.from_numpy(y).to('cuda'))


def _depthwise_ms(trainer, batch):
    """(device ms a step of the kernels whose name says depthwise, of
    all kernels, the depthwise kernels' names) over one eager step under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(*batch)
        torch.cuda.synchronize()
    dw, total, names = 0.0, 0.0, set()
    for e in prof.events():
        if not is_device_event(e) or e.name in ANNOTATIONS:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        if 'depthwise' in e.name.lower() or 'dwconv' in e.name.lower():
            dw += us
            names.add(e.name[:100])
    return dw / 1e3, total / 1e3, sorted(names)


def vision_zoo_phase():
    """VGG-16, MobileNet v1 and v2 at 224 x 224 through
    ``ParallelTrainer.step`` (bf16 O2, Momentum), and MobileNet v2
    through ``step_fused`` against eager, BatchNorm buffers included."""
    out = {}
    for name, batch_size, lr, source in ZOO_MODELS:
        batch = zoo_batch(batch_size)
        trainer = _zoo_trainer(name, lr)
        model = trainer.model
        n_params = sum(p.numel() for p in model.parameters())
        n_bufs = sum(1 for b in model.buffers() if b.is_floating_point())
        flops, macs = resnet_step_flops(model, ZOO_IMAGE, batch_size,
                                        nchw=True)
        losses, launches, warm_s, dt, peak = _run_steps(
            trainer, batch, ZOO_WARMUP, ZOO_STEPS)
        _check_losses(name, losses)
        _no_kernel_launches(name, launches)
        ms_step = dt / ZOO_STEPS * 1e3
        imgs = batch_size * ZOO_STEPS / dt
        mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
        idle, prof_s = idle_share(lambda: trainer.step(*batch))
        dw_ms, dev_ms, dw_names = _depthwise_ms(trainer, batch)
        log(f'{name} model ({source}): {n_params} parameters, {n_bufs} '
            f'BatchNorm buffers, seed 0; B {batch_size} x 3 x {ZOO_IMAGE} x '
            f'{ZOO_IMAGE} bf16 NCHW, bf16 O2, Momentum lr {lr} momentum '
            f'{RESNET_MOMENTUM}; {macs / 1e9:.4f} G multiply-adds an image')
        log(f'{name}: losses {", ".join(f"{v:.4f}" for v in losses)} '
            f'(finite, falling); no ported kernel launched; warm-up '
            f'{ZOO_WARMUP} steps {warm_s:.2f} s; {ZOO_STEPS} steps in '
            f'{dt:.3f} s = {ms_step:.1f} ms/step, {imgs:.0f} imgs/s, MFU '
            f'{mfu:.4f}; peak max_memory_allocated {peak / 2**30:.2f} GiB; '
            f'idle share {idle:.4f} under the profiler ({prof_s * 1e3:.1f} '
            f'ms/step there)')
        log(f'{name}: depthwise convolution kernels {dw_ms:.2f} ms of '
            f'{dev_ms:.2f} device ms a step ({len(dw_names)} kernel names'
            + (f': {"; ".join(dw_names[:4])}' if dw_names else '') + ')')
        out[name] = {'batch': batch_size, 'lr': lr, 'source': source,
                     'ms_per_step': ms_step, 'imgs_per_s': imgs, 'mfu': mfu,
                     'macs_per_image': macs, 'peak_bytes': peak,
                     'idle_share': idle, 'depthwise_device_ms': dw_ms,
                     'device_ms_per_step': dev_ms, 'losses': losses,
                     'warmup_s': warm_s, 'launches': launches}
        del trainer, model
        _free()
        if name == 'mobilenet_v2':
            out[name]['fused'] = _graph_vs_eager(
                'mobilenet_v2_fused',
                lambda **kw: _zoo_trainer(name, lr, **kw), batch, ZOO_K,
                batch_size, 'imgs', flops, 'cudnn.deterministic',
                _cudnn_deterministic)
        del batch
        _free()
    return out


def optimizers_phase():
    """Every optimizer of the family on gpt_small's widths at 2 layers,
    f32: 4 guarded steps on the card against the same on the CPU, and
    ``step_fused`` (K 4) on the card against the card's eager steps."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.parallel import ParallelTrainer
    rs = np.random.RandomState(2)
    chunk = rs.randint(0, 50304, (OPT_STEPS, 1, OPT_SEQ)).astype(np.int64)

    def run(i, name, kw, lr_value, dev, fused):
        model = gpt_small(device=dev, seed=0, **OPT_MODEL_KW)
        opt, desc = _optimizer(i, name, kw, lr_value, model.parameters())
        tr = ParallelTrainer(model, opt, lambda out, y: model.loss(out, y),
                             nan_guard=True,
                             fused_steps=OPT_STEPS if fused else None)
        if fused:
            losses = tr.step_fused(chunk, chunk)
        else:
            losses = torch.stack([tr.step(chunk[j], chunk[j])
                                  for j in range(OPT_STEPS)])
        out = (losses.cpu(), {n: p.detach().cpu()
                              for n, p in model.named_parameters()},
               tr._step_no, desc)
        del model, opt, tr
        return out

    rows, t0 = [], time.perf_counter()
    _build.reset_launches()
    cpu_runs = []
    for i, (name, kw, lr_value) in enumerate(OPTIMIZERS):
        card = run(i, name, kw, lr_value, 'cuda', False)
        graph = run(i, name, kw, lr_value, 'cuda', True)
        rows.append((name, card, graph))
        _free()
    torch.cuda.synchronize()
    launches = launch_counts()
    for i, (name, kw, lr_value) in enumerate(OPTIMIZERS):
        cpu_runs.append(run(i, name, kw, lr_value, 'cpu', False))
    L = OPT_MODEL_KW['num_layers']
    per_step = _per_step(L, 2 * L + 1, flash=1, flash_design='simt')
    steps = 2 * OPT_STEPS * len(OPTIMIZERS)
    for n, c in per_step.items():
        if launches[n] != c * steps:
            raise AssertionError(f'optimizers: {n} launched {launches[n]} '
                                 f'times in {steps} steps')
    out = {}
    lr_of = {name: lr_value for name, _, lr_value in OPTIMIZERS}
    for (name, card, graph), cpu in zip(rows, cpu_runs):
        (cl, cp, cs, desc), (gl, gp, gs, _), (pl, pp, ps, _) = \
            card, graph, cpu
        loss_rel = float(((cl - pl).abs() / pl.abs()).max())
        worst, worst_name, key_diff = 0.0, None, 0.0
        for n, want in pp.items():
            diff = float((cp[n] - want).abs().max())
            if n.endswith('attn.qkv.bias'):
                key_diff = max(key_diff, diff)
                continue
            rel = diff / max(float(want.abs().max()), 1e-30)
            if rel >= worst:
                worst, worst_name = rel, n
        key_bound = 2 * lr_of[name] * OPT_STEPS
        exact = torch.equal(gl, cl) and all(torch.equal(gp[n], cp[n])
                                             for n in cp)
        ok = (bool(torch.isfinite(cl).all()) and cs == gs == ps == OPT_STEPS
              and loss_rel <= OPT_LOSS_RTOL and worst <= OPT_PARAM_RTOL
              and key_diff <= key_bound and exact)
        log(f'optimizers: {name} ({desc}): losses '
            f'{", ".join(f"{x:.5f}" for x in cl.tolist())}; card vs CPU '
            f'loss rel {loss_rel:.2e} (tol {OPT_LOSS_RTOL}), worst '
            f'parameter {worst_name} {worst:.2e} of its max (tol '
            f'{OPT_PARAM_RTOL}), qkv.bias {key_diff:.2e} (bound '
            f'{key_bound:.2e}); step_fused K {OPT_STEPS} == eager '
            f'{"bit for bit" if exact else "DIFFERS"}')
        if not ok:
            raise AssertionError(f'optimizers: {name} failed its checks')
        out[name] = {'with': desc, 'losses': cl.tolist(),
                     'loss_rel': loss_rel, 'worst_param_rel': worst,
                     'worst_param': worst_name, 'qkv_bias_diff': key_diff,
                     'graph_bit_for_bit': exact}
    log(f'optimizers: {len(OPTIMIZERS)} optimizers, launches '
        f'{_launch_summary(launches, per_step, steps)}; '
        f'{time.perf_counter() - t0:.1f} s')
    return {'optimizers': out, 'launches': launches}

def _moe_blocks(model):
    return [b.mlp for b in model.gpt.blocks
            if type(b.mlp).__name__ == 'SwitchMoE']


def _active_params(model):
    """Parameters a token meets: all but the experts it is not routed
    to (top-k of E in each MoE block)."""
    total = sum(p.numel() for p in model.parameters())
    for moe in _moe_blocks(model):
        per_expert = sum(getattr(moe, n)[0].numel()
                         for n in ('w1', 'b1', 'w2', 'b2'))
        total -= (moe.num_experts - moe.top_k) * per_expert
    return total


def _moe_einsum_ms(S, E, C, H, F):
    """Device ms of one MoE layer's four einsums, forward and backward,
    at the training step's shapes in bf16 (random operands: a dense
    einsum's time does not depend on the values): ``{'routing': the
    dispatch and combine einsums, 'experts': the two expert products,
    'all': the four}``, and their flops."""
    dev, bf = 'cuda', torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, grad=False):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=bf).requires_grad_(grad)

    dispatch, combine = rnd(S, E, C), rnd(S, E, C, grad=True)
    xs, w1, w2 = rnd(S, H, grad=True), rnd(E, H, F, grad=True), \
        rnd(E, F, H, grad=True)
    out, gy = rnd(E, C, H, grad=True), rnd(S, H)

    def routing():
        ein = torch.einsum('sec,sh->ech', dispatch, xs)
        y = torch.einsum('ech,sec->sh', out, combine)
        torch.autograd.grad([ein, y], [xs, out, combine],
                            [torch.ones_like(ein), gy])

    def experts():
        ein = xs.new_ones((E, C, H)).requires_grad_()
        h = torch.einsum('ech,ehf->ecf', ein, w1)
        o = torch.einsum('ecf,efh->ech', h, w2)
        torch.autograd.grad(o, [ein, w1, w2], torch.ones_like(o))

    def four():
        ein = torch.einsum('sec,sh->ech', dispatch, xs)
        h = torch.einsum('ech,ehf->ecf', ein, w1)
        o = torch.einsum('ecf,efh->ech', h, w2)
        y = torch.einsum('ech,sec->sh', o, combine)
        torch.autograd.grad(y, [xs, w1, w2, combine], gy)

    ms = {name: device_ms(fn, iters=20)[0]
          for name, fn in (('routing', routing), ('experts', experts),
                           ('all', four))}
    flops = {'routing': 5 * 2 * S * E * C * H,
             'experts': 6 * 2 * E * C * H * F}
    flops['all'] = flops['routing'] + flops['experts']
    del dispatch, combine, xs, w1, w2, out, gy
    _free()
    return ms, flops


def moe_phase():
    """gpt_small with Switch-Base-8's routing (MOE_KW) at the GPT
    training configuration: eager steps, the four einsums' device time,
    step_fused against eager (parameters and Adam state bit for bit),
    and an f32 card-vs-CPU step at 2 layers."""
    from paddle_tpu_torch.models.gpt import gpt_small
    kw = dict(TRAIN_MODEL_KW, **MOE_KW)
    model = gpt_small(device='cuda', seed=0, **kw)
    cfg = model.config
    L = cfg.num_layers
    moes = _moe_blocks(model)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = _active_params(model)
    E, H, F = moes[0].num_experts, cfg.hidden_size, cfg.intermediate_size
    S = TRAIN_BATCH * TRAIN_SEQ
    C = moes[0]._capacity(S * cfg.moe_top_k)
    log(f'moe model: gpt_small with {len(moes)} SwitchMoE blocks of {E} '
        f'experts (blocks {cfg.moe_every - 1}, {2 * cfg.moe_every - 1}, '
        f'... of {L}, top-{cfg.moe_top_k}, '
        f'capacity factor {cfg.moe_capacity_factor}, aux weight '
        f'{cfg.moe_aux_weight}), {n_params} parameters, {n_active} active '
        f'a token, seed 0; B {TRAIN_BATCH}, T {TRAIN_SEQ}, bf16 O2, fused '
        f'head, AdamW lr {TRAIN_LR}; routing tensors [S {S}, E {E}, C {C}]')
    trainer = _trainer(model, amp_o2=True)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, (ids, ids), TRAIN_WARMUP, TRAIN_STEPS)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = _per_step(L, 2 * L + 1, flash=1)
    _check_run('moe', losses, launches, per_step, steps)
    aux = [float(m.aux_loss.detach()) for m in moes]
    if not all(math.isfinite(a) and a >= 1.0 - 1e-3 for a in aux):
        raise AssertionError(f'moe: aux losses {aux} (each >= 1, the '
                             'balanced floor)')
    ms_step = dt / TRAIN_STEPS * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, attn = gpt_step_flops(cfg, n_active, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    idle, prof_s = idle_share(lambda: [trainer.step(ids, ids)
                                       for _ in range(2)])
    busy_ms = prof_s / 2 * 1e3 * (1.0 - idle)
    del model, trainer, moes
    _free()
    ein_ms, ein_flops = _moe_einsum_ms(S, E, C, H, F)
    n_moe = L // cfg.moe_every
    step_ein = {k: v * n_moe if v is not None else None
                for k, v in ein_ms.items()}
    share = {k: v / busy_ms if v is not None else None
             for k, v in step_ein.items()}
    log(f'moe: losses {", ".join(f"{x:.4f}" for x in losses)} (finite, '
        f'falling); aux losses of the last step '
        f'{", ".join(f"{a:.4f}" for a in aux)}; '
        f'launches {_launch_summary(launches, per_step, steps)}')
    log(f'moe: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; {TRAIN_STEPS} '
        f'steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{tokens * TRAIN_STEPS / dt:.0f} tokens/s; MFU {mfu:.4f} = (6 * '
        f'{n_active} active params * {tokens} tokens + {attn:.4g} attention '
        f'flops) / (step time * 989e12); idle share {idle:.4f} under the '
        f'profiler ({prof_s / 2 * 1e3:.1f} ms/step there, {busy_ms:.1f} '
        f'busy); peak max_memory_allocated {peak / 2**30:.2f} GiB')
    log('moe: one layer\'s einsums, forward and backward, device ms: '
        + ', '.join(f'{k} {ein_ms[k]:.3f} ('
                    f'{ein_flops[k] / ein_ms[k] / 1e9:.1f} TFLOP/s)'
                    if ein_ms[k] else f'{k} not measured'
                    for k in ein_ms)
        + f'; x {n_moe} layers a step: '
        + ', '.join(f'{k} {step_ein[k]:.2f} ms ({share[k]:.3f} of the busy '
                    'step)' if step_ein[k] else f'{k} not measured'
                    for k in step_ein))
    summary = {'ms_per_step': ms_step,
               'tokens_per_s': tokens * TRAIN_STEPS / dt, 'mfu': mfu,
               'params': n_params, 'active_params': n_active,
               'capacity': C, 'peak_bytes': peak, 'idle_share': idle,
               'profiled_ms_per_step': prof_s / 2 * 1e3,
               'busy_ms_per_step': busy_ms, 'losses': losses,
               'aux_losses': aux, 'warmup_s': warm_s,
               'einsum_ms_per_layer': ein_ms,
               'einsum_ms_per_step': step_ein,
               'einsum_share_of_busy': share, 'launches': launches}
    summary['fused'] = _fused_vs_eager(
        f'moe_fused (gpt_small + Switch-Base-8 routing B {TRAIN_BATCH} T '
        f'{TRAIN_SEQ}, bf16 O2)',
        lambda: gpt_small(device='cuda', seed=0, **kw), (ids, ids),
        TRAIN_LR, per_step, tokens,
        lambda cfg, n: gpt_step_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ),
        with_opt_state=True, mfu_params=_active_params)
    summary['parity'] = _card_vs_cpu(
        f'moe {MOE_PARITY_LAYERS} layers B 1 T {PARITY_SEQ}',
        lambda dev: gpt_small(device=dev, seed=0, **dict(
            kw, max_seq_len=PARITY_SEQ, num_layers=MOE_PARITY_LAYERS)),
        lambda cfg: 2 * [np.random.RandomState(1).randint(
            0, cfg.vocab_size, (1, PARITY_SEQ)).astype(np.int64)],
        _per_step(MOE_PARITY_LAYERS, 2 * MOE_PARITY_LAYERS + 1, flash=1,
                  flash_design='simt'))
    return summary


def moe_gen_phase():
    """``generate`` on the MoE gpt_small at gptgen's configuration (B 8,
    128 + 128, greedy, f32), one CUDA graph a call: tokens/s, exact
    LayerNorm launches a replay, the streams equal to the eager loop's;
    the prompt bucket is the prompt's own length."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    model = gpt_small(device='cuda', seed=0,
                      **dict(GEN_MODEL_KW, **MOE_KW)).eval()
    cfg = model.config
    per_forward = 2 * cfg.num_layers + 1
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int64)
    if model._decode_bucket(GEN_PROMPT - 28, GEN_NEW) != GEN_PROMPT - 28:
        raise AssertionError('moe_gen: a MoE prompt bucket is padded')
    t0 = time.perf_counter()
    out = model.generate(ids, GEN_NEW, temperature=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sig = (GEN_BATCH, GEN_PROMPT, GEN_NEW, True, 0.0, None)
    mods = _captured(model._gen_cache, 'moe_gen generate')
    if set(mods) != {sig}:
        raise AssertionError(f'moe_gen: modules {sorted(mods)}, expected '
                             f'{sig}')
    mod = mods[sig]
    per_replay = per_forward * GEN_NEW
    if mod.launches.counts() != {'fused_layer_norm': per_replay}:
        raise AssertionError(f'moe_gen: the graph captured '
                             f'{mod.launches.counts()}, expected '
                             f'fused_layer_norm {per_replay}')
    replays0 = mod.replays
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for i in range(GEN_CALLS):
        again = model.generate(ids, GEN_NEW, temperature=0, seed=i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = per_replay * GEN_CALLS
    ran = {k: n for k, n in launches.items() if n}
    if ran != {'fused_layer_norm': want, 'fused_layer_norm:warp': want} \
            or mod.replays - replays0 != GEN_CALLS:
        raise AssertionError(f'moe_gen: {GEN_CALLS} calls launched {ran} in '
                             f'{mod.replays - replays0} replays, expected '
                             f'fused_layer_norm {want}')
    if not torch.equal(again, out):
        raise AssertionError('moe_gen: greedy generate changed between '
                             'calls')
    out = out.cpu()
    if tuple(out.shape) != (GEN_BATCH, GEN_PROMPT + GEN_NEW) or not \
            torch.equal(out[:, :GEN_PROMPT], torch.from_numpy(ids)):
        raise AssertionError(f'moe_gen: output {tuple(out.shape)}')
    eager = _generate_eager(model, ids, GEN_PROMPT, GEN_NEW).cpu()
    if not torch.equal(eager, out[:, GEN_PROMPT:]):
        raise AssertionError('moe_gen: the graph\'s streams differ from the '
                             'eager loop\'s')
    tokens_s = GEN_BATCH * GEN_NEW * GEN_CALLS / dt
    log(f'moe_gen: gpt_small + Switch-Base-8 routing, max_seq_len '
        f'{cfg.max_seq_len}, f32, B {GEN_BATCH}, prompt {GEN_PROMPT} '
        f'(bucket = the prompt\'s length), {GEN_NEW} new tokens, greedy: '
        f'graph {sig} captured in {mod.capture_s:.3f} s (first call '
        f'{warm_s:.2f} s); {GEN_CALLS} calls in {dt:.3f} s = '
        f'{tokens_s:.1f} tokens/s ({dt / GEN_CALLS / GEN_NEW * 1e3:.3f} ms '
        f'a token step); fused_layer_norm {per_replay} a replay, {want} in '
        f'{GEN_CALLS} calls (exact, warp); the {GEN_BATCH} streams equal '
        f'the eager loop\'s, every token; peak max_memory_allocated '
        f'{peak / 2**30:.3f} GiB')
    summary = {'tokens_per_s': tokens_s, 'ms_per_call': dt / GEN_CALLS * 1e3,
               'ms_per_token_step': dt / GEN_CALLS / GEN_NEW * 1e3,
               'first_call_s': warm_s, 'capture_s': mod.capture_s,
               'peak_bytes': peak, 'layer_norm_per_replay': per_replay,
               'launches': launches}
    del model, mod, mods
    _free()
    return summary


def _quanted(model):
    return [(n, m) for n, m in model.named_modules()
            if type(m).__name__ == 'QuantedLayer']


def qat_phase(resnet_ms):
    """ResNet-50 under ``ImperativeQuantAware`` at the resnet
    configuration: eager steps against the plain model's ``resnet_ms``,
    the ``.quant`` artifact loaded into a fresh float ResNet-50, then
    step_fused against eager (``_graph_vs_eager``: every BatchNorm
    buffer and activation scale bit for bit) and PTQ card vs CPU."""
    import os
    from paddle_tpu_torch.quantization import (ImperativeQuantAware,
                                               load_quantized_model)
    from paddle_tpu_torch.vision.models import BottleneckBlock, ResNet
    x, y = resnet_batch()
    trainer = _resnet_trainer(qat=True)
    model = trainer.model
    quanted = _quanted(model)
    n_scales = sum(1 for n, _ in model.named_buffers()
                   if n.endswith('act_fq.scale'))
    flops, macs = resnet_step_flops(model, RESNET_IMAGE, RESNET_BATCH)
    log(f'qat model: ResNet-50 (NHWC, seed 0) with {len(quanted)} '
        f'QuantedLayers (ImperativeQuantAware: abs_max weights, '
        f'moving-average activations, 8 bits), {n_scales} activation '
        f'scales; B {RESNET_BATCH} x {RESNET_IMAGE}^2 bf16, bf16 O2, '
        f'Momentum lr {RESNET_LR}')
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, (x, y), QAT_WARMUP, QAT_STEPS)
    _check_losses('qat', losses)
    _no_kernel_launches('qat', launches)
    scales = [float(m.act_fq.scale) for _, m in quanted]
    if not all(math.isfinite(v) and v > 0 for v in scales):
        raise AssertionError(f'qat: activation scales {scales}')
    ms_step = dt / QAT_STEPS * 1e3
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    # deploy: the artifact into a fresh float ResNet-50 that holds the
    # QAT model's float state (BatchNorm, biases) first
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'build', 'qat', 'resnet50')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = ImperativeQuantAware().save_quantized_model(model, path)
    fp = ResNet(BottleneckBlock, 50, num_classes=RESNET_CLASSES,
                data_format='NHWC', device='cuda', seed=1)
    fp.load_state_dict({k.replace('.inner.', '.'): v
                        for k, v in model.state_dict().items()
                        if not k.endswith('act_fq.scale')})
    load_quantized_model(fp, path)
    # the deployed weights are the grid QAT trained on: each equals its
    # layer's fake-quantized weight (f32) bit for bit
    fp_layers = dict(fp.named_modules())
    with torch.no_grad():
        off = [name for name, q in quanted if not torch.equal(
            q.weight_fq(q.inner.weight), fp_layers[name].weight)]
    if off:
        raise AssertionError(f'qat: loaded int8 weights differ from the '
                             f'fake-quantized ones: {off[:5]}')
    # top-1 agreement in eval mode, and with BatchNorm on the batch's
    # statistics: 7 steps leave the running statistics near their init,
    # where activations overrun the learned (frozen) activation scales
    xe = x[:QAT_EVAL_IMAGES].float()
    agree = {}
    with torch.no_grad():
        for mode in ('eval', 'batch_stats'):
            for m in (model, fp):
                m.train(mode == 'batch_stats')
            for _, q in quanted:
                q.act_fq.eval()
            qat_logits, int8_logits = model(xe), fp(xe)
            if not (torch.isfinite(qat_logits).all()
                    and torch.isfinite(int8_logits).all()):
                raise AssertionError(f'qat: non-finite {mode} logits')
            agree[mode] = float((qat_logits.argmax(-1)
                                 == int8_logits.argmax(-1)).float().mean())
    n_q = sum(k.endswith('.qweight') for k in state)
    log(f'qat: losses {", ".join(f"{v:.4f}" for v in losses)} (finite, '
        f'falling); no ported kernel launched; {len(scales)} activation '
        f'scales in [{min(scales):.4g}, {max(scales):.4g}]')
    log(f'qat: warm-up {QAT_WARMUP} steps {warm_s:.2f} s; {QAT_STEPS} steps '
        f'in {dt:.3f} s = {ms_step:.1f} ms/step ({ms_step / resnet_ms:.3f}x '
        f'the resnet phase\'s {resnet_ms:.1f}), '
        f'{RESNET_BATCH * QAT_STEPS / dt:.0f} imgs/s, MFU {mfu:.4f}; peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; .quant artifact: '
        f'{n_q} int8 weights; loaded into a float ResNet-50: every weight '
        f'equal to its fake-quantized one, finite logits, top-1 '
        f'agreement with the QAT model on {QAT_EVAL_IMAGES} images '
        f'{agree["eval"]:.4f} in eval mode, '
        f'{agree["batch_stats"]:.4f} with BatchNorm on batch statistics')
    summary = {'ms_per_step': ms_step, 'resnet_ms_per_step': resnet_ms,
               'vs_resnet': ms_step / resnet_ms,
               'imgs_per_s': RESNET_BATCH * QAT_STEPS / dt, 'mfu': mfu,
               'peak_bytes': peak, 'losses': losses, 'warmup_s': warm_s,
               'quanted_layers': len(quanted), 'act_scales': len(scales),
               'artifact_weights': n_q, 'top1_agreement_int8': agree,
               'launches': launches}
    del trainer, model, fp, qat_logits, int8_logits
    _free()
    summary['fused'] = _graph_vs_eager(
        'qat_fused', lambda fused_steps=None: _resnet_trainer(
            fused_steps, qat=True), (x, y), RESNET_K, RESNET_BATCH, 'imgs',
        flops, 'cudnn.deterministic', _cudnn_deterministic)
    del x, y
    _free()
    summary['ptq'] = _ptq_vs_cpu()
    return summary


def _ptq_vs_cpu():
    """``PostTrainingQuantization`` of the same seeded float ResNet-50
    (eval, f32) over the same PTQ_BATCHES batches on the card and on the
    CPU: the same artifact keys, int8 weights and scales equal, the
    stem's activation scale equal, every other within PARITY_GRAD_RTOL."""
    from paddle_tpu_torch.quantization import PostTrainingQuantization
    from paddle_tpu_torch.vision.models import BottleneckBlock, ResNet
    rs = np.random.RandomState(2)
    batches = [rs.randn(PTQ_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
               .astype(np.float32) for _ in range(PTQ_BATCHES)]
    got = {}
    t0 = time.perf_counter()
    for dev in ('cuda', 'cpu'):
        model = ResNet(BottleneckBlock, 50, num_classes=RESNET_CLASSES,
                       data_format='NHWC', device=dev, seed=0).eval()
        got[dev] = PostTrainingQuantization(
            model, data_loader=batches, batch_nums=PTQ_BATCHES).quantize()
        del model
    card, cpu = got['cuda'], got['cpu']
    if set(card) != set(cpu):
        raise AssertionError('ptq: artifact keys differ, card vs CPU')
    off = [k for k in card if not k.endswith('.act_scale')
           and not np.array_equal(card[k], cpu[k])]
    acts = [k for k in card if k.endswith('.act_scale')]
    rel = {k: abs(float(card[k]) - float(cpu[k])) / float(cpu[k])
           for k in acts}
    stem = acts[0]
    equal = sum(card[k] == cpu[k] for k in acts)
    worst = max(rel, key=rel.get)
    if off or card[stem] != cpu[stem] or rel[worst] > PARITY_GRAD_RTOL:
        raise AssertionError(
            f'ptq card vs CPU: weights or scales differ {off[:5]}; stem '
            f'{stem} {card[stem]} vs {cpu[stem]}; worst activation scale '
            f'{worst} rel {rel[worst]:.3e}')
    log(f'ptq: PostTrainingQuantization of ResNet-50 (eval, f32) over '
        f'{PTQ_BATCHES} batches of {PTQ_BATCH} x {RESNET_IMAGE}^2, card vs '
        f'CPU ({time.perf_counter() - t0:.1f} s): {len(card) - len(acts)} '
        f'int8 weights and scales equal; {len(acts)} activation scales, '
        f'{equal} equal (the stem {stem} among them), worst {worst} rel '
        f'{rel[worst]:.3e} (tol {PARITY_GRAD_RTOL})')
    return {'act_scales': len(acts), 'act_scales_equal': int(equal),
            'worst_act_scale_rel': rel[worst], 'worst_act_scale': worst}




# -- sequence models, written against a Paddle-like package ``paddle``
# (this package or the JAX one: the tests build both from one code)

def sinusoid_table(max_len, d_model):
    """The sinusoidal position encodings of arXiv:1706.03762 section
    3.5, ``[max_len, d_model]`` f32: sin on even, cos on odd
    features."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    i = np.arange(d_model // 2, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d_model)
    table = np.zeros((max_len, d_model), np.float64)
    table[:, 0::2], table[:, 1::2] = np.sin(angle), np.cos(angle)
    return table.astype(np.float32)


def transformer_model(paddle, vocab_size, d_model, nhead, num_layers,
                      dim_feedforward, dropout, max_len, pad_id=0):
    """``nn.Transformer`` with one shared embedding (N(0, d_model^-0.5),
    ``pad_id`` zeroed) for source, target and the pre-softmax
    projection, the inputs scaled by sqrt(d_model) plus sinusoidal
    positions, then dropout.  ``model(src, tgt)`` -> logits ``[B, T,
    V]``; a source token ``pad_id`` is masked from every attention over
    the source (bool key mask, -1e9), the target causally (the -1e9
    mask of ``generate_square_subsequent_mask``)."""
    nn = paddle.nn

    class TransformerSeq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.config = dict(vocab_size=vocab_size, d_model=d_model,
                               nhead=nhead, num_layers=num_layers,
                               dim_feedforward=dim_feedforward)
            self.pad_id = pad_id
            self.embedding = nn.Embedding(
                vocab_size, d_model, pad_id, weight_attr=paddle.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d_model ** -0.5)))
            self.transformer = nn.Transformer(
                d_model, nhead, num_layers, num_layers, dim_feedforward,
                dropout)
            self.dropout = nn.Dropout(dropout)
            self.register_buffer('position', paddle.to_tensor(
                sinusoid_table(max_len, d_model)), persistable=False)
            # generate_square_subsequent_mask(max_len), made once where
            # the model is
            causal = np.triu(np.full((max_len, max_len), -1e9, np.float32),
                             1)
            self.register_buffer('causal', paddle.to_tensor(causal),
                                 persistable=False)

        def embed(self, ids, offset=0):
            x = paddle.scale(self.embedding(ids), d_model ** 0.5)
            pos = self.position[offset:offset + ids.shape[1]]
            return self.dropout(paddle.add(x, pos))

        def source_mask(self, src):
            return paddle.unsqueeze(paddle.not_equal(src, self.pad_id),
                                    [1, 2])

        def logits(self, h):
            return paddle.matmul(h, self.embedding.weight, transpose_y=True)

        def forward(self, src, tgt):
            src_mask = self.source_mask(src)
            T = tgt.shape[1]
            h = self.transformer(self.embed(src), self.embed(tgt), src_mask,
                                 self.causal[:T, :T], src_mask)
            return self.logits(h)

    return TransformerSeq2Seq()


def transformer_loss(paddle, epsilon=TRANSFORMER_LS):
    """Label-smoothed cross entropy: ``F.label_smooth`` of the one-hot
    targets, a soft-label ``cross_entropy``, the mean over tokens."""
    F = paddle.nn.functional

    def loss(logits, labels):
        soft = F.label_smooth(F.one_hot(labels, logits.shape[-1]),
                              epsilon=epsilon)
        return F.cross_entropy(logits, soft, soft_label=True)
    return loss


def transformer_batch(batch, src_len, tgt_len, vocab, seed=0,
                      min_src=TRANSFORMER_MIN_SRC):
    """Seeded ids: sources of ``min_src .. src_len`` ids padded with 0,
    targets ``[BOS] + y[:-1]`` and labels ``y``, ids in ``3 .. vocab``
    (0 pads, 1 and 2 are BOS and EOS)."""
    rs = np.random.RandomState(seed)
    src = rs.randint(3, vocab, (batch, src_len)).astype(np.int64)
    lens = rs.randint(min(min_src, src_len), src_len + 1, batch)
    src[np.arange(src_len)[None, :] >= lens[:, None]] = 0
    y = rs.randint(3, vocab, (batch, tgt_len)).astype(np.int64)
    tgt = np.concatenate([np.full((batch, 1), BOS, np.int64), y[:, :-1]], 1)
    return src, tgt, y


def transformer_trainer(paddle, model, amp_o2, fused_steps=None):
    """Adam (0.9, 0.98, 1e-9) under ``NoamDecay(d_model, 4000)``, the
    label-smoothed loss, bf16 O2 when ``amp_o2``, through
    ``ParallelTrainer`` (two model inputs: source and target)."""
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.parallel import ParallelTrainer
    strategy = DistributedStrategy()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs['use_pure_fp16'] = True
    sched = paddle.optimizer.lr.NoamDecay(model.config['d_model'],
                                          TRANSFORMER_WARMUP)
    opt = paddle.optimizer.Adam(sched, parameters=model.parameters(),
                                **TRANSFORMER_ADAM)
    return ParallelTrainer(model, opt, transformer_loss(paddle),
                           strategy=strategy, n_inputs=2,
                           fused_steps=fused_steps)


def lstm_lm_model(paddle, vocab_size, hidden_size, num_layers, dropout,
                  init_scale):
    """Zaremba's PTB language model: embedding, dropout, ``nn.LSTM``
    (dropout between its layers), dropout, the softmax projection; every
    weight and bias ``Uniform(+-init_scale)`` through ``ParamAttr``.
    ``model(ids)`` -> logits ``[B, T, V]``, the state zeroed."""
    nn = paddle.nn

    def attr():
        return paddle.ParamAttr(initializer=nn.initializer.Uniform(
            -init_scale, init_scale))

    class PTBLanguageModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.config = dict(vocab_size=vocab_size,
                               hidden_size=hidden_size,
                               num_layers=num_layers)
            self.embedding = nn.Embedding(vocab_size, hidden_size,
                                          weight_attr=attr())
            self.lstm = nn.LSTM(hidden_size, hidden_size, num_layers,
                                dropout=dropout, weight_ih_attr=attr(),
                                weight_hh_attr=attr(), bias_ih_attr=attr(),
                                bias_hh_attr=attr())
            self.dropout = nn.Dropout(dropout)
            self.out = nn.Linear(hidden_size, vocab_size, attr(), attr())

        def forward(self, ids):
            y, _ = self.lstm(self.dropout(self.embedding(ids)))
            return self.out(self.dropout(y))

    return PTBLanguageModel()


def lstm_lm_loss(paddle):
    """PaddlePaddle ``ptb_lm``'s loss: per-word cross entropy, the mean
    over the batch, summed over the unrolled steps."""
    F = paddle.nn.functional

    def loss(logits, labels):
        per = F.cross_entropy(logits, labels, reduction='none')
        return paddle.sum(paddle.mean(per, axis=0))
    return loss


def lstm_lm_batch(batch, steps, vocab, seed=0):
    """Seeded word ids ``[batch, steps + 1]``: inputs and next words."""
    ids = np.random.RandomState(seed).randint(
        0, vocab, (batch, steps + 1)).astype(np.int64)
    return ids[:, :-1].copy(), ids[:, 1:].copy()


def lstm_lm_trainer(paddle, model, fused_steps=None):
    """SGD lr 1 with ``ClipGradByGlobalNorm(10)``, f32."""
    from paddle_tpu_torch.parallel import ParallelTrainer
    opt = paddle.optimizer.SGD(
        LSTM_LM_LR, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(LSTM_LM_CLIP))
    return ParallelTrainer(model, opt, lstm_lm_loss(paddle),
                           fused_steps=fused_steps)


def transformer_beam_cell(paddle, model):
    """The decoder as a ``BeamSearchDecoder`` cell over its caches:
    ``cell(ids [N], caches, memory_mask=)`` embeds the ids at the
    position the self-attention cache has reached, runs the decoder
    one step and returns the logits and the grown caches."""
    def cell(ids, caches, memory_mask=None):
        t = caches[0][0].k.shape[2]
        x = model.embed(paddle.unsqueeze(ids, [1]), offset=t)
        h, caches = model.transformer.decoder(x, None, None, memory_mask,
                                              caches)
        return model.logits(h[:, -1]), caches
    return cell


def transformer_prefix_cell(paddle, model, memory):
    """The decoder without caches: the state is every id so far ``[N,
    t]``, and each step runs the decoder over the whole prefix
    (``memory`` tiled to the beams)."""
    def cell(ids, prefix, memory_mask=None):
        prefix = paddle.concat([prefix, paddle.unsqueeze(ids, [1])], axis=1)
        t = prefix.shape[1]
        h = model.transformer.decoder(model.embed(prefix), memory,
                                      model.causal[:t, :t], memory_mask)
        return model.logits(h[:, -1]), prefix
    return cell


def beam_decode(paddle, model, src, max_step_num, cached=True, record=None):
    """Beam search (``BEAM_SIZE``, ``BOS`` to ``EOS``) over ``src`` with
    the decoder's caches (``gen_cache``: ``Cache`` for self-attention,
    ``StaticCache`` for cross-attention), or without (``cached=False``);
    returns ``dynamic_decode``'s ids ``[B, T, beam]``.  ``record``, a
    list, gets each step's ``(predicted_ids, parent_ids)``."""
    nn = paddle.nn
    K = BEAM_SIZE
    tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
    src_mask = model.source_mask(src)
    memory = model.transformer.encoder(model.embed(src), src_mask)
    if cached:
        cell = transformer_beam_cell(paddle, model)
        inits = model.transformer.decoder.gen_cache(memory)
    else:
        cell = transformer_prefix_cell(paddle, model, tile(memory, K))
        inits = src[:, :0]

    class Recording(nn.BeamSearchDecoder):
        def step(self, time, inputs, states, **kwargs):
            out = super().step(time, inputs, states, **kwargs)
            if record is not None:
                record.append((out[0].predicted_ids, out[0].parent_ids))
            return out

    dec = Recording(cell, BOS, EOS, K)
    ids, _ = nn.dynamic_decode(dec, inits=inits, max_step_num=max_step_num,
                               memory_mask=tile(src_mask, K))
    return ids


def _seq_model(build, dev):
    """A sequence model seeded at 0 on the CPU, moved to ``dev``: the
    same weights on either side of a card-vs-CPU check."""
    import paddle_tpu_torch as paddle
    paddle.seed(0)
    paddle.set_device('cpu')
    try:
        model = build(paddle)
    finally:
        paddle.set_device(None)
    return model.to(dev)


def transformer_step_flops(cfg, n_params, batch, src, tgt):
    """(model flops of one Transformer training step, its attention
    part): 6 x parameters x tokens, the encoder's parameters over the
    source tokens, the decoder's and the shared embedding's (the
    projection) over the target tokens, plus attention at 12 x d_model
    per (query, key) pair per layer (4 forward, 8 backward): the
    encoder's and the cross-attention's full, the decoder's causal."""
    d, L, ff, V = (cfg['d_model'], cfg['num_layers'],
                   cfg['dim_feedforward'], cfg['vocab_size'])
    enc = L * (4 * d * d + 2 * d * ff)
    dec = L * (8 * d * d + 2 * d * ff)
    dense = 6 * batch * (enc * src + (dec + V * d) * tgt)
    pairs = src * src + tgt * src + attention_pairs(tgt, tgt, True)
    attn = 12 * d * pairs * batch * L
    return dense + attn, attn


def transformer_phase():
    """Transformer-base (``nn.Transformer()``) trained through
    ``ParallelTrainer.step`` at bf16 O2: the LayerNorm kernel 30 times a
    step and no other; then one f32 step at B 2 against the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import _build
    paddle.seed(0)
    model = transformer_model(paddle, **TRANSFORMER_KW)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f'transformer model: nn.Transformer() (d_model {cfg["d_model"]}, '
        f'{cfg["nhead"]} heads, {cfg["num_layers"]} + '
        f'{cfg["num_layers"]} layers, FFN {cfg["dim_feedforward"]}, '
        f'dropout {TRANSFORMER_KW["dropout"]}), shared vocabulary '
        f'{cfg["vocab_size"]}, {n_params} parameters, seed 0; B '
        f'{TRANSFORMER_BATCH}, source {TRANSFORMER_SRC}, target '
        f'{TRANSFORMER_TGT}, bf16 O2, Adam 0.9/0.98/1e-9 under '
        f'NoamDecay(512, {TRANSFORMER_WARMUP}), label smoothing '
        f'{TRANSFORMER_LS}')
    trainer = transformer_trainer(paddle, model, amp_o2=True)
    batch = transformer_batch(TRANSFORMER_BATCH, TRANSFORMER_SRC,
                              TRANSFORMER_TGT, cfg['vocab_size'])
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, batch, TRAIN_WARMUP, TRAIN_STEPS)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = _per_step(cfg['num_layers'], LN_PER_TRANSFORMER_FORWARD)
    # Noam's rate over the first steps is ~1e-7: the loss need not fall
    _check_run('transformer', losses, launches, per_step, steps,
               falls=False)
    tokens = TRANSFORMER_BATCH * TRANSFORMER_TGT
    ms_step = dt / TRAIN_STEPS * 1e3
    flops, attn = transformer_step_flops(cfg, n_params, TRANSFORMER_BATCH,
                                         TRANSFORMER_SRC, TRANSFORMER_TGT)
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'transformer: losses {", ".join(f"{x:.4f}" for x in losses)} '
        f'(finite); launches {_launch_summary(launches, per_step, steps)}'
        f'; no softmax, flash or GEMM+GELU launch')
    log(f'transformer: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; '
        f'{TRAIN_STEPS} steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{tokens * TRAIN_STEPS / dt:.0f} target tokens/s; peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; MFU {mfu:.4f} = '
        f'{flops:.4g} flops ({attn:.4g} attention) / (step time * 989e12)')
    summary = {'ms_per_step': ms_step,
               'target_tokens_per_s': tokens * TRAIN_STEPS / dt,
               'peak_bytes': peak, 'mfu': mfu, 'losses': losses,
               'warmup_s': warm_s, 'launches': launches}
    del model, trainer
    _free()
    kw = dict(TRANSFORMER_KW, dropout=0.0)
    summary['parity'] = _card_vs_cpu(
        f'transformer B {SEQ_PARITY_BATCH}, dropout 0',
        lambda dev: _seq_model(lambda p: transformer_model(p, **kw), dev),
        lambda cfg: transformer_batch(SEQ_PARITY_BATCH, TRANSFORMER_SRC,
                                      TRANSFORMER_TGT, cfg['vocab_size'],
                                      seed=1),
        per_step, make_trainer=lambda m: transformer_trainer(
            paddle, m, amp_o2=False), zero_grads=('k_proj.bias',))
    _build.reset_launches()
    return summary


def transformer_fused_phase():
    """The transformer configuration through ``step_fused`` (K 5)
    against eager steps, parameters and Adam's moments bit for bit."""
    import paddle_tpu_torch as paddle
    cfg = dict(TRANSFORMER_KW)
    batch = transformer_batch(TRANSFORMER_BATCH, TRANSFORMER_SRC,
                              TRANSFORMER_TGT, cfg['vocab_size'])
    return _fused_vs_eager(
        f'transformer_fused (Transformer-base B {TRANSFORMER_BATCH}, '
        f'{TRANSFORMER_SRC} + {TRANSFORMER_TGT}, bf16 O2)',
        lambda: transformer_model(paddle, **cfg), batch, None,
        _per_step(cfg['num_layers'], LN_PER_TRANSFORMER_FORWARD),
        TRANSFORMER_BATCH * TRANSFORMER_TGT,
        lambda c, n: transformer_step_flops(
            c, n, TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT),
        with_opt_state=True,
        make_trainer=lambda m, fused_steps=None: transformer_trainer(
            paddle, m, amp_o2=True, fused_steps=fused_steps),
        falls=False)


def transformer_beam_phase():
    """Beam search over Transformer-base's decoder caches: B 8 sources
    of 128 ids, beam 4, 128 steps, f32, eval.  The first 16 steps' ids
    and parents equal a decoder without caches over the same weights;
    B 1 x 16 steps equal the CPU's; LayerNorm 12 launches for the
    encoder and 18 a step, no other kernel."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import _build
    kw = dict(TRANSFORMER_KW, dropout=0.0)
    model = _seq_model(lambda p: transformer_model(p, **kw), 'cuda').eval()
    src = torch.from_numpy(transformer_batch(
        BEAM_BATCH, TRANSFORMER_SRC, 1, kw['vocab_size'], seed=2)[0]).cuda()
    n_enc, n_step = 2 * kw['num_layers'], 3 * kw['num_layers']
    with torch.no_grad():
        beam_decode(paddle, model, src, 3)                  # warm-up
        record = []
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = beam_decode(paddle, model, src, BEAM_MAX_STEP, record=record)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        steps = len(record)
        want = _per_step(kw['num_layers'], n_enc + n_step * steps)
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(
                    f'transformer_beam: {name} launched {launches[name]} '
                    f'times in {steps} steps, expected {n}')
        # the profiler's trace of a shorter decode: the share per step is
        # the same, the trace's parse a quarter
        idle, prof_s = idle_share(lambda: beam_decode(
            paddle, model, src, BEAM_PROFILE_STEPS - 1))
        plain = []
        beam_decode(paddle, model, src, BEAM_CHECK_STEPS - 1, cached=False,
                    record=plain)
        for t, ((a_ids, a_par), (b_ids, b_par)) in enumerate(
                zip(record[:BEAM_CHECK_STEPS], plain)):
            if not (torch.equal(a_ids, b_ids) and torch.equal(a_par, b_par)):
                raise AssertionError(
                    f'transformer_beam: step {t}: cached ids/parents '
                    f'{a_ids.tolist()} / {a_par.tolist()} != without '
                    f'caches {b_ids.tolist()} / {b_par.tolist()}')
        if len(plain) != BEAM_CHECK_STEPS:
            raise AssertionError(f'transformer_beam: {len(plain)} steps '
                                 'without caches')
        one = beam_decode(paddle, model, src[:1], BEAM_CHECK_STEPS - 1)
        cpu_model = _seq_model(lambda p: transformer_model(p, **kw),
                               'cpu').eval()
        want_one = beam_decode(paddle, cpu_model, src[:1].cpu(),
                               BEAM_CHECK_STEPS - 1)
        if not torch.equal(one.cpu(), want_one):
            raise AssertionError(
                f'transformer_beam: B 1 x {BEAM_CHECK_STEPS} steps, card '
                f'{one[0, :, 0].tolist()} != CPU '
                f'{want_one[0, :, 0].tolist()}')
    tokens = BEAM_BATCH * BEAM_SIZE * steps
    log(f'transformer_beam: BeamSearchDecoder (beam {BEAM_SIZE}) + '
        f'dynamic_decode over gen_cache (Cache + StaticCache), B '
        f'{BEAM_BATCH} x source {TRANSFORMER_SRC}, {steps} steps '
        f'(max_step_num {BEAM_MAX_STEP}), f32: ids {tuple(ids.shape)}; '
        f'launches fused_layer_norm {launches["fused_layer_norm"]} = '
        f'{n_enc} + {n_step} x {steps} (exact), no other kernel; first '
        f'{BEAM_CHECK_STEPS} steps\' ids and parents == the decoder '
        f'without caches; B 1 x {BEAM_CHECK_STEPS} steps == the CPU\'s')
    log(f'transformer_beam: {dt:.3f} s = {dt / steps * 1e3:.2f} ms a '
        f'step, {tokens / dt:.0f} beam tokens/s ({BEAM_BATCH * steps / dt:.0f}'
        f' target tokens/s); idle share {idle:.4f} under the profiler '
        f'over {BEAM_PROFILE_STEPS} steps ({prof_s:.3f} s there)')
    out = {'steps': steps, 's': dt, 'ms_per_step': dt / steps * 1e3,
           'beam_tokens_per_s': tokens / dt,
           'target_tokens_per_s': BEAM_BATCH * steps / dt,
           'idle_share': idle, 'launches': launches}
    del model, cpu_model
    _free()
    return out


def _lstm_lm_trainer(fused_steps=None):
    import paddle_tpu_torch as paddle
    return lstm_lm_trainer(paddle, lstm_lm_model(paddle, **LSTM_LM_KW),
                           fused_steps=fused_steps)


def lstm_lm_step_flops(cfg, batch, steps):
    """6 x parameters x words: each word passes the embedding row (no
    flops, left out), both LSTM layers and the softmax projection."""
    H, L, V = cfg['hidden_size'], cfg['num_layers'], cfg['vocab_size']
    return 6 * (L * 8 * H * H + H * V) * batch * steps


def lstm_lm_phase():
    """Zaremba's large PTB LSTM LM trained through
    ``ParallelTrainer.step`` in f32 (no hand-written kernel), then one
    f32 step at B 2 against the CPU (dropout 0)."""
    import paddle_tpu_torch as paddle
    paddle.seed(0)
    trainer = _lstm_lm_trainer()
    cfg = trainer.model.config
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f'lstm_lm model: {cfg["num_layers"]} x {cfg["hidden_size"]} LSTM, '
        f'vocabulary {cfg["vocab_size"]}, dropout '
        f'{LSTM_LM_KW["dropout"]}, Uniform(+-{LSTM_LM_KW["init_scale"]}), '
        f'{n_params} parameters, seed 0; B {LSTM_LM_BATCH} x '
        f'{LSTM_LM_STEPS} steps, f32, SGD lr {LSTM_LM_LR}, global-norm '
        f'clip {LSTM_LM_CLIP}')
    batch = lstm_lm_batch(LSTM_LM_BATCH, LSTM_LM_STEPS, cfg['vocab_size'])
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, batch, TRAIN_WARMUP, TRAIN_STEPS)
    _check_losses('lstm_lm', losses)
    _no_kernel_launches('lstm_lm', launches)
    words = LSTM_LM_BATCH * LSTM_LM_STEPS
    ms_step = dt / TRAIN_STEPS * 1e3
    flops = lstm_lm_step_flops(cfg, LSTM_LM_BATCH, LSTM_LM_STEPS)
    log(f'lstm_lm: losses {", ".join(f"{x:.4f}" for x in losses)} '
        f'(finite, falling); no ported kernel launched')
    log(f'lstm_lm: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; '
        f'{TRAIN_STEPS} steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{words * TRAIN_STEPS / dt:.0f} words/s; peak '
        f'max_memory_allocated {peak / 2**30:.2f} GiB; '
        f'{flops / (ms_step / 1e3) / 1e12:.2f} TFLOP/s of f32 '
        f'({flops:.4g} flops a step)')
    summary = {'ms_per_step': ms_step,
               'words_per_s': words * TRAIN_STEPS / dt, 'peak_bytes': peak,
               'losses': losses, 'warmup_s': warm_s, 'launches': launches}
    del trainer
    _free()
    kw = dict(LSTM_LM_KW, dropout=0.0)
    summary['parity'] = _card_vs_cpu(
        f'lstm_lm B {SEQ_PARITY_BATCH}, dropout 0',
        lambda dev: _seq_model(lambda p: lstm_lm_model(p, **kw), dev),
        lambda cfg: lstm_lm_batch(SEQ_PARITY_BATCH, LSTM_LM_STEPS,
                                  cfg['vocab_size'], seed=1),
        _per_step(cfg['num_layers'], 0),
        make_trainer=lambda m: lstm_lm_trainer(paddle, m))
    return summary


def lstm_lm_fused_phase():
    """The lstm_lm configuration through ``step_fused`` (K 5) against
    eager steps bit for bit (``_graph_vs_eager``)."""
    cfg = dict(LSTM_LM_KW)
    batch = tuple(torch.from_numpy(b).cuda() for b in lstm_lm_batch(
        LSTM_LM_BATCH, LSTM_LM_STEPS, cfg['vocab_size']))
    return _graph_vs_eager(
        f'lstm_lm_fused (PTB large B {LSTM_LM_BATCH} x {LSTM_LM_STEPS}, '
        'f32)', _lstm_lm_trainer, batch, TRAIN_STEPS,
        LSTM_LM_BATCH * LSTM_LM_STEPS, 'words',
        lstm_lm_step_flops(cfg, LSTM_LM_BATCH, LSTM_LM_STEPS),
        'torch.use_deterministic_algorithms', _deterministic_algorithms)

def mnist_lenet(paddle, network=None, epochs=2, batch_size=64, limit=0,
                eval_split='test', shuffle=True, fused_steps=None,
                callbacks=None, verbose=0, before_fit=None):
    """``examples/mnist_lenet.py``'s program against ``paddle`` (either
    package): synthetic MNIST through ``Normalize(127.5, 127.5, 'HWC')``
    and ``Transpose((2, 0, 1))``, ``Model(LeNet())`` (or ``network``)
    prepared with Adam 1e-3, ``CrossEntropyLoss`` and ``Accuracy``,
    ``fit`` and ``evaluate`` on the ``eval_split`` split.  ``limit``
    keeps the first images of each split; ``before_fit(model)`` runs
    between ``prepare`` and ``fit``.  Returns ``(model, eval logs)``."""
    T = paddle.vision.transforms
    transform = T.Compose([T.Normalize(mean=[127.5], std=[127.5],
                                       data_format='HWC'),
                           T.Transpose((2, 0, 1))])
    train_ds = paddle.vision.datasets.MNIST(mode='train',
                                            transform=transform)
    test_ds = paddle.vision.datasets.MNIST(mode='test', transform=transform)
    if limit:
        train_ds = paddle.io.Subset(train_ds,
                                    range(min(limit, len(train_ds))))
        test_ds = paddle.io.Subset(test_ds, range(min(limit, len(test_ds))))
    model = paddle.Model(network if network is not None
                         else paddle.vision.models.LeNet())
    model.prepare(
        paddle.optimizer.Adam(learning_rate=1e-3,
                              parameters=model.parameters()),
        paddle.nn.CrossEntropyLoss(),
        paddle.metric.Accuracy())
    if before_fit is not None:
        before_fit(model)
    model.fit(train_ds, epochs=epochs, batch_size=batch_size,
              verbose=verbose, shuffle=shuffle, fused_steps=fused_steps,
              callbacks=callbacks)
    logs = model.evaluate(train_ds if eval_split == 'train' else test_ds,
                          batch_size=batch_size, verbose=0)
    return model, logs


def step_recorder(model):
    """Wrap ``model``'s ``train_batch`` and ``train_chunk`` so every
    step's loss (device tensors, read at the end) lands in the returned
    list, in order: ``torch.cat`` of it is the run's losses."""
    losses = []
    batch, chunk = model.train_batch, model.train_chunk

    def train_batch(*a, **kw):
        loss, logs = batch(*a, **kw)
        losses.append(loss.detach().reshape(1).clone())
        return loss, logs

    def train_chunk(*a, **kw):
        out, oks = chunk(*a, **kw)
        losses.append(out.detach().clone())
        return out, oks
    model.train_batch, model.train_chunk = train_batch, train_chunk
    return losses


def metric_logs(paddle):
    """A hapi callback of ``paddle`` that keeps each epoch's metric
    logs (``logs`` of ``on_epoch_end``, the loss left out)."""

    class MetricLogs(paddle.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.logs = []

        def on_epoch_end(self, epoch, logs=None):
            self.logs.append({k: v for k, v in (logs or {}).items()
                              if k != 'loss'})
    return MetricLogs()


def _hapi_params(model):
    return {k: v.detach().clone() for k, v in
            model.network.state_dict().items()}


def _hapi_lenet_fit(paddle, fused_steps):
    """The anchor's fit on the card from LeNet(seed 0), unshuffled so a
    fused run sees the eager run's batches; -> (model, eval logs, [n]
    losses, epoch metric logs, seconds of the fit)."""
    from paddle_tpu_torch.vision.models import LeNet
    cb = metric_logs(paddle)
    rec = {}

    def before_fit(model):
        rec['losses'] = step_recorder(model)
        rec['t0'] = time.perf_counter()
    model, logs = mnist_lenet(
        paddle, network=LeNet(device='cuda', seed=0),
        epochs=HAPI_LENET_EPOCHS, batch_size=HAPI_LENET_BATCH,
        limit=HAPI_LENET_N, eval_split='train', shuffle=False,
        fused_steps=fused_steps, callbacks=[cb], before_fit=before_fit)
    torch.cuda.synchronize()
    dt = time.perf_counter() - rec['t0']
    return model, logs, torch.cat(rec['losses']), cb.logs, dt


def _hapi_vs_cpu(paddle):
    """Three ``train_batch`` steps of one LeNet on the card and on the
    CPU: the largest gap of each loss and each tensor, over its largest
    value."""
    from paddle_tpu_torch.vision.models import LeNet
    batches = _lenet_train_batches(3)
    out = {}
    for dev in ('cuda', 'cpu'):
        net = LeNet(device=dev, seed=0)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                            parameters=model.parameters()),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        losses = [float(model.train_batch([x], [y])[0]) for x, y in batches]
        out[dev] = (losses, {k: v.detach().cpu() for k, v in
                             net.state_dict().items()})
    worst = max(abs(a - b) / max(abs(b), 1e-12)
                for a, b in zip(out['cuda'][0], out['cpu'][0]))
    for k, v in out['cpu'][1].items():
        worst = max(worst, float((out['cuda'][1][k] - v).abs().max())
                    / max(float(v.abs().max()), 1e-12))
    return worst, out['cuda'][0]


def _lenet_train_batches(n, batch=HAPI_LENET_BATCH, seed=0):
    """``n`` seeded MNIST-shaped batches: (x f32 NCHW, y int64 [B, 1])."""
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 1, 28, 28).astype(np.float32),
             rs.randint(0, 10, (batch, 1)).astype(np.int64))
            for _ in range(n)]


def _hapi_resume(paddle, workdir):
    """Save a Model after 3 steps, load it into a fresh one, step both:
    the resumed step must equal the uninterrupted one bit for bit."""
    from paddle_tpu_torch.vision.models import LeNet
    batches = _lenet_train_batches(4, seed=1)

    def fresh():
        net = LeNet(device='cuda', seed=0)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                            parameters=model.parameters()),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        return model
    a = fresh()
    for x, y in batches[:3]:
        a.train_batch([x], [y])
    path = f'{workdir}/lenet'
    a.save(path)
    b = fresh().load(path)
    x, y = batches[3]
    la, lb = a.train_batch([x], [y])[0], b.train_batch([x], [y])[0]
    pa, pb = _hapi_params(a), _hapi_params(b)
    same = bool(torch.equal(la, lb)) and all(
        torch.equal(pa[k], pb[k]) for k in pa) and all(
        torch.equal(u, w) for (_, u), (_, w) in zip(
            sorted(a._optimizer.state_dict().items()),
            sorted(b._optimizer.state_dict().items()))
        if torch.is_tensor(u))
    if not same or a._optimizer._global_step != b._optimizer._global_step:
        raise AssertionError('hapi_lenet: the resumed step is not the '
                             'uninterrupted one')
    return float(la)


def _hapi_host_cost(paddle):
    """bench.py's LeNet configuration (f32 B 256, Adam 1e-3) through
    ``Model.train_batch`` and through the bare ``ParallelTrainer`` on
    the same batch, in turns: ms/step of each."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    (x, y), = _lenet_train_batches(1, batch=LENET_BATCH, seed=2)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    net = LeNet(device='cuda', seed=0)
    model = paddle.Model(net)
    model.prepare(Adam(learning_rate=LENET_LR,
                       parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    tnet = LeNet(device='cuda', seed=0)
    tr = _vision_trainer(tnet, Adam(learning_rate=LENET_LR,
                                    parameters=tnet.parameters()),
                         amp_o2=False)
    runs = {'hapi': lambda: model.train_batch([xd], [yd]),
            'trainer': lambda: tr.step(xd, yd)}
    for fn in runs.values():
        for _ in range(LENET_WARMUP):
            fn()
    ms = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LENET_STEPS):
                fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / LENET_STEPS * 1e3)
    return {name: min(v) for name, v in ms.items()}


def hapi_lenet_phase(trainer_ms=None):
    """``examples/mnist_lenet.py``'s program on the card through
    ``hapi.Model`` (``hapi_lenet``): the eager fit to the reference's
    anchor, the same fit in fused chunks bit for bit, three steps
    against the CPU, save and resume bit for bit, and bench.py's LeNet
    batch through ``train_batch`` beside the bare trainer; no
    hand-written kernel may launch."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import _build
    _build.reset_launches()
    t_phase = time.perf_counter()
    # bit-for-bit comparisons take cuDNN's deterministic algorithms
    with _cudnn_deterministic():
        eager = _hapi_lenet_fit(paddle, None)
        fused = _hapi_lenet_fit(paddle, HAPI_LENET_K)
        with tempfile.TemporaryDirectory() as d:
            resumed = _hapi_resume(paddle, d)
    model, logs, losses, epochs, fit_s = eager
    acc = logs['acc']
    if not acc > HAPI_LENET_ACC:
        raise AssertionError(f'hapi_lenet: train-split accuracy {acc} '
                             f'after {HAPI_LENET_EPOCHS} epochs is not above '
                             f'{HAPI_LENET_ACC}')
    f_model, f_logs, f_losses, f_epochs, f_fit_s = fused
    pe, pf = _hapi_params(model), _hapi_params(f_model)
    steps = len(losses)
    if not (torch.equal(losses, f_losses) and all(
            torch.equal(pe[k], pf[k]) for k in pe)
            and epochs == f_epochs and logs == f_logs):
        raise AssertionError(
            'hapi_lenet: fused fit differs from the eager fit: losses '
            f'{(losses - f_losses).abs().max().item()}, params '
            f'{max((pe[k] - pf[k]).abs().max().item() for k in pe)}, '
            f'logs {epochs[-1]} vs {f_epochs[-1]}, eval {logs} vs '
            f'{f_logs}')
    if f_model.chunk_syncs != steps // HAPI_LENET_K:
        raise AssertionError(f'hapi_lenet: {f_model.chunk_syncs} chunk '
                             f'reads for {steps // HAPI_LENET_K} chunks')
    graphs = list(f_model._fused_cache.modules.values())
    if len(graphs) != 1 or graphs[0].replays != steps - 1:
        raise AssertionError(
            f'hapi_lenet: {len(graphs)} captured steps with '
            f'{[g.replays for g in graphs]} replays; want one graph '
            f'replayed {steps - 1} times (the first step is its warm-up)')
    capture_s, syncs = graphs[0].capture_s, f_model.chunk_syncs
    cpu_gap, _ = _hapi_vs_cpu(paddle)
    if not cpu_gap <= HAPI_LENET_TOL:
        raise AssertionError(f'hapi_lenet: card vs CPU {cpu_gap} > '
                             f'{HAPI_LENET_TOL}')
    cost = _hapi_host_cost(paddle)
    launches = launch_counts()
    _no_kernel_launches('hapi_lenet', launches)
    phase_s = time.perf_counter() - t_phase
    log(f'hapi_lenet: mnist_lenet program, {HAPI_LENET_N} synthetic MNIST '
        f'images, B {HAPI_LENET_BATCH}, {HAPI_LENET_EPOCHS} epochs = {steps} '
        f'steps: eager fit {fit_s:.3f} s ({fit_s / steps * 1e3:.3f} ms/step '
        f'with the loader), loss {float(losses[0]):.4f} -> '
        f'{float(losses[-1]):.4f}, train-split acc {acc:.4f} (> '
        f'{HAPI_LENET_ACC}); fused K {HAPI_LENET_K}: {f_fit_s:.3f} s, one '
        f'step graph (capture {capture_s:.3f} s, {steps - 1} replays), '
        f'{syncs} chunk reads, losses, parameters and metric logs equal to '
        f'eager bit for bit; card vs CPU 3 steps {cpu_gap:.3g} '
        f'(<= {HAPI_LENET_TOL}); saved and resumed step equal bit for bit '
        f'(loss {resumed:.4f}); bench LeNet B {LENET_BATCH}: train_batch '
        f'{cost["hapi"]:.3f} ms/step vs ParallelTrainer.step '
        f'{cost["trainer"]:.3f} (lenet phase {trainer_ms}); no ported '
        f'kernel launched; phase {phase_s:.1f} s')
    del model, f_model, graphs, eager, fused
    _free()
    return {'acc': acc, 'steps': steps, 'eager_fit_s': fit_s,
            'fused_fit_s': f_fit_s, 'fused_k': HAPI_LENET_K,
            'chunk_syncs': syncs, 'capture_s': capture_s,
            'card_vs_cpu': cpu_gap,
            'hapi_ms_per_step': cost['hapi'],
            'trainer_ms_per_step': cost['trainer'],
            'lenet_phase_ms_per_step': trainer_ms,
            'phase_s': phase_s, 'launches': launches}


def flowers_loader(paddle, batch_size, num_workers, device_prefetch=True):
    """The Paddle tutorial's Flowers-102 input pipeline against
    ``paddle``: the synthetic train split through
    ``RandomResizedCrop(224)``, ``RandomHorizontalFlip()``,
    ``Normalize(127.5, 127.5, 'HWC')`` and ``Transpose((2, 0, 1))``, in
    a shuffled ``DataLoader`` of OS-process workers that stages each
    batch on the device ahead of the step."""
    T = paddle.vision.transforms
    transform = T.Compose([
        T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
        T.Normalize(mean=[127.5] * 3, std=[127.5] * 3, data_format='HWC'),
        T.Transpose((2, 0, 1))])
    ds = paddle.vision.datasets.Flowers(mode='train', transform=transform)
    return paddle.io.DataLoader(
        ds, batch_size=batch_size, shuffle=True, drop_last=True,
        num_workers=num_workers, use_process_workers=True,
        device_prefetch=device_prefetch)


class _CheckedLoader:
    """A loader whose first ``n`` batches are cloned on the consumer's
    stream as they are handed out, beside a host copy of each taken as
    the staging thread starts its copy to the card: a batch read on the
    consumer's stream before its side-stream copy finished would show
    as a difference."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n
        self.num_workers = loader.num_workers
        self.host, self.seen, self.staged = [], [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        from paddle_tpu_torch.io import DataLoader
        put = DataLoader._device_put_batch
        host = self.host

        def recording(item, device):
            if len(host) < self.n:
                host.append([x.clone() for x in item])
            return put(item, device)
        DataLoader._device_put_batch = staticmethod(recording)
        try:
            for i, batch in enumerate(self.loader):
                if i < self.n:
                    self.seen.append([x.clone() for x in batch])
                self.staged.append([x.clone() for x in batch])
                yield batch
        finally:
            DataLoader._device_put_batch = staticmethod(put)


def hapi_flowers_phase():
    """The Paddle tutorial's ResNet-50 on Flowers-102 through
    ``hapi.Model`` (``hapi_flowers``): f32 NCHW, B 64, one epoch of the
    synthetic train split through process workers, the native ring and
    ``device_prefetch``: images/s, ms/step, the prefetch wait a step and
    the idle share (the device's busy time a step from four steps under
    the profiler, over the epoch's wall, and the four steps' own); then
    the same steps on batches already on the card; no hand-written
    kernel may launch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.io import default_collate_fn, native
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.vision.models import resnet50
    _build.reset_launches()
    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError(f'hapi_flowers: the native ring did not build: '
                             f'{native._lib_err!r}')
    net = resnet50(num_classes=102, device='cuda', seed=0)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                            parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    B, W = HAPI_FLOWERS_BATCH, HAPI_FLOWERS_WORKERS
    loader = flowers_loader(paddle, B, W)
    steps = len(loader)
    if steps < HAPI_FLOWERS_WINDOW[1]:
        raise AssertionError(f'hapi_flowers: {steps} steps cannot hold the '
                             f'profiled window {HAPI_FLOWERS_WINDOW}')
    build_s = time.perf_counter() - t_phase
    # warm-up on batches made in this process (cuDNN's first calls)
    t0 = time.perf_counter()
    ds = loader.dataset
    for i in range(HAPI_FLOWERS_WARMUP):
        x, y = default_collate_fn([ds[j] for j in range(i * B, i * B + B)])
        model.train_batch([x], [y])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    rec = telemetry.get_recorder()

    def counters():
        c = rec.snapshot()['counters']
        return (c.get('io.device_prefetch.wait_s', 0.0),
                native.batches_carried())
    checked = _CheckedLoader(loader, HAPI_FLOWERS_CHECKED)
    wait0, ring0 = counters()
    losses = []

    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}

    class Steps(paddle.hapi.callbacks.Callback):
        """The losses, and the device's activity over steps
        HAPI_FLOWERS_WINDOW of the epoch (the steady state: the workers
        are up) for the idle share."""

        def on_train_batch_begin(self, step, logs=None):
            if step == HAPI_FLOWERS_WINDOW[0]:
                torch.cuda.synchronize()
                prof.start()
                window['t0'] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            losses.append(logs['loss'])
            if step == HAPI_FLOWERS_WINDOW[1] - 1:
                torch.cuda.synchronize()
                window['wall_us'] = (time.perf_counter() - window['t0']) \
                    * 1e6
                prof.stop()
    # one epoch: its wall gives images/s and ms/step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(checked, epochs=1, verbose=0, callbacks=[Steps()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_us = device_busy_us(prof)
    idle = 1.0 - busy_us / window['wall_us']
    copy_us, top = device_time_by_name(prof)
    # every step does the same device work, so the window's busy time a
    # step, over the epoch's wall, is the epoch's busy share
    n_window = HAPI_FLOWERS_WINDOW[1] - HAPI_FLOWERS_WINDOW[0]
    epoch_idle = 1.0 - busy_us / n_window * steps / (wall * 1e6)
    wait1, ring1 = counters()
    if ring1 - ring0 < steps:
        raise AssertionError(f'hapi_flowers: the native ring carried '
                             f'{ring1 - ring0} batches of the {steps}')
    for i, (h, d) in enumerate(zip(checked.host, checked.seen)):
        for a, b in zip(h, d):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f'hapi_flowers: staged batch {i} is '
                                     'not its host batch')
    if len(checked.seen) != HAPI_FLOWERS_CHECKED:
        raise AssertionError('hapi_flowers: too few batches checked')
    losses = [float(v) for v in losses]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'hapi_flowers: losses {losses}')
    wait_ms = (wait1 - wait0) / steps * 1e3
    # the same batches, already on the card: the step without the loader
    staged = checked.staged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in staged:
        model.train_batch([x], [y])
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    launches = launch_counts()
    _no_kernel_launches('hapi_flowers', launches)
    ips, dev_ips = steps * B / wall, len(staged) * B / dev_wall
    dev_ms = dev_wall / len(staged) * 1e3
    phase_s = time.perf_counter() - t_phase
    log(f'hapi_flowers: Model(resnet50(num_classes=102)) f32 NCHW, B {B}, '
        f'synthetic Flowers train split through RandomResizedCrop(224), '
        f'{W} process workers, the native ring and device_prefetch: one '
        f'epoch of {steps} steps in {wall:.3f} s = '
        f'{wall / steps * 1e3:.2f} ms/step, {ips:.1f} images/s, prefetch '
        f'wait {wait_ms:.2f} ms a step, idle share {epoch_idle:.3f} over '
        f'the epoch (the device busy {busy_us / n_window / 1e3:.1f} ms a '
        f'step) and {idle:.3f} over steps {HAPI_FLOWERS_WINDOW[0]}-'
        f'{HAPI_FLOWERS_WINDOW[1] - 1} under the profiler (busy '
        f'{busy_us / 1e3:.1f} of {window["wall_us"] / 1e3:.1f} ms, copies '
        f'{copy_us / 1e3:.1f} ms, top kernels '
        f'{[(n[:40], round(us / 1e3, 1)) for n, us in top]}); the same '
        f'steps on batches already on the card {dev_ms:.2f} ms/step, '
        f'{dev_ips:.1f} images/s; loss {losses[0]:.4f} -> '
        f'{losses[-1]:.4f}; the ring carried {ring1 - ring0} batches; '
        f'{HAPI_FLOWERS_CHECKED} staged batches equal to their host copies; '
        f'no ported kernel launched; phase {phase_s:.1f} s (model '
        f'{build_s:.1f} s, {HAPI_FLOWERS_WARMUP} warm-up steps '
        f'{warmup_s:.1f} s)')
    del model, net, checked, staged
    _free()
    return {'workers': W, 'batch': B, 'steps': steps,
            'ms_per_step': wall / steps * 1e3, 'images_per_s': ips,
            'prefetch_wait_ms_per_step': wait_ms,
            'idle_share': epoch_idle, 'window_idle_share': idle,
            'window_busy_ms': busy_us / 1e3,
            'window_wall_ms': window['wall_us'] / 1e3,
            'window_copy_ms': copy_us / 1e3,
            'device_fed_ms_per_step': dev_ms,
            'device_fed_images_per_s': dev_ips,
            'ring_batches': ring1 - ring0, 'phase_s': phase_s,
            'model_s': build_s, 'warmup_s': warmup_s,
            'launches': launches}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.ops import _build
    for mod in ('flash_attention', 'fused_softmax', 'fused_gelu_linear'):
        _ops_module(mod)                                # registers
    name = device_phase()
    _, resources = build_phase()
    timings = kernel_phase()
    timings.update(flash_kernel_phase())
    timings.update(softmax_kernel_phase())
    timings.update(gelu_kernel_phase())
    serve_launches, serve, f32_streams = serving_phase()
    frontdoor_launches, frontdoor = frontdoor_phase(f32_streams, serve)
    fleet_launches, fleet = fleet_phase()
    serve_quant = {mode: serve_quant_phase(mode, f32_streams)
                   for mode in ('int8', 'int4')}
    train = training_phase()
    gpt_fused = gpt_fused_phase()
    gpt_recipe = gpt_recipe_phase(gpt_fused['ms_per_step'])
    gpt_dropout = gpt_dropout_phase()
    gpt_f16 = gpt_f16_phase()
    bert = bert_phase()
    bert_fused = bert_fused_phase()
    resnet = resnet_phase()
    resnet_parity = resnet_parity_phase()
    lenet = lenet_phase()
    hapi_lenet = hapi_lenet_phase(lenet['ms_per_step'])
    hapi_flowers = hapi_flowers_phase()
    widedeep = widedeep_phase()
    longctx = longctx_phase()
    gptgen = gptgen_phase()
    ernie = ernie_phase()
    zoo = vision_zoo_phase()
    optimizers = optimizers_phase()
    moe = moe_phase()
    moe_gen = moe_gen_phase()
    qat = qat_phase(resnet['ms_per_step'])
    transformer = transformer_phase()
    transformer_fused = transformer_fused_phase()
    transformer_beam = transformer_beam_phase()
    lstm_lm = lstm_lm_phase()
    lstm_lm_fused = lstm_lm_fused_phase()
    log(json.dumps({'serve': serve, 'frontdoor': frontdoor,
                    'fleet': fleet,
                    **{f'serve_{m}': r[1] for m, r in serve_quant.items()},
                    'train': train, 'gpt_fused': gpt_fused,
                    'gpt_recipe': gpt_recipe,
                    'gpt_dropout': gpt_dropout, 'gpt_f16': gpt_f16,
                    'bert': bert, 'bert_dropout_fused': bert_fused,
                    'resnet': resnet, 'resnet_parity': resnet_parity,
                    'lenet': lenet, 'hapi_lenet': hapi_lenet,
                    'hapi_flowers': hapi_flowers, 'widedeep': widedeep,
                    'longctx': longctx, 'gptgen': gptgen, 'ernie': ernie,
                    'vision_zoo': zoo, 'optimizers': optimizers,
                    'moe': moe, 'moe_gen': moe_gen, 'qat': qat,
                    'transformer': transformer,
                    'transformer_fused': transformer_fused,
                    'transformer_beam': transformer_beam,
                    'lstm_lm': lstm_lm, 'lstm_lm_fused': lstm_lm_fused}))
    # 'serve', 'frontdoor', 'fleet', 'serve_int8', 'serve_int4',
    # 'gptgen', 'gpt_fused',
    # 'gpt_recipe', 'bert_dropout_fused', 'resnet_fused',
    # 'widedeep_fused', 'longctx_fused', 'mobilenet_v2_fused',
    # 'moe_fused', 'moe_gen', 'qat_fused', 'transformer_fused',
    # 'lstm_lm_fused' and half of 'optimizers' replay CUDA graphs
    paths = {'serve': serve_launches,
             # the door's run in this process; the fleet's in its
             # replicas, read from each worker's metrics plane
             'frontdoor': frontdoor_launches, 'fleet': fleet_launches,
             **{f'serve_{m}': r[0] for m, r in serve_quant.items()},
             'train': train['launches'],
             'gpt_fused': gpt_fused['launches'],
             'gpt_recipe': gpt_recipe['launches'],
             'gpt_dropout': gpt_dropout['launches'],
             'gpt_f16': gpt_f16['launches'],
             **{run: bert[run]['launches'] for run, *_ in BERT_RUNS},
             'bert_dropout_fused': bert_fused['launches'],
             # the vision and Wide&Deep paths launch none of the eight
             # (checked there)
             'resnet': resnet['launches'],
             'resnet_fused': resnet['fused']['launches'],
             **{f'resnet_parity_{name}': r['launches']
                for name, r in resnet_parity.items()},
             'lenet': lenet['launches'],
             # hapi over LeNet and ResNet-50 launches none (checked there)
             'hapi_lenet': hapi_lenet['launches'],
             'hapi_flowers': hapi_flowers['launches'],
             'widedeep': widedeep['launches'],
             'widedeep_fused': widedeep['fused']['launches'],
             'deepfm': widedeep['deepfm']['launches'],
             'longctx': longctx['launches'],
             'longctx_fused': longctx['fused']['launches'],
             'gptgen': gptgen['launches'],
             'ernie': ernie['launches'],
             **{name: r['launches'] for name, r in zoo.items()},
             'mobilenet_v2_fused': zoo['mobilenet_v2']['fused']['launches'],
             'optimizers': optimizers['launches'],
             'moe': moe['launches'], 'moe_fused': moe['fused']['launches'],
             'moe_gen': moe_gen['launches'], 'qat': qat['launches'],
             'qat_fused': qat['fused']['launches'],
             # the sequence models: LayerNorm only, on the Transformer's
             # paths; none on the LSTM's (checked there)
             'transformer': transformer['launches'],
             'transformer_fused': transformer_fused['launches'],
             'transformer_beam': transformer_beam['launches'],
             'lstm_lm': lstm_lm['launches'],
             'lstm_lm_fused': lstm_lm_fused['launches']}
    kernels = []
    for k in _build.KERNELS:
        rows = timings[k.name]
        # the first row is the main path's shape: LayerNorm the decode
        # shape (most launches), flash GPT training, softmax and
        # GEMM+GELU BERT-base training
        head = rows[0]
        by_path = {p: launches[k.name] for p, launches in paths.items()}
        by_design = {v: sum(launches[f'{k.name}:{v}']
                            for launches in paths.values())
                     for v in k.variant_launches}
        kernels.append({
            'name': k.name, 'route': k.route, 'source': k.source_path,
            'replaces': k.replaces, 'launches': sum(by_path.values()),
            'launches_by_path': by_path,
            **({'launches_by_design': by_design} if by_design else {}),
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': head['ms'], 'kernel_ms': head['ms'],
            'cold_ms': head['cold_ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'bound_share_cold': head['bound_ms'] / head['cold_ms'],
            'library_ms': head['library_ms'],
            'library_ms_range': head['library_ms_range'],
            'ms_from': head['ms_from'], 'call_ms': head['call_ms'],
            'resources': resources.get(k.source, {}),
            'shapes': rows})
        if k.name == 'fused_softmax_masked':
            kernels[-1]['launched_in'] = (
                'the kernel comparison only, through the public '
                'ops.fused_softmax(x, mask): no model path passes a mask, '
                'as in the reference')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
