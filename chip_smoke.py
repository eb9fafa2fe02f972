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
   row of 1024, at a ragged row of 200 and at DDPM's U-Net attention
   rows (128 x 256 x 256 and 128 x 16 x 16, f32; the ``vec`` design), at
   rows of 199 (``scalar``) and of 4096 (``block``); the masked softmax
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
   then deploying a model (``jit_deploy``): ``bert_base`` at the bench's
   width (T 128) and 4 of its layers in f32 and eval mode, B 64 eagerly
   and through ``jit.to_static`` (one CUDA graph: equal bit for bit,
   LayerNorm 10 and flash forward 4 a replay, ms per forward of each);
   ``jit.save`` of it and of its encoder with an additive mask, batch
   ``None`` (the export seconds and the files' bytes, into a temporary
   directory outside the tree); a fresh process that imports only
   ``paddle_tpu_torch.inference`` (``paddle_tpu_torch.models.bert`` must
   stay unloaded) serving both artifacts through ``create_predictor`` at
   B 1, 8 and 64: every forward exactly 26 LayerNorm + 12 flash
   launches (25 + 12 softmax masked), the outputs within 1e-5 of the
   largest of the eager model's (bit-equality printed), ms per forward
   at B 64; the reference's greedy decoder, a tensor ``if`` and a
   Python ``if`` under ``to_static`` on the card equal to eager, each
   signature's mode printed (the tensor predicates read on the host:
   eager; the Python one: a graph); and ``batch(reader.shuffle(
   dataset.mnist.train(), 1024), 64)`` feeding LeNet through 16
   ``ParallelTrainer`` steps, finite and falling, no kernel launched;
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
   counts; the CPU's runs go on in child processes (``chip_smoke.py
   --optimizers-cpu FILE SHARD SHARDS``) while the card's run;
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
   (``lstm_lm_fused``); then the tensor library (``tensor_lib``): every
   name of ``paddle_tpu_torch.tensor.__all__`` called on the card (each
   call recorded) against the same call on the CPU, the random ops by
   seed and by their laws, ``grad`` through gpt_small's training path
   bit for bit equal to ``backward()`` with exact launches, and the
   second order through one block against the CPU, each pass's
   launches exact (``tensor_lib_grad``, ``tensor_lib_second_order``);
   then the vision half of ``nn``, its two models built from the public
   layers by code the CPU tests run on both packages (``ddpm_unet``,
   ``dcgan_models``): DDPM's CIFAR-10 U-Net (``ddpm_unet``: Ho et al.
   2020 Appendix B, ch 128, multipliers (1, 2, 2, 2), 2 residual blocks
   a level, GroupNorm 32, attention at 16^2 and in the middle, dropout
   0.1, 35.7 M parameters; B 128 x 3 x 32^2 seeded synthetic images, t
   and the noise drawn on the host, T 1000, eps-prediction MSE, Adam
   2e-4 with a global-norm clip of 1, bf16 O2): 2 + 5 eager steps with
   finite, falling losses and the softmax kernel exactly 6 times a step
   on the design the wrapper names for rows of 256 and 16, ms/step,
   images/s, MFU, idle share and peak memory; ``step_fused`` K 5 against
   two eager trainers bit for bit (``ddpm_unet_fused``); an f32 step at
   B 8 against the CPU; DCGAN (``dcgan``: Radford et al. 2016, 5 x 5
   stride-2 ``Conv2DTranspose`` 1024 -> 3 at 64^2 and its mirrored
   discriminator, B 128, two eager Adam 2e-4 / 0.5 optimizers, D and G
   steps written as a user writes them): 2 + 5 iterations with finite
   losses, no hand-written kernel, ms an iteration and the idle share,
   an f32 iteration at B 8 against the CPU; and ``vision_ops``: every
   new name of ``nn.functional``, ``nn`` and ``nn.utils`` called on the
   card (each call recorded) against the CPU, forward and every input's
   gradient; after the fault-tolerance phases, the training strategies
   built the user's way (``fleet.init(strategy=s)``, then
   ``fleet.distributed_optimizer``, then ``ParallelTrainer``):
   ``strategy_recompute`` (the GPT cell with and without
   ``s.recompute``, eager and ``step_fused`` K 5, at dropout 0 on flash
   and 0.1 on the softmax kernel: 10 steps each, losses, every parameter
   and the port's generator bit-equal to the run without recompute and
   the replay bit-equal to eager, launches exact (LayerNorm 50 and flash
   forward 24 a step, softmax 24 at 0.1), and every block through
   ``fleet.utils.recompute``: ms/step and peak memory of the three),
   ``strategy_merge`` (B 32 in 4 merged micro-batches: launches exactly 4
   times the cell's, the first step bit-equal to a hand-written
   accumulation, ``step_fused`` equal to eager, a NaN in one micro-batch
   skipping the whole step under ``nan_guard``; ms/step, tokens/s and
   peak memory against B 8 and B 32 unmerged), ``strategy_lamb``
   (BERT-base pretraining under ``s.lamb``, merge 4 and recompute at
   dropout 0.1, bf16 O2: exact launches, a falling loss, the swapped
   ``Lamb`` on the scheduler passed in, a 2-layer f32 step against the
   CPU) and ``profiler`` (a ``start_profiler``/``stop_profiler(parse=
   True)`` window over 3 GPT steps whose parsed trace holds the flash
   and LayerNorm kernels and the ``RecordEvent`` and trainer ranges
   (busy time read only from a window holding every launch of those
   kernels), ``ParallelTrainer(profile=)`` windows closed by
   ``finish_profile``,
   and ``op_summary``, which launches nothing and leaves parameters,
   slots and the generator bit-equal);
12. prints one JSON line with the serving and training results, one
   listing every kernel (its launches on each path, each path's counts
   set to 0 just before it and read just after, and per design where a
   kernel has two; the paths ``serve``, ``frontdoor``, ``fleet`` (the
   replicas' counts), ``serve_int8``, ``serve_int4``,
   ``gptgen``, ``gpt_fused``, ``gpt_recipe``,
   ``bert_dropout_fused``, ``resnet_fused``, ``widedeep_fused``,
   ``longctx_fused``, ``mobilenet_v2_fused``, ``moe_fused``, ``moe_gen``,
   ``qat_fused``, ``transformer_fused``, ``lstm_lm_fused``,
   ``ddpm_unet_fused`` and ``jit_deploy_to_static`` replay graphs, ``optimizers`` half its
   steps, ``jit_deploy_predictor`` and ``jit_deploy_masked`` are the
   fresh process's forwards, counted there; the vision, hapi, reader,
   Wide&Deep, QAT, LSTM and DCGAN paths count 0 of each, the
   Transformer's LayerNorm only, the U-Net's softmax only; each strategy
   run is a path of its own, ``strategy_recompute_dropout_0.0_fused``
   and the merge's ``strategy_merge_fused`` replaying graphs),
   then as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero.  Without a
CUDA device it exits non-zero before printing any result.
"""
import contextlib
import functools
import json
import math
import os
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
    # DDPM's U-Net attention at B 128: 16^2 and the middle block's 4^2
    ('ddpm_16x16', (128, 256, 256), torch.float32, None, 'vec'),
    ('ddpm_4x4', (128, 16, 16), torch.float32, None, 'vec'),
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
# 256, 3 steps: (optimizer, its arguments, learning rate: the rules
# that normalise each element's step take the size of Adam's usual
# 3e-4, for at 1e-3 and above 4 steps move the random model far enough
# that the card's and the CPU's round-off part by more than 1e-3 of a
# tensor's max); each takes a
# clip, a regularizer (where its constructor takes weight_decay) and a
# scheduler in rotation, and DGC's ramp begins inside the run (step 1
# dense, 2 and 3 sparse at its two sparsities).  Card vs CPU, following _card_vs_cpu: each step's
# loss within 1e-4 relative, each parameter's max |diff| after the last
# within 1e-3 of its max |value|, except the attention's qkv.bias: the
# key slice's true gradient is exactly 0 and the query slice's is near
# it at a random init, so each device's is mostly round-off, which L1's
# sign, Adam's m / sqrt(v) and Lamb's trust ratio scale up to steps of
# up to lr; it is held to its bound, 2 * lr * steps
OPT_MODEL_KW = dict(num_layers=2, max_seq_len=256, dropout=0.0,
                    fused_head=True, fused_head_chunks=8)
OPT_SEQ, OPT_STEPS = 256, 4
# the CPU's runs: OPT_CPU_PROCS processes of OPT_CPU_THREADS threads each,
# while the card's run (their elementwise steps gain little from more
# threads, the processes run side by side)
OPT_CPU_PROCS, OPT_CPU_THREADS = 3, 2
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
# slice 17: deploying bert_base (bench.py:148-191's width, T 128) in f32;
# at 4 of its 12 layers since slice 21 (the export, the artifact's load
# and the Predictor's path are the same at any depth, and a third of
# the graph keeps the whole smoke inside its time limit on a slow host)
JIT_SEQ = 128
JIT_BATCHES = (1, 8, 64)
JIT_LAYERS = 4
JIT_MODEL_KW = dict(max_seq_len=JIT_SEQ, num_layers=JIT_LAYERS)
JIT_TOL = 1e-5          # of the largest |output| of the eager model's
JIT_TIMED = 10          # forwards timed at B 64, eager, graph, Predictor
JIT_LN = 1 + 2 * JIT_LAYERS + 1         # embeddings, 2 a layer, MLM head
JIT_LN_MASKED = 1 + 2 * JIT_LAYERS      # BertModel: no MLM head
JIT_READER_STEPS, JIT_READER_BATCH, JIT_READER_BUF = 16, 64, 1024
# the reference's greedy decoder (tests/test_dy2static.py:144-175)
DY2_V, DY2_H, DY2_EOS, DY2_MAXLEN = 16, 8, 0, 10


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
               'ParallelTrainer.optimizer', 'batch_norm', 'group_norm',
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
    fa = _ops_module('flash_attention')
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
              flash_design='mma', recompute=False, merge=1,
              ln_recomputed=None):
    """Launches per training step of every kernel, and of each design:
    every LayerNorm launch on ``'warp'`` (the models' widths are at most
    2048), every softmax launch on ``'vec'`` (fresh, aligned scores of
    128 or 1024 columns), all ``flash`` launches on ``flash_design``, all
    ``gelu`` launches on ``gelu_design``.  Under ``strategy.recompute``
    (``recompute``) every forward kernel runs twice (of the ``ln``
    LayerNorms only ``ln_recomputed`` again, when given: a per-block
    recompute leaves the final norm out), and under
    ``strategy.gradient_merge`` (``merge`` = k) the whole step's kernels
    run once a micro-batch."""
    fa = _ops_module('flash_attention')
    fgl = _ops_module('fused_gelu_linear')
    fn = _ops_module('fused_norm')
    fsm = _ops_module('fused_softmax')
    twice = 2 if recompute else 1
    ln = (ln + (ln * (twice - 1) if ln_recomputed is None
                else ln_recomputed)) * merge
    softmax *= twice * merge
    fwd_of = {'flash_attention_fwd': twice, 'fused_linear_gelu_fwd': twice}
    flash, gelu = flash * merge, gelu * merge
    return {'fused_layer_norm': ln,
            **{f'fused_layer_norm:{v}': ln if v == 'warp' else 0
               for v in fn.VARIANTS},
            'fused_softmax': softmax * L,
            **{f'fused_softmax:{v}': softmax * L if v == 'vec' else 0
               for v in fsm.VARIANTS},
            'fused_softmax_masked': 0,
            **{f'fused_softmax_masked:{v}': 0 for v in fsm.VARIANTS},
            **{k: flash * L * fwd_of.get(k, 1) for k in FLASH_KERNELS},
            **{f'{k}:{v}': flash * L * fwd_of.get(k, 1)
               if v == flash_design else 0
               for k in FLASH_KERNELS for v in fa.VARIANTS},
            **{k: gelu * L * fwd_of.get(k, 1) for k in GELU_KERNELS},
            **{f'{k}:{v}': gelu * L * fwd_of.get(k, 1)
               if v == gelu_design else 0
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
                    fallback_name, fallback, per_step=None):
    """``step_fused`` (K ``k``, 2 chunks) of ``make_trainer(fused_steps=
    k)`` against two eager trainers (``make_trainer()``), each built
    after ``paddle_tpu_torch.seed(0)``, on the same batch: losses,
    parameters and every buffer bit for bit.  Where the two eager
    trainers differ, all three run again under the context
    ``fallback()`` (``fallback_name`` in the log), and the run says so.
    ``items`` of ``unit`` a step; ``flops`` a step for the MFU.  The
    fused run launches no hand-written kernel, or with ``per_step``
    exactly that many of each a step."""
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
        if per_step is None:
            _no_kernel_launches(what, launches)
        else:
            _check_run(what, losses, launches, per_step, 2 * k)
        idle, prof_s = idle_share(lambda: tr.step_fused(*chunk))
    n_bufs = sum(1 for _ in tr.model.buffers() if _.is_floating_point())
    ms_step = dt / k * 1e3
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'{what}: step_fused K {k} == {2 * k} eager steps bit for bit'
        f' (losses, every parameter and all {n_bufs} float buffers; '
        f'eager vs eager equal too'
        + (f', under {fallback_name}' if deterministic else '')
        + f'); losses {", ".join(f"{v:.4f}" for v in losses)}; '
        + ('no ported kernel launched' if per_step is None else
           f'launches {_launch_summary(launches, per_step, 2 * k)}, a '
           f'replay {graph.launches.counts()}'))
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
                      use_global_stats=None, name=None, group=None):
    """The float64 witness's BatchNorm: batch statistics in the input's
    own dtype, two-pass (the port's keeps the reference's f32 statistics
    whatever the dtype); the running statistics stay as they are.  One
    process: ``group`` is None."""
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


def _optimizer_chunk():
    rs = np.random.RandomState(2)
    return rs.randint(0, 50304, (OPT_STEPS, 1, OPT_SEQ)).astype(np.int64)


def _optimizer_run(i, name, kw, lr_value, dev, fused, chunk):
    """OPT_STEPS guarded steps of ``gpt_small`` at OPT_MODEL_KW on
    ``dev`` under optimizer ``name``'s turn ``i``: (losses, parameters,
    steps taken, the turn's description), on the host."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.parallel import ParallelTrainer
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


def optimizers_cpu_main(path, shard, shards):
    """The CPU's side of ``optimizers_phase`` (``chip_smoke.py
    --optimizers-cpu FILE SHARD SHARDS``): the runs of the optimizers
    whose turn is SHARD modulo SHARDS, on the CPU, saved to ``FILE``
    with ``torch.save`` as ``{turn: run}``."""
    torch.set_num_threads(OPT_CPU_THREADS)
    chunk = _optimizer_chunk()
    runs = {i: _optimizer_run(i, name, kw, lr_value, 'cpu', False, chunk)
            for i, (name, kw, lr_value) in enumerate(OPTIMIZERS)
            if i % shards == shard}
    torch.save(runs, path)
    return 0


def optimizers_phase():
    """Every optimizer of the family on gpt_small's widths at 2 layers,
    f32: OPT_STEPS guarded steps on the card against the same on the
    CPU (child processes, ``optimizers_cpu_main``, while the card's
    run), and ``step_fused`` (K OPT_STEPS) on the card against the
    card's eager steps."""
    import tempfile

    from paddle_tpu_torch.ops import _build
    chunk = _optimizer_chunk()
    rows, t0 = [], time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='smoke_optimizers_')
    files = [os.path.join(tmp, f'cpu{k}.pt') for k in range(OPT_CPU_PROCS)]
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--optimizers-cpu',
         f, str(k), str(OPT_CPU_PROCS)],
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for k, f in enumerate(files)]
    try:
        _build.reset_launches()
        for i, (name, kw, lr_value) in enumerate(OPTIMIZERS):
            card = _optimizer_run(i, name, kw, lr_value, 'cuda', False,
                                  chunk)
            graph = _optimizer_run(i, name, kw, lr_value, 'cuda', True,
                                   chunk)
            rows.append((name, card, graph))
            _free()
        torch.cuda.synchronize()
        launches = launch_counts()
        card_s = time.perf_counter() - t0
        rcs = [c.wait(timeout=1800) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    if any(rcs):
        raise AssertionError(f'optimizers: the CPU runs\' processes exited '
                             f'with {rcs}')
    cpu_runs = {}
    for f in files:
        cpu_runs.update(torch.load(f))
    cpu_runs = [cpu_runs[i] for i in range(len(OPTIMIZERS))]
    log(f'optimizers: the card\'s runs {card_s:.1f} s, the CPU\'s done '
        f'{time.perf_counter() - t0 - card_s:.1f} s after them')
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


# -- slice 17: deploying a model ---------------------------------------------

def _scatter_nd_add(x, index, updates):
    from paddle_tpu_torch.tensor.manipulation import scatter_nd_add
    return scatter_nd_add(x, index, updates)


class GreedyDecoder(torch.nn.Module):
    """The reference's dy2static decoder (``tests/test_dy2static.py:
    144-175``): greedy decoding that stops at EOS, a data-dependent trip
    count in a ``while`` whose test is ``(i < MAXLEN) and (~done)``.
    ``nn`` is the port's layer package (its layers on the default
    device); the sizes are module globals, as there (a closure would
    keep ``dy2static`` from converting it)."""

    def __init__(self, nn):
        super().__init__()
        self.emb = nn.Embedding(DY2_V, DY2_H)
        self.cell = nn.GRUCell(DY2_H, DY2_H)
        self.head = nn.Linear(DY2_H, DY2_V)

    def forward(self, start_ids, h0):
        tok = start_ids
        h = h0
        out = torch.zeros([DY2_MAXLEN], dtype=torch.int64, device=h0.device)
        i = torch.zeros((), dtype=torch.int64, device=h0.device)
        done = tok.sum() < -1
        while (i < DY2_MAXLEN) and (~done):
            x = self.emb(tok)
            h, _ = self.cell(x, h)
            nxt = self.head(h).argmax(-1)
            out = _scatter_nd_add(out, i.reshape([1, 1]), nxt.reshape([1]))
            done = (nxt == DY2_EOS).all()
            tok = nxt
            i = i + 1
        return out, i


def tensor_if(x):
    """A tensor ``if`` (the reference's ``test_tensor_if_in_to_static``)."""
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = -x
    return y + 1.0


def python_if(x, flag):
    """A Python ``if``: no host read, so ``to_static`` captures a graph."""
    if flag:
        y = x * 2.0
    else:
        y = x
    return y - 1.0


def _forward_launches(ln, softmax=0, flash=0):
    """Launches of one inference forward: LayerNorm on ``warp``, the
    softmax on ``vec``, the flash forward on ``simt`` (f32), nothing
    else (no backward)."""
    want = _per_step(1, ln, softmax=softmax)
    want['flash_attention_fwd'] = flash
    want['flash_attention_fwd:simt'] = flash
    return want


def _check_launches(what, launches, want, times=1):
    bad = {k: (launches.get(k, 0), n * times) for k, n in want.items()
           if launches.get(k, 0) != n * times}
    bad.update({k: (n, 0) for k, n in launches.items()
                if n and k not in want})
    if bad:
        raise AssertionError(f'{what}: launches (got, want) {bad}')


def jit_inputs(vocab_size, batch, seq, seed=0):
    """Seeded ids and token types (a second segment from a random
    position of each row), int64."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab_size, (batch, seq)).astype(np.int64)
    types = (np.arange(seq)[None, :] >= rs.randint(1, seq, (batch, 1))) \
        .astype(np.int64)
    return ids, types


def jit_mask(batch, seq, seed=1):
    """An additive padding mask ``[B, 1, 1, T]``: 0 on each row's first
    ``len`` keys, -1e9 after."""
    lens = np.random.RandomState(seed).randint(seq // 4, seq + 1, batch)
    keep = np.arange(seq)[None, :] < lens[:, None]
    return np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]


# The fresh process of ``jit_deploy``: it imports the port's inference
# API only, never the model's class, loads the two artifacts, feeds them
# by name at B 1, 8 and 64, counts every kernel launch of each forward,
# times the Predictor at B 64, and holds its outputs to the eager model's
# (saved by the parent) on the host.  Prints one JSON line.
JIT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from paddle_tpu_torch import inference
from paddle_tpu_torch.ops import _build

def counts():
    out = {}
    for k in _build.KERNELS:
        out[k.name] = k.launches
        for v, n in k.variant_launches.items():
            out[k.name + ':' + v] = n
    return out

def predictor(path):
    t0 = time.perf_counter()
    cfg = inference.Config(path)
    cfg.enable_use_gpu(device_id=0)
    pred = inference.create_predictor(cfg)
    return pred, time.perf_counter() - t0

def run(pred, feeds):
    for name, arr in feeds.items():
        pred.get_input_handle(name).copy_from_cpu(arr)
    pred.run()

def fetch(pred):
    return [pred.get_output_handle(n).copy_to_cpu()
            for n in pred.get_output_names()]

def compare(got, want):
    rel = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
              for g, w in zip(got, want))
    return rel, all(np.array_equal(g, w) for g, w in zip(got, want))

tmp, timed = sys.argv[1], int(sys.argv[2])
assert 'paddle_tpu_torch.models.bert' not in sys.modules
assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'paddle_tpu')]
data = np.load(tmp + '/inputs.npz')
refs = torch.load(tmp + '/eager.pt')
res = {'models_bert_imported': False}
pred, res['load_s'] = predictor(tmp + '/bert')
res['input_names'] = pred.get_input_names()
# a kernel registers when its module loads, at the first forward
main_path = {}
per_forward = []
for b in (1, 8, 64):
    feeds = {'input_ids': data['ids'][:b], 'token_type_ids': data['types'][:b]}
    for call in range(2):                   # the capture, then a replay
        _build.reset_launches()
        run(pred, feeds)
        torch.cuda.synchronize()
        c = counts()
        per_forward.append(c)
        for k, n in c.items():
            main_path[k] = main_path.get(k, 0) + n
    got = fetch(pred)
    rel, equal = compare(got, [t.numpy() for t in refs['b%d' % b]])
    res['b%d' % b] = {'rel_err': rel, 'bit_equal': equal,
                      'shapes': [list(g.shape) for g in got]}
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(timed):
    run(pred, feeds)
torch.cuda.synchronize()
res['predictor_ms'] = (time.perf_counter() - t0) / timed * 1e3
t0 = time.perf_counter()
fetch(pred)
res['copy_to_cpu_ms'] = (time.perf_counter() - t0) * 1e3
res['graphs'] = len(pred._fn.graphs())
res['per_forward'] = per_forward
res['main_path'] = main_path
masked, res['masked_load_s'] = predictor(tmp + '/bert_masked')
feeds = {'input_ids': data['ids'], 'token_type_ids': data['types'],
         'attn_mask': data['mask']}
masked_forward, masked_path = [], {}
for call in range(2):
    _build.reset_launches()
    run(masked, feeds)
    torch.cuda.synchronize()
    c = counts()
    masked_forward.append(c)
    for k, n in c.items():
        masked_path[k] = masked_path.get(k, 0) + n
rel, equal = compare(fetch(masked), [t.numpy() for t in refs['masked']])
res['masked'] = {'rel_err': rel, 'bit_equal': equal,
                 'per_forward': masked_forward, 'main_path': masked_path}
res['models_bert_imported'] = 'paddle_tpu_torch.models.bert' in sys.modules
print(json.dumps({'jit_child': res}))
"""


def _jit_to_static(model, ids, types, eager):
    """Eager against ``to_static`` at B 64: bit for bit, the launches of
    one replay exact, ms per forward of each."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import _build
    with torch.no_grad():
        eager_ms = time_ms(lambda: model(ids, types), iters=JIT_TIMED,
                           warmup=1)
    jit.to_static(model)
    t0 = time.perf_counter()
    first = model(ids, types)                   # warm-up and capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _build.reset_launches()
    replay = model(ids, types)
    torch.cuda.synchronize()
    launches = launch_counts()
    _check_launches('jit_deploy to_static replay', launches,
                    _forward_launches(JIT_LN, flash=JIT_LAYERS))
    for what, out in (('warm-up', first), ('replay', replay)):
        if not all(torch.equal(a, b) for a, b in zip(out, eager)):
            raise AssertionError(f'jit_deploy: to_static {what} differs '
                                 f'from eager at B 64')
    static_ms = time_ms(lambda: model(ids, types), iters=JIT_TIMED,
                        warmup=1)
    modes = list(model.forward.modes().values())
    if modes != ['graph']:
        raise AssertionError(f'jit_deploy: to_static modes {modes}')
    return {'eager_ms': eager_ms, 'to_static_ms': static_ms,
                   'capture_s': capture_s, 'mode': modes[0],
                   'bit_equal': True, 'launches': launches}


def _jit_dy2static():
    """The reference's greedy decoder, a tensor ``if`` and a Python
    ``if`` under ``to_static`` on the card: outputs equal eager's, and
    each signature's mode."""
    from paddle_tpu_torch import jit, nn, seed
    from paddle_tpu_torch.jit import dy2static
    seed(3)
    dec = GreedyDecoder(nn)
    ids = torch.tensor([3], device='cuda')
    h0 = torch.zeros((1, DY2_H), device='cuda')
    with torch.no_grad():
        want = dec(ids, h0)
    reads = dy2static.host_reads()
    jit.to_static(dec)
    got = dec(ids, h0)
    again = dec(ids, h0)
    dec_reads = dy2static.host_reads() - reads
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, want, again)):
        raise AssertionError(f'jit_deploy: to_static decoder {got} != '
                             f'eager {want}')
    x = torch.tensor([[1.0, -2.0, 0.5]], device='cuda')
    st_if, st_py = jit.to_static(tensor_if), jit.to_static(python_if)
    results = {}
    for name, sf, args, fn in (('tensor_if', st_if, (x,), tensor_if),
                               ('tensor_if_neg', st_if, (-x,), tensor_if),
                               ('python_if', st_py, (x, True), python_if)):
        outs = [sf(*args) for _ in range(3)]
        if not all(torch.equal(o, fn(*args)) for o in outs):
            raise AssertionError(f'jit_deploy: to_static {name} != eager')
    modes = {'greedy_decoder': list(dec.forward.modes().values()),
             'tensor_if': list(st_if.modes().values()),
             'python_if': list(st_py.modes().values())}
    want_modes = {'greedy_decoder': ['eager'],
                  'tensor_if': ['eager'], 'python_if': ['graph']}
    if modes != want_modes:
        raise AssertionError(f'jit_deploy: signature modes {modes}, '
                             f'expected {want_modes}')
    results.update(tokens=got[0].tolist(), steps=int(got[1]),
                   decoder_host_reads=dec_reads, modes=modes)
    return results


def _jit_reader_lenet():
    """The fluid-era input pipeline, ``batch(reader.shuffle(dataset.
    mnist.train(), 1024), 64)``, feeding LeNet through 16
    ``ParallelTrainer`` steps: finite losses, the last four's mean below
    the first four's (a new batch each step), no kernel launched."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    paddle.seed(0)
    model = LeNet(device='cuda', seed=0)
    tr = _vision_trainer(model, Adam(learning_rate=LENET_LR,
                                     parameters=model.parameters()),
                         amp_o2=False)
    feed = paddle.batch(paddle.reader.shuffle(
        paddle.dataset.mnist.train(), JIT_READER_BUF), JIT_READER_BATCH)
    _build.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for batch in feed():
        x = torch.from_numpy(np.stack([s[0] for s in batch]).reshape(
            -1, 1, 28, 28)).to('cuda')
        y = torch.tensor([[s[1]] for s in batch], device='cuda')
        losses.append(tr.step(x, y))
        if len(losses) == JIT_READER_STEPS:
            break
    losses = [tr.loss_float(v) for v in losses]
    dt = time.perf_counter() - t0
    launches = launch_counts()
    _no_kernel_launches('jit_deploy reader', launches)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not (all(math.isfinite(v) for v in losses) and last < first):
        raise AssertionError(f'jit_deploy reader: losses {losses}')
    return {'losses': losses, 'ms_per_step': dt / len(losses) * 1e3,
            'launches': launches}


def jit_deploy_phase():
    """``bert_base`` deployed (slice 17): eager against ``to_static`` at B
    64 bit for bit; ``jit.save`` with ``None`` batch ``InputSpec``s (the
    export seconds, the files' bytes), of the MLM model and of the
    masked encoder; a fresh process that imports only
    ``paddle_tpu_torch.inference`` serving both artifacts at B 1, 8 and
    64, every forward's launches exact and its outputs within 1e-5 of
    the largest of eager's; dy2static on the card; the fluid-era reader
    feeding LeNet."""
    import os
    import shutil
    import tempfile
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.bert import bert_base
    from paddle_tpu_torch.static import InputSpec
    t_phase = time.perf_counter()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    model = bert_base(device='cuda', seed=0, **JIT_MODEL_KW).eval()
    cfg = model.config
    B = max(JIT_BATCHES)
    ids, types = jit_inputs(cfg.vocab_size, B, JIT_SEQ)
    mask = jit_mask(B, JIT_SEQ)
    ids_d, types_d = (torch.from_numpy(a).to('cuda') for a in (ids, types))
    refs = {}
    with torch.no_grad():
        for b in JIT_BATCHES:
            refs[f'b{b}'] = model(ids_d[:b], types_d[:b])
        refs['masked'] = model.bert(ids_d, types_d,
                                    torch.from_numpy(mask).to('cuda'))
    summary = _jit_to_static(model, ids_d, types_d, refs[f'b{B}'])
    log(f'jit_deploy: on {card}: bert_base\'s widths at {JIT_LAYERS} layers '
        f'f32 eval B {B} T {JIT_SEQ}: eager '
        f'{summary["eager_ms"]:.3f} ms/forward, to_static '
        f'{summary["to_static_ms"]:.3f} (one graph, capture '
        f'{summary["capture_s"]:.2f} s), equal bit for bit; launches a '
        f'replay: LayerNorm {JIT_LN}, flash forward {JIT_LAYERS} (exact)')
    tmp = tempfile.mkdtemp(prefix='jit_deploy_')
    try:
        torch.save({k: [t.cpu() for t in v] for k, v in refs.items()},
                   os.path.join(tmp, 'eager.pt'))
        del refs
        np.savez(os.path.join(tmp, 'inputs.npz'), ids=ids, types=types,
                 mask=mask)
        spec = [InputSpec([None, JIT_SEQ], 'int64', 'input_ids'),
                InputSpec([None, JIT_SEQ], 'int64', 'token_type_ids')]
        files = {}
        for name, layer, sp in (
                ('bert', model, spec),
                ('bert_masked', model.bert, spec + [InputSpec(
                    [None, 1, 1, JIT_SEQ], 'float32', 'attn_mask')])):
            t0 = time.perf_counter()
            jit.save(layer, os.path.join(tmp, name), input_spec=sp)
            files[name] = {
                'export_s': time.perf_counter() - t0,
                'pdmodel_bytes': os.path.getsize(
                    os.path.join(tmp, name + '.pdmodel')),
                'pdiparams_bytes': os.path.getsize(
                    os.path.join(tmp, name + '.pdiparams'))}
        log(f'jit_deploy: jit.save ' + '; '.join(
            f'{n} export {f["export_s"]:.2f} s, .pdmodel '
            f'{f["pdmodel_bytes"]} bytes, .pdiparams '
            f'{f["pdiparams_bytes"]} bytes' for n, f in files.items()))
        del model
        _free()
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', JIT_CHILD, tmp, str(JIT_TIMED)],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        raise AssertionError(f'jit_deploy: the Predictor process failed '
                             f'({proc.returncode}):\n{proc.stdout}\n'
                             f'{proc.stderr[-4000:]}')
    child = json.loads([ln for ln in proc.stdout.splitlines()
                        if ln.startswith('{"jit_child"')][-1])['jit_child']
    # the child registers a kernel only when its module loads: count the
    # others at 0, under every name this process knows
    names = launch_counts()
    for part in (child, child['masked']):
        part['main_path'] = {k: part['main_path'].get(k, 0) for k in names}
    if child['models_bert_imported']:
        raise AssertionError('jit_deploy: the Predictor imported the model')
    if child['input_names'] != ['input_ids', 'token_type_ids']:
        raise AssertionError(f'jit_deploy: input names '
                             f'{child["input_names"]}')
    want = _forward_launches(JIT_LN, flash=JIT_LAYERS)
    for i, c in enumerate(child['per_forward']):
        _check_launches(f'jit_deploy Predictor forward {i}', c, want)
    _check_launches('jit_deploy Predictor', child['main_path'], want,
                    times=len(child['per_forward']))
    want_masked = _forward_launches(JIT_LN_MASKED, softmax=JIT_LAYERS)
    for i, c in enumerate(child['masked']['per_forward']):
        _check_launches(f'jit_deploy masked forward {i}', c, want_masked)
    for key in [f'b{b}' for b in JIT_BATCHES] + ['masked']:
        if not child[key]['rel_err'] <= JIT_TOL:
            raise AssertionError(f'jit_deploy: Predictor {key} lies '
                                 f'{child[key]["rel_err"]:.3g} of the '
                                 f'largest output from eager')
    log(f'jit_deploy: fresh process (imports paddle_tpu_torch.inference '
        f'only; models.bert never imported): load {child["load_s"]:.2f} '
        f's, ' + ', '.join(
            f'B {b} within {child[f"b{b}"]["rel_err"]:.3g} of eager '
            f'(bit-equal {child[f"b{b}"]["bit_equal"]})'
            for b in JIT_BATCHES) + f'; {child["graphs"]} graphs; '
        f'Predictor {child["predictor_ms"]:.3f} ms/forward at B {B} '
        f'(copy_to_cpu {child["copy_to_cpu_ms"]:.1f} ms); every forward '
        f'LayerNorm {JIT_LN} + flash {JIT_LAYERS} exactly; masked '
        f'artifact within {child["masked"]["rel_err"]:.3g} (bit-equal '
        f'{child["masked"]["bit_equal"]}), LayerNorm {JIT_LN_MASKED} + '
        f'softmax {JIT_LAYERS} a forward exactly; process {child_s:.1f} s')
    dy2 = _jit_dy2static()
    log(f'jit_deploy: dy2static on the card: greedy decoder tokens '
        f'{dy2["tokens"]} in {dy2["steps"]} steps ({dy2["decoder_host_reads"]}'
        f' host reads of its predicates), tensor if and Python if equal '
        f'to eager; modes {dy2["modes"]}')
    reader = _jit_reader_lenet()
    log(f'jit_deploy: batch(reader.shuffle(dataset.mnist.train(), '
        f'{JIT_READER_BUF}), {JIT_READER_BATCH}) into LeNet, '
        f'{JIT_READER_STEPS} ParallelTrainer steps: losses '
        f'{reader["losses"][0]:.4f} .. {reader["losses"][-1]:.4f} (finite, '
        f'falling), {reader["ms_per_step"]:.2f} ms/step with the reader; '
        f'no kernel launched')
    summary.update(card=card, files=files, predictor=child, child_s=child_s,
                   dy2static=dy2, reader=reader,
                   phase_s=time.perf_counter() - t_phase)
    log(f'jit_deploy: phase {summary["phase_s"]:.1f} s on {card}')
    return summary



# -- slice 18: the tensor library and autograd ---------------------------------
# Every function of paddle_tpu_torch.tensor.__all__ on the card, held to
# the same call on the CPU with the same inputs: elementwise ops,
# reductions and manipulation on gpt_small's activations [8, 1024, 768]
# (f32, and bf16 where the case says), sort/search/top-k on [8, 50257]
# logits (rounded to 0.1 so that ties occur), linalg on 768 x 768.
# Tolerances, as the largest |card - CPU| over the largest |CPU value|
# of each output: elementwise f32 1e-5 (transcendentals differ by an ulp
# or two between CUDA's and the CPU's libm), bf16 2^-7 (one bf16 step of
# a result rounded from f32 values that differ by an ulp); reductions
# f32 1e-4 (sums over up to 6.3M elements in another order), bf16 2^-7;
# linalg f32 1e-3 (cuSOLVER and LAPACK factor in other orders, 768-long
# dot products); every integer, bool, index, sort, search and
# manipulation result exactly.  The random ops cannot match the CPU's
# generator: they are held by determinism and by their laws.
TLIB_SHAPE = (8, 1024, 768)
TLIB_VOCAB = 50257
TLIB_N = 768
TLIB_DRAWS = 1 << 24
TLIB_TOL = {('elementwise', torch.float32): 1e-5,
            ('elementwise', torch.bfloat16): 2.0 ** -7,
            ('reduction', torch.float32): 1e-4,
            ('reduction', torch.bfloat16): 2.0 ** -7,
            ('linalg', torch.float32): 1e-3}
# the WGAN-GP-style penalty through one gpt_small block on the card
# against the CPU (f32, causal, B 2 x T 1024): each gradient's largest
# gap over its largest |value|
TLIB_BLOCK_BATCH, TLIB_SECOND_ORDER_TOL = 2, 1e-3
TLIB_CONSTANT_BIAS = 'mlp.proj.bias'
TLIB_CHI2_999 = {9: 27.877}    # chi-square 99.9% quantile by d.o.f.


def _tlib_inputs():
    """The phase's numpy inputs, seed 0."""
    rs = np.random.RandomState(0)
    x = rs.randn(*TLIB_SHAPE).astype(np.float32)
    y = rs.randn(*TLIB_SHAPE).astype(np.float32)
    g = rs.randn(TLIB_N, TLIB_N).astype(np.float32)
    mat = np.eye(TLIB_N, dtype=np.float32) + 0.5 * g / np.sqrt(TLIB_N)
    spd = (g @ g.T / TLIB_N + np.eye(TLIB_N)).astype(np.float32)
    return {
        'x': x, 'y': y, 'pos': np.abs(y) + 0.5,
        'unit': np.tanh(y).astype(np.float32) * 0.9,
        'near1': (1.0 + 1e-3 * y).astype(np.float32),
        'ix': rs.randint(-50, 50, TLIB_SHAPE).astype(np.int32),
        'ipos': rs.randint(1, 50, TLIB_SHAPE).astype(np.int32),
        'halves': (rs.randint(0, 100, TLIB_SHAPE) + 0.5).astype(np.float32),
        'logits': np.round(3 * rs.randn(8, TLIB_VOCAB), 1).astype(np.float32),
        'mat': mat.astype(np.float32), 'spd': spd,
        'rhs': rs.randn(TLIB_N, 64).astype(np.float32),
        'v': rs.randn(TLIB_N).astype(np.float32),
        'w64': rs.randn(64).astype(np.float32),
        'm64': rs.randn(64, 64).astype(np.float32),
        'cplx': (x[0, :4] + 1j * y[0, :4]).astype(np.complex64),
        'idx': rs.randint(0, 1024, 512).astype(np.int64),
        'perm': rs.permutation(1024)[:64].astype(np.int64),
        'rows': rs.randint(0, 8, (8, 1)).astype(np.int64),
    }


def _tlib_cases():
    """``(name, family, fn, bf16)``: ``fn(P, d)`` calls the op on the
    inputs ``d`` (tensors of one device); ``bf16`` runs it a second time
    with the float inputs in bf16."""
    E, R, X, L = 'elementwise', 'reduction', 'exact', 'linalg'
    cases = []

    def add(name, family, fn, bf16=False):
        cases.append((name, family, fn, bf16))

    # creation (on the default device, set to each side's in turn)
    add('to_tensor', X, lambda P, d: P.to_tensor(d['x'].cpu().numpy()[:2]))
    add('zeros', X, lambda P, d: P.zeros(TLIB_SHAPE))
    add('ones', X, lambda P, d: P.ones(TLIB_SHAPE, 'bfloat16'))
    add('full', X, lambda P, d: P.full(TLIB_SHAPE, 2.5))
    add('empty', X, lambda P, d: P.empty([4, 4]))
    add('zeros_like', X, lambda P, d: P.zeros_like(d['x']), True)
    add('ones_like', X, lambda P, d: P.ones_like(d['x']))
    add('full_like', X, lambda P, d: P.full_like(d['x'], 3.0), True)
    add('empty_like', X, lambda P, d: P.empty_like(d['x']))
    add('arange', X, lambda P, d: P.arange(0, 1 << 20))
    add('linspace', E, lambda P, d: P.linspace(0, 1, 1 << 20))
    add('logspace', E, lambda P, d: P.logspace(0, 2, 4096))
    add('eye', X, lambda P, d: P.eye(TLIB_N))
    add('diag', X, lambda P, d: [P.diag(d['x'][0], 1), P.diag(d['v'], -2)])
    add('diagflat', X, lambda P, d: P.diagflat(d['v']))
    add('tril', X, lambda P, d: P.tril(d['x'], -1), True)
    add('triu', X, lambda P, d: P.triu(d['x'], 1), True)
    add('meshgrid', X, lambda P, d: P.meshgrid(d['x'][0, :, 0],
                                               d['v']))
    add('assign', X, lambda P, d: P.assign(d['x']), True)
    add('clone', X, lambda P, d: P.clone(d['x']), True)

    # elementwise
    unary = {'exp': 'x', 'expm1': 'x', 'log': 'pos', 'log2': 'pos',
             'log10': 'pos', 'log1p': 'pos', 'sqrt': 'pos', 'rsqrt': 'pos',
             'square': 'x', 'abs': 'x', 'sign': 'x', 'sgn': 'x', 'sin': 'x',
             'cos': 'x', 'tan': 'unit', 'asin': 'unit', 'acos': 'unit',
             'atan': 'x', 'sinh': 'x', 'cosh': 'x', 'tanh': 'x',
             'asinh': 'x', 'acosh': 'pos', 'atanh': 'unit',
             'reciprocal': 'pos', 'floor': 'x', 'ceil': 'x', 'round': 'x',
             'trunc': 'x', 'erf': 'x', 'erfinv': 'unit', 'digamma': 'pos',
             'lgamma': 'pos', 'frac': 'x', 'rad2deg': 'x', 'deg2rad': 'x',
             'angle': 'x', 'real': 'x', 'imag': 'x', 'conj': 'x',
             'isfinite': 'x', 'isinf': 'x', 'isnan': 'x', 'logit': 'unit',
             'stanh': 'x'}
    low = {'exp', 'log', 'sqrt', 'rsqrt', 'square', 'abs', 'sign', 'sin',
           'cos', 'tanh', 'floor', 'ceil', 'round', 'reciprocal', 'erf'}
    for name, key in unary.items():
        arg = (lambda P, d, k=key: d[k] * 0.5 + 0.5) if name == 'logit' \
            else (lambda P, d, k=key: d[k])
        add(name, E, lambda P, d, n=name, a=arg: getattr(P, n)(a(P, d)),
            name in low)
    binary = ['add', 'subtract', 'multiply', 'divide', 'floor_divide',
              'mod', 'remainder', 'floor_mod', 'maximum', 'minimum', 'fmax',
              'fmin', 'atan2', 'heaviside']
    for name in binary:
        add(name, E, lambda P, d, n=name: getattr(P, n)(d['x'], d['pos']),
            name in ('add', 'subtract', 'multiply', 'divide', 'maximum',
                     'minimum'))
    add('pow', E, lambda P, d: [P.pow(d['pos'], d['unit']),
                                P.pow(d['x'], 3)], True)
    add('float_power', E, lambda P, d: P.float_power(d['pos'], 0.5))
    add('gcd', X, lambda P, d: P.gcd(d['ix'], d['ipos']))
    add('lcm', X, lambda P, d: P.lcm(d['ix'], d['ipos']))
    add('clip', E, lambda P, d: P.clip(d['x'], -0.5, 0.5), True)
    add('nan_to_num', E, lambda P, d: P.nan_to_num(P.log(d['x'])))
    add('lerp', E, lambda P, d: P.lerp(d['x'], d['y'], 0.3), True)
    add('scale', E, lambda P, d: P.scale(d['x'], 2.0, 0.5), True)
    add('increment', E, lambda P, d: P.increment(P.clone(d['x']), 2.0))
    add('multiply_', E, lambda P, d: P.multiply_(P.clone(d['x']), d['y']))
    add('add_', E, lambda P, d: P.add_(P.clone(d['x']), d['y']))
    add('subtract_', E, lambda P, d: P.subtract_(P.clone(d['x']), d['y']))
    add('clip_', E, lambda P, d: P.clip_(P.clone(d['x']), -1.0, 1.0))
    add('scale_', E, lambda P, d: P.scale_(P.clone(d['x']), 3.0, 1.0))
    for name in ('tanh_', 'exp_', 'ceil_', 'floor_', 'round_'):
        add(name, E, lambda P, d, n=name: getattr(P, n)(P.clone(d['x'])))
    for name in ('reciprocal_', 'rsqrt_', 'sqrt_'):
        add(name, E, lambda P, d, n=name: getattr(P, n)(P.clone(d['pos'])))
    add('diff', E, lambda P, d: P.diff(d['x'], axis=-1), True)
    add('take', X, lambda P, d: P.take(d['x'], d['idx'], mode='wrap'))
    add('multiplex', X, lambda P, d: P.multiplex(
        [d['x'][:, 0], d['y'][:, 0]], d['rows'] % 2))
    add('add_n', E, lambda P, d: P.add_n([d['x'], d['y'], d['pos']]), True)
    add('outer', L, lambda P, d: P.outer(d['v'], d['v']))
    add('inner', L, lambda P, d: P.inner(d['x'][0], d['y'][0]))
    add('kron', L, lambda P, d: P.kron(d['m64'], d['m64'][:8, :8]))
    add('addmm', L, lambda P, d: P.addmm(d['rhs'], d['mat'], d['rhs'],
                                         0.5, 2.0))
    add('trace', R, lambda P, d: P.trace(d['mat']))
    add('matmul', L, lambda P, d: P.matmul(d['x'][0], d['mat']))
    add('conj', E, lambda P, d: P.conj(d['cplx']))

    # reductions
    for name in ('sum', 'mean', 'max', 'min', 'amax', 'amin', 'logsumexp'):
        add(name, R, lambda P, d, n=name: [getattr(P, n)(d['x']),
                                           getattr(P, n)(d['x'], axis=-1),
                                           getattr(P, n)(d['x'], axis=[0, 1],
                                                         keepdim=True)],
            name != 'logsumexp')
    add('prod', R, lambda P, d: P.prod(d['near1'], axis=-1))
    # (no bf16 cumsum: a running sum rounded to bf16 at each of 768
    # steps drifts by more than one bf16 step on either device)
    add('cumsum', R, lambda P, d: P.cumsum(d['x'], axis=-1))
    add('cumprod', R, lambda P, d: P.cumprod(d['near1'], dim=-1))
    add('all', X, lambda P, d: [P.all(d['x'] > -9), P.all(d['x'] > 0, 1)])
    add('any', X, lambda P, d: [P.any(d['x'] > 4), P.any(d['x'] > 3, 2)])
    add('count_nonzero', X, lambda P, d: P.count_nonzero(d['x'] > 0, -1))
    for name in ('sum', 'cumsum', 'prod', 'cumprod'):
        add(f'{name}:int', X, lambda P, d, n=name: getattr(P, n)(
            d['ix'][:, :, :4], **({'dim': -1} if n == 'cumprod' else
                                  {'axis': -1})))
    add('std', R, lambda P, d: [P.std(d['x']), P.std(d['x'], axis=1)])
    add('var', R, lambda P, d: P.var(d['x'], axis=[0, 2], unbiased=False))
    add('median', R, lambda P, d: [P.median(d['x'], axis=-1),
                                   P.median(d['x'][0])])
    add('quantile', R, lambda P, d: P.quantile(d['x'], [0.1, 0.5, 0.9],
                                               axis=-1))
    add('nanmean', R, lambda P, d: P.nanmean(P.log(d['x']), axis=-1))
    add('nansum', R, lambda P, d: P.nansum(P.log(d['x']), axis=-1))

    # manipulation
    man = {
        'reshape': lambda P, d: P.reshape(d['x'], [-1, 768]),
        'view': lambda P, d: P.view(d['x'], [8192, 768]),
        'flatten': lambda P, d: P.flatten(d['x'], 0, 1),
        'transpose': lambda P, d: P.transpose(d['x'], [1, 0, 2]),
        'moveaxis': lambda P, d: P.moveaxis(d['x'], 0, -1),
        'concat': lambda P, d: P.concat([d['x'], d['y']], axis=1),
        'split': lambda P, d: P.split(d['x'], 3, axis=2),
        'chunk': lambda P, d: P.chunk(d['x'], 4, axis=1),
        'stack': lambda P, d: P.stack([d['x'], d['y']], axis=1),
        'unstack': lambda P, d: P.unstack(d['x'], axis=0),
        'unbind': lambda P, d: P.unbind(d['x'], 0),
        'squeeze': lambda P, d: P.squeeze(d['x'][:, :1], 1),
        'unsqueeze': lambda P, d: P.unsqueeze(d['x'], [0, 2]),
        'expand': lambda P, d: P.expand(d['x'][:, :1], [8, 1024, 768]),
        'expand_as': lambda P, d: P.expand_as(d['x'][:1], d['x']),
        'broadcast_to': lambda P, d: P.broadcast_to(d['v'], TLIB_SHAPE),
        'tile': lambda P, d: P.tile(d['x'][:2], [2, 1, 1]),
        'flip': lambda P, d: P.flip(d['x'], [0, 2]),
        'reverse': lambda P, d: P.reverse(d['x'], 1),
        'rot90': lambda P, d: P.rot90(d['x'], 1, [1, 2]),
        'roll': lambda P, d: P.roll(d['x'], 5, 1),
        'gather': lambda P, d: P.gather(d['x'], d['idx'], axis=1),
        'gather_nd': lambda P, d: P.gather_nd(
            d['x'], P.stack([d['idx'] % 8, d['idx']], axis=1)),
        'index_select': lambda P, d: P.index_select(d['x'], d['idx'], 1),
        'index_sample': lambda P, d: P.index_sample(
            d['x'][:, 0], P.reshape(d['idx'], [8, 64]) % 768),
        'take_along_axis': lambda P, d: P.take_along_axis(
            d['x'], P.argsort(d['x'], axis=-1), -1),
        'put_along_axis': lambda P, d: P.put_along_axis(
            d['x'], P.argsort(d['x'], axis=-1)[:, :, :4], 0.0, -1),
        'scatter': lambda P, d: P.scatter(d['x'][0], d['perm'],
                                          d['y'][0, :64]),
        'scatter:add': lambda P, d: P.scatter(d['x'][0], d['idx'][:64] % 16,
                                              d['y'][0, :64],
                                              overwrite=False),
        'scatter_': lambda P, d: P.scatter_(P.clone(d['x'][0]),
                                            d['idx'][:64] % 16,
                                            d['y'][0, :64], overwrite=False),
        'scatter_nd_add': lambda P, d: P.scatter_nd_add(
            d['x'][0], P.reshape(d['idx'] % 16, [-1, 1]), d['y'][0, :512]),
        'scatter_nd': lambda P, d: P.scatter_nd(
            P.reshape(d['idx'] % 16, [-1, 1]), d['y'][0, :512], [16, 768]),
        'repeat_interleave': lambda P, d: P.repeat_interleave(
            d['x'][:2], 2, axis=1),
        'cast': lambda P, d: [P.cast(d['x'], 'bfloat16'),
                              P.cast(d['x'] * 10, 'int32')],
        'slice': lambda P, d: P.slice(d['x'], [1, 2], [3, 10], [-5, 700]),
        'strided_slice': lambda P, d: P.strided_slice(
            d['x'], [1, 2], [0, 700], [1024, 3], [3, -7]),
        'crop': lambda P, d: P.crop(d['x'], [4, 512, -1], [1, 100, 8]),
        'tensordot': lambda P, d: P.tensordot(d['x'][0], d['mat'],
                                              axes=[[1], [0]]),
        'atleast_1d': lambda P, d: P.atleast_1d(d['x'][0, 0, 0]),
        'atleast_2d': lambda P, d: P.atleast_2d(d['v']),
        'atleast_3d': lambda P, d: P.atleast_3d(d['mat']),
        'shard_index': lambda P, d: P.shard_index(d['ipos'], 64, 4, 1),
        'shape': lambda P, d: P.shape(d['x']),
        'rank': lambda P, d: P.rank(d['x']),
        'numel': lambda P, d: P.numel(d['x']),
        'reshape_': lambda P, d: P.reshape_(P.clone(d['x']), [8192, 768]),
        'flatten_': lambda P, d: P.flatten_(P.clone(d['x']), 0, 1),
        'squeeze_': lambda P, d: P.squeeze_(P.clone(d['x'][:, :1]), 1),
        'unsqueeze_': lambda P, d: P.unsqueeze_(P.clone(d['x']), 0),
        'unique': lambda P, d: P.unique(d['ix'], return_index=True,
                                        return_inverse=True,
                                        return_counts=True),
    }
    bf16_man = {'reshape', 'transpose', 'concat', 'split', 'stack',
                'gather', 'scatter', 'flip', 'roll', 'cast', 'slice'}
    # the adding scatters sum repeated rows in another order on the card
    adding = {'scatter:add', 'scatter_', 'scatter_nd_add', 'scatter_nd'}
    for name, fn in man.items():
        fam = L if name == 'tensordot' else E if name in adding else X
        add(name, fam, fn, name in bf16_man)

    # logic
    for name in ('equal', 'not_equal', 'greater_than', 'greater_equal',
                 'less_than', 'less_equal', 'logical_and', 'logical_or',
                 'logical_xor'):
        add(name, X, lambda P, d, n=name: [getattr(P, n)(d['x'], d['y']),
                                           getattr(P, n)(d['x'], 0.0)],
            True)
    add('logical_not', X, lambda P, d: P.logical_not(d['x'] > 0))
    for name in ('bitwise_and', 'bitwise_or', 'bitwise_xor'):
        add(name, X, lambda P, d, n=name: getattr(P, n)(d['ix'], d['ipos']))
    add('bitwise_not', X, lambda P, d: P.bitwise_not(d['ix']))
    add('allclose', X, lambda P, d: [P.allclose(d['x'], d['x'] + 1e-9),
                                     P.allclose(d['x'], d['y'])])
    add('isclose', X, lambda P, d: P.isclose(d['x'], d['x'] * 1.00001))
    add('equal_all', X, lambda P, d: [P.equal_all(d['x'], d['x']),
                                      P.equal_all(d['x'], d['y'])])
    add('is_empty', X, lambda P, d: [P.is_empty(d['x']),
                                     P.is_empty(d['x'][:0])])

    # search (the logits: ties at 0.1 steps)
    add('argmax', X, lambda P, d: [P.argmax(d['logits'], axis=-1),
                                   P.argmax(d['logits'])], True)
    add('argmin', X, lambda P, d: P.argmin(d['logits'], axis=-1,
                                           keepdim=True), True)
    add('argsort', X, lambda P, d: [P.argsort(d['logits'], axis=-1),
                                    P.argsort(d['logits'], axis=-1,
                                              descending=True)], True)
    add('sort', X, lambda P, d: [P.sort(d['logits'], axis=-1),
                                 P.sort(d['logits'], 0, True)], True)
    add('topk', X, lambda P, d: [*P.topk(d['logits'], 50),
                                 *P.topk(d['logits'], 5, largest=False)],
        True)
    add('where', X, lambda P, d: P.where(d['x'] > 0, d['x'], d['y']), True)
    add('nonzero', X, lambda P, d: P.nonzero(d['logits'] > 8.0))
    add('masked_select', X, lambda P, d: P.masked_select(d['logits'],
                                                         d['logits'] > 8))
    add('searchsorted', X, lambda P, d: P.searchsorted(
        P.sort(d['logits'][0]), d['logits'][1], right=True))
    add('kthvalue', X, lambda P, d: P.kthvalue(d['logits'], 100, axis=-1))
    add('mode', X, lambda P, d: P.mode(d['logits'], axis=-1))

    # linalg
    lin = {
        'mm': lambda P, d: P.mm(d['mat'], d['rhs']),
        'bmm': lambda P, d: P.bmm(d['x'][:, :64], d['x'][:, :64].transpose(
            1, 2)),
        'dot': lambda P, d: P.dot(d['x'], d['y']),
        'mv': lambda P, d: P.mv(d['mat'], d['v']),
        't': lambda P, d: P.t(d['mat']),
        'norm': lambda P, d: [P.norm(d['x']), P.norm(d['x'], 2, axis=-1),
                              P.norm(d['mat'], np.inf, axis=0)],
        'dist': lambda P, d: [P.dist(d['x'], d['y']),
                              P.dist(d['x'], d['y'], 1)],
        'cross': lambda P, d: P.cross(d['x'][0, :, :3], d['y'][0, :, :3]),
        'cholesky': lambda P, d: P.cholesky(d['spd']),
        'matrix_power': lambda P, d: P.matrix_power(d['mat'], 3),
        'histogram': lambda P, d: P.histogram(d['halves'], 50, 0, 100),
        'einsum': lambda P, d: P.einsum('btd,de->bte', d['x'][:2],
                                        d['mat']),
        'inv': lambda P, d: P.inv(d['mat']),
        'inverse': lambda P, d: P.inverse(d['spd']),
        'det': lambda P, d: P.det(d['mat']),
        'slogdet': lambda P, d: P.slogdet(d['mat']),
        'solve': lambda P, d: P.solve(d['spd'], d['rhs']),
        'triangular_solve': lambda P, d: P.triangular_solve(
            P.triu(d['spd']), d['rhs']),
        'pinv': lambda P, d: P.pinv(d['rhs']),
        'multi_dot': lambda P, d: P.multi_dot([d['mat'], d['spd'],
                                               d['rhs']]),
        'cond': lambda P, d: P.cond(d['spd']),
        'matrix_rank': lambda P, d: P.matrix_rank(d['spd']),
        'svd': lambda P, d: P.svd(d['mat'])[1],
        'qr': lambda P, d: P.abs(P.diag(P.qr(d['mat'])[1])),
        'eigh': lambda P, d: P.eigh(d['spd'])[0],
    }
    for name, fn in lin.items():
        fam = X if name in ('t', 'histogram', 'matrix_rank') else L
        add(name, fam, fn)

    # host-side helpers on card tensors: their values, as tensors on the
    # inputs' device
    def host(fn):
        return lambda P, d: torch.tensor(fn(P, d), device=d['x'].device)
    add('is_tensor', X, host(lambda P, d: P.is_tensor(d['x'])))
    add('broadcast_shape', X, host(
        lambda P, d: P.broadcast_shape([8, 1, 768], [1024, 1])))
    add('tolist', X, host(lambda P, d: P.tolist(d['v'])))
    def array(P, d):
        arr = P.array_write(d['x'], 1, P.array_write(d['y'], 0,
                                                     P.create_array()))
        return [P.array_read(arr, 1), torch.tensor(P.array_length(arr),
                                                   device=d['x'].device)]
    add('array', X, array)

    def to_string(P, d):
        P.set_printoptions(precision=4)
        try:
            return [ord(c) for c in P.tensor.to_string(d['mat'])]
        finally:
            P.set_printoptions(precision=8)     # the default
    add('to_string', X, host(to_string))
    add('check_shape', X, host(
        lambda P, d: P.check_shape(P.shape(d['x']))))
    add('as_strided', X, host(lambda P, d: _tlib_raises(
        NotImplementedError, P.as_strided, d['x'], [2], [1])))
    return cases


def _tlib_raises(error, fn, *args):
    """Whether ``fn(*args)`` raises ``error`` (what the reference does
    for the op)."""
    try:
        fn(*args)
    except error:
        return True
    return False


class _TlibCalls:
    """Records which names of ``P.tensor.__all__`` are called: each is
    wrapped on ``P`` and ``P.tensor`` while the context is open, and
    restored after."""

    def __init__(self, P):
        self.P, self.called, self.saved = P, set(), []

    def __enter__(self):
        P = self.P
        for name in P.tensor.__all__:
            fn = getattr(P.tensor, name)

            def record(*args, _name=name, _fn=fn, **kw):
                self.called.add(_name)
                return _fn(*args, **kw)
            for mod in (P, P.tensor):
                if getattr(mod, name, None) is fn:
                    self.saved.append((mod, name, fn))
                    setattr(mod, name, record)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _tlib_flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _tlib_flat(x)]
    return [out]


def _tlib_gap(got, want):
    """``(gap, scale)``: the largest |got - want| over the finite
    elements (NaN and inf where both are), and the largest |want|."""
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    g, w = got.double(), want.double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    fin = torch.isfinite(w) & torch.isfinite(g)
    if bool((~same & ~fin).any()):
        return float('inf'), 1.0
    d = (g - w).abs()[fin]
    gap = float(d.max()) if d.numel() else 0.0
    scale = float(w.abs()[torch.isfinite(w)].max()) if w.numel() else 0.0
    return gap, max(scale, 1e-30)


def _tlib_run(P, fn, inputs, device):
    P.set_device(device)
    try:
        with torch.no_grad():
            out = fn(P, inputs)
    finally:
        P.set_device(None)
    return _tlib_flat(out)


def tensor_ops_vs_cpu(P):
    """Every case on the card and on the CPU: ``(ran, exact matches,
    {family: largest gap over scale})``; raises on a mismatch."""
    host = _tlib_inputs()
    on = {dev: {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
          for dev in ('cuda', 'cpu')}
    bf16 = {dev: {k: (v.to(torch.bfloat16) if v.is_floating_point()
                      and k not in ('mat', 'spd', 'rhs') else v)
                  for k, v in on[dev].items()} for dev in on}
    ran, exact, worst, bad = 0, 0, {}, []
    for name, family, fn, with_bf16 in _tlib_cases():
        for dtype, inputs in [(torch.float32, on)] + (
                [(torch.bfloat16, bf16)] if with_bf16 else []):
            try:
                got = _tlib_run(P, fn, inputs['cuda'], 'cuda')
                want = _tlib_run(P, fn, inputs['cpu'], 'cpu')
                torch.cuda.synchronize()
            except Exception as e:      # every op's failure is reported
                bad.append(f'{name} ({dtype}) raised {type(e).__name__}: '
                           f'{e}')
                continue
            ran += 1
            if len(got) != len(want):
                bad.append(f'{name}: {len(got)} outputs on the card, '
                           f'{len(want)} on the CPU')
                continue
            # the CPU's results go to the card for the comparison, which
            # there takes a few passes over each output instead of
            # seconds of the host's time
            for i, (a, b) in enumerate(zip(got, want)):
                if a.device.type != 'cuda':
                    bad.append(f'{name} output {i} lies on {a.device}')
                    continue
                b = b.to(a.device)
                if a.dtype != b.dtype or a.shape != b.shape:
                    bad.append(f'{name} output {i}: {a.dtype} '
                               f'{tuple(a.shape)} on the card, {b.dtype} '
                               f'{tuple(b.shape)} on the CPU')
                    continue
                if family == 'exact' or not (b.is_floating_point()
                                             or b.is_complex()):
                    if not torch.equal(a, b) and not (
                            b.is_floating_point() and bool(torch.equal(
                                a.isnan(), b.isnan())) and torch.equal(
                                a.nan_to_num(), b.nan_to_num())):
                        bad.append(f'{name} output {i} ({dtype}) is not '
                                   'exact')
                    continue
                gap, scale = _tlib_gap(a, b)
                tol = TLIB_TOL[(family, dtype)]
                key = f'{family} {str(dtype)[6:]}'
                worst[key] = max(worst.get(key, 0.0), gap / scale)
                if gap > tol * scale:
                    bad.append(f'{name} output {i} ({dtype}): card vs CPU '
                               f'gap {gap:.3e} over {scale:.3e} exceeds '
                               f'{tol}')
            if len(got) == len(want) and all(
                    a.shape == b.shape and a.dtype == b.dtype
                    and torch.equal(a, b.to(a.device))
                    for a, b in zip(got, want)):
                exact += 1
    if bad:
        raise AssertionError('tensor_lib: ' + '; '.join(bad))
    return ran, exact, worst


def _tlib_moments(x, mean, var, what):
    """``x``'s mean and variance within 6 standard errors of the law's
    (the variance's standard error from the 4th central moment)."""
    x = x.double().reshape(-1)
    n = x.numel()
    m, v = float(x.mean()), float(x.var())
    m4 = float(((x - m) ** 4).mean())
    se_m, se_v = (var / n) ** 0.5, ((m4 - var * var) / n) ** 0.5
    if abs(m - mean) > 6 * se_m or abs(v - var) > 6 * se_v:
        raise AssertionError(f'tensor_lib {what}: mean {m} var {v} off '
                             f'the law\'s {mean}, {var} (n {n})')
    return {'mean': m, 'var': v}


def tensor_random_phase(P):
    """The random ops on the card: the same seed repeats the bits,
    another seed changes them, the moments follow the laws at 2^24
    draws, multinomial passes a chi-square test, randperm and shuffle
    give permutations, and a get/set_cuda_rng_state round trip repeats
    the draws."""
    P.set_device('cuda')
    n = TLIB_DRAWS
    draws = {
        'rand': lambda: P.rand([n]), 'randn': lambda: P.randn([n]),
        'standard_normal': lambda: P.standard_normal([n]),
        'randint': lambda: P.randint(0, 10, [n]),
        'randint_like': lambda: P.randint_like(P.zeros([n], 'int32'), 0,
                                               10),
        'uniform': lambda: P.uniform([n], min=2.0, max=3.0),
        'normal': lambda: P.normal(1.0, 2.0, [n]),
        'gaussian': lambda: P.gaussian([n], -1.0, 0.5),
        'randperm': lambda: P.randperm(1 << 20),
        'bernoulli': lambda: P.bernoulli(P.full([n], 0.3)),
        'multinomial': lambda: P.multinomial(P.ones([1 << 16, 16]) / 16, 4),
        'poisson': lambda: P.poisson(P.full([n], 3.0)),
        'shuffle': lambda: P.shuffle(P.arange(1 << 20)),
        'uniform_': lambda: P.uniform_(P.zeros([n])),
        'normal_': lambda: P.normal_(P.zeros([n]), 1.0, 3.0),
        'exponential_': lambda: P.exponential_(P.zeros([n]), 2.0),
        'create_parameter': lambda: P.create_parameter([TLIB_N, TLIB_N],
                                                       'float32'),
    }
    try:
        for name, draw in draws.items():
            P.seed(11)
            a = draw()
            P.seed(11)
            b = draw()
            c = draw()
            P.seed(12)
            d = draw()
            if a.device.type != 'cuda':
                raise AssertionError(f'tensor_lib {name} drew on {a.device}')
            if not torch.equal(a, b) or torch.equal(b, c) \
                    or torch.equal(a, d):
                raise AssertionError(f'tensor_lib {name}: the seed does '
                                     'not decide the bits')
        P.seed(5)
        laws = {
            'rand': _tlib_moments(P.rand([n]), 0.5, 1 / 12, 'rand'),
            'randn': _tlib_moments(P.randn([n]), 0.0, 1.0, 'randn'),
            'uniform': _tlib_moments(P.uniform([n], min=2.0, max=3.0), 2.5,
                                     1 / 12, 'uniform'),
            'normal': _tlib_moments(P.normal(1.0, 2.0, [n]), 1.0, 4.0,
                                    'normal'),
            'gaussian': _tlib_moments(P.gaussian([n], -1.0, 0.5), -1.0,
                                      0.25, 'gaussian'),
            'normal_': _tlib_moments(P.normal_(P.zeros([n]), 1.0, 3.0),
                                     1.0, 9.0, 'normal_'),
            'uniform_': _tlib_moments(P.uniform_(P.zeros([n])), 0.0,
                                      1 / 3, 'uniform_'),
            'exponential_': _tlib_moments(P.exponential_(P.zeros([n]), 2.0),
                                          0.5, 0.25, 'exponential_'),
            'poisson': _tlib_moments(P.poisson(P.full([n], 3.0)), 3.0, 3.0,
                                     'poisson'),
            'bernoulli': _tlib_moments(P.bernoulli(P.full([n], 0.3)), 0.3,
                                       0.21, 'bernoulli'),
            'randint': _tlib_moments(P.randint(0, 10, [n]), 4.5, 8.25,
                                     'randint'),
        }
        p = torch.arange(1, 11, dtype=torch.float32, device='cuda') / 55.0
        chi2 = {}
        for what, sample in (
                ('multinomial replacement', lambda: P.multinomial(
                    p, n, replacement=True)),
                ('multinomial gumbel first draw', lambda: P.multinomial(
                    p.expand(n // 16, 10).contiguous(), 3)[:, 0])):
            s = sample()
            counts = torch.bincount(s.reshape(-1), minlength=10).double()
            expect = p.double() * s.numel()
            chi2[what] = float(((counts - expect) ** 2 / expect).sum())
            if chi2[what] > TLIB_CHI2_999[9]:
                raise AssertionError(f'tensor_lib {what}: chi-square '
                                     f'{chi2[what]:.2f} > {TLIB_CHI2_999[9]}')
        rows = P.multinomial(p.expand(4096, 10).contiguous(), 10)
        if not torch.equal(rows.sort(dim=1)[0], torch.arange(
                10, device='cuda').expand(4096, 10)):
            raise AssertionError('tensor_lib multinomial without '
                                 'replacement repeated a category')
        for what, perm in (('randperm', P.randperm(1 << 20)),
                           ('shuffle', P.shuffle(P.arange(1 << 20)))):
            if not torch.equal(perm.sort()[0], torch.arange(
                    1 << 20, device='cuda')):
                raise AssertionError(f'tensor_lib {what} is not a '
                                     'permutation')
        P.rand([7])
        state = P.get_cuda_rng_state()
        first = [P.randn([n]), P.randint(0, 100, [1 << 20]),
                 P.multinomial(p, 1 << 20, replacement=True)]
        P.set_cuda_rng_state(state)
        again = [P.randn([n]), P.randint(0, 100, [1 << 20]),
                 P.multinomial(p, 1 << 20, replacement=True)]
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError('tensor_lib: set_cuda_rng_state did not '
                                 'repeat the draws')
    finally:
        P.set_device(None)
    return {'draws': n, 'laws': laws, 'chi2': chi2,
            'chi2_limit_999': TLIB_CHI2_999[9]}


def tensor_grad_phase(P):
    """``grad`` at the training path's shape (gpt_small, B 8 x T 1024,
    bf16 O2, the fused head): ``P.grad(loss, params)`` equals
    ``loss.backward()``'s ``.grad``s bit for bit, and the ``grad`` pass
    launches exactly 25 LayerNorm, 12 flash forward, 12 dq and 12 dk/dv
    kernels (the main path's counts)."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    model = gpt_small(device='cuda', seed=0, **TRAIN_MODEL_KW)
    trainer = _trainer(model, amp_o2=True)
    L = model.config.num_layers
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    params = [p for p in model.parameters() if p.requires_grad]
    model.train()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with trainer._autocast():
        loss = model.loss(model(ids), ids).float().mean()
    grads = P.grad(loss, params, retain_graph=True)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {'fused_layer_norm': 2 * L + 1, 'flash_attention_fwd': L,
            'flash_attention_bwd_dq': L, 'flash_attention_bwd_dkv': L}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f'tensor_lib grad: {k} launched '
                                 f'{launches[k]} times, expected {n}')
    if any(p.grad is not None for p in params):
        raise AssertionError('tensor_lib grad: P.grad touched a .grad')
    loss.backward()
    same = sum(torch.equal(g, p.grad) for g, p in zip(grads, params))
    if same != len(params):
        raise AssertionError(f'tensor_lib grad: {len(params) - same} of '
                             f'{len(params)} gradients differ from '
                             'backward()\'s')
    out = {'loss': loss.item(), 'params': len(params), 'bit_equal': same,
           'grad_s': grad_s, 'launches': launches}
    del model, trainer, grads, loss, params
    _free()
    return out


def _tlib_block_penalty(block, h, between=lambda: None):
    """WGAN-GP-style: the block's input gradient under ``create_graph``,
    its per-token norm's distance from 1 squared, averaged, then
    ``backward`` to the block's parameters and the input; ``between``
    runs after the ``create_graph`` pass."""
    import paddle_tpu_torch as P
    g, = P.grad(block(h)[0].sum(), h, create_graph=True)
    between()
    penalty = ((g.square().sum(dim=-1).sqrt() - 1.0) ** 2).mean()
    penalty.backward()
    return penalty


# the launches of the block's second order, f32 with the fused GEMM+GELU
# MLP: the forward and the create_graph pass launch every kernel of the
# block (dq, dk/dv and dz for the first-order values); the penalty's
# backward differentiates the kernels' backwards through their plain
# composition and reaches the forward's flash node once more (through
# the second LayerNorm's input), not its GEMM+GELU node
TLIB_SECOND_ORDER_LAUNCHES = {
    'create_graph': {'fused_layer_norm': 2, 'flash_attention_fwd': 1,
                     'flash_attention_bwd_dq': 1,
                     'flash_attention_bwd_dkv': 1,
                     'fused_linear_gelu_fwd': 1, 'fused_linear_gelu_bwd': 1},
    'penalty_backward': {'fused_layer_norm': 0, 'flash_attention_fwd': 0,
                         'flash_attention_bwd_dq': 1,
                         'flash_attention_bwd_dkv': 1,
                         'fused_linear_gelu_fwd': 0,
                         'fused_linear_gelu_bwd': 0},
}


def tensor_second_order_phase(P):
    """A second order through one gpt_small block on the card (H 768, T
    1024, B 2, f32, causal flash, the fused GEMM+GELU MLP): the
    penalty's gradients match the same computation on the CPU and are
    nonzero on every parameter (the qkv bias by thirds: its key third's
    true gradient is 0, held to 1e-3 of the largest gradient on both
    sides), and each pass launches the kernels
    ``TLIB_SECOND_ORDER_LAUNCHES`` names, exactly."""
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    fgl = _ops_module('fused_gelu_linear')
    res = {}
    fgl.USE_PALLAS_MLP = True
    try:
        for dev in ('cuda', 'cpu'):
            model = gpt_small(device=dev, seed=0, num_layers=1,
                              max_seq_len=TRAIN_SEQ, dropout=0.0)
            model.train()
            block = model.gpt.blocks[0]
            h_np = np.random.RandomState(3).randn(
                TLIB_BLOCK_BATCH, TRAIN_SEQ,
                model.config.hidden_size).astype(np.float32)
            h = torch.tensor(h_np, device=dev, requires_grad=True)
            between = lambda: None      # noqa: E731
            if dev == 'cuda':
                def between():
                    torch.cuda.synchronize()
                    res['create_graph'] = launch_counts()
                    _build.reset_launches()
                torch.cuda.synchronize()
                _build.reset_launches()
                t0 = time.perf_counter()
            penalty = _tlib_block_penalty(block, h, between)
            if dev == 'cuda':
                torch.cuda.synchronize()
                res['card_s'] = time.perf_counter() - t0
                res['penalty_backward'] = launch_counts()
            res[dev] = (penalty.item(), h.grad.cpu(),
                        {n: torch.zeros(p.shape) if p.grad is None
                         else p.grad.cpu()
                         for n, p in block.named_parameters()})
            del model, block, h
    finally:
        fgl.USE_PALLAS_MLP = False
    for run, want in TLIB_SECOND_ORDER_LAUNCHES.items():
        for k, n in want.items():
            if res[run][k] != n:
                raise AssertionError(f'tensor_lib second order: {k} '
                                     f'launched {res[run][k]} times in the '
                                     f'{run} pass, expected {n}')
    card, cpu = res['cuda'], res['cpu']
    largest = max(float(g.abs().max()) for g in cpu[2].values())
    worst = {}
    for name, want in [('h', cpu[1])] + sorted(cpu[2].items()):
        got = card[1] if name == 'h' else card[2][name]
        if name == TLIB_CONSTANT_BIAS:
            # the block's last bias adds a constant to its output, which
            # the input gradient does not see: exactly zero on both
            if float(want.abs().max()) or float(got.abs().max()):
                raise AssertionError(f'tensor_lib second order: {name} '
                                     'has a gradient')
            continue
        parts = [(name, got, want)]
        if name.endswith('qkv.bias'):
            third = want.shape[0] // 3
            key = (got[third:2 * third], want[third:2 * third])
            worst[f'{name} k'] = max(float(t.abs().max()) for t in key) \
                / largest
            if worst[f'{name} k'] > 1e-3:
                raise AssertionError(f'tensor_lib second order: {name} key '
                                     f'third {worst[f"{name} k"]:.3e} of the '
                                     'largest gradient')
            parts = [(f'{name} {t}', got[sl], want[sl])
                     for t, sl in (('q', slice(0, third)),
                                   ('v', slice(2 * third, None)))]
        for what, g, w in parts:
            scale = float(w.abs().max())
            if scale == 0.0:
                raise AssertionError(f'tensor_lib second order: the '
                                     f'gradient of {what} is zero')
            worst[what] = float((g - w).abs().max()) / scale
            if worst[what] > TLIB_SECOND_ORDER_TOL:
                raise AssertionError(f'tensor_lib second order: {what} '
                                     f'{worst[what]:.3e} from the CPU')
    rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    if rel > TLIB_SECOND_ORDER_TOL:
        raise AssertionError(f'tensor_lib second order: penalty {card[0]} '
                             f'vs {cpu[0]} on the CPU')
    _free()
    total = {k: res['create_graph'][k] + res['penalty_backward'][k]
             for k in res['create_graph']}
    return {'penalty': card[0], 'penalty_cpu': cpu[0],
            'worst_rel': max(v for k, v in worst.items()
                             if not k.endswith(' k')),
            'key_bias_of_largest': worst['attn.qkv.bias k'],
            'card_s': res['card_s'], 'launches': total,
            'create_graph_launches': res['create_graph'],
            'penalty_backward_launches': res['penalty_backward'],
            'per_tensor': worst}


def tensor_lib_phase():
    """Slice 18: the tensor library and autograd on the card."""
    import paddle_tpu_torch as P
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    with _TlibCalls(P) as calls:
        ran, exact, worst = tensor_ops_vs_cpu(P)
        ops_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        rnd = tensor_random_phase(P)
        rnd_s = time.perf_counter() - t1
    missing = set(P.tensor.__all__) - calls.called
    if missing:
        raise AssertionError(f'tensor_lib: never called on the card: '
                             f'{sorted(missing)}')
    log(f'tensor_lib ({smi}): {ran} calls of every tensor op ran on the '
        f'card against the CPU in {ops_s:.1f} s, {exact} exactly equal; '
        'largest gap over scale by family: '
        + ', '.join(f'{k} {v:.3e} (tol {TLIB_TOL[(k.split()[0], getattr(torch, k.split()[1]))]})'
                    for k, v in sorted(worst.items())))
    log(f'tensor_lib random ({smi}): every draw repeats under its seed and '
        f'changes with another; moments within 6 SE at {rnd["draws"]} '
        f'draws ({", ".join(f"{k} {v['mean']:.5f}" for k, v in rnd["laws"].items())}); '
        f'chi-square {", ".join(f"{k} {v:.2f}" for k, v in rnd["chi2"].items())} '
        f'< {rnd["chi2_limit_999"]}; permutations and the rng-state round '
        f'trip hold ({rnd_s:.1f} s); {len(calls.called)} of the '
        f'{len(P.tensor.__all__)} names of tensor.__all__ called')
    grad = tensor_grad_phase(P)
    log(f'tensor_lib grad ({smi}): gpt_small B {TRAIN_BATCH} T {TRAIN_SEQ} '
        f'bf16 O2 fused head, loss {grad["loss"]:.4f}; paddle.grad equals '
        f'backward() bit for bit on {grad["bit_equal"]}/{grad["params"]} '
        f'parameters; forward + grad {grad["grad_s"]:.3f} s; launches '
        + ', '.join(f'{k} {grad["launches"][k]}' for k in (
            'fused_layer_norm', 'flash_attention_fwd',
            'flash_attention_bwd_dq', 'flash_attention_bwd_dkv')))
    second = tensor_second_order_phase(P)
    kernels = ('fused_layer_norm', 'flash_attention_fwd',
               'flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
               'fused_linear_gelu_fwd', 'fused_linear_gelu_bwd')
    log(f'tensor_lib second order ({smi}): one gpt_small block with the '
        f'fused GEMM+GELU MLP, B {TLIB_BLOCK_BATCH} T {TRAIN_SEQ} f32, '
        f'penalty {second["penalty"]:.6f} (CPU {second["penalty_cpu"]:.6f}); '
        f'worst gradient gap {second["worst_rel"]:.3e} of its max (tol '
        f'{TLIB_SECOND_ORDER_TOL}), every parameter nonzero, the qkv key '
        f'bias third {second["key_bias_of_largest"]:.3e} of the largest '
        f'gradient; card {second["card_s"]:.3f} s; launches in the '
        'create_graph pass ' + ', '.join(
            f'{k} {second["create_graph_launches"][k]}' for k in kernels)
        + '; in the penalty\'s backward ' + ', '.join(
            f'{k} {second["penalty_backward_launches"][k]}'
            for k in kernels))
    total = time.perf_counter() - t0
    log(f'tensor_lib: phase {total:.1f} s')
    return {'ops_ran': ran, 'ops_exact': exact, 'worst_by_family': worst,
            'ops_s': ops_s, 'random': rnd,
            'grad': {k: v for k, v in grad.items() if k != 'launches'},
            'second_order': {k: v for k, v in second.items()
                             if k not in ('launches', 'per_tensor')},
            'names_called': len(calls.called),
            'phase_s': total, 'smi': smi,
            'launches': grad['launches'],
            'second_order_launches': second['launches']}


# -- the vision half of nn: DDPM's U-Net, DCGAN and every new name ---------

# DDPM's CIFAR-10 model (Ho, Jain & Abbeel 2020, arXiv:2006.11239,
# Appendix B; the authors' released unet): base channels 128 at 32^2,
# multipliers (1, 2, 2, 2) down to 4^2, two residual blocks a level,
# GroupNorm(32) and SiLU, dropout 0.1, self-attention at 16^2 and in the
# middle block, T 1000 with the linear betas 1e-4 .. 0.02
DDPM_KW = dict(ch=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2,
               attn_resolutions=(16,), dropout=0.1, resolution=32, groups=32)
DDPM_T, DDPM_BETAS = 1000, (1e-4, 0.02)
DDPM_BATCH, DDPM_LR, DDPM_CLIP = 128, 2e-4, 1.0
DDPM_FUSED_K = 5
DDPM_PARITY_BATCH = 8
# attention blocks a forward: 2 down at 16^2, 1 in the middle at 4^2,
# 3 up at 16^2, each one softmax launch over [B * HW, HW]
DDPM_SOFTMAX_ROWS = {256: 5, 16: 1}
# DCGAN (Radford, Metz & Chintala 2016, arXiv:1511.06434, section 3-4
# and Fig. 1): z of 100 projected to 4 x 4 x 1024, four 5 x 5 stride-2
# transposed convolutions 1024 -> 512 -> 256 -> 128 -> 3 at 64^2
# (BatchNorm and ReLU, tanh at the output), the discriminator their
# mirror with LeakyReLU 0.2 and no BatchNorm on its input layer; weights
# N(0, 0.02), Adam 2e-4 with beta1 0.5 for both, B 128
DCGAN_KW = dict(nz=100, ngf=128, ndf=128, image=64)
DCGAN_BATCH, DCGAN_LR, DCGAN_BETA1 = 128, 2e-4, 0.5
DCGAN_WARMUP, DCGAN_ITERS = 2, 5
DCGAN_PARITY_BATCH = 8


def ddpm_unet(paddle, ch, ch_mult, num_res_blocks, attn_resolutions,
              dropout, resolution, groups, in_ch=3, T=DDPM_T,
              betas=DDPM_BETAS):
    """DDPM's noise-prediction U-Net built from the public ``nn`` layers
    (``paddle`` is either package).  ``model(x0, t, noise)`` forms
    ``x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise`` and returns the
    predicted noise: the sinusoidal embedding of ``t`` through a
    two-layer SiLU MLP, a 3 x 3 stem, residual blocks (GroupNorm, SiLU,
    3 x 3 conv, plus the projected embedding, GroupNorm, SiLU, dropout,
    3 x 3 conv, a 1 x 1 shortcut where the width changes), attention
    blocks (GroupNorm, 1 x 1 q, k, v, ``softmax(q^T k / sqrt(C))`` over
    the keys through ``F.softmax``, a 1 x 1 output), stride-2 3 x 3
    ``'SAME'`` convolutions down, nearest ``interpolate`` x 2 and a 3 x 3
    conv up, and GroupNorm, SiLU and a 3 x 3 conv out."""
    nn = paddle.nn
    F = nn.functional

    class ResBlock(nn.Layer):
        def __init__(self, cin, cout):
            super().__init__()
            self.norm1 = nn.GroupNorm(groups, cin)
            self.conv1 = nn.Conv2D(cin, cout, 3, padding=1)
            self.temb_proj = nn.Linear(4 * ch, cout)
            self.norm2 = nn.GroupNorm(groups, cout)
            self.dropout = nn.Dropout(dropout)
            self.conv2 = nn.Conv2D(cout, cout, 3, padding=1)
            self.shortcut = nn.Conv2D(cin, cout, 1) if cin != cout else \
                nn.Identity()

        def forward(self, x, temb):
            h = self.conv1(F.silu(self.norm1(x)))
            h = paddle.add(h, paddle.unsqueeze(
                self.temb_proj(F.silu(temb)), [2, 3]))
            h = self.conv2(self.dropout(F.silu(self.norm2(h))))
            return paddle.add(self.shortcut(x), h)

    class AttnBlock(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.norm = nn.GroupNorm(groups, c)
            self.q = nn.Conv2D(c, c, 1)
            self.k = nn.Conv2D(c, c, 1)
            self.v = nn.Conv2D(c, c, 1)
            self.proj_out = nn.Conv2D(c, c, 1)

        def forward(self, x):
            B, C, H, W = x.shape
            h = self.norm(x)
            q, k, v = (paddle.reshape(f(h), [B, C, H * W])
                       for f in (self.q, self.k, self.v))
            w = paddle.scale(paddle.matmul(q, k, transpose_x=True),
                             C ** -0.5)
            w = F.softmax(w, axis=-1)
            h = paddle.reshape(paddle.matmul(v, w, transpose_y=True),
                               [B, C, H, W])
            return paddle.add(x, self.proj_out(h))

    class Up(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.conv = nn.Conv2D(c, c, 3, padding=1)

        def forward(self, x):
            return self.conv(F.interpolate(x, scale_factor=2,
                                           mode='nearest'))

    class UNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.config = dict(ch=ch, ch_mult=tuple(ch_mult),
                               num_res_blocks=num_res_blocks,
                               attn_resolutions=tuple(attn_resolutions),
                               resolution=resolution, groups=groups, T=T)
            half = ch // 2
            freqs = np.exp(-math.log(10000.0) * np.arange(half)
                           / (half - 1)).astype(np.float32)
            abar = np.cumprod(1.0 - np.linspace(betas[0], betas[1], T))
            for name, value in (('freqs', freqs),
                                ('sqrt_abar', np.sqrt(abar)),
                                ('sqrt_1m_abar', np.sqrt(1.0 - abar))):
                self.register_buffer(name, paddle.to_tensor(
                    value.astype(np.float32)), persistable=False)
            self.temb0 = nn.Linear(ch, 4 * ch)
            self.temb1 = nn.Linear(4 * ch, 4 * ch)
            self.conv_in = nn.Conv2D(in_ch, ch, 3, padding=1)
            self.down, self.down_attn = nn.LayerList(), nn.LayerList()
            self.downsample = nn.LayerList()
            chans, cur, res = [ch], ch, resolution
            for i, mult in enumerate(ch_mult):
                for _ in range(num_res_blocks):
                    self.down.append(ResBlock(cur, ch * mult))
                    cur = ch * mult
                    self.down_attn.append(AttnBlock(cur) if res in
                                          attn_resolutions else nn.Identity())
                    chans.append(cur)
                if i != len(ch_mult) - 1:
                    self.downsample.append(nn.Conv2D(cur, cur, 3, stride=2,
                                                     padding='SAME'))
                    chans.append(cur)
                    res //= 2
            self.mid1, self.mid_attn = ResBlock(cur, cur), AttnBlock(cur)
            self.mid2 = ResBlock(cur, cur)
            self.up, self.up_attn = nn.LayerList(), nn.LayerList()
            self.upsample = nn.LayerList()
            for i, mult in reversed(list(enumerate(ch_mult))):
                for _ in range(num_res_blocks + 1):
                    self.up.append(ResBlock(cur + chans.pop(), ch * mult))
                    cur = ch * mult
                    self.up_attn.append(AttnBlock(cur) if res in
                                        attn_resolutions else nn.Identity())
                if i != 0:
                    self.upsample.append(Up(cur))
                    res *= 2
            self.norm_out = nn.GroupNorm(groups, cur)
            self.conv_out = nn.Conv2D(cur, in_ch, 3, padding=1)

        def eps(self, x, t):
            args = paddle.multiply(paddle.unsqueeze(
                paddle.cast(t, 'float32'), [1]),
                paddle.unsqueeze(self.freqs, [0]))
            emb = paddle.concat([paddle.sin(args), paddle.cos(args)], axis=1)
            temb = self.temb1(F.silu(self.temb0(emb)))
            hs = [self.conv_in(x)]
            n = num_res_blocks
            for i in range(len(ch_mult)):
                for j in range(n):
                    b = i * n + j
                    hs.append(self.down_attn[b](self.down[b](hs[-1], temb)))
                if i != len(ch_mult) - 1:
                    hs.append(self.downsample[i](hs[-1]))
            h = self.mid2(self.mid_attn(self.mid1(hs[-1], temb)), temb)
            for i in range(len(ch_mult)):
                for j in range(n + 1):
                    b = i * (n + 1) + j
                    h = self.up[b](paddle.concat([h, hs.pop()], axis=1),
                                   temb)
                    h = self.up_attn[b](h)
                if i != len(ch_mult) - 1:
                    h = self.upsample[i](h)
            return self.conv_out(F.silu(self.norm_out(h)))

        def forward(self, x0, t, noise):
            a = paddle.reshape(paddle.gather(self.sqrt_abar, t),
                               [-1, 1, 1, 1])
            s = paddle.reshape(paddle.gather(self.sqrt_1m_abar, t),
                               [-1, 1, 1, 1])
            x = paddle.add(paddle.multiply(a, x0), paddle.multiply(s, noise))
            return self.eps(x, t)

    return UNet()


def ddpm_loss(paddle):
    """The simplified objective: MSE between predicted and true noise."""
    return lambda pred, noise: paddle.nn.functional.mse_loss(pred, noise)


def ddpm_batch(batch, resolution=32, T=DDPM_T, seed=0):
    """``(x0, t, noise, noise)``: seeded synthetic images at CIFAR-10's
    shape in [-1, 1] (smooth 4 x 4 blocks plus texture), ``t`` uniform
    in [0, T) and the noise N(0, 1), all drawn on the host; the noise is
    the model's input and the loss's label."""
    rs = np.random.RandomState(seed)
    r = resolution // 4
    coarse = np.kron(rs.randn(batch, 3, 4, 4), np.ones((r, r)))
    x0 = np.tanh(coarse + 0.3 * rs.randn(batch, 3, resolution, resolution))
    t = rs.randint(0, T, batch).astype(np.int64)
    noise = rs.randn(batch, 3, resolution, resolution).astype(np.float32)
    return x0.astype(np.float32), t, noise, noise


def ddpm_trainer(paddle, model, amp_o2, fused_steps=None, trainer_cls=None,
                 strategy_cls=None):
    """Adam 2e-4 with a global-norm clip of 1.0 on the MSE objective,
    bf16 O2 when ``amp_o2``, through the package's ``ParallelTrainer``
    (the port's unless the classes are given), three model inputs."""
    if trainer_cls is None:
        from paddle_tpu_torch.distributed.fleet import DistributedStrategy
        from paddle_tpu_torch.parallel import ParallelTrainer
        trainer_cls, strategy_cls = ParallelTrainer, DistributedStrategy
    strategy = strategy_cls()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs['use_pure_fp16'] = True
    opt = paddle.optimizer.Adam(
        learning_rate=DDPM_LR, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(DDPM_CLIP))
    return trainer_cls(model, opt, ddpm_loss(paddle), strategy=strategy,
                       n_inputs=3, fused_steps=fused_steps)


def dcgan_models(paddle, nz, ngf, ndf, image):
    """DCGAN's generator and discriminator from the public ``nn`` layers
    (``paddle`` is either package), every convolution and linear weight
    N(0, 0.02), no bias where a BatchNorm follows.  ``G(z)`` -> images
    ``[B, 3, image, image]`` in (-1, 1); ``D(x)`` -> one logit a
    sample."""
    nn = paddle.nn
    F = nn.functional
    n_up = int(round(math.log2(image // 4)))
    gch = [ngf * 2 ** (n_up - 1 - i) for i in range(n_up)] + [3]
    dch = [3] + [ndf * 2 ** i for i in range(n_up)]

    def w():
        return paddle.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))

    class Generator(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(nz, 16 * gch[0], weight_attr=w(),
                                bias_attr=False)
            self.bn0 = nn.BatchNorm2D(gch[0])
            self.ups = nn.LayerList([nn.Conv2DTranspose(
                a, b, 5, stride=2, padding=2, output_padding=1,
                weight_attr=w(), bias_attr=False if b != 3 else None)
                for a, b in zip(gch[:-1], gch[1:])])
            self.bns = nn.LayerList([nn.BatchNorm2D(b) for b in gch[1:-1]])

        def forward(self, z):
            h = F.relu(self.bn0(paddle.reshape(self.fc(z),
                                               [-1, gch[0], 4, 4])))
            for i, up in enumerate(self.ups):
                h = up(h)
                h = F.relu(self.bns[i](h)) if i < n_up - 1 else paddle.tanh(h)
            return h

    class Discriminator(nn.Layer):
        def __init__(self):
            super().__init__()
            self.convs = nn.LayerList([nn.Conv2D(
                a, b, 5, stride=2, padding=2, weight_attr=w(),
                bias_attr=None if a == 3 else False)
                for a, b in zip(dch[:-1], dch[1:])])
            self.bns = nn.LayerList([nn.BatchNorm2D(b) for b in dch[2:]])
            self.fc = nn.Linear(16 * dch[-1], 1, weight_attr=w())

        def forward(self, x):
            h = x
            for i, conv in enumerate(self.convs):
                h = conv(h)
                if i:
                    h = self.bns[i - 1](h)
                h = F.leaky_relu(h, 0.2)
            return self.fc(paddle.flatten(h, 1))

    G, D = Generator(), Discriminator()
    G.config = D.config = dict(nz=nz, ngf=ngf, ndf=ndf, image=image)
    return G, D


def dcgan_optimizers(paddle, G, D):
    return tuple(paddle.optimizer.Adam(learning_rate=DCGAN_LR,
                                       beta1=DCGAN_BETA1,
                                       parameters=m.parameters())
                 for m in (G, D))


def dcgan_iteration(paddle, G, D, opt_g, opt_d, real, z, grads=None):
    """One D step and one G step, as a user writes them: the
    discriminator's BCE on real (label 1) and detached fake (label 0)
    images, ``backward()``, ``step()``; then the generator's BCE of the
    fakes labelled real.  Returns ``(loss_d, loss_g)``; with a dict
    ``grads``, each network's gradients as its ``step()`` sees them."""
    F = paddle.nn.functional
    opt_d.clear_grad()
    opt_g.clear_grad()
    fake = G(z)
    d_real, d_fake = D(real), D(fake.detach())
    loss_d = paddle.add(
        F.binary_cross_entropy_with_logits(d_real, paddle.ones_like(d_real)),
        F.binary_cross_entropy_with_logits(d_fake,
                                           paddle.zeros_like(d_fake)))
    loss_d.backward()
    if grads is not None:
        grads.update({f'D.{n}': p.grad.detach().clone()
                      for n, p in D.named_parameters()})
    opt_d.step()
    opt_d.clear_grad()
    d_fake = D(fake)
    loss_g = F.binary_cross_entropy_with_logits(d_fake,
                                                paddle.ones_like(d_fake))
    loss_g.backward()
    if grads is not None:
        grads.update({f'G.{n}': p.grad.detach().clone()
                      for n, p in G.named_parameters()})
    opt_g.step()
    return loss_d, loss_g


def dcgan_batch(batch, nz, image, seed=0):
    """Seeded synthetic images at 64^2 x 3 in [-1, 1] and N(0, 1)
    noise vectors, drawn on the host."""
    rs = np.random.RandomState(seed)
    r = image // 8
    real = np.tanh(np.kron(rs.randn(batch, 3, 8, 8), np.ones((r, r)))
                   + 0.2 * rs.randn(batch, 3, image, image))
    return real.astype(np.float32), rs.randn(batch, nz).astype(np.float32)


def conv_linear_flops(model, *inputs):
    """Forward flops of ``model(*inputs)`` in its convolutions (2 x
    output elements x in/groups x kernel; a transposed one 2 x input
    elements x out/groups x kernel) and linears (2 x rows x in x out),
    counted by hooks on one forward."""
    import paddle_tpu_torch as paddle
    total = [0]

    def hook(layer, ins, out):
        if isinstance(layer, paddle.nn.Linear):
            total[0] += 2 * out.numel() * layer.in_features
        elif isinstance(layer, paddle.nn.Conv2DTranspose):
            total[0] += 2 * ins[0].numel() * math.prod(layer.kernel_size) \
                * (layer.out_channels // layer.groups)
        else:
            total[0] += 2 * out.numel() * math.prod(layer.kernel_size) * \
                (layer.in_channels // layer.groups)
    kinds = (paddle.nn.Conv2D, paddle.nn.Conv2DTranspose, paddle.nn.Linear)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def ddpm_step_flops(model, batch):
    """Model flops of one U-Net training step: 3 x (the forward's
    convolution and linear flops, counted at B 1 and scaled, plus each
    attention's two [HW, HW, C] products)."""
    dev = next(model.parameters()).device
    x0, t, noise, _ = (torch.from_numpy(a[:1]).to(dev) for a in batch)
    fwd = conv_linear_flops(model, x0, t, noise)
    cfg = model.config
    attn = 0
    for res, n in ((cfg['resolution'] // 2, 5), (cfg['resolution'] // 8, 1)):
        attn += n * 2 * 2 * (res * res) ** 2 * 2 * cfg['ch']
    return 3 * (fwd + attn) * len(batch[0])


def _ddpm_per_step():
    """The U-Net's kernel launches a training step: the softmax kernel
    once an attention block, on the design the wrapper names for each
    row width (fresh, aligned f32 scores), nothing else."""
    fsm = _ops_module('fused_softmax')
    per = _per_step(1, 0)
    designs = {}
    for width, n in DDPM_SOFTMAX_ROWS.items():
        x = torch.empty(4, width, width, device='cuda')
        design = fsm.design(x, torch.empty_like(x))
        designs[width] = design
        per['fused_softmax'] += n
        per[f'fused_softmax:{design}'] += n
    return per, designs


def ddpm_unet_phase():
    """DDPM's CIFAR-10 U-Net at its published widths trained through
    ``ParallelTrainer`` at bf16 O2: eager steps with the softmax kernel
    launched exactly 6 times a step, ``step_fused`` against eager bit for
    bit, and one f32 step at B 8 against the CPU."""
    import paddle_tpu_torch as paddle
    per_step, designs = _ddpm_per_step()
    paddle.seed(0)
    model = ddpm_unet(paddle, **DDPM_KW)
    n_params = sum(p.numel() for p in model.parameters())
    batch = ddpm_batch(DDPM_BATCH)
    flops = ddpm_step_flops(model, batch)
    log(f'ddpm_unet model: Ho et al. 2020 CIFAR-10 U-Net (ch '
        f'{DDPM_KW["ch"]}, mult {DDPM_KW["ch_mult"]}, '
        f'{DDPM_KW["num_res_blocks"]} blocks a level, attention at '
        f'{DDPM_KW["attn_resolutions"]} and in the middle, GroupNorm '
        f'{DDPM_KW["groups"]}, dropout {DDPM_KW["dropout"]}), {n_params} '
        f'parameters, seed 0; B {DDPM_BATCH} x 3 x '
        f'{DDPM_KW["resolution"]}^2 synthetic, T {DDPM_T}, eps-prediction '
        f'MSE, Adam {DDPM_LR} clip {DDPM_CLIP}, bf16 O2; softmax rows '
        f'{sorted(DDPM_SOFTMAX_ROWS)} take {designs}')
    trainer = ddpm_trainer(paddle, model, amp_o2=True)
    losses, launches, warm_s, dt, peak = _run_steps(
        trainer, batch, TRAIN_WARMUP, TRAIN_STEPS)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    _check_run('ddpm_unet', losses, launches, per_step, steps)
    idle, prof_s = idle_share(lambda: trainer.step(*batch))
    ms_step = dt / TRAIN_STEPS * 1e3
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS_PER_S
    log(f'ddpm_unet: losses {", ".join(f"{x:.4f}" for x in losses)} '
        f'(finite, falling); launches '
        f'{_launch_summary(launches, per_step, steps)}')
    log(f'ddpm_unet: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; '
        f'{TRAIN_STEPS} steps in {dt:.3f} s = {ms_step:.1f} ms/step, '
        f'{DDPM_BATCH * TRAIN_STEPS / dt:.0f} images/s; idle share '
        f'{idle:.4f} over one profiled step ({prof_s * 1e3:.1f} ms there); '
        f'peak max_memory_allocated {peak / 2**30:.2f} GiB; MFU {mfu:.4f} '
        f'= {flops:.4g} flops / (step time * 989e12)')
    summary = {'params': n_params, 'ms_per_step': ms_step,
               'images_per_s': DDPM_BATCH * TRAIN_STEPS / dt,
               'idle_share': idle, 'peak_bytes': peak, 'mfu': mfu,
               'step_flops': flops, 'losses': losses, 'warmup_s': warm_s,
               'softmax_designs': designs, 'launches': launches}
    del model, trainer
    _free()
    summary['fused'] = _graph_vs_eager(
        f'ddpm_unet_fused (B {DDPM_BATCH}, bf16 O2, dropout 0.1)',
        lambda fused_steps=None: ddpm_trainer(
            paddle, ddpm_unet(paddle, **DDPM_KW), amp_o2=True,
            fused_steps=fused_steps),
        tuple(torch.from_numpy(b).cuda() for b in batch), DDPM_FUSED_K,
        DDPM_BATCH, 'images', flops, 'cudnn.deterministic',
        _cudnn_deterministic, per_step=per_step)
    kw = dict(DDPM_KW, dropout=0.0)
    summary['parity'] = _card_vs_cpu(
        f'ddpm_unet B {DDPM_PARITY_BATCH}, dropout 0',
        lambda dev: _seq_model(lambda p: ddpm_unet(p, **kw), dev),
        lambda cfg: ddpm_batch(DDPM_PARITY_BATCH, seed=1), per_step,
        make_trainer=lambda m: ddpm_trainer(paddle, m, amp_o2=False),
        zero_grads=('.k.bias',))
    from paddle_tpu_torch.ops import _build
    _build.reset_launches()
    return summary


def _dcgan_on(dev, batch):
    """G and D seeded at 0 on the CPU, moved to ``dev``, their two Adam
    optimizers, and the seeded batch there."""
    import paddle_tpu_torch as paddle
    paddle.seed(0)
    paddle.set_device('cpu')
    try:
        G, D = dcgan_models(paddle, **DCGAN_KW)
    finally:
        paddle.set_device(None)
    G, D = G.to(dev), D.to(dev)
    opt_g, opt_d = dcgan_optimizers(paddle, G, D)
    real, z = (torch.from_numpy(a).to(dev) for a in dcgan_batch(
        batch, DCGAN_KW['nz'], DCGAN_KW['image']))
    return G, D, opt_g, opt_d, real, z


@contextlib.contextmanager
def _activation_masks(masks, parted, replay):
    """The port's ``F.relu`` and ``F.leaky_relu`` record each call's
    branches (``x >= 0``) into ``masks`` or, with ``replay``, take the
    recorded ones in call order (``parted`` gets where they differ from
    this run's own).  DCGAN's gradients at B 8 jump where an activation
    input within the two devices' rounding of 0 takes one side on the
    card and the other on the CPU (each BatchNorm couples its batch, and
    Adam's first step turns the D gradient's sign into a whole ``lr``),
    so the CPU's run takes the card's branches, as Wide&Deep's parity
    takes its ReLU masks."""
    import paddle_tpu_torch.nn.functional as F
    relu, leaky = F.relu, F.leaky_relu
    recorded = iter(list(masks))

    def forced(x):
        mask = next(recorded).to(x.device)
        parted.append((mask != (x >= 0)).cpu())
        return mask

    def relu_of(x, name=None):
        if not replay:
            masks.append((x >= 0).cpu())
            return relu(x)
        return torch.where(forced(x), x, torch.zeros_like(x))

    def leaky_of(x, negative_slope=0.01, name=None):
        if not replay:
            masks.append((x >= 0).cpu())
            return leaky(x, negative_slope)
        return torch.where(forced(x), x, x * negative_slope)
    F.relu, F.leaky_relu = relu_of, leaky_of
    try:
        yield
    finally:
        F.relu, F.leaky_relu = relu, leaky


def dcgan_phase():
    """DCGAN at its published widths, eager as a user writes it: D and G
    steps through two Adam optimizers, finite losses, no hand-written
    kernel, ms an iteration and the idle share; then one f32 iteration
    at B 8 against the CPU on the card's activation branches
    (``_activation_masks``): losses within 1e-4 and every gradient
    within 1e-3 of its largest magnitude."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import _build
    G, D, opt_g, opt_d, real, z = _dcgan_on('cuda', DCGAN_BATCH)
    n_g = sum(p.numel() for p in G.parameters())
    n_d = sum(p.numel() for p in D.parameters())
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [dcgan_iteration(paddle, G, D, opt_g, opt_d, real, z)
              for _ in range(DCGAN_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    losses += [dcgan_iteration(paddle, G, D, opt_g, opt_d, real, z)
               for _ in range(DCGAN_ITERS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = launch_counts()
    losses = [(float(a.detach()), float(b.detach())) for a, b in losses]
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f'dcgan: non-finite losses {losses}')
    _no_kernel_launches('dcgan', launches)
    idle, prof_s = idle_share(lambda: dcgan_iteration(
        paddle, G, D, opt_g, opt_d, real, z))
    ms = dt / DCGAN_ITERS * 1e3
    flops = 3 * (conv_linear_flops(G, z[:1]) + 2 * conv_linear_flops(
        D, real[:1])) * DCGAN_BATCH
    mfu = flops / (ms / 1e3) / F32_FLOPS_PER_S
    log(f'dcgan model: Radford et al. 2016 (z {DCGAN_KW["nz"]}, G '
        f'1024 -> 512 -> 256 -> 128 -> 3 by 5 x 5 stride-2 '
        f'Conv2DTranspose, D its mirror), G {n_g} and D {n_d} parameters, '
        f'N(0, 0.02), seed 0; B {DCGAN_BATCH} x 3 x 64^2 synthetic, Adam '
        f'{DCGAN_LR} beta1 {DCGAN_BETA1}, f32, eager')
    log(f'dcgan: (D, G) losses {", ".join(f"({a:.4f}, {b:.4f})" for a, b in losses)} '
        f'(finite); no hand-written kernel launched; warm-up '
        f'{DCGAN_WARMUP} iterations {warm_s:.2f} s; {DCGAN_ITERS} D+G '
        f'iterations in {dt:.3f} s = {ms:.1f} ms an iteration, '
        f'{DCGAN_BATCH * DCGAN_ITERS / dt:.0f} images/s; idle share '
        f'{idle:.4f} over one profiled iteration ({prof_s * 1e3:.1f} ms '
        f'there); {flops:.4g} flops an iteration, {mfu:.4f} of the f32 '
        'peak (67e12)')
    summary = {'g_params': n_g, 'd_params': n_d, 'ms_per_iteration': ms,
               'images_per_s': DCGAN_BATCH * DCGAN_ITERS / dt,
               'idle_share': idle, 'losses': losses, 'warmup_s': warm_s,
               'iteration_flops': flops, 'f32_peak_share': mfu,
               'launches': launches}
    del G, D, opt_g, opt_d
    _free()
    got, masks, parted = [], [], []
    for replay, dev in ((False, 'cuda'), (True, 'cpu')):
        G, D, opt_g, opt_d, real, z = _dcgan_on(dev, DCGAN_PARITY_BATCH)
        grads = {}
        with _activation_masks(masks, parted, replay):
            loss_d, loss_g = dcgan_iteration(paddle, G, D, opt_g, opt_d,
                                             real, z, grads)
        got.append((float(loss_d.detach()), float(loss_g.detach()),
                    {n: g.cpu() for n, g in grads.items()}))
    flips = int(sum(int(p.sum()) for p in parted))
    n_masked = sum(m.numel() for m in masks)
    (ld, lg, g_card), (ld0, lg0, g_cpu) = got
    loss_rel = max(abs(ld - ld0) / abs(ld0), abs(lg - lg0) / abs(lg0))
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        rel = float((g_card[name] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    if not (loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL):
        raise AssertionError(
            f'dcgan f32 iteration, card vs CPU: losses ({ld}, {lg}) vs '
            f'({ld0}, {lg0}) (rel {loss_rel:.3e}, tol {PARITY_LOSS_RTOL}); '
            f'worst gradient {worst_name} rel {worst:.3e} (tol '
            f'{PARITY_GRAD_RTOL})')
    log(f'parity: dcgan f32 D+G iteration B {DCGAN_PARITY_BATCH}, card vs '
        f'CPU on the card\'s ReLU and LeakyReLU branches ({flips} of '
        f'{n_masked} inputs took the other side on the CPU): losses '
        f'({ld:.6f}, {lg:.6f}) vs ({ld0:.6f}, {lg0:.6f}) (rel '
        f'{loss_rel:.3e}, tol {PARITY_LOSS_RTOL}); worst of '
        f'{len(g_cpu)} gradients {worst_name} max |diff| / max |grad| '
        f'{worst:.3e} (tol {PARITY_GRAD_RTOL})')
    summary['parity'] = {'loss_rel': loss_rel, 'worst_grad_rel': worst,
                         'worst_grad': worst_name, 'inputs_parted': flips}
    _build.reset_launches()
    return summary


# the names of nn.functional, nn and nn.utils the vision half brings,
# each of which vision_ops calls on the card
VISION_FUNCTIONALS = (
    'conv1d_transpose', 'conv2d_transpose', 'conv3d_transpose',
    'interpolate', 'upsample', 'affine_grid', 'grid_sample', 'group_norm',
    'instance_norm', 'local_response_norm', 'pixel_shuffle', 'unfold',
    'bilinear', 'diag_embed', 'tanh_', 'layer_norm')
VISION_LAYERS = (
    'Conv1DTranspose', 'Conv2DTranspose', 'Conv3DTranspose', 'GroupNorm',
    'InstanceNorm1D', 'InstanceNorm2D', 'InstanceNorm3D',
    'LocalResponseNorm', 'SpectralNorm', 'Upsample', 'UpsamplingNearest2D',
    'UpsamplingBilinear2D', 'Bilinear', 'Unfold', 'PixelShuffle',
    'PairwiseDistance')
VISION_UTILS = ('weight_norm', 'remove_weight_norm', 'spectral_norm')
VISION_TOL = (1e-5, 1e-4)       # f32 forward, gradients: of the scale


def _vision_cases():
    """(name, fn(P, *tensors), [input shapes]) for each call of
    the phase: ResNet-stage activations, the U-Net's and DCGAN's own
    shapes, every interpolate mode up and down, every grid_sample mode x
    padding x align_corners, 1/2/3-d transposes with groups, dilation,
    asymmetric pads and output_size, NCHW and NHWC."""
    def fn(name, *a, **kw):
        return lambda P, *ts: getattr(P.nn.functional, name)(*ts, *a, **kw)

    def layer(name, *a, **kw):
        return lambda P, *ts: _seeded_on_cpu(
            P, lambda: getattr(P.nn, name)(*a, **kw), ts[0])(*ts)
    cases = [
        ('group_norm resnet', fn('group_norm', 32), [(32, 256, 56, 56)]),
        ('group_norm unet', lambda P, x, w, b: P.nn.functional.group_norm(
            x, 32, 1e-5, w, b), [(128, 256, 16, 16), (256,), (256,)]),
        ('group_norm nhwc', lambda P, x: P.nn.functional.group_norm(
            x, 8, data_format='NHWC'), [(16, 28, 28, 64)]),
        ('instance_norm', lambda P, x, w, b: P.nn.functional.instance_norm(
            x, weight=w, bias=b), [(32, 256, 56, 56), (256,), (256,)]),
        ('local_response_norm', fn('local_response_norm', 5),
         [(32, 96, 55, 55)]),
        ('layer_norm 2 axes', lambda P, x, w, b: P.nn.functional.layer_norm(
            x, [56, 56], w, b), [(32, 64, 56, 56), (56, 56), (56, 56)]),
        ('pixel_shuffle', fn('pixel_shuffle', 2), [(32, 256, 28, 28)]),
        ('pixel_shuffle nhwc', fn('pixel_shuffle', 2, 'NHWC'),
         [(32, 28, 28, 256)]),
        ('unfold', fn('unfold', 3, 1, 1), [(16, 64, 28, 28)]),
        ('bilinear', fn('bilinear'), [(512, 64), (512, 32), (128, 64, 32),
                                      (128,)]),
        ('diag_embed', fn('diag_embed', 1, 0, 2), [(64, 8, 128)]),
        ('tanh_', lambda P, x: P.nn.functional.tanh_(x * 1.0),
         [(32, 64, 56, 56)]),
        ('affine_grid', fn('affine_grid', [32, 3, 64, 64]), [(32, 2, 3)]),
    ]
    for mode in ('nearest', 'bilinear', 'bicubic', 'area'):
        for size in ([112, 112], [28, 20]):
            cases.append((f'interpolate {mode} {size}', fn(
                'interpolate', size=size, mode=mode), [(16, 64, 56, 56)]))
    cases += [
        ('interpolate unet x2', fn('interpolate', scale_factor=2),
         [(128, 256, 16, 16)]),
        ('interpolate linear', fn('interpolate', size=[300], mode='linear',
                                  data_format='NCW'), [(32, 64, 128)]),
        ('interpolate trilinear', fn('interpolate', scale_factor=1.5,
                                     mode='trilinear'), [(4, 16, 16, 16, 16)]),
        ('interpolate nhwc', fn('interpolate', size=[64, 48],
                                mode='bilinear', data_format='NHWC'),
         [(32, 56, 56, 64)]),
        ('upsample', fn('upsample', scale_factor=2, mode='bilinear'),
         [(32, 64, 28, 28)]),
    ]
    for mode in ('bilinear', 'nearest'):
        for pad in ('zeros', 'border', 'reflection'):
            for align in (True, False):
                cases.append((f'grid_sample {mode} {pad} {align}', fn(
                    'grid_sample', mode=mode, padding_mode=pad,
                    align_corners=align), [(32, 64, 56, 56),
                                           ('grid', 32, 48, 40, 2)]))
    cases += [
        ('conv2d_transpose dcgan', fn('conv2d_transpose', stride=2,
                                      padding=2, output_padding=1),
         [(4, 512, 8, 8), (512, 256, 5, 5)]),
        ('conv2d_transpose groups dilation nhwc', fn(
            'conv2d_transpose', stride=2, padding=[(0, 2), (1, 1)],
            groups=4, dilation=2, data_format='NHWC'),
         [(8, 28, 28, 64), (64, 16, 3, 3), (64,)]),
        ('conv2d_transpose output_size', fn(
            'conv2d_transpose', stride=2, padding=1, output_size=[56, 56]),
         [(8, 128, 28, 28), (128, 64, 3, 3), (64,)]),
        ('conv1d_transpose', fn('conv1d_transpose', stride=3, padding=[
            (2, 0)], groups=2, output_size=[383]), [(8, 64, 128),
                                                   (64, 16, 4)]),
        ('conv3d_transpose', fn('conv3d_transpose', stride=2, padding=1,
                                output_padding=1, data_format='NDHWC'),
         [(2, 8, 8, 8, 32), (32, 16, 3, 3, 3), (16,)]),
        ('Conv2DTranspose', layer('Conv2DTranspose', 256, 128, 5, stride=2,
                                  padding=2, output_padding=1),
         [(4, 256, 16, 16)]),
        ('Conv1DTranspose', layer('Conv1DTranspose', 32, 16, 3, stride=2),
         [(8, 32, 64)]),
        ('Conv3DTranspose', layer('Conv3DTranspose', 16, 8, 2, stride=2),
         [(2, 16, 8, 8, 8)]),
        ('GroupNorm', layer('GroupNorm', 32, 256), [(32, 256, 28, 28)]),
        ('InstanceNorm1D', layer('InstanceNorm1D', 64), [(32, 64, 512)]),
        ('InstanceNorm2D', layer('InstanceNorm2D', 64), [(32, 64, 56, 56)]),
        ('InstanceNorm3D', layer('InstanceNorm3D', 16),
         [(4, 16, 16, 16, 16)]),
        ('LocalResponseNorm', layer('LocalResponseNorm', 5),
         [(8, 256, 27, 27)]),
        ('SpectralNorm', layer('SpectralNorm', [512, 256, 5, 5],
                               power_iters=10), [(512, 256, 5, 5)]),
        ('Upsample', layer('Upsample', scale_factor=2, mode='bicubic'),
         [(16, 64, 28, 28)]),
        ('UpsamplingNearest2D', layer('UpsamplingNearest2D',
                                      scale_factor=2), [(32, 128, 28, 28)]),
        ('UpsamplingBilinear2D', layer('UpsamplingBilinear2D',
                                       size=[112, 112]), [(16, 64, 56, 56)]),
        ('Bilinear', layer('Bilinear', 64, 32, 128), [(512, 64),
                                                      (512, 32)]),
        ('Unfold', layer('Unfold', 2, 2), [(16, 64, 56, 56)]),
        ('PixelShuffle', layer('PixelShuffle', 3), [(16, 576, 16, 16)]),
        ('PairwiseDistance', layer('PairwiseDistance', 3.0),
         [(4096, 256), (4096, 256)]),
        ('weight_norm', _weight_norm_case, [(64, 128, 28, 28)]),
        ('spectral_norm', _spectral_norm_case, [(64, 128, 28, 28)]),
    ]
    return cases


def _seeded_on_cpu(P, build, like):
    """``build()`` from seed 5 on the CPU, moved to ``like``'s device:
    the same weights on either side of the comparison (each device's
    generator draws its own)."""
    P.seed(5)
    P.set_device('cpu')
    try:
        layer = build()
    finally:
        P.set_device('cuda' if like.is_cuda else 'cpu')
    return layer.to(like.device)


def _weight_norm_case(P, x):
    conv = P.nn.utils.weight_norm(_seeded_on_cpu(
        P, lambda: P.nn.Conv2D(128, 64, 3, padding=1), x))
    y = conv(x)
    P.nn.utils.remove_weight_norm(conv)
    return y, conv(x)


def _spectral_norm_case(P, x):
    conv = P.nn.utils.spectral_norm(_seeded_on_cpu(
        P, lambda: P.nn.Conv2D(128, 64, 3, padding=1), x),
        n_power_iterations=2)
    conv.weight_u.copy_(torch.linspace(-1.0, 1.0, 64))
    conv.weight_u.div_(conv.weight_u.norm())
    return conv(x)


class _VisionCalls:
    """Records which of the vision half's names are called: the functionals
    wrapped on ``P.nn.functional``, the layers' ``forward`` and the
    utils on ``P.nn.utils``, restored after."""

    def __init__(self, P):
        self.P, self.called, self.saved = P, set(), []

    def _wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def record(*args, _fn=fn, **kw):
            self.called.add(name)
            return _fn(*args, **kw)
        self.saved.append((owner, attr, fn))
        setattr(owner, attr, record)

    def __enter__(self):
        P = self.P
        for name in VISION_FUNCTIONALS:
            self._wrap(P.nn.functional, name, name)
        for name in VISION_LAYERS:
            self._wrap(getattr(P.nn, name), 'forward', name)
        for name in VISION_UTILS:
            self._wrap(P.nn.utils, name, name)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        return False


def _vision_inputs(shapes, seed):
    rs = np.random.RandomState(seed)
    out = []
    for s in shapes:
        if s[0] == 'grid':
            out.append(rs.uniform(-1.2, 1.2, s[1:]).astype(np.float32))
        else:
            out.append(rs.randn(*s).astype(np.float32))
    return out


def _vision_run(P, fn, arrays, device, seed):
    """Outputs and every input's gradient of ``sum(out * cot)`` on
    ``device`` (cotangents seeded on the host)."""
    ts = [torch.from_numpy(a).to(device).requires_grad_(True)
          for a in arrays]
    P.set_device(device)
    try:
        outs = fn(P, *ts)
    finally:
        P.set_device(None)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    rs = np.random.RandomState(seed + 100)
    cots = [torch.from_numpy(rs.randn(*o.shape).astype(np.float32)).to(
        device) for o in outs]
    grads = torch.autograd.grad(
        sum((o.float() * c).sum() for o, c in zip(outs, cots)), ts,
        allow_unused=True)
    return [o.detach() for o in outs], [
        torch.zeros_like(t) if g is None else g for t, g in zip(ts, grads)]


def vision_ops_phase():
    """Every new name of ``nn.functional``, ``nn`` and ``nn.utils`` on
    the card against the same call on the CPU, forward and every input's
    gradient, f32 within VISION_TOL of each tensor's largest magnitude;
    each name's call recorded."""
    import paddle_tpu_torch as P
    t0 = time.perf_counter()
    worst_f, worst_g, bad, ran = 0.0, 0.0, [], 0
    with _VisionCalls(P) as calls:
        for i, (name, fn, shapes) in enumerate(_vision_cases()):
            arrays = _vision_inputs(shapes, i)
            got = _vision_run(P, fn, arrays, 'cuda', i)
            want = _vision_run(P, fn, arrays, 'cpu', i)
            torch.cuda.synchronize()
            ran += 1
            for kind, tol, pairs in (('output', VISION_TOL[0],
                                      zip(got[0], want[0])),
                                     ('gradient', VISION_TOL[1],
                                      zip(got[1], want[1]))):
                for j, (a, b) in enumerate(pairs):
                    if a.device.type != 'cuda' or a.shape != b.shape or \
                            a.dtype != b.dtype:
                        bad.append(f'{name} {kind} {j}: {a.device} '
                                   f'{tuple(a.shape)} {a.dtype} vs '
                                   f'{tuple(b.shape)} {b.dtype}')
                        continue
                    b = b.to(a.device)
                    scale = max(float(b.abs().max()), 1e-30)
                    rel = float((a - b).abs().max()) / scale
                    if kind == 'output':
                        worst_f = max(worst_f, rel)
                    else:
                        worst_g = max(worst_g, rel)
                    if rel > tol:
                        bad.append(f'{name} {kind} {j}: card vs CPU '
                                   f'{rel:.3e} of its scale > {tol}')
    if bad:
        raise AssertionError('vision_ops: ' + '; '.join(bad))
    names = set(VISION_FUNCTIONALS) | set(VISION_LAYERS) | set(VISION_UTILS)
    missing = names - calls.called
    if missing:
        raise AssertionError(f'vision_ops: never called on the card: '
                             f'{sorted(missing)}')
    dt = time.perf_counter() - t0
    log(f'vision_ops: {ran} cases, every one of the {len(names)} new names '
        f'called on the card against the CPU, f32: worst output '
        f'{worst_f:.3e} (tol {VISION_TOL[0]}), worst input gradient '
        f'{worst_g:.3e} (tol {VISION_TOL[1]}) of each tensor\'s largest '
        f'magnitude; {dt:.1f} s')
    return {'cases': ran, 'names_called': len(calls.called),
            'worst_output_rel': worst_f, 'worst_grad_rel': worst_g,
            'phase_s': dt}


# -- slice 20: checkpoints, recovery and elastic restarts ---------------------
# ckpt_resume: 20 steps with async saves after steps 5, 10 and 15 (keep 2),
# a fresh trainer restored from step 10, and the same trainer restored in
# place, each held to the uninterrupted run bit for bit; then 5 steps with
# no save in flight for the ms/step beside the steps that overlap one
# the checkpoint phases run gpt_small's widths at 4 of its 12 layers: the
# save, restore, rollback and supervisor paths are the same at any
# depth, and a third of the bytes to hash, write and read keeps the
# whole smoke inside its time limit on a slow host
CKPT_LAYERS = 4
CKPT_MODEL_KW = dict(TRAIN_MODEL_KW, num_layers=CKPT_LAYERS)
CKPT_K = 5
CKPT_STEPS = 20
CKPT_SAVES = (5, 10, 15)
CKPT_FROM = 10
CKPT_QUIET = 5
# elastic: a supervised GPT worker (this file, --elastic-worker) that
# checkpoints every 4 steps and resumes from the latest committed step
ELASTIC_STEPS = 16
ELASTIC_EVERY = 4
ELASTIC_MAX_RESTARTS = 3
ELASTIC_PLAN = {'seed': 20, 'name': 'elastic', 'faults': [
    {'kind': 'sigkill', 'at_step': 6},
    {'kind': 'torn_write', 'at_step': None,
     'path': 'step_8/_PADDLE_COMMIT'},
    {'kind': 'sigterm', 'at_step': 10}]}
ELASTIC_TIMEOUT = 600
# auto_checkpoint: 1 snapshotted step (the whole train state, pickled),
# then a fresh model resumes at step 2
ACP_STEPS = 1


def ckpt_ids(vocab_size, step):
    """Step ``step``'s batch (1-based), its own seed."""
    return np.random.RandomState(step).randint(
        0, vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)


def _ckpt_trainer(fused, seed=0):
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=seed, **CKPT_MODEL_KW)
    return _trainer(model, amp_o2=True,
                    fused_steps=CKPT_K if fused else None)


def _ckpt_steps(tr, steps, fused):
    """Steps ``steps`` (1-based) eagerly, or in chunks of CKPT_K through
    ``step_fused``; the losses as one device tensor."""
    from paddle_tpu_torch.core import scan_loop
    vocab = tr.model.config.vocab_size
    if not fused:
        return torch.stack([tr.step(ckpt_ids(vocab, s), ckpt_ids(vocab, s))
                            for s in steps])
    out = []
    for i in range(0, len(steps), CKPT_K):
        chunk = [(ckpt_ids(vocab, s), ckpt_ids(vocab, s))
                 for s in steps[i:i + CKPT_K]]
        out.append(tr.step_fused(*scan_loop.stack_batches(chunk)))
    return torch.cat(out)


def _train_state_of(tr):
    """Parameters and optimizer slots, cloned, keyed as train_state."""
    st = tr.train_state()
    out = {f'params/{n}': p.detach().clone()
           for n, p in st['params'].items()}
    for n, slots in st['opt_state'].items():
        out.update({f'opt_state/{n}/{k}': v.detach().clone()
                    for k, v in slots.items()})
    return out


def _state_ptrs(tr):
    st = tr.train_state()
    return [p.data_ptr() for p in st['params'].values()] + [
        v.data_ptr() for slots in st['opt_state'].values()
        for v in slots.values()]


def _bit_equal(what, got_l, want_l, got, want):
    """Losses (unless None) and every state tensor equal, bit for bit."""
    if got_l is not None and not torch.equal(got_l, want_l):
        raise AssertionError(f'{what}: losses {got_l.tolist()} != '
                             f'{want_l.tolist()}')
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f'{what}: {len(bad)} of {len(want)} state '
                             f'tensors differ, e.g. {bad[:3]}')


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ckpt_resume(workdir, fused):
    """One mode of ``ckpt_resume``: the uninterrupted run with saves
    (the main path, its launches counted), a fresh trainer restored from
    step CKPT_FROM, and that trainer restored again in place."""
    from paddle_tpu_torch.ops import _build
    mode = 'step_fused K %d' % CKPT_K if fused else 'eager step'
    d = f'{workdir}/{"fused" if fused else "eager"}'
    tr = _ckpt_trainer(fused)
    L = tr.model.config.num_layers
    per_step = _per_step(L, 2 * L + 1, flash=1)
    _build.reset_launches()
    losses, handles, seg_s, save_s = [], [], {}, []
    t0 = time.perf_counter()
    for lo in range(1, CKPT_STEPS + 1, CKPT_K):
        seg = list(range(lo, lo + CKPT_K))
        out, seg_s[lo] = _timed(lambda: _ckpt_steps(tr, seg, fused))
        losses.append(out)
        if seg[-1] in CKPT_SAVES:
            # the loop's whole cost of a save: waiting for the previous
            # one to commit, then the dispatch
            ts = time.perf_counter()
            handles.append(tr.save_checkpoint(d, keep=2, async_save=True))
            save_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    want_l = torch.cat(losses)
    _check_run(f'ckpt_resume {mode}', want_l.tolist(), launches, per_step,
               CKPT_STEPS, falls=False)
    want = _train_state_of(tr)
    mgr = tr._ckpt_mgr
    _, drain_s = _timed(mgr.wait)
    if mgr._steps() != [10, 15]:
        raise AssertionError(f'ckpt_resume: committed steps {mgr._steps()}'
                             ', expected [10, 15] (keep 2)')
    copy_ms = [h.copy_ms() for h in handles]
    quiet, quiet_s = _timed(lambda: _ckpt_steps(
        tr, list(range(CKPT_STEPS + 1, CKPT_STEPS + CKPT_QUIET + 1)), fused))
    ckpt_bytes = sum(r['size'] for r in handles[-1].records.values())
    pinned = mgr.pinned_bytes
    del tr, quiet
    _free()

    fresh = _ckpt_trainer(fused, seed=1)
    _build.reset_launches()
    got_step, restore_s = _timed(lambda: fresh.restore_checkpoint(
        d, step=CKPT_FROM))
    if got_step != CKPT_FROM or fresh._step_no != CKPT_FROM:
        raise AssertionError(f'ckpt_resume: restored {got_step}, step '
                             f'{fresh._step_no}, expected {CKPT_FROM}')
    steps = list(range(CKPT_FROM + 1, CKPT_STEPS + 1))
    got_l = _ckpt_steps(fresh, steps, fused)
    torch.cuda.synchronize()
    resumed = launch_counts()
    _check_run(f'ckpt_resume {mode} fresh', got_l.tolist(), resumed,
               per_step, len(steps), falls=False)
    _bit_equal(f'ckpt_resume {mode}: fresh trainer from step {CKPT_FROM}',
               got_l, want_l[CKPT_FROM:], _train_state_of(fresh), want)
    ptrs = _state_ptrs(fresh)
    replays = sum(m.replays for m in fresh._fused_cache.modules.values())
    _, inplace_s = _timed(lambda: fresh.restore_checkpoint(
        d, step=CKPT_FROM))
    if _state_ptrs(fresh) != ptrs:
        raise AssertionError('ckpt_resume: a restore moved a parameter or '
                             'moment (a captured graph would read stale '
                             'memory)')
    got_l = _ckpt_steps(fresh, steps, fused)
    _bit_equal(f'ckpt_resume {mode}: in place from step {CKPT_FROM}',
               got_l, want_l[CKPT_FROM:], _train_state_of(fresh), want)
    replayed = sum(m.replays for m in fresh._fused_cache.modules.values())
    if fused and replayed - replays != len(steps):
        raise AssertionError(f'ckpt_resume: {replayed - replays} replays '
                             f'after the in-place restore, expected '
                             f'{len(steps)} (no new capture)')
    overlap_ms = sum(seg_s[lo] for lo in (6, 11, 16)) / (3 * CKPT_K) * 1e3
    quiet_ms = quiet_s / CKPT_QUIET * 1e3
    out = {'mode': mode, 'ckpt_bytes': ckpt_bytes, 'pinned_bytes': pinned,
           'dispatch_s': [h.dispatch_s for h in handles],
           'save_call_s': save_s,
           'write_s': [h.write_s for h in handles],
           'write_bytes_per_s': [ckpt_bytes / h.write_s for h in handles],
           'staging_copy_ms': copy_ms, 'drain_s': drain_s,
           'restore_s': restore_s, 'restore_in_place_s': inplace_s,
           'ms_per_step_overlapping_save': overlap_ms,
           'ms_per_step_no_save': quiet_ms, 'run_s': run_s,
           'losses': want_l.tolist(), 'launches': launches,
           'launches_resumed': resumed}
    log(f'ckpt_resume {mode}: {CKPT_STEPS} steps, async saves after '
        f'{CKPT_SAVES} (keep 2): {ckpt_bytes} checkpoint bytes '
        f'({len(handles[-1].records)} files), pinned host {pinned} bytes; '
        f'dispatch_s {", ".join(f"{x:.4f}" for x in out["dispatch_s"])}'
        f' (the save call, the previous save\'s commit included: '
        f'{", ".join(f"{x:.3f}" for x in save_s)} s); '
        f'staging copy {", ".join(str(x and round(x, 1)) for x in copy_ms)}'
        f' ms; writer '
        f'{", ".join(f"{x:.2f}" for x in out["write_s"])} s; final drain '
        f'{drain_s:.3f} s; {overlap_ms:.1f} ms/step over steps 6-10, 11-15 '
        f'and 16-20 (a save in flight) vs {quiet_ms:.1f} ms/step over '
        f'{CKPT_QUIET} steps with none')
    log(f'ckpt_resume {mode}: fresh trainer restored step {CKPT_FROM} in '
        f'{restore_s:.3f} s and trained {len(steps)} steps equal to the '
        f'uninterrupted run bit for bit (losses and {len(want)} parameter '
        f'and moment tensors); restored again in place in {inplace_s:.3f} '
        f's, every data_ptr kept, and equal again; launches '
        f'{_launch_summary(launches, per_step, CKPT_STEPS)}, the resumed '
        f'run {_launch_summary(resumed, per_step, len(steps))}')
    del fresh
    _free()
    return out


def ckpt_resume_phase():
    """gpt_small's widths at CKPT_LAYERS layers in the GPT cell's
    configuration (B 8 x T 1024, bf16 O2, fused CE head, AdamW 3e-4,
    dropout 0, seed 0) saving and resuming, under ``step_fused`` and
    eagerly."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix='ckpt_resume_')
    try:
        out = {'fused': _ckpt_resume(workdir, True),
               'eager': _ckpt_resume(workdir, False)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t0
    log(f'ckpt_resume: phase {out["phase_s"]:.1f} s')
    return out


def _fault_batch(vocab, step, eng):
    ids = ckpt_ids(vocab, step)
    return ids, ids, eng.poison(step, np.ones(1, np.float32))


def ckpt_faults_phase():
    """The same trainer under ``nan_guard``: a NaN step skipped and
    rolled back to the last committed step, a truncated payload
    quarantined on restore, a dropped commit never seen, and the port's
    ``check_ckpt --deep`` classifying a torn (3) and a rotted (5)
    step."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.resilience import ChaosEngine, FaultPlan
    from paddle_tpu_torch.resilience import manifest as M
    from paddle_tpu_torch.tools import check_ckpt
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix='ckpt_faults_')
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelTrainer
    model = gpt_small(device='cuda', seed=0, **CKPT_MODEL_KW)
    strategy = DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs['use_pure_fp16'] = True
    tr = ParallelTrainer(
        model, AdamW(learning_rate=TRAIN_LR, parameters=model.parameters()),
        lambda out, y, w: model.loss(out, y) * w, strategy=strategy,
        nan_guard=True, nan_patience=1)
    vocab = model.config.vocab_size
    L = model.config.num_layers
    per_step = _per_step(L, 2 * L + 1, flash=1)

    def deep(step):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = check_ckpt.main([d, '--deep', '--step', str(step)])
        return rc, buf.getvalue()

    def train(steps, eng):
        for s in steps:
            tr.step(*_fault_batch(vocab, s, eng))

    out = {}
    try:
        nan = ChaosEngine(FaultPlan(seed=20, faults=[
            {'kind': 'nan_grads', 'at_step': 12}]))
        _build.reset_launches()
        train(range(1, 11), nan)
        tr.save_checkpoint(d, keep=3, async_save=True)
        at10 = _train_state_of(tr)
        train((11, 12), nan)         # 12: skipped, then rolled back
        torch.cuda.synchronize()
        launches = launch_counts()
        _check_run('ckpt_faults', [0.0], launches, per_step, 12, falls=False)
        if (tr._step_no, tr.sentinel.rollbacks, tr.sentinel.total_skipped) \
                != (CKPT_FROM, 1, 1):
            raise AssertionError(
                f'ckpt_faults: after the NaN at step 12: step '
                f'{tr._step_no}, {tr.sentinel.rollbacks} rollback(s), '
                f'{tr.sentinel.total_skipped} skipped; expected 10, 1, 1')
        _bit_equal('ckpt_faults: rollback to step 10', None, None,
                   _train_state_of(tr), at10)
        flight = [f for f in os.listdir(d) if f.startswith('flightrec-')]
        if not flight:
            raise AssertionError('ckpt_faults: no flight dump beside the '
                                 'checkpoint')
        with ChaosEngine(FaultPlan(seed=20, faults=[
                {'kind': 'truncate_shard', 'at_step': 15}])) as eng:
            train(range(11, 16), nan)
            tr.save_checkpoint(d, keep=3, async_save=True).wait()
        torn_rc, torn_out = deep(15)
        got = tr.restore_checkpoint(d)
        quarantined = [f for f in os.listdir(d) if '.torn-' in f]
        if got != CKPT_FROM or torn_rc != 3 or not quarantined:
            raise AssertionError(
                f'ckpt_faults: truncated step 15: check_ckpt --deep '
                f'{torn_rc}, restore landed on {got}, quarantined '
                f'{quarantined}; expected 3, 10, one\n{torn_out}')
        truncated = eng.sequence()[0]['path']
        with ChaosEngine(FaultPlan(seed=20, faults=[
                {'kind': 'drop_commit', 'at_step': 15}])):
            train(range(11, 16), nan)
            tr.save_checkpoint(d, keep=3, async_save=True).wait()
        dropped_latest = tr._ckpt_mgr.latest_step()
        if M.is_committed(os.path.join(d, 'step_15')) or \
                dropped_latest != CKPT_FROM:
            raise AssertionError('ckpt_faults: the dropped commit of step '
                                 f'15 is visible (latest {dropped_latest})')
        with ChaosEngine(FaultPlan(seed=20, faults=[
                {'kind': 'corrupt_shard', 'at_step': 20}])):
            train(range(16, 21), nan)
            tr.save_checkpoint(d, keep=3, async_save=True).wait()
        rot_rc, rot_out = deep(20)
        if rot_rc != 5:
            raise AssertionError(f'ckpt_faults: corrupt_shard: check_ckpt '
                                 f'--deep {rot_rc}, expected 5\n{rot_out}')
        out = {'rollback_to': CKPT_FROM, 'flight_dumps': len(flight),
               'truncated': os.path.relpath(truncated, d),
               'quarantined': quarantined, 'check_ckpt_torn': torn_rc,
               'check_ckpt_corrupt': rot_rc,
               'dropped_commit_latest': dropped_latest,
               'launches': launches}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t0
    log(f'ckpt_faults: nan_grads at step 12 skipped and rolled back to '
        f'step {CKPT_FROM} bit for bit (flight dump beside the checkpoint); '
        f'truncate_shard on step 15 ({out["truncated"]}): check_ckpt --deep '
        f'{torn_rc}, restore quarantined it ({quarantined}) and landed on '
        f'{CKPT_FROM}; drop_commit on step 15: latest_step '
        f'{out["dropped_commit_latest"]}; corrupt_shard on step 20: '
        f'check_ckpt --deep {rot_rc}; launches '
        f'{_launch_summary(launches, per_step, 12)}; phase '
        f'{out["phase_s"]:.1f} s')
    del tr, model
    _free()
    return out


def elastic_worker_main(workdir):
    """One incarnation of the elastic phase's worker (run by
    ``python -m paddle_tpu_torch.distributed.launch --elastic N
    chip_smoke.py --elastic-worker DIR``): the checkpoint phases' trainer,
    resumed from the latest committed step, under the plan in
    PADDLE_TPU_CHAOS_PLAN (faults an earlier incarnation fired are
    marked fired from the run's events), a checkpoint every
    ELASTIC_EVERY steps and one at a preemption."""
    import os
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.resilience import (
        PREEMPTED_EXIT_CODE, install_shutdown, shutdown_requested)
    from paddle_tpu_torch.resilience.chaos import (
        ChaosEngine, load_run_events, plan_from_env)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free, total = torch.cuda.mem_get_info()
    rec = {'pid': os.getpid(),
           'restarts': int(os.environ.get('PADDLE_ELASTIC_RESTART_COUNT', 0)),
           'preemptions': int(os.environ.get('PADDLE_ELASTIC_PREEMPT_COUNT',
                                             0)),
           'mem_free': free, 'mem_total': total}

    def note(**kw):
        with open(os.path.join(workdir, 'incarnations.jsonl'), 'a') as f:
            f.write(json.dumps(dict(rec, **kw)) + '\n')

    note(event='start')
    telemetry.enable(os.path.join(workdir, 'telemetry'))
    plan = plan_from_env()
    plan.mark_fired(load_run_events(workdir))
    eng = ChaosEngine(plan).activate()
    install_shutdown()
    for mod in ('fused_norm', 'flash_attention', 'fused_softmax',
                'fused_gelu_linear'):
        _ops_module(mod)                                # registers
    from paddle_tpu_torch.ops import _build
    tr = _ckpt_trainer(False)
    ckpt = os.path.join(workdir, 'ckpt')
    start = max(0, tr.restore_checkpoint(ckpt))
    vocab = tr.model.config.vocab_size
    _build.reset_launches()
    step = start
    for step in range(start + 1, ELASTIC_STEPS + 1):
        eng.step(step)              # may SIGKILL or SIGTERM us here
        tr.step(ckpt_ids(vocab, step), ckpt_ids(vocab, step))
        if step % ELASTIC_EVERY == 0 or shutdown_requested():
            tr.save_checkpoint(ckpt, keep=2, async_save=False)
        if shutdown_requested():
            torch.cuda.synchronize()
            note(event='preempted', restored=start, step=step,
                 launches=launch_counts())
            telemetry.dump_flight(os.path.join(
                workdir, f'flightrec-preempt-{step}.json'))
            return PREEMPTED_EXIT_CODE
    torch.cuda.synchronize()
    note(event='done', restored=start, step=step, launches=launch_counts())
    return 0


def _elastic_reference(steps):
    """The uninterrupted run the elastic worker's must equal: its state
    after ``steps`` eager steps."""
    tr = _ckpt_trainer(False)
    vocab = tr.model.config.vocab_size
    for s in range(1, steps + 1):
        tr.step(ckpt_ids(vocab, s), ckpt_ids(vocab, s))
    torch.cuda.synchronize()
    want = _train_state_of(tr)
    del tr
    return want


def elastic_phase():
    """``python -m paddle_tpu_torch.distributed.launch --elastic 3`` over
    the GPT worker under a seeded plan (a SIGKILL at step 6, torn writes
    of step 8's save, a SIGTERM at step 10): rc 0, ``check_invariants``
    empty, one failure restart and one preemption, and the final state
    equal to an uninterrupted 16-step run's bit for bit; then one
    ``auto_checkpoint.train_step_range`` drill at the same width."""
    import os
    import shutil
    import tempfile
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience.chaos import (
        check_invariants, load_run_events)
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix='elastic_')
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PADDLE_TPU_CHAOS_PLAN=json.dumps(ELASTIC_PLAN),
               PYTHONPATH=here + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    try:
        # its own session: a timeout takes the workers down with it
        proc = subprocess.Popen(
            [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
             '--elastic', str(ELASTIC_MAX_RESTARTS),
             '--elastic-log-dir', os.path.join(workdir, 'logs'),
             os.path.abspath(__file__), '--elastic-worker', workdir],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            stderr = proc.communicate(timeout=ELASTIC_TIMEOUT)[1]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            raise
        run_s = time.perf_counter() - t0
        logs = ''
        for f in sorted(os.listdir(os.path.join(workdir, 'logs'))):
            with open(os.path.join(workdir, 'logs', f), errors='replace') \
                    as fh:
                logs += fh.read()[-4000:]
        with open(os.path.join(workdir, 'incarnations.jsonl')) as f:
            incs = [json.loads(line) for line in f]
        if proc.returncode != 0:
            raise AssertionError(f'elastic: launcher rc {proc.returncode}'
                                 f'\n{stderr[-3000:]}\n{logs}')
        starts = [r for r in incs if r['event'] == 'start']
        ends = [r for r in incs if r['event'] != 'start']
        final = ends[-1]
        events = load_run_events(workdir)
        preempt_codes = [117 for r in ends if r['event'] == 'preempted']
        violations = check_invariants(
            os.path.join(workdir, 'ckpt'), events=events,
            max_restarts=ELASTIC_MAX_RESTARTS, restarts=final['restarts'],
            preempt_codes=preempt_codes, final_rc=proc.returncode)
        injected = [(e['fault'], e.get('step'), os.path.basename(
            e.get('path') or '')) for e in events
            if e.get('kind') == 'fault_injected']
        if violations or final['event'] != 'done' or \
                (final['restarts'], final['preemptions']) != (1, 1) or \
                len(starts) != 3:
            raise AssertionError(
                f'elastic: violations {violations}, incarnations {incs}, '
                f'injected {injected}\n{logs}')
        mgr = CheckpointManager(os.path.join(workdir, 'ckpt'))
        if mgr.latest_step() != ELASTIC_STEPS:
            raise AssertionError(f'elastic: latest committed step '
                                 f'{mgr.latest_step()}')
        want = _elastic_reference(ELASTIC_STEPS)
        tr = _ckpt_trainer(False, seed=1)
        got = tr.restore_checkpoint(mgr.directory)
        _bit_equal(f'elastic: step {got} vs the uninterrupted run', None,
                   None, _train_state_of(tr), want)
        del tr, want
        _free()
        L = CKPT_LAYERS
        per_step = _per_step(L, 2 * L + 1, flash=1)
        trained = sum(r['step'] - r['restored'] for r in ends)
        # the SIGKILLed incarnation reports nothing: it trained steps 1-5
        killed = 5
        launches = {k: sum(r['launches'].get(k, 0) for r in ends)
                    for k in ends[0]['launches']}
        _check_run('elastic', [0.0], launches, per_step, trained,
                   falls=False)
        out = {'rc': proc.returncode, 'violations': violations,
               'incarnations': len(starts),
               'failure_restarts': final['restarts'],
               'preemptions': final['preemptions'],
               'injected': injected, 'launches': launches,
               'steps_counted': trained, 'steps_killed': killed,
               'mem_free_at_start': [r['mem_free'] for r in starts],
               'run_s': run_s}
        log(f'elastic: launch --elastic {ELASTIC_MAX_RESTARTS}, plan '
            f'{[(f["kind"], f.get("at_step") or f.get("path")) for f in ELASTIC_PLAN["faults"]]}: '
            f'rc 0, check_invariants [] , {len(starts)} incarnations '
            f'({final["restarts"]} failure restart, {final["preemptions"]} '
            f'preemption), injected {injected}; final step '
            f'{ELASTIC_STEPS} equal to an uninterrupted run bit for bit; '
            f'free card memory at each start '
            f'{[round(m / 2**30, 2) for m in out["mem_free_at_start"]]} GiB; '
            f'launches {_launch_summary(launches, per_step, trained)} '
            f'(the killed incarnation\'s {killed} steps uncounted); '
            f'{run_s:.1f} s')
        out['acp'] = _acp_drill(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t0
    log(f'elastic: phase {out["phase_s"]:.1f} s')
    return out


def _acp_drill(workdir):
    """``auto_checkpoint.train_step_range`` at the GPT cell's width, a
    plain dygraph loop (bf16 O2): ACP_STEPS snapshotted steps, then a
    fresh model from another seed resumes at the next step and equals
    the first model's next step bit for bit."""
    import os
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as acp
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.optimizer import AdamW
    d = os.path.join(workdir, 'acp')

    def build(seed):
        model = gpt_small(device='cuda', seed=seed, **CKPT_MODEL_KW)
        return model, AdamW(learning_rate=TRAIN_LR,
                            parameters=model.parameters())

    def step(model, opt, s):
        ids = torch.from_numpy(ckpt_ids(model.config.vocab_size, s + 1)
                               ).cuda()
        with amp.auto_cast(level='O2'):
            loss = model.loss(model(ids), ids)
        loss.float().mean().backward()
        opt.step()
        opt.clear_grad()

    a, opt_a = build(0)
    acp.configure(checkpoint_dir=d, model=a, optimizer=opt_a,
                  save_checkpoint_inter=0)
    t0 = time.perf_counter()
    for s in acp.train_step_range(ACP_STEPS):
        step(a, opt_a, s)
    torch.cuda.synchronize()
    snap_s = time.perf_counter() - t0
    snap_bytes = os.path.getsize(os.path.join(d, 'acp_snapshot'))
    step(a, opt_a, ACP_STEPS)
    b, opt_b = build(1)
    acp.configure(checkpoint_dir=d, model=b, optimizer=opt_b,
                  save_checkpoint_inter=0)
    t1 = time.perf_counter()
    seen = []
    for s in acp.train_step_range(ACP_STEPS + 1):
        if not seen:
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t1
        seen.append(s)
        step(b, opt_b, s)
    acp.configure()
    if seen != [ACP_STEPS]:
        raise AssertionError(f'acp: the resumed range yielded {seen}')
    got = {n: p for n, p in b.named_parameters()}
    bad = [n for n, p in a.named_parameters() if not torch.equal(p, got[n])]
    if bad:
        raise AssertionError(f'acp: {len(bad)} parameters differ after '
                             f'the resumed step, e.g. {bad[:3]}')
    log(f'acp: train_step_range({ACP_STEPS}) with a snapshot a step '
        f'({snap_bytes} bytes) in {snap_s:.2f} s; a fresh model resumed at '
        f'step {ACP_STEPS + 1} in {resume_s:.2f} s and equals the first '
        f'bit for bit')
    del a, b, opt_a, opt_b
    _free()
    return {'snapshot_bytes': snap_bytes, 'steps_with_snapshots_s': snap_s,
            'resume_s': resume_s}


# slice 21: the training strategies (fleet.init -> distributed_optimizer ->
# ParallelTrainer) and the profiler, on the GPT cell and BERT-base
STRATEGY_STEPS = 10     # every strategy run: 10 steps on one seeded batch
STRATEGY_WARMUP = 2     # of which the first 2 are not timed (eager runs)
STRATEGY_K = 5          # step_fused's K: two chunks make the 10 steps
STRATEGY_DROPOUTS = (0.0, 0.1)   # flash at 0, the softmax branch at 0.1
# the strategy and profiler phases run gpt_small's widths at 4 of its 12
# layers: recompute, gradient merge and the profiler's windows take the
# same paths at any depth, and the smoke stays inside its time limit on
# a slow host with the dist phases after them
STRATEGY_LAYERS = 4
STRATEGY_MODEL_KW = dict(TRAIN_MODEL_KW, num_layers=STRATEGY_LAYERS)
MERGE_BATCH, MERGE_K = 32, 4     # 4 micro-batches of the cell's B 8
MERGE_POISON = 2        # the micro-batch whose rows carry a NaN loss weight
# the large-batch recipe LAMB was made for (You et al. 2019, "Large Batch
# Optimization for Deep Learning", arXiv:1904.00962): BERT-base
# pretraining under LAMB, weight decay 0.01, its learning rate warmed up
# and decayed polynomially; cut from 64K sequences a step to 4 merged
# micro-batches of the cell's B 64 x T 128 (256 sequences), lr 2e-3 with
# a 2-step warm-up over a 10-step decay
LAMB_K, LAMB_WD, LAMB_LR, LAMB_WARMUP = 4, 0.01, 2e-3, 2
LAMB_PARITY_LAYERS, LAMB_PARITY_BATCH = 2, 2
PROFILE_SPEC = 'start=2,steps=2,every=4,limit=2'   # windows at 2-3, 6-7
PROFILE_STEPS = 10


def _fleet_trainer(model, recompute=False, merge=1, lamb=False, lr=TRAIN_LR,
                   fused_steps=None, nan_guard=False, loss_fn=None,
                   amp_o2=True):
    """The user's way: ``fleet.init(strategy=s)``, then
    ``fleet.distributed_optimizer(AdamW)``, then ``ParallelTrainer``,
    which takes the strategy from the optimizer."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelTrainer
    s = fleet.DistributedStrategy()
    if amp_o2:
        s.amp = True
        s.amp_configs['use_pure_fp16'] = True
    s.recompute = recompute
    if merge > 1:
        s.gradient_merge = True
        s.gradient_merge_configs['k_steps'] = merge
    if lamb:
        s.lamb = True
        s.lamb_configs['lamb_weight_decay'] = LAMB_WD
    fleet.init(is_collective=True, strategy=s)
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=lr, parameters=model.parameters()))
    return ParallelTrainer(
        model, opt, loss_fn or (lambda out, y: model.loss(out, y)),
        fused_steps=fused_steps, nan_guard=nan_guard)


def _strategy_run(make_model, batch, fused=False, wrap=None, **kw):
    """STRATEGY_STEPS steps of a fresh seeded model on ``batch``: eager
    (the last STRATEGY_STEPS - STRATEGY_WARMUP timed) or through
    ``step_fused`` (two chunks of K, the second timed).  Every count at
    0 just before, read just after.  Returns the run's losses, final
    parameters, the port's device generator state, launches, ms/step and
    peak memory."""
    import paddle_tpu_torch
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import _build
    paddle_tpu_torch.seed(0)
    model = make_model()
    if wrap is not None:
        wrap(model)
    tr = _fleet_trainer(model, fused_steps=STRATEGY_K if fused else None,
                        **kw)
    _free()
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if fused:
        chunk = tuple(np.stack([b] * STRATEGY_K) for b in batch)
        losses = [tr.step_fused(*chunk)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.step_fused(*chunk))
        torch.cuda.synchronize()
        timed = STRATEGY_K
        losses = torch.cat(losses)
    else:
        losses = [tr.step(*batch) for _ in range(STRATEGY_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [tr.step(*batch)
                   for _ in range(STRATEGY_STEPS - STRATEGY_WARMUP)]
        torch.cuda.synchronize()
        timed = STRATEGY_STEPS - STRATEGY_WARMUP
        losses = torch.stack(losses)
    dt = time.perf_counter() - t0
    out = {'losses': losses, 'launches': launch_counts(),
           'peak_bytes': torch.cuda.max_memory_allocated(),
           'ms_per_step': dt / timed * 1e3,
           'params': {n: p.detach().clone()
                      for n, p in model.named_parameters()},
           'gen': rng.generator('cuda').get_state().clone(),
           'optimizer': type(tr.optimizer).__name__}
    del tr, model
    _free()
    return out


def _bit_equal_runs(what, got, want, gen=True):
    """Losses, every parameter and (``gen``) the port's generator state
    of two runs, bit for bit."""
    bad = [n for n in want['params']
           if not torch.equal(got['params'][n], want['params'][n])]
    if not torch.equal(got['losses'], want['losses']) or bad or (
            gen and not torch.equal(got['gen'], want['gen'])):
        diff = float((got['losses'] - want['losses']).abs().max())
        same_gen = torch.equal(got['gen'], want['gen']) if gen else None
        raise AssertionError(
            f'{what}: losses differ by {diff:.3e}, {len(bad)} parameters '
            f'differ ({bad[:3]}), generator equal {same_gen}')


def _summary_of(run):
    return {k: (v.tolist() if k == 'losses' else v)
            for k, v in run.items() if k not in ('params', 'gen')}


def strategy_recompute_phase():
    """``strategy.recompute`` on the GPT cell, built through fleet: with
    and without, eager and ``step_fused``, at dropout 0 (flash) and 0.1
    (the softmax branch, the masks replayed), bit for bit; then peak
    memory and ms/step of no recompute, the whole forward recomputed and
    every block recomputed through ``fleet.utils.recompute``."""
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    cfg = GPTConfig(**STRATEGY_MODEL_KW)       # gpt_small's widths
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    L = cfg.num_layers
    out, none0 = {}, None
    for p in STRATEGY_DROPOUTS:
        def make(p=p):
            return gpt_small(device='cuda', seed=0,
                             **dict(STRATEGY_MODEL_KW, dropout=p))
        kern = dict(softmax=1) if p else dict(flash=1)
        none = _strategy_run(make, (ids, ids))
        _check_run(f'strategy_recompute none p {p}',
                   none['losses'].tolist(), none['launches'],
                   _per_step(L, 2 * L + 1, **kern), STRATEGY_STEPS)
        per = _per_step(L, 2 * L + 1, recompute=True, **kern)
        rec = _strategy_run(make, (ids, ids), recompute=True)
        _check_run(f'strategy_recompute eager p {p}', rec['losses'].tolist(),
                   rec['launches'], per, STRATEGY_STEPS)
        _bit_equal_runs(f'strategy_recompute p {p}: recompute vs none',
                        rec, none)
        fused = _strategy_run(make, (ids, ids), fused=True, recompute=True)
        _check_run(f'strategy_recompute fused p {p}',
                   fused['losses'].tolist(), fused['launches'], per,
                   STRATEGY_STEPS)
        _bit_equal_runs(f'strategy_recompute p {p}: step_fused vs eager',
                        fused, rec)
        log(f'strategy_recompute: gpt_small B {TRAIN_BATCH} T {TRAIN_SEQ} '
            f'bf16 O2 dropout {p}, through fleet.init -> '
            f'distributed_optimizer -> ParallelTrainer: {STRATEGY_STEPS} '
            'steps with strategy.recompute bit-equal to none (losses, '
            f'every parameter, the generator), step_fused K {STRATEGY_K} '
            'bit-equal to eager; launches '
            f'{_launch_summary(rec["launches"], per, STRATEGY_STEPS)} '
            f'(none: {_launch_summary(none["launches"], _per_step(L, 2 * L + 1, **kern), STRATEGY_STEPS)}); '
            f'ms/step none {none["ms_per_step"]:.2f}, recompute '
            f'{rec["ms_per_step"]:.2f}, replayed {fused["ms_per_step"]:.2f}; '
            f'peak none {none["peak_bytes"] / 2**30:.2f} GiB, recompute '
            f'{rec["peak_bytes"] / 2**30:.2f}, replayed '
            f'{fused["peak_bytes"] / 2**30:.2f}')
        out[f'dropout_{p}'] = {'none': _summary_of(none),
                               'recompute': _summary_of(rec),
                               'fused': _summary_of(fused)}
        if not p:
            none0 = none
        del none, rec, fused

    def per_block(model):
        # a user's wrap of each block, not a change of the model
        for blk in model.gpt.blocks:
            blk.forward = functools.partial(recompute, blk.forward)

    def make0():
        return gpt_small(device='cuda', seed=0, **STRATEGY_MODEL_KW)
    blocks = _strategy_run(make0, (ids, ids), wrap=per_block)
    per = _per_step(L, 2 * L + 1, flash=1, recompute=True,
                             ln_recomputed=2 * L)
    _check_run('strategy_recompute per block', blocks['losses'].tolist(),
               blocks['launches'], per, STRATEGY_STEPS)
    _bit_equal_runs('strategy_recompute per block vs none', blocks, none0)
    del none0
    log(f'strategy_recompute: each of the {L} blocks through '
        'fleet.utils.recompute (dropout 0): bit-equal to none; launches '
        f'{_launch_summary(blocks["launches"], per, STRATEGY_STEPS)}; '
        f'{blocks["ms_per_step"]:.2f} ms/step, peak '
        f'{blocks["peak_bytes"] / 2**30:.2f} GiB')
    out['per_block'] = _summary_of(blocks)
    return out


def _merge_loss(model):
    """The GPT loss times a per-row f32 weight (a NaN weight poisons its
    rows)."""
    return lambda out, y, w: model.loss(out, y) * w


def _hand_merged_step(make_model, ids):
    """The merged step written out: MERGE_K eager forward/backward passes
    of the same bf16 O2 forward on the same slices, their gradients
    summed in order and divided by MERGE_K, then one AdamW update at
    step 1 through the optimizer's own rule."""
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    paddle_tpu_torch.seed(0)
    model = make_model()
    model.train()
    params = [p for p in model.parameters()]
    opt = AdamW(learning_rate=TRAIN_LR, parameters=params)
    opt._param_names.update({id(p): n for n, p in model.named_parameters()})
    x = torch.from_numpy(ids).cuda()
    b = MERGE_BATCH // MERGE_K
    total, losses = None, []
    for i in range(MERGE_K):
        sl = x[i * b:(i + 1) * b]
        with amp.auto_cast(level='O2'):
            loss = model.loss(model(sl), sl).float().mean()
        g = torch.autograd.grad(loss, params)
        total = list(g) if total is None else [a + c for a, c in
                                               zip(total, g)]
        losses.append(loss.detach())
    for p, g in zip(params, total):
        p.grad = g
        p.grad.div_(MERGE_K)
    opt._load_step(opt._scalar_rows(1, 1)[0])
    opt._t = 1
    opt._update()
    out = ({n: p.detach().clone() for n, p in model.named_parameters()},
           torch.stack(losses).mean())
    del model, opt, params, total
    _free()
    return out


def strategy_merge_phase():
    """``strategy.gradient_merge`` k 4 on the GPT cell at B 32 (4
    micro-batches of the cell's B 8): exact launches, the first step
    bit-equal to the hand-written accumulation, ``step_fused`` equal to
    eager, and under ``nan_guard`` one poisoned micro-batch skipping the
    whole step; ms/step, tokens/s and peak memory against B 8 and B 32
    without merge."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    cfg = GPTConfig(**STRATEGY_MODEL_KW)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (MERGE_BATCH, TRAIN_SEQ)).astype(np.int64)
    L = cfg.num_layers

    def make():
        return gpt_small(device='cuda', seed=0, **STRATEGY_MODEL_KW)
    per = _per_step(L, 2 * L + 1, flash=1, merge=MERGE_K)
    # the hand-written step, then a trainer's first step against it
    want_p, want_l = _hand_merged_step(make, ids)
    paddle_tpu_torch.seed(0)
    model = make()
    tr = _fleet_trainer(model, merge=MERGE_K)
    got_l = tr.step(ids, ids)
    bad = [n for n, p in model.named_parameters()
           if not torch.equal(p.detach(), want_p[n])]
    if bad or not torch.equal(got_l, want_l):
        raise AssertionError(
            f'strategy_merge: the merged step vs the hand-written '
            f'accumulation: loss {float(got_l)} vs {float(want_l)}, '
            f'{len(bad)} parameters differ ({bad[:3]})')
    del tr, model, want_p
    _free()
    merged = _strategy_run(make, (ids, ids), merge=MERGE_K)
    _check_run('strategy_merge eager', merged['losses'].tolist(),
               merged['launches'], per, STRATEGY_STEPS)
    fused = _strategy_run(make, (ids, ids), fused=True, merge=MERGE_K)
    _check_run('strategy_merge fused', fused['losses'].tolist(),
               fused['launches'], per, STRATEGY_STEPS)
    _bit_equal_runs('strategy_merge: step_fused vs eager', fused, merged)
    # the NaN guard: micro-batch MERGE_POISON's rows carry a NaN weight
    b = MERGE_BATCH // MERGE_K
    w = np.ones(MERGE_BATCH, np.float32)
    bad_w = w.copy()
    bad_w[MERGE_POISON * b:(MERGE_POISON + 1) * b] = np.nan
    paddle_tpu_torch.seed(0)
    model = make()
    tr = _fleet_trainer(model, merge=MERGE_K, nan_guard=True,
                        loss_fn=_merge_loss(model))
    tr.step(ids, ids, w)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    slots = _opt_state(tr)
    poisoned = tr.loss_float(tr.step(ids, ids, bad_w))
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    slot_moved = [n for n, v in _opt_state(tr).items()
                  if not torch.equal(v, slots[n])]
    if math.isfinite(poisoned) or moved or slot_moved or tr._step_no != 1:
        raise AssertionError(
            f'strategy_merge nan_guard: loss {poisoned}, {len(moved)} '
            f'parameters and {len(slot_moved)} slots moved, step '
            f'{tr._step_no} (expected NaN, none, none, 1)')
    del tr, model, before, slots
    _free()
    small = _strategy_run(make, (ids[:b], ids[:b]))
    wide = _strategy_run(make, (ids, ids))
    _check_run('strategy_merge B 32 unmerged', wide['losses'].tolist(),
               wide['launches'], _per_step(L, 2 * L + 1, flash=1),
               STRATEGY_STEPS)
    runs = {'merged': merged, 'fused': fused, f'b{b}': small,
            f'b{MERGE_BATCH}': wide}
    rows = []
    for name, r in runs.items():
        r['tokens_per_s'] = (b if name == f'b{b}' else MERGE_BATCH) * \
            TRAIN_SEQ / (r['ms_per_step'] / 1e3)
        rows.append(f'{name} {r["ms_per_step"]:.2f} ms/step, '
                    f'{r["tokens_per_s"]:.0f} tokens/s, peak '
                    f'{r["peak_bytes"] / 2**30:.2f} GiB')
    log(f'strategy_merge: gpt_small B {MERGE_BATCH} T {TRAIN_SEQ} bf16 O2, '
        f'gradient_merge k_steps {MERGE_K}: the first step bit-equal to '
        f'{MERGE_K} hand-written passes summed, /{MERGE_K}, one AdamW '
        f'update; step_fused K {STRATEGY_K} bit-equal to eager; a NaN in '
        f'micro-batch {MERGE_POISON} skipped the whole step (parameters '
        'and slots kept); launches '
        f'{_launch_summary(merged["launches"], per, STRATEGY_STEPS)}; '
        + '; '.join(rows))
    return {name: _summary_of(r) for name, r in runs.items()}


def _lamb_sched():
    from paddle_tpu_torch.optimizer import lr
    return lr.LinearWarmup(
        lr.PolynomialDecay(LAMB_LR, STRATEGY_STEPS, end_lr=0.0),
        LAMB_WARMUP, start_lr=0.0, end_lr=LAMB_LR)


def strategy_lamb_phase():
    """bert_base pretraining under ``strategy.lamb`` (the swap from
    AdamW), ``gradient_merge`` k 4 and ``recompute``, bf16 O2 at dropout
    0.1: exact launches, a finite falling loss, the optimizer a Lamb on
    the scheduler passed in, and a 2-layer f32 copy's step on the card
    against the CPU's."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models.bert import BertConfig, bert_base
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.optimizer import Lamb
    cfg = BertConfig(dropout=0.1, **BERT_MODEL_KW)
    L = cfg.num_layers
    batch = bert_batch(cfg.vocab_size, BERT_BATCH * LAMB_K, BERT_SEQ)
    per = _per_step(L, 2 * L + 2, softmax=1, recompute=True,
                             merge=LAMB_K)
    paddle_tpu_torch.seed(0)
    model = bert_base(device='cuda', seed=0, dropout=0.1, **BERT_MODEL_KW)
    sched = _lamb_sched()
    tr = _fleet_trainer(model, recompute=True, merge=LAMB_K, lamb=True,
                        lr=sched)
    opt = tr.optimizer
    if not (isinstance(opt, Lamb) and opt._learning_rate is sched
            and opt._lamb_wd == LAMB_WD):
        raise AssertionError(f'strategy_lamb: optimizer {type(opt)}, '
                             f'lr {opt._learning_rate!r}')
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(*batch) for _ in range(STRATEGY_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [tr.step(*batch)
               for _ in range(STRATEGY_STEPS - STRATEGY_WARMUP)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [tr.loss_float(x) for x in losses]
    _check_run('strategy_lamb', losses, launches, per, STRATEGY_STEPS)
    ms = dt / (STRATEGY_STEPS - STRATEGY_WARMUP) * 1e3
    del tr, model, opt
    _free()
    log(f'strategy_lamb: bert_base B {BERT_BATCH} x {LAMB_K} merged '
        f'micro-batches ({BERT_BATCH * LAMB_K} sequences a step) T '
        f'{BERT_SEQ}, dropout 0.1, bf16 O2, recompute, strategy.lamb '
        f'(Lamb from AdamW, lamb_weight_decay {LAMB_WD}, the scheduler '
        f'object kept): losses {", ".join(f"{x:.4f}" for x in losses)} '
        '(finite, falling); launches '
        f'{_launch_summary(launches, per, STRATEGY_STEPS)}; {ms:.2f} '
        f'ms/step, {BERT_BATCH * LAMB_K * BERT_SEQ / (ms / 1e3):.0f} '
        f'tokens/s, peak {peak / 2**30:.2f} GiB')
    pcfg = BertConfig(num_layers=LAMB_PARITY_LAYERS,
                      dropout=BERT_PARITY_DROPOUT, **BERT_MODEL_KW)
    parity = _card_vs_cpu(
        f'bert_base {LAMB_PARITY_LAYERS} layers, Lamb + merge '
        f'{LAMB_K} + recompute',
        lambda dev: bert_base(device=dev, seed=0,
                              num_layers=LAMB_PARITY_LAYERS,
                              dropout=BERT_PARITY_DROPOUT, **BERT_MODEL_KW),
        lambda c: bert_batch(c.vocab_size, LAMB_PARITY_BATCH * LAMB_K,
                             BERT_SEQ, seed=1),
        _per_step(pcfg.num_layers, 2 * pcfg.num_layers + 2,
                           softmax=1, recompute=True, merge=LAMB_K),
        make_trainer=lambda m: _fleet_trainer(
            m, recompute=True, merge=LAMB_K, lamb=True, lr=_lamb_sched(),
            amp_o2=False))
    return {'losses': losses, 'ms_per_step': ms, 'peak_bytes': peak,
            'launches': launches, 'parity': parity}


def _trace_gaps(path):
    """Which launches of a trace have no kernel event, and how far each
    kernel's start lies after its launch on the trace's clock: a launch
    (``cuda_runtime``/``cuda_driver`` event) and its kernel share a
    ``correlation`` id.  ``unmatched_*_ms`` place the launches without
    a kernel from the window's first launch; a negative
    ``kernel_after_launch_min_us`` means the device's timestamps run
    behind the host's."""
    from paddle_tpu_torch.profiler import trace
    doc, _ = trace._load_doc(path)
    launches, kernels = {}, {}
    for e in doc.get('traceEvents', []):
        if e.get('ph') != 'X':
            continue
        cat = str(e.get('cat', '')).lower()
        corr = (e.get('args') or {}).get('correlation')
        if corr is None:
            continue
        if cat in ('cuda_runtime', 'cuda_driver') and \
                'launch' in str(e.get('name', '')).lower():
            launches[corr] = float(e['ts'])
        elif cat == 'kernel':
            kernels[corr] = float(e['ts'])
    lead = sorted(kernels[c] - t for c, t in launches.items() if c in kernels)
    missing = sorted(t for c, t in launches.items() if c not in kernels)
    t0 = min(launches.values()) if launches else 0.0
    return {'launches': len(launches), 'unmatched': len(missing),
            'unmatched_from_ms': (missing[0] - t0) / 1e3 if missing else None,
            'unmatched_to_ms': (missing[-1] - t0) / 1e3 if missing else None,
            'kernel_after_launch_min_us': lead[0] if lead else None,
            'kernel_after_launch_median_us':
                lead[len(lead) // 2] if lead else None}


def _kernel_events(prof, kinds):
    """Events of each kernel ``kinds`` names in a parsed trace."""
    return {k: sum(r['count'] for n, r in prof.ops.items() if k in n)
            for k in kinds}


def profiler_phase():
    """The profiler API on the GPT cell: a ``start_profiler``/
    ``stop_profiler(parse=True)`` window over 3 steps, ``RecordEvent``,
    ``ParallelTrainer(profile=)`` windows with ``finish_profile``, and
    ``op_summary``, which launches nothing and moves nothing."""
    import tempfile

    import paddle_tpu_torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.parallel import ParallelTrainer
    cfg = GPTConfig(**STRATEGY_MODEL_KW)
    L = cfg.num_layers
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
    paddle_tpu_torch.seed(0)
    model = gpt_small(device='cuda', seed=0, **STRATEGY_MODEL_KW)
    tr = _fleet_trainer(model)
    tr.step(ids, ids)
    torch.cuda.synchronize()
    logdir = tempfile.mkdtemp(prefix='smoke_profiler_')
    _build.reset_launches()
    t0 = time.perf_counter()
    profiler.start_profiler(logdir=logdir)
    losses = []
    for i in range(3):
        with profiler.RecordEvent(f'smoke_step_{i}'):
            losses.append(tr.step(ids, ids))
    prof = profiler.stop_profiler(parse=True)
    window_s = time.perf_counter() - t0
    launches = launch_counts()
    _check_run('profiler window', [tr.loss_float(x) for x in losses],
               launches, _per_step(L, 2 * L + 1, flash=1), 3, falls=False)
    # kernel names without their template arguments
    top = [r['name'].split('<')[0].split('(')[0].replace('void ', '')
           for r in prof.top(8)]
    kinds = {'flash_fwd_mma': 'flash forward', 'flash_bwd_dq_mma': 'dq',
             'flash_bwd_dkv_mma': 'dk/dv', 'layer_norm_warp': 'LayerNorm'}
    missing = [k for k in kinds if not any(k in n for n in prof.ops)]
    counts = _kernel_events(prof, kinds)
    launched = {'flash_fwd_mma': 3 * L, 'flash_bwd_dq_mma': 3 * L,
                'flash_bwd_dkv_mma': 3 * L, 'layer_norm_warp': 3 * (2 * L + 1)}
    # a window once missed some kernel events (PERF.md, open questions):
    # busy time is read only from a window that holds every launch
    complete = counts == launched
    busy = prof.device_total_us / 3 / 1e3 if complete else None
    gaps = _trace_gaps(prof.source)
    ranges = [f'smoke_step_{i}' for i in range(3)] + [
        f'ParallelTrainer.{p}' for p in ('forward', 'backward', 'optimizer')]
    no_range = [r for r in ranges if prof.ranges.get(r, {}).get('count')
                not in (1, 3)]
    if missing or no_range or not prof.device_total_us > 0:
        raise AssertionError(
            f'profiler: kernels missing {missing}, counts {counts}, ranges '
            f'missing {no_range}, device {prof.device_total_us} us')
    log(f'profiler: start_profiler/stop_profiler(parse=True) over 3 GPT '
        f'steps ({window_s:.2f} s with the export and parse): '
        f'{prof.n_events} device events, {len(prof.ops)} kernels, '
        + (f'{busy:.2f} busy ms a step' if complete else
           'events lost: no busy time read')
        + f'; top {top[:5]}; kernel events {counts} (launched '
        f'{launched}); launches and their kernels {gaps}; ranges '
        f'{ {r: prof.ranges[r]["count"] for r in ranges} }')
    del tr
    _free()
    # ParallelTrainer(profile=): two sampled windows over 10 steps
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW
    s = fleet.DistributedStrategy()
    s.amp = True
    s.amp_configs['use_pure_fp16'] = True
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    tr = ParallelTrainer(model, opt, lambda out, y: model.loss(out, y),
                         strategy=s, profile=f'{PROFILE_SPEC},dir={logdir}')
    t0 = time.perf_counter()
    last = None
    for _ in range(PROFILE_STEPS):
        last = tr.step(ids, ids)
    wins = tr.finish_profile(sync=last)
    loop_s = time.perf_counter() - t0
    spans = [(w['step_lo'], w['step_hi']) for w in wins]
    if spans != [(2, 3), (6, 7)] or any(
            'error' in w or not w['device_total_us'] > 0
            or not os.path.exists(w['trace']) for w in wins):
        raise AssertionError(f'profiler: trainer windows {wins}')
    per_window = {k: c * 2 // 3 for k, c in launched.items()}
    win_counts = [_kernel_events(profiler.parse_trace(w['trace']), kinds)
                  for w in wins]
    win_ms = [w['device_us_per_step'] / 1e3 if c == per_window else None
              for w, c in zip(wins, win_counts)]
    win_gaps = [_trace_gaps(w['trace']) for w in wins]
    log(f'profiler: ParallelTrainer(profile={PROFILE_SPEC!r}) over '
        f'{PROFILE_STEPS} steps ({loop_s:.2f} s): windows {spans}, '
        + ', '.join(f'{ms:.2f} device ms a step' if ms is not None else
                    f'events lost ({c} of {per_window})'
                    for ms, c in zip(win_ms, win_counts))
        + f'; launches and their kernels {win_gaps}')
    # op_summary: a fake trace of one step, nothing launched or moved
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    slots = _opt_state(tr)
    gen = rng.generator('cuda').get_state().clone()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = tr.op_summary(ids, ids, print_table=False)
    torch.cuda.synchronize()
    summary_s = time.perf_counter() - t0
    launched = {k: v for k, v in launch_counts().items() if v}
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), params[n])]
    slot_moved = [n for n, v in _opt_state(tr).items()
                  if not torch.equal(v, slots[n])]
    names = {r['opcode']: r['calls'] for r in rows}
    want = {'paddle_tpu_torch::fused_layer_norm': 2 * L + 1,
            'paddle_tpu_torch::flash_attention_fwd': L,
            'paddle_tpu_torch::flash_attention_bwd_dq': L,
            'paddle_tpu_torch::flash_attention_bwd_dkv': L}
    if launched or moved or slot_moved or not torch.equal(
            gen, rng.generator('cuda').get_state()) or any(
            names.get(k) != n for k, n in want.items()):
        raise AssertionError(
            f'profiler op_summary: launched {launched}, {len(moved)} '
            f'parameters and {len(slot_moved)} slots moved, kernel rows '
            f'{ {k: names.get(k) for k in want} }')
    log(f'profiler: trainer.op_summary in {summary_s:.2f} s: {len(rows)} '
        f'ops, no launch, parameters, slots and generator bit-equal; the '
        f'kernels\' operators {want}; top by output bytes '
        + ', '.join(f'{r["opcode"]} {r["ratio"]:.3f}' for r in rows[:5]))
    del tr, model, params, slots
    _free()
    return {'window_s': window_s, 'busy_ms_per_step': busy,
            'window_complete': complete, 'top': top[:5],
            'kernel_counts': counts, 'windows': spans,
            'window_device_ms_per_step': win_ms,
            'trace_gaps': [gaps] + win_gaps,
            'op_summary_s': summary_s, 'op_rows': len(rows),
            'launches': launches}


# slice 22: data and tensor parallelism over torch.distributed
DIST_NCCL_LAYERS = 4        # dist_nccl: gpt_small's widths, depth cut
DIST_F32_LAYERS = 2         # dist_gpt's f32 parity runs: 3 steps
DIST_F32_STEPS = 3
DIST_BF16_LAYERS = 4        # dist_gpt's bf16 O2 runs: 10 falling steps
DIST_BF16_STEPS = 10
DIST_BF16_WARMUP = 2
DIST_DROP_LAYERS = 2        # dist_gpt's dropout 0.1 runs (the softmax
DIST_DROP_STEPS = 3         # branch, the model_parallel stream under tp)
DIST_LOSS_RTOL, DIST_PARAM_TOL = 1e-5, 1e-4
DIST_CONFIGS = {'dp2': dict(dp=2, tp=1), 'tp2': dict(dp=1, tp=2)}
DIST_TIMEOUT = 420          # a dist_gpt world's wall-clock limit (s)
DIST_GLOO_LINE = (
    'dist_gpt: a world of 2 processes on the one card, its collectives '
    'over gloo through pinned host memory (NCCL refuses two ranks on one '
    'device): every collective on a CUDA tensor is staged to the host and '
    'back; these are not times of data parallelism over NCCL')


def _nccl_definitions():
    """Every collective of ``distributed.collective`` on CUDA tensors in
    a world of one NCCL rank, each against its definition there (the
    rank's own tensor, or the list of it); returns the names checked."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    if tdist.get_backend() != 'nccl' or C.staged_through_host():
        raise AssertionError('dist_nccl: the world group is not NCCL')
    x = torch.arange(12, dtype=torch.float32, device='cuda').reshape(3, 4) \
        + 1.0
    checked = []

    def same(name, got, want):
        if isinstance(want, list):
            ok = len(got) == len(want) and all(
                torch.equal(a, b) for a, b in zip(got, want))
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f'dist_nccl: {name} differs from its '
                                 'definition at one rank')
        checked.append(name)
    for op in ('SUM', 'MAX', 'MIN', 'PROD', 'AVG'):
        same(f'all_reduce_{op}', dist.all_reduce(
            x.clone(), getattr(C.ReduceOp, op)), x)
    parts = []
    same('all_gather', dist.all_gather(parts, x.clone()), x)
    same('all_gather_list', parts, [x])
    same('all_gather_axis1', dist.all_gather([], x.clone(), axis=1), x)
    if dist.all_gather_object([], {'r': 0}) != [{'r': 0}]:
        raise AssertionError('dist_nccl: all_gather_object')
    checked.append('all_gather_object')
    same('broadcast', dist.broadcast(x.clone(), 0), x)
    same('reduce', dist.reduce(x.clone(), 0), x)
    same('scatter', dist.scatter(torch.zeros_like(x), [x * 2], 0), x * 2)
    same('alltoall', dist.alltoall([x + 1]), [x + 1])
    same('p2p', C.p2p(x.clone(), 0, 0), x)
    same('send', dist.send(x.clone(), 0, src=0), x)
    same('recv', dist.recv(x.clone(), 0), x)
    same('p2p_rotate', C.p2p_rotate(x.clone()), x)
    dist.barrier()
    same('wait', dist.wait(x.clone()), x)
    same('all_reduce_graph_replay', _nccl_graph_replay(x), x * 8)
    return checked


def _nccl_graph_replay(x):
    """One all_reduce (after a doubling) captured in a CUDA graph on a
    side stream, replayed 3 times on ``x``: ``x * 8`` at one rank."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    buf = x.clone()
    dist.all_reduce(buf)                    # the communicator, warm
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            buf.mul_(2.0)
            dist.all_reduce(buf, C.ReduceOp.SUM)
    torch.cuda.current_stream().wait_stream(side)
    buf.copy_(x)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return buf


def dist_nccl_phase():
    """One process, one NCCL rank: every collective of
    ``distributed.collective`` on CUDA tensors against its definition,
    an all_reduce captured in a CUDA graph and replayed, then the GPT
    cell through ``fleet.init`` at degrees 1 with the NCCL group up,
    eager and through ``step_fused`` (K 5) under ``nan_guard`` (the
    world's MIN of the finite flag, an NCCL all_reduce the captured step
    replays), each bit-equal to the same run without a process group,
    launches exact.  The process group is destroyed after."""
    import os
    import tempfile
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    kw = dict(TRAIN_MODEL_KW, num_layers=DIST_NCCL_LAYERS)
    ids = _dist_ids(GPTConfig(**kw).vocab_size)
    L = DIST_NCCL_LAYERS
    per = _per_step(L, 2 * L + 1, flash=1)

    def make():
        return gpt_small(device='cuda', seed=0, **kw)

    def runs(what):
        # under nan_guard the step reduces its finite flag over the world
        # (MIN): with the group up that all_reduce is captured in the
        # step's graph and replayed
        out = {m: _strategy_run(make, (ids, ids), fused=m == 'fused',
                                nan_guard=True)
               for m in ('eager', 'fused')}
        for m, r in out.items():
            _check_run(f'dist_nccl {what} {m}', r['losses'].tolist(),
                       r['launches'], per, STRATEGY_STEPS)
        return out
    free = runs('without a group')
    workdir = tempfile.mkdtemp(prefix='dist_nccl_')
    env = {'PADDLE_DIST_INIT_METHOD': 'file://' + os.path.join(workdir,
                                                               'store'),
           'PADDLE_TRAINERS_NUM': '1', 'PADDLE_TRAINER_ID': '0',
           'PADDLE_DISTRI_BACKEND': 'nccl'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        dist.init_parallel_env()
        init_s = time.perf_counter() - t0
        checked = _nccl_definitions()
        grouped = runs('with the NCCL group')
    finally:
        dist.set_mesh(None)
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for m in grouped:
        _bit_equal_runs(f'dist_nccl {m}: with the NCCL group vs without',
                        grouped[m], free[m])
    log(f'dist_nccl: one NCCL rank up in {init_s:.2f} s; {len(checked)} '
        f'collectives on CUDA tensors equal their definitions '
        f'({", ".join(checked)}), an all_reduce replayed from a CUDA '
        f'graph 3 times; gpt_small ({L} layers) B {TRAIN_BATCH} T '
        f'{TRAIN_SEQ} bf16 O2 under nan_guard through fleet.init at '
        f'degrees 1, {STRATEGY_STEPS} steps eager and through step_fused K '
        f'{STRATEGY_K} (the flag\'s all_reduce in the graph): each bit-equal to the run without a process group '
        f'(losses, every parameter, the generator); launches '
        f'{_launch_summary(grouped["eager"]["launches"], per, STRATEGY_STEPS)}'
        f'; ms/step eager {grouped["eager"]["ms_per_step"]:.2f} '
        f'(without a group {free["eager"]["ms_per_step"]:.2f}), replayed '
        f'{grouped["fused"]["ms_per_step"]:.2f} '
        f'({free["fused"]["ms_per_step"]:.2f})')
    return {'collectives': checked, 'init_s': init_s,
            **{m: _summary_of(r) for m, r in grouped.items()},
            'without_group': {m: _summary_of(r) for m, r in free.items()}}


def _dist_ids(vocab):
    return np.random.RandomState(0).randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)


def _kernel_shapes():
    """Wrap the flash kernels' and the softmax kernel's launch functions
    to record the shapes they launch at (flash ``[B*H, T, D]``, softmax
    its input's); returns the set of ``(module, function, shape)``."""
    seen = set()
    for mod, names in (('flash_attention', ('_fwd_cuda', '_bwd_dq_cuda',
                                            '_bwd_dkv_cuda')),
                       ('fused_softmax', ('_fwd_cuda',))):
        m = _ops_module(mod)
        for name in names:
            fn = getattr(m, name)

            def wrap(*args, fn=fn, key=(mod, name), **kw):
                seen.add(key + (tuple(args[0].shape),))
                return fn(*args, **kw)
            setattr(m, name, wrap)
    return seen


def dist_worker_main(workdir, config):
    """One rank of dist_gpt's world (``chip_smoke.py --dist-worker DIR
    CONFIG``, started by ``distributed.utils.start_local_trainers``):
    ``fleet.init`` over the config's degrees, the f32 parity run at
    DIST_F32_LAYERS and the bf16 O2 run at DIST_BF16_LAYERS of
    gpt_small, each with every count at 0 just before and read just
    after; writes its result and its f32 parameters under ``workdir``."""
    import os
    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.models.gpt import gpt_small
    from paddle_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mod in ('fused_norm', 'flash_attention', 'fused_softmax',
                'fused_gelu_linear'):
        _ops_module(mod)                                # registers
    shapes = _kernel_shapes()
    deg = DIST_CONFIGS[config]
    s = fleet.DistributedStrategy()
    s.hybrid_configs['dp_degree'] = deg['dp']
    s.hybrid_configs['mp_degree'] = deg['tp']
    fleet.init(is_collective=True, strategy=s)
    rank = env.get_rank()
    res = {'rank': rank, 'coords': env.get_mesh().coords}
    for run, layers, o2, steps, p in (
            ('f32', DIST_F32_LAYERS, False, DIST_F32_STEPS, 0.0),
            ('bf16', DIST_BF16_LAYERS, True, DIST_BF16_STEPS, 0.0),
            ('dropout', DIST_DROP_LAYERS, True, DIST_DROP_STEPS, 0.1)):
        paddle_tpu_torch.seed(0)
        model = gpt_small(device='cuda', seed=0,
                          **dict(TRAIN_MODEL_KW, num_layers=layers,
                                 dropout=p))
        tr = _trainer(model, o2)
        ids = _dist_ids(model.config.vocab_size)
        _free()
        shapes.clear()
        _build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warm = DIST_BF16_WARMUP if run == 'bf16' else 0
        losses = [tr.step(ids, ids) for _ in range(warm)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [tr.step(ids, ids) for _ in range(steps - warm)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[run] = {'losses': [tr.loss_float(x) for x in losses],
                    'launches': launch_counts(), 'layers': layers,
                    'steps': steps,
                    'ms_per_step': dt / (steps - warm) * 1e3,
                    'peak_bytes': torch.cuda.max_memory_allocated(),
                    'shapes': sorted(shapes)}
        if run == 'f32':
            torch.save({n: p.detach().cpu()
                        for n, p in model.named_parameters()},
                       os.path.join(workdir, f'params{rank}.pt'))
            try:
                tr.step_fused(ids[None], ids[None])
                res['fused_refused'] = None
            except RuntimeError as e:
                res['fused_refused'] = str(e)
        del tr, model
        _free()
    with open(os.path.join(workdir, f'rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    torch.distributed.barrier()
    return 0


def _dist_reference():
    """The world-1 f32 run dist_gpt's worlds must equal: losses, the
    parameters after DIST_F32_STEPS steps, the entries whose first
    gradient is round-off (held to AdamW's bound), and the layers'
    tensor-parallel specs."""
    from paddle_tpu_torch.convert import shard_specs
    from paddle_tpu_torch.models.gpt import gpt_small
    model = gpt_small(device='cuda', seed=0,
                      **dict(TRAIN_MODEL_KW, num_layers=DIST_F32_LAYERS))
    tr = _trainer(model, False)
    ids = _dist_ids(model.config.vocab_size)
    losses = [tr.loss_float(tr.step(ids, ids))]
    noisy = {n: (p.grad.abs() <= 1e-6 * p.grad.abs().max()).cpu()
             for n, p in model.named_parameters()}
    losses += [tr.loss_float(tr.step(ids, ids))
               for _ in range(DIST_F32_STEPS - 1)]
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    cfg, specs = model.config, shard_specs(model)
    del tr, model
    _free()
    return losses, params, noisy, cfg, specs


def _dist_world(config, workdir):
    """Start the config's two ranks on the card over gloo and wait (the
    world's own wall-clock limit kills both); returns their results."""
    import os
    from paddle_tpu_torch.distributed.utils import (
        get_cluster, run_local_trainers, start_local_trainers)
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ,
               PADDLE_DISTRI_BACKEND='gloo', GLOO_SOCKET_IFNAME='lo',
               PADDLE_DIST_INIT_METHOD='file://' + os.path.join(workdir,
                                                                'store'),
               PADDLE_DIST_TIMEOUT=str(DIST_TIMEOUT))
    cluster, pod = get_cluster(['127.0.0.1'], '127.0.0.1',
                               [['127.0.0.1:0', '127.0.0.1:1']], [0, 0])
    procs = start_local_trainers(
        cluster, pod, os.path.abspath(__file__),
        ['--dist-worker', workdir, config],
        log_dir=os.path.join(workdir, 'logs'), env=env)
    try:
        run_local_trainers(procs, 2, timeout=DIST_TIMEOUT)
    except (RuntimeError, TimeoutError):
        for r in range(2):
            path = os.path.join(workdir, 'logs', f'workerlog.{r}')
            if os.path.exists(path):
                with open(path, errors='replace') as f:
                    log(f'dist_gpt {config} rank {r} log:\n'
                        + f.read()[-4000:])
        raise
    out = []
    for r in range(2):
        with open(os.path.join(workdir, f'rank{r}.json')) as f:
            res = json.load(f)
        res['params'] = torch.load(os.path.join(workdir, f'params{r}.pt'))
        out.append(res)
    return out


def _dist_params_close(what, got, want, noisy, h):
    """Every parameter within DIST_PARAM_TOL (relative and absolute);
    the attention key's bias (columns ``[h, 2h)`` of the qkv bias) and
    the round-off entries within AdamW's bound, ``2 * lr * steps``."""
    loose_bound = 2 * TRAIN_LR * DIST_F32_STEPS
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        loose = noisy[name].clone()
        if name.endswith('attn.qkv.bias'):
            loose[h:2 * h] = True
        diff = (g - w).abs()
        tight = diff[~loose] - DIST_PARAM_TOL * w.abs()[~loose]
        if tight.numel() and float(tight.max()) > DIST_PARAM_TOL:
            raise AssertionError(f'{what}: {name} differs from world 1 by '
                                 f'{float(diff[~loose].max()):.3e}')
        if loose.any() and float(diff[loose].max()) > loose_bound:
            raise AssertionError(f'{what}: {name} (round-off entries) '
                                 f'by {float(diff[loose].max()):.3e}')
        if (~loose).any():
            worst = max(worst, float(diff[~loose].max()))
    return worst


def dist_gpt_phase():
    """Two processes on the one card over gloo (DIST_GLOO_LINE):
    gpt_small at full width, global B 8 x T 1024, at dp 2 and at tp 2
    (6 heads a rank).  f32 at DIST_F32_LAYERS, DIST_F32_STEPS steps,
    against the world-1 run on the same global batch (losses, the
    gathered parameters); bf16 O2 at DIST_BF16_LAYERS, 10 falling,
    finite steps; bf16 O2 at dropout 0.1 (the softmax kernel, the
    ``model_parallel`` stream under tp); each rank's launches exact and
    every kernel at its local shape."""
    import tempfile
    from paddle_tpu_torch.convert import gather_state
    from paddle_tpu_torch.distributed.env import Mesh
    log(DIST_GLOO_LINE)
    want_l, want_p, noisy, cfg, specs = _dist_reference()
    hd = cfg.hidden_size // cfg.num_heads
    out = {}
    for config, deg in DIST_CONFIGS.items():
        t0 = time.perf_counter()
        ranks = _dist_world(config, tempfile.mkdtemp(
            prefix=f'dist_gpt_{config}_'))
        wall = time.perf_counter() - t0
        local_bh = TRAIN_BATCH // deg['dp'] * cfg.num_heads // deg['tp']
        local_b = TRAIN_BATCH // deg['dp']
        want_shapes = {
            'f32': {('flash_attention', f, (local_bh, TRAIN_SEQ, hd))
                    for f in ('_fwd_cuda', '_bwd_dq_cuda', '_bwd_dkv_cuda')},
            'dropout': {('fused_softmax', '_fwd_cuda',
                         (local_b, cfg.num_heads // deg['tp'], TRAIN_SEQ,
                          TRAIN_SEQ))}}
        want_shapes['bf16'] = want_shapes['f32']
        for r in ranks:
            for run, kern in (('f32', dict(flash=1, flash_design='simt')),
                              ('bf16', dict(flash=1)),
                              ('dropout', dict(softmax=1))):
                rr = r[run]
                L = rr['layers']
                per = _per_step(L, 2 * L + 1, **kern)
                _check_run(f'dist_gpt {config} rank {r["rank"]} {run}',
                           rr['losses'], rr['launches'], per, rr['steps'],
                           falls=run == 'bf16')
                shapes = {(m, f, tuple(shape))
                          for m, f, shape in rr['shapes']}
                if shapes != want_shapes[run]:
                    raise AssertionError(
                        f'dist_gpt {config} rank {r["rank"]} {run}: '
                        f'kernels launched at {sorted(shapes)}, expected '
                        f'{sorted(want_shapes[run])}')
            if 'gloo' not in (r['fused_refused'] or ''):
                raise AssertionError(
                    f'dist_gpt {config} rank {r["rank"]}: step_fused on a '
                    f'gloo world was not refused ({r["fused_refused"]})')
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(r['f32']['losses'], want_l))
            if rel > DIST_LOSS_RTOL:
                raise AssertionError(f'dist_gpt {config} rank {r["rank"]}: '
                                     f'f32 losses {r["f32"]["losses"]} vs '
                                     f'world 1 {want_l} (rel {rel:.2e})')
        if deg['tp'] > 1:
            got = gather_state(
                [{n: t.numpy() for n, t in r['params'].items()}
                 for r in ranks], Mesh(['dp', 'tp'], [1, 2]), specs)
            got = {n: torch.from_numpy(np.ascontiguousarray(v))
                   for n, v in got.items()}
        else:
            got = ranks[0]['params']
        worst = _dist_params_close(f'dist_gpt {config}', got, want_p, noisy,
                                   cfg.hidden_size)
        for r in ranks[1:]:
            if deg['tp'] == 1 and any(not torch.equal(r['params'][n], got[n])
                                      for n in got):
                raise AssertionError(f'dist_gpt {config}: the dp replicas '
                                     'differ')
        b = [r['bf16'] for r in ranks]
        log(f'dist_gpt {config}: 2 ranks (gloo, one card) in {wall:.1f} s '
            f'of wall; f32 {DIST_F32_LAYERS} layers x {DIST_F32_STEPS} '
            f'steps: losses {ranks[0]["f32"]["losses"]} vs world 1 '
            f'{want_l}, gathered parameters within {worst:.2e}; bf16 O2 '
            f'{DIST_BF16_LAYERS} layers: losses {b[0]["losses"][0]:.4f} -> '
            f'{b[0]["losses"][-1]:.4f}, ms/step '
            f'{[round(x["ms_per_step"], 2) for x in b]}, peak '
            f'{[round(x["peak_bytes"] / 2**30, 2) for x in b]} GiB a rank; '
            f'flash at [{local_bh}, {TRAIN_SEQ}, {hd}], launches a rank '
            + _launch_summary(b[0]['launches'], _per_step(
                DIST_BF16_LAYERS, 2 * DIST_BF16_LAYERS + 1, flash=1),
                DIST_BF16_STEPS)
            + f'; dropout 0.1 ({DIST_DROP_LAYERS} layers, '
            f'{DIST_DROP_STEPS} steps): losses '
            f'{[round(x, 4) for x in ranks[0]["dropout"]["losses"]]}, '
            'softmax at '
            f'{sorted(want_shapes["dropout"])[0][2]}, launches a rank '
            + _launch_summary(ranks[0]['dropout']['launches'], _per_step(
                DIST_DROP_LAYERS, 2 * DIST_DROP_LAYERS + 1, softmax=1),
                DIST_DROP_STEPS))
        out[config] = {
            'wall_s': wall, 'transport': 'gloo (host-staged), one card',
            'f32_losses': ranks[0]['f32']['losses'], 'world1_losses': want_l,
            'param_max_diff': worst,
            'bf16_losses': b[0]['losses'],
            'ms_per_step': [x['ms_per_step'] for x in b],
            'peak_bytes': [x['peak_bytes'] for x in b],
            'dropout_losses': [r['dropout']['losses'] for r in ranks],
            'launches': {f'rank{r["rank"]}_{run}': r[run]['launches']
                         for r in ranks
                         for run in ('f32', 'bf16', 'dropout')}}
    return out


def _without_launches(tree):
    """A phase's summary for the JSON line, its launch tables left out
    (they go to the kernels line)."""
    if not isinstance(tree, dict):
        return tree
    return {k: _without_launches(v) for k, v in tree.items()
            if k != 'launches'}


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
    jit_deploy = jit_deploy_phase()
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
    tensor_lib = tensor_lib_phase()
    ddpm = ddpm_unet_phase()
    dcgan = dcgan_phase()
    vision_ops = vision_ops_phase()
    ckpt_resume = ckpt_resume_phase()
    ckpt_faults = ckpt_faults_phase()
    elastic = elastic_phase()
    strategy_recompute = strategy_recompute_phase()
    strategy_merge = strategy_merge_phase()
    strategy_lamb = strategy_lamb_phase()
    profiler_run = profiler_phase()
    dist_gpt = dist_gpt_phase()
    dist_nccl = dist_nccl_phase()
    log(json.dumps({'serve': serve, 'frontdoor': frontdoor,
                    'fleet': fleet,
                    **{f'serve_{m}': r[1] for m, r in serve_quant.items()},
                    'train': train, 'gpt_fused': gpt_fused,
                    'gpt_recipe': gpt_recipe,
                    'gpt_dropout': gpt_dropout, 'gpt_f16': gpt_f16,
                    'bert': bert, 'bert_dropout_fused': bert_fused,
                    'resnet': resnet, 'resnet_parity': resnet_parity,
                    'lenet': lenet, 'hapi_lenet': hapi_lenet,
                    'hapi_flowers': hapi_flowers,
                    'jit_deploy': {k: v for k, v in jit_deploy.items()
                                   if k != 'predictor'},
                    'widedeep': widedeep,
                    'longctx': longctx, 'gptgen': gptgen, 'ernie': ernie,
                    'vision_zoo': zoo, 'optimizers': optimizers,
                    'moe': moe, 'moe_gen': moe_gen, 'qat': qat,
                    'transformer': transformer,
                    'transformer_fused': transformer_fused,
                    'transformer_beam': transformer_beam,
                    'lstm_lm': lstm_lm, 'lstm_lm_fused': lstm_lm_fused,
                    'tensor_lib': {k: v for k, v in tensor_lib.items()
                                   if 'launches' not in k},
                    'ddpm_unet': {k: v for k, v in ddpm.items()
                                  if k != 'launches'}
                    | {'fused': {k: v for k, v in ddpm['fused'].items()
                                 if k != 'launches'}},
                    'dcgan': {k: v for k, v in dcgan.items()
                              if k != 'launches'},
                    'vision_ops': vision_ops,
                    'ckpt_resume': {m: {k: v for k, v in r.items()
                                        if 'launches' not in k}
                                    if isinstance(r, dict) else r
                                    for m, r in ckpt_resume.items()},
                    'ckpt_faults': {k: v for k, v in ckpt_faults.items()
                                    if k != 'launches'},
                    'elastic': {k: v for k, v in elastic.items()
                                if k != 'launches'},
                    'strategy_recompute': _without_launches(
                        strategy_recompute),
                    'strategy_merge': _without_launches(strategy_merge),
                    'strategy_lamb': _without_launches(strategy_lamb),
                    'profiler': _without_launches(profiler_run),
                    'dist_nccl': _without_launches(dist_nccl),
                    'dist_gpt': _without_launches(dist_gpt)}))
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
             # slice 17: bert_base's to_static replay, the Predictor's
             # forwards in its fresh process (counted there), the masked
             # artifact's; dy2static and the reader-fed LeNet launch none
             'jit_deploy_to_static': jit_deploy['launches'],
             'jit_deploy_predictor': jit_deploy['predictor']['main_path'],
             'jit_deploy_masked':
                 jit_deploy['predictor']['masked']['main_path'],
             'jit_deploy_reader': jit_deploy['reader']['launches'],
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
             'lstm_lm_fused': lstm_lm_fused['launches'],
             # slice 18: paddle.grad through gpt_small's training path,
             # and the block's second order (its first-order kernels)
             'tensor_lib_grad': tensor_lib['launches'],
             'tensor_lib_second_order':
                 tensor_lib['second_order_launches'],
             # the vision half: the softmax kernel in the U-Net's
             # attention, 6 a step; DCGAN launches none (checked there)
             'ddpm_unet': ddpm['launches'],
             'ddpm_unet_fused': ddpm['fused']['launches'],
             'dcgan': dcgan['launches'],
             # slice 20: the uninterrupted runs with saves, the resumed
             # runs, the faults drill's 12 guarded steps, and the elastic
             # worker's incarnations (each counted in its own process)
             **{f'ckpt_resume_{m}{part}': ckpt_resume[m][key]
                for m in ('fused', 'eager')
                for part, key in (('', 'launches'),
                                  ('_resumed', 'launches_resumed'))},
             'ckpt_faults': ckpt_faults['launches'],
             'elastic': elastic['launches'],
             # slice 21: the strategy runs (each counted alone), the
             # Lamb BERT run and the profiler's traced window
             **{f'strategy_recompute_{p}_{run}': r['launches']
                for p, runs in strategy_recompute.items()
                if p != 'per_block' for run, r in runs.items()},
             'strategy_recompute_per_block':
                 strategy_recompute['per_block']['launches'],
             **{f'strategy_merge_{run}': r['launches']
                for run, r in strategy_merge.items()},
             'strategy_lamb': strategy_lamb['launches'],
             'profiler': profiler_run['launches'],
             # slice 22: the NCCL rank's GPT cell, and each gloo rank of
             # the two worlds on the card (counted in its own process)
             **{f'dist_nccl_{m}': dist_nccl[m]['launches']
                for m in ('eager', 'fused')},
             **{f'dist_gpt_{config}_{key}': n
                for config, r in dist_gpt.items()
                for key, n in r['launches'].items()}}
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
    if sys.argv[1:2] == ['--elastic-worker']:
        sys.exit(elastic_worker_main(sys.argv[2]))
    if sys.argv[1:2] == ['--dist-worker']:
        sys.exit(dist_worker_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ['--optimizers-cpu']:
        sys.exit(optimizers_cpu_main(sys.argv[2], int(sys.argv[3]),
                                     int(sys.argv[4])))
    sys.exit(main())
