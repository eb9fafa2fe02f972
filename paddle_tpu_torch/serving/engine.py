"""Serving engine: continuous batching over the paged KV cache.

Counterpart of ``paddle_tpu/serving/engine.py``, with the same
scheduling and the same shapes:

- the paged KV cache (``kv_cache.py``) and ragged paged attention
  (``ops/paged_attention.py``): the whole live set decodes as ONE
  batched step, every sequence at its own depth;
- continuous batching (``scheduler.py``): admit/evict at every
  intervention, prefill into freed blocks, immediate backfill;
- the same declared prompt buckets, pow2 batch buckets and pow2
  prefill chunks, so the kernels and the allocator see a finite set of
  shapes;
- one prefill module per (prompt bucket P, chunk B) and one decode
  module per (batch bucket S, span K), as the reference compiles one
  XLA module each; ``decode_span=K`` decode steps per intervention,
  tokens on the device until the span ends (one host read per
  intervention).  On the card each module is a CUDA graph
  (``core.compile_cache``), captured by ``warmup()`` for every
  declared signature or at a signature's first use; its plan goes in
  through one static buffer from pinned staging, and all of the
  engine's graphs share one memory pool.  On the CPU the module is the
  same body, called directly;
- weight-only PTQ (``ServeConfig(quantize='int8'|'int4')``,
  ``quantization.quantize_for_serving``), applied before any module is
  made.

The decode math runs through ``GPTForCausalLM.prefill``/``decode_step``,
the same forward ``generate()`` uses, so greedy engine output equals
batch-1 ``generate``.

Left for later slices of the port: the live metrics plane, the memory
sampler, the step profiler, watchdog budgets, ``DecodeAuditLayer`` and
the telemetry events.  A ``ServeConfig`` that asks for watchdog
budgets or the profiler raises.
"""
import functools
import hashlib
import json
import math
import time
import zlib

import numpy as np
import torch

from ..core.compile_cache import GraphCache, bucket_pow2
from ..ops import _build, fused_gelu_linear
from ..ops.sampling import make_row_sampler
from .kv_cache import PagedKVCache, PagedCacheView, blocks_for
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ['ServeConfig', 'ServingEngine', 'request_seed']


def request_seed(rid, engine_seed):
    """The per-request sampling seed: a pure function of (rid, engine
    seed), as in the reference."""
    return (zlib.crc32(str(rid).encode()) ^ int(engine_seed)) \
        & 0x7FFFFFFF


def _pow2_chain(lo, hi):
    out = []
    b = int(lo)
    while b < int(hi):
        out.append(b)
        b *= 2
    out.append(int(hi))
    return tuple(sorted(set(out)))


class ServeConfig:
    """The declared serving surface (the reference's fields): every
    field shapes the finite module set, so the config is the bucket
    declaration."""

    def __init__(self, *, block_size=16, max_slots=8, decode_span=4,
                 prompt_buckets=None, batch_buckets=None,
                 prefill_batch=8, max_model_len=None, temperature=0.0,
                 top_k=None, eos_id=None, num_blocks=None,
                 request_deadline_s=None, watchdog=None, profile=None,
                 seed=0, quantize=None):
        for field, value, what in (
                ('watchdog', watchdog, 'watchdog budgets'),
                ('profile', profile, 'the step profiler')):
            if value is not None:
                raise NotImplementedError(
                    f'ServeConfig({field}=...): {what} ports with a '
                    'later slice of paddle_tpu_torch')
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.decode_span = max(1, int(decode_span))
        self.prefill_batch = max(1, int(prefill_batch))
        self.prompt_buckets = None if prompt_buckets is None \
            else tuple(sorted(set(int(p) for p in prompt_buckets)))
        self.batch_buckets = batch_buckets
        self.max_model_len = max_model_len
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.num_blocks = num_blocks
        self.request_deadline_s = request_deadline_s
        self.seed = int(seed)
        # weight-only PTQ of the served model: None (full width), 'int8'
        # or 'int4'; part of signature()
        if quantize not in (None, 'int8', 'int4'):
            raise ValueError(f'ServeConfig quantize={quantize!r}: '
                             "expected None, 'int8' or 'int4'")
        self.quantize = quantize

    @classmethod
    def from_json(cls, path_or_dict):
        """A serving config file (or its dict): the ServeConfig fields,
        plus ``model``/``model_kwargs`` keys, which the callers that
        build models from configs read and this drops."""
        if isinstance(path_or_dict, dict):
            doc = dict(path_or_dict)
        else:
            with open(path_or_dict) as f:
                doc = json.load(f)
        doc.pop('model', None)
        doc.pop('model_kwargs', None)
        return cls(**doc)

    def resolved(self, model_config):
        """Fill derived fields from the model config; returns self."""
        if self.max_model_len is None:
            self.max_model_len = int(model_config.max_seq_len)
        if self.prompt_buckets is None:
            hi = bucket_pow2(max(1, self.max_model_len // 2))
            self.prompt_buckets = _pow2_chain(min(8, hi), hi)
        if self.batch_buckets is None:
            self.batch_buckets = _pow2_chain(1, self.max_slots)
        else:
            self.batch_buckets = tuple(sorted(set(
                int(b) for b in self.batch_buckets)))
        if self.num_blocks is None:
            per_seq = blocks_for(self.max_model_len, self.block_size)
            self.num_blocks = self.max_slots * per_seq + 1
        if max(self.prompt_buckets) > self.max_model_len:
            raise ValueError(
                f'prompt bucket {max(self.prompt_buckets)} exceeds '
                f'max_model_len {self.max_model_len}')
        return self

    def signature(self):
        """The scalar fields that key the serving modules."""
        return tuple(sorted(
            (k, v if not isinstance(v, (list, tuple)) else tuple(v))
            for k, v in vars(self).items()
            if k not in ('watchdog', 'profile', 'request_deadline_s')))

    def to_dict(self):
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in vars(self).items()
                if k not in ('watchdog', 'profile')}


class ServingEngine:
    """Continuous-batching decode over one ``GPTForCausalLM``, on the
    model's device.

    ::

        eng = ServingEngine(model, ServeConfig(max_slots=64))
        eng.submit(prompt_ids, max_new_tokens=64)
        report = eng.run()          # drain; per-request TTFT/TPOT

    The model must be non-MoE: padded prefill rows would contend for
    expert capacity, the exemption ``generate``'s bucket makes.
    """

    def __init__(self, model, config=None, now_fn=time.monotonic):
        cfg = model.config
        if cfg.moe_num_experts > 0:
            raise ValueError('serving engine requires a non-MoE model '
                             '(see GPTForCausalLM._decode_bucket)')
        model.eval()
        self.model = model
        self.device = model.device
        self.config = (config or ServeConfig()).resolved(cfg)
        applied = getattr(model, '_ptq_mode', None)
        if applied != (self.config.quantize or None):
            if applied is not None:
                # the swap dropped the float weights: an engine whose
                # declared signature disagrees with the model's numerics
                # would key its modules wrongly
                raise ValueError(
                    f'model was already PTQ-quantized ({applied!r}) '
                    f'but this config declares '
                    f'quantize={self.config.quantize!r}; build each '
                    'quantization mode from a FRESH model '
                    '(quantize_for_serving swaps weights in place)')
            # before any module is made: every prefill and decode module
            # reads the narrow weights
            from ..quantization import quantize_for_serving
            quantize_for_serving(model, self.config.quantize)
        self.now_fn = now_fn
        # one engine-relative clock for every timestamp
        self._epoch = now_fn()
        self._clock = lambda: self.now_fn() - self._epoch
        nh = cfg.num_heads
        self.cache = PagedKVCache(
            cfg.num_layers, nh, cfg.hidden_size // nh,
            block_size=self.config.block_size,
            num_blocks=self.config.num_blocks, device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            self.cache, max_slots=self.config.max_slots,
            batch_buckets=self.config.batch_buckets,
            bucket_fn=self.prompt_bucket,
            max_model_len=self.config.max_model_len,
            decode_span=self.config.decode_span,
            eos_id=self.config.eos_id, now_fn=self._clock)
        self._sample = make_row_sampler(self.config.temperature,
                                        self.config.top_k)
        self.interventions = 0
        self.decoded_tokens = 0
        self.prefill_dispatches = 0
        self.decode_steps = 0
        self._rid = 0
        # one decode module per (S, K) and one prefill module per (P,
        # B); all of their graphs share one pool
        self._modules = GraphCache(self.device, shared_pool=True)
        self._prefill_modules = GraphCache(self.device,
                                           share_with=self._modules)
        self._staging = {}          # S -> host plan buffer (pinned)

    # -- buckets -------------------------------------------------------------
    def prompt_bucket(self, t0):
        for b in self.config.prompt_buckets:
            if b >= t0:
                return b
        raise ValueError(
            f'prompt length {t0} exceeds the declared bucket set '
            f'{self.config.prompt_buckets}')

    def _chunk_bucket(self, n):
        return bucket_pow2(n, cap=self.config.prefill_batch)

    # -- device work ---------------------------------------------------------
    def _prefill_plan(self, ids, t0s, blocks, seeds):
        """The host plan ``[B, P + 2 + nblk]`` int64 of one prefill
        dispatch: each row's padded ids, true length, seed and block
        table.  A fresh pinned buffer a dispatch: several dispatches of
        one intervention may share a module, and the caching host
        allocator keeps a buffer until its copy to the card is done."""
        B, P = ids.shape
        plan = torch.empty((B, P + 2 + blocks.shape[1]), dtype=torch.int64,
                           pin_memory=self.device.type == 'cuda')
        host = plan.numpy()
        host[:, :P] = ids
        host[:, P] = t0s
        host[:, P + 1] = seeds
        host[:, P + 2:] = blocks
        return plan

    @torch.no_grad()
    def _prefill_body(self, plan, P):
        """ONE cached forward over B padded prompts, on device tensors
        only (the card captures it): per-row first tokens sampled at
        each row's true length, every row's block-rounded KV scattered
        (in place) into its own blocks of the persistent pools, which
        live outside any graph's pool.  Returns the first tokens
        ``[B]``."""
        model = self.model
        B = plan.shape[0]
        ids = plan[:, :P]
        t0, seeds = plan[:, P], plan[:, P + 1]
        blk = plan[:, P + 2:]
        nblk = blk.shape[1]
        bs = self.config.block_size
        nh = model.config.num_heads
        hd = model.config.hidden_size // nh
        caches = model.init_decode_caches(B, nblk * bs)
        logits, caches = model.prefill(ids, 0, caches)
        rows = logits[torch.arange(B, device=logits.device), t0 - 1]
        # the first token's absolute position is t0-1, where
        # generate's prefill samples too
        tok = self._sample(rows, seeds, t0 - 1)
        for (kbuf, vbuf), (kp, vp) in zip(caches, self.cache.pools):
            # [B, nh, Pc, hd] -> [B, nblk, nh, bs, hd] block rows
            kp[blk] = kbuf.reshape(B, nh, nblk, bs, hd) \
                .permute(0, 2, 1, 3, 4).to(kp.dtype)
            vp[blk] = vbuf.reshape(B, nh, nblk, bs, hd) \
                .permute(0, 2, 1, 3, 4).to(vp.dtype)
        return tok

    def _prefill_module(self, P, B):
        """The prefill module of prompt bucket ``P`` and chunk ``B``:
        made at first use and called once on an inert plan (every row
        on the trash block), which on the card warms it up and captures
        it."""
        nblk = blocks_for(P, self.config.block_size)
        inert = np.zeros((B, nblk), np.int32)
        return self._prefill_modules.module(
            (P, B), functools.partial(self._prefill_body, P=P),
            warmup_inputs=(self._prefill_plan(
                np.zeros((B, P), np.int64), np.full((B,), P, np.int64),
                inert, np.zeros((B,), np.int64)),))

    def _prefill(self, ids, t0s, blocks, seeds):
        """One prefill dispatch through its (P, B) module; returns the
        first tokens as an un-synced device tensor ``[B]`` of its own
        (the module's output is overwritten by its next replay)."""
        B, P = ids.shape
        plan = self._prefill_plan(ids, t0s, blocks, seeds)
        tok = self._prefill_module(P, B)(plan).clone()
        self.prefill_dispatches += 1
        return tok

    # the plan's columns after each row's block table
    _PLAN_COLS = ('ctx', 'tok', 'active', 'limit', 'seed')

    @torch.no_grad()
    def _span_body(self, plan, span):
        """``span`` single-token steps of the WHOLE live set, on device
        tensors only (no host read, so the card can capture it).  Row i
        of ``plan`` ``[S, W + 5]`` int64 is request i's block table, then
        its ctx, last token, active flag, limit and seed.  Returns
        ``[2, span, S]`` int64: each step's tokens and their validity."""
        model = self.model
        eos = self.config.eos_id
        W = plan.shape[1] - len(self._PLAN_COLS)
        tables = plan[:, :W]
        ctx, tok, active, limit, seeds = plan[:, W:].unbind(1)
        active = active != 0
        toks, valid = [], []
        for _ in range(span):
            views = [PagedCacheView(kp, vp, tables, ctx, ctx + 1)
                     for kp, vp in self.cache.pools]
            logits, _ = model.decode_step(tok[:, None], ctx, views)
            # each row samples at its OWN absolute position with its
            # OWN request seed
            ntok = self._sample(logits[:, -1], seeds, ctx)
            valid.append(active)
            ntok = torch.where(active, ntok, tok)
            ctx = ctx + active.long()
            nactive = active & (ctx < limit)
            if eos is not None:
                nactive = nactive & (ntok != eos)
            toks.append(ntok)
            tok, active = ntok, nactive
        return torch.stack((torch.stack(toks), torch.stack(valid).long()))

    def _decode_module(self, S, K):
        """The decode module of batch bucket ``S`` and span ``K``: made at
        first use and called once on an inert plan (every table on the
        trash block, every lane inactive), which on the card warms the
        span up and captures it."""
        W = self.scheduler.table_width
        return self._modules.module(
            (S, K), functools.partial(self._span_body, span=K),
            warmup_inputs=(torch.zeros((S, W + len(self._PLAN_COLS)),
                                       dtype=torch.int64),))

    def _decode_span(self, tables, ctx, tok, active, limit, seeds, span):
        """One span of the live set through its module; returns host
        ``(toks, valid)``, each ``[span, S]``."""
        S, W = tables.shape
        plan = self._staging.get(S)
        if plan is None:
            plan = torch.zeros((S, W + len(self._PLAN_COLS)),
                               dtype=torch.int64,
                               pin_memory=self.device.type == 'cuda')
            self._staging[S] = plan
        # the last span's read synchronised: the buffer is free again
        host = plan.numpy()
        host[:, :W] = tables
        for j, col in enumerate((ctx, tok, active, limit, seeds), W):
            host[:, j] = col
        # the card's module copies the plan into its static buffer; the
        # CPU's body reads it in place
        out = self._decode_module(S, span)(plan)
        self.decode_steps += span
        out = out.cpu().numpy()
        return out[0], out[1].astype(bool)

    # -- request lifecycle ---------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, rid=None,
               arrival_t=None, deadline_s=None):
        # the config's per-request completion budget, if any
        default_deadline = self.config.request_deadline_s
        if isinstance(prompt, Request):
            req = prompt
            if req.deadline_s is None:
                req.deadline_s = default_deadline
        else:
            self._rid += 1
            req = Request(
                rid if rid is not None else f'r{self._rid:05d}',
                prompt, max_new_tokens,
                arrival_t=(arrival_t if arrival_t is not None
                           else self._clock()),
                deadline_s=(deadline_s if deadline_s is not None
                            else default_deadline))
        if req.seed is None:
            req.seed = request_seed(req.rid, self.config.seed)
        return self.scheduler.submit(req)

    def cancel(self, rid, cause='cancelled'):
        """Evict one in-flight request; rolls its decoded-token
        accounting back.  True if the rid was queued or running."""
        sched = self.scheduler
        for req in list(sched.queue):
            if req.rid == rid:
                sched.queue.remove(req)
                sched.finish(req, cause)
                return True
        for req in list(sched.running):
            if req.rid == rid:
                self.decoded_tokens -= len(req.tokens)
                sched.finish(req, cause)
                return True
        return False

    def _prefill_dispatch(self, reqs):
        """ONE batched prefill over a chunk of same-bucket admissions;
        returns the un-synced first tokens [chunk bucket]."""
        P = reqs[0].prompt_bucket
        nblk = blocks_for(P, self.config.block_size)
        B = self._chunk_bucket(len(reqs))
        ids = np.zeros((B, P), np.int64)
        t0s = np.ones((B,), np.int32)      # padding rows sample row 0
        blocks = np.zeros((B, nblk), np.int32)   # padding -> trash
        seeds = np.zeros((B,), np.int64)
        for i, req in enumerate(reqs):
            ids[i, :req.prompt.size] = req.prompt
            t0s[i] = req.prompt.size
            blocks[i] = self.cache.owned(req.rid)[:nblk]
            seeds[i] = req.seed or 0
        tok = self._prefill(ids, t0s, blocks, seeds)
        now = self._clock()
        for req in reqs:
            req.trace_note('prefill', now, bucket=P, chunk=B,
                           dispatch=self.prefill_dispatches)
        return tok

    def _prefill_finish(self, req, tok):
        """Record one synced first token (TTFT anchor) and finish the
        request if it is already complete."""
        req.tokens.append(int(tok))
        req.first_token_t = self._clock()
        req.trace_note('first_token', req.first_token_t)
        self.decoded_tokens += 1
        if self.config.eos_id is not None \
                and req.tokens[-1] == self.config.eos_id:
            self.scheduler.finish(req, 'eos')
        elif len(req.tokens) >= req.max_new_tokens:
            self.scheduler.finish(req, 'max_tokens')
        return req

    # -- the intervention loop -----------------------------------------------
    def step(self, now=None):
        """ONE scheduler intervention: release/admit/prefill, decode
        the live set for one span, absorb, evict, backfill.  Returns
        the progress count (admissions + evictions + decoded tokens)."""
        sched = self.scheduler
        now = self._clock() if now is None else now
        breached = sched.check_deadlines(now)
        dispatched, chunk = [], []
        admitted = 0

        def flush():
            if chunk:
                dispatched.append((list(chunk),
                                   self._prefill_dispatch(chunk)))
                chunk.clear()

        while True:
            req = sched.admit_next()
            if req is None:
                break
            admitted += 1
            if chunk and (req.prompt_bucket != chunk[0].prompt_bucket
                          or len(chunk) >= self.config.prefill_batch):
                flush()
            chunk.append(req)
        flush()
        for reqs, toks_dev in dispatched:
            toks = toks_dev.cpu().numpy()
            for i, req in enumerate(reqs):
                self._prefill_finish(req, toks[i])
        progress = admitted + len(breached)
        if not sched.running:
            return progress
        preempted = sched.reserve_span(sched.decode_span)
        # a preempted request's tokens are recomputed later: un-count
        # them so tokens_per_s counts delivered tokens once
        self.decoded_tokens -= sum(getattr(r, 'discarded_tokens', 0)
                                   for r in preempted)
        plan = sched.plan()
        if plan is None:
            return progress
        toks, valid = self._decode_span(plan.tables, plan.ctx, plan.tok,
                                        plan.active, plan.limit,
                                        plan.seed, plan.span)
        sched.absorb(plan, toks, valid)
        n = int(valid.sum())
        self.decoded_tokens += n
        self.interventions += 1
        return progress + n

    def run(self, requests=(), timeout_s=None):
        """Drive to drain: submit `requests` honoring their
        ``arrival_t`` offsets, loop interventions until every request
        completes or evicts.  Returns the report dict."""
        pending = sorted(requests, key=lambda r: r.arrival_t)
        sched = self.scheduler
        t0 = self.now_fn()
        start = self._clock()
        fin0 = len(sched.finished)
        tok0 = self.decoded_tokens
        for r in pending:
            r.arrival_t = start + max(0.0, r.arrival_t)
        while pending or sched.queue or sched.running:
            now = self._clock()
            if timeout_s is not None and now - start > timeout_s:
                for req in list(sched.running) + list(sched.queue):
                    if req in sched.queue:
                        sched.queue.remove(req)
                    sched.finish(req, 'engine_timeout')
                pending = []
                break
            while pending and pending[0].arrival_t <= now:
                self.submit(pending.pop(0))
            if not sched.queue and not sched.running:
                if pending:
                    time.sleep(min(
                        0.05, max(0.0, pending[0].arrival_t - now)))
                continue
            if self.step(now=now) == 0 and not sched.running \
                    and sched.queue:
                # the head of the queue cannot be admitted even into
                # an empty pool: evict instead of spinning forever
                sched.finish(sched.queue.popleft(), 'oom')
        return self.report(wall_s=self.now_fn() - t0,
                           finished_from=fin0, tokens_from=tok0)

    # -- reporting -----------------------------------------------------------
    def report(self, wall_s=None, finished_from=0, tokens_from=0):
        """Latency/throughput report over the engine's life, or over
        one run()'s window when the slicing args are given."""
        now = self._clock()
        sched = self.scheduler
        recs = [r.record(now) for r in sched.finished[finished_from:]]
        ttfts = sorted(r['ttft_s'] for r in recs
                       if r['ttft_s'] is not None)
        tpots = [r['tpot_s'] for r in recs if r['tpot_s'] is not None]

        def pct(sorted_vals, q):
            if not sorted_vals:
                return None
            i = min(len(sorted_vals) - 1,
                    int(math.ceil(q * len(sorted_vals))) - 1)
            return sorted_vals[max(0, i)]

        decoded = self.decoded_tokens - tokens_from
        return {
            'requests': recs,
            'counters': dict(sched.counters),
            'decoded_tokens': decoded,
            'interventions': self.interventions,
            'prefill_dispatches': self.prefill_dispatches,
            'decode_steps': self.decode_steps,
            'wall_s': wall_s,
            'tokens_per_s': decoded / wall_s if wall_s else None,
            'ttft_p50_s': pct(ttfts, 0.50),
            'ttft_p99_s': pct(ttfts, 0.99),
            'tpot_mean_s': (sum(tpots) / len(tpots)) if tpots else None,
            'audit': sched.audit(),
        }

    def stats(self):
        return {'interventions': self.interventions,
                'decoded_tokens': self.decoded_tokens,
                'prefill_dispatches': self.prefill_dispatches,
                'decode_steps': self.decode_steps,
                'free_blocks': self.cache.free_blocks,
                'kv_frag': self.cache.frag_report()}

    def warmup(self):
        """Make every declared prefill module (prompt bucket x pow2
        chunk) and decode module (batch bucket x ``decode_span``) and
        call each once on inert inputs (every row on the trash block,
        decode lanes inactive): on the card that builds the kernels and
        captures every graph, so ``run()`` captures nothing.  Returns
        stats()."""
        c = self.config
        for P in c.prompt_buckets:
            for B in _pow2_chain(1, c.prefill_batch):
                self._prefill_module(P, B)
        for S in c.batch_buckets:
            self._decode_module(S, c.decode_span)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return self.stats()

    # -- declared bucket set -------------------------------------------------
    def bucket_set(self):
        """The declared module signatures (the reference's dict)."""
        c = self.config
        return {'prompt_buckets': list(c.prompt_buckets),
                'batch_buckets': list(c.batch_buckets),
                'prefill_chunks': list(_pow2_chain(1, c.prefill_batch)),
                'decode_span': c.decode_span,
                'block_size': c.block_size,
                'max_slots': c.max_slots,
                'max_model_len': c.max_model_len}

    def precompile(self):
        """What persists across processes, made for every declared
        module; returns ``(entries, errors)`` in the reference's shape,
        one entry per declared prefill and decode module.

        The reference exports each module's XLA executable into its
        persistent compile cache.  A CUDA graph cannot be serialised,
        so here what persists is the nvcc build of every kernel the
        modules launch (``ops._build``, keyed by source and flags under
        ``build/``); a later process loads the libraries instead of
        compiling.  ``warmup()`` stays the step that captures the
        graphs.  On the CPU nothing is built (the modules are the eager
        bodies over the plain twins) and each entry says so."""
        c = self.config
        specs = [(f'serve-prefill bucket {P} chunk {B}', ('prefill', P, B))
                 for P in c.prompt_buckets
                 for B in _pow2_chain(1, c.prefill_batch)]
        specs += [(f'serve-decode batch {S} span {c.decode_span}',
                   ('decode', S, c.decode_span)) for S in c.batch_buckets]
        # the serving forward's kernels: LayerNorm, and GEMM+GELU where
        # USE_PALLAS_MLP routes the MLP through it
        sources = ['fused_norm'] + (['fused_gelu_linear']
                                    if fused_gelu_linear.USE_PALLAS_MLP
                                    else [])
        tier = 'nvcc' if self.device.type == 'cuda' else 'eager'
        built, failure = [], None
        if tier == 'nvcc':
            try:
                built = _build.build(sources)
            except RuntimeError as e:    # reported per module, as there
                failure = repr(e)
        model_cfg = tuple(sorted(vars(self.model.config).items()))
        pspec = tuple(sorted((n, tuple(v.shape), str(v.dtype)) for n, v in
                             self.model.state_dict().items()))
        entries, errors = [], {}
        for desc, sig in specs:
            if failure is not None:
                errors[desc] = failure
                continue
            fp = hashlib.sha256(repr((
                sig, model_cfg, self.config.signature(), pspec,
                [p.rsplit('/', 1)[-1] for p in built])).encode()) \
                .hexdigest()
            entries.append({'tier': tier, 'fingerprint': fp,
                            'description': desc, 'kernels': list(built)})
        return entries, errors

    def close(self):
        """The reference tears down its live metrics plane here; the
        port has none yet (ROADMAP Queue 1 item 5), so this only keeps
        the API.  Idempotent; the engine stays usable."""
        return None
