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
  made;
- per-request SLOs: watchdog budgets (``ServeConfig(watchdog=)`` or
  ``PADDLE_TPU_WATCHDOG``, ``resilience.watchdog.Budget``) give each
  request a deadline; a starved request is evicted with a ``timeout``
  telemetry event; TTFT and TPOT land on ``serve_request`` events and
  profile windows (``ServeConfig(profile=)``, ``telemetry.profile``)
  name exact decode step ids;
- live observability (``serve_metrics_port=`` /
  ``PADDLE_TPU_METRICS_PORT``, default OFF): a
  ``telemetry.live.LiveAggregator`` on the recorder's stream keeps
  rolling TTFT/TPOT/occupancy windows, SLO/drift (and, with a
  ``PADDLE_TPU_MEMSTATS`` budget, memory) monitors emit their edges,
  and ``telemetry.httpd.MetricsServer`` serves ``/healthz``
  ``/status.json`` ``/metrics`` ``/requests/<rid>``.  Every event is
  emitted from host state the engine already holds (the span's tokens
  are read once per intervention whatever is armed), so the plane adds
  no device sync and a scrape changes no numerics.  Under
  ``PADDLE_TPU_MEMSTATS`` each module's capture also records its graph
  pool bytes (``telemetry.memory.note_graph_capture``).

The decode math runs through ``GPTForCausalLM.prefill``/``decode_step``,
the same forward ``generate()`` uses, so greedy engine output equals
batch-1 ``generate``.
"""
import functools
import hashlib
import json
import math
import time
import zlib

import numpy as np
import torch

from .. import telemetry
from ..core.compile_cache import GraphCache, bucket_pow2
from ..ops import _build, fused_gelu_linear
from ..ops.sampling import make_row_sampler
from ..resilience.watchdog import resolve_watchdog
from ..telemetry import memory as _mem
from ..telemetry.httpd import MetricsServer, resolve_metrics_port
from ..telemetry.live import LiveAggregator
from ..telemetry.monitors import DriftMonitor, MemoryMonitor, SLOMonitor
from ..telemetry.profile import step_profiler
from .kv_cache import PagedKVCache, PagedCacheView, blocks_for
from .scheduler import ContinuousBatchingScheduler, RejectedRequest, Request

__all__ = ['ServeConfig', 'ServingEngine', 'DecodeAuditLayer',
           'request_seed']


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
        # watchdog budgets (resilience.watchdog.resolve_watchdog's
        # posture) and the step profiler's schedule
        # (telemetry.profile.resolve_schedule's); neither keys a module
        self.watchdog = watchdog
        self.profile = profile
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

    def __init__(self, model, config=None, now_fn=time.monotonic,
                 serve_metrics_port=None, live_window_s=60.0):
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
        self.budget = resolve_watchdog(self.config.watchdog)
        # first-token / rollback counts carried to the NEXT serve_step
        # event, so the live plane's token accounting matches
        # decoded_tokens exactly (a prefill-only intervention emits no
        # serve_step of its own)
        self._pending_prefilled = 0
        self._pending_discarded = 0
        self._prof = step_profiler(profile=self.config.profile,
                                   name='serve')
        # the CPU memory census counts what the engine holds
        _mem.track(model)
        for kp, vp in self.cache.pools:
            _mem.track(kp)
            _mem.track(vp)
        # -- live observability plane (default OFF; see telemetry.live) --
        # the aggregator consumes the recorder's boundary-rate stream,
        # the monitors turn its windows into slo_breach/drift_detected
        # events, and the HTTP server exposes /metrics + /status.json;
        # scrapes read host-side rolling state only
        self.live = None
        self.monitors = []
        self.metrics_server = None
        port = resolve_metrics_port(serve_metrics_port)
        if port is not None:
            self.live = LiveAggregator(window_s=live_window_s).install()
            self.live.live_trace_fn = self._live_trace
            # the Budget that derives per-request deadlines also defines
            # the aggregate TTFT envelope
            self.monitors = [
                self.live.attach_monitor(SLOMonitor(budget=self.budget)),
                self.live.attach_monitor(DriftMonitor()),
            ]
            mcfg = _mem.resolve_memstats()
            if mcfg is not None and mcfg.budget_bytes is not None:
                self.monitors.append(self.live.attach_monitor(
                    MemoryMonitor(config=mcfg)))
        # the live memory sampler: default OFF, armed by the same env
        # (idempotent; a daemon thread at boundary rate)
        _mem.ensure_sampler()
        if port is not None:
            try:
                self.metrics_server = MetricsServer(self.live,
                                                    port=port).start()
            except Exception:
                # a dead port must not leak the recorder subscription:
                # the engine never constructs, so close() never runs
                self.live.uninstall()
                self.live = None
                self.monitors = []
                raise

    # -- live plane ----------------------------------------------------------
    def _live_trace(self, rid):
        """telemetry.live hook: the in-flight trace for `rid` (the
        finished ones live in the aggregator's serve_trace store).
        Runs on a scrape thread while the engine thread mutates the
        scheduler's deques; copying one mid-mutation raises
        RuntimeError, so retry a few times and give up with None."""
        sched = self.scheduler
        for _ in range(4):
            try:
                reqs = list(sched.running) + list(sched.queue) \
                    + list(sched.finished)
                for req in reqs:
                    if req.rid == rid:
                        return [dict(row) for row in req.trace]
                return None
            except RuntimeError:    # mutated during iteration
                continue
        return None

    def close(self):
        """Tear down the live plane (HTTP server + stream subscription)
        and close an open profile window.  Idempotent; the engine stays
        usable."""
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.live is not None:
            self.live.uninstall()
        if self._prof is not None:
            self._prof.close()

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

    def request_deadline_s(self, max_new_tokens):
        """Per-request completion budget: the config's explicit value
        wins; an armed watchdog Budget derives prefill + per-span
        allowances; None = no deadline."""
        if self.config.request_deadline_s is not None:
            return float(self.config.request_deadline_s)
        if self.budget is None:
            return None
        return self.budget.request_budget_s(
            max_new_tokens, span=self.config.decode_span)

    def _made(self, cache, sig, name, make):
        """``make()``, the first call of a module (warm-up and capture on
        the card); under PADDLE_TPU_MEMSTATS its graph pool bytes become
        a ``memory_compiled`` event (telemetry.memory)."""
        mod = cache.modules.get(sig)
        if mod is not None:
            return mod
        return _mem.note_graph_capture(name, self.device, make,
                                       shared=cache.shared_pool)

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
        return self._made(
            self._prefill_modules, (P, B), f'serve.prefill[{P}x{B}]',
            lambda: self._prefill_modules.module(
                (P, B), functools.partial(self._prefill_body, P=P),
                warmup_inputs=(self._prefill_plan(
                    np.zeros((B, P), np.int64),
                    np.full((B,), P, np.int64), inert,
                    np.zeros((B,), np.int64)),)))

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
        return self._made(
            self._modules, (S, K), f'serve.decode[{S}x{K}]',
            lambda: self._modules.module(
                (S, K), functools.partial(self._span_body, span=K),
                warmup_inputs=(torch.zeros((S, W + len(self._PLAN_COLS)),
                                           dtype=torch.int64),)))

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
        if isinstance(prompt, Request):
            req = prompt
            if req.deadline_s is None:
                req.deadline_s = self.request_deadline_s(
                    req.max_new_tokens)
        else:
            self._rid += 1
            req = Request(
                rid if rid is not None else f'r{self._rid:05d}',
                prompt, max_new_tokens,
                arrival_t=(arrival_t if arrival_t is not None
                           else self._clock()),
                deadline_s=(deadline_s if deadline_s is not None
                            else self.request_deadline_s(
                                max_new_tokens)))
        if req.seed is None:
            # rid-derived, so the same request replayed on any replica
            # sharing the config seed samples the identical stream
            req.seed = request_seed(req.rid, self.config.seed)
        try:
            return self.scheduler.submit(req)
        except RejectedRequest as e:
            telemetry.event('serve_reject', rid=req.rid,
                            reason=e.reason, detail=e.detail)
            raise

    def cancel(self, rid, cause='cancelled'):
        """Evict one in-flight request (client cancel / disconnect):
        frees its blocks, rolls its decoded-token accounting back (a
        token nobody received does not count as delivered), and emits
        the finished-request telemetry with the typed cause.  True if
        the rid was queued or running."""
        sched = self.scheduler
        for req in list(sched.queue):
            if req.rid == rid:
                sched.queue.remove(req)
                sched.finish(req, cause)
                self._note_finished([req], self._clock())
                return True
        for req in list(sched.running):
            if req.rid == rid:
                rolled = len(req.tokens)
                self.decoded_tokens -= rolled
                self._pending_discarded += rolled
                sched.finish(req, cause)
                self._note_finished([req], self._clock())
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

    def _flush_pending_tokens(self, admitted, t_start):
        """A prefill-only intervention (nothing left running) emits a
        decode-less ``serve_step`` carrying the pending first-token /
        rollback counts, so no delivered token is lost to the early
        return paths."""
        if not self._pending_prefilled and not self._pending_discarded:
            return
        sched = self.scheduler
        frag = self.cache.frag_report()
        telemetry.event('serve_step', intervention=self.interventions,
                        live=0, batch=0, span=0, decoded=0,
                        admitted=admitted, finished=0, preempted=0,
                        queued=len(sched.queue),
                        free_blocks=self.cache.free_blocks,
                        total_blocks=self.cache.num_blocks,
                        kv_frag_frac=frag['frag_frac'],
                        kv_largest_free_run=frag['largest_free_run'],
                        kv_high_water=frag['high_water_blocks'],
                        prefilled=self._pending_prefilled,
                        discarded=self._pending_discarded,
                        dur_s=round(self._clock() - t_start, 6))
        self._pending_prefilled = 0
        self._pending_discarded = 0

    def _note_finished(self, finished, now):
        for req in finished:
            rec = req.record(now)
            telemetry.event('serve_request', **rec)
            # the full lifecycle trail, ONE event per finished request,
            # joinable with serve_request by rid, served live at
            # /requests/<rid>
            telemetry.event('serve_trace', rid=req.rid,
                            state=req.state, reason=req.reason,
                            prompt_bucket=req.prompt_bucket,
                            trace=[dict(r) for r in req.trace])
            if req.reason == 'deadline':
                telemetry.event(
                    'timeout', op='serve_request', rid=req.rid,
                    budget_s=req.deadline_s, age_s=rec['age_s'])

    # -- the intervention loop -----------------------------------------------
    def step(self, now=None):
        """ONE scheduler intervention: release/admit/prefill, decode
        the live set for one span, absorb, evict, backfill.  Returns
        the progress count (admissions + evictions + decoded tokens)."""
        sched = self.scheduler
        now = self._clock() if now is None else now
        t_start = self._clock()
        breached = sched.check_deadlines(now)
        self._note_finished(breached, now)
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
            self._pending_prefilled += len(reqs)
        self._note_finished(
            [r for reqs, _ in dispatched for r in reqs if r.done], now)
        progress = admitted + len(breached)
        if not sched.running:
            # everything finished at prefill (or was evicted): flush the
            # carried first-token counts now, no later serve_step will
            self._flush_pending_tokens(admitted, t_start)
            return progress
        preempted = sched.reserve_span(sched.decode_span)
        # a preempted request's tokens are recomputed later: un-count
        # them so tokens_per_s counts delivered tokens once
        discarded = sum(getattr(r, 'discarded_tokens', 0)
                        for r in preempted)
        self.decoded_tokens -= discarded
        self._pending_discarded += discarded
        plan = sched.plan()
        if plan is None:
            self._flush_pending_tokens(admitted, t_start)
            return progress
        toks, valid = self._decode_span(plan.tables, plan.ctx, plan.tok,
                                        plan.active, plan.limit,
                                        plan.seed, plan.span)
        if self._prof is not None:
            # the span's tokens were read to the host: its work is done
            self._prof.observe(self.interventions * plan.span,
                               span=plan.span)
        finished = sched.absorb(plan, toks, valid)
        self._note_finished(finished, self._clock())
        n = int(valid.sum())
        self.decoded_tokens += n
        self.interventions += 1
        frag = self.cache.frag_report()
        telemetry.event('serve_step', intervention=self.interventions,
                        live=len(plan.requests), batch=plan.batch,
                        span=plan.span, decoded=n, admitted=admitted,
                        finished=len(finished),
                        preempted=len(preempted),
                        queued=len(sched.queue),
                        free_blocks=self.cache.free_blocks,
                        total_blocks=self.cache.num_blocks,
                        kv_frag_frac=frag['frag_frac'],
                        kv_largest_free_run=frag['largest_free_run'],
                        kv_high_water=frag['high_water_blocks'],
                        prefilled=self._pending_prefilled,
                        discarded=self._pending_discarded,
                        dur_s=round(self._clock() - t_start, 6))
        self._pending_prefilled = 0
        self._pending_discarded = 0
        telemetry.add('serve.decoded_tokens', n)
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
        try:
            while pending or sched.queue or sched.running:
                now = self._clock()
                if timeout_s is not None and now - start > timeout_s:
                    timed_out = []
                    for req in list(sched.running) + list(sched.queue):
                        if req in sched.queue:
                            sched.queue.remove(req)
                        sched.finish(req, 'engine_timeout')
                        timed_out.append(req)
                    # the same telemetry as any other eviction
                    self._note_finished(timed_out, self._clock())
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
                    # the head of the queue cannot be admitted even
                    # into an empty pool: evict instead of spinning
                    req = sched.queue.popleft()
                    sched.finish(req, 'oom')
                    self._note_finished([req], self._clock())
        finally:
            if self._prof is not None:
                self._prof.close()
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
        if self.live is not None:
            # every declared module is made: a compile from here on is
            # an anomaly the drift monitor flags
            self.live.mark_steady()
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


class DecodeAuditLayer(torch.nn.Module):
    """One paged decode step as a module (the reference's audit
    surface): its forward runs the serving engine's per-step math,
    paged views and ragged attention over the pools, on the model's
    device.

    ``tok`` [S, 1] int64, ``k_pools``/``v_pools`` [L, num_blocks, H,
    block, D] (or a sequence of L pools), ``tables`` [S, W] int, ``ctx``
    [S] int64.  Returns ``(logits [S, 1, V], new k pools, new v pools)``
    with the new pools stacked [L, ...]; the inputs' pools are written
    in place, as the engine's are."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    @torch.no_grad()
    def forward(self, tok, k_pools, v_pools, tables, ctx):
        L = self.model.config.num_layers
        views = [PagedCacheView(k_pools[l], v_pools[l], tables, ctx,
                                ctx + 1) for l in range(L)]
        logits, views = self.model.decode_step(tok, ctx, views)
        nk = torch.stack([v.k_pool for v in views])
        nv = torch.stack([v.v_pool for v in views])
        return logits, nk, nv
