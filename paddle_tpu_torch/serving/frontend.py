"""Serving front door: the streaming HTTP request plane over ONE
:class:`ServingEngine` (the port's copy of
``paddle_tpu/serving/frontend.py``: the same routes, SSE framing, JSON
keys, typed rejections and threading contract).

The metrics plane (``telemetry/httpd.py``) is read-only; this is the
plane clients talk to — the same stdlib posture (ThreadingHTTPServer,
daemon threads, 127.0.0.1 default bind, default OFF: nothing binds
unless a caller constructs one):

* ``POST /v1/generate``      — submit; token-at-a-time SSE stream
  (``stream: true``, chunked transfer) or one JSON document
* ``POST /v1/cancel/<rid>``  — evict an in-flight request
* ``POST /admin/drain``      — stop admitting (typed 503s), finish
  in-flight; the router's replica-swap lever
* ``GET  /healthz``          — liveness + draining flag
* ``GET  /status.json``      — live occupancy/queue-depth snapshot
  (what the router's dispatch reads)

**Admission control** degrades overload predictably instead of OOMing
or starving: a bounded admission queue and the scheduler's own
worst-case-block preflight shed excess load with TYPED rejections —
the :class:`~.scheduler.RejectReason` taxonomy (429 ``queue_full``,
503 ``draining``, 413 ``exceeds_pool``), each carrying a
``Retry-After`` derived from live TPOT, each emitting a
``serve_reject`` event.  A client that disconnects mid-stream (or
cancels) has its request EVICTED and its delivered-token accounting
rolled back through the preemption path (``ServingEngine.cancel``),
so an abandoned stream frees KV blocks at the next intervention
instead of decoding to its limit.

**Threading contract**: the scheduler/engine structures are not
thread-safe, so ONE daemon engine thread owns every engine mutation
(an intervention loop around ``engine.step()``); HTTP handler threads
talk to it through a control queue (submit/cancel ops, each acked via
an Event) and read request progress through ``Request.tokens`` —
CPython list appends are atomic, and the reader only indexes below
``len``, so streaming never takes the engine's locks and a slow
client never stalls decode (tokens buffer host-side; TCP backpressure
stays in the handler thread).  On the card the engine thread is also
the only thread that touches CUDA: handler threads read host lists,
never a device tensor, and the engine's graphs are captured by
``warmup()`` (call it before ``start()``; a module first made under
traffic is captured on the engine thread, with the handler threads
doing host work only).
"""
import json
import os
import queue
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import telemetry
from .scheduler import RejectReason, RejectedRequest

__all__ = ['ServingFrontend', 'FRONTEND_HOST_ENV']

FRONTEND_HOST_ENV = 'PADDLE_TPU_FRONTEND_HOST'


class DoorServer(ThreadingHTTPServer):
    """The doors' HTTP server: daemon handler threads and a listen
    backlog of 128 (``socketserver``'s default of 5 drops the SYNs of a
    burst of new streams, which the client retries after a second)."""
    daemon_threads = True
    request_queue_size = 128


class _Op:
    """One control-queue operation (HTTP thread -> engine thread)."""

    def __init__(self, kind, **kw):
        self.kind = kind
        self.kw = kw
        self.done = threading.Event()
        self.result = None
        self.error = None

    def finish(self, result=None, error=None):
        self.result, self.error = result, error
        self.done.set()

    def wait(self, timeout_s):
        if not self.done.wait(timeout_s):
            raise TimeoutError(f'engine loop did not ack {self.kind}')
        if self.error is not None:
            raise self.error
        return self.result


class ServingFrontend:
    """One engine, one door.

    ::

        fe = ServingFrontend(engine, port=0).start()
        ... POST http://127.0.0.1:{fe.port}/v1/generate ...
        fe.drain(); fe.stop()

    ``max_queue`` bounds ADMISSION (scheduler queue + in-flight
    control ops); past it new work sheds with 429 ``queue_full``.
    ``port=0`` binds an ephemeral port (tests/fleet workers).
    ``poll_s`` is the longest a waiting stream, or the idle engine
    thread, sleeps before it looks again (for a client gone away, for
    the stop flag): the engine thread wakes waiting streams after each
    intervention and op batch (``wait_progress``), so the reference's
    2 ms polling of every stream, which on the card starved the engine
    thread of the GIL with 32 streams open, is gone.
    """

    def __init__(self, engine, port=0, host=None, max_queue=None,
                 poll_s=0.05):
        self.engine = engine
        self.requested_port = int(port)
        self.host = host or os.environ.get(FRONTEND_HOST_ENV,
                                           '127.0.0.1')
        self.max_queue = (2 * engine.config.max_slots
                          if max_queue is None else int(max_queue))
        self.poll_s = float(poll_s)
        self.draining = False
        self.shed_counts = {r: 0 for r in RejectReason.ALL}
        # alerts forced through POST /admin/alert/<kind> — the chaos
        # drill's deterministic stand-in for a latched monitor (the
        # real SLOMonitor/MemoryMonitor latches ride the same status
        # field when the live plane is armed)
        self.forced_alerts = set()
        self._requests = {}          # rid -> Request (every admitted)
        self._ops = queue.Queue()
        # the engine thread's progress counter: bumped, under the
        # condition, after every op batch and intervention
        self._progress = threading.Condition()
        self._version = 0
        self._pending_submits = 0    # ops in flight toward the queue
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._httpd = None
        self._http_thread = None
        self.port = None
        self.started_t = time.monotonic()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        self._thread = threading.Thread(
            target=self._engine_loop, name='paddle-tpu-frontdoor-engine',
            daemon=True)
        self._thread.start()
        httpd = DoorServer((self.host, self.requested_port), _Handler)
        httpd.frontend = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=httpd.serve_forever, name='paddle-tpu-frontdoor-http',
            daemon=True)
        self._http_thread.start()
        return self

    @property
    def url(self):
        return (None if self.port is None
                else f'http://{self.host}:{self.port}')

    def drain(self):
        """Stop admitting (new submissions shed 503 ``draining``);
        in-flight requests run to completion.  Idempotent."""
        self.draining = True
        return self

    def stop(self, timeout_s=10.0):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=timeout_s)
            self._http_thread = None
        self.engine.close()

    # -- the engine thread ---------------------------------------------------
    def _run_op(self, op):
        eng = self.engine
        try:
            if op.kind == 'submit':
                try:
                    op.finish(eng.submit(**op.kw))
                finally:
                    with self._lock:
                        self._pending_submits -= 1
            elif op.kind == 'cancel':
                op.finish(eng.cancel(**op.kw))
            else:
                op.finish(error=ValueError(op.kind))
        except Exception as e:      # pragma: no cover - relay
            op.finish(error=e)

    def _engine_loop(self):
        """The ONLY thread that mutates the engine: drain control
        ops, run one intervention, repeat.  Mirrors ``engine.run()``'s
        drain loop but never exits on an empty schedule — the door
        stays open until stop().  Idle, it blocks on the op queue (a
        new request wakes it at once); after every op batch and every
        intervention it wakes the streams waiting for progress."""
        eng = self.engine
        sched = eng.scheduler
        while not self._stop.is_set():
            ran_op = False
            while True:
                try:
                    op = self._ops.get_nowait()
                except queue.Empty:
                    break
                ran_op = True
                self._run_op(op)
            if ran_op:
                self._notify()
            if not sched.queue and not sched.running:
                if not ran_op:
                    try:
                        op = self._ops.get(timeout=self.poll_s)
                    except queue.Empty:
                        continue
                    self._run_op(op)
                    self._notify()
                continue
            if eng.step() == 0 and not sched.running and sched.queue:
                # the head of the queue can never be admitted even
                # into an empty pool (engine.run()'s livelock guard —
                # preflight makes this near-unreachable, but a guard
                # that spins forever is worse than one that evicts)
                req = sched.queue.popleft()
                sched.finish(req, 'oom')
                eng._note_finished([req], eng._clock())
            self._notify()

    # -- progress (engine thread -> HTTP threads) ----------------------------
    def _notify(self):
        with self._progress:
            self._version += 1
            self._progress.notify_all()

    def wait_progress(self, version, timeout_s=None):
        """Block until the engine thread moved past ``version`` (an op
        batch or an intervention ran) or ``timeout_s`` passed; returns
        the current version.  Streams wait here instead of polling, so
        a live stream costs a wake-up per intervention, not one per
        ``poll_s``, and they leave the GIL to the engine thread."""
        with self._progress:
            if self._version == version:
                self._progress.wait(self.poll_s if timeout_s is None
                                    else timeout_s)
            return self._version

    # -- admission (HTTP threads) --------------------------------------------
    def submit(self, prompt, max_new_tokens, rid=None,
               deadline_s=None):
        """Typed admission: sheds BEFORE touching the engine thread
        when draining or the admission queue is full; the engine's own
        preflight sheds ``exceeds_pool``.  Returns the live Request;
        raises RejectedRequest."""
        if self.draining:
            self._shed(RejectReason.DRAINING, rid,
                       'front door is draining')
        with self._lock:
            depth = (len(self.engine.scheduler.queue)
                     + self._pending_submits)
            if depth >= self.max_queue:
                pass                    # shed outside the lock
            else:
                self._pending_submits += 1
                depth = None
        if depth is not None:
            self._shed(RejectReason.QUEUE_FULL, rid,
                       f'admission queue at capacity ({depth} >= '
                       f'{self.max_queue})')
        op = _Op('submit', prompt=np.asarray(prompt, np.int64),
                 max_new_tokens=int(max_new_tokens), rid=rid,
                 deadline_s=deadline_s)
        self._ops.put(op)
        try:
            req = op.wait(timeout_s=30.0)
        except RejectedRequest as e:
            # engine.submit already emitted serve_reject; count it
            self.shed_counts[e.reason] += 1
            raise
        self._requests[req.rid] = req
        telemetry.add('frontdoor.admitted', 1)
        return req

    def _shed(self, reason, rid, detail):
        self.shed_counts[reason] += 1
        retry = self.retry_after_s()
        telemetry.event('serve_reject', rid=rid, reason=reason,
                        detail=detail, retry_after_s=retry)
        raise RejectedRequest(reason, detail, rid=rid)

    def cancel(self, rid, cause='cancelled'):
        """Evict an in-flight request from any thread (handler path
        for /v1/cancel and for detected client disconnects)."""
        op = _Op('cancel', rid=rid, cause=cause)
        self._ops.put(op)
        try:
            return bool(op.wait(timeout_s=30.0))
        except TimeoutError:
            return False

    def get_request(self, rid):
        return self._requests.get(rid)

    # -- load-shedding arithmetic --------------------------------------------
    def _recent_tpot_s(self, tail=16):
        """Live TPOT estimate from the most recent finished requests
        (host-side fields only — no device sync, no aggregator
        dependency)."""
        vals = []
        for req in self.engine.scheduler.finished[-tail:]:
            if (req.finish_t is not None
                    and req.first_token_t is not None
                    and len(req.tokens) > 1):
                vals.append((req.finish_t - req.first_token_t)
                            / (len(req.tokens) - 1))
        return (sum(vals) / len(vals)) if vals else None

    def retry_after_s(self):
        """``Retry-After`` for a typed rejection: the backlog's
        decode work at the live TPOT, spread over the slots — i.e.
        roughly when a queue position frees up.  Falls back to the
        watchdog step allowance, then a constant, when no TPOT has
        been observed yet."""
        eng = self.engine
        tpot = self._recent_tpot_s()
        if tpot is None:
            if eng.budget is not None:
                tpot = eng.budget.effective_step_s() \
                    / max(1, eng.config.decode_span)
            else:
                tpot = 0.05
        backlog = sum(r.max_new_tokens for r in
                      list(eng.scheduler.queue))
        backlog += sum(max(0, r.max_new_tokens - len(r.tokens))
                       for r in list(eng.scheduler.running))
        est = tpot * backlog / max(1, eng.config.max_slots)
        return round(min(30.0, max(0.05, est)), 3)

    # -- status (HTTP threads; best-effort reads) ----------------------------
    def alerts(self):
        """Latched alert kinds the router's supervision acts on
        (drain + warm-spare promotion): the live plane's monitor
        latches — SLOMonitor -> ``slo_breach``, MemoryMonitor ->
        ``memory_pressure`` — plus any drill-forced kinds."""
        out = set(self.forced_alerts)
        for mon in self.engine.monitors:
            if not getattr(mon, '_latched', None):
                continue
            name = type(mon).__name__
            if name == 'SLOMonitor':
                out.add('slo_breach')
            elif name == 'MemoryMonitor':
                out.add('memory_pressure')
            elif name == 'DriftMonitor':
                out.add('drift_detected')
        return sorted(out)

    def status(self):
        eng = self.engine
        sched = eng.scheduler
        total = eng.cache.num_blocks
        free = eng.cache.free_blocks
        return {
            'ok': True,
            'draining': bool(self.draining),
            'uptime_s': round(time.monotonic() - self.started_t, 3),
            'queue_depth': len(sched.queue),
            'live': len(sched.running),
            'in_flight': len(sched.queue) + len(sched.running),
            'max_queue': self.max_queue,
            'max_slots': eng.config.max_slots,
            'free_blocks': free,
            'total_blocks': total,
            'kv_occupancy': round(1.0 - free / total, 4) if total
            else None,
            'shed_counts': dict(self.shed_counts),
            'alerts': self.alerts(),
            'counters': dict(sched.counters),
            'decoded_tokens': eng.decoded_tokens,
            'interventions': eng.interventions,
            'tpot_s': self._recent_tpot_s(),
            'retry_after_s': self.retry_after_s(),
        }


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .frontend (set by ServingFrontend)
    protocol_version = 'HTTP/1.1'

    def log_message(self, *args):       # no stderr chatter per request
        pass

    # -- plumbing ------------------------------------------------------------
    def _send_json(self, code, doc, headers=()):
        data = json.dumps(doc).encode('utf-8')
        self.send_response(code)
        self.send_header('Content-Type',
                         'application/json; charset=utf-8')
        self.send_header('Content-Length', str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _read_body(self):
        n = int(self.headers.get('Content-Length') or 0)
        raw = self.rfile.read(n) if n else b''
        if not raw:
            return {}
        return json.loads(raw.decode('utf-8'))

    def _reject(self, exc, retry_after_s):
        self._send_json(
            exc.http_status,
            {'error': exc.reason, 'detail': exc.detail,
             'rid': exc.rid, 'retry_after_s': retry_after_s},
            headers=(('Retry-After',
                      str(max(1, int(round(retry_after_s)))),),))

    # -- routes --------------------------------------------------------------
    def do_GET(self):                   # noqa: N802 (http.server API)
        fe = self.server.frontend
        path = self.path.split('?', 1)[0].rstrip('/') or '/'
        try:
            if path == '/healthz':
                self._send_json(200, {
                    'ok': True, 'draining': bool(fe.draining),
                    'uptime_s': round(
                        time.monotonic() - fe.started_t, 3)})
            elif path == '/status.json':
                self._send_json(200, fe.status())
            else:
                self._send_json(404, {'error': 'not found'})
        except Exception as e:          # a probe must never crash it
            try:
                self._send_json(500, {'error': repr(e)[:200]})
            except Exception:
                pass

    def do_POST(self):                  # noqa: N802 (http.server API)
        fe = self.server.frontend
        path = self.path.split('?', 1)[0].rstrip('/') or '/'
        try:
            if path == '/v1/generate':
                self._generate(fe)
            elif path.startswith('/v1/cancel/'):
                rid = path[len('/v1/cancel/'):]
                hit = fe.cancel(rid, cause='cancelled')
                self._send_json(200 if hit else 404,
                                {'rid': rid, 'cancelled': bool(hit)})
            elif path == '/admin/drain':
                fe.drain()
                self._send_json(200, {'draining': True,
                                      'in_flight': fe.status()
                                      ['in_flight']})
            elif path.startswith('/admin/alert/'):
                kind = path[len('/admin/alert/'):]
                fe.forced_alerts.add(kind)
                self._send_json(200, {'alerts': fe.alerts()})
            else:
                self._send_json(404, {'error': 'not found'})
        except RejectedRequest as e:
            self._reject(e, fe.retry_after_s())
        except Exception as e:
            try:
                self._send_json(500, {'error': repr(e)[:200]})
            except Exception:
                pass

    # -- generate ------------------------------------------------------------
    def _generate(self, fe):
        doc = self._read_body()
        prompt = doc.get('prompt')
        if not prompt:
            self._send_json(400, {'error': 'bad_request',
                                  'detail': 'prompt required'})
            return
        req = fe.submit(prompt, int(doc.get('max_new_tokens', 16)),
                        rid=doc.get('rid'),
                        deadline_s=doc.get('deadline_s'))
        if doc.get('stream', True):
            self._stream(fe, req)
        else:
            version = fe._version
            while not req.done:
                version = fe.wait_progress(version)
            self._send_json(200, {
                'rid': req.rid, 'tokens': list(req.tokens),
                'state': req.state, 'reason': req.reason})

    def _stream(self, fe, req):
        """Token-at-a-time SSE over chunked transfer.  At-most-once
        delivery: every event carries the token's stream offset ``i``,
        so a router that lost this replica mid-stream knows exactly
        which prefix its client already holds.  A failed write means
        the client is gone — evict the request and roll its tokens
        back."""
        self.send_response(200)
        self.send_header('Content-Type', 'text/event-stream')
        self.send_header('Cache-Control', 'no-store')
        self.send_header('Transfer-Encoding', 'chunked')
        self.send_header('X-Request-Id', str(req.rid))
        self.end_headers()

        def chunk(data):
            self.wfile.write(b'%X\r\n%s\r\n' % (len(data), data))
            self.wfile.flush()

        def event(doc):
            chunk(b'data: ' + json.dumps(doc).encode('utf-8')
                  + b'\n\n')

        def client_gone():
            # a failed write only surfaces once kernel buffers fill —
            # a short stream fits entirely in them and the dead
            # client would never be noticed.  An SSE client sends
            # nothing after the request, so readable == EOF (or
            # pipelined garbage; either way this stream is over).
            r, _w, _x = select.select([self.connection], [], [], 0)
            if not r:
                return False
            try:
                return self.connection.recv(
                    1, socket.MSG_PEEK) == b''
            except OSError:
                return True

        sent = 0
        try:
            while True:
                # read the progress counter before the tokens: a step
                # that lands after this read wakes the wait below
                version = fe._version
                n = len(req.tokens)
                while sent < n:
                    event({'i': sent, 'token': int(req.tokens[sent])})
                    sent += 1
                if req.done and sent >= len(req.tokens):
                    break
                if client_gone():
                    raise ConnectionResetError('client closed stream')
                fe.wait_progress(version)
            event({'done': True, 'rid': req.rid, 'n': sent,
                   'state': req.state, 'reason': req.reason})
            chunk(b'')                  # terminal chunk
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client went away mid-stream: evict + roll back —
            # an abandoned request must not decode to its limit
            if not req.done:
                fe.cancel(req.rid, cause='client_disconnect')
