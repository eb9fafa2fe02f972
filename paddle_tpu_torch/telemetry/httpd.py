"""Stdlib-only HTTP status server over a LiveAggregator (the port's
copy of ``paddle_tpu/telemetry/httpd.py``, with the same routes, the
same environment variables and the same off-by-default posture).

Four read-only routes, enough for a human with curl, a Prometheus
scraper, and a load balancer's health check:

* ``/healthz``        — liveness: ``{"ok": true, "uptime_s": …}``
* ``/status.json``    — the aggregator's full rolling snapshot
  (latency percentiles, rates, gauges, alerts, traced rids)
* ``/metrics``        — Prometheus text exposition format
* ``/requests/<rid>`` — one request's lifecycle trace (finished
  requests from the bounded ``serve_trace`` store; in-flight ones via
  the engine's live hook), 404 when unknown

One server, many views: besides the primary aggregator a server
carries a small **source registry** (``add_source(name, src)`` — any
object with ``snapshot()``/``prometheus()``), so one process exposes
the serving AND cluster planes on ONE port instead of double-binding:

* ``/<name>/status.json`` — that source's snapshot
  (``/cluster/status.json`` for the training-cluster view)
* ``/<name>/metrics``     — that source's families alone
* ``/metrics``            — the primary's families plus EVERY
  registered source's, concatenated (one scrape config per process)

``attach_source(name, src, port=…)`` is the module-level helper that
reuses a server already running in this process (whoever bound first
— typically the ServingEngine) or starts one.

Serving happens on daemon threads (ThreadingHTTPServer); every
response is computed from the aggregator's host-side rolling state
under its lock — a scrape NEVER touches a device array, a compiled
module, or the engine's scheduler structures, which is what makes
"scraping /metrics mid-run changes no numerics and adds no syncs"
provable (bench ``--obs-smoke`` and the bit-exactness test pin it).

Security note: binds ``127.0.0.1`` by default — metrics can leak
prompts' shape/timing and the trace view leaks rids; exporting the
port off-host is an explicit operator decision
(``PADDLE_TPU_METRICS_HOST=0.0.0.0``).

Off by default everywhere: construct+start explicitly, or let
``ServingEngine(serve_metrics_port=…)`` / ``PADDLE_TPU_METRICS_PORT``
do it (see :func:`resolve_metrics_port` for the posture).
"""
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ['MetricsServer', 'resolve_metrics_port', 'attach_source',
           'running_servers', 'METRICS_PORT_ENV', 'METRICS_HOST_ENV']

METRICS_PORT_ENV = 'PADDLE_TPU_METRICS_PORT'
METRICS_HOST_ENV = 'PADDLE_TPU_METRICS_HOST'


def resolve_metrics_port(arg=None):
    """The shared opt-in posture (mirrors ``resolve_watchdog``):
    explicit ``False`` -> None (off even if the env says on); an int
    passes through (0 = bind an ephemeral port — tests);``None`` ->
    the PADDLE_TPU_METRICS_PORT env decides, where unset/'0'/'off'/
    'false' mean off.  Returns a port int or None."""
    if arg is False:
        return None
    if arg is not None:
        return int(arg)
    text = (os.environ.get(METRICS_PORT_ENV) or '').strip().lower()
    if text in ('', '0', 'off', 'false'):
        return None
    return int(text)


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .aggregator (set by MetricsServer)
    protocol_version = 'HTTP/1.1'

    def log_message(self, *args):       # no stderr chatter per scrape
        pass

    def _send(self, code, body, ctype='application/json'):
        data = body if isinstance(body, bytes) else body.encode('utf-8')
        self.send_response(code)
        self.send_header('Content-Type', f'{ctype}; charset=utf-8')
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass                        # scraper went away mid-write

    def do_GET(self):                   # noqa: N802 (http.server API)
        agg = self.server.aggregator
        sources = getattr(self.server, 'sources', {})
        path = self.path.split('?', 1)[0].rstrip('/') or '/'
        try:
            if path == '/healthz':
                up = (agg.snapshot().get('uptime_s')
                      if agg is not None else None)
                self._send(200, json.dumps(
                    {'ok': True, 'uptime_s': up,
                     'sources': sorted(sources)}))
            elif path == '/status.json':
                if agg is None:
                    self._send(404, json.dumps(
                        {'error': 'no primary aggregator',
                         'sources': sorted(sources)}))
                else:
                    self._send(200, json.dumps(agg.snapshot(),
                                               indent=1))
            elif path == '/metrics':
                # the primary's families plus every registered
                # source's — one scrape endpoint per process.  A
                # broken source degrades to its name in a comment,
                # never a dead scrape.
                parts = []
                if agg is not None:
                    parts.append(agg.prometheus())
                for name, src in sorted(sources.items()):
                    try:
                        parts.append(src.prometheus())
                    except Exception:
                        parts.append(f'# source {name} failed\n')
                self._send(200, ''.join(parts) or '\n',
                           ctype='text/plain; version=0.0.4')
            elif path.startswith('/requests/'):
                if agg is None:
                    self._send(404, json.dumps(
                        {'error': 'no primary aggregator'}))
                    return
                rid = path[len('/requests/'):]
                doc = agg.request_trace(rid)
                if doc is None:
                    self._send(404, json.dumps(
                        {'error': f'unknown rid {rid!r}'}))
                else:
                    self._send(200, json.dumps(doc, indent=1))
            elif path == '/memory.json':
                # the memory observatory's three-way table (predicted
                # vs compiled vs live) — module-global state, so every
                # metrics server in the process serves it without any
                # wiring
                from . import memory as _mem
                self._send(200, json.dumps(_mem.snapshot(), indent=1))
            elif self._try_source(path, sources):
                pass
            elif path == '/':
                routes = ['/healthz', '/status.json', '/metrics',
                          '/requests/<rid>', '/memory.json']
                for name in sorted(sources):
                    routes += [f'/{name}/status.json',
                               f'/{name}/metrics']
                self._send(200, json.dumps({'routes': routes}))
            else:
                self._send(404, json.dumps({'error': 'not found'}))
        except Exception as e:          # a scrape must never crash it
            try:
                self._send(500, json.dumps({'error': repr(e)[:200]}))
            except Exception:
                pass

    def _try_source(self, path, sources):
        """Serve /<name>/status.json | /<name>/metrics for a
        registered source; False when the path is not source-shaped."""
        parts = path.lstrip('/').split('/')
        if len(parts) != 2 or parts[0] not in sources:
            return False
        src = sources[parts[0]]
        if parts[1] == 'status.json':
            self._send(200, json.dumps(src.snapshot(), indent=1))
        elif parts[1] == 'metrics':
            self._send(200, src.prometheus(),
                       ctype='text/plain; version=0.0.4')
        else:
            self._send(404, json.dumps({'error': 'not found'}))
        return True


class MetricsServer:
    """One live-metrics HTTP endpoint over one (optional) primary
    aggregator plus any number of named sources.

        srv = MetricsServer(agg, port=0).start()
        srv.add_source('cluster', cluster_agg)
        ... http://127.0.0.1:{srv.port}/cluster/status.json ...
        srv.stop()

    ``aggregator=None`` starts a registry-only server (the training
    cluster plane with no serving engine in-process).  A source is any
    object with ``snapshot()`` and ``prometheus()``.
    """

    # names the fixed routes own — a source may not shadow them
    _RESERVED = ('healthz', 'status.json', 'metrics', 'requests')

    def __init__(self, aggregator=None, port=0, host=None):
        self.aggregator = aggregator
        self.sources = {}
        self.requested_port = int(port)
        self.host = host or os.environ.get(METRICS_HOST_ENV,
                                           '127.0.0.1')
        self._httpd = None
        self._thread = None
        self.port = None

    # -- source registry -----------------------------------------------------
    def add_source(self, name, source):
        """Register `source` under `name` (routes
        ``/<name>/status.json`` + ``/<name>/metrics``, and its
        families join ``/metrics``).  Replaces an existing source of
        the same name."""
        name = str(name).strip('/')
        if not name or '/' in name or name in self._RESERVED:
            raise ValueError(f'bad source name {name!r}')
        if not (hasattr(source, 'snapshot')
                and hasattr(source, 'prometheus')):
            raise TypeError('a metrics source needs snapshot() and '
                            'prometheus()')
        self.sources[name] = source
        if self._httpd is not None:
            self._httpd.sources = self.sources
        return source

    def remove_source(self, name):
        src = self.sources.pop(name, None)
        if self._httpd is not None:
            self._httpd.sources = self.sources
        return src

    def start(self):
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        httpd.aggregator = self.aggregator
        httpd.sources = self.sources
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name='paddle-tpu-metrics',
            daemon=True)
        self._thread.start()
        _note_running(self)
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        t, self._thread = self._thread, None
        _note_stopped(self)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if t is not None:
            t.join(timeout=5.0)

    @property
    def url(self):
        return (None if self.port is None
                else f'http://{self.host}:{self.port}')

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# -- process-wide running-server registry -------------------------------------
#
# The double-binding fix: when a ServingEngine already bound a metrics
# port in this process, the training cluster plane must ADD its view
# there instead of fighting for a second port.  start()/stop() keep
# this list current; attach_source() consults it.

_running = []
_running_lock = threading.Lock()


def _note_running(server):
    with _running_lock:
        if server not in _running:
            _running.append(server)


def _note_stopped(server):
    with _running_lock:
        if server in _running:
            _running.remove(server)


def running_servers():
    """The MetricsServers currently serving in this process (oldest
    first — the first binder is the canonical process endpoint)."""
    with _running_lock:
        return list(_running)


def attach_source(name, source, port=None, host=None):
    """Expose `source` over HTTP on ONE port per process: reuse the
    process's already-running MetricsServer when there is one (the
    source registry — serving + cluster views together), else start a
    fresh registry-only server on `port`.  ``port=None`` with no
    running server means no HTTP (the caller did not opt in) —
    returns (None, False).  Otherwise returns (server, created)."""
    with _running_lock:
        live = _running[0] if _running else None
    if live is not None:
        live.add_source(name, source)
        return live, False
    if port is None:
        return None, False
    server = MetricsServer(None, port=port, host=host)
    server.add_source(name, source)
    server.start()
    return server, True
