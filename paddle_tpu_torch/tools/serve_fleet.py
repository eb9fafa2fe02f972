"""serve_fleet — multi-replica serving: N engine workers behind ONE door
(the port's counterpart of ``tools/serve_fleet.py``, over
``paddle_tpu_torch/serving/router.py``).

    # one replica worker (what the router spawns; also usable alone)
    python -m paddle_tpu_torch.tools.serve_fleet worker \\
        --config serve.json --port-file /tmp/r0.port [--warmup] \\
        [--host 127.0.0.1] [--device cuda] [--metrics-port 0]

    # a whole fleet: N active replicas + S warm spares + the door
    python -m paddle_tpu_torch.tools.serve_fleet up --config serve.json \\
        --replicas 2 --spares 1 [--port 8901] [--workdir DIR] \\
        [--device cuda]

CONFIG is the reference's serve-config JSON: ServeConfig fields plus
``"model"`` ('tiny' | 'small') and ``"model_kwargs"``; the model is
built from seed 0.  Workers run on ``--device``, the CUDA card by
default: without a card they exit non-zero with the message
``core.device.resolve_device`` gives, and they run on the CPU only when
asked with ``--device cpu``.  Each worker is a fresh interpreter with
its own CUDA context, and publishes ``{"port": ..., "pid": ...}``
through its --port-file once ``/healthz`` answers, which is the
router's readiness handshake.  ``--metrics-port`` (the port's
addition; 0 binds an ephemeral port) arms the engine's live metrics
plane (``/metrics``, ``/status.json``, ``/memory.json``) with one more
source, ``/kernels/status.json``: the worker's hand-written kernel
launches since it started, by kernel and design, beside its serving
graphs' replays (``KernelLaunches``); the port file then also carries
``metrics_port``.

``up`` binds the door to 127.0.0.1 by default — same posture as the
single-engine frontend; set PADDLE_TPU_FRONTEND_HOST to widen.
Requests that hit the door survive replica death mid-stream: the
router replays prompt+emitted-prefix on a survivor and the
per-request position-keyed sampling makes the resumed stream
bit-exact.

Exit codes: 0 clean shutdown, 1 startup failure, 2 usage error.
"""
import argparse
import json
import os
import signal
import sys
import threading

__all__ = ['build_engine', 'run_worker', 'launch_fleet', 'run_up',
           'main', 'KernelLaunches']


def _load_config(path):
    with open(path) as f:
        return json.load(f)


def resolve_fleet_device(device='cuda'):
    """The ``torch.device`` a worker runs on: ``'cuda'`` (the default)
    is the card, and raises with ``resolve_device``'s message where
    there is none (without making a CUDA context); anything else is
    taken as given."""
    import torch
    from ..core.device import resolve_device
    if str(device) == 'cuda':
        if not torch.cuda.is_available():
            resolve_device(None)            # raises, naming device='cpu'
        return torch.device('cuda')
    return resolve_device(device)


class KernelLaunches:
    """A metrics-server source (``snapshot()``/``prometheus()``) of this
    worker's hand-written kernel launches beside the CUDA-graph replays
    that made them, from host counters only: ``launches`` by kernel and,
    for a kernel with several designs, under ``'<kernel>:<design>'``,
    and ``graphs``, each captured serving graph (``'decode[SxK]'``,
    ``'prefill[PxB]'``) with its ``replays`` and its
    ``launches_a_replay``.  Read under ``_build.counts_lock``, which a
    replay holds only while it is counted, so the launches are exactly
    what the replays so far launched."""

    def __init__(self, engine):
        self.engine = engine

    def snapshot(self):
        from ..core.compile_cache import GraphModule
        from ..ops import _build
        eng = self.engine
        mods = [(f'{kind}[{a}x{b}]', mod)
                for kind, cache in (('decode', eng._modules),
                                    ('prefill', eng._prefill_modules))
                for (a, b), mod in list(cache.modules.items())
                if isinstance(mod, GraphModule) and mod.graph is not None]
        launches = {}
        with _build.counts_lock:
            for k in _build.KERNELS:
                launches[k.name] = k.launches
                for variant, n in k.variant_launches.items():
                    launches[f'{k.name}:{variant}'] = n
            graphs = {name: {'replays': mod.replays,
                             'launches_a_replay': mod.launches.counts()}
                      for name, mod in mods}
        return {'launches': launches, 'graphs': graphs}

    def prometheus(self):
        doc = self.snapshot()
        rows = ['# TYPE paddle_tpu_kernel_launches_total counter']
        for name, n in sorted(doc['launches'].items()):
            rows.append(f'paddle_tpu_kernel_launches_total'
                        f'{{kernel="{name}"}} {n}')
        rows.append('# TYPE paddle_tpu_graph_replays_total counter')
        for name, g in sorted(doc['graphs'].items()):
            rows.append(f'paddle_tpu_graph_replays_total'
                        f'{{graph="{name}"}} {g["replays"]}')
        return '\n'.join(rows) + '\n'


def build_engine(doc, device='cuda', serve_metrics_port=None):
    """Model + engine from a serve-config document, on ``device``: the
    model from seed 0, ``dropout`` 0 unless the document says
    otherwise."""
    from ..models import gpt as _gpt
    from ..serving import ServeConfig, ServingEngine
    builders = {'tiny': _gpt.gpt_tiny, 'small': _gpt.gpt_small}
    name = doc.get('model', 'tiny')
    if name not in builders:
        raise SystemExit(f'unknown model {name!r} '
                         f'(have {sorted(builders)})')
    kw = dict(doc.get('model_kwargs') or {})
    kw.setdefault('dropout', 0.0)
    model = builders[name](device=resolve_fleet_device(device), seed=0,
                           **kw)
    model.eval()
    return ServingEngine(model, ServeConfig.from_json(doc),
                         serve_metrics_port=serve_metrics_port)


def run_worker(args):
    from ..serving.frontend import ServingFrontend
    doc = _load_config(args.config)
    try:
        engine = build_engine(doc, device=args.device,
                              serve_metrics_port=args.metrics_port)
    except RuntimeError as e:
        print(f'[serve_fleet] worker failed to start: {e}',
              file=sys.stderr, flush=True)
        return 1
    if engine.metrics_server is not None:
        engine.metrics_server.add_source('kernels', KernelLaunches(engine))
    if args.warmup:
        engine.warmup()
    fe = ServingFrontend(engine, port=args.port,
                         host=args.host).start()
    if args.port_file:
        doc = {'port': fe.port, 'pid': os.getpid()}
        if engine.metrics_server is not None:
            doc['metrics_port'] = engine.metrics_server.port
        tmp = args.port_file + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(doc, f)
        os.replace(tmp, args.port_file)   # atomic: no partial reads
    print(f'[serve_fleet] worker ready on {fe.url} ({engine.device})',
          flush=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    fe.stop()
    return 0


def launch_fleet(config_path, replicas=2, spares=0, workdir=None,
                 extra_env=None, device='cuda', metrics=False):
    """Spawn the worker set on ``device`` and return a started
    :class:`FleetRouter` — the importable form ``up``, the smoke's fleet
    phase and the tests use.  ``device='cuda'`` (the default) raises
    here, before anything is spawned, where there is no card.  Every
    worker runs ``warmup()`` before its door opens, active replicas as
    well as spares (the reference warms only the spares): on the card
    that captures every CUDA graph before any request arrives, so no
    capture ever runs beside the door's threads.  ``metrics=True`` arms
    every worker's metrics plane (``ReplicaHandle.metrics_port``)."""
    from ..serving.router import FleetRouter, ReplicaHandle
    device = str(device)
    resolve_fleet_device(device)
    workdir = workdir or os.path.join('.', '_fleet')
    active, warm = [], []
    for names, out in (([f'r{i}' for i in range(replicas)], active),
                       ([f's{i}' for i in range(spares)], warm)):
        for name in names:
            out.append(ReplicaHandle.spawn(
                name, config_path, workdir, warmup=True,
                extra_env=extra_env, device=device, metrics=metrics))
    try:
        for rep in active + warm:
            rep.wait_ready()
    except Exception:
        for rep in active + warm:
            rep.kill()
            rep.reap()
        raise
    return FleetRouter(active, spares=warm)


def run_up(args):
    from ..serving.frontend import FRONTEND_HOST_ENV
    from ..serving.router import FleetFrontend
    host = os.environ.get(FRONTEND_HOST_ENV, '127.0.0.1')
    try:
        router = launch_fleet(args.config, replicas=args.replicas,
                              spares=args.spares,
                              workdir=args.workdir, device=args.device)
    except Exception as e:
        print(f'[serve_fleet] fleet failed to start: {e}',
              file=sys.stderr, flush=True)
        return 1
    router.start_health_loop()
    door = FleetFrontend(router, port=args.port, host=host).start()
    print(f'[serve_fleet] door open on {door.url} '
          f'({args.replicas} replicas, {args.spares} spares, '
          f'{args.device})', flush=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    door.stop()
    router.stop()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='serve_fleet',
        description='multi-replica serving fleet (worker + door)')
    sub = ap.add_subparsers(dest='cmd', required=True)

    w = sub.add_parser('worker', help='one engine replica')
    w.add_argument('--config', required=True,
                   help='serve-config JSON (ServeConfig fields + model)')
    w.add_argument('--port-file',
                   help='publish {"port", "pid"} here once ready')
    w.add_argument('--port', type=int, default=0)
    w.add_argument('--host', default='127.0.0.1')
    w.add_argument('--warmup', action='store_true',
                   help='run engine.warmup() before opening the door')
    w.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    w.add_argument('--metrics-port', type=int, default=None,
                   help='arm the live metrics plane on this port '
                        '(0: ephemeral)')

    u = sub.add_parser('up', help='N replicas + spares + the door')
    u.add_argument('--config', required=True)
    u.add_argument('--replicas', type=int, default=2)
    u.add_argument('--spares', type=int, default=0)
    u.add_argument('--port', type=int, default=0)
    u.add_argument('--workdir', default=None)
    u.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")

    args = ap.parse_args(argv)
    if args.cmd == 'worker':
        return run_worker(args)
    return run_up(args)


if __name__ == '__main__':
    sys.exit(main())
