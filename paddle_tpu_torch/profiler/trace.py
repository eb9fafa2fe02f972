"""Trace parsing: a ``torch.profiler`` Chrome trace (``.json`` or
``.json.gz``) into per-op durations (counterpart of
``paddle_tpu/profiler/trace.py``).  The port's one trace parser:
``telemetry.profile``'s capture windows read their traces through it.

Which events are ops: the work on the device's timeline (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``), one event a launch, named
as the kernel is (``flash_fwd_mma<...>``, ``layer_norm_warp<...>``,
cuBLAS's GEMMs).  A trace with no device event (tensors on the CPU)
counts its ``cpu_op`` events instead, as the reference counts the CPU
runtime's thunks; a host op runs inside the op that called it
(``aten::linear`` around ``aten::addmm``), so ``ops`` lists every
one but ``device_total_us`` sums only the outermost of each thread.
``n_events`` counts the op events, as the reference's does.
``record_function`` ranges (``RecordEvent``,
``ParallelTrainer.forward``/``backward``/``optimizer``) are kept
apart, in ``ranges``.  Kernels whose name carries ``nccl`` are the
collectives.

The reference also joins each profiled collective with the compiled
module's HLO census (``match_collectives``); a CUDA graph has no HLO
and the port has no instruction census yet (ROADMAP Queue 1 item 11),
so ``match_collectives`` raises.

Standard library only (gzip and json), so it runs inside the training
process at a window's close and on any machine against an archived
trace::

    prof = parse_trace('.../trace.json.gz')
    prof.top(5), prof.ranges['ParallelTrainer.backward']
"""
import glob
import gzip
import json
import os

__all__ = ['find_traces', 'parse_trace', 'TraceProfile',
           'match_collectives', 'collective_base', 'is_op_event_name',
           'DEVICE_CATEGORIES']

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
_RANGE_CATEGORIES = ('user_annotation', 'gpu_user_annotation')
_HOST_OP_CATEGORY = 'cpu_op'


def collective_base(name):
    """``'nccl'`` for a collective kernel's name, else None."""
    return 'nccl' if name and 'nccl' in name.lower() else None


def is_op_event_name(name):
    """True for a name an op event may carry (not empty, not a
    profiler's own bookkeeping range)."""
    return bool(name) and not name.startswith('ProfilerStep')


def find_traces(logdir):
    """Every Chrome trace under ``logdir`` (``*.json`` and
    ``*.json.gz`` whose name holds ``trace``), oldest first."""
    out = set()
    for pat in ('*trace*.json', '*trace*.json.gz'):
        out.update(glob.glob(os.path.join(logdir, '**', pat),
                             recursive=True))
    return sorted(out, key=lambda f: (os.path.getmtime(f), f))


class TraceProfile:
    """The aggregated view of one trace.

    ``ops`` maps an op's name to ``{name, count, total_us, avg_us}``;
    ``ranges`` the ``record_function`` ranges the same way (host
    ranges, and their device mirrors under ``'gpu:' + name``).
    ``device_total_us`` and ``collective_total_us`` sum the op events
    (``device_total_us`` the outermost ones where the ops are the
    host's: ``total_us``); divide by the window's steps for a per-step
    figure."""

    __slots__ = ('ops', 'ranges', 'n_events', 'device_total_us',
                 'collective_total_us', 'source', 'device_pids')

    def __init__(self, ops, n_events=0, device_pids=0, source=None,
                 ranges=None, total_us=None):
        self.ops = ops
        self.ranges = ranges or {}
        self.n_events = n_events
        self.device_pids = device_pids
        self.source = source
        self.device_total_us = sum(r['total_us'] for r in ops.values()) \
            if total_us is None else round(total_us, 3)
        self.collective_total_us = sum(
            r['total_us'] for r in ops.values()
            if collective_base(r['name']))

    def collectives(self):
        """The collective op rows, keyed by name."""
        return {n: r for n, r in self.ops.items() if collective_base(n)}

    def top(self, k=20):
        return sorted(self.ops.values(), key=lambda r: r['total_us'],
                      reverse=True)[:k]

    def summary(self):
        return {'n_ops': len(self.ops), 'n_events': self.n_events,
                'device_total_us': round(self.device_total_us, 3),
                'collective_total_us': round(
                    self.collective_total_us, 3),
                'source': self.source}


def _load_doc(path_or_doc):
    if isinstance(path_or_doc, (dict, list)):
        return path_or_doc, None
    path = str(path_or_doc)
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as fh:
        return json.load(fh), path


def _add(table, name, dur):
    row = table.setdefault(name, {'name': name, 'count': 0,
                                  'total_us': 0.0})
    row['count'] += 1
    row['total_us'] += dur


def _finish(table):
    for row in table.values():
        row['total_us'] = round(row['total_us'], 3)
        row['avg_us'] = round(row['total_us'] / row['count'], 3)
    return table


def _outermost_us(events):
    """The time of the events no other event of their thread encloses
    (host ops: each nested op's time is already inside its caller's)."""
    total = 0.0
    threads = {}
    for e in events:
        threads.setdefault((e.get('pid'), e.get('tid')), []).append(e)
    for evs in threads.values():
        end = float('-inf')
        for e in sorted(evs, key=lambda e: (float(e.get('ts', 0.0)),
                                            -float(e['dur']))):
            ts = float(e.get('ts', 0.0))
            if ts >= end:
                total += float(e['dur'])
                end = ts + float(e['dur'])
    return total


def parse_trace(path_or_doc):
    """Parse one trace (a path, or the loaded document) into a
    :class:`TraceProfile` (module docstring)."""
    doc, path = _load_doc(path_or_doc)
    events = doc.get('traceEvents', []) if isinstance(doc, dict) else doc
    complete = [e for e in events if e.get('ph') == 'X'
                and e.get('dur') is not None]
    device = [e for e in complete
              if str(e.get('cat', '')).lower() in DEVICE_CATEGORIES]
    chosen = device or [e for e in complete
                        if str(e.get('cat', '')).lower()
                        == _HOST_OP_CATEGORY]
    chosen = [e for e in chosen if is_op_event_name(str(e.get('name', '')))]
    ops, ranges = {}, {}
    for e in chosen:
        _add(ops, str(e['name']), float(e['dur']))
    total = None if device else _outermost_us(chosen)
    for e in complete:
        cat = str(e.get('cat', '')).lower()
        if cat in _RANGE_CATEGORIES:
            name = str(e.get('name', ''))
            _add(ranges, ('gpu:' + name) if cat.startswith('gpu')
                 else name, float(e['dur']))
    return TraceProfile(_finish(ops), n_events=len(chosen),
                        device_pids=len({e.get('pid') for e in device}),
                        source=path, ranges=_finish(ranges),
                        total_us=total)


def match_collectives(profile, instr_index, *, num_partitions=1,
                      name=None):
    """The reference's join of profiled collectives with an HLO census:
    the port has no instruction census to join (module docstring)."""
    raise NotImplementedError(
        'match_collectives joins a trace with a compiled module\'s '
        'collective census; the port has none yet (ROADMAP Queue 1 item '
        '11)')
