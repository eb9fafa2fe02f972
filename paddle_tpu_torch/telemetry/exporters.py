"""Telemetry exporters: JSONL stream, TensorBoard event files, and the
TensorBoard-style scalar sink (the port's copy of
``paddle_tpu/telemetry/exporters.py``, host code only: the files it
writes are the reference's, record for record).

JsonlWriter is the durable export — one append-only file per host,
rank-tagged records, flushed per line so a preempted worker's stream
is complete up to its last event.  ``tools/run_report.py`` merges
these files across hosts into one run report.

TensorBoardWriter emits NATIVE TensorBoard scalar event files
(``events.out.tfevents.*``) from the same stream — hand-encoded Event
protos in masked-CRC TFRecord framing, pure stdlib (no tensorflow /
tensorboard import).  It consumes only the ``steps`` flushes (the
StepAccumulator's buffered device scalars, already materialized at
the flush boundary) and ``scalar`` records, so selecting it adds
zero per-step host syncs.  Enable with
``telemetry.enable(log_dir, tensorboard=True)`` (TeeWriter fans the
stream to JSONL + TB) then ``tensorboard --logdir <log_dir>``.

ScalarAdapter is the TensorBoard-scalar-shaped sink the hapi VisualDL
callback rewires onto: ``add_scalar(tag, value, step)`` keeps the
legacy ``events.jsonl`` format the old callback wrote (same keys, same
file), and additionally forwards each record to the telemetry recorder
as a ``scalar`` event so the run's scalars live in the same merged
stream as its spans and resilience timeline.
"""
import json
import os
import struct
import threading
import time

from .recorder import get_recorder, _jsonable, _rank

__all__ = ['JsonlWriter', 'ScalarAdapter', 'TensorBoardWriter',
           'TeeWriter']


class JsonlWriter:
    """Append-only JSONL event stream, one file per host process.

    The filename carries the rank (``telemetry-r<rank>.jsonl``) so a
    shared checkpoint/log directory collects every host's stream
    without collisions; each record is additionally rank-tagged for
    merged readers."""

    def __init__(self, directory, rank=None, filename=None):
        self.directory = os.path.abspath(directory)
        self.rank = _rank() if rank is None else rank
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory, filename or f'telemetry-r{self.rank}.jsonl')
        self._lock = threading.Lock()
        self._fh = open(self.path, 'a')

    def write(self, rec):
        if self._fh is None:
            return
        line = json.dumps(dict(rec, rank=self.rank),
                          default=_jsonable)
        with self._lock:
            if self._fh is None:    # closed while we serialized
                return
            self._fh.write(line + '\n')
            # flush per record: events are boundary-rate, and a
            # preempted worker's stream must be complete on disk
            self._fh.flush()

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None


# -- TensorBoard event files (stdlib-only) ------------------------------------
#
# TB's on-disk format is TFRecord-framed Event protos.  Both layers are
# simple enough to encode by hand — the alternative is a tensorflow /
# tensorboard dependency this image does not ship:
#   TFRecord: u64le(len) · masked_crc32c(len) · data · masked_crc32c(data)
#   Event:    1=wall_time(double) 2=step(int64) 3=file_version(str)
#             5=summary{ 1=value{ 1=tag(str) 2=simple_value(float) } }

_CRC_TABLE = None


def _crc32c(data):
    """CRC-32C (Castagnoli), the TFRecord checksum."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _tfrecord(data):
    header = struct.pack('<Q', len(data))
    return (header + struct.pack('<I', _masked_crc(header))
            + data + struct.pack('<I', _masked_crc(data)))


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_str(field, s):
    data = s.encode('utf-8')
    return bytes([(field << 3) | 2]) + _varint(len(data)) + data


def _pb_msg(field, body):
    return bytes([(field << 3) | 2]) + _varint(len(body)) + body


def _event_proto(wall_time, step=None, tag=None, value=None,
                 file_version=None):
    body = struct.pack('<Bd', 0x09, wall_time)      # 1: wall_time
    if step is not None:
        body += b'\x10' + _varint(max(0, int(step)))  # 2: step
    if file_version is not None:
        body += _pb_str(3, file_version)
    if tag is not None:
        val = _pb_str(1, tag) + struct.pack('<Bf', 0x15, float(value))
        body += _pb_msg(5, _pb_msg(1, val))         # 5: summary.value
    return body


class TensorBoardWriter:
    """Native TensorBoard scalar export over the telemetry stream.

    Attachable wherever JsonlWriter is (``recorder.attach_writer`` /
    ``TeeWriter``): ``write(rec)`` ignores everything except ``steps``
    flushes — each buffered per-step column becomes scalar points
    tagged ``<loop>/<column>`` at the flushed step ids — and
    ``scalar`` records (one point under the record's own tag).  All
    values reaching here were materialized by the flush that produced
    the record, so TB export costs no extra device readback."""

    def __init__(self, directory, rank=None, filename=None):
        self.directory = os.path.abspath(directory)
        self.rank = _rank() if rank is None else rank
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory, filename
            or f'events.out.tfevents.{int(time.time())}.r{self.rank}')
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False

    def _file(self):
        if self._fh is None:
            self._fh = open(self.path, 'ab')
            if self._fh.tell() == 0:
                self._fh.write(_tfrecord(_event_proto(
                    time.time(), file_version='brain.Event:2')))
        return self._fh

    def _emit(self, points):
        """Write a batch of (tag, value, step, wall_time) points under
        ONE lock/flush — a 32-step flush with several columns is one
        syscall burst, not one per point (JsonlWriter's per-record
        durability contract, at the same boundary)."""
        blobs = []
        for tag, value, step, wall_time in points:
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            blobs.append(_tfrecord(_event_proto(
                wall_time or time.time(), step=step, tag=tag,
                value=v)))
        if not blobs:
            return
        with self._lock:
            if self._closed:
                return
            fh = self._file()
            fh.write(b''.join(blobs))
            fh.flush()

    def add_scalar(self, tag, value, step, wall_time=None):
        self._emit([(tag, value, step, wall_time)])

    def write(self, rec):
        kind = rec.get('kind')
        if kind == 'scalar':
            tag = rec.get('tag', 'scalar')
            self._emit([
                (tag if k == 'value' else f'{tag}/{k}', v,
                 rec.get('step') or 0, rec.get('ts'))
                for k, v in rec.items()
                if k not in ('kind', 'ts', 't', 'rank', 'tag', 'step')
                and isinstance(v, (int, float))])
            return
        if kind != 'steps':
            return
        loop = rec.get('tag', 'train')
        steps = rec.get('step') or []
        ts = rec.get('ts')
        points = []
        for col, vals in rec.items():
            if col in ('kind', 'ts', 't', 'rank', 'tag', 'n', 'step',
                       'step_lo', 'step_hi'):
                continue
            if not isinstance(vals, list):
                continue
            points += [(f'{loop}/{col}', v, steps[i], ts)
                       for i, v in enumerate(vals)
                       if v is not None and i < len(steps)]
        self._emit(points)

    def close(self):
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None


class TeeWriter:
    """Fan one telemetry stream out to several writers (JSONL + TB);
    a failing branch never blocks the others."""

    def __init__(self, *writers):
        self.writers = writers

    def write(self, rec):
        for w in self.writers:
            try:
                w.write(rec)
            except Exception:
                pass

    def close(self):
        for w in self.writers:
            try:
                w.close()
            except Exception:
                pass


class ScalarAdapter:
    """TensorBoard-scalar-shaped writer over the telemetry stream.

    Keeps the legacy VisualDL ``events.jsonl`` on disk (same format:
    one JSON object per line with ``tag``/``step``/``ts`` plus metric
    keys) AND emits each record as a telemetry ``scalar`` event, so
    scalars logged through the callback are queryable by
    ``run_report`` next to spans and resilience events."""

    def __init__(self, log_dir, recorder=None):
        self.log_dir = log_dir
        self.rec = recorder or get_recorder()
        self._fh = None
        self._lock = threading.Lock()

    def _file(self):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(
                os.path.join(self.log_dir, 'events.jsonl'), 'a')
        return self._fh

    def write_record(self, tag, step, values):
        """Write one already-materialized record: `values` is a dict
        of plain numbers / lists (the CALLER pays any device sync, at
        its own log boundary)."""
        rec = {'tag': tag, 'step': step, 'ts': time.time()}
        rec.update(values)
        with self._lock:
            fh = self._file()
            fh.write(json.dumps(rec, default=_jsonable) + '\n')
            fh.flush()
        self.rec.event('scalar', tag=tag, step=step, **values)
        return rec

    def add_scalar(self, tag, value, step):
        return self.write_record(tag, step, {'value': value})

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None
