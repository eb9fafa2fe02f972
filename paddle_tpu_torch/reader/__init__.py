"""paddle.reader — generator-composition decorators of the fluid era
(counterpart of ``paddle_tpu/reader``, ported as it is: host-side
Python with no device work).

Paddle's reader/decorator.py: cache, map_readers, shuffle, chain,
compose, buffered, firstn, xmap_readers and multiprocess_reader.  A
"reader" is a zero-arg callable returning an iterable of samples.
These combinators compose readers and feed ``paddle.batch``, then the
trainer (``io.DataLoader`` stages batches on the card).  xmap_readers
and buffered use daemon threads and bounded queues, as the reference
does; multiprocess_reader is thread-backed there too (the samples land
in host RAM either way).  ``shuffle`` draws from Python's ``random``,
which ``paddle_tpu_torch.seed`` seeds, as the reference's does.
"""
import itertools
import queue as _queue
import random as _random
import threading

__all__ = ['cache', 'map_readers', 'buffered', 'compose', 'chain',
           'shuffle', 'firstn', 'xmap_readers', 'multiprocess_reader']


class ComposeNotAligned(ValueError):
    pass


def _put_or_stop(q, item, stop, poll_s=0.1):
    """put() that gives up when `stop` is set — worker threads must not
    park forever on a bounded queue after the consumer abandons the
    generator.  Returns False when stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except _queue.Full:
            continue
    return False


def cache(reader):
    """Materialize `reader`'s samples in memory on first COMPLETE
    iteration; later passes replay the cached list (reference
    decorator.py:51).  The cache is built in a local list and only
    published once the pass finishes, so an abandoned partial pass
    (firstn, zip with a shorter reader) cannot corrupt it."""
    state = {'data': None}

    def cached_reader():
        if state['data'] is not None:
            yield from state['data']
            return
        fresh = []
        for item in reader():
            fresh.append(item)
            yield item
        state['data'] = fresh

    return cached_reader


def map_readers(func, *readers):
    """Zip N readers and map `func` over the per-reader samples
    (reference decorator.py:91)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle: fill a buf_size window, shuffle, drain
    (reference decorator.py:133)."""

    def shuffled_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled_reader


def chain(*readers):
    """Concatenate readers back to back (reference decorator.py:182)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into combined samples: sample tuples are flattened
    into one tuple per step (reference decorator.py:247).  With
    check_alignment=True (default) raises ComposeNotAligned when the
    readers end at different lengths."""
    check_alignment = kwargs.pop('check_alignment', True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        'outputs of readers are not aligned')
                yield sum(map(make_tuple, outputs), ())

    return reader


def buffered(reader, size):
    """Producer thread fills a bounded queue of `size` samples; the
    consumer overlaps with production (reference decorator.py:307)."""

    class _End:
        pass

    def buffered_reader():
        q = _queue.Queue(maxsize=size)
        stop = threading.Event()

        def produce():
            try:
                for item in reader():
                    if not _put_or_stop(q, item, stop):
                        return
                _put_or_stop(q, _End, stop)
            except BaseException as e:
                # surface producer failures in the consumer — a
                # swallowed error would look like a short epoch
                _put_or_stop(q, e, stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            import time as _time
            from ..telemetry import active as _tel_active
            gauge = _tel_active()
            while True:
                if gauge:
                    # host-wait gauge: time blocked on the producer
                    # (same counter family as io.DataLoader's — the
                    # run report's host-wait split reads both)
                    _t0 = _time.perf_counter()
                    item = q.get()
                    from .. import telemetry
                    telemetry.add('io.reader.wait_s',
                                  _time.perf_counter() - _t0)
                else:
                    item = q.get()
                if item is _End:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # consumer abandoned early (firstn/zip/early-stop): release
            # the producer instead of leaving it parked on a full queue
            stop.set()
            # bounded join — the producer's put-poll re-checks `stop`
            # every 0.1s; the timeout only guards a source reader
            # wedged mid-next()
            t.join(timeout=2.0)

    return buffered_reader


def firstn(reader, n):
    """Limit to the first n samples (reference decorator.py:366)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map `mapper` over samples with `process_num` worker threads and a
    bounded queue (reference decorator.py:411 — processes there, threads
    here; see module docstring).  order=True preserves input order."""

    end_token = object()

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)
        stop = threading.Event()

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not _put_or_stop(in_q, (i, sample), stop):
                        return
            except BaseException as e:
                _put_or_stop(out_q, e, stop)
            finally:
                # workers must always see their end tokens or they (and
                # then the consumer) would block forever
                for _ in range(process_num):
                    if not _put_or_stop(in_q, end_token, stop):
                        return

        def work():
            while not stop.is_set():
                try:
                    item = in_q.get(timeout=0.1)
                except _queue.Empty:
                    continue
                if item is end_token:
                    _put_or_stop(out_q, end_token, stop)
                    return
                i, sample = item
                try:
                    _put_or_stop(out_q, (i, mapper(sample)), stop)
                except BaseException as e:
                    _put_or_stop(out_q, e, stop)
                    _put_or_stop(out_q, end_token, stop)
                    return

        threads = [threading.Thread(target=feed, daemon=True)]
        threads.extend(threading.Thread(target=work, daemon=True)
                       for _ in range(process_num))
        for t in threads:
            t.start()

        finished = 0
        try:
            if not order:
                while finished < process_num:
                    item = out_q.get()
                    if item is end_token:
                        finished += 1
                    elif isinstance(item, BaseException):
                        raise item
                    else:
                        yield item[1]
            else:
                pending, next_i = {}, 0
                while finished < process_num or pending:
                    if next_i in pending:
                        yield pending.pop(next_i)
                        next_i += 1
                        continue
                    if finished == process_num:
                        # all workers done; next index never arrived
                        break
                    item = out_q.get()
                    if item is end_token:
                        finished += 1
                    elif isinstance(item, BaseException):
                        raise item
                    else:
                        pending[item[0]] = item[1]
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
        finally:
            stop.set()
            # feeder and workers all poll `stop` on their queue ops, so
            # they exit within one 0.1s tick — bounded join, no leak
            for t in threads:
                t.join(timeout=2.0)

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave N readers concurrently (reference decorator.py:504).
    Thread-backed: each reader drains into a shared queue from its own
    thread; samples arrive in completion order."""
    if len(readers) < 1:
        raise ValueError('multiprocess_reader needs at least one reader')

    end_token = object()

    def mp_reader():
        q = _queue.Queue(queue_size)
        stop = threading.Event()

        def drain(r):
            try:
                for sample in r():
                    if not _put_or_stop(q, (None, sample), stop):
                        return
            except BaseException as e:
                _put_or_stop(q, (e, None), stop)
            finally:
                _put_or_stop(q, end_token, stop)

        threads = [threading.Thread(target=drain, args=(r,), daemon=True)
                   for r in readers]
        for t in threads:
            t.start()
        finished = 0
        try:
            while finished < len(readers):
                item = q.get()
                if item is end_token:
                    finished += 1
                elif item[0] is not None:
                    raise item[0]
                else:
                    yield item[1]
        finally:
            stop.set()
            # drainers poll `stop` on put, so this completes within one
            # 0.1s tick per thread — bounded join, no orphan threads
            for t in threads:
                t.join(timeout=2.0)

    return mp_reader
