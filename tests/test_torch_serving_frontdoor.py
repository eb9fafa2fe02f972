"""The port's serving front door against the JAX package's, on the CPU.

One JAX ``ServingFrontend`` over the JAX engine (``gpt_tiny``) and one
port ``ServingFrontend`` over the port's engine, with the JAX model's
weights carried into the port by ``load_numpy_state`` (biases and
LayerNorm parameters nudged off their initial values so every term is
exercised); each door is built and warmed up once for the module.

- the same greedy requests over HTTP give identical token streams, the
  same SSE framing (event keys, offsets, terminal record, headers) and
  the same non-streamed JSON keys, timing values aside;
- ``413`` (a prompt beyond the pool), ``429`` (a full admission queue)
  and ``503`` (draining) come back with the same status, error type
  and a ``Retry-After`` header from both;
- one request emits the same ``serve_step``/``serve_request``/
  ``serve_trace`` kinds in the same order, with the same fields, equal
  but for the timings and the counts of the door's history
  (intervention number, fragmentation of the pool);
- a client that disconnects mid-stream, and ``POST /v1/cancel/<rid>``,
  evict the request, roll its tokens back and return every block;
  ``close()`` is idempotent and tears the live plane down;
- ``tools/run_report.py --json`` renders both packages' telemetry
  directories with the same serving-section keys and reject taxonomy;
- ``ServeConfig(watchdog=, profile=)`` gives the reference's deadlines,
  and a starved request under a tight budget is evicted with a
  ``timeout`` event in both.

Tolerances: token streams, statuses, keys and counts exactly equal
(the logits agree within 1e-5, as ``test_torch_serving_compiled.py``
holds them).
"""
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest

import paddle_tpu as paddle
from paddle_tpu import telemetry as ref_tel
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServeConfig as JaxServeConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving.frontend import ServingFrontend as JaxFrontend
from paddle_tpu_torch import telemetry as tel
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.serving import (RejectReason, Request, ServeConfig,
                                      ServingEngine)
from paddle_tpu_torch.serving.frontend import ServingFrontend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(num_layers=2, hidden_size=32, num_heads=2, max_seq_len=64)
# one prompt bucket and chunks 1-2: a small JAX module set
SERVE_KW = dict(block_size=4, max_slots=4, decode_span=2,
                prompt_buckets=(8,), batch_buckets=(1, 2, 4),
                prefill_batch=2, max_model_len=32, num_blocks=24,
                temperature=0.0)
TIMING = ('ts', 't', 'dur_s', 'ttft_s', 'tpot_s', 'age_s')
# serve_step fields that count the engine's whole history (the doors
# serve every test of the module, at their own pace)
HISTORY = ('intervention', 'kv_frag_frac', 'kv_largest_free_run',
           'kv_high_water')


def _host_weights():
    paddle.seed(7)
    jm = jax_gpt_tiny(**MODEL_KW)
    jm.eval()
    params, _ = jm.functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name:
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
    return jm, host


@pytest.fixture(scope='module')
def doors():
    """(port door, JAX door), each over a warmed-up engine."""
    jm, host = _host_weights()
    jeng = JaxServingEngine(jm, JaxServeConfig(**SERVE_KW))
    jeng.warmup()
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    peng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    peng.warmup()
    port_door = ServingFrontend(peng, port=0).start()
    jax_door = JaxFrontend(jeng, port=0).start()
    yield port_door, jax_door
    port_door.stop()
    jax_door.stop()


def _post(port, path, doc=None, timeout=60):
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    c.request('POST', path,
              body=json.dumps(doc) if doc is not None else '',
              headers={'Content-Type': 'application/json'})
    r = c.getresponse()
    body = json.loads(r.read().decode())
    c.close()
    return r.status, dict(r.getheaders()), body


def _stream(port, doc, timeout=60):
    """(status, headers, token events, terminal event) of one SSE
    request."""
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    c.request('POST', '/v1/generate', body=json.dumps(doc),
              headers={'Content-Type': 'application/json'})
    r = c.getresponse()
    events, done = [], None
    while True:
        line = r.readline()
        if not line:
            break
        line = line.strip()
        if line.startswith(b'data: '):
            ev = json.loads(line[len(b'data: '):])
            if ev.get('done'):
                done = ev
                break
            events.append(ev)
    c.close()
    return r.status, dict(r.getheaders()), events, done


def _specs(n, seed):
    rs = np.random.RandomState(seed)
    return [([int(t) for t in rs.randint(0, 128, int(rs.randint(3, 9)))],
             int(rs.randint(3, 8))) for _ in range(n)]


def _both(fn):
    """``fn(0)`` (the port's door) then ``fn(1)`` (the JAX door)."""
    return fn(0), fn(1)


def test_streams_and_framing_equal_the_reference(doors):
    specs = _specs(6, seed=3)
    results = [{}, {}]

    def run(which):
        threads = []
        for i, (prompt, n) in enumerate(specs):
            def one(i=i, prompt=prompt, n=n):
                results[which][i] = _stream(doors[which].port, {
                    'prompt': prompt, 'max_new_tokens': n,
                    'rid': f'st-{i}'})
            t = threading.Thread(target=one, daemon=True)
            t.start()
            threads.append(t)
            time.sleep(0.01)
        for t in threads:
            t.join(120)

    _both(run)
    for i, (prompt, n) in enumerate(specs):
        (ps, ph, pev, pdone), (js, jh, jev, jdone) = \
            results[0][i], results[1][i]
        assert ps == js == 200
        for key in ('Content-Type', 'Cache-Control', 'Transfer-Encoding',
                    'X-Request-Id'):
            assert ph[key] == jh[key], key
        assert [e['i'] for e in pev] == list(range(n))
        assert pev == jev, f'st-{i}: streams differ'
        assert pdone == jdone
        assert [sorted(e) for e in pev] == [['i', 'token']] * n
        assert sorted(pdone) == ['done', 'n', 'reason', 'rid', 'state']
    # non-streamed: the same document
    doc = {'prompt': [3, 1, 4, 1, 5], 'max_new_tokens': 5,
           'rid': 'nd-0', 'stream': False}
    (ps, _ph, pbody), (js, _jh, jbody) = _both(
        lambda w: _post(doors[w].port, '/v1/generate', doc))
    assert ps == js == 200 and pbody == jbody
    assert pbody['state'] == 'done' and len(pbody['tokens']) == 5
    # status documents: the same keys
    (p, j) = _both(lambda w: json.loads(urllib.request.urlopen(
        doors[w].url + '/status.json', timeout=10).read()))
    assert sorted(p) == sorted(j)
    assert p['shed_counts'] == j['shed_counts']


def test_typed_sheds_equal_the_reference(doors):
    # 413: the prompt and its tokens can never fit the pool
    big = {'prompt': list(range(8)), 'max_new_tokens': 120,
           'rid': 'big-0'}
    (ps, ph, pb), (js, jh, jb) = _both(
        lambda w: _post(doors[w].port, '/v1/generate', big))
    assert ps == js == 413
    assert pb['error'] == jb['error'] == RejectReason.EXCEEDS_POOL
    assert float(ph['Retry-After']) > 0 and float(jh['Retry-After']) > 0
    assert sorted(pb) == sorted(jb)
    small = {'prompt': [1, 2, 3], 'max_new_tokens': 2, 'rid': 'sh-0'}
    for attr, value, status, reason in (
            ('max_queue', 0, 429, RejectReason.QUEUE_FULL),
            ('draining', True, 503, RejectReason.DRAINING)):
        saved = [getattr(d, attr) for d in doors]
        try:
            for d in doors:
                setattr(d, attr, value)
            (ps, ph, pb), (js, jh, jb) = _both(
                lambda w: _post(doors[w].port, '/v1/generate', small))
        finally:
            for d, v in zip(doors, saved):
                setattr(d, attr, v)
        assert ps == js == status
        assert pb['error'] == jb['error'] == reason
        assert 'Retry-After' in ph and 'Retry-After' in jh
    assert doors[0].shed_counts == doors[1].shed_counts


def test_one_request_emits_the_reference_events(doors):
    for t in (tel, ref_tel):
        t.reset()
    doc = {'prompt': [7, 7, 2, 9], 'max_new_tokens': 6, 'rid': 'ev-0',
           'stream': False}
    _both(lambda w: _post(doors[w].port, '/v1/generate', doc))

    def serving(t):
        return [e for e in t.events()
                if e['kind'] in ('serve_step', 'serve_request',
                                 'serve_trace', 'timeout')]

    got, want = serving(tel), serving(ref_tel)
    assert [e['kind'] for e in got] == [e['kind'] for e in want]
    assert [e['kind'] for e in got].count('serve_request') == 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), g['kind']
        if g['kind'] == 'serve_trace':
            assert [r['stage'] for r in g['trace']] == \
                [r['stage'] for r in w['trace']]
            continue
        skip = TIMING + HISTORY
        assert {k: v for k, v in g.items() if k not in skip} == \
            {k: v for k, v in w.items() if k not in skip}, g['kind']
    assert sum(e['decoded'] + e['prefilled'] for e in got
               if e['kind'] == 'serve_step') == 6


def _long_door():
    """A port door whose engine can decode one request for long."""
    model = gpt_tiny(device='cpu', num_layers=2, hidden_size=32,
                     num_heads=2, max_seq_len=512)
    cfg = ServeConfig(block_size=4, max_slots=2, decode_span=2,
                      prompt_buckets=(4,), batch_buckets=(1, 2),
                      max_model_len=320, num_blocks=96)
    return ServingFrontend(ServingEngine(model, cfg), port=0).start()


def test_disconnect_and_cancel_roll_the_blocks_back():
    fe = _long_door()
    eng = fe.engine
    try:
        # a client that reads two tokens and goes away
        c = http.client.HTTPConnection('127.0.0.1', fe.port, timeout=30)
        c.request('POST', '/v1/generate', body=json.dumps(
            {'prompt': [4, 4, 4, 4], 'max_new_tokens': 300,
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
            time.sleep(0.02)
        assert req.state == Request.EVICTED
        assert req.reason == 'client_disconnect'
        assert len(req.tokens) < 300
        # cancel through the door: a stream in flight on another client
        got = {}
        t = threading.Thread(target=lambda: got.update(out=_stream(
            fe.port, {'prompt': [1, 2, 3, 4], 'max_new_tokens': 300,
                      'rid': 'cx-0'})), daemon=True)
        t.start()
        while fe.get_request('cx-0') is None or \
                len(fe.get_request('cx-0').tokens) < 2:
            time.sleep(0.01)
        st, _h, body = _post(fe.port, '/v1/cancel/cx-0')
        assert st == 200 and body['cancelled']
        t.join(60)
        _s, _h, _ev, done = got['out']
        assert done['state'] == Request.EVICTED
        assert done['reason'] == 'cancelled'
        st, _h, _b = _post(fe.port, '/v1/cancel/no-such-rid')
        assert st == 404
        deadline = time.monotonic() + 30
        while eng.scheduler.running and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.cache.free_blocks == eng.cache.num_blocks - 1
        assert eng.scheduler.audit() == []
        # every delivered token was rolled back: nothing of the two
        # evicted streams counts as decoded
        assert eng.decoded_tokens == 0
    finally:
        fe.stop()
        fe.stop()


def test_close_is_idempotent_and_tears_the_plane_down():
    model = gpt_tiny(device='cpu', **MODEL_KW)
    eng = ServingEngine(model, ServeConfig(**SERVE_KW),
                        serve_metrics_port=0)
    url = f'http://127.0.0.1:{eng.metrics_server.port}'
    assert json.loads(urllib.request.urlopen(url + '/healthz',
                                             timeout=10).read())['ok']
    rec = tel.get_recorder()
    assert eng.live.write in rec._subscribers
    eng.close()
    eng.close()
    assert eng.metrics_server is None
    assert eng.live.write not in rec._subscribers
    with pytest.raises(OSError):
        urllib.request.urlopen(url + '/healthz', timeout=2)
    # the engine itself stays usable
    req = eng.submit(np.arange(4, dtype=np.int64), 3)
    eng.run()
    assert req.state == Request.DONE


def _run_report(path):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'tools', 'run_report.py'),
         str(path), '--json'], capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_run_report_reads_both_packages_alike(doors, tmp_path):
    specs = _specs(3, seed=9)
    dirs = (tmp_path / 'port', tmp_path / 'jax')
    for which, (t, d) in enumerate(zip((tel, ref_tel), dirs)):
        t.enable(str(d))
        try:
            for i, (prompt, n) in enumerate(specs):
                _post(doors[which].port, '/v1/generate', {
                    'prompt': prompt, 'max_new_tokens': n,
                    'rid': f'rr-{i}', 'stream': False})
            _post(doors[which].port, '/v1/generate', {
                'prompt': list(range(8)), 'max_new_tokens': 120,
                'rid': 'rr-big'})
        finally:
            t.disable()
    got, want = (_run_report(d)['serving'] for d in dirs)
    assert sorted(got) == sorted(want)
    assert got['requests'] == want['requests'] == 3
    assert got['shed_by_reason'] == want['shed_by_reason'] == \
        {RejectReason.EXCEEDS_POOL: 1}
    assert got['by_cause'] == want['by_cause']
    assert got['decoded_tokens'] == want['decoded_tokens']


def test_watchdog_and_profile_give_the_reference_deadlines(tmp_path):
    jm, host = _host_weights()
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    watchdog = {'step_s': 0.5, 'first_step_s': 2.0}
    prof = f'start=2,steps=2,limit=1,dir={tmp_path}'
    kw = dict(SERVE_KW, watchdog=watchdog, profile=prof)
    peng = ServingEngine(pm, ServeConfig(**kw))
    jeng = JaxServingEngine(jm, JaxServeConfig(**kw))
    assert vars(peng.budget) == vars(jeng.budget)
    for n in (1, 2, 7, 30):
        assert peng.request_deadline_s(n) == jeng.request_deadline_s(n)
    p = peng.submit(np.arange(5, dtype=np.int64), 9, rid='dl-0')
    j = jeng.submit(np.arange(5, dtype=np.int64), 9, rid='dl-0')
    assert p.deadline_s == j.deadline_s == 2.0 + 4 * 0.5
    # an explicit request_deadline_s wins over the budget, as there
    kw['request_deadline_s'] = 3.25
    assert ServingEngine(pm, ServeConfig(**kw)).request_deadline_s(9) \
        == JaxServingEngine(jm, JaxServeConfig(**kw)) \
        .request_deadline_s(9) == 3.25
    assert ServeConfig(**kw).signature() == \
        JaxServeConfig(**kw).signature()
    assert ServeConfig(**kw).to_dict() == JaxServeConfig(**kw).to_dict()
    # the port's profile window opens on the reference's step ids
    peng.run()
    assert [(w['step_lo'], w['step_hi']) for w in peng._prof.windows] \
        == [(2, 3)]
    assert os.path.exists(peng._prof.windows[0]['trace'])


def test_starved_request_times_out_with_an_event():
    """A request whose budget is spent before it is admitted: evicted
    with reason 'deadline' and one ``timeout`` event, as in the
    reference."""
    for t in (tel, ref_tel):
        t.reset()
    jm, host = _host_weights()
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    outs = []
    for eng in (ServingEngine(pm, ServeConfig(**SERVE_KW),
                              now_fn=lambda: 0.0),
                JaxServingEngine(jm, JaxServeConfig(**SERVE_KW),
                                 now_fn=lambda: 0.0)):
        req = eng.submit(np.arange(5, dtype=np.int64), 4, rid='to-0',
                         deadline_s=1.0)
        eng.step(now=5.0)
        outs.append(req)
    for req in outs:
        assert req.state == Request.EVICTED and req.reason == 'deadline'
    p, j = tel.events('timeout'), ref_tel.events('timeout')
    assert len(p) == len(j) == 1
    assert {k: v for k, v in p[0].items() if k not in ('ts', 't')} == \
        {k: v for k, v in j[0].items() if k not in ('ts', 't')}
