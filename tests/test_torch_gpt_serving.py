"""The port's GPT serving path against the JAX package's, on the CPU.

One ``gpt_tiny`` (2 layers, H 128, 4 heads) is built in the JAX
package, its LayerNorm and bias parameters are perturbed with seeded
numpy noise (so the affine parts are exercised), and the same numpy
weights are loaded into both packages (``convert.load_numpy_state``).

Tolerances: logits 1e-5 (f32 through 2 layers, sums in another order);
token streams exactly equal (greedy argmax over logits that agree to
1e-5).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServeConfig as JaxServeConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.serving import (PagedKVCache, Request, ServeConfig,
                                      ServingEngine, blocks_for,
                                      poisson_requests)
from paddle_tpu_torch.serving.kv_cache import TRASH_BLOCK

LOGIT_TOL = 1e-5
MODEL_KW = dict(num_layers=2, hidden_size=128, num_heads=4, max_seq_len=64)
SERVE_KW = dict(block_size=4, max_slots=4, decode_span=2,
                prompt_buckets=(4, 8), batch_buckets=(1, 2, 4),
                prefill_batch=2, max_model_len=32, temperature=0.0)


@pytest.fixture(scope='module')
def models():
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
    pm = gpt_tiny(device='cpu', **MODEL_KW).load_numpy_state(host)
    return jm, pm, host


def _jax_logits(value):
    return np.asarray(value.value if hasattr(value, 'value') else value)


def test_prefill_and_decode_logits_match_jax(models):
    jm, pm, _ = models
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (2, 8)).astype(np.int64)
    params, buffers = jm.functional_state()
    jcaches = jm.init_decode_caches(2, 16)
    jlog, jcaches = jm.prefill(params, buffers, jnp.asarray(ids),
                               jnp.zeros((), jnp.int32), jcaches)
    pcaches = pm.init_decode_caches(2, 16)
    plog, pcaches = pm.prefill(torch.from_numpy(ids), 0, pcaches)
    np.testing.assert_allclose(plog.numpy(), _jax_logits(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    tok = rs.randint(0, 128, (2, 1)).astype(np.int64)
    jlog, _ = jm.decode_step(params, buffers, jnp.asarray(tok),
                             jnp.asarray(8, jnp.int32), jcaches)
    plog, _ = pm.decode_step(torch.from_numpy(tok), 8, pcaches)
    np.testing.assert_allclose(plog.numpy(), _jax_logits(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_generate_greedy_matches_jax(models):
    jm, pm, _ = models
    rs = np.random.RandomState(1)
    for t0 in (3, 8):
        prompt = rs.randint(0, 128, (2, t0)).astype(np.int64)
        want = jm.generate(paddle.to_tensor(prompt), max_new_tokens=10,
                           temperature=0)
        got = pm.generate(prompt, max_new_tokens=10, temperature=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))


def test_engine_streams_match_jax_engine_under_churn(models):
    """Mixed prompt/output lengths through 4 slots (admissions,
    evictions, backfill): every request's greedy stream equals the JAX
    engine's on the same load."""
    jm, pm, _ = models
    rs = np.random.RandomState(0)
    specs = [(int(rs.randint(2, 9)), int(rs.randint(2, 7)))
             for _ in range(10)]
    prompts = [rs.randint(0, 128, (t0,)).astype(np.int64)
               for t0, _ in specs]
    jeng = JaxServingEngine(jm, JaxServeConfig(**SERVE_KW))
    peng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    jreqs = [jeng.submit(p, n) for p, (_, n) in zip(prompts, specs)]
    preqs = [peng.submit(p, n) for p, (_, n) in zip(prompts, specs)]
    jeng.run()
    rep = peng.run()
    assert rep['audit'] == []
    assert peng.cache.free_blocks == peng.cache.num_blocks - 1
    assert rep['decoded_tokens'] == sum(n for _, n in specs)
    for jr, pr in zip(jreqs, preqs):
        assert pr.state == Request.DONE, (pr.rid, pr.reason)
        assert pr.tokens == jr.tokens, pr.rid
    # and each equals the port's own batch-1 generate
    for pr in preqs[:3]:
        ref = pm.generate(pr.prompt[None], pr.max_new_tokens,
                          temperature=0)[0, pr.prompt.size:].tolist()
        assert pr.tokens == ref


def test_sampled_streams_depend_only_on_seed_and_position(models):
    """temperature>0: a request's stream is a pure function of (its
    seed, absolute positions) — equal across batch compositions and
    equal to batch-1 ``generate(seed=request seed)``."""
    _, pm, _ = models
    kw = dict(SERVE_KW, temperature=0.8, top_k=20)
    load = poisson_requests(6, rate_rps=1e6, prompt_lens=(3, 5, 8),
                            new_tokens=(4, 6), vocab_size=128, seed=3)
    first = {}
    eng = ServingEngine(pm, ServeConfig(**kw))
    for r in load:
        eng.submit(Request(r.rid, r.prompt, r.max_new_tokens))
    eng.run()
    for r in eng.scheduler.finished:
        first[r.rid] = (r.seed, r.tokens)
    # alone, one slot at a time, in reverse order
    eng2 = ServingEngine(pm, ServeConfig(**dict(kw, max_slots=1,
                                                batch_buckets=(1,))))
    for r in reversed(load):
        eng2.submit(Request(r.rid, r.prompt, r.max_new_tokens))
    eng2.run()
    assert len(eng2.scheduler.finished) == len(load)
    for r in eng2.scheduler.finished:
        assert r.tokens == first[r.rid][1], r.rid
    for r in load[:2]:
        seed, toks = first[r.rid]
        ref = pm.generate(r.prompt[None], r.max_new_tokens,
                          temperature=0.8, top_k=20, seed=seed)
        assert ref[0, r.prompt.size:].tolist() == toks
    assert any(len(set(t)) > 1 for _, t in first.values())


def test_engine_eos_cancel_and_warmup(models):
    """eos_id truncates exactly where batch-1 ``generate`` first emits
    it; ``cancel`` evicts a queued and a running request and rolls the
    running one's tokens back; ``warmup`` leaves the pool clean."""
    _, pm, _ = models
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 128, (4,)).astype(np.int64) for _ in range(6)]
    refs = [pm.generate(p[None], 8, temperature=0)[0, 4:].tolist()
            for p in prompts]
    flat = [t for r in refs for t in r[:-1]]
    eos = flat[len(flat) // 2]
    eng = ServingEngine(pm, ServeConfig(**dict(
        SERVE_KW, max_slots=2, batch_buckets=(1, 2), eos_id=eos)))
    stats = eng.warmup()
    assert stats['free_blocks'] == eng.cache.num_blocks - 1
    reqs = [eng.submit(p, 8) for p in prompts]
    assert eng.run()['audit'] == []
    truncated = 0
    for req, ref in zip(reqs, refs):
        want = ref[:ref.index(eos) + 1] if eos in ref else ref
        assert req.tokens == want, req.rid
        truncated += req.reason == 'eos'
    assert truncated >= 1

    eng = ServingEngine(pm, ServeConfig(**dict(
        SERVE_KW, max_slots=1, batch_buckets=(1,))))
    running = eng.submit(prompts[0], 8)
    queued = eng.submit(prompts[1], 8)
    eng.step()
    assert running.state == Request.RUNNING and len(running.tokens) > 1
    assert queued.state == Request.QUEUED
    assert eng.cancel(queued.rid) and queued.reason == 'cancelled'
    assert eng.cancel(running.rid) and running.state == Request.EVICTED
    assert not eng.cancel('no-such-request')
    assert eng.decoded_tokens == 0
    assert eng.cache.free_blocks == eng.cache.num_blocks - 1
    assert eng.scheduler.audit() == []


def test_load_numpy_state_rejects_mismatch(models):
    _, _, host = models
    pm = gpt_tiny(device='cpu', **MODEL_KW)
    missing = dict(host)
    missing.pop('gpt.ln_f.bias')
    with pytest.raises(KeyError, match='gpt.ln_f.bias'):
        pm.load_numpy_state(missing)
    with pytest.raises(KeyError, match='extra'):
        pm.load_numpy_state(dict(host, **{'gpt.extra.weight':
                                          np.zeros(3, np.float32)}))
    bad = dict(host)
    bad['gpt.wpe.weight'] = bad['gpt.wpe.weight'][:4]
    with pytest.raises(ValueError, match='shape'):
        pm.load_numpy_state(bad)
    state = convert.state_from_numpy(host, device='cpu')
    assert set(state) == set(pm.state_dict())
    assert state['gpt.blocks.0.attn.qkv.weight'].shape == (128, 384)


def test_uncached_forward_belongs_to_training_slice(models):
    """The training slice's uncached forward (flash attention) gives the
    JAX model's uncached logits, and the cached prefill's."""
    jm, pm, _ = models
    ids = np.random.RandomState(3).randint(0, 128, (2, 8)).astype(np.int64)
    got = pm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, _jax_logits(jm(paddle.to_tensor(ids))),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    plog, _ = pm.prefill(torch.from_numpy(ids), 0,
                         pm.init_decode_caches(2, 8))
    np.testing.assert_allclose(got, plog.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_serve_config_rejects_unported_features():
    # watchdog budgets and the step profiler are ported: accepted and
    # kept out of the module signature, as the reference keeps them
    for kw in ({'watchdog': True}, {'profile': True},
               {'watchdog': {'step_s': 2.0}, 'profile': 'start=3,steps=2'}):
        got, want = ServeConfig(**kw), JaxServeConfig(**kw)
        assert (got.watchdog, got.profile) == (want.watchdog, want.profile)
        assert got.signature() == want.signature()
        assert got.to_dict() == want.to_dict()
    # weight-only PTQ is ported: its modes are validated as the
    # reference validates them
    for mode in ('int8', 'int4', None):
        assert ServeConfig(quantize=mode).quantize == mode
        assert JaxServeConfig(quantize=mode).quantize == mode
    for cls in (ServeConfig, JaxServeConfig):
        with pytest.raises(ValueError, match='int3'):
            cls(quantize='int3')


def test_allocator_churn_never_leaks_never_aliases():
    """300 seeded admit/append/evict ops; every allocator invariant
    holds after every one (the reference's property test)."""
    rs = np.random.RandomState(42)
    c = PagedKVCache(1, 1, 1, block_size=4, num_blocks=17,
                     device_init=False)
    live = {}
    for step in range(300):
        op = rs.randint(3)
        if op == 0:
            sid = f's{step}'
            want = int(rs.randint(1, 20))
            if c.ensure(sid, want):
                live[sid] = want
        elif op == 1 and live:
            sid = list(live)[rs.randint(len(live))]
            grow = live[sid] + int(rs.randint(1, 9))
            if c.ensure(sid, grow):
                live[sid] = grow
        elif op == 2 and live:
            sid = list(live)[rs.randint(len(live))]
            assert c.free_seq(sid) == blocks_for(live.pop(sid), 4)
        assert c.audit() == [], f'step {step}: {c.audit()}'
        used = sum(blocks_for(n, 4) for n in live.values())
        assert c.free_blocks == 16 - used
        fr = c.frag_report()
        assert fr['owned_blocks'] == used
        assert fr['owned_seqs'] == len(live)
        assert 0 <= fr['largest_free_run'] <= fr['free_blocks']
        assert fr['high_water_blocks'] >= used
    for sid in list(live):
        c.free_seq(sid)
    assert c.free_blocks == 16 and c.audit() == []
    row = c.table_row('nobody', 3)
    assert list(row) == [TRASH_BLOCK] * 3


def test_warmup_makes_every_declared_decode_module(models):
    """``warmup`` makes one decode module per (declared batch bucket,
    ``decode_span``), as the reference builds every module (on the card
    each is a captured graph; here the span body itself), and leaves
    the pool clean; traffic adds no module."""
    _, pm, _ = models
    eng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    stats = eng.warmup()
    K = SERVE_KW['decode_span']
    want = {(S, K) for S in SERVE_KW['batch_buckets']}
    assert set(eng._modules.modules) == want
    assert stats['free_blocks'] == eng.cache.num_blocks - 1
    rs = np.random.RandomState(1)
    for _ in range(5):
        eng.submit(rs.randint(0, 128, (5,)).astype(np.int64), 4)
    assert eng.run()['audit'] == []
    assert set(eng._modules.modules) == want


def test_span_modules_give_the_jax_streams_across_bucket_changes(models):
    """Static-buffer spans through their (S, K) modules: the live set
    goes through buckets 1, 4, 2, 4, 2, 1 (a lone request, three more,
    the short ones finish, two more, all drain), and every greedy stream
    equals the JAX engine's on the same load."""
    jm, pm, _ = models
    rs = np.random.RandomState(8)
    jeng = JaxServingEngine(jm, JaxServeConfig(**SERVE_KW))
    peng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    buckets = []
    span = peng._decode_span

    def recording(tables, *args):
        buckets.append(tables.shape[0])
        return span(tables, *args)

    peng._decode_span = recording
    jreqs, preqs = [], []

    def submit(new_tokens):
        for n in new_tokens:
            p = rs.randint(0, 128, (int(rs.randint(2, 9)),)).astype(np.int64)
            jreqs.append(jeng.submit(p, n))
            preqs.append(peng.submit(p, n))

    def step(times=1):
        for _ in range(times):
            jeng.step()
            peng.step()

    submit([20])
    step()
    submit([3, 3, 20])
    step(2)
    submit([3, 9])
    step()
    jeng.run()
    assert peng.run()['audit'] == []
    changes = [b for a, b in zip(buckets, buckets[1:]) if a != b]
    assert buckets[0] == 1 and changes == [4, 2, 4, 2, 1], buckets
    for jr, pr in zip(jreqs, preqs):
        assert pr.state == Request.DONE, (pr.rid, pr.reason)
        assert pr.tokens == jr.tokens, pr.rid


def test_span_body_reads_the_plan_and_writes_only_the_pools(models):
    """The span body is a function of its plan buffer and the pools:
    one inert plan (every lane inactive, every table on the trash
    block) returns invalid lanes and writes nothing but the trash
    block."""
    _, pm, _ = models
    eng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    W = eng.scheduler.table_width
    before = [(k.clone(), v.clone()) for k, v in eng.cache.pools]
    plan = torch.zeros((4, W + 5), dtype=torch.int64)
    out = eng._span_body(plan, 3)
    assert out.shape == (2, 3, 4) and out.dtype == torch.int64
    assert not out[1].any() and not out[0].any()
    for (k0, v0), (k1, v1) in zip(before, eng.cache.pools):
        assert torch.equal(k0[1:], k1[1:]) and torch.equal(v0[1:], v1[1:])
    assert torch.equal(plan, torch.zeros_like(plan))


def test_generate_greedy_matches_jax_at_the_gptgen_shape_cut(models):
    """``bench.py``'s ``gptgen`` (B 8, prompt 128, 128 new tokens) cut
    to this model's 64 positions: B 8, prompt 32, 32 new tokens, greedy,
    every stream equal to the JAX package's ``generate``."""
    jm, pm, _ = models
    prompt = np.random.RandomState(2).randint(0, 128, (8, 32)).astype(
        np.int64)
    want = jm.generate(paddle.to_tensor(prompt), max_new_tokens=32,
                       temperature=0)
    got = pm.generate(prompt, max_new_tokens=32, temperature=0)
    assert got.shape == (8, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))
