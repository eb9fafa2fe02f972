"""The port's compiled serving surface against the JAX package's, on the CPU.

- the dense cache at a device position (a 0-d tensor ``pos``) gives the
  int path's logits and caches bit for bit, and ``sample_rows`` draws
  the same tokens from a tensor seed and position as from ints;
- ``generate`` keeps one module per signature, keyed as the JAX
  package keys its compiled modules, ``(B, P, max_new_tokens, greedy,
  temperature, top_k)``, and reuses it across prompt lengths in a
  bucket and across seeds (on the card each module is one CUDA graph of
  the call; here it is the same body, run eagerly), with the JAX
  package's greedy streams;
- the engine's prefill module body, on one static plan, gives the JAX
  engine's prefill module's first tokens and KV blocks (the trash
  block, which padding rows all write, left out), and ``warmup()``
  makes every declared prefill and decode module;
- ``ServeConfig.signature``/``to_dict``/``from_json`` and
  ``ServingEngine.bucket_set`` equal the reference's, and
  ``precompile`` returns ``(entries, errors)`` in its shape.

Tolerances: logits, caches and pools of the port's two paths bit for
bit; port against JAX, logits and KV values within 1e-5 (f32 through 2
layers, sums in another order) and token streams exactly equal.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServeConfig as JaxServeConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.sampling import sample_rows
from paddle_tpu_torch.serving import (Request, ServeConfig, ServingEngine,
                                      TRASH_BLOCK)

TOL = 1e-5
MODEL_KW = dict(num_layers=2, hidden_size=128, num_heads=4, max_seq_len=64)
# one prompt bucket, chunks 1-2: a small JAX module set
SERVE_KW = dict(block_size=4, max_slots=2, decode_span=2,
                prompt_buckets=(8,), batch_buckets=(1, 2),
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
    return jm, pm


def test_dense_cache_at_a_tensor_position_is_the_int_path(models):
    _, pm = models
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 128, (2, 5)).astype(np.int64))
    tok = torch.from_numpy(rs.randint(0, 128, (2, 1)).astype(np.int64))
    runs = []
    for pos in (3, torch.tensor(3)):
        caches = pm.init_decode_caches(2, 16)
        lp, caches = pm.prefill(ids, pos, caches)
        step = 8 if isinstance(pos, int) else torch.tensor(8)
        ld, caches = pm.decode_step(tok, step, caches)
        runs.append((lp, ld, caches))
    (lp0, ld0, c0), (lp1, ld1, c1) = runs
    assert torch.equal(lp0, lp1) and torch.equal(ld0, ld1)
    for (k0, v0), (k1, v1) in zip(c0, c1):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)
    # the slots written: 3..7 by the prefill, 8 by the step, none else
    assert not c1[0][0][:, :, :3].any() and not c1[0][0][:, :, 9:].any()
    assert c1[0][0][:, :, 3:9].abs().sum(-1).all()


@pytest.mark.parametrize('temperature,top_k', [(0, None), (0.8, None),
                                               (0.7, 5)])
def test_sample_rows_draws_the_same_from_tensor_seed_and_position(
        temperature, top_k):
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(3, 50).astype(np.float32))
    want = sample_rows(logits, 1234, 17, temperature, top_k)
    got = sample_rows(logits, torch.tensor(1234), torch.tensor(17),
                      temperature, top_k)
    assert torch.equal(got, want)
    if temperature:
        other = sample_rows(logits, torch.tensor(1235), torch.tensor(17),
                            temperature, top_k)
        assert not torch.equal(other, want)


def test_generate_keys_its_modules_as_the_reference(models):
    """Prompt lengths 5 and 7 share bucket 8, 9 takes 16; two seeds of a
    sampled call share one module: the port's keys equal the JAX
    package's, each module is made once, and greedy streams equal the
    JAX package's."""
    jm, pm = models
    pm._gen_cache.clear()
    rs = np.random.RandomState(2)
    calls = [(t0, dict(temperature=0)) for t0 in (5, 7, 9)]
    calls += [(6, dict(temperature=0.7, top_k=5, seed=s)) for s in (1, 2)]
    made, outs = {}, []
    for t0, kw in calls:
        prompt = rs.randint(0, 128, (2, t0)).astype(np.int64)
        out = pm.generate(prompt, 6, **kw)
        outs.append(out)
        for sig, mod in pm._gen_cache.modules.items():
            assert made.setdefault(sig, mod) is mod
        if not kw['temperature']:
            want = jm.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                               **kw)
            np.testing.assert_array_equal(out.numpy(),
                                          np.asarray(want.value))
    want_keys = {(2, 8, 6, True, 0.0, None), (2, 16, 6, True, 0.0, None),
                 (2, 8, 6, False, 0.7, 5)}
    assert set(pm._gen_cache.modules) == want_keys
    assert set(jm._gen_cache) == {(2, 8, 6, True, 0.0, None),
                                  (2, 16, 6, True, 0.0, None)}
    # the sampled calls: seeds part the streams, a seed repeats its own
    assert not torch.equal(outs[3][:, 6:], outs[4][:, 6:])
    prompt = outs[4][:, :6].numpy()
    assert torch.equal(pm.generate(prompt, 6, temperature=0.7, top_k=5,
                                   seed=2), outs[4])
    assert len(pm._gen_cache.modules) == 3


def test_generate_body_reads_only_its_inputs(models):
    """The module body takes the padded ids, T0 and the seed as tensors
    and gives ``generate``'s new tokens; padding ids past T0 change
    nothing (the decode steps overwrite their slots first)."""
    _, pm = models
    prompt = np.random.RandomState(3).randint(0, 128, (2, 5)).astype(
        np.int64)
    want = pm.generate(prompt, 4, temperature=0.8, seed=9)[:, 5:]
    for pad in (0, 77):
        ids_p = torch.full((2, 8), pad, dtype=torch.int64)
        ids_p[:, :5] = torch.from_numpy(prompt)
        got = pm._generate_body(ids_p, torch.tensor(5), torch.tensor(9),
                                max_new_tokens=4, temperature=0.8,
                                top_k=None)
        assert torch.equal(got, want)


def test_quantizing_drops_the_generate_modules(models):
    from paddle_tpu_torch.quantization import quantize_for_serving
    pm = gpt_tiny(device='cpu', **MODEL_KW)
    pm.generate(np.zeros((1, 3), np.int64), 2, temperature=0)
    assert len(pm._gen_cache.modules) == 1
    quantize_for_serving(pm, 'int8')
    assert pm._gen_cache.modules == {}


def _jax_prefill(jeng, P, B, ids, t0s, blocks, seeds):
    ks, vs = (tuple(x) for x in zip(*jeng.cache.pools))
    tok, ks, vs = jeng._prefill_module(P, B)(
        jeng._params, jeng._buffers, jnp.asarray(ids), jnp.asarray(t0s),
        ks, vs, jnp.asarray(blocks), jnp.asarray(seeds))
    return np.asarray(tok), [np.asarray(k) for k in ks], \
        [np.asarray(v) for v in vs]


def test_prefill_module_body_matches_the_jax_prefill_module(models):
    """One (P 8, B 2) plan: a prompt of 5 in blocks 3 and 1, a padding
    row on the trash block (t0 1, as the dispatch pads)."""
    jm, pm = models
    jeng = JaxServingEngine(jm, JaxServeConfig(**SERVE_KW))
    peng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    ids = np.zeros((2, 8), np.int64)
    ids[0, :5] = np.random.RandomState(4).randint(0, 128, 5)
    t0s = np.array([5, 1], np.int32)
    blocks = np.array([[3, 1], [TRASH_BLOCK, TRASH_BLOCK]], np.int32)
    seeds = np.array([123, 0], np.int64)
    jtok, jks, jvs = _jax_prefill(jeng, 8, 2, ids, t0s, blocks, seeds)
    plan = peng._prefill_plan(ids, t0s, blocks, seeds)
    assert plan.shape == (2, 8 + 2 + 2) and plan.dtype == torch.int64
    tok = peng._prefill_body(plan, 8)
    assert int(tok[0]) == int(jtok[0])
    for (kp, vp), jk, jv in zip(peng.cache.pools, jks, jvs):
        for got, want in ((kp, jk), (vp, jv)):
            np.testing.assert_allclose(got[1:].numpy(), want[1:],
                                       rtol=TOL, atol=TOL)
            assert got[[1, 3]].abs().sum() > 0
    # the dispatch goes through the (P, B) module and counts itself
    peng._prefill_modules.clear()
    before = [(k.clone(), v.clone()) for k, v in peng.cache.pools]
    tok2 = peng._prefill(ids, t0s, blocks, seeds)
    assert set(peng._prefill_modules.modules) == {(8, 2)}
    assert peng.prefill_dispatches == 1 and torch.equal(tok2, tok)
    for (k0, v0), (k1, v1) in zip(before, peng.cache.pools):
        assert torch.equal(k0[1:], k1[1:]) and torch.equal(v0[1:], v1[1:])


def test_warmup_makes_every_declared_module_and_traffic_adds_none(models):
    _, pm = models
    eng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    stats = eng.warmup()
    prefill = {(8, 1), (8, 2)}
    decode = {(1, 2), (2, 2)}
    assert set(eng._prefill_modules.modules) == prefill
    assert set(eng._modules.modules) == decode
    assert eng.prefill_dispatches == 0
    assert stats['free_blocks'] == eng.cache.num_blocks - 1
    rs = np.random.RandomState(5)
    reqs = [eng.submit(rs.randint(0, 128, (int(t0),)).astype(np.int64), 3)
            for t0 in (2, 8, 5)]
    assert eng.run()['audit'] == []
    assert all(r.state == Request.DONE for r in reqs)
    assert set(eng._prefill_modules.modules) == prefill
    assert set(eng._modules.modules) == decode
    eng.close()
    eng.close()
    req = eng.submit(rs.randint(0, 128, (4,)).astype(np.int64), 2)
    eng.run()
    assert req.state == Request.DONE


def test_config_and_bucket_set_equal_the_reference(models, tmp_path):
    jm, pm = models
    kw = dict(SERVE_KW, quantize='int8', seed=5, request_deadline_s=2.0)
    pc = ServeConfig(**kw).resolved(pm.config)
    jc = JaxServeConfig(**kw).resolved(jm.config)
    assert pc.signature() == jc.signature()
    assert pc.to_dict() == jc.to_dict()
    assert ServeConfig(**SERVE_KW).signature() != \
        ServeConfig(**dict(SERVE_KW, quantize='int4')).signature()
    doc = dict(pc.to_dict(), model='gpt_tiny', model_kwargs={'x': 1})
    path = tmp_path / 'serve.json'
    path.write_text(json.dumps(doc))
    for src in (doc, str(path)):
        got = ServeConfig.from_json(src).resolved(pm.config)
        want = JaxServeConfig.from_json(src).resolved(jm.config)
        assert got.signature() == want.signature() == pc.signature()
    jeng = JaxServingEngine(jm, JaxServeConfig(**SERVE_KW))
    peng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    assert peng.bucket_set() == jeng.bucket_set()
    assert peng.bucket_set()['prefill_chunks'] == [1, 2]


def test_precompile_returns_entries_and_errors_in_the_reference_shape(
        models, monkeypatch):
    _, pm = models
    eng = ServingEngine(pm, ServeConfig(**SERVE_KW))
    entries, errors = eng.precompile()
    descs = ['serve-prefill bucket 8 chunk 1', 'serve-prefill bucket 8 '
             'chunk 2', 'serve-decode batch 1 span 2',
             'serve-decode batch 2 span 2']
    assert errors == {}
    assert [e['description'] for e in entries] == descs
    for e in entries:
        assert {'tier', 'fingerprint', 'description'} <= set(e)
        assert e['tier'] == 'eager' and e['kernels'] == []
    assert len({e['fingerprint'] for e in entries}) == len(descs)
    # the same declaration fingerprints the same; a quantized one not
    again, _ = ServingEngine(pm, ServeConfig(**SERVE_KW)).precompile()
    assert [e['fingerprint'] for e in again] == \
        [e['fingerprint'] for e in entries]
    quantized, _ = ServingEngine(
        gpt_tiny(device='cpu', **MODEL_KW),
        ServeConfig(**dict(SERVE_KW, quantize='int8'))).precompile()
    assert not {e['fingerprint'] for e in quantized} & \
        {e['fingerprint'] for e in entries}
    # on the card a failed nvcc build is reported for every module
    def broken(names=None):
        raise RuntimeError('nvcc failed on fused_norm.cu')

    monkeypatch.setattr(_build, 'build', broken)
    eng.device = torch.device('cuda')
    entries, errors = eng.precompile()
    assert entries == [] and sorted(errors) == sorted(descs)
    assert all('nvcc failed' in v for v in errors.values())
