"""The port's CUDA graphs against its eager path, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device
exists; the file imports neither JAX nor the JAX package, so it runs on
a machine without them.  On the card, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_graphs.py

- ``ParallelTrainer.step_fused`` (one captured forward + backward +
  AdamW step, replayed) equals the same number of eager ``step`` calls
  bit for bit, losses and every parameter, for a small GPT in bf16 O2
  (flash, LayerNorm) and for a small BERT at dropout 0.1 (the softmax
  kernel, dropout drawn from the device's generator registered with the
  graph); two eager trainers are shown equal first, so that equality is
  the claim;
- launch counts stay exact under replay: each kernel's launches are
  its launches per step times the steps;
- under the NaN guard with GPT-3 Small's recipe (AdamW, ``LinearWarmup``
  into ``CosineAnnealingDecay``, global-norm clipping), the guarded graph
  equals eager guarded steps bit for bit through a chunk with a poisoned
  step (its loss NaN, its update dropped, the counter advanced by the
  finite steps) and the chunk after it, with the chunk's one host read
  the only sync (``torch.cuda.set_sync_debug_mode('error')``) and exact
  launches on the skipped step too;
- the serving engine's decode spans, two batch buckets captured in one
  order and replayed out of it, give the same streams as the span body
  run eagerly on the same schedule, greedy and sampled (temperature
  0.8, top-k 20: the counter-hash sampler inside the graph);
- ``generate``'s one graph per signature replays across prompt lengths
  in a bucket and across seeds, equal to its body run eagerly; the
  engine's prefill graphs leave the streams and the KV pools of eager
  prefill (the trash block left out);
- the int8 product on the card equals the CPU's: weights, activation
  quantization and int32 accumulator exactly, the output within 1 f32
  ulp.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models.bert import bert_tiny
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.optimizer import AdamW, lr
from paddle_tpu_torch.parallel import ParallelTrainer
from paddle_tpu_torch.serving import Request, ServeConfig, ServingEngine

pytestmark = pytest.mark.cuda

# head_dim 64 and T 128: flash's tensor-core design under bf16
GPT_KW = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=256,
              max_seq_len=128, dropout=0.0, fused_head=True,
              fused_head_chunks=2)
K = 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()


def _trainer(model, o2=True):
    st = DistributedStrategy()
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    return ParallelTrainer(model, opt, lambda out, y: model.loss(out, y),
                           strategy=st, fused_steps=K)


def _gpt_batches(chunks):
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (K, 2, 128)).astype(np.int64)
            for _ in range(chunks)]


def _eager(trainer, chunks, *labels):
    out = []
    for c, ids in enumerate(chunks):
        lbl = labels[c] if labels else ids
        out += [trainer.step(ids[i], lbl[i]) for i in range(K)]
    return torch.stack(out)


def _params(trainer):
    return {n: p.detach().clone()
            for n, p in trainer.model.named_parameters()}


def _assert_equal(got, want, what):
    for n in want:
        assert torch.equal(got[n], want[n]), f'{what}: {n}'


def test_step_fused_replays_the_eager_gpt_step_bit_for_bit():
    _cuda()
    chunks = _gpt_batches(2)
    a = _trainer(gpt_tiny(device='cuda', seed=0, **GPT_KW))
    b = _trainer(gpt_tiny(device='cuda', seed=0, **GPT_KW))
    want = _eager(a, chunks)
    assert torch.equal(_eager(b, chunks), want), 'eager differs from eager'
    _assert_equal(_params(b), _params(a), 'eager vs eager')
    fused = _trainer(gpt_tiny(device='cuda', seed=0, **GPT_KW))
    got = torch.cat([fused.step_fused(ids, ids) for ids in chunks])
    assert torch.equal(got, want)
    _assert_equal(_params(fused), _params(a), 'graph vs eager')
    assert fused._step_no == fused.optimizer._global_step == 2 * K
    (mod,) = fused._fused_cache.modules.values()
    # the first chunk's first step is the warm-up, every other a replay
    assert mod.replays == 2 * K - 1 and mod.capture_s > 0


def test_launch_counts_stay_exact_under_replay():
    _cuda()
    L = GPT_KW['num_layers']
    fused = _trainer(gpt_tiny(device='cuda', seed=0, **GPT_KW))
    chunks = _gpt_batches(2)
    _build.reset_launches()
    for ids in chunks:
        fused.step_fused(ids, ids)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS}
    steps = 2 * K
    assert counts['fused_layer_norm'] == (2 * L + 1) * steps
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert counts[name] == L * steps, name
        kernel = next(k for k in _build.KERNELS if k.name == name)
        assert kernel.variant_launches == {'mma': L * steps, 'simt': 0}
    (mod,) = fused._fused_cache.modules.values()
    assert mod.launches.counts()['fused_layer_norm'] == 2 * L + 1


def _recipe_trainer(fused_steps=None):
    model = gpt_tiny(device='cuda', seed=0, **GPT_KW)
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs['use_pure_fp16'] = True
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(6e-4, 8, eta_min=6e-5),
                            3, start_lr=0.0, end_lr=6e-4)
    opt = AdamW(learning_rate=sched, beta2=0.95, weight_decay=0.1,
                parameters=model.parameters(),
                apply_decay_param_fun=lambda n: not (
                    n.endswith('bias') or '.ln' in n),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return ParallelTrainer(model, opt,
                           lambda out, y, w: model.loss(out, y) * w,
                           strategy=st, nan_guard=True,
                           fused_steps=fused_steps)


def test_guarded_recipe_graph_equals_eager_through_a_poisoned_step():
    _cuda()
    chunks = _gpt_batches(3)
    weights = [np.ones(K, np.float32) for _ in chunks]
    weights[1][2] = np.nan
    eager = [_recipe_trainer(), _recipe_trainer()]
    want = []
    for tr in eager:
        want.append(torch.stack([tr.step(ids[i], ids[i], w[i])
                                 for ids, w in zip(chunks, weights)
                                 for i in range(K)]))
    assert torch.equal(want[0].nan_to_num(), want[1].nan_to_num())
    _assert_equal(_params(eager[1]), _params(eager[0]), 'eager vs eager')
    fused = _recipe_trainer(fused_steps=K)
    L = GPT_KW['num_layers']
    got = [fused.step_fused(chunks[0], chunks[0], weights[0])]
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for ids, w in zip(chunks[1:], weights[1:]):
            got.append(fused.step_fused(ids, ids, w))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert fused.chunk_syncs == 3
    got = torch.cat(got)
    assert torch.equal(torch.isnan(got), torch.isnan(want[0]))
    assert int(torch.isnan(got).sum()) == 1
    assert torch.equal(got.nan_to_num(), want[0].nan_to_num())
    _assert_equal(_params(fused), _params(eager[0]), 'graph vs eager')
    assert fused._step_no == eager[0]._step_no == 3 * K - 1
    assert fused.sentinel.total_skipped == 1
    counts = {k.name: k.launches for k in _build.KERNELS}
    assert counts['fused_layer_norm'] == (2 * L + 1) * 2 * K
    assert counts['flash_attention_fwd'] == L * 2 * K


def test_step_fused_with_dropout_draws_as_the_eager_steps():
    _cuda()
    assert hasattr(torch.cuda.CUDAGraph, 'register_generator_state')
    rs = np.random.RandomState(1)
    chunks = [rs.randint(0, 256, (K, 4, 64)).astype(np.int64)
              for _ in range(2)]
    labels = [np.where(rs.rand(*c.shape) < 0.15, c, -100).astype(np.int64)
              for c in chunks]

    def trainer():
        return _trainer(bert_tiny(device='cuda', seed=0, vocab_size=256,
                                  hidden_size=128, num_layers=2,
                                  num_heads=2, dropout=0.1,
                                  max_seq_len=64, fused_head=True,
                                  fused_head_chunks=2))

    paddle_tpu_torch.seed(3)
    a = trainer()
    want = _eager(a, chunks, *labels)
    paddle_tpu_torch.seed(3)
    b = trainer()
    assert torch.equal(_eager(b, chunks, *labels), want)
    paddle_tpu_torch.seed(3)
    fused = trainer()
    _build.reset_launches()
    got = torch.cat([fused.step_fused(c, l) for c, l in zip(chunks, labels)])
    assert torch.equal(got, want)
    _assert_equal(_params(fused), _params(a), 'graph vs eager')
    softmax = next(k for k in _build.KERNELS if k.name == 'fused_softmax')
    assert softmax.launches == 2 * 2 * K


def _serve(model, eager, sampling):
    """Two engines' schedule: buckets 2 and 4 captured in that order by
    ``warmup``, then traffic that takes 4, then 2, then 4 again."""
    eng = ServingEngine(model, ServeConfig(
        block_size=16, max_slots=4, decode_span=3, prompt_buckets=(16,),
        batch_buckets=(2, 4), max_model_len=64, **sampling))
    if eager:
        eng._decode_module = lambda S, span: (
            lambda plan: eng._span_body(plan.to(eng.device), span))
    eng.warmup()
    rs = np.random.RandomState(4)
    reqs = []

    def submit(new_tokens):
        for n in new_tokens:
            reqs.append(eng.submit(
                rs.randint(0, 256, (int(rs.randint(3, 16)),)), n))

    submit([24, 4, 4])
    eng.step()
    eng.step()
    eng.step()
    submit([20, 6])
    eng.run()
    return eng, reqs


@pytest.mark.parametrize('sampling', [
    dict(temperature=0.0), dict(temperature=0.8, top_k=20)],
    ids=['greedy', 'sampled'])
def test_decode_graphs_replayed_out_of_capture_order_keep_the_streams(
        sampling):
    _cuda()
    model = gpt_tiny(device='cuda', seed=0, vocab_size=256, hidden_size=128,
                     num_layers=2, num_heads=2, max_seq_len=64)
    graphs, got = _serve(model, eager=False, sampling=sampling)
    _, want = _serve(model, eager=True, sampling=sampling)
    assert [m.replays > 0 for m in graphs._modules.modules.values()] \
        == [True, True]
    assert list(graphs._modules.modules) == [(2, 3), (4, 3)]
    for g, w in zip(got, want):
        assert g.state == w.state == Request.DONE
        assert g.tokens == w.tokens, g.rid


def _tiny_gpt():
    return gpt_tiny(device='cuda', seed=0, vocab_size=256, hidden_size=128,
                    num_layers=2, num_heads=2, max_seq_len=64)


@pytest.mark.parametrize('sampling', [
    dict(temperature=0.0), dict(temperature=0.8, top_k=20)],
    ids=['greedy', 'sampled'])
def test_generate_graph_replays_the_eager_body_across_lengths_and_seeds(
        sampling):
    """One graph per signature: prompt lengths 5 and 7 (bucket 8) and two
    seeds replay the first capture, each call equal to the eager body
    bit for bit; LayerNorm's launches are the capture's per replay."""
    _cuda()
    model = _tiny_gpt()
    rs = np.random.RandomState(6)
    calls = [(5, 1), (7, 1), (7, 2), (5, 3)]
    for i, (t0, seed) in enumerate(calls):
        prompt = rs.randint(0, 256, (2, t0))
        got = model.generate(prompt, 9, seed=seed, **sampling)
        ids_p = torch.zeros((2, 8), dtype=torch.int64, device='cuda')
        ids_p[:, :t0] = torch.from_numpy(prompt)
        with torch.no_grad():
            want = model._generate_body(
                ids_p, torch.tensor(t0, device='cuda'),
                torch.tensor(seed, device='cuda'), max_new_tokens=9,
                top_k=sampling.get('top_k'),
                temperature=sampling['temperature'])
        assert torch.equal(got[:, t0:], want), (t0, seed)
        mod, = model._gen_cache.modules.values()
        if i == 0:
            graph = mod.graph
            _build.reset_launches()
    assert mod.graph is graph and mod.replays == len(calls) - 1
    per_replay = mod.launches.counts()['fused_layer_norm']
    assert per_replay == 9 * (2 * 2 + 1)
    # the eager bodies launched as many as the replays recorded
    norm, = [k for k in _build.KERNELS if k.name == 'fused_layer_norm']
    assert norm.launches == 2 * (len(calls) - 1) * per_replay


def test_prefill_graphs_write_the_pools_as_the_eager_body():
    """Every prefill of a run is a replay of a graph warmup captured;
    two engines, graphed and eager prefill, end with the same streams
    and the same KV pools outside the trash block."""
    _cuda()
    model = _tiny_gpt()
    cfg = dict(block_size=16, max_slots=4, decode_span=3,
               prompt_buckets=(16, 32), batch_buckets=(4,),
               prefill_batch=2, max_model_len=64)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 256, (int(rs.randint(3, 30)),))
               for _ in range(7)]
    runs = []
    for eager in (False, True):
        eng = ServingEngine(model, ServeConfig(**cfg))
        if eager:
            eng._prefill_module = lambda P, B: (
                lambda plan: eng._prefill_body(plan.to(eng.device), P))
        eng.warmup()
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        runs.append((eng, reqs))
    (geng, greqs), (eeng, ereqs) = runs
    mods = geng._prefill_modules.modules
    assert set(mods) == {(P, B) for P in (16, 32) for B in (1, 2)}
    assert sum(m.replays for m in mods.values()) \
        == geng.prefill_dispatches > 0
    for g, e in zip(greqs, ereqs):
        assert g.state == e.state == Request.DONE
        assert g.tokens == e.tokens, g.rid
    for (gk, gv), (ek, ev) in zip(geng.cache.pools, eeng.cache.pools):
        assert torch.equal(gk[1:], ek[1:]) and torch.equal(gv[1:], ev[1:])


def test_int8_product_on_the_card_equals_the_cpu():
    """At 8 rows (padded for ``_int_mm``) and 64: the weights, the
    activation's quantization and the int32 accumulator exactly the
    CPU's, the output within 1 f32 ulp."""
    _cuda()
    from paddle_tpu_torch.ops import int8_matmul as q8
    g = torch.Generator().manual_seed(0)
    for m, k, n in ((8, 768, 2304), (64, 3072, 768)):
        x = torch.randn(m, k, generator=g)
        w = torch.randn(k, n, generator=g) / k ** 0.5
        b = torch.randn(n, generator=g)
        wq, ws = q8.quantize_weight_int8(w)
        cwq, cws = q8.quantize_weight_int8(w.cuda())
        assert torch.equal(cwq.cpu(), wq) and torch.equal(cws.cpu(), ws)
        xq, xs = q8.quantize_activation(x)
        cxq, cxs = q8.quantize_activation(x.cuda())
        assert torch.equal(cxq.cpu(), xq) and torch.equal(cxs.cpu(), xs)
        assert torch.equal(q8.int_dot(cxq, cwq).cpu(), q8.int_dot(xq, wq))
        want = q8.dynamic_int8_matmul(x, wq, ws, b, out_dtype=torch.float32)
        got = q8.dynamic_int8_matmul(x.cuda(), cwq, cws, b.cuda(),
                                     out_dtype=torch.float32).cpu()
        ulp = torch.nextafter(want.abs(), torch.tensor(float('inf'))) \
            - want.abs()
        assert bool(((got - want).abs() <= ulp).all())
