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
  0.8, top-k 20: the counter-hash sampler inside the graph).
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
