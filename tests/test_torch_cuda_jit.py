"""``jit.to_static`` and ``jit.load`` on the card: graphs per signature.

Every test here is marked ``cuda`` and skips where no CUDA device
exists; the file imports neither JAX nor the JAX package.  On the card,
from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_jit.py

- a ``to_static`` layer in train mode: dropout draws fresh bits on every
  replay (the reference's "mask must differ per call"), and BatchNorm's
  running statistics update in place on every replay as eager calls
  update them, bit for bit;
- a signature whose warm-up read a tensor predicate stays eager, one
  with only Python control flow is captured, and both equal eager;
- a ``jit.load``ed BERT captures one graph per input shape and equals
  the eager model bit for bit at B 1, 3 and 3 again (a replay), with
  exact launches a forward.
"""
import pytest
import torch

from paddle_tpu_torch import jit, nn, seed
from paddle_tpu_torch.jit import dy2static
from paddle_tpu_torch.models.bert import bert_tiny
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.static import InputSpec

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()


def test_train_mode_replays_draw_dropout_and_update_batch_norm():
    _cuda()
    seed(7)
    drop = nn.Dropout(0.5)
    drop.train()
    jit.to_static(drop)
    x = torch.ones(1000, device='cuda')
    outs = [drop(x) for _ in range(3)]
    assert list(drop.forward.modes().values()) == ['graph']
    assert not torch.equal(outs[1], outs[2])      # replays, fresh bits
    assert all(0.3 < float((o == 0).float().mean()) < 0.7 for o in outs)

    bn, ref = nn.BatchNorm1D(4, device='cuda'), nn.BatchNorm1D(
        4, device='cuda')
    jit.to_static(bn)
    g = torch.Generator(device='cuda').manual_seed(0)
    for _ in range(3):
        xb = torch.randn(16, 4, device='cuda', generator=g) * 3 + 5
        got = bn(xb)
        with torch.no_grad():
            want = ref(xb)
        assert torch.equal(got, want)
    assert torch.equal(bn._mean, ref._mean)
    assert torch.equal(bn._variance, ref._variance)


def _tensor_if(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = -x
    return y + 1.0


def _python_if(x, flag):
    if flag:
        y = x * 2.0
    else:
        y = x
    return y - 1.0


def test_host_read_signatures_stay_eager_and_others_are_captured():
    _cuda()
    x = torch.tensor([[1.0, -2.0, 0.5]], device='cuda')
    st, sp = jit.to_static(_tensor_if), jit.to_static(_python_if)
    reads = dy2static.host_reads()
    for _ in range(3):
        assert torch.equal(st(x), _tensor_if(x))
        assert torch.equal(st(-x), _tensor_if(-x))
        assert torch.equal(sp(x, True), _python_if(x, True))
    assert dy2static.host_reads() - reads == 6
    assert set(st.modes().values()) == {'eager'}
    assert list(sp.modes().values()) == ['graph']


def test_loaded_bert_is_one_graph_per_shape_equal_to_eager(tmp_path):
    _cuda()
    model = bert_tiny(device='cuda', num_layers=2).eval()
    path = str(tmp_path / 'bert')
    jit.save(model, path, input_spec=[
        InputSpec([None, 32], 'int64', 'input_ids'),
        InputSpec([None, 32], 'int64', 'token_type_ids')])
    loaded = jit.load(path)
    g = torch.Generator(device='cuda').manual_seed(1)
    for b in (1, 3, 3):
        ids = torch.randint(0, 128, (b, 32), device='cuda', generator=g)
        types = torch.zeros_like(ids)
        with torch.no_grad():
            want = model(ids, types)
        _build.reset_launches()
        got = loaded(ids, types)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in _build.KERNELS}
        assert counts['fused_layer_norm'] == 1 + 2 * 2 + 1
        assert counts['flash_attention_fwd'] == 2
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert len(loaded.graphs()) == 2
