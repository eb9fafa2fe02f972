"""The port's ``nn/layer/transformer.py`` against the JAX package's, on
the CPU.

Each JAX layer is built from a seed and its weights carried into the
port's through numpy; the same seeded inputs go through both, and the
output, every parameter's gradient and every float input's gradient of
``sum(output * cot)`` are compared (``torch_seq_oracle``).  An
attention key's bias has a true gradient of 0 (softmax does not see a
shift shared by every key), so each side's is round-off: it is held to
be tiny on both sides instead.  Tolerances, relative to the largest
magnitude of the JAX result: f32 outputs 2e-5 (1e-4 through a whole
Transformer) and gradients 1e-4.

The training cases run the smoke's Transformer (``chip_smoke.
transformer_model``, one code for both packages) at 2 + 2 layers, d
32, 4 heads, FFN 64, vocabulary 64, dropout 0, three steps of each
package's ``ParallelTrainer`` with Adam under ``NoamDecay(32, 4,
0.05)`` (rates near 1e-3) and
the label-smoothed loss: f32 losses within 1e-5 and parameters within
1e-4 (the key biases within ``2 * lr * steps``: Adam scales round-off
to steps of up to ``lr``).  Under bf16 O2 the JAX trainer's compiled
step keeps some bf16 intermediates in f32 (XLA's excess precision: the
label-smoothed targets, 0.9 and 0.1 / 64, are not rounded to bf16
there), so its first loss already stands 1.5e-3 from the JAX package's
own eager O2 forward; the port's first O2 loss is held to that eager
forward within 1e-3, and the three trainer losses to the JAX trainer's
within bf16's epsilon, 2^-8, relative.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.parallel import ParallelTrainer
from torch_seq_oracle import close, compare_vjp, jt, load_from_jax, np32

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the smoke's models, one code for both)

TOL, GRAD_TOL, MODEL_TOL = 2e-5, 1e-4, 1e-4
O2_LOSS_RTOL, O2_EAGER_RTOL = 2.0 ** -8, 1e-3
NOAM_LR = 0.05      # Noam's rate times 0.05: ~1e-3 over the 3 steps
D, HEADS, FF, B, S, T = 16, 4, 24, 2, 5, 4
KEY_BIAS = ('k_proj.bias',)
SMALL = dict(vocab_size=64, d_model=32, nhead=4, num_layers=2,
             dim_feedforward=64, dropout=0.0, max_len=32)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(cls, *args, **kw):
    jpaddle.seed(0)
    jm = getattr(jpaddle.nn, cls)(*args, **kw)
    pm = getattr(nn, cls)(*args, **kw)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jm.state_dict().items()}
    return jm, load_from_jax(pm, jm)


def _bool_mask():
    m = np.ones((B, 1, 1, S), bool)
    m[0, ..., 3:] = False
    return m


def _float_mask(n, m):
    return np.triu(np.full((n, m), -1e9, np.float32), 1)


@pytest.mark.parametrize('mask', ['none', 'bool', 'float'])
@pytest.mark.parametrize('need_weights', [False, True])
def test_multihead_attention_matches_jax(mask, need_weights):
    jm, pm = _pair('MultiHeadAttention', D, HEADS, need_weights=need_weights)
    q, kv = _x(B, T, D), _x(B, S, D, seed=1)
    m = {'none': None, 'bool': _bool_mask(),
         'float': _float_mask(T, S)}[mask]
    inputs = [q, kv] + ([] if m is None else [m])

    def fn(layer, a, b, *mm):
        return layer(a, b, b, mm[0] if mm else None)

    compare_vjp(jm, pm, fn, inputs, TOL, GRAD_TOL, skip=KEY_BIAS)
    if need_weights:
        jw = jm(*[jt(a) for a in (q, kv, kv)],
                None if m is None else jt(m))[1]
        pw = pm(*[torch.from_numpy(a) for a in (q, kv, kv)],
                None if m is None else torch.from_numpy(m))[1]
        assert tuple(pw.shape) == (B, HEADS, T, S)
        close(np32(pw), np32(jw), TOL, 'weights')
        if mask == 'bool':
            assert float(pw[0, ..., 3:].detach().abs().max()) == 0.0


def test_attention_kdim_vdim_and_no_bias_match_jax():
    jm, pm = _pair('MultiHeadAttention', D, HEADS, kdim=6, vdim=7,
                   bias_attr=False)
    assert not any(k.endswith('bias') for k in pm.state_dict())
    compare_vjp(jm, pm, lambda m, a, k, v: m(a, k, v),
                [_x(B, T, D), _x(B, S, 6, seed=1), _x(B, S, 7, seed=2)],
                TOL, GRAD_TOL)


def test_cached_attention_equals_uncached_in_both_packages():
    """A ``Cache`` grown one step at a time and a ``StaticCache`` over
    the memory give what the uncached attention gives over the whole
    prefix, in each package, and the packages agree."""
    jm, pm = _pair('MultiHeadAttention', D, HEADS)
    pm.eval()
    jm.eval()
    x, mem = _x(B, T, D), _x(B, S, D, seed=1)
    mask = _float_mask(T, T)
    for m, wrap in ((pm, torch.from_numpy), (jm, jt)):
        full = np32(m(wrap(x), attn_mask=wrap(mask)))
        cache = m.gen_cache(wrap(x))
        static = m.gen_cache(wrap(mem), wrap(mem), type=m.StaticCache)
        cross = np32(m(wrap(x), wrap(mem), wrap(mem)))
        for t in range(T):
            out, cache = m(wrap(x[:, t:t + 1]), cache=cache)
            close(np32(out)[:, 0], full[:, t], TOL, f'self step {t}')
            out, static2 = m(wrap(x[:, t:t + 1]), cache=static)
            close(np32(out)[:, 0], cross[:, t], TOL, f'cross step {t}')
        assert tuple(cache.k.shape) == (B, HEADS, T, D // HEADS)
        assert static2 is static
    seeded = pm.gen_cache(torch.zeros(B, HEADS, 2, 4),
                          torch.ones(B, HEADS, 2, 4))
    assert isinstance(seeded, pm.Cache) and float(seeded.v.sum()) == 64.0


LAYER_CASES = [(nb, act) for nb in (False, True) for act in ('relu', 'gelu')]


@pytest.mark.parametrize('normalize_before,activation', LAYER_CASES)
def test_encoder_layer_matches_jax(normalize_before, activation):
    jm, pm = _pair('TransformerEncoderLayer', D, HEADS, FF, 0.0, activation,
                   normalize_before=normalize_before)
    compare_vjp(jm, pm, lambda m, a, mm: m(a, mm),
                [_x(B, S, D), _bool_mask()], TOL, GRAD_TOL, skip=KEY_BIAS)


@pytest.mark.parametrize('normalize_before,activation', LAYER_CASES)
def test_decoder_layer_matches_jax(normalize_before, activation):
    jm, pm = _pair('TransformerDecoderLayer', D, HEADS, FF, 0.0, activation,
                   normalize_before=normalize_before)
    compare_vjp(jm, pm, lambda m, a, mem, tm, mm: m(a, mem, tm, mm),
                [_x(B, T, D), _x(B, S, D, seed=1), _float_mask(T, T),
                 _bool_mask()], TOL, GRAD_TOL, skip=KEY_BIAS)


@pytest.mark.parametrize('normalize_before', [False, True])
def test_transformer_matches_jax(normalize_before):
    """2 + 2 layers, with a final LayerNorm on each stack only under
    ``normalize_before``; dropout 1e-9 (every element kept at scale 1)
    in training mode, so the dropout branch runs."""
    jm, pm = _pair('Transformer', D, HEADS, 2, 2, FF, 1e-9,
                   normalize_before=normalize_before)
    assert ('encoder.norm.weight' in pm.state_dict()) == normalize_before
    mask = jpaddle.nn.Transformer.generate_square_subsequent_mask(T)
    pmask = nn.Transformer.generate_square_subsequent_mask(T)
    assert np.array_equal(np32(mask), np32(pmask))
    assert float(pmask[0, 1]) == -1e9 and float(pmask[1, 0]) == 0.0
    compare_vjp(jm, pm, lambda m, a, b, tm, mm: m(a, b, mm, tm, mm),
                [_x(B, S, D), _x(B, T, D, seed=1), np32(mask),
                 _bool_mask()], MODEL_TOL, GRAD_TOL, skip=KEY_BIAS)


def test_decoder_caches_equal_the_uncached_decoder():
    """``TransformerDecoder.gen_cache`` (a ``Cache`` and a
    ``StaticCache`` a layer), stepped one position at a time, gives the
    uncached decoder's outputs under the causal mask; ``do_zip``
    transposes the pairs; the encoder's incremental caches too."""
    jm, pm = _pair('Transformer', D, HEADS, 2, 2, FF, 0.0)
    pm.eval()
    x, mem = _x(B, T, D), _x(B, S, D, seed=1)
    mask = torch.from_numpy(_float_mask(T, T))
    full = pm.decoder(torch.from_numpy(x), torch.from_numpy(mem), mask)
    cache = pm.decoder.gen_cache(torch.from_numpy(mem))
    assert [type(c).__name__ for c in cache[0]] == ['Cache', 'StaticCache']
    for t in range(T):
        out, cache = pm.decoder(torch.from_numpy(x[:, t:t + 1]), None, None,
                                None, cache)
        close(np32(out)[:, 0], np32(full)[:, t], TOL, f'step {t}')
    zipped = pm.decoder.gen_cache(torch.from_numpy(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    enc_full = pm.encoder(torch.from_numpy(x), mask)
    enc_cache = pm.encoder.gen_cache(torch.from_numpy(x))
    for t in range(T):
        out, enc_cache = pm.encoder(torch.from_numpy(x[:, t:t + 1]), None,
                                    enc_cache)
        close(np32(out)[:, 0], np32(enc_full)[:, t], TOL, f'enc step {t}')
    jfull = jm.decoder(jt(x), jt(mem), jt(_float_mask(T, T)))
    close(np32(full), np32(jfull), TOL, 'decoder vs JAX')


def _trainers(o2):
    jpaddle.seed(0)
    jm = chip_smoke.transformer_model(jpaddle, **SMALL)
    pm = chip_smoke.transformer_model(paddle, **SMALL)
    load_from_jax(pm, jm)
    out = []
    for pkg, model, cls, strat in ((jpaddle, jm, JaxTrainer, JaxStrategy),
                                   (paddle, pm, ParallelTrainer,
                                    DistributedStrategy)):
        st = strat()
        if o2:
            st.amp = True
            st.amp_configs['use_pure_fp16'] = True
        opt = pkg.optimizer.Adam(pkg.optimizer.lr.NoamDecay(32, 4, NOAM_LR),
                                 parameters=model.parameters(),
                                 **chip_smoke.TRANSFORMER_ADAM)
        out.append(cls(model, opt, chip_smoke.transformer_loss(pkg),
                       strategy=st, n_inputs=2))
    return out


@pytest.mark.parametrize('o2', [False, True], ids=['f32', 'bf16_o2'])
def test_transformer_trains_as_the_jax_trainer(o2):
    jtr, ptr = _trainers(o2)
    batch = chip_smoke.transformer_batch(3, 10, 8, SMALL['vocab_size'],
                                         min_src=5)
    if o2:
        with jpaddle.amp.auto_cast(level='O2'):
            eager = float(chip_smoke.transformer_loss(jpaddle)(
                jtr.model(*map(jpaddle.to_tensor, batch[:2])),
                jpaddle.to_tensor(batch[2])).value)
    for step in range(3):
        want = jtr.loss_float(jtr.step(*batch))
        got = ptr.loss_float(ptr.step(*batch))
        if o2 and step == 0:
            np.testing.assert_allclose(got, eager, rtol=O2_EAGER_RTOL)
        if o2:
            np.testing.assert_allclose(got, want, rtol=O2_LOSS_RTOL)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)
    if o2:
        assert all(p.dtype == torch.float32 for p in ptr.model.parameters())
        return
    bound = 2 * float(paddle.optimizer.lr.NoamDecay(
        32, 4, NOAM_LR).value_at(3)) * 3
    for name, p in ptr.model.named_parameters():
        want = np.asarray(jtr.params[name])
        if name.endswith(KEY_BIAS):
            assert float(np.abs(np32(p) - want).max()) <= bound, name
            continue
        close(np32(p), want, MODEL_TOL, name)


def test_every_reference_name_exists_in_the_port():
    import paddle_tpu.nn.layer.transformer as ref
    from paddle_tpu_torch.nn.layer import transformer
    assert [n for n in ref.__all__ if not hasattr(transformer, n)] == []
