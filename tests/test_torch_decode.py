"""The port's ``nn/decode.py`` (``BeamSearchDecoder``,
``dynamic_decode``) and ``F.gather_tree`` against the JAX package's, on
the CPU, and the port's run of the reference's seq2seq end-to-end test
(``tests/test_models.py`` ``TestSeq2SeqEndToEnd``).

The beam searches run the smoke's Transformer (``chip_smoke.
transformer_model`` and ``beam_decode``, one code for both packages) at
2 + 2 layers, d 32, vocabulary 64, with the JAX model's weights in the
port's: every step's ids and parents, and the traced-back ids, must be
the JAX package's, with the decoder's caches and without; a search that
ends early gives the JAX package's final scores within 1e-5 (f32 sums
in another order) and its lengths.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from torch_seq_oracle import jt, load_from_jax, np32

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the smoke's models, one code for both)

SMALL = dict(vocab_size=64, d_model=32, nhead=4, num_layers=2,
             dim_feedforward=64, dropout=0.0, max_len=32)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


@pytest.fixture(scope='module')
def models():
    paddle.set_device('cpu')
    jpaddle.seed(0)
    jm = chip_smoke.transformer_model(jpaddle, **SMALL)
    pm = load_from_jax(chip_smoke.transformer_model(paddle, **SMALL), jm)
    jm.eval()
    pm.eval()
    src = chip_smoke.transformer_batch(2, 12, 1, SMALL['vocab_size'],
                                       min_src=6)[0]
    paddle.set_device(None)
    return jm, pm, src


def test_gather_tree_matches_jax():
    rs = np.random.RandomState(0)
    T, B, K = 6, 3, 4
    ids = rs.randint(0, 50, (T, B, K)).astype(np.int64)
    parents = rs.randint(0, K, (T, B, K)).astype(np.int64)
    want = np.asarray(jpaddle.nn.functional.gather_tree(
        jt(ids), jt(parents)).value)
    got = F.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    assert np.array_equal(got.numpy(), want)
    # the last step is kept as it is; each earlier one re-selected
    assert np.array_equal(got[-1].numpy(), ids[-1])


@pytest.mark.parametrize('cached,max_step', [(True, 5), (False, 3)])
def test_beam_search_matches_jax(models, cached, max_step):
    jm, pm, src = models
    jrec, prec = [], []
    with torch.no_grad():
        got = chip_smoke.beam_decode(paddle, pm, torch.from_numpy(src),
                                     max_step, cached=cached, record=prec)
    want = chip_smoke.beam_decode(jpaddle, jm, jt(src), max_step,
                                  cached=cached, record=jrec)
    # max_step_num + 1 steps, as the reference runs them
    assert len(prec) == len(jrec) == max_step + 1
    for (pi, pp), (ji, jp) in zip(prec, jrec):
        assert np.array_equal(pi.numpy(), np32(ji).astype(np.int64))
        assert np.array_equal(pp.numpy(), np32(jp).astype(np.int64))
    assert tuple(got.shape) == (2, max_step + 1, chip_smoke.BEAM_SIZE)
    assert np.array_equal(got.numpy(), np32(want).astype(np.int64))


def test_cached_beam_search_equals_the_decoder_without_caches(models):
    _, pm, src = models
    a, b = [], []
    with torch.no_grad():
        chip_smoke.beam_decode(paddle, pm, torch.from_numpy(src), 5,
                               record=a)
        chip_smoke.beam_decode(paddle, pm, torch.from_numpy(src), 5,
                               cached=False, record=b)
    for (ai, ap), (bi, bp) in zip(a, b):
        assert torch.equal(ai, bi) and torch.equal(ap, bp)


def _eos_cell(pkg, V, eos, wrap):
    """A cell whose logits are a row of a fixed table: EOS wins from
    every token by 20, so every beam ends within two steps."""
    table = np.random.RandomState(1).randn(V, V).astype(np.float32)
    table[:, eos] += 20.0
    emb = pkg.nn.Embedding(V, V)
    if pkg is paddle:
        emb.set_state_dict({'weight': table})
    else:
        emb.set_state_dict({'weight': jt(table)})

    def cell(ids, states):
        return emb(ids), states
    return cell, wrap(np.zeros((2, 3), np.float32))


@pytest.mark.parametrize('time_major', [False, True])
def test_dynamic_decode_stops_when_every_beam_ends(time_major):
    """``all(finished)`` read back every step ends the loop before
    ``max_step_num``; the outputs' layout, the scores and the lengths
    are the JAX package's."""
    V, EOS, K = 12, 2, 3
    out = {}
    for pkg, wrap in ((paddle, torch.from_numpy), (jpaddle, jt)):
        cell, init = _eos_cell(pkg, V, EOS, wrap)
        dec = pkg.nn.BeamSearchDecoder(cell, 1, EOS, K)
        ids, states, lengths = pkg.nn.dynamic_decode(
            dec, inits=init, max_step_num=10, output_time_major=time_major,
            return_length=True)
        out[pkg.__name__] = (np32(ids), np32(states.log_probs),
                             np32(lengths), np32(states.finished))
    got, want = out['paddle_tpu_torch'], out['paddle_tpu']
    assert got[0].shape == want[0].shape
    assert got[0].shape[0 if time_major else 1] == 2      # two steps
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert np.array_equal(got[2], want[2])
    assert got[3].all()


def test_tile_beam_merge_with_batch_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(x), 3)
    want = jpaddle.nn.BeamSearchDecoder.tile_beam_merge_with_batch(jt(x), 3)
    assert np.array_equal(got.numpy(), np32(want))
    empty = nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.zeros(2, 4, 0, 8), 3)
    assert tuple(empty.shape) == (6, 4, 0, 8)


class _CountingDecoder(nn.Decoder):
    """A decoder that does not track its own finished flags: entry b
    finishes at step b; its state counts the steps it ran."""

    def initialize(self, inits):
        fin = torch.zeros(3, dtype=torch.bool)
        return torch.zeros(3), {'n': torch.zeros(3)}, fin

    def step(self, time, inputs, states, **kwargs):
        t = int(time[0])
        out = inputs + 1
        return out, {'n': states['n'] + 1}, out, torch.arange(3) <= t


@pytest.mark.parametrize('impute', [False, True])
def test_dynamic_decode_imputes_finished_states(impute):
    """With ``impute_finished`` a finished entry keeps its states; the
    lengths count each entry's live steps."""
    outs, states, lengths = nn.dynamic_decode(
        _CountingDecoder(), max_step_num=9, impute_finished=impute,
        return_length=True)
    assert tuple(outs.shape) == (3, 3)
    assert lengths.tolist() == [1, 2, 3]
    assert states['n'].tolist() == ([1.0, 2.0, 3.0] if impute
                                    else [3.0, 3.0, 3.0])


def test_every_reference_name_exists_in_the_port():
    import paddle_tpu.nn.decode as ref
    from paddle_tpu_torch.nn import decode
    assert [n for n in ref.__all__ if not hasattr(decode, n)] == []
    assert nn.BeamSearchDecoder.OutputWrapper._fields == \
        jpaddle.nn.BeamSearchDecoder.OutputWrapper._fields
    assert nn.BeamSearchDecoder.StateWrapper._fields == \
        jpaddle.nn.BeamSearchDecoder.StateWrapper._fields


def test_seq2seq_end_to_end():
    """The reference's ``TestSeq2SeqEndToEnd`` run on the port: a tiny
    ``nn.Transformer`` trained on a copy task with Adam through the
    eager ``backward`` / ``step`` / ``clear_grad`` loop, then greedy
    decoding and a beam search over a cell without caches."""
    V, H, T = 12, 32, 6
    BOS, EOS = 0, 1
    paddle.seed(0)
    rs = np.random.RandomState(0)

    class TinySeq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(V, H)
            self.tgt_emb = nn.Embedding(V, H)
            self.tf = nn.Transformer(
                d_model=H, nhead=4, num_encoder_layers=1,
                num_decoder_layers=1, dim_feedforward=64, dropout=0.0)
            self.head = nn.Linear(H, V)

        def forward(self, src, tgt):
            mask = paddle.to_tensor(
                np.triu(np.full((tgt.shape[1], tgt.shape[1]), -1e9,
                                'float32'), 1))
            out = self.tf(self.src_emb(src), self.tgt_emb(tgt),
                          tgt_mask=mask)
            return self.head(out)

    model = TinySeq2Seq()
    opt = paddle.optimizer.Adam(5e-3, parameters=model.parameters())
    ce = nn.CrossEntropyLoss()
    src_np = rs.randint(2, V, size=(32, T)).astype('int64')
    tgt_in = np.concatenate([np.full((32, 1), BOS, 'int64'),
                             src_np[:, :-1]], axis=1)
    src = paddle.to_tensor(src_np)
    ti = paddle.to_tensor(tgt_in)
    lbl = paddle.to_tensor(src_np.reshape(32, T, 1))
    first = None
    for _ in range(80):
        loss = ce(model(src, ti), lbl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        first = first if first is not None else float(loss.detach())
    assert float(loss.detach()) < first * 0.5, (first, float(loss))

    s = paddle.to_tensor(src_np[:1])
    cur = np.full((1, 1), BOS, 'int64')
    with torch.no_grad():
        for _ in range(T):
            logits = model(s, paddle.to_tensor(cur))
            nxt = int(logits.numpy()[0, -1].argmax())
            cur = np.concatenate([cur, [[nxt]]], axis=1)
    assert (cur[0, 1:] == src_np[0]).mean() >= 0.5, (cur[0, 1:], src_np[0])

    class PrefixCell(nn.Layer):
        def __init__(self, m, src):
            super().__init__()
            self.m = m
            self.memory = m.tf.encoder(m.src_emb(src))

        def forward(self, inputs, states):
            prefix = paddle.concat([states, inputs.reshape([-1, 1])],
                                   axis=1)
            mask = paddle.to_tensor(
                np.triu(np.full((prefix.shape[1], prefix.shape[1]), -1e9,
                                'float32'), 1))
            mem = paddle.expand(self.memory,
                                [prefix.shape[0]] + list(
                                    self.memory.shape[1:]))
            out = self.m.tf.decoder(self.m.tgt_emb(prefix), mem,
                                    tgt_mask=mask)
            return self.m.head(out[:, -1]), prefix

    with torch.no_grad():
        dec = nn.BeamSearchDecoder(PrefixCell(model, s), start_token=BOS,
                                   end_token=EOS, beam_size=2)
        ids, _ = nn.dynamic_decode(
            dec, inits=paddle.to_tensor(np.zeros((1, 0), 'int64')),
            max_step_num=T - 1)
    top = ids.numpy()[0, :, 0]
    assert (top[:T] == src_np[0][:len(top[:T])]).mean() >= 0.5, (
        top, src_np[0])
