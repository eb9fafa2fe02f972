"""The port's flash attention against the JAX package's, on the CPU.

The same numpy-seeded q/k/v/do (bh 2, T 256, D 64, f32) go through the
reference's Pallas kernels in TPU-interpret mode (blocks 128, as
``tests/test_ops_kernels.py`` runs them) and through the port's public
functions on CPU tensors, which run the plain twins of the CUDA
kernels.  Causal modes ``False``, ``True`` and ``'strict'``.

Tolerances: 1e-5 on o and lse (f32; the kernels' online softmax sums in
another order than the twin's whole-row softmax), 1e-4 on dq/dk/dv.
Strict mode's row 0 has no valid column: its lse is a sentinel (-1e30 in
the Pallas kernel, -1e29 in the reference's plain function and in the
port, whose CUDA kernel matches its twin), so that row's lse is checked
to be <= -1e29 and the others are compared.

The bf16 tensor-core kernels (forward and dk/dv) round P and dS to bf16
before their second products, where the plain twins keep f32.
``_mma_forward`` and ``_mma_bwd_dkv`` replay that arithmetic in plain
torch (64-key tiles, online max and sum in f32, P rounded before P.V;
P and dS rounded before P^T.dO and dS^T.Q) on bf16 inputs, and the
tests hold them within the card's kernel-vs-twin tolerance,
``|got - want| <= 2e-2 * (1 + |want|)`` on o, dk, dv (1e-4 on the f32
lse), of the twins and of the Pallas kernels in interpret mode, and
within half of it (1e-2) of the twins, the headroom the card's check
keeps for the other rounding it sees.
"""
import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops import _build

jfa = importlib.import_module('paddle_tpu.ops.flash_attention')
pfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SCALE = 0.125
MODES = [False, True, 'strict']


def _inputs(bh=2, t=256, d=64, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(bh, t, d).astype(np.float32) for _ in range(4))
    g_lse = rs.randn(bh, t).astype(np.float32)
    return q, k, v, do, g_lse


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _check_lse(got, want, causal):
    got, want = np.asarray(got), np.asarray(want)
    if causal == 'strict':
        assert (got[:, 0] <= -1e29).all() and (want[:, 0] <= -1e29).all()
        got, want = got[:, 1:], want[:, 1:]
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize('causal', MODES)
def test_forward_matches_the_pallas_kernel(causal):
    q, k, v, _, _ = _inputs()
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), SCALE, causal, 128, 128)
    o, lse = pfa.flash_attention_lse(*_torch(q, k, v), causal, SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert lse.shape == (2, 256) and lse.dtype == torch.float32
    _check_lse(lse.numpy(), np.asarray(jlse)[:, :, 0], causal)
    if causal == 'strict':
        assert float(o[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize('causal', MODES)
def test_gradients_match_jax_grad_through_the_pallas_kernels(causal):
    q, k, v, do, _ = _inputs(seed=1)

    def loss(a, b, c):
        return jnp.sum(jfa._flash(a, b, c, causal, SCALE, 128, 128)
                       * jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        jg = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, grad=True)
    pfa.flash_attention(tq, tk, tv, causal=causal, scale=SCALE).backward(
        torch.from_numpy(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize('causal', MODES)
def test_lse_cotangent_folds_in_exactly(causal):
    """The g_lse fold (delta - g_lse) against jax.vjp of _flash_lse."""
    q, k, v, do, g_lse = _inputs(seed=2)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda a, b, c: jfa._flash_lse(a, b, c, causal, SCALE, 128, 128),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        jg = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = pfa.flash_attention_lse(tq, tk, tv, causal, SCALE)
    torch.autograd.backward((o, lse), _torch(do, g_lse))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize('causal', MODES)
def test_backward_twins_equal_autograd_through_the_forward_twin(causal):
    """The explicit backward twins (the kernels' algebra, clamp and
    masking) against torch autograd through ``_reference_lse``."""
    q, k, v, do, g_lse = _inputs(bh=2, t=96, d=32, seed=3)
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = pfa._reference_lse(tq, tk, tv, causal, SCALE)
    torch.autograd.backward((o, lse), _torch(do, g_lse))
    o, lse = o.detach(), lse.detach()
    tdo, tg = _torch(do, g_lse)
    delta = (tdo * o).sum(-1) - tg
    args = (*_torch(q, k, v), tdo, lse, delta, causal, SCALE)
    dq = pfa._bwd_dq_reference(*args)
    dk, dv = pfa._bwd_dkv_reference(*args)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize('causal', MODES)
def test_ragged_length_matches_the_reference_function(causal):
    """T = 200 is no multiple of any tile: the port (the CUDA kernels
    mask the ragged last tile) against the reference's plain
    ``_reference_lse`` and jax.grad through it."""
    q, k, v, do, _ = _inputs(bh=3, t=200, d=48, seed=4)
    scale = 1.0 / math.sqrt(48)
    jo, jlse = jfa._reference_lse(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, scale)

    def loss(a, b, c):
        return jnp.sum(jfa._reference_lse(a, b, c, causal, scale)[0]
                       * jnp.asarray(do))

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = pfa.flash_attention_lse(tq, tk, tv, causal, None)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _check_lse(lse.detach().numpy(), jlse, causal)
    # the public path on CPU tensors is the kernels' twin
    to, tlse = pfa._reference_lse(*_torch(q, k, v), causal, scale)
    assert torch.equal(o.detach(), to) and torch.equal(lse.detach(), tlse)
    o.backward(torch.from_numpy(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_bf16_inputs_give_bf16_outputs_and_f32_lse():
    q, k, v, do, _ = _inputs(bh=2, t=64, d=32, seed=5)
    tq, tk, tv = (t.to(torch.bfloat16).requires_grad_()
                  for t in _torch(q, k, v))
    o, lse = pfa.flash_attention_lse(tq, tk, tv, True, None)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))
    ro, _ = pfa._reference_lse(tq, tk, tv, True, 1.0 / math.sqrt(32))
    np.testing.assert_allclose(o.detach().float().numpy(),
                               ro.detach().numpy(), rtol=1e-2, atol=1e-2)


def test_shape_gate_and_block_arguments():
    assert pfa.can_use_pallas(1, 1, 16) and pfa.can_use_pallas(200, 200, 64)
    assert pfa.can_use_pallas(1024, 1024, 128)
    assert not pfa.can_use_pallas(128, 128, 8)
    assert not pfa.can_use_pallas(128, 128, 72)
    assert not pfa.can_use_pallas(128, 128, 256)
    assert not pfa.can_use_pallas(0, 128, 64)
    q, k, v, _, _ = _inputs(bh=1, t=32, d=16)
    base = pfa.flash_attention(*_torch(q, k, v), causal=True)
    same = pfa.flash_attention(*_torch(q, k, v), causal=True, block_q=128,
                               block_k=256)
    assert torch.equal(base, same)
    for bad in (0, -64, 1.5, True):
        with pytest.raises(ValueError, match='block_q'):
            pfa.flash_attention(*_torch(q, k, v), block_q=bad)


def test_a_tensor_on_another_device_raises_instead_of_falling_back():
    q = torch.empty((1, 8, 16), device='meta')
    with pytest.raises(ValueError, match='no kernel for device'):
        pfa.flash_attention(q, q, q, causal=True)


def test_kernels_are_registered_with_their_tpu_counterparts():
    names = {kn.name: kn for kn in (pfa.FWD_KERNEL, pfa.DQ_KERNEL,
                                    pfa.DKV_KERNEL)}
    assert set(names) == {'flash_attention_fwd', 'flash_attention_bwd_dq',
                          'flash_attention_bwd_dkv'}
    assert names['flash_attention_fwd'].replaces.endswith(':151')
    assert names['flash_attention_bwd_dq'].replaces.endswith(':245')
    assert names['flash_attention_bwd_dkv'].replaces.endswith(':295')
    for kn in names.values():
        assert kn.route == 'cuda'
        assert kn.source_path == 'paddle_tpu_torch/csrc/flash_attention.cu'


# the card's bf16 kernel-vs-twin tolerances (chip_smoke.FLASH_TOL), and
# the half of the first that the rounding of P and dS may take
BF16_TOL, BF16_LSE_TOL, ROUNDING_TOL = 2e-2, 1e-4, 1e-2
MMA_KEYS = 64   # keys of a K/V tile of the tensor-core forward


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mma_forward(q, k, v, causal, scale):
    """The tensor-core forward's arithmetic on the CPU: ``(o bf16, lse
    f32)`` from 64-key tiles with the online max and sum in f32 and P
    rounded to bf16 before P.V."""
    s_all, _ = pfa._scores(q, k, causal, scale)
    bh, tq, tk = s_all.shape
    m = torch.full((bh, tq, 1), pfa.NEG_INF)
    l = torch.zeros((bh, tq, 1))
    acc = torch.zeros((bh, tq, q.shape[-1]))
    for k0 in range(0, tk, MMA_KEYS):
        s = s_all[:, :, k0:k0 + MMA_KEYS]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(s <= pfa.NEG_INF / 2, torch.zeros(()),
                        torch.exp(s - m_new))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + _bf16(p) @ v[:, k0:k0 + MMA_KEYS].float()
        m = m_new
    safe = l.clamp_min(1e-30)
    lse = (m.clamp_min(-1e29) + torch.log(safe))[..., 0]
    return (acc / safe).to(torch.bfloat16), lse


def _mma_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """The tensor-core dk/dv's arithmetic on the CPU: the twin's P and
    dS, rounded to bf16 before ``dV = P^T.dO`` and ``dK = dS^T.Q``."""
    p, ds = pfa._bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dk = _bf16(ds).transpose(-1, -2) @ q.float()
    dv = _bf16(p).transpose(-1, -2) @ do.float()
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _within(got, want, tol):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert bool((diff <= tol * (1 + want.abs())).all()), float(diff.max())
    return float(diff.max())


@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('causal', MODES)
def test_bf16_rounding_of_p_and_ds_stays_within_the_card_tolerance(d,
                                                                   causal):
    """bh 2, T 200 (ragged against 64-key tiles), bf16 inputs: the
    kernels' rounding points against the plain twins and the Pallas
    kernels (interpret mode, one 200-row block)."""
    rs = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 200, d).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o_emu, lse_emu = _mma_forward(q, k, v, causal, scale)
    o_twin, lse_twin = pfa._reference_lse(q, k, v, causal, scale)
    o_twin = o_twin.to(torch.bfloat16)
    rounding = _within(o_emu, o_twin, ROUNDING_TOL)
    _check_lse(lse_emu.numpy(), lse_twin.numpy(), causal)
    _within(lse_emu, lse_twin, BF16_LSE_TOL)
    delta = (do.float() * o_twin.float()).sum(-1)
    args = (q, k, v, do, lse_twin, delta, causal, scale)
    grads_emu = _mma_bwd_dkv(*args)
    for got, want in zip(grads_emu, pfa._bwd_dkv_reference(*args)):
        rounding = max(rounding, _within(got, want, ROUNDING_TOL))
    assert rounding > 0   # the rounding points are exercised

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._fwd_pallas(jq, jk, jv, scale, causal, 200, 200)
        _, jdk, jdv = jfa._bwd_pallas((jq, jk, jv, jo, jlse), jdo, scale,
                                      causal, 200, 200)
    _within(o_emu, torch.from_numpy(np.array(jo.astype(jnp.float32))),
            BF16_TOL)
    for got, want in zip(grads_emu, (jdk, jdv)):
        _within(got, torch.from_numpy(np.array(want.astype(jnp.float32))),
                BF16_TOL)
    if causal == 'strict':
        assert float(o_emu[:, 0].float().abs().max()) == 0.0


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its source, every
    ``csrc/*.cuh`` header and the flags: editing a header builds anew."""
    assert 'hopper_mma.cuh' in os.listdir(_build.CSRC_DIR)
    (tmp_path / 'kern.cu').write_text('#include "shared.cuh"\n')
    (tmp_path / 'shared.cuh').write_text('// v1\n')
    monkeypatch.setattr(_build, 'CSRC_DIR', str(tmp_path))
    src, first = _build._target('kern')
    assert src == str(tmp_path / 'kern.cu') and _build._target('kern')[1] \
        == first
    (tmp_path / 'shared.cuh').write_text('// v2\n')
    second = _build._target('kern')[1]
    (tmp_path / 'kern.cu').write_text('#include "shared.cuh"\n// edit\n')
    third = _build._target('kern')[1]
    (tmp_path / 'other.cuh').write_text('// new\n')
    fourth = _build._target('kern')[1]
    assert len({first, second, third, fourth}) == 4
    assert _build.sources() == ['kern']


def _stub_launches(monkeypatch):
    """The three kernels' entry points replaced by recorders (no card
    here): what the wrappers hand a launch on CUDA tensors."""
    seen = {}
    for kn in (pfa.FWD_KERNEL, pfa.DQ_KERNEL, pfa.DKV_KERNEL):
        monkeypatch.setattr(kn, '_fn', lambda *a, _n=kn.name:
                            seen.setdefault(_n, []).append(a) or 0)
    monkeypatch.setattr(pfa, 'stream', lambda device: 7)
    return seen


@pytest.mark.parametrize('dtype,code,design', [
    (torch.float16, 2, 'mma'), (torch.bfloat16, 1, 'mma'),
    (torch.float32, 0, 'simt')])
def test_each_dtype_reaches_every_kernel_launch_with_its_code(
        monkeypatch, dtype, code, design):
    """float16 reaches the forward, dq and dk/dv launches with code 2 (and
    the tensor-core design); 16-bit views off 16 bytes are copied to
    aligned ones first, dq's too; each launch counts on its design."""
    seen = _stub_launches(monkeypatch)
    bh, t, d = 2, 40, 32
    q, k, v, do = (torch.zeros(1 + bh * t * d, dtype=dtype)[1:]
                   .view(bh, t, d) for _ in range(4))
    lse, delta = torch.zeros(bh, t), torch.zeros(bh, t)
    before = {kn.name: dict(kn.variant_launches)
              for kn in (pfa.FWD_KERNEL, pfa.DQ_KERNEL, pfa.DKV_KERNEL)}
    o, lse_out = pfa._fwd_cuda(q, k, v, True, 0.125)
    dq = pfa._bwd_dq_cuda(q, k, v, do, lse, delta, True, 0.125)
    dk, dv = pfa._bwd_dkv_cuda(q, k, v, do, lse, delta, True, 0.125)
    assert all(t_.dtype == dtype for t_ in (o, dq, dk, dv))
    assert lse_out.dtype == torch.float32
    n_ptr = {'flash_attention_fwd': 5, 'flash_attention_bwd_dq': 7,
             'flash_attention_bwd_dkv': 8}
    for kn in (pfa.FWD_KERNEL, pfa.DQ_KERNEL, pfa.DKV_KERNEL):
        args, = seen[kn.name]
        ptrs, tail = args[:n_ptr[kn.name]], args[n_ptr[kn.name]:]
        assert tail[:4] == (bh, t, t, d) and tail[5:] == (1, code, 7)
        # q (and k, v, do) copied to 16 bytes for the tensor cores only
        assert (ptrs[0] != q.data_ptr()) is (design == 'mma')
        if design == 'mma':
            assert all(p % 16 == 0 for p in ptrs[:3])
        want = dict(before[kn.name])
        want[design] += 1
        assert kn.variant_launches == want


def test_dims_take_more_heads_than_one_grid_holds(monkeypatch):
    """B*H past 65535 (the grid's y limit) is taken: the entry points
    launch it in chunks of heads."""
    q = torch.zeros((65536, 2, 16))
    assert pfa._dims(q, q, q) == (65536, 2, 2, 16)
    seen = _stub_launches(monkeypatch)
    pfa._fwd_cuda(q, q, q, True, 0.25)
    args, = seen['flash_attention_fwd']
    assert args[5] == 65536
    assert pfa.can_use_pallas(2, 2, 16)


def _half(x, dtype):
    return x.to(dtype).float()


def _mma_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """The tensor-core dq's arithmetic on the CPU: S and dP in f32, P in
    the exp2 form with log2(e) folded into the scale (``exp2(min(s *
    scale * log2e - lse * log2e, 0))``), dS = P (dP - delta) scale,
    rounded to the input type before dQ = dS.K, dQ rounded to it."""
    log2e = 1.4426950408889634
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    arg = s * (scale * log2e) - (lse * log2e)[..., None]
    p = torch.exp2(torch.clamp_max(arg, 0.0))
    keep = pfa._keep_mask(q.shape[1], k.shape[1], causal, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros(()))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (_half(ds, q.dtype) @ k.float()).to(q.dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('causal', MODES)
def test_dq_rounding_replay_stays_within_half_the_card_tolerance(
        dtype, d, causal):
    """bh 2, T 200 (ragged against the 64- and 32-key tiles): the
    tensor-core dq's rounding points against its plain twin and against
    the Pallas dq in interpret mode (one 200-row block), both within
    half of the card's 2e-2 * (1 + |want|)."""
    rs = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 200, d).astype(np.float32))
                   .to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = pfa._reference_lse(q, k, v, causal, scale)
    delta = (do.float() * o.to(dtype).float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    emu = _mma_bwd_dq(*args)
    rounding = _within(emu, pfa._bwd_dq_reference(*args), ROUNDING_TOL)
    assert rounding > 0   # the rounding points are exercised

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jdt)
                       for t in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._fwd_pallas(jq, jk, jv, scale, causal, 200, 200)
        jdq, _, _ = jfa._bwd_pallas((jq, jk, jv, jo, jlse), jdo, scale,
                                    causal, 200, 200)
    _within(emu, torch.from_numpy(np.array(jdq.astype(jnp.float32))),
            ROUNDING_TOL)
    if causal == 'strict':
        assert float(emu[:, 0].float().abs().max()) == 0.0
