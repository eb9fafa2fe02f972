"""The JAX side of the port's multi-process tests
(``tests/test_torch_tensor_parallel.py``, ``test_torch_data_parallel.py``):
the shared small GPT, its weights and batch, the JAX ``ParallelTrainer``
under ``fleet.init`` with the same degrees on the 8 virtual CPU devices
(the global mesh reset after each use), and the comparison of the
port's gathered parameters with the bounds of
``tests/test_torch_fleet_strategy.py``.
"""
import jax.numpy as jnp
import numpy as np

import paddle_tpu as jpaddle
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer

MODEL_KW = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
                max_seq_len=64, dropout=0.0, fused_head=False)
LR, STEPS = 3e-3, 3
TOL, GRAD_TOL, O2_LOSS_RTOL = 2e-5, 1e-4, 2e-3
IDS = np.random.RandomState(0).randint(0, 128, (8, 32)).astype(np.int64)


def gpt_weights():
    """The JAX ``gpt_tiny``'s init with its biases and LayerNorms moved
    off their constants (so their gradients are not all alike)."""
    jpaddle.seed(7)
    params, _ = jax_gpt_tiny(**MODEL_KW).functional_state()
    rs = np.random.RandomState(11)
    host = {}
    for name, value in params.items():
        arr = np.asarray(value).copy()
        if name.endswith('bias') or '.ln' in name:
            arr = arr + (0.1 * rs.randn(*arr.shape)).astype(np.float32)
        host[name] = arr
    return host


def strategy(dp=-1, tp=1, recompute=False, merge=1, o2=False):
    st = jfleet.DistributedStrategy()
    st.hybrid_configs['dp_degree'] = dp
    st.hybrid_configs['mp_degree'] = tp
    st.recompute = recompute
    if merge > 1:
        st.gradient_merge = True
        st.gradient_merge_configs['k_steps'] = merge
    if o2:
        st.amp = True
        st.amp_configs['use_pure_fp16'] = True
    return st


def jax_gpt_run(host, dp, tp, clip=None, clip_by='global', **kw):
    """The JAX trainer over ``dp x tp`` (AdamW, with
    ``ClipGradByGlobalNorm(clip)``, or ``ClipGradByNorm(clip)`` for
    ``clip_by='norm'``, where given): the losses of ``STEPS``
    steps on ``IDS`` and the parameters after them."""
    st = strategy(dp, tp, **kw)
    jfleet.init(is_collective=True, strategy=st)
    try:
        jm = jax_gpt_tiny(**MODEL_KW)
        jm.load_functional_state({k: jnp.asarray(v) for k, v in host.items()})
        tr = JaxTrainer(jm, JaxAdamW(
            learning_rate=LR, parameters=jm.parameters(),
            grad_clip=None if not clip else (
                ClipGradByNorm if clip_by == 'norm'
                else ClipGradByGlobalNorm)(clip)),
            lambda out, y: jm.loss(out, y), strategy=st)
        losses = [tr.loss_float(tr.step(IDS, IDS)) for _ in range(STEPS)]
        return losses, {k: np.asarray(v) for k, v in tr.params.items()}
    finally:
        jenv.set_mesh(None)


def roundoff(host):
    """``{name: mask}`` of the entries whose first gradient (the port at
    one process, on the full batch) is round-off, at most 1e-6 of its
    tensor's largest: AdamW turns those into steps of up to ``LR`` whose
    sign the summation order decides."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt_tiny
    pm = gpt_tiny(device='cpu', **MODEL_KW).train()
    pm.load_numpy_state(host)
    t = torch.from_numpy(IDS)
    pm.loss(pm(t), t).backward()
    out = {}
    for name, p in pm.named_parameters():
        g = p.grad.abs()
        out[name] = (g <= 1e-6 * g.max()).numpy()
    return out


def params_close(got, want, noisy, tol=GRAD_TOL):
    """Every parameter within ``tol``; the attention key's bias (true
    gradient 0) and the round-off entries of ``noisy`` within AdamW's
    bound ``2 * LR * STEPS``."""
    assert set(got) == set(want)
    h = MODEL_KW['hidden_size']
    bound = 2 * LR * STEPS
    for name, value in want.items():
        g, v = np.asarray(got[name]), np.asarray(value)
        loose = np.asarray(noisy.get(name, np.zeros(g.shape, bool))).copy()
        if name.endswith('attn.qkv.bias'):
            loose[h:2 * h] = True
        np.testing.assert_allclose(g[loose], v[loose], atol=bound, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g[~loose], v[~loose], rtol=tol, atol=tol,
                                   err_msg=name)


def gpt_specs():
    """The port's ``gpt_tiny``'s tensor-parallel specs, from its layers
    (built on the meta device)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models.gpt import gpt_tiny
    return convert.shard_specs(gpt_tiny(device='meta', **MODEL_KW))


def port_mesh(dp, tp):
    """The port's mesh layout of ``fleet.init`` with ``dp x tp`` (no
    process group: for ``convert.gather_state``)."""
    from paddle_tpu_torch.distributed.env import Mesh
    return Mesh(['pp', 'dp', 'sp', 'ep', 'tp'], [1, dp, 1, 1, tp])
