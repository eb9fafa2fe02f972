"""The port's ``amp.GradScaler`` against the JAX package's, on the CPU.

The same seeded gradient sequence, some steps with an injected inf or
NaN, goes through both scalers: the scale, the good- and bad-step
counts, whether each step updated the parameters, and the unscaled
gradients agree after every step.  Both scalers divide by the same
power-of-two scale, so the unscaled gradients agree exactly.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jax_amp
from paddle_tpu_torch import amp
from paddle_tpu_torch.optimizer import AdamW

SHAPES = [(4, 3), (5,)]


class _JaxOpt:
    """What the reference scaler touches: ``_params`` with ``_grad``,
    and ``step()``."""

    def __init__(self):
        self._params = [SimpleNamespace(_grad=None) for _ in SHAPES]
        self.steps = 0

    def step(self):
        self.steps += 1


def _grads(rs, scale, bad):
    grads = [(scale * rs.randn(*s)).astype(np.float32) for s in SHAPES]
    if bad:
        grads[bad % 2].flat[bad % 3] = np.inf if bad % 2 else np.nan
    return grads


def _run(kw, bad_steps, n_steps):
    """Both scalers over ``n_steps`` seeded steps; ``bad_steps`` maps a
    step to a nonzero tag that injects an inf or a NaN."""
    jscaler, pscaler = jax_amp.GradScaler(**kw), amp.GradScaler(**kw)
    jopt = _JaxOpt()
    params = [torch.zeros(s, requires_grad=True) for s in SHAPES]
    popt = AdamW(learning_rate=1e-3, parameters=params)
    rs = np.random.RandomState(0)
    history = []
    for step in range(n_steps):
        assert pscaler.get_init_loss_scaling() == \
            jscaler.get_init_loss_scaling()
        grads = _grads(rs, jscaler.get_init_loss_scaling(),
                       bad_steps.get(step, 0))
        for jp, pp, g in zip(jopt._params, params, grads):
            jp._grad = jnp.asarray(g)
            pp.grad = torch.from_numpy(g.copy())
        before = [p.detach().clone() for p in params]
        jsteps = jopt.steps
        jscaler.step(jopt)
        pscaler.step(popt)
        stepped = not all(torch.equal(a, p.detach())
                          for a, p in zip(before, params))
        assert stepped == (jopt.steps == jsteps + 1), step
        for jp, pp in zip(jopt._params, params):
            np.testing.assert_array_equal(pp.grad.numpy(),
                                          np.asarray(jp._grad))
        assert pscaler.state_dict() == jscaler.state_dict(), step
        history.append((pscaler.state_dict()['scale'], stepped))
    return history


def test_scale_and_step_trajectory_match_the_reference():
    """Fast increase (every 3 good steps), decrease after 2 bad steps in a
    row, bad steps that do not reach the decrease, and runs long enough
    to climb again."""
    bad = {3: 1, 6: 2, 7: 3, 10: 4, 11: 5, 12: 1, 16: 2}
    history = _run(dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
                        decr_every_n_nan_or_inf=2), bad, 20)
    scales = [s for s, _ in history]
    assert max(scales) > 2.0 ** 4 and min(scales) < 2.0 ** 4
    assert [st for _, st in history] == [i not in bad for i in range(20)]


def test_defaults_match_the_reference():
    """The reference's defaults: 2^15, x2 after 1000 good steps, x0.5
    after 2 bad ones; the scale floors at 1."""
    assert amp.GradScaler().state_dict() == jax_amp.GradScaler().state_dict()
    history = _run(dict(init_loss_scaling=2.0), {i: 1 + i for i in range(6)},
                   6)
    assert [s for s, _ in history] == [2.0, 1.0, 1.0, 1.0, 1.0, 1.0]


def test_scale_minimize_state_dict_and_disabled_scaler():
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    loss = torch.tensor(1.5)
    assert float(scaler.scale(loss)) == 12.0
    p = torch.zeros(3, requires_grad=True)
    opt = AdamW(learning_rate=0.1, parameters=[p])
    p.grad = torch.full((3,), 8.0)
    scaler.minimize(opt, scaler.scale(loss))
    assert torch.equal(p.grad, torch.ones(3)) and opt._global_step == 1
    state = scaler.state_dict()
    other = amp.GradScaler()
    other.load_state_dict(state)
    assert other.state_dict() == state
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    p.grad = torch.full((3,), np.inf)
    off.step(opt)                                # steps unconditionally
    assert opt._global_step == 2


def test_a_static_scale_unscales_every_step():
    """With ``use_dynamic_loss_scaling=False`` the scale stays, and each
    step's gradients are unscaled (the reference unscales only the
    first: its per-step flags are cleared only when the scale is
    dynamic)."""
    scaler = amp.GradScaler(init_loss_scaling=4.0,
                            use_dynamic_loss_scaling=False)
    p = torch.zeros(2, requires_grad=True)
    opt = AdamW(learning_rate=0.1, parameters=[p])
    for _ in range(3):
        p.grad = torch.full((2,), 4.0)
        scaler.step(opt)
        assert torch.equal(p.grad, torch.ones(2))
    p.grad = torch.full((2,), np.nan)
    scaler.step(opt)
    assert opt._global_step == 3 and scaler.get_init_loss_scaling() == 4.0


@pytest.mark.parametrize('name', ['GradScaler', 'auto_cast', 'decorate'])
def test_exported_where_the_reference_exports_it(name):
    assert name in amp.__all__ and name in jax_amp.__all__
