"""The fleet singleton on one process (counterpart of
``paddle_tpu/distributed/fleet/fleet_base.py``).

``fleet.init(strategy=)`` records the strategy and the role maker and
resolves the hybrid degrees as the reference does (``dp_degree`` -1
takes what the other degrees leave of the world).  Where the reference
then builds one mesh over every chip, the port runs one process a card
and no mesh yet: at a world of 1 with every degree 1 it records a
``HybridCommunicateGroup`` of sizes 1 and ranks 0, and a degree above 1
raises (ROADMAP Queue 1 item 9b), as do the group handles.

``distributed_optimizer`` is the reference's: ``strategy.lamb`` swaps
the optimizer for ``Lamb`` (the live learning-rate object, the
parameter list, ``grad_clip``, ``lamb_configs['lamb_weight_decay']``);
``strategy.dgc`` swaps a ``Momentum`` for ``DGCMomentum`` (momentum,
Nesterov, the coupled decay and the clip kept) and warns for any other
optimizer; the strategy rides the optimizer as ``_fleet_strategy``,
where ``ParallelTrainer`` finds it.  The reference swaps nothing for
``lars``, and neither does the port.  ``validate_strategy`` warns for
``a_sync`` and refuses ZeRO stage 3, as there.  The worker/server role
functions answer for one worker and no server.
"""
import warnings

from .. import env as _env
from ..env import ITEM_9B
from .distributed_strategy import DistributedStrategy

__all__ = ['init', 'get_fleet', 'Fleet', 'HybridCommunicateGroup',
           'distributed_optimizer', 'distributed_model',
           'get_hybrid_communicate_group', 'validate_strategy']



class HybridCommunicateGroup:
    """Rank and world size along each parallel dimension: sizes 1 and
    ranks 0 on one process.  The group handles raise (item 9b)."""

    def __init__(self, degrees=None):
        d = dict(degrees or {})
        self._dp = d.get('dp', 1)
        self._mp = d.get('tp', 1)
        self._pp = d.get('pp', 1)
        self._sp = d.get('sp', 1)

    def get_data_parallel_world_size(self):
        return self._dp

    def get_model_parallel_world_size(self):
        return self._mp

    def get_pipe_parallel_world_size(self):
        return self._pp

    def get_sequence_parallel_world_size(self):
        return self._sp

    def get_data_parallel_rank(self):
        return 0

    def get_model_parallel_rank(self):
        return 0

    def get_stage_id(self):
        return 0

    def _group(self, axis):
        raise NotImplementedError(f'the {axis} process group: {ITEM_9B}')

    def get_model_parallel_group(self):
        return self._group('tp')

    def get_data_parallel_group(self):
        return self._group('dp')

    def get_pipe_parallel_group(self):
        return self._group('pp')

    def topology(self):
        """The mesh, which the port does not build (item 9b): None."""
        return None


def _degrees(strategy, world):
    """The reference's degree resolution: (pp, dp, sp, ep, tp)."""
    hc = strategy.hybrid_configs
    mp = max(1, hc.get('mp_degree') or 1)
    pp = max(1, hc.get('pp_degree') or 1)
    sp = max(1, hc.get('sp_degree') or 1)
    ep = max(1, hc.get('ep_degree') or 1)
    dp = hc.get('dp_degree') or -1
    if dp is None or dp <= 0:
        dp = max(1, world // (mp * pp * sp * ep))
    return {'pp': pp, 'dp': dp, 'sp': sp, 'ep': ep, 'tp': mp}


class Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._is_initialized = False
        self._role_maker = None
        self._util = None

    @property
    def util(self):
        """``fleet.util``: host-side helpers for this role maker."""
        if self._util is None:
            from .role_maker import UtilBase
            self._util = UtilBase(self._role_maker)
        return self._util

    def init(self, role_maker=None, is_collective=True, strategy=None):
        strategy = strategy or DistributedStrategy()
        degrees = _degrees(strategy, _env.get_world_size())
        wide = {k: v for k, v in degrees.items() if v > 1}
        if wide:
            raise NotImplementedError(
                f'fleet.init with degrees {wide}: {ITEM_9B}')
        self._role_maker = role_maker
        self._util = None   # fleet.util follows this role maker
        self._strategy = strategy
        self._hcg = HybridCommunicateGroup(degrees)
        self._is_initialized = True
        return self

    @property
    def strategy(self):
        return self._strategy


_fleet = Fleet()


def get_fleet():
    return _fleet


def init(role_maker=None, is_collective=True, strategy=None):
    return _fleet.init(role_maker, is_collective, strategy)


def get_hybrid_communicate_group():
    return _fleet._hcg


def distributed_model(model):
    """The reference's wrap: ``DataParallel`` (one rank: the model
    unchanged)."""
    from ..parallel import DataParallel
    return DataParallel(model)


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer the strategy asks for, carrying it as
    ``_fleet_strategy`` (module docstring)."""
    strategy = strategy or _fleet._strategy or DistributedStrategy()
    validate_strategy(strategy)
    if strategy.lamb:
        from ...optimizer import Lamb
        if not isinstance(optimizer, Lamb):
            optimizer = Lamb(
                learning_rate=optimizer._learning_rate,  # the live object
                parameters=optimizer._parameter_list,
                grad_clip=optimizer._grad_clip,
                lamb_weight_decay=strategy.lamb_configs.get(
                    'lamb_weight_decay', 0.01))
    if strategy.dgc:
        from ...optimizer import DGCMomentum, Momentum
        if isinstance(optimizer, Momentum):
            cfg = strategy.dgc_configs or {}
            optimizer = DGCMomentum(
                learning_rate=optimizer._learning_rate,
                momentum=optimizer._momentum,
                parameters=optimizer._parameter_list,
                rampup_begin_step=cfg.get('rampup_begin_step', 0),
                rampup_step=cfg.get('rampup_step', 1),
                sparsity=cfg.get('sparsity', (0.999,)),
                use_nesterov=optimizer._nesterov,
                weight_decay=optimizer._coupled_wd or None,
                grad_clip=optimizer._grad_clip)
        else:
            warnings.warn(
                'strategy.dgc only applies to Momentum (reference '
                'dgc_optimizer.py raises for other optimizers); ignoring',
                UserWarning, stacklevel=2)
    optimizer._fleet_strategy = strategy
    return optimizer


def validate_strategy(strategy):
    """Warn for ``a_sync`` (the dense path stays synchronous) and refuse
    ZeRO stage 3, as the reference does."""
    if strategy is None:
        return
    if strategy.a_sync:
        warnings.warn(
            'strategy.a_sync: the dense (collective) path stays '
            'synchronous; asynchronous parameter-server semantics belong '
            'to the sparse host embedding (ROADMAP Queue 1 item 9d)',
            UserWarning, stacklevel=2)
    if strategy.sharding:
        stage = strategy.sharding_configs.get('stage', 1)
        if stage not in (0, 1, 2):
            raise NotImplementedError(
                f'ZeRO sharding stage={stage}: stages 0/1/2 are '
                'implemented (opt-state + gradient sharding over dp); '
                'stage-3 parameter sharding is not yet')


# -- the worker/server role API: one worker, no server -----------------------

def is_first_worker():
    return _env.get_rank() == 0


def worker_index():
    return _env.get_rank()


def worker_num():
    return _env.get_world_size()


def is_worker():
    return True


def worker_endpoints(to_string=False):
    eps = _env.ParallelEnv().trainer_endpoints
    return ','.join(eps) if to_string else eps


def server_num():
    return 0


def server_index():
    return 0


def server_endpoints(to_string=False):
    return '' if to_string else []


def is_server():
    return False


def barrier_worker():
    """A barrier over the workers: nothing to wait for on one."""
    _fleet.util.barrier()


def init_worker():
    pass


def init_server(*args, **kwargs):
    pass


def run_server():
    raise NotImplementedError(
        'there is no separate server process: the parameter server is '
        'replaced by sharded embeddings (ROADMAP Queue 1 item 9b) and the '
        'host embedding (item 9d)')


def stop_worker():
    pass
