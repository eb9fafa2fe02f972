"""DistributedStrategy — training strategy configuration (counterpart of
``paddle_tpu/distributed/fleet/distributed_strategy.py``).

The reference's toggles and configs, unchanged.  The port's
single-device ``ParallelTrainer`` honours what the reference's does
without a mesh: ``amp`` (``amp_configs['use_pure_fp16']``: bf16 O1 or
O2), ``recompute`` (the whole forward recomputed in the backward;
``recompute_configs`` unread, as there) and ``gradient_merge``
(``k_steps`` micro-batches in one step, their gradients averaged
whatever ``avg`` says, as there); ``lamb`` and ``dgc`` act through
``fleet.distributed_optimizer``.  ``sharding`` at stages 0-2,
``tensor_parallel``, ``sequence_parallel``, ``localsgd``, ``lars`` and
``pipeline`` (which warns) change nothing on one device, as in the
reference; ``a_sync`` warns and ZeRO stage 3 raises
(``fleet_base.validate_strategy``).  The parallel degrees above 1 are
ROADMAP item 9b.
"""

__all__ = ['DistributedStrategy']


class _Bag(dict):
    __getattr__ = dict.get

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = _Bag(init_loss_scaling=32768.0,
                                use_pure_fp16=False,
                                custom_white_list=None,
                                custom_black_list=None, use_bf16=True)
        self.recompute = False
        self.recompute_configs = _Bag(checkpoints=[],
                                      policy='nothing_saveable')
        self.sharding = False
        self.sharding_configs = _Bag(stage=1, sharding_degree=-1)
        self.pipeline = False
        self.pipeline_configs = _Bag(accumulate_steps=1, micro_batch_size=1,
                                     schedule_mode='1F1B')
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Bag(tensor_parallel_degree=1)
        self.sequence_parallel = False
        self.gradient_merge = False
        self.gradient_merge_configs = _Bag(k_steps=1, avg=True)
        self.lamb = False
        self.lamb_configs = _Bag(lamb_weight_decay=0.01,
                                 exclude_from_weight_decay=[])
        self.lars = False
        self.lars_configs = _Bag(lars_coeff=0.001, lars_weight_decay=0.0005)
        self.localsgd = False
        self.localsgd_configs = _Bag(k_steps=1)
        self.dgc = False
        self.dgc_configs = _Bag(rampup_begin_step=0, rampup_step=1,
                                sparsity=[0.999])
        self.a_sync = False
        self.a_sync_configs = _Bag(k_steps=-1)
        self.hybrid_configs = _Bag(dp_degree=-1, mp_degree=1, pp_degree=1,
                                   sp_degree=1, ep_degree=1,
                                   sharding_degree=1)
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True   # parity only
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1            # parity only

    @property
    def hybrid_parallel_order(self):
        return ['pp', 'dp', 'sp', 'ep', 'mp']

    def enabled_toggles(self):
        """Names of the boolean toggles that are on."""
        return [k for k, v in self.__dict__.items()
                if isinstance(v, bool) and v]

    def __repr__(self):
        return (f'DistributedStrategy(enabled={self.enabled_toggles()}, '
                f'hybrid={dict(self.hybrid_configs)})')
