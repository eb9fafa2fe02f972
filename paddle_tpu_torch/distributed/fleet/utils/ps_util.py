"""Parameter-server inference shim (counterpart of
``paddle_tpu/distributed/fleet/utils/ps_util.py``): ``DistributedInfer``.
There are no remote sparse tables to pull, so the setup is a no-op and
the program comes back unchanged, as in the reference.
"""

__all__ = ['DistributedInfer']


class DistributedInfer:
    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program
        self._startup = startup_program

    def init_distributed_infer_env(self, exe=None, loss=None,
                                   role_maker=None, dirname=None):
        """Nothing to pull: every table is local."""
        return None

    def get_dist_infer_program(self):
        return self._main
