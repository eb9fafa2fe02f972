"""``paddle.utils.profiler`` (counterpart of
``paddle_tpu/utils/profiler.py``): an option-driven wrapper over
``paddle_tpu_torch.profiler``'s trace windows (``torch.profiler``) and
host step timers.  The reference's option keys are kept; the keys of
the legacy op-table profiler (``sorted_key``, ``op_summary_path``, ...)
are carried and unread, and the output is a Chrome trace under the
profiler's logdir.
"""
import sys
import warnings

from ..profiler import (start_profiler, stop_profiler, profiler,
                        reset_profiler, cuda_profiler)
# the one step timer (telemetry's; profiler re-exports it too)
from ..telemetry import StepTimer  # noqa: F401

__all__ = ['Profiler', 'get_profiler', 'ProfilerOptions', 'cuda_profiler',
           'start_profiler', 'profiler', 'stop_profiler', 'reset_profiler',
           'StepTimer']


class ProfilerOptions:
    """Option bag with the reference's keys and 'none'→None reads
    (the reference's ``utils/profiler.py:39``)."""

    def __init__(self, options=None):
        self.options = {
            'state': 'All',
            'sorted_key': 'default',
            'tracer_level': 'Default',
            'batch_range': [0, sys.maxsize],
            'output_thread_detail': False,
            'profile_path': 'none',
            'timeline_path': 'none',
            'op_summary_path': 'none',
        }
        if options is not None:
            for key in self.options:
                if options.get(key, None) is not None:
                    self.options[key] = options[key]

    def with_state(self, state):
        self.options['state'] = state
        return self

    def __getitem__(self, name):
        if self.options.get(name, None) is None:
            raise ValueError(
                f'ProfilerOptions does not have an option named {name}.')
        v = self.options[name]
        return None if (isinstance(v, str) and v == 'none') else v


_current_profiler = None


class Profiler:
    """Batch-range-aware profiling context (the reference's ``utils/profiler.py:76``).

    `add_step` drives the batch counter; tracing starts/stops when the
    counter crosses options['batch_range'].
    """

    def __init__(self, enabled=True, options=None):
        self.profiler_options = options if options is not None \
            else ProfilerOptions()
        self.batch_id = 0
        self.enabled = enabled
        self._tracing = False

    def __enter__(self):
        global _current_profiler
        self.previous_profiler = _current_profiler
        _current_profiler = self
        if self.enabled and self.profiler_options['batch_range'][0] == 0:
            self.start()
        return self

    def __exit__(self, *exc):
        global _current_profiler
        _current_profiler = self.previous_profiler
        if self.enabled:
            self.stop()

    def start(self):
        if self.enabled and not self._tracing:
            try:
                start_profiler(
                    state=self.profiler_options['state'],
                    tracer_option=self.profiler_options['tracer_level'])
                self._tracing = True
            except Exception as e:
                warnings.warn('Profiler is not enabled because following '
                              f'exception:\n{e}')

    def stop(self):
        if self.enabled and self._tracing:
            try:
                stop_profiler(
                    sorted_key=self.profiler_options['sorted_key'],
                    profile_path=self.profiler_options['profile_path'])
                self._tracing = False
            except Exception as e:
                warnings.warn('Profiler is not disabled because following '
                              f'exception:\n{e}')

    def reset(self):
        if self.enabled and self._tracing:
            reset_profiler()

    def record_step(self, change_profiler_status=True):
        if not self.enabled:
            return
        self.batch_id += 1
        if not change_profiler_status:
            return
        lo, hi = self.profiler_options['batch_range']
        if self.batch_id == lo:
            self.start() if not self._tracing else self.reset()
        elif self.batch_id == hi:
            self.stop()


def get_profiler():
    """The innermost active Profiler, creating a disabled default when
    none is live (the reference's ``utils/profiler.py:144``)."""
    global _current_profiler
    if _current_profiler is None:
        _current_profiler = Profiler(enabled=False)
    return _current_profiler
