"""Fault-tolerant training and serving (counterpart of
``paddle_tpu/resilience``): the NaN sentinel, the watchdog's deadline
budgets and the serving half of chaos (fault plans and the serving
fault injector).  Checkpoint manifests, graceful shutdown, retry, the
watchdog thread, chaos's training seams, plan generation and the
supervisor wait for later slices."""
from .chaos import (COLLECTIVE_FAULT_KINDS, FAULT_KINDS, PLAN_ENV,
                    SERVING_FAULT_KINDS, Fault, FaultPlan,
                    ServingFaultInjector, plan_from_env)
from .sentinel import NanSentinel, finite_step, guard_update
from .watchdog import (WATCHDOG_ENV, WATCHDOG_EXIT_CODE, Budget,
                       collective_budget, default_collective_s,
                       remaining_budget, resolve_watchdog)

__all__ = ['NanSentinel', 'finite_step', 'guard_update',
           'Budget', 'resolve_watchdog', 'collective_budget',
           'remaining_budget', 'default_collective_s', 'WATCHDOG_ENV',
           'WATCHDOG_EXIT_CODE', 'Fault', 'FaultPlan',
           'ServingFaultInjector', 'plan_from_env', 'FAULT_KINDS',
           'COLLECTIVE_FAULT_KINDS', 'SERVING_FAULT_KINDS', 'PLAN_ENV']
