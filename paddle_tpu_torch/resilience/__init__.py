"""Fault-tolerant training and serving (counterpart of
``paddle_tpu/resilience``):

  manifest   verified checkpoints — a commit manifest (step, leaf spec,
             per-file sizes + checksums) written atomically AFTER the
             (async) save finishes; the two-phase cross-host variant.
  retry      retry with backoff, jitter, a deadline and telemetry.
  shutdown   GracefulShutdown — SIGTERM/SIGINT become a "finish the
             step, checkpoint, exit PREEMPTED_EXIT_CODE" request.
  sentinel   NanSentinel — skip non-finite updates, roll back to the
             last committed checkpoint after K consecutive strikes.
  chaos      seeded fault plans, the training seams (ChaosEngine,
             ChaosCallback), the invariant checker and the serving
             fault injector.
  watchdog   deadline budgets and the Watchdog thread for one rank.

Still waiting: ``ChaosCluster`` and chaos's ``drift`` and collective
faults (the host transport of ``distributed.collective``, ROADMAP Queue
1 item 9b's second part, and item 10), the watchdog's cluster quorum
(``transport=``/``kv=``, item 9b's second part), ``plangen`` and the
plan ``supervisor`` (items 10 and 11).
"""
from .manifest import (  # noqa: F401
    MANIFEST_NAME, TWO_PHASE_DIR, write_manifest, read_manifest,
    verify_manifest, is_committed, file_checksum, atomic_write,
    write_intent, read_intents, intent_age, finalize_two_phase,
    CommitBarrierTimeout)
from .retry import retry  # noqa: F401
from .shutdown import (  # noqa: F401
    PREEMPTED_EXIT_CODE, GracefulShutdown, install_shutdown,
    shutdown_requested, exit_if_requested, preemption_signal,
    clear_shutdown, handler_installed, uninstall_shutdown)
from .sentinel import NanSentinel, finite_step, guard_update  # noqa: F401
from .chaos import (  # noqa: F401
    COLLECTIVE_FAULT_KINDS, FAULT_KINDS, PLAN_ENV, SERVING_FAULT_KINDS,
    ChaosCallback, ChaosCluster, ChaosEngine, Fault, FaultPlan,
    ServingFaultInjector, check_invariants, load_run_events,
    plan_from_env)
from .watchdog import (  # noqa: F401
    WATCHDOG_ENV, WATCHDOG_EXIT_CODE, Budget, Watchdog, collective_budget,
    default_collective_s, remaining_budget, resolve_watchdog)

__all__ = [
    'MANIFEST_NAME', 'TWO_PHASE_DIR', 'write_manifest', 'read_manifest',
    'verify_manifest', 'is_committed', 'file_checksum', 'atomic_write',
    'write_intent', 'read_intents', 'intent_age', 'finalize_two_phase',
    'CommitBarrierTimeout',
    'retry',
    'PREEMPTED_EXIT_CODE', 'GracefulShutdown', 'install_shutdown',
    'shutdown_requested', 'exit_if_requested', 'preemption_signal',
    'clear_shutdown', 'handler_installed', 'uninstall_shutdown',
    'NanSentinel', 'finite_step', 'guard_update',
    'Fault', 'FaultPlan', 'ChaosEngine', 'ChaosCallback', 'ChaosCluster',
    'check_invariants', 'load_run_events', 'ServingFaultInjector',
    'plan_from_env', 'FAULT_KINDS', 'COLLECTIVE_FAULT_KINDS',
    'SERVING_FAULT_KINDS', 'PLAN_ENV',
    'Watchdog', 'Budget', 'WATCHDOG_EXIT_CODE', 'collective_budget',
    'remaining_budget', 'resolve_watchdog', 'default_collective_s',
    'WATCHDOG_ENV',
]
