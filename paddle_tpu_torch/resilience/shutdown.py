"""Graceful preemption: SIGTERM → checkpoint at the step boundary
(counterpart of ``paddle_tpu/resilience/shutdown.py``; host code, the
same latch, exit code and environment variable).

Accelerator hosts get preempted with a SIGTERM and a short grace window.  The
wrong responses are both fatal: dying instantly loses up-to-an-epoch
of work, and ignoring the signal gets the SIGKILL anyway.  The right
response — and what `GracefulShutdown` implements — is to latch the
request, let the in-flight step finish, write one final synchronous
checkpoint, and exit with `PREEMPTED_EXIT_CODE` so the elastic
supervisor knows this was a CLEAN preemption: it restarts the worker
WITHOUT consuming the max_restarts failure budget (a fleet that
preempts a job 10 times must not exhaust a 3-restart budget meant for
real crashes).

Signal handlers only latch a flag (async-signal-safe); all real work
happens on the main loop at `requested()` checkpoints —
incubate.checkpoint.auto_checkpoint's train ranges and hapi.Model.fit
poll it every step.
"""
import os
import signal
import sys
import threading

__all__ = ['PREEMPTED_EXIT_CODE', 'GracefulShutdown',
           'install_shutdown', 'shutdown_requested', 'exit_if_requested']

# Distinct from every exit code the stack produces organically: shells
# use 126/127, Python tracebacks exit 1, argparse exits 2, signal
# deaths surface as negative returncodes / 128+N.  Exported to workers
# as PADDLE_TPU_PREEMPTED_EXIT_CODE for non-Python launch targets.
PREEMPTED_EXIT_CODE = int(os.environ.get(
    'PADDLE_TPU_PREEMPTED_EXIT_CODE', '117'))


class GracefulShutdown:
    """Latch SIGTERM/SIGINT into a poll-able "please checkpoint and
    exit" request.

        gs = GracefulShutdown().install()
        for step in ...:
            train_step()
            if gs.requested():
                save_final_checkpoint()
                gs.exit()          # sys.exit(PREEMPTED_EXIT_CODE)

    `install()` chains to the previous handler on the SECOND signal:
    the first SIGINT requests a graceful stop, an impatient second one
    falls through to the default KeyboardInterrupt.  Installation is
    a no-op off the main thread (CPython restriction) — `requested()`
    then only reflects `request()` calls, which tests and embedding
    runtimes use directly.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 exit_code=PREEMPTED_EXIT_CODE, on_request=None):
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self.on_request = on_request
        self._event = threading.Event()
        self._prev = {}
        self._installed = False
        self.signum = None

    def install(self):
        if self._installed:
            return self
        # pre-create the telemetry recorder on the MAIN thread so the
        # signal handler's flight-ring note never has to construct it
        # (get_recorder() takes a non-reentrant creation lock the
        # handler must not touch)
        try:
            from ..telemetry import active, get_recorder
            if active():
                get_recorder()
        except Exception:       # pragma: no cover - defensive
            pass
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:
            # not the main thread: polling still works via request()
            self._prev.clear()
        return self

    def uninstall(self):
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _handler(self, signum, frame):
        if self._event.is_set():
            if signum == getattr(signal, 'SIGINT', None):
                # second Ctrl-C: the USER is done waiting — restore
                # and re-raise into the previous (usually default)
                # handler
                prev = self._prev.get(signum)
                signal.signal(signum, prev if callable(prev)
                              else signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            # a repeated SIGTERM stays latched: fleets deliver the
            # preemption signal to the whole process group AND the
            # supervisor forwards it, so doubles are normal — dying
            # on the second one would lose the final checkpoint the
            # grace window exists for
            return
        self.signum = signum
        self._event.set()
        self._note_preemption(signum)
        if self.on_request is not None:
            self.on_request(signum)

    @staticmethod
    def _note_preemption(signum):
        """Land a ``preemption`` event in the telemetry flight ring.
        Runs in signal-handler context: event_unlocked is one atomic
        deque append — no locks of any kind (a signal landing while
        another thread holds the recorder lock — or the singleton
        creation lock inside get_recorder() — must not deadlock the
        latch), no file I/O (the JSONL copy is written by the poll
        site, e.g. Model.fit's step boundary).  Reads the module
        global directly: if no recorder exists yet the note is
        skipped (install() pre-creates it on the main thread, so in
        practice it exists)."""
        try:
            from ..telemetry import recorder as _rmod
            rec = _rmod._recorder
            if rec is not None and not _rmod.hard_off():
                rec.event_unlocked('preemption', signum=signum)
        except Exception:       # pragma: no cover - defensive
            pass

    def request(self, signum=None):
        """Programmatic preemption request (tests; cluster agents that
        learn of preemption via metadata server rather than signal)."""
        self.signum = signum
        self._event.set()
        self._note_preemption(signum)

    def requested(self):
        return self._event.is_set()

    def clear(self):
        """Un-latch a handled request (a loop that chose to stop
        WITHOUT exiting — e.g. an interactive fit stopped by Ctrl-C —
        clears so the next loop starts fresh)."""
        self.signum = None
        self._event.clear()

    def exit(self, final=None):
        """Run `final` (the last checkpoint) and exit preempted."""
        if final is not None:
            final()
        sys.exit(self.exit_code)


# -- process-wide singleton ----------------------------------------------
# auto_checkpoint / hapi.fit poll the same instance the launcher (or
# user code) installed, so one SIGTERM stops every loop in the process.
_default = None


def install_shutdown(**kwargs):
    """Install (once) and return the process-wide GracefulShutdown."""
    global _default
    if _default is None:
        _default = GracefulShutdown(**kwargs)
    return _default.install()


def shutdown_requested():
    """True iff a graceful shutdown was requested on the process-wide
    handler (False when none was ever installed)."""
    return _default is not None and _default.requested()


def preemption_signal():
    """The latched signum of the process-wide request, or None (no
    handler / no request / programmatic request()).  Lets loops tell
    fleet preemption (SIGTERM → checkpoint and EXIT preempted) from a
    user interrupt (SIGINT → stop and hand control back)."""
    if _default is not None and _default.requested():
        return _default.signum
    return None


def exit_if_requested(final=None):
    """Checkpoint-and-exit when preempted; no-op otherwise."""
    if shutdown_requested():
        _default.exit(final)


def clear_shutdown():
    """Un-latch the process-wide request (see GracefulShutdown.clear)."""
    if _default is not None:
        _default.clear()


def handler_installed():
    """True iff the process-wide handler currently owns the signals
    (lets scoped installers — e.g. Model.fit — restore the previous
    handlers on exit instead of holding them for process lifetime)."""
    return _default is not None and _default._installed


def uninstall_shutdown():
    """Restore the signal handlers the process-wide install replaced."""
    if _default is not None:
        _default.uninstall()
