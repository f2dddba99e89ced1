"""Preemption capture: turn SIGTERM/SIGINT into a final checkpoint (the
port's copy of ``runtime/preempt.py``).

SLURM preemption and cloud-VM maintenance both deliver SIGTERM with a
grace window of tens of seconds — enough to finish the in-flight epoch and
write one checkpoint, and exactly what the grid's bit-identical resume
needs to make preemption a pause instead of lost work.

The guard is deliberately cooperative: the signal handler only sets a flag
(async-signal-safe; no I/O or device calls in handler context), and the
training loop polls it at epoch boundaries, saves, and raises
:class:`Preempted`. A second SIGINT falls through to the previous handler
(normally KeyboardInterrupt) so an interactive user can still force-quit a
hung save.

stdlib only.
"""
from __future__ import annotations

import signal

__all__ = ["Preempted", "DeadlineExceeded", "PreemptionGuard"]


class DeadlineExceeded(Exception):
    """A fit stopped because its wall-clock deadline expired at an epoch
    boundary, AFTER draining in-flight work and writing a final checkpoint
    — so a rerun against the same checkpoint_dir resumes losslessly."""

    def __init__(self, scope, epoch=None, elapsed_s=None, deadline_s=None):
        self.scope = scope
        self.epoch = epoch
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        super().__init__(
            f"{scope} deadline of {deadline_s}s exceeded at epoch {epoch} "
            f"(elapsed {None if elapsed_s is None else round(elapsed_s, 1)}s);"
            f" final checkpoint written — rerun with the same checkpoint_dir "
            f"to resume")


class Preempted(Exception):
    """A fit stopped on SIGTERM/SIGINT after writing its final checkpoint."""

    def __init__(self, signum, epoch=None):
        self.signum = signum
        self.epoch = epoch
        name = signal.Signals(signum).name if signum is not None else "signal"
        super().__init__(
            f"fit preempted by {name} at epoch {epoch}; final checkpoint "
            f"written — rerun with the same checkpoint_dir to resume")


class PreemptionGuard:
    """Context manager that latches SIGTERM/SIGINT into ``self.preempted``.

    ``enabled=False`` (or installation from a non-main thread, where Python
    forbids signal handlers) degrades to an inert guard whose flag never
    sets, so call sites never branch. Previous handlers are restored on
    exit.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.preempted = False
        self.signum = None
        self._previous = {}

    def _handle(self, signum, frame):
        if self.preempted and signum == signal.SIGINT:
            # second Ctrl-C: the user wants OUT, not another checkpoint
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            raise KeyboardInterrupt
        self.preempted = True
        self.signum = signum

    def __enter__(self):
        if not self.enabled:
            return self
        try:
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
        except ValueError:  # not the main thread: signals are off the table
            self._previous = {}
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous = {}
        return False
