"""Preemption-safe training: the port's copy of lanegcn_tpu/train/preempt.py.

The reference has no preemption handling: recovery is a manual restart with
`--resume ckpt` (reference train.py:71-79; SURVEY.md §5 "Failure detection /
elastic recovery: none"). Cloud GPU machines get preempted routinely, so the
port treats eviction as a normal event: a `PreemptionGuard` converts
SIGTERM/SIGINT into a flag the train loop polls once per step; the loop then
finishes the in-flight step, writes a regular checkpoint, and exits cleanly.
`--resume` continues the run bitwise: the CLI restores the step and skips
the groups of the current epoch that were already trained.

The handler only sets a flag (no I/O, no CUDA calls), so it is safe at any
interrupt point, including while kernels are being launched.
"""

from __future__ import annotations

import signal
from typing import Iterable


class PreemptionGuard:
    """Context manager: latch termination signals instead of dying.

    Usage:
        with PreemptionGuard() as guard:
            for batch in loader:
                train_step(...)
                if guard.triggered:
                    save_checkpoint(...)
                    break

    A second signal while latched re-raises the default behavior (so a stuck
    run can still be killed with a repeated Ctrl-C / SIGTERM).
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous = {}
        self._triggered = False
        self._signum = None

    @property
    def triggered(self) -> bool:
        return self._triggered

    @property
    def signal_name(self) -> str:
        return signal.Signals(self._signum).name if self._signum is not None else ""

    def _handle(self, signum, frame):
        if self._triggered:
            # Second signal: restore default disposition and re-deliver, so
            # repeated Ctrl-C still kills a wedged process.
            signal.signal(signum, self._previous.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self._triggered = True
        self._signum = signum

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
