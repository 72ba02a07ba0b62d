"""repro_torch.chaos — seeded, deterministic fault injection (the port of
``repro.chaos``'s injection hooks).

A :class:`FaultPlan` of scheduled faults is armed over a block of code with
:func:`armed`; named injection points placed in the stack fire exactly the
faults the plan schedules for them, so two runs with the same seed see the
same schedule and every drill is a regression test.  Disarmed, an injection
point is one module-global load and a ``None`` check.

The port places the ``train.step`` site (``train.loop.fit``): the crash
drill stops a run there, and ``train.checkpoint``'s restore falls back
past a file :func:`corrupt_file` damaged; and the kernel path's
``exec.pallas_launch`` / ``exec.kernel_result`` sites, which
``exec.fallback.ResilientPlan`` answers.  :func:`adversarial_trace` is the
serving traffic that overloads the batcher's bounded queue (load shedding)
and carries malformed ids.  The ``dist.halo`` site sits in the retry
ladders of ``dist.resilient`` and ``dist.elastic``.  ``chaos.drill`` is
the seeded gauntlet over all of them (``python -m repro_torch.chaos.drill
--seed 0``).
"""
from .inject import (KINDS, Fault, FaultInjector, FaultPlan, InjectedFault,
                     active, armed, corrupt_file, fail_point, fire, mangle)

__all__ = ["Fault", "FaultPlan", "FaultInjector", "InjectedFault",
           "armed", "active", "fire", "fail_point", "mangle",
           "corrupt_file", "KINDS", "adversarial_trace"]


def __getattr__(name: str):
    # traffic pulls in serve, which pulls in exec and train, which import
    # the injection hooks: loading it lazily avoids the import cycle
    if name == "adversarial_trace":
        from .traffic import adversarial_trace
        return adversarial_trace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
