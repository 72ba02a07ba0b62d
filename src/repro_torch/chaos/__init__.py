"""repro_torch.chaos — seeded, deterministic fault injection (the port of
``repro.chaos``'s injection hooks).

A :class:`FaultPlan` of scheduled faults is armed over a block of code with
:func:`armed`; named injection points placed in the stack fire exactly the
faults the plan schedules for them, so two runs with the same seed see the
same schedule and every drill is a regression test.  Disarmed, an injection
point is one module-global load and a ``None`` check.

The port places the ``train.step`` site (``train.loop.fit``): the crash
drill stops a run there, and ``train.checkpoint``'s restore falls back
past a file :func:`corrupt_file` damaged.  The reference's exec fallback
chain and its sites, its serving traffic (``adversarial_trace``) and its
drill runner are ROADMAP §1 items 6 and 10.
"""
from .inject import (KINDS, Fault, FaultInjector, FaultPlan, InjectedFault,
                     active, armed, corrupt_file, fail_point, fire, mangle)

__all__ = ["Fault", "FaultPlan", "FaultInjector", "InjectedFault",
           "armed", "active", "fire", "fail_point", "mangle",
           "corrupt_file", "KINDS"]
