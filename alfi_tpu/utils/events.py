"""Lightweight event timing registry.

JAX-native stand-in for PETSc's event logging
(/root/reference/alfi/driver.py:77-92,
/root/reference/alfi/transfer.py:186-192 @timed_function): named
wall-clock accumulators around device computations (timers call
``block_until_ready`` on outputs so XLA async dispatch doesn't hide the
cost).  Event names mirror the reference's so reports stay comparable
(SNESSolve, KSPSolve, PCApply, PCPATCHSolve, SchoeberlProlong, ...).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import jax

EVENTS: dict = defaultdict(lambda: {"time": 0.0, "count": 0})

# event names whose cold (first) call was already attributed elsewhere
_WARMED: set = set()


def reset():
    EVENTS.clear()
    _WARMED.clear()


@contextmanager
def timed_region(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ev = EVENTS[name]
        ev["time"] += dt
        ev["count"] += 1


def timed_function(name, first_to=None):
    """Accumulate wall-clock under ``name``.  With ``first_to``, the
    FIRST-ever recorded call of ``name`` is attributed to that event
    instead (e.g. "JITWarmup"): the first invocation of a jitted solver
    step carries the XLA trace+compile, which is a one-off setup cost —
    folding it into a per-iteration event makes the event 10-100x wrong
    on backends where compile dominates (the CPU test meshes), which is
    exactly what the micro_events consistency ratio guards against."""

    def deco(fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            out = jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            target = name
            if first_to is not None and name not in _WARMED:
                _WARMED.add(name)
                target = first_to
            ev = EVENTS[target]
            ev["time"] += dt
            ev["count"] += 1
            return out

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    return deco
