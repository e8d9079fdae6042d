"""Deterministic fault injection for chaos tests: the port's copy of the
JAX package's ``utils/fault_injection.py`` (standard library only), with
the same ``STPU_FAULTS`` grammar, seed and modes, so one spec arms either
package's seams.

    STPU_FAULTS="train.step:kill:skip=4,times=1"

or programmatically in tests::

    from skypilot_tpu_torch.utils import fault_injection as fi
    with fi.inject("ckpt.write", mode="kill"):
        ...

Spec grammar (";"-separated rules): ``point:mode[:k=v[,k=v...]]`` with

    mode   ``raise`` / ``error``  -> raise InjectedFault at the point
           ``delay``              -> sleep ``s`` seconds at the point
           ``kill``               -> SIGKILL the current process at the
                                     point (no cleanup runs)
    p      trigger probability in [0, 1] (default 1.0)
    times  stop firing after this many triggers (default unlimited)
    skip   ignore the first N otherwise-eligible hits (default 0)
    s      delay seconds (``delay`` mode only, default 0.05)

Probabilistic rules draw from one module RNG seeded by
``STPU_FAULTS_SEED`` (default 0), so a chaos run replays identically under
the same spec and seed. ``InjectedFault`` subclasses ``ConnectionError``,
as there.

Call sites guard with the module attribute ``ENABLED`` (``if
fault_injection.ENABLED: fault_injection.fire(...)``), so an unarmed point
costs one global load.

The port's points:

    ckpt.write   train/checkpoint._save_locked, between the payload bytes
                 and the atomic rename (``kill`` leaves the torn .tmp that
                 restore_latest must skip)
    train.step   recipes' training loops, after each optimizer step
                 (``skip=K`` + ``kill``: a crash at a chosen step)
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Dict, Iterator, List, Optional

ENV = "STPU_FAULTS"
SEED_ENV = "STPU_FAULTS_SEED"

# Hot-path guard: True iff at least one rule is armed. Call sites read
# this module attribute before paying for the fire() call.
ENABLED = False


class InjectedFault(ConnectionError):
    """Raised at an armed fault point (see module docstring for why
    this is a ConnectionError)."""


class FaultSpecError(ValueError):
    """Malformed STPU_FAULTS spec."""


class _Rule:
    __slots__ = ("point", "mode", "p", "times", "delay", "skip",
                 "fired", "seen")

    def __init__(self, point: str, mode: str = "raise", p: float = 1.0,
                 times: Optional[int] = None, delay: float = 0.05,
                 skip: int = 0):
        if mode not in ("raise", "error", "delay", "kill"):
            raise FaultSpecError(
                f"{point}: unknown fault mode {mode!r} "
                "(expected raise/error/delay/kill)")
        if not 0.0 <= p <= 1.0:
            raise FaultSpecError(f"{point}: p={p} outside [0, 1]")
        self.point = point
        self.mode = mode
        self.p = float(p)
        self.times = None if times is None else int(times)
        self.delay = float(delay)
        self.skip = int(skip)     # eligible hits ignored before firing
        self.fired = 0            # times this rule actually triggered
        self.seen = 0             # eligible hits (incl. skipped ones)


_lock = threading.Lock()
_rules: Dict[str, _Rule] = {}
_rng = random.Random(0)


def _refresh_enabled() -> None:
    global ENABLED
    ENABLED = bool(_rules)


def parse_spec(spec: str) -> List[_Rule]:
    """Parse an STPU_FAULTS string into rules (see module docstring)."""
    rules: List[_Rule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise FaultSpecError(
                f"fault rule {part!r}: expected point:mode[:k=v,...]")
        point, mode = fields[0].strip(), fields[1].strip()
        kwargs: Dict[str, float] = {}
        if len(fields) > 2:
            for kv in ":".join(fields[2:]).split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise FaultSpecError(
                        f"fault rule {part!r}: bad param {kv!r}")
                k, v = kv.split("=", 1)
                k = k.strip()
                if k not in ("p", "times", "s", "skip"):
                    raise FaultSpecError(
                        f"fault rule {part!r}: unknown param {k!r}")
                try:
                    kwargs[k] = float(v)
                except ValueError as e:
                    raise FaultSpecError(
                        f"fault rule {part!r}: {k}={v!r} not numeric"
                    ) from e
        rules.append(_Rule(
            point, mode, p=kwargs.get("p", 1.0),
            times=(int(kwargs["times"]) if "times" in kwargs else None),
            delay=kwargs.get("s", 0.05),
            skip=int(kwargs.get("skip", 0))))
    return rules


def configure(spec: str, seed: Optional[int] = None) -> None:
    """Replace all armed rules with the parsed ``spec`` and reseed the
    RNG (``seed`` falls back to STPU_FAULTS_SEED, then 0)."""
    rules = parse_spec(spec)
    if seed is None:
        seed = int(os.environ.get(SEED_ENV, "0"))
    with _lock:
        _rules.clear()
        for rule in rules:
            _rules[rule.point] = rule
        _rng.seed(seed)
        _refresh_enabled()


def activate(point: str, mode: str = "raise", p: float = 1.0,
             times: Optional[int] = None, delay: float = 0.05,
             skip: int = 0) -> None:
    """Arm one fault point programmatically (tests)."""
    rule = _Rule(point, mode, p=p, times=times, delay=delay, skip=skip)
    with _lock:
        _rules[point] = rule
        _refresh_enabled()


def deactivate(point: str) -> None:
    with _lock:
        _rules.pop(point, None)
        _refresh_enabled()


def clear() -> None:
    """Disarm every fault point (tests MUST call this in teardown)."""
    with _lock:
        _rules.clear()
        _refresh_enabled()


def fires(point: str) -> int:
    """How many times ``point``'s rule has actually triggered."""
    with _lock:
        rule = _rules.get(point)
        return rule.fired if rule is not None else 0


@contextlib.contextmanager
def inject(point: str, mode: str = "raise", p: float = 1.0,
           times: Optional[int] = None, delay: float = 0.05,
           skip: int = 0) -> Iterator[None]:
    """Arm ``point`` for the duration of the with-block."""
    activate(point, mode=mode, p=p, times=times, delay=delay, skip=skip)
    try:
        yield
    finally:
        deactivate(point)


def fire(point: str, **context) -> None:
    """Trigger ``point`` if armed: raises InjectedFault (raise/error
    mode) or sleeps (delay mode). ``context`` (e.g. the upstream url)
    lands in the fault message for chaos-log readability. No-op when
    the point is unarmed, over its ``times`` budget, or loses the
    probability roll."""
    with _lock:
        rule = _rules.get(point)
        if rule is None:
            return
        if rule.times is not None and rule.fired >= rule.times:
            return
        if rule.p < 1.0 and _rng.random() >= rule.p:
            return
        rule.seen += 1
        if rule.seen <= rule.skip:
            return
        rule.fired += 1
        mode, delay = rule.mode, rule.delay
    if mode == "delay":
        import time
        time.sleep(delay)
        return
    if mode == "kill":
        # Crash chaos: die the way a preempted host dies — instantly,
        # with no chance to flush or clean up.
        import signal
        os.kill(os.getpid(), signal.SIGKILL)
        return  # unreachable; kill is synchronous on this thread
    detail = "".join(f" {k}={v}" for k, v in sorted(context.items()))
    raise InjectedFault(f"injected fault at {point}{detail}")


# Arm from the environment at import: operators export STPU_FAULTS for
# a game day and every process in the serving stack picks it up.
if os.environ.get(ENV):
    configure(os.environ[ENV])
