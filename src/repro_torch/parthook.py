"""The hook through which the model's parts reach a serving tracer.

The model's forward marks its parts (``attn``, ``attn.core``, ``mlp``,
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.shared``, and the join's ``readout``) with ``with part(name):``,
and counts on the device with ``count(name, fn)``.  Nothing records them
unless a recorder is armed: the serving batcher arms its
:class:`~repro_torch.serve.telemetry.Tracer`'s ``part`` around a traced
join, and its ``count`` around every traced join and decode segment (a
captured decode graph replays the counts it captured).  Unarmed, ``part``
returns one shared ``nullcontext`` and ``count`` does nothing, so a
decode graph's capture, training and untraced serving pay one global
read a call.

This module imports nothing of ``repro_torch``: ``models`` imports it, and
``models`` must not import ``serve`` (``serve/__init__`` imports the
scheduler, which imports the models).  The armed recorders are one per
process, as the batcher runs its rounds on one thread.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

NULL = nullcontext()      # reusable: it keeps no state between uses
_recorder = None          # name -> context manager, or None (unarmed)
_counter = None           # (name, hits, total) -> None, or None (unarmed)


def part(name: str):
    """The context of one part of the model's forward: the armed
    recorder's, or the shared null context."""
    rec = _recorder
    return NULL if rec is None else rec(name)


def count(name: str, fn) -> None:
    """Add ``fn()``'s (hits, total), device tensors or ints, to the armed
    counter's ``name``; ``fn`` runs only when a counter is armed."""
    rec = _counter
    if rec is not None:
        rec(name, *fn())


@contextmanager
def armed(recorder):
    """Arm ``recorder`` (``name -> context manager``) for the body, and
    restore the previous one after it."""
    global _recorder
    prev, _recorder = _recorder, recorder
    try:
        yield
    finally:
        _recorder = prev


@contextmanager
def counting(counter):
    """Arm ``counter`` (``(name, hits, total) -> None``) for the body, and
    restore the previous one after it."""
    global _counter
    prev, _counter = _counter, counter
    try:
        yield
    finally:
        _counter = prev
