"""The hook through which the model's parts reach a serving tracer.

The model's forward marks its parts (``attn``, ``attn.core``, ``mlp``,
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.shared``, and the join's ``readout``) with ``with part(name):``.
Nothing records them unless a recorder is armed: the serving batcher arms
its :class:`~repro_torch.serve.telemetry.Tracer`'s ``part`` around a traced
join, and only there.  Unarmed, ``part`` returns one shared
``nullcontext``, so a decode graph's capture, training and untraced
serving pay one global read a call.

This module imports nothing of ``repro_torch``: ``models`` imports it, and
``models`` must not import ``serve`` (``serve/__init__`` imports the
scheduler, which imports the models).  The armed recorder is one per
process, as the batcher runs its rounds on one thread.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

NULL = nullcontext()      # reusable: it keeps no state between uses
_recorder = None          # name -> context manager, or None (unarmed)


def part(name: str):
    """The context of one part of the model's forward: the armed
    recorder's, or the shared null context."""
    rec = _recorder
    return NULL if rec is None else rec(name)


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
