"""Launch accounting shared by the kernel wrappers.

Each wrapper keeps a ``launch_counts`` dict and calls :func:`count` where
it launches its kernel.  Outside stream capture that adds one to the
wrapper's count: the kernel runs now.  While a CUDA graph is captured
nothing runs; the launch goes into the tally of the open
:func:`recording` instead, and each replay of the graph adds that tally
back through :func:`replayed`.  So a count says what the card ran,
whether it ran eagerly or inside graphs, and a capture with no recording
open (a timing graph, say) counts nothing.
"""
from __future__ import annotations

import contextlib

import torch

_owners: dict[str, dict] = {}     # kernel name -> the dict that counts it
_open: list[dict[str, int]] = []  # tallies of the recordings in progress


def count(counts: dict, name: str) -> None:
    """One launch of kernel ``name``, whose count ``counts`` holds."""
    _owners[name] = counts
    if torch.cuda.is_current_stream_capturing():
        if _open:
            _open[-1][name] = _open[-1].get(name, 0) + 1
    else:
        counts[name] += 1


@contextlib.contextmanager
def recording():
    """Collect the launches captured inside the block into the yielded
    dict (kernel name -> launches), instead of counting them now."""
    tally: dict[str, int] = {}
    _open.append(tally)
    try:
        yield tally
    finally:
        _open.pop()


def replayed(tally: dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    for name, n in tally.items():
        _owners[name][name] += n
