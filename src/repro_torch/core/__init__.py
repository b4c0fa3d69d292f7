"""The paper's core, ported from :mod:`repro.core`.

So far only the functional part of the primitives (:mod:`.primitives`);
the timing simulator, the amenability test and the planner are not ported
yet.  Nothing here imports ``repro``.
"""
