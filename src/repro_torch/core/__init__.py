"""The paper's core, ported from :mod:`repro.core`.

The functional part of the primitives (:mod:`.primitives`), the hardware
specifications (:mod:`.hwspec`: the paper's simulated PIM and GPU, and
the H100 the port runs on) and the PIM-amenability test
(:mod:`.amenability`); the timing simulator and the planner are not
ported yet.  Nothing here imports ``repro``.
"""
