"""The paper's core, ported from :mod:`repro.core`: Inclusive-PIM as an
executable model.

- PIM-amenability-test (§3): :mod:`.amenability`
- pim-command IR + DRAM timing engine (§4.3.1): :mod:`.commands`,
  :mod:`.timing`
- GPU baseline + cache models (§4.3.1, §5.2.3): :mod:`.gpu_model`,
  :mod:`.cache_model`
- placement + schedules + optimizations (§4.2, §5.1): :mod:`.placement`,
  :mod:`.optimizations`
- the functional PIM machine (§4.2.2): :mod:`.functional_sim`
- primitives under study (§2.3), their data, oracles and models:
  :mod:`.primitives`
- per-op offload planner for LM steps: :mod:`.planner`
- hardware specifications (:mod:`.hwspec`): the paper's simulated PIM and
  GPU, and the H100 the port runs on.

All of it is host arithmetic in Python and numpy, equal to the JAX
package's bit for bit; the figure drivers are under
:mod:`repro_torch.launch.figures`.  Nothing here imports ``repro``.
"""
