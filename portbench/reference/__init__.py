"""The plain references: one module a family of layer kinds.

A configuration names its reference by the top-level ``"reference"`` key
of ``configs/<config>.json`` (default ``model``); ``spec.reference``
loads ``reference/<name>.py`` by file and ``spec.Cell.reference`` holds
it.  Every module here keeps this contract:

- ``forward(weights, port, seqs, *, score_from, fp8)`` runs float32
  causal forwards of the token lists ``seqs`` on the weights the
  benchmark made (the port's layout), the configuration's ``port`` block
  giving the sizes, and yields ``(i, at, logits)``: sequence ``i``'s
  logits [n, vocab] at positions ``at`` to ``at + n - 1``, every position
  from ``score_from[i]`` to the end, in order.  ``fp8=True`` is the
  control: the same forward one precision below the served one (every
  projection's operands rounded to float8 e4m3);
- ``COVERS`` is a dict naming what the module computes: ``"attn"`` (the
  ``attn`` values), ``"segments"`` (the segment kinds) and
  ``"activation"`` (the activations), each a list; a cell's ``port``
  block has to lie inside its reference's ``COVERS``
  (``test_portbench_reference.py``);
- it imports neither the port (``repro_torch``) nor JAX nor the JAX
  package, and takes nothing the program made: it works positions,
  tables, masks and routing out itself
  (``test_portbench_isolation.py``).
"""
