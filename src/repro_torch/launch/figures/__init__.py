"""The paper's figure drivers, from the repository's ``benchmarks/``: one
module a table, each ``run()`` returning the dict JAX's returns, plus
``kernel_bench`` (the ported kernels' skip structure, on the card) and
``run`` (``python -m repro_torch.launch.figures.run [--fast]``)."""
