"""Shared figure plumbing: CSV row emission + paper-anchor comparison,
a copy of the repository's ``benchmarks/common.py``."""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Row:
    name: str
    us_per_call: float          # modeled execution time (us) where relevant
    derived: str                # the figure's metric (speedup etc.)

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.3f},{self.derived}"


class Table:
    """Collects rows for one paper table/figure and prints CSV."""

    def __init__(self, title: str):
        self.title = title
        self.rows: list[Row] = []
        self._t0 = time.perf_counter()

    def add(self, name: str, time_ns: float, derived: str) -> None:
        self.rows.append(Row(name, time_ns / 1e3, derived))

    def anchor(self, name: str, value: float, paper: float | str,
               time_ns: float = 0.0) -> None:
        if isinstance(paper, (int, float)):
            delta = (value / paper - 1.0) * 100.0
            derived = f"{value:.2f}x (paper {paper}x, {delta:+.0f}%)"
        else:
            derived = f"{value:.2f}x (paper: {paper})"
        self.add(name, time_ns, derived)

    def emit(self) -> None:
        dt = time.perf_counter() - self._t0
        print(f"# {self.title}  [{dt:.1f}s]")
        print("name,us_per_call,derived")
        for row in self.rows:
            print(row.csv())
        print()
