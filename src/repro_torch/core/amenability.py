"""PIM-amenability-test (paper §3), from :mod:`repro.core.amenability`.

Four characteristics, each with the paper's heuristic:

  A. *Memory bandwidth limited* — low algorithmic op/byte (below the target
     architecture's roofline ridge).
  B. *Memory residency and low on-chip reuse* — ratio of physical-memory
     accesses to on-chip-structure accesses exceeds the PIM bandwidth
     multiplier (otherwise the cache/registers win).
  C. *Operand locality* — interacting operands map (or can be mapped) to the
     same bank: single-operand, commutative-reduction, or localized
     multi-operand interaction.
  D. *Aligned data parallelism* — interacting operands sit at the same
     row/column address across banks and align within the 256-bit SIMD word
     (achievable via interleave-aware allocation).

The verdict is holistic (§3.1): a weak characteristic does not necessarily
veto PIM (optimizations may recover it) and a single strong one does not
guarantee acceleration.  The report records each characteristic, the
heuristic evidence, and an overall grade used by the offload planner.
"""
from __future__ import annotations

import dataclasses
import enum

from .hwspec import GpuSpec, PimSpec


class Interaction(enum.Enum):
    """Operand-interaction classes from §3.1.3."""

    SINGLE_OPERAND = "single-operand"        # in-place updates: trivial
    REDUCTION = "commutative-reduction"      # same-bank-first: trivial
    LOCALIZED = "localized-multi-operand"    # e.g. elementwise: co-align
    INDUCIBLE = "inducible-via-mapping"      # e.g. matrix packing for GEMV
    IRREGULAR = "irregular"                  # e.g. graph neighbors


class Verdict(enum.Enum):
    AMENABLE = "amenable"
    CONDITIONAL = "conditional"   # amenable with optimizations / care
    NOT_AMENABLE = "not-amenable"


@dataclasses.dataclass(frozen=True)
class PrimitiveProfile:
    """Inputs to the test, as a programmer would characterize a primitive."""

    name: str
    ops: float                       # algorithmic operations
    mem_bytes: float                 # bytes that must come from DRAM
    onchip_bytes: float              # bytes served by caches/registers
    interaction: Interaction
    alignable: bool                  # can allocation co-align operands?
    input_dependent_locality: bool = False   # push / ss-gemm style
    notes: str = ""

    @property
    def op_byte(self) -> float:
        total = self.mem_bytes + self.onchip_bytes
        return self.ops / total if total else float("inf")

    @property
    def mem_ratio(self) -> float:
        if self.onchip_bytes == 0:
            return float("inf")
        return self.mem_bytes / self.onchip_bytes


@dataclasses.dataclass(frozen=True)
class Characteristic:
    name: str
    passed: bool
    evidence: str


@dataclasses.dataclass(frozen=True)
class AmenabilityReport:
    profile: PrimitiveProfile
    characteristics: tuple[Characteristic, ...]
    verdict: Verdict
    guidance: str

    def summary(self) -> str:
        rows = [f"PIM-amenability: {self.profile.name} -> {self.verdict.value}"]
        for c in self.characteristics:
            rows.append(f"  [{'x' if c.passed else ' '}] {c.name}: {c.evidence}")
        rows.append(f"  guidance: {self.guidance}")
        return "\n".join(rows)


def pim_bandwidth_multiplier(pim: PimSpec, gpu: GpuSpec) -> float:
    """How much more bandwidth PIM offers over the processor's view."""
    return pim.pim_peak_gbps / gpu.effective_gbps


def run_test(profile: PrimitiveProfile, pim: PimSpec | None = None,
             gpu: GpuSpec | None = None) -> AmenabilityReport:
    pim = pim or PimSpec()
    gpu = gpu or GpuSpec()
    mult = pim_bandwidth_multiplier(pim, gpu)
    # ridge point of the *baseline* machine: ops/ns over bytes/ns.  A GPU
    # stack paired with one HBM3 device: Table 1 gives 45 TFLOP16/stack.
    ridge = 45e3 / gpu.effective_gbps     # FLOP/ns / B/ns ~ 81 op/B

    a = Characteristic(
        "memory-bandwidth-limited (low op/byte)",
        profile.op_byte < ridge,
        f"op/byte={profile.op_byte:.2f} vs ridge~{ridge:.0f}",
    )
    b = Characteristic(
        "memory-resident, low on-chip reuse",
        profile.mem_ratio > mult,
        f"mem/on-chip={profile.mem_ratio:.2f} vs PIM multiplier {mult:.2f}",
    )
    c_pass = profile.interaction in (Interaction.SINGLE_OPERAND,
                                     Interaction.REDUCTION,
                                     Interaction.LOCALIZED,
                                     Interaction.INDUCIBLE)
    c = Characteristic(
        "operand locality",
        c_pass,
        f"interaction={profile.interaction.value}",
    )
    d = Characteristic(
        "aligned data parallelism",
        profile.alignable,
        "interleave-aware allocation possible" if profile.alignable
        else "irregular addressing precludes alignment",
    )
    chars = (a, b, c, d)
    n_pass = sum(ch.passed for ch in chars)

    if not a.passed:
        verdict = Verdict.NOT_AMENABLE
        guidance = ("compute-bound: PIM's bandwidth amplification cannot "
                    "help; keep on the processor")
    elif n_pass == 4 and not profile.input_dependent_locality:
        verdict = Verdict.AMENABLE
        guidance = ("offload wholesale; co-align operands at allocation and "
                    "stage open rows through pim-registers")
    elif n_pass >= 2:
        verdict = Verdict.CONDITIONAL
        hints = []
        if not b.passed:
            hints.append("reuse favors the cache: use cache-aware selective "
                         "offload (§5.1.3)")
        if profile.interaction is Interaction.INDUCIBLE:
            hints.append("induce locality via data mapping (blocked layout, "
                         "§4.2.4) and factor the mapping cost in")
        if profile.interaction is Interaction.IRREGULAR:
            hints.append("fall back to single-bank pim-commands; expect "
                         "command-bandwidth limits (§5.1.4)")
        if not d.passed:
            hints.append("broadcast commands unavailable; single-bank "
                         "orchestration only")
        if profile.input_dependent_locality:
            hints.append("locality is input-dependent: gate the offload with "
                         "a locality predictor (§5.1.3)")
        guidance = "; ".join(hints) or "offload with careful orchestration"
    else:
        verdict = Verdict.NOT_AMENABLE
        guidance = "too few PIM-amenable characteristics; keep on processor"
    return AmenabilityReport(profile=profile, characteristics=chars,
                             verdict=verdict, guidance=guidance)
