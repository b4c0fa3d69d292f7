"""Hardware specifications, from :mod:`repro.core.hwspec`.

Two families of constants live here:

1. ``PimSpec`` / ``GpuSpec`` — the commercial-PIM strawman and the GPU+HBM3
   baseline from the paper (Tables 1 and 2), copied unchanged.  The
   amenability test (:mod:`.amenability`) reads them.

2. ``HopperSpec`` — the card the port runs on, an NVIDIA H100 SXM, in
   place of the JAX module's TPU constants: what the paged-attention
   autotuner (:mod:`repro_torch.kernels.paged_attn.autotune`) checks a
   launch against and scores it with, and whose ridge the offload
   planner (:mod:`.planner`) derates by.

All times are nanoseconds, all bandwidths are bytes/ns (== GB/s), all sizes
bytes, matching Table 2 of the paper.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PimSpec:
    """Strawman commercial-PIM design (HBM-PIM-leaning), paper Table 2.

    The derived properties reproduce the paper's bandwidth story:

    * regular HBM access: one 32 B column word per ``tccds`` per pseudo
      channel -> 32 pCH * 32 B / 1.667 ns = 614.4 GB/s peak (Table 2).
    * broadcast pim-command: issued once per ``tccdl`` (half the regular
      rate, footnote 3), executed by the 8 PIM units of one even/odd bank
      subset -> 8 * 32 B / 3.333 ns = 76.8 GB/s per pCH = 2457.6 GB/s per
      stack = 4x the external peak — the paper's "about 4x" upper bound.
    """

    # --- DRAM geometry (Table 2) ---
    banks_per_pch: int = 16
    banks_per_stack: int = 512
    row_buffer_bytes: int = 1024          # per bank
    dram_word_bytes: int = 32             # one column access / SIMD word
    # --- DRAM timing (Table 2) ---
    t_rp_ns: float = 15.0                 # precharge
    t_ras_ns: float = 33.0                # min row-open time
    t_ccdl_ns: float = 10.0 / 3.0         # 3.33 ns: same-bank-group CAS gap
    t_rcd_ns: float = 15.0                # activate-to-access (not in Table 2;
                                          # standard HBM3-class value, = tRP)
    # --- PIM resources (Table 2) ---
    pim_units_per_stack: int = 256        # one ALU per bank *pair*
    pim_regs_per_alu: int = 16            # 256 b (= 32 B) each
    simd_lanes: int = 16                  # 256 b / 16 b
    # --- External interface (Table 2) ---
    peak_hbm_gbps: float = 614.4          # GB/s per stack
    # --- knobs for the §5.1.4 limit studies ---
    command_bw_mult: float = 1.0          # extra command bus capacity for
                                          # data-less single-bank commands

    # ---------------- derived ----------------
    @property
    def pch_per_stack(self) -> int:
        return self.banks_per_stack // self.banks_per_pch

    @property
    def t_ccds_ns(self) -> float:
        """Min gap between regular column commands (different bank group)."""
        return self.t_ccdl_ns / 2.0

    @property
    def banks_per_subset(self) -> int:
        """Banks driven by one broadcast pim-command (even OR odd half)."""
        return self.banks_per_pch // 2

    @property
    def cols_per_row(self) -> int:
        return self.row_buffer_bytes // self.dram_word_bytes

    @property
    def broadcast_bytes_per_cmd(self) -> int:
        """Bytes touched by one broadcast pim-command in one pCH."""
        return self.banks_per_subset * self.dram_word_bytes

    @property
    def pim_peak_gbps(self) -> float:
        """PIM data bandwidth per stack (Table 1: ~1229 GB/s for HBM-PIM at
        1.2 GHz; our strawman runs HBM3 timing so it lands at 4x ext-peak)."""
        per_pch = self.broadcast_bytes_per_cmd / self.t_ccdl_ns
        return per_pch * self.pch_per_stack

    @property
    def regular_bytes_per_ns_per_pch(self) -> float:
        return self.dram_word_bytes / self.t_ccds_ns

    @property
    def row_cycle_ns(self) -> float:
        """tRC: min time between activations of the same bank."""
        return self.t_ras_ns + self.t_rp_ns

    @property
    def row_switch_ns(self) -> float:
        """Critical-path cost of moving an open row to a new row once tRAS
        has elapsed: precharge + activate-to-data."""
        return self.t_rp_ns + self.t_rcd_ns


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """GPU + HBM3 baseline (paper §4.3.1).

    Execution time is bandwidth-only: ``bytes / (efficiency * peak)`` with
    perfect on-chip reuse except where the paper says otherwise (wavesim
    inter-timestep, push cache hit rates, ss-gemm row sparsity).
    """

    peak_hbm_gbps: float = 614.4
    bw_efficiency: float = 0.90           # "assumed to be 90% of peak"
    cache_line_bytes: int = 64
    l2_capacity_bytes: int = 4 * 1024 * 1024   # cache model: 4 MiB
    l2_ways: int = 16                          # 16-way LRU
    reduced_access_bytes: int = 32        # cache-aware GPU: 32 B accesses

    @property
    def effective_gbps(self) -> float:
        return self.peak_hbm_gbps * self.bw_efficiency


@dataclasses.dataclass(frozen=True)
class HopperSpec:
    """NVIDIA H100 SXM constants for the autotuner's feasibility check and
    analytic score, and the roofline's per-device terms
    (:mod:`repro_torch.roofline.analysis`).  Every number is the H100 SXM
    data sheet's (dense rates, at the card's full 700 W power limit),
    except ``sms``, which :meth:`for_device` reads from the card.

    The NVLink fields are the data sheet's 18 NVLink-4 links of 25 GB/s
    each way, 450 GB/s a direction in all.  The roofline's collective term
    divides a device's collective bytes by that rate: a lower bound that
    assumes NVLink between every pair of ranks, which holds within one
    NVSwitch domain and not across the 256 or 512 ranks of the production
    meshes (their cross-host links are slower)."""

    sms: int = 132                        # data sheet; for_device reads it
    smem_per_cta: int = 227 * 1024        # dynamic shared memory a CTA
    max_cluster: int = 8                  # portable thread-block cluster
    hbm_gbps: float = 3350.0              # 3.35 TB/s HBM3
    peak_bf16_tflops: float = 989.0       # tensor cores, dense
    peak_fp32_tflops: float = 67.0        # outside the tensor cores
    nvlink_links: int = 18                # NVLink 4
    nvlink_link_gbps: float = 25.0        # each way, a link

    @property
    def nvlink_gbps(self) -> float:
        """All links, one direction: 450 GB/s."""
        return self.nvlink_links * self.nvlink_link_gbps

    def peak_flops_per_ns(self, dtype_name: str) -> float:
        """The peak for ``dtype_name`` ("bfloat16" or "float32"), FLOP/ns:
        the rates ``chip_smoke.py``'s bounds use."""
        tflops = {"bfloat16": self.peak_bf16_tflops,
                  "float32": self.peak_fp32_tflops}[dtype_name]
        return tflops * 1e3

    @property
    def ridge_op_byte(self) -> float:
        """Arithmetic intensity at the bf16 compute/memory ridge point,
        FLOP per HBM byte (about 295.2)."""
        return self.peak_flops_per_ns("bfloat16") / self.hbm_gbps

    @classmethod
    def for_device(cls, device) -> "HopperSpec":
        """The data-sheet spec with the SM count of the CUDA ``device``
        (:func:`repro_torch.device.sm_count`)."""
        from ..device import sm_count
        return cls(sms=sm_count(device))


DEFAULT_PIM = PimSpec()
DEFAULT_GPU = GpuSpec()
DEFAULT_HOPPER = HopperSpec()
