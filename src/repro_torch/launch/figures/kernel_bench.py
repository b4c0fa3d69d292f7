"""Kernel micro-bench, from ``benchmarks/kernel_bench.py``: the structural
speedup the sparsity-aware kernels deliver (blocks and tiles skipped, the
GPU analogue of the paper's commands skipped), on the port's kernels.

* ss-gemm skip granularity, the paper's own §5.1.2 argument made
  quantitative: PIM skips at *element* granularity (one command per 32 B
  word), a GPU kernel at *block* granularity.  Random element sparsity
  therefore skips ~0 blocks of 256 rows, while structured sparsity
  (pruned blocks, clustered embedding-bag rows) skips in proportion.  The
  two B matrices are the JAX bench's (same seed, same draws);
  ``block_occupancy`` runs on ``device`` and ``ssgemm_masked`` multiplies
  a seeded A of ``Problem()``'s M by each.
* MoE expert-tile occupancy at decode batch sizes: deepseek-v3's routing
  draws (E 256, top-8, T 128 and 4,096; the JAX bench's) with its
  capacity, run through ``group_gemm`` at the full expert width (D 7,168,
  F 2,048, bf16: 7.5 GB of w) on the card, which counts the tiles it ran
  and skipped (``group_gemm_cuda(tiles=)``); they must equal the port's
  tiling rule (``kernel.tile_counts``).  Each row also carries the JAX
  bench's count of live 128-row tiles.

``--device`` defaults to ``cuda`` and raises without a GPU; ``--device
cpu`` runs the plain versions (no tile count from a kernel) and takes
``--m`` and ``--expert-width`` to stay small.

  PYTHONPATH=src python -m repro_torch.launch.figures.kernel_bench
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ...configs import get_config
from ...core.primitives import ss_gemm
from ...device import resolve_device
from .common import Table

K, N, BK = 4096, 4, 256
MOE_ARCH = "deepseek-v3-671b"
TOKENS = (128, 4096)
JAX_BC = 128                 # the JAX kernel's capacity rows a tile


def skinny_pair(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """The JAX bench's random and clustered 45%-dense B [4096, 4] float32,
    drawn in its order."""
    b_rand = rng.standard_normal((K, N)).astype(np.float32)
    b_rand[rng.random(K) > 0.45] = 0.0
    b_clu = rng.standard_normal((K, N)).astype(np.float32)
    live_blocks = rng.random(K // BK) < 0.45
    b_clu[~np.repeat(live_blocks, BK)] = 0.0
    return {"random": b_rand, "clustered": b_clu}


def moe_counts(rng: np.random.Generator, tokens: int, n_experts: int,
               top_k: int) -> tuple[np.ndarray, int]:
    """The JAX bench's per-expert token counts and capacity for
    ``tokens`` (its draw, its capacity factor 1.25)."""
    assign = rng.integers(0, n_experts, size=(tokens, top_k))
    counts = np.bincount(assign.reshape(-1), minlength=n_experts)
    cap = max(1, int(tokens * top_k * 1.25 / n_experts))
    return counts, cap


def run(device: str | torch.device = "cuda", *, m: int | None = None,
        expert_width: tuple[int, int] | None = None,
        table: Table | None = None) -> dict:
    """Emit the table; return, for each B (``ss_gemm``), its occupancy,
    the skipped share, A, B and the masked product, and for each T
    (``moe``), the counts, capacity, the JAX bench's live and total
    128-row tiles, ``tile_counts`` and the kernel's own (total, skipped)
    count (None off the card)."""
    from ...kernels.moe_group_gemm import group_gemm, kernel as group_kernel
    from ...kernels.ss_gemm import block_occupancy, ssgemm_masked

    dev = resolve_device(device)
    t = table or Table("Kernels — sparsity-aware block and tile skipping")
    rng = np.random.default_rng(0)
    m = ss_gemm.Problem().m if m is None else m
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
    out: dict = {"ss_gemm": {}, "moe": {}}
    notes = {"random": "element-granular skip is PIM-unique — the paper's "
                       "finer-grain-than-GPU claim",
             "clustered": "structured sparsity: the kernel's block-skip "
                          "regime"}
    for kind, b_np in skinny_pair(rng).items():
        b = torch.from_numpy(b_np).to(dev).to(torch.bfloat16)
        occ = block_occupancy(b, BK)
        prod = ssgemm_masked(a, b, bk=BK)
        err = float((prod.double() - ss_gemm.reference(
            a, b, dtype=torch.float64)).abs().max())
        skipped = 1.0 - float(occ.float().mean())
        out["ss_gemm"][kind] = {"occupancy": occ.cpu().numpy(),
                                "skipped_frac": skipped, "a": a, "b": b,
                                "out": prod, "max_abs_err": err}
        t.add(f"ss-gemm {kind} 45%-dense, bk={BK}", 0.0,
              f"{skipped:.0%} tiles skipped ({notes[kind]})")
        t.add(f"ssgemm_masked {kind} (M={m} K={K} N={N} bf16, "
              f"{dev.type})", 0.0,
              f"{int(occ.sum())}/{occ.shape[0]} blocks walked; max |err| "
              f"vs the float64 product {err:.2e}")

    cfg = get_config(MOE_ARCH)
    moe = cfg.moe
    d, f = expert_width or (cfg.d_model, moe.d_ff_expert)
    w = torch.randn(moe.n_experts, d, f, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for tokens in TOKENS:
        counts_np, cap = moe_counts(rng, tokens, moe.n_experts, moe.top_k)
        per = -(-cap // JAX_BC)
        jax_tiles = per * moe.n_experts
        jax_live = sum(min(-(-int(c) // JAX_BC), per) for c in counts_np)
        t.add(f"moe-group-gemm tiles live (T={tokens}, 256e top-8)", 0.0,
              f"{jax_live}/{jax_tiles} tiles computed "
              f"({1 - jax_live / jax_tiles:.0%} skipped)")
        counts = torch.from_numpy(counts_np).to(dev, torch.int32)
        xe = torch.randn(moe.n_experts, cap, d, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        rule = group_kernel.tile_counts(counts, cap, f, torch.bfloat16)
        if dev.type == "cuda":
            tiles = torch.zeros(2, dtype=torch.int32, device=dev)
            group_kernel.group_gemm_cuda(xe, w, counts, tiles=tiles)
            ran = tuple(int(x) for x in tiles.cpu())
            if ran != rule:
                raise RuntimeError(
                    f"group_gemm counted (tiles, skipped) {ran} at T "
                    f"{tokens}, the tiling rule gives {rule}")
            where = f"{ran[0] - ran[1]}/{ran[0]} tiles run on the card"
        else:
            group_gemm(xe, w, counts)
            ran = None
            where = "plain version on the cpu, no tile count"
        out["moe"][tokens] = {"counts": counts_np, "cap": cap,
                              "jax_live": jax_live, "jax_tiles": jax_tiles,
                              "tile_counts": rule, "kernel_tiles": ran}
        t.add(f"group_gemm tiles (T={tokens}, C {cap}, D {d}, F {f}, bf16)",
              0.0, f"{where}; tile_counts {rule[0] - rule[1]}/{rule[0]} "
              f"({group_kernel.tile_rows(cap, torch.bfloat16)} x "
              f"{group_kernel.tile_cols(cap, torch.bfloat16)} tiles)")
    if table is None:
        t.emit()
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--m", type=int, default=None,
                    help="rows of A (default Problem()'s 16,384)")
    ap.add_argument("--expert-width", type=int, nargs=2, default=None,
                    metavar=("D", "F"),
                    help="expert width (default deepseek-v3's 7168 2048)")
    args = ap.parse_args(argv)
    return run(args.device, m=args.m,
               expert_width=tuple(args.expert_width)
               if args.expert_width else None)


if __name__ == "__main__":
    main()
