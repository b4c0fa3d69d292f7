"""What the wavesim-volume kernel compiles to: registers, spills, CTAs an
SM, and the machine code of its multiply-add runs.

  python -m repro_torch.launch.sass_check [--src volume.cu] [--stages 3]

Needs the CUDA toolkit (``nvcc`` and ``cuobjdump``, found under PyTorch's
``CUDA_HOME``, or Triton's copy of ``cuobjdump``), not a card.  It
compiles ``--src`` (by default the port's ``volume.cu``, which includes no
PyTorch header) for ``sm_90a`` with ``-Xptxas -v`` into a cubin in a
temporary directory, reads each kernel's registers, stack and spills from
ptxas, works out the CTAs an SM that follow from them, the kernel's 256
threads and its shared memory (static, as ptxas reports it, plus the ring
of ``--stages`` tiles that the kernel asks for at launch; ``--stages 0``
for a kernel with static shared memory only), then disassembles the cubin
with ``cuobjdump -sass``.  A *product run* is a stretch of the code whose
FFMA instructions lie at most ``GAP`` instructions apart; for each run it
counts the FFMAs, those that take their weight from the constant bank
either directly (``c[0x0][...]``) or through a uniform register (``URn``,
filled from the constant bank by a ULDC on the uniform datapath), and
the ULDC, LDC, LDL and STL instructions inside it.  The last line is a
JSON report.  ``chip_smoke.py`` calls :func:`report` and
:func:`stencil_loop_ok` on the port's kernel.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import tempfile

GAP = 48                      # instructions between FFMAs of one run
THREADS = 256                 # the kernel's CTA
REGS_PER_SM = 65536
WARPS_PER_SM = 64
CTAS_PER_SM_MAX = 32
SMEM_PER_SM = 233472          # 228 KB, of which a CTA may use 227 KB
SMEM_RESERVED = 1024          # the system's share of each CTA's
ITEMSIZE = {"float": 4, "bf16": 2}

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_FUNC = re.compile(r"Function : (\w+)")
_CONSTANT = re.compile(r"c\[0x0\]|\bUR\d+")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"(.*?);")


def tool(name: str) -> str:
    """Path of a CUDA tool: PyTorch's CUDA_HOME first, then PATH, then
    (for cuobjdump) the copy that Triton ships."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / name).exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / name)
    found = shutil.which(name)
    if found:
        return found
    try:
        import triton
        path = (pathlib.Path(triton.__file__).parent / "backends" /
                "nvidia" / "bin" / name)
        if path.exists():
            return str(path)
    except ImportError:
        pass
    raise FileNotFoundError(f"no {name}: the CUDA toolkit is needed")


def dtype_of(func: str) -> str:
    """The kernel's element type from its mangled name."""
    return "bf16" if "bfloat16" in func else "float"


def ctas_per_sm(regs: int, smem: int, threads: int = THREADS
                ) -> tuple[int, str]:
    """Resident CTAs an SM for ``regs`` registers a thread and ``smem``
    bytes of shared memory a CTA, and what limits them (registers are
    given out per warp in units of 256)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    limits = {"registers": REGS_PER_SM // per_warp // warps,
              "threads": WARPS_PER_SM // warps,
              "shared memory": (SMEM_PER_SM // (smem + SMEM_RESERVED)
                                if smem else CTAS_PER_SM_MAX),
              "CTA slots": CTAS_PER_SM_MAX}
    by = min(limits, key=limits.get)
    return limits[by], by


def product_runs(insns: list[tuple[str, str]]) -> list[dict]:
    """The FFMA runs of one kernel's instructions (opcode, operands)."""
    at = [i for i, (op, _) in enumerate(insns) if op.startswith("FFMA")]
    runs, start = [], None
    for n, i in enumerate(at):
        if start is None:
            start = i
        if n + 1 == len(at) or at[n + 1] - i > GAP:
            span = insns[start:i + 1]
            ops = [op for op, _ in span]
            runs.append({
                "instructions": len(span),
                "ffma": sum(op.startswith("FFMA") for op in ops),
                "ffma_constant_weight": sum(
                    op.startswith("FFMA") and _CONSTANT.search(args)
                    is not None for op, args in span),
                "uldc": sum(op.startswith("ULDC") for op in ops),
                "ldc": sum(op.startswith("LDC") for op in ops),
                "ldl": sum(op.startswith("LDL") for op in ops),
                "stl": sum(op.startswith("STL") for op in ops)})
            start = None
    return runs


def report(src: str | pathlib.Path, stages: int = 3) -> dict:
    """Compile ``src`` and read back each kernel's resources and product
    runs (see the module's docstring)."""
    src = pathlib.Path(src).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "kernel.cubin"
        ptxas = subprocess.run(
            [tool("nvcc"), "-cubin", "-O3", "-std=c++17",
             "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas", "-v",
             "-o", str(cubin), str(src)],
            capture_output=True, text=True, timeout=300, check=True).stderr
        sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    kernels: dict[str, dict] = {}
    func = None
    for line in ptxas.splitlines():
        if m := _ENTRY.search(line):
            func = m.group(1)
            kernels[func] = {"dtype": dtype_of(func)}
        elif func and (m := _SPILL.search(line)):
            kernels[func].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        elif func and (m := _USED.search(line)):
            kernels[func].update(registers=int(m.group(1)),
                                 static_smem=int(m.group(2) or 0))
    insns: dict[str, list] = {}
    for line in sass.splitlines():
        if m := _FUNC.search(line):
            func = m.group(1)
            insns[func] = []
        elif func in insns and (m := _INSN.search(line)):
            insns[func].append((m.group(2), m.group(3)))
    for func, k in kernels.items():
        ring = stages * THREADS * 27 * ITEMSIZE[k["dtype"]] + 8 * stages
        k["smem"] = k.get("static_smem", 0) + (ring if stages else 0)
        k["ctas_per_sm"], k["limited_by"] = ctas_per_sm(k["registers"],
                                                        k["smem"])
        k["instructions"] = len(insns.get(func, []))
        k["product_runs"] = product_runs(insns.get(func, []))
    return {"src": str(src), "kernels": kernels}


def stencil_loop_ok(rep: dict) -> bool:
    """The stencil kernel compiled as designed: no stack or spills, and
    every product run is one row's 189 FFMAs, each with its weight from
    the constant bank (directly or through a uniform register), with no
    LDC, LDL or STL among them."""
    for k in rep["kernels"].values():
        if k["stack"] or k["spill_stores"] or k["spill_loads"]:
            return False
        runs = k["product_runs"]
        if not runs or any(
                r["ffma"] != 189 or r["ffma_constant_weight"] != 189
                or r["ldc"] or r["ldl"] or r["stl"] for r in runs):
            return False
    return True


def lines(rep: dict) -> list[str]:
    out = []
    for func, k in rep["kernels"].items():
        runs = "; ".join(
            f"{r['ffma']} FFMA ({r['ffma_constant_weight']} with a "
            f"constant-bank weight) in {r['instructions']} instructions, "
            f"ULDC {r['uldc']}, LDC {r['ldc']}, LDL {r['ldl']}, "
            f"STL {r['stl']}"
            for r in k["product_runs"])
        out.append(f"[sass] {k['dtype']}: {k['registers']} registers, "
                   f"stack {k['stack']} B, spills {k['spill_stores']}/"
                   f"{k['spill_loads']} B, shared memory {k['smem']} B a "
                   f"CTA -> {k['ctas_per_sm']} CTAs an SM (limited by "
                   f"{k['limited_by']}); {k['instructions']} instructions; "
                   f"product runs: {runs}")
    return out


def main() -> None:
    here = pathlib.Path(__file__).resolve().parents[1]
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(here / "kernels" / "wavesim_volume"
                                         / "csrc" / "volume.cu"))
    ap.add_argument("--stages", type=int, default=3,
                    help="ring stages of dynamic shared memory (0: none)")
    args = ap.parse_args()
    rep = report(args.src, args.stages)
    for line in lines(rep):
        print(line)
    rep["stencil_loop_ok"] = stencil_loop_ok(rep)
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
