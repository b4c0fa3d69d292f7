"""Quickstart: the paper in five minutes, from ``examples/quickstart.py``.

1. Run the PIM-amenability-test on the studied primitives.
2. Model baseline vs optimized PIM execution (the paper's headline).
3. Run three of the port's kernels against their plain versions: the
   masked skinny GEMM, the wave volume term and dense decode attention, at
   the JAX example's shapes and inputs.

Steps 1 and 2 are host arithmetic and print the JAX example's lines.  Step
3 runs on ``--device`` (default ``cuda``, which raises without a GPU);
``--device cpu`` runs the ops' plain versions.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.amenability import run_test
from ..core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ..core.primitives import ss_gemm, vector_sum, wavesim
from ..device import resolve_device


def kernel_inputs(device: torch.device) -> dict[str, tuple]:
    """The JAX example's step-3 inputs, drawn in its order from
    ``default_rng(0)``: the skinny GEMM's (a, b), the volume term's (u,)
    and decode attention's (q, k, v, length), float32 on ``device``."""
    rng = np.random.default_rng(0)

    def t(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x.astype(np.float32)).to(device)

    a = t(rng.standard_normal((256, 512)))
    b = rng.standard_normal((512, 4)).astype(np.float32)
    b[rng.random(512) > 0.45] = 0.0
    u = t(rng.standard_normal((16, 9, 3, 3, 3)))
    q = t(rng.standard_normal((1, 8, 64)))
    k = t(rng.standard_normal((1, 512, 2, 64)))
    v = t(rng.standard_normal((1, 512, 2, 64)))
    return {"ss-gemm": (a, t(b)), "wavesim-volume": (u,),
            "decode-attn": (q, k, v, 300)}


def run(device: str | torch.device = "cuda") -> dict:
    """Print the three steps; return, for each kernel of step 3, its
    inputs, output, plain version's output and their largest absolute
    difference."""
    dev = resolve_device(device)
    print("=" * 72)
    print("1) PIM-amenability-test (paper §3)")
    print("=" * 72)
    for profile in (vector_sum.profile(vector_sum.Problem(64 << 20)),
                    wavesim.profile_volume(wavesim.Problem()),
                    ss_gemm.profile(ss_gemm.Problem(n=4))):
        print(run_test(profile, PIM, GPU).summary())
        print()

    print("=" * 72)
    print("2) Analytical PIM model: baseline vs optimized (paper §4-5)")
    print("=" * 72)
    vp = vector_sum.Problem(64 << 20)
    print(f"vector-sum     : {vector_sum.speedup(vp, PIM, GPU):.2f}x -> "
          f"{vector_sum.speedup(vp, PIM, GPU, arch_aware=True):.2f}x "
          "(arch-aware activation)")
    wp = wavesim.Problem()
    print(f"wavesim-volume : {wavesim.speedup_volume(wp, PIM, GPU):.2f}x -> "
          f"{wavesim.speedup_volume(wp, PIM, GPU, arch_aware=True):.2f}x")
    sp = ss_gemm.Problem(n=4)
    r = ss_gemm.speedups(sp, PIM, GPU)
    print(f"ss-gemm (N=4)  : {r['baseline']:.2f}x -> "
          f"{r['sparsity_aware']:.2f}x (sparsity-aware command skip)")
    print()

    print("=" * 72)
    print(f"3) The port's kernels vs their plain versions ({dev.type})")
    print("=" * 72)
    from ..kernels.decode_attn import decode_attn, decode_attn_ref
    from ..kernels.ss_gemm import ssgemm_masked, ssgemm_ref
    from ..kernels.wavesim_volume import volume, volume_ref
    inputs = kernel_inputs(dev)
    a, b = inputs["ss-gemm"]
    (u,) = inputs["wavesim-volume"]
    q, k, v, length = inputs["decode-attn"]
    runs = {"ss-gemm": (ssgemm_masked(a, b, bm=128, bk=128),
                        ssgemm_ref(a, b)),
            "wavesim-volume": (volume(u), volume_ref(u)),
            "decode-attn": (decode_attn(q, k, v, length),
                            decode_attn_ref(q, k, v, length))}
    kernels = {}
    for name, (out, plain) in runs.items():
        err = float((out.float() - plain.float()).abs().max())
        print(f"{name} kernel max |err| vs oracle: {err:.2e}")
        kernels[name] = {"inputs": inputs[name], "out": out, "plain": plain,
                         "max_abs_err": err}
    return kernels


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
