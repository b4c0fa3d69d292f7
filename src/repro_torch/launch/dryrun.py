"""Production-mesh dry-run of the port: trace every (arch x shape x mesh)
cell on fake ranks, from :mod:`repro.launch.dryrun`.

JAX forces 512 host devices and lowers and compiles each cell's jitted
step.  Here each cell runs in a fake world of 256 (``single``, 16 x 16
data x model) or 512 (``multi``, 2 x 16 x 16 pod x data x model) ranks
(:func:`repro_torch.launch.mesh.fake_world`) under ``FakeTensorMode``, so
nothing is allocated and no collective moves data: the cell's params,
optimizer state and inputs are placed as DTensors with the shardings of
:mod:`repro_torch.distributed.sharding`, and its step (the sharded train
step, ``Model.prefill`` or the sharded decode step) runs eagerly under
the mesh's activation policy, rank 0's program traced by
:class:`repro_torch.roofline.trace_analyzer.TraceAnalyzer`.  Every number
in a record is host arithmetic on shapes, per device:

* ``memory``: ``argument_bytes`` (the local shards of the step's inputs),
  ``param_bytes`` (of the params among them), ``output_bytes`` (of its
  outputs) and ``temp_bytes`` (the analyzer's peak of live op outputs);
* ``flops`` (``torch.utils.flop_counter.FlopCounterMode``) and the
  analyzer's dot FLOPs (``trace_stats``), which the roofline reads;
* ``collective_bytes`` by JAX's kinds, from the analyzer;
* ``lower_s`` (placing the inputs) and ``trace_s`` (running the step).

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``;
:mod:`repro_torch.launch.figures.roofline_table` reads them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh multi

Cells are resumable: existing records are skipped unless --force.  With
--fork each cell runs in a fresh process.  A failing cell fails the run
(exit 1).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import torch

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")
WORLD = {"single": 256, "multi": 512}


def _accum_for(arch_cfg) -> int:
    # keep microbatch activations ~2k tokens per data-shard row
    return 8 if arch_cfg.d_model >= 4096 else 2


def _train_dtypes(arch_cfg):
    """Param/moment dtypes: bf16 state for the near-trillion class."""
    big = arch_cfg.d_model >= 6144 or (arch_cfg.moe is not None
                                       and arch_cfg.moe.n_experts >= 64)
    return (torch.bfloat16, torch.bfloat16) if big else (torch.float32,
                                                         torch.float32)


def _fake(tree_of_meta):
    """The ``meta`` tensors of a tree as (fake-mode) empty tensors."""
    from .. import tree
    return tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                         tree_of_meta)


def _local_bytes(values) -> int:
    """Bytes of this rank's shards of every tensor in ``values``."""
    from torch.distributed.tensor import DTensor

    from .. import tree
    return int(sum((t.to_local() if isinstance(t, DTensor) else t).numel()
                   * t.element_size() for t in tree.leaves(values)))


def build_cell(cfg, shape, mesh):
    """(inputs, step, params) of one cell: ``step(*inputs)`` runs it; the
    inputs are placed on ``mesh``, the params among them.  Call inside a
    fake mode."""
    from ..distributed import sharding as shd
    from ..models.model_zoo import Model
    from ..serve.engine import ServeConfig, sharded_decode_step
    from ..train import optimizer as opt
    from ..train.train_loop import (TrainConfig, sharded_train_step,
                                    split_microbatches, state_shardings)

    model = Model(cfg)
    specs = model.input_specs(shape)
    if shape.kind == "train":
        pdt, mdt = _train_dtypes(cfg)
        tcfg = TrainConfig(opt=opt.OptConfig(moment_dtype=mdt),
                           accum=_accum_for(cfg), remat=True,
                           param_dtype=pdt)
        params = _fake(model.abstract_params(dtype=pdt))
        moments = [_fake(model.abstract_params(dtype=mdt))
                   for _ in range(2)]
        state = {"params": params,
                 "opt": {"mu": moments[0], "nu": moments[1],
                         "step": torch.zeros((), dtype=torch.int32)},
                 "ef": None}
        state = shd.place_tree(state, state_shardings(model, tcfg, mesh))
        step = sharded_train_step(model, tcfg, mesh, specs["batch"])
        batch = split_microbatches(_fake(specs["batch"]), tcfg.accum)
        return (state, batch), step, state["params"]

    params = shd.place_tree(_fake(model.abstract_params(torch.bfloat16)),
                            shd.param_shardings(model.abstract_ptree(),
                                                mesh))
    if shape.kind == "prefill":
        from ..distributed.act_sharding import activation_policy
        from ..models.transformer import init_caches
        batch = shd.place_tree(_fake(specs["batch"]),
                               shd.data_shardings(specs["batch"], mesh))
        meta = init_caches(cfg, shape.global_batch, shape.seq_len,
                           torch.bfloat16, "meta")
        caches = shd.place_tree(_fake(meta), shd.cache_shardings(meta, mesh))

        @torch.no_grad()
        def prefill_step(p, b, c):
            with activation_policy(mesh):
                return model.prefill(p, b, shape.seq_len, caches=c)
        return (params, batch, caches), prefill_step, params

    scfg = ServeConfig(max_len=shape.seq_len, batch=shape.global_batch)
    step = sharded_decode_step(model, scfg, mesh, specs)
    inputs = (params,
              shd.place_tree(_fake(specs["tokens"]),
                             shd.data_shardings(specs["tokens"], mesh)),
              shd.place_tree(_fake(specs["caches"]),
                             shd.cache_shardings(specs["caches"], mesh)),
              shd.replicated(mesh).place(torch.zeros((), dtype=torch.int32)),
              shd.place_tree(_fake(specs["extra"]),
                             shd.data_shardings(specs["extra"], mesh)))
    return inputs, step, params


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_path: pathlib.Path | None = None, cfg=None) -> dict:
    """Trace one cell in a fake world and return its record (written to
    ``out_path`` when given).  ``cfg`` overrides the registry's config
    (the tests pass reduced ones)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..configs import get_config
    from ..configs.base import SHAPES
    from ..roofline.trace_analyzer import TraceAnalyzer
    from .mesh import fake_world, make_production_mesh

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    with fake_world(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        fake = FakeTensorMode(allow_non_fake_inputs=True)   # the mesh
        fake.__enter__()
        t0 = time.perf_counter()
        inputs, step, params = build_cell(cfg, shape, mesh)
        arg_bytes = _local_bytes(inputs)
        param_bytes = _local_bytes(params)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        flop_mode = FlopCounterMode(display=False)
        with flop_mode, TraceAnalyzer() as analyzer:
            out = step(*inputs)
        t_trace = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
        fake.__exit__(None, None, None)
    stats = analyzer.stats
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": WORLD[mesh_kind],
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "lower_s": round(t_lower, 3), "trace_s": round(t_trace, 3),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": int(stats.peak_temp_bytes),
                   "param_bytes": param_bytes},
        "flops": float(flop_mode.get_total_flops()),
        "bytes_accessed": stats.dot_bytes,
        "collective_bytes": dict(stats.collective_bytes),
        "trace_stats": stats.as_dict(),
    }
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(record, indent=1))
    return record


def all_cells():
    from ..configs import ALL_ARCHS, get_config, shapes_for
    for arch in ALL_ARCHS:
        for shape in shapes_for(get_config(arch)):
            for mesh_kind in ("single", "multi"):
                yield arch, shape.name, mesh_kind


def cell_path(arch: str, shape: str, mesh_kind: str) -> pathlib.Path:
    return ARTIFACTS / f"{arch}__{shape}__{mesh_kind}.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fork", action="store_true",
                    help="run each cell in a fresh subprocess")
    args = ap.parse_args(argv)

    if args.all:
        cells = list(all_cells())
    else:
        if not (args.arch and args.shape and args.mesh):
            ap.error("--all or all of --arch/--shape/--mesh")
        cells = [(args.arch, args.shape, args.mesh)]

    failures = []
    for arch, shape, mesh_kind in cells:
        path = cell_path(arch, shape, mesh_kind)
        tag = f"{arch} x {shape} x {mesh_kind}"
        if path.exists() and not args.force:
            print(f"[skip] {tag}", flush=True)
            continue
        if args.fork and len(cells) > 1:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind]
            if args.force:
                cmd.append("--force")
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=7200)
            ok = r.returncode == 0 and path.exists()
            print(f"[{'ok' if ok else 'FAIL'}] {tag}", flush=True)
            if not ok:
                failures.append(tag)
                path.parent.mkdir(parents=True, exist_ok=True)
                (path.parent / f"FAIL_{path.stem}.log").write_text(
                    (r.stdout or "")[-2000:] + (r.stderr or "")[-4000:])
            continue
        try:
            rec = run_cell(arch, shape, mesh_kind, path)
            coll = {k: f"{v / 1e9:.2f}GB"
                    for k, v in rec["collective_bytes"].items()}
            print(f"[ok] {tag}: trace {rec['trace_s']}s "
                  f"flops={rec['trace_stats']['flops']:.4g} coll={coll}",
                  flush=True)
            print(f"     memory: {rec['memory']}", flush=True)
        except Exception:
            failures.append(tag)
            print(f"[FAIL] {tag}\n{traceback.format_exc()}", flush=True)
    if failures:
        print(f"FAILED cells: {failures}", flush=True)
        return 1
    print("all cells ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
