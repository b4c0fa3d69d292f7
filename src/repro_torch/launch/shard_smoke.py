"""The ``[shard]`` phase of ``chip_smoke.py``: the sharded paths of the
port on one card, and the dry-run in a fake world on its host.

* (a) the sharded decode step (``serve.engine.sharded_decode_step``) on a
  one-rank NCCL group's (1, 1) mesh: full-width qwen2-0.5b, batch 8,
  max_len 1,024, 16 greedy steps against ``Model.decode_step``
  unsharded; float32 tokens equal and logits within 1e-5, bf16 tokens
  compared; ``decode_attn`` launched layers x steps times, exactly;
* (b) one full-width moonshot-v1-16b-a3b MoE layer through the
  expert-parallel ``_moe_shard_map`` against ``moe_apply``'s unsharded
  path (bf16 within 2e-2, float32 within 1e-5), ``group_gemm``
  launched;
* (c) two sharded train steps of full-width qwen2-0.5b at 2 x 1,024
  tokens against the unsharded ``make_train_step``: float32 loss within
  1e-5;
* (d) ``ElasticPlan.for_devices(1)``'s mesh, qwen's params saved and
  restored with shardings: values equal;
* (e) ``launch.dryrun`` cells in a fake world: qwen2-0.5b ``train_4k``
  on ``single`` and full-depth deepseek-v3's ``decode_32k`` on ``multi``,
  per-device bytes and the roofline row (spec-sheet bounds on host
  arithmetic);
* (f) ``launch.serve_lm``'s dump against ``launch.serve.run``, the flight
  drill, and ``launch.train_lm --profile 100m`` on the card.

``run(torch, check, smi)`` raises through ``check`` (chip_smoke's
``SmokeFailure``) and returns the launches of (a) and (b).
"""
from __future__ import annotations

import dataclasses
import pathlib
import statistics
import tempfile
import time

ARCH, MOE_ARCH, MLA_ARCH = "qwen2-0.5b", "moonshot-v1-16b-a3b", \
    "deepseek-v3-671b"
BATCH, MAX_LEN, PROMPT, STEPS = 8, 1024, 64, 16
DRY_CELLS = ((ARCH, "train_4k", "single"), (MLA_ARCH, "decode_32k", "multi"))


def _max_diff(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def sharded_decode(torch, check, mesh) -> int:
    """(a); returns the decode_attn launches of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import activation_policy
    from repro_torch.kernels import decode_attn
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve.engine import ServeConfig, sharded_decode_step
    cfg = get_config(ARCH)
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device="cuda",
                           generator=gen)
    total = 0
    for dtype in (torch.float32, torch.bfloat16):
        params = model.init(0, device="cuda", dtype=dtype)
        logits, caches = model.prefill(params, {"tokens": prompt}, MAX_LEN,
                                       dtype=dtype)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        ref_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
        specs = model.input_specs(ShapeConfig("shard", MAX_LEN, BATCH,
                                              "decode"), dtype=dtype)
        step = sharded_decode_step(
            model, ServeConfig(max_len=MAX_LEN, batch=BATCH, dtype=dtype),
            mesh, specs)
        # one sharded forward's logits against the unsharded step's
        placed = shd.place_tree(params, shd.param_shardings(
            model.abstract_ptree(), mesh))
        probe = shd.place_tree([{k: v.clone() for k, v in c.items()}
                                for c in caches],
                               shd.cache_shardings(specs["caches"], mesh))
        depth = torch.full((BATCH,), PROMPT, dtype=torch.int32,
                           device="cuda")
        with torch.no_grad(), activation_policy(mesh):
            got_logits = model.decode_step(
                placed, shd.place_tree(first, shd.data_shardings(
                    first, mesh)), probe,
                shd.place_tree(depth, shd.data_shardings(depth, mesh)),
                dtype=dtype)[0].full_tensor()
        del probe
        want = []
        tok = first
        with torch.no_grad():
            for i in range(STEPS):
                lg, ref_caches = model.decode_step(
                    params, tok, ref_caches, depth + i, dtype=dtype)
                if i == 0:
                    want_logits = lg
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                want.append(tok)
        decode_attn.reset_launch_counts()
        got, tok, sh_caches = [], first, caches
        for i in range(STEPS):
            tok, sh_caches = step(placed, tok, sh_caches, PROMPT + i)
            tok = tok.full_tensor()
            got.append(tok)
        torch.cuda.synchronize()
        launches = decode_attn.launch_counts["decode_attn"]
        total += launches
        agree = sum(int(torch.equal(a, b)) for a, b in zip(got, want))
        rows_agree = int(sum((a == b).sum() for a, b in zip(got, want)))
        err = _max_diff(torch, got_logits, want_logits)
        name = str(dtype).removeprefix("torch.")
        print(f"[shard] (a) sharded decode, {ARCH} full width, {name}, "
              f"batch {BATCH}, max_len {MAX_LEN}, {STEPS} greedy steps on "
              f"a (1, 1) NCCL mesh (eager): {agree}/{STEPS} steps and "
              f"{rows_agree}/{STEPS * BATCH} tokens equal to the unsharded "
              f"step; first step's logits max |diff| {err:.3e}; "
              f"decode_attn launches {launches} (layers x steps "
              f"{cfg.n_layers * STEPS})")
        check(launches == cfg.n_layers * STEPS,
              f"[shard] (a) {name}: decode_attn launched {launches} times, "
              f"not layers x steps")
        if dtype == torch.float32:
            check(agree == STEPS and err <= 1e-5,
                  f"[shard] (a) float32 sharded decode differs: {agree} "
                  f"steps equal, logits |diff| {err:.3e}")
        del params, caches, ref_caches, sh_caches, placed
        torch.cuda.empty_cache()
    return total


def moe_cut():
    """Full-width moonshot cut to its dense layer and one MoE layer."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockKind, Segment
    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(
        cfg, n_layers=2, segments=(Segment(BlockKind.DENSE, 1),
                                   Segment(BlockKind.MOE, 1)))


def expert_parallel(torch, check, mesh) -> int:
    """(b); returns group_gemm's launches."""
    from repro_torch import tree
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.act_sharding import activation_policy
    from repro_torch.kernels import moe_group_gemm
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.moe import _moe_shard_map, moe_apply
    cfg = moe_cut()
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    launches = 0
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        params = model.init(0, device="cuda", dtype=dtype)
        placed = shd.place_tree(params, shd.param_shardings(
            model.abstract_ptree(), mesh))
        layer = tree.tree_map(lambda t: t[0], params["segments"][1]["moe"])
        layer_dt = tree.tree_map(lambda t: t[0],
                                 placed["segments"][1]["moe"])
        x = (torch.randn((2, 2048, cfg.d_model), device="cuda",
                         generator=gen) * 0.5).to(dtype)
        with torch.no_grad():
            want = moe_apply(layer, x, cfg, cfg.activation)
            moe_group_gemm.reset_launch_counts()
            with activation_policy(mesh):
                xd = shd.place_tree(x, shd.data_shardings(x, mesh))
                got = _moe_shard_map(layer_dt, xd, cfg, cfg.activation,
                                     mesh).full_tensor()
            torch.cuda.synchronize()
        n = moe_group_gemm.launch_counts["group_gemm"]
        launches += n
        err = _max_diff(torch, got, want)
        name = str(dtype).removeprefix("torch.")
        print(f"[shard] (b) expert-parallel MoE, one full-width {MOE_ARCH} "
              f"layer ({cfg.moe.n_experts} experts, d {cfg.d_model}), "
              f"4,096 tokens, {name}: _moe_shard_map against moe_apply "
              f"max |diff| {err:.3e} (tolerance {tol}); group_gemm "
              f"launches {n}")
        check(err <= tol and n > 0,
              f"[shard] (b) {name}: |diff| {err:.3e} or {n} launches")
        del params, placed, layer, layer_dt
        torch.cuda.empty_cache()
    return launches


def sharded_train(torch, check, mesh) -> None:
    """(c)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (TrainConfig, make_train_state,
                                              make_train_step,
                                              sharded_train_step)
    cfg = get_config(ARCH)
    model = Model(cfg)
    tcfg = TrainConfig(opt=opt.OptConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=10),
                       dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (2, 1024),
                                        device="cuda", generator=gen)}
               for _ in range(2)]
    ref = make_train_state(model, 0, tcfg, device="cuda")
    state = tree.tree_map(torch.clone, ref)
    ref_step = make_train_step(model, tcfg)
    step = sharded_train_step(model, tcfg, mesh,
                              {"tokens": batches[0]["tokens"]})
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        ref, want = ref_step(ref, batch)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, got = step(state, batch)
        loss = float(got["loss"].full_tensor())
        t_sh = time.perf_counter() - t0
        err = abs(loss - float(want["loss"]))
        print(f"[shard] (c) sharded train step {i}, {ARCH} full width, "
              f"2 x 1,024 tokens, float32: loss {loss!r} against "
              f"{float(want['loss'])!r} (|diff| {err:.3e}); grad_norm "
              f"{float(got['grad_norm'].full_tensor()):.6f} against "
              f"{float(want['grad_norm']):.6f}; {t_sh * 1e3:.1f} ms "
              f"sharded, {t_ref * 1e3:.1f} ms unsharded")
        check(err <= 1e-5, f"[shard] (c) step {i}: loss |diff| {err:.3e}")
    worst = max(_max_diff(torch, a.full_tensor(), b) for a, b in zip(
        tree.leaves(state["params"]), tree.leaves(ref["params"])))
    print(f"[shard] (c) params after 2 steps, max |diff| {worst:.3e}")


def elastic_restore(torch, check) -> None:
    """(d)."""
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.ft.elastic import ElasticPlan
    from repro_torch.models.model_zoo import Model
    plan = ElasticPlan.for_devices(1)
    mesh = plan.make_mesh()
    model = Model(get_config(ARCH))
    params = model.init(1, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(3, params)
        restored, manifest = ck.restore(
            params, shardings=shd.param_shardings(model.abstract_ptree(),
                                                  mesh))
    equal = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        tree.leaves(restored), tree.leaves(params)))
    print(f"[shard] (d) ElasticPlan.for_devices(1) = {plan}; {ARCH} params "
          f"saved at step {manifest['step']} and restored onto its "
          f"{tuple(mesh.mesh.shape)} mesh as DTensors: values equal "
          f"{equal}")
    check(equal and manifest["step"] == 3, "[shard] (d) restore differs")


def dryrun_cells(check, smi: str) -> float:
    """(e); returns its seconds."""
    import json
    from repro_torch.core.hwspec import DEFAULT_HOPPER as H
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import from_artifact
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        for arch, shape, mesh in DRY_CELLS:
            t1 = time.perf_counter()
            path = pathlib.Path(d) / f"{arch}__{shape}__{mesh}.json"
            rec = dryrun.run_cell(arch, shape, mesh, path)
            mem = rec["memory"]
            r = from_artifact(path)
            print(f"[shard] (e) dry-run {arch} x {shape} x {mesh} "
                  f"({rec['n_devices']} fake ranks, "
                  f"{time.perf_counter() - t1:.1f}s: place "
                  f"{rec['lower_s']}s, trace {rec['trace_s']}s): per "
                  f"device args {mem['argument_bytes'] / 2**30:.3f} GiB, "
                  f"out {mem['output_bytes'] / 2**30:.3f} GiB, temp "
                  f"{mem['temp_bytes'] / 2**30:.3f} GiB, "
                  f"{rec['trace_stats']['flops']:.4g} dot FLOPs, "
                  f"collectives {json.dumps(rec['collective_bytes'])} B")
            print(f"[shard] (e) roofline (H100 spec: {H.peak_bf16_tflops} "
                  f"TFLOP/s bf16, {H.hbm_gbps / 1e3} TB/s, NVLink "
                  f"{H.nvlink_gbps} GB/s; spec-sheet bounds on host "
                  f"arithmetic, beside this card: {smi}): "
                  f"arch,shape,mesh,compute_ms,memory_ms,collective_ms,"
                  f"bound,useful_ratio,roofline_frac = {r.row()}")
            check(rec["trace_stats"]["flops"] > 0
                  and mem["argument_bytes"] > 0,
                  f"[shard] (e) {arch} {shape} {mesh}: an empty record")
    secs = time.perf_counter() - t0
    print(f"[shard] (e) dry-run cells took {secs:.1f}s")
    return secs


def main_path_leftovers(torch, check) -> None:
    """(f)."""
    import contextlib
    import io
    from repro_torch.launch import flight_drill, serve_lm, train_lm
    from repro_torch.launch.serve import run
    argv = ["--requests", "4", "--max-new", "6"]
    with contextlib.redirect_stdout(io.StringIO()) as dump:
        got = serve_lm.main(argv)
        want = run("qwen2-0.5b", reduced=True, requests=4, max_new=6,
                   batch=4, max_len=64, sync_every=8, temperature=0.0)
    lines = [ln for ln in dump.getvalue().splitlines()
             if ln.startswith("request ")]
    same = got["results"] == want["results"] and lines == [
        f"request {rid}: {toks}" for rid, toks in
        sorted(want["results"].items())]
    print(f"[shard] (f) launch.serve_lm dump ({len(lines)} requests) equal "
          f"to launch.serve.run's results on the card: {same}")
    check(same, "[shard] (f) serve_lm's dump differs from serve.run's")
    with tempfile.TemporaryDirectory() as d:
        failures = flight_drill.drill(str(pathlib.Path(d) / "bundle.json"),
                                      device="cuda")
        print(f"[shard] (f) flight drill on the card: {len(failures)} "
              f"failures {failures}")
        check(not failures, f"[shard] (f) flight drill: {failures}")
        with contextlib.redirect_stdout(io.StringIO()):
            out = train_lm.main(["--profile", "100m", "--steps", "20",
                                 "--ckpt", str(pathlib.Path(d) / "ck")])
    step_ms = statistics.median(out["step_s"][1:]) * 1e3
    losses = out["losses"]
    print(f"[shard] (f) launch.train_lm --profile 100m on the card "
          f"({train_lm.hundred_m().name}, 16 x 512 tokens, accum 2, 20 "
          f"steps): median step {step_ms:.1f} ms, "
          f"{16 * 512 / step_ms * 1e3:.0f} tokens/s, loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}")
    check(losses[-1] < losses[0], "[shard] (f) the 100m loss did not fall")


def run(torch, check, smi: str) -> dict:
    from repro_torch.launch.mesh import local_world, make_host_mesh
    t0 = time.perf_counter()
    with local_world("nccl"):
        mesh = make_host_mesh()
        counts = {"decode_attn": sharded_decode(torch, check, mesh),
                  "group_gemm": expert_parallel(torch, check, mesh)}
        sharded_train(torch, check, mesh)
        torch.cuda.empty_cache()
        elastic_restore(torch, check)
    torch.cuda.empty_cache()
    dryrun_cells(check, smi)
    main_path_leftovers(torch, check)
    print(f"[shard] phase took {time.perf_counter() - t0:.1f}s")
    return counts
