"""Training driver of the port: data pipeline, train step,
checkpoint/restart, failure handling and straggler monitoring, from
:mod:`repro.launch.train`.

The loop survives injected failures by restoring the latest checkpoint
and continues the exact data stream.  The port initialises from its own
seeded generator, so a run's numbers differ from the JAX driver's; the
two agree step for step from one bridged state (the tests).  ``run``
takes a registered arch name or an ``ArchConfig`` (``launch.train_lm``'s
100M-param profile).  The driver runs on one device; the sharded train
step on a mesh is ``train.train_loop.sharded_train_step``.

``run`` returns JAX's ``final_loss``, ``losses`` and ``straggle_rate``,
and for measuring runs also ``grad_norms`` (beside ``losses``),
``step_s`` (each executed step's wall seconds, up to its loss on the
host), ``ckpt_stall_s`` (the seconds each ``save_async`` held the loop:
the host copy) and the final ``state``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --device cpu --steps 12 --batch 4 --seq 64 --lr 3e-3
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import Checkpointer
from ..configs import ArchConfig, get_config
from ..data import DataConfig, DataPipeline
from ..device import resolve_device
from ..ft import FailureInjector, SimulatedFailure, StragglerMonitor
from ..models.model_zoo import Model
from ..train import optimizer as opt
from ..train.train_loop import (TrainConfig, make_train_state,
                                make_train_step, split_microbatches)


def run(arch: str | ArchConfig, *, steps: int = 20, batch: int = 8, seq: int = 128,
        reduced: bool = True, ckpt_dir: str | None = None,
        ckpt_every: int = 10, accum: int = 1, lr: float = 3e-4,
        fail_at: tuple[int, ...] = (), seed: int = 0,
        log_every: int = 5, compress_grads: bool = False,
        device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    tcfg = TrainConfig(opt=opt.OptConfig(lr=lr,
                                         warmup_steps=max(2, steps // 10),
                                         total_steps=steps),
                       accum=accum, remat=not reduced,
                       compress_grads=compress_grads)
    data = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch, seed=seed))
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    injector = FailureInjector(fail_at)
    monitor = StragglerMonitor()

    state = make_train_state(model, seed, tcfg, device=dev)
    step_fn = make_train_step(model, tcfg)
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        state, manifest = ckpt.restore(state)
        start = manifest["step"]
        data.load_state_dict(manifest["extra"].get("data", {"step": start}))
        print(f"[train] restored step {start}", flush=True)

    losses, grad_norms, step_s, stalls = [], [], [], []
    step = start
    while step < steps:
        try:
            injector.check(step)
            monitor.step_start()
            t0 = time.perf_counter()
            raw = data.batch_at(step)
            batch_dev = {k: torch.from_numpy(v).to(dev)
                         for k, v in raw.items()}
            batch_dev = split_microbatches(batch_dev, tcfg.accum)
            state, metrics = step_fn(state, batch_dev)
            loss = float(metrics["loss"])      # waits for the step
            step_s.append(time.perf_counter() - t0)
            grad_norms.append(float(metrics["grad_norm"]))
            if monitor.step_end(step):
                print(f"[train] step {step}: straggler flagged "
                      f"(rate {monitor.straggle_rate:.0%})", flush=True)
            losses.append(loss)
            if step % log_every == 0:
                print(f"[train] step {step}: loss {loss:.4f} "
                      f"gnorm {grad_norms[-1]:.3f}",
                      flush=True)
            step += 1
            data.step = step
            if ckpt and step % ckpt_every == 0:
                t0 = time.perf_counter()
                ckpt.save_async(step, state,
                                extra={"data": data.state_dict(),
                                       "arch": getattr(arch, "name", arch)})
                stalls.append(time.perf_counter() - t0)
        except SimulatedFailure as exc:
            print(f"[train] {exc}; restoring from checkpoint", flush=True)
            if ckpt is None or ckpt.latest_step() is None:
                print("[train] no checkpoint; restarting from scratch",
                      flush=True)
                state = make_train_state(model, seed, tcfg, device=dev)
                step = 0
            else:
                ckpt.wait()
                state, manifest = ckpt.restore(state)
                step = manifest["step"]
                data.load_state_dict(
                    manifest["extra"].get("data", {"step": step}))
                print(f"[train] resumed at step {step}", flush=True)
    if ckpt:
        ckpt.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "straggle_rate": monitor.straggle_rate,
            "grad_norms": grad_norms, "step_s": step_s,
            "ckpt_stall_s": stalls, "state": state}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", dest="ckpt_dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain path")
    args = ap.parse_args()
    out = run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              reduced=args.reduced, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, accum=args.accum, lr=args.lr,
              fail_at=tuple(args.fail_at),
              compress_grads=args.compress_grads, device=args.device)
    print(f"[train] done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
