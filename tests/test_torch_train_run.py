"""The port's train driver (``repro_torch.launch.train.run``) on the CPU
shows the four behaviours JAX's driver is held to in
``tests/test_train_integration.py``, with the same arguments: the loss
falls; a run with an injected failure restores its checkpoint and ends at
the clean run's final loss (rtol 1e-4); gradient compression trains; and
accumulation over 2 microbatches lands within 0.1 of accum 1.  The port
initialises from its own seeded generator, so these are its own runs,
not JAX's numbers."""
import numpy as np
import torch

from repro_torch.launch.train import main, run

torch.set_num_threads(1)


def test_train_loss_decreases():
    out = run("qwen2-0.5b", steps=12, batch=4, seq=64, reduced=True,
              lr=3e-3, log_every=100, device="cpu")
    losses = out["losses"]
    assert len(losses) == 12
    assert losses[-1] < losses[0] - 0.05, \
        f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"


def test_train_failure_recovery_deterministic(tmp_path, capsys):
    kw = dict(steps=10, batch=2, seq=32, reduced=True, lr=1e-3,
              ckpt_every=5, log_every=100, device="cpu")
    clean = run("qwen2-0.5b", ckpt_dir=str(tmp_path / "a"), **kw)
    faulty = run("qwen2-0.5b", ckpt_dir=str(tmp_path / "b"), fail_at=(7,),
                 **kw)
    assert np.isclose(clean["final_loss"], faulty["final_loss"],
                      rtol=1e-4), (clean["final_loss"],
                                   faulty["final_loss"])
    out = capsys.readouterr().out
    assert "[train] injected failure at step 7; restoring" in out
    assert "[train] resumed at step 5" in out
    assert len(faulty["losses"]) == 12        # steps 5 and 6 ran twice
    # a new run in the same directory restores the latest checkpoint
    again = run("qwen2-0.5b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert again["losses"] == []
    assert "[train] restored step 10" in capsys.readouterr().out


def test_train_with_grad_compression():
    out = run("qwen2-0.5b", steps=8, batch=2, seq=32, reduced=True,
              lr=3e-3, compress_grads=True, log_every=100, device="cpu")
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["losses"][0]


def test_train_with_accumulation_matches_tokens():
    out1 = run("qwen2-0.5b", steps=6, batch=4, seq=32, reduced=True,
               accum=1, lr=1e-3, log_every=100, device="cpu")
    out2 = run("qwen2-0.5b", steps=6, batch=4, seq=32, reduced=True,
               accum=2, lr=1e-3, log_every=100, device="cpu")
    # same data, nearly the same optimization trajectory
    assert abs(out1["final_loss"] - out2["final_loss"]) < 0.1


def test_cli_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "mamba2-370m", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16"])
    main()
    out = capsys.readouterr().out
    assert "[train] step 0: loss" in out and "[train] done: final loss" in out
