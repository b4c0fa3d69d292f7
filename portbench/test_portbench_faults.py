"""The correctness check against a broken program.

Each test drives a whole run of a cell on the CPU at a size a test holds
(``portbench.testcell``: the cell's layer kinds at smoke widths, float32,
four slots; the harness's look for a card is skipped), with the timed
path broken underneath, and sees ``correct`` come out false: a decode
step that returns its state unchanged (the KV pool it should write left
as it was), the batch's rows left out (every row given the logits of the
row before it, the logits rolled by one row, so no live row keeps its
own whichever slots the sample reads), and a token altered where it is
produced.  One card holds
every cell, so there is no exchange between chips to leave out.  The
sound run beside them comes out true.  The control, the reference in
float8 in the program's place, is read against the cell's limit on the
sound run's requests.  Every cell of ``BENCHMARK.json`` is tested.
"""
import pytest

from portbench import check, spec
from portbench.testcell import run_tiny, tiny_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
LIMIT = 0.05      # a float32 program reads 0 here; a broken one far more


def _state_unchanged(monkeypatch):
    from repro_torch.models.model_zoo import Model
    orig = Model.decode_step

    def step(self, params, tokens, caches, cache_len, **kw):
        scratch = [{k: v.clone() for k, v in c.items()} for c in caches]
        logits, _ = orig(self, params, tokens, scratch, cache_len, **kw)
        return logits, caches
    monkeypatch.setattr(Model, "decode_step", step)


def _half_batch(monkeypatch):
    from repro_torch.models.model_zoo import Model
    orig = Model.decode_step

    def step(self, params, tokens, caches, cache_len, **kw):
        logits, caches = orig(self, params, tokens, caches, cache_len, **kw)
        return logits.roll(1, 0), caches
    monkeypatch.setattr(Model, "decode_step", step)


def _token_altered(monkeypatch):
    from repro_torch.serve import engine
    orig = engine.sample_tokens

    def sample(logits, temperature, generator=None):
        tok = orig(logits, temperature, generator)
        return (tok + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_tokens", sample)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run_tiny(workload, 3, limit=LIMIT)
    assert out["correct"], out["checks"]
    assert out["checks"]["tokens_compared"]["value"] >= 20
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m.name for m in
                                   tiny_cell(workload).metrics_e2e}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_program_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_tiny(workload, 4, limit=LIMIT)
    assert not out["correct"], out["checks"]
    assert max(out["checks"][k]["value"] for k in check.STATS) > LIMIT


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(workload):
    """The float8 reference's own first choices, read in the float32
    reference, lie further below its best than the limit allows."""
    read = {}

    def control(cell, mix, params, session, seed):
        reqs = check.sample(session, seed, 4, cell.port)
        firsts = check.gaps(cell, params, reqs, fp8=True)
        got = check.gaps(cell, params, reqs,
                         tokens=[f.tolist() for f in firsts])
        read["control"] = max(g.max() for g in got)
        return check.check(cell, mix, params, session, seed)
    out = run_tiny(workload, 6, limit=LIMIT, check_fn=control)
    assert out["correct"]
    assert read["control"] > LIMIT
