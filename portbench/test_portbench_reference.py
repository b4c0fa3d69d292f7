"""Each cell's frozen reference against the port's CPU path in float32,
at the smoke widths of its configuration's layer kinds
(``ArchConfig.reduced`` sizes), on weights the benchmark makes.  The test
imports both; a reference imports neither the port nor JAX."""
import json

import pytest
import torch

from portbench import spec
from portbench.reference import model as ref
from portbench.testcell import tiny_cell
from portbench.weights import make_weights

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_port_in_float32(workload):
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import forward, logits_fn
    cell = tiny_cell(workload)
    port = cell.port
    arch = spec.arch(cell.config_name, port)
    w = make_weights(Model(arch).abstract_ptree(), 5, torch.device("cpu"),
                     torch.float32)
    with torch.no_grad():
        # biases and norm scales away from their init, so they count
        for seg in w["segments"]:
            for blk in ("attn",):
                for p in seg[blk].values():
                    if "b" in p:
                        p["b"].normal_(0, 0.1)
            seg["norm1"]["scale"].uniform_(0.5, 1.5)
        seqs = [[3, 200, 17, 5, 9, 41, 250], [7, 7, 1, 99]]
        for s in seqs:
            hidden, _ = forward(w, {"tokens": torch.tensor([s])}, arch,
                                dtype=torch.float32)
            want = logits_fn(w, hidden, arch)[0]
            got = torch.cat([lg for _, _, lg in cell.reference.forward(
                w, port, [s], score_from=[0], fp8=False)])
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_capacity_drops_as_the_port():
    """With a binding capacity the reference drops the same (token,
    choice) pairs as the port's ``moe_apply``."""
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.moe import capacity, moe_apply
    cell = tiny_cell("moonshot.decode_backlog")
    port = dict(cell.port, moe=dict(cell.port["moe"], capacity_factor=0.5))
    arch = spec.arch("moe", port)
    w = make_weights(Model(arch).abstract_ptree(), 9, torch.device("cpu"),
                     torch.float32)
    layer = {k: v[0] for k, v in w["segments"][1]["moe"].items()
             if k != "shared" and k != "router"}
    layer["router"] = {"w": w["segments"][1]["moe"]["router"]["w"][0]}
    layer["shared"] = {k: {"w": v["w"][0]} for k, v in
                       w["segments"][1]["moe"]["shared"].items()}
    x = torch.randn(3, 10, port["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    want = moe_apply(layer, x, arch, port["activation"])
    cap = capacity(arch, 30)
    got = ref.moe(layer, x.reshape(30, -1), port["moe"], ref._act("silu"),
                  False, capacity=cap).reshape(x.shape)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    free = ref.moe(layer, x.reshape(30, -1), port["moe"], ref._act("silu"),
                   False).reshape(x.shape)
    assert (free - want).abs().max() > 1e-3       # the capacity did bind


def test_control_rounds_through_fp8():
    x = torch.linspace(-3, 3, 97)[None, :].repeat(4, 1)
    q = ref._fp8(x, -1)
    assert 0 < (q - x).abs().max() <= 3 * 2 ** -3
    assert torch.equal(ref._fp8(q, -1), q)


def test_each_cell_lies_inside_its_reference():
    """Every cell's ``port`` block uses only the attention, segment kinds
    and activation that the reference its configuration names says it
    computes (``COVERS``)."""
    for w in spec.load_benchmark()["workloads"]:
        cell = spec.cell(w["name"])
        covers = cell.reference.COVERS
        arch = spec.arch(cell.config_name, cell.port)
        assert arch.attn.value in covers["attn"], w["name"]
        assert {s.kind.value for s in arch.segments} <= \
            set(covers["segments"]), w["name"]
        assert arch.activation in covers["activation"], w["name"]
        json.dumps(cell.port)
