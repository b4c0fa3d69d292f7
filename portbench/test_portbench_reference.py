"""The frozen reference against the port's CPU path in float32, at the
smoke widths of both configurations' layer kinds (``ArchConfig.reduced``
sizes), on weights the benchmark makes.  The test imports both; the
reference imports neither the port nor JAX."""
import json

import pytest
import torch

from portbench import spec
from portbench.reference import model as ref
from portbench.testcell import tiny_cell
from portbench.weights import make_weights


def _arch(port, name):
    from repro_torch.configs.base import (ArchConfig, BlockKind, MoeConfig,
                                          Segment)
    kinds = {"dense": BlockKind.DENSE, "moe": BlockKind.MOE}
    return ArchConfig(
        name=name, n_layers=port["n_layers"], d_model=port["d_model"],
        n_heads=port["n_heads"], kv_heads=port["kv_heads"],
        d_ff=port["d_ff"], vocab=port["vocab"],
        segments=tuple(Segment(kinds[k], n) for k, n in port["segments"]),
        activation=port["activation"], gated_mlp=port["gated_mlp"],
        qkv_bias=port["qkv_bias"], tied_embeddings=port["tied_embeddings"],
        head_dim=port["head_dim"], rope_theta=port["rope_theta"],
        norm_eps=port["norm_eps"],
        moe=MoeConfig(**port["moe"]) if port.get("moe") else None)


@pytest.mark.parametrize("workload", ["moonshot.decode_backlog",
                                      "starcoder2.completion_open"])
def test_reference_equals_the_port_in_float32(workload):
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import forward, logits_fn
    cell = tiny_cell(workload)
    port = cell.port
    arch = _arch(port, cell.config_name)
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
            got = torch.cat([lg for _, _, lg in ref.forward(
                w, port, [s], score_from=[0])])
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_capacity_drops_as_the_port():
    """With a binding capacity the reference drops the same (token,
    choice) pairs as the port's ``moe_apply``."""
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.moe import capacity, moe_apply
    cell = tiny_cell("moonshot.decode_backlog")
    port = dict(cell.port, moe=dict(cell.port["moe"], capacity_factor=0.5))
    arch = _arch(port, "moe")
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


def test_configs_name_the_reference_layer_kinds():
    for w in spec.load_benchmark()["workloads"]:
        port = spec.cell(w["name"]).port
        assert port["attn"] == "gqa"
        assert {k for k, _ in port["segments"]} <= {"dense", "moe"}
        assert port["activation"] in ("silu", "gelu")
        json.dumps(port)
