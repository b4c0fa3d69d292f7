"""A configuration reaches the port through one builder (``spec.arch``),
and a new one, of any layer kind the port's ``ArchConfig`` has, needs new
files only: a DeepSeek-shaped configuration with MLA and its own
``"reference"``, written beside a copy of ``BENCHMARK.json`` in a
temporary directory, runs through the harness on the CPU to a result
line."""
import json
import shutil

import pytest

from portbench import spec
from portbench.testcell import run_tiny, tiny_cell, tiny_port

CONFIGS = {c["name"]: c["file"] for c in spec.load_benchmark()["configs"]}


def _as_built_before(name, port):
    """The ``ArchConfig`` the harness built from the GQA keys it knew,
    before the builder."""
    from repro_torch.configs.base import (ArchConfig, BlockKind, MoeConfig,
                                          Segment)
    kinds = {"dense": BlockKind.DENSE, "moe": BlockKind.MOE}
    moe = port.get("moe")
    return ArchConfig(
        name=name, n_layers=port["n_layers"], d_model=port["d_model"],
        n_heads=port["n_heads"], kv_heads=port["kv_heads"],
        d_ff=port["d_ff"], vocab=port["vocab"],
        segments=tuple(Segment(kinds[k], n) for k, n in port["segments"]),
        activation=port["activation"], gated_mlp=port["gated_mlp"],
        qkv_bias=port["qkv_bias"], tied_embeddings=port["tied_embeddings"],
        head_dim=port["head_dim"], rope_theta=port["rope_theta"],
        norm_eps=port["norm_eps"],
        moe=MoeConfig(**moe) if moe else None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_builder_equals_the_harness_before_it(name):
    port = json.loads((spec.ROOT / CONFIGS[name]).read_text())["port"]
    assert spec.arch(name, port) == _as_built_before(name, port)


# DeepSeek-V3 (hf:deepseek-ai/DeepSeek-V3 config.json) at published
# widths, one dense and two MoE layers
DEEPSEEK = {
    "n_layers": 3, "d_model": 7168, "n_heads": 128, "kv_heads": 128,
    "head_dim": None, "d_ff": 18432, "vocab": 129280,
    "segments": [["dense", 1], ["moe", 2]], "attn": "mla",
    "activation": "silu", "gated_mlp": True, "qkv_bias": False,
    "tied_embeddings": False, "rope_theta": 10000.0, "norm_eps": 1e-6,
    "mla": {"q_lora_rank": 1536, "kv_lora_rank": 512,
            "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "v_head_dim": 128},
    "moe": {"n_experts": 256, "top_k": 8, "d_ff_expert": 2048,
            "n_shared_experts": 1, "d_ff_shared": 2048,
            "capacity_factor": 1.25},
    "dtype": "bfloat16"}


def test_builder_maps_every_block_and_names_an_unknown_key():
    from repro_torch.configs.base import AttnKind, BlockKind, MlaConfig
    arch = spec.arch("ds", DEEPSEEK)
    assert arch.attn is AttnKind.MLA
    assert arch.mla == MlaConfig(**DEEPSEEK["mla"])
    assert [s.kind for s in arch.segments] == [BlockKind.DENSE,
                                                BlockKind.MOE]
    hybrid = spec.arch("z", dict(
        DEEPSEEK, attn="gqa", mla=None, moe=None, shared_attn_every=2,
        segments=[["ssm", 2], ["shared", 1]],
        ssm={"d_state": 64, "head_dim": 64}))
    assert [s.kind for s in hybrid.segments] == [BlockKind.SSM,
                                                  BlockKind.SHARED_ATTN]
    assert (hybrid.ssm.d_state, hybrid.shared_attn_every) == (64, 2)
    # a key the port has no field for would run another model
    with pytest.raises(ValueError, match="'sliding_window'"):
        spec.arch("ds", dict(DEEPSEEK, sliding_window=4096))
    with pytest.raises(ValueError, match="'moe.router_experts'"):
        spec.arch("ds", dict(DEEPSEEK, moe=dict(DEEPSEEK["moe"],
                                                router_experts=256)))
    with pytest.raises(ValueError, match="'mla.rope_dim'"):
        spec.arch("ds", dict(DEEPSEEK, mla=dict(DEEPSEEK["mla"],
                                                rope_dim=64)))


def test_tiny_port_shrinks_every_block():
    tiny = tiny_port("ds", DEEPSEEK)
    assert tiny["segments"] == [["dense", 1], ["moe", 2]]
    assert tiny["mla"] == {"q_lora_rank": 32, "kv_lora_rank": 16,
                           "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
                           "v_head_dim": 8}
    assert (tiny["moe"]["n_experts"], tiny["moe"]["top_k"]) == (8, 2)
    assert (tiny["d_model"], tiny["kv_heads"], tiny["vocab"]) == (64, 4, 256)
    ssm = tiny_port("m", dict(DEEPSEEK, attn="gqa", mla=None, moe=None,
                              segments=[["ssm", 48], ["shared", 1]],
                              shared_attn_every=6,
                              ssm={"d_state": 128, "chunk": 256}))
    assert ssm["segments"] == [["ssm", 2], ["shared", 1]]
    assert ssm["ssm"] == {"d_state": 16, "chunk": 8}
    assert ssm["shared_attn_every"] == 2


STANDIN = '''"""A stand-in reference: the port's own float32 forward."""
import torch

COVERS = {"attn": ["mla"], "segments": ["dense", "moe"],
          "activation": ["silu"]}
CALLS = []


def forward(weights, port, seqs, *, score_from, fp8=False):
    from portbench import spec
    from repro_torch.models.transformer import forward as run, logits_fn
    arch = spec.arch("standin", port)
    CALLS.append(len(seqs))
    with torch.no_grad():
        for i, s in enumerate(seqs):
            hidden, _ = run(weights, {"tokens": torch.tensor([s])}, arch,
                            dtype=torch.float32)
            at = score_from[i]
            yield i, at, logits_fn(weights, hidden, arch)[0, at:]
'''


def _write_cell(root, name, workload, config):
    """A copy of ``BENCHMARK.json`` under ``root`` with one more
    configuration and one more backlog cell on it, and their files."""
    bench = spec.load_benchmark()
    bench["configs"].append({
        "name": name, "source": "https://huggingface.co/deepseek-ai/"
        "DeepSeek-V3/blob/main/config.json",
        "file": f"portbench/configs/{name}.json", "reduced": [],
        "why": "a configuration added with new files only"})
    bench["workloads"].append({"name": workload, "config": name,
                               "traffic": "decode_backlog", "chips": 1,
                               "why": "a backlog on it"})
    for m in bench["end_to_end"]:
        if m["name"] in ("output_tok_s", "tpot_p95_ms"):
            m["workloads"].append(workload)
    own = root / "portbench"
    for sub in ("configs", "limits", "reference"):
        (own / sub).mkdir(parents=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (own / "configs" / f"{name}.json").write_text(json.dumps(config))
    (own / "limits" / f"{workload}.json").write_text(json.dumps(
        {"logit_gap_max": {"limit": 0.05}, "sample_requests": 4,
         "min_tokens": 10}))
    (own / "reference" / "standin.py").write_text(STANDIN)
    shutil.copy(spec.HERE / "reference" / "__init__.py",
                own / "reference" / "__init__.py")


def test_a_new_mla_configuration_needs_new_files_only(tmp_path):
    name, workload = "deepseek-v3-share", "deepseek-v3-share.decode_backlog"
    _write_cell(tmp_path, name, workload,
                {"name": name, "reference": "standin", "port": DEEPSEEK})
    cell = tiny_cell(workload, root=tmp_path)
    assert cell.reference.COVERS["attn"] == ["mla"]
    assert cell.port["attn"] == "mla" and cell.port["mla"]["kv_lora_rank"]
    out = run_tiny(workload, 3, cell=cell)
    assert cell.reference.CALLS, "the check read another reference"
    assert out["correct"], out["checks"]
    assert out["checks"]["tokens_compared"]["value"] >= 10
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "output_tok_s",
                                   "tpot_p95_ms"}
    assert list(out)[-1] == "checks"


def test_a_layer_kind_the_yardstick_cannot_count_is_refused_first(tmp_path):
    """SSM and shared-block layers are built, but their work is not
    counted, so such a cell is refused at discovery, before the set-up and
    the window that a run would spend on it."""
    name, workload = "zamba2-like", "zamba2-like.decode_backlog"
    port = dict(DEEPSEEK, attn="gqa", mla=None, moe=None, head_dim=None,
                segments=[["ssm", 4], ["shared", 1]], shared_attn_every=2,
                ssm={"d_state": 64})
    _write_cell(tmp_path, name, workload,
                {"name": name, "reference": "standin", "port": port})
    with pytest.raises(NotImplementedError, match="'shared', 'ssm'"):
        spec.cell(workload, tmp_path)
