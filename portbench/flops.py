"""The yardstick: the chip's peaks, and the operations and bytes that the
traffic asks of the model and of each kernel.

Everything here is reckoned from the configuration and the token counts
the harness knows (prompt lengths, every live row's context at every
decode step), never from how the program computes it, so that a later
change that fuses, replaces or removes a kernel is read against the same
work.  A matrix product of m x k by k x n is 2 m k n operations; each
input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2                   # bytes an element in the serving dtype


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the yardstick needs of a configuration's ``port`` block."""
    d: int
    hq: int
    hkv: int
    hd: int
    d_ff: int
    vocab: int
    gated: bool
    layers: tuple[str, ...]            # "dense" or "moe", in order
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    attn: str = "gqa"                  # "gqa" or "mla"
    q_lora: int = 0                    # MLA; 0: q projected from d
    kv_lora: int = 0
    nope: int = 0
    rope: int = 0
    v_dim: int = 0

    @classmethod
    def of(cls, port: dict) -> "Shapes":
        layers = tuple(kind for kind, n in port["segments"]
                       for _ in range(n))
        other = set(layers) - {"dense", "moe"}
        if other:
            raise NotImplementedError(
                f"the yardstick counts dense and moe layers, not "
                f"{sorted(other)}")
        moe = port.get("moe") or {}
        attn = port.get("attn", "gqa")
        mla = port["mla"] if attn == "mla" else {}
        return cls(d=port["d_model"], hq=port["n_heads"],
                   hkv=port["kv_heads"],
                   hd=port.get("head_dim") or port["d_model"]
                   // port["n_heads"],
                   d_ff=port["d_ff"], vocab=port["vocab"],
                   gated=port["gated_mlp"], layers=layers,
                   n_experts=moe.get("n_experts", 0),
                   top_k=moe.get("top_k", 0),
                   d_ff_expert=moe.get("d_ff_expert", 0),
                   d_ff_shared=moe.get("d_ff_shared", 0),
                   attn=attn, q_lora=mla.get("q_lora_rank") or 0,
                   kv_lora=mla.get("kv_lora_rank", 0),
                   nope=mla.get("qk_nope_head_dim", 0),
                   rope=mla.get("qk_rope_head_dim", 0),
                   v_dim=mla.get("v_head_dim", 0))

    @property
    def n_moe(self) -> int:
        return sum(k == "moe" for k in self.layers)

    @property
    def n_attn(self) -> int:
        return len(self.layers)

    def attn_params(self) -> int:
        """One layer's attention projections.  MLA: q_a d q_lora and q_b
        q_lora H (nope + rope) (or d H (nope + rope) without q_lora),
        kv_a d (r + rope), kv_b r H (nope + v), counted once a token (W_uk
        and W_uv absorbed into each query, or applied once to each key),
        and o H v d."""
        if self.attn != "mla":
            return self.d * self.hd * (2 * self.hq + 2 * self.hkv)
        qk = self.hq * (self.nope + self.rope)
        q = (self.d * self.q_lora + self.q_lora * qk if self.q_lora
             else self.d * qk)
        return (q + self.d * (self.kv_lora + self.rope)
                + self.kv_lora * self.hq * (self.nope + self.v_dim)
                + self.hq * self.v_dim * self.d)

    def layer_params(self, kind: str) -> int:
        """Weights one token multiplies by in one layer: attention, and
        the dense MLP or the router, the top-k experts and the shared
        experts."""
        if kind == "moe":
            ffn = (self.d * self.n_experts
                   + self.top_k * 3 * self.d * self.d_ff_expert
                   + 3 * self.d * self.d_ff_shared)
        else:
            ffn = (3 if self.gated else 2) * self.d * self.d_ff
        return self.attn_params() + ffn

    def active_params(self) -> int:
        """Weights one token multiplies by, read-out excluded."""
        return sum(self.layer_params(k) for k in self.layers)

    def attn_flops_per_key(self, prefill: bool = False) -> float:
        """Operations of one query position over one key in one layer:
        GQA q k^T and p v over the head width.  MLA in the cheaper of its
        two forms: a decoded query absorbs W_uk and W_uv, so it scores
        the (r + rope)-wide key and sums the r-wide latent, 2 H (r + rope
        + r); a prefilled prompt expands each of its keys once by kv_b
        (counted in ``attn_params``), then scores (nope + rope) and sums
        v a head, 2 H (nope + rope + v)."""
        if self.attn != "mla":
            return 4.0 * self.hq * self.hd
        if prefill:
            return 2.0 * self.hq * (self.nope + self.rope + self.v_dim)
        return 2.0 * self.hq * (self.kv_lora + self.rope + self.kv_lora)


def attention_flops(s: Shapes, keys: int) -> float:
    """One query position over ``keys`` keys, every layer."""
    return s.attn_flops_per_key() * keys * s.n_attn


def readout_flops(s: Shapes) -> float:
    return 2.0 * s.d * s.vocab


def prompt_flops(s: Shapes, length: int) -> float:
    """A prompt of ``length`` tokens prefilled causally, and its one read
    out (the first token's logits)."""
    causal_keys = length * (length + 1) / 2
    return (2.0 * s.active_params() * length
            + s.attn_flops_per_key(prefill=True) * causal_keys * s.n_attn
            + readout_flops(s))


def decode_flops(s: Shapes, keys: int) -> float:
    """One decode step of one row whose query reads ``keys`` keys."""
    return (2.0 * s.active_params() + attention_flops(s, keys)
            + readout_flops(s))


# -------------------------------------------------------------------------
# kernel work: (operations, bytes) summed over calls
# -------------------------------------------------------------------------

def paged_decode_work(s: Shapes, keys: list[int]) -> tuple[float, float]:
    """One GQA decode step over rows reading ``keys[i]`` keys each, every
    layer: each key and value read once, q read and the output written."""
    k = float(sum(keys))
    flops = s.attn_flops_per_key() * k * s.n_attn
    nbytes = (k * s.hkv * s.hd * 2 * BF16
              + len(keys) * 2 * s.hq * s.hd * BF16) * s.n_attn
    return flops, nbytes


def paged_prefill_work(s: Shapes, lengths: list[int]) -> tuple[float, float]:
    """GQA prompts of ``lengths`` real tokens (padding not counted),
    causal, every layer: q, k and v read once and the output written."""
    keys = sum(n * (n + 1) / 2 for n in lengths)
    toks = float(sum(lengths))
    flops = s.attn_flops_per_key(prefill=True) * keys * s.n_attn
    nbytes = toks * (2 * s.hq + 2 * s.hkv) * s.hd * BF16 * s.n_attn
    return flops, nbytes


def experts_touched(s: Shapes, rows: int) -> float:
    """Experts that ``rows`` tokens route to, in expectation under
    uniform routing: E (1 - (1 - k/E)^rows)."""
    if not s.n_experts or rows <= 0:
        return 0.0
    return s.n_experts * (1.0 - (1.0 - s.top_k / s.n_experts) ** rows)


def group_gemm_work(s: Shapes, rows: int) -> tuple[float, float]:
    """The routed experts' three products for one call of ``rows``
    tokens, every MoE layer: each routed-to expert's weights read once,
    the token's input read and its output written once a choice."""
    if not s.n_experts or rows <= 0:
        return 0.0, 0.0
    pairs = rows * s.top_k
    flops = 2.0 * pairs * 3 * s.d * s.d_ff_expert
    nbytes = (experts_touched(s, rows) * 3 * s.d * s.d_ff_expert
              + pairs * 2 * s.d) * BF16
    return flops * s.n_moe, nbytes * s.n_moe


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bfloat16 peak and bytes over the memory's."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def share(bound: float, seconds: float) -> float | None:
    """A bound's share of a measured time, in percent; None with no
    time."""
    if seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * bound / seconds
