"""Public dense-stripe decode-attention op and the attention routing
policy, from :mod:`repro.kernels.decode_attn.ops`.

``decode_attn`` takes one shared length or per-slot lengths ([B] int32),
and ``s_cap``, a host-known bound on the deepest live slot that the caller
passes down (the JAX policy's ``kv_cap``): no row at or past it is read.

:class:`DecodeAttnPolicy` is how the model's attention layer picks a
route for every attention op, dense and paged, and how the paged ops find
a tuned launch.  ``mode``:

* ``"auto"`` (the default): the hand-written kernel on a CUDA tensor, the
  plain PyTorch version on a CPU tensor;
* ``"kernel"``: the kernel, and a CPU tensor raises: there is no
  interpreter to fall back to, and no fallback;
* ``"plain"`` (JAX's ``"xla"``): gather, then the plain PyTorch attention,
  on either device, only because the caller asked for it.  Nothing
  switches to it when a kernel fails.

The policy is a Python global read when an op is called, so a call
captured in a CUDA graph bakes in the route and the tuned launch of the
policy active at capture, as JAX resolves them at trace time.  The JAX
policy's ``interpret`` and ``block_size`` have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from . import kernel, ref

MODES = ("auto", "kernel", "plain")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length, *, s_cap: int | None = None) -> torch.Tensor:
    """q: [B, Hq, D] one-token queries; k/v: [B, S, Hkv, D] stripes; slot b
    attends over the first ``length[b]`` rows (a scalar length is
    broadcast; a length above the rows read masks nothing).  ``s_cap``
    bounds the rows read to the first ``s_cap``, a host-known bound on the
    deepest live slot, as the JAX op's grid pruning does.  Routes by the
    active policy (:meth:`DecodeAttnPolicy.kernel_wanted`): the kernel, or
    the plain version.  Returns q's dtype."""
    s = k.shape[1]
    cap = s if s_cap is None else min(int(s_cap), s)
    if active_policy().kernel_wanted(q.device):
        b = q.shape[0]
        ln = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1)
        return kernel.decode_attn_cuda(q.contiguous(), k, v,
                                       ln.expand(b).contiguous(), cap)
    return ref.decode_attn_ref(q, k[:, :cap], v[:, :cap],
                               length).to(q.dtype)


# --------------------------------------------------------------------------
# routing policy (read by repro_torch.models.attention at call time)
# --------------------------------------------------------------------------

def _int_in(value, allowed) -> bool:
    """``value`` is an int (not a bool) among ``allowed``."""
    return (isinstance(value, int) and not isinstance(value, bool)
            and value in allowed)


@dataclasses.dataclass(frozen=True)
class DecodeAttnPolicy:
    mode: str = "auto"              # "auto" | "kernel" | "plain"
    use_tuned: bool = True          # consult the autotuned-launch cache
    tuned_path: str | None = None   # None -> committed default (env wins)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"attention mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        # resolve the tuned-launch table once, at policy construction: ops
        # then do a dict lookup per call shape, never file I/O.  A missing
        # or corrupt cache (or REPRO_TORCH_TUNED_SHAPES=off) degrades to
        # the default launches; it must never break routing.
        entries: dict = {}
        if self.use_tuned:
            try:
                from ..paged_attn.autotune import load_entries
                entries = load_entries(self.tuned_path)
            except Exception:
                entries = {}
        object.__setattr__(self, "_tuned", entries)
        object.__setattr__(self, "_lookups", {})   # key -> sanitized cfg

    def tuned_config(self, op: str, *, hq: int, hkv: int, d: int,
                     page_size: int, lg: int | None = None,
                     backend: str = "cuda") -> dict | None:
        """The tuned launch for ``(backend, op, geometry)``, or None on a
        miss.  ``backend`` is the tensors' device type.  A malformed entry
        degrades field by field, as in JAX: a non-dict entry misses, an
        empty or non-dict config misses, and a knob outside the values the
        kernels take (``ctas_per_sm`` in 1, 2, 4, 8, ``cta_rows`` in 1, 2,
        4, ``block_rows`` in 16, 32, 64) is dropped; the ops read no other
        field.  Unlike JAX's, ``block_rows`` need not divide the fused row
        count ``lg``: the kernels' last row block may be ragged, so ``lg``
        stays in the signature only.  Lookups are memoised per key, so an
        eager call pays a dict lookup."""
        key = (backend, op, hq, hkv, d, page_size)
        if key not in self._lookups:
            self._lookups[key] = self._sanitized(
                self._tuned.get(f"{backend}|{op}|"
                                f"hq{hq}.hkv{hkv}.d{d}.ps{page_size}"))
        cfg = self._lookups[key]
        return dict(cfg) if cfg else None

    @staticmethod
    def _sanitized(ent) -> dict | None:
        from ..paged_attn.kernel import BLOCK_ROWS_CHOICES
        from ..paged_attn.split import CTA_ROWS_CHOICES, CTAS_PER_SM_CHOICES
        if not isinstance(ent, dict):
            return None
        cfg = ent.get("config") or {}
        if not isinstance(cfg, dict):
            return None
        cfg = dict(cfg)
        for name, values in (("ctas_per_sm", CTAS_PER_SM_CHOICES),
                             ("cta_rows", CTA_ROWS_CHOICES),
                             ("block_rows", BLOCK_ROWS_CHOICES)):
            if name in cfg and not _int_in(cfg[name], values):
                del cfg[name]
        return cfg or None

    def kernel_wanted(self, device: torch.device) -> bool:
        """Whether an op on tensors of ``device`` takes its kernel."""
        if self.mode == "plain":
            return False
        if device.type == "cuda":
            return True
        if self.mode == "kernel":
            raise RuntimeError(
                "attention mode 'kernel' on a CPU tensor: the CUDA kernels "
                "have no CPU version to run; use mode 'auto' or 'plain'")
        return False


_ACTIVE = DecodeAttnPolicy()


def active_policy() -> DecodeAttnPolicy:
    return _ACTIVE


@contextlib.contextmanager
def decode_attn_policy(policy: DecodeAttnPolicy | None = None, **kw):
    """Install ``policy``, or the active one with the fields ``kw``
    replaced, for the calls made inside this context (a CUDA graph
    captured inside bakes it in).  A replacement reloads the tuned cache
    (memoised by path, mtime and size); a policy object keeps the entries
    it loaded when it was built."""
    global _ACTIVE
    prev = _ACTIVE
    if policy is None:
        policy = dataclasses.replace(
            prev, **{k: v for k, v in kw.items()
                     if v is not None or k == "tuned_path"})
    elif kw:
        raise TypeError("pass a policy or fields to replace, not both")
    _ACTIVE = policy
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev
