"""Port dense-stripe decode attention vs the JAX package's Pallas kernel
(run in interpret mode, as the JAX tests run it on the CPU) and vs the
JAX plain version: ragged per-slot lengths, a length above the stripe, a
stripe read under ``s_cap``, a length-0 slot and a scalar length.  On the
CPU the port's op runs its plain PyTorch version; the CUDA kernel is held
against that same version on the card by ``tests/test_torch_cuda.py``.

Tolerance: float32 on both sides, atol = rtol = 1e-5 (the two frameworks
sum in different orders; the results agree to about 1e-6)."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attn as jax_decode_attn
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_ref
from repro_torch.kernels.decode_attn import (decode_attn, decode_attn_ref,
                                             kernel)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, b, s, hq, hkv, d):
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return a(b, hq, d), a(b, s, hkv, d), a(b, s, hkv, d)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (4, 256, 4, 1, 16),      # reduced qwen2-0.5b geometry (G=4, D=16)
    (3, 192, 14, 2, 64),     # full-width qwen2-0.5b geometry (G=7, D=64)
    (2, 128, 8, 8, 32),      # MHA
])
def test_decode_matches_pallas_kernel(b, s, hq, hkv, d):
    """Ragged lengths: one token, block edges, and a length above S (a
    retired slot waiting for refill), which masks nothing."""
    rng = np.random.default_rng(s + hq)
    q, k, v = _inputs(rng, b, s, hq, hkv, d)
    ln = np.asarray([1, 64, s + 40, 65][:b], np.int32)
    want = jax_decode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(ln), bs=64)
    got = decode_attn(_t(q), _t(k), _t(v), _t(ln))
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(ln))),
        **TOL)


@pytest.mark.parametrize("s_cap", [64, 100, 128])
def test_s_cap_prunes_rows_as_jax_does(s_cap):
    """``s_cap`` below S: rows at or past it are not read, and a length
    above the cap reads all ``s_cap`` rows, as the JAX op's slice does.
    The Pallas kernel is compared where the cap is a whole number of its
    blocks: at a cap of 100 with blocks of 64 and a length above the cap,
    the interpreted kernel reads the padding of its last block (NaN), so
    there the JAX plain version over the sliced stripe is the reference."""
    rng = np.random.default_rng(s_cap)
    b, s, hq, hkv, d = 4, 256, 4, 1, 16
    q, k, v = _inputs(rng, b, s, hq, hkv, d)
    ln = np.asarray([1, 33, 64, 200], np.int32)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k[:, :s_cap]),
                   jnp.asarray(v[:, :s_cap]), jnp.asarray(ln))
    if s_cap % 64 == 0:
        np.testing.assert_allclose(
            np.asarray(want), np.asarray(jax_decode_attn(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(ln), bs=64, s_cap=s_cap)), **TOL)
    k, v = k.copy(), v.copy()
    k[:, s_cap:] = np.nan                  # rows past the cap: never read
    v[:, s_cap:] = np.nan
    got = decode_attn(_t(q), _t(k), _t(v), _t(ln), s_cap=s_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_length_zero_slot_gives_zeros_as_the_kernel_does():
    """A slot of length 0 reads nothing: zeros from the TPU kernel's
    ``acc / max(l, 1e-30)``, never NaN."""
    rng = np.random.default_rng(3)
    q, k, v = _inputs(rng, 3, 128, 4, 1, 16)
    ln = np.asarray([0, 7, 0], np.int32)
    want = jax_decode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(ln), bs=64)
    got = decode_attn(_t(q), _t(k), _t(v), _t(ln))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got[[0, 2]].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scalar_length_broadcasts():
    rng = np.random.default_rng(4)
    q, k, v = _inputs(rng, 2, 128, 4, 1, 16)
    want = jax_decode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           70, bs=64)
    got = decode_attn(_t(q), _t(k), _t(v), 70)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    per_slot = decode_attn_ref(_t(q), _t(k), _t(v), torch.tensor([70, 70]))
    np.testing.assert_array_equal(got.numpy(), per_slot.numpy())


def test_op_keeps_the_query_dtype_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (_t(a).to(torch.bfloat16)
               for a in _inputs(rng, 2, 64, 4, 1, 16))
    out = decode_attn(q, k, v, torch.tensor([3, 64], dtype=torch.int32))
    assert out.dtype == torch.bfloat16
    want = decode_attn_ref(q.float(), k.float(), v.float(),
                           torch.tensor([3, 64]))
    assert (out.float() - want).abs().max() < 2e-2


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors only, and builds
    nothing before its checks pass."""
    q = torch.zeros(2, 4, 16)
    kv = torch.zeros(2, 8, 1, 16)
    ln = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        kernel.decode_attn_cuda(q, kv, kv, ln, 8)
    assert kernel._ext is None


def test_build_dir_is_under_the_ignored_build_tree():
    root = pathlib.Path(__file__).resolve().parents[1]
    assert kernel.build_dir() == root / "build" / "decode_attn"
    assert (root / "src/repro_torch/kernels/decode_attn/csrc/"
            "decode_attn.cu").is_file()
