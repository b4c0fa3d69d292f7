"""Port vector-sum vs the JAX package: the op against the JAX op (its
Pallas kernel in interpret mode, as the JAX tests run it on the CPU), bit
for bit; any shape; the shape check; the empty input.  On the CPU the
port's op runs the kernel's plain version, ``a + b``; the CUDA kernel is
held against that same version on the card by ``tests/test_torch_cuda.py``.
Each side adds two values of the dtype and rounds once, which is the
correctly rounded sum, so the tolerance is zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.primitives import vector_sum as jax_core
from repro.kernels.vector_sum import vector_sum as jax_vector_sum
from repro_torch.core.primitives import vector_sum as core
from repro_torch.kernels import vector_sum as vs

torch.set_num_threads(1)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16),
       "float16": (torch.float16, jnp.float16)}


def _pair(rng, shape, dtype):
    tdt, jdt = _DT[dtype]
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return ((torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)),
            (jnp.asarray(a, jdt), jnp.asarray(b, jdt)))


def _bits(x) -> np.ndarray:
    """The values' bit patterns (compares NaN and -0 as well)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("n", [1, 7, 512, 4096, 10_000])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_vector_sum_matches_jax_bit_for_bit(n, dtype):
    rng = np.random.default_rng(n)
    (a, b), (ja, jb) = _pair(rng, n, dtype)
    got = vs.vector_sum(a, b)
    want = jax_vector_sum(ja, jb)
    assert got.dtype == a.dtype and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(core.reference(a, b)), _bits(want))


def test_vector_sum_any_shape():
    rng = np.random.default_rng(0)
    (a, b), (ja, jb) = _pair(rng, (3, 5, 7), "float32")
    got = vs.vector_sum(a, b)
    assert got.shape == (3, 5, 7)
    np.testing.assert_array_equal(_bits(got), _bits(jax_vector_sum(ja, jb)))


def test_vector_sum_rejects_a_shape_mismatch():
    with pytest.raises(ValueError, match="shape mismatch"):
        vs.vector_sum(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_vector_sum(jnp.zeros(4), jnp.zeros(5))


def test_vector_sum_of_empty_inputs():
    before = vs.launch_counts["vector_sum"]
    out = vs.vector_sum(torch.zeros(0, dtype=torch.float16),
                        torch.zeros(0, dtype=torch.float16))
    assert out.shape == (0,) and out.dtype == torch.float16
    assert vs.launch_counts["vector_sum"] == before


def test_problem_and_cuda_wrapper_refusal():
    """The paper's problem size in bytes as JAX reckons it; the kernel's
    wrapper takes CUDA tensors only and raises before building anything."""
    for n in (1, 64 << 20):
        assert (core.Problem(n).bytes_per_array
                == jax_core.Problem(n).bytes_per_array)
    assert core.ELEM_BYTES == jax_core.ELEM_BYTES
    with pytest.raises(ValueError):
        vs.kernel.vector_sum_cuda(torch.zeros(4), torch.zeros(4))
