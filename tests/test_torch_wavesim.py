"""Port DGM wave step vs the JAX package: the fused operator (exactly),
the core volume, flux and step (float32), the volume op against the JAX
Pallas kernel and the flux1d op against the JAX op (interpret mode, as
the JAX tests run them on the CPU), the volume kernel's 7-point stencil
(taken from every fused operator exactly, refused off its pattern, the
op's cached copy), the constant-field zeros and linearity, and the
40-step demo of ``examples/wave_demo.py`` against the
port's ``launch.wave_demo.run``.  On the CPU the port's ops run the
kernels' plain versions; the CUDA kernels are held against those same
versions on the card by ``tests/test_torch_cuda.py``.

Tolerances: 1e-6 for the core functions in float32 (the same operations,
in another order inside the einsums); 1e-5 for the volume op in float32
(27-term sums in another order); bfloat16 within one unit in the last
place of the output (both sides sum the same rounded operator and values
in float32 and round once, so they differ only where the two float32
sums straddle a rounding boundary); flux1d at alpha 0.5 exactly in
float32; 1e-5 for the 40-step demo."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.primitives import wavesim as jax_wavesim
from repro.kernels.wavesim_flux import flux1d as jax_flux1d
from repro.kernels.wavesim_volume import volume as jax_volume
from repro.kernels.wavesim_volume.kernel import (
    fused_operator as jax_fused_operator)
from repro_torch.core.primitives import wavesim
from repro_torch.kernels import wavesim_flux, wavesim_volume
from repro_torch.launch import wave_demo

torch.set_num_threads(1)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x) -> np.ndarray:
    """float32 numpy copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    m = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def _within_one_bf16_ulp(got, want) -> bool:
    got, want = _np(got), _np(want)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    return bool((np.abs(got - want) <= ulp).all())


def _lines_agree(got: list[str], want: list[str]) -> bool:
    """The same energy lines to their printed precision: the same steps,
    each number within one unit of its last printed place (float32 sums
    taken in another order may round the last digit the other way)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        gn, wn = re.findall(r"-?[\d.]+", g), re.findall(r"-?[\d.]+", w)
        if len(gn) != len(wn) or gn[0] != wn[0]:
            return False
        for a, b in zip(gn[1:], wn[1:]):
            places = len(a.split(".")[1]) if "." in a else 0
            if abs(float(a) - float(b)) > 1.01 * 10.0 ** -places:
                return False
    return True


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_fused_operator_equals_jax(dtype, c):
    """Array for array: the port's [27, 27] operator is the leading block
    of JAX's, whose other lanes are the TPU's zero padding; rounded to
    bfloat16 the same way."""
    tdt, jdt = _DT[dtype]
    got = wavesim_volume.fused_operator(c, tdt)
    want = _np(jax_fused_operator(c, jdt))
    assert got.dtype == tdt and got.shape == (27, 27)
    np.testing.assert_array_equal(_np(got), want[:27, :27])
    assert not want[27:].any() and not want[:, 27:].any()


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("c", [1.0, 0.7, -2.5])
def test_stencil_operator_takes_every_fused_operator(dtype, c):
    """Every W that ``fused_operator`` builds lies on the 7-point pattern:
    ``stencil_operator`` takes its 189 values, zeros on the pattern (the
    centre node's diagonal) included, as float32."""
    tdt, _ = _DT[dtype]
    s = wavesim_volume.stencil_operator(wavesim_volume.fused_operator(c, tdt))
    assert s.shape == (189,) and s.dtype == torch.float32
    assert s.is_contiguous() and s.device.type == "cpu"
    nodes = wavesim_volume.kernel.STENCIL_NODES
    assert nodes.shape == (27, 7)
    for j in range(27):                 # ascending, j itself among them
        assert list(nodes[j]) == sorted(set(nodes[j])) and j in nodes[j]
    centre = 13 * 7 + list(nodes[13]).index(13)
    assert float(s[centre]) == 0.0


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("c", [1.0, 0.7, -2.5])
def test_stencil_scattered_back_equals_w(dtype, c):
    """The 189 values put back at (STENCIL_NODES[j, t], j), zeros
    elsewhere, give W exactly."""
    tdt, _ = _DT[dtype]
    w = wavesim_volume.fused_operator(c, tdt)
    s = wavesim_volume.stencil_operator(w)
    nodes = wavesim_volume.kernel.STENCIL_NODES
    back = torch.zeros(27, 27)
    back[torch.from_numpy(nodes.reshape(-1)),
         torch.arange(27).repeat_interleave(7)] = s
    assert torch.equal(back, w.float())


@pytest.mark.parametrize("entry,value", [((0, 26), 0.5), ((26, 0), -1e-30),
                                         ((4, 20), float("nan")),
                                         ((13, 0), 2.0)])
def test_stencil_operator_refuses_off_pattern(entry, value):
    """One nonzero (or NaN) entry where the two nodes differ in two or
    three of (i, j, k) raises; so do a W on the wrong shape and a
    non-tensor."""
    w = wavesim_volume.fused_operator(0.7).clone()
    w[entry] = value
    with pytest.raises(ValueError):
        wavesim_volume.stencil_operator(w)
    with pytest.raises(ValueError):
        wavesim_volume.stencil_operator(torch.zeros(27, 32))
    with pytest.raises(TypeError):
        wavesim_volume.stencil_operator(np.zeros((27, 27)))


def test_stencil_chain_computes_the_dense_product():
    """Each output as the sum of its 7 stencil terms, in float64, equals x
    @ W: the stencil's node order pairs each value with its input."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((50, 27)))
    w = wavesim_volume.fused_operator(-2.5).double()
    s = wavesim_volume.stencil_operator(w).double().view(27, 7)
    nodes = torch.from_numpy(wavesim_volume.kernel.STENCIL_NODES)
    got = (x[:, nodes] * s).sum(-1)
    torch.testing.assert_close(got, x @ w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_volume_op_caches_its_stencil(dtype, c):
    """The op builds W and its stencil once for each (c, dtype): the
    cached pair is the same object on a second call and equals a fresh
    one."""
    tdt, _ = _DT[dtype]
    w, s = wavesim_volume.ops.operator(c, tdt)
    assert wavesim_volume.ops.operator(c, tdt)[1] is s
    fresh = wavesim_volume.fused_operator(c, tdt)
    assert torch.equal(w, fresh)
    assert torch.equal(s, wavesim_volume.stencil_operator(fresh))


def test_problem_sizes_match_jax():
    for grid, fields in (((40, 40, 40), 27), ((3, 5, 2), 2)):
        got = wavesim.Problem(grid, fields)
        want = jax_wavesim.Problem(grid, fields)
        for name in ("n_elements", "points_per_element", "volume_bytes",
                     "face_points", "flux_bytes"):
            assert getattr(got, name) == getattr(want, name), name
    assert (wavesim.ELEM_BYTES, wavesim.NODES_1D, wavesim.NODES,
            wavesim.DEFAULT_FIELDS) == (jax_wavesim.ELEM_BYTES,
                                        jax_wavesim.NODES_1D,
                                        jax_wavesim.NODES,
                                        jax_wavesim.DEFAULT_FIELDS)
    np.testing.assert_array_equal(
        wavesim.reference_operator().numpy(),
        np.asarray(jax_wavesim.reference_operator()))


@pytest.mark.parametrize("grid,fields", [((4, 4, 4), 3), ((3, 5, 2), 2)])
@pytest.mark.parametrize("fn", ["volume", "flux", "step"])
def test_core_functions_match_jax(grid, fields, fn):
    """The plain volume, flux and step on non-cubic grids too (a wrong
    axis shows), float32 at 1e-6."""
    rng = np.random.default_rng(sum(grid) + fields)
    u = rng.standard_normal(grid + (fields, 3, 3, 3)).astype(np.float32)
    if fn == "volume":
        u = u.reshape((-1, fields, 3, 3, 3))
        got = wavesim.volume(torch.from_numpy(u), 0.7)
        want = jax_wavesim.volume(jnp.asarray(u), 0.7)
    elif fn == "flux":
        got = wavesim.flux(torch.from_numpy(u), 0.3)
        want = jax_wavesim.flux(jnp.asarray(u), 0.3)
    else:
        got = wavesim.step(torch.from_numpy(u), dt=1e-2, c=0.7, alpha=0.3)
        want = jax_wavesim.step(jnp.asarray(u), dt=1e-2, c=0.7, alpha=0.3)
    assert got.shape == u.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("e,f", [(1, 1), (8, 9), (65, 27), (256, 3)])
@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_volume_op_matches_jax_kernel(e, f, dtype, c):
    """The op against the Pallas kernel in interpret mode on JAX's own
    sweep: float32 at 1e-5, bfloat16 within one ulp of the output."""
    tdt, jdt = _DT[dtype]
    rng = np.random.default_rng(e * 31 + f)
    u = rng.standard_normal((e, f, 3, 3, 3)).astype(np.float32)
    u_t = torch.from_numpy(u).to(tdt)
    got = wavesim_volume.volume(u_t, c)
    want = jax_volume(jnp.asarray(u, jdt), c)
    assert got.shape == u.shape and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert _within_one_bf16_ulp(got, want)


def test_volume_op_against_the_core_einsums():
    """The op (fused operator) against the three einsums of the core
    volume it fuses, float32."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((40, 5, 3, 3, 3)).astype(
        np.float32))
    for c in (1.0, 0.7):
        np.testing.assert_allclose(wavesim_volume.volume(u, c).numpy(),
                                   wavesim_volume.volume_ref(u, c).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("e,t", [(1, 9), (4, 9), (256, 36), (600, 27),
                                 (1024, 128)])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_flux1d_op_matches_jax(e, t, dtype):
    """Periodic neighbours at every E, the seam (600 is no multiple of
    JAX's 256-element tile) and E = 1 (each element its own neighbour):
    float32 exactly, bfloat16 within one ulp, at alpha 0.5."""
    tdt, jdt = _DT[dtype]
    rng = np.random.default_rng(e + t)
    hi = rng.standard_normal((e, t)).astype(np.float32)
    lo = rng.standard_normal((e, t)).astype(np.float32)
    got = wavesim_flux.flux1d(torch.from_numpy(hi).to(tdt),
                              torch.from_numpy(lo).to(tdt), 0.5)
    want = jax_flux1d(jnp.asarray(hi, jdt), jnp.asarray(lo, jdt), 0.5)
    for g, w in zip(got, want):
        assert g.shape == (e, t) and g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            assert _within_one_bf16_ulp(g, w)


def test_flux1d_single_element_is_its_own_neighbour():
    hi = torch.tensor([[1.0, 2.0, 3.0]])
    lo = torch.tensor([[0.5, -1.0, 4.0]])
    fhi, flo = wavesim_flux.flux1d(hi, lo, 0.5)
    torch.testing.assert_close(fhi, 0.5 * (lo - hi), rtol=0, atol=0)
    torch.testing.assert_close(flo, 0.5 * (hi - lo), rtol=0, atol=0)


def test_constant_field_gives_zero_volume_and_flux():
    """Constant fields have no jumps and no gradient: the core flux is
    exactly zero, the core volume and the volume op zero to 1e-5 (as
    ``tests/test_primitives.py`` holds the JAX functions)."""
    u = torch.ones((4, 4, 4, 2, 3, 3, 3))
    assert float(wavesim.flux(u).abs().max()) == 0.0
    flat = torch.ones((8, 2, 3, 3, 3))
    np.testing.assert_allclose(wavesim.volume(flat).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(wavesim_volume.volume(flat).numpy(), 0.0,
                               atol=1e-5)
    fhi, flo = wavesim_flux.flux1d(torch.ones(5, 9), torch.ones(5, 9))
    assert float(fhi.abs().max()) == 0.0 and float(flo.abs().max()) == 0.0


def test_volume_op_is_linear():
    """volume(2u + 3v) == 2 volume(u) + 3 volume(v), as
    ``tests/test_kernels_wavesim.py`` holds the JAX op (1e-4)."""
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((4, 9, 3, 3, 3)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 9, 3, 3, 3)).astype(
        np.float32))
    vol = wavesim_volume.volume
    np.testing.assert_allclose(vol(2.0 * u + 3.0 * v).numpy(),
                               (2.0 * vol(u) + 3.0 * vol(v)).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_volume_op_shapes_and_refusals():
    assert wavesim_volume.volume(torch.zeros(0, 3, 3, 3, 3)).shape == (
        0, 3, 3, 3, 3)
    with pytest.raises(ValueError):
        wavesim_volume.volume(torch.zeros(4, 3, 27))
    with pytest.raises(ValueError):
        wavesim_flux.flux1d(torch.zeros(4, 9), torch.zeros(4, 8))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (the ops send CPU
    tensors to the plain versions); they raise before building anything."""
    x = torch.zeros(4, 27)
    with pytest.raises(ValueError):
        wavesim_volume.kernel.volume_cuda(x, wavesim_volume.fused_operator())
    with pytest.raises(ValueError):
        wavesim_volume.kernel.volume_cuda(
            x, wavesim_volume.ops.operator(1.0, torch.float32)[1])
    with pytest.raises(ValueError):
        wavesim_flux.kernel.flux1d_cuda(x, x)


def _jax_demo(steps: int) -> tuple[np.ndarray, list[str]]:
    """``examples/wave_demo.py``'s loop: the Pallas volume op (interpret
    mode) and the functional flux, with its energy lines."""
    g, fields = (8, 8, 8), 3
    u = np.zeros(g + (fields, 3, 3, 3), np.float32)
    for i in range(g[0]):
        for j in range(g[1]):
            for k in range(g[2]):
                r2 = (i - 4) ** 2 + (j - 4) ** 2 + (k - 4) ** 2
                u[i, j, k, 0] = np.exp(-r2 / 4.0)
    u = jnp.asarray(u)
    lines = []
    for step in range(steps):
        flat = u.reshape((-1, fields, 3, 3, 3))
        rhs_v = jax_volume(flat).reshape(u.shape)
        rhs_f = jax_wavesim.flux(u)
        u = u + 5e-3 * (rhs_v + rhs_f)
        if step % 10 == 0:
            e = np.asarray(jnp.sum(jnp.square(u), axis=(3, 4, 5, 6)))
            lines.append(f"step {step:3d}: energy center={e[4, 4, 4]:8.4f} "
                         f"shell={e[1, 4, 4]:8.4f} total={e.sum():9.3f}")
    return np.asarray(u), lines


def test_wave_demo_matches_jax_demo():
    """40 steps of the demo on the CPU: u within 1e-5 of the JAX loop and
    the same energy lines to their printed precision."""
    res = wave_demo.run(device="cpu", verbose=False)
    want_u, want_lines = _jax_demo(40)
    assert res["u"].shape == want_u.shape and res["u"].dtype == torch.float32
    np.testing.assert_allclose(res["u"].numpy(), want_u, rtol=0, atol=1e-5)
    assert _lines_agree(res["energy"], want_lines)
    assert res["ms_per_step"] > 0 and res["device"] == "cpu"


def test_wave_demo_initial_state_and_cli(capsys, monkeypatch):
    """The pulse equals the demo's float32 array; the CLI runs on the CPU
    and prints the demo's lines; a CUDA request without a GPU raises."""
    u0 = wave_demo.initial_state((8, 8, 8), 3, device="cpu")
    want = np.zeros((8, 8, 8, 3, 3, 3, 3), np.float32)
    for i in range(8):
        for j in range(8):
            for k in range(8):
                want[i, j, k, 0] = np.exp(
                    -((i - 4) ** 2 + (j - 4) ** 2 + (k - 4) ** 2) / 4.0)
    np.testing.assert_array_equal(u0.numpy(), want)
    seeded = wave_demo.initial_state((2, 3, 4), 2, device="cpu", seed=5)
    assert seeded.shape == (2, 3, 4, 2, 3, 3, 3)
    assert torch.equal(seeded, wave_demo.initial_state(
        (2, 3, 4), 2, device="cpu", seed=5))
    monkeypatch.setattr("sys.argv", ["wave_demo", "--device", "cpu",
                                     "--steps", "11"])
    wave_demo.main()
    out = capsys.readouterr().out
    assert "step   0: energy center=" in out and "step  10:" in out
    assert "[wave] grid 8x8x8, 3 fields, 11 steps, float32 on cpu" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            wave_demo.run(steps=1)
