"""Port parity: vrdd_tpu_torch.kernels.slice_kernel against
vrdd_tpu.pallas.slice_kernel on the same numpy inputs.

On the CPU each wrapper takes its plain torch version; the JAX kernels run
under the Pallas TPU interpreter, as tests/test_hist_decode.py runs them.
The CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.pallas import slice_kernel as jk
from vrdd_tpu_torch.convert import state_from_jax
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import slice_kernel as tk
from vrdd_tpu_torch.models.hist_renderer import HistRenderer

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
W = H = 128


def _hist(nz=16, B=8, seed=0, dtype=jnp.float32):
    """Random normalized bins-major histograms, as a numpy array in the JAX
    storage dtype (ml_dtypes.bfloat16 for bf16)."""
    rng = np.random.default_rng(seed)
    h = rng.random((nz, B, nz, nz)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    return np.asarray(jnp.asarray(h).astype(dtype))


FAMILIES = ["raw", "fractal", "flex", "unit"]
STATS = ["mean", "var", "entropy"]


@pytest.mark.parametrize("family,stat", list(itertools.product(FAMILIES, STATS)))
def test_decode_weight_rows_exact(family, stat):
    rows, mode = tk.decode_weight_rows(stat, 16, family=family)
    ref_rows, ref_mode = jk.decode_weight_rows(stat, 16, family=family)
    assert mode == ref_mode
    assert rows.dtype == ref_rows.dtype
    np.testing.assert_array_equal(rows, ref_rows)


@pytest.mark.parametrize("stat,dtype", list(itertools.product(
    STATS, ["float32", "bfloat16"])))
def test_decode_with_rows_matches_jax(stat, dtype):
    h = _hist(B=16, seed=4, dtype=getattr(jnp, dtype))
    rows, mode = jk.decode_weight_rows(stat, 16, family="unit")
    ref = np.asarray(jk.decode_with_rows(jnp.asarray(h), rows, mode))
    got = tk.decode_with_rows(state_from_jax({"h": h}, "cpu")["h"], rows, mode)
    assert got.dtype == torch.float32
    # f32 contractions summed in another order (torch einsum vs XLA dot);
    # entropy adds the two CPU log2 implementations' ~1-ulp difference
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)


SLICE_CASES = list(itertools.product([16, 32], [0.05, 5.0]))


@pytest.mark.parametrize("n_planes,density", SLICE_CASES)
def test_pallas_slice_render_matches_jax(n_planes, density):
    vol = gaussian_blob_volume((16, 24, 24))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.pallas_slice_render(
            jnp.asarray(vol), jnp.asarray(O), jnp.asarray(TF), density, 1.0,
            0.1, 1.5, width=100, height=72, n_planes=n_planes))
    got = tk.pallas_slice_render(
        torch.from_numpy(vol), O, TF, density, 1.0, 0.1, 1.5, width=100,
        height=72, n_planes=n_planes).numpy()
    assert got.shape == ref.shape == (72, 100, 4)
    diff = np.abs(got - ref)
    # the JAX kernel's own rule against its plain twin
    # (tests/test_pallas_slice.py:79-80): it evaluates the TF in the relu
    # basis and sums in another order, so a rare pixel flips at the 0.95
    # opacity cutoff; the bulk must match tightly
    assert np.quantile(diff, 0.999) < 1e-4, np.quantile(diff, 0.999)
    assert diff.max() < 0.05, diff.max()


HIST_CASES = list(itertools.product(STATS, ["float32", "bfloat16"], [0.05, 5.0]))


@pytest.mark.parametrize("stat,dtype,density", HIST_CASES)
def test_pallas_hist_render_matches_jax(stat, dtype, density):
    h = _hist(seed=7, dtype=getattr(jnp, dtype))
    rows, mode = jk.decode_weight_rows(stat, 8, family="unit")
    tscl = 10.0 if stat == "var" else 1.0  # var ~0.05: window it mid-ramp
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.pallas_hist_render(
            jnp.asarray(h), jnp.asarray(rows), jnp.asarray(O), jnp.asarray(TF),
            density, transfer_scale=tscl, width=W, height=H, stat=mode))
    st = state_from_jax({"hist_bm": h, "rows": rows, "tf_lut": TF}, "cpu")
    assert st["hist_bm"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
    got = tk.pallas_hist_render(
        st["hist_bm"], st["rows"], O, st["tf_lut"], density,
        transfer_scale=tscl, width=W, height=H, stat=mode).numpy()
    assert np.abs(ref).max() > 1e-3, "vacuous comparison: image is black"
    # Both sides decode the same bits in f32 on the CPU, entropy through
    # the two CPU log2 implementations (no TPU log2 approximation is
    # involved here); they differ in summation order (the JAX kernel's
    # balanced bin trees and relu-basis TF vs einsum and the tent TF)
    if density < 1.0:
        # atol 2e-5 / rtol 1e-5 as tests/test_hist_decode.py:52
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        # saturating opacity (alpha ~ 60x the TF alpha, clamped at 1)
        # amplifies that rounding on a few pixels of the noise histograms:
        # the JAX kernel's own rule (tests/test_pallas_slice.py:79-80)
        diff = np.abs(got - ref)
        assert np.quantile(diff, 0.999) < 1e-4, np.quantile(diff, 0.999)
        assert diff.max() < 0.05, diff.max()


def test_launch_counters_stay_zero_on_cpu():
    k1 = tk.sweep_preblended_planes.launches
    k2 = tk.pallas_hist_render.launches
    vol = torch.from_numpy(gaussian_blob_volume((8, 8, 8), seed=1))
    tk.pallas_slice_render(vol, O, TF, width=16, height=16)
    h = torch.tensor(_hist(nz=8, B=4))
    tk.pallas_hist_render(h, np.full(4, 0.25, np.float32), O, TF, width=16,
                          height=16)
    assert tk.sweep_preblended_planes.launches == k1 == 0
    assert tk.pallas_hist_render.launches == k2 == 0


def test_hist_renderer_module_matches_function():
    h = torch.tensor(_hist(seed=2))
    rows, mode = tk.decode_weight_rows("var", 8, family="unit")
    m = HistRenderer(TF, rows, stat=mode, width=40, height=30, density=0.3,
                     transfer_scale=10.0, device="cpu")
    assert set(dict(m.named_buffers())) == {"tf_lut", "rows"}
    got = m(h, torch.from_numpy(O))
    ref = tk.pallas_hist_render(h, rows, O, TF, 0.3, transfer_scale=10.0,
                                width=40, height=30, stat=mode)
    assert torch.equal(got, ref)


def test_hist_renderer_defaults_to_the_card():
    """The module's buffers go to the card unless the caller asks for the
    CPU, as every entry point of the port does."""
    rows, mode = tk.decode_weight_rows("mean", 8, family="unit")
    if torch.cuda.is_available():
        m = HistRenderer(TF, rows, stat=mode, width=8, height=8)
        assert m.tf_lut.is_cuda and m.rows.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            HistRenderer(TF, rows, stat=mode, width=8, height=8)
    m = HistRenderer(TF, rows, stat=mode, width=8, height=8, device="cpu")
    assert m.tf_lut.device.type == m.rows.device.type == "cpu"


def test_supported_predicates():
    assert tk.pallas_supported((512, 512, 512), 1024, 1024, 512)
    assert tk.pallas_supported((16, 24, 24), 100, 72, 32)
    assert not tk.pallas_supported((16, 24, 24), 100, 72, 32, n_lut=4096)
    assert tk.hist_render_supported((512, 16, 512, 512), 1024, 1024)
    assert tk.hist_render_supported((16, 8, 24, 24), 136, 96)
    assert not tk.hist_render_supported((16, 4096, 16, 16), 128, 128)


def test_unported_modes_raise():
    vol = torch.zeros((4, 4, 4))
    # empty-space skipping is ported: on an empty volume it renders what the
    # sweep without it renders
    assert torch.equal(
        tk.pallas_slice_render(vol, O, TF, width=8, height=8,
                               empty_space_skip=True),
        tk.pallas_slice_render(vol, O, TF, width=8, height=8))
    # the seeded sweep is ported: an empty stack gives the seed back times
    # brightness; a seed with ESS raises, as JAX asserts
    seed = torch.rand((8, 8, 4), generator=torch.Generator().manual_seed(0))
    got = tk.sweep_preblended_planes(vol, np.zeros(4, np.float32), O,
                                     (0.0, 0.1, 0.0, 0.1), TF, 0.05, 1.5,
                                     width=8, height=8, acc_init=seed)
    assert torch.equal(got, seed * 1.5)
    with pytest.raises(ValueError, match="empty-space"):
        tk.sweep_preblended_planes(vol, np.zeros(4, np.float32), O,
                                   (0.0, 0.1, 0.0, 0.1), TF, width=8,
                                   height=8, acc_init=seed,
                                   empty_space_skip=True)
    # precision='bf16' is ported (tests/test_torch_bf16.py holds it against
    # JAX); any other value raises, as JAX knows only 'f32' and 'bf16'
    img = tk.pallas_hist_render(torch.zeros((4, 2, 4, 4)), np.ones(2), O, TF,
                                width=8, height=8, precision="bf16")
    assert img.shape == (8, 8, 4) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="precision"):
        tk.pallas_hist_render(torch.zeros((4, 2, 4, 4)), np.ones(2), O, TF,
                              width=8, height=8, precision="f16")


def test_other_devices_raise_instead_of_falling_back():
    """Only CPU tensors take the plain version; a tensor on any device other
    than 'cuda' or 'cpu' raises."""
    h = torch.empty((4, 2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.pallas_hist_render(h, np.ones(2, np.float32), O, TF, width=8,
                              height=8)
