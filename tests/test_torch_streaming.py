"""Port parity of the seeded sweep and the streamed decode:
vrdd_tpu_torch's ``acc_init`` (march/slice.py, the plain versions of the
seeded K1/K3/K4/K5 in kernels/), ``ops/gaussian.py`` and
``march/streaming.py`` against vrdd_tpu on the same numpy inputs, on the
CPU.

JAX's seeded route is its XLA twin (``sweep_preblended_planes_xla``), the
oracle its own fused kernels are held to (tests/test_dist_sweep.py); the
port's kernel wrappers take their plain versions on the CPU. The CUDA
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march import slice as jslice
from vrdd_tpu.march import streaming as jstream
from vrdd_tpu.ops import gaussian as jgauss
from vrdd_tpu.ops import histogram as jhist
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import slice_kernel as tk
from vrdd_tpu_torch.kernels import slice_vjp as tv
from vrdd_tpu_torch.march import slice as tslice
from vrdd_tpu_torch.march.streaming import streaming_decode_render
from vrdd_tpu_torch.models.volumes import (
    GaussianMomentVolume,
    compute_stats_volume,
)
from vrdd_tpu_torch.ops.gaussian import gaussian_stats
from vrdd_tpu_torch.ops.histogram import flex_block_stats

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
W, H, P = 20, 16, 16
SPACING = 2.0 / P
# images 1e-5 abs; gradients 1e-4 of the reference's largest magnitude
# (the JAX suite's measure, tests/test_hist_decode.py:81-83): the two
# libraries round the resample's matmuls in their own orders
ATOL, GRAD_MRE = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=rtol)


def _close_grad(got, ref):
    got, ref = _np(got), _np(ref)
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() or 1.0))
    assert err < GRAD_MRE, err


@pytest.fixture(scope="module")
def stack():
    """A blob's 16-plane pre-blended stack and its depths."""
    vol = gaussian_blob_volume((8, 12, 12), seed=1)
    planes, zs = tslice.preblend_planes(torch.from_numpy(vol), P,
                                        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0),
                                        -1)
    return planes.numpy(), zs


def _seed(frozen=True):
    """A premultiplied RGBA seed; with ``frozen`` a few pixels past the 0.95
    cutoff (alpha 0.99, exactly 1, 0.951) beside a live one."""
    rng = np.random.default_rng(0)
    seed = (rng.random((H, W, 4)) * 0.5).astype(np.float32)
    seed[..., :3] *= seed[..., 3:]
    if frozen:
        seed[0, :4, 3] = [0.99, 1.0, 0.951, 0.5]
    return seed


_JAX_SEEDED = {}


def _jax_seeded(planes, zs, seed, density, use_custom_vjp=True):
    """JAX's seeded XLA twin at brightness 1.2, TF offset 0.1, scale 1.5:
    ``((loss, image), grads)``, one compile per ``use_custom_vjp``."""
    if use_custom_vjp not in _JAX_SEEDED:
        mx, my = tk._pixel_slopes(W, H, 2.0)

        def loss(p, lut, d, to, ts, a0):
            img = jslice.sweep_preblended_planes_xla(
                p, zs, O, mx, my, lut, d, 1.2, to, ts, plane_spacing=SPACING,
                acc_init=a0, use_custom_vjp=use_custom_vjp)
            return jnp.sum(img ** 2), img

        _JAX_SEEDED[use_custom_vjp] = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True))
    return _JAX_SEEDED[use_custom_vjp](
        jnp.asarray(planes), jnp.asarray(TF), jnp.float32(density),
        jnp.float32(0.1), jnp.float32(1.5), jnp.asarray(seed))


def _leaves(planes, density, seed):
    return [torch.tensor(x, requires_grad=True) for x in
            (planes, TF, np.float32(density), np.float32(0.1),
             np.float32(1.5), seed)]


@pytest.mark.parametrize("use_custom_vjp", [True, False])
@pytest.mark.parametrize("density", [0.5, 4.0])
def test_seeded_sweep_matches_jax(stack, density, use_custom_vjp):
    """The port's seeded plain sweep against JAX's seeded XLA twin: the
    image and every cotangent, the seed's included, with frozen seeds
    (alpha 0.99 and exactly 1)."""
    planes, zs = stack
    seed = _seed()
    (_, jimg), jgrads = _jax_seeded(planes, zs, seed, density,
                                    use_custom_vjp)
    mx, my = tk._pixel_slopes(W, H, 2.0)
    leaves = _leaves(planes, density, seed)
    img = tslice.sweep_preblended_planes_xla(
        leaves[0], zs, O, mx, my, *leaves[1:3], 1.2, *leaves[3:5],
        plane_spacing=SPACING, acc_init=leaves[5],
        use_custom_vjp=use_custom_vjp)
    grads = torch.autograd.grad(torch.sum(img ** 2), leaves)
    _close(img, jimg)
    for g, r in zip(grads, jgrads):
        _close_grad(g, r)
    # frozen pixels: the seed comes back times brightness, its alpha
    # cotangent is g_a (nothing behind it), for alpha 0.99 and exactly 1
    np.testing.assert_array_equal(img.detach().numpy()[0, :3],
                                  seed[0, :3] * np.float32(1.2))
    np.testing.assert_allclose(grads[5].numpy()[0, :3, 3],
                               2.0 * 1.2 * 1.2 * seed[0, :3, 3], rtol=1e-6)


def test_seeded_halves_equal_one_sweep(stack):
    """The back half seeded with the front half's image is the one-pass
    sweep (2e-6), for the plain sweep and K1's plain version."""
    planes, zs = stack
    planes = torch.from_numpy(planes)
    mx, my = tk._pixel_slopes(W, H, 2.0)
    kw = dict(plane_spacing=SPACING)
    full = tslice.sweep_preblended_planes_xla(planes, zs, O, mx, my, TF, 3.0,
                                              **kw)
    front = tslice.sweep_preblended_planes_xla(planes[:8], zs[:8], O, mx, my,
                                               TF, 3.0, **kw)
    back = tslice.sweep_preblended_planes_xla(planes[8:], zs[8:], O, mx, my,
                                              TF, 3.0, acc_init=front, **kw)
    assert float(front[..., 3].max()) > 0.95  # frozen seeds exercised
    _close(back, full, atol=2e-6, rtol=0)
    slopes = tk.pixel_slope_params(W, H)
    kw.update(width=W, height=H)
    k_front = tk.sweep_preblended_planes(planes[:8], zs[:8], O, slopes, TF,
                                         3.0, **kw)
    k_back = tk.sweep_preblended_planes(planes[8:], zs[8:], O, slopes, TF,
                                        3.0, acc_init=k_front, **kw)
    _close(k_back, tk.sweep_preblended_planes(planes, zs, O, slopes, TF, 3.0,
                                              **kw), atol=2e-6, rtol=0)


@pytest.mark.parametrize("density", [0.5, 4.0])
def test_seeded_kernel_plain_versions_match_jax(stack, density):
    """K3/K4/K5 seeded (``sweep_preblended_planes_diff(acc_init=)``, plain
    versions on the CPU) and K1 seeded against JAX's seeded XLA twin:
    image, plane / LUT / density / TF cotangents and ``d_acc0``; K4's
    checkpoint rows of a frozen pixel are all T0, K5's S there is 0."""
    planes, zs = stack
    seed = _seed()
    (_, jimg), jgrads = _jax_seeded(planes, zs, seed, density)
    slopes = tk.pixel_slope_params(W, H)
    leaves = _leaves(planes, density, seed)
    kw = dict(width=W, height=H, plane_spacing=SPACING)
    img = tv.sweep_preblended_planes_diff(
        leaves[0], zs, O, slopes, *leaves[1:3], 1.2, *leaves[3:5],
        acc_init=leaves[5], wrt=("volume", "lut", "params"), **kw)
    grads = torch.autograd.grad(torch.sum(img ** 2), leaves)
    _close(img, jimg)
    for g, r in zip(grads, jgrads):
        _close_grad(g, r)
    k1 = tk.sweep_preblended_planes(torch.from_numpy(planes), zs, O, slopes,
                                    TF, density, 1.2, 0.1, 1.5,
                                    acc_init=torch.from_numpy(seed), **kw)
    _close(k1, jimg)
    # the seed's cotangent alone (no other input needs a gradient)
    a0 = torch.tensor(seed, requires_grad=True)
    img = tv.sweep_preblended_planes_diff(
        torch.from_numpy(planes), zs, O, slopes, TF, density, 1.2, 0.1, 1.5,
        acc_init=a0, **kw)
    (d_a0,) = torch.autograd.grad(torch.sum(img ** 2), [a0])
    assert torch.equal(d_a0, grads[5])
    # ... and beside a parameter that wrt prunes, which gets exact zeros
    a0 = torch.tensor(seed, requires_grad=True)
    d = torch.tensor(np.float32(density), requires_grad=True)
    img = tv.sweep_preblended_planes_diff(
        torch.from_numpy(planes), zs, O, slopes, TF, d, 1.2, 0.1, 1.5,
        acc_init=a0, wrt=("volume",), **kw)
    d_a0, d_d = torch.autograd.grad(torch.sum(img ** 2), [a0, d])
    assert torch.equal(d_a0, grads[5]) and float(d_d) == 0.0
    # the wrappers' pieces: K4's checkpoints start at T0, K5's S
    cfg = tv.planes_config(zs, O, slopes, n_planes=P, **kw)
    args = (torch.from_numpy(planes), None, torch.tensor(TF),
            torch.tensor(density), torch.tensor(0.1), torch.tensor(1.5))
    acc0 = torch.from_numpy(seed)
    _, tck = tv.sweep_fwd_ckpt(cfg, *args, acc0)
    t0 = 1.0 - acc0[..., 3]
    assert torch.equal(tck[0], t0)
    assert torch.equal(tck[:, 0, :3], t0[0, :3].expand(tck.shape[0], 3))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (H, W, 4)).astype(np.float32))
    *_, s_img = tv.sweep_bwd(cfg, *args, g, tck, False, True, False,
                             acc0=acc0)
    assert torch.equal(s_img[0, :3], torch.zeros(3))
    assert tv.sweep_bwd(cfg, *args, g, tck, False, True, False)[3] is None


def test_seeded_hist_sweep_matches_jax():
    """The in-kernel decode sweep seeded (linear statistic, plain versions
    on the CPU) against JAX's decode plus seeded XLA twin."""
    rng = np.random.default_rng(5)
    hist = rng.random((P, 4, 12, 12)).astype(np.float32)  # (P, B, NY, NX)
    rows = np.linspace(0.1, 0.9, 4, dtype=np.float32)[None]
    seed = _seed()
    mx, my = tk._pixel_slopes(W, H, 2.0)
    slopes = tk.pixel_slope_params(W, H)
    zs = ((np.arange(P, dtype=np.float32) + 0.5) * SPACING - 1.0)[::-1].copy()

    def jloss(h, lut, a0):
        planes = jnp.einsum("b,pbyx->pyx", jnp.asarray(rows[0]), h)
        img = jslice.sweep_preblended_planes_xla(
            planes, zs, O, mx, my, lut, 0.8, plane_spacing=SPACING,
            acc_init=a0)
        return jnp.sum(img ** 2), img

    (_, jimg), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(hist), jnp.asarray(TF), jnp.asarray(seed))
    leaves = [torch.tensor(x, requires_grad=True) for x in (hist, TF, seed)]
    img = tv.sweep_preblended_hist_diff(
        leaves[0], rows, zs, O, slopes, leaves[1], 0.8, width=W, height=H,
        plane_spacing=SPACING, stat="linear", acc_init=leaves[2],
        wrt=("hist", "lut"), reverse_planes=False)
    grads = torch.autograd.grad(torch.sum(img ** 2), leaves)
    _close(img, jimg)
    for g, r in zip(grads, jgrads):
        _close_grad(g, r)


def test_seed_and_ess_raise(stack):
    planes, zs = stack
    with pytest.raises(ValueError, match="empty-space"):
        tk.sweep_preblended_planes(torch.from_numpy(planes), zs, O,
                                   tk.pixel_slope_params(W, H), TF, width=W,
                                   height=H, empty_space_skip=True,
                                   acc_init=torch.from_numpy(_seed()))
    with pytest.raises(ValueError, match="acc_init"):
        tv.sweep_preblended_planes_diff(
            torch.from_numpy(planes), zs, O, tk.pixel_slope_params(W, H), TF,
            width=W, height=H, acc_init=torch.zeros((H, W + 1, 4)))


def test_gaussian_stats_match_jax():
    """gaussian_stats against JAX's, its pinned literals
    (tests/test_ops.py), and GaussianMomentVolume's stats decode."""
    mu = np.asarray([0.3, -1.0, 2.0], np.float32)
    sigma = np.asarray([0.1, 1.0, 4.0], np.float32)
    got = gaussian_stats(torch.from_numpy(mu), torch.from_numpy(sigma))
    expected = np.array([[0.3, 0.01, 0.46024558], [-1.0, 1.0, 0.56362492],
                         [2.0, 16.0, 0.62384176]], np.float32)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((4, 5, 6)).astype(np.float32)
    sigma = np.exp(rng.standard_normal((4, 5, 6))).astype(np.float32)
    sigma[0, 0, 0] = 0.0  # the 1e-12 variance floor
    ref = np.asarray(jgauss.gaussian_stats(jnp.asarray(mu),
                                           jnp.asarray(sigma)))
    vol = GaussianMomentVolume(torch.from_numpy(mu), torch.from_numpy(sigma))
    np.testing.assert_allclose(compute_stats_volume(vol).numpy(), ref,
                               rtol=1e-6, atol=1e-7)


def _hist_volume(n=8, bins=8, seed=1):
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((n, n, n, bins)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _decode_hist(lib):
    if lib is jnp:
        return lambda h: jhist.flex_block_stats(h, channels=(0,))[..., 0] / 255
    return lambda h: flex_block_stats(h, channels=(0,))[..., 0] / 255


def _decode_gauss(lib):
    if lib is jnp:
        return lambda t: jgauss.gaussian_stats(t[0], jnp.exp(t[1]))[..., 1]
    return lambda t: gaussian_stats(t[0], torch.exp(t[1]))[..., 1]


def _gauss_params():
    rng = np.random.default_rng(4)
    mu = rng.random((8, 8, 8), dtype=np.float32)
    log_sigma = np.log(0.05 + 0.2 * rng.random((8, 8, 8), dtype=np.float32))
    return mu, log_sigma.astype(np.float32)


# (distribution, decode, density, TF scale): a histogram volume (one leaf)
# at a saturating density (chained frozen seeds) and the (mu, log sigma)
# pair of fit-voxels (a tuple), its variance scaled into the LUT's domain
STREAM_CASES = {
    "hist_saturating": (lambda: _hist_volume(seed=3), _decode_hist, 5.0, 1.0),
    "gaussian": (_gauss_params, _decode_gauss, 0.5, 20.0),
}


@pytest.fixture(scope="module")
def jax_stream():
    """JAX's streamed render (backend 'xla') and its gradients to the
    distribution and the LUT, memoized per case."""
    cache = {}

    def get(case):
        if case not in cache:
            make, decode, density, tscl = STREAM_CASES[case]
            dist = make()
            jdist = (tuple(jnp.asarray(x) for x in dist)
                     if isinstance(dist, tuple) else jnp.asarray(dist))

            def loss(d, lut):
                img = jstream.streaming_decode_render(
                    d, decode(jnp), jnp.asarray(O), lut, density=density,
                    transfer_scale=tscl, width=16, height=16, n_planes=16,
                    chunk_planes=8, backend="xla", remat=False)
                return jnp.sum(img ** 2), img

            (_, img), (gd, gl) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jdist, jnp.asarray(TF))
            cache[case] = (dist, np.asarray(img), jax.tree_util.tree_map(
                np.asarray, gd), np.asarray(gl))
        return cache[case]

    return get


def _port_stream(case, dist, backend, remat=True):
    _, decode, density, tscl = STREAM_CASES[case]
    leaves = [torch.tensor(x, requires_grad=True) for x in
              (dist if isinstance(dist, tuple) else (dist,))]
    lut = torch.tensor(TF, requires_grad=True)
    img = streaming_decode_render(
        tuple(leaves) if isinstance(dist, tuple) else leaves[0],
        decode(torch), O, lut, density=density, transfer_scale=tscl,
        width=16, height=16, n_planes=16, chunk_planes=8, backend=backend,
        remat=remat, wrt=("volume", "lut"))
    grads = torch.autograd.grad(torch.sum(img ** 2), leaves + [lut])
    return img.detach(), grads


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streaming_matches_jax(jax_stream, case, backend):
    """The streamed decode (chained seeded sweeps; 'pallas' = the plain
    K3/K4/K5 versions on the CPU, 'auto' = 'xla' off the card) against
    JAX's 'xla' streamed render: the image at JAX's own tolerance (2e-6
    abs, 1e-5 rel, tests/test_streaming.py:39), the gradients to the
    distribution and the LUT within 1e-4 of the reference's largest
    magnitude (JAX holds itself to 1e-5 abs + 1e-4 rel elementwise; across
    libraries a few elements near zero differ by the matmuls' rounding)."""
    dist, jimg, jgd, jgl = jax_stream(case)
    img, grads = _port_stream(case, dist, backend)
    _close(img, jimg, atol=2e-6, rtol=1e-5)
    assert float(img[..., 3].max()) > 0.05, "vacuous: empty render"
    for g, r in zip(grads, list(jgd if isinstance(jgd, tuple) else (jgd,))
                    + [jgl]):
        _close_grad(g, r)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_streaming_remat_invariant(backend):
    """torch.utils.checkpoint around each chunk changes memory, not the
    result: images and gradients bitwise equal with remat on and off."""
    dist = _gauss_params()
    img, grads = _port_stream("gaussian", dist, backend, remat=True)
    img_r, grads_r = _port_stream("gaussian", dist, backend, remat=False)
    assert torch.equal(img, img_r)
    for g, r in zip(grads, grads_r):
        assert torch.equal(g, r)


def test_streaming_matches_materialized():
    """Decoding in stream equals decoding everything first (JAX's
    tests/test_streaming.py:26-37), for several chunk sizes."""
    hist = _hist_volume(n=8, bins=8, seed=0)
    vol = flex_block_stats(torch.from_numpy(hist), channels=(0,))[..., 0] / 255
    ref = tslice.slice_render_image(vol, O, 16, 16, TF, 0.3, n_planes=16)
    for chunk_planes in (4, 5, 16):
        got = streaming_decode_render(
            torch.from_numpy(hist), _decode_hist(torch), O, TF, density=0.3,
            width=16, height=16, n_planes=16, chunk_planes=chunk_planes,
            backend="xla")
        _close(got, ref.numpy(), atol=2e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="backend"):
        streaming_decode_render(torch.from_numpy(hist), _decode_hist(torch),
                                O, TF, width=16, height=16, backend="tpu")
