"""``fit-tf`` in the port against the JAX package on the CPU: one Adam step
(torch.optim.Adam against optax.adam) on the same raw stats, the scan and
fused ('pallas', its plain version here) renderers, and the CLI's
checkpoints (JAX's layout, ``--resume`` across packages).

Tolerances: the loss within 1e-5 relative; the LUT after a step within
1e-5 abs (Adam's first step is about lr * sign(g), and no LUT entry's
gradient sits near 0 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vrdd_tpu import cli as jcli
from vrdd_tpu.core.geometry import default_benchmark_inv_view
from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
from vrdd_tpu.io.synthetic import random_histogram_volume
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.models.renderer import stats_sample_fn
from vrdd_tpu.models.volumes import RawHistogramVolume as JRaw
from vrdd_tpu.models.volumes import compute_stats_volume as j_stats
from vrdd_tpu.utils.config import MarchConfig
from vrdd_tpu_torch import cli as tcli
from vrdd_tpu_torch.io.checkpoint import load_leaves

SIZE, STEPS, LR = 16, 20, 1e-2
BLOCKS = ["8", "8", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the suite runs several
    test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stats():
    """The raw stats of fit-tf's synthetic volume, from JAX."""
    hist = random_histogram_volume((4, 8, 8), n_bins=32, seed=0)
    return np.array(j_stats(JRaw(jnp.asarray(hist))))


def _jax_loss(stats, renderer):
    """cmd_fit_tf's loss off the TPU (vrdd_tpu/cli.py:225-262)."""
    inv_view = jnp.asarray(default_benchmark_inv_view())
    tf0 = jnp.asarray(default_transfer_function())
    if renderer == "slice":
        n_planes = max(64, 2 * stats.shape[0])

        def fwd(lut):
            return slice_render_image(jnp.asarray(stats[..., 0]),
                                      inv_view[:, 3], SIZE, SIZE, lut,
                                      n_planes=n_planes)

        target = fwd(tf0)
        return lambda lut: jnp.mean((fwd(lut) - target) ** 2)
    march = MarchConfig(max_steps=STEPS, tstep=2.0 / STEPS)
    target = render_image(stats_sample_fn(jnp.asarray(stats), 0), inv_view,
                          SIZE, SIZE, tf0)
    return lambda lut: jnp.mean((render_image(
        stats_sample_fn(jnp.asarray(stats), 0), inv_view, SIZE, SIZE, lut,
        march=march) - target) ** 2)


@pytest.mark.parametrize("renderer", ["slice", "scan"])
def test_adam_step_matches_optax(stats, renderer):
    lut0 = grayscale_ramp(9).astype(np.float32)
    jloss = _jax_loss(stats, renderer)
    opt = optax.adam(LR)
    jl, g = jax.value_and_grad(jloss)(jnp.asarray(lut0))
    updates, _ = opt.update(g, opt.init(jnp.asarray(lut0)), jnp.asarray(lut0))
    jnew = np.asarray(optax.apply_updates(jnp.asarray(lut0), updates))

    loss_fn, name = tcli.fit_tf_problem(torch.from_numpy(stats), SIZE, STEPS,
                                        renderer)
    assert name == renderer
    lut = torch.nn.Parameter(torch.from_numpy(lut0.copy()))
    topt = torch.optim.Adam([lut], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    loss = loss_fn(lut)
    loss.backward()
    topt.step()
    assert float(jl) > 1e-4  # not vacuous
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_allclose(lut.detach().numpy(), jnew, rtol=0, atol=1e-5)


def test_fused_renderer_matches_slice_on_cpu(stats):
    """'pallas' (pallas_slice_render_diff with wrt=('lut',), its plain
    analytic VJP on the CPU) gives the plain sweep's loss and LUT gradient;
    'auto' is 'slice' on the CPU."""
    s = torch.from_numpy(stats)
    out = {}
    for renderer in ("pallas", "slice"):
        loss_fn, _ = tcli.fit_tf_problem(s, SIZE, STEPS, renderer)
        lut = torch.tensor(grayscale_ramp(9), requires_grad=True)
        loss = loss_fn(lut)
        (g,) = torch.autograd.grad(loss, [lut])
        out[renderer] = (float(loss.detach()), g)
    assert abs(out["pallas"][0] - out["slice"][0]) <= 1e-6 * out["slice"][0]
    gp, gs = out["pallas"][1], out["slice"][1]
    assert float(torch.linalg.norm(gp - gs)) <= 1e-4 * float(
        torch.linalg.norm(gs))
    assert tcli.fit_tf_problem(s, SIZE, STEPS, "auto")[1] == "slice"


def _run(pkg, tmp_path, name, *extra):
    ck = str(tmp_path / name)
    argv = ["fit-tf", "--blocks", *BLOCKS, "--size", str(SIZE), "--iters",
            "2", "--checkpoint", ck, *extra]
    if pkg is tcli:
        argv += ["--device", "cpu"]
    assert pkg.main(argv) == 0
    return ck


def test_cli_checkpoints_keep_jax_layout_and_resume(tmp_path, capsys):
    """Two steps in each package: the same leaves (Adam count, moments,
    step, LUT) in the same order and dtypes; then the port resumes from
    JAX's file and from its own as JAX resumes from its own (JAX cannot
    read the port's treedef, which is JSON, not a pickle)."""
    tck = _run(tcli, tmp_path, "t.npz")
    jck = _run(jcli, tmp_path, "j.npz")
    text = capsys.readouterr().out
    assert "fit-tf renderer: slice on cpu" in text and "step 2: loss" in text
    for got, ref in zip(load_leaves(tck), load_leaves(jck)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    count, _, _, step, _ = load_leaves(tck)
    assert int(count) == 2 and int(step) == 2
    j2 = _run(jcli, tmp_path, "j2.npz", "--resume", jck)
    for resume in (jck, tck):
        t2 = _run(tcli, tmp_path, "t2.npz", "--resume", resume)
        assert "resumed from" in capsys.readouterr().out
        for got, ref in zip(load_leaves(t2), load_leaves(j2)):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        assert int(load_leaves(t2)[3]) == 4 and int(load_leaves(t2)[0]) == 4


def test_fit_tf_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["fit-tf", "--iters", "1", "--checkpoint",
                   str(tmp_path / "x.npz")])
