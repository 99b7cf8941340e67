"""The training slice end to end: the port's ``fit-hist`` (torch Adam
through ``pallas_hist_render_diff``) against the JAX package's (optax Adam
through its decode-then-render path on the CPU), and the port's checkpoint
files against the JAX package's layout."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vrdd_tpu.core.transfer import grayscale_ramp
from vrdd_tpu.io.checkpoint import save_checkpoint as jax_save
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.pallas.slice_kernel import decode_weight_rows, decode_with_rows
from vrdd_tpu_torch import cli as tcli
from vrdd_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

N, IMG, B, LR = 16, 32, 16, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the suite runs several
    test processes side by side, and the plain sweep's reductions then
    keep one order whatever the worker's thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loss(stat, logits_true, route_rows):
    """cmd_fit_hist's loss off the TPU (vrdd_tpu/cli.py:489-511)."""
    rows, mode = route_rows
    toff, tscl = {"mean": (0.0, 1.0), "var": (0.0, 12.0),
                  "entropy": (0.55, 2.0)}[stat]
    lut = jnp.asarray(grayscale_ramp(9))
    origin = jnp.asarray([0.0, 0.0, 4.0])

    def render(hist_bm):
        vol = decode_with_rows(hist_bm, jnp.asarray(rows), mode)
        return slice_render_image(vol, origin, IMG, IMG, lut,
                                  transfer_offset=toff, transfer_scale=tscl,
                                  n_planes=N)

    def to_hist(logits):
        return jnp.transpose(jax.nn.softmax(logits, axis=0), (1, 0, 2, 3))

    target = render(to_hist(jnp.asarray(logits_true)))
    return lambda logits: jnp.mean((render(to_hist(logits)) - target) ** 2)


@pytest.mark.parametrize("stat", ["mean", "entropy"])
def test_adam_step_matches_optax(stat):
    """One fit-hist step from the same numpy logits: loss within 1e-5
    relative, updated logits within 1e-5. Adam's first step is
    lr * g / (|g| + eps), about lr * sign(g): where a ray's opacity sits at
    the 0.95 cutoff, the two implementations' rounding can freeze it at
    different planes and flip the sign of a few near-zero gradients behind
    it, which moves those logits by up to 2 lr. So at most 0.2% of the
    logits may lie outside 1e-5 (measured: 64 of 65536 for the mean, none
    for the entropy)."""
    loss_fn, _, logits_true = tcli.fit_hist_problem(N, IMG, B, stat, 0,
                                                    "inkernel", "cpu")
    init = (0.05 * np.random.default_rng(1).standard_normal(
        (B, N, N, N))).astype(np.float32)

    jloss = _jax_loss(stat, logits_true,
                      decode_weight_rows(stat, B, family="unit"))
    opt = optax.adam(LR)
    state = opt.init(jnp.asarray(init))
    jl, g = jax.value_and_grad(jloss)(jnp.asarray(init))
    updates, _ = opt.update(g, state, jnp.asarray(init))
    jnew = np.asarray(optax.apply_updates(jnp.asarray(init), updates))

    logits = torch.nn.Parameter(torch.tensor(init))
    topt = torch.optim.Adam([logits], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    loss = loss_fn(logits)
    loss.backward()
    topt.step()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    off = np.abs(logits.detach().numpy() - jnew) > 1e-5
    assert off.mean() <= 2e-3, off.mean()


def test_adam_matches_optax_on_the_same_gradients():
    """torch.optim.Adam with fit-hist's settings is optax.adam's formula:
    five steps on the same gradient sequence."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) * 10.0 ** -k
             for k in range(5)]
    opt = optax.adam(LR)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.tensor(p0))
    topt = torch.optim.Adam([tp], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.tensor(g)
        topt.step()
    # optax forms its bias corrections 1 - b^t in float32, torch in float64
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-5, rtol=0)


def test_fit_hist_cli_on_cpu(tmp_path, capsys):
    ckpt = tmp_path / "fit.npz"
    rc = tcli.main(["fit-hist", "--device", "cpu", "--size", "16",
                    "--image", "32", "--iters", "3", "--checkpoint",
                    str(ckpt)])
    assert rc == 0 and ckpt.exists()
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"step \d+: loss ([0-9.eE+-]+)",
                                           out)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    tree = load_checkpoint(str(ckpt))
    assert set(tree) == {"hist", "loss"}
    hist = tree["hist"]
    assert hist.shape == (16, 16, 16, 16)  # bins-major (nz, B, ny, nx)
    np.testing.assert_allclose(hist.sum(axis=1), 1.0, atol=1e-5)
    assert float(tree["loss"]) == pytest.approx(losses[-1], rel=1e-5)


def test_fit_hist_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda trains on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["fit-hist", "--size", "8", "--image", "16", "--iters", "1",
                   "--checkpoint", str(tmp_path / "f.npz")])
    assert not (tmp_path / "f.npz").exists()


def test_checkpoint_layout_matches_jax(tmp_path):
    """The arrays fit-hist writes sit under the same keys as in the JAX
    package's file; the port's file round-trips without JAX."""
    rng = np.random.default_rng(3)
    tree = {"loss": np.float32(0.25),
            "hist": rng.random((4, 3, 4, 4)).astype(np.float32)}
    jax_save(str(tmp_path / "j.npz"), tree)
    save_checkpoint(str(tmp_path / "t.npz"), tree)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert set(j.files) == set(t.files)
        for k in j.files:
            if k.startswith("leaf_") or k == "__version__":
                np.testing.assert_array_equal(t[k], j[k])
    back = load_checkpoint(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back["hist"], tree["hist"])
    assert back["loss"] == tree["loss"]
    nested = {"b": [torch.ones(2), (np.zeros(3), 5)], "a": np.arange(4)}
    save_checkpoint(str(tmp_path / "n.npz"), nested)
    got = load_checkpoint(str(tmp_path / "n.npz"))
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    np.testing.assert_array_equal(got["b"][0], np.ones(2, np.float32))
    assert int(got["b"][1][1]) == 5
    np.testing.assert_array_equal(got["a"], np.arange(4))
