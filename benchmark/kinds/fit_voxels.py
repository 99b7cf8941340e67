"""The multi-view Gaussian fit: back-to-back steps of ``fit-voxels``
(``vrdd_tpu_torch/models/voxel_fit.py``), each rendering the mean and
variance channels of a per-voxel ``(mu, log sigma)`` volume from every
camera of the mix, fwd+bwd, with Adam over both volumes.

The ground truth is the CLI's, from the seed; the fit starts from the truth
plus seeded noise, a fit in progress, so every step does about the same
work. A step is the CLI's (``voxel_fit.train_step``: zero the gradients,
the loss over all views, its backward, Adam's update) and then a wait for
the device (one client). Before each step of the window a reservoir of one
decides whether to keep it; a kept step snapshots its parameters and
Adam's state first, and keeps its loss, renders, gradients and the
parameters after the update. After the window the plain reference
(``benchmark/reference/voxels.py``) makes the truth again from the seed,
computes the same step from the snapshot, its targets included, and
applies a plain Adam update with its own gradients to the snapshot; the
two are compared, the update by the parameters' change.

The program's module is imported inside :meth:`Cell.make_inputs`, never at
import: a checkout without it still imports this kind (the traced runs of
every cell import every kind), and only this cell fails there.

Configuration keys: ``n``, ``image``, ``renderer``, ``streamed``,
``start_noise`` (``mu``, ``log_sigma``), ``lr``, ``betas``, ``eps``, the
reference's ``reference_chunk``, and ``limits``. The planes (``2 n``), the
focal length (2) and the m-grid's oversampling (2) are the job's own, in
the program and in the reference alike. Mix keys: ``views``,
``view_angle``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import voxels as ref
from benchmark.roofline import voxels as count


class Cell:
    unit = "steps"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.c, self.mix, self.seed, self.dev = config, mix, seed, device
        self.limits = config["limits"]
        self.failed = 0
        self.kept = None
        self.live = None
        self._f32 = None  # (kept step, the float32 reference's outputs)
        self._pick = np.random.default_rng(seed)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def make_inputs(self):
        from vrdd_tpu_torch.models import voxel_fit

        c = self.c
        self.truth = voxel_fit.blob_truth(c["n"], self.seed, self.dev)
        self.fit = voxel_fit.fit_problem(
            self.truth, views=self.mix["views"],
            view_angle=self.mix["view_angle"], image=c["image"],
            renderer=c["renderer"], device=self.dev, streamed=c["streamed"])
        self.train_step = voxel_fit.train_step
        views = self.fit.views
        self.renders = 2 * len(views)
        self.rotated = 2 * sum(v != (0.0, 0.0) for v in views)
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        noise = c["start_noise"]
        mu_true, sigma_true = self.truth
        self.mu = (mu_true + noise["mu"] * torch.randn(
            mu_true.shape, generator=gen, device=self.dev)).requires_grad_()
        self.log_sigma = (torch.log(sigma_true) + noise["log_sigma"]
                          * torch.randn(mu_true.shape, generator=gen,
                                        device=self.dev)).requires_grad_()
        self.opt = torch.optim.Adam([self.mu, self.log_sigma], lr=c["lr"],
                                    betas=tuple(c["betas"]), eps=c["eps"])
        self._sync()

    def _adam_state(self):
        """Each parameter's ``(exp_avg, exp_avg_sq, step)``, copied."""
        out = []
        for p in (self.mu, self.log_sigma):
            st = self.opt.state.get(p)
            if not st:
                out.append((torch.zeros_like(p), torch.zeros_like(p), 0))
            else:
                out.append((st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                            int(st["step"])))
        return out

    def _step(self, keep: bool):
        params = (self.mu, self.log_sigma)
        if keep:
            snap = tuple(p.detach().clone() for p in params)
            state = self._adam_state()
        loss, renders = self.train_step(self.fit, self.opt, *params)
        if keep:
            after = tuple(p.detach().clone() for p in params)
        self._sync()
        if not keep:
            return None
        return (snap, state, loss.detach(),
                [tuple(r.detach() for r in pair) for pair in renders],
                (self.mu.grad, self.log_sigma.grad), after)

    def warm(self):
        # two steps, the second holding the first's kept outputs as the
        # window's kept step does, so the allocator has what the window takes
        keep = self._step(True)
        self._step(False)
        del keep

    def step(self, i: int, spans):
        # reservoir of one, drawn before the step: every step of the window
        # equally likely kept
        keep = self._pick.integers(0, i + 1) == 0
        with spans("step"):
            out = self._step(keep)
        if keep:
            self.kept = (i, out)

    def end_to_end(self, n: int, window_s: float) -> dict:
        return {"fit_mrays_s": n * self.renders * self.c["image"] ** 2
                / window_s / 1e6}

    def counters(self) -> dict:
        return {"kept_step": None if self.kept is None else self.kept[0]}

    def release(self):
        # the program's state and truth go; the kept step stays for the check
        self.fit = self.opt = self.mu = self.log_sigma = self.truth = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _adam(self, snap, grads, state, dtype):
        c = self.c
        return ref.adam_update(snap, grads, state, lr=c["lr"],
                               betas=tuple(c["betas"]), eps=c["eps"],
                               dtype=dtype)

    def reference(self, params, dtype):
        c = self.c
        truth = ref.blob_truth(c["n"], self.seed, self.dev)
        return ref.fit_step(
            *params, truth, views=self.mix["views"],
            view_angle=self.mix["view_angle"], image=c["image"],
            chunk=c["reference_chunk"], dtype=dtype)

    def control(self):
        """The control's outputs for the kept step: the plain reference put
        in the program's place, computed one precision lower (bfloat16),
        its Adam update too."""
        i, (snap, state, *_) = self.kept
        loss, renders, d_mu, d_ls, _ = self.reference(snap, torch.bfloat16)
        after = self._adam(snap, (d_mu, d_ls), state, torch.bfloat16)
        return i, (snap, state, loss, renders, (d_mu, d_ls), after)

    def check(self, outputs=None) -> dict:
        """The kept step's loss, renders, gradients and update (or
        ``outputs``, the control's) against the plain reference in float32:
        the loss's relative error, the largest absolute error of any
        render's pixel and channel, each gradient's relative L2 error, and
        the parameters' change against the reference's Adam step from the
        same snapshot and state, the relative L2 error of the worse of the
        two (1 for a step that changed nothing)."""
        i, (snap, state, loss, renders, grads, after) = (
            self.kept if outputs is None else outputs)
        if self._f32 is None or self._f32[0] != i:  # once a kept step
            out = self.reference(snap, torch.float32)
            self._f32 = (i, out, self._adam(snap, out[2:4], state,
                                            torch.float32))
        (loss_r, renders_r, d_mu_r, d_ls_r, self.live), after_r = (
            self._f32[1:])

        def rel_l2(got, want):
            return float(torch.linalg.vector_norm((got - want).double())
                         / torch.linalg.vector_norm(want.double()))

        return {
            "loss_rel": abs(float(loss) - float(loss_r)) / float(loss_r),
            "image_max_abs": max(
                float((got.float() - want).abs().max())
                for pair, pair_r in zip(renders, renders_r)
                for got, want in zip(pair, pair_r)),
            "d_mu_rel_l2": rel_l2(grads[0], d_mu_r),
            "d_log_sigma_rel_l2": rel_l2(grads[1], d_ls_r),
            "param_step_rel_l2": max(
                rel_l2(got - p0, want - p0)
                for got, want, p0 in zip(after, after_r, snap)),
        }

    def roofline(self) -> dict:
        """The step's least time, from the samples the reference counted."""
        c = self.c
        if self.live is None:
            return None
        n_bytes, n_ops = count.fit_step_work(
            voxels=c["n"] ** 3, renders=self.renders, rotated=self.rotated,
            width=c["image"], height=c["image"], live_samples=self.live)
        t, by = count.bound_s(n_bytes, n_ops)
        return {"bound_s": t, "bound_by": by, "bytes": n_bytes, "ops": n_ops,
                "live_samples": self.live}
