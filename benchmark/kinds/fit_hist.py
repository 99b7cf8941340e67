"""The fitting job: fwd+bwd steps of ``pallas_hist_render_diff`` over a
bins-major histogram volume, back to back, with gradients to the
histograms and the LUT.

A step renders the volume from an unrotated camera, one plane per layer,
takes ``loss = mean((img - target)^2)`` and its gradients, and waits for
them (one client: the next step starts when the last has finished). The
density changes by ``density_step`` a step, as a training loop's carried
parameter would. One step of the window, drawn from the seed, keeps its
outputs; after the window the plain reference computes the same step again
from the same inputs and the two are compared.

Configuration keys: ``n``, ``bins``, ``image``, ``storage`` (a torch
dtype's name), ``route``, ``plane_chunk``, ``origin``, ``focal``,
``density``, ``density_step``, ``target``, ``blob`` (the generator's
shape), ``reference_chunk`` and ``limits``. Mix keys: ``statistic``
('mean', 'var' or 'entropy'), ``tf_offset``, ``tf_scale``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from vrdd_tpu_torch.kernels import slice_vjp

from benchmark import inputs
from benchmark.reference import sweep as ref
from benchmark.roofline import count

_MODES = {"mean": "linear", "var": "var", "entropy": "entropy"}


class Cell:
    unit = "steps"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.c, self.mix, self.seed, self.dev = config, mix, seed, device
        self.stat = mix["statistic"]
        self.limits = config["limits"]
        self.failed = 0
        self.kept = None
        self.live = None
        self._pick = np.random.default_rng(seed)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def make_inputs(self):
        c = self.c
        self.render = slice_vjp.pallas_hist_render_diff
        self.hist = inputs.blob_histograms(
            c["n"], c["bins"], seed=self.seed, device=self.dev,
            dtype=getattr(torch, c["storage"]), blob=c["blob"],
        ).requires_grad_()
        self.rows = torch.as_tensor(inputs.unit_decode_rows(self.stat, c["bins"]),
                                    device=self.dev)
        self.lut0 = torch.as_tensor(inputs.rainbow_lut(), device=self.dev)
        self.lut = self.lut0.clone().requires_grad_()
        self._sync()

    def density(self, i: int) -> float:
        return self.c["density"] * (1.0 + self.c["density_step"] * i)

    def _step(self, i: int, spans=None):
        c, W = self.c, self.c["image"]
        img = self.render(
            self.hist, self.rows, tuple(c["origin"]), self.lut,
            density=self.density(i), transfer_offset=self.mix["tf_offset"],
            transfer_scale=self.mix["tf_scale"], width=W, height=W,
            plane_chunk=c["plane_chunk"], focal=c["focal"],
            wrt=("hist", "lut"), stat=_MODES[self.stat], route=c["route"])
        loss = torch.mean((img - c["target"]) ** 2)
        d_hist, d_lut = torch.autograd.grad(loss, [self.hist, self.lut])
        self._sync()
        return img.detach(), loss.detach(), d_hist, d_lut

    def warm(self):
        # two steps, the second holding the first's outputs as the window's
        # kept step does, so the allocator has what the window takes
        keep = self._step(0)
        self._step(1)
        del keep

    def step(self, i: int, spans):
        with spans("step"):
            out = self._step(i)
        # reservoir of one: every step of the window equally likely kept
        if self._pick.integers(0, i + 1) == 0:
            self.kept = (i, out)

    def end_to_end(self, n: int, window_s: float) -> dict:
        return {"fit_mrays_s": n * self.c["image"] ** 2 / window_s / 1e6}

    def counters(self) -> dict:
        return {"kept_step": None if self.kept is None else self.kept[0]}

    def release(self):
        # the autograd graphs went with each step; the program keeps nothing
        # else but its outputs, which the check reads
        self.render = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i: int, dtype, on_d_hist):
        c = self.c
        return ref.fit_step(
            self.hist.detach(), self.rows, self.stat, self.lut0,
            self.density(i), self.mix["tf_offset"], self.mix["tf_scale"],
            width=c["image"], height=c["image"], origin=c["origin"],
            focal=c["focal"], chunk=c["reference_chunk"], dtype=dtype,
            on_d_hist=on_d_hist)

    def control(self):
        """The control's outputs for the kept step: the plain reference put
        in the program's place, computed one precision lower (bfloat16)."""
        i = self.kept[0]
        d_hist = torch.empty_like(self.hist, requires_grad=False)

        def keep(z0, z1, d):
            d_hist[z0:z1] = d.to(d_hist.dtype)

        img, loss, d_lut, _ = self.reference(i, torch.bfloat16, keep)
        return i, (img, loss, d_hist, d_lut)

    def check(self, outputs=None) -> dict:
        """The kept step's image, ``d_hist`` and ``d_lut`` (or ``outputs``,
        the control's) against the plain reference in float32. ``d_hist``
        is compared as the program returns it, in the storage dtype,
        against the reference rounded to that dtype: the rounding both
        share is not the program's error."""
        i, (img, _, d_hist, d_lut) = self.kept if outputs is None else outputs
        storage = self.hist.dtype
        acc = torch.zeros(2, dtype=torch.float64, device=self.dev)

        def judge(z0, z1, d_ref):
            got = d_hist[z0:z1].double()
            want = d_ref.to(storage).double()
            acc[0] += ((got - want) ** 2).sum()
            acc[1] += (want ** 2).sum()

        img_r, _, d_lut_r, live = self.reference(i, torch.float32, judge)
        self.live = live
        d_lut_r = d_lut_r.double()
        return {
            "image_max_abs": float((img.float() - img_r).abs().max()),
            "d_hist_rel_l2": math.sqrt(float(acc[0]) / float(acc[1])),
            "d_lut_rel_l2": float(torch.linalg.vector_norm(d_lut.double() - d_lut_r)
                                  / torch.linalg.vector_norm(d_lut_r)),
        }

    def roofline(self) -> dict:
        """The step's least time, from the samples the reference counted."""
        c = self.c
        if self.live is None:
            return None
        n_bytes, n_ops = count.fit_step_work(
            voxels=c["n"] ** 3, bins=c["bins"],
            storage_bytes=torch.finfo(self.hist.dtype).bits // 8,
            width=c["image"], height=c["image"], n_lut=9,
            live_samples=self.live, stat=self.stat)
        t, by = count.bound_s(n_bytes, n_ops)
        return {"bound_s": t, "bound_by": by, "bytes": n_bytes, "ops": n_ops,
                "live_samples": self.live}
