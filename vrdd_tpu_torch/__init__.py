"""vrdd_tpu_torch — the PyTorch/CUDA port of ``vrdd_tpu``.

The JAX package ``vrdd_tpu`` is the reference; this package mirrors its
layout module for module (``vrdd_tpu_torch/march/slice.py`` <->
``vrdd_tpu/march/slice.py``) and keeps its public names and array layouts:
bins-major ``(nz, B, ny, nx)`` histograms, ``(H, W, 4)`` premultiplied RGBA
images, ``(n_lut, 4)`` LUTs. It imports ``torch`` and numpy, never JAX.

Ported so far: the ``render`` path (``models/pipeline.py`` ``RenderPipeline``
for queries 0-9 over the raw, fractal and flexible-block families, through
the scan marcher, the plain sweep, the fused kernel with empty-space
skipping or shear-warp), ``encode``, ``fit-tf``, ``render-hist``,
``fit-hist``, ``fit-voxels`` and ``view`` (``cli.py``, ``viewer.py``), the
distributed renderers (``parallel/``) and the native loader
(``io/native.py``), with the sweep kernels written in CUDA C++ for Hopper
(``csrc/``), in f32 and JAX's ``precision='bf16'``: every module of
``vrdd_tpu`` but its benchmark. Importing the package builds nothing; the
kernels and the loader compile at first use.
"""
