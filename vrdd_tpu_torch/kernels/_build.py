"""Build and bind the hand-written CUDA kernels (``vrdd_tpu_torch/csrc``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers. Each ``.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more links them. The library goes to
``vrdd_tpu_torch/_build/`` (ignored by git), named by a hash of every file
under ``csrc/`` (sources and shared headers) and the flags, and is built at
first use: importing this module does nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "slice_sweep.cu", CSRC / "slice_vjp.cu",
           CSRC / "slice_vjp_staged.cu", CSRC / "ess_bitmap.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_FLOAT_FIELDS = (
    "ox", "oy", "oz", "density", "brightness", "tf_off", "tf_scale",
    "spacing", "mx0", "dmx", "my0", "dmy", "xlo", "ylo", "xhi", "yhi",
    "tstep", "threshold", "tex_offset", "sx", "sy",
)
_INT_FIELDS = (
    "height", "width", "ny", "nx", "n_planes", "n_layers", "n_lut",
    "n_bins", "n_rows", "dz_sign", "reverse", "length_correction",
    "filter_linear",
)


class SweepParams(ctypes.Structure):
    """Mirror of ``struct SweepParams`` in ``csrc/sweep_common.cuh``."""

    _fields_ = [(n, ctypes.c_float) for n in _FLOAT_FIELDS] + [
        (n, ctypes.c_int) for n in _INT_FIELDS
    ]


class BwdParams(ctypes.Structure):
    """Mirror of ``struct BwdParams`` in ``csrc/bwd_common.cuh``: the
    checkpoint stride (4 or 8), the number of checkpoint rows, and which
    cotangents the reverse sweep computes."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "ck_stride", "n_chunks", "g_planes", "g_lut", "g_params",
    )]


class EssParams(ctypes.Structure):
    """Mirror of ``struct EssParams`` in ``csrc/ess_bitmap.cu``."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "ox", "oy", "oz", "mx0", "dmx", "my0", "dmy", "xlo", "xhi", "ylo",
        "yhi", "tex_offset", "sx", "sy",
    )] + [(n, ctypes.c_float) for n in ("tf_off", "tf_scale", "q_margin")] + [
        (n, ctypes.c_int) for n in (
            "n_planes", "plane_chunk", "height", "width", "tile_h", "tile_w",
            "ny", "nx", "n_lut", "n_by", "n_bx",
        )
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "CUDA kernels of vrdd_tpu_torch cannot be built"
    )


def _source_hash(csrc: Path = CSRC) -> str:
    """Hash of every source and header under ``csrc`` and of the flags: an
    edit to a shared header alone names a new library."""
    h = hashlib.sha256()
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands concurrently; raise with the output of the first
    that fails. Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile the kernels if their library is missing; return build info:
    ``path``, ``seconds`` (0 when the library was already there) and the
    compiler's ``log`` (ptxas register and spill lines)."""
    lib = BUILD_DIR / f"vrdd_kernels-{_source_hash()}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{tag}.tmp"
    log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)]])
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    for o in objs:
        o.unlink()
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "log": log}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()["path"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.vrdd_slice_sweep
    # params, mode, bf16, vol, zs, lut, rows, out, ck_stride, tck, ess,
    # ess_chunk, seed, tile_w, tile_h, stage_w, stage_h, stream
    fwd.argtypes = [ctypes.POINTER(SweepParams), i32, i32, ptr, ptr, ptr,
                    ptr, ptr, i32, ptr, ptr, i32, ptr, i32, i32, i32, i32,
                    ptr]
    fwd.restype = i32
    bwd = lib.vrdd_slice_bwd
    # params, bwd params, mode, bf16, vol, zs, lut, rows, g, tck,
    # d_planes, partials, mom, s_out, stage_w, stage_h, stream
    bwd.argtypes = [ctypes.POINTER(SweepParams), ctypes.POINTER(BwdParams),
                    i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                    ptr, i32, i32, ptr]
    bwd.restype = i32
    ess = lib.vrdd_ess_bitmap
    # params, pmin, pmax, zs, lut, out, stream
    ess.argtypes = [ctypes.POINTER(EssParams), ptr, ptr, ptr, ptr, ptr, ptr]
    ess.restype = i32
    return lib
