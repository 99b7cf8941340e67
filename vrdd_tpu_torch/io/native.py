"""ctypes bindings of the native C++ data loaders (counterpart of
``vrdd_tpu/io/native.py``).

The source is the port's own copy, ``vrdd_tpu_torch/csrc/vrdd_io.cpp``. At
first use it is compiled with ``g++`` into ``vrdd_tpu_torch/_build/``
(ignored by git), named by a hash of the source and the flags, as
``kernels/_build.py`` builds the CUDA kernels; importing this module builds
nothing. The readers have the signatures, semantics and validation of
:mod:`vrdd_tpu_torch.io.formats` (the specification) and raise its
``FormatError``. When the library cannot be built (no ``g++``),
:func:`available` is False and callers take the Python readers.

``read_histograms_bins_major`` transposes to the bins-major device layout
as it reads (up to 8 threads, each a range of z-layers: one read a layer,
then a voxel row at a time into contiguous per-bin runs) and rounds to bf16
there (to nearest even, as ``torch.Tensor.to(torch.bfloat16)``), so no
full-size float32 copy or Python transpose exists; it returns a CPU
tensor, as the Python reader does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from vrdd_tpu_torch.io.formats import FormatError

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "vrdd_io.cpp"
#: where the library is built; tests point it at a temporary directory
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
             "-Wextra")

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def build(build_dir: Path) -> Path:
    """Compile ``csrc/vrdd_io.cpp`` into ``build_dir`` unless its library is
    there; returns the library's path. Raises ``RuntimeError`` when ``g++``
    is missing or fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    lib = Path(build_dir) / f"libvrdd_io-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def _load(build_dir: str) -> Optional[ctypes.CDLL]:
    """The library built in ``build_dir`` with its signatures declared, or
    None when it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build(Path(build_dir))))
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    c_str, c_int, c_long = ctypes.c_char_p, ctypes.c_int, ctypes.c_long
    sigs = {
        "vrdd_read_raw": [c_str, c_long, _f32p],
        "vrdd_codebook_count": [c_str],
        "vrdd_read_codebook": [c_str, c_int, c_int, _i32p, _i32p, _f32p,
                               _i32p],
        "vrdd_templates_count": [c_str],
        "vrdd_read_templates": [c_str, c_int, _f32p],
        "vrdd_span_count": [c_str],
        "vrdd_read_span_list": [c_str, _i32p, _i32p],
        "vrdd_simple_count": [c_str],
        "vrdd_read_simple": [c_str, c_str, c_str, c_int, _i32p, _i32p,
                             _i32p, _f32p, _i32p],
        "vrdd_write_ppm": [c_str, c_int, c_int, _u8p],
        "vrdd_ppm_size": [c_str, ctypes.POINTER(c_int),
                          ctypes.POINTER(c_int)],
        "vrdd_read_ppm": [c_str, c_int, c_int, _u8p],
        "vrdd_compare_ppm": [_u8p, c_str, c_int, c_int, ctypes.c_float],
        "vrdd_read_histograms_bins_major": [c_str, c_long, c_long, c_long,
                                            c_long, c_int, ctypes.c_void_p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_long if name == "vrdd_compare_ppm" else c_int
    return lib


def _lib() -> ctypes.CDLL:
    lib = _load(str(BUILD_DIR))
    if lib is None:
        raise RuntimeError("the native loader is not available (g++ missing "
                           "or failed); use vrdd_tpu_torch.io.formats")
    return lib


def available() -> bool:
    """Whether the native library builds and loads (built at first call)."""
    return _load(str(BUILD_DIR)) is not None


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise FormatError(f"native reader failed ({what}): code {rc}")
    return rc


def read_raw_histograms(path: str, n_blocks: int, n_bins: int) -> np.ndarray:
    out = np.empty(n_blocks * n_bins, dtype=np.float32)
    _check(_lib().vrdd_read_raw(path.encode(), out.size, out), "raw")
    return out.reshape(n_blocks, n_bins)


def read_histograms_bins_major(path: str, dims, n_bins: int,
                               dtype="bfloat16") -> torch.Tensor:
    """Block-histogram blob -> bins-major ``(nz, n_bins, ny, nx)`` CPU
    tensor in ``dtype`` ('bfloat16' / 'bf16' or 'float32'), transposed and
    rounded by the C++ reader as it reads (see
    ``formats.read_histograms_bins_major``)."""
    nz, ny, nx = (int(d) for d in dims)
    if str(dtype) in ("bfloat16", "bf16"):
        out = torch.empty((nz, n_bins, ny, nx), dtype=torch.bfloat16)
    elif str(dtype) == "float32":
        out = torch.empty((nz, n_bins, ny, nx), dtype=torch.float32)
    else:
        raise FormatError(f"unsupported histogram dtype {dtype!r}")
    _check(_lib().vrdd_read_histograms_bins_major(
        path.encode(), nz, ny, nx, n_bins, int(out.dtype == torch.bfloat16),
        out.data_ptr()), "bins-major histograms")
    return out


def read_codebook(path: str, n_bins: int, max_errors: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    lib = _lib()
    max_errors = max_errors or n_bins
    n = _check(lib.vrdd_codebook_count(path.encode()), "codebook header")
    codebook = np.zeros((n, 4), dtype=np.int32)
    ebins = np.zeros((n, max_errors), dtype=np.int32)
    evals = np.zeros((n, max_errors), dtype=np.float32)
    span_ids = np.zeros(n, dtype=np.int32)
    _check(lib.vrdd_read_codebook(path.encode(), n_bins, max_errors,
                                  codebook, ebins, evals, span_ids),
           "codebook")
    return codebook, ebins, evals, span_ids


def read_templates(path: str, n_bins: int) -> np.ndarray:
    lib = _lib()
    n = _check(lib.vrdd_templates_count(path.encode()), "templates header")
    out = np.zeros((n, n_bins), dtype=np.float32)
    _check(lib.vrdd_read_templates(path.encode(), n_bins, out), "templates")
    return out


def read_span_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _lib()
    n = _check(lib.vrdd_span_count(path.encode()), "span header")
    low = np.zeros((n, 3), dtype=np.int32)
    high = np.zeros((n, 3), dtype=np.int32)
    _check(lib.vrdd_read_span_list(path.encode(), low, high), "span list")
    return low, high


def read_simple_histograms(counts_path: str, bin_ids_path: str,
                           freqs_path: str, n_bins: int):
    lib = _lib()
    n = _check(lib.vrdd_simple_count(counts_path.encode()), "simple header")
    low = np.zeros((n, 3), dtype=np.int32)
    high = np.zeros((n, 3), dtype=np.int32)
    bin_ids = np.zeros((n, n_bins), dtype=np.int32)
    freqs = np.zeros((n, n_bins), dtype=np.float32)
    counts = np.zeros(n, dtype=np.int32)
    _check(lib.vrdd_read_simple(counts_path.encode(), bin_ids_path.encode(),
                                freqs_path.encode(), n_bins, low, high,
                                bin_ids, freqs, counts), "simple")
    return low, high, bin_ids, freqs, counts


def write_ppm(path: str, rgba_u8) -> None:
    """Native P6 writer (sdkSavePPM4ub semantics: alpha dropped)."""
    arr = np.ascontiguousarray(np.asarray(rgba_u8), dtype=np.uint8)
    h, w = arr.shape[:2]
    _check(_lib().vrdd_write_ppm(path.encode(), w, h, arr.reshape(-1)),
           "ppm write")


def read_ppm(path: str) -> np.ndarray:
    lib = _lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.vrdd_ppm_size(path.encode(), ctypes.byref(w), ctypes.byref(h)),
           "ppm header")
    out = np.zeros(h.value * w.value * 3, dtype=np.uint8)
    _check(lib.vrdd_read_ppm(path.encode(), w.value, h.value, out),
           "ppm read")
    return out.reshape(h.value, w.value, 3)


def compare_ppm(img_rgb_u8, ref_path: str, epsilon: float = 5.0,
                threshold: float = 0.30):
    """Native golden compare against a stored reference PPM, with the
    tolerance model of ``formats.compare_ppm`` (the reference's
    sdkComparePPM, volumeRender.cpp:57-58, 1077). Returns ``(passed,
    outlier_fraction)``."""
    arr = np.ascontiguousarray(np.asarray(img_rgb_u8)[..., :3],
                               dtype=np.uint8)
    h, w = arr.shape[:2]
    outliers = _check(int(_lib().vrdd_compare_ppm(
        arr.reshape(-1), ref_path.encode(), w, h, float(epsilon))),
        "ppm compare")
    frac = outliers / float(w * h)
    return frac <= threshold, frac
