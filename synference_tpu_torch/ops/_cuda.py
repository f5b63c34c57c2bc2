"""Build and load the package's hand-written CUDA kernels.

The sources under `synference_tpu_torch/csrc/` expose a plain C interface.
They are compiled by `nvcc` for Hopper (`sm_90a`) into a shared library in
`synference_tpu_torch/_build/` at first use, keyed by a hash of the source,
and bound with `ctypes`. Nothing here runs at import time: a machine without
`nvcc` or a card can import the package and use the plain versions on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "fused_window.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the kernels in synference_tpu_torch/csrc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> tuple[pathlib.Path, float, str]:
    """Compile the kernel library if its build is missing or stale.

    Returns (path, seconds spent compiling, compiler log); seconds is 0.0
    when an up-to-date build was found.
    """
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libsynference_kernels_{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every C entry point typed."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.k1_fused_window.argtypes = [
        p, i64, p, p, p, p, i64, p, p, i64, p, i64, p, p,
        i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, p]
    lib.k1_fused_window.restype = i32
    lib.k1_smem_bytes.argtypes = [i32]
    lib.k1_smem_bytes.restype = ctypes.c_size_t
    lib.k1_tile_galaxies.argtypes = []
    lib.k1_tile_galaxies.restype = i32
    lib.k1_chunk_columns.argtypes = []
    lib.k1_chunk_columns.restype = i32
    lib.k1_error_string.argtypes = [i32]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib
