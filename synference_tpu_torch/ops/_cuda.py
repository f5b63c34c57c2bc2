"""Build and load the package's hand-written CUDA kernels.

The sources under `synference_tpu_torch/csrc/` expose a plain C interface.
At first use every `csrc/*.cu` is compiled by its own `nvcc` process for
Hopper (`sm_90a`), all started together, and the objects are linked into one
shared library in `synference_tpu_torch/_build/`, keyed by a hash of every
source and header; it is bound with `ctypes`. Nothing here runs at import time: a machine without
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
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the kernels in synference_tpu_torch/csrc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_digest() -> str:
    """sha256 hex digest over every kernel source and header: the identity
    of a build."""
    digest = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    return digest.hexdigest()


def build_library() -> tuple[pathlib.Path, float, str]:
    """Compile the kernel library if its build is missing or stale.

    Returns (path, seconds spent compiling and linking, compiler log);
    seconds is 0.0 when an up-to-date build was found.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libsynference_kernels_{source_digest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(sources, objs)]
    logs = []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        logs.append(f"{src.name}:\n{err}")
        if proc.returncode != 0:
            for other in procs:
                other.wait()
            raise RuntimeError(
                f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
    tmp = out.with_suffix(f".{tag}")
    link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "\n".join(logs)


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
    lib.k2_fused_sed.argtypes = [
        p, i64, p, p, p, p, p, i64, p, p, i64, p, i64, p,
        i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, p]
    lib.k2_fused_sed.restype = i32
    lib.k3_shift_num.argtypes = [p, i64, p, p, i32, p, p, i32, i32, i32, i32,
                                 i32, i32, p]
    lib.k3_shift_keys.argtypes = [p, p, i32, i32, i32, p]
    lib.k3_shift_keys.restype = i32
    lib.k3_shift_num.restype = i32
    lib.k1_error_string.argtypes = [i32]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib
