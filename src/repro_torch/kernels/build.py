"""Build and load the CUDA kernel library (nvcc + ctypes).

Every `.cu` file under `repro_torch/csrc/` compiles for `sm_90a` into an
object file, all of them in parallel, and the objects link into one shared
library with a plain C interface.  The library lands in `build/kernels/`
of the checkout (git-ignored), named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once.  Nothing
is built when the package is imported: the first kernel launch builds.

Each C entry point takes device pointers and the CUDA stream as `void*`,
launches on that stream, and returns `cudaGetLastError()`; `check` turns a
nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
REPO = _PKG.parents[1]
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point: argument types (all return int).
SIGNATURES = {
    # x, q, scale, m, k, mask, stream
    "repro_quantize_rows": (_P, _P, _P, _I, _I, _I, _P),
    # a, b, out, m, k, n, mask_a, mask_b, stream
    "repro_qgemm_plane0": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # a, b, fu, fv, scales, acc, out, m, k, n, k_valid, rank, mask_a,
    # mask_b, splits, stream
    "repro_qgemm_skinny": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P),
    # a, b, fu, fv, scales, out, m, k, n, k_valid, rank, mask_a, mask_b,
    # stream
    "repro_qgemm_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P),
    # a_stack, b_stack, scales, out, planes, m, k, n, stream
    "repro_qgemm_stacked": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, o, bh, sq, skv, d, causal, is_bf16, scale, stream
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build did: {"seconds", "path", "built", "ptxas"}
last_build: dict = {}


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                                       REPO / "build" / "kernels"))


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(srcs: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels-{_digest(srcs)}.so"
    if lib_path.exists():
        last_build.update(seconds=0.0, path=str(lib_path), built=False)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        obj = out_dir / f"{src.stem}-{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink(missing_ok=True)
    ptxas = "\n".join(logs)
    (out_dir / "ptxas.log").write_text(ptxas)
    last_build.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      built=True, ptxas=ptxas)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        text = _lib.repro_cuda_error_string(err).decode() if _lib else ""
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
