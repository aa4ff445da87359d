"""Build the CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``_build/lib<name>-<hash>.so`` inside the package (a directory the
repository's ``.gitignore`` lists), for ``sm_90a`` (Hopper). The hash covers
the sources and flags, so an edited kernel is rebuilt and a built one is
reused. :func:`build_all` starts one ``nvcc`` per source at once; a wrapper's
first call builds just its own source if it is missing.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` on a machine without the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("paged_attention", "flash_prefill", "flash_attention",
           "block_score", "pool_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argument types of the kernels' C interfaces (pointers and the stream as
# void*: a plain int would cut them to 32 bits)
PTR, INT, LONG, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built on this machine")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process | None, output path, log path)."""
    out = _lib_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return None, out, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, out, log


def _finish(name: str, proc, out: Path, log: Path) -> None:
    if proc is None:
        return
    rc = proc.wait()
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    if rc != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (rc {rc}):\n"
                           f"{log.read_text()}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every kernel source in parallel (one nvcc each); returns
    {name: nvcc output} (``-Xptxas -v`` register / shared-memory report)."""
    started = {n: _start(n) for n in names}
    for n, (proc, out, log) in started.items():
        _finish(n, proc, out, log)
    return {n: log.read_text() if log.exists() else ""
            for n, (_, _, log) in started.items()}


def load(name: str, signatures: dict | None = None) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed.
    ``signatures`` ({function: argtypes}, each returning a C int) are set
    once, when the library is first loaded."""
    lib = _LIBS.get(name)
    if lib is None:
        proc, out, log = _start(name)
        _finish(name, proc, out, log)
        lib = ctypes.CDLL(str(out))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        for fn, argtypes in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd is on and an input of ``kernel`` requires grad.
    The kernels write into fresh tensors through ctypes and have no
    backward pass: their outputs would carry no ``grad_fn`` and the
    gradient of every input would be dropped without a word. Each CUDA
    wrapper calls this first, before its device checks."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the CUDA kernel has no "
            f"backward pass. The JAX package trains through plain attention "
            f"(models.common.causal_attention, the route of "
            f"transformer.forward_train); run inference under "
            f"torch.no_grad()")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
