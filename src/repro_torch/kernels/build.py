"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together) and linked into one shared
library with a plain C interface under ``build/repro_torch/<hash>/`` of the
checkout. The hash covers the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and an unchanged one is loaded as it is. Nothing is built when a module is
imported: :func:`library` builds on its first call, which the
kernel wrappers make at their first launch on a CUDA tensor.

Ranks of a sharded run that launch their first kernel together build once:
:func:`library` takes a file lock (``out_dir/.lock``) before it builds,
looks for the library again under the lock, and writes its objects under
names of its own process, so no process links another's half-written
object.

Each C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero status into an exception.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of every entry point: name -> argument types (all return int)
SIGNATURES = {
    "rt_bincount": (_P, _P, _L, _I, _P, _P),
    "rt_hot_count": (_P, _L, _I, _P, _P),
    "rt_topk_rows": (_P, _I, _L, _I, _P, _P, _P, _P, _P),
    "rt_topk_scratch": (_I, _L, _I, _P),
    "rt_topk_max_k": (),
    "rt_gather_rows": (_P, _L, _L, _P, _L, _P, _P),
    "rt_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "rt_consolidate_gather": (_P, _L, _L, _P, _I, _P, _P),
    "rt_consolidate_scatter": (_P, _L, _L, _P, _P, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
}

_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "can only be built on a machine with the CUDA toolkit")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out_dir: Path) -> Path:
    """Compile every source to an object in parallel, then link the objects
    into one shared library; the compiler's output goes to ``build.log``.
    The objects carry this process's id and are removed after the link."""
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    so = out_dir / "librepro_torch_kernels.so"
    if not failed:
        tmp = out_dir / f".{so.name}.{os.getpid()}"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            failed.append("link")
        else:
            os.replace(tmp, so)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}; see {out_dir / 'build.log'}:\n"
            + "\n".join(log)[-4000:])
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    so = out_dir / "librepro_torch_kernels.so"
    t0 = time.perf_counter()
    built = False
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not so.exists():  # another process may have built it meanwhile
                so = _compile(_nvcc(), sources, out_dir)
                built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    BUILD_INFO.update(
        path=str(so), built=built, seconds=time.perf_counter() - t0,
        sources=[s.name for s in sources])
    _LIB = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError_t {status}")
