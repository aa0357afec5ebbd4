"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (raw pointers, ints, the
stream) and compiles on its own into `build/hip_llama_tpu_torch/<name>-<hash>.so`
under the repository root, keyed by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads. At first use every
source's nvcc starts at once and the calls wait for all of them. Nothing
else is used: no torch.utils.cpp_extension, no prebuilt binary. A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hip_llama_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
build_seconds: float | None = None  # wall time of the last build_all()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _target(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(os.listdir(CSRC)):  # shared headers feed every source
        if hdr.endswith(".cuh"):
            with open(os.path.join(CSRC, hdr), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every csrc/*.cu that has no up-to-date library, all nvcc
    processes in parallel, and load them all."""
    global build_seconds
    with _lock:
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in _sources():
            if name in _libs:
                continue
            out = _target(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
        errors = []
        for name, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu (rc {p.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in _sources():
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_target(name))
        build_seconds = time.perf_counter() - t0
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building everything at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def bind(name: str, fn: str, signature: str):
    """`fn` of csrc/<name>.cu's library with its arguments declared:
    `signature` spells each as 'p' (pointer or stream, ctypes.c_void_p),
    'i' (ctypes.c_int) or 'f' (ctypes.c_float). The function returns its
    cudaError_t as an int."""
    key = (name, fn)
    f = _fns.get(key)
    if f is None:
        f = getattr(load(name), fn)
        types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        f.argtypes = [types[c] for c in signature]
        f.restype = ctypes.c_int
        _fns[key] = f
    return f


def check(rc: int, name: str, what: str) -> None:
    """Raise on a nonzero cudaError_t, with CUDA's message for it."""
    if rc != 0:
        msg = getattr(load(name), "hipllama_error_string")
        msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg(rc).decode()})")
