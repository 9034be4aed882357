"""Builds the CUDA sources under ``csrc/`` and binds them with ctypes.

Each ``csrc/<name>.cu`` is compiled by one ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), named after a hash of its source, the headers and the flags,
under ``<repo>/build/repro_torch/``. Building happens at first use, or for
every source at once through :func:`build_all`. Nothing here runs when
the package is imported.

Each nvcc run is a ``kernels.compile`` span and counts in
``kernels.compiles{kernel}`` (always on: which kernel was built again);
loading a library is a ``kernels.load`` span.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("box_mindist", "paa", "l2_dist", "topk", "pq_adc",
           "lex_select")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported function: (argtypes), restype is int
# (the cudaError_t of a launch, 0 on success; a size for a query)
SIGNATURES = {
    "box_mindist": {"box_mindist_f32": (_P, _P, _P, _P, _P, _I, _LL, _I,
                                        _P)},
    "paa": {"paa_f32": (_P, _P, _LL, _I, _I, _F, _P)},
    "l2_dist": {"l2_f32": (_P, _P, _P, _I, _LL, _I, _P),
                "l2_bf16": (_P, _P, _P, _I, _LL, _I, _P)},
    "topk": {"coop_score_f32": (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                                _P),
             "coop_score_bf16": (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                                 _P),
             "coop_score_tile": (_I,)},
    "pq_adc": {"pq_adc_u8": (_P, _P, _P, _I, _LL, _I, _I, _I, _P)},
    "lex_select": {"lex_select_f32": (_P, _P, _P, _P, _I, _LL, _I, _P,
                                      _P),
                   "lex_select_limit": (_I,)},
}

# one loaded library per source for the process, filled under _lock
_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + headers + " ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique per thread too: a compaction thread may build beside build_all
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    obs.REGISTRY.counter("kernels.compiles", kernel=name).inc()
    with obs.span("kernels.compile", kernel=name):
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stderr)
    os.replace(tmp, out)
    return out


def _bind(name: str, path: Path) -> ctypes.CDLL:
    with obs.span("kernels.load", kernel=name):
        lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = _bind(name, _compile(name))
        return lib


def build_all() -> dict:
    """Build every source in parallel (one nvcc each) and load them;
    returns {name: the compiler's register and shared-memory report}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {n: pool.submit(_compile, n) for n in SOURCES}
        paths = {n: f.result() for n, f in futures.items()}
    for n in paths:
        library(n)
    return {n: p.with_suffix(".log").read_text() for n, p in paths.items()}


# guards every wrapper's ``launches`` count: the engine's shard owners
# launch from several threads, and ``+= 1`` on an attribute is not atomic
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` count."""
    with _count_lock:
        wrapper.launches += 1


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t, dtypes, what: str, ndim: int) -> None:
    """Validate a tensor handed to a kernel: on a CUDA device, one of
    ``dtypes``, ``ndim`` dims, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def stream(t) -> int:
    """The current CUDA stream of t's device, as a pointer for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
