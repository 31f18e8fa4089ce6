"""Build and load the port's native libraries (plain C ABI, ctypes).

Seven shared libraries, each built from this package's sources on first
use into ``hesic_tpu_torch/_build/`` (gitignored) and rebuilt when its
source is newer than the library.  The host library's file name carries
a hash of the target options ``-march=native`` resolves to, so a
``_build/`` copied to a host with another CPU builds its own instead of
loading instructions that CPU may lack:

  ``rans``       csrc/rans.cpp, g++: the host rANS coder for z, the CDF
                 quantizer, the streaming decoder and the host AR coder,
                 with the JAX package's flags (``-ffp-contract=off``: no
                 FMA contraction, so the AR coder's float sums are exact
                 IEEE mul+add in a fixed order; ``-march=native``, retried
                 without it where the compiler refuses);
  ``pmf``        csrc/pmf.cu, nvcc for sm_90a with ``-fmad=false``:
                 kernel 1 (GMM -> frequency rows);
  ``grid_rans``  csrc/grid_rans.cu, nvcc for sm_90a: kernels 2 and 3
                 (grid rANS encode and decode);
  ``pairs_rans`` csrc/pairs_rans.cu, nvcc for sm_90a: kernel 4 (the
                 slot-stream rANS encoder);
  ``wavefront``  csrc/wavefront.cu, nvcc for sm_90a with ``-fmad=false``:
                 kernel 5 (the wavefront level scan);
  ``dense_warp`` csrc/dense_warp.cu, nvcc for sm_90a: DSIC's dense warp
                 (no TPU kernel: the JAX package leaves it to XLA);
  ``gdn``        csrc/gdn.cu, nvcc for sm_90a: GDN and IGDN with the
                 preceding conv's bias as one pass (no TPU kernel: GDN
                 was left to XLA).

Nothing is compiled at import.  ``build_all`` starts every compiler at
once (one process per source) so a cold start pays the slowest build,
not the sum.  Concurrent builds (test workers, two processes) each
write a pid-unique temporary file and rename it into place atomically.

``launch_counts`` counts kernel launches by name: each kernel wrapper adds
one (``count_launch``, under a lock: a worker thread may encode while
the main thread decodes) where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

SOURCES = {
    "rans": "rans.cpp",
    "pmf": "pmf.cu",
    "grid_rans": "grid_rans.cu",
    "pairs_rans": "pairs_rans.cu",
    "wavefront": "wavefront.cu",
    "dense_warp": "dense_warp.cu",
    "gdn": "gdn.cu",
}

_HOST_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
               "-Wall"]
_HOST_ARCH = ["-march=native"]
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# kernel 1 and kernel 5's coder must be bit-equal to eager PyTorch: no
# mul+add contraction (kernel 5's products use explicit __fmaf_rn)
_NVCC_EXTRA = {"pmf": ["-fmad=false"], "wavefront": ["-fmad=false"]}

# Hopper, as the rANS kernels' plans size their blocks: the dynamic
# shared memory one block may opt into (227 KB), and one SM's shared
# memory (228 KB, of which each resident block reserves 1 KB); the H100
# SXM's SM count, the plans' default off the card
SM_COUNT = 132
SMEM_BLOCK = 232448
SMEM_SM = 233472
WARPS_SM = 64           # resident warps an SM holds
LANE_GROUP = 8          # lanes a rANS block owns: a 32-byte row segment

launch_counts: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel `name` to ``launch_counts``."""
    with _count_lock:
        launch_counts[name] += 1

_loaded: dict = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def host_tag() -> str:
    """12 hex digits of the target options that ``-march=native``
    resolves to on this host (as ``g++ -Q --help=target`` prints them),
    or "portable" where the compiler does not take it."""
    proc = subprocess.run([_cxx(), *_HOST_ARCH, "-Q", "--help=target"],
                          stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    if proc.returncode != 0 or not proc.stdout:
        return "portable"
    return hashlib.sha256(proc.stdout).hexdigest()[:12]


def lib_path(name: str) -> str:
    tag = f"-{host_tag()}" if name == "rans" else ""
    return os.path.join(BUILD_DIR, f"lib{name}{tag}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (sm_90a)")


def _command(name: str, out: str, portable: bool = False) -> list:
    src = os.path.join(CSRC, SOURCES[name])
    if name == "rans":
        arch = [] if portable else _HOST_ARCH
        return [_cxx(), *_HOST_FLAGS, *arch, src,
                "-o", out]
    return [_nvcc(), *_NVCC_FLAGS, *_NVCC_EXTRA.get(name, []), src,
            "-o", out]


def _stale(name: str) -> bool:
    """Missing, or older than its source or a shared csrc/*.cuh header."""
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, SOURCES[name])] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(lib)


def _start(name: str):
    """Start the compiler for `name`; returns (process, tmp path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str):
    out, _ = proc.communicate()
    if proc.returncode != 0 and name == "rans":
        # the host library again without -march=native
        proc = subprocess.Popen(_command(name, tmp, portable=True),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {SOURCES[name]} failed "
                           f"(rc={proc.returncode}):\n{out}")
    os.replace(tmp, lib_path(name))


def build(name: str) -> str:
    """Compile library `name` if it is missing or stale; return its path."""
    if _stale(name):
        _finish(name, *_start(name))
    return lib_path(name)


def build_all(names=tuple(SOURCES)) -> dict:
    """Compile every stale library in parallel; returns {name: seconds}
    of wall time from the common start to each build's end (0 when the
    library was already current).  Every compiler is waited for before
    the first failure is raised."""
    t0 = time.perf_counter()
    running = {n: _start(n) for n in names if _stale(n)}
    times = {n: 0.0 for n in names}
    errors = []
    for n, (proc, tmp) in running.items():
        try:
            _finish(n, proc, tmp)
        except RuntimeError as e:
            errors.append(e)
        times[n] = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build(name))
    return lib


def check_cuda_tensor(t, name: str, dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_status(rc: int, kernel: str, limits: str = ""):
    """Raise unless a C entry point returned 0.  -1 means the arguments
    are outside the kernel's `limits` (it then launched nothing); any
    other code is the launch's cudaError_t."""
    if rc == -1:
        raise ValueError(f"{kernel}: arguments outside the kernel's limits"
                         + (f" ({limits})" if limits else ""))
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {rc}")
