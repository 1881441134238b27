"""Phase-1 score kernel for NVIDIA Hopper (viterbi_cuda.cu), through jax.ffi.

The kernel scores each (profile, window) pair in one thread block that
loops over the window's positions, with the DP state of the pair kept on
chip; see viterbi_cuda.cu for the algorithm.  Its costs equal the plain
engine's (ops/viterbi_jax.py, ops/engine.py scan_pairs) bit for bit.

The shared library is compiled from the source beside this module with
`nvcc` at first use, or ahead of time with

    python -m deciphon_tpu.ops.viterbi_cuda

into `build/` at the root of the checkout.  A library that cannot be built
or loaded raises `KernelUnavailable`; nothing falls back to another engine.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np

TARGET = "deciphon_viterbi_score"
MAX_K = 16384  # the reference's profile size limit (c-core/model.h:12)

# (nodes per thread, most threads per block).  Up to 8 nodes a thread
# the pending ring and the transition rows stay in registers, and a block
# of at most 256 threads may use all 255 registers a thread can have.
# Past K = 2048 the ring lives in a global scratch buffer (16 nodes a
# thread, up to 1024 threads: K <= 16384).
_TIERS = ((4, 256), (8, 256), (16, 1024))
_RING = 10  # pending M and I minima per node (5 slots each)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "viterbi_cuda.cu")
BUILD_DIR = os.path.join(os.path.dirname(_SRC), "..", "..", "build")
_LIB = os.path.join(BUILD_DIR, "libdeciphon_cuda.so")


class KernelUnavailable(RuntimeError):
    pass


def launch_shape(K: int) -> tuple[int, int]:
    """(threads per block, nodes per thread) for a profile of K nodes.

    The block covers threads * nodes_per_thread >= K nodes; the first tier
    whose thread count fits is taken, so the padding stays below one warp
    of runs."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside 1..{MAX_K}")
    for npt, most in _TIERS:
        threads = -(-K // (32 * npt)) * 32
        if threads <= most:
            return threads, npt
    raise AssertionError("unreachable: the last tier covers MAX_K")


def scratch_floats(n_pairs: int, threads: int, npt: int) -> int:
    """Scratch floats a call needs (the memory-state tier only)."""
    return n_pairs * _RING * threads * npt if npt == _TIERS[-1][0] else 1


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), NVCC_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    raise KernelUnavailable("nvcc not found: the CUDA toolkit is required "
                            "to build the phase-1 kernel")


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path.  nvcc's register report goes to
    build/libdeciphon_cuda.log."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    import jax

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, "libdeciphon_cuda.log"), "w") as fp:
        fp.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise KernelUnavailable(f"nvcc failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, _LIB)
    return _LIB


@functools.lru_cache(maxsize=1)
def register() -> str:
    """Build, load and register the FFI target once per process."""
    import jax

    try:
        lib = ctypes.CDLL(build())
    except OSError as exc:
        raise KernelUnavailable(f"cannot load {_LIB}: {exc}") from exc
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.DeciphonViterbiScore),
        platform="CUDA")
    return TARGET


def score_pairs(tables, tvecs, codes, pidx, starts, lens, xts, *,
                threads: int, npt: int):
    """(alt, null) costs of N pairs, each (N,) f32.

    tables (P, 1364, kw), tvecs (P, 9, kw): ops/costs.py build_tables
    with kw >= threads * npt + 4.  codes: the scan's (T, 5) start-indexed
    fragment codes.  pidx, starts, lens (N,) i32: profile row, global
    start and length of each window; xts (N, 16) f32 special-transition
    costs.  A pair of length 0 scores +inf."""
    import jax
    import jax.numpy as jnp

    n = pidx.shape[0]
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    scratch = jax.ShapeDtypeStruct((scratch_floats(n, threads, npt),),
                                   jnp.float32)
    alt, nul, _ = jax.ffi.ffi_call(register(), (out, out, scratch))(
        tables, tvecs, codes, pidx, starts, lens, xts,
        threads=np.int64(threads), nodes_per_thread=np.int64(npt))
    return alt, nul


if __name__ == "__main__":
    print(build())
