"""Build the Hopper kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c <src>.cu           (one per source, parallel)
    nvcc -shared -o build/librepro_torch_<hash>.so *.o

The library lands in ``build/`` at the repository root, named by a hash of
the sources and flags, and is built at first use — never at import, so a
machine without ``nvcc`` can import every module.  A failed build raises.
``-Xptxas -v`` output (registers, shared memory, spills per kernel) is
kept beside the library as ``librepro_torch_<hash>.ptxas.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_p = ctypes.c_void_p
_i = ctypes.c_int
#: C entry point → argument types (every pointer and the stream as c_void_p)
SIGNATURES = {
    # (q bf16, docs u8, bias f32 | null, out f32, n_q, n_docs, d, stream)
    "int8_ip_launch": [_p, _p, _p, _p, _i, _i, _i, _p],
    # (q signs i8, q row stride, docs words, docs row stride, out f32, n_q,
    #  n_docs, n_words, accumulate, stream)
    "binary_ip_launch": [_p, _i, _p, _i, _p, _i, _i, _i, _i, _p],
    # (scores f32, vals f32, idx i32, sort scratch u64 | null, tie tiles
    #  u64, bound survivors u64, n_q, n_d, k, block_d, n_blocks, sort
    #  length, stream)
    "topk_blocks_launch": [_p] * 6 + [_i] * 6 + [_p],
    # (vals f32, ids i32, out vals f32, out ids i64, scratch u64 | null,
    #  tie rows u64, n_q, n_lists, k, buffer entries, stream)
    "topk_merge_launch": [_p] * 6 + [_i] * 4 + [_p],
    # (probes i32, q, storage, list ids i32, base f32, vals f32, ids i32,
    #  work i32, candidates f32, candidates i32, scratch f32 | null,
    #  scratch i32 | null, n_q, nprobe, nlist, L, w, k, m, backend, stream)
    "ivf_fused_launch": [_p] * 12 + [_i] * 8 + [_p],
    # (n_q, nprobe, nlist) → int32s of ivf_fused_launch's work buffer
    "ivf_fused_work_ints": [_i, _i, _i],
    # (x f32, mu1, w, mu2, scale, zero f32, work u8, scratch f32 | null,
    #  out u8, n, d, kp, d_out, dp, tile rows, stream)
    "fused_quantize_launch": [_p] * 9 + [_i] * 5 + [_p],
}
#: entry points that return something other than a cudaError_t
RESTYPES = {"ivf_fused_work_ints": ctypes.c_longlong}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels are compiled on "
                       "the machine with the card (CUDA toolkit on PATH or "
                       "under /usr/local/cuda)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if not already built) and return the library's path.

    Objects go to a fresh directory and the library and its log are
    renamed into place, so processes building at once do not collide.
    """
    tag = source_hash()
    lib = BUILD_DIR / f"librepro_torch_{tag}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{tag}-", dir=BUILD_DIR))
    procs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    (work / "ptxas.log").write_text("\n".join(logs))
    tmp = work / lib.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(work / "ptxas.log", _log_path(tag))
    os.replace(tmp, lib)      # a reader never sees half a library
    shutil.rmtree(work)
    return lib


def _log_path(tag: str) -> Path:
    return BUILD_DIR / f"librepro_torch_{tag}.ptxas.log"


def ptxas_log() -> str:
    """What ``-Xptxas -v`` reported for the current build."""
    path = _log_path(source_hash())
    return path.read_text() if path.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")


def stream_handle(tensor) -> int:
    """PyTorch's current stream on ``tensor``'s device, as an int."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
