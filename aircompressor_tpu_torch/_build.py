"""Build the package's CUDA kernels with nvcc, and its C++ host code with
g++, and load them with ctypes.

``csrc/*.cu`` compile once into one shared library with a plain C
interface, under ``build/kernels/`` at the root of the checkout: one nvcc
process for each source, all started together, then one link. The file
name carries a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source builds anew and an unchanged one loads
the library already built. Nothing here
includes PyTorch's headers: pointers and the stream pass as integers, which
keeps a build to seconds. Nothing is built when the module is imported.

``host/**/*.cc`` (the deflate planner, the two zstd planners and the native
tier's block codecs, hashes and CRC, ``host/native``) compile the same way with g++ into one
library under ``build/host/``, keyed by a hash of its sources, the headers
beside them and the flags. It runs on the CPU, so it is built wherever it
is first used, the CPU tests included. ``-O3`` without ``-march``, so the
library does not depend on the CPU it was built on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
HOST_SRC = Path(__file__).resolve().parent / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
GXX_FLAGS = ("-std=c++17", "-O3", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
# C entry -> argument types; each returns its cudaGetLastError() as an int.
_SIGNATURES = {
    "acx_snappy_decode": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P],
    "acx_snappy_decode_r2": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P],
    "acx_snappy_encode": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    "acx_xxh64": [_P, _P, _I, _I, _U64, _P, _P],
    "acx_lz4_decode": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P],
    "acx_lz4_encode": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    "acx_xxh32": [_P, _P, _I, _I, _U32, _P, _P],
    "acx_crc32c": [_P, _P, _I, _I, _P, _P],
    "acx_zstd_huffman": [_P, _L, _P, _P, _I, _P, _P, _P],
    "acx_zstd_fse": [_P, _L, _P, _P, _P, _I, _P, _P, _P, _P],
    "acx_zstd_fse_blocks_per_sm": [],
    "acx_zstd_execute": [_P, _L, _P, _L, _P, _P, _P, _I, _P, _I, _P, _P, _P],
    "acx_lzo_decode": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P],
    "acx_deflate_decode": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "acx_zstd_dfast": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "acx_zstd_emit": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
}
_SZ = ctypes.c_size_t
_I64 = ctypes.c_int64
_STR = ctypes.c_char_p
# The zstd compress planner's callback for numpy's argsort order
# (``host/zstd/encode_plan.cc``): keys, their count, the order written.
ORDER_FN = ctypes.CFUNCTYPE(_I, ctypes.POINTER(_I64), _I64, ctypes.POINTER(_I64))
# C++ host entry -> (argument types, return type): the deflate and zstd
# planners, and the native tier's block codecs and hashes (``native``; each
# codec returns its byte count, or -(offset + 1) on malformed input).
_HOST_SIGNATURES = {
    "acx_inflate_plan_batch": ([_P, _L, _L, _P, _I, _I, _I, _P, _P, _P], None),
    "acx_zstd_decode_plan": ([_P, _L, _P, _L, _L, _P, _P, _STR, _L], _P),
    "acx_zstd_decode_plan_write": ([_P] * 12, None),
    "acx_zstd_decode_plan_free": ([_P], None),
    "acx_zstd_verify_proposals": ([_P] * 8 + [_L, _L], _I64),
    "acx_zstd_encode_plan": ([_P] * 6 + [_L, _P, ORDER_FN, _P, _P, _P, _STR, _L], _P),
    "acx_zstd_encode_pack": ([_P] * 9, None),
    "acx_zstd_encode_assemble": ([_P] * 8 + [_STR, _L], _I64),
    "acx_zstd_encode_detail": ([_P, _L, _P, _P, _P], ctypes.c_int32),
    "acx_zstd_field_cost": ([_P, _L, _P, _L, _L, _P], ctypes.c_double),
    "acx_zstd_encode_plan_free": ([_P], None),
    "actpu_xxh32": ([_P, _SZ, _U32], _U32),
    "actpu_xxh64": ([_P, _SZ, _U64], _U64),
    "actpu_crc32c": ([_P, _SZ, _U32], _U32),
    "actpu_lz4_compress": ([_P, _SZ, _P, _SZ, _I], _I64),
    "actpu_lz4_decompress": ([_P, _SZ, _P, _SZ], _I64),
    "actpu_snappy_compress": ([_P, _SZ, _P, _SZ, _I], _I64),
    "actpu_snappy_decompress": ([_P, _SZ, _P, _SZ], _I64),
}

_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _host_sources() -> list[Path]:
    return sorted(HOST_SRC.rglob("*.cc"))


def _host_headers() -> list[Path]:
    return sorted(HOST_SRC.rglob("*.h"))


def _hashed_path(directory: Path, stem: str, flags, sources) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return directory / f"{stem}-{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    return _hashed_path(BUILD_DIR, "libaircompressor_kernels", NVCC_FLAGS,
                        _sources() + sorted(CSRC.glob("*.cuh")))


def host_library_path() -> Path:
    """Where the host library for the current sources and flags lives."""
    return _hashed_path(HOST_BUILD_DIR, "libaircompressor_host", GXX_FLAGS,
                        _host_sources() + _host_headers())


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path.

    The compilers' output (with ptxas's register and spill report) is kept
    beside the library as ``.log``. Raises with the compiler's stderr when
    the build fails; no compiler process outlives the call.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = [(src, tmp.with_name(f"{tmp.name}.{src.stem}.o")) for src in _sources()]
    procs = []
    try:
        for src, obj in jobs:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for (src, _), proc in zip(jobs, procs):
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode} on {src.name}:\n{log}")
            logs.append(log)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj in jobs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {link.returncode}: {' '.join(cmd)}\n"
                f"{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for _, obj in jobs:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
    os.replace(tmp, lib)
    return lib


def build_host() -> Path:
    """Compile ``host/**/*.cc`` with g++ unless this exact build exists;
    return its path. Raises with the compiler's output when it fails."""
    lib = host_library_path()
    if lib.exists():
        return lib
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library needs a C++ compiler")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-shared", "-o", str(tmp),
           *(str(src) for src in _host_sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_host() -> ctypes.CDLL:
    """The host library, built on first use in this process."""
    global _host_lib
    if _host_lib is None:
        lib = ctypes.CDLL(str(build_host()))
        for name, (argtypes, restype) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _host_lib = lib
    return _host_lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
