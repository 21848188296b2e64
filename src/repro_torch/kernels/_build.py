"""Build the CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface under
``build/kernels/`` at the repository root, named by a hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source
is rebuilt and an unchanged one is reused. A failed build raises: there
is no fallback to the plain versions. ``srht.cu`` and ``codec.cu`` are
also Python extension modules (``module``: ``repro_srht``,
``repro_codec``, bound by ``csrc/pymodule.cuh``): their launch entry
points, called for a few rows or small payloads on the main path, cost
less host time that way than through ctypes.

The toolkit is found under ``$CUDA_HOME`` (default ``/usr/local/cuda``)
or on ``PATH``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# Flags of one source beside NVCC_FLAGS. -fmad=false keeps each multiply
# and add separately rounded, as the plain PyTorch versions round them:
# the SRHT and codec kernels are then bit-equal to those versions. Flash
# attention is held to a tolerance and keeps its fused multiply-adds. Every
# source reports registers and spills (-Xptxas=-v, kept in the build log
# beside the library). srht.cu and codec.cu include the interpreter's
# headers.
_PY_INCLUDE = ("-I", sysconfig.get_paths()["include"])
SOURCE_FLAGS = {"srht": ("-fmad=false", "-Xptxas=-v", *_PY_INCLUDE),
                "codec": ("-fmad=false", "-Xptxas=-v", *_PY_INCLUDE),
                "flash_attention": ("-Xptxas=-v",),
                "flash_attention_sm90": ("-Xptxas=-v",),
                "flash_attention_bwd": ("-Xptxas=-v",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# source stem -> C entry point -> argument types (every pointer and the
# stream as c_void_p; all return cudaError_t as int); the entry points of
# srht.cu and codec.cu are called through ``module``
# q, k, v, o, lse (None: not written), b, tq, tk, h, hkv, d, causal,
# window, q_offset, scale, empty_denom, stream
_FLASH = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _D, _P)
# q, k, v, o, dout, lse, delta, dq, dk, dv, b, t, h, hkv, d, causal,
# window, scale, stream
_FLASH_BWD = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              _I, _D, _P)
SIGNATURES = {
    "srht": {},
    "flash_attention": {
        "repro_flash_attention_f32": _FLASH,
        "repro_flash_attention_bf16": _FLASH,
    },
    "flash_attention_sm90": {
        "repro_flash_attention_sm90_bf16": _FLASH,
    },
    "flash_attention_bwd": {
        "repro_flash_attention_bwd_f32": _FLASH_BWD,
        "repro_flash_attention_bwd_bf16": _FLASH_BWD,
    },
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {home}/bin or on PATH: the CUDA kernels "
            f"of repro_torch cannot be built")
    return found


def _flags(src: pathlib.Path) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS[src.stem]


def _target(src: pathlib.Path) -> pathlib.Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> "dict[str, float]":
    """Compile every source that has no current library, one ``nvcc``
    per source, all in parallel. Returns seconds per built source (empty
    when everything was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(src), "-o", str(tmp), str(src)]
        procs[src] = (out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    seconds = {}
    errors = []
    for src, (out, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        seconds[src.name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def build_log(stem: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<stem>.cu``."""
    build_all()
    return _target(CSRC / f"{stem}.cu").with_suffix(".log").read_text()


@functools.cache
def library(stem: str = "srht") -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built first if
    needed), with ``argtypes``/``restype`` declared for every entry."""
    build_all()
    lib = ctypes.CDLL(str(_target(CSRC / f"{stem}.cu")))
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def module(stem: str = "srht"):
    """The library built from ``csrc/<stem>.cu`` (built first if needed)
    imported as the Python extension module ``repro_<stem>``."""
    build_all()
    spec = importlib.util.spec_from_file_location(
        f"repro_{stem}", _target(CSRC / f"{stem}.cu"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(lib, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch; ``lib``
    is a ctypes ``library`` or an extension ``module``, whose
    ``repro_error_string`` names the error."""
    if err != 0:
        msg = lib.repro_error_string(err)
        if isinstance(msg, bytes):
            msg = msg.decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
