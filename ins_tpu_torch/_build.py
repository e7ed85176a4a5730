"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<file>.cu   (each)
    nvcc -shared -o <lib> <objs>

The library lands in `build/ins_tpu_torch/` beside the package (listed in
`.gitignore`), named by a hash of the sources, the headers and the flags,
so an edited source is rebuilt at first use and an unchanged one is
loaded as is.  The build happens on first use, never at import.  A failed
build raises `KernelBuildError` with the compiler's output; `ptxas`
register and spill counts of a successful build are kept in `build.log`
beside it.
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

__all__ = ["KernelBuildError", "build", "load", "check", "build_seconds"]

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "ins_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_f32 = ctypes.c_float
_c_i64 = ctypes.c_longlong

# the cube stage (float and bf16 stream storage share it)
_STAGE = (
    [_c_ptr, _c_ptr, _c_ptr, ctypes.POINTER(_c_ptr), ctypes.POINTER(_c_f32),
     _c_int, _c_f32, _c_ptr, _c_ptr, _c_f32, _c_int,
     _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,
     _c_f32, _c_f32, _c_f32, _c_f32, _c_f32]
    + [_c_ptr] * 5 + [_c_int] + [_c_f32] * 3 + [_c_int, _c_ptr, _c_ptr],
    _c_int,
)

# C signatures of the exported entry points: (argtypes, restype)
_SIGNATURES = {
    "ins_plane_gemm_tf32": (
        [_c_ptr, _c_i64, _c_ptr, _c_ptr, _c_i64] + [_c_int] * 5 + [_c_ptr],
        _c_int,
    ),
    "ins_plane_gemm_bf16x3": (
        [_c_ptr, _c_i64, _c_ptr, _c_ptr, _c_i64] + [_c_int] * 5 + [_c_ptr],
        _c_int,
    ),
    "ins_stage_f32": _STAGE,
    "ins_stage_bf16": _STAGE,
    "ins_stage_halo_f32": (
        [_c_ptr] * 8 + [ctypes.POINTER(_c_ptr)] * 2 + [ctypes.POINTER(_c_f32), _c_int,
                                                      _c_f32, _c_ptr, _c_f32, _c_int]
        + [_c_ptr] * 5 + [_c_int] * 2 + [_c_f32] * 5 + [_c_ptr] * 2 + [_c_int] * 2
        + [_c_ptr],
        _c_int,
    ),
    "ins_eigen_scale_f32": (
        [_c_ptr] + [_c_int] * 6 + [_c_f32] * 5 + [_c_ptr],
        _c_int,
    ),
    "ins_fold_split_f32": ([_c_ptr] * 3 + [_c_i64, _c_ptr], _c_int),
    "ins_fold_combine_f32": ([_c_ptr] * 3 + [_c_i64, _c_ptr], _c_int),
    "ins_passb_fold_f32": ([_c_ptr] * 8 + [_c_int] * 4 + [_c_f32] * 5 + [_c_ptr], _c_int),
    "ins_passb_fold_bf16x3": ([_c_ptr] * 8 + [_c_int] * 4 + [_c_f32] * 5 + [_c_ptr], _c_int),
    "ins_passb_dense_f32": ([_c_ptr] * 4 + [_c_int] * 3 + [_c_f32] * 5 + [_c_ptr], _c_int),
    "ins_passb_dense_bf16x3": ([_c_ptr] * 4 + [_c_int] * 3 + [_c_f32] * 5 + [_c_ptr], _c_int),
    "ins_smag_f32": (
        [_c_ptr] * 5 + [_c_int] * 3 + [_c_f32] * 4 + [_c_ptr],
        _c_int,
    ),
    "ins_smag_halo_f32": (
        [_c_ptr] * 11 + [_c_int] * 5 + [_c_f32] * 4 + [_c_ptr],
        _c_int,
    ),
    "ins_correct_f32": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_f32, _c_f32, _c_f32, _c_ptr],
        _c_int,
    ),
    "ins_correct_bf16": (
        [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_f32, _c_f32, _c_f32, _c_ptr],
        _c_int,
    ),
    "ins_correct_halo_f32": (
        [_c_ptr] * 4 + [_c_int] * 2 + [_c_f32] * 3 + [_c_ptr],
        _c_int,
    ),
    "ins_convdiff_f32": (
        [_c_ptr, _c_ptr] + [_c_int] * 3 + [_c_f32] * 6 + [_c_ptr],
        _c_int,
    ),
    "ins_stage_div_f32": (
        [_c_ptr, _c_ptr, _c_f32, _c_ptr, _c_ptr] + [_c_int] * 3 + [_c_f32] * 4 + [_c_ptr],
        _c_int,
    ),
    "ins_pressure_correct_f32": (
        [_c_ptr, _c_ptr, _c_ptr] + [_c_int] * 3 + [_c_f32] * 3 + [_c_ptr],
        _c_int,
    ),
    "ins_conv_fwd_mma": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int] + [_c_int] * 11 + [_c_ptr],
        _c_int,
    ),
    "ins_conv_wgrad_mma_chunks": ([_c_int] * 6, _c_int),
    "ins_conv_wgrad_mma": (
        [_c_ptr] * 4 + [_c_int] * 11 + [_c_ptr],
        _c_int,
    ),
    "ins_conv_fwd_tf32": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int] + [_c_int] * 11 + [_c_ptr],
        _c_int,
    ),
    "ins_conv_wgrad_tf32_chunks": ([_c_int] * 7, _c_int),
    "ins_conv_wgrad_tf32": (
        [_c_ptr] * 4 + [_c_int] * 11 + [_c_ptr],
        _c_int,
    ),
    "ins_tapconv_fwd_mma": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int] + [_c_int] * 10 + [_c_ptr],
        _c_int,
    ),
    "ins_tapconv_fwd_tf32": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int] + [_c_int] * 10 + [_c_ptr],
        _c_int,
    ),
    "ins_tapconv_wgrad_mma": (
        [_c_ptr] * 4 + [_c_int] * 14 + [_c_ptr],
        _c_int,
    ),
    "ins_tapconv_wgrad_tf32": (
        [_c_ptr] * 4 + [_c_int] * 15 + [_c_ptr],
        _c_int,
    ),
    "ins_packconv_tf32": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int] + [_c_int] * 9 + [_c_ptr],
        _c_int,
    ),
    "ins_packconv_mma": (
        [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int] + [_c_int] * 9 + [_c_ptr],
        _c_int,
    ),
    "ins_channel_msd_f32": (
        [_c_ptr] * 10 + [_c_int] * 3 + [_c_f32] * 11 + [_c_int] * 2 + [_c_ptr],
        _c_int,
    ),
    "ins_channel_correct_f32": (
        [_c_ptr] * 4 + [_c_int] * 3 + [_c_f32] * 2 + [_c_ptr],
        _c_int,
    ),
    "ins_error_string": ([_c_int], ctypes.c_char_p),
}

_lib = None
# wall seconds of the last compile in this process (None: loaded a
# library that was already built, or nothing loaded yet)
build_seconds = None


class KernelBuildError(RuntimeError):
    """The CUDA sources could not be compiled or loaded."""


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from ins_tpu_torch/csrc at first use"
    )


def _run_all(cmds):
    """Run the commands concurrently; returns [(cmd, returncode, output)]."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    outs = [(cmd, p.communicate()[0]) for cmd, p in procs]
    return [(cmd, p.returncode, out) for (cmd, out), (_, p) in zip(outs, procs)]


def build():
    """Compile the kernels if the library for the current sources is
    missing; return its path."""
    global build_seconds
    tag = _source_hash()
    lib_path = BUILD_DIR / f"libins_tpu_torch_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():  # another process built it meanwhile
                return lib_path
            tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
            objs = [BUILD_DIR / f"{p.stem}_{tag}.o" for p in _sources()]
            t0 = time.perf_counter()
            runs = _run_all([
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                for p, o in zip(_sources(), objs)
            ])
            if all(rc == 0 for _, rc, _ in runs):
                runs += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
            elapsed = time.perf_counter() - t0
            log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in runs)
            (BUILD_DIR / "build.log").write_text(log)
            for o in objs:
                o.unlink(missing_ok=True)
            if any(rc != 0 for _, rc, _ in runs):
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"nvcc failed:\n{log}")
            os.replace(tmp, lib_path)
            build_seconds = elapsed
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err, what):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load().ins_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
