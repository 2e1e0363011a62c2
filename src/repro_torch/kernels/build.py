"""Build and load the hand-written CUDA kernels of this package.

Each source in `csrc/` compiles with `nvcc` into a shared library with a
plain C interface, loaded with `ctypes`.  Every source gets its own `nvcc`
process and all of them start together.  Libraries are named by a hash of
their sources and flags, so an edited kernel is rebuilt and an unchanged one
is reused.  Nothing is built or loaded at import: the first call that needs
a library builds it.

Launch counts live here too: every wrapper that launches a kernel adds one
to that kernel's count, right after the launch and nowhere else.  Kernel 3's
two routes count apart (`fused_facility_totals`, `fused_facility_series`).

Each `nvcc` build and each load of a built library is reported, with its
seconds, to the compile monitor of core/telemetry.py: they are this
package's compiles.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from ..core import telemetry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("power_carbon", "first_fit", "fused_step", "ssd_chunk",
           "flash_attn", "host_sum")

# IEEE division and sqrt (no --use_fast_math) and no contracted multiply-add,
# so the kernels repeat their plain versions' f32 arithmetic operation for
# operation; the model kernels' inner products call fmaf() where they mean
# a fused multiply-add.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNELS = ("fused_power_carbon", "fused_facility_power",
           "fused_facility_totals", "fused_facility_series",
           "first_fit_place", "ssd_intra_chunk", "flash_attention",
           "per_host_sum")
_launches = dict.fromkeys(KERNELS, 0)
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Build the named libraries that are not built yet, one `nvcc` each,
    all in parallel.  Returns {name: {"seconds", "ptxas", "path"}} for the
    ones built; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _target(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _target(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    report, failed = {}, []
    last = t0  # the builds overlap: each reports the wall since the last
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees whole files
        now = time.perf_counter()
        telemetry.note_compile(now - last)
        last = now
        report[n] = {"seconds": now - t0, "path": str(out),
                     "ptxas": [ln.strip() for ln in log.splitlines()
                               if "spill" in ln or "ptxas" in ln and any(
                                   w in ln for w in ("Used", "Compiling",
                                                     "Performance",
                                                     "warning"))]}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def resources(ptxas: list[str], kernel: str) -> list[dict]:
    """Registers, stack, spill and static shared-memory bytes of every
    compiled kernel whose (mangled) name holds `kernel`, from a build's
    `ptxas` lines."""
    out, cur = [], None
    for ln in ptxas:
        if "Compiling entry function" in ln:
            cur = None
            if kernel in ln:
                cur = {"function": ln.split("'")[1]}
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            if m:
                cur["static_smem"] = int(m[1])
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(_target(name)))
        telemetry.note_compile(time.perf_counter() - t0)
        err = getattr(lib, f"steam_{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """C entry point `fn_name` of library `lib_name`, its argument and
    result types declared once (ctypes would otherwise pass each int as 32
    bits and cut the pointers); a launch returns an int CUDA error code."""
    fn = _fns.get(fn_name)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes, fn.restype = list(argtypes), restype
        _fns[fn_name] = fn
    return fn


def check(name: str, what: str, code: int) -> None:
    """Raise if a C entry point of library `name` returned a CUDA error."""
    if code != 0:
        msg = getattr(library(name), f"steam_{name}_error_string")(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({msg.decode(errors='replace')})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def f32(t):
    """t as contiguous f32: t itself when it already is (no copy)."""
    import torch
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def aligned(t):
    """t, or a fresh copy of it if its data does not start on 16 bytes (the
    model kernels copy 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(what: str, *tensors) -> None:
    """Wrappers launch only on CUDA tensors of one device (they make their
    own contiguous copies where needed)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: all inputs must be CUDA tensors on "
                             f"{dev}, got {t.device}")
