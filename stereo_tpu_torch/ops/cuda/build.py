"""Build the port's native code at first use and load it with ctypes.

The CUDA kernels under ``stereo_tpu_torch/csrc`` compile with ``nvcc`` into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds): one compiler process per source, all started
together, then one link. The host speckle filter compiles with ``g++``.
Both land in ``build/kernels/`` at the repository root, named by a hash of
their sources and flags, so a changed source rebuilds and an unchanged one
loads the library already built. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

#: IEEE division is required by the subpixel step: no --use_fast_math.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_cu = ctypes.c_uint
_cl = ctypes.c_longlong

#: C entry points of the kernel library: argument types (all return int:
#: the launch's cudaError_t, or the answer of a query).
KERNEL_SIGNATURES = {
    # w, sp -> 1 if K3's row fits a block's shared memory
    "stpu_sgm_select_fits": [_ci, _ci],
    # d -> K2's pixels staged per warp; d, cost_bytes -> its shared memory
    # per warp (bytes; a block holds one warp, two in the horizontal pair)
    "stpu_sgm_path_stages": [_ci],
    "stpu_sgm_path_smem": [_ci, _ci],
    # h, w, d -> a K2 sweep group's blocks; d -> its warps per block and
    # its shared memory per block (bytes)
    "stpu_sgm_group_blocks": [_ci, _ci, _ci],
    "stpu_sgm_group_warps": [_ci],
    "stpu_sgm_group_smem": [_ci],
    # img, out, h, w, wy, wx, image type, rank, stream
    "stpu_census_transform": [_vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _vp],
    # cl, cr, out, h, w, d, words, combine, md, maxc, ctx, x_off, stream
    "stpu_census_cost": [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
                         _ci, _ci, _vp],
    # d, wy, wx -> K5's shared memory per block (bytes) at its largest tile
    "stpu_sad_cost_smem": [_ci, _ci, _ci],
    # left, right, out, h, w, d, md, wy, wx, maxc, ctx, x_off, image type,
    # magic, shift, inv, bias, stream
    "stpu_sad_cost": [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
                      _ci, _ci, _cu, _ci, _cf, _cf, _vp],
    # cost, cost_bytes, image (NULL: fixed P2), sum, h, w, d, step_y,
    # step_x (0, 0: both horizontals, the horizontal pair; +-2, 0: the down
    # or up sweep group), p1, p2, p2_min, grad_floor, accumulate, rect (0:
    # the whole-frame form), y_lo, y_hi, x_lo, x_hi, shear (0, or the
    # sheared form's sign), x0 (its sheared column origin), frame_w, mask
    # (NULL, or the mask form's [h, w] bytes), sync and edge (a sweep
    # group's counters and edge buffer, else NULL), stream
    "stpu_sgm_path": [_vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
                      _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
                      _vp, _vp, _vp, _vp],
    # sum, disp, valid, d0 (NULL: not emitted), h, w, d, md, subpixel,
    # uniqueness, uniq_f, lr_check, lr_tau, x0, iw, lr_bit, qr (NULL: not
    # the emit_qr form), spill, own_lo, own_hi, sp, stream
    "stpu_sgm_select": [_vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci,
                        _cf, _ci, _cf, _ci, _ci, _vp, _vp, _vp, _ci, _ci,
                        _ci, _vp],
    # in, out, h, w, stream
    "stpu_median3x3": [_vp, _vp, _ci, _ci, _vp],
    # x, out, n, k, chains, is_int, stream
    "stpu_alu_peak": [_vp, _vp, _cl, _ci, _ci, _ci, _vp],
}

_lock = threading.Lock()
_kernels: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "source at first use"
        )
    return found


def compile_library(name: str, sources: Sequence[Path],
                    compiler: List[str]) -> Path:
    """Compile each of ``sources`` with ``compiler + [-c, -o obj, src]``,
    all in parallel, and link them with ``compiler[0] -shared`` into
    BUILD_DIR, unless a library of the same sources and command exists.
    The compilers' output, and each compile's wall seconds, are kept
    beside the library as ``<lib>.log``."""
    digest = hashlib.sha256()
    for part in compiler:
        digest.update(part.encode() + b"\0")
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    objs = [str(work / f"{src.stem}.o") for src in sources]
    procs = []
    try:
        t0 = time.perf_counter()
        for src, obj in zip(sources, objs):
            cmd = [*compiler, "-c", "-o", obj, str(src)]
            # Output to a file: a full pipe would stall the compiler.
            with open(work / f"{src.stem}.out", "w") as out:
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT)))
        seconds = {}
        while len(seconds) < len(procs):
            for i, (_, proc) in enumerate(procs):
                if i not in seconds and proc.poll() is not None:
                    seconds[i] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                raise RuntimeError(f"building {name}: over 600 s")
            time.sleep(0.05)
        runs = [(cmd, (work / f"{src.stem}.out").read_text()
                 + f"# compiled in {seconds[i]:.1f} s\n", proc.returncode)
                for i, (src, (cmd, proc)) in enumerate(zip(sources, procs))]
        if all(rc == 0 for *_, rc in runs):
            cmd = [compiler[0], "-shared", "-o", str(work / lib.name), *objs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=600)
            runs.append((cmd, proc.stdout, proc.returncode))
        lib.with_name(lib.name + ".log").write_text(
            "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in runs))
        failed = [out for _, out, rc in runs if rc != 0]
        if failed:
            raise RuntimeError(
                f"building {name} failed:\n" + "\n".join(
                    line for out in failed for line in out.splitlines()
                    if "ptxas info" not in line and "bytes stack" not in line)
            )
        os.replace(work / lib.name, lib)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return lib


def kernel_sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def load_kernels() -> ctypes.CDLL:
    """The CUDA kernel library, built on first use."""
    global _kernels
    with _lock:
        if _kernels is None:
            path = compile_library(
                "stereo_kernels", kernel_sources(), [find_nvcc(), *NVCC_FLAGS]
            )
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in KERNEL_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.stpu_error_string.argtypes = [ctypes.c_int]
            lib.stpu_error_string.restype = ctypes.c_char_p
            _kernels = lib
        return _kernels


def check_launch(fn: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = load_kernels().stpu_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: cudaError_t {err} ({text})")
