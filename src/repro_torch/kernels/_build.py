"""Build the port's CUDA kernels into one shared library, at first use.

The sources under ``repro_torch/csrc/`` have a plain C interface. Each
``.cu`` is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one ``.so`` that is loaded
with ``ctypes``. The library is named after a hash of the sources and
flags and kept in ``build/repro_torch/`` at the root of the checkout, so
an edited source builds anew and an unchanged one is reused.

Nothing here runs when the module is imported: :func:`library` builds
and loads on the first kernel launch.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Limits the launchers' grids obey (mirrored from csrc/): gridDim.y, and the
# bytes one CTA of the byte-copy kernels moves (kCopyChunk, byte_copy.cuh).
MAX_GRID_Y = 65535
COPY_CHUNK_BYTES = 64 * 1024

LAUNCHES: dict[str, int] = {"block_dist": 0, "scatter_save": 0,
                            "masked_restore": 0, "arena_maintain": 0,
                            "arena_scatter": 0, "parity_xor": 0,
                            "gf256_mac": 0, "fused_maintain": 0}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # seconds the last build took (None: reused)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "block_dist_chunks": ([_I64], _I64),
    "block_dist_f32": ([_P, _P, _P, _P, _I64, _I64, _P], ctypes.c_int),
    "scatter_save_bytes": ([_P, _P, _P, _I64, _I64, _I64, _P], ctypes.c_int),
    "masked_restore_bytes": ([_P, _P, _P, _P, _I64, _I64, _P], ctypes.c_int),
    "arena_maintain": ([_P] * 13 + [_I64] + [_P] * 3 + [_I64, _I64]
                       + [_P] * 4 + [_I64, _P], ctypes.c_int),
    "arena_scatter": ([_P] * 6 + [_I64, _P], ctypes.c_int),
    "parity_xor_chunks": ([_I64], _I64),
    "parity_xor": ([_P] * 10 + [_I64, _I64, _P], ctypes.c_int),
    "gf256_mac_chunks": ([_I64], _I64),
    "gf256_mac_max_m": ([], _I64),
    "gf256_mac": ([_P] * 13 + [_I64] * 7 + [_P], ctypes.c_int),
    "fused_maintain_chunks": ([_I64], _I64),
    "fused_maintain": ([_P] * 8 + [_I64] * 10 + [_P], ctypes.c_int),
    "repro_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    work = target.parent / f"objs_{target.stem}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    units = sorted(CSRC.glob("*.cu"))
    procs = []
    for unit in units:
        obj = work / (unit.stem + ".o")
        procs.append((unit, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(unit), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for unit, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {unit.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(unit.name)
    (target.parent / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = work / target.name
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
    os.replace(tmp, target)
    shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if not target.exists():
        t0 = time.perf_counter()
        _build(target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _lib = lib
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def launch(kernel: str, fn, device, *args) -> None:
    """Call C launcher ``fn(*args, stream)`` on ``device``'s current
    PyTorch stream, raise on its CUDA error code, and count the launch.

    The stream comes from ``torch._C._cuda_getCurrentRawStream`` (the raw
    handle PyTorch's own compiled kernels launch on); building a
    ``torch.cuda.Stream`` object per launch cost more host time than the
    kernels of a small leaf take on the card. The device guard is entered
    only when ``device`` is not the current device already.
    """
    idx = device.index
    if idx == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    check(rc, kernel)
    LAUNCHES[kernel] += 1
