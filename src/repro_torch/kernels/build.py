"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` is one shared library with a plain C interface, built by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
(no PyTorch headers, so a build takes seconds).  Libraries land in
``build/repro_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and flags, and are built at first use.  ``build_all`` starts
one ``nvcc`` per source, all at once.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the instantiations every kernel is compiled for; dtype codes match
# kFloat32 / kBFloat16 in csrc/common.cuh
HEAD_DIMS = (32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``) on PATH or under
    ``CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / name
    if not path.exists():
        raise RuntimeError(f"{name} not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns {kernel name: nvcc's resource report (``-Xptxas -v``)} for the
    sources built in this call.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not (out_dir / f"{s.stem}.so").exists()]
    if not todo:
        return {}
    nvcc = cuda_tool("nvcc")
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for src, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out_dir / f"{src.stem}.so")
        reports[src.stem] = text
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def lib_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return _build_dir() / f"{name}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check_tensor(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust all four."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
