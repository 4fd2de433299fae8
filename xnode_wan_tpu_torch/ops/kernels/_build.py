"""Build and bind the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds. Libraries go
into ``xnode_wan_tpu_torch/_build/<hash of the sources and flags>/`` (listed
in ``.gitignore``), so an edited source is rebuilt and an unchanged one
is reused. :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for all of them.

No ``--use_fast_math``: ``tanhf`` and the division stay IEEE, which the
kernel-versus-plain tolerances rely on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("xnode_eval", "xnode_train")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    """Build directory keyed on the kernel sources and the nvcc flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` each, all started together. The compiler's output (``ptxas``
    register and spill counts) is kept in ``<name>.log`` beside the
    library. Raises with that output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        pending[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in pending.items():
        output, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(output)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{output}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


class CudaKernel:
    """One C entry point of a kernel library, loaded at its first call.

    ``launches`` counts the launches that succeeded; the entry point
    returns ``cudaGetLastError()`` after its launch, and a non-zero code
    raises here. Every entry point takes ``(int device, void* stream, ...)``
    first; the stream is PyTorch's current stream on that device.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build([self.source])[self.source]))
                fn = getattr(lib, self.symbol)
                fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + self.argtypes
                fn.restype = ctypes.c_int
                lib.xn_error_string.argtypes = [ctypes.c_int]
                lib.xn_error_string.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self.load()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(device.index, stream, *args)
        if err != 0:
            msg = self._lib.xn_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} ({msg})")
        self.launches += 1
