"""Build and bind the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds. A source listed in
``WIDTH_SOURCES`` is compiled once per tuple of widths, one define each:
``xnode_fwd`` per XNODE width pair (H, Hh), with ``-DXN_H=<H>
-DXN_HH=<Hh>``, into ``libxnode_fwd_H<H>_Hh<Hh>.so``, and ``disc_fwd`` per
adversary width H, with ``-DXD_H=<H>``, into ``libdisc_fwd_H<H>.so``: their
register kernels size their per-thread arrays by those widths. Every other
source (``xnode_grad``, ``xnode_path_tile``, ``disc_train``) takes its
widths at run time and is built once. Libraries go into
``xnode_wan_tpu_torch/_build/<hash of the sources and flags>/`` (listed in
``.gitignore``), so an edited source is rebuilt and an unchanged one is
reused. :func:`build` starts one ``nvcc`` per missing library, all at
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
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("xnode_fwd", "xnode_grad", "xnode_path_tile", "disc_fwd",
                  "disc_train")
# Width-specialized sources: (define, tag in the library name) per width
WIDTH_SOURCES = {"xnode_fwd": (("XN_H", "H"), ("XN_HH", "Hh")),
                 "disc_fwd": (("XD_H", "H"),)}

Widths = Optional[Tuple[int, ...]]


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


def _width_defines(source: str, widths: Widths) -> List[Tuple[str, str,
                                                             int]]:
    """``(define, tag, width)`` for each width of ``source``; raises unless
    ``widths`` has exactly the widths the source takes."""
    spec = WIDTH_SOURCES.get(source, ())
    if (widths is None) != (not spec) or len(widths or ()) != len(spec):
        raise ValueError(f"{source} takes the widths "
                         f"{[tag for _, tag in spec]}, given {widths}")
    return [(d, tag, w) for (d, tag), w in zip(spec, widths or ())]


def lib_name(source: str, widths: Widths = None) -> str:
    """``source``, or ``source_H<H>_Hh<Hh>`` / ``source_H<H>`` for a
    width-specialized one."""
    return source + "".join(f"_{tag}{w}"
                            for _, tag, w in _width_defines(source, widths))


def library_path(source: str, widths: Widths = None) -> Path:
    return build_dir() / f"lib{lib_name(source, widths)}.so"


def nvcc_command(source: str, widths: Widths, out: Path,
                 nvcc: str = "nvcc") -> List[str]:
    """The ``nvcc`` command line that builds ``source`` (at ``widths``)."""
    defines = [f"-D{d}={w}" for d, _, w in _width_defines(source, widths)]
    return [nvcc, *NVCC_FLAGS, *defines, "-o", str(out),
            str(CSRC / f"{source}.cu")]


def build(targets: Iterable[Tuple[str, Widths]]) -> Dict[str, Path]:
    """Compile every library of ``targets`` (``(source, None)``, or
    ``(source, widths)`` for a width-specialized one) that is missing,
    one ``nvcc`` each, all started together. The compiler's output (``ptxas`` register
    and spill counts) is kept in ``<library name>.log`` beside the
    library. Returns the paths by library name; raises with the output if
    any build fails."""
    targets = list(targets)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    pending = {}
    for source, widths in targets:
        name = lib_name(source, widths)
        lib = library_path(source, widths)
        if lib.exists() or name in pending:
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = nvcc_command(source, widths, tmp, _nvcc())
        pending[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in pending.items():
        output, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(output)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                          f"{output}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {lib_name(*t): library_path(*t) for t in targets}


class CudaKernel:
    """One C entry point of a kernel library, loaded at its first call.

    For a width-specialized source the caller passes its ``widths`` and
    gets the library built for them; ``launches`` counts the
    launches that succeeded, whichever the library. The entry point
    returns ``cudaGetLastError()`` after its launch, and a non-zero code
    raises here. Every entry point takes ``(int device, void* stream,
    ...)`` first; the stream is PyTorch's current stream on that device.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._loaded = {}  # widths -> (library, entry point)
        self._lock = threading.Lock()

    def load(self, widths: Widths = None):
        with self._lock:
            if widths not in self._loaded:
                name = lib_name(self.source, widths)
                lib = ctypes.CDLL(str(build([(self.source, widths)])[name]))
                fn = getattr(lib, self.symbol)
                fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + self.argtypes
                fn.restype = ctypes.c_int
                lib.xn_error_string.argtypes = [ctypes.c_int]
                lib.xn_error_string.restype = ctypes.c_char_p
                self._loaded[widths] = (lib, fn)
        return self._loaded[widths]

    def __call__(self, device: torch.device, *args,
                 widths: Widths = None) -> None:
        lib, fn = self.load(widths)
        stream = torch.cuda.current_stream(device).cuda_stream
        # names the launch in a torch.profiler trace (profile_dir)
        with torch.profiler.record_function(self.symbol):
            err = fn(device.index, stream, *args)
        if err != 0:
            msg = lib.xn_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} ({msg})")
        self.launches += 1


class KernelVariants:
    """One kernel's launch count over the variants it is built as
    (``{name: CudaKernel}``): ``launches`` is their sum, and setting it to
    0 zeroes each; :meth:`by_variant` gives each variant's count."""

    def __init__(self, variants: Dict[str, CudaKernel]):
        self.variants = dict(variants)

    @property
    def launches(self) -> int:
        return sum(k.launches for k in self.variants.values())

    @launches.setter
    def launches(self, n: int) -> None:
        if n != 0:
            raise ValueError("a kernel's variants are reset to 0 together")
        for k in self.variants.values():
            k.launches = 0

    def by_variant(self) -> Dict[str, int]:
        return {name: k.launches for name, k in self.variants.items()}
