"""Build-and-load step for the port's hand-written CUDA kernels.

Every ``kernels/csrc/*.cu`` file is one kernel with a plain C entry point.
On first use each is compiled by ``nvcc`` for Hopper (``sm_90a``) into its
own shared library under ``kernels/_build/`` (listed in ``.gitignore``) and
bound with :mod:`ctypes`; the sources are compiled in parallel, one ``nvcc``
process each, all started together. A library is named after a digest of
its sources and flags, so an edited source rebuilds and an unchanged one is
reused within a checkout.

This step is where the port decides whether its kernels can run, the role
`paddle_tpu/kernels/pallas/_compat.py::probe_mosaic_lowering` plays on the
TPU: a missing ``nvcc`` or a failed compile raises with the compiler's
error. Nothing falls back to the plain PyTorch versions: those run only for
tensors that lie on the CPU (`kernels/registry.py`).
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

from paddle_tpu_torch.kernels import registry

__all__ = ["CudaKernel", "nvcc", "build_all", "kernels", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LOCK = threading.Lock()
_KERNELS: list["CudaKernel"] = []
_BUILT: dict[str, dict] = {}     # source stem -> {"path", "seconds", "ptxas"}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on
    ``PATH``, then the toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found (looked at "
        f"{cands}). The kernels run only where the CUDA toolkit is "
        "installed; tensors on the CPU take the plain PyTorch versions.")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, all in parallel, and
    return ``{stem: {"path", "seconds", "ptxas"}}`` for every source. Raises
    with nvcc's output if any compile fails."""
    with _LOCK:
        todo = [s for s in _sources() if s.stem not in _BUILT]
        if not todo:
            return dict(_BUILT)
        cc = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            lib = _lib_path(src)
            if lib.exists():
                _BUILT[src.stem] = {"path": str(lib), "seconds": 0.0,
                                    "ptxas": "(reused)"}
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [cc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            procs.append((src, lib, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        failures = []
        for src, lib, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {src.name} "
                                f"(exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, lib)   # atomic: a concurrent build sees old or new
            _BUILT[src.stem] = {"path": str(lib),
                                "seconds": time.perf_counter() - t0,
                                "ptxas": log}
        if failures:
            raise RuntimeError("\n\n".join(failures))
        return dict(_BUILT)


class CudaKernel:
    """One ``csrc/<source>.cu`` C entry point, built on first launch and
    bound with ctypes. ``launches`` counts successful launches, and only
    those: it is how a run shows that its main path went through the
    kernel."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        _KERNELS.append(self)

    @property
    def path(self) -> str:
        """Repo-relative path of the kernel's CUDA source."""
        return f"paddle_tpu_torch/kernels/csrc/{self.source}.cu"

    def _load(self):
        if self._fn is None:
            lib = ctypes.CDLL(build_all()[self.source]["path"])
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args):
        """Call the C entry point; raise when it reports a CUDA error (a
        refused launch never runs, and a later synchronize would not say
        so)."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch: "
                               f"cudaError {rc}")
        own = registry.tally()
        if own is not None:       # a graph's warm-up or capture run
            own["launches"][self] = own["launches"].get(self, 0) + 1
        else:
            self.launches += 1


def kernels() -> list[CudaKernel]:
    """Every kernel the imported wrapper modules declared."""
    return list(_KERNELS)
