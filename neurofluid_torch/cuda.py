"""Devices and constants on them, the nvcc build of `csrc/*.cu`, and the
kernel launch handle.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds); the `csrc/*.cuh`
headers are shared building blocks that a source includes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/neurofluid_torch/<name>-<hash>.so <name>.cu

The build runs at first use and is keyed on a hash of the source, the
headers and the flags, so an edited source rebuilds and an unchanged one
loads. Libraries
load through ctypes; every C entry point takes device pointers and the
stream as `c_void_p` and returns `cudaGetLastError()`, which `Kernel`
turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "neurofluid_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA raises (the
    port's entry points default to the card and never fall back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions"
        )
    return dev


@functools.lru_cache(maxsize=64)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """`values` as a 1-D `dtype` tensor on `device`, each element rounded
    as `torch.as_tensor(values, dtype=dtype)` rounds it. It is written by
    fills: a copy from host memory would wait until the device has drained
    its queue. Made once per argument set and shared by every caller, so
    it is read and never written."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return path


def nvcc_version() -> str:
    """The toolkit's version as `nvcc --version` names it (V12.9.86 ->
    '12.9.86')."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    m = re.search(r"V(\d+\.\d+\.\d+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1]


def library_path(source: str) -> Path:
    """Build output for `csrc/<source>`, named by a hash of its text, the
    headers', any other source it includes and the flags."""
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text)
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    for name in re.findall(rb'#include "([^"]+\.cu)"', text):
        digest.update((CSRC / name.decode()).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _start_build(source: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(sources) -> None:
    """Compile every source that has no current library, one nvcc process
    per source, all started together."""
    started = [(s, _start_build(s)) for s in sources]
    errors = []
    for s, st in started:
        try:
            _finish_build(s, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def loaded(source: str) -> ctypes.CDLL | None:
    """The library of `csrc/<source>` if this process has loaded it, else
    None (nothing is built)."""
    return _libs.get(source)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
        return lib


class Kernel:
    """A C entry point of one `csrc/` source, with its launch count.

    `argtypes` are the ctypes of the arguments before the stream, which
    every entry point takes last; calls pass those arguments and the
    current stream is appended.

    `launches` grows by one for each launch that the CUDA runtime accepted;
    nothing else changes it, so a run can show which kernels it went
    through.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} ({self.source}) failed to launch: CUDA error "
                f"{err}"
            )
        self.launches += 1


def check_tensor(name: str, t: torch.Tensor, device: torch.device,
                 dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on the CUDA device
    `device`."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
