"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, which the kernel's wrapper loads
with ``ctypes``. The build happens on first use, never at import, into
``build/repro_torch/<name>-<hash>/`` at the root of the checkout (a path
``.gitignore`` lists); the hash covers the source, every ``csrc`` header it
includes (``#include "..."``, followed recursively) and the flags, so an
edited source or header rebuilds and an unchanged one loads from the cache.

Also the pieces every wrapper shares: :class:`LaunchCounter` and
:func:`launch` (current stream, error code to exception).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
MAX_SMEM = 232_448  # shared memory one Hopper block may use (dynamic, opted in)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are built on the machine "
        "that has the card")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str, csrc: pathlib.Path = CSRC) -> List[pathlib.Path]:
    """``csrc/<name>.cu`` and every header of ``csrc`` it includes with
    quotes, directly or through another header, in a fixed order."""
    seen: List[pathlib.Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def library_path(name: str, csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Where the build of ``csrc/<name>.cu`` with the current flags and
    headers lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless the cached library exists; returns
    the library path. The compiler's resource report (``-Xptxas -v``) is
    kept beside it in ``build.log``."""
    lib = library_path(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build of the same
    # source can never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    (lib.parent / "build.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    os.replace(tmp, lib)
    return lib


def build_all(names: Iterable[str]) -> List[pathlib.Path]:
    """Build several libraries at once, one ``nvcc`` each, all started
    together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name`` once per
    process."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """The compiler output of the cached build of ``name`` ('' if none)."""
    log = library_path(name).parent / "build.log"
    return log.read_text() if log.exists() else ""


@dataclasses.dataclass
class LaunchCounter:
    """Launches of one kernel: added to only where the wrapper launches it,
    never by its plain version."""

    n: int = 0

    def reset(self) -> None:
        self.n = 0


def launch(what: str, fn: Callable[..., int], error_string: Callable[[int], bytes],
           device: torch.device, *args) -> None:
    """Call the C launch function ``fn(*args, stream)`` on ``device``'s
    current stream and raise on the ``cudaGetLastError()`` code it returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(err).decode()}")
