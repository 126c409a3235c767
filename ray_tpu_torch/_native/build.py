"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, no ninja), so a build takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \\
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

Libraries land in ``ray_tpu_torch/_build/`` (git-ignored), keyed by a hash of
the source, every ``csrc`` header it includes (``#include "..."``, followed
recursively) and the flags, built at first use under a file lock so that
concurrent processes build once.  A failed build raises; nothing falls back.
The ptxas report of each library (registers, shared memory, spills) is kept
beside it as ``lib<name>-<hash>.ptxas.txt``.

TMA tensor maps are encoded on the host with ``cuTensorMapEncodeTiled``,
which the kernels reach through ``cudaGetDriverEntryPoint``: the libraries
link only the CUDA runtime, no ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library this
# process built or found built, by kernel source name
build_logs: Dict[str, str] = {}
# the sources this process compiled (a process that found every library
# built, as a train worker after the driver's build, compiles none)
compiled: List[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def sources() -> list:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` file it includes, recursively,
    in a fixed order."""
    seen, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo.extend(path.parent / inc.decode()
                    for inc in _INCLUDE.findall(path.read_bytes()))
    return sorted(seen)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        _read_log(name, out)
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            _read_log(name, out)
            return out
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        _log_path(out).write_text(proc.stderr)
        os.replace(tmp, out)
        build_logs[name] = proc.stderr
        compiled.append(name)
    return out


def _read_log(name: str, lib: Path) -> None:
    log = _log_path(lib)
    if name not in build_logs and log.exists():
        build_logs[name] = log.read_text()


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every kernel source at once, one nvcc process each."""
    names = list(names) if names is not None else sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {n: pool.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
