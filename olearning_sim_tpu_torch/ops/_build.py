"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, then loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds, not minutes). Builds happen
at first use, inside the call that needs the kernel, into
``<repo>/build/kernels/`` (listed in ``.gitignore``). The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a current one is reused.

``python -m olearning_sim_tpu_torch.ops._build`` builds every source ahead
of time (:func:`build_all`; ``nvcc`` needs no card to compile for
``sm_90a``), as the GPU image does (``deploy/Dockerfile.gpu``), so a
process that later loads a kernel finds its library and compiles nothing.
It prints one line per source: ``<source> built|found <library path>``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Compiler output (``-Xptxas -v``: registers, shared memory, spills) of each
# library built by this process, by source name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def library_path(source: str) -> Tuple[pathlib.Path, pathlib.Path]:
    """``(source_path, library_path)`` for ``csrc/<source>``."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = src.stem + "-" + digest.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{stem}.so"


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` unless its current library exists; return
    the library path. Safe to call from several processes at once (each
    writes a private temporary file and renames it into place)."""
    src, lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, building it on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib


def sources() -> List[str]:
    """Every kernel source of the package, by file name."""
    return sorted(p.name for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Tuple[pathlib.Path, bool]]:
    """Build every source (one ``nvcc`` each, all started together) unless
    its current library exists. Returns ``source -> (library path, built)``,
    ``built`` False where the library was found."""
    names = sources()
    found = {name: library_path(name)[1].exists() for name in names}
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = list(pool.map(build, names))
    return {name: (lib, not found[name]) for name, lib in zip(names, libs)}


def main() -> int:
    for name, (lib, built) in build_all().items():
        print(f"{name} {'built' if built else 'found'} {lib}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
