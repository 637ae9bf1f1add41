"""Build-on-first-use of the port's CUDA kernels.

Each kernel source under `csrc/` has a plain C interface. It is compiled
with nvcc for `sm_90a` into a shared library under `nonrigid_nerf_torch/_build/`
(git-ignored) and loaded with ctypes. The library's file name carries a hash
of the source, of the headers beside it (`csrc/*.cuh`) and of the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. Nothing here runs at import time: `load_kernel_library`
is called by a wrapper the first time it launches on a CUDA tensor, and
`load_kernel_libraries` builds several sources side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# per library: the nvcc/ptxas report and the build time in seconds (0 when
# the library was already on disk)
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are built with it at first use")


def _library_path(source: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    sha = hashlib.sha1(repr(NVCC_FLAGS).encode())
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest[:12]}.so")


def load_kernel_libraries(sources: Sequence[str]) -> List[ctypes.CDLL]:
    """Compile each `csrc/<source>` that is not built yet, one nvcc per
    source and all started together, and load them."""
    running = []
    for source in sources:
        if source in _LIBS:
            continue
        lib_path = _library_path(source)
        info = {"seconds": 0.0, "log": "", "path": lib_path}
        BUILD_INFO[source] = info
        if os.path.exists(lib_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        src_path = os.path.join(CSRC_DIR, source)
        proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((info, proc, tmp, src_path, time.perf_counter()))
    failed = []
    for info, proc, tmp, src_path, t0 in running:
        info["log"] = proc.communicate()[0]
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src_path}:\n{info['log']}")
        else:
            os.replace(tmp, info["path"])
    if failed:
        raise RuntimeError("\n".join(failed))
    for source in sources:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(BUILD_INFO[source]["path"])
    return [_LIBS[source] for source in sources]


def load_kernel_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (if not built yet) and load it."""
    return load_kernel_libraries([source])[0]
