"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`, where the hash
covers the source and the flags, so an edited source never loads a stale
library. `build_all` starts one nvcc per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels are built from csrc/ at first use")
    return nvcc


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out


def build_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile every named source that has no current library, in parallel,
    then load them all. Raises with nvcc's output if a build fails."""
    names = list(names)
    with _lock:
        jobs: List = []
        for name in names:
            if name not in _libs:
                jobs.append((name, _start(name)))
        for name, job in jobs:
            if job is not None:
                proc, tmp, out = job
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
                os.replace(tmp, out)
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return {name: _libs[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]
