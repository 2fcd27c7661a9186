"""Build and load the port's CUDA kernels.

A source ``horovod_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o horovod_tpu_torch/_build/lib<name>-<hash>.so

The build happens at first use, from the source in the checkout, into
``horovod_tpu_torch/_build/`` (ignored by git).  The file name carries a hash
of the source and the flags, so an edited kernel is rebuilt and a built one
is reused.  Nothing here runs at import: the CPU tests import every module,
and there is no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH); "
            "the CUDA toolkit is needed to build the port's kernels")
    return found


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    library's path and nvcc's report (registers, shared memory, spills;
    empty when the library was reused).  Raises with nvcc's output on
    failure."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {src.name} (nvcc exit "
                           f"{proc.returncode}):\n{report}")
    os.replace(tmp, target)  # atomic: ranks building at once are safe
    return target, report


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)[0]))
