"""Build and load the port's CUDA kernels.

A source ``horovod_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o horovod_tpu_torch/_build/lib<name>-<hash>.so

The build happens at first use, from the source in the checkout, into
``horovod_tpu_torch/_build/`` (ignored by git).  The file name carries a hash
of the source, of every header in ``csrc/`` (``*.cuh``, which a source
includes by name) and of the flags, so an edited kernel or header is
rebuilt and a built one is reused.  Nothing here runs at import: the CPU
tests import every module, and there is no ``nvcc`` there.

The negotiation core (``csrc/core/``, the port's own copy of the C++
library's sources) is built the same way by ``g++``, one compiler per
source at once, then linked:

    g++ -O2 -g -std=c++17 -fPIC -pthread -c <source>.cc
    g++ -shared -pthread -o horovod_tpu_torch/_build/libhvd_core-<hash>.so
        *.o -lrt

under an ``fcntl`` lock in ``_build/`` (test workers that need the core at
once build it once), in a work directory of the building process,
renamed into place when it is whole.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

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


def source_digest(src: Path, flags=NVCC_FLAGS) -> str:
    """Hash of a kernel source, every header beside it (``*.cuh``, by name
    and content, so that an edited, added or removed header changes it)
    and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    library's path and nvcc's report (registers, shared memory, spills;
    empty when the library was reused).  Raises with nvcc's output on
    failure."""
    src = CSRC_DIR / f"{name}.cu"
    target = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
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


CORE_DIR = CSRC_DIR / "core"
CXX_FLAGS = ["-O2", "-g", "-std=c++17", "-fPIC", "-pthread"]
LINK_FLAGS = ["-shared", "-pthread"]
LINK_LIBS = ["-lrt"]  # shm_open/shm_unlink live in librt on older glibc


def core_digest(core_dir: Path = CORE_DIR, flags=None) -> str:
    """Hash of every source and header of the core (by name and content)
    and of the compile and link flags."""
    if flags is None:
        flags = CXX_FLAGS + LINK_FLAGS + LINK_LIBS
    digest = hashlib.sha256()
    for path in sorted(core_dir.glob("*.cc")) + sorted(core_dir.glob("*.h")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def _compile(cxx: str, src: Path, obj: Path) -> Tuple[int, str]:
    proc = subprocess.run([cxx, *CXX_FLAGS, "-c", str(src), "-o", str(obj)],
                          capture_output=True, text=True)
    return proc.returncode, f"{src.name}:\n{proc.stdout}{proc.stderr}"


def build_core(core_dir: Path = CORE_DIR, build_dir: Path = BUILD_DIR,
               cxx: str = "g++") -> Path:
    """``libhvd_core-<hash>.so``, compiled from ``core_dir`` by ``cxx``
    unless it is built already.  Raises with the compiler's output on
    failure.  The compiler is ``g++`` from PATH whatever ``$CXX`` says: a
    library built by another toolchain than the ``libstdc++`` the process
    loads can crash at run time."""
    target = build_dir / f"libhvd_core-{core_digest(core_dir)}.so"
    if target.exists():
        return target
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists():  # another process built it meanwhile
            return target
        work = build_dir / f"core.tmp{os.getpid()}"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        try:
            sources = sorted(core_dir.glob("*.cc"))
            objs: List[Path] = [work / f"{s.stem}.o" for s in sources]
            with ThreadPoolExecutor(len(sources)) as pool:
                results = list(pool.map(_compile, [cxx] * len(sources),
                                        sources, objs))
            failed = [out for rc, out in results if rc != 0]
            if failed:
                raise RuntimeError("native core build failed:\n"
                                   + "\n".join(failed))
            lib = work / target.name
            proc = subprocess.run(
                [cxx, *LINK_FLAGS, "-o", str(lib), *map(str, objs),
                 *LINK_LIBS], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("native core link failed:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(lib, target)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return target
