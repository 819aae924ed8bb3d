"""Build the hand kernels in ``csrc/`` into one shared library with nvcc.

Each ``.cu`` file is compiled to an object by its own nvcc process, all
started together, and the objects are linked into ``libef_kernels.so``. The
library has a plain C interface (pointers, ints, floats, the stream) and is
loaded with ctypes by ``kernels/ops.py``; no PyTorch header is compiled.

The library lands in ``_build/<hash>/`` beside this file (listed in
.gitignore), keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built at import time:
``build()`` runs on the first kernel launch, or from ``chip_smoke.py``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("ef_update.cu", "fused_round.cu", "codec.cu",
           "flash_attention.cu", "topk.cu")
LIB_NAME = "libef_kernels.so"
# no --use_fast_math: the kernels rely on IEEE division and rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch are built from source on first use")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Return the path of the built library, building it first when no
    library for the current sources exists. The compiler's output (register
    and spill counts from ``-Xptxas -v``) is kept in ``build.log`` beside
    the library."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        log = []
        failed = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            log.append(f"== nvcc {src} (exit {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
        log.append(f"== built in {time.time() - t0:.1f} s")
        lib.parent.mkdir(parents=True, exist_ok=True)
        (lib.parent / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)       # atomic: a reader never sees half a .so
    return lib


def build_log() -> str:
    path = library_path().parent / "build.log"
    return path.read_text() if path.exists() else ""
