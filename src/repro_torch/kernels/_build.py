"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. The compiler's output,
with ptxas's registers and spills for every kernel, is kept beside the
library as ``<name>-<hash>.log`` (`ptxas_report` reads it). ``build/``
sits at the root of the checkout and is listed in ``.gitignore``. `build_all` starts
one ``nvcc`` per source at once and waits for all of them. Nothing here
runs at import: the CPU tests import every module, and this host has no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, pathlib.Path]:
    """Kernel name -> ``.cu`` source, for every source in ``csrc/``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (``/usr/local/cuda`` by default), else
    ``nvcc`` on the PATH."""
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = shutil.which("nvcc", path=str(home / "bin")) or shutil.which("nvcc")
    if found is not None:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only on a host with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=None) -> dict[str, float]:
    """Compile every (or the named) missing library, all ``nvcc`` at once.

    Returns the seconds each build took (0.0 for one already built).
    Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(sources()) if names is None else list(names)
    t0 = time.perf_counter()
    seconds = {n: 0.0 for n in names}
    running = {n: _start(n) for n in names if not library_path(n).exists()}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def ptxas_report(name: str, kernel: str) -> list[str]:
    """ptxas's lines for the kernels of library ``name`` whose (mangled)
    names contain ``kernel``: the entry, its stack and spills, its
    registers, and any other line that names it (the C75xx advisories
    that ``wgmma`` was serialised). Empty if the library was built
    without its log."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    lines, keep = [], False
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep or kernel in line:
            lines.append(line.strip())
            if keep and "Used" in line and "registers" in line:
                keep = False
    return lines


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
