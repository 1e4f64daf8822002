"""Build and load the hand-written CUDA kernels of ``expecto_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
at the repository root, then loaded with ctypes. The hash covers the source
and the flags, so an edited source never loads a stale library. Nothing is
built or loaded at import time: the first launch of a kernel builds it, and
:func:`build` compiles several sources at once (one ``nvcc`` each, all
started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every ``csrc`` header it includes with ``#include "x.cuh"``,
    directly or through another header, each once, in include order."""
    if path not in seen:
        seen.append(path)
        for header in re.findall(r'^\s*#\s*include\s+"([^"]+\.cuh)"', path.read_text(), flags=re.M):
            _sources(CSRC_DIR / header, seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC_DIR / f"{name}.cu", []):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build(names=None, *, ptxas_info: bool = False) -> dict[str, tuple[float, str]]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process each, all running at once. Returns
    {name: (seconds, compiler output)} for the kernels built by this call;
    ``ptxas_info`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _tool("nvcc")
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
                   "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out, time.perf_counter())
        built = {}
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            built[name] = (time.perf_counter() - t0, log)
        return built
    finally:
        for proc, tmp, _out, _t0 in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def ptxas_report(name: str) -> str:
    """``-Xptxas -v``'s report (registers, shared memory and spills of each
    function) of ``csrc/<name>.cu``, compiled anew to a scratch file beside
    the built libraries; the built library is left as it is."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"ptxas-{name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([_tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                              capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    finally:
        tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of ``opcode`` (e.g. ``HGMMA``) the built
    library of ``csrc/<name>.cu`` holds, from ``cuobjdump -sass``."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(library_path(name))], capture_output=True, text=True,
                         timeout=NVCC_TIMEOUT_S, check=True).stdout
    return len(re.findall(rf"\b{opcode}\b", out))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def launcher(name: str, n_ints: int, n_floats: int = 0, n_ptrs: int = 4, entry: str | None = None):
    """``entry`` (default ``<name>_launch``) of ``csrc/<name>.cu``, whose C
    signature is ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats
    and the stream, returning the CUDA error."""
    fn = getattr(load(name), entry or f"{name}_launch")
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float] * n_floats + [vp]
        fn.restype = ctypes.c_int
    return fn
