"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), placed in ``kernels/_build/`` (git-ignored) under a name keyed
by a hash of the source and the flags: an edited source rebuilds, an
unchanged one loads the library already there. ``build()`` starts one
``nvcc`` per missing library, all at once. The compiler's output, with
ptxas's registers, shared memory and spills of every kernel (``-Xptxas
-v``), is kept beside each library (``ptxas_report``). ``summary()`` says which
libraries this process compiled and which it loaded: a serving replica
whose libraries were built before it started compiles none.

There is no fallback: when ``nvcc`` is missing or a build fails this
module raises. The CPU path never comes here — kernel wrappers run their
plain PyTorch versions on CPU tensors without loading anything.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load", "ptxas_report",
           "summary"]

SOURCES = ("mega_decode", "cache_write", "flash_attention",
           "flash_attention_sm90", "flash_attention_sm90_f32", "fused_ce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_lock = threading.Lock()
_loaded: dict = {}
_compiled: list = []          # (name, seconds) of every nvcc run here


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` not built yet, one ``nvcc`` per
    source, all started together. Returns {name: seconds} for the ones
    it compiled. Raises RuntimeError with the compiler's output when a
    build fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}.cu (rc {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_bytes(log)
            os.replace(tmp, out)       # atomic: readers never see half a file
            _compiled.append((name, seconds[name]))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return seconds


def summary() -> dict:
    """This process's builds: the ``nvcc`` runs (successful ones, by
    library, with their seconds) and the libraries loaded so far. Takes no
    lock (``load`` holds it through a build of minutes, and a server's
    /healthz must not wait on that): each copy below is one C-level call
    under the interpreter lock."""
    runs = list(_compiled)
    loaded = sorted(list(_loaded))
    return {"nvcc_runs": len(runs), "built": [n for n, _ in runs],
            "compile_wall_s": round(sum(t for _, t in runs), 3),
            "loaded": loaded}


def ptxas_report(name: str) -> list:
    """ptxas's report for each kernel of ``csrc/<name>.cu`` from its last
    build: [(mangled kernel name, its "N registers, ..." text, its stack
    and spill line)]. Dynamic shared memory is not in it: the source says
    what each kernel asks for."""
    log = _lib_path(name).with_suffix(".log")
    rows, kernel, spills = [], None, ""
    for line in log.read_text(errors="replace").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "bytes spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            rows.append((kernel, line.split("Used")[1].strip(), spills))
            kernel = None
    return rows


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built first if needed),
    with ``signatures`` {function: (restype, [argtypes])} applied once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib
