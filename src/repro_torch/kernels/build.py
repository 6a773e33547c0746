"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds.  The shared library goes to
``<repo>/build/repro_torch/<name>-<hash>.so``; the hash covers the source,
the headers beside it (``csrc/*.cuh``, which the sources include by
relative path) and the flags, so an edited source or header is rebuilt and
an unchanged one is reused;
nvcc's log (``-Xptxas -v``: registers, spills) is kept beside it as
``<name>-<hash>.log``.
Nothing is built when this module is imported: the first launch of a kernel
builds it, and ``build_all`` builds every kernel at once, one ``nvcc`` per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("gram", "gram_q8", "smo", "flash_attention")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()      # farm workers may reach a first launch at once
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel was launched), also when
    several host threads launch at once (the task farm's workers)."""
    with _count_lock:
        wrapper.launches += 1


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): $CUDA_HOME/bin first,
    then PATH."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / name
    if cand.is_file():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of repro_torch are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


Started = Tuple[str, Path, Path, Optional[subprocess.Popen]]


def _start(name: str) -> Started:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return name, out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, out, tmp, proc


def _finish(started: Started) -> str:
    name, out, tmp, proc = started
    log_path = out.with_suffix(".log")
    if proc is None:
        log = log_path.read_text() if log_path.exists() else ""
        return f"{name}: cached {out.name}\n{log.strip()}"
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return f"{name}: built {out.name}\n{log.strip()}"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel in parallel; returns each one's nvcc log
    (the kept one for a library already built)."""
    started = [_start(name) for name in names]
    try:
        return {s[0]: _finish(s) for s in started}
    finally:
        for *_, proc in started:     # stop every nvcc, also after a failure
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib
