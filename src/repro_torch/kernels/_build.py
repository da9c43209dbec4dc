"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``build/repro_torch_kernels/lib<name>-<hash>.so``
at the repository root), loaded with ``ctypes``.  The hash covers the
source and the shared header, so an edited kernel is rebuilt.  Nothing is
compiled at import: :func:`load` builds on first use, :func:`build_all`
starts one ``nvcc`` per source at once.  Both hold a module lock, so two
threads (a threaded ``ManuSystem``'s pump thread and the caller's) never
build or load one library at once.  :func:`count_launch` is how every
wrapper counts its launches, from any thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("l2_topk", "merge_topk", "kmeans_assign", "sq_codec", "pq_adc")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
_launch_lock = threading.Lock()
_this_thread = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path] | None":
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named kernel source concurrently; returns nvcc's log
    (register and shared-memory use) per source that was built."""
    with _lock:
        return _build_all(names)


def _build_all(names) -> dict[str, str]:
    jobs = {n: _start(n) for n in names}
    logs: dict[str, str] = {}
    errors: list[str] = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            logs[n] = _finish(n, job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built if missing."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all((name,))
                lib = ctypes.CDLL(str(_lib_path(name)))
                _loaded[name] = lib
    return lib


def count_launch(wrapper, path: str | None = None) -> None:
    """Add one launch to ``wrapper.launches`` (and to
    ``wrapper.path_launches[path]``), under a lock: a threaded
    ``ManuSystem`` launches from its pump and build threads beside the
    caller's.  The launching thread's own count (:func:`thread_launches`)
    moves with it."""
    with _launch_lock:
        wrapper.launches += 1
        if path is not None:
            wrapper.path_launches[path] += 1
    counts = getattr(_this_thread, "counts", None)
    if counts is None:
        counts = _this_thread.counts = {}
    counts[wrapper] = counts.get(wrapper, 0) + 1


def thread_launches(wrapper) -> int:
    """The launches of ``wrapper`` the calling thread has made."""
    return getattr(_this_thread, "counts", {}).get(wrapper, 0)
