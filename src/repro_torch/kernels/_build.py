"""Builds the hand-written CUDA kernels in ``repro_torch/csrc`` on first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/repro_torch_kernels/lib<name>.so`` (under the repository
root), compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v

and loaded with :mod:`ctypes`. The first call starts one ``nvcc`` per source,
all at once, and waits for them; a library newer than its source is reused.
ptxas's register, shared-memory and spill counts for each kernel are kept
beside the library (``lib<name>.ptxas.txt``; :func:`ptxas_report` reads
them). Nothing is built when this module is imported. A missing ``nvcc`` or
a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.ptxas.txt"


def build_all() -> List[str]:
    """Compile every stale ``csrc/*.cu`` in parallel; returns the names of the
    sources compiled. Raises ``RuntimeError`` with nvcc's output if one fails."""
    sources = sorted(CSRC.glob("*.cu"))
    stale = [
        s for s in sources
        if not _lib_path(s.stem).exists()
        or _lib_path(s.stem).stat().st_mtime < s.stat().st_mtime
    ]
    if not stale:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in stale:
        tmp = BUILD_DIR / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            _log_path(src.stem).write_text(out)
            os.replace(tmp, _lib_path(src.stem))
    if errors:
        raise RuntimeError("repro_torch: kernel build failed\n" + "\n".join(errors))
    return [s.name for s in stale]


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building every kernel first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not (CSRC / f"{name}.cu").exists():
                raise RuntimeError(f"repro_torch: no kernel source csrc/{name}.cu")
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> List[Dict[str, object]]:
    """Each kernel entry of ``lib<name>.so`` as ptxas reported it at build
    time: ``{"entry", "registers", "smem_bytes", "spill_stores",
    "spill_loads"}`` (static shared memory only; the dynamic part is set at
    launch)."""
    entries: List[Dict[str, object]] = []
    for line in _log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append({"entry": _demangle(m.group(1)), "registers": None, "smem_bytes": 0,
                            "spill_stores": None, "spill_loads": None})
            continue
        if not entries:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entries[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entries[-1]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return entries


def _demangle(symbol: str) -> str:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return symbol
    out = subprocess.run([tool, symbol], capture_output=True, text=True)
    return short_name(out.stdout.strip() if out.returncode == 0 else symbol)


def short_name(signature: str) -> str:
    """``void (anonymous namespace)::k<T, 4>(int, ...)`` -> ``k<T, 4>``: a
    demangled kernel signature without namespace, return type and parameters."""
    name = signature
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(anon, "")
    depth = 0  # cut the parameter list: the first "(" outside template brackets
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.removeprefix("void ")
