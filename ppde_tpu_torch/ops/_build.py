"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own
shared library, ``_build_out/lib<name>-<hash>.so`` inside the package (a
git-ignored directory); the hash of the source names the file, so an edited
source is rebuilt and an unchanged one is reused. ``build_all`` starts one
nvcc per source at once and waits for all of them; ``library`` builds on
first use; ``set_defines`` switches a source to a build with extra ``-D``
defines (a profiling build). Nothing here runs at import time: the CPU tests import the
package on hosts with no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
OUT = os.path.join(PKG, "_build_out")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_defines: dict[str, tuple[str, ...]] = {}  # extra -D defines per source
# ptxas register / shared-memory report of the last build of each source
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in _defines.get(name, ())]


def set_defines(name: str, defines: tuple[str, ...]) -> None:
    """From now on ``library(name)`` is ``csrc/<name>.cu`` compiled with
    these extra ``-D`` defines: a library of its own beside the regular
    one, built at its first use."""
    with _lock:
        _defines[name] = tuple(defines)
        _libs.pop(name, None)


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(OUT, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every source that has no up-to-date library, all nvcc
    processes at once; returns the wall seconds spent."""
    t0 = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name in sources():
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(name), "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of an nvcc log: the kernel (``kernel_name``),
    its registers and spills, and ptxas' performance remarks (C75xx, but
    not the routine one on wgmma's registers)."""
    out, kernel, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used " in line:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "(C75" in line and "(C7519)" not in line:
            out.append(line.strip()[:200])
    return out


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel name: its nested names (the
    anonymous namespace left out) and its template arguments, e.g.
    ``_ZN12_GLOBAL__N_12rs11attn_fwd_rsILi32EEEvPK...`` -> ``rs::attn_fwd_rs
    <32>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    names = []
    while (m := re.match(r"(\d+)", mangled[i:])) is not None:
        n, i = int(m.group(1)), i + len(m.group(1))
        names.append(mangled[i:i + n])
        i += n
    names = [n for n in names if not n.startswith("_GLOBAL__N_")] or [mangled]
    args = ""
    if mangled[i:i + 1] == "I":
        toks = re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)",
                          mangled[i + 1:mangled.find("EE", i) + 1])
        args = "<" + ",".join(n or ("bf16" if b else "float")
                              for n, b, _ in toks) + ">"
    return "::".join(names) + args


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            target = _target(name)
            if not os.path.exists(target):
                build_all()
            _libs[name] = ctypes.CDLL(target)
        return _libs[name]
