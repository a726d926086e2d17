"""Build and load the port's CUDA kernels (nvcc -> one shared library).

Every ``csrc/*.cu`` compiles to an object in its own ``nvcc`` process,
all started together, and the objects link into one ``.so`` with a plain
C interface that ``ctypes`` loads.  The library is built at first use
into ``build/`` at the repository root, named by a hash of the sources
and flags, so an edited kernel is never served from a stale build.
Nothing here runs at import time: this module is imported on machines
without ``nvcc``.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``.  No
``--use_fast_math``: it flushes denormals, and the converter and the
E8M0 scale decode must keep them.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import operator
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# exported C entry points -> ctypes argument kinds
# p = pointer (c_void_p), i = int (c_int)
SIGNATURES: Dict[str, str] = {
    "mx_quant_launch": "ppp" + "ii" + "i" * 11 + "p",
    "mx_quant_vec_launch": "ppp" + "ii" + "i" * 11 + "p",
    "mx_kv_write_launch": "p" * 10 + "i" + "ppp" + "i" * 10 + "p",
    "mx_matmul_launch": "ppppppp" + "i" * 5 + "p",
    "mx_matmul_tc_launch": "ppppppp" + "i" * 5 + "p",
    "mx_paged_decode_attn_launch": "p" * 12 + "i" * 11 + "p",
    "mx_decode_attn_launch": "p" * 11 + "i" * 7 + "p",
    "mx_paged_decode_attn_tc_launch": "p" * 12 + "i" * 12 + "p",
    "mx_decode_attn_tc_launch": "p" * 11 + "i" * 8 + "p",
    "flash_attn_launch": "pppp" + "i" * 8 + "p",
    "flash_attn_tc_launch": "pppp" + "i" * 8 + "p",
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of this process's build
build_log: str = ""                       # nvcc output (ptxas register use)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library (no-op
    when a library of the same sources is already built).  Returns its
    path; raises with nvcc's output when a build fails."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libmx_kernels_{_digest()}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time
        if out.exists():
            return out
        t0 = time.perf_counter()
        nvcc = _nvcc()
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        so = tmp / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, out)
        shutil.rmtree(tmp, ignore_errors=True)
        build_seconds = time.perf_counter() - t0
        build_log = "\n".join(logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        for name, sig in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = [kinds[c] for c in sig]
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def position(name: str, pos, device: torch.device):
    """A position operand as the kernels take it: (host int, None) for a
    Python int, (None, tensor) for a one-element int32 tensor on
    ``device`` that the kernel reads itself (a position that a replayed
    CUDA graph advances on the device)."""
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1 \
                or pos.device != device:
            raise ValueError(f"{name}: a tensor pos must be one int32 on "
                             f"{device}, got {tuple(pos.shape)} {pos.dtype} "
                             f"on {pos.device}")
        return None, pos
    return operator.index(pos), None


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
