"""Build and load the port's CUDA kernels.

The kernels in ``csrc/`` have a plain C interface, so they are compiled by
``nvcc`` straight into a shared library and loaded with ``ctypes`` (no
PyTorch headers to compile: the build takes seconds, not minutes).  The
library goes under ``build/kernels/`` at the repository root, named by a
hash of the sources, and is built at first use: the first kernel launch of
a process builds it when it is missing.  Needs ``nvcc`` (``CUDA_HOME`` or
``/usr/local/cuda``) and a card of compute capability 9.0 (``sm_90a``).
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
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("metadata_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS

#: C parameter types the launchers use, and their ctypes: pointers and the
#: stream as void*, sizes as long long (a bare Python int would be cut to
#: 32 bits)
_CTYPES = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "unsigned": ctypes.c_uint}


def signatures() -> Dict[str, List[type]]:
    """The ctypes argument list of every launcher, read from the
    ``extern "C"`` prototypes of the sources, so the two cannot drift."""
    out: Dict[str, List[type]] = {}
    for s in SOURCES:
        text = (CSRC / s).read_text()
        block = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"\bint\s+(\w+_launch)\s*\(([^)]*)\)",
                                       block):
            args = []
            for p in params.split(","):
                ctype = re.sub(r"\bconst\b|\s*\w+\s*$", "", p.strip())
                ctype = re.sub(r"\s+", " ", ctype).replace(" *", "*").strip()
                if ctype not in _CTYPES:
                    raise ValueError(f"{s}: {name}: no ctypes for {p!r}")
                args.append(_CTYPES[ctype])
            out[name] = args
    return out


_lib: Optional[ctypes.CDLL] = None
_mu = threading.Lock()
#: what the last build did: seconds, library path, nvcc's report
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit "
                       "(set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source has none."""
    global _lib
    with _mu:
        if _lib is not None:
            return _lib
        out = BUILD_DIR / f"libmetadata_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(CSRC / s) for s in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in signatures().items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, path=str(out),
                          log=log)
        _lib = lib
        return lib


def require_cuda_int32(**tensors: object) -> None:
    """The kernels take contiguous int32 tensors on the card, nothing else."""
    import torch
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name: str, *args: object) -> None:
    """Call one launcher on the current stream; raise on a refused launch."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
