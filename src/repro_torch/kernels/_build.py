"""Build and load the port's CUDA kernels.

The kernels in ``csrc/`` have a plain C interface, so they are compiled by
``nvcc`` and loaded with ``ctypes`` (no PyTorch headers to compile: the
build takes seconds, not minutes).  Every source is compiled to an object
by its own ``nvcc``, all started together, and the objects are linked into
one shared library under ``build/kernels/`` at the repository root, named
by a hash of every file in ``csrc/`` (the sources, the headers they share
and the flags).  It is built at first use: the first kernel launch of a
process builds it when it is missing.  The tensor-core kernels reach the
driver's ``cuTensorMapEncodeTiled`` through the runtime's
``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``.  Needs ``nvcc``
(``CUDA_HOME`` or ``/usr/local/cuda``) and a card of compute capability
9.0 (``sm_90a``: ``wgmma`` and ``setmaxnreg`` exist only there).
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
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("metadata_kernels.cu", "model_kernels.cu", "flash_tc.cu",
           "gmm_tc.cu", "ssd_scan.cu", "wkv_scan.cu", "span_marks.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS

#: C parameter types the launchers use, and their ctypes: pointers and the
#: stream as void*, sizes as long long (a bare Python int would be cut to
#: 32 bits), scales as float (ctypes would pass a bare Python float as a
#: double)
_CTYPES = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "unsigned": ctypes.c_uint,
           "float": ctypes.c_float}


def signatures() -> Dict[str, List[type]]:
    """The ctypes argument list of every launcher, read from the
    ``extern "C"`` prototypes of the sources, so the two cannot drift."""
    out: Dict[str, List[type]] = {}
    for s in SOURCES:
        text = (CSRC / s).read_text()
        if 'extern "C" {' not in text:
            continue
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


def _digest(csrc: Path = CSRC) -> str:
    """Hash of the flags and of every file under ``csrc`` (names and
    contents; Python's bytecode caches aside): a change to a shared header
    rebuilds the library too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()
                    and "__pycache__" not in p.parts):
        h.update(f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source has none."""
    global _lib
    lib = _lib
    if lib is not None:           # loaded: no lock on the launch path
        return lib
    with _mu:
        if _lib is not None:
            return _lib
        out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{_digest()}.{os.getpid()}"
            objs = [BUILD_DIR / f"{Path(s).stem}_{tag}.o" for s in SOURCES]
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(SOURCES, objs)]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            failed = [s for s, p in zip(SOURCES, procs) if p.returncode]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), "-shared", *ARCH_FLAGS, "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            for o in objs:
                o.unlink(missing_ok=True)
            if proc.returncode != 0:
                raise RuntimeError(f"link failed ({proc.returncode}):\n{log}")
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


#: blocks a segment-parallel scan (``ssd_scan.cu``, ``wkv_scan.cu``) aims
#: at for each SM: a few resident at once and several waves, so that the
#: last wave's tail is short
SEGMENT_BLOCKS_PER_SM = 8


def segments(n_chunks: int, n_rows: int, device) -> Tuple[int, int]:
    """(chunks a segment G, segments) of a segment-parallel scan of
    ``n_chunks`` chunks for ``n_rows`` (batch row, head) pairs: the largest
    G that still gives about :data:`SEGMENT_BLOCKS_PER_SM` blocks or more
    for each SM of the card, since every segment boundary adds a state's
    bytes to move."""
    import torch
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = max(1, n_chunks * n_rows // (SEGMENT_BLOCKS_PER_SM * sms))
    return g, max(1, -(-n_chunks // g))


def c_int(name: str) -> int:
    """The value of an ``int`` the library exports (``gmm_last_route``,
    ``ssd_last_route``, ``wkv6_last_route``)."""
    return ctypes.c_int.in_dll(library(), name).value


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


def require_cuda_float(**tensors: object) -> None:
    """The float kernels take contiguous bf16 or fp32 tensors on the card."""
    import torch
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: expected bfloat16 or float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name: str, *args: object) -> None:
    """Call one launcher on the current stream; raise on a refused launch.
    The stream's handle comes from PyTorch's raw accessor, as PyTorch's own
    compiled kernels take it: ``torch.cuda.current_stream()`` would build
    a Stream object on every launch, several µs a call."""
    import torch
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
