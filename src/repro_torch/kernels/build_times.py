"""Time the two ways of building the port's CUDA kernels on one machine.

    PYTHONPATH=src python -m repro_torch.kernels.build_times

(a) what the port does (``_build``): ``nvcc`` compiles ``csrc/`` into a
shared library with a plain C interface, loaded with ``ctypes``;
(b) ``torch.utils.cpp_extension.load``: the same sources plus a pybind
binding file that includes ``torch/extension.h`` and checks its tensors
with ``TORCH_CHECK``, compiled and linked against PyTorch.

Both start from empty build directories under ``build/build_times/``.
Each built module launches ``phash`` once and is compared with its plain
version.  Prints one JSON line with the seconds of each build.  Needs
``nvcc`` and a card; (b) also needs ``ninja``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time

import torch

from . import _build

BINDING = r"""
#include <torch/extension.h>
#include <ATen/cuda/CUDAContext.h>

extern "C" int phash_launch(const void* keys, void* out, long long n,
                            unsigned n_partitions, void* stream);

torch::Tensor phash(torch::Tensor keys, int64_t n_partitions) {
  TORCH_CHECK(keys.is_cuda(), "phash: keys must be on the card");
  TORCH_CHECK(keys.scalar_type() == torch::kInt32, "phash: keys must be int32");
  TORCH_CHECK(keys.is_contiguous(), "phash: keys must be contiguous");
  auto out = torch::empty_like(keys);
  int err = phash_launch(keys.data_ptr(), out.data_ptr(), keys.numel(),
                         (unsigned)n_partitions,
                         at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "phash: CUDA error ", err, " at launch");
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("phash", &phash); }
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("build_times: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.utils.cpp_extension import load
    from .phash.ref import phash_ref
    root = _build.BUILD_DIR.parent / "build_times"
    shutil.rmtree(root, ignore_errors=True)
    keys = torch.arange(1 << 16, dtype=torch.int32, device="cuda")
    want = phash_ref(keys, 64)

    _build.BUILD_DIR = root / "ctypes"
    t0 = time.perf_counter()
    _build.library()
    ctypes_s = time.perf_counter() - t0
    from .phash.kernel import phash
    ok_ctypes = torch.equal(phash(keys, 64), want)

    ext_dir = root / "cpp_extension"
    ext_dir.mkdir(parents=True)
    binding = ext_dir / "binding.cpp"
    binding.write_text(BINDING)
    t0 = time.perf_counter()
    ext = load(name="metadata_kernels_ext",
               sources=[str(binding)] + [str(_build.CSRC / s)
                                         for s in _build.SOURCES],
               extra_cuda_cflags=["-O3", *_build.ARCH_FLAGS],
               build_directory=str(ext_dir), verbose=False)
    load_s = time.perf_counter() - t0
    ok_ext = torch.equal(ext.phash(keys, 64), want)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ctypes_nvcc_s": ctypes_s, "ctypes_ok": ok_ctypes,
                      "cpp_extension_load_s": load_s,
                      "cpp_extension_ok": ok_ext}), flush=True)
    return 0 if ok_ctypes and ok_ext else 1


if __name__ == "__main__":
    sys.exit(main())
