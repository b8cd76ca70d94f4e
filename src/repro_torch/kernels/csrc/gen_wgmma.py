"""Writes ``wgmma_ops.cuh``: the ``wgmma.mma_async`` wrappers of the
tensor-core kernels, one per shape, each listing its accumulator
registers one by one as PTX requires (128 of them at N = 256).

    python src/repro_torch/kernels/csrc/gen_wgmma.py

``tests/test_torch_kernels.py`` checks that the header is what this
script writes.
"""
from __future__ import annotations

from pathlib import Path

#: B from shared memory (SS): gmm's 256-column tiles, flash's Q K^T over
#: 64 or 128 keys; A from registers (RS): flash's P V over the 64-column
#: (64, 128, 256) and 16-column (16, 32) blocks of each head dim
SS_N = (32, 64, 128, 256)
RS_N = (16, 32, 64, 128, 256)
OUT = Path(__file__).resolve().parent / "wgmma_ops.cuh"

HEAD = """\
// Generated by gen_wgmma.py in this directory: do not edit by hand.
//
// wgmma.mma_async m64nNk16, fp32 accumulators, bf16 operands.  d holds
// the N/2 fp32 accumulators of this thread; B is read from shared memory
// through its descriptor; A from shared memory (ss) or from four
// registers of packed bf16 pairs (rs).  scale_d = 0 overwrites d with
// A B, 1 adds A B to it.  TB (the transpose bit of B) is 0 for a K-major
// B and 1 for an MN-major one.
#pragma once
#include <stdint.h>

namespace tc {
"""


def _regs(n: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n))


def _outs(n: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(n: int) -> str:
    k = n // 2
    return f"""
template <int TB>
__device__ __forceinline__ void wgmma_ss_n{n}(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(k)}}}, %{k}, %{k + 1}, p, 1, 1, 0, %{k + 3};\\n}}\\n"
      : {_outs(k)}
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}}
"""


def rs(n: int) -> str:
    k = n // 2
    return f"""
template <int TB>
__device__ __forceinline__ void wgmma_rs_n{n}(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{k + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(k)}}}, {{{_regs(4, k)}}}, %{k + 4}, p, 1, 1, %{k + 6};\\n}}\\n"
      : {_outs(k)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}}
"""


def dispatch(kind: str, ns) -> str:
    args = ("float* d, uint64_t da, uint64_t db, int scale_d" if kind == "ss"
            else "float* d, const uint32_t* a, uint64_t db, int scale_d")
    call = "d, da, db, scale_d" if kind == "ss" else "d, a, db, scale_d"
    body = "\n".join(
        f"  {'if' if i == 0 else 'else if'} constexpr (N == {n}) "
        f"wgmma_{kind}_n{n}<TB>({call});" for i, n in enumerate(ns))
    return f"""
template <int N, int TB>
__device__ __forceinline__ void wgmma_{kind}({args}) {{
{body}
  else {{ static_assert(N < 0, "no wgmma_{kind} of this N"); }}
}}
"""


def render() -> str:
    parts = [HEAD]
    parts += [ss(n) for n in SS_N]
    parts += [rs(n) for n in RS_N]
    parts += [dispatch("ss", SS_N), dispatch("rs", RS_N)]
    parts.append("\n}  // namespace tc\n")
    return "".join(parts)


if __name__ == "__main__":
    OUT.write_text(render())
