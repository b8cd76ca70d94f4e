"""What the work needs, counted from the configuration and the shapes:
the model FLOPs of a forward, and each kernel's least time on the chip
(its roofline bound).

A bound is the larger of the operations over the peak rate and the
bytes over the memory bandwidth, each input read once and each output
written once, whatever the kernel reads again; work that depends on the
data is counted as these inputs need it (causal attention: only the
visible pairs).  The kernel formulas follow the counts the repository's
kernel checks used (``work_flash``, ``work_wkv``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from perfbench.reference import families

#: published peaks of one NVIDIA H100 SXM (dense, no sparsity)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(n_bytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(least seconds, what bounds it)."""
    tb, tf = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def hd(m: Dict[str, Any]) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def causal_pairs(S: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal row set sees: row t sees t + 1 keys,
    a window caps that."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_work(m: Dict[str, Any], B: int, S: int) -> Tuple[float, float]:
    """(bytes, operations) of one causal attention launch: q, k, v read
    once, the output written once; 4 hd operations (q.k and p.v) a
    visible pair and query head."""
    e = DTYPE_BYTES[m["dtype"]]
    h, H, KV = hd(m), m["n_heads"], m["n_kv_heads"]
    n_bytes = e * B * S * h * (2 * H + 2 * KV)
    return n_bytes, 4 * h * B * H * causal_pairs(S, m.get("sliding_window"))


def wkv_work(m: Dict[str, Any], B: int, S: int, chunk: int = 32
             ) -> Tuple[float, float]:
    """(bytes, operations) of one WKV launch from a zero state: r, k, v
    and y in the compute type, the fp32 decay, u and the final state.
    Operations per chunk of L steps and (row, head): the clamped log
    decay and its sums, each kept pair's exponent, product and sum over
    the channels, the bonus, att @ v on and below the diagonal, the
    decayed r and k, r @ S, and the state update with its decay."""
    D = m["rwkv_head_dim"]
    H = m["d_model"] // D
    flops = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        pairs = L * (L - 1) // 2
        flops += B * H * (5 * L * D + 5 * D * pairs + 3 * L * D
                          + 2 * D * (pairs + L) + 5 * L * D
                          + 4 * L * D * D + 3 * D * D)
    e = DTYPE_BYTES[m["dtype"]]
    n = B * S * H * D
    return 4 * n * e + 4 * (n + H * D) + 4 * B * H * D * D, flops


def forward_flops(m: Dict[str, Any], B: int, S: int) -> float:
    """Model FLOPs of one forward of B sequences of S tokens from an
    empty state, as the model's family counts them
    (``perfbench/reference/families/``)."""
    return families.load(m).forward_flops(m, B, S)


def train_flops(m: Dict[str, Any], B: int, S: int) -> float:
    """Model FLOPs of one training step: the forward and a backward of
    twice its work (recomputation in the backward is not counted)."""
    return 3 * forward_flops(m, B, S)
