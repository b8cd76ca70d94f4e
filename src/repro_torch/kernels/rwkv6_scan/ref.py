"""Plain version of the WKV kernel: the model's own chunked WKV, as the JAX
package's ``wkv6_ref`` is (``wkv6_chunked(chunk=32)``).

It takes an initial state ``s0`` (fp32 or bf16, computed in fp32) and any
S: chunks of ``chunk`` steps, the last one cut short, which the kernel cuts
too.  Where the reference is defined it computes the same function.
"""
from ...models.rwkv6 import wkv6_chunked


def wkv6_ref(r, k, v, w, u, *, s0=None, chunk=32):
    return wkv6_chunked(r, k, v, w, u, s0=s0, chunk=chunk)
