"""Plain version of the SSD kernel: the model's own chunked SSD, as the JAX
package's ``ssd_ref`` is.

Where the reference is defined it is the same call.  A sequence longer
than ``chunk`` and not a multiple of it (where the reference's reshape
fails, or it cuts other chunks) is padded with zero steps, which compute
the same function (dt = 0 decays nothing, x = 0 and B = 0 add nothing), so
it is cut into the chunks of ``chunk`` steps that the kernel cuts.
"""
import torch

from ...models.mamba2 import ssd_chunked


def _pad_steps(t, n):
    return torch.cat([t, t.new_zeros((t.shape[0], n) + t.shape[2:])], 1)


def ssd_ref(x, dt, A, Bc, Cc, *, h0=None, chunk=128):
    S = x.shape[1]
    pad = -S % chunk if S > chunk else 0
    if not pad:
        return ssd_chunked(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)
    x, dt, Bc, Cc = (_pad_steps(t, pad) for t in (x, dt, Bc, Cc))
    y, h = ssd_chunked(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)
    return y[:, :S].contiguous(), h
