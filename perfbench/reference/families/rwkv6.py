"""RWKV-6 as the program's model states it (the departures from the
paper are listed in the configuration's file): time mix with token
shift, five static mixes, the WKV recurrence with the data-dependent
decay ``exp(-exp(w0 + lora))``, one RMS norm over all channels and a
SiLU gate; channel mix with a squared ReLU and a sigmoid gate; block
norms are RMS norms with the factor ``1 + scale``."""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.lib import work
from perfbench.reference.layout import Leaf
from perfbench.reference.models import (MM, layer_slice, mm8, mm32, quant,
                                        rmsnorm)

Tensor = torch.Tensor


def leaves(m: Dict[str, Any]) -> List[Leaf]:
    d, L, V, f = m["d_model"], m["n_layers"], m["vocab_size"], m["d_ff"]
    r = m["decay_lora"]
    a, ff = ("layers", "att"), ("layers", "ffn")
    w = 1 / math.sqrt(d)
    return [
        Leaf(("embed", "tok"), (V, d), 0.0, 1.0),
        Leaf(("embed", "head"), (d, V), 0.0, w),
        Leaf(a + ("mu",), (L, 5, d), 0.5, 0.2),
        Leaf(a + ("wr",), (L, d, d), 0.0, w),
        Leaf(a + ("wk",), (L, d, d), 0.0, w),
        Leaf(a + ("wv",), (L, d, d), 0.0, w),
        Leaf(a + ("wg",), (L, d, d), 0.0, w),
        Leaf(a + ("wo",), (L, d, d), 0.0, w),
        # decays exp(-exp(w0 + lora)) mostly within (0.6, 0.99)
        Leaf(a + ("w0",), (L, d), -2.0, 0.5),
        Leaf(a + ("w_lora_a",), (L, d, r), 0.0, w),
        Leaf(a + ("w_lora_b",), (L, r, d), 0.0, 0.5 / math.sqrt(r)),
        Leaf(a + ("u",), (L, d), 0.0, 0.5),
        Leaf(a + ("ln_x",), (L, d), 0.0, 0.1),
        Leaf(ff + ("mu",), (L, 2, d), 0.5, 0.2),
        Leaf(ff + ("wk",), (L, d, f), 0.0, w),
        Leaf(ff + ("wv",), (L, f, d), 0.0, 1 / math.sqrt(f)),
        Leaf(ff + ("wr",), (L, d, d), 0.0, w),
        Leaf(("layers", "ln1", "scale"), (L, d), 0.0, 0.1),
        Leaf(("layers", "ln1", "bias"), (L, d), 0.0, 0.1),
        Leaf(("layers", "ln2", "scale"), (L, d), 0.0, 0.1),
        Leaf(("layers", "ln2", "bias"), (L, d), 0.0, 0.1),
        Leaf(("ln_f", "scale"), (d,), 0.0, 0.1),
        Leaf(("ln_f", "bias"), (d,), 0.0, 0.1),
    ]


def wkv(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
        chunk: int = 32, block: int = 16) -> Tensor:
    """The WKV recurrence y_t = r_t S_{t-1} + (r_t u k_t) v_t,
    S_t = diag(w_t) S_{t-1} + k_t v_t^T from S_0 = 0, per head: r, k, v,
    w [B, S, H, hd] fp32 (w the per-step decay in (0, 1)), u [H, hd].
    Worked in chunks: the pairs inside a chunk directly, each chunk's
    start state carried from the one before; ``block`` chunks at once.
    The log decay is held at -60 or above a step, as the program's model
    states it (a decay below e^-60 is zero in fp32 either way)."""
    B, S, H, D = r.shape
    Q = chunk
    n = -(-S // Q)
    pad = n * Q - S
    if pad:
        z = r.new_zeros(B, pad, H, D)
        r, k, v = (torch.cat([t, z], 1) for t in (r, k, v))
        w = torch.cat([w, torch.ones_like(z)], 1)
    lw = torch.log(w.clamp_min(1e-30)).clamp_min(-60.0)
    shape = (B, n, Q, H, D)
    r, k, v, lw = (t.reshape(shape) for t in (r, k, v, lw))
    cum = lw.cumsum(2)
    prev = cum - lw
    tri = torch.ones(Q, Q, dtype=torch.bool, device=r.device).tril(-1)
    s = r.new_zeros(B, H, D, D)
    ys = []
    for c0 in range(0, n, block):
        c1 = min(n, c0 + block)
        rc, kc, vc = r[:, c0:c1], k[:, c0:c1], v[:, c0:c1]
        cc, pc = cum[:, c0:c1], prev[:, c0:c1]
        seg = pc[:, :, :, None] - cc[:, :, None]           # [B,c,t,s,H,D]
        seg = seg.masked_fill(~tri[None, None, :, :, None, None], -math.inf)
        att = (rc[:, :, :, None] * kc[:, :, None] * seg.exp()).sum(-1)
        del seg
        y = torch.einsum("bctsh,bcshd->bcthd", att, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        k_end = kc * (cc[:, :, -1:] - cc).exp()
        add = torch.einsum("bcshi,bcshj->bchij", k_end, vc)
        decay = cc[:, :, -1].exp()                          # [B,c,H,D]
        rn = rc * pc.exp()
        for j in range(c1 - c0):
            y[:, j] += torch.einsum("bthi,bhij->bthj", rn[:, j], s)
            s = s * decay[:, j, :, :, None] + add[:, j]
        ys.append(y)
    y = torch.cat(ys, 1).reshape(B, n * Q, H, D)
    return y[:, :S]


def _shift(x: Tensor) -> Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def layer(lp: Dict[str, Any], x: Tensor, m: Dict[str, Any], mm: MM
          ) -> Tensor:
    """Time mix, then channel mix, each on a residual."""
    B, S, d = x.shape
    eps, hd, a, f = m["norm_eps"], m["rwkv_head_dim"], lp["att"], lp["ffn"]
    H = d // hd
    h = rmsnorm(x, lp["ln1"]["scale"], eps)
    hs = _shift(h)
    mix = [h + (hs - h) * a["mu"][j] for j in range(5)]
    r = mm(mix[0], a["wr"]).reshape(B, S, H, hd)
    k = mm(mix[1], a["wk"]).reshape(B, S, H, hd)
    v = mm(mix[2], a["wv"]).reshape(B, S, H, hd)
    g = F.silu(mm(mix[4], a["wg"]))
    wlog = a["w0"] + mm(mm(mix[3], a["w_lora_a"]), a["w_lora_b"])
    w = torch.exp(-torch.exp(wlog)).reshape(B, S, H, hd)
    if mm is mm8:                       # the scan's operands in float8 too
        r, k, v = quant(r), quant(k), quant(v)
    y = wkv(r, k, v, w, a["u"].reshape(H, hd)).reshape(B, S, d)
    y = rmsnorm(y, a["ln_x"], eps) * g
    x = x + mm(y, a["wo"])
    h2 = rmsnorm(x, lp["ln2"]["scale"], eps)
    hs = _shift(h2)
    xk = h2 + (hs - h2) * f["mu"][0]
    xr = h2 + (hs - h2) * f["mu"][1]
    kk = torch.relu(mm(xk, f["wk"])).square()
    return x + mm(kk, f["wv"]) * torch.sigmoid(mm(xr, f["wr"]))


def forward(p: Dict[str, Any], tokens: Tensor, m: Dict[str, Any], *,
            mm: MM = mm32, remat: bool = False) -> Tensor:
    """fp32 logits [B, S, V] from a zero state; ``remat`` recomputes each
    layer in the backward."""
    x = p["embed"]["tok"][tokens.long()]
    for i in range(m["n_layers"]):
        lp = layer_slice(p["layers"], i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, lp, x, m, mm, use_reentrant=False)
        else:
            x = layer(lp, x, m, mm)
    x = rmsnorm(x, p["ln_f"]["scale"], m["norm_eps"])
    return mm(x, p["embed"]["head"])


def forward_flops(m: Dict[str, Any], B: int, S: int) -> float:
    """The projections (five mixes, the decay's low-rank term, the
    output, the channel mix), the WKV recurrence and the LM head over
    every position."""
    d, f, r = m["d_model"], m["d_ff"], m["decay_lora"]
    proj = 2 * (5 * d * d + 2 * d * r + 2 * d * f + d * d)
    return m["n_layers"] * (B * S * proj + work.wkv_work(m, B, S)[1]) \
        + 2 * d * m["vocab_size"] * B * S
