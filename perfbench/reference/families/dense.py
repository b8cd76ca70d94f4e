"""Pre-norm decoder (Qwen1.5 and its kind): GQA attention with RoPE and,
where the model has them, q, k and v biases; a SwiGLU MLP; RMS norms
with the factor ``1 + scale``; an untied LM head."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.lib import work
from perfbench.reference.layout import Leaf
from perfbench.reference.models import (MM, causal_attention, layer_slice,
                                        mm32, rmsnorm, rope)

Tensor = torch.Tensor


def _hd(m: Dict[str, Any]) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def leaves(m: Dict[str, Any]) -> List[Leaf]:
    if m.get("mlp_type", "swiglu") != "swiglu":
        raise ValueError("the dense reference is written for SwiGLU MLPs; "
                         "another MLP is another family's file")
    d, L, V, f = m["d_model"], m["n_layers"], m["vocab_size"], m["d_ff"]
    nh, kv, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    out = [Leaf(("embed", "tok"), (V, d), 0.0, 1.0),
           Leaf(("embed", "head"), (d, V), 0.0, 1 / math.sqrt(d))]
    lay = ("layers",)
    out += [Leaf(lay + ("ln1", "scale"), (L, d), 0.0, 0.1),
            Leaf(lay + ("ln2", "scale"), (L, d), 0.0, 0.1),
            Leaf(lay + ("attn", "wq"), (L, d, nh, hd), 0.0, 1 / math.sqrt(d)),
            Leaf(lay + ("attn", "wk"), (L, d, kv, hd), 0.0, 1 / math.sqrt(d)),
            Leaf(lay + ("attn", "wv"), (L, d, kv, hd), 0.0, 1 / math.sqrt(d)),
            Leaf(lay + ("attn", "wo"), (L, nh, hd, d), 0.0,
                 1 / math.sqrt(nh * hd))]
    if m.get("qkv_bias"):
        out += [Leaf(lay + ("attn", "bq"), (L, nh, hd), 0.0, 0.1),
                Leaf(lay + ("attn", "bk"), (L, kv, hd), 0.0, 0.1),
                Leaf(lay + ("attn", "bv"), (L, kv, hd), 0.0, 0.1)]
    out += [Leaf(lay + ("mlp", "wi"), (L, d, f), 0.0, 1 / math.sqrt(d)),
            Leaf(lay + ("mlp", "wg"), (L, d, f), 0.0, 1 / math.sqrt(d)),
            Leaf(lay + ("mlp", "wo"), (L, f, d), 0.0, 1 / math.sqrt(f)),
            Leaf(("ln_f", "scale"), (d,), 0.0, 0.1)]
    return out


def layer(lp: Dict[str, Any], x: Tensor, m: Dict[str, Any], mm: MM
          ) -> Tensor:
    """One decoder layer: attention, then the MLP, each on a residual."""
    B, S, d = x.shape
    eps, a = m["norm_eps"], lp["attn"]
    h = rmsnorm(x, lp["ln1"]["scale"], eps)

    def proj(w: Tensor, bias: Optional[Tensor]) -> Tensor:
        y = mm(h, w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])
        return y if bias is None else y + bias

    q = rope(proj(a["wq"], a.get("bq")), m["rope_theta"])
    k = rope(proj(a["wk"], a.get("bk")), m["rope_theta"])
    v = proj(a["wv"], a.get("bv"))
    o = causal_attention(q, k, v, mm).reshape(B, S, -1)
    x = x + mm(o, a["wo"].reshape(-1, d))
    h2 = rmsnorm(x, lp["ln2"]["scale"], eps)
    f = lp["mlp"]
    return x + mm(F.silu(mm(h2, f["wg"])) * mm(h2, f["wi"]), f["wo"])


def forward(p: Dict[str, Any], tokens: Tensor, m: Dict[str, Any], *,
            mm: MM = mm32, remat: bool = False) -> Tensor:
    """fp32 logits [B, S, V]; ``remat`` recomputes each layer in the
    backward."""
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
    """The projections, the attention's visible pairs and the LM head
    over every position."""
    d, f, H, KV, h = (m["d_model"], m["d_ff"], m["n_heads"],
                      m["n_kv_heads"], _hd(m))
    proj = 2 * (d * H * h + 2 * d * KV * h + H * h * d + 3 * d * f)
    return m["n_layers"] * (B * S * proj + work.flash_work(m, B, S)[1]) \
        + 2 * d * m["vocab_size"] * B * S
