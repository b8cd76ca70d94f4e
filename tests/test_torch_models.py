"""The port's model path against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``: the flash-attention and SSD kernels' plain versions
against the JAX kernels in interpret mode and their jnp references, the
Mamba2 and attention layers, the zamba2 forward with and without a cache,
and the serving engine.  The JAX package's parameters carry across with
``params_from_numpy``.

Tolerances: the kernels' plain versions take ``tests/test_kernels.py``'s
(flash atol 2e-5 fp32 / 2e-2 bf16 with rtol 1e-2; the SSD scan four times
those with rtol 2e-2).  Layers and the forward in fp32: atol 1e-4 (layers)
and 1e-3 (logits of the 4-layer smoke model, whose random weights amplify
fp32 rounding ~100x), rtol 1e-3.  In bf16 the two frameworks round at
different places (XLA keeps fused elementwise chains in fp32): the smoke
model amplifies one bf16 ulp of input noise to a relative L2 error of
~0.3 in its logits, so a bf16 forward must be no further from the JAX
bf16 logits than JAX's own bf16 logits are from its fp32 ones, times 1.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as r_layers
import repro.models.mamba2 as r_m2
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.kernels.flash_attention import ops as r_fa_ops
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref as r_attention
from repro.kernels.mamba2_ssd.kernel import ssd_fwd as r_ssd_fwd
from repro.kernels.mamba2_ssd.ref import ssd_ref as r_ssd_ref
from repro.models import forward as r_forward
from repro.models import init_cache_specs as r_cache_specs
from repro.models import init_params as r_init
from repro.models import param_specs as r_param_specs
from repro.models.params import ParamSpec as RSpec
from repro.parallel.sharding import MeshPolicy as RPolicy
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine

import repro_torch.models.layers as t_layers
import repro_torch.models.mamba2 as t_m2
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.mamba2_ssd import ops as t_ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as t_ssd_ref
from repro_torch.models import (count_params, forward, init_cache_specs,
                                init_params, param_specs, params_from_numpy)
from repro_torch.models.params import tree_leaves
from repro_torch.parallel.sharding import MeshPolicy, shard_constraint
from repro_torch.serve import Request, ServeEngine

CPU = "cpu"
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RP, TP = RPolicy(), MeshPolicy()


def _j(a, dtype="float32"):
    return jnp.asarray(a, jnp.dtype(dtype))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=1e-3):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _carry(tree):
    """JAX pytree -> the same tree of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk,softcap", [
    (1, 128, 4, 4, 32, 64, 64, None),       # MHA
    (2, 256, 8, 2, 64, 128, 64, None),      # GQA, rectangular blocks
    (1, 512, 4, 1, 32, 128, 128, None),     # MQA
    (1, 128, 2, 2, 16, 64, 64, 30.0),       # softcap
    (1, 128, 4, 2, 80, 64, 128, None),      # zamba2's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_ref_matches_jax_kernel(B, S, H, KV, hd, bq, bk, softcap,
                                      dtype, window):
    rng = np.random.default_rng(S + hd)
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    want = flash_attention_fwd(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               causal=True, window=window, softcap=softcap,
                               block_q=bq, block_k=bk)
    want_ref = r_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                           causal=True, window=window, softcap=softcap)
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    got = t_fa_ref.attention_ref(tq, tk, tv, causal=True, window=window,
                                 softcap=softcap)
    via_ops = t_fa_ops.flash_attention(tq, tk, tv, True, window, softcap)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    assert torch.equal(via_ops, got)           # a CPU tensor: plain version
    _close(got, want, FLASH_ATOL[dtype], 1e-2)
    _close(got, want_ref, FLASH_ATOL[dtype], 1e-2)


@pytest.mark.parametrize("window,softcap", [(None, None), (48, 20.0)])
def test_flash_grad_matches_jax(window, softcap):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 128, 2, 16)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((1, 128, 2, 16)).astype(np.float32)

    def r_loss(q_, k_, v_):
        return (r_fa_ops.flash_attention(q_, k_, v_, True, window, softcap)
                * g).sum()
    want = jax.grad(r_loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (t_fa_ops.flash_attention(tq, tk, tv, True, window, softcap)
     * _t(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, 1e-4, 1e-3)


# ---------------------------------------------------------------------------
# mamba2 SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, hd, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, hd, N)).astype(np.float32)
    return x, dt, A, Bc, Cc, h0


@pytest.mark.parametrize("B,S,H,hd,N", [(2, 128, 3, 16, 8), (1, 64, 2, 8, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_matches_jax(B, S, H, hd, N, dtype, with_h0):
    x, dt, A, Bc, Cc, h0 = _ssd_inputs(B, S, H, hd, N)
    jx, jb, jc = _j(x, dtype), _j(Bc, dtype), _j(Cc, dtype)
    tx, tb, tc = _t(x, dtype), _t(Bc, dtype), _t(Cc, dtype)
    jh0 = _j(h0) if with_h0 else None
    th0 = _t(h0) if with_h0 else None
    wants = [r_ssd_ref(jx, _j(dt), _j(A), jb, jc, h0=jh0, chunk=32)]
    if not with_h0:                            # the Pallas kernel takes none
        wants.append(r_ssd_fwd(jx, _j(dt), _j(A), jb, jc, chunk=32))
    got = t_ssd_ref.ssd_ref(tx, _t(dt), _t(A), tb, tc, h0=th0, chunk=32)
    via_ops = t_ssd_ops.ssd(tx, _t(dt), _t(A), tb, tc, h0=th0, chunk=32)
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == torch.float32
    for a, b in zip(via_ops, got):
        assert torch.equal(a, b)
    atol = 4 * FLASH_ATOL[dtype]
    for y, h in wants:
        _close(got[0], y, atol, 2e-2)
        _close(got[1], h, atol, 2e-2)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_ref_takes_a_ragged_sequence(with_h0):
    """S = 100 with chunks of 32 (where the JAX reshape fails): zero steps
    pad it to 128, the same function as one chunk of 100 in the JAX
    package."""
    x, dt, A, Bc, Cc, h0 = _ssd_inputs(2, 100, 3, 16, 8, seed=2)
    want = r_m2.ssd_chunked(_j(x), _j(dt), _j(A), _j(Bc), _j(Cc),
                            h0=_j(h0) if with_h0 else None, chunk=100)
    got = t_ssd_ref.ssd_ref(_t(x), _t(dt), _t(A), _t(Bc), _t(Cc),
                            h0=_t(h0) if with_h0 else None, chunk=32)
    assert got[0].shape == x.shape
    for a, b in zip(got, want):
        _close(a, b, 4 * FLASH_ATOL["float32"], 2e-2)


def test_ssd_decode_step_matches_jax():
    x, dt, A, Bc, Cc, h0 = _ssd_inputs(2, 1, 3, 8, 4, seed=3)
    want = r_m2.ssd_decode_step(_j(x), _j(dt), _j(A), _j(Bc), _j(Cc),
                                _j(h0))
    got = t_m2.ssd_decode_step(_t(x), _t(dt), _t(A), _t(Bc), _t(Cc), _t(h0))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    want = r_m2._causal_conv(_j(x), _j(w), _j(st) if with_state else None)
    got = t_m2._causal_conv(_t(x), _t(w), _t(st) if with_state else None)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 19.9, 20.5, 40.0])
    _close(t_m2.softplus(x), jax.nn.softplus(_j(x.numpy())), 1e-6)


def _layer_params(cfg, seed=0):
    """The smoke model's parameters (JAX) and the first layer's slice."""
    rp = r_init(r_param_specs(cfg), jax.random.PRNGKey(seed))
    lp = jax.tree.map(lambda a: a[0], rp["layers"])
    return rp, lp, _carry(rp), _carry(lp)


@pytest.mark.parametrize("mode", ["prefill", "prefill_state", "decode"])
def test_mamba2_block_matches_jax(mode):
    cfg = r_smoke("zamba2_2_7b").derive(dtype="float32")
    _, rlp, _, tlp = _layer_params(cfg)
    S = 1 if mode == "decode" else 32
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    d_in = cfg.ssm_expand * cfg.d_model
    state = None
    if mode != "prefill":
        hd = d_in // cfg.ssm_heads
        state = {"h": rng.standard_normal(
            (2, cfg.ssm_heads, hd, cfg.ssm_state)).astype(np.float32),
            "conv": rng.standard_normal(
                (2, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state)
            ).astype(np.float32)}
    kw = dict(decode=mode == "decode")
    want, wst = r_m2.mamba2_block(
        rlp["mamba"], _j(x), cfg=cfg, policy=RP,
        state=None if state is None else jax.tree.map(_j, state),
        use_pallas=True, **kw)
    for use_kernels in (False, True):
        got, gst = t_m2.mamba2_block(
            tlp["mamba"], _t(x), cfg=cfg, policy=TP,
            state=None if state is None else
            {k: _t(v) for k, v in state.items()},
            use_kernels=use_kernels, **kw)
        _close(got, want, 1e-4)
        assert (gst is None) == (wst is None)
        if gst is not None:
            for k in wst:
                _close(gst[k], wst[k], 1e-4)


# ---------------------------------------------------------------------------
# layers.py, function by function
# ---------------------------------------------------------------------------

def _attn_cfg(**kw):
    return r_smoke("zamba2_2_7b").derive(dtype="float32", **kw)


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    _close(t_layers.rmsnorm(_t(x), _t(s)), r_layers.rmsnorm(_j(x), _j(s)),
           1e-5)
    _close(t_layers.layernorm(_t(x), _t(s), _t(b)),
           r_layers.layernorm(_j(x), _j(s), _j(b)), 1e-5)
    pos = np.tile(np.arange(8), (2, 1)).astype(np.int32) * 37
    _close(t_layers.apply_rope(_t(x), torch.from_numpy(pos), 1e4),
           r_layers.apply_rope(_j(x), jnp.asarray(pos), 1e4), 1e-4)
    pos3 = rng.integers(0, 500, (2, 8, 3)).astype(np.int32)
    _close(t_layers.apply_mrope(_t(x), torch.from_numpy(pos3), 1e6,
                                (2, 3, 3)),
           r_layers.apply_mrope(_j(x), jnp.asarray(pos3), 1e6, (2, 3, 3)),
           1e-4)
    for sq, sk, win, off in ((5, 5, None, 0), (3, 9, 4, 6)):
        assert np.array_equal(
            t_layers.causal_mask(sq, sk, window=win, offset=off).numpy(),
            np.asarray(r_layers.causal_mask(sq, sk, window=win,
                                            offset=off)))


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 5)])
def test_sdpa_and_blocked_attention_match_jax(softcap, window):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    mask = np.asarray(r_layers.causal_mask(64, 64, window=window))
    mask = np.broadcast_to(mask, (2, 64, 64))
    _close(t_layers._sdpa(_t(q), _t(k), _t(v), torch.from_numpy(mask.copy()),
                          softcap),
           r_layers._sdpa(_j(q), _j(k), _j(v), jnp.asarray(mask), softcap),
           1e-5)
    for is_global in (True, False):
        _close(t_layers.blocked_attention(
            _t(q), _t(k), _t(v), is_global=is_global, window=window,
            softcap=softcap, block_q=16, block_k=32),
            r_layers.blocked_attention(
                _j(q), _j(k), _j(v), is_global=is_global, window=window,
                softcap=softcap, block_q=16, block_k=32), 1e-5)


@pytest.mark.parametrize("mode", ["prefill", "prefill_cache", "decode",
                                  "window_decode"])
def test_attention_block_matches_jax(mode):
    cfg = _attn_cfg(sliding_window=6 if mode == "window_decode" else None,
                    qkv_bias=True, logit_softcap=30.0)
    spec = r_layers.attn_specs(cfg)
    rp = r_init(spec, jax.random.PRNGKey(8))
    rng = np.random.default_rng(8)
    rp = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in rp.items()}                   # non-zero biases
    tp = _carry(rp)
    decode = mode.endswith("decode")
    S, S_max = (1, 24) if decode else (16, 24)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    idx = 13
    pos = (np.full((2, S), idx) if decode else np.tile(np.arange(S), (2, 1))
           ).astype(np.int32)
    cache = None
    if mode != "prefill":
        shape = (2, S_max, cfg.n_kv_heads, cfg.hd)
        cache = {"k": rng.standard_normal(shape).astype(np.float32),
                 "v": rng.standard_normal(shape).astype(np.float32)}
    is_global = mode != "window_decode"
    want, wc = r_layers.attention_block(
        rp, _j(x), cfg=cfg, positions=jnp.asarray(pos), policy=RP,
        is_global=is_global,
        cache=None if cache is None else jax.tree.map(_j, cache),
        cache_index=jnp.int32(idx) if decode else None)
    got, gc = t_layers.attention_block(
        tp, _t(x), cfg=cfg, positions=torch.from_numpy(pos), policy=TP,
        is_global=is_global,
        cache=None if cache is None else {k: _t(v) for k, v in cache.items()},
        cache_index=idx if decode else None)
    _close(got, want, 1e-4)
    assert (gc is None) == (wc is None)
    if gc is not None:
        for k in wc:
            _close(gc[k], wc[k], 1e-6)


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp_block_matches_jax(mlp_type):
    cfg = _attn_cfg(mlp_type=mlp_type)
    rp = r_init(r_layers.mlp_specs(cfg), jax.random.PRNGKey(9))
    x = np.random.default_rng(9).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    _close(t_layers.mlp_block(_carry(rp), _t(x), cfg=cfg, policy=TP),
           r_layers.mlp_block(rp, _j(x), cfg=cfg, policy=RP), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_lm_head_match_jax(dtype):
    cfg = _attn_cfg()
    rp = r_init(r_layers.embed_specs(cfg.derive(tie_embeddings=False)),
                jax.random.PRNGKey(10))
    tp = _carry(rp)
    tok = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 8))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ex = r_layers.embed(rp, jnp.asarray(tok), policy=RP, dtype=jdt)
    gx = t_layers.embed(tp, torch.from_numpy(tok), policy=TP, dtype=tdt)
    assert gx.dtype == tdt
    _close(gx, ex, 0)
    for p_r, p_t in ((rp, tp), ({"tok": rp["tok"]}, {"tok": tp["tok"]})):
        want = r_layers.lm_head(p_r, ex, policy=RP)
        got = t_layers.lm_head(p_t, gx, policy=TP)
        assert got.dtype == torch.float32
        _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# parameter and cache trees
# ---------------------------------------------------------------------------

def _shapes(tree, is_leaf):
    return [tuple(s.shape) for s in jax.tree.leaves(tree, is_leaf=is_leaf)]


def test_param_and_cache_specs_match_jax():
    cfg = get_smoke_config("zamba2_2_7b")
    rcfg = r_smoke("zamba2_2_7b")
    assert cfg == type(cfg)(**rcfg.__dict__)
    is_spec = lambda x: isinstance(x, RSpec)  # noqa: E731
    for t_tree, r_tree in ((param_specs(cfg), r_param_specs(rcfg)),
                           (init_cache_specs(cfg, 3, 40),
                            r_cache_specs(rcfg, 3, 40))):
        # the same keys and the same (shape, axes, init) per key path
        flat_t = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.scale),
                         t_tree, is_leaf=lambda x: hasattr(x, "axes")),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        flat_r = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.scale),
                         r_tree, is_leaf=is_spec),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        assert flat_t == flat_r
    assert count_params(param_specs(cfg)) == \
        sum(int(np.prod(s)) for s in _shapes(r_param_specs(rcfg), is_spec))


def test_full_zamba2_param_count():
    cfg = get_config("zamba2_2_7b")
    assert cfg == type(cfg)(**r_get_config("zamba2_2_7b").__dict__)
    assert count_params(param_specs(cfg)) == 6_587_337_888


def test_init_params_is_seeded_and_shaped():
    cfg = get_smoke_config("zamba2_2_7b")
    specs = param_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(3), device=CPU)
    b = init_params(specs, torch.Generator().manual_seed(3), device=CPU)
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [tuple(t.shape) for t in la] == \
        [s.shape for s in tree_leaves(specs)]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.all(a["layers"]["mamba"]["A_log"] == 1)
    assert torch.all(a["ln_f"]["scale"] == 0)


def _arch_batch(cfg, B, S, rng):
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        b["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_forward_shapes_and_finite(arch):
    """Every smoke configuration through the port's forward on the CPU
    (the kernels' plain versions): scoring, a cache-filling prefill and
    one decode step give finite logits of the expected shapes, and the
    cache keeps its specs' shapes."""
    cfg = get_smoke_config(arch)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         device=CPU)
    B, S, S_max = 2, 16, 24
    batch = _arch_batch(cfg, B, S, np.random.default_rng(0))
    logits, none = forward(params, batch, cfg=cfg, device=CPU,
                           use_kernels=True)
    assert none is None and logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    specs = init_cache_specs(cfg, B, S_max)
    cache = {k: torch.zeros(s.shape, dtype=torch.bfloat16 if len(s.shape)
                            >= 3 else torch.float32)
             for k, s in specs.items()}          # the engine's dtypes
    _, cache = forward(params, batch, cfg=cfg, device=CPU, cache=cache)
    step, cache = forward(params, {"tokens": batch["tokens"][:, :1]},
                          cfg=cfg, device=CPU, cache=cache, cache_index=S)
    assert step.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(step).all()
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: s.shape for k, s in specs.items()}


def test_shard_constraint_is_the_identity_on_one_card():
    x = torch.ones(2, 3)
    assert shard_constraint(x, ("batch", "seq"), TP) is x
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_constraint(x, ("batch", "seq"), TP, mesh=object())
    # a one-rank (1, 1) gloo mesh: the constraint is the identity
    from repro_torch.launch.mesh import init_host_group, make_host_mesh
    owns = init_host_group(torch.device(CPU))
    try:
        mesh = make_host_mesh(CPU)
        assert shard_constraint(x, ("batch", "seq"), TP, mesh=mesh) is x
    finally:
        if owns:
            torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the zamba2 forward, with and without a cache
# ---------------------------------------------------------------------------

def _zamba(dtype, seed=0):
    rcfg = r_smoke("zamba2_2_7b").derive(dtype=dtype)
    tcfg = get_smoke_config("zamba2_2_7b").derive(dtype=dtype)
    rp = r_init(r_param_specs(rcfg), jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, _carry(rp)


def _zero_cache(cfg, B, S_max):
    """The serving engine's cache dtypes: bf16 at rank >= 3, else fp32."""
    return jax.tree.map(lambda s: jnp.zeros(
        s.shape, jnp.bfloat16 if len(s.shape) >= 3 else jnp.float32),
        r_cache_specs(cfg, B, S_max), is_leaf=lambda x: isinstance(x, RSpec))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_fp32_matches_jax(use_kernels):
    rcfg, tcfg, rp, tp = _zamba("float32")
    tok = np.random.default_rng(11).integers(0, 256, (2, 64)).astype(
        np.int32)
    want, _ = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                        policy=RP, use_pallas=use_kernels)
    got, cache = forward(tp, {"tokens": tok}, cfg=tcfg, device=CPU,
                         use_kernels=use_kernels)
    assert cache is None and got.dtype == torch.float32
    _close(got, want, 1e-3)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_with_cache_then_decode_matches_jax(use_kernels):
    """A cache-filling prefill, then two decode steps, in fp32: logits and
    every cache leaf, dtypes included."""
    rcfg, tcfg, rp, tp = _zamba("float32", seed=1)
    tok = np.random.default_rng(12).integers(0, 256, (2, 40)).astype(
        np.int32)
    rc = _zero_cache(rcfg, 2, 64)
    tc = _carry(rc)
    want, rc = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                         policy=RP, cache=rc, use_pallas=use_kernels)
    got, tc = forward(tp, {"tokens": tok}, cfg=tcfg, cache=tc, device=CPU,
                      use_kernels=use_kernels)
    _close(got, want, 1e-3)
    for step in range(2):
        nxt = np.asarray(want[:, -1].argmax(-1), np.int32)[:, None]
        assert np.array_equal(nxt[:, 0], got[:, -1].argmax(-1).numpy())
        for k in rc:
            assert str(tc[k].dtype).split(".")[1] == str(rc[k].dtype)
            _close(tc[k], rc[k], 1e-3 if rc[k].dtype == jnp.float32
                   else 2e-2, 1e-2)
        want, rc = r_forward(rp, {"tokens": jnp.asarray(nxt)}, cfg=rcfg,
                             policy=RP, cache=rc,
                             cache_index=jnp.int32(40 + step))
        got, tc = forward(tp, {"tokens": nxt}, cfg=tcfg, cache=tc,
                          device=CPU, cache_index=40 + step)
        _close(got, want, 1e-3)


def test_forward_bf16_within_the_noise_of_jax():
    """bf16 rounds at other places in the two frameworks; the port's
    kernel path must be no further from JAX's Pallas path than JAX's own
    bf16 logits are from its fp32 ones (times 1.5)."""
    rcfg, tcfg, rp, tp = _zamba("bfloat16")
    tok = np.random.default_rng(13).integers(0, 256, (2, 64)).astype(
        np.int32)
    want, _ = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                        policy=RP, use_pallas=True)
    fp32, _ = r_forward(rp, {"tokens": jnp.asarray(tok)},
                        cfg=rcfg.derive(dtype="float32"), policy=RP)
    got, _ = forward(tp, {"tokens": tok}, cfg=tcfg, device=CPU,
                     use_kernels=True)
    noise = _rel_l2(want, fp32)
    assert np.isfinite(_np(got)).all() and got.shape == (2, 64, 256)
    assert _rel_l2(got, want) <= 1.5 * noise, (_rel_l2(got, want), noise)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(engine_cls, request_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, max_batch=2, max_seq=32, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=np.asarray(p, np.int32),
                               max_new=6))
    done = eng.run(max_iters=32)
    return {r.rid: list(r.generated) for r in done}


def test_serve_engine_matches_jax_and_keeps_its_fault():
    """fp32 smoke config: equal tokens in both packages.  Request A's
    tokens change when B is admitted beside it (every step writes every
    slot's cache; ROADMAP.md queue 3), in both packages alike."""
    rcfg, tcfg, rp, tp = _zamba("float32", seed=2)
    a, b = [5, 17, 3, 99, 42], [2, 3]
    runs = {}
    for name, prompts in (("alone", [a]), ("with_b", [a, b])):
        want = _serve(REngine, RRequest, rcfg, rp, prompts)
        got = _serve(ServeEngine, Request, tcfg, tp, prompts, device=CPU)
        assert got == want, (name, got, want)
        runs[name] = got
    assert runs["alone"][0] != runs["with_b"][0]


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("zamba2_2_7b")
    tp = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                     device=CPU)
    tok = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        forward(tp, {"tokens": tok}, cfg=cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(cfg, tp)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_params(param_specs(cfg), torch.Generator())
    logits, _ = forward(tp, {"tokens": tok}, cfg=cfg, device=CPU)
    assert logits.shape == (1, 4, cfg.vocab_size)
