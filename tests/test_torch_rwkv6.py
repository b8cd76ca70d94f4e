"""The port's rwkv6 path and its grouped matmul against the JAX package,
on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``: the WKV kernel's plain version against the JAX kernel in
interpret mode and its jnp reference, the decode step, the gradient, the
rwkv6 time and channel mixing blocks, the rwkv6 smoke forward with and
without a cache, the serving engine, and the grouped matmul's plain version
against the JAX kernel.  The JAX package's parameters carry across with
``params_from_numpy``.  Two faults of the reference's WKV path are pinned
on ``repro`` itself, beside the port's answer.

Tolerances: the kernels' plain versions take ``tests/test_kernels.py``'s
(WKV atol 4 x (2e-5 fp32, 2e-2 bf16) with rtol 2e-2; gmm atol
(2e-5 fp32, 2e-2 bf16) x sqrt(D) with rtol 2e-2); the decode step and the
per-step recurrence the reference's 1e-4 with rtol 1e-3.  Blocks and the
forward in fp32: atol 1e-4 (blocks) and 1e-3 (logits of the 2-layer smoke
model), rtol 1e-3, as ``tests/test_torch_models.py`` holds zamba2; the
blocks' parameters are perturbed so that every input matters, which lifts
their outputs to ~10, so there the atol is 1e-4 of the output's largest
magnitude (fp32 rounding of the output projection's sums, seen at up to
5e-5 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv6 as r_rwkv
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.kernels.moe_gmm import ops as r_gmm_ops
from repro.kernels.moe_gmm.kernel import gmm as r_gmm
from repro.kernels.moe_gmm.ref import gmm_ref as r_gmm_ref
from repro.kernels.rwkv6_scan import ops as r_wkv_ops
from repro.kernels.rwkv6_scan.kernel import wkv6_fwd as r_wkv6_fwd
from repro.kernels.rwkv6_scan.ref import wkv6_ref as r_wkv6_ref
from repro.models import forward as r_forward
from repro.models import init_cache_specs as r_cache_specs
from repro.models import init_params as r_init
from repro.models import param_specs as r_param_specs
from repro.models.params import ParamSpec as RSpec
from repro.parallel.sharding import MeshPolicy as RPolicy
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine

import repro_torch.models.rwkv6 as t_rwkv
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.moe_gmm import ops as t_gmm_ops
from repro_torch.kernels.moe_gmm import ref as t_gmm_ref
from repro_torch.kernels.rwkv6_scan import ops as t_wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as t_wkv_ref
from repro_torch.models import (count_params, forward, init_cache_specs,
                                param_specs, params_from_numpy)
from repro_torch.parallel.sharding import MeshPolicy
from repro_torch.serve import Request, ServeEngine

CPU = "cpu"
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
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


def _close_scaled(got, want, rel=1e-4):
    _close(got, want, rel * float(np.abs(_np(want)).max()))


def _carry(tree):
    """JAX pytree -> the same tree of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _wkv_inputs(B, S, H, hd, seed=0, decay_scale=0.5):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, hd))
                       * decay_scale)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _wkv_explicit(r, k, v, w, u, s0=None):
    """The per-step recurrence in float64: the yardstick of both
    packages' chunked forms."""
    r, k, v, w = (np.asarray(a, np.float64) for a in (r, k, v, w))
    B, S, H, hd = r.shape
    s = np.zeros((B, H, hd, hd)) if s0 is None else np.asarray(s0,
                                                               np.float64)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        ys.append(np.einsum("bhc,bhcd->bhd", rt, s)
                  + np.einsum("bhc,bhc,bhd->bhd", rt * u[None], kt, vt))
        s = s * wt[..., None] + np.einsum("bhc,bhd->bhcd", kt, vt)
    return np.stack(ys, 1), s


# ---------------------------------------------------------------------------
# the WKV scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_plain_matches_jax_kernel_and_ref(dtype, with_s0):
    """S=128 in chunks of 32: the port's plain version (and ``ops.wkv6``
    on a CPU tensor) against the Pallas kernel in interpret mode (which
    takes no initial state) and the jnp reference."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 128, 3, 16)
    jr, jk, jv = (_j(a, dtype) for a in (r, k, v))
    tr, tk, tv = (_t(a, dtype) for a in (r, k, v))
    js0, ts0 = (_j(s0), _t(s0)) if with_s0 else (None, None)
    wants = [r_wkv6_ref(jr, jk, jv, _j(w), _j(u), s0=js0, chunk=32)]
    if not with_s0:
        wants.append(r_wkv6_fwd(jr, jk, jv, _j(w), _j(u), chunk=32))
    got = t_wkv_ref.wkv6_ref(tr, tk, tv, _t(w), _t(u), s0=ts0, chunk=32)
    via_ops = t_wkv_ops.wkv6(tr, tk, tv, _t(w), _t(u), s0=ts0)
    assert got[0].dtype == getattr(torch, dtype) and got[0].shape == tr.shape
    assert got[1].dtype == torch.float32 and got[1].shape == (2, 3, 16, 16)
    for a, b in zip(via_ops, got):
        assert torch.equal(a, b)                 # a CPU tensor: plain version
    for y, s in wants:
        _close(got[0], y, 4 * ATOL[dtype], 2e-2)
        _close(got[1], s, 4 * ATOL[dtype], 2e-2)


def test_wkv_takes_a_bf16_initial_state():
    """The serving engine's cache holds the state in bf16: the port
    computes it in fp32.  The reference's ``wkv6_chunked`` refuses it (its
    scan carries a bf16 state in and an fp32 state out), so a cache-filling
    prefill from the engine's cache fails there, on both of its paths; the
    port's answer is the reference's on the same state in fp32."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 64, 2, 16, seed=1)
    s0b = _t(s0, "bfloat16")
    jb = jnp.asarray(s0b.float().numpy(), jnp.bfloat16)
    for fn in (r_wkv6_ref, r_wkv_ops.wkv6):
        with pytest.raises(TypeError, match="carry"):
            fn(_j(r), _j(k), _j(v), _j(w), _j(u), s0=jb)
    want = r_wkv6_ref(_j(r), _j(k), _j(v), _j(w), _j(u),
                      s0=jb.astype(jnp.float32))
    got = t_wkv_ops.wkv6(_t(r), _t(k), _t(v), _t(w), _t(u), s0=s0b)
    for a, b in zip(got, want):
        _close(a, b, 4 * ATOL["float32"], 2e-2)


@pytest.mark.parametrize("S,chunk", [(1, 32), (40, 32), (65, 32), (100, 32),
                                     (129, 64), (96, 16)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_plain_matches_explicit_recurrence_at_any_length(S, chunk,
                                                             with_s0):
    """Chunks of ``chunk`` steps, the last one cut short: the per-step
    recurrence at every S, including those where the reference fails."""
    r, k, v, w, u, s0 = _wkv_inputs(2, S, 2, 8, seed=S)
    s0 = s0 if with_s0 else None
    y, s = t_wkv_ref.wkv6_ref(_t(r), _t(k), _t(v), _t(w), _t(u),
                              s0=None if s0 is None else _t(s0), chunk=chunk)
    want_y, want_s = _wkv_explicit(r, k, v, w, u, s0)
    assert y.shape == r.shape
    _close(y, want_y, 1e-4)
    _close(s, want_s, 1e-4)


def test_wkv_step_matches_the_chunked_scan():
    """32 decode steps, one token at a time, against the chunked scan (the
    reference's test_wkv_decode_step_matches_scan) and against the JAX
    decode step."""
    r, k, v, w, u, _ = _wkv_inputs(1, 32, 2, 8, seed=3, decay_scale=0.3)
    s = torch.zeros(1, 2, 8, 8)
    js = jnp.zeros((1, 2, 8, 8))
    ys = []
    for t in range(32):
        sl = slice(t, t + 1)
        y, s = t_rwkv.wkv6_step(_t(r[:, sl]), _t(k[:, sl]), _t(v[:, sl]),
                               _t(w[:, sl]), _t(u), s)
        jy, js = r_rwkv.wkv6_step(_j(r[:, sl]), _j(k[:, sl]), _j(v[:, sl]),
                                  _j(w[:, sl]), _j(u), js)
        _close(y, jy, 1e-5)
        _close(s, js, 1e-5)
        ys.append(y[:, 0])
    y_ref, s_ref = t_rwkv.wkv6_chunked(_t(r), _t(k), _t(v), _t(w), _t(u),
                                      chunk=8)
    _close(torch.stack(ys, 1), y_ref, 1e-4)
    _close(s, s_ref, 1e-4)


def test_wkv_step_promotes_a_bf16_state():
    r, k, v, w, u, s0 = _wkv_inputs(2, 1, 2, 8, seed=4)
    sb = _t(s0, "bfloat16")
    y, s = t_rwkv.wkv6_step(_t(r), _t(k), _t(v), _t(w), _t(u), sb)
    jy, js = r_rwkv.wkv6_step(_j(r), _j(k), _j(v), _j(w), _j(u),
                              jnp.asarray(sb.float().numpy(), jnp.bfloat16))
    assert s.dtype == torch.float32 and str(js.dtype) == "float32"
    _close(y, jy, 1e-5)
    _close(s, js, 1e-5)


@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv_strong_decay_is_finite(chunk):
    """The reference's regression: w = 1e-45 (flushed to zero) must stay
    finite through the clamp and the masked exponent."""
    r, k, v, _, _, _ = _wkv_inputs(1, 64, 1, 8, seed=5)
    w = np.full(r.shape, 1e-45, np.float32)
    u = np.ones((1, 8), np.float32)
    y, s = t_wkv_ref.wkv6_ref(_t(r), _t(k), _t(v), _t(w), _t(u), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jy, js = r_rwkv.wkv6_chunked(_j(r), _j(k), _j(v), _j(w), _j(u),
                                 chunk=chunk)
    _close(y, jy, 4 * ATOL["float32"], 2e-2)
    _close(s, js, 4 * ATOL["float32"], 2e-2)


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_grad_matches_jax(with_s0):
    """The backward differentiates the plain version, as the reference's
    oracle VJP does."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 64, 2, 8, seed=6)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal(r.shape).astype(np.float32)
    gs = rng.standard_normal(s0.shape).astype(np.float32)
    argn = (0, 1, 2, 3, 4, 5) if with_s0 else (0, 1, 2, 3, 4)

    def r_loss(r_, k_, v_, w_, u_, s_=None):
        y, s = r_wkv_ops.wkv6(r_, k_, v_, w_, u_, s0=s_)
        return (y * gy).sum() + (s * gs).sum()
    jargs = [_j(a) for a in (r, k, v, w, u)] + ([_j(s0)] if with_s0 else [])
    want = jax.grad(r_loss, argnums=argn)(*jargs)
    targs = [_t(a).requires_grad_() for a in (r, k, v, w, u)]
    ts0 = _t(s0).requires_grad_() if with_s0 else None
    y, s = t_wkv_ops.wkv6(*targs, s0=ts0)
    ((y * _t(gy)).sum() + (s * _t(gs)).sum()).backward()
    got = [a.grad for a in targs] + ([ts0.grad] if with_s0 else [])
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-4, 1e-3)


# ---------------------------------------------------------------------------
# the reference's two WKV faults, pinned on repro beside the port's answer
# ---------------------------------------------------------------------------

def test_reference_wkv_kernel_leaves_the_tail_unwritten():
    """S=40 with chunks of 32: the Pallas grid covers S // 32 chunks, so
    positions 32-39 of y come back NaN in interpret mode and the state
    misses their keys.  The port computes every position."""
    r, k, v, w, u, _ = _wkv_inputs(1, 40, 2, 8, seed=8)
    y, s = r_wkv6_fwd(_j(r), _j(k), _j(v), _j(w), _j(u), chunk=32)
    y = np.asarray(y)
    assert np.isfinite(y[:, :32]).all() and np.isnan(y[:, 32:]).all()
    want_y, want_s = _wkv_explicit(r, k, v, w, u)
    assert np.abs(np.asarray(s) - want_s).max() > 1.0
    ty, ts = t_wkv_ops.wkv6(_t(r), _t(k), _t(v), _t(w), _t(u), chunk=32)
    _close(ty, want_y, 1e-4)
    _close(ts, want_s, 1e-4)


def test_reference_wkv_with_a_state_fails_at_65_steps():
    """``ops.wkv6(s0=...)`` calls ``wkv6_chunked(chunk=32)``, whose
    reshape into S // 32 chunks of S // nc steps fails where that does not
    divide S; so a cache-filling prefill of 65 tokens fails in the
    reference.  The port takes it."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 65, 2, 8, seed=9)
    with pytest.raises(TypeError, match="reshape"):
        r_wkv_ops.wkv6(_j(r), _j(k), _j(v), _j(w), _j(u), s0=_j(s0))
    ty, ts = t_wkv_ops.wkv6(_t(r), _t(k), _t(v), _t(w), _t(u), s0=_t(s0))
    want_y, want_s = _wkv_explicit(r, k, v, w, u, s0)
    _close(ty, want_y, 1e-4)
    _close(ts, want_s, 1e-4)


# ---------------------------------------------------------------------------
# the rwkv6 blocks
# ---------------------------------------------------------------------------

def _smoke(dtype="float32"):
    return (r_smoke("rwkv6_3b").derive(dtype=dtype),
            get_smoke_config("rwkv6_3b").derive(dtype=dtype))


def _layer(cfg, seed=0):
    """The smoke model's parameters (JAX, perturbed so that every mixing
    coefficient, decay, bonus and norm scale is non-trivial) and the
    first layer's slice."""
    rp = r_init(r_param_specs(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    rp = jax.tree.map(lambda a: a + 0.2 * rng.standard_normal(
        a.shape).astype(np.float32), rp)
    lp = jax.tree.map(lambda a: a[0], rp["layers"])
    return rp, lp, _carry(rp), _carry(lp)


def _state(cfg, B, rng):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {"wkv": rng.standard_normal((B, d // hd, hd, hd)).astype(
        np.float32),
        "shift_a": rng.standard_normal((B, 1, d)).astype(np.float32),
        "shift_f": rng.standard_normal((B, 1, d)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["prefill", "prefill_state", "decode"])
def test_rwkv6_att_matches_jax(mode):
    rcfg, tcfg = _smoke()
    _, rlp, _, tlp = _layer(rcfg)
    rng = np.random.default_rng(10)
    S = 1 if mode == "decode" else 64
    x = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    state = None if mode == "prefill" else _state(rcfg, 2, rng)
    kw = dict(decode=mode == "decode")
    for use_kernels in (False, True):
        want, wst = r_rwkv.rwkv6_att(
            rlp["att"], _j(x), cfg=rcfg, policy=RP,
            state=None if state is None else jax.tree.map(_j, state),
            use_pallas=use_kernels, **kw)
        got, gst = t_rwkv.rwkv6_att(
            tlp["att"], _t(x), cfg=tcfg, policy=TP,
            state=None if state is None else
            {k: _t(v) for k, v in state.items()},
            use_kernels=use_kernels, **kw)
        _close_scaled(got, want)
        assert (gst is None) == (wst is None)
        if gst is not None:
            for k in wst:
                assert gst[k].dtype == torch.float32
                _close_scaled(gst[k], wst[k])


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_ffn_matches_jax(with_state):
    rcfg, tcfg = _smoke()
    _, rlp, _, tlp = _layer(rcfg, seed=1)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, rcfg.d_model)).astype(np.float32)
    state = _state(rcfg, 2, rng) if with_state else None
    want, wprev = r_rwkv.rwkv6_ffn(
        rlp["ffn"], _j(x), cfg=rcfg, policy=RP,
        state=None if state is None else {"shift_f": _j(state["shift_f"])})
    got, gprev = t_rwkv.rwkv6_ffn(
        tlp["ffn"], _t(x), cfg=tcfg, policy=TP,
        state=None if state is None else {"shift_f": _t(state["shift_f"])})
    _close_scaled(got, want)
    _close(gprev, wprev, 0)


@pytest.mark.parametrize("prev", [None, "float32", "bfloat16"])
def test_token_shift_matches_jax(prev):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    p = rng.standard_normal((2, 1, 8)).astype(np.float32)
    want = r_rwkv._token_shift(_j(x), None if prev is None else _j(p, prev))
    got = t_rwkv._token_shift(_t(x), None if prev is None else _t(p, prev))
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        _close(a, b, 0)


# ---------------------------------------------------------------------------
# parameter and cache trees
# ---------------------------------------------------------------------------

def test_rwkv6_param_and_cache_specs_match_jax():
    cfg = get_smoke_config("rwkv6_3b")
    rcfg = r_smoke("rwkv6_3b")
    assert cfg == type(cfg)(**rcfg.__dict__)
    is_spec = lambda x: isinstance(x, RSpec)  # noqa: E731
    for t_tree, r_tree in ((param_specs(cfg), r_param_specs(rcfg)),
                           (init_cache_specs(cfg, 3, 40),
                            r_cache_specs(rcfg, 3, 40))):
        flat_t = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.scale),
                         t_tree, is_leaf=lambda x: hasattr(x, "axes")),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        flat_r = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.scale),
                         r_tree, is_leaf=is_spec),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        assert flat_t == flat_r


def test_full_rwkv6_param_count():
    cfg = get_config("rwkv6_3b")
    assert cfg == type(cfg)(**r_get_config("rwkv6_3b").__dict__)
    assert count_params(param_specs(cfg)) == 3_073_479_680


# ---------------------------------------------------------------------------
# the rwkv6 forward, with and without a cache
# ---------------------------------------------------------------------------

def _model(dtype, seed=0):
    rcfg, tcfg = _smoke(dtype)
    rp = r_init(r_param_specs(rcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    # non-zero mixing, decay, bonus and ln_x: the blocks' every input
    # matters (the init leaves them at zero)
    for key in ("mu", "w0", "u", "ln_x"):
        a = rp["layers"]["att"][key]
        rp["layers"]["att"][key] = a + 0.3 * rng.standard_normal(
            a.shape).astype(np.float32)
    return rcfg, tcfg, rp, _carry(rp)


def _zero_cache(cfg, B, S_max, wkv_dtype=jnp.bfloat16):
    """The serving engine's cache dtypes: bf16 at rank >= 3, else fp32;
    the reference's prefill needs the wkv leaf in fp32
    (``test_wkv_takes_a_bf16_initial_state``)."""
    c = jax.tree.map(lambda s: jnp.zeros(
        s.shape, jnp.bfloat16 if len(s.shape) >= 3 else jnp.float32),
        r_cache_specs(cfg, B, S_max), is_leaf=lambda x: isinstance(x, RSpec))
    return dict(c, wkv=c["wkv"].astype(wkv_dtype))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S", [64, 96])
def test_rwkv6_forward_fp32_matches_jax(use_kernels, S):
    rcfg, tcfg, rp, tp = _model("float32")
    tok = np.random.default_rng(13).integers(0, 256, (2, S)).astype(np.int32)
    want, _ = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                        policy=RP, use_pallas=use_kernels)
    got, cache = forward(tp, {"tokens": tok}, cfg=tcfg, device=CPU,
                         use_kernels=use_kernels)
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, S, rcfg.vocab_size)
    _close(got, want, 1e-3)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_rwkv6_prefill_then_decode_matches_jax(use_kernels):
    """A cache-filling prefill from the engine's cache (its wkv leaf bf16
    zeros on the port, the same zeros in fp32 on the reference), a second
    prefill segment continuing from its cache, then decode steps, in fp32:
    logits and every cache leaf, dtypes included."""
    rcfg, tcfg, rp, tp = _model("float32", seed=1)
    tok = np.random.default_rng(14).integers(0, 256, (2, 64)).astype(
        np.int32)
    rc = _zero_cache(rcfg, 2, 96, wkv_dtype=jnp.float32)
    tc = _carry(_zero_cache(rcfg, 2, 96))
    assert tc["wkv"].dtype == torch.bfloat16
    for seg in (tok[:, :32], tok[:, 32:]):
        want, rc = r_forward(rp, {"tokens": jnp.asarray(seg)}, cfg=rcfg,
                             policy=RP, cache=rc, use_pallas=use_kernels)
        got, tc = forward(tp, {"tokens": seg}, cfg=tcfg, cache=tc,
                          device=CPU, use_kernels=use_kernels)
        _close(got, want, 1e-3)
    for step in range(3):
        nxt = np.asarray(want[:, -1].argmax(-1), np.int32)[:, None]
        assert np.array_equal(nxt[:, 0], got[:, -1].argmax(-1).numpy())
        for k in rc:
            assert str(tc[k].dtype).split(".")[1] == str(rc[k].dtype)
            _close(tc[k], rc[k], 1e-3, 1e-2)
        want, rc = r_forward(rp, {"tokens": jnp.asarray(nxt)}, cfg=rcfg,
                             policy=RP, cache=rc,
                             cache_index=jnp.int32(64 + step))
        got, tc = forward(tp, {"tokens": nxt}, cfg=tcfg, cache=tc,
                          device=CPU, cache_index=64 + step)
        _close(got, want, 1e-3)


def test_rwkv6_decode_carries_the_reference_dtypes():
    """bf16 compute from the engine's zero cache: the first decode step's
    wkv leaf comes back fp32 (the bf16 state promoted), the shifts stay
    bf16, in both packages."""
    rcfg, tcfg, rp, tp = _model("bfloat16", seed=2)
    rc = _zero_cache(rcfg, 2, 16)
    tc = _carry(rc)
    tok = np.asarray([[3], [7]], np.int32)
    for step in range(2):
        _, rc = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                          policy=RP, cache=rc, cache_index=jnp.int32(step))
        _, tc = forward(tp, {"tokens": tok}, cfg=tcfg, cache=tc, device=CPU,
                        cache_index=step)
        for k in rc:
            assert str(tc[k].dtype).split(".")[1] == str(rc[k].dtype), k
    assert tc["wkv"].dtype == torch.float32
    assert tc["shift_a"].dtype == tc["shift_f"].dtype == torch.bfloat16


def test_rwkv6_forward_bf16_within_the_noise_of_jax():
    """bf16 rounds at other places in the two frameworks; the port's
    kernel path must be no further from JAX's Pallas path than JAX's own
    bf16 logits are from its fp32 ones (times 1.5)."""
    rcfg, tcfg, rp, tp = _model("bfloat16")
    tok = np.random.default_rng(15).integers(0, 256, (2, 64)).astype(
        np.int32)
    want, _ = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                        policy=RP, use_pallas=True)
    fp32, _ = r_forward(rp, {"tokens": jnp.asarray(tok)},
                        cfg=rcfg.derive(dtype="float32"), policy=RP)
    got, _ = forward(tp, {"tokens": tok}, cfg=tcfg, device=CPU,
                     use_kernels=True)

    def rel(a, b):
        a, b = _np(a), _np(b)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert np.isfinite(_np(got)).all()
    assert rel(got, want) <= 1.5 * rel(want, fp32), (rel(got, want),
                                                     rel(want, fp32))


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


@pytest.mark.parametrize("prompts", [[[5, 17, 3, 99, 42]],
                                     [[5, 17, 3, 99, 42], [2, 3]]])
def test_rwkv6_serve_engine_matches_jax(prompts):
    """fp32 smoke config: equal tokens in both packages, the engine's fault
    (every slot's state advanced at every step) included."""
    rcfg, tcfg, rp, tp = _model("float32", seed=3)
    want = _serve(REngine, RRequest, rcfg, rp, prompts)
    got = _serve(ServeEngine, Request, tcfg, tp, prompts, device=CPU)
    assert got == want


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", [
    (4, 64, 32, 48, 32, 16, 16), (2, 128, 64, 64, 64, 64, 32),
    (8, 32, 16, 16, 32, 16, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_jax_kernel(E, C, D, F, bc, bf, bd, dtype):
    """The reference's sweep shapes: the plain version (and ``ops.gmm`` on
    a CPU tensor) against the Pallas kernel in interpret mode and the jnp
    reference."""
    rng = np.random.default_rng(E * C)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    jx, jw = _j(x, dtype), _j(w, dtype)
    tx, tw = _t(x, dtype), _t(w, dtype)
    got = t_gmm_ref.gmm_ref(tx, tw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (E, C, F)
    assert torch.equal(t_gmm_ops.gmm(tx, tw), got)
    atol = ATOL[dtype] * D ** 0.5
    for want in (r_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd),
                 r_gmm_ref(jx, jw)):
        _close(got, want, atol, 2e-2)


def test_gmm_takes_a_remainder_block():
    """The reference's grid is (E, C // bc, F // bf, D // bd): C=40 in
    blocks of 32 leaves rows 32-39 unwritten (NaN in interpret mode), F=20
    in blocks of 16 columns 16-19, and D=20 in blocks of 8 sums only the
    first 16.  The port's plain version is the whole product."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 40, 20)).astype(np.float32)
    w = rng.standard_normal((2, 20, 20)).astype(np.float32)
    got = t_gmm_ops.gmm(_t(x), _t(w))
    _close(got, np.einsum("ecd,edf->ecf", x, w), 1e-4)
    ref = np.asarray(r_gmm(_j(x), _j(w), block_c=32, block_f=16,
                           block_d=8))
    assert np.isnan(ref[:, 32:]).all() and np.isnan(ref[:, :, 16:]).all()
    _close(ref[:, :32, :16],
           np.einsum("ecd,edf->ecf", x[:, :32, :16], w[:, :16, :16]), 1e-4)


def test_gmm_grad_matches_jax():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3, 16, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8, 12)).astype(np.float32)
    g = rng.standard_normal((3, 16, 12)).astype(np.float32)
    want = jax.grad(lambda a, b: (r_gmm_ops.gmm(a, b) * g).sum(),
                    argnums=(0, 1))(_j(x), _j(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    (t_gmm_ops.gmm(tx, tw) * _t(g)).sum().backward()
    for got, wnt in zip((tx.grad, tw.grad), want):
        _close(got, wnt, 1e-4)
