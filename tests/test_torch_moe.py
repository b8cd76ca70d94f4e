"""The port's MoE layer and the moe family against the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``: the router (tied logits included), the experts' SwiGLU
with and without the grouped-matmul kernel's plain version, the dense
route, the capacity-buffer dispatch and combine, the qwen3-moe and mixtral
smoke forwards, a cache-filling prefill with two decode steps, the bf16
forward, and the serving engine.  The JAX package's parameters carry
across with ``params_from_numpy``.

Tolerances (``tests/test_torch_models.py``'s): fp32 layers atol 1e-4,
fp32 logits of the smoke models atol 1e-3, rtol 1e-3; the bf16 forward no
further from JAX's bf16 logits than JAX's own bf16 logits are from its
fp32 ones, times 1.5 (the two frameworks round bf16 at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as r_moe
from repro.configs import get_smoke_config as r_smoke
from repro.models import forward as r_forward
from repro.models import init_cache_specs as r_cache_specs
from repro.models import init_params as r_init
from repro.models import param_specs as r_param_specs
from repro.models.params import ParamSpec as RSpec
from repro.parallel.sharding import MeshPolicy as RPolicy
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine

import repro_torch.models.moe as t_moe
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import forward, params_from_numpy
from repro_torch.parallel.sharding import MeshPolicy
from repro_torch.serve import Request, ServeEngine

CPU = "cpu"
RP, TP = RPolicy(), MeshPolicy()
MOE_ARCHS = ("qwen3_moe_30b_a3b", "mixtral_8x22b")


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


def _model(arch, dtype="float32", seed=0):
    rcfg = r_smoke(arch).derive(dtype=dtype)
    tcfg = get_smoke_config(arch).derive(dtype=dtype)
    rp = r_init(r_param_specs(rcfg), jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, _carry(rp)


@pytest.fixture(scope="module")
def qwen3_layer():
    """The qwen3-moe smoke model's first MoE layer (both packages) and a
    token block [2, 16, d]."""
    rcfg, tcfg, rp, tp = _model("qwen3_moe_30b_a3b", seed=3)
    rlp = jax.tree.map(lambda a: a[0], rp["layers"])["moe"]
    tlp = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 16, rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, rlp, tlp, x


# ---------------------------------------------------------------------------
# the layer, function by function
# ---------------------------------------------------------------------------

def test_router_matches_jax(qwen3_layer):
    rcfg, _, rlp, tlp, x = qwen3_layer
    for dtype in ("float32", "bfloat16"):
        w_r, i_r = r_moe._router(rlp, _j(x, dtype), rcfg.experts_per_token)
        w_t, i_t = t_moe._router(tlp, _t(x, dtype), rcfg.experts_per_token)
        assert w_t.dtype == getattr(torch, dtype)
        assert np.array_equal(i_t.numpy(), np.asarray(i_r))
        _close(w_t, w_r, 1e-4 if dtype == "float32" else 1e-2)


def test_router_ties_keep_the_lower_expert():
    """jax.lax.top_k puts the lower index first among equal logits; so
    must the port (torch.topk leaves that order unspecified)."""
    E, k, d = 8, 3, 4
    router = np.zeros((d, E), np.float32)
    router[0, [1, 5, 6]] = 1.0                   # logits: e1 = e5 = e6 > 0
    router[1, [2, 3]] = -1.0
    x = np.zeros((3, 5, d), np.float32)
    x[0, :, 0] = 1.0                             # three tied leaders
    x[1, :, 1] = 1.0                             # e2, e3 below a tie of six
    x[2, :, 0] = -1.0                            # e1, e5, e6 last
    w_r, i_r = r_moe._router({"router": _j(router)}, _j(x), k)
    w_t, i_t = t_moe._router({"router": _t(router)}, _t(x), k)
    assert np.array_equal(i_t.numpy(), np.asarray(i_r))
    assert i_t[0, 0].tolist() == [1, 5, 6]
    assert i_t[1, 0].tolist() == [0, 1, 4]
    assert i_t[2, 0].tolist() == [0, 2, 3]
    _close(w_t, w_r, 1e-6)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_expert_ffn_matches_jax(qwen3_layer, use_kernels):
    rcfg, _, rlp, tlp, _ = qwen3_layer
    h = np.random.default_rng(4).standard_normal(
        (rcfg.n_experts, 12, rcfg.d_model)).astype(np.float32)
    want = r_moe._expert_ffn(rlp, _j(h))
    got = t_moe._expert_ffn(tlp, _t(h), use_kernels=use_kernels)
    _close(got, want, 1e-4)
    # a slice of the experts, as the parallel routes take them
    want = r_moe._expert_ffn(rlp, _j(h[2:5]), which=slice(2, 5))
    got = t_moe._expert_ffn(tlp, _t(h[2:5]), which=slice(2, 5),
                            use_kernels=use_kernels)
    _close(got, want, 1e-4)


def test_expert_ffn_kernel_route_makes_one_contiguous_input(qwen3_layer,
                                                           monkeypatch):
    """Under use_kernels the experts' matmuls are three ops.gmm calls; the
    broadcast input is made contiguous once and both input projections
    read that one tensor."""
    rcfg, tcfg, _, tlp, x = qwen3_layer
    calls = []
    real = gmm_ops.gmm

    def counted(a, w):
        calls.append((a.data_ptr(), a.is_contiguous(), tuple(a.shape)))
        return real(a, w)

    monkeypatch.setattr(gmm_ops, "gmm", counted)
    t_moe.moe_dense(tlp, _t(x), tcfg.derive(dtype="float32"),
                    use_kernels=True)
    assert len(calls) == 3
    (p_i, c_i, s_i), (p_g, c_g, _), (_, c_o, s_o) = calls
    assert p_i == p_g and c_i and c_g and c_o
    T = x.shape[0] * x.shape[1]
    assert s_i == (rcfg.n_experts, T, rcfg.d_model)
    assert s_o == (rcfg.n_experts, T, rcfg.moe_d_ff)
    calls.clear()
    t_moe.moe_dense(tlp, _t(x), tcfg, use_kernels=False)
    assert not calls


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_matches_jax(qwen3_layer, use_kernels, dtype):
    rcfg, tcfg, rlp, tlp, x = qwen3_layer
    want = r_moe.moe_dense(rlp, _j(x, dtype), rcfg)
    got = t_moe.moe_dense(tlp, _t(x, dtype), tcfg, use_kernels=use_kernels)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "float32":
        _close(got, want, 1e-4)
    else:                   # bf16 expert outputs: one rounding apart
        assert _rel_l2(got, want) < 2e-2


@pytest.mark.parametrize("capacity", ["ample", "dropping"])
def test_dispatch_and_combine_match_jax(qwen3_layer, capacity):
    """The capacity-buffer helpers of the parallel routes, against the
    reference's, and (with ample capacity) against the dense route, as
    tests/test_arch_smoke.py holds the reference's."""
    rcfg, tcfg, rlp, tlp, x = qwen3_layer
    k, E = rcfg.experts_per_token, rcfg.n_experts
    T = x.shape[0] * x.shape[1]
    C = T * k if capacity == "ample" else 3
    w_r, i_r = r_moe._router(rlp, _j(x), k)
    w_t, i_t = t_moe._router(tlp, _t(x), k)
    x2 = x.reshape(T, -1)
    want = r_moe._dispatch(_j(x2), w_r.reshape(T, k), i_r.reshape(T, k), E,
                           C)
    got = t_moe._dispatch(_t(x2), w_t.reshape(T, k), i_t.reshape(T, k), E, C)
    buf, keep, pos, w2 = got
    _close(buf, want[0], 1e-6)
    assert np.array_equal(keep.numpy(), np.asarray(want[1]))
    assert np.array_equal(pos.numpy(), np.asarray(want[2]))
    assert bool(keep.all()) == (capacity == "ample")
    y_r = r_moe._combine(r_moe._expert_ffn(rlp, want[0]), i_r.reshape(T, k),
                         want[2], want[1], want[3])
    y_t = t_moe._combine(t_moe._expert_ffn(tlp, buf), i_t.reshape(T, k),
                         pos, keep, w2)
    _close(y_t, y_r, 1e-4)
    if capacity == "ample":
        _close(y_t.reshape(x.shape), t_moe.moe_dense(tlp, _t(x), tcfg), 2e-4)


def test_moe_apply_takes_the_dense_route_on_one_card(qwen3_layer):
    _, tcfg, _, tlp, x = qwen3_layer
    got = t_moe.moe_apply(tlp, _t(x), cfg=tcfg, policy=TP, mesh=None)
    assert torch.equal(got, t_moe.moe_dense(tlp, _t(x), tcfg))
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_moe.moe_apply(tlp, _t(x), cfg=tcfg, policy=TP, mesh=object())
    # a one-rank (1, 1) gloo mesh: a model axis of 1 takes the dense route
    from repro_torch.launch.mesh import init_host_group, make_host_mesh
    owns = init_host_group(torch.device(CPU))
    try:
        mesh = make_host_mesh(CPU)
        assert t_moe.moe_route(tcfg, mesh) == "dense"
        on_mesh = t_moe.moe_apply(tlp, _t(x), cfg=tcfg, policy=TP, mesh=mesh)
        assert torch.equal(on_mesh, got)
    finally:
        if owns:
            torch.distributed.destroy_process_group()


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module: its
    ``KernelWatch`` holds every model kernel launch against the plain
    version on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gmm_with(fault):
    """A stand-in for the CUDA binding on the CPU: the plain version, or a
    wrong one."""
    from repro_torch.kernels.moe_gmm.ref import gmm_ref

    def gmm(x, w):
        if fault == "zero_expert":
            y = gmm_ref(x, w)
            y[-1] = 0
            return y
        if fault == "short_k":      # the reduction's last 64-deep tile
            return gmm_ref(x[..., :-64], w[:, :-64])
        return gmm_ref(x, w)
    return gmm


@pytest.mark.parametrize("fault", [None, "zero_expert", "short_k"])
def test_chip_smoke_gmm_check_fails_a_wrong_kernel(monkeypatch, fault):
    """chip_smoke's launch-by-launch check of gmm at qwen3-moe's expert
    width (D = 2048 -> F = 768, weights scaled by 1/sqrt(D) as a model's
    are, so the products' RMS is about 1), bf16: the plain version passes,
    and a kernel that drops an expert or the last tile of its reduction
    fails."""
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    E, C, D, F = 4, 256, 2048, 768
    x = _t(rng.standard_normal((E, C, D)), "bfloat16")
    w = _t(rng.standard_normal((E, D, F)) * D ** -0.5, "bfloat16")
    monkeypatch.setattr(gmm_kernel, "gmm", _gmm_with(fault))
    watch = cs.KernelWatch(check=True)
    try:
        if fault is None:
            gmm_kernel.gmm(x, w)
            assert watch.checked["gmm"][0] == 1
        else:
            with pytest.raises(AssertionError, match="gmm launch 0"):
                gmm_kernel.gmm(x, w)
    finally:
        watch.restore()


# ---------------------------------------------------------------------------
# the moe family's forward, cache and engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, use_kernels):
    rcfg, tcfg, rp, tp = _model(arch)
    tok = np.random.default_rng(11).integers(0, 256, (2, 32)).astype(
        np.int32)
    want, _ = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                        policy=RP, use_pallas=use_kernels)
    got, cache = forward(tp, {"tokens": tok}, cfg=tcfg, device=CPU,
                         use_kernels=use_kernels)
    assert cache is None and got.dtype == torch.float32
    _close(got, want, 1e-3)


def _zero_cache(cfg, B, S_max):
    """The serving engine's cache dtypes: bf16 at rank >= 3, else fp32."""
    return jax.tree.map(lambda s: jnp.zeros(
        s.shape, jnp.bfloat16 if len(s.shape) >= 3 else jnp.float32),
        r_cache_specs(cfg, B, S_max), is_leaf=lambda x: isinstance(x, RSpec))


def test_qwen3_prefill_then_decode_matches_jax():
    """A cache-filling prefill through the kernels' plain versions, then
    two decode steps, in fp32: logits and every cache leaf."""
    rcfg, tcfg, rp, tp = _model("qwen3_moe_30b_a3b", seed=1)
    tok = np.random.default_rng(12).integers(0, 256, (2, 20)).astype(
        np.int32)
    rc = _zero_cache(rcfg, 2, 32)
    tc = _carry(rc)
    want, rc = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                         policy=RP, cache=rc, use_pallas=True)
    got, tc = forward(tp, {"tokens": tok}, cfg=tcfg, cache=tc, device=CPU,
                      use_kernels=True)
    _close(got, want, 1e-3)
    for step in range(2):
        nxt = np.asarray(want[:, -1].argmax(-1), np.int32)[:, None]
        assert np.array_equal(nxt[:, 0], got[:, -1].argmax(-1).numpy())
        for k in rc:
            assert str(tc[k].dtype).split(".")[1] == str(rc[k].dtype)
            _close(tc[k], rc[k], 2e-2, 1e-2)
        want, rc = r_forward(rp, {"tokens": jnp.asarray(nxt)}, cfg=rcfg,
                             policy=RP, cache=rc,
                             cache_index=jnp.int32(20 + step))
        got, tc = forward(tp, {"tokens": nxt}, cfg=tcfg, cache=tc,
                          device=CPU, cache_index=20 + step)
        _close(got, want, 1e-3)


def test_qwen3_bf16_forward_within_the_noise_of_jax():
    """The port's kernel path in bf16 is no further from JAX's Pallas
    path than JAX's own bf16 logits are from its fp32 ones (times 1.5)."""
    rcfg, tcfg, rp, tp = _model("qwen3_moe_30b_a3b", dtype="bfloat16")
    tok = np.random.default_rng(13).integers(0, 256, (2, 32)).astype(
        np.int32)
    want, _ = r_forward(rp, {"tokens": jnp.asarray(tok)}, cfg=rcfg,
                        policy=RP, use_pallas=True)
    fp32, _ = r_forward(rp, {"tokens": jnp.asarray(tok)},
                        cfg=rcfg.derive(dtype="float32"), policy=RP)
    got, _ = forward(tp, {"tokens": tok}, cfg=tcfg, device=CPU,
                     use_kernels=True)
    noise = _rel_l2(want, fp32)
    assert np.isfinite(_np(got)).all() and got.shape == (2, 32, 256)
    assert _rel_l2(got, want) <= 1.5 * noise, (_rel_l2(got, want), noise)


def test_qwen3_serve_engine_matches_jax():
    """fp32 smoke config, two requests in two slots: equal tokens in both
    packages (the reference's every-slot cache writes included)."""
    rcfg, tcfg, rp, tp = _model("qwen3_moe_30b_a3b", seed=2)
    prompts = ([5, 17, 3, 99, 42], [2, 3])
    runs = []
    for cls, req, cfg, params, kw in ((REngine, RRequest, rcfg, rp, {}),
                                      (ServeEngine, Request, tcfg, tp,
                                       {"device": CPU})):
        eng = cls(cfg, params, max_batch=2, max_seq=32, **kw)
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=np.asarray(p, np.int32), max_new=5))
        runs.append({r.rid: list(r.generated) for r in eng.run(max_iters=32)})
    assert runs[1] == runs[0] and sorted(runs[0]) == [0, 1]
