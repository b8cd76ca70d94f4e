"""The port's decoder families (dense, vlm, encdec) against the JAX
package, on the CPU, and the parameter and cache trees of all ten
architectures.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``: the smoke forwards of qwen1.5, gemma3, command-r,
nemotron, qwen2-vl (with patch embeddings and M-RoPE positions) and
seamless (with encoder frames), with and without the kernels' plain
versions (the JAX side's Pallas kernels in interpret mode); cache-filling
prefills with two decode steps; the bf16 forward; the serving engine; and
gemma3's sliding-window fault under the kernels, pinned in both packages.
The JAX package's parameters carry across with ``params_from_numpy``.

Tolerances (``tests/test_torch_models.py``'s): fp32 logits of the smoke
models and their fp32 cache leaves (as the zamba2 test's) atol 1e-3,
rtol 1e-3; the bf16 forward no further from JAX's bf16 logits than JAX's
own bf16 logits are from its fp32 ones, times 1.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.models import forward as r_forward
from repro.models import init_cache_specs as r_cache_specs
from repro.models import init_params as r_init
from repro.models import param_specs as r_param_specs
from repro.models.params import ParamSpec as RSpec
from repro.parallel.sharding import MeshPolicy as RPolicy
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import (count_params, forward, init_cache_specs,
                                layer_flags, param_specs, params_from_numpy)
from repro_torch.serve import Request, ServeEngine

CPU = "cpu"
RP = RPolicy()
DECODER_ARCHS = ("qwen1_5_4b", "gemma3_12b", "command_r_plus_104b",
                 "nemotron_4_340b", "qwen2_vl_7b", "seamless_m4t_medium")


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


def _model(arch, dtype="float32", seed=0, **derive):
    rcfg = r_smoke(arch).derive(dtype=dtype, **derive)
    tcfg = get_smoke_config(arch).derive(dtype=dtype, **derive)
    rp = r_init(r_param_specs(rcfg), jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, _carry(rp)


def _batch(cfg, B, S, seed):
    """Tokens, and the family's extra inputs: vlm's patch embeddings and
    M-RoPE positions, encdec's encoder frames (numpy, fp32)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        b["positions"] = rng.integers(0, 3 * S, (B, S, 3)).astype(np.int32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# parameter and cache trees, all ten architectures
# ---------------------------------------------------------------------------

def _flat(tree, is_leaf):
    return jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda s: (tuple(s.shape), s.axes, s.init, s.scale),
                     tree, is_leaf=is_leaf),
        is_leaf=lambda x: isinstance(x, tuple))[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_jax(arch):
    """The same keys and the same (shape, axes, init, scale) per key path,
    for the smoke and the full configuration."""
    t_leaf = lambda x: hasattr(x, "axes")          # noqa: E731
    r_leaf = lambda x: isinstance(x, RSpec)        # noqa: E731
    for t_cfg, r_cfg in ((get_smoke_config(arch), r_smoke(arch)),
                         (get_config(arch), r_get_config(arch))):
        assert t_cfg == type(t_cfg)(**r_cfg.__dict__)
        for t_tree, r_tree in ((param_specs(t_cfg), r_param_specs(r_cfg)),
                               (init_cache_specs(t_cfg, 3, 40),
                                r_cache_specs(r_cfg, 3, 40))):
            assert _flat(t_tree, t_leaf) == _flat(r_tree, r_leaf)
        assert count_params(param_specs(t_cfg)) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(
                r_param_specs(r_cfg), is_leaf=r_leaf))


# ---------------------------------------------------------------------------
# forward, cache, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_forward_fp32_matches_jax(arch, use_kernels):
    rcfg, tcfg, rp, tp = _model(arch)
    batch = _batch(tcfg, 2, 32, seed=11)
    want, _ = r_forward(rp, _jb(batch), cfg=rcfg, policy=RP,
                        use_pallas=use_kernels)
    got, cache = forward(tp, batch, cfg=tcfg, device=CPU,
                         use_kernels=use_kernels)
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 32, tcfg.vocab_size)
    _close(got, want, 1e-3)


def _zero_cache(cfg, B, S_max):
    """fp32 zeros: the comparison stays fp32's.  (In the engine's bf16
    cache one ulp of a rounded encoder output or key, flipped by an fp32
    difference of 1e-7, moves a smoke logit by ~2e-3; the engine tests
    take that path.)"""
    return jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                        r_cache_specs(cfg, B, S_max),
                        is_leaf=lambda x: isinstance(x, RSpec))


@pytest.mark.parametrize("arch", ["gemma3_12b", "seamless_m4t_medium",
                                  "qwen2_vl_7b"])
def test_prefill_then_decode_matches_jax(arch):
    """A cache-filling prefill through the kernels' plain versions, then
    two decode steps (seamless reads the cached encoder output; qwen2-vl
    takes its default M-RoPE positions): logits and every cache leaf."""
    rcfg, tcfg, rp, tp = _model(arch, seed=1)
    batch = _batch(tcfg, 2, 24, seed=12)
    batch.pop("positions", None)
    rc = _zero_cache(rcfg, 2, 32)
    tc = _carry(rc)
    want, rc = r_forward(rp, _jb(batch), cfg=rcfg, policy=RP, cache=rc,
                         use_pallas=True)
    got, tc = forward(tp, batch, cfg=tcfg, cache=tc, device=CPU,
                      use_kernels=True)
    _close(got, want, 1e-3)
    for step in range(2):
        nxt = np.asarray(want[:, -1].argmax(-1), np.int32)[:, None]
        assert np.array_equal(nxt[:, 0], got[:, -1].argmax(-1).numpy())
        assert sorted(tc) == sorted(rc)
        for k in rc:
            assert tc[k].dtype == torch.float32
            _close(tc[k], rc[k], 1e-3)
        want, rc = r_forward(rp, {"tokens": jnp.asarray(nxt)}, cfg=rcfg,
                             policy=RP, cache=rc,
                             cache_index=jnp.int32(24 + step))
        got, tc = forward(tp, {"tokens": nxt}, cfg=tcfg, cache=tc,
                          device=CPU, cache_index=24 + step)
        _close(got, want, 1e-3)


@pytest.mark.parametrize("arch", ["gemma3_12b", "seamless_m4t_medium"])
def test_forward_bf16_within_the_noise_of_jax(arch):
    """bf16 rounds at other places in the two frameworks; the port's
    kernel path must be no further from JAX's Pallas path than JAX's own
    bf16 logits are from its fp32 ones (times 1.5)."""
    rcfg, tcfg, rp, tp = _model(arch, dtype="bfloat16")
    batch = _batch(tcfg, 2, 32, seed=13)
    want, _ = r_forward(rp, _jb(batch), cfg=rcfg, policy=RP,
                        use_pallas=True)
    fp32, _ = r_forward(rp, _jb(batch), cfg=rcfg.derive(dtype="float32"),
                        policy=RP)
    got, _ = forward(tp, batch, cfg=tcfg, device=CPU, use_kernels=True)
    noise = _rel_l2(want, fp32)
    assert np.isfinite(_np(got)).all() and got.shape == (2, 32, 256)
    assert _rel_l2(got, want) <= 1.5 * noise, (_rel_l2(got, want), noise)


def test_gemma3_serve_engine_matches_jax():
    """fp32 smoke config, two requests in two slots: equal tokens in both
    packages (the reference's every-slot cache writes included)."""
    rcfg, tcfg, rp, tp = _model("gemma3_12b", seed=2)
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


def test_gemma3_global_layers_take_the_window_under_kernels():
    """A reference fault kept by the port (ROADMAP.md queue 3): with the
    kernels, gemma3's global layers get the sliding window, because
    ``attention_block`` drops the window only for a literal
    ``is_global is True`` and ``_decoder_stack`` passes each layer's flag
    as an array.  Past the window (S = 32, window 16) both packages'
    kernel paths agree with each other and differ from their plain paths,
    which honour the flag; within the window (S = 16) all four agree."""
    rcfg, tcfg, rp, tp = _model("gemma3_12b", seed=4)
    assert tcfg.sliding_window == 16
    assert list(np.flatnonzero(layer_flags(tcfg))) == [1, 3]
    for S, fault_shows in ((32, True), (16, False)):
        batch = _batch(tcfg, 2, S, seed=14)
        logits = {}
        for kern in (False, True):
            logits["jax", kern] = r_forward(rp, _jb(batch), cfg=rcfg,
                                            policy=RP, use_pallas=kern)[0]
            logits["port", kern] = forward(tp, batch, cfg=tcfg, device=CPU,
                                           use_kernels=kern)[0]
        for kern in (False, True):
            _close(logits["port", kern], logits["jax", kern], 1e-3)
        for pkg in ("jax", "port"):
            gap = float(np.abs(_np(logits[pkg, True])
                               - _np(logits[pkg, False])).max())
            assert (gap > 1e-2) == fault_shows, (pkg, S, gap)
