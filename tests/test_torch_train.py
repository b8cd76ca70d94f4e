"""The port's training path against the JAX package, on the CPU: the loss,
its gradients, AdamW, the train step (microbatched, with compressed
gradients, under each ``remat`` policy), the SSD scan's backward, the
abstract parameter and axes trees, and the trainer's entry point.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``; the JAX package's parameters carry across with
``params_from_numpy``, and its Pallas kernels run in interpret mode, as
its own tests run them.  Smoke configurations, fp32.

Tolerances:
- the loss: rtol 1e-5 (fp32 logits of the smoke models agree to about
  1e-6 relative: the two frameworks sum in other orders);
- gradients: atol 1e-5 + rtol 1e-3 of each leaf's largest element
  (a leaf's entries are sums over the batch and sequence, rounded in
  another order in each framework);
- ``adamw_update`` on identical inputs: atol 1e-6 (the same formula; the
  frameworks may fuse a multiply-add where the other rounds twice);
- two train steps: the losses rtol 1e-5; the parameters atol
  ``STEP_ATOL`` = 1e-5 at lr = 1e-3 with AdamW's eps = 1e-3 (``OPT``).
  The first AdamW step moves each parameter by
  ``lr * g / (|g| + eps)``, about ``lr * sign(g)``: at the default eps
  of 1e-8 a gradient within rounding of zero (a key bias's, which
  softmax cannot see, is all rounding) steps by up to ``lr`` either way
  in either framework, so the parameters could differ by ``2 * lr``
  whatever the port computes.  With eps = 1e-3 a gradient error ``e``
  moves its parameter by at most ``lr * e / eps``: about 1e-6 for the
  smoke models' fp32 gradient errors, and the atol leaves a factor of
  about 5;
- the remat policies against no remat: exact (the same operations,
  recomputed); ``microbatches=2`` against ``microbatches=1``: rtol 1e-6
  on the loss, ``STEP_ATOL`` on the parameters.

The reference's loss, gradients and steps run under ``jax.jit`` (a
quarter of the time of its eager calls here).
"""
import functools
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.kernels.mamba2_ssd import ops as r_ssd_ops
from repro.models import abstract_params as r_abstract
from repro.models import axes_tree as r_axes
from repro.models import init_cache_specs as r_cache_specs
from repro.models import loss_fn as r_loss
from repro.models import param_specs as r_param_specs
from repro.models.params import ParamSpec as RSpec
from repro.parallel.sharding import MeshPolicy as RPolicy
from repro.train.optimizer import OptConfig as ROpt
from repro.train.optimizer import adamw_init as r_adamw_init
from repro.train.optimizer import adamw_update as r_adamw_update
from repro.train.optimizer import lr_at as r_lr_at
from repro.train.step import decode_step_fn as r_decode
from repro.train.step import prefill_step_fn as r_prefill
from repro.train.step import train_step_fn as r_train_step

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.launch import train as launcher
from repro_torch.models import (abstract_params, axes_tree, forward,
                                init_cache_specs, loss_fn, param_specs,
                                params_from_numpy)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.parallel.sharding import MeshPolicy
from repro_torch.train import (OptConfig, adamw_init, adamw_update,
                               make_train_step, train_step_fn)
from repro_torch.train.optimizer import lr_at
from repro_torch.train.step import decode_step_fn, prefill_step_fn

CPU = "cpu"
RP, TP = RPolicy(), MeshPolicy()
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
ADAMW_ATOL = 1e-6
STEP_ATOL = 1e-5
#: one smoke configuration a family
FAMILIES = {"dense": "qwen1_5_4b", "moe": "qwen3_moe_30b_a3b",
            "hybrid": "zamba2_2_7b", "ssm": "rwkv6_3b",
            "encdec": "seamless_m4t_medium"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _np_init(specs, seed):
    """The reference's ``init_params`` law (zeros, ones, or normal over
    sqrt(fan_in) times the spec's scale), drawn by numpy: JAX's eager
    random calls compile per shape and would take most of this file's
    time."""
    rng = np.random.default_rng(seed)

    def make(s):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, s.init == "ones", np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * s.scale
                / np.sqrt(max(1, fan_in))).astype(np.float32)
    return jax.tree.map(make, specs, is_leaf=lambda x: hasattr(x, "init"))


def _model(arch, seed=0, **derive):
    rcfg = r_smoke(arch).derive(dtype="float32", **derive)
    tcfg = get_smoke_config(arch).derive(dtype="float32", **derive)
    params = _np_init(r_param_specs(rcfg), seed)
    return rcfg, tcfg, jax.tree.map(jnp.asarray, params), \
        params_from_numpy(params, CPU)


def _batch(cfg, B=2, S=16, seed=0):
    """Tokens, next-token labels with a few masked (-1), and the family's
    extra inputs (numpy)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    b = {"tokens": tok, "labels": labels}
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


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _paths(tree, prefix=""):
    """{key path: leaf} of a nested dict (JAX or torch)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close_trees(got, want, atol, rtol=0.0, scaled=False):
    g, w = _paths(got), _paths(want)
    assert set(g) == set(w)
    for k in w:
        wa = _np(w[k])
        tol = atol + (rtol * float(np.abs(wa).max()) if scaled else 0.0)
        np.testing.assert_allclose(_np(g[k]), wa, atol=tol,
                                   rtol=0.0 if scaled else rtol,
                                   err_msg=k)


def _grads(params, batch, cfg, use_kernels=False):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    diff = tree_map(lambda _: next(it), params)
    loss = loss_fn(diff, _tb(batch), cfg=cfg, use_kernels=use_kernels,
                   device=CPU)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


# ---------------------------------------------------------------------------
# the loss and its gradients, all ten architectures
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, use_kernels):
    """The reference's loss and ``jax.grad`` on ``_batch(seed=1)``, once
    an architecture and path (the loss test and the plain gradient test
    share one compile)."""
    rcfg, _, rp, _ = _model(arch)
    batch = _batch(rcfg, seed=1)
    return jax.jit(jax.value_and_grad(
        lambda p, b: r_loss(p, b, cfg=rcfg, policy=RP,
                            use_pallas=use_kernels)))(rp, _jb(batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    """Masked labels included; the port's gather form of the gold logit
    equals the reference's one-hot sum on the same logits."""
    _, tcfg, _, tp = _model(arch)
    batch = _batch(tcfg, seed=1)
    want = float(_jax_loss_and_grads(arch, False)[0])
    got = loss_fn(tp, _tb(batch), cfg=tcfg, device=CPU)
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    logits, _ = forward(tp, _tb(batch), cfg=tcfg, device=CPU)
    labels = torch.from_numpy(batch["labels"]).long()
    lf = logits.float()
    onehot = torch.where(torch.arange(lf.shape[-1]) == labels[..., None],
                         lf, 0.0).sum(-1)
    gather = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = labels >= 0
    assert torch.equal(onehot[mask], gather[mask])
    assert torch.equal(onehot[~mask], torch.zeros_like(onehot[~mask]))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_jax(arch, use_kernels):
    """``torch.autograd.grad`` of the port's loss against ``jax.grad`` of
    the reference's, with the kernels' plain versions (and their
    Functions' backwards) or without; the JAX side's Pallas kernels in
    interpret mode."""
    _, tcfg, _, tp = _model(arch)
    batch = _batch(tcfg, seed=1)
    want_l, want_g = _jax_loss_and_grads(arch, use_kernels)
    got_l, got_g = _grads(tp, batch, tcfg, use_kernels)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=LOSS_RTOL)
    _close_trees(got_g, want_g, GRAD_ATOL, GRAD_RTOL, scaled=True)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    c = dict(lr=1e-2, warmup_steps=3, total_steps=10)
    for step in range(14):
        np.testing.assert_allclose(
            float(lr_at(OptConfig(**c), torch.tensor(step, dtype=torch.int32))),
            float(r_lr_at(ROpt(**c), jnp.int32(step))), rtol=1e-6)


def test_adamw_update_matches_jax():
    """Six steps on identical inputs: the first two in warmup, the rest
    down the cosine; the gradients' norm above the clip at every step.
    The port updates the trees in place and returns them."""
    rng = np.random.default_rng(3)
    shapes = {"a": {"w": (4, 5), "b": (5,)}, "z": (3, 2, 2)}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    c = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_adamw_init(rp)
    tp = params_from_numpy(params, CPU)
    ts = adamw_init(tp)
    for step in range(6):
        g = jax.tree.map(lambda a: 3.0 * rng.standard_normal(
            a.shape).astype(np.float32), params)
        rp, rs = r_adamw_update(ROpt(**c), rp, jax.tree.map(jnp.asarray, g),
                                rs)
        tp2, ts2 = adamw_update(OptConfig(**c), tp, params_from_numpy(
            g, CPU), ts)
        assert tp2 is tp and ts2 is ts
        _close_trees(tp, rp, ADAMW_ATOL)
        _close_trees(ts["mu"], rs["mu"], ADAMW_ATOL)
        _close_trees(ts["nu"], rs["nu"], ADAMW_ATOL)
        assert int(ts["step"]) == int(rs["step"]) == step + 1


def test_adamw_casts_a_bf16_parameter_back():
    p = {"w": torch.linspace(-1, 1, 8).to(torch.bfloat16)}
    s = adamw_init(p)
    adamw_update(OptConfig(lr=1e-2, warmup_steps=0), p,
                 {"w": torch.ones(8)}, s)
    assert p["w"].dtype == torch.bfloat16 and s["mu"]["w"].dtype == \
        torch.float32
    rp = {"w": jnp.linspace(-1, 1, 8).astype(jnp.bfloat16)}
    want, _ = r_adamw_update(ROpt(lr=1e-2, warmup_steps=0), rp,
                             {"w": jnp.ones(8)}, r_adamw_init(rp))
    np.testing.assert_array_equal(_np(p["w"]), _np(want["w"]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=4, eps=1e-3)


def _r_step(rcfg, microbatches=1):
    return jax.jit(lambda p, s, b: r_train_step(
        p, s, b, cfg=rcfg, policy=RP, opt=ROpt(**OPT),
        microbatches=microbatches))


def _two_steps(arch, microbatches=1, B=2, **derive):
    rcfg, tcfg, rp, tp = _model(arch, **derive)
    rs, ts = r_adamw_init(rp), adamw_init(tp)
    r_step = _r_step(rcfg, microbatches)
    losses = []
    for i in range(2):
        batch = _batch(tcfg, B=B, seed=10 + i)
        rp, rs, rl = r_step(rp, rs, _jb(batch))
        tp, ts, tl = train_step_fn(tp, ts, _tb(batch), cfg=tcfg, policy=TP,
                                   opt=OptConfig(**OPT),
                                   microbatches=microbatches, device=CPU)
        losses.append((float(tl), float(rl)))
    return losses, (tp, ts), (rp, rs)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_train_steps_match_jax(family):
    losses, (tp, ts), (rp, rs) = _two_steps(FAMILIES[family])
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _close_trees(tp, rp, STEP_ATOL)
    assert int(ts["step"]) == int(rs["step"]) == 2


def test_microbatches_match_one_batch_and_jax():
    """``microbatches=2`` against ``microbatches=1`` (the reference's
    ``test_microbatched_grad_accumulation_matches``, here with masked
    labels: the halves' means differ from the whole's, so the loss agrees
    to the label counts' imbalance) and against the reference's
    ``microbatches=2``."""
    arch = "qwen1_5_4b"
    losses, (tp, ts), (rp, rs) = _two_steps(arch, microbatches=2, B=4)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _close_trees(tp, rp, STEP_ATOL)
    _, tcfg, _, p1 = _model(arch)
    p2 = tree_map(torch.clone, p1)
    batch = _tb(_batch(tcfg, B=4, seed=10))
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    out = []
    for p, mb in ((p1, 1), (p2, 2)):
        _, _, loss = train_step_fn(p, adamw_init(p), batch, cfg=tcfg,
                                   policy=TP, opt=OptConfig(**OPT),
                                   microbatches=mb, device=CPU)
        out.append(float(loss))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-6)
    _close_trees(p2, p1, STEP_ATOL)


def test_grad_compress_matches_jax():
    losses, (tp, _), (rp, _) = _two_steps("qwen1_5_4b", grad_compress=True)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _close_trees(tp, rp, STEP_ATOL)


def test_train_step_updates_in_place():
    _, tcfg, _, tp = _model("qwen1_5_4b")
    ts = adamw_init(tp)
    before = {k: (v.data_ptr(), v.clone()) for k, v in _paths(tp).items()}
    step = make_train_step(tcfg, TP, opt=OptConfig(**OPT), device=CPU)
    p2, s2, loss = step(tp, ts, _tb(_batch(tcfg)))
    assert p2 is tp and s2 is ts and loss.requires_grad is False
    for k, v in _paths(tp).items():
        assert v.data_ptr() == before[k][0] and not v.requires_grad
    assert any(not torch.equal(v, before[k][1])
               for k, v in _paths(tp).items())


def test_prefill_and_decode_steps_match_jax():
    """A cache-filling prefill of 16 tokens, then one decode step, fp32:
    atol 1e-4, rtol 1e-4 (``tests/test_torch_decoder.py``'s logits)."""
    rcfg, tcfg, rp, tp = _model("qwen1_5_4b")
    batch = {"tokens": _batch(tcfg)["tokens"]}
    rc = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                      r_cache_specs(rcfg, 2, 24),
                      is_leaf=lambda x: isinstance(x, RSpec))
    tc = tree_map(lambda s: torch.zeros(s.shape), init_cache_specs(
        tcfg, 2, 24))
    want, wc = r_prefill(rp, _jb(batch), rc, cfg=rcfg, policy=RP)
    got, gc = prefill_step_fn(tp, _tb(batch), tc, cfg=tcfg, policy=TP,
                              device=CPU)
    assert got.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    _close_trees(gc, wc, 1e-4, 1e-4)
    nxt = {"tokens": np.argmax(_np(got), -1).astype(np.int32)}
    want, _ = r_decode(rp, _jb(nxt), wc, jnp.int32(16), cfg=rcfg,
                       policy=RP)
    got, _ = decode_step_fn(tp, _tb(nxt), gc, 16, cfg=tcfg, policy=TP,
                            device=CPU)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# remat and the stacked parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "selective"])
@pytest.mark.parametrize("arch", ["qwen1_5_4b", "qwen3_moe_30b_a3b"])
def test_remat_gradients_equal(arch, remat):
    """The same loss and gradients, bit for bit, as without remat."""
    _, tcfg, _, tp = _model(arch)
    batch = _batch(tcfg, seed=4)
    want_l, want_g = _grads(tp, batch, tcfg)
    got_l, got_g = _grads(tp, batch, tcfg.derive(remat=remat))
    assert torch.equal(got_l, want_l)
    for k, w in _paths(want_g).items():
        assert torch.equal(_paths(got_g)[k], w), k


def _saved_bytes(cfg, params, batch):
    """Bytes autograd saves for the backward, as the outermost
    ``saved_tensors_hooks`` sees them (a checkpointed layer's own saves
    are its hooks' business, not these)."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    diff = tree_map(lambda _: next(it), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_fn(diff, _tb(batch), cfg=cfg, device=CPU)
    torch.autograd.grad(loss, leaves, allow_unused=True)
    return sum(saved)


def test_full_remat_saves_fewer_bytes():
    _, tcfg, _, tp = _model("qwen1_5_4b", n_layers=4)
    batch = _batch(tcfg, S=32)
    none = _saved_bytes(tcfg, tp, batch)
    sel = _saved_bytes(tcfg.derive(remat="selective"), tp, batch)
    full = _saved_bytes(tcfg.derive(remat="full"), tp, batch)
    assert full < none and sel < none, (none, sel, full)


def _leaf_selects(loss):
    """The ``select`` nodes of the backward of ``loss`` that read a leaf
    (a parameter) directly."""
    seen, todo, found = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if fn.name() == "SelectBackward0" and any(
                f is not None and f.name() == "torch::autograd::"
                "AccumulateGrad" for f, _ in fn.next_functions):
            found.append(tuple(fn._saved_self_sym_sizes))
        todo.extend(f for f, _ in fn.next_functions)
    return found


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "qwen3_moe_30b_a3b",
                                  "zamba2_2_7b", "rwkv6_3b",
                                  "seamless_m4t_medium"])
def test_backward_runs_no_select_backward(arch):
    """The stacked parameters are unbound once a forward: the backward
    stacks each leaf's layer gradients once and never zero-fills a
    ``[L, ...]`` gradient a layer.  The dense stack runs no
    ``aten::select_backward`` at all; the other families' layers still
    index their own per-layer weights (conv taps, RWKV's mixing rows) and
    their activations, never a stacked leaf."""
    _, tcfg, _, tp = _model(arch)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    it = iter(leaves)
    diff = tree_map(lambda _: next(it), tp)
    loss = loss_fn(diff, _tb(_batch(tcfg)), cfg=tcfg, device=CPU)
    assert _leaf_selects(loss) == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(loss, leaves, allow_unused=True)
    names = {e.key for e in prof.key_averages()}
    assert "aten::stack" in names
    if tcfg.family == "dense":
        assert "aten::select_backward" not in names


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, with_h0):
    rng = np.random.default_rng(seed)
    B, S, H, hd, N = 1, 24, 2, 4, 8
    ins = [rng.standard_normal((B, S, H, hd)).astype(np.float32),
           np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
               np.float32),
           -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32),
           rng.standard_normal((B, S, N)).astype(np.float32),
           rng.standard_normal((B, S, N)).astype(np.float32)]
    h0 = rng.standard_normal((B, H, hd, N)).astype(np.float32) \
        if with_h0 else None
    gy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    gh = rng.standard_normal((B, H, hd, N)).astype(np.float32)
    return ins, h0, gy, gh


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_function_gradients(with_h0):
    """The Function's gradients of (y, h) against autograd through
    ``ref.ssd_ref`` (the same recompute: equal) and against ``jax.grad``
    of the reference's ``ops.ssd`` (its kernel in interpret mode, or its
    oracle with ``h0``)."""
    ins, h0, gy, gh = _ssd_inputs(5, with_h0)
    chunk = 8
    arrays = ins + ([h0] if with_h0 else [])

    def run(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        y, h = fn(*ts[:5], h0=ts[5] if with_h0 else None, chunk=chunk)
        return torch.autograd.grad((y, h), ts, (torch.from_numpy(gy),
                                                torch.from_numpy(gh)))

    got = run(ssd_ops.ssd)
    plain = run(ssd_ref.ssd_ref)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)

    def r_out(*a):
        y, h = r_ssd_ops.ssd(*a[:5], h0=a[5] if with_h0 else None,
                             chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(r_out, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# abstract parameters and their axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_axes_match_jax(arch):
    specs, r_specs = param_specs(get_smoke_config(arch)), \
        r_param_specs(r_smoke(arch))
    abs_t = _paths(abstract_params(specs))
    abs_r = _paths(r_abstract(r_specs))
    assert set(abs_t) == set(abs_r)
    for k, a in abs_t.items():
        assert a.device.type == "meta" and a.dtype == torch.float32
        assert tuple(a.shape) == tuple(abs_r[k].shape)
        assert str(abs_r[k].dtype) == "float32"
    ax_t = _paths(axes_tree(specs))
    ax_r = jax.tree_util.tree_flatten_with_path(
        r_axes(r_specs), is_leaf=lambda x: isinstance(x, tuple))[0]
    ax_r = {"".join(f"/{p.key}" for p in path): v for path, v in ax_r}
    assert ax_t == ax_r


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _train(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        launcher.main(list(argv))
    return out.getvalue()


def test_trainer_checkpoints_and_resumes(tmp_path):
    common = ["--smoke", "--batch", "2", "--seq", "16", "--ckpt-every",
              "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = _train("--steps", "4", *common)
    assert "checkpointed step 4" in first
    assert first.strip().endswith("ledger last step = 3")
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step-00000002", "step-00000004"]
    second = _train("--steps", "6", "--resume", *common)
    assert "resumed from step 4" in second
    assert "done: 2 steps" in second
    assert second.strip().endswith("ledger last step = 5")


def test_trainer_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _train("--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path))
