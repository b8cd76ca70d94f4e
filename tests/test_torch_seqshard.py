"""Sequence-sharded KV caches (``seq_shard``: `kv_seq` over `data`) and
the donated serving caches in the port, against the JAX package, on the
CPU.

The long_500k cells (B = 1) split their KV caches along the sequence over
`data`: rank ``r`` holds rows ``[r * S_loc, (r + 1) * S_loc)``, a decode
writes the new row on the rank that holds it and combines the ranks'
partial softmaxes (``models.layers._sdpa_over_shards``), and the batch is
replicated over `data`.  Here the smoke gemma3 (window 16, local and
global layers), mixtral (window 16, the MoE tensor-parallel route) and
zamba2 (the shared attention block) run in fp32 with B = 1 and
``S_MAX = 64``: a prefill of 12 tokens through ``prefill_step_fn``, then
``decode_step_fn`` at indexes 15, 16 and 63, so that whole shards fall
outside the window and a write crosses a shard boundary.  The port runs
on 4 gloo ranks (``launch.mesh.spawn_ranks``) on a ``(4, 1)`` mesh (16
rows a rank), and mixtral also on ``(2, 2)`` (32 rows a rank, heads and
expert MLP over `model`); a ``(1, 1)`` mesh under the same policy is held
bitwise to ``mesh=None``.  The JAX side runs the reference's
``prefill_step_fn``/``decode_step_fn`` under ``jax.jit`` with the
seq_shard policy's shardings (the cache's `kv_seq` over `data`, the
batch replicated, the cache donated) on a ``(4, 1)`` mesh, in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.

Held: the logits within SERVE_TOL (``tests/test_torch_tp.py``'s serving
tolerance) of the reference's and within ATOL/RTOL of the port's own
whole-cache steps without a mesh; every rank's gathered logits bitwise
alike; the gathered cache against the whole-cache run's: bitwise in every
row the decode steps did not write and in the decode rows of the first
attention layer (computed from the same inputs), within ATOL/RTOL in the
rest (their inputs passed the combined softmax, which rounds apart from
``_sdpa``'s single softmax).  The spawned ranks import this module, so it
imports ``repro`` (and JAX) only in the subprocess.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import init_cache_specs, param_specs
from repro_torch.models.params import ParamSpec, tree_map
from repro_torch.parallel.sharding import MeshPolicy

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
ATOL, RTOL = 2e-4, 1e-4
SERVE_TOL = 1e-3
TIMEOUT = 120
ARCHS = ("gemma3_12b", "mixtral_8x22b", "zamba2_2_7b")
#: name -> (mesh shape over ("data", "model"), archs)
MESHES = {"seq": ((4, 1), ARCHS), "seq_tp": ((2, 2), ("mixtral_8x22b",)),
          "one": ((1, 1), ARCHS)}
B, S_MAX, PREFILL = 1, 64, 12
STEPS = (15, 16, 63)
KV_KEYS = ("k", "v", "shared_k", "shared_v")


def _cfg(arch):
    cfg = get_smoke_config(arch).derive(dtype="float32")
    if cfg.is_moe:
        cfg = cfg.derive(capacity_factor=cfg.n_experts /
                         cfg.experts_per_token)
    return cfg


def _policy(arch):
    """``launch.inputs.cell_policy``'s for a long_500k cell: the batch
    replicated, the KV caches' sequence over `data`."""
    rules = (("batch", None),)
    if arch == "mixtral_8x22b":
        rules += (("experts", None), ("expert_mlp", "model"))
    return MeshPolicy(seq_shard=True, rules=rules)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat, prefix=""):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _weights(cfg, rng):
    """The parameters by the specs' laws, drawn by numpy."""
    def draw(s: ParamSpec):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, s.init == "ones", np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * s.scale
                / np.sqrt(max(1, fan_in))).astype(np.float32)
    return tree_map(draw, param_specs(cfg))


def _inputs(d):
    arrays = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        rng = np.random.default_rng(300 + i)
        for k, v in _flat(_weights(cfg, rng)).items():
            arrays[f"{arch}/p/{k}"] = v
        arrays[f"{arch}/prompt"] = rng.integers(
            0, cfg.vocab_size, (B, PREFILL)).astype(np.int32)
        arrays[f"{arch}/next"] = rng.integers(
            0, cfg.vocab_size, (len(STEPS), B, 1)).astype(np.int32)
    np.savez(d / "inputs.npz", **arrays)


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, %r)
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.models import init_cache_specs
    from repro.models.params import ParamSpec, axes_tree
    from repro.parallel.sharding import MeshPolicy, param_pspecs
    from repro.train.step import decode_step_fn, prefill_step_fn

    archs, d, (B, S_MAX, STEPS) = %r, %r, %r
    inp = dict(np.load(d + "/inputs.npz"))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1),
                ("data", "model"))
    out = {}

    def tree(prefix):
        t = {}
        for key, v in inp.items():
            if key.startswith(prefix):
                node, parts = t, key[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return t

    for arch in archs:
        cfg = get_smoke_config(arch).derive(dtype="float32")
        if cfg.is_moe:
            cfg = cfg.derive(capacity_factor=cfg.n_experts /
                             cfg.experts_per_token)
        rules = (("batch", None),)
        if arch == "mixtral_8x22b":
            rules += (("experts", None), ("expert_mlp", "model"))
        pol = MeshPolicy(seq_shard=True, rules=rules)
        specs = init_cache_specs(cfg, B, S_MAX)
        c_sh = jax.tree.map(lambda ps: NamedSharding(mesh, ps),
                            param_pspecs(axes_tree(specs), pol, mesh))
        cache = jax.device_put(jax.tree.map(
            lambda s: jnp.zeros(s.shape, jnp.float32), specs,
            is_leaf=lambda x: isinstance(x, ParamSpec)), c_sh)
        rep = NamedSharding(mesh, P())
        params = jax.device_put(tree(arch + "/p/"), rep)
        prefill = jax.jit(lambda p, b, c: prefill_step_fn(
            p, b, c, cfg=cfg, policy=pol), in_shardings=(rep, rep, c_sh),
            out_shardings=(rep, c_sh), donate_argnums=(2,))
        decode = jax.jit(lambda p, b, c, i: decode_step_fn(
            p, b, c, i, cfg=cfg, policy=pol),
            in_shardings=(rep, rep, c_sh, rep), out_shardings=(rep, c_sh),
            donate_argnums=(2,))
        logits, cache = prefill(params, {"tokens": inp[arch + "/prompt"]},
                                cache)
        out[arch + "/0"] = np.asarray(logits[:, -1])
        for t, idx in enumerate(STEPS):
            logits, cache = decode(params, {"tokens": inp[arch + "/next"][t]},
                                   cache, jnp.int32(idx))
            out[arch + "/%%d" %% (t + 1)] = np.asarray(logits[:, -1])
        out[arch + "/kv_seq_sharding"] = np.asarray(str(
            cache["shared_k" if "shared_k" in cache else "k"].sharding.spec))
    np.savez(d + "/ref.npz", **out)
    print("JAX_OK")
""")


def _serve(arch, params, cache, inp, *, policy, mesh, gather):
    """A prefill, then the decode steps, through the donated serving
    steps: the gathered logits of each step and the last cache."""
    from repro_torch.train.step import decode_step_fn, prefill_step_fn
    cfg = _cfg(arch)
    kw = dict(cfg=cfg, policy=policy, mesh=mesh, device=CPU)
    with torch.no_grad():
        logits, cache = prefill_step_fn(
            params, {"tokens": inp[f"{arch}/prompt"]}, cache, **kw)
        served = [gather(logits[:, -1])]
        for t, idx in enumerate(STEPS):
            logits, cache = decode_step_fn(
                params, {"tokens": inp[f"{arch}/next"][t]}, cache, idx,
                **kw)
            served.append(gather(logits[:, -1]))
    return served, cache


def _seq_rank(rank, world, device, d, mesh_name):
    """Every case of ``mesh_name`` on this rank: the gathered logits of
    each step, the gathered cache and the cache's local rows; on rank 0
    also the port's whole-cache run without a mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import gather_params, shard_params
    from repro_torch.parallel.sharding import (all_gather_dim, local_shape,
                                               model_part, storage_pspecs)
    torch.set_num_threads(1)
    shape, archs = MESHES[mesh_name]
    mesh = init_device_mesh(CPU, shape, mesh_dim_names=("data", "model"))
    inp = dict(np.load(d / "inputs.npz"))
    model = model_part(mesh)[0]
    out = {}
    for arch in archs:
        cfg, pol = _cfg(arch), _policy(arch)
        full = _unflat(inp, f"{arch}/p/")
        params = shard_params(full, storage_pspecs(param_specs(cfg), pol,
                                                   mesh), mesh, CPU)
        c_specs = init_cache_specs(cfg, B, S_MAX)
        c_pspecs = storage_pspecs(c_specs, pol, mesh)
        cache = tree_map(lambda s: torch.zeros(local_shape(
            s.shape, storage_pspecs(s, pol, mesh), mesh)), c_specs)
        rows = {k: tuple(v.shape) for k, v in cache.items()}

        def gather(logits, cfg=cfg):
            if logits.shape[-1] < cfg.vocab_size:
                logits = all_gather_dim(logits, logits.dim() - 1, model)
            return logits.numpy()

        served, cache = _serve(arch, params, cache, inp, policy=pol,
                               mesh=mesh, gather=gather)
        res = {"served": served, "local": rows, "cache": {
            k: v.numpy() for k, v in gather_params(cache, c_pspecs,
                                                   mesh).items()}}
        if rank == 0:
            whole = tree_map(lambda s: torch.zeros(s.shape), c_specs)
            one, whole = _serve(arch, tree_map(torch.from_numpy, full),
                                whole, inp, policy=pol, mesh=None,
                                gather=lambda t: t.numpy())
            res["one"] = one
            res["one_cache"] = {k: v.numpy() for k, v in whole.items()}
        out[arch] = res
    return out


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    """The inputs, the JAX side started in a process of its own that runs
    while the ranks do."""
    d = tmp_path_factory.mktemp("seqshard")
    _inputs(d)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % (
            str(SRC), ARCHS, str(d), (B, S_MAX, STEPS))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(seq_dir):
    d, proc = seq_dir
    try:
        so, se = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        so, se = proc.communicate()
    assert "JAX_OK" in so, so[-2000:] + se[-4000:]
    return dict(np.load(d / "ref.npz"))


@pytest.fixture(scope="module")
def ranks(seq_dir):
    d, _ = seq_dir
    return {name: spawn_ranks(_seq_rank, shape[0] * shape[1], d, name,
                              store_dir=str(d), device_type=CPU,
                              timeout=TIMEOUT)
            for name, (shape, _) in MESHES.items()}


def _cases():
    return [(name, arch) for name, (_, archs) in MESHES.items()
            if name != "one" for arch in archs]


def _alike(results, arch):
    first = results[0][arch]["served"]
    for r in results[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(r[arch]["served"], first)), arch
    return first


@pytest.mark.parametrize("mesh_name,arch", _cases())
def test_seq_sharded_steps_match_jax_and_the_whole_cache(ranks, reference,
                                                         mesh_name, arch):
    got = ranks[mesh_name]
    served = _alike(got, arch)
    one = got[0][arch]["one"]
    assert len(served) == len(STEPS) + 1
    for t, logits in enumerate(served):
        np.testing.assert_allclose(logits, one[t], rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(logits, reference[f"{arch}/{t}"],
                                   rtol=SERVE_TOL, atol=SERVE_TOL,
                                   err_msg=f"step {t}")


def test_the_reference_took_the_seq_shard_layout(reference):
    """The reference's donated cache came back split along `kv_seq` over
    `data`, the batch replicated."""
    for arch in ARCHS:
        spec = str(reference[f"{arch}/kv_seq_sharding"])
        assert spec.startswith("PartitionSpec(None, None, 'data'"), spec


@pytest.mark.parametrize("mesh_name,arch", _cases())
def test_seq_sharded_cache_rows_equal_the_whole_cache(ranks, mesh_name,
                                                      arch):
    """Each rank holds S_MAX / data rows; the gathered cache is the
    whole-cache run's: bitwise where no decode wrote and in the first
    attention layer's decode rows, within ATOL/RTOL elsewhere (bitwise
    everywhere on (4, 1) before the decode; tensor parallelism on (2, 2)
    regroups the prefill's sums too)."""
    shape, _ = MESHES[mesh_name]
    got = ranks[mesh_name]
    for r in got:
        for key in KV_KEYS:
            if key in r[arch]["local"]:
                assert r[arch]["local"][key][2] == S_MAX // shape[0]
    cache, want = got[0][arch]["cache"], got[0][arch]["one_cache"]
    for r in got[1:]:
        assert all(np.array_equal(r[arch]["cache"][k], v)
                   for k, v in cache.items())
    decoded = np.zeros(S_MAX, bool)
    decoded[list(STEPS)] = True
    for key, v in cache.items():
        np.testing.assert_allclose(v, want[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
        if key in KV_KEYS and shape[1] == 1:
            assert np.array_equal(v[:, :, ~decoded], want[key][:, :, ~decoded])
            assert np.array_equal(v[0], want[key][0]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_bitwise_the_whole_cache(ranks, arch):
    """On a (1, 1) mesh the seq_shard policy splits nothing: the steps
    are bitwise those without a mesh."""
    got = ranks["one"][0][arch]
    assert all(np.array_equal(a, b) for a, b in zip(got["served"],
                                                    got["one"]))
    assert all(np.array_equal(v, got["one_cache"][k])
               for k, v in got["cache"].items())


def test_a_shard_without_a_valid_key_gets_no_weight():
    """``_combine_partials`` over two halves of the keys equals ``_sdpa``
    over all of them; a half whose keys are all masked (its ``m`` the
    -1e30 fill) adds nothing, and where every key is masked the output is
    finite, ``_sdpa``'s uniform softmax over the fills."""
    from repro_torch.models.layers import (_combine_partials,
                                           _partial_softmax, _sdpa)
    g = torch.Generator().manual_seed(0)
    Bq, H, KV, hd, S = 2, 4, 2, 8, 32
    q = torch.randn(Bq, 1, H, hd, generator=g)
    k = torch.randn(Bq, S, KV, hd, generator=g)
    v = torch.randn(Bq, S, KV, hd, generator=g)

    def split(mask):
        parts = []
        for lo in (0, S // 2):
            m, l, o = _partial_softmax(q, k[:, lo:lo + S // 2],
                                       v[:, lo:lo + S // 2],
                                       mask[..., lo:lo + S // 2], 30.0)
            parts.append(torch.cat([m[..., None], l[..., None], o], -1))
        out = _combine_partials(parts).permute(0, 3, 1, 2, 4)
        return parts, out.reshape(Bq, 1, H, hd)

    mask = torch.ones(Bq, 1, S, dtype=torch.bool)
    _, out = split(mask)
    torch.testing.assert_close(out, _sdpa(q, k, v, mask, 30.0), atol=1e-6,
                               rtol=1e-5)
    mask[..., :S // 2] = False                 # the first half: no key
    parts, out = split(mask)
    assert bool((parts[0][..., 0] == -1e30).all())
    torch.testing.assert_close(out, _sdpa(q, k, v, mask, 30.0), atol=1e-6,
                               rtol=1e-5)
    half = _sdpa(q, k[:, S // 2:], v[:, S // 2:], mask[..., S // 2:], 30.0)
    torch.testing.assert_close(out, half, atol=1e-6, rtol=1e-5)
    mask[:] = False
    _, out = split(mask)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, _sdpa(q, k, v, mask, 30.0), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_write_the_cache_they_are_given(arch):
    """``prefill_step_fn`` and ``decode_step_fn`` return the storage they
    were handed (the reference donates the cache), the decode's row
    written at ``index``; ``forward`` called directly leaves its argument
    as it was and returns the same values."""
    from repro_torch.models import forward
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.step import decode_step_fn, prefill_step_fn
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    params = params_from_numpy(_weights(cfg, rng), CPU)
    cache = tree_map(lambda s: torch.zeros(s.shape),
                     init_cache_specs(cfg, B, S_MAX))
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    prompt = rng.integers(0, cfg.vocab_size, (B, PREFILL)).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    kw = dict(cfg=cfg, policy=MeshPolicy(), device=CPU)
    with torch.no_grad():
        _, c1 = prefill_step_fn(params, {"tokens": prompt}, cache, **kw)
        assert {k: v.data_ptr() for k, v in c1.items()} == ptrs
        before = tree_map(torch.clone, c1)
        want, fresh = forward(params, {"tokens": tok}, cache=c1,
                              cache_index=STEPS[0], **kw)
        assert all(torch.equal(v, before[k]) for k, v in c1.items())
        got, c2 = decode_step_fn(params, {"tokens": tok}, c1, STEPS[0],
                                 **kw)
    assert {k: v.data_ptr() for k, v in c2.items()} == ptrs
    assert torch.equal(got, want)
    for key, v in c2.items():
        assert torch.equal(v, fresh[key]), key
    kv = "shared_k" if "shared_k" in c2 else "k"
    row = c2[kv][:, :, STEPS[0]]
    assert bool((row != 0).any()) and not bool(
        (before[kv][:, :, STEPS[0]] != 0).any())
