"""Tensor parallelism and FSDP in the port against the JAX package, on the
CPU.

The port stores every parameter as ``parallel.sharding.storage_pspecs``
cuts it and computes on those shards: heads, MLP and vocabulary over
`model`, and under FSDP the `embed` dimension over `data`, gathered a
layer at a time.  Three meshes of 4 gloo ranks (``launch.mesh.
spawn_ranks``): ``(1, 4)`` with tensor parallelism only, ``(2, 2)`` and
``(4, 1)`` with ``fsdp=True``; each rank holds ``shard_params`` of the
same numpy weights (drawn by the specs' laws from a seed) and takes its
rows of the batch.  The JAX side runs in two subprocesses (training, serving) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``; ``jax.jit`` takes
the policy's shardings of the parameters (those entries that divide, as
the port stores them) and of the batch, on the (2, 2) mesh for the
training function and on the (1, 4) mesh for serving.  Its model runs the
dense MoE route: the reference's expert-parallel route runs a token
through another expert where a rank holds more than one (ROADMAP.md
queue 3), so the capacity factor is set to ``n_experts /
experts_per_token``, where the port's capacity buffers drop no token.

For the eight smoke configurations (fp32): qwen1.5 (dense; 5 heads stay
whole on 4 ranks), qwen3-moe (query heads split, kv heads replicated and
selected; EP), gemma3 (tied embedding, local and global layers),
command-r (the parallel block), qwen2-vl (patch embeddings, M-RoPE),
seamless (encoder and cross-attention), zamba2 (the shared block; mamba2's
``norm`` and ``out_proj`` gathered over `model`), rwkv6 (``heads_flat``
gathered; the channel mix split) and, with ``experts`` replicated and
``expert_mlp`` over `model` as ``cell_policy`` sets it, mixtral on the MoE
tensor-parallel route.  Held to the reference on every mesh: the
gathered logits, the loss, every gradient leaf after ``gather_params``
(against ``jax.grad`` of ``loss_fn``) and the parameters after one
``train_step_fn`` (against the reference's step: those gradients, then
its ``adamw_update``, at lr 1e-3 and eps 1e-3 as
``tests/test_torch_dp.py``); on (1, 4), a prefill and two decode steps.
Tolerances, fp32: atol 2e-4 (``tests/test_torch_parallel.py``'s) with
rtol 1e-4 on the logits, the loss and the stepped parameters; the
gradients atol 2e-4 plus 1e-3 of each leaf's largest element
(``tests/test_torch_train.py``'s rule: a leaf's entries are sums over the
batch and the sequence, rounded in another order in each framework;
without a mesh the port's ``embed/tok`` gradient of gemma3's case is
3.7e-4 from JAX's at a largest entry of 4.28, and rwkv6's ``u`` 0.066 at
45,304).  The served logits: within ATOL and RTOL of the port's own
prefill and decode without a mesh on the same inputs, and within
``tests/test_torch_decoder.py``'s atol 1e-3 and rtol 1e-3 of the
reference's on its (1, 4) mesh (GSPMD's sums move seamless's second
decode step 3.7e-4 at logits of about 3; without a mesh the two
frameworks are 1.25e-4 apart there).  Every rank's gathered results are
bitwise alike.  The spawned ranks import this
module, so it imports ``repro`` (and JAX) only in the subprocess.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import init_cache_specs, param_specs
from repro_torch.models.params import ParamSpec, tree_map
from repro_torch.parallel.sharding import MeshPolicy, storage_pspecs

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
ATOL, RTOL = 2e-4, 1e-4
GRAD_RTOL = 1e-3
SERVE_TOL = 1e-3
TIMEOUT = 120
ARCHS = ("qwen1_5_4b", "qwen3_moe_30b_a3b", "gemma3_12b",
         "command_r_plus_104b", "qwen2_vl_7b", "seamless_m4t_medium",
         "zamba2_2_7b", "rwkv6_3b", "mixtral_8x22b")
#: name -> (mesh shape over ("data", "model"), fsdp)
MESHES = {"tp": ((1, 4), False), "fsdp": ((2, 2), True),
          "fsdp_data": ((4, 1), True)}
B, S = 4, 16
PREFILL, S_MAX = 12, 16
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=4, eps=1e-3)


def _cfg(arch):
    cfg = get_smoke_config(arch).derive(dtype="float32")
    if cfg.is_moe:
        cfg = cfg.derive(capacity_factor=cfg.n_experts /
                         cfg.experts_per_token)
    return cfg


def _policy(arch, fsdp):
    pol = MeshPolicy(fsdp=fsdp)
    if arch == "mixtral_8x22b":
        pol = pol.with_rules(experts=None, expert_mlp="model")
    return pol


def _fake_mesh(shape):
    return SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)


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


def _batch(cfg, rng):
    """Tokens and next-token labels (some masked, all in row 0); vlm's
    patch embeddings and M-RoPE positions, encdec's frames."""
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    b = {"tokens": tok, "labels": labels}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        b["positions"] = rng.integers(0, 3 * S, (B, S, 3)).astype(np.int32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _pspec_lists(tree):
    return {k: [list(e) if isinstance(e, tuple) else e for e in v]
            for k, v in _flat(tree).items()}


def _inputs(d):
    """Every case's arrays in one npz; the shardings as JSON."""
    arrays, specs = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        rng = np.random.default_rng(200 + i)
        for k, v in _flat(_weights(cfg, rng)).items():
            arrays[f"{arch}/p/{k}"] = v
        for k, v in _batch(cfg, rng).items():
            arrays[f"{arch}/b/{k}"] = v
        arrays[f"{arch}/next"] = rng.integers(
            0, cfg.vocab_size, (2, B, 1)).astype(np.int32)
        specs[arch] = {
            name: _pspec_lists(storage_pspecs(
                param_specs(cfg), _policy(arch, fsdp), _fake_mesh(shape)))
            for name, (shape, fsdp) in MESHES.items()}
    np.savez(d / "inputs.npz", **arrays)
    (d / "specs.json").write_text(json.dumps(specs))


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, %r)
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.models import forward, init_cache_specs
    from repro.models.lm import loss_fn
    from repro.models.params import ParamSpec
    from repro.parallel.sharding import MeshPolicy
    from repro.train.optimizer import OptConfig, adamw_init, adamw_update

    archs, d, opt, (B, S, PRE, S_MAX), part = %r, %r, %r, %r, %r
    inp = dict(np.load(d + "/inputs.npz"))
    specs = json.load(open(d + "/specs.json"))
    devs = np.array(jax.devices()[:4])
    meshes = {"fsdp": Mesh(devs.reshape(2, 2), ("data", "model")),
              "tp": Mesh(devs.reshape(1, 4), ("data", "model"))}
    out = {}

    def tree(prefix):
        t = {}
        for key, v in inp.items():
            if key.startswith(prefix):
                node, parts = t, key[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        return t

    def placed(t, mesh, spec, path=""):
        if isinstance(t, dict):
            return {k: placed(v, mesh, spec, path + k + "/")
                    for k, v in t.items()}
        entries = [tuple(e) if isinstance(e, list) else e
                   for e in spec[path[:-1]]]
        return jax.device_put(jnp.asarray(t), NamedSharding(mesh,
                                                            P(*entries)))

    def rows(t, mesh):
        return {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, P("data"))) for k, v in t.items()}

    def flat(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                flat(v, prefix + "/" + k)
        else:
            out[prefix] = np.asarray(t)

    for arch in archs:
        cfg = get_smoke_config(arch).derive(dtype="float32")
        if cfg.is_moe:
            cfg = cfg.derive(capacity_factor=cfg.n_experts /
                             cfg.experts_per_token)
        pol = MeshPolicy()
        if part == "train":
            mesh = meshes["fsdp"]
            p = placed(tree(arch + "/p/"), mesh, specs[arch]["fsdp"])
            batch = rows(tree(arch + "/b/"), mesh)

            def train(p, b):
                # train_step_fn's step: the loss's gradients, then AdamW
                loss, g = jax.value_and_grad(
                    lambda p: loss_fn(p, b, cfg=cfg, policy=pol))(p)
                logits, _ = forward(p, {k: v for k, v in b.items()
                                        if k != "labels"}, cfg=cfg,
                                    policy=pol)
                p2, _ = adamw_update(OptConfig(**opt), p, g, adamw_init(p))
                return loss, g, logits, p2

            loss, g, logits, p2 = jax.jit(train)(p, batch)
            out[arch + "/loss"] = np.asarray(loss)
            out[arch + "/logits"] = np.asarray(logits)
            flat(g, arch + "/grad")
            flat(p2, arch + "/step")
            continue
        mesh = meshes["tp"]
        p = placed(tree(arch + "/p/"), mesh, specs[arch]["tp"])
        pre = {k: v[:, :PRE] if k == "tokens" else v
               for k, v in tree(arch + "/b/").items()
               if k not in ("labels", "positions")}
        cache = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                             init_cache_specs(cfg, B, S_MAX),
                             is_leaf=lambda x: isinstance(x, ParamSpec))
        step = jax.jit(lambda p, b, c, i: forward(
            p, b, cfg=cfg, policy=pol, cache=c,
            cache_index=i))
        logits, cache = jax.jit(lambda p, b, c: forward(
            p, b, cfg=cfg, policy=pol, cache=c))(p, pre, cache)
        out[arch + "/serve/0"] = np.asarray(logits[:, -1])
        for t in range(2):
            tok = jnp.asarray(inp[arch + "/next"][t])
            logits, cache = step(p, {"tokens": tok}, cache,
                                 jnp.int32(PRE + t))
            out[arch + "/serve/%%d" %% (t + 1)] = np.asarray(logits[:, -1])
    np.savez(d + "/ref_" + part + ".npz", **out)
    print("JAX_OK")
""")


@pytest.fixture(scope="module")
def tp_dir(tmp_path_factory):
    """The inputs, the JAX side started in two processes (training,
    serving) that run while the ranks do."""
    d = tmp_path_factory.mktemp("tp")
    _inputs(d)
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % (
            str(SRC), ARCHS, str(d), OPT, (B, S, PREFILL, S_MAX), part)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("train", "serve")]
    yield d, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference(tp_dir):
    d, procs = tp_dir
    out = {}
    for proc, part in zip(procs, ("train", "serve")):
        try:
            so, se = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        assert "JAX_OK" in so, so[-2000:] + se[-4000:]
        out.update(np.load(d / f"ref_{part}.npz"))
    return out


def _tp_rank(rank, world, device, d, mesh_name):
    """Every case on this rank: the gathered logits, loss and gradients,
    the gathered parameters after one train step, and on (1, 4) the
    served logits."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import forward, gather_params, shard_params
    from repro_torch.models.lm import nll_terms
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel.sharding import (all_gather_dim, local_shape,
                                               model_part)
    from repro_torch.train import OptConfig, adamw_init, train_step_fn
    torch.set_num_threads(1)
    shape, fsdp = MESHES[mesh_name]
    mesh = init_device_mesh(CPU, shape, mesh_dim_names=("data", "model"))
    inp = dict(np.load(d / "inputs.npz"))
    data = mesh.get_group("data")
    model = model_part(mesh)[0]

    def whole(logits, cfg):
        """Logits gathered over the vocabulary and the rows."""
        if logits.shape[-1] < cfg.vocab_size:
            logits = all_gather_dim(logits, logits.dim() - 1, model)
        if shape[0] > 1:
            logits = all_gather_dim(logits, 0, data)
        return logits.numpy()

    out = {}
    for arch in ARCHS:
        cfg, pol = _cfg(arch), _policy(arch, fsdp)
        pspecs = storage_pspecs(param_specs(cfg), pol, mesh)
        full = _unflat(inp, f"{arch}/p/")
        params = shard_params(full, pspecs, mesh, CPU)
        batch = _unflat(inp, f"{arch}/b/")
        rows = {k: torch.from_numpy(np.ascontiguousarray(np.split(
            v, shape[0])[mesh.get_coordinate()[0]])) for k, v in
            batch.items()}
        res = {}
        # the loss (the whole batch's mean) and its gradients
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        diff = tree_map(lambda _: next(it), params)
        count = (rows["labels"] >= 0).sum().float()
        dist.all_reduce(count, group=data)
        total, _ = nll_terms(diff, rows, cfg=cfg, policy=pol, mesh=mesh,
                             device=CPU)
        loss = total / count
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        loss = loss.detach()
        dist.all_reduce(loss, group=data)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        for g, spec in zip(tree_leaves(grads), tree_leaves(pspecs)):
            if "data" not in spec:           # FSDP's were reduce-scattered
                dist.all_reduce(g, group=data)
        res["loss"] = float(loss)
        res["grad"] = {k: v.numpy() for k, v in _flat(
            gather_params(grads, pspecs, mesh)).items()}
        with torch.no_grad():
            logits, _ = forward(params, {k: v for k, v in rows.items()
                                         if k != "labels"}, cfg=cfg,
                                policy=pol, mesh=mesh, device=CPU)
        res["logits"] = whole(logits, cfg)
        # one train step
        _, _, step_loss = train_step_fn(params, adamw_init(params), rows,
                                        cfg=cfg, policy=pol, mesh=mesh,
                                        opt=OptConfig(**OPT), device=CPU)
        res["step_loss"] = float(step_loss)
        res["step"] = {k: v.numpy() for k, v in _flat(
            gather_params(params, pspecs, mesh)).items()}
        res["local"] = {k: tuple(v.shape) for k, v in _flat(params).items()}
        if mesh_name == "tp":
            pre = {k: (v[:, :PREFILL] if k == "tokens" else v)
                   for k, v in batch.items()
                   if k not in ("labels", "positions")}
            for key, on in (("serve", mesh), ("serve_one", None)):
                params = shard_params(full, pspecs, mesh, CPU) if on \
                    else tree_map(torch.from_numpy, full)
                cpol = pol.with_rules(kv_seq=None)
                cache = tree_map(lambda s: torch.zeros(
                    local_shape(s.shape, storage_pspecs(s, cpol, mesh),
                                mesh) if on else s.shape),
                    init_cache_specs(cfg, B, S_MAX))
                served = []
                with torch.no_grad():
                    logits, cache = forward(params, pre, cfg=cfg, policy=pol,
                                            mesh=on, cache=cache, device=CPU)
                    served.append(whole(logits[:, -1], cfg))
                    for t in range(2):
                        logits, cache = forward(
                            params, {"tokens": inp[f"{arch}/next"][t]},
                            cfg=cfg, policy=pol, mesh=on, cache=cache,
                            cache_index=PREFILL + t, device=CPU)
                        served.append(whole(logits[:, -1], cfg))
                res[key] = served
        out[arch] = res
    return out


@pytest.fixture(scope="module")
def ranks(tp_dir):
    d, _ = tp_dir
    return {name: spawn_ranks(_tp_rank, 4, d, name, store_dir=str(d),
                              device_type=CPU, timeout=TIMEOUT)
            for name in MESHES}


def _alike(results, arch, key):
    first = results[0][arch][key]
    for r in results[1:]:
        got = r[arch][key]
        if isinstance(first, dict):
            assert all(np.array_equal(got[k], v) for k, v in first.items())
        elif isinstance(first, list):
            assert all(np.array_equal(a, b) for a, b in zip(got, first))
        else:
            assert np.array_equal(got, first), (arch, key)
    return first


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_gradients_match_jax(ranks, reference, arch,
                                             mesh_name):
    got = ranks[mesh_name]
    np.testing.assert_allclose(_alike(got, arch, "loss"),
                               reference[f"{arch}/loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_alike(got, arch, "logits"),
                               reference[f"{arch}/logits"], rtol=RTOL,
                               atol=ATOL)
    grads = _alike(got, arch, "grad")
    assert sorted(grads) == sorted(k[len(arch) + 6:] for k in reference
                                   if k.startswith(f"{arch}/grad/"))
    for k, g in grads.items():
        want = reference[f"{arch}/grad/{k}"]
        np.testing.assert_allclose(
            g, want, rtol=0, err_msg=k,
            atol=ATOL + GRAD_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(ranks, reference, arch, mesh_name):
    got = ranks[mesh_name]
    np.testing.assert_allclose(_alike(got, arch, "step_loss"),
                               reference[f"{arch}/loss"], rtol=RTOL,
                               atol=ATOL)
    for k, v in _alike(got, arch, "step").items():
        np.testing.assert_allclose(v, reference[f"{arch}/step/{k}"],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_four_model_ranks_match_jax(ranks, reference,
                                                          arch):
    served = _alike(ranks["tp"], arch, "serve")
    one = ranks["tp"][0][arch]["serve_one"]
    for t, logits in enumerate(served):
        np.testing.assert_allclose(logits, one[t], rtol=RTOL, atol=ATOL,
                                   err_msg=str(t))
        np.testing.assert_allclose(logits, reference[f"{arch}/serve/{t}"],
                                   rtol=SERVE_TOL, atol=SERVE_TOL,
                                   err_msg=str(t))


def test_shards_are_the_storage_layout(ranks):
    """The split the tests ran on: qwen3-moe's query heads over `model`
    with its kv heads whole (4:2 on 4 ranks), qwen1.5's 5 heads whole,
    the vocabulary and MLP over `model`, FSDP's `embed` over `data`."""
    tp, fsdp = ranks["tp"][0], ranks["fsdp"][0]
    q3 = get_smoke_config("qwen3_moe_30b_a3b")
    assert tp["qwen3_moe_30b_a3b"]["local"]["layers/attn/wq"] == (
        q3.n_layers, q3.d_model, q3.n_heads // 4, q3.hd)
    assert tp["qwen3_moe_30b_a3b"]["local"]["layers/attn/wk"] == (
        q3.n_layers, q3.d_model, q3.n_kv_heads, q3.hd)
    q1 = get_smoke_config("qwen1_5_4b")
    assert tp["qwen1_5_4b"]["local"]["layers/attn/wq"][2] == q1.n_heads
    assert tp["qwen1_5_4b"]["local"]["embed/tok"] == (q1.vocab_size // 4,
                                                      q1.d_model)
    assert fsdp["qwen1_5_4b"]["local"]["layers/mlp/wi"] == (
        q1.n_layers, q1.d_model // 2, q1.d_ff // 2)
    assert fsdp["qwen1_5_4b"]["local"]["embed/tok"] == (
        q1.vocab_size // 2, q1.d_model // 2)
