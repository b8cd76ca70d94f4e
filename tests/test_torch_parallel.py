"""The port's multi-device layer against the JAX package, on the CPU.

Sharding: ``logical_to_pspec`` and ``param_pspecs`` for every parameter,
moment and cache tree of ``configs.cells()`` under ``cell_policy`` on a
16x16 and a 2x16x16 mesh (stand-ins that carry only the axis names, which
both packages read), entry by entry; ``named_shardings`` as DTensor
placements; ``shard_constraint`` on local tensors and DTensors.

The MoE routes and the pipeline: the JAX side runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the device count is
process-wide), the port's side on spawned gloo ranks that meet through a
file under ``tmp_path``; both read the same numpy inputs, made from a
seed.  Each rank holds its slices of the weights (``shard_params`` by
``moe_pspecs``); the gradients come back whole through ``gather_params``.

- EP with one expert a rank (4 experts on 4 ranks), with ample capacity
  and with capacity that drops tokens: forward and the gradients of
  ``sum(out * g)`` against the reference's EP and ``jax.grad``.
- EP with two experts a rank (qwen3-moe's smoke config, 8 experts on 4
  ranks): the reference's EP runs a token through another expert there and
  its devices disagree (ROADMAP.md queue 3, pinned below); the port's EP
  is held to the reference's own ``_dispatch``, every expert through
  ``_expert_ffn`` and ``_combine`` on one device, with the same capacity.
- TP (mixtral's smoke config: 4 experts on 8 ranks, d_ff 128 / 8).
- ``pipeline_apply`` over 4 stages: ``tests/test_pipeline_multistage.py``'s
  case.

Tolerances: fp32 forward and gradients atol 2e-4; the pipeline 1e-4
(``test_pipeline_multistage.py``'s).  Each subprocess and each spawn has its
own timeout of 120 s.
"""
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cells, get_config, \
    get_smoke_config
from repro_torch.launch.inputs import cache_abstract, cell_policy
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
from repro_torch.models import (axes_tree, gather_params, param_specs,
                                shard_params)
from repro_torch.models import moe as t_moe
from repro_torch.parallel.pipeline import (pipeline_apply,
                                           pipeline_bubble_fraction)
from repro_torch.parallel.sharding import (LOGICAL_RULES, MeshPolicy,
                                           PartitionSpec, logical_to_pspec,
                                           named_shardings, param_pspecs,
                                           shard_constraint)
from repro_torch.train.optimizer import opt_axes_tree

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
ATOL = 2e-4
TIMEOUT = 120

# ---------------------------------------------------------------------------
# sharding rules, every cell on both production meshes
# ---------------------------------------------------------------------------

MESHES = {"16x16": (("data", "model"), 1),
          "2x16x16": (("pod", "data", "model"), 2)}


def _entries(tree, prefix=""):
    """path -> tuple of PartitionSpec entries (either package's P)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_entries(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax_for_every_cell(arch):
    from repro.configs import get_config as r_get_config
    from repro.launch.inputs import cache_abstract as r_cache_abstract
    from repro.launch.inputs import cell_policy as r_cell_policy
    from repro.models import param_specs as r_param_specs
    from repro.models.params import axes_tree as r_axes_tree
    from repro.parallel.sharding import param_pspecs as r_param_pspecs
    from repro.train.optimizer import opt_axes_tree as r_opt_axes_tree

    cfg, rcfg = get_config(arch), r_get_config(arch)
    t_axes, r_axes = axes_tree(param_specs(cfg)), \
        r_axes_tree(r_param_specs(rcfg))
    n = 0
    for a, shape, _ in cells():
        if a != arch:
            continue
        for names, pods in MESHES.values():
            pol = cell_policy(cfg, shape, n_pods=pods)
            rpol = r_cell_policy(rcfg, shape, n_pods=pods)
            t_mesh = SimpleNamespace(mesh_dim_names=names)
            r_mesh = SimpleNamespace(axis_names=names)
            trees = [(opt_axes_tree(t_axes), r_opt_axes_tree(r_axes))]
            if SHAPES[shape]["kind"] == "decode":
                trees.append((cache_abstract(cfg, shape)[1],
                              r_cache_abstract(rcfg, shape)[1]))
            for t_tree, r_tree in trees:
                got = _entries(param_pspecs(t_tree, pol, t_mesh))
                want = _entries(r_param_pspecs(r_tree, rpol, r_mesh))
                assert got == want, (shape, names)
                n += len(got)
    assert n > 0


def test_logical_to_pspec_rules_match_jax():
    from repro.parallel.sharding import LOGICAL_RULES as R_RULES
    from repro.parallel.sharding import MeshPolicy as RPolicy
    from repro.parallel.sharding import logical_to_pspec as r_to_pspec
    assert LOGICAL_RULES == R_RULES
    axes_cases = [("batch", "seq", "act_embed"), ("embed", "heads", None),
                  ("kv_seq", "kv_heads", "head_dim"), ("vocab", "embed"),
                  ("experts", "embed", "expert_mlp"), ("batch", "kv_seq"),
                  ("heads", "kv_heads"), ("mlp", "vocab"), ()]
    policies = [((), False, False), ((("expert_mlp", "model"),), True, True),
                ((("batch", None), ("heads", None)), False, True),
                ((("heads", ("data", "model")),), True, False)]
    for names in [None, ("data", "model"), ("pod", "data", "model"),
                  ("stage",)]:
        t_mesh = names and SimpleNamespace(mesh_dim_names=names)
        r_mesh = names and SimpleNamespace(axis_names=names)
        for rules, fsdp, seq in policies:
            pol = MeshPolicy(fsdp=fsdp, seq_shard=seq, rules=rules)
            rpol = RPolicy(fsdp=fsdp, seq_shard=seq, rules=rules)
            assert pol.resolve() == rpol.resolve()
            assert pol.with_rules(mlp=None).resolve() == \
                rpol.with_rules(mlp=None).resolve()
            for axes in axes_cases:
                assert tuple(logical_to_pspec(axes, pol, t_mesh)) == \
                    tuple(r_to_pspec(axes, rpol, r_mesh)), (axes, names)


def test_named_shardings_are_the_pspecs_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    cfg = get_config("qwen3_moe_30b_a3b")
    pol = cell_policy(cfg, "train_4k", n_pods=2)
    axes = axes_tree(param_specs(cfg))
    specs = _entries(param_pspecs(axes, pol, mesh))
    places = _entries(named_shardings(axes, pol, mesh))
    assert specs.keys() == places.keys()
    for path, spec in specs.items():
        want = []
        for name in mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            want.append(Shard(dims[0]) if dims else Replicate())
        assert places[path] == tuple(want), path
    # batch over both outer axes, pod major: two mesh dims shard dim 0
    tok = named_shardings({"t": ("batch", None)}, pol.with_rules(
        batch=("pod", "data")), mesh)["t"]
    assert tok == (Shard(0), Shard(0), Replicate())


def test_partition_spec_entries():
    assert tuple(PartitionSpec(("data",), None, ["pod", "data"])) == \
        ("data", None, ("pod", "data"))
    assert PartitionSpec("model") == ("model",)


# ---------------------------------------------------------------------------
# the MoE routes and the pipeline across ranks
# ---------------------------------------------------------------------------

#: name -> (arch, config overrides, ranks, skew the tokens toward expert 0)
MOE_CASES = {
    "ep_ample": ("qwen3_moe_30b_a3b", dict(n_experts=4, capacity_factor=4.0),
                 4, False),
    "ep_drops": ("qwen3_moe_30b_a3b", dict(n_experts=4), 4, True),
    "ep_two_a_rank": ("qwen3_moe_30b_a3b", {}, 4, False),
    "tp": ("mixtral_8x22b", {}, 8, False),
}
MOE_BS = (2, 16)
PIPE = dict(S=4, L_per=2, M=8, mb=2, d=8)


def _moe_cfg(case):
    arch, over, _, _ = MOE_CASES[case]
    return get_smoke_config(arch).derive(**over)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _moe_inputs(path):
    """Weights, tokens and output cotangents of every case, from seeds."""
    arrays = {}
    for i, case in enumerate(MOE_CASES):
        cfg = _moe_cfg(case)
        rng = np.random.default_rng(100 + i)
        for name, spec in t_moe.moe_specs(cfg).items():
            fan_in = spec.shape[-2]
            arrays[f"{case}/p/{name}"] = (rng.standard_normal(
                spec.shape) / np.sqrt(fan_in)).astype(np.float32)
        B, S = MOE_BS
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        if MOE_CASES[case][3]:
            r = arrays[f"{case}/p/router"][:, 0]
            x += (3.0 * r / np.linalg.norm(r) ** 2).astype(np.float32)
        arrays[f"{case}/x"] = x
        arrays[f"{case}/g"] = rng.standard_normal(x.shape).astype(
            np.float32)
    np.savez(path, **arrays)


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, %r)
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.models import moe as M
    from repro.parallel.pipeline import pipeline_apply
    from repro.parallel.sharding import MeshPolicy

    cases, inp, out_path = %r, dict(np.load(%r)), %r
    out = {}

    def one_device(p, x, cfg):
        B, S, d = x.shape
        T, k, E = B * S, cfg.experts_per_token, cfg.n_experts
        C = max(8, int(np.ceil(T * k / E * cfg.capacity_factor)))
        w, idx = M._router(p, x, k)
        buf, keep, pos, w2 = M._dispatch(x.reshape(T, d), w.reshape(T, k),
                                         idx.reshape(T, k), E, C)
        y = M._expert_ffn(p, buf)
        return M._combine(y, idx.reshape(T, k), pos, keep,
                          w2).reshape(B, S, d)

    for case, (arch, over, ranks, _) in cases.items():
        cfg = get_smoke_config(arch).derive(**over)
        mesh = Mesh(np.array(jax.devices()[:ranks]).reshape(1, ranks),
                    ("data", "model"))
        p = {k: jnp.asarray(inp[f"{case}/p/{k}"])
             for k in ("router", "wi", "wg", "wo")}
        x, g = jnp.asarray(inp[f"{case}/x"]), jnp.asarray(inp[f"{case}/g"])
        route = lambda p, x: M.moe_apply(p, x, cfg=cfg,
                                         policy=MeshPolicy(), mesh=mesh)
        fn = route
        if case == "ep_two_a_rank":
            # the port is held to the one-device dispatch; the reference's
            # own EP is kept for the spread of its devices' outputs
            fn = lambda p, x: one_device(p, x, cfg)
            shards = [np.asarray(s.data)
                      for s in jax.jit(route)(p, x).addressable_shards]
            out[case + "/ref_ep_spread"] = np.asarray(max(
                float(np.abs(s - shards[0]).max()) for s in shards))
        y = jax.jit(fn)(p, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) * g),
                                  argnums=(0, 1)))(p, x)
        out[case + "/out"] = np.asarray(y)
        out[case + "/gx"] = np.asarray(gx)
        for k, v in gp.items():
            out[case + "/gp/" + k] = np.asarray(v)

    S, L_per, Mb, mb, d = %r
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))
    w = jax.random.normal(jax.random.PRNGKey(0), (S, L_per, d, d)) * 0.3
    x = jax.random.normal(jax.random.PRNGKey(1), (Mb, mb, d))
    y = pipeline_apply(lambda lp, h: jnp.tanh(h @ lp), w, x, mesh=mesh)
    out.update({"pipe/w": np.asarray(w), "pipe/x": np.asarray(x),
                "pipe/out": np.asarray(y)})
    np.savez(out_path, **out)
    print("JAX_OK")
""")


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    """Inputs and the JAX side's results, in one directory."""
    d = tmp_path_factory.mktemp("parallel")
    _moe_inputs(d / "inputs.npz")
    script = JAX_SCRIPT % (str(SRC), MOE_CASES, str(d / "inputs.npz"),
                           str(d / "ref.npz"),
                           tuple(PIPE[k] for k in ("S", "L_per", "M", "mb",
                                                   "d")))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert "JAX_OK" in r.stdout, r.stdout + r.stderr
    return d


def _moe_rank(rank, world, device, d, case):
    """One rank of a MoE case: its slices, the route, the whole gradient."""
    cfg = _moe_cfg(case)
    inp = dict(np.load(d / "inputs.npz"))
    mesh = make_host_mesh(CPU)
    pspecs = t_moe.moe_pspecs(axes_tree(t_moe.moe_specs(cfg)), cfg, mesh)
    p = shard_params(_unflat(inp, f"{case}/p/"), pspecs, mesh, CPU)
    for v in p.values():
        v.requires_grad_()
    x = torch.from_numpy(inp[f"{case}/x"]).requires_grad_()
    out = t_moe.moe_apply(p, x, cfg=cfg, policy=MeshPolicy(), mesh=mesh)
    (out * torch.from_numpy(inp[f"{case}/g"])).sum().backward()
    gp = gather_params({k: v.grad for k, v in p.items()}, pspecs, mesh)
    B, S, dm = x.shape
    T, k = B * S, cfg.experts_per_token
    w, idx = t_moe._router(p, x.detach(), k)
    C = t_moe._capacity(T, k, cfg.n_experts, cfg.capacity_factor)
    _, keep, _, _ = t_moe._dispatch(x.detach().reshape(T, dm),
                                    w.reshape(T, k), idx.reshape(T, k),
                                    cfg.n_experts, C)
    return {"route": t_moe.moe_route(cfg, mesh),
            "local": {n: tuple(v.shape) for n, v in p.items()},
            "dropped": int((~keep).sum()), "out": out.detach().numpy(),
            "gx": x.grad.numpy(),
            "gp": {n: v.numpy() for n, v in gp.items()}}


def _four_ranks(rank, world, device, d):
    """Everything the 4-rank spawn checks: the three EP cases, the
    pipeline over 4 stages, a DTensor through shard_constraint, the host
    mesh."""
    res = {case: _moe_rank(rank, world, device, d, case)
           for case, (_, _, n, _) in MOE_CASES.items() if n == world}
    from torch.distributed.device_mesh import init_device_mesh
    ref = dict(np.load(d / "ref.npz"))
    stages = init_device_mesh(CPU, (world,), mesh_dim_names=("stage",))
    w = torch.from_numpy(ref["pipe/w"])
    local = shard_params({"w": w}, {"w": PartitionSpec("stage")}, stages,
                         CPU)
    res["pipe"] = {"local": tuple(local["w"].shape), "out": pipeline_apply(
        lambda lp, h: torch.tanh(h @ lp["w"]), local,
        torch.from_numpy(ref["pipe/x"]), mesh=stages).numpy()}
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_host_mesh(CPU)
    full = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    dt = distribute_tensor(full, mesh, [Replicate(), Replicate()])
    got = shard_constraint(dt, ("batch", "heads", None), MeshPolicy(),
                           mesh)
    res["dtensor"] = {"placements": tuple(got.placements),
                      "local": tuple(got.to_local().shape),
                      "full": torch.equal(got.full_tensor(), full)}
    res["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                   tuple(mesh.get_coordinate()))
    return res


def _eight_ranks(rank, world, device, d):
    return {case: _moe_rank(rank, world, device, d, case)
            for case, (_, _, n, _) in MOE_CASES.items() if n == world}


@pytest.fixture(scope="module")
def four(ranks_dir):
    return spawn_ranks(_four_ranks, 4, ranks_dir, store_dir=str(ranks_dir),
                       device_type=CPU, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def eight(ranks_dir):
    return spawn_ranks(_eight_ranks, 8, ranks_dir, store_dir=str(ranks_dir),
                       device_type=CPU, timeout=TIMEOUT)


def _held(results, case, d):
    """Every rank's output bitwise alike; rank 0's output and the whole
    gradient within ATOL of the JAX side's."""
    ref = dict(np.load(d / "ref.npz"))
    first = results[0][case]
    for r in results[1:]:
        assert np.array_equal(r[case]["out"], first["out"])
    np.testing.assert_allclose(first["out"], ref[f"{case}/out"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(first["gx"], ref[f"{case}/gx"], atol=ATOL,
                               rtol=0)
    for name, g in first["gp"].items():
        np.testing.assert_allclose(g, ref[f"{case}/gp/{name}"], atol=ATOL,
                                   rtol=0, err_msg=name)
    return first


@pytest.mark.parametrize("case", ["ep_ample", "ep_drops"])
def test_ep_route_matches_jax(four, ranks_dir, case):
    cfg = _moe_cfg(case)
    first = _held(four, case, ranks_dir)
    assert first["route"] == "ep"
    assert first["local"]["wi"] == (1,) + t_moe.moe_specs(cfg)["wi"].shape[1:]
    assert first["local"]["router"] == (cfg.d_model, cfg.n_experts)
    assert (first["dropped"] > 0) == (case == "ep_drops")


def test_ep_with_two_experts_a_rank_is_the_one_device_dispatch(
        four, ranks_dir):
    first = _held(four, "ep_two_a_rank", ranks_dir)
    assert first["route"] == "ep" and first["local"]["wi"][0] == 2
    assert first["dropped"] > 0


def test_reference_ep_with_two_experts_a_rank_disagrees_across_devices(
        ranks_dir):
    """The reference's fault the port does not keep (ROADMAP.md queue 3):
    its exchanged buffer is reshaped without moving the source axis, so
    its devices' copies of the replicated output differ."""
    ref = dict(np.load(ranks_dir / "ref.npz"))
    assert float(ref["ep_two_a_rank/ref_ep_spread"]) > 1e-2


def test_tp_route_matches_jax(eight, ranks_dir):
    cfg = _moe_cfg("tp")
    first = _held(eight, "tp", ranks_dir)
    assert first["route"] == "tp" and cfg.n_experts % 8
    assert first["local"]["wi"] == (cfg.n_experts, cfg.d_model,
                                    cfg.moe_d_ff // 8)
    assert first["local"]["wo"] == (cfg.n_experts, cfg.moe_d_ff // 8,
                                    cfg.d_model)


def test_pipeline_four_stages_matches_jax(four, ranks_dir):
    ref = dict(np.load(ranks_dir / "ref.npz"))
    w, x = ref["pipe/w"], ref["pipe/x"]
    seq = x
    for s in range(PIPE["S"]):
        for i in range(PIPE["L_per"]):
            seq = np.tanh(seq @ w[s, i])
    for r in four:
        assert r["pipe"]["local"] == (1,) + w.shape[1:]
        np.testing.assert_allclose(r["pipe"]["out"], ref["pipe/out"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(r["pipe"]["out"], seq, atol=1e-4, rtol=0)


def test_pipeline_one_stage_is_the_layers_in_sequence():
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import init_host_group
    g = torch.Generator().manual_seed(0)
    w = torch.randn(1, 3, 8, 8, generator=g) * 0.3
    x = torch.randn(4, 2, 8, generator=g)
    owns = init_host_group(torch.device(CPU))
    try:
        mesh = init_device_mesh(CPU, (1,), mesh_dim_names=("stage",))
        out = pipeline_apply(lambda lp, h: torch.tanh(h @ lp), w, x,
                             mesh=mesh)
    finally:
        if owns:
            dist.destroy_process_group()
    ref = x
    for i in range(3):
        ref = torch.tanh(ref @ w[0, i])
    assert torch.equal(out, ref)
    assert pipeline_bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert pipeline_bubble_fraction(1, 8) == 0.0


def test_shard_constraint_redistributes_a_dtensor(four):
    from torch.distributed.tensor import Shard
    for r in four:
        # batch -> data (size 1), heads -> model (4 ranks)
        assert r["dtensor"]["placements"] == (Shard(0), Shard(1))
        assert r["dtensor"]["local"] == (2, 2, 3)
        assert r["dtensor"]["full"]


def test_host_mesh_on_four_ranks(four):
    assert [r["mesh"] for r in four] == [
        (("data", "model"), (1, 4), (0, i)) for i in range(4)]


def test_shard_and_gather_params_round_trip(four, ranks_dir):
    """Each rank's expert slices are the blocks of the full weights in
    rank order, and the gathered gradients have the full shapes."""
    inp = dict(np.load(ranks_dir / "inputs.npz"))
    for i, r in enumerate(four):
        res = r["ep_two_a_rank"]
        assert res["local"]["wi"] == (2,) + inp[
            "ep_two_a_rank/p/wi"].shape[1:]
        for name in ("router", "wi", "wg", "wo"):
            assert res["gp"][name].shape == inp[
                f"ep_two_a_rank/p/{name}"].shape
    full = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 2, 3), get_coordinate=lambda: (1, 0, 2))
    got = shard_params({"a": full, "b": {"c": full}},
                       {"a": PartitionSpec(("pod", "data"), "model"),
                        "b": {"c": PartitionSpec(None, None, "pod")}},
                       mesh, CPU)
    assert torch.equal(got["a"], torch.from_numpy(full[2:3, 4:6]))
    assert torch.equal(got["b"]["c"], torch.from_numpy(full[:, :, 4:8]))
    with pytest.raises(ValueError, match="split"):
        shard_params({"a": full}, {"a": PartitionSpec("model")}, mesh, CPU)
