"""The port's mesh-free launch modules and its meshes against the JAX
package, on the CPU.

- ``launch.analytic``: ``layer_param_count``, ``active_layer_param_count``,
  ``analytic_bytes`` and ``analytic_collective_bytes``, equal for every cell
  of ``configs.cells()`` under ``cell_policy`` on a 16x16 and a 2x16x16
  mesh.
- ``launch.inputs``: ``batch_specs`` (meta tensors here, ShapeDtypeStructs
  there), ``batch_axes``, ``cache_abstract`` and ``cell_policy``: equal
  shapes, dtypes, axes and policies for every cell.
- ``launch.mesh``: the host mesh on one rank, the production mesh's
  refusal without its ranks, an import that touches no process group (the
  host mesh on four ranks is in ``tests/test_torch_parallel.py``).
- The trainer on a host mesh: qwen1.5's smoke configuration on 2 ranks and
  mixtral's on 4 (the expert-parallel route, one expert a rank), spawned
  gloo ranks that meet through a file under ``tmp_path``, against the
  reference's trainer on as many host devices in a subprocess
  (``XLA_FLAGS``); the same numpy weights on both sides, the smoke
  configurations in fp32 (in bf16 the two frameworks round at other
  places).  Losses rtol 1e-5 (``tests/test_torch_train.py``'s), every
  rank's alike.  Each subprocess and spawn has its own timeout of 120 s.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cells, get_config, \
    get_smoke_config
from repro_torch.launch import analytic, inputs
from repro_torch.launch.mesh import (init_host_group, make_host_mesh,
                                     make_production_mesh, spawn_ranks)
from repro_torch.models import param_specs, shard_params
from repro_torch.models.params import ParamSpec, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
TIMEOUT = 120
MESH_SHAPES = ({"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16})


def _arch_cells(arch):
    return [s for a, s, _ in cells() if a == arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_bytes_match_jax_for_every_cell(arch):
    from repro.configs import get_config as r_get_config
    from repro.launch import analytic as r_analytic
    from repro.launch.inputs import cell_policy as r_cell_policy
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert analytic.layer_param_count(cfg) == \
        r_analytic.layer_param_count(rcfg)
    assert analytic.active_layer_param_count(cfg) == \
        r_analytic.active_layer_param_count(rcfg)
    for shape in _arch_cells(arch):
        for sizes in MESH_SHAPES:
            pods = sizes.get("pod", 1)
            pol = inputs.cell_policy(cfg, shape, n_pods=pods)
            rpol = r_cell_policy(rcfg, shape, n_pods=pods)
            for name in ("analytic_bytes", "analytic_collective_bytes"):
                got = getattr(analytic, name)(cfg, shape, pol, sizes)
                want = getattr(r_analytic, name)(rcfg, shape, rpol, sizes)
                assert got == want, (name, shape, sizes)


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_match_jax_for_every_cell(arch):
    from repro.configs import get_config as r_get_config
    from repro.launch import inputs as r_inputs
    cfg, rcfg = get_config(arch), r_get_config(arch)
    for shape in _arch_cells(arch):
        got = inputs.batch_specs(cfg, shape)
        want = r_inputs.batch_specs(rcfg, shape)
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert _dtype_name(t) == str(want[k].dtype), k
        assert inputs.batch_axes(cfg, shape) == \
            r_inputs.batch_axes(rcfg, shape)
        if SHAPES[shape]["kind"] == "decode":
            (tc, ta), (rc, ra) = inputs.cache_abstract(cfg, shape), \
                r_inputs.cache_abstract(rcfg, shape)
            assert ta == ra and tc.keys() == rc.keys()
            for k, t in tc.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(rc[k].shape)
                assert _dtype_name(t) == str(rc[k].dtype), k
        for kw in (dict(), dict(n_pods=2), dict(model_axis=4, data_axis=1),
                   dict(model_axis=8, data_axis=2, fsdp=False)):
            assert inputs.cell_policy(cfg, shape, **kw).__dict__ == \
                r_inputs.cell_policy(rcfg, shape, **kw).__dict__, kw


def test_host_mesh_on_one_rank_and_the_production_mesh_refused():
    assert not dist.is_initialized()      # importing made no group
    with pytest.raises(RuntimeError, match="default process group"):
        make_host_mesh(CPU)
    owns = init_host_group(torch.device(CPU))
    try:
        mesh = make_host_mesh(CPU)
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(RuntimeError,
                               match=f"needs {n} ranks.*world size 1"):
                make_production_mesh(multi_pod=multi_pod, device_type=CPU)
    finally:
        if owns:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the trainer on a host mesh
# ---------------------------------------------------------------------------

#: arch -> ranks: qwen1.5 (dense: the mesh changes no number) on 2,
#: mixtral (EP, its 4 experts one a rank) on 4
TRAINER_CASES = {"qwen1_5_4b": 2, "mixtral_8x22b": 4}
TRAIN_ARGS = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
              "--ckpt-every", "100"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node, parts = out, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _weights(cfg, seed=0):
    """The parameters by the specs' laws, drawn by numpy."""
    rng = np.random.default_rng(seed)

    def draw(s: ParamSpec):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * s.scale
                / np.sqrt(max(1, fan_in))).astype(np.float32)

    return tree_map(draw, param_specs(cfg))


JAX_TRAINER = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    import json, sys
    sys.path.insert(0, %r)
    import jax.numpy as jnp, numpy as np
    import repro.launch.train as L
    from repro.metaplane import MetadataPlane

    flat = dict(np.load(%r))

    def init_params(specs, key):
        out = {}
        for k, v in flat.items():
            node, parts = out, k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
        return out

    losses, record = [], MetadataPlane.record_step

    def record_step(self, job, step, *, loss):
        losses.append(loss)
        return record(self, job, step, loss=loss)

    smoke = L.get_smoke_config
    L.get_smoke_config = lambda arch: smoke(arch).derive(dtype="float32")
    L.init_params, MetadataPlane.record_step = init_params, record_step
    sys.argv = ["train"] + %r
    L.main()
    print("LOSSES", json.dumps(losses))
""")


def _trainer_rank(rank, world, device, d, arch):
    """One rank of the port's trainer, the weights from ``d``; returns the
    losses it recorded."""
    import repro_torch.launch.train as L
    from repro_torch.metaplane import MetadataPlane
    full = _unflat(dict(np.load(d / "weights.npz")))
    L._init_sharded = lambda specs, pspecs, gen, mesh, dev: shard_params(
        full, pspecs, mesh, dev)
    losses, record = [], MetadataPlane.record_step

    def record_step(self, job, step, *, loss):
        losses.append(loss)
        return record(self, job, step, loss=loss)

    MetadataPlane.record_step = record_step
    L.get_smoke_config = lambda a: get_smoke_config(a).derive(dtype="float32")
    L.main(["--arch", arch, "--device", CPU, "--ckpt-dir", str(d / "ck")]
           + TRAIN_ARGS)
    return losses


@pytest.mark.parametrize("arch", sorted(TRAINER_CASES))
def test_trainer_on_a_host_mesh_matches_jax(tmp_path, arch):
    world = TRAINER_CASES[arch]
    np.savez(tmp_path / "weights.npz",
             **_flat(_weights(get_smoke_config(arch))))
    argv = ["--arch", arch, "--ckpt-dir", str(tmp_path / "ck-jax")] + \
        TRAIN_ARGS
    r = subprocess.run([sys.executable, "-c", JAX_TRAINER % (
        world, str(SRC), str(tmp_path / "weights.npz"), argv)],
        capture_output=True, text=True, timeout=TIMEOUT)
    line = [s for s in r.stdout.splitlines() if s.startswith("LOSSES")]
    assert line, r.stdout + r.stderr
    want = json.loads(line[0].split(" ", 1)[1])
    got = spawn_ranks(_trainer_rank, world, tmp_path, arch,
                      store_dir=str(tmp_path), device_type=CPU,
                      timeout=TIMEOUT)
    assert len(want) == 3 and all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
