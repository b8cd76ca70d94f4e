"""HopsFS's consumers on the port against the JAX package, on the CPU:
``tests/test_system.py``'s scenarios for the metadata plane, checkpoints,
the data pipeline and the fleet runtime.

Each scenario runs through ``repro`` and ``repro_torch`` (stores with
``device="cpu"``): the namespace each leaves behind, byte for byte, and
what it returns must be equal.  Checkpoints hold the port's parameter
trees of tensors, fp32, int32 and bf16: the port writes the reference's
file layout and ``.npy`` bytes, and a checkpoint written by either package
restores in the other.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.ckpt import CheckpointManager as RCkpt
from repro.data import DataPipeline as RData
from repro.data import synthetic_batch as r_batch
from repro.metaplane import MetadataPlane as RPlane
from repro.runtime import FleetRuntime as RFleet
from repro.runtime import elastic_remesh as r_remesh
from repro_torch.ckpt import CheckpointManager as TCkpt
from repro_torch.data import DataPipeline as TData
from repro_torch.data import synthetic_batch as t_batch
from repro_torch.metaplane import MetadataPlane as TPlane
from repro_torch.runtime import FleetRuntime as TFleet
from repro_torch.runtime import elastic_remesh as t_remesh

CPU = {"device": "cpu"}


def _plane(pkg):
    return RPlane() if pkg == "repro" else TPlane(**CPU)


def _ckpt(pkg, directory, plane, job, **kw):
    if pkg == "repro":
        return RCkpt(directory, plane, job, **kw)
    return TCkpt(directory, plane, job, **kw, **CPU)


def _params(pkg):
    """The same tree in each package's own form: numpy arrays for the
    reference, tensors for the port."""
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    mu = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    if pkg == "repro":
        return {"w": w, "b": np.ones(3, np.float32)}, \
            {"mu": {"w": mu}, "step": np.int32(5)}
    return {"w": torch.from_numpy(w), "b": torch.ones(3)}, \
        {"mu": {"w": torch.from_numpy(mu)},
         "step": torch.tensor(5, dtype=torch.int32)}


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _files(directory):
    return {str(p.relative_to(directory)): p.read_bytes()
            for p in sorted(directory.rglob("*")) if p.is_file()}


def test_checkpoint_commit_is_atomic_and_restorable(tmp_path):
    out = {}
    for pkg in ("repro", "port"):
        plane = _plane(pkg)
        cm = _ckpt(pkg, tmp_path / pkg, plane, "j", keep=2)
        params, opt = _params(pkg)
        cm.save(100, params, opt)
        step, p, o = cm.restore_latest()
        assert step == 100
        if pkg == "port":
            assert all(torch.is_tensor(v) for v in _flat((p, o)[0]).values())
        np.testing.assert_array_equal(_np(p["w"]), _np(params["w"]))
        man = plane.manifest("j", 100)
        assert man.complete and "params/w" in man.shards
        out[pkg] = (_files(tmp_path / pkg), man.shards,
                    plane.store.dump_state())
    assert out["port"] == out["repro"]


def test_checkpoint_gc_uses_subtree_delete(tmp_path):
    out = {}
    for pkg in ("repro", "port"):
        plane = _plane(pkg)
        cm = _ckpt(pkg, tmp_path / pkg, plane, "j2", keep=1)
        params, opt = _params(pkg)
        for s in (1, 2, 3):
            cm.save(s, params, opt)
        names = plane.client.execute("ls", "/ckpt/j2").value
        assert names == ["step-00000003"]
        out[pkg] = (_files(tmp_path / pkg), plane.store.dump_state())
    assert out["port"] == out["repro"]


def test_restore_ignores_uncommitted_tmp(tmp_path):
    out = {}
    for pkg in ("repro", "port"):
        plane = _plane(pkg)
        cm = _ckpt(pkg, tmp_path / pkg, plane, "j3", keep=3)
        params, opt = _params(pkg)
        cm.save(7, params, opt)
        base = plane.begin_checkpoint("j3", 9)
        plane.add_shard(base, "params/w", 0)
        assert plane.latest_checkpoint("j3") == 7
        out[pkg] = (plane.latest_checkpoint("j3"),
                    plane.manifest("j3", 9).complete,
                    plane.store.dump_state())
    assert out["port"] == out["repro"]


def test_async_checkpoint_matches_reference(tmp_path):
    out = {}
    for pkg in ("repro", "port"):
        plane = _plane(pkg)
        cm = _ckpt(pkg, tmp_path / pkg, plane, "ja", keep=2,
                   async_mode=True)
        params, opt = _params(pkg)
        for s in (10, 20, 30):
            cm.save(s, params, opt)
        step, p, _ = cm.restore_latest()
        assert step == 30
        out[pkg] = (_files(tmp_path / pkg), plane.store.dump_state())
    assert out["port"] == out["repro"]


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """Written by one package, restored by the other, bf16 leaves too: the
    files are the same bytes either way, and every leaf comes back equal."""
    import jax.numpy as jnp
    bf = np.asarray(jnp.asarray(np.linspace(-3, 3, 8, dtype=np.float32),
                                jnp.bfloat16))
    trees = {"repro": ({"w": np.arange(4.0, dtype=np.float32), "h": bf},
                       {"step": np.int32(3)}),
             "port": ({"w": torch.arange(4.0),
                       "h": torch.linspace(-3, 3, 8).to(torch.bfloat16)},
                      {"step": torch.tensor(3, dtype=torch.int32)})}
    files = {}
    for pkg in ("repro", "port"):
        cm = _ckpt(pkg, tmp_path / f"w-{pkg}", _plane(pkg), "x")
        cm.save(4, *trees[pkg])
        files[pkg] = _files(tmp_path / f"w-{pkg}")
    assert files["port"] == files["repro"]
    reader = "port" if writer == "repro" else "repro"
    plane = _plane(reader)
    # the reader's plane learns the writer's manifest through its own
    # namespace: register the shards as the writer did
    base = plane.begin_checkpoint("x", 4)
    for path in _flat({"params": trees[writer][0], "opt": trees[writer][1]}):
        plane.add_shard(base, path, 0)
    plane.commit_checkpoint("x", 4)
    cm = _ckpt(reader, tmp_path / f"w-{writer}", plane, "x")
    step, p, o = cm.restore_latest()
    assert step == 4
    got = _flat({"params": p, "opt": o})
    want = _flat({"params": trees[writer][0], "opt": trees[writer][1]})
    assert set(got) == set(want)
    for k, v in got.items():
        w = want[k]
        if reader == "port":
            assert torch.is_tensor(v)
            if k.endswith("/h"):
                assert v.dtype == torch.bfloat16
                v = v.float()
                w = torch.linspace(-3, 3, 8).to(torch.bfloat16).float()
            np.testing.assert_array_equal(_np(v), _np(w))
        else:
            if k.endswith("/h"):
                # the reference reads a bf16 leaf back as its raw words
                assert v.dtype == np.dtype("V2") and v.shape == (8,)
                v = v.view(np.uint16)
                w = _np(trees["port"][0]["h"].view(torch.int16)).view(
                    np.uint16)
            np.testing.assert_array_equal(v, _np(w))


def test_elastic_remesh_shapes_match_reference():
    for n in (1, 2, 3, 7, 8, 64, 127, 128, 1000):
        for axis in (1, 4, 16):
            for cpw in (1, 4, 8):
                assert t_remesh(n, model_axis=axis, chips_per_worker=cpw) \
                    == r_remesh(n, model_axis=axis, chips_per_worker=cpw)
    assert t_remesh(127, model_axis=16, chips_per_worker=4) == (16, 16)


def test_fleet_failover_and_rejoin():
    out = {}
    for pkg, (plane, cls) in (("repro", (RPlane(), RFleet)),
                              ("port", (TPlane(**CPU), TFleet))):
        fleet = cls(plane, 8, model_axis=4, chips_per_worker=4)
        seen = [fleet.mesh_shape, fleet.leader()]
        fleet.fail_worker(3)
        fleet.tick()
        seen.append(fleet.maybe_remesh())
        fleet.fail_worker(0)
        for _ in range(4):
            fleet.tick()
        seen += [fleet.leader(), fleet.alive_workers(), fleet.maybe_remesh()]
        fleet.join_worker(3)
        fleet.join_worker(9)
        fleet.tick()
        seen += [fleet.maybe_remesh(), fleet.remesh_events, fleet.now]
        out[pkg] = (seen, plane.store.dump_state())
    assert out["port"] == out["repro"]
    assert out["port"][0][:3] == [(8, 4), 0, (4, 4)]
    assert out["port"][0][3] == 1


def test_straggler_redispatch_and_idempotent_completion():
    out = {}
    for pkg, (plane, cls) in (("repro", (RPlane(), RData)),
                              ("port", (TPlane(**CPU), TData))):
        dp = cls(plane, "ds", n_shards=3, hb_timeout=2)
        s0 = dp.lease(0)
        seen = [s0, dp.lease(1), dp.lease(1), dp.lease(2)]
        for _ in range(4):
            dp.tick()
        seen += [dp.lease(2), dp.complete(2, s0), dp.complete(0, s0),
                 dp.duplicate_completions, dp.pending()]
        out[pkg] = (seen, plane.store.dump_state())
    assert out["port"] == out["repro"]
    assert out["port"][0][3] is None and out["port"][0][4] == out["port"][0][0]


def test_data_batches_match_reference():
    """A pipeline's batches are the reference's tokens, as int32 tensors,
    and a restarted pipeline reads the same data."""
    plane, rplane = TPlane(**CPU), RPlane()
    dp, rdp = TData(plane, "ds2", n_shards=2), RData(rplane, "ds2",
                                                      n_shards=2)
    for shard in ("shard-00000", "shard-00001"):
        for step in (0, 5):
            got = dp.read(shard, batch=2, seq=8, vocab=100, step=step, **CPU)
            want = rdp.read(shard, batch=2, seq=8, vocab=100, step=step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    again = TData(plane, "ds2").read("shard-00000", batch=2, seq=8,
                                     vocab=100, step=5, **CPU)
    first = dp.read("shard-00000", batch=2, seq=8, vocab=100, step=5, **CPU)
    assert torch.equal(again["tokens"], first["tokens"])
    b = t_batch(3, 16, 50, step=7, seed=11, **CPU)
    rb = r_batch(3, 16, 50, step=7, seed=11)
    np.testing.assert_array_equal(b["labels"].numpy(), rb["labels"])
    assert plane.store.dump_state() == rplane.store.dump_state()


def test_metadata_plane_job_ledger_and_datasets():
    out = {}
    for pkg in ("repro", "port"):
        plane = _plane(pkg)
        plane.open_job("jl")
        for s in (3, 1, 2):
            plane.record_step("jl", s, loss=0.5)
        plane.register_dataset("d", 4)
        base = plane.begin_checkpoint("jl", 2)
        plane.add_shard(base, "params/a/b", 1)
        plane.add_shard(base, "params/a/b", 0)
        plane.commit_checkpoint("jl", 2)
        seen = [plane.last_step("jl"), plane.dataset_shards("d"),
                plane.manifest("jl", 2), plane.manifest("jl", 5),
                plane.latest_checkpoint("jl"), plane.gc_checkpoint("jl", 2),
                plane.latest_checkpoint("jl")]
        plane.tick()
        out[pkg] = ([(m.job, m.step, m.shards, m.complete)
                     if hasattr(m, "shards") else m for m in seen],
                    plane.store.dump_state())
    assert out["port"] == out["repro"]
    assert out["port"][0][0] == 3 and out["port"][0][5] >= 2


def test_metadata_plane_serves_on_the_card_by_default(monkeypatch):
    """Entry points run on the card: without one the consumers raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TPlane()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_batch(1, 4, 10, step=0)
    plane = TPlane(**CPU)
    assert plane.store.device.type == "cpu"
    assert isinstance(plane.store, T.MetadataStore)
    assert not isinstance(plane.store, R.MetadataStore)
