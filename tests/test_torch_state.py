"""Carrying a store's state from the JAX package into the port.

``repro_torch.core.columnar.load_state`` fills a port store from plain
data — each table's partitions' rows in scan order, and the inode id
allocator's position — built here with the JAX package's public table API
after a seeded trace has churned the namespace.
"""
import pytest

import repro.core as R
import repro.core.columnar as r_col
import repro.core.workload as r_wl
import repro_torch.core as T
import repro_torch.core.columnar as t_col
import repro_torch.core.workload as t_wl

READ_MIX = [("read", 67.0, 0.0), ("stat", 10.0, 0.25), ("ls", 12.0, 0.95)]


def _churned_reference():
    store = r_col.ColumnarMetadataStore(n_datanodes=4)
    R.format_fs(store)
    cluster = R.NamenodeCluster(store, 4)
    ns = r_wl.SyntheticNamespace(r_wl.NamespaceSpec(), n_dirs=20,
                                 files_per_dir=4)
    R.materialize_namespace(cluster.namenodes[0], ns)
    trace = r_wl.make_spotify_trace(ns, 400, seed=3,
                                    mix=r_wl.WRITE_HEAVY_MIX)
    R.PlannedRequestPipeline(cluster, batch_size=16, window=128).run(trace)
    return store


def _plain_state(store):
    tables = {name: [list(part.values()) for part in t.parts]
              for name, t in store.tables.items()}
    return tables, store.table("id_seq").get(("inode",))["next"]


def _loaded(columnar, tables, next_id):
    cls = t_col.ColumnarMetadataStore if columnar else T.MetadataStore
    port = cls(n_datanodes=4, device="cpu")
    t_col.load_state(port, tables, next_id)
    return port


@pytest.mark.parametrize("columnar", [True, False])
def test_load_state_round_trips_dump_state(columnar):
    ref = _churned_reference()
    tables, next_id = _plain_state(ref)
    port = _loaded(columnar, tables, next_id)
    assert port.dump_state() == ref.dump_state()
    # the same scan order, partition by partition
    for name, t in ref.tables.items():
        assert [list(p) for p in port.table(name).parts] == \
            [list(p) for p in t.parts]
    if columnar:       # the loaded hash index resolves every inode alike
        ridx, pidx = ref.table("inode").hindex, port.table("inode").hindex
        assert pidx.live == ridx.live
        for part in ref.table("inode").parts:
            for row in part.values():
                key = (row["parent_id"], t_wl.name_hash32(row["name"]))
                assert pidx.get(*key) == ridx.get(*key) == row["id"]


def test_read_trace_on_loaded_store_matches_reference():
    ref = _churned_reference()
    tables, next_id = _plain_state(ref)
    port = _loaded(True, tables, next_id)
    results = []
    for core, wl, store in ((R, r_wl, ref), (T, t_wl, port)):
        cluster = core.NamenodeCluster(store, 4)
        ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=20,
                                   files_per_dir=4)
        trace = wl.make_spotify_trace(ns, 600, seed=9, mix=READ_MIX)
        stats = core.PlannedRequestPipeline(
            cluster, batch_size=64, window=512).run(trace)
        results.append([(o.ok, o.error,
                         None if o.result is None else o.result.value,
                         None if o.result is None
                         else o.result.cost.as_dict())
                        for o in stats.outcomes])
    assert results[0] == results[1]
    assert any(ok for ok, *_ in results[1])
    assert port.dump_state() == ref.dump_state()
