"""The planned request path on the port against the JAX package, on the CPU.

The same seeded traces go through ``repro`` (JAX kernels in interpret
mode) and ``repro_torch`` (plain PyTorch versions, ``device="cpu"``), both
on the columnar store with the planned pipeline and 4 namenodes.  They
must end in byte-equal ``dump_state`` with equal per-op outcomes, equal
``OpCost`` and round trips, and equal kernel launch, probe and demotion
counts.  Inside the port, the dict store and the columnar store must agree
as they do in the JAX package.
"""
import pytest

import repro.core as R
import repro.core.columnar as r_col
import repro.core.workload as r_wl
import repro_torch.core as T
import repro_torch.core.columnar as t_col
import repro_torch.core.workload as t_wl

PKGS = {"repro": (R, r_col, r_wl, {}),
        "port": (T, t_col, t_wl, {"device": "cpu"})}


def _build(pkg, columnar=True, *, n_dirs=20, files_per_dir=4):
    core, col, wl, kw = PKGS[pkg]
    cls = col.ColumnarMetadataStore if columnar else core.MetadataStore
    store = cls(n_datanodes=4, **kw)
    core.format_fs(store)
    cluster = core.NamenodeCluster(store, 4)
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=n_dirs,
                               files_per_dir=files_per_dir)
    core.materialize_namespace(cluster.namenodes[0], ns)
    return store, cluster, ns


def _trace(pkg, mix, n_ops, **ns_kw):
    _, _, wl, _ = PKGS[pkg]
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), **ns_kw)
    kw = {} if mix == "spotify" else {"mix": wl.WRITE_HEAVY_MIX}
    return wl.make_spotify_trace(ns, n_ops, seed=5, **kw)


def _replay(pkg, mix, *, n_ops, batch_size, window, columnar=True,
            adaptive=True):
    store, cluster, _ = _build(pkg, columnar)
    trace = _trace(pkg, mix, n_ops, n_dirs=20, files_per_dir=4)
    pipe = PKGS[pkg][0].PlannedRequestPipeline(
        cluster, batch_size=batch_size, window=window, adaptive=adaptive)
    stats = pipe.run(list(trace))
    rep = pipe.plan_report
    nns = cluster.namenodes
    counts = {
        "windows": rep.windows,
        "kernel_launches": rep.kernel_launches,
        "hintchain_launches": rep.hintchain_launches,
        "pkval_launches": rep.pkval_launches,
        "pkval_probes": rep.pkval_probes,
        "pkval_demotions": rep.pkval_demotions,
        "nn_pkval_launches": sum(nn.pkval_launches for nn in nns),
        "nn_pkval_probes": sum(nn.pkval_probes for nn in nns),
        "nn_pkval_demotions": sum(nn.pkval_demotions for nn in nns),
        "treeagg_launches": sum(nn.treeagg_launches for nn in nns),
    }
    return store, stats, counts


def _outcomes(stats):
    return [(o.ok, o.error, o.batched,
             None if o.result is None else o.result.value,
             None if o.result is None else o.result.cost.as_dict())
            for o in stats.outcomes]


def _assert_same(a, b):
    (sa, ta, ca), (sb, tb, cb) = a, b
    assert sa.dump_state() == sb.dump_state()
    assert _outcomes(ta) == _outcomes(tb)
    assert ta.total_cost.as_dict() == tb.total_cost.as_dict()
    assert ta.total_cost.round_trips == tb.total_cost.round_trips
    assert {k: v.as_dict() for k, v in ta.per_nn_cost.items()} == \
        {k: v.as_dict() for k, v in tb.per_nn_cost.items()}
    assert (ta.ok, ta.failed, ta.n_batches) == (tb.ok, tb.failed, tb.n_batches)
    assert ca == cb


# window 512 with batches of 64 opens every gate (phash_chain at 512 ops,
# pkval and hintchain at 128 probes); 16/128 is the JAX package's own
# columnar benchmark setup (600 ops, seed 5), below the phash_chain gate
@pytest.mark.parametrize("mix", ["spotify", "write_heavy"])
@pytest.mark.parametrize("batch_size,window", [(64, 512), (16, 128)])
def test_planned_replay_matches_reference(mix, batch_size, window):
    ref = _replay("repro", mix, n_ops=600, batch_size=batch_size,
                  window=window)
    port = _replay("port", mix, n_ops=600, batch_size=batch_size,
                   window=window)
    _assert_same(ref, port)
    counts = port[2]
    assert counts["hintchain_launches"] >= 1
    assert counts["pkval_launches"] >= 1 and counts["pkval_probes"] > 0
    if window >= 512:
        assert counts["kernel_launches"] >= 1


def test_planned_replay_with_demotions_matches_reference():
    """3,000 Spotify ops in pinned windows of 512: stale client chains get
    demoted by pkval, a path the shorter replays never take."""
    kw = dict(n_ops=3000, batch_size=64, window=512, adaptive=False)
    ref = _replay("repro", "spotify", **kw)
    port = _replay("port", "spotify", **kw)
    _assert_same(ref, port)
    assert port[2]["pkval_demotions"] > 0
    assert port[2]["treeagg_launches"] > 0     # subtree deletes' waves
    # the dict store demotes nothing: a demoted op runs sequentially on
    # another namenode and draws other ids, so only the logical namespace
    # and the outcomes' success agree with it — in both packages alike
    import repro_torch.core as T
    dct = _replay("port", "spotify", columnar=False, **kw)
    ref_dct = _replay("repro", "spotify", columnar=False, **kw)
    assert dct[0].dump_state() == ref_dct[0].dump_state()
    assert ref_dct[0].dump_state() != ref[0].dump_state()
    assert T.namespace_snapshot(dct[0]) == T.namespace_snapshot(port[0])
    assert [o[:2] for o in _outcomes(dct[1])] == \
        [o[:2] for o in _outcomes(port[1])]


@pytest.mark.parametrize("mix", ["spotify", "write_heavy"])
def test_port_columnar_matches_port_dict(mix):
    """The dict store stays the port's own oracle (no kernel validation
    runs on it, every other path is shared)."""
    col = _replay("port", mix, n_ops=600, batch_size=64, window=512)
    dct = _replay("port", mix, n_ops=600, batch_size=64, window=512,
                  columnar=False)
    assert col[0].dump_state() == dct[0].dump_state()
    assert [o[:2] + o[3:4] for o in _outcomes(col[1])] == \
        [o[:2] + o[3:4] for o in _outcomes(dct[1])]
    assert dct[2]["pkval_probes"] == 0 and col[2]["pkval_probes"] > 0


def _client_batch(pkg):
    """The facade's deferred batch: 600 stats, run twice so that the
    second run resolves from the namenode's hint cache — a read run large
    enough for the namenode's pkval and phash launches."""
    core = PKGS[pkg][0]
    store, cluster, ns = _build(pkg, n_dirs=40, files_per_dir=16)
    client = core.DFSClient(cluster)
    paths = list(ns.files)[:600]
    out = []
    for _ in range(2):
        with client.batch() as b:
            handles = [b.stat(p) for p in paths]
        out.append([h.result() for h in handles])
    nns = cluster.namenodes
    counts = [(nn.pkval_launches, nn.pkval_probes, nn.pkval_demotions,
               nn.batched_ops) for nn in nns]
    return store, out, counts


def test_client_batch_read_run_matches_reference(monkeypatch):
    import repro_torch.kernels.phash.ops as t_phash_ops
    sizes = []
    real = t_phash_ops.phash_partitions

    def spy(keys, *a, **kw):
        sizes.append(len(keys))
        return real(keys, *a, **kw)

    monkeypatch.setattr(t_phash_ops, "phash_partitions", spy)
    rs, rout, rcounts = _client_batch("repro")
    ts, tout, tcounts = _client_batch("port")
    assert sizes and min(sizes) >= 512          # the phash path ran
    assert rs.dump_state() == ts.dump_state()
    as_tuple = lambda runs: [[(s.path, s.inode_id, s.is_dir, s.perm, s.owner,
                               s.size, s.repl, s.mtime) for s in run]
                             for run in runs]
    assert as_tuple(rout) == as_tuple(tout)
    assert rcounts == tcounts
    assert sum(c[0] for c in tcounts) >= 1      # pkval ran on the read run


def test_du_matches_reference():
    """``du`` on the columnar store resolves each wave with one treeagg
    launch, in both packages alike: the same sums, the same (kernel-path)
    costs and launches; the port's dict store gives the same sums."""
    paths = ["/w", "/w/d1x0uuuuuuuu", "/w/d1x1uuuuuuuu/d2x0uuuuuuuu", "/"]
    results = {}
    for pkg, columnar in (("repro", True), ("port", True), ("port", False)):
        store, cluster, ns = _build(pkg, columnar, n_dirs=40,
                                    files_per_dir=8)
        nn = cluster.namenodes[1]
        out = [nn.perform("du", p) for p in paths + [ns.files[0]]]
        results[pkg, columnar] = ([r.value for r in out],
                                  [r.cost.as_dict() for r in out],
                                  nn.treeagg_launches)
    ref, port, dct = (results["repro", True], results["port", True],
                      results["port", False])
    assert port == ref
    assert port[2] > 0 and dct[2] == 0
    assert dct[0] == port[0]
    assert port[0][0]["inodes"] > 300
