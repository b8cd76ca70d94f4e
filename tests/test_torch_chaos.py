"""The chaos and failover harness on the port against the JAX package, on
the CPU.

The same fault plans and seeded traces go through ``repro`` and
``repro_torch`` (``device="cpu"``: the kernels' plain versions).  Both must
end in equal ``ChaosReport``s (per-op outcomes and costs, injector events,
recovery rounds, retried ops, outcome, housekeeping and per-namenode
costs), byte-equal ``dump_state`` and equal namespace snapshots; where the
reference's own test asserts convergence to the fault-free oracle, the port
must converge too.  Every subtree pool runs at parallelism 1 (its threads
race on one ``OpCost`` otherwise, in both packages).

On the columnar store the planned pipeline runs windows wide enough to pass
every kernel's size gate (phash_chain at 512 ops, pkval and hintchain at
128 probes), so a crash that holds a group's locks, or that strikes between
a subtree delete's chunk commits, runs through the plain versions of the
kernels; afterwards the device mirrors (the inode hash index and the hot
columns) must equal the host columns, read back through the plain pkval.
"""
import pytest
import torch

import repro.core as R
import repro.core.chaos as r_chaos
import repro.core.columnar as r_col
import repro.core.workload as r_wl
import repro_torch.core as T
import repro_torch.core.chaos as t_chaos
import repro_torch.core.columnar as t_col
import repro_torch.core.workload as t_wl

PKGS = {"repro": (R, r_col, r_wl, {}),
        "port": (T, t_col, t_wl, {"device": "cpu"})}

pytestmark = pytest.mark.chaos


def _cluster(pkg, n, *, columnar=False, dirs=(), files=(), namespace=False,
             n_dirs=16, files_per_dir=4):
    """``tests/conftest.py``'s ``make_cluster`` for either package, every
    subtree pool at parallelism 1."""
    core, col, wl, kw = PKGS[pkg]
    cls = col.ColumnarMetadataStore if columnar else core.MetadataStore
    store = cls(n_datanodes=4, **kw)
    core.format_fs(store)
    cluster = core.NamenodeCluster(store, n)
    for nn in cluster.namenodes:
        nn.subtree.parallelism = 1
    nn = cluster.namenodes[0]
    for d in dirs:
        nn.ops.mkdirs(d)
    for f in files:
        nn.ops.create(f)
    if namespace:
        ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=n_dirs,
                                   files_per_dir=files_per_dir)
        core.materialize_namespace(nn, ns)
    return store, cluster


def _write_heavy(pkg, n=160, seed=7):
    _, _, wl, _ = PKGS[pkg]
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=16,
                               files_per_dir=4)
    return wl.SpotifyWorkload(ns, seed=seed,
                              mix=wl.WRITE_HEAVY_MIX).make_trace(n)


def _ops(pkg, specs):
    core = PKGS[pkg][0]
    return [core.WorkloadOp(op, path) for op, path in specs]


def _plan(pkg, faults):
    """A ChaosPlan of ``(site, at, victim, kind, heal_after, delay_ticks)``
    in the package's own types."""
    core = PKGS[pkg][0]
    return core.ChaosPlan(tuple(
        core.Fault(core.FaultSite(site), at=at, victim=victim, kind=kind,
                   heal_after=heal, delay_ticks=ticks)
        for site, at, victim, kind, heal, ticks in faults))


def _outcomes(outs):
    return [(o.ok, o.error, o.batched,
             None if o.result is None else o.result.value,
             None if o.result is None else o.result.cost.as_dict())
            for o in outs]


def report_of(rep):
    """Everything a ChaosReport holds, as plain data."""
    return {"outcomes": _outcomes(rep.outcomes), "ok": rep.ok,
            "failed": rep.failed, "rounds": rep.recovery_rounds,
            "retried": rep.retried_ops,
            "events": [(e.site.value, e.occurrence, e.nn_id, e.kind,
                        e.action) for e in rep.events],
            "outcome_cost": rep.outcome_cost.as_dict(),
            "housekeeping": rep.housekeeping_cost.as_dict(),
            "per_nn": {k: v.as_dict() for k, v in rep.per_nn_delta.items()}}


def _oracle(pkg, trace, **build):
    """The fault-free sequential oracle's namespace snapshot."""
    core = PKGS[pkg][0]
    store, cluster = _cluster(pkg, 1, **build)
    core.RequestPipeline(cluster, batch_size=1).run(list(trace))
    return core.namespace_snapshot(store)


W = "write_heavy"
GP = R.FaultSite.GROUP_TXN_POST_LOCK.value
#: the reference's fixed-seed regressions (tests/test_chaos_recovery.py):
#: (namenodes, build, trace, faults, replay keywords, subtree batch size,
#: whether the reference asserts convergence to the oracle)
SCENARIOS = {
    "pre_lock": (4, dict(namespace=True), W,
                 [("group_txn_pre_lock", 1, None, "crash", 3, 2)],
                 dict(batch_size=8), None, True),
    "post_lock": (4, dict(namespace=True), W,
                  [(GP, 2, None, "crash", 3, 2)], dict(batch_size=8), None,
                  True),
    "subtree_chunk": (2, dict(dirs=("/big",), files=tuple(
        f"/big/f{i:02d}" for i in range(12))),
        [("delete_subtree", "/big")],
        [("subtree_chunk", 1, None, "crash", 3, 2)], dict(batch_size=1), 4,
        False),
    "partition_block_writes": (2, dict(dirs=("/w",), files=tuple(
        f"/w/f{i}" for i in range(4))),
        [("add_block", f"/w/f{i % 4}") for i in range(24)],
        [("batch_exchange", 1, None, "partition", 3, 2)],
        dict(batch_size=4), None, True),
    "delay_planned": (3, dict(namespace=True), W,
                      [("batch_exchange", 2, 1, "delay", 4, 2),
                       ("rpc", 6, None, "delay", 2, 2)],
                      dict(batch_size=8, planned=True), None, True),
    "seeded_3": (3, dict(namespace=True), W, "seeded", dict(batch_size=8),
                 None, False),
}
#: one fault at each write-path site over the write-heavy trace
SITES = [("rpc", "crash"), ("rpc", "partition"), ("batch_exchange", "crash"),
         ("batch_exchange", "partition"), ("batch_exchange", "delay"),
         ("group_txn_pre_lock", "crash"), (GP, "crash"), (GP, "delay"),
         ("subtree_chunk", "crash"), ("subtree_chunk", "delay"),
         ("rpc", "delay")]
for _site, _kind in SITES:
    SCENARIOS[f"site_{_site}_{_kind}"] = (
        3, dict(namespace=True), W, [(_site, 2, None, _kind, 2, 2)],
        dict(batch_size=8), 4, True)


def _scenario(pkg, name):
    n, build, trace, faults, kw, chunk, _ = SCENARIOS[name]
    core = PKGS[pkg][0]
    store, cluster = _cluster(pkg, n, **build)
    if chunk:
        for nn in cluster.namenodes:
            nn.subtree.batch_size = chunk
    trace = _write_heavy(pkg, 120 if faults == "seeded" else 160) \
        if trace == W else _ops(pkg, trace)
    plan = (core.ChaosPlan.seeded(3, n_namenodes=3, n_faults=2)
            if faults == "seeded" else _plan(pkg, faults))
    inj = core.FaultInjector(plan, cluster)
    rep = core.replay_with_recovery(cluster, trace, injector=inj, **kw)
    return store, cluster, trace, rep


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fixed_seed_regression_matches_reference(name):
    """Each of the reference's fixed-seed chaos regressions through both
    packages: equal reports, states and snapshots; where the reference's
    test asserts convergence, the port's run converges to its own
    fault-free oracle with every recovery invariant holding."""
    rs, _, _, rr = _scenario("repro", name)
    ps, pc, trace, pr = _scenario("port", name)
    assert report_of(pr) == report_of(rr)
    assert ps.dump_state() == rs.dump_state()
    assert T.namespace_snapshot(ps) == R.namespace_snapshot(rs)
    inv = T.RecoveryInvariants(ps, pc)
    assert inv.orphan_violations() == [] and inv.lock_violations() == []
    if SCENARIOS[name][-1]:
        oracle = _oracle("port", trace, **SCENARIOS[name][1])
        inv.assert_all(oracle, outcome_cost=pr.outcome_cost,
                       per_nn_delta=pr.per_nn_delta,
                       housekeeping=pr.housekeeping_cost)


def test_seeded_plans_and_catalog_match_reference():
    """Plans drawn from one seed are the same plans in both packages, and
    the site strings and retryable errors are the same contract."""
    for seed in range(8):
        for kinds in (("crash", "partition"), ("crash", "partition",
                                               "delay")):
            a = R.ChaosPlan.seeded(seed, n_namenodes=4, n_faults=3,
                                   kinds=kinds)
            b = T.ChaosPlan.seeded(seed, n_namenodes=4, n_faults=3,
                                   kinds=kinds)
            assert [(f.site.value, f.at, f.victim, f.kind, f.heal_after,
                     f.delay_ticks) for f in a.faults] == \
                [(f.site.value, f.at, f.victim, f.kind, f.heal_after,
                  f.delay_ticks) for f in b.faults]
    assert [s.value for s in R.FaultSite] == [s.value for s in T.FaultSite]
    assert t_chaos.RETRYABLE_ERRORS == r_chaos.RETRYABLE_ERRORS
    assert [s.value for s in t_chaos.PARTITIONABLE] == \
        [s.value for s in r_chaos.PARTITIONABLE]


def test_fault_schedules_draw_the_same_plans():
    """The hypothesis strategy, derandomized, draws equal plans."""
    hyp = pytest.importorskip("hypothesis")
    drawn = {}
    for pkg, core in (("repro", R), ("port", T)):
        out = []

        @hyp.settings(derandomize=True, max_examples=15, database=None)
        @hyp.given(plan=core.fault_schedules(
            n_namenodes=3, max_at=12, max_faults=2,
            kinds=("crash", "partition", "delay")))
        def draw(plan):
            out.append([(f.site.value, f.at, f.victim, f.kind, f.heal_after,
                         f.delay_ticks) for f in plan.faults])
        draw()
        drawn[pkg] = out
    assert drawn["port"] == drawn["repro"] and len(drawn["port"]) == 15


def _prop_trace(pkg):
    return _ops(pkg, [("create", f"/w/px{i:03d}") for i in range(24)]
                + [("add_block", f"/w/px{i:03d}") for i in range(24)]
                + [("read", f"/w/px{i:03d}") for i in range(24)])


def _pinned_run(pkg):
    core, _, wl, kw = PKGS[pkg]
    store = core.MetadataStore(n_datanodes=4, **kw)
    core.format_fs(store)
    cluster = core.NamenodeCluster(store, 3)
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=8, files_per_dir=3)
    core.materialize_namespace(cluster.namenodes[0], ns)
    for nn in cluster.namenodes:
        nn.subtree.batch_size = 4
        nn.subtree.parallelism = 1
    plan = _plan(pkg, [("batch_exchange", 0, None, "crash", 3, 2)])
    inj = core.FaultInjector(plan, cluster)
    rep = core.replay_with_recovery(cluster, _prop_trace(pkg), injector=inj,
                                    batch_size=6, planned=True)
    return store, rep


def test_pinned_planned_crash_is_a_reference_fault_kept_by_the_port():
    """REFERENCE FAULT, kept on purpose (the port carries ``repro``'s
    planner unchanged).  The failing example of
    ``tests/test_chaos_recovery.py::test_random_schedules_with_delay_converge_planned``:
    namenode 0 crashes at the first batch exchange of a planned replay of
    24 creates, 24 add_blocks and 24 reads (3 namenodes, batches of 6).
    The whole trace is one window, and every op in it is order-pinned
    (each path has a create and an add_block).  The crashed batch's six
    creates go to the residual queue, which the planner re-deals only
    after the window's other ordered batches ran: the add_blocks and reads
    of those six files find no file.  ``FileNotFound`` is a genuine FS
    outcome, not a retryable one, so recovery re-drives nothing and 12 ops
    stay failed in both packages."""
    rs, rr = _pinned_run("repro")
    ps, pr = _pinned_run("port")
    assert report_of(pr) == report_of(rr)
    assert ps.dump_state() == rs.dump_state()
    failed = [(i, o.error) for i, o in enumerate(pr.outcomes) if not o.ok]
    assert failed == [(i, "FileNotFound")
                      for i in list(range(24, 30)) + list(range(48, 54))]
    assert pr.recovery_rounds == 0 and pr.failed == 12
    assert [(e.nn_id, e.action) for e in pr.events] == [(0, "killed")]


# ---------------------------------------------------------------------------
# the columnar store: faults on the kernels' path
# ---------------------------------------------------------------------------

COLUMNAR = {
    # a crash holding a grouped transaction's row locks, in one planned
    # window of 900 Spotify ops over 4 namenodes (window 2,048)
    "group_txn_post_lock": ([(GP, 1, None, "crash", 3, 2)], None, None, []),
    # a crash between the chunk commits of a subtree delete (chunks of 4)
    # of /doomed (22 inodes), the trace's last op
    "subtree_chunk_last": ([("subtree_chunk", 2, None, "crash", 3, 2)], 4,
                           900, []),
    # the same crash with the delete mid-window: the reference fault of
    # test_pinned_planned_crash_is_a_reference_fault_kept_by_the_port.
    # The crashed ordered batch's remaining ops are re-dealt after the
    # window's later ordered batches, and one of them, trace op 451
    # (add_block), then fails with FileNotFound, in both packages
    "subtree_chunk_mid": ([("subtree_chunk", 2, None, "crash", 3, 2)], 4,
                          450, [(451, "FileNotFound")]),
}


def _columnar_run(pkg, name, monkeypatch, faults=True):
    core, col, wl, _ = PKGS[pkg]
    plan, chunk, at, _ = COLUMNAR[name]
    store, cluster = _cluster(pkg, 4, columnar=True, namespace=True,
                              n_dirs=20, files_per_dir=4)
    if chunk:
        for nn in cluster.namenodes:
            nn.subtree.batch_size = chunk
        nn = cluster.namenodes[0]
        nn.ops.mkdirs("/doomed/sub")
        for i in range(10):
            nn.ops.create(f"/doomed/f{i}")
            nn.ops.create(f"/doomed/sub/g{i}")
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=20,
                               files_per_dir=4)
    trace = wl.make_spotify_trace(ns, 900, seed=5)
    if chunk:
        trace.insert(at, core.WorkloadOp("delete_subtree", "/doomed"))
    pipes = []
    real = core.PlannedRequestPipeline.run

    def run(self, wops):
        pipes.append(self)
        return real(self, wops)
    monkeypatch.setattr(core.PlannedRequestPipeline, "run", run)
    inj = core.FaultInjector(_plan(pkg, plan), cluster) if faults else None
    rep = core.replay_with_recovery(cluster, trace, injector=inj,
                                    batch_size=64, planned=True)
    plan_rep, nns = pipes[0].plan_report, cluster.namenodes
    counts = {"windows": plan_rep.windows,
              "phash_chain": plan_rep.kernel_launches,
              "hintchain": plan_rep.hintchain_launches,
              "pkval": plan_rep.pkval_launches
              + sum(nn.pkval_launches for nn in nns),
              "pkval_probes": plan_rep.pkval_probes,
              "pkval_demotions": plan_rep.pkval_demotions,
              "treeagg": sum(nn.treeagg_launches for nn in nns)}
    return store, cluster, rep, counts


def mirror_differences(store):
    """Where the inode table's device mirrors differ from its host columns
    after a refresh: the hash index's three arrays, every live key read
    back through the plain pkval on the mirror, and the hot columns."""
    from repro_torch.kernels.pkval.ops import pkval_lookup
    inode = store.table("inode")
    hx = inode.hindex
    out = []
    assert hx._mirror_device == store.device, \
        "the replay never mirrored the hash index"
    par, nam, val = hx.device_arrays(store.device)
    host = (hx.par, hx.nam.view("int32"), hx.val)
    for what, m, h in zip(("parent", "name", "value"), (par, nam, val),
                          host):
        if not torch.equal(m.cpu(), torch.from_numpy(h)):
            out.append(f"hash index {what} mirror")
    live = hx.par >= 0
    got = pkval_lookup(par, nam, val, hx.par[live], hx.nam[live])
    if not (got == hx.val[live]).all():
        out.append("pkval on the mirror misses live keys")
    for c, m in inode.device_columns(store.device).items():
        want = inode._for_device(c, inode.hot_column(c))
        if not torch.equal(m.cpu(), torch.from_numpy(want)):
            out.append(f"hot column {c} mirror")
    return out


@pytest.mark.parametrize("name", sorted(COLUMNAR))
def test_columnar_fault_on_the_kernel_path_matches_reference(name,
                                                             monkeypatch):
    """A crash on the columnar store under the planned pipeline, the JAX
    kernels in interpret mode against the port's plain versions: equal
    reports, states and counts, every gated kernel launched, the crash
    injected, the namespace converged to the fault-free oracle, and the
    device mirrors equal to the host columns."""
    rs, _, rr, rc = _columnar_run("repro", name, monkeypatch)
    ps, pc, pr, pcnt = _columnar_run("port", name, monkeypatch)
    assert report_of(pr) == report_of(rr)
    assert ps.dump_state() == rs.dump_state()
    assert pcnt == rc
    assert pcnt["phash_chain"] >= 1 and pcnt["hintchain"] >= 1
    assert pcnt["pkval"] >= 1 and pcnt["pkval_probes"] >= 128
    if name.startswith("subtree_chunk"):
        assert pcnt["treeagg"] >= 1
    assert [(e.site.value, e.action) for e in pr.events
            if e.action == "killed"] == [(COLUMNAR[name][0][0][0], "killed")]
    inv = T.RecoveryInvariants(ps, pc)
    assert inv.orphan_violations() == [] and inv.lock_violations() == []
    assert mirror_differences(ps) == []
    assert T.namespace_snapshot(ps) == R.namespace_snapshot(rs)
    # the fault-free replay of the same trace: the same outcomes (but for
    # the reference fault's) and, without it, the same namespace
    fs, _, fr, _ = _columnar_run("port", name, monkeypatch, faults=False)
    assert not fr.events and fr.failed + len(COLUMNAR[name][3]) == pr.failed
    assert [(i, o.error) for i, (o, f) in enumerate(zip(pr.outcomes,
                                                        fr.outcomes))
            if (o.ok, o.error) != (f.ok, f.error)] == COLUMNAR[name][3]
    if not COLUMNAR[name][3]:
        assert T.namespace_snapshot(ps) == T.namespace_snapshot(fs)
