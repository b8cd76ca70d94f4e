"""The elastic namenode pool on the port against the JAX package, on the CPU.

``tests/test_elastic_pool.py``'s cases, each run through ``repro`` and
``repro_torch`` (``device="cpu"``) on the same seeds: the pool's load
samples and scale events, the namenodes' hint caches, the replay's
outcomes and costs and the store's ``dump_state`` must be equal, and each
case's own claims (scale-out under load with pre-warmed joiners, scale-in
with warm migration and surviving leases, hysteresis and cooldown,
membership epochs, hint-aware routing, elastic replay equal to the
sequential oracle, a crash during scale-out recovered by the §7.6
protocol) must hold on the port.  Every subtree pool, joiners' too, runs
at parallelism 1.
"""
import pytest

import repro.core as R
import repro.core.chaos as r_chaos
import repro.core.cluster_sim as r_sim
import repro.core.workload as r_wl
import repro_torch.core as T
import repro_torch.core.chaos as t_chaos
import repro_torch.core.cluster_sim as t_sim
import repro_torch.core.workload as t_wl

PKGS = {"repro": (R, r_wl, {}), "port": (T, t_wl, {"device": "cpu"})}
CHAOS = {"repro": r_chaos, "port": t_chaos}
SIM = {"repro": r_sim, "port": t_sim}


def _cluster(pkg, n, *, dirs=(), files=(), namespace=False, n_dirs=16,
             files_per_dir=4):
    core, wl, kw = PKGS[pkg]
    store = core.MetadataStore(n_datanodes=4, **kw)
    core.format_fs(store)
    cluster = core.NamenodeCluster(store, n)
    for nn in cluster.namenodes:
        nn.subtree.parallelism = 1
    nn = cluster.namenodes[0]
    for d in dirs:
        nn.ops.mkdirs(d)
    for f in files:
        nn.ops.create(f)
    ns = None
    if namespace:
        ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=n_dirs,
                                   files_per_dir=files_per_dir)
        core.materialize_namespace(nn, ns)
    return store, cluster, ns


def _pool(pkg, cluster, **kw):
    """A pool whose joiners run their subtree pools at parallelism 1."""
    pool = PKGS[pkg][0].ElasticNamenodePool(cluster, **kw)

    def serial(_event):
        for nn in cluster.namenodes:
            nn.subtree.parallelism = 1
    pool.subscribe(serial)
    return pool


def _elastic(pkg, *, n=2, **pool_kw):
    store, cluster, ns = _cluster(pkg, n, namespace=True)
    kw = dict(min_namenodes=n, max_namenodes=4, high_load=60, low_load=20,
              hysteresis=2, cooldown=2)
    kw.update(pool_kw)
    return store, cluster, ns, _pool(pkg, cluster, **kw)


def pool_state(pool):
    return {"events": [(e.t, e.action, e.nn_id, e.reason, e.migrated_entries)
                       for e in pool.events],
            "samples": [(s.t, s.alive, s.ops_delta, s.queue_depth,
                         s.lock_wait_frac, s.load) for s in pool.samples],
            "counts": (pool.scale_outs, pool.scale_ins,
                       pool.migrated_entries, pool.membership_epoch)}


def _outcomes(outs):
    return [(o.ok, o.error, o.batched,
             None if o.result is None else o.result.value,
             None if o.result is None else o.result.cost.as_dict())
            for o in outs]


def _fleet(cluster):
    return [(nn.nn_id, nn.alive, nn.ops_served,
             nn.ops.cache.entries if nn.ops.cache is not None else None)
            for nn in cluster.namenodes]


def case_scale_out(pkg):
    core, wl, _ = PKGS[pkg]
    store, cluster, ns, pool = _elastic(pkg)
    client = core.DFSClient(cluster)
    client.attach_pool(pool)
    trace = wl.SpotifyWorkload(ns, seed=13).make_trace(600)
    stats = client.run_trace(trace, planned=True, window=100,
                             adaptive=False)
    assert stats.failed == 0 and pool.scale_outs >= 1
    assert len(cluster.alive_namenodes()) > 2
    ev = next(e for e in pool.events if e.action == "scale_out")
    assert ev.migrated_entries > 0
    assert cluster.namenodes[2].ops.cache.entries > 0
    return dict(pool_state(pool), fleet=_fleet(cluster),
                outcomes=_outcomes(stats.outcomes), state=store.dump_state())


def case_scale_in(pkg):
    store, cluster, ns, pool = _elastic(pkg, n=3, min_namenodes=2,
                                        hysteresis=2, cooldown=1)
    victim = cluster.namenodes[2]
    victim.perform("stat", ns.files[-1])
    before = cluster.namenodes[1].ops.cache.entries
    for _ in range(8):
        if len(cluster.alive_namenodes()) <= 2:
            break
        pool.tick(queue_depth=0)
    assert pool.scale_ins == 1 and not victim.alive
    assert cluster.election.leader() != victim.nn_id
    assert cluster.namenodes[1].ops.cache.entries > before
    return dict(pool_state(pool), fleet=_fleet(cluster),
                state=store.dump_state())


def case_scale_in_leases(pkg):
    core = PKGS[pkg][0]
    store, cluster, ns, pool = _elastic(pkg, n=3, min_namenodes=2,
                                        hysteresis=2, cooldown=1)
    client = core.DFSClient(cluster)
    client.create("/w_lease", client="writer")
    client.add_block("/w_lease", client="writer")
    for _ in range(8):
        if len(cluster.alive_namenodes()) <= 2:
            break
        client.renew_lease(client="writer")
        pool.tick(queue_depth=0)
    assert pool.scale_ins == 1
    client.add_block("/w_lease", client="writer")
    client.complete_block("/w_lease", size=1024, client="writer")
    return dict(pool_state(pool), state=store.dump_state())


def case_hysteresis(pkg):
    store, cluster, ns, pool = _elastic(pkg, high_load=10, low_load=5,
                                        hysteresis=3, cooldown=4)
    outs = []
    for _ in range(15):
        pool.tick(queue_depth=1000)
        outs.append(pool.scale_outs)
    assert outs[:7] == [0, 0, 1, 1, 1, 1, 2]
    assert len(cluster.alive_namenodes()) == 4
    return dict(pool_state(pool), outs=outs)


def case_sticky_epoch(pkg):
    core = PKGS[pkg][0]
    store, cluster, ns, pool = _elastic(pkg)
    client = core.DFSClient(cluster, policy="sticky")
    client.attach_pool(pool)
    client.stat("/")
    first = client._selector._sticky
    pool.scale_out("test")
    epoch = pool.membership_epoch
    client.stat("/")
    assert pool.membership_epoch == epoch
    assert client._selector._sticky is not None
    return dict(pool_state(pool), sticky=(first, client._selector._sticky))


def case_warm_routing(pkg):
    core = PKGS[pkg][0]
    store, cluster, _ = _cluster(pkg, 3, dirs=("/w",), files=("/w/f",))
    cluster.namenodes[0].ops.cache.clear()
    cluster.namenodes[1].ops.cache.clear()
    warm = cluster.namenodes[2]
    warm.perform("stat", "/w/f")
    alive = cluster.alive_namenodes()
    assert core.RequestPipeline._warm_namenode("/w/f", alive) is warm
    assert core.RequestPipeline._warm_namenode("/nope/x", alive) is None
    store, cluster, ns = _cluster(pkg, 3, namespace=True)
    cluster.namenodes[0].ops.cache.clear()
    for f in ns.files[:8]:
        cluster.namenodes[1].perform("stat", f)
    pipe = core.PlannedRequestPipeline(cluster, batch_size=4, window=8,
                                       adaptive=False, hint_routing=True)
    stats = pipe.run([core.WorkloadOp("stat", f) for f in ns.files[:8]])
    assert stats.failed == 0 and pipe.plan_report.hint_routed_batches > 0
    assert stats.per_nn_ops[1] > 0
    return dict(routed=pipe.plan_report.hint_routed_batches,
                per_nn=dict(stats.per_nn_ops),
                outcomes=_outcomes(stats.outcomes))


def case_routing_off(pkg):
    core, wl, _ = PKGS[pkg]
    store, cluster, ns = _cluster(pkg, 2, namespace=True)
    pipe = core.PlannedRequestPipeline(cluster, batch_size=8, window=32,
                                       adaptive=False)
    stats = pipe.run(wl.SpotifyWorkload(ns, seed=5).make_trace(64))
    assert pipe.hint_routing is False
    assert pipe.plan_report.hint_routed_batches == 0
    return dict(outcomes=_outcomes(stats.outcomes), state=store.dump_state())


def _oracle(pkg, trace):
    core = PKGS[pkg][0]
    store, cluster, _ = _cluster(pkg, 1, namespace=True)
    stats = core.RequestPipeline(cluster, batch_size=1).run(list(trace))
    return core.namespace_snapshot(store), stats.outcomes


def case_elastic_replay(pkg):
    core, wl, _ = PKGS[pkg]
    store, cluster, ns, pool = _elastic(pkg)
    client = core.DFSClient(cluster)
    client.attach_pool(pool)
    trace, bounds = wl.make_phased_trace(ns, [300, 300], seed=13)
    a = client.run_trace(trace[:bounds[0]], planned=True, window=100,
                         adaptive=False)
    for _ in range(12):
        if len(cluster.alive_namenodes()) <= 2:
            break
        pool.tick(queue_depth=0)
    b = client.run_trace(trace[bounds[0]:], planned=True, window=100,
                         adaptive=False)
    assert pool.scale_outs >= 1 and pool.scale_ins >= 1
    assert core.namespace_snapshot(store) == _oracle(pkg, trace)[0]
    return dict(pool_state(pool), fleet=_fleet(cluster),
                outcomes=_outcomes(a.outcomes) + _outcomes(b.outcomes),
                state=store.dump_state())


def case_kill_during_scale_out(pkg):
    """tests/test_elastic_pool.py's composed failure: namenode 0 crashes at
    the batch exchange right after the pool's first scale-out, and the
    §7.6 protocol, written out, converges to the sequential oracle."""
    core, wl, _ = PKGS[pkg]
    chaos = CHAOS[pkg]
    store, cluster, ns = _cluster(pkg, 2, namespace=True)
    pool = _pool(pkg, cluster, min_namenodes=2, max_namenodes=4,
                 high_load=1, low_load=0.5, hysteresis=1, cooldown=0)
    trace = wl.SpotifyWorkload(ns, seed=7).make_trace(300)
    plan = core.ChaosPlan((core.Fault(core.FaultSite.BATCH_EXCHANGE, at=9,
                                      victim=0, kind=core.CRASH),))
    inj = core.FaultInjector(plan, cluster)
    pipe = core.PlannedRequestPipeline(cluster, batch_size=8, window=50,
                                       adaptive=False, pool=pool)
    with inj:
        stats = pipe.run(trace)
    assert pool.scale_outs >= 1
    crash = [e for e in inj.events if e.kind == core.CRASH]
    assert crash and crash[0].nn_id == 0 and not cluster.namenodes[0].alive
    outcomes = list(stats.outcomes)
    for _ in range(3):
        todo = [i for i, oc in enumerate(outcomes)
                if not oc.ok and oc.error in chaos.RETRYABLE_ERRORS]
        if not todo:
            break
        for _ in range(cluster.election.max_missed + 1):
            cluster.tick()
        cluster.recover_leases()
        rstats = core.RequestPipeline(cluster, batch_size=8).run(
            [trace[i] for i in todo])
        for i, oc in zip(todo, rstats.outcomes):
            outcomes[i] = oc
    cluster.scrub_leases()
    assert all(oc.ok or oc.error not in chaos.RETRYABLE_ERRORS
               for oc in outcomes)
    core.RecoveryInvariants(store, cluster).assert_all(
        _oracle(pkg, trace)[0])
    return dict(pool_state(pool), fleet=_fleet(cluster),
                events=[(e.site.value, e.occurrence, e.nn_id, e.kind,
                         e.action) for e in inj.events],
                outcomes=_outcomes(outcomes), state=store.dump_state())


def case_des_scale_events(pkg):
    _, wl, kw = PKGS[pkg]
    sim_mod = SIM[pkg]
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=20)
    trace = wl.SpotifyWorkload(ns, seed=13).make_trace(800)
    sim = sim_mod.BatchedHopsFSSim(
        n_namenodes=2, n_ndb=4, profiles=sim_mod.profile_ops(**kw),
        batch_size=8, seed=1, planned=True, timeline_bin=0.01)
    sim.start_clients(400, wl.TraceReplay(trace))
    sim.schedule_scale_out(0.03, 2)
    sim.schedule_scale_in(0.07, 1)
    res = sim.run(0.1)
    assert [e[1:] for e in sim.fault_events] == [
        ("scale_out", 2), ("scale_out", 3), ("scale_in", 3)]
    assert sim.nn_alive == [True, True, True, False]
    assert sim.nn_ops_completed[2] > 0
    return dict(events=sim.fault_events, completed=res.completed,
                latencies=res.latencies, timeline=res.timeline,
                per_nn=sim.nn_ops_completed)


CASES = {f.__name__[5:]: f for f in (
    case_scale_out, case_scale_in, case_scale_in_leases, case_hysteresis,
    case_sticky_epoch, case_warm_routing, case_routing_off,
    case_elastic_replay, case_kill_during_scale_out, case_des_scale_events)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pool_case_matches_reference(name):
    """The case's claims hold in both packages, and everything it
    observed is equal between them."""
    assert CASES[name]("port") == CASES[name]("repro")
