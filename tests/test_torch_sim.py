"""The simulator, the cost model and the HDFS baseline on the port against
the JAX package, on the CPU.

``profile_ops`` measures each op's round trips on a functional store of
either package (the port's with ``device="cpu"``); the discrete-event
simulators (``HopsFSSim``, ``BatchedHopsFSSim``, ``HDFSSim``) are host
Python seeded by ``random.Random``, so on the same seeds and profiles both
packages must give equal ``SimResult``s: completions, every latency, the
timeline, failed ops and fault events.  The cost model's tables and the
HDFS baseline's functional model must be equal too, the baseline's fault
included.
"""
import itertools

import pytest

import repro.core as R
import repro.core.cluster_sim as r_sim
import repro.core.costmodel as r_cost
import repro.core.workload as r_wl
import repro_torch.core as T
import repro_torch.core.cluster_sim as t_sim
import repro_torch.core.costmodel as t_cost
import repro_torch.core.workload as t_wl

PKGS = {"repro": (R, r_sim, r_wl, {}),
        "port": (T, t_sim, t_wl, {"device": "cpu"})}


def _profiles(pkg, **kw):
    _, sim, _, dev = PKGS[pkg]
    return sim.profile_ops(**kw, **dev)


def _plain(profiles):
    return {k: (p.pk, p.batch, p.ppis, p.is_scans, p.fts, p.local, p.remote)
            for k, p in profiles.items()}


@pytest.mark.parametrize("kw", [
    {}, {"use_cache": False}, {"distribution_aware": False},
    {"adp": False}, {"depth": 3}, {"depth": 10}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_profile_ops_match_reference(kw):
    port = _plain(_profiles("port", **kw))
    assert port == _plain(_profiles("repro", **kw))
    assert set(port) >= {"read", "create", "delete_subtree", "renew_lease"}


def _result(res, sim):
    return {"completed": res.completed, "duration": res.duration,
            "latencies": res.latencies, "timeline": res.timeline,
            "throughput": res.throughput, "p99": res.latency_pct(99),
            "failed": getattr(sim, "failed_ops", None),
            "faults": getattr(sim, "fault_events", None)}


def _hopsfs(pkg, cls, *, n_nn, clients, seconds, seed=0, kill=None,
            restart=None, workload_seed=None, policy="round_robin", **kw):
    _, sim_mod, wl, _ = PKGS[pkg]
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=30)
    sim = getattr(sim_mod, cls)(n_namenodes=n_nn, n_ndb=4,
                                profiles=_profiles(pkg), seed=seed, **kw)
    wkw = {} if workload_seed is None else {"seed": workload_seed}
    sim.start_clients(clients, wl.SpotifyWorkload(ns, **wkw), policy=policy)
    if kill is not None:
        sim.schedule_kill(*kill)
    if restart is not None:
        sim.schedule_restart(*restart)
    res = sim.run(seconds)
    out = _result(res, sim)
    if cls == "BatchedHopsFSSim":
        out.update(batches=sim.batches_executed, batched=sim.batched_ops,
                   per_nn=sim.nn_ops_completed,
                   window=(sim.controller.history
                           if sim.controller is not None else None))
    return out


SIMS = {
    "hopsfs_1nn": ("HopsFSSim", dict(n_nn=1, clients=60, seconds=0.1)),
    "hopsfs_4nn_sticky": ("HopsFSSim", dict(n_nn=4, clients=80,
                                            seconds=0.1, policy="sticky")),
    "hopsfs_4nn_random_kill": ("HopsFSSim", dict(
        n_nn=4, clients=80, seconds=0.12, policy="random", seed=3,
        kill=(0.03, 1), restart=(0.07, 1))),
    "batched_fifo": ("BatchedHopsFSSim", dict(n_nn=2, clients=100,
                                              seconds=0.06, batch_size=8)),
    "batched_planned": ("BatchedHopsFSSim", dict(
        n_nn=2, clients=120, seconds=0.06, batch_size=16, planned=True,
        seed=1, workload_seed=13)),
    "batched_adaptive_kill": ("BatchedHopsFSSim", dict(
        n_nn=4, clients=120, seconds=0.08, batch_size=8, planned=True,
        adaptive=True, kill=(0.02, 2), restart=(0.05, 2))),
}


@pytest.mark.parametrize("name", sorted(SIMS))
def test_hopsfs_sim_matches_reference(name):
    cls, kw = SIMS[name]
    port = _hopsfs("port", cls, **kw)
    assert port == _hopsfs("repro", cls, **kw)
    assert port["completed"] > 0


def _hdfs(pkg, *, clients, seconds, kill_at=None, seed=0):
    _, sim_mod, wl, _ = PKGS[pkg]
    ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=30)
    sim = sim_mod.HDFSSim(seed=seed)
    sim.start_clients(clients, wl.SpotifyWorkload(ns))
    gaps = []
    if kill_at is not None:
        sim.sim.after(kill_at, lambda: gaps.append(sim.kill_active()))
    res = sim.run(seconds)
    return dict(_result(res, sim), gaps=gaps, down_until=sim.down_until)


@pytest.mark.parametrize("kw", [dict(clients=60, seconds=0.06),
                                dict(clients=100, seconds=0.3, kill_at=0.02,
                                     seed=2)],
                         ids=["steady", "failover"])
def test_hdfs_sim_matches_reference(kw):
    port = _hdfs("port", **kw)
    assert port == _hdfs("repro", **kw)
    assert port["completed"] > 0
    if "kill_at" in kw:
        assert port["down_until"] > kw["kill_at"]


def test_sim_primitives_match_reference():
    """The DES core (event queue, k-server, readers-writer lock) on a
    scripted schedule: the same completion order and times."""
    logs = {}
    for pkg in ("repro", "port"):
        _, sim_mod, _, _ = PKGS[pkg]
        sim = sim_mod.Sim()
        srv = sim_mod.Server(sim, 2)
        lock = sim_mod.RWLock(sim)
        log = []
        for i in range(6):
            srv.submit(0.01 * (i + 1), lambda i=i: log.append(
                ("srv", i, round(sim.t, 9))))
            lock.submit(i % 3 == 0, 0.005, lambda i=i: log.append(
                ("lock", i, round(sim.t, 9))))
        sim.run(1.0)
        logs[pkg] = log
    assert logs["port"] == logs["repro"] and len(logs["port"]) == 12


# ---------------------------------------------------------------------------
# the cost model (Tables 2 and 3)
# ---------------------------------------------------------------------------

OPS = ("mkdir", "create", "addblk", "read", "ls", "stat", "chmod", "delete")


def test_table3_matches_reference():
    for op, n, cached, empty, is_dir in itertools.product(
            OPS, (2, 3, 7, 10, 16), (True, False), (True, False),
            (True, False)):
        a = r_cost.table3(op, n, cached=cached, empty_file=empty,
                          is_dir=is_dir)
        b = t_cost.table3(op, n, cached=cached, empty_file=empty,
                          is_dir=is_dir)
        assert (b.pk_rc, b.pk_r, b.pk_w, b.batches, b.ppis, b.is_scans,
                b.total) == (a.pk_rc, a.pk_r, a.pk_w, a.batches, a.ppis,
                             a.is_scans, a.total)
    with pytest.raises(KeyError):
        t_cost.table3("truncate", 3, cached=True)


def test_table2_and_headlines_match_reference():
    assert t_cost.table2() == r_cost.table2()
    assert t_cost.create_depth10_roundtrips() == \
        r_cost.create_depth10_roundtrips() == {
            "no_cache": 26, "cache": 11, "saved": 15, "improvement_pct": 58}
    assert t_cost.capacity_headline() == r_cost.capacity_headline()
    assert t_cost.capacity_headline()["ratio"] > 20


# ---------------------------------------------------------------------------
# the HDFS baseline
# ---------------------------------------------------------------------------

def _baseline_run(pkg, script):
    core = PKGS[pkg][0]
    nn = core.HDFSNamenode()
    out = []
    for op, *args in script:
        try:
            out.append((op, getattr(nn, op)(*args)))
        except Exception as e:            # HDFSError, KeyError
            out.append((op, type(e).__name__))
    return out, (nn.n_files, nn.n_dirs, nn.edits_logged, nn._next_id,
                 nn._next_blk, dict(nn.block_map),
                 nn.metadata_bytes(), nn.metadata_bytes(avg_name_len=30))


SCRIPT = [("mkdir", "/a/b/c"), ("create", "/a/b/f"), ("create", "/a/b/f"),
          ("add_block", "/a/b/f"), ("add_block", "/a/b/f"),
          ("read", "/a/b/f"), ("ls", "/a/b"), ("stat", "/a/b/c"),
          ("chmod", "/a", 0o700), ("stat", "/a/b/f"),
          ("rename", "/a/b/f", "/a/g"), ("ls", "/a"), ("read", "/a/g"),
          ("create", "/x/y"), ("stat", "/nope"), ("mkdir", "/a/b/c/d/e"),
          ("create", "/a/b/c/d/e/h"), ("add_block", "/a/b/c/d/e/h"),
          ("delete", "/a/b"), ("ls", "/a"), ("read", "/a/b/c/d/e/h"),
          ("delete", "/a"), ("ls", "/")]


def test_hdfs_baseline_matches_reference():
    port = _baseline_run("port", SCRIPT)
    assert port == _baseline_run("repro", SCRIPT)
    assert ("create", "HDFSError") in port[0]


def test_hdfs_ha_cluster_matches_reference():
    got = {}
    for pkg in ("repro", "port"):
        core = PKGS[pkg][0]
        ha = core.HDFSHACluster(n_journal=5, detect_s=1.5,
                                standby_lag_edits=100_000)
        steps = [ha.failover_downtime_s(), ha.journal_quorum_ok()]
        for _ in range(3):
            try:
                ha.fail_journal_node()
                steps.append(ha.journal_quorum_ok())
            except Exception as e:
                steps.append(type(e).__name__)
        got[pkg] = steps
    assert got["port"] == got["repro"] == [3.5, True, True, True,
                                           "HDFSError"]


#: the failing example of tests/test_properties.py::test_hopsfs_matches_oracle
#: (pinned in .hypothesis/patches/2026-10-16--66f3d7ff.patch), with /w made
#: first as that test does
PINNED = [("create", "/w/a")] + [("mkdir", "/w/a")] * 6 + \
    [("mkdir", "/w/a/a"), ("ls", "/w/a")]


def _pinned(pkg):
    core = PKGS[pkg][0]
    kw = PKGS[pkg][3]
    store = core.MetadataStore(n_datanodes=2, **kw)
    core.format_fs(store)
    hops = core.HopsFSOps(store, 0)
    base = core.HDFSNamenode()
    hops.mkdir("/w")
    base.mkdir("/w")
    seen = []
    for op, path in PINNED:
        row = []
        for name, call in (("hopsfs", lambda: (
                hops.listing(path).value if op == "ls"
                else getattr(hops, op)(path).value)),
                ("baseline", lambda: getattr(base, op)(path))):
            try:
                value = call()
                row.append((name, value if op == "ls" else "ok"))
            except Exception as e:
                row.append((name, type(e).__name__))
        seen.append(row)
    return seen


def test_hdfs_baseline_mkdir_fault_is_kept_by_the_port():
    """REFERENCE FAULT, kept on purpose: ``HDFSNamenode.mkdir`` never checks
    that an existing path component is a directory
    (``src/repro/core/hdfs_baseline.py:100-114``).  After ``create /w/a``,
    HopsFS refuses ``mkdir /w/a`` and ``mkdir /w/a/a`` and lists ``/w/a``
    as empty; the baseline accepts both and lists ``['a']`` under the
    file.  The port carries the baseline as the reference has it, so both
    packages disagree with HopsFS in the same way."""
    port = _pinned("port")
    assert port == _pinned("repro")
    assert port[-1] == [("hopsfs", []), ("baseline", ["a"])]
    assert port[1][0][1] != "ok" and port[1][1] == ("baseline", "ok")
