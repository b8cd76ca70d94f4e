"""The port's CUDA kernels on the card, the integer ones held bit-equal
and the float ones (flash attention, the SSD scan, the WKV scan, the
grouped matmul) within the tolerances of ``tests/test_kernels.py`` against
their plain PyTorch versions, and the
planned request path run on the card against the same path on the CPU.
The bf16 tensor-core kernels (flash attention, gmm, the two scans) are
also held at every head dim and on both of gmm's routes, on their routes
(``LAST_ROUTE``), and to the plain version's error against a float64
recomputation.
Needs an NVIDIA card of compute capability 9.0 and ``nvcc``; skipped
elsewhere:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.core.columnar as t_col
import repro_torch.core.workload as t_wl
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.hintchain import kernel as hc_kernel
from repro_torch.kernels.hintchain import ref as hc_ref
from repro_torch.kernels.phash import kernel as ph_kernel
from repro_torch.kernels.phash import ref as ph_ref
from repro_torch.kernels.pkval import kernel as pk_kernel
from repro_torch.kernels.pkval import ref as pk_ref
from repro_torch.kernels.treeagg import kernel as ta_kernel
from repro_torch.kernels.treeagg import ref as ta_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _i32(rng, shape, lo=0, hi=2**32):
    a = rng.integers(lo, hi, size=shape, dtype=np.int64)
    return torch.from_numpy((a & 0xFFFFFFFF).astype(np.uint32)
                            .view(np.int32))


def _index(n_live, cap, rng):
    idx = t_col.HashIndex(cap)
    for i in range(n_live):
        idx.set(int(rng.integers(1, 10 * n_live)), int(rng.integers(0, 2**32)),
                i + 2)
    return idx


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_phash_kernels_bit_equal(cuda, n):
    rng = np.random.default_rng(n)
    keys = _i32(rng, n).to(cuda)
    assert torch.equal(ph_kernel.phash(keys, 64), ph_ref.phash_ref(keys, 64))
    par, nam = _i32(rng, (n, 16)).to(cuda), _i32(rng, (n, 16)).to(cuda)
    hints = _i32(rng, n).to(cuda)
    depths = torch.from_numpy(
        rng.integers(0, 17, size=n).astype(np.int32)).to(cuda)
    for a, b in zip(ph_kernel.phash_chain(par, nam, hints, depths, 64),
                    ph_ref.phash_chain_ref(par, nam, hints, depths, 64)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 4099])
def test_probe_kernels_bit_equal(cuda, n):
    rng = np.random.default_rng(n)
    idx = _index(3000, 64, rng)
    for k in range(0, 3000, 7):                       # tombstones
        j = int(np.flatnonzero(idx.par >= 0)[0])
        idx.remove(int(idx.par[j]), int(idx.nam[j]))
    live = np.flatnonzero(idx.par >= 0)
    idx.val[live[::11]] = t_col.AMBIG
    tp, tn, tv = (t.to(cuda) for t in idx.device_arrays("cpu"))
    pick = rng.choice(live, size=n)
    par = torch.from_numpy(idx.par[pick].copy())
    nam = torch.from_numpy(idx.nam[pick].view(np.int32).copy())
    par[::5] = -1                                     # padding parents
    par[1::5] += 1                                    # misses
    par, nam = par.to(cuda), nam.to(cuda)
    assert torch.equal(pk_kernel.pkval(tp, tn, tv, par, nam),
                       pk_ref.pkval_ref(tp, tn, tv, par, nam))
    names = nam.repeat(16).reshape(16, n).t().contiguous()
    depths = torch.from_numpy(
        rng.integers(0, 17, size=n).astype(np.int32)).to(cuda)
    fb = [t.flip(0).contiguous() for t in (tp, tn, tv)]
    got = hc_kernel.hintchain(tp, tn, tv, *fb, names, depths)
    want = hc_ref.hintchain_ref(tp, tn, tv, *fb, names, depths)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("c,w", [(1, 1), (5000, 0), (70_001, 33),
                                 (1 << 20, 4096)])
def test_treeagg_kernel_bit_equal(cuda, c, w):
    """Children of wave members in runs (the warp-aggregated sums), of
    other ids and cleared slots; sizes large enough for the sums to wrap."""
    rng = np.random.default_rng(c + w)
    wave = np.sort(rng.choice(np.arange(2, 8 * w + 10), size=w,
                              replace=False))
    par = np.where(rng.random(c) < 0.5, rng.integers(2, 8 * w + 10, size=c),
                   np.repeat(wave, c // max(w, 1) + 1)[:c] if w else -1)
    par[rng.random(c) < 0.1] = -1
    isdir = (rng.random(c) < 0.3) & (par >= 0)
    size = np.where(par >= 0, rng.integers(0, 2**31 - 1, size=c), 0)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
            for a in (wave, par, isdir, size)]
    got = ta_kernel.treeagg(*args)
    want = ta_ref.treeagg_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _wave_case(case, rng):
    """(wave, ids, par, isdir, size) on the host for the compact form: the
    CPU tests' cases (``tests/test_torch_metadata.py``) and a member with
    a million children."""
    tile = ta_kernel.TILE_SLOTS
    w_big = ta_kernel.WAVE_SMEM_CAP + 1
    c, wave, par = {
        "empty wave": (3 * tile + 17, [], None),
        "all cleared": (2 * tile + 1, range(2, 40), -1),
        "one member owns every slot": (3 * tile + 5, [7], 7),
        "hits in every tile": (4 * tile + 333, np.sort(rng.choice(
            np.arange(2, 4000), 300, replace=False)), None),
        "sums that wrap": (2 * tile + 77, [3, 9], None),
        "wave above the shared-memory cap": (3 * tile + 9, np.sort(
            rng.choice(np.arange(2, 4 * w_big), w_big, replace=False)),
            None),
        "a member with 1M children": ((1 << 20) + 3, [5, 9, 100], 9),
    }[case]
    wave = np.asarray(wave, np.int64)
    if par is None:
        hi = int(wave.max()) * 2 + 10 if wave.size else 500
        par = np.where(rng.random(c) < 0.6, rng.choice(wave, size=c),
                       rng.integers(2, hi, size=c)) if wave.size \
            else rng.integers(2, hi, size=c)
        par[rng.random(c) < 0.1] = -1
    else:
        par = np.full(c, par, np.int64)
        if case == "a member with 1M children":
            par[::97] = -1
    cleared = par < 0
    isdir = np.where(cleared, 0, rng.random(c) < 0.3)
    hi = 2**31 - 1 if case in ("sums that wrap",
                               "a member with 1M children") else 5000
    size = np.where(cleared, 0, rng.integers(0, hi, size=c))
    ids = rng.permutation(np.arange(10**6, 10**6 + c)).astype(np.int64)
    ids[cleared] = -1
    return wave, ids, par, isdir, size


@pytest.mark.parametrize("case", [
    "empty wave", "all cleared", "one member owns every slot",
    "hits in every tile", "sums that wrap",
    "wave above the shared-memory cap", "a member with 1M children"])
def test_treeagg_compact_bit_equal(cuda, case):
    """The compact form (no seg; the children compacted on the card in
    slot order) against its plain version, through the kernel and through
    the wrapper the subtree protocol calls."""
    from repro_torch.kernels.treeagg import ops as ta_ops
    rng = np.random.default_rng(len(case))
    wave, ids, par, isdir, size = _wave_case(case, rng)
    args = (torch.from_numpy(wave.astype(np.int32)).to(cuda),
            torch.from_numpy(ids).to(cuda),
            *(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
              for a in (par, isdir, size)))
    reset_launch_counts()
    out = ta_kernel.treeagg_compact(*args)
    got = ta_kernel.unpack(out, wave.size, par.size)
    assert launch_counts()["treeagg"] == 1
    want = [t.cpu() for t in ta_ref.treeagg_expand_ref(*args)]
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)
    for g, r in zip(ta_ops.treeagg_expand(wave, *args[1:]), want):
        assert np.array_equal(g, r.numpy())
    if case == "a member with 1M children":
        assert int(got[0][1]) == got[3].numel() > 1_000_000


def _hint_case(ccap, fcap, n_ops, rng, d=16):
    """Client and fallback indexes of the given capacities (AMBIG values,
    a tombstone) over a random tree, and chains down it."""
    n_nodes = max(2, fcap // 4)
    kids = {i: [] for i in range(n_nodes)}
    client, fallback = t_col.HashIndex(ccap), t_col.HashIndex(fcap)
    n_client = 0
    for iid in range(2, n_nodes):
        par, h = int(rng.integers(max(1, iid // 3), iid)), iid * 2654435761
        h &= 0xFFFFFFFF
        kids[par].append((h, iid))
        r = rng.random()
        if r < 0.05 and n_client < ccap // 4:
            client.set(par, h, iid if r > 0.01 else t_col.AMBIG)
            n_client += 1
        else:
            fallback.set(par, h, iid if r < 0.95 else t_col.AMBIG)
    fallback.set(1, 12345, 77)
    fallback.remove(1, 12345)
    assert (client.cap, fallback.cap) == (ccap, fcap)
    names = np.zeros((n_ops, d), np.int64)
    depths = np.zeros(n_ops, np.int32)
    for i in range(n_ops):
        cur, k, want = 1, 0, int(rng.integers(0, d + 1))
        while k < want and kids[cur]:
            h, nxt = kids[cur][int(rng.integers(len(kids[cur])))]
            names[i, k] = h if rng.random() > 0.03 else h ^ 1
            cur, k = nxt, k + 1
        depths[i] = k
    return client, fallback, names, depths


@pytest.mark.parametrize("ccap,fcap,n_ops,route", [
    (64, 8192, 1024, "smem"),          # the main path's first window
    (4096, 16384, 1024, "smem"),       # keys in shared memory, values not
    (64, 8192, 3, "smem"),
    (1, 2, 40, "smem"),                # tables too small for bulk copies
    (65536, 65536, 4096, "global"),
])
def test_hintchain_routes_bit_equal(cuda, ccap, fcap, n_ops, route):
    """Both routes against the plain version, through the kernel and the
    wrapper the planner calls (one packed copy each way)."""
    from repro_torch.kernels.hintchain import ops as hc_ops
    rng = np.random.default_rng(ccap + n_ops)
    client, fallback, names, depths = _hint_case(ccap, fcap, n_ops, rng)
    assert hc_kernel.route_for(ccap, fcap) == route
    tabs = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(cuda)
            for a in (*client.arrays(), *fallback.arrays())]
    nam = torch.from_numpy((names & 0xFFFFFFFF).astype(np.uint32)
                           .view(np.int32)).to(cuda)
    dep = torch.from_numpy(depths).to(cuda)
    got = hc_kernel.hintchain(*tabs, nam, dep)
    torch.cuda.synchronize()
    assert hc_kernel.LAST_ROUTE == route
    want = hc_ref.hintchain_ref(*tabs, nam, dep)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    child, src = hc_ops.hintchain_resolve(client.arrays(), fallback.arrays(),
                                          names, depths, device=cuda)
    assert hc_kernel.LAST_ROUTE == route
    assert np.array_equal(child, want[0].cpu().numpy())
    assert np.array_equal(src, want[1].cpu().numpy())
    if n_ops > 1000:
        assert (want[0] > 0).sum(1).max() >= 4 and (want[1] == 1).any()


def _probe_table(cap, n_live, rng):
    """A linear-probe table of n_live random keys with no bound on the
    chain (windows of 8 and past them), 5% tombstones and 2% AMBIG, and
    the keys: int64 numpy (tp, tn, tv, par, nam).  Small tables are filled
    one key at a time and wrap past their last slot; large ones in bulk
    (the main path's index, as chip_smoke.py builds it)."""
    par = rng.integers(1, 1 << 30, size=n_live)
    nam = rng.integers(0, 1 << 32, size=n_live)
    home = np.array([t_col.HashIndex._mix(int(p), int(m)) & (cap - 1)
                     for p, m in zip(par, nam)]) if cap <= 4096 else (
        (((par * 0x9E3779B1) & 0xFFFFFFFF) ^ ((nam * 0x85EBCA6B)
                                              & 0xFFFFFFFF)))
    if cap > 4096:
        home = (home ^ (home >> 16)) & (cap - 1)
    tp, tn = np.full(cap, -1, np.int64), np.zeros(cap, np.int64)
    if cap <= 4096:
        slot = np.empty(n_live, np.int64)
        for i, j in enumerate(home):
            while tp[j] != -1:
                j = (j + 1) & (cap - 1)
            tp[j], slot[i] = 0, j
    else:
        order = np.argsort(home, kind="stable")
        par, nam, home = par[order], nam[order], home[order]
        i = np.arange(n_live)
        slot = i + np.maximum.accumulate(home - i)
        keep = slot < cap
        par, nam, slot = par[keep], nam[keep], slot[keep]
    tp[slot], tn[slot] = par, nam
    tv = np.full(cap, -1, np.int64)
    tv[slot] = 2 + np.arange(slot.size)
    tomb = rng.random(slot.size) < 0.05
    tp[slot[tomb]], tn[slot[tomb]], tv[slot[tomb]] = -2, 0, -1
    tv[slot[~tomb & (rng.random(slot.size) < 0.02)]] = -3
    return tp, tn, tv, par, nam


@pytest.mark.parametrize("cap,n_live,n,max_probe", [
    (1 << 23, 1_050_000, 2500, 8),    # the main path's index and first call
    (1 << 12, 3_000, 1, 8),
    (1 << 12, 3_000, 4099, 16),       # not a multiple of a block's probes
    (1 << 10, 800, 1000, 3),          # long chains, windows that wrap
    (1 << 10, 800, 1000, 8),
    (1 << 10, 800, 1000, 16),
])
def test_pkval_windows_bit_equal(cuda, cap, n_live, n, max_probe):
    """Lane groups reading a probe's window at once against the step loop
    and its window form, through the kernel and the wrapper (one upload,
    one copy back) on the card against the wrapper on the host."""
    from repro_torch.kernels.pkval import ops as pk_ops
    rng = np.random.default_rng(cap + n + max_probe)
    tp, tn, tv, kpar, knam = _probe_table(cap, n_live, rng)
    pick = rng.integers(0, kpar.size, size=n)
    ppar, pnam = kpar[pick].copy(), knam[pick].copy()
    r = rng.random(n)
    ppar[r < 0.2] = rng.integers(1, 1 << 30, size=int((r < 0.2).sum()))
    ppar[r > 0.9] = -1                                 # padding parents
    idx = [_as_i32(a).to(cuda) for a in (tp, tn, tv)]
    par, nam = _as_i32(ppar).to(cuda), _as_i32(pnam).to(cuda)
    got = pk_kernel.pkval(*idx, par, nam, max_probe=max_probe)
    want = pk_ref.pkval_ref(*idx, par, nam, max_probe=max_probe)
    assert torch.equal(got, want)
    assert torch.equal(got, pk_ref.probe_window_ref(*idx, par, nam,
                                                    max_probe=max_probe))
    host = pk_ops.pkval_lookup(*(t.cpu() for t in idx), ppar, pnam,
                               max_probe=max_probe)
    assert np.array_equal(pk_ops.pkval_lookup(*idx, ppar, pnam,
                                              max_probe=max_probe), host)
    if n >= 1000:
        assert (got > 0).any() and {-1, -3} <= set(got.tolist())


def _as_i32(a):
    return torch.from_numpy((np.asarray(a, np.int64) & 0xFFFFFFFF)
                            .astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("n,d", [(1024, 16), (1, 16), (17, 16), (4099, 16),
                                 (1000, 1), (333, 3), (64, 17), (5, 0)])
@pytest.mark.parametrize("aligned", [True, False])
def test_phash_chain_rows_bit_equal(cuda, n, d, aligned):
    """Tiles of rows through shared memory against the plain version: the
    planner's window, N = 1 and N not a multiple of a block's 16 rows,
    D in {1, 3, 16, 17} (16-byte loads only where D % 4 == 0), views
    4 bytes off 16-byte alignment (scalar loads and stores), and the
    wrapper on the card against the wrapper on the host."""
    from repro_torch.kernels.phash import ops as ph_ops
    rng = np.random.default_rng(n + d)
    arrays = [rng.integers(0, 2**32, size=s) for s in ((n, d), (n, d), n)]
    arrays.append(rng.integers(-1, d + 2, size=n))     # depths past D too
    args = [_as_i32(a).to(cuda) for a in arrays]
    total = ph_kernel.layout(n, d)[2]
    out = None
    if not aligned:
        views = []
        for t in args[:2]:
            buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=cuda)
            buf[1:] = t.reshape(-1)
            views.append(buf[1:].view(n, d))
        args[:2] = views
        out = torch.empty(total + 1, dtype=torch.int32, device=cuda)[1:]
    got = ph_kernel.phash_chain(*args, 64, out=out)
    want = ph_ref.phash_chain_ref(*args, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    card = ph_ops.phash_chains(*arrays, 64, device=cuda)
    for a, b in zip(card, ph_ops.phash_chains(*arrays, 64, device="cpu")):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_hash_index_mirror_on_card_after_writes(cuda):
    """The card's mirror after dirty writes (one packed upload a refresh),
    a growth (a whole copy) and more writes equals the host arrays."""
    rng = np.random.default_rng(11)
    idx = t_col.HashIndex(64)
    keys = [(int(rng.integers(1, 500)), int(rng.integers(0, 2**32)))
            for _ in range(600)]

    def same():
        mirror = idx.device_arrays(cuda)
        return all(torch.equal(m.cpu(), torch.from_numpy(h)) for m, h in
                   zip(mirror, (idx.par, idx.nam.view(np.int32), idx.val)))

    for p, m in keys[:30]:
        idx.set(p, m, p + 3)
    assert same()
    for p, m in keys[:10]:
        idx.set(p, m, t_col.AMBIG)
    for p, m in keys[10:20]:
        idx.remove(p, m)
    assert idx._dirty and same()
    cap = idx.cap
    for i, (p, m) in enumerate(keys[30:]):
        idx.set(p, m, i + 2)
    assert idx.cap > cap and same()
    for p, m in keys[30:200]:
        idx.remove(p, m)
    assert same() and not idx._dirty


def test_du_on_card_matches_cpu(cuda):
    def run(device):
        store = t_col.ColumnarMetadataStore(n_datanodes=4, device=device)
        T.format_fs(store)
        nn = T.NamenodeCluster(store, 2).namenodes[0]
        ns = t_wl.SyntheticNamespace(t_wl.NamespaceSpec(), n_dirs=40,
                                     files_per_dir=8)
        T.materialize_namespace(nn, ns)
        T.materialize_big_dir(nn, "/bulk", 5000)
        return [(r.value, r.cost.as_dict()) for r in
                (nn.perform("du", p) for p in ("/", "/w", "/bulk"))]

    cpu = run("cpu")
    reset_launch_counts()
    assert run(cuda) == cpu
    assert launch_counts()["treeagg"] > 0


def test_planned_replay_on_card_matches_cpu(cuda):
    def replay(device):
        store = t_col.ColumnarMetadataStore(n_datanodes=4, device=device)
        T.format_fs(store)
        cluster = T.NamenodeCluster(store, 4)
        ns = t_wl.SyntheticNamespace(t_wl.NamespaceSpec(), n_dirs=20,
                                     files_per_dir=4)
        T.materialize_namespace(cluster.namenodes[0], ns)
        trace = t_wl.make_spotify_trace(ns, 600, seed=5)
        stats = T.DFSClient(cluster).run_trace(
            trace, planned=True, batch_size=64, window=512, adaptive=False)
        return store.dump_state(), [(o.ok, o.error) for o in stats.outcomes]

    cpu = replay("cpu")
    reset_launch_counts()
    assert replay(cuda) == cpu
    counts = launch_counts()
    assert counts["phash_chain"] and counts["pkval"] and counts["hintchain"]


def test_chaos_replay_on_card_matches_cpu(cuda):
    """A namenode crashes holding a grouped transaction's row locks in a
    planned replay on the columnar store, and the §7.6 protocol recovers:
    the card and the host end byte-equal in state, in every outcome and
    cost, in the injector's events and in the report's costs, and the
    card's mirrors equal its host columns."""
    def replay(device):
        store = t_col.ColumnarMetadataStore(n_datanodes=4, device=device)
        T.format_fs(store)
        cluster = T.NamenodeCluster(store, 4)
        for nn in cluster.namenodes:
            nn.subtree.parallelism = 1
        ns = t_wl.SyntheticNamespace(t_wl.NamespaceSpec(), n_dirs=20,
                                     files_per_dir=4)
        T.materialize_namespace(cluster.namenodes[0], ns)
        trace = t_wl.make_spotify_trace(ns, 900, seed=5)
        inj = T.FaultInjector(T.ChaosPlan((T.Fault(
            T.FaultSite.GROUP_TXN_POST_LOCK, at=1),)), cluster)
        rep = T.replay_with_recovery(cluster, trace, injector=inj,
                                     batch_size=64, planned=True)
        inv = T.RecoveryInvariants(store, cluster)
        assert inv.orphan_violations() == [] and inv.lock_violations() == []
        inode = store.table("inode")
        hx = inode.hindex
        mirror = hx.device_arrays(store.device)
        assert all(torch.equal(m.cpu(), torch.from_numpy(h)) for m, h in
                   zip(mirror, (hx.par, hx.nam.view(np.int32), hx.val)))
        return (store.dump_state(),
                [(o.ok, o.error, None if o.result is None
                  else o.result.cost.as_dict()) for o in rep.outcomes],
                [(e.site.value, e.occurrence, e.nn_id, e.action)
                 for e in rep.events],
                (rep.recovery_rounds, rep.retried_ops,
                 rep.outcome_cost.as_dict(), rep.housekeeping_cost.as_dict(),
                 {k: v.as_dict() for k, v in rep.per_nn_delta.items()}))

    cpu = replay("cpu")
    reset_launch_counts()
    card = replay(cuda)
    assert card == cpu
    assert [e[3] for e in card[2]] == ["killed"]
    counts = launch_counts()
    assert counts["phash_chain"] and counts["pkval"] and counts["hintchain"]


# ---------------------------------------------------------------------------
# the model kernels: fp32 math on bf16 or fp32 inputs, so within tolerances
# (tests/test_kernels.py's: flash atol 2e-5 fp32 / 2e-2 bf16 with rtol
# 1e-2, the SSD scan four times those with rtol 2e-2)
# ---------------------------------------------------------------------------

FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _close(got, want, atol, rtol):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,S,H,KV,hd,window,softcap", [
    (1, 128, 4, 4, 32, None, None),       # MHA
    (2, 256, 8, 2, 64, 64, None),         # GQA, sliding window
    (1, 512, 4, 1, 16, None, 30.0),       # MQA, softcap
    (1, 1000, 4, 4, 80, None, None),      # zamba2's head dim, ragged S
    (1, 77, 2, 1, 128, 32, 50.0),         # ragged, window and softcap
    (1, 200, 2, 2, 256, None, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, KV, hd, window,
                                              softcap, dtype):
    g = torch.Generator(device="cpu").manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, h, hd, generator=g).to(cuda, dtype)
               for h in (H, KV, KV))
    reset_launch_counts()
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=True, window=window,
                                        softcap=softcap)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = fa_ref.attention_ref(q, k, v, causal=True, window=window,
                                softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, FLASH_ATOL[dtype], 1e-2)


def test_flash_attention_grad_on_card(cuda):
    """The backward recomputes through the plain version on the card."""
    g = torch.Generator(device="cpu").manual_seed(1)
    q, k, v = (torch.randn(1, 128, 2, 16, generator=g).to(cuda)
               .requires_grad_() for _ in range(3))
    fa_ops.flash_attention(q, k, v, window=48).square().sum().backward()
    torch.cuda.synchronize()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa_ref.attention_ref(q2, k2, v2, window=48).square().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        _close(a.grad, b.grad, 1e-4, 1e-3)


@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 128, 3, 16, 8, 32),
    (1, 256, 2, 64, 64, 128),
    (2, 300, 4, 32, 16, 128),             # ragged: chunks of 128, 128, 44
    (1, 1000, 2, 64, 64, 128),            # ragged
    (1, 96, 2, 128, 32, 128),
    (2, 4096, 80, 64, 64, 128),           # zamba2's scoring shape
    (2, 2700, 80, 64, 64, 128),           # 22 chunks in segments of 3
    (1, 640, 3, 32, 100, 128),            # N padded to 128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_kernel_matches_plain(cuda, B, S, H, hd, N, chunk, dtype,
                                  with_h0):
    g = torch.Generator(device="cpu").manual_seed(S + N)
    x = torch.randn(B, S, H, hd, generator=g).to(cuda, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g)).to(cuda)
    A = -torch.exp(torch.randn(H, generator=g) * 0.3).to(cuda)
    Bc = torch.randn(B, S, N, generator=g).to(cuda, dtype)
    Cc = torch.randn(B, S, N, generator=g).to(cuda, dtype)
    h0 = torch.randn(B, H, hd, N, generator=g).to(cuda) if with_h0 else None
    reset_launch_counts()
    y, h = ssd_ops.ssd(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["ssd"] == 1
    assert ssd_kernel.LAST_ROUTE == ("tc" if dtype == torch.bfloat16
                                     else "simt")
    y2, h2 = ssd_ref.ssd_ref(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)
    atol = 4 * FLASH_ATOL[dtype]
    assert y.dtype == dtype and h.dtype == torch.float32
    _close(y, y2, atol, 2e-2)
    _close(h, h2, atol, 2e-2)


def _ssd_fp64(x, dt, A, Bc, Cc, Q):
    """The chunked SSD in float64, as a yardstick of both fp32 versions:
    (y, the final state)."""
    x, dt, A, Bc, Cc = (t.double() for t in (x, dt, A, Bc, Cc))
    B, S, H, hd = x.shape
    h = torch.zeros(B, H, hd, Bc.shape[-1], dtype=torch.float64,
                    device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xq, dq, bq, cq = (t[:, c0:c0 + Q] for t in (x, dt, Bc, Cc))
        cum = torch.cumsum(dq * A, 1)                        # [B,L,H]
        tri = torch.tril(torch.ones(cum.shape[1], cum.shape[1],
                                    dtype=torch.bool, device=x.device))
        seg = cum[:, :, None] - cum[:, None]
        decay = torch.exp(torch.where(tri[None, :, :, None], seg,
                                      -torch.inf))
        M = torch.einsum("bqn,bsn->bqs", cq, bq)[..., None] * decay \
            * dq[:, None]
        ys.append(torch.einsum("bqsh,bshp->bqhp", M, xq) + torch.einsum(
            "bqn,bhpn,bqh->bqhp", cq, h, torch.exp(cum)))
        rem = torch.exp(cum[:, -1:] - cum) * dq
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bqhp,bqn->bhpn", xq * rem[..., None], bq)
    return torch.cat(ys, 1), h


def test_ssd_kernel_as_accurate_as_plain(cuda):
    """Over a long sequence the log decays |cum| reach ~100 per chunk:
    exp(cum_t - cum_s) turns their rounding into relative errors, so the
    kernel must round cum as the plain version does (in order).  Its
    error against float64 is held to the plain version's."""
    g = torch.Generator(device="cpu").manual_seed(7)
    B, S, H, hd, N = 1, 2048, 16, 64, 64
    x = torch.randn(B, S, H, hd, generator=g).to(cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g)).to(cuda)
    A = -torch.exp(torch.randn(H, generator=g) * 0.3).to(cuda)
    Bc = torch.randn(B, S, N, generator=g).to(cuda)
    Cc = torch.randn(B, S, N, generator=g).to(cuda)
    y64, _ = _ssd_fp64(x, dt, A, Bc, Cc, 128)
    yk, _ = ssd_kernel.ssd_fwd(x, dt, A, Bc, Cc)
    yp, _ = ssd_ref.ssd_ref(x, dt, A, Bc, Cc)
    torch.cuda.synchronize()
    ek, ep = ((y.double() - y64).abs() for y in (yk, yp))
    assert ek.max() <= 1.25 * ep.max(), (float(ek.max()), float(ep.max()))
    assert ek.mean() <= 1.25 * ep.mean(), (float(ek.mean()),
                                           float(ep.mean()))


def test_model_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_fwd(q.cpu(), q.cpu(), q.cpu())
    x = torch.zeros(1, 8, 2, 16, device=cuda)
    dt = torch.zeros(1, 8, 2, device=cuda)
    A = torch.zeros(2, device=cuda)
    bc = torch.zeros(1, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.ssd_fwd(x, dt, A, bc, bc, chunk=0)
    with pytest.raises(ValueError, match="one dtype"):
        ssd_kernel.ssd_fwd(x, dt, A, bc.bfloat16(), bc.bfloat16())


# ---------------------------------------------------------------------------
# the WKV scan and the grouped matmul (tests/test_kernels.py's tolerances:
# WKV atol 4 x (2e-5 fp32, 2e-2 bf16) with rtol 2e-2; gmm atol
# (2e-5, 2e-2) x sqrt(D) with rtol 2e-2)
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, hd, cuda, dtype=torch.float32, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, hd, generator=g).to(cuda, dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, hd, generator=g) * 0.5)
                  ).to(cuda)
    u = (torch.randn(H, hd, generator=g) * 0.1).to(cuda)
    s0 = torch.randn(B, H, hd, hd, generator=g).to(cuda)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (2, 128, 3, 16, 32),
    (1, 40, 2, 64, 32),                   # ragged: chunks of 32 and 8
    (2, 1000, 4, 64, 32),                 # ragged
    (1, 96, 2, 32, 16),
    (1, 65, 2, 128, 32),
    (1, 7, 1, 64, 32),                    # one short chunk
    (2, 4096, 40, 64, 32),                # rwkv6's scoring shape
    (2, 1275, 40, 64, 32),                # 40 chunks in segments of 3
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s0_dtype", [None, torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain(cuda, B, S, H, hd, chunk, dtype,
                                   s0_dtype):
    r, k, v, w, u, s0 = _wkv_inputs(B, S, H, hd, cuda, dtype, seed=S + hd)
    s0 = None if s0_dtype is None else s0.to(s0_dtype)
    reset_launch_counts()
    y, s = wkv_ops.wkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["wkv6"] == 1
    assert wkv_kernel.LAST_ROUTE == ("tc" if dtype == torch.bfloat16
                                     else "simt")
    y2, s2 = wkv_ref.wkv6_ref(r, k, v, w, u, s0=s0, chunk=chunk)
    atol = 4 * FLASH_ATOL[dtype]
    assert y.dtype == dtype and s.dtype == torch.float32
    _close(y, y2, atol, 2e-2)
    _close(s, s2, atol, 2e-2)


def test_wkv6_kernel_strong_decay_is_finite(cuda):
    r, k, v, _, _, _ = _wkv_inputs(1, 64, 2, 64, cuda, seed=3)
    w = torch.full_like(r, 1e-45)
    u = torch.ones(2, 64, device=cuda)
    y, s = wkv_kernel.wkv6_fwd(r, k, v, w, u)
    y2, s2 = wkv_ref.wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, y2, 4 * FLASH_ATOL[torch.float32], 2e-2)
    _close(s, s2, 4 * FLASH_ATOL[torch.float32], 2e-2)


def _wkv_fp64(r, k, v, w, u):
    """The per-step recurrence in float64, as a yardstick of both fp32
    versions."""
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    B, S, H, hd = r.shape
    s = torch.zeros(B, H, hd, hd, dtype=torch.float64, device=r.device)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        ys.append(torch.einsum("bhc,bhcd->bhd", rt, s)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = s * wt[..., None] + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, 1), s


def test_wkv6_kernel_as_accurate_as_plain(cuda):
    """Slow decay over long chunks makes |cum| large: exp(cum_prev_t -
    cum_s) turns its rounding into relative errors, so the kernel must
    round cum as the plain version does.  Its error against float64 is
    held to the plain version's."""
    g = torch.Generator(device="cpu").manual_seed(11)
    B, S, H, hd = 1, 512, 4, 64
    r, k, v = (torch.randn(B, S, H, hd, generator=g).to(cuda)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, hd, generator=g))
                  ).to(cuda)
    u = (torch.randn(H, hd, generator=g) * 0.1).to(cuda)
    y64, s64 = _wkv_fp64(r, k, v, w, u)
    yk, sk = wkv_kernel.wkv6_fwd(r, k, v, w, u)
    yp, sp = wkv_ref.wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    for got, plain, want in ((yk, yp, y64), (sk, sp, s64)):
        ek, ep = ((t.double() - want).abs() for t in (got, plain))
        assert ek.max() <= 1.25 * ep.max(), (float(ek.max()),
                                             float(ep.max()))
        assert ek.mean() <= 1.25 * ep.mean(), (float(ek.mean()),
                                               float(ep.mean()))


def test_wkv6_grad_on_card(cuda):
    """The backward differentiates the plain version on the card."""
    r, k, v, w, u, s0 = (t.requires_grad_() for t in
                         _wkv_inputs(1, 64, 2, 16, cuda, seed=5))
    y, s = wkv_ops.wkv6(r, k, v, w, u, s0=s0)
    (y.square().sum() + s.square().sum()).backward()
    torch.cuda.synchronize()
    ins2 = [t.detach().clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y2, s2 = wkv_ref.wkv6_ref(*ins2[:5], s0=ins2[5])
    (y2.square().sum() + s2.square().sum()).backward()
    for a, b in zip((r, k, v, w, u, s0), ins2):
        _close(a.grad, b.grad, 1e-3, 1e-3)


@pytest.mark.parametrize("E,C,D,F", [
    (4, 64, 32, 48), (2, 128, 64, 64), (8, 32, 16, 16),
    (8, 600, 1000, 700),                  # ragged in every dimension
    (3, 1, 5, 1), (2, 130, 129, 257),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain(cuda, E, C, D, F, dtype):
    g = torch.Generator(device="cpu").manual_seed(E * C + F)
    x = torch.randn(E, C, D, generator=g).to(cuda, dtype)
    w = torch.randn(E, D, F, generator=g).to(cuda, dtype)
    reset_launch_counts()
    got = gmm_ops.gmm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["gmm"] == 1
    want = gmm_ref.gmm_ref(x, w)
    assert got.dtype == dtype and got.shape == (E, C, F)
    _close(got, want, FLASH_ATOL[dtype] * D ** 0.5, 2e-2)


def test_gmm_grad_on_card(cuda):
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(3, 40, 24, generator=g).to(cuda).requires_grad_()
    w = torch.randn(3, 24, 20, generator=g).to(cuda).requires_grad_()
    gmm_ops.gmm(x, w).square().sum().backward()
    x2, w2 = (t.detach().clone().requires_grad_() for t in (x, w))
    gmm_ref.gmm_ref(x2, w2).square().sum().backward()
    for a, b in ((x, x2), (w, w2)):
        _close(a.grad, b.grad, 1e-3, 1e-3)


def test_wkv6_and_gmm_refuse_what_they_do_not_take(cuda):
    r = torch.zeros(1, 8, 2, 24, device=cuda)
    u = torch.zeros(2, 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv_kernel.wkv6_fwd(r, r, r, r, u)
    r = torch.zeros(1, 100, 2, 16, device=cuda)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        wkv_kernel.wkv6_fwd(r, r, r, r, u, chunk=64)
    with pytest.raises(ValueError, match="fp32"):
        wkv_kernel.wkv6_fwd(r, r, r, r.bfloat16(), u)
    x = torch.zeros(2, 4, 3, device=cuda)
    with pytest.raises(ValueError, match="expected x"):
        gmm_kernel.gmm(x, torch.zeros(2, 4, 3, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        gmm_kernel.gmm(x, torch.zeros(2, 3, 5, device=cuda).bfloat16())


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels: gmm's two routes (TMA, plain loads), flash at
# every head dim and mask, and both against float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,D,F,route", [
    (2, 256, 128, 512, "tma"),            # whole tiles (128 x 256, D by 64)
    (2, 600, 1000, 776, "tma"),           # ragged in C, D and F
    (2, 130, 129, 257, "loads"),          # row strides not 16-byte multiples
    (3, 1, 5, 1, "loads"),
    (8, 600, 1000, 700, "loads"),         # F = 700: 1,400-byte rows
])
def test_gmm_bf16_routes(cuda, E, C, D, F, route):
    g = torch.Generator(device="cpu").manual_seed(E + C + D + F)
    x = torch.randn(E, C, D, generator=g).to(cuda, torch.bfloat16)
    w = torch.randn(E, D, F, generator=g).to(cuda, torch.bfloat16)
    reset_launch_counts()
    got = gmm_kernel.gmm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["gmm"] == 1 and gmm_kernel.LAST_ROUTE == route
    want = gmm_ref.gmm_ref(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (E, C, F)
    _close(got, want, FLASH_ATOL[torch.bfloat16] * D ** 0.5, 2e-2)


def test_gmm_fp32_route_is_simt(cuda):
    x = torch.randn(2, 64, 32, device=cuda)
    w = torch.randn(2, 32, 48, device=cuda)
    got = gmm_kernel.gmm(x, w)
    torch.cuda.synchronize()
    assert gmm_kernel.LAST_ROUTE == "simt"
    _close(got, gmm_ref.gmm_ref(x, w), FLASH_ATOL[torch.float32] * 32 ** 0.5,
           2e-2)


@pytest.mark.parametrize("hd", fa_kernel.HEAD_DIMS)
def test_flash_bf16_every_head_dim(cuda, hd):
    """S = 1000: a ragged last key tile (128 keys, 64 at hd=256) and a
    ragged last query tile."""
    g = torch.Generator(device="cpu").manual_seed(hd)
    B, S, H, KV = 2, 1000, 4, 2
    q, k, v = (torch.randn(B, S, h, hd, generator=g).to(cuda, torch.bfloat16)
               for h in (H, KV, KV))
    reset_launch_counts()
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = fa_ref.attention_ref(q, k, v, causal=True)
    _close(got, want, FLASH_ATOL[torch.bfloat16], 1e-2)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,softcap", [
    (1, 300, 4, 4, 64, True, 40, None),   # window inside one key tile
    (1, 700, 2, 1, 128, True, 200, None), # window across tiles
    (2, 513, 8, 2, 80, True, None, None), # GQA, H / KV = 4
    (1, 400, 4, 1, 32, True, None, 30.0), # softcap
    (1, 333, 4, 2, 64, False, None, None),  # no mask
    (1, 300, 2, 2, 256, False, 64, 20.0),
    (3, 1, 4, 2, 80, True, None, None),   # S = 1
    (1, 1, 2, 2, 256, True, 1, 50.0),
])
def test_flash_bf16_masks(cuda, B, S, H, KV, hd, causal, window, softcap):
    g = torch.Generator(device="cpu").manual_seed(S * hd + H)
    q, k, v = (torch.randn(B, S, h, hd, generator=g).to(cuda, torch.bfloat16)
               for h in (H, KV, KV))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa_kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa_ref.attention_ref(q, k, v, **kw)
    _close(got, want, FLASH_ATOL[torch.bfloat16], 1e-2)


def test_flash_bf16_refuses_misaligned(cuda):
    buf = torch.zeros(1 * 8 * 2 * 16 + 1, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 2, 16)
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.flash_attention_fwd(q, q, q)


def _attention_fp64(q, k, v):
    """Causal GQA attention in float64, as a yardstick of both versions."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qd = q.double()
    kd, vd = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bshd->bhqs", qd, kd) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, vd)


def test_tensor_core_kernels_as_accurate_as_plain(cuda):
    """Error against float64, mean over the output, held to 1.5x the plain
    bf16 version's.  Both sum in fp32 and round the output to bf16, and
    flash keeps P as two bf16 parts (~2^-17 of each weight), as the scans
    keep M, att, the decayed operands and the state, so the output's
    rounding dominates both errors: they should be about equal.
    The factor leaves room for the kernels' other order of summation and
    base-2 or fast exponentials, not for a second rounding of P (which
    alone would add an error of the output rounding's size, ~1.3x in the
    mean).
    The scans' final states stay fp32, so no output rounding hides their
    products': two bf16 parts hold each operand to ~2^-17 where fp32 holds
    it to 2^-24, so a state's error, mean and max, is held to 2^7 times
    the plain version's (tests/test_torch_scans.py's rule); a state
    product rounded once to bf16 (2^-9) would be ~2^15 times."""
    g = torch.Generator(device="cpu").manual_seed(13)
    bf = torch.bfloat16
    x = torch.randn(4, 256, 512, generator=g).to(cuda, bf)
    w = torch.randn(4, 512, 384, generator=g).to(cuda, bf)
    y64 = torch.einsum("ecd,edf->ecf", x.double(), w.double())
    yk, yp = gmm_kernel.gmm(x, w), gmm_ref.gmm_ref(x, w)
    q = torch.randn(1, 1024, 8, 128, generator=g).to(cuda, bf)
    k, v = (torch.randn(1, 1024, 2, 128, generator=g).to(cuda, bf)
            for _ in range(2))
    o64 = _attention_fp64(q, k, v)
    ok = fa_kernel.flash_attention_fwd(q, k, v, causal=True)
    op = fa_ref.attention_ref(q, k, v, causal=True)
    # the scans: bf16 inputs (dt, A, w and u fp32), float64 yardsticks
    sx = torch.randn(1, 1024, 8, 64, generator=g).to(cuda, bf)
    sdt = torch.nn.functional.softplus(
        torch.randn(1, 1024, 8, generator=g)).to(cuda)
    sA = -torch.exp(torch.randn(8, generator=g) * 0.3).to(cuda)
    sB, sC = (torch.randn(1, 1024, 64, generator=g).to(cuda, bf)
              for _ in range(2))
    s64, sh64 = _ssd_fp64(sx, sdt, sA, sB, sC, 128)
    sk, shk = ssd_kernel.ssd_fwd(sx, sdt, sA, sB, sC)
    assert ssd_kernel.LAST_ROUTE == "tc"
    sp, shp = ssd_ref.ssd_ref(sx, sdt, sA, sB, sC)
    wr, wk, wv = (torch.randn(1, 512, 4, 64, generator=g).to(cuda, bf)
                  for _ in range(3))
    ww = torch.exp(-torch.exp(torch.randn(1, 512, 4, 64, generator=g))
                   ).to(cuda)
    wu = (torch.randn(4, 64, generator=g) * 0.1).to(cuda)
    w64, ws64 = _wkv_fp64(wr, wk, wv, ww, wu)
    wkk, wsk = wkv_kernel.wkv6_fwd(wr, wk, wv, ww, wu)
    assert wkv_kernel.LAST_ROUTE == "tc"
    wp, wsp = wkv_ref.wkv6_ref(wr, wk, wv, ww, wu)
    torch.cuda.synchronize()
    for name, got, plain, want in (("gmm", yk, yp, y64),
                                   ("flash", ok, op, o64),
                                   ("ssd", sk, sp, s64),
                                   ("wkv6", wkk, wp, w64)):
        ek, ep = ((t.double() - want).abs().mean() for t in (got, plain))
        assert ek <= 1.5 * ep, (name, float(ek), float(ep))
    for name, got, plain, want in (("ssd h", shk, shp, sh64),
                                   ("wkv6 S", wsk, wsp, ws64)):
        assert got.dtype == plain.dtype == torch.float32, name
        ek, ep = ((t.double() - want).abs() for t in (got, plain))
        assert ek.mean() <= 128 * ep.mean(), (name, float(ek.mean()),
                                              float(ep.mean()))
        assert ek.max() <= 128 * ep.max(), (name, float(ek.max()),
                                            float(ep.max()))


# ---------------------------------------------------------------------------
# the decoder families: qwen3-moe and gemma3 on the card against the CPU,
# and gmm at the dense MoE route's shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "gemma3_12b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_smoke_forward_on_card_matches_cpu(cuda, arch, dtype):
    """The smoke model's scoring forward with the kernels on the card (one
    flash launch a layer, three gmm launches a MoE layer; S = 40 is past
    gemma3's window of 16) against the same parameters' plain path on the
    CPU: fp32 within 1e-3; bf16 within 1.5x the host's own bf16-vs-fp32
    gap plus 1e-3 (relative L2, chip_smoke.py's noise rule)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import forward, init_params, param_specs
    from repro_torch.models.params import tree_map
    cfg = get_smoke_config(arch).derive(dtype=dtype)
    host = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)
                                            ).astype(np.int32)
    reset_launch_counts()
    got, _ = forward(card, {"tokens": tok}, cfg=cfg, use_kernels=True,
                     device=cuda)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["gmm"] == (3 * cfg.n_layers if cfg.is_moe else 0)
    want, _ = forward(host, {"tokens": tok}, cfg=cfg, use_kernels=True,
                      device="cpu")
    got = got.cpu()
    assert torch.isfinite(got).all() and got.shape == want.shape
    if dtype == "float32":
        _close(got, want, 1e-3, 1e-3)
        return
    fp32, _ = forward(host, {"tokens": tok}, cfg=cfg.derive(dtype="float32"),
                      device="cpu")

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    assert rel(got, want) <= 1.5 * rel(want, fp32) + 1e-3


def test_gmm_at_the_dense_moe_shape_with_ragged_tokens(cuda):
    """qwen3-moe's dense route at T = 1,000 tokens: every token through
    all 128 experts, so C = 1,000 rows, not a multiple of the kernel's
    128-row tiles; the up projection (D = 2048 -> F = 768) and the down
    projection (768 -> 2048), both on the TMA route.  The weights are
    scaled by 1/sqrt(fan_in), as a model's are, so the products' RMS is
    about 1: atol is 2e-2 of the plain output's RMS (sqrt(D) in the tests
    above is that RMS for products of unit normals), rtol 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(1000)
    bf = torch.bfloat16
    E, T, D, F = 128, 1000, 2048, 768
    x = torch.randn(1, T, D, generator=g, device=cuda).to(bf).expand(
        E, T, D).contiguous()
    wi = (torch.randn(E, D, F, generator=g, device=cuda) * D ** -0.5).to(bf)
    wo = (torch.randn(E, F, D, generator=g, device=cuda) * F ** -0.5).to(bf)
    h = gmm_ops.gmm(x, wi)
    for a, w in ((x, wi), (torch.nn.functional.silu(h), wo)):
        reset_launch_counts()
        y = gmm_ops.gmm(a, w)
        torch.cuda.synchronize()
        assert launch_counts()["gmm"] == 1 and gmm_kernel.LAST_ROUTE == "tma"
        assert y.shape == (E, T, w.shape[2]) and y.dtype == bf
        want = gmm_ref.gmm_ref(a, w)
        _close(y, want, FLASH_ATOL[bf] * float(
            want.float().pow(2).mean().sqrt()), 2e-2)


# ---------------------------------------------------------------------------
# training: the float kernels' Functions and a smoke train step on the card
# against the CPU
# ---------------------------------------------------------------------------

def _function_case(kernel):
    """(fp32 inputs on the host, the op, the launch counter's name) at
    smoke shapes the kernels take."""
    g = torch.Generator().manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g)
    if kernel == "flash_attention":
        ins = [randn(1, 64, 4, 16), randn(1, 64, 2, 16), randn(1, 64, 2, 16)]
        return ins, lambda q, k, v: fa_ops.flash_attention(q, k, v), kernel
    if kernel in ("ssd", "ssd_h0"):
        ins = [randn(1, 64, 2, 16),
               torch.nn.functional.softplus(randn(1, 64, 2)),
               -torch.exp(0.3 * randn(2)), randn(1, 64, 16), randn(1, 64, 16)]
        if kernel == "ssd_h0":
            ins.append(randn(1, 2, 16, 16))
        return ins, lambda x, dt, A, Bc, Cc, *h0: ssd_ops.ssd(
            x, dt, A, Bc, Cc, h0=h0[0] if h0 else None, chunk=16), "ssd"
    if kernel == "wkv6":
        ins = [randn(1, 64, 2, 16), randn(1, 64, 2, 16), randn(1, 64, 2, 16),
               torch.exp(-torch.exp(0.5 * randn(1, 64, 2, 16))),
               0.1 * randn(2, 16), randn(1, 2, 16, 16)]
        return ins, lambda r, k, v, w, u, s0: wkv_ops.wkv6(
            r, k, v, w, u, s0=s0), kernel
    ins = [randn(3, 40, 24), randn(3, 24, 20)]
    return ins, gmm_ops.gmm, "gmm"


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd", "ssd_h0",
                                    "wkv6", "gmm"])
def test_kernel_function_gradients_on_card_match_cpu(cuda, kernel):
    """Each float kernel's autograd Function trains on the card: its
    forward launches the kernel once, its backward launches none (it
    differentiates the plain version, as the reference's ``custom_vjp``
    does), and outputs and gradients agree with the same Function on the
    CPU (the plain version throughout), fp32: atol 1e-3 and rtol 1e-3,
    rtol 2e-2 for the two scans (their kernels' own rtol against the
    plain version, ``WKV_TOL``/``SSD_TOL`` in chip_smoke.py: the
    gradients are the plain backward applied to the kernel's outputs)."""
    ins, op, name = _function_case(kernel)
    rtol = 2e-2 if name in ("ssd", "wkv6") else 1e-3

    def run(dev):
        ts = [t.to(dev).requires_grad_() for t in ins]
        reset_launch_counts()
        out = op(*ts)
        outs = out if isinstance(out, tuple) else (out,)
        fwd = launch_counts()
        grads = torch.autograd.grad(sum(o.square().sum() for o in outs), ts)
        if dev != "cpu":
            torch.cuda.synchronize()
        return outs, grads, fwd, launch_counts()

    outs, grads, fwd, total = run(cuda)
    assert fwd[name] == 1 and sum(fwd.values()) == 1 and total == fwd
    want_outs, want_grads, _, _ = run("cpu")
    for got, want in zip(outs + grads, want_outs + want_grads):
        _close(got.cpu(), want, 1e-3, rtol)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "gemma3_12b",
                                  "zamba2_2_7b", "rwkv6_3b"])
def test_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """One ``train_step_fn`` with the kernels on the card against the same
    step on the CPU (the kernels' plain versions), fp32, the decoder
    families under ``remat="full"``: exact launches (the decoder's flash
    and gmm twice, forward and recompute), the loss within rtol 1e-4, the
    parameters within 1e-5.  AdamW's eps is 1e-3, as in
    ``tests/test_torch_train.py``: at the default 1e-8 a gradient within
    rounding of zero steps by up to lr either way on either device."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.parallel.sharding import MeshPolicy
    from repro_torch.train import OptConfig, adamw_init, train_step_fn
    cfg = get_smoke_config(arch).derive(dtype="float32", remat="full")
    host = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    # a copy: the step updates its parameters in place
    card = tree_map(lambda t: t.to(cuda, copy=True), host)
    batch = synthetic_batch(2, 32, cfg.vocab_size, step=0, device="cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=2, eps=1e-3)
    L = cfg.n_layers
    if cfg.family == "hybrid":
        want = {"flash_attention": L // cfg.shared_attn_every, "ssd": L}
    elif cfg.family == "ssm":
        want = {"wkv6": L}
    else:
        want = {"flash_attention": 2 * L, "gmm": 6 * L if cfg.is_moe else 0}
    reset_launch_counts()
    _, _, got = train_step_fn(card, adamw_init(card), {
        k: v.to(cuda) for k, v in batch.items()}, cfg=cfg,
        policy=MeshPolicy(), opt=opt, use_kernels=True, device=cuda)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k: n for k, n in counts.items() if n} == \
        {k: n for k, n in want.items() if n}
    _, _, loss = train_step_fn(host, adamw_init(host), batch, cfg=cfg,
                               policy=MeshPolicy(), opt=opt,
                               use_kernels=True, device="cpu")
    assert abs(float(got) / float(loss) - 1) <= 1e-4
    for a, b in zip(tree_leaves(card), tree_leaves(host)):
        _close(a.cpu(), b, 1e-5, 0.0)


# ---------------------------------------------------------------------------
# the multi-device layer on one rank: NCCL, a (1, 1) mesh
# ---------------------------------------------------------------------------

def test_one_rank_nccl_mesh_takes_the_dense_route_and_one_stage(cuda):
    """A one-rank NCCL group and ``make_host_mesh()``: qwen3-moe's smoke
    MoE layer with the kernels on that mesh is the ``mesh=None`` layer
    bitwise (a model axis of 1 is the dense route, three gmm launches),
    ``shard_constraint`` returns its input, and ``pipeline_apply`` with one
    stage equals the layers in sequence."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_host_group, make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models import moe as t_moe
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import MeshPolicy, shard_constraint
    owns = init_host_group(cuda)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_host_mesh()
        cfg = get_smoke_config("qwen3_moe_30b_a3b")
        gen = torch.Generator(device=cuda).manual_seed(0)
        p = init_params(t_moe.moe_specs(cfg), gen, device=cuda)
        x = torch.randn(2, 64, cfg.d_model, generator=gen, device=cuda
                        ).to(torch.bfloat16)
        reset_launch_counts()
        got = t_moe.moe_apply(p, x, cfg=cfg, policy=MeshPolicy(), mesh=mesh,
                              use_kernels=True)
        assert launch_counts()["gmm"] == 3
        want = t_moe.moe_apply(p, x, cfg=cfg, policy=MeshPolicy(),
                               use_kernels=True)
        assert torch.equal(got, want)
        assert shard_constraint(got, ("batch", "seq", "act_embed"),
                                MeshPolicy(), mesh) is got
        stages = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
        w = torch.randn(1, 3, 64, 64, generator=gen, device=cuda) * 0.1
        h = torch.randn(4, 2, 64, generator=gen, device=cuda)
        out = pipeline_apply(lambda lp, a: torch.tanh(a @ lp), w, h,
                             mesh=stages)
        for i in range(3):
            h = torch.tanh(h @ w[0, i])
        assert torch.equal(out, h)
    finally:
        if owns:
            dist.destroy_process_group()


def test_dry_run_rank_on_card_matches_its_prediction(cuda):
    """``chip_smoke.py`` phase 17 at 2 layers of qwen3-moe: the dry run's
    ``run_cell(fast=True)`` prediction of rank 0 on the fake group of 256
    ranks, then that rank's prefill step (flash and gmm on the
    expert-parallel route) and decode step (gmm) on the card: the FLOPs
    counted over the real step equal the prediction's, every launch is
    held to its plain version, and the measured peak is within a factor
    of 2 of the predicted executed peak."""
    import importlib.util
    from pathlib import Path
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("qwen3_moe_30b_a3b").derive(n_layers=2)
    for shape, launched in (("prefill_32k", {"flash_attention", "gmm"}),
                            ("decode_32k", {"gmm"})):
        pred = run_cell("qwen3_moe_30b_a3b", shape, multi_pod=False,
                        fast=True, cfg_override=cfg)
        res = smoke.dryrun_rank(pred, cfg, 0, cuda, "test")["measured"]
        assert set(res["launches"]) == launched
        assert res["flops"] == pred["cost_raw"]["flops"]
        assert {k: c["launches"] for k, c in res["checked"].items()} == \
            res["launches"]
        assert 0.5 < res["peak_over_predicted"] < 2.0
