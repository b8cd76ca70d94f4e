"""The port's kernel families against the JAX package, on the CPU.

For phash, phash_chain, pkval, hintchain and treeagg the port's plain
PyTorch version (what a CPU tensor runs) must be bit-equal to the JAX
kernel run in interpret mode and to the JAX package's numpy reference, on
the same seeded inputs: empty input, N not a power of two, depth 0,
tombstones, AMBIG buckets, padding parents, cleared slots, wrapping sums
and an index or table that has grown.  The CUDA
kernels themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import repro.core.columnar as r_col
import repro.core.store as r_store
import repro.kernels.hintchain.ops as r_hc_ops
import repro.kernels.hintchain.ref as r_hc_ref
import repro.kernels.phash.ops as r_ph_ops
import repro.kernels.phash.ref as r_ph_ref
import repro.kernels.pkval.kernel as r_pk_kernel
import repro.kernels.pkval.ops as r_pk_ops
import repro.kernels.pkval.ref as r_pk_ref
import repro.kernels.treeagg.ops as r_ta_ops
import repro.kernels.treeagg.ref as r_ta_ref
import repro_torch.core.batch_planner as t_planner
import repro_torch.core.columnar as t_col
import repro_torch.core.store as t_store
import repro_torch.kernels.hintchain.ops as t_hc_ops
import repro_torch.kernels.phash.kernel as t_ph_kernel
import repro_torch.kernels.phash.ops as t_ph_ops
import repro_torch.kernels.pkval.ops as t_pk_ops
import repro_torch.kernels.pkval.ref as t_pk_ref
import repro_torch.kernels.treeagg.ops as t_ta_ops
from repro_torch.core.workload import ColumnarTrace, name_hash32

CPU = torch.device("cpu")


def _u32(rng, shape, hi=2**32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# phash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4097])
def test_phash_matches_jax_kernel_and_ref(n):
    rng = np.random.default_rng(n)
    keys = _u32(rng, n)
    out = t_ph_ops.phash_partitions(keys, 64, device=CPU)
    assert out.dtype == np.int32 and out.shape == (n,)
    assert np.array_equal(out, r_ph_ops.phash_partitions(keys, 64))
    assert np.array_equal(out, r_ph_ref.phash_ref(keys, 64))


@pytest.mark.parametrize("n_partitions", [1, 7, 64, 1000])
def test_phash_equals_scalar_store_hash(n_partitions):
    """Placement agrees with the store's own hash for integer keys, keys
    wider than 32 bits included (both hash the low 32 bits)."""
    rng = np.random.default_rng(n_partitions)
    keys = [int(k) for k in rng.integers(0, 2**40, size=600)] + [0, 1, 2**32]
    out = t_ph_ops.phash_partitions(keys, n_partitions, device=CPU)
    want = [t_store._hash_key(k) % n_partitions for k in keys]
    assert out.tolist() == want
    assert want == [r_store._hash_key(k) % n_partitions for k in keys]


def _chains(rng, n, d=16):
    par = _u32(rng, (n, d))
    nam = _u32(rng, (n, d))
    hints = _u32(rng, n)
    depths = rng.integers(0, d + 1, size=n).astype(np.int32)
    if n:
        depths[0] = 0                       # a row of depth 0
    for i in range(n):                      # zero past the depth, as lowered
        par[i, depths[i]:] = 0
        nam[i, depths[i]:] = 0
    return par, nam, hints, depths


@pytest.mark.parametrize("n", [0, 5, 300, 513])
def test_phash_chain_matches_jax_kernel_and_ref(n):
    par, nam, hints, depths = _chains(np.random.default_rng(n + 1), n)
    got = t_ph_ops.phash_chains(par, nam, hints, depths, 64, device=CPU)
    jax_out = r_ph_ops.phash_chains(par, nam, hints, depths, 64)
    ref_out = r_ph_ref.phash_chain_ref(par, nam, hints, depths, 64)
    for g, j, r in zip(got, jax_out, ref_out):
        assert g.dtype == np.asarray(j).dtype
        assert np.array_equal(g, np.asarray(j))
        assert np.array_equal(g, np.asarray(r)[:n])


@pytest.mark.parametrize("n", [100, 600])
def test_planner_chain_partitions_both_sides_of_gate(n):
    """Below PHASH_MIN_BATCH the planner hashes on the host with the scalar
    store hash; above it, one launch.  Both equal the JAX reference."""
    par, nam, hints, depths = _chains(np.random.default_rng(n), n)
    ct = ColumnarTrace(n=n, max_depth=16, type_ids=np.zeros(n, np.int32),
                       depths=depths, parent_ids=par.astype(np.int64),
                       name_hashes=nam.astype(np.int64),
                       hint_ids=hints.astype(np.int64))
    comp, hint_parts, sigs, used = t_planner._chain_partitions(
        ct, 64, device=CPU)
    assert used == (n >= t_planner.PHASH_MIN_BATCH)
    ref = r_ph_ref.phash_chain_ref(par, nam, hints, depths, 64)
    for g, r in zip((comp, hint_parts, sigs), ref):
        assert np.array_equal(np.asarray(g), r)


def test_kernel_binding_refuses_host_tensors():
    """A wrapper takes its plain version only for a CPU tensor; the CUDA
    binding itself never runs anything for one."""
    with pytest.raises(ValueError):
        t_ph_kernel.phash(torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# hash index: the same script gives the same arrays in both packages
# ---------------------------------------------------------------------------

def _index_script(seed, n=400):
    rng = np.random.default_rng(seed)
    ops = []
    live = []
    for i in range(n):
        if live and rng.random() < 0.2:
            ops.append(("rm",) + live.pop(int(rng.integers(len(live)))))
        else:
            key = (int(rng.integers(1, 5_000)), name_hash32(f"e{seed}_{i}"))
            val = r_col.AMBIG if rng.random() < 0.05 else i + 2
            ops.append(("set", *key, val))
            live.append(key)
    return ops


def _apply(idx, ops):
    for op in ops:
        if op[0] == "set":
            idx.set(op[1], op[2], op[3])
        else:
            idx.remove(op[1], op[2])
    return idx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_index_bit_equal_to_reference(seed):
    ops = _index_script(seed)
    ref = _apply(r_col.HashIndex(), ops)
    port = _apply(t_col.HashIndex(), ops)
    assert port.cap == ref.cap > 64          # the index grew
    assert (port.used, port.live) == (ref.used, ref.live)
    for a, b in zip(port.arrays(), ref.arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (t_col.EMPTY, t_col.TOMB, t_col.AMBIG, t_col.MAX_PROBE) == \
        (r_col.EMPTY, r_col.TOMB, r_col.AMBIG, r_col.MAX_PROBE)
    assert t_pk_ref.MAX_PROBE == r_pk_kernel.MAX_PROBE


def test_hash_index_device_mirror_follows_host():
    """The mirror is refreshed from the slots written since the last use,
    and copied whole after a growth."""
    ops = _index_script(7, n=600)
    idx = t_col.HashIndex()

    def check():
        tp, tn, tv = idx.device_arrays(CPU)
        assert np.array_equal(tp.numpy(), idx.par)
        assert np.array_equal(tn.numpy().view(np.uint32), idx.nam)
        assert np.array_equal(tv.numpy(), idx.val)

    caps = set()
    for k in range(0, len(ops), 50):
        _apply(idx, ops[k:k + 50])
        caps.add(idx.cap)
        check()
    assert len(caps) > 1                      # growths happened in between
    mirror = idx.device_arrays(CPU)
    idx.set(3, 4, 5)                           # an incremental update
    assert idx.device_arrays(CPU) is mirror
    check()


def test_hash_index_mirror_under_concurrent_writers():
    """Writers on several threads (growths included) race a thread that
    refreshes the mirror: no write may be lost from it."""
    import os
    import sys
    import threading
    idx = t_col.HashIndex()
    n_writers = 2 * (os.cpu_count() or 2)
    stop = threading.Event()
    errors = []

    def writer(w):
        try:
            for i in range(300):
                idx.set(w + 1, name_hash32(f"k{w}_{i}"), i + 2)
                if i % 3 == 0:
                    idx.remove(w + 1, name_hash32(f"k{w}_{i // 2}"))
        except Exception as e:          # reported by the assert below
            errors.append(e)

    def refresher():
        try:
            while not stop.is_set():
                idx.device_arrays(CPU)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        r = threading.Thread(target=refresher)
        r.start()
        ws = [threading.Thread(target=writer, args=(w,))
              for w in range(n_writers)]
        for t in ws:
            t.start()
        for t in ws:
            t.join(timeout=60)
        stop.set()
        r.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not r.is_alive() and not any(t.is_alive() for t in ws)
    assert not errors
    tp, tn, tv = idx.device_arrays(CPU)
    assert np.array_equal(tp.numpy(), idx.par)
    assert np.array_equal(tn.numpy().view(np.uint32), idx.nam)
    assert np.array_equal(tv.numpy(), idx.val)
    assert idx.live == int((idx.par >= 0).sum())


# ---------------------------------------------------------------------------
# pkval
# ---------------------------------------------------------------------------

def _probes(ops, rng, n):
    keys = [(op[1], op[2]) for op in ops if op[0] == "set"]
    par = np.empty(n, np.int64)
    nam = np.empty(n, np.int64)
    for i in range(n):
        r = rng.random()
        if r < 0.6:                           # live, removed or AMBIG keys
            par[i], nam[i] = keys[int(rng.integers(len(keys)))]
        elif r < 0.9:                         # misses
            par[i], nam[i] = int(rng.integers(6_000, 9_000)), \
                name_hash32(f"miss{i}")
        else:                                 # padding parents
            par[i], nam[i] = -1, name_hash32(f"pad{i}")
    return par, nam


@pytest.mark.parametrize("n", [0, 1, 129, 1000])
def test_pkval_matches_jax_kernel_and_ref(n):
    ops = _index_script(3)
    ridx = _apply(r_col.HashIndex(), ops)
    tidx = _apply(t_col.HashIndex(), ops)
    par, nam = _probes(ops, np.random.default_rng(n), n)
    tp, tn, tv = tidx.device_arrays(CPU)
    got = t_pk_ops.pkval_lookup(tp, tn, tv, par, nam)
    rtp, rtn, rtv = ridx.arrays()
    assert got.dtype == np.int32 and got.shape == (n,)
    assert np.array_equal(got, r_pk_ops.pkval_lookup(rtp, rtn, rtv, par, nam))
    assert np.array_equal(got, r_pk_ref.pkval_ref(
        rtp, rtn, rtv, par.astype(np.int32), nam.astype(np.uint32)))
    if n > 100:                                # every case is covered
        assert {-1, r_col.AMBIG} <= set(got.tolist())
        assert (got > 0).any() and (par < 0).any()
    for i in range(n):                         # the host index agrees
        want = tidx.get(int(par[i]), int(nam[i])) if par[i] >= 0 else -1
        assert int(got[i]) == want


# ---------------------------------------------------------------------------
# hintchain
# ---------------------------------------------------------------------------

def _tree_tables(seed, n_ops, d=16):
    """A random tree of inode ids, the client cache knowing some edges and
    the fallback cache others (some in both, with disagreeing and AMBIG
    values), and every op a walk down it, cut short at random."""
    rng = np.random.default_rng(seed)
    children = {1: []}
    edges = []
    for iid in range(2, 400):
        par = int(rng.choice(list(children)))
        name = f"n{iid}"
        children[par].append((name, iid))
        children[iid] = []
        edges.append((par, name, iid))
    client, fallback = [], []
    for par, name, iid in edges:
        r = rng.random()
        if r < 0.45:
            client.append((par, name, iid))
        elif r < 0.85:
            fallback.append((par, name, iid))
        elif r < 0.9:
            client.append((par, name, r_col.AMBIG))
            fallback.append((par, name, iid))
        elif r < 0.95:
            fallback.append((par, name, r_col.AMBIG))
    names = np.zeros((n_ops, d), np.uint32)
    depths = np.zeros(n_ops, np.int32)
    for i in range(n_ops):
        cur, k = 1, 0
        want = int(rng.integers(0, d + 1))
        while k < want and children[cur]:
            name, nxt = children[cur][int(rng.integers(len(children[cur])))]
            if rng.random() < 0.05:
                name = f"stranger{i}"
            names[i, k] = name_hash32(name)
            cur, k = nxt, k + 1
        depths[i] = k
    return client, fallback, names, depths


def _hindex(mod, entries):
    idx = mod.HashIndex()
    for par, name, iid in entries:
        idx.set(par, name_hash32(name), iid)
    return idx


@pytest.mark.parametrize("n", [0, 3, 200])
def test_hintchain_matches_jax_kernel_and_ref(n):
    client, fallback, names, depths = _tree_tables(n, n)
    # tombstones: entries set, then removed again
    extra = [(1, f"gone{k}", 900 + k) for k in range(20)]
    rc, rf = _hindex(r_col, client + extra), _hindex(r_col, fallback)
    tc, tf = _hindex(t_col, client + extra), _hindex(t_col, fallback)
    for idx in (rc, tc):
        for par, name, _ in extra:
            idx.remove(par, name_hash32(name))
    child, src = t_hc_ops.hintchain_resolve(tc.arrays(), tf.arrays(), names,
                                            depths, device=CPU, root_id=1)
    jchild, jsrc = r_hc_ops.hintchain_resolve(rc.arrays(), rf.arrays(),
                                              names, depths, root_id=1)
    rchild, rsrc = r_hc_ref.hintchain_ref(*rc.arrays(), *rf.arrays(),
                                          names, depths, root_id=1)
    assert child.shape == src.shape == (n, 16)
    assert np.array_equal(child, np.asarray(jchild))
    assert np.array_equal(src, np.asarray(jsrc))
    assert np.array_equal(child, rchild) and np.array_equal(src, rsrc)
    if n > 100:
        seen = set(child.ravel().tolist())
        assert {-1, -2, r_col.AMBIG} <= seen
        assert {0, 1, -1} <= set(src.ravel().tolist())
        assert (child[depths == 0] == -2).all()


# ---------------------------------------------------------------------------
# treeagg
# ---------------------------------------------------------------------------

def _wave_slots(seed, c, w, *, big_sizes=False):
    """A sorted wave of w ids and c slots: children of wave members,
    of other ids, and cleared slots (parent -1, is_dir/size 0)."""
    rng = np.random.default_rng(seed)
    pool = np.arange(2, 4 * w + 40)
    wave = np.sort(rng.choice(pool, size=w, replace=False)).astype(np.int32)
    r = rng.random(c)
    par = rng.choice(pool, size=c).astype(np.int32)
    if w:
        member = r < 0.6
        par[member] = rng.choice(wave, size=int(member.sum()))
    cleared = r > 0.9
    par[cleared] = -1
    isdir = (rng.random(c) < 0.3).astype(np.int32)
    hi = 2**31 - 1 if big_sizes else 1000
    size = rng.integers(0, hi, size=c).astype(np.int32)
    isdir[cleared] = 0
    size[cleared] = 0
    return wave, par, isdir, size


@pytest.mark.parametrize("c,w,big", [(0, 3, False), (5, 0, False),
                                     (1, 1, False), (300, 17, False),
                                     (1000, 64, False), (2049, 1, False),
                                     (777, 5, True)])
def test_treeagg_matches_jax_kernel_and_ref(c, w, big):
    wave, par, isdir, size = _wave_slots(c + w, c, w, big_sizes=big)
    got = [t.numpy() for t in t_ta_ops.treeagg(
        *(torch.from_numpy(a) for a in (wave, par, isdir, size)))]
    jax_out = r_ta_ops.treeagg_expand(wave, par, isdir, size, interpret=True)
    ref_out = r_ta_ref.treeagg_ref(wave, par, isdir, size)
    for g, j, r, n in zip(got, jax_out, ref_out, (c, w, w, w)):
        assert g.dtype == np.int32 and g.shape == (n,)
        assert np.array_equal(g, np.asarray(j))
        assert np.array_equal(g, r)
    if c > 100 and w > 1:                   # hits, misses and cleared slots
        assert (got[0] >= 0).any() and (got[0] == -1).any()
        assert got[1].sum() == (got[0] >= 0).sum()
    if big:                                 # the int32 size sums wrapped
        assert (got[3] < 0).any()


def _columnar_pair(n_dirs=40, files_per_dir=8):
    """The same namespace in a JAX-package and a port columnar store."""
    import repro.core as R
    import repro.core.workload as r_wl
    import repro_torch.core as T
    import repro_torch.core.workload as t_wl
    out = []
    for core, col, wl, kw in ((R, r_col, r_wl, {}),
                              (T, t_col, t_wl, {"device": "cpu"})):
        store = col.ColumnarMetadataStore(n_datanodes=4, **kw)
        core.format_fs(store)
        cluster = core.NamenodeCluster(store, 2)
        ns = wl.SyntheticNamespace(wl.NamespaceSpec(), n_dirs=n_dirs,
                                   files_per_dir=files_per_dir)
        core.materialize_namespace(cluster.namenodes[0], ns)
        out.append((store, cluster, core))
    return out


def _same_expansion(rstore, tstore, wave):
    r = r_col.expand_wave(rstore, wave)
    t = t_col.expand_wave(tstore, wave)
    assert (r is None) == (t is None)
    if r is None:
        return None
    assert r.used
    for name in ("wave", "counts", "dirs", "sizes", "child_ids",
                 "child_dir_ids"):
        a, b = getattr(r, name), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    return t


def test_expand_wave_matches_reference_as_the_table_changes():
    """Waves over the same tables give the same children and sums in both
    packages: on the first use of the port's hot-column mirror, after
    single-row changes (the dirty-slot refresh), and after the table's
    slot arrays grew (the whole copy)."""
    (rstore, rcl, _), (tstore, tcl, _) = _columnar_pair()
    inode = tstore.table("inode")
    dirs = [r["id"] for part in inode.parts for r in part.values()
            if r["is_dir"]]
    waves = [[1], dirs, dirs[::3], [10**6], dirs[:5] + [10**6]]
    for wave in waves:
        assert _same_expansion(rstore, tstore, wave) is not None
    assert inode.n_rows >= t_col.TREEAGG_MIN_BATCH
    for cl in (rcl, tcl):                       # single-row changes
        nn = cl.namenodes[1]
        nn.perform("mkdirs", "/w/extra/deeper")
        nn.perform("create", "/w/extra/deeper/f")
        nn.perform("delete_subtree", "/w/extra")
        nn.perform("create", "/w/late")
    cap = inode._cap
    for wave in waves:
        _same_expansion(rstore, tstore, wave)
    for cl in (rcl, tcl):                       # a growth of the slots
        cl.namenodes[0].perform("mkdirs", "/bulk")
    import repro.core as R
    import repro_torch.core as T
    R.materialize_big_dir(rcl.namenodes[0], "/bulk2", 600)
    T.materialize_big_dir(tcl.namenodes[0], "/bulk2", 600)
    assert inode._cap > cap
    bulk = inode.get((1, "bulk2"))["id"]
    t = _same_expansion(rstore, tstore, [bulk] + dirs[:4])
    assert t.n_children >= 600


def test_expand_wave_gate_and_dict_store():
    """Below the slot-count gate, and on the dict store, no launch."""
    import repro_torch.core as T
    for cls in (t_col.ColumnarMetadataStore, T.MetadataStore):
        store = cls(n_datanodes=4, device="cpu")
        T.format_fs(store)
        T.NamenodeCluster(store, 1).namenodes[0].perform("mkdirs", "/a/b/c")
        assert t_col.expand_wave(store, [1]) is None
        small = t_col.expand_wave(store, [1], min_batch=1)
        if cls is T.MetadataStore:
            assert small is None
        else:
            assert small.n_children == 1 and len(small.child_dir_ids) == 1


def test_inode_hot_column_mirror_follows_host():
    """The hot columns' mirror equals the host columns after puts,
    deletes and growths of the slot arrays, refreshed incrementally."""
    import repro_torch.core.tables as t_tables
    t = t_col.ColumnarTable(t_tables.INODE, 8)
    rng = np.random.default_rng(11)
    live = []

    def check():
        cols = t.device_columns(CPU)
        for c in ("id", "parent_id", "is_dir", "size"):
            want = t._for_device(c, t.hot_column(c))
            assert cols[c].dtype == (torch.int64 if c == "id"
                                     else torch.int32)
            assert np.array_equal(cols[c].numpy(), want), c

    caps = set()
    for step in range(12):
        for i in range(40):
            if live and rng.random() < 0.3:
                t.delete(live.pop(int(rng.integers(len(live)))))
            else:
                iid = 100 * step + i + 2
                row = t_tables.make_inode(iid, int(rng.integers(1, 50)),
                                          f"n{iid}", bool(rng.random() < .3))
                row["size"] = int(rng.integers(0, 2**40))
                t.put(row)
                live.append((row["parent_id"], row["name"]))
        caps.add(t._cap)
        check()
    assert len(caps) > 1                         # growths happened between
    mirror = t.device_columns(CPU)["parent_id"]
    t.delete(live[0])                            # an incremental update
    assert t.device_columns(CPU)["parent_id"].data_ptr() == \
        mirror.data_ptr()
    check()


def test_inode_hot_column_mirror_under_concurrent_refreshes():
    """A writer (puts, deletes, slot growths) races threads that refresh
    the mirror: no write may be lost from it."""
    import os
    import sys
    import threading
    import repro_torch.core.tables as t_tables
    t = t_col.ColumnarTable(t_tables.INODE, 8)
    stop = threading.Event()
    errors = []

    def writer():
        try:
            for i in range(2000):
                t.put(t_tables.make_inode(i + 2, 1 + i % 37, f"n{i}",
                                          i % 5 == 0))
                if i % 3 == 0:
                    t.delete((1 + (i // 2) % 37, f"n{i // 2}"))
        except Exception as e:          # reported by the assert below
            errors.append(e)

    def refresher():
        try:
            while not stop.is_set():
                t.device_columns(CPU)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rs = [threading.Thread(target=refresher)
              for _ in range(2 * (os.cpu_count() or 2))]
        w = threading.Thread(target=writer)
        for r in rs:
            r.start()
        w.start()
        w.join(timeout=120)
        stop.set()
        for r in rs:
            r.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not w.is_alive() and not any(r.is_alive() for r in rs)
    assert not errors
    cols = t.device_columns(CPU)
    for c in ("id", "parent_id", "is_dir", "size"):
        assert np.array_equal(cols[c].numpy(),
                              t._for_device(c, t.hot_column(c))), c


# ---------------------------------------------------------------------------
# the ctypes bindings agree with the C launchers
# ---------------------------------------------------------------------------

def test_launcher_signatures_match_bindings():
    """Every launcher's ctypes argument list is read from its C
    prototype, and each binding passes exactly that many arguments (the
    stream is added by ``launch``)."""
    import ast
    from pathlib import Path
    from repro_torch.kernels import LAUNCHES, _build
    sigs = _build.signatures()
    assert set(sigs) == {f"{k}_launch" for k in LAUNCHES}
    assert all(s[-1] is __import__("ctypes").c_void_p for s in sigs.values())
    root = Path(_build.__file__).parent
    seen = {}
    for path in root.glob("*/kernel.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "launch":
                name = node.args[0].value
                seen[name] = len(node.args) - 1
    assert seen == {k: len(v) - 1 for k, v in sigs.items()}


def test_route_exports_match_bindings():
    """A binding's ``LAST_ROUTE`` is read from an int its library exports
    (``_build.c_int``): that int is defined once, with C linkage, and
    every value the sources assign it names a route in the binding's
    table (-1: nothing launched yet, or the launch failed)."""
    import ast
    import importlib
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    texts = [(_build.CSRC / s).read_text() for s in _build.SOURCES]
    read = {}
    for path in Path(_build.__file__).parent.glob("*/kernel.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "c_int":
                read[node.args[0].value] = path.parent.name
    assert set(read) == {"gmm_last_route", "ssd_last_route",
                         "wkv6_last_route", "hintchain_last_route"}
    for name, pkg in read.items():
        defined = [t for t in texts
                   if re.search(rf"^int {name} = -?\d+;", t, re.M)]
        assert len(defined) == 1, name
        text = defined[0]
        assert re.search(rf"^int {name} = ", text[text.index(
            'extern "C" {'):], re.M), f"{name}: no C linkage"
        values = {int(v) for v in re.findall(rf"\b{name} = (-?\d+);", text)}
        routes = importlib.import_module(
            f"repro_torch.kernels.{pkg}.kernel")._ROUTES
        assert values and values <= set(routes), (name, values, routes)


# ---------------------------------------------------------------------------
# the build: what its hash covers, and the generated wgmma wrappers
# ---------------------------------------------------------------------------

def test_build_digest_covers_headers(tmp_path):
    """A change to a header the sources share (not listed in SOURCES)
    names another library, so it is rebuilt."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _build._digest(csrc) == _build._digest()
    headers = sorted(csrc.glob("*.cuh"))
    assert headers and not {h.name for h in headers} & set(_build.SOURCES)
    for h in headers:
        before = _build._digest(csrc)
        h.write_text(h.read_text() + "\n// changed\n")
        assert _build._digest(csrc) != before, h.name


def test_wgmma_header_is_what_its_generator_writes():
    import importlib.util
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        "gen_wgmma", _build.CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (_build.CSRC / "wgmma_ops.cuh").read_text() == gen.render()
