"""The compact form of the port's treeagg, the packed transfers of its
hintchain, pkval and phash_chain, the window form of pkval and the hash
index's packed refresh, on the CPU, against the JAX package.

The compact form's plain version (``treeagg_expand_ref``) is held against
JAX's ``treeagg`` kernel (Pallas in interpret mode) followed by the JAX
package's own compaction (``columnar.expand_wave``: ``ids[seg >= 0]``, then
the ids whose ``is_dir`` is 1), exactly: integer results, int32 sums that
wrap.  The CUDA kernel writes a packed buffer whose layout ``unpack`` reads:
that layout is checked here by packing the plain result by hand.  The CUDA
kernels themselves are held against these plain versions in
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import repro.core.columnar as r_col
import repro.kernels.hintchain.ops as r_hc_ops
import repro.kernels.phash.ops as r_ph_ops
import repro.kernels.pkval.ops as r_pk_ops
import repro.kernels.treeagg.ops as r_ta_ops
import repro_torch.core.columnar as t_col
from repro_torch.core.workload import name_hash32
from repro_torch.kernels import _build, _staging
from repro_torch.kernels.hintchain import kernel as hc_kernel
from repro_torch.kernels.hintchain import ops as hc_ops
from repro_torch.kernels.phash import kernel as ph_kernel
from repro_torch.kernels.phash import ops as ph_ops
from repro_torch.kernels.phash import ref as ph_ref
from repro_torch.kernels.pkval import ops as pk_ops
from repro_torch.kernels.pkval import ref as pk_ref
from repro_torch.kernels.treeagg import kernel as ta_kernel
from repro_torch.kernels.treeagg import ops as ta_ops
from repro_torch.kernels.treeagg import ref as ta_ref

T = ta_kernel.TILE_SLOTS


def _slots(case, seed=0):
    """(wave, ids, par, isdir, size) numpy arrays of one named case."""
    rng = np.random.default_rng(seed)
    if case == "empty wave":
        c, wave = 3 * T + 17, np.zeros(0, np.int64)
        par = rng.integers(2, 500, size=c)
    elif case == "all cleared":
        c, wave = 2 * T + 1, np.arange(2, 40)
        par = np.full(c, -1)
    elif case == "one member owns every slot":
        c, wave = 3 * T + 5, np.array([7])
        par = np.full(c, 7)
    elif case == "hits in every tile":
        c, wave = 4 * T + 333, np.sort(rng.choice(np.arange(2, 4000), 300,
                                                  replace=False))
        par = rng.integers(2, 4000, size=c)
        par[rng.random(c) < 0.1] = -1
    elif case == "sums that wrap":
        c, wave = 2 * T + 77, np.array([3, 9])
        par = rng.choice([3, 9, 11, -1], size=c)
    elif case == "wave above the shared-memory cap":
        w = ta_kernel.WAVE_SMEM_CAP + 1
        c = 3 * T + 9
        wave = np.sort(rng.choice(np.arange(2, 4 * w), w, replace=False))
        par = np.where(rng.random(c) < 0.7, rng.choice(wave, size=c),
                       rng.integers(2, 4 * w, size=c))
    else:
        raise KeyError(case)
    cleared = par < 0
    isdir = np.where(cleared, 0, rng.random(c) < 0.3).astype(np.int64)
    hi = 2**31 - 1 if case == "sums that wrap" else 5000
    size = np.where(cleared, 0, rng.integers(0, hi, size=c))
    ids = rng.permutation(np.arange(10**6, 10**6 + c)).astype(np.int64)
    ids[cleared] = -1
    return wave.astype(np.int64), ids, par.astype(np.int64), isdir, size


CASES = ("empty wave", "all cleared", "one member owns every slot",
         "hits in every tile", "sums that wrap",
         "wave above the shared-memory cap")


def _jax_expansion(wave, ids, par, isdir, size):
    """JAX's kernel, then the JAX package's compaction (expand_wave)."""
    seg, counts, dirs, sizes = r_ta_ops.treeagg_expand(
        wave, par, isdir, size, interpret=True)
    hit = np.asarray(seg) >= 0
    child_ids = ids[hit]
    return (np.asarray(counts), np.asarray(dirs), np.asarray(sizes),
            child_ids, child_ids[isdir[hit] == 1])


def _torch(*arrays):
    wave, ids, par, isdir, size = arrays
    return (torch.from_numpy(wave.astype(np.int32)), torch.from_numpy(ids),
            *(torch.from_numpy(a.astype(np.int32)) for a in (par, isdir,
                                                              size)))


@pytest.mark.parametrize("case", CASES)
def test_treeagg_expand_ref_matches_jax(case):
    arrays = _slots(case)
    got = [t.numpy() for t in ta_ref.treeagg_expand_ref(*_torch(*arrays))]
    want = _jax_expansion(*arrays)
    for g, j, dtype in zip(got, want, (np.int32,) * 3 + (np.int64,) * 2):
        assert g.dtype == dtype and np.array_equal(g, j)
    wave, ids, par = arrays[:3]
    if case == "one member owns every slot":
        assert got[0].tolist() == [par.size] and got[3].size == par.size
    if case == "hits in every tile":
        tiles = np.flatnonzero(np.isin(par, wave)) // T
        assert set(tiles.tolist()) == set(range(-(-par.size // T)))
    if case == "sums that wrap":
        assert (got[2] < 0).any()
    if case in ("empty wave", "all cleared"):
        assert got[3].size == 0 and not got[0].any()


@pytest.mark.parametrize("case", CASES)
def test_treeagg_expand_on_cpu_matches_jax(case):
    """The wrapper the subtree protocol calls, on CPU columns."""
    wave, ids, par, isdir, size = arrays = _slots(case)
    _, ids_t, par_t, isdir_t, size_t = _torch(*arrays)
    got = ta_ops.treeagg_expand(wave, ids_t, par_t, isdir_t, size_t)
    for g, j in zip(got, _jax_expansion(*arrays)):
        assert np.array_equal(g, j)


def _pack(res, w, c):
    """A plain result packed as the CUDA kernel lays it out."""
    counts, dirs, sizes, child_ids, dir_ids = res
    status, mid, total = ta_kernel.layout(w, c)
    out = torch.full((total,), 0x5A5A5A5A, dtype=torch.int32)
    out[:3 * w] = torch.cat([counts, dirs, sizes])
    out[3 * w], out[3 * w + 1] = child_ids.numel(), dir_ids.numel()
    as64 = out.view(torch.int64)
    as64[mid // 2:mid // 2 + child_ids.numel()] = child_ids
    if dir_ids.numel():
        as64[mid // 2 - dir_ids.numel():mid // 2] = dir_ids.flip(0)
    return out


@pytest.mark.parametrize("case", CASES)
def test_treeagg_packed_layout_round_trips(case):
    """``unpack`` reads back what the kernel's layout holds: the header,
    the children from the middle forwards, the directories backwards."""
    arrays = _slots(case)
    w, c = arrays[0].size, arrays[2].size
    res = ta_ref.treeagg_expand_ref(*_torch(*arrays))
    status, mid, total = ta_kernel.layout(w, c)
    assert status >= 3 * w + 3 and status % 2 == 0 and mid % 2 == 0
    assert mid - (status + 2 * -(-c // T)) == 2 * c == total - mid
    for g, r in zip(ta_kernel.unpack(_pack(res, w, c), w, c), res):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_kernel_constants_match_source():
    """The bindings' copies of the CUDA source's sizes agree with it."""
    src = (_build.CSRC / "metadata_kernels.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr [\w ]+ {name} = ([\d *]+);", src)
        return eval(expr.group(1))

    assert const("kTaThreads") * const("kTaVecs") * 4 == T
    assert const("kWaveSmemCap") == ta_kernel.WAVE_SMEM_CAP
    assert const("kHcSmemCap") == hc_kernel.SMEM_CAP
    # the deepest row leaves room for one row's fold operands (D | 1)
    assert 4 * (ph_kernel.MAX_DEPTH | 1) <= const("kPcSmemCap") \
        < 4 * ((ph_kernel.MAX_DEPTH + 1) | 1)
    assert const("kPkLanes") == pk_ref.WINDOW


@pytest.mark.parametrize("ccap,fcap,route", [
    (64, 8192, "smem"),                     # the main path's first window
    (4096, 16384, "smem"),                  # its largest snapshots
    (65536, 65536, "global"),               # chip_smoke phase 2's tables
    (1, 2, "smem"),
    (16384, 8192, "smem"),
    (16384, 16384, "global"),
])
def test_hintchain_route_choice(ccap, fcap, route):
    assert hc_kernel.route_for(ccap, fcap) == route


def test_upload_packs_each_array_aligned():
    """One buffer holds every array's low 32 bits, each from a 16-byte
    boundary; the views read back the arrays."""
    rng = np.random.default_rng(3)
    arrays = [rng.integers(-2**31, 2**31, size=5, dtype=np.int64),
              rng.integers(0, 2**32, size=(3, 7), dtype=np.int64)
              .astype(np.uint32),
              np.arange(2**33, 2**33 + 4, dtype=np.int64),
              np.zeros(0, np.int32), np.array([-3], np.int32)]
    views = _staging.upload_i32(arrays, torch.device("cpu"))
    base = views[0].data_ptr()
    offs = _staging.offsets([a.size for a in arrays])
    for a, v, o in zip(arrays, views, offs):
        assert v.dtype == torch.int32 and tuple(v.shape) == a.shape
        assert (v.data_ptr() - base) % 16 == 0 and v.data_ptr() - base \
            == 4 * o or a.size == 0
        want = (a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        assert np.array_equal(v.numpy().view(np.uint32), want)
    assert offs == [0, 8, 32, 36, 36, 40]


def _hint_tables(n_ops, client_cap, fallback_cap, seed=0, d=16):
    """Client and fallback hint indexes of the given capacities over a
    random tree, with AMBIG values and tombstones, and chains down it."""
    rng = np.random.default_rng(seed)
    n_nodes = fallback_cap // 4
    kids = {i: [] for i in range(n_nodes)}
    cl, fb = {}, {}
    for iid in range(2, n_nodes):
        par = int(rng.integers(max(1, iid // 3), iid))
        h = name_hash32(f"n{iid}")
        kids[par].append((h, iid))
        r = rng.random()
        (cl if r < 0.02 else fb)[(par, h)] = iid
        if 0.9 < r < 0.93:
            fb[(par, h)] = r_col.AMBIG
        if r < 0.005:
            cl[(par, h)] = r_col.AMBIG
    out = []
    for mod in (r_col, t_col):
        c, f = mod.HashIndex(client_cap), mod.HashIndex(fallback_cap)
        for (p, h), v in list(cl.items())[:client_cap // 4]:
            c.set(p, h, v)
        for (p, h), v in fb.items():
            f.set(p, h, v)
        f.set(1, 12345, 77)
        f.remove(1, 12345)                       # a tombstone
        assert (c.cap, f.cap) == (client_cap, fallback_cap)
        out.append((c, f))
    names = np.zeros((n_ops, d), np.uint32)
    depths = np.zeros(n_ops, np.int32)
    for i in range(n_ops):
        cur, k, want = 1, 0, int(rng.integers(0, d + 1))
        while k < want and kids[cur]:
            h, nxt = kids[cur][int(rng.integers(len(kids[cur])))]
            names[i, k] = h if rng.random() > 0.03 else h ^ 1
            cur, k = nxt, k + 1
        depths[i] = k
    return out, names, depths


def test_hintchain_resolve_packed_on_cpu_matches_jax():
    """The wrapper packs tables, names and depths into one buffer and
    unpacks (child, src) from one [2, N, D] result: equal to JAX's at the
    main path's shapes (N=1,024, D=16, 64 + 8,192 slots)."""
    ((rc, rf), (tc, tf)), names, depths = _hint_tables(1024, 64, 8192)
    assert hc_kernel.route_for(tc.cap, tf.cap) == "smem"
    child, src = hc_ops.hintchain_resolve(tc.arrays(), tf.arrays(), names,
                                          depths, device="cpu", root_id=1)
    jchild, jsrc = r_hc_ops.hintchain_resolve(rc.arrays(), rf.arrays(),
                                              names, depths, root_id=1)
    assert child.dtype == src.dtype == np.int32
    assert child.shape == src.shape == (1024, 16)
    assert np.array_equal(child, np.asarray(jchild))
    assert np.array_equal(src, np.asarray(jsrc))
    assert {-2, -1} <= set(child.ravel().tolist())
    assert {0, 1} <= set(src.ravel().tolist())
    assert (child > 0).sum(axis=1).max() >= 4


# ---------------------------------------------------------------------------
# pkval: the window form and the packed lookup
# ---------------------------------------------------------------------------

def _probe_index(cap=256, load=0.8, seed=0):
    """A linear-probe table filled to ``load`` with no bound on the chain
    (the host index grows first; here the long chains are wanted), with
    tombstones and AMBIG values, and probes: every stored key, misses and
    padding parents.  int32 numpy arrays (tp, tn, tv, parents, names)."""
    rng = np.random.default_rng(seed)
    n = int(cap * load)
    par = rng.integers(1, 1000, size=n)
    nam = rng.integers(0, 2**32, size=n)
    tp = np.full(cap, -1, np.int64)
    tn = np.zeros(cap, np.int64)
    tv = np.full(cap, -1, np.int64)
    for i, (p, m) in enumerate(zip(par, nam)):
        j = t_col.HashIndex._mix(int(p), int(m)) & (cap - 1)
        while tp[j] != -1:
            j = (j + 1) & (cap - 1)
        tp[j], tn[j], tv[j] = p, m, 2 + i
    placed = np.flatnonzero(tp >= 0)
    tomb = rng.choice(placed, n // 10, replace=False)
    tp[tomb], tn[tomb], tv[tomb] = -2, 0, -1
    tv[rng.choice(np.setdiff1d(placed, tomb), n // 20, replace=False)] = -3
    ppar = np.concatenate([par, rng.integers(1, 1000, size=n // 2), [-1] * 9])
    pnam = np.concatenate([nam, rng.integers(0, 2**32, size=n // 2 + 9)])
    as32 = (lambda a: (np.asarray(a, np.int64) & 0xFFFFFFFF)
            .astype(np.uint32).view(np.int32))
    return tuple(as32(a) for a in (tp, tn, tv, ppar, pnam))


@pytest.mark.parametrize("max_probe", [0, 1, 3, 8, 13, 16])
def test_pkval_window_form_matches_step_loop_and_jax(max_probe):
    """The kernel's form (a window of 8 slots read at once, the first of
    hit or EMPTY) against the step loop and JAX's kernel in interpret mode:
    tombstones, AMBIG, windows that wrap past the last slot, chains of all
    8 steps and past them, padding parents."""
    tp, tn, tv, par, nam = arrays = _probe_index()
    t = [torch.from_numpy(a) for a in arrays]
    got = pk_ref.probe_window_ref(*t, max_probe=max_probe)
    assert torch.equal(got, pk_ref.pkval_ref(*t, max_probe=max_probe))
    jax_out = r_pk_ops.pkval_lookup(tp, tn.view(np.uint32), tv, par,
                                    nam.view(np.uint32), max_probe=max_probe)
    assert np.array_equal(got.numpy(), np.asarray(jax_out))
    if max_probe == 8:
        cap = tp.size
        home = pk_ref.bucket_hash_ref(t[3], t[4]).numpy() & (cap - 1)
        steps = np.array([next((s for s in range(4 * cap) if tp[(h + s) % cap]
                                == p and tn[(h + s) % cap] == m), -1)
                          for h, p, m in zip(home, par, nam)])
        hit = got.numpy() != -1
        assert {-1, -3} <= set(got.numpy().tolist()) and (got > 0).any()
        assert (steps[hit] == 7).any()                # all 8 steps
        assert ((steps >= 8) & (par >= 0)).any()       # missed after 8
        assert (hit & (home + steps >= cap)).any()     # wrapped window


@pytest.mark.parametrize("n", [1024, 999, 1])
def test_pkval_lookup_packed_on_cpu_matches_jax(n):
    """Parents and names in one packed upload, the ids back in one copy:
    equal to JAX's lookup at the main path's size and ragged ones."""
    tp, tn, tv, par, nam = _probe_index(cap=2048, load=0.45, seed=n)
    rng = np.random.default_rng(n)
    pick = rng.integers(0, par.size, size=n)
    ppar = par[pick].astype(np.int64)
    pnam = nam[pick].view(np.uint32).astype(np.int64)
    got = pk_ops.pkval_lookup(*(torch.from_numpy(a) for a in (tp, tn, tv)),
                              ppar, pnam)
    want = r_pk_ops.pkval_lookup(tp, tn.view(np.uint32), tv, ppar, pnam)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert np.array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# phash_chain: the packed output
# ---------------------------------------------------------------------------

def _chain_rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    par = rng.integers(0, 2**32, size=(n, d))
    nam = rng.integers(0, 2**32, size=(n, d))
    hints = rng.integers(0, 2**32, size=n)
    depths = rng.integers(0, d + 1, size=n)
    past = np.arange(d) >= depths[:, None]
    par[past], nam[past] = 0, 0
    return par, nam, hints, depths


@pytest.mark.parametrize("n,d", [(1024, 16), (1000, 16), (37, 3), (1, 17),
                                 (513, 1)])
def test_phash_chains_packed_on_cpu_matches_jax(n, d):
    """Four arrays in one packed upload, the three results back from one
    packed buffer: equal to JAX's at the planner's window (N=1,024,
    D=16), ragged N and odd D."""
    par, nam, hints, depths = _chain_rows(n, d, seed=n + d)
    got = ph_ops.phash_chains(par, nam, hints, depths, 64, device="cpu")
    want = r_ph_ops.phash_chains(par, nam, hints, depths, 64)
    for g, w, dtype in zip(got, want, (np.int32, np.int32, np.uint32)):
        assert g.dtype == dtype and np.array_equal(g, np.asarray(w))
    assert got[0].shape == (n, d)


@pytest.mark.parametrize("n,d", [(1024, 16), (5, 3), (1, 1), (0, 4)])
def test_phash_chain_packed_layout_round_trips(n, d):
    """``unpack`` reads back, from a tensor and from a host array, what the
    kernel writes where ``layout`` says: comp, then the hint partitions,
    then the signatures."""
    hint_at, sig_at, total = ph_kernel.layout(n, d)
    assert (hint_at, sig_at, total) == (n * d, n * d + n, n * d + 2 * n)
    args = [_staging.low32(a) for a in _chain_rows(n, d, seed=d)]
    res = ph_ref.phash_chain_ref(*(torch.from_numpy(a) for a in args), 64)
    packed = torch.cat([t.reshape(-1) for t in res])
    assert packed.shape == (total,)
    for form in (packed, packed.numpy()):
        parts = ph_kernel.unpack(form, n, d)
        for g, r in zip(parts, res):
            assert tuple(g.shape) == tuple(r.shape)
            assert np.array_equal(np.asarray(g), r.numpy())


# ---------------------------------------------------------------------------
# the hash index's mirror: one packed upload a refresh
# ---------------------------------------------------------------------------

def test_hash_index_packed_refresh_equals_host(monkeypatch):
    """After sets, removes and a growth, the mirror refreshed by one packed
    upload (the dirty slots and their three values) equals the host
    arrays."""
    uploads = []
    real = t_col.upload_i32
    monkeypatch.setattr(t_col, "upload_i32",
                        lambda arrays, device: uploads.append(len(arrays))
                        or real(arrays, device))
    rng = np.random.default_rng(7)
    idx = t_col.HashIndex(64)
    keys = [(int(rng.integers(1, 500)), int(rng.integers(0, 2**32)))
            for _ in range(400)]

    def same():
        mirror = idx.device_arrays("cpu")
        host = (idx.par, idx.nam.view(np.int32), idx.val)
        return all(np.array_equal(m.numpy(), h) for m, h in zip(mirror,
                                                                 host))

    for p, m in keys[:20]:
        idx.set(p, m, p + 7)
    assert same() and uploads == []          # the first call: a whole copy
    for p, m in keys[:10]:
        idx.set(p, m, -3)                    # AMBIG over existing keys
    for p, m in keys[10:15]:
        idx.remove(p, m)                     # tombstones
    assert idx._dirty and same() and uploads == [2]
    cap = idx.cap
    for i, (p, m) in enumerate(keys[20:]):
        idx.set(p, m, i + 2)                 # grows: a whole copy again
    assert idx.cap > cap and same() and uploads == [2]
    for p, m in keys[20:60]:
        idx.remove(p, m)
    idx.set(*keys[0], 99)
    assert same() and uploads == [2, 2] and not idx._dirty
