"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--bulk 1000000] [--ops 20000]

Phases, each printing its results on lines of its own; any failure raises
and the script exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``) and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Kernel vs plain version on the card, bit-equal, on seeded synthetic
   inputs: phash over 1,048,576 keys, phash_chain at N=4096, D=16,
   pkval against a 2^23-slot index with ~1M live entries, tombstones and
   AMBIG buckets (65,536 probes, padding parents included), hintchain over
   client and fallback tables at N=4096, D=16, treeagg over 1,048,576
   inode slots (runs of children, other parents, cleared slots, sums that
   wrap) against a wave of 4,096 directories.  Times are CUDA-event
   medians of 20 launches after warm-up.
3. The main path at deployment size: a columnar store on the card with 4
   datanodes and 4 namenodes, the Spotify-shaped namespace (127
   directories x 16 files) created through the op path plus a bulk
   directory of ``--bulk`` file inodes (the inode hash index, 2^23 slots at
   1M entries, lives on the card), then a ``--ops`` Spotify trace through
   ``DFSClient.run_trace(planned=True, batch_size=64, window=1024,
   adaptive=False)`` (its subtree deletes expand their waves with
   treeagg over the inode columns on the card), a ``du`` of the whole
   namespace (a treeagg launch per wave) and a ``DFSClient.batch()`` of
   1,024 stats served from the namenode's hint cache.  The launch counts
   are set to 0 just before and read just after: each of the five
   kernels must have run.
   Each kernel's first main-path call is recorded and replayed against the
   plain version: those shapes give the JSON line's times and bounds.
4. Checks: the same build, trace, du and batch on the host (plain
   versions) must end byte-equal to the card's run, in state, outcomes,
   OpCost and counts.  Then the oracle, the dict ``MetadataStore``: every
   outcome must be equal, and every table's rows, with inode and block ids
   replaced by paths and the namenodes' atime/mtime clocks left out
   (``canonical_state``); byte-equal, ids and all, when pkval demoted no
   chain.

The line before the last is the kernels' JSON, the last line the device
JSON.  Without a CUDA device, or outside the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
#: H100 SXM: the data sheet's HBM3 rate, and the INT32 issue rate, 132 SMs x
#: 64 INT32 lanes x 1.98 GHz boost (the data sheet gives no integer rate
#: outside the tensor cores; the kernels' work is all 32-bit integer)
BYTES_PER_S = 3.35e12
OPS_PER_S = 132 * 64 * 1.98e9
SOURCE = "src/repro_torch/kernels/csrc/metadata_kernels.cu"
REPLACES = {
    "phash": "src/repro/kernels/phash/kernel.py:35",
    "phash_chain": "src/repro/kernels/phash/kernel.py:83",
    "pkval": "src/repro/kernels/pkval/kernel.py:76",
    "hintchain": "src/repro/kernels/hintchain/kernel.py:101",
    "treeagg": "src/repro/kernels/treeagg/kernel.py:83",
}


def card() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up: what a caller
    waits for, the host's dispatch of the call included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one launch: ``reps`` launches queued behind a spin
    kernel run back to back on the card, so the host's dispatch time
    (larger than these kernels' run time) stays out of the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)          # ~10 ms: the host queues ahead
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def max_abs_err(a, b) -> int:
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in pairs)


# ---------------------------------------------------------------------------
# work counts for the bounds: what these inputs need
# ---------------------------------------------------------------------------

def probe_work(tp, tn, tv, par, nam):
    """Walk of the plain probe loop: (probe steps, slots touched, value)."""
    from repro_torch.kernels.pkval.ref import MAX_PROBE, bucket_hash_ref
    from repro_torch.kernels.phash.ref import u32
    cap = tp.numel()
    slot = bucket_hash_ref(par, nam) & (cap - 1)
    nam64, tn64 = u32(nam), u32(tn)
    alive = par >= 0
    out = torch.full_like(par, -1)
    steps, touched = 0, []
    for s in range(MAX_PROBE):
        j = (slot + s) & (cap - 1)
        touched.append(j[alive])
        steps += int(alive.sum())
        ep = tp[j]
        hit = alive & (ep >= 0) & (ep == par) & (tn64[j] == nam64)
        out = torch.where(hit, tv[j], out)
        alive = alive & ~hit & (ep != -1)
    return steps, torch.cat(touched), out


def bound(bytes_: int, ops: int) -> tuple:
    """(bound_ms, bound_by, bytes, operations) of one call."""
    tb, to = bytes_ / BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (tb, "bytes", bytes_, ops) if tb >= to \
        else (to, "operations", bytes_, ops)


def work_phash(keys, n_partitions=64):
    n = keys.numel()
    return bound(8 * n, 4 * n)


def work_phash_chain(parents, names, hints, depths, n_partitions=64):
    n, d = parents.shape
    folded = int(depths.clamp(0, d).sum())
    return bound(4 * (2 * n * d + 2 * n) + 4 * (n * d + 2 * n),
                 4 * n * d + 5 * folded + 4 * n)


def work_pkval(tp, tn, tv, parents, name_hashes, **_):
    steps, touched, _ = probe_work(tp, tn, tv, parents, name_hashes)
    n = parents.numel()
    slots = int(torch.unique(touched).numel())
    return bound(12 * n + 12 * slots, 6 * n + 4 * steps)


def work_hintchain(cp, cn, cv, fp, fn, fv, names, depths, root_id=1, **_):
    n, d_max = names.shape
    parent = torch.full((n,), root_id, dtype=torch.int32,
                        device=names.device)
    alive = depths > 0
    steps, probed, c_t, f_t = 0, 0, [], []
    for d in range(d_max):
        rows = (alive & (d < depths)).nonzero().squeeze(1)
        if rows.numel() == 0:
            break
        probed += rows.numel()
        p, nd = parent[rows], names[rows, d]
        s1, t1, cval = probe_work(cp, cn, cv, p, nd)
        miss = cval == -1
        s2, t2, fval = probe_work(fp, fn, fv, p[miss], nd[miss])
        steps += s1 + s2
        c_t.append(t1)
        f_t.append(t2)
        val = cval.clone()
        val[miss] = fval
        found = val > 0
        alive = torch.zeros_like(alive)
        alive[rows[found]] = True
        parent[rows[found]] = val[found]
    slots = sum(int(torch.unique(torch.cat(t)).numel()) if t else 0
                for t in (c_t, f_t))
    return bound(4 * n + 4 * probed + 8 * n * d_max + 12 * slots,
                 6 * probed + 4 * steps)


def work_treeagg(wave, par, isdir, size):
    """Every slot's parent read and seg written; is_dir and size read for
    the children found; the wave read and three sums per member written.
    Operations: a compare and a halving per search step of each live slot
    and three adds per child."""
    w, c = wave.numel(), par.numel()
    seg = torch.searchsorted(wave, par)
    hits = int(((par >= 0) & (seg < w) & (wave[seg.clamp(max=max(w - 1, 0))]
                                          == par)).sum()) if w else 0
    live = int((par >= 0).sum())
    return bound(4 * w + 4 * c + 8 * hits + 4 * c + 12 * w,
                 live * 3 * max(1, w.bit_length()) + 3 * hits)


# ---------------------------------------------------------------------------
# phase 2: synthetic inputs
# ---------------------------------------------------------------------------

def i32(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a, np.int64) & 0xFFFFFFFF)
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)


def synthetic_index(rng, cap: int, n_live: int):
    """Linear-probe table of n_live random keys built in bulk, with
    tombstones and AMBIG values: (tp, tn, tv) int64 numpy, keys."""
    par = rng.integers(1, 1 << 30, size=n_live, dtype=np.int64)
    nam = rng.integers(0, 1 << 32, size=n_live, dtype=np.int64)
    h = ((par * 0x9E3779B1) & 0xFFFFFFFF) ^ ((nam * 0x85EBCA6B) & 0xFFFFFFFF)
    home = (h ^ (h >> 16)) & (cap - 1)
    order = np.argsort(home, kind="stable")
    home = home[order]
    i = np.arange(n_live)
    slot = i + np.maximum.accumulate(home - i)       # first free at or after
    keep = slot < cap
    par, nam, slot = par[order][keep], nam[order][keep], slot[keep]
    tp = np.full(cap, -1, np.int64)
    tn = np.zeros(cap, np.int64)
    tv = np.full(cap, -1, np.int64)
    tp[slot], tn[slot] = par, nam
    tv[slot] = 2 + np.arange(slot.size)
    tomb = rng.random(slot.size) < 0.05
    tp[slot[tomb]], tn[slot[tomb]], tv[slot[tomb]] = -2, 0, -1
    ambig = ~tomb & (rng.random(slot.size) < 0.02)
    tv[slot[ambig]] = -3
    return (tp, tn, tv), par, nam


def synthetic_hint_tables(rng, n_ops: int, depth: int = 16):
    """Client and fallback hint tables over a random tree, and n_ops chains
    walking down it (mixed depths, 0 included)."""
    from repro_torch.core.columnar import AMBIG, HashIndex
    from repro_torch.core.workload import name_hash32
    n_nodes = 20_000
    parents = np.concatenate([[0, 0], rng.integers(
        np.maximum(1, np.arange(2, n_nodes) // 3), np.arange(2, n_nodes))])
    kids = {i: [] for i in range(n_nodes)}
    client, fallback = HashIndex(), HashIndex()
    for iid in range(2, n_nodes):
        par, h = int(parents[iid]), name_hash32(f"n{iid}")
        kids[par].append((h, iid))
        r = rng.random()
        if r < 0.45:
            client.set(par, h, iid)
        elif r < 0.85:
            fallback.set(par, h, iid)
        elif r < 0.9:
            client.set(par, h, AMBIG)
            fallback.set(par, h, iid)
        elif r < 0.95:
            fallback.set(par, h, AMBIG)
        else:
            client.set(par, h, iid)
            client.remove(par, h)                  # a tombstone
    names = np.zeros((n_ops, depth), np.int64)
    depths = np.zeros(n_ops, np.int64)
    for i in range(n_ops):
        cur, k, want = 1, 0, int(rng.integers(0, depth + 1))
        while k < want and kids[cur]:
            h, nxt = kids[cur][int(rng.integers(len(kids[cur])))]
            names[i, k] = h if rng.random() > 0.03 else h ^ 1
            cur, k = nxt, k + 1
        depths[i] = k
    return client, fallback, names, depths


def synthetic_slots(rng, c: int, w: int):
    """An inode table of c slots and a sorted wave of w directory ids:
    runs of children of wave members (as bulk loads lay them out), other
    parents, cleared slots; sizes large enough for the sums to wrap."""
    wave = np.sort(rng.choice(np.arange(2, 64 * w), size=w, replace=False))
    par = np.repeat(wave, c // w + 1)[:c]
    other = rng.random(c) < 0.3
    par[other] = rng.integers(2, 64 * w, size=int(other.sum()))
    par[rng.random(c) < 0.05] = -1
    isdir = (rng.random(c) < 0.1) & (par >= 0)
    size = np.where(par >= 0, rng.integers(0, 1 << 31, size=c), 0)
    return wave, par, isdir, size


def phase_kernels(seed: int, dev) -> None:
    from repro_torch.kernels.hintchain import kernel as hk, ref as hr
    from repro_torch.kernels.phash import kernel as pk, ref as pr
    from repro_torch.kernels.pkval import kernel as vk, ref as vr
    from repro_torch.kernels.treeagg import kernel as tk, ref as tr
    rng = np.random.default_rng(seed)
    cases = {}
    keys = i32(rng.integers(0, 1 << 32, size=1 << 20), dev)
    cases["phash"] = (pk.phash, pr.phash_ref, (keys, 64), {}, work_phash)
    n, d = 4096, 16
    par = i32(rng.integers(0, 1 << 32, size=(n, d)), dev)
    nam = i32(rng.integers(0, 1 << 32, size=(n, d)), dev)
    hints = i32(rng.integers(0, 1 << 32, size=n), dev)
    dep = i32(rng.integers(0, d + 1, size=n), dev)
    dep[:64] = 0
    cases["phash_chain"] = (pk.phash_chain, pr.phash_chain_ref,
                            (par, nam, hints, dep, 64), {}, work_phash_chain)
    (tp, tn, tv), kpar, knam = synthetic_index(rng, 1 << 23, 1_050_000)
    m = 1 << 16
    pick = rng.integers(0, kpar.size, size=m)
    ppar, pnam = kpar[pick].copy(), knam[pick].copy()
    r = rng.random(m)
    ppar[r < 0.25] = rng.integers(1, 1 << 30, size=int((r < 0.25).sum()))
    ppar[r > 0.95] = -1                                # padding parents
    idx = tuple(i32(a, dev) for a in (tp, tn, tv))
    cases["pkval"] = (vk.pkval, vr.pkval_ref,
                      idx + (i32(ppar, dev), i32(pnam, dev)), {}, work_pkval)
    client, fallback, hnames, hdep = synthetic_hint_tables(rng, 4096)
    tabs = tuple(i32(a, dev) for a in (*client.arrays(), *fallback.arrays()))
    cases["hintchain"] = (hk.hintchain, hr.hintchain_ref,
                          tabs + (i32(hnames, dev), i32(hdep, dev)),
                          {"root_id": 1}, work_hintchain)
    slots = synthetic_slots(rng, 1 << 20, 4096)
    cases["treeagg"] = (tk.treeagg, tr.treeagg_ref,
                        tuple(i32(a, dev) for a in slots), {}, work_treeagg)
    for name, (kern, plain, args, kw, work) in cases.items():
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"{name}: kernel != plain version")
        ms = device_ms(lambda: kern(*args, **kw))
        call_ms = cuda_ms(lambda: kern(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
        b_ms, b_by, n_bytes, n_ops = work(*args, **kw)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"phase2 {name}: bit-equal shapes={shapes} ms={ms:.6f} "
            f"call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={b_ms:.6f} ({b_by}; bytes={n_bytes} ops={n_ops})")
    live = int((tp >= 0).sum())
    log(f"phase2 pkval index: cap={tp.size} live={live} "
        f"tombstones={int((tp == -2).sum())} ambig={int((tv == -3).sum())}")


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

class Recorder:
    """Keeps a copy of each kernel binding's first call on the main path,
    and the host time spent in the request path's kernel wrappers (inputs
    to the card, launch, results back) and in the index mirror's refresh."""

    def __init__(self):
        from repro_torch.core.columnar import ColumnarTable, HashIndex
        from repro_torch.kernels.hintchain import kernel as hk, ops as ho
        from repro_torch.kernels.phash import kernel as pk, ops as po
        from repro_torch.kernels.pkval import kernel as vk, ops as vo
        from repro_torch.kernels.treeagg import kernel as tk, ops as to
        self.calls = {}
        self.host_s = {}
        self._orig = []
        for mod, name in ((pk, "phash"), (pk, "phash_chain"),
                          (vk, "pkval"), (hk, "hintchain"),
                          (tk, "treeagg")):
            self._patch(mod, name, self._record)
        for mod, name in ((po, "phash_partitions"), (po, "phash_chains"),
                          (vo, "pkval_lookup"), (ho, "hintchain_resolve"),
                          (to, "treeagg_expand"),
                          (HashIndex, "device_arrays"),
                          (ColumnarTable, "device_columns")):
            self._patch(mod, name, self._time)

    def _patch(self, owner, name, wrap):
        real = getattr(owner, name)
        self._orig.append((owner, name, real))
        setattr(owner, name, wrap(name, real))

    def _record(self, name, real):
        def rec(*args, **kw):
            if name not in self.calls:
                self.calls[name] = (tuple(a.clone() if torch.is_tensor(a)
                                          else a for a in args), dict(kw))
            return real(*args, **kw)
        return rec

    def _time(self, name, real):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                n, s = self.host_s.get(name, (0, 0.0))
                self.host_s[name] = (n + 1, s + time.perf_counter() - t0)
        return timed

    def restore(self):
        for owner, name, real in self._orig:
            setattr(owner, name, real)


def build(columnar: bool, bulk: int, dev):
    import repro_torch.core as T
    from repro_torch.core.columnar import ColumnarMetadataStore
    from repro_torch.core.workload import NamespaceSpec, SyntheticNamespace
    cls = ColumnarMetadataStore if columnar else T.MetadataStore
    store = cls(n_datanodes=4, device=dev)
    T.format_fs(store)
    cluster = T.NamenodeCluster(store, 4)
    ns = SyntheticNamespace(NamespaceSpec(), n_dirs=127, files_per_dir=16)
    T.materialize_namespace(cluster.namenodes[0], ns)
    if bulk:
        T.materialize_big_dir(cluster.namenodes[0], "/bulk", bulk)
    return store, cluster, ns


def drive(columnar: bool, bulk: int, n_ops: int, dev, on_start=None):
    """Build, replay the trace, du the namespace, then the client batch;
    returns results."""
    import repro_torch.core as T
    from repro_torch.core.workload import make_spotify_trace
    t0 = time.perf_counter()
    store, cluster, ns = build(columnar, bulk, dev)
    t_build = time.perf_counter() - t0
    trace = make_spotify_trace(ns, n_ops, seed=5)
    client = T.DFSClient(cluster)
    # keep the pipeline run_trace builds, to read its plan report
    pipes = []
    real_run = T.PlannedRequestPipeline.run

    def run(self, wops):
        pipes.append(self)
        return real_run(self, wops)

    T.PlannedRequestPipeline.run = run
    if on_start:
        on_start()
    t1 = time.perf_counter()
    try:
        stats = client.run_trace(trace, planned=True, batch_size=64,
                                 window=1024, adaptive=False)
    finally:
        T.PlannedRequestPipeline.run = real_run
    t_trace = time.perf_counter() - t1
    t3 = time.perf_counter()
    du = client.call("du", "/")
    t_du = time.perf_counter() - t3
    # 1,024 distinct files: the namespace's files the trace left alive,
    # then bulk files; the first pass warms the namenode's hint cache
    paths = [p for p in ns.files if client.exists(p)][:1024]
    step = max(1, bulk // 1024)
    paths += [f"/bulk/f{i:06d}" for i in range(0, bulk, step)
              ][:1024 - len(paths)]
    runs = []
    t2 = time.perf_counter()
    for _ in range(2):
        with client.batch() as b:
            handles = [b.stat(p) for p in paths]
        runs.append([h.result() for h in handles])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_batch = time.perf_counter() - t2
    rep, nns = pipes[0].plan_report, cluster.namenodes
    counts = {k: getattr(rep, k) for k in (
        "windows", "kernel_launches", "hintchain_launches",
        "pkval_launches", "pkval_probes", "pkval_demotions")}
    for k in ("pkval_launches", "pkval_probes", "pkval_demotions",
              "batched_ops", "treeagg_launches"):
        counts["nn_" + k] = sum(getattr(nn, k) for nn in nns)
    counts["nn_treeagg_mismatches"] = sum(nn.subtree.treeagg_mismatches
                                          for nn in nns)
    return dict(store=store, stats=stats, runs=runs, paths=paths, du=du,
                counts=counts, t_build=t_build, t_trace=t_trace,
                t_du=t_du, t_batch=t_batch)


def outcomes(r, physical: bool = True):
    """Per-op (ok, error, value), the du's value and the batch's stats;
    without the physical identifiers (inode ids, per-namenode mtime
    clocks) when ``physical`` is False."""
    if physical:
        ops = [(o.ok, o.error, None if o.result is None else o.result.value)
               for o in r["stats"].outcomes]
        stats = [[(s.path, s.inode_id, s.is_dir, s.perm, s.owner, s.size,
                   s.repl, s.mtime) for s in run] for run in r["runs"]]
        du = (r["du"].value, r["du"].cost.as_dict())
    else:
        ops = [(o.ok, o.error) for o in r["stats"].outcomes]
        stats = [[(s.path, s.is_dir, s.perm, s.owner, s.size, s.repl)
                  for s in run] for run in r["runs"]]
        du = r["du"].value
    return ops, du, stats


def canonical_state(store):
    """Every table's rows (``id_seq``, the id allocators' positions, left
    out) with inode ids replaced by paths, block ids by (file path, block
    index), and the namenodes' own atime/mtime clocks left out: what two
    runs must share when the same ops ran on other namenodes, which draw
    other ids and stamp other times.  An id whose inode is gone (the lease
    rows that deleted files leave behind) becomes "no inode": such rows
    are compared by their number only."""
    by_id = {r["id"]: r for part in store.table("inode").parts
             for r in part.values()}
    paths = {1: ""}                            # the root inode

    def path(iid):
        chain = []
        while iid not in paths:
            row = by_id.get(iid)
            if row is None or len(chain) > len(by_id):
                return ("no inode",)
            chain.append(row)
            iid = row["parent_id"]
        p = paths[iid]
        for row in reversed(chain):
            p = paths[row["id"]] = p + "/" + row["name"]
        return p

    blocks = {r["block_id"]: (path(r["inode_id"]), r["index"])
              for part in store.table("block").parts for r in part.values()}
    out = {}
    for name, t in store.tables.items():
        if name == "id_seq":
            continue
        rows = []
        for part in t.parts:
            for row in part.values():
                rows.append(tuple(
                    (k, path(v) if k in ("id", "parent_id", "inode_id")
                     else blocks.get(v, ("no block", v))
                     if k == "block_id" else v)
                    for k, v in sorted(row.items())
                    if k not in ("atime", "mtime")))
        out[name] = sorted(rows, key=repr)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bulk", type=int, default=1_000_000)
    ap.add_argument("--ops", type=int, default=20_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, launch_counts, \
        reset_launch_counts
    t_start = time.perf_counter()
    dev = card()

    # -- phase 1 -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    _build.library()
    log(f"build: {_build.build_info['seconds']:.2f} s -> "
        f"{_build.build_info['path']}")
    for line in str(_build.build_info["log"]).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- phase 2 -----------------------------------------------------------
    phase_kernels(args.seed, dev)

    # -- phase 3 -----------------------------------------------------------
    rec = Recorder()
    torch.cuda.reset_peak_memory_stats()
    col = drive(True, args.bulk, args.ops, dev, on_start=reset_launch_counts)
    launches = launch_counts()
    rec.restore()
    st, counts = col["stats"], col["counts"]
    inode = col["store"].table("inode")
    log(f"phase3 store: inodes={inode.n_rows} index_cap={inode.hindex.cap} "
        f"index_live={inode.hindex.live} "
        f"index_on_card_bytes={12 * inode.hindex.cap}")
    log(f"phase3 trace: ops={len(st.outcomes)} ok={st.ok} "
        f"failed={st.failed} round_trips={st.total_cost.round_trips} "
        f"batches={st.n_batches} build_s={col['t_build']:.3f} "
        f"trace_s={col['t_trace']:.3f} batch_s={col['t_batch']:.3f} "
        f"batch_stats={len(col['paths'])}x2")
    log(f"phase3 du /: {json.dumps(col['du'].value)} "
        f"round_trips={col['du'].cost.round_trips} du_s={col['t_du']:.3f}")
    log(f"phase3 counts: {json.dumps(counts)}")
    wall = col["t_trace"] + col["t_du"] + col["t_batch"]
    in_kernels = sum(t for _, t in rec.host_s.values())
    log("phase3 host time in kernel wrappers: " + ", ".join(
        f"{k} {n} calls {t:.4f} s" for k, (n, t) in rec.host_s.items())
        + f"; {in_kernels:.4f} s of {wall:.3f} s trace+du+batch wall "
        f"({100 * in_kernels / wall:.2f}%)")
    log(f"phase3 launches: {json.dumps(launches)} peak_device_bytes="
        f"{torch.cuda.max_memory_allocated()}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    # kernels vs plain on the main path's own inputs
    from repro_torch.kernels.hintchain import kernel as hk, ref as hr
    from repro_torch.kernels.phash import kernel as pk, ref as pr
    from repro_torch.kernels.pkval import kernel as vk, ref as vr
    from repro_torch.kernels.treeagg import kernel as tk, ref as tr
    pairs = {"phash": (pk.phash, pr.phash_ref, work_phash),
             "phash_chain": (pk.phash_chain, pr.phash_chain_ref,
                             work_phash_chain),
             "pkval": (vk.pkval, vr.pkval_ref, work_pkval),
             "hintchain": (hk.hintchain, hr.hintchain_ref, work_hintchain),
             "treeagg": (tk.treeagg, tr.treeagg_ref, work_treeagg)}
    rows = []
    for name, (kern, plain, work) in pairs.items():
        a, kw = rec.calls[name]
        got, want = kern(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"{name}: kernel != plain on main path")
        ms = device_ms(lambda: kern(*a, **kw))
        call_ms = cuda_ms(lambda: kern(*a, **kw))
        plain_ms = cuda_ms(lambda: plain(*a, **kw), reps=5, warmup=1)
        b_ms, b_by, n_bytes, n_ops = work(*a, **kw)
        shapes = [tuple(t.shape) for t in a if torch.is_tensor(t)]
        log(f"phase3 {name}: first main-path call shapes={shapes} "
            f"bit-equal ms={ms:.6f} call_ms={call_ms:.6f} "
            f"plain_ms={plain_ms:.6f} bound_ms={b_ms:.6f} "
            f"({b_by}; bytes={n_bytes} ops={n_ops})")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": max_abs_err(got, want), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    rec.calls.clear()

    # -- phase 4 -----------------------------------------------------------
    # the same run on the host, plain versions: equal in every byte
    host = drive(True, args.bulk, args.ops, torch.device("cpu"))
    if host["store"].dump_state() != col["store"].dump_state():
        raise AssertionError("card store state != host store state")
    if outcomes(host) != outcomes(col) or host["counts"] != counts \
            or host["stats"].total_cost.as_dict() != st.total_cost.as_dict():
        raise AssertionError("card outcomes or counts != host run's")
    log(f"phase4 host: columnar store on the CPU (plain versions): state, "
        f"{len(st.outcomes)} outcomes, du, OpCost and counts equal; "
        f"trace_s={host['t_trace']:.3f}")
    del host
    # the dict store, the oracle: no index, so no pkval demotions; a
    # demoted op rides the sequential path, maybe on another namenode,
    # which draws other inode and block ids and stamps other times: with
    # demotions the state must agree without those (canonical_state)
    oracle = drive(False, args.bulk, args.ops, dev)
    if outcomes(col, physical=False) != outcomes(oracle, physical=False):
        raise AssertionError("columnar outcomes != dict store outcomes")
    canon = canonical_state(col["store"])
    differ = [k for k, v in canonical_state(oracle["store"]).items()
              if canon.get(k) != v]
    if differ:
        raise AssertionError(f"columnar tables {differ} != dict store's")
    demoted = counts["pkval_demotions"] + counts["nn_pkval_demotions"]
    bytes_equal = col["store"].dump_state() == oracle["store"].dump_state()
    if not demoted and not bytes_equal:
        raise AssertionError("no demotions, yet columnar state != dict")
    log(f"phase4 oracle: dict store's {len(canon)} tables "
        f"({sum(map(len, canon.values()))} rows) equal up to ids and "
        f"clocks, {len(st.outcomes)} outcomes + du + "
        f"{2 * len(col['paths'])} batch stats equal; dump_state "
        f"byte-equal={bytes_equal} with {demoted} demotions; "
        f"dict trace_s={oracle['t_trace']:.3f} du_s={oracle['t_du']:.3f}")
    log(f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
