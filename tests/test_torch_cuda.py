"""The port's CUDA kernels on the card, held bit-equal against their plain
PyTorch versions, and the planned request path run on the card against the
same path on the CPU.  Needs an NVIDIA card of compute capability 9.0 and
``nvcc``; skipped elsewhere:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.core.columnar as t_col
import repro_torch.core.workload as t_wl
from repro_torch.kernels import launch_counts, reset_launch_counts
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
