"""The port's CUDA kernels on the card, the integer ones held bit-equal
and the float ones (flash attention, the SSD scan) within the tolerances
of ``tests/test_kernels.py`` against their plain PyTorch versions, and the
planned request path run on the card against the same path on the CPU.
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
    y2, h2 = ssd_ref.ssd_ref(x, dt, A, Bc, Cc, h0=h0, chunk=chunk)
    atol = 4 * FLASH_ATOL[dtype]
    assert y.dtype == dtype and h.dtype == torch.float32
    _close(y, y2, atol, 2e-2)
    _close(h, h2, atol, 2e-2)


def _ssd_fp64(x, dt, A, Bc, Cc, Q):
    """The chunked SSD in float64, as a yardstick of both fp32 versions."""
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
    return torch.cat(ys, 1)


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
    y64 = _ssd_fp64(x, dt, A, Bc, Cc, 128)
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
