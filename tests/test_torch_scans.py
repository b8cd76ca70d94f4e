"""The segment-parallel decomposition of the two chunked scans, on the CPU.

``csrc/ssd_scan.cu`` and ``csrc/wkv_scan.cu`` cut the chunks of a scan
into segments of G chunks and run (A) each segment's local end state from
a zero start, (B) a pass over the segments, start(g + 1) = decay(g)
start(g) + local(g), from the initial state, and (C) the chunk loop of
every segment from its start state.  In bf16 every fp32 operand of a
product enters the tensor cores as two bf16 parts (hi = its bf16 rounding,
lo = the bf16 rounding of the rest), the bf16 inputs as they are.

A few lines of PyTorch here compute both scans that way, and are held
against the plain versions (``ssd_ref``, ``wkv6_ref``) with the card
tests' tolerances (atol 4 x (2e-5 fp32, 2e-2 bf16), rtol 2e-2), and
against a float64 loop: the fp32 error within 1.25x the plain version's,
the bf16 mean error within 1.5x, as ``tests/test_torch_cuda.py`` holds
the kernels.  This pins the kernels' numerics before the card runs them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

ATOL = {torch.float32: 4 * 2e-5, torch.bfloat16: 4 * 2e-2}
RTOL = 2e-2


def _split(t, on):
    """(hi, lo) bf16 parts of an fp32 tensor, as fp32 values; (t, 0)
    where the product stays in fp32."""
    if not on:
        return t, torch.zeros_like(t)
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _mm(eq, a, b, on):
    """einsum with a as its two parts (b enters as it is)."""
    hi, lo = _split(a, on)
    return torch.einsum(eq, hi, b) + torch.einsum(eq, lo, b)


def _pad(t, n):
    return torch.cat([t, t.new_zeros((t.shape[0], n) + t.shape[2:])], 1)


def _segmented(chunk_loop, s0, nc, G):
    """(A), (B), (C): chunk_loop(state, chunks, want_y) -> (ys, state,
    decay of the chunks, shaped to multiply the state)."""
    nseg = -(-nc // G)
    locs, decs = [], []
    for g in range(nseg - 1):                               # (A)
        _, loc, dec = chunk_loop(torch.zeros_like(s0),
                                 range(g * G, (g + 1) * G), False)
        locs.append(loc)
        decs.append(dec)
    starts = [s0]                                           # (B)
    for loc, dec in zip(locs, decs):
        starts.append(dec * starts[-1] + loc)
    ys = []
    for g in range(nseg):                                   # (C)
        y, s, _ = chunk_loop(starts[g], range(g * G, min((g + 1) * G, nc)),
                             True)
        ys += y
    return torch.cat(ys, 1), s


def ssd_segmented(x, dt, A, Bc, Cc, h0, *, chunk, G):
    """The SSD scan as ``ssd_scan.cu`` computes it."""
    on = x.dtype == torch.bfloat16
    B, S, H, hd = x.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtp, bf, cf = (_pad(t.float(), pad) for t in (x, dt, Bc, Cc))
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))

    def chunk_loop(h, chunks, want_y):
        ys, dec = [], torch.ones(B, H, 1, 1)
        for c in chunks:
            sl = slice(c * Q, (c + 1) * Q)
            xq, dq, bq, cq = xf[:, sl], dtp[:, sl], bf[:, sl], cf[:, sl]
            cum = torch.cumsum(dq * A, 1)                   # [B,Q,H]
            last = cum[:, -1]                               # [B,H]
            if want_y:
                cb = torch.einsum("btn,bsn->bts", cq, bq)
                seg = torch.where(tri[None, :, :, None],
                                  cum[:, :, None] - cum[:, None], -torch.inf)
                M = cb[..., None] * torch.exp(seg) * dq[:, None]
                hhi, hlo = _split(h, on)
                y = (torch.einsum("btn,bhpn->bthp", cq, hhi)
                     + torch.einsum("btn,bhpn->bthp", cq, hlo)) \
                    * torch.exp(cum)[..., None]
                ys.append(y + _mm("btsh,bshp->bthp", M, xq, on))
            w = torch.exp(last[:, None] - cum) * dq
            h = h * torch.exp(last)[..., None, None] + _mm(
                "bshp,bsn->bhpn", xq * w[..., None], bq, on)
            dec = dec * torch.exp(last)[..., None, None]
        return ys, h, dec

    h0 = torch.zeros(B, H, hd, N) if h0 is None else h0.float()
    y, h = _segmented(chunk_loop, h0, nc, G)
    return y[:, :S].to(x.dtype), h


def wkv_segmented(r, k, v, w, u, s0, *, chunk, G):
    """The WKV scan as ``wkv_scan.cu`` computes it."""
    on = r.dtype == torch.bfloat16
    B, S, H, hd = r.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    lw = torch.clamp_min(torch.log(torch.clamp_min(w.float(), 1e-30)), -60.)
    rf, kf, vf, lwp = (_pad(t.float(), pad) for t in (r, k, v, lw))
    uf = u.float()
    strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool), diagonal=-1)

    def chunk_loop(s, chunks, want_y):
        ys, dec = [], torch.ones(B, H, hd, 1)
        for c in chunks:
            sl = slice(c * Q, (c + 1) * Q)
            rq, kq, vq, lq = rf[:, sl], kf[:, sl], vf[:, sl], lwp[:, sl]
            cum = torch.cumsum(lq, 1)                        # [B,Q,H,hd]
            cum_prev = cum - lq
            if want_y:
                seg = torch.where(strict[None, :, :, None, None],
                                  cum_prev[:, :, None] - cum[:, None],
                                  -torch.inf)
                att = (rq[:, :, None] * kq[:, None] * torch.exp(seg)).sum(-1)
                diag = (rq * uf * kq).sum(-1)                # [B,Q,H]
                att = att + torch.diag_embed(diag.transpose(1, 2)
                                             ).permute(0, 2, 3, 1)
                y = _mm("btsh,bshd->bthd", att, vq, on)
                rn_hi, rn_lo = _split(rq * torch.exp(cum_prev), on)
                s_hi, s_lo = _split(s, on)
                eq = "bthc,bhcd->bthd"
                y = y + torch.einsum(eq, rn_hi, s_hi) + torch.einsum(
                    eq, rn_hi, s_lo) + torch.einsum(eq, rn_lo, s_hi)
                ys.append(y)
            k_end = kq * torch.exp(cum[:, -1:] - cum)
            s = s * torch.exp(cum[:, -1])[..., None] + _mm(
                "bshc,bshd->bhcd", k_end, vq, on)
            dec = dec * torch.exp(cum[:, -1])[..., None]
        return ys, s, dec

    s0 = torch.zeros(B, H, hd, hd) if s0 is None else s0.float()
    y, s = _segmented(chunk_loop, s0, nc, G)
    return y[:, :S].to(r.dtype), s


# ---------------------------------------------------------------------------
# float64 yardsticks
# ---------------------------------------------------------------------------

def _ssd_fp64(x, dt, A, Bc, Cc, h0):
    """The SSD recurrence step by step in float64."""
    x, dt, A, Bc, Cc = (t.double() for t in (x, dt, A, Bc, Cc))
    B, S, H, hd = x.shape
    h = torch.zeros(B, H, hd, Bc.shape[-1], dtype=torch.float64) \
        if h0 is None else h0.double()
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], Bc[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cc[:, t], h))
    return torch.stack(ys, 1), h


def _wkv_fp64(r, k, v, w, u, s0):
    """The WKV recurrence step by step in float64, with the plain
    version's clamp of the log decay."""
    r, k, v, u = (t.double() for t in (r, k, v, u))
    w = torch.exp(torch.clamp_min(torch.log(torch.clamp_min(
        w.double(), 1e-30)), -60.))
    B, S, H, hd = r.shape
    s = torch.zeros(B, H, hd, hd, dtype=torch.float64) if s0 is None \
        else s0.double()
    ys = []
    for t in range(S):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhc,bhcd->bhd", rt, s)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        s = s * w[:, t][..., None] + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, 1), s


def _held(dtype, seg, plain, exact):
    """seg against plain within the card tests' tolerances, and seg's
    error against float64 within the card tests' factor of plain's.  In
    bf16 the final state stays fp32: two bf16 parts hold each operand to
    ~2^-17 where fp32 holds it to 2^-24, so its error may be up to 2^7
    times the plain version's (one rounding, 2^-9, would be 2^15)."""
    for a, b, e in zip(seg, plain, exact):
        torch.testing.assert_close(a.float(), b.float(), atol=ATOL[dtype],
                                   rtol=RTOL)
        es, ep = ((t.double() - e).abs() for t in (a, b))
        if dtype == torch.float32:
            assert es.max() <= 1.25 * ep.max(), (float(es.max()),
                                                 float(ep.max()))
            assert es.mean() <= 1.25 * ep.mean(), (float(es.mean()),
                                                   float(ep.mean()))
        elif a.dtype == torch.bfloat16:               # y
            assert es.mean() <= 1.5 * ep.mean(), (float(es.mean()),
                                                  float(ep.mean()))
        else:                                         # h or S, fp32
            assert es.mean() <= 128 * ep.mean(), (float(es.mean()),
                                                  float(ep.mean()))
            assert es.max() <= 128 * ep.max(), (float(es.max()),
                                                float(ep.max()))


# S = 1000 in chunks of 128: 8 chunks, the last of 104 steps; G = 3 does
# not divide them (segments of 3, 3 and 2 chunks); G = 1 is a segment a
# chunk; G = 8 one segment
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_segments_match_plain_and_float64(G, dtype, with_h0):
    rng = np.random.default_rng(G + 10 * with_h0)
    B, S, H, hd, N = 1, 1000, 2, 16, 8
    x = torch.from_numpy(rng.standard_normal((B, S, H, hd),
                                             dtype=np.float32)).to(dtype)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H), dtype=np.float32)))
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(H, dtype=np.float32)) * 0.3)
    Bc, Cc = (torch.from_numpy(rng.standard_normal(
        (B, S, N), dtype=np.float32)).to(dtype) for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((B, H, hd, N),
                                              dtype=np.float32)) \
        if with_h0 else None
    seg = ssd_segmented(x, dt, A, Bc, Cc, h0, chunk=128, G=G)
    plain = ssd_ref.ssd_ref(x, dt, A, Bc, Cc, h0=h0, chunk=128)
    _held(dtype, seg, plain, _ssd_fp64(x, dt, A, Bc, Cc, h0))


# S = 1000 in chunks of 32: 32 chunks, the last of 8 steps; G = 5 does not
# divide them
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s0_dtype", [None, torch.float32, torch.bfloat16])
def test_wkv_segments_match_plain_and_float64(G, dtype, s0_dtype):
    rng = np.random.default_rng(G + 3)
    B, S, H, hd = 1, 1000, 2, 16

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32) * np.float32(scale))

    r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, S, H, hd) * 0.5))
    u = randn(H, hd, scale=0.1)
    s0 = None if s0_dtype is None else randn(B, H, hd, hd).to(s0_dtype)
    seg = wkv_segmented(r, k, v, w, u, s0, chunk=32, G=G)
    plain = wkv_ref.wkv6_ref(r, k, v, w, u, s0=s0, chunk=32)
    _held(dtype, seg, plain, _wkv_fp64(r, k, v, w, u, s0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_segments_strong_decay_is_finite(dtype):
    """w = 1e-45 (below fp32's normals): every kept exponent is <= 0 and
    the masked ones are never taken, so the segments stay finite."""
    rng = np.random.default_rng(4)
    B, S, H, hd = 1, 200, 2, 16
    r, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, H, hd), dtype=np.float32)).to(dtype) for _ in range(3))
    w = torch.full((B, S, H, hd), 1e-45)
    u = torch.ones(H, hd)
    seg = wkv_segmented(r, k, v, w, u, None, chunk=32, G=3)
    assert all(torch.isfinite(t.float()).all() for t in seg)
    plain = wkv_ref.wkv6_ref(r, k, v, w, u, chunk=32)
    _held(dtype, seg, plain, _wkv_fp64(r, k, v, w, u, None))
