"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--bulk 1000000] [--ops 20000]
    python3 chip_smoke.py --scan-times [--src DIR] [--tag NAME] [--profile]
    python3 chip_smoke.py --meta-times [--src DIR] [--tag NAME] [--profile]

Drives the ported paths, the metadata request path (phases 2-4), the
zamba2 model path (phases 5-7), gmm's own path and the rwkv6 model path
(phases 8-10), the metadata path under failover (phase 11), the decoder
families: qwen3-moe (phase 12), gemma3, qwen2-vl, seamless and mixtral
(phase 13), training: qwen1.5-4B (phase 14), the other kernels'
training paths and the trainer (phase 15), the multi-device layer
(phase 16; its second part on four cards) and one production rank's
step against the dry run's prediction (phase 17).  Phases,
each printing its results on lines of its own; any failure raises and the
script exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``) and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together), with ptxas's register,
   spill and wgmma-serialization lines and the count of HGMMA (wgmma)
   instructions in the library (``cuobjdump``).
2. Kernel vs plain version on the card, bit-equal, on seeded synthetic
   inputs: phash over 1,048,576 keys, phash_chain at N=4096, D=16,
   pkval against a 2^23-slot index with ~1M live entries, tombstones and
   AMBIG buckets (65,536 probes, padding parents included), hintchain over
   65,536-slot client and fallback tables at N=4096, D=16 (route
   ``global``) and over the main path's 64 + 8,192 slots at N=1,024
   (route ``smem``, the tables in shared memory), treeagg over 1,048,576
   inode slots (runs of children, other parents, cleared slots, sums that
   wrap) against a wave of 4,096 directories in its seg form, and in its
   compact form (the children's ids compacted on the card) against waves
   of 4,096 and of 1.  Times are CUDA-event medians of 20 launches after
   warm-up.  Then the launch floor (an empty kernel, back to back) and
   one dependent device-memory load (a pointer chase over 512 MiB).
3. The main path at deployment size: a columnar store on the card with 4
   datanodes and 4 namenodes, the Spotify-shaped namespace (127
   directories x 16 files) created through the op path plus a bulk
   directory of ``--bulk`` file inodes (the inode hash index, 2^23 slots at
   1M entries, lives on the card), then a ``--ops`` Spotify trace through
   ``DFSClient.run_trace(planned=True, batch_size=64, window=1024,
   adaptive=False)`` (its subtree deletes expand their waves with
   treeagg over the inode columns on the card; each namenode's subtree
   pool at parallelism 1, so that its threads cannot race on a shared
   OpCost and the run is deterministic), a ``du`` of the whole
   namespace (a treeagg launch per wave) and a ``DFSClient.batch()`` of
   1,024 stats served from the namenode's hint cache.  The launch counts
   are set to 0 just before and read just after: each of the five
   kernels must have run, every hintchain launch on route ``smem``.
   The host time in the kernels' wrappers is reported per wrapper, wall
   and the thread's CPU time (their difference: waits for the GIL or the
   OS; CUDA's synchronisation spins, so waits for the card are CPU
   time), with treeagg's calls whose wave holds at least BIG_WAVE
   children apart.
   Each kernel's first main-path call is recorded and replayed against the
   plain version: those shapes give the JSON line's times and bounds.
4. Checks: the same build, trace, du and batch on the host (plain
   versions) must end byte-equal to the card's run, in state, outcomes,
   OpCost and counts; a failure names the first table row and the first
   op that differ and every differing key.  Then the oracle, the dict ``MetadataStore``: every
   outcome must be equal, and every table's rows, with inode and block ids
   replaced by paths and the namenodes' atime/mtime clocks left out
   (``canonical_state``); byte-equal, ids and all, when pkval demoted no
   chain.

5. The model kernels against their plain versions on the card, at
   synthetic sizes, in bf16 and fp32: flash attention at B=1, S=4096,
   H=32, KV=8, hd=128 with window None/1024 and softcap None/50, at
   zamba2's H=KV=32, hd=80, and at a ragged S=1000, and in bf16 at hd=64
   and hd=256 (H=32, KV=8); the SSD scan at B=2,
   S=4096, H=80, hd=64, N=64, Q=128 with and without an initial state,
   and at a ragged S=1000.  Tolerances: tests/test_kernels.py's (FLASH_TOL,
   SSD_TOL).  ``library_ms`` is one ``scaled_dot_product_attention`` call
   on the same inputs (none with a softcap; none for the SSD scan).  The
   rows of the kernels that run bf16 on the tensor cores (flash, gmm and
   the two scans) add the achieved TFLOP/s and its share of the
   989 TFLOP/s bf16 peak; gmm's and the scans' rows their route (a scan:
   ``tc`` in bf16, ``simt`` in fp32, as the library recorded it after the
   launch; phases 6 and 9 hold every main-path launch to it), the scans'
   rows their segments of G chunks and the bytes of state scratch.
6. The zamba2 model path on the card: ``get_config("zamba2_2_7b")``
   unchanged (54 layers, full width, 6,587,337,888 parameters in fp32 from
   a seeded ``torch.Generator`` on the card).  A scoring ``forward`` at
   B=2, S=4096 with ``use_kernels=True``: the launch counts are set to 0
   just before and read just after, and must be exactly 9 flash_attention
   and 54 ssd, every ssd launch on the tensor-core route; its logits held
   against the plain path's.  Each kernel's
   first call on that path is replayed against its plain version, which
   gives the JSON line's times and bounds.  The same forward once more with
   every one of its launches held against the plain version on that
   launch's own inputs.  A cache-filling prefill (B=4, S=1024 into a
   2048-slot cache), kernel path against plain on the logits and every
   cache leaf, and once more launch by launch.  ``ServeEngine(max_batch=4, max_seq=256)``
   answers 4 requests of 8-64 prompt tokens, 16 new tokens each.
7. Host check at full width and 6 layers (one shared-attention
   application), the same parameter tensors on the CPU: the card's kernel
   path against the host's plain path on a B=1, S=512 forward, and the
   card's engine against the host's on every decode step's logits, both
   fed the host's tokens.
   Phases 6, 7, 9, 10, 12 and 13 hold a bf16 result against the plain bf16
   result by the plain path's own bf16-vs-fp32 gap (NOISE_FACTOR,
   NOISE_FLOOR): random weights amplify any rounding, so no fixed
   tolerance fits.  At 54 layers that gap saturates (bf16 and fp32 logits
   are uncorrelated), so there the launch-by-launch checks carry the
   kernels' correctness.
   The zamba2 parameters are freed before phase 8.
8. gmm's own path: the experts' SwiGLU FFN of one qwen3-moe layer over its
   capacity buffers (E=128, C=640 = ceil(8192 x 8 / 128 x 1.25) for B=2,
   S=4096 at top-8, D=2048, F=768, bf16) through ``ops.gmm``: exactly 3
   gmm launches, each held against the plain version and each by the TMA
   route; the first one replayed gives the JSON line's times.  Then the
   WKV scan and gmm
   against their plain versions, in bf16 and fp32: WKV at B=2, S=4096,
   H=40, hd=64 with and without an initial state, at a ragged S=1000 with
   one, and on the strong-decay input (w = 1e-45); gmm at the qwen3-moe
   shape (the TMA route in bf16) and a ragged E=8, C=600, D=1000, F=700
   (1,400-byte rows: the plain-loads route in bf16); fp32 runs the SIMT
   kernel, and each row's route is checked.  Tolerances:
   tests/test_kernels.py's (WKV_TOL, GMM_ATOL).  ``library_ms`` is one
   ``torch.bmm`` call for gmm (none for the WKV scan).
9. The rwkv6 model path on the card: ``get_config("rwkv6_3b")`` unchanged
   (32 layers, full width, 3,073,479,680 parameters in fp32 from a seeded
   ``torch.Generator`` on the card, bf16 compute).  A scoring ``forward``
   at B=2, S=4096 with ``use_kernels=True``: exactly 32 wkv6 launches,
   each on the tensor-core route, and none of the other model kernels; its logits held against the plain
   path's; the first launch replayed for the JSON line; the forward once
   more with every launch held against the plain version.  A cache-filling
   prefill in two segments (B=4: S=1024 from the engine's zero cache, then
   S=1024 more from the returned cache, so the kernel starts from a
   nonzero state), 32 launches each, the second segment's logits and
   cache leaves against the plain path's and its launches one by one.
   ``ServeEngine(max_batch=4, max_seq=256)`` on 4 requests of 8-64 prompt
   tokens, 16 new tokens each, with its time per decode step.
10. Host check at full width and 4 layers, as phase 7.
11. Failover at deployment size: phase 3's build on the card, 1M inodes
    and all, started with 2 namenodes under an ``ElasticNamenodePool`` of
    2 to 4 (FAILOVER_POOL) attached by ``DFSClient.attach_pool``, and
    phase 3's trace replayed through ``replay_with_recovery``, the §7.6
    protocol, with FAILOVER_PLAN injected: the leader's crash at a batch
    exchange after the first scale-out, a partition of namenode 1, a
    delay on the first joiner and a crash between a subtree delete's
    chunk commits.  Then ``du /`` and the 1,024-stat batch, as phase 3.
    Checks, any failure raising: every planned fault fired, the pool
    scaled out and in; each of the five metadata kernels launched, its
    first call bit-equal to its plain version; no orphan lease, UC or
    block row, no stale subtree lock, every lock released
    (``RecoveryInvariants``); the same build, plan and trace on the host
    byte-equal to the card's run (state, outcomes, du, batch, the chaos
    report, pool events, counts); every op's outcome equal to phase 3's,
    and, once both are quiesced (``quiesce``), every table but the
    election's equal to phase 3's up to ids and clocks; ``profile_ops``
    equal on card and host.  Prints the build, replay and recovery
    times, the scale and fault events and the peak device bytes.
12. The qwen3-moe model path on the card at full width (d=2048, 32 heads
    of 64, kv 4, 128 experts top-8 of expert d_ff 768, vocab 151,936) and
    QWEN3_LAYERS = 24 of its 48 layers (all 48 are 120.3 GB in fp32):
    15,350,728,704 fp32 parameters from a seeded ``torch.Generator``,
    bf16 compute.  A scoring ``forward`` at B=2, S=2048 with
    ``use_kernels=True``: exactly 24 flash_attention and 72 gmm launches
    (the dense MoE route's three expert matmuls a layer, every token
    through all 128 experts), every gmm on the TMA route, none of the other
    kernels; tokens/s from a second, warm call; the peak device bytes.
    The same forward once more with every launch held against its plain
    version; the first flash and gmm calls replayed for the JSON line
    (``library_ms``: SDPA, ``torch.bmm``).  A cache-filling prefill (B=4,
    S=512 into a 1024-slot cache), kernels against plain on the logits and
    every cache leaf.  ``ServeEngine(max_batch=4, max_seq=256)`` on 4
    requests of 8-64 prompt tokens, 16 new tokens each, with its time per
    decode step.  A host check at full width and 2 layers (B=1, S=128),
    as phase 7.
13. gemma3_12b (6 layers: one 5:1 local-to-global group), qwen2_vl_7b (4
    layers, patch embeddings over its 1,024 leading positions and M-RoPE
    positions), seamless_m4t_medium (whole, 12 + 12 layers, encoder frames)
    and mixtral_8x22b (2 layers, ~21.6 GB) at full width on the card, one
    at a time (FAMILY_CUTS): a scoring ``forward`` at B=1, S=2048 with
    ``use_kernels=True``, exactly one flash launch a decoder layer and
    three gmm launches a MoE layer, every launch then held against its
    plain version; ``ServeEngine`` on 2 requests, 8 new tokens each.
    gemma3 also: every flash launch got the 1024-token window, the global
    layer's too (the reference's fault, kept; ROADMAP.md queue 3), and at
    S = 1024 (= the window, where the fault cannot show) its kernel path
    agrees with its plain path within noise.
14. qwen1.5-4B training at full width (d=2560, 20 heads of 128, d_ff
    6,912, vocab 151,936) and TRAIN_LAYERS = 40 layers, ``remat="full"``:
    3,950,369,280 fp32 parameters from a seeded ``torch.Generator`` (63.2
    GB with their gradients and AdamW's moments), bf16 compute.  Three
    ``make_train_step(..., use_kernels=True)`` steps of AdamW (lr 1e-4,
    no warmup) on one ``synthetic_batch(1, 2048)``: the launch counts are
    set to 0 before each step and read after, exactly 80 flash launches a
    step (40 in the forward, 40 in the backward's recompute) and no other
    kernel; the first step holds every launch against its plain version;
    every loss finite, the third no more than the first plus 0.5
    (``tests/test_arch_smoke.py``'s rule), the parameters finite; ms per
    warm step, training tokens/s, the peak device bytes; one more step
    under ``torch.profiler`` split by where each device event was
    launched (``train_split``: flash kernels, the attention's plain
    backward, the LM head and loss, the optimizer, the rest).  The first
    flash call replayed for the JSON line.  At 8 layers, loss and
    gradients with ``remat="none"`` and ``"full"``: equal (bitwise where
    the card's kernels are deterministic, else within 1e-6 of each leaf's
    largest element), 8 against 16 flash launches, both peaks.  At 2
    layers (B=1, S=128) the card's kernel path against the host's plain
    path, loss and every gradient leaf by the noise rule, and
    ``adamw_update`` on the card against the host on identical gradients
    (atol 1e-6).
15. Full width, one model at a time (TRAIN_CUTS): zamba2_2_7b (12 of 54
    layers: two shared-attention applications), rwkv6_3b (8 of 32) and
    qwen3_moe_30b_a3b (2 of 48, the dense MoE route), at B=1, S=1024:
    the loss and gradients with the kernels (exact launches: ssd one a
    Mamba2 layer, flash one a shared-attention application or decoder
    layer, wkv6 one a layer, gmm three a MoE layer; none in the backward,
    which differentiates the plain versions) against the plain path's by
    the noise rule; a training step with every launch held against its
    plain version, a finite loss and finite parameters.  Then the trainer
    as users start it, in a subprocess on the card: ``python -m
    repro_torch.launch.train --arch qwen1_5_4b --smoke --steps 12
    --ckpt-every 5``, then ``--resume --steps 14``: it must resume from
    step 10, its ledger end at step 13, both exit 0.

16. The multi-device layer.  On every card: a one-rank NCCL group and
    ``make_host_mesh()``; a full-width qwen3-moe layer (MESH1_MOE_BS) on
    that (1, 1) mesh takes the dense route, bitwise equal to
    ``mesh=None`` with exactly 3 gmm launches; ``pipeline_apply`` with one
    stage over 2 qwen1.5-4B layers, bitwise equal to the layers in
    sequence; the trainer's smoke configuration, two steps on the mesh;
    one ``phase16 {"ranks": 1, ...}`` line.  When EP_RANKS = 4 cards are
    visible (else a line says that part did not run and on how many
    cards): ``nvidia-smi topo -m``, then 4 ranks spawned by
    ``launch.mesh.spawn_ranks`` (NCCL, one card each, the kernel library
    built here first) run ``ep_rank``: qwen3_moe_30b_a3b at full width
    and all 48 layers on a (1, 4) mesh through the expert-parallel route
    (replicated leaves from the seed, alike on every rank by an
    all-reduced checksum; each rank's 32 experts from (seed, rank)),
    scoring at B=2, S=2048: exactly 48 flash, 144 gmm (every one on the
    TMA route) and 96 all-to-alls a rank, the logits bitwise equal across
    ranks, a warm forward's time, tokens/s, peak bytes and all-to-all
    time, its device time by kernel, every launch held against its plain
    version, gmm's first call replayed for the JSON line; at 2 layers the
    4-rank output against one card computing the same function
    (``one_card_moe``: ``_dispatch``, all 128 experts through
    ``_expert_ffn`` with the route's capacity, ``_combine``) within
    NOISE_FLOOR relative L2; ``pipeline_apply`` over 4 stages, 8 of
    qwen1.5-4B's layers (2 a stage), 8 microbatches of B=1, S=512,
    against the same layers in sequence on one card, both timed; data
    parallelism (``dp_rank``): a 2-layer qwen3-moe train step in fp32 on
    a (2, 2) ("data", "model") mesh (the batch's rows over `data`, the
    experts over `model`), every rank's gathered parameters bitwise
    alike, held to rank 0's step on the whole batch on its card alone in
    two microbatches, the ranks' rows (DP_ATOL, DP_LOSS_RTOL).
17. One production rank (``phase_dryrun``): ``launch.dryrun``'s
    prediction of rank 0 of the 16x16 mesh for each candidate cell in
    turn (the prefill_32k cells, then train_4k, then qwen3-moe x
    decode_32k), and the first flash cell and the gmm cell whose
    predicted executed peak is under DRYRUN_LIMIT run on the card, at
    full width and depth, at the rank's shard shapes, on a fake process
    group of 256 ranks (``dryrun_rank``): a first call under the dry
    run's FLOP counter and ``StepRecorder(fill=True)`` (each collective's
    output written as if every rank held this one's tensor), whose
    FLOPs and collectives must equal the prediction's and whose every
    flash and gmm launch has its first and last DRYRUN_ROWS rows held
    to the plain version; each kernel's first launch timed alone; a
    warm call (its collectives cost nothing) timed by CUDA events
    against the roofline's ``bound_s``, its peak against the predicted
    executed peak; one ``{"dryrun_rank": ...}`` line a cell, with the
    card's name and power limit.

The line third from the end is the training JSON (phases 14-15), the
line before the last the kernels' JSON (nine kernels; flash and gmm once
more for the qwen3-moe path, flash once more for the training path, gmm
once more for the four-card path when it ran; each row names its path),
the last line the device JSON.  Without a CUDA device, or outside the repository,
it exits non-zero and prints no result.

``--meta-times`` runs none of the phases either: it holds the four
redesigned metadata kernels, treeagg (the form its main path launches),
hintchain, pkval and phash_chain, against their plain versions at their
main-path shapes (META_CASES: the first wave of a subtree op over
1,002,162 slots, the wave that holds ``/bulk``'s million files, two
planner windows, pkval's first call with the index's refresh, a
phash_chain window) and times the kernel and its wrapper (inputs to the
card, launch, results back; median and least, and the thread's CPU
time), for pkval and phash_chain also the bare binding's steps and the
two ways to copy, one JSON line a case after a line with the launch
floor (``--profile`` adds the launch's CUDA kernels, the wrapper's
copies and kernels by ``torch.profiler`` and its host time by
``cProfile``); with ``--src`` as below.

``--scan-times`` runs none of the phases: it holds the two chunked scans,
``ssd`` and ``wkv6``, against their plain versions at the model paths'
shapes (SCAN_CASES) and times them as phase 5 does, one JSON line a case
(``--profile`` adds each call's CUDA kernels, local states, pass and chunk
loop, as ``torch.profiler`` traces them).  ``--src`` imports
``repro_torch`` from the ``src`` directory of another checkout, which
builds its own kernels, so that two versions are timed by the same code:
compare them in one call on one card, in turns (parent, change, change,
parent).
"""
from __future__ import annotations

import argparse
import json
import os
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
#: device-memory round trips that a launch of these kernels must wait for
#: one after another, beside the launch floor: pkval's probe window
#: (an index larger than L2); phash_chain's loads are independent
LATENCY_CHAIN = {"pkval": 1, "phash_chain": 0}
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
    # one write a line: the ranks of phase 16 share the output
    sys.stdout.write(" ".join(map(str, a)) + "\n")
    sys.stdout.flush()


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


def _treeagg_hits(wave, par):
    """(children, directories among them, live slots) of these inputs."""
    w = wave.numel()
    seg = torch.searchsorted(wave, par)
    hit = ((par >= 0) & (seg < w) & (wave[seg.clamp(max=max(w - 1, 0))]
                                     == par)) if w else par < -1
    return int(hit.sum()), hit, int((par >= 0).sum())


def work_treeagg(wave, ids, par, isdir, size):
    """The compact form, as the main path runs it: every slot's parent
    read; is_dir, size and id read for the children found; the wave read,
    three sums per member and the counts written, each child's id written
    and each directory's once more.  Operations: a compare and a halving
    per search step of each live slot and three adds per child."""
    w, c = wave.numel(), par.numel()
    hits, hit, live = _treeagg_hits(wave, par)
    n_dirs = int((isdir[hit] == 1).sum())
    return bound(4 * w + 4 * c + 16 * hits + 12 * w + 8 + 8 * hits
                 + 8 * n_dirs,
                 live * 3 * max(1, w.bit_length()) + 3 * hits)


def work_treeagg_seg(wave, par, isdir, size):
    """The seg form: every slot's parent read and seg written; is_dir and
    size read for the children found; the wave read and three sums per
    member written."""
    w, c = wave.numel(), par.numel()
    hits, _, live = _treeagg_hits(wave, par)
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


def synthetic_hint_tables(rng, n_ops: int, depth: int = 16,
                          n_nodes: int = 20_000, client_max: int = None,
                          caps=(64, 64)):
    """Client and fallback hint tables over a random tree of n_nodes, and
    n_ops chains walking down it (mixed depths, 0 included); the client
    table holds at most client_max edges (its others go to the fallback);
    the tables start at caps slots and grow as their inserts need."""
    from repro_torch.core.columnar import AMBIG, HashIndex
    from repro_torch.core.workload import name_hash32
    parents = np.concatenate([[0, 0], rng.integers(
        np.maximum(1, np.arange(2, n_nodes) // 3), np.arange(2, n_nodes))])
    kids = {i: [] for i in range(n_nodes)}
    client, fallback = HashIndex(caps[0]), HashIndex(caps[1])
    n_client = 0
    for iid in range(2, n_nodes):
        par, h = int(parents[iid]), name_hash32(f"n{iid}")
        kids[par].append((h, iid))
        r = rng.random()
        to_client = r < 0.45 or 0.85 <= r < 0.9 or r >= 0.95
        if to_client and client_max is not None:
            if n_client >= client_max:
                r = 0.5                  # the client is full: the fallback
            n_client += 1
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


def phase_kernels(seed: int, dev):
    """Phase 2; returns ``launch_floor``'s numbers."""
    from repro_torch.kernels.hintchain import kernel as hk, ref as hr
    from repro_torch.kernels.phash import kernel as pk, ref as pr
    from repro_torch.kernels.pkval import kernel as vk, ref as vr
    from repro_torch.kernels.treeagg import kernel as tk, ref as tr
    rng = np.random.default_rng(seed)
    cases = {}
    keys = i32(rng.integers(0, 1 << 32, size=1 << 20), dev)
    # name: (kernel, plain version, args, kwargs, work, read the kernel's
    # output back to the plain version's form, route the kernel must take)
    cases["phash"] = (pk.phash, pr.phash_ref, (keys, 64), {}, work_phash,
                      None, None)
    n, d = 4096, 16
    par = i32(rng.integers(0, 1 << 32, size=(n, d)), dev)
    nam = i32(rng.integers(0, 1 << 32, size=(n, d)), dev)
    hints = i32(rng.integers(0, 1 << 32, size=n), dev)
    dep = i32(rng.integers(0, d + 1, size=n), dev)
    dep[:64] = 0
    cases["phash_chain"] = (pk.phash_chain, pr.phash_chain_ref,
                            (par, nam, hints, dep, 64), {}, work_phash_chain,
                            None, None)
    (tp, tn, tv), kpar, knam = synthetic_index(rng, 1 << 23, 1_050_000)
    m = 1 << 16
    pick = rng.integers(0, kpar.size, size=m)
    ppar, pnam = kpar[pick].copy(), knam[pick].copy()
    r = rng.random(m)
    ppar[r < 0.25] = rng.integers(1, 1 << 30, size=int((r < 0.25).sum()))
    ppar[r > 0.95] = -1                                # padding parents
    idx = tuple(i32(a, dev) for a in (tp, tn, tv))
    cases["pkval"] = (vk.pkval, vr.pkval_ref,
                      idx + (i32(ppar, dev), i32(pnam, dev)), {}, work_pkval,
                      None, None)
    for name, hint_kw, route in (
            ("hintchain", {"n_ops": 4096}, "global"),
            ("hintchain main-path shape", {
                "n_ops": 1024, "n_nodes": 2000, "client_max": 24,
                "caps": (64, 8192)}, "smem")):
        client, fallback, hnames, hdep = synthetic_hint_tables(rng,
                                                               **hint_kw)
        if route == "smem" and (client.cap, fallback.cap) != (64, 8192):
            raise AssertionError(f"{name}: tables of {client.cap} and "
                                 f"{fallback.cap} slots, not 64 and 8,192")
        tabs = tuple(i32(a, dev) for a in (*client.arrays(),
                                            *fallback.arrays()))
        cases[name] = (hk.hintchain, hr.hintchain_ref,
                       tabs + (i32(hnames, dev), i32(hdep, dev)),
                       {"root_id": 1}, work_hintchain, None, route)
    slots = synthetic_slots(rng, 1 << 20, 4096)
    cases["treeagg"] = (tk.treeagg, tr.treeagg_ref,
                        tuple(i32(a, dev) for a in slots), {},
                        work_treeagg_seg, None, None)
    for w in (4096, 1):
        wave, par, isdir, size = synthetic_slots(rng, 1 << 20, w)
        ids = torch.from_numpy(rng.permutation(1 << 20) + 2).to(dev)
        cases[f"treeagg compact W={w}"] = (
            tk.treeagg_compact, tr.treeagg_expand_ref,
            (i32(wave, dev), ids, *(i32(a, dev) for a in (par, isdir, size))),
            {}, work_treeagg,
            lambda out, w=w: tk.unpack(out, w, 1 << 20), None)
    for name, (kern, plain, args, kw, work, read, route) in cases.items():
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if route is not None and hk.LAST_ROUTE != route:
            raise AssertionError(f"{name}: route {hk.LAST_ROUTE}, not "
                                 f"{route}")
        if read is not None:
            got, want = read(got), tuple(t.cpu() for t in want)
        if not same(got, want):
            raise AssertionError(f"{name}: kernel != plain version")
        ms = device_ms(lambda: kern(*args, **kw))
        call_ms = cuda_ms(lambda: kern(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
        b_ms, b_by, n_bytes, n_ops = work(*args, **kw)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        extra = f" route={route}" if route else ""
        log(f"phase2 {name}: bit-equal shapes={shapes} ms={ms:.6f} "
            f"call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={b_ms:.6f} ({b_by}; bytes={n_bytes} ops={n_ops})"
            f"{extra}")
    live = int((tp >= 0).sum())
    log(f"phase2 pkval index: cap={tp.size} live={live} "
        f"tombstones={int((tp == -2).sum())} ambig={int((tv == -3).sum())}")
    floor = launch_floor(dev)
    log(f"phase2 launch floor: empty kernel ms={floor[0]:.6f} "
        f"call_ms={floor[1]:.6f}; one device-memory round trip "
        f"ms={floor[2]:.6f} (pointer chase, {CHASE_STEPS} steps over "
        f"{4 * CHASE_SLOTS >> 20} MiB)" if floor else
        "phase2 launch floor: not measured (no launch_floor in the "
        "library)")
    return floor


#: the pointer chase of ``launch_floor``: a random cycle over 512 MiB (ten
#: times L2), walked this many steps
CHASE_SLOTS = 1 << 27
CHASE_STEPS = 100_000


def launch_floor(dev):
    """(device ms, call ms) of an empty kernel launched through the same
    ctypes path as the kernels, and the ms of one round trip to device
    memory (a dependent pointer chase over a random cycle), from the two
    measurements in the metadata kernels' source; None for a library
    without them."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.library()
    if not hasattr(lib, "launch_floor"):
        return None
    lib.launch_floor.argtypes = [ctypes.c_void_p]
    lib.memory_round_trips.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_void_p, ctypes.c_void_p]

    def run(fn, *args):
        if fn(*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"{fn.__name__}: launch refused")

    empty = lambda: run(lib.launch_floor)          # noqa: E731
    perm = torch.randperm(CHASE_SLOTS, device=dev)
    nxt = torch.empty(CHASE_SLOTS, dtype=torch.int32, device=dev)
    nxt[perm] = perm.roll(-1).to(torch.int32)      # one cycle through all
    del perm
    out = torch.empty(1, dtype=torch.int32, device=dev)
    chase = device_ms(lambda: run(lib.memory_round_trips, nxt.data_ptr(),
                                  CHASE_STEPS, out.data_ptr()),
                      reps=3, warmup=1)
    return device_ms(empty), cuda_ms(empty), chase / CHASE_STEPS


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

class Recorder:
    """Keeps a copy of each kernel binding's first call on the main path
    (treeagg's is its compact form's) and the route of every hintchain
    launch, and the host time spent in the request path's kernel wrappers
    (inputs to the card, launch, results back) and in the index mirror's
    refresh: wall time and the calling thread's CPU time, whose difference
    is the time that thread waited (for the GIL or for the card), and the
    dirty slots each refresh of the hash index sends."""

    def __init__(self):
        from repro_torch.core.columnar import ColumnarTable, HashIndex
        from repro_torch.kernels.hintchain import kernel as hk, ops as ho
        from repro_torch.kernels.phash import kernel as pk, ops as po
        from repro_torch.kernels.pkval import kernel as vk, ops as vo
        from repro_torch.kernels.treeagg import kernel as tk, ops as to
        self.calls = {}
        self.host_s = {}
        self.hint_routes = []
        self.hint_slots = []              # (client, fallback) a launch
        self.big_waves = (0, 0.0)
        self.dirty = (0, 0, 0)            # refreshes, slots sent, most
        self._hk = hk
        self._orig = []
        for mod, name in ((pk, "phash"), (pk, "phash_chain"),
                          (vk, "pkval"), (hk, "hintchain"),
                          (tk, "treeagg_compact")):
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
            if name not in self.calls:        # an output buffer is not input
                self.calls[name] = (tuple(a.clone() if torch.is_tensor(a)
                                          else a for a in args),
                                    {k: v for k, v in kw.items()
                                     if k != "out"})
            res = real(*args, **kw)
            if name == "hintchain":
                self.hint_routes.append(self._hk.LAST_ROUTE)
                self.hint_slots.append((args[0].numel(), args[3].numel()))
            return res
        return rec

    def _time(self, name, real):
        def timed(*args, **kw):
            if name == "device_arrays":       # slots the refresh will send
                n, s, m = self.dirty
                k = len(args[0]._dirty) if args[0]._mirror is not None else 0
                self.dirty = (n + 1, s + k, max(m, k))
            t0, c0 = time.perf_counter(), time.thread_time()
            res = None
            try:
                res = real(*args, **kw)
                return res
            finally:
                dt = time.perf_counter() - t0
                dc = time.thread_time() - c0
                n, s, c = self.host_s.get(name, (0, 0.0, 0.0))
                self.host_s[name] = (n + 1, s + dt, c + dc)
                if name == "treeagg_expand" and res is not None \
                        and len(res[3]) >= BIG_WAVE:
                    n, s = self.big_waves
                    self.big_waves = (n + 1, s + dt)
        return timed

    def restore(self):
        for owner, name, real in self._orig:
            setattr(owner, name, real)


#: phase 3 reports apart the treeagg_expand calls whose wave has at least
#: this many children (the waves that hold /bulk's million files)
BIG_WAVE = 100_000

#: each namenode's subtree pool: waves scanned and chunks committed one at
#: a time.  The wave scans of the thread pool merge their costs into one
#: OpCost from several threads (SubtreeOps._wave_scan, as in the
#: reference), and a thread switch inside that merge loses an update, so
#: two runs of one trace could differ in OpCost.  The sums are what a
#: race-free pool gives.
SUBTREE_PARALLELISM = 1


def build(columnar: bool, bulk: int, dev, n_namenodes: int = 4):
    import repro_torch.core as T
    from repro_torch.core.columnar import ColumnarMetadataStore
    from repro_torch.core.workload import NamespaceSpec, SyntheticNamespace
    cls = ColumnarMetadataStore if columnar else T.MetadataStore
    store = cls(n_datanodes=4, device=dev)
    T.format_fs(store)
    cluster = T.NamenodeCluster(store, n_namenodes)
    for nn in cluster.namenodes:
        nn.subtree.parallelism = SUBTREE_PARALLELISM
    ns = SyntheticNamespace(NamespaceSpec(), n_dirs=127, files_per_dir=16)
    T.materialize_namespace(cluster.namenodes[0], ns)
    if bulk:
        T.materialize_big_dir(cluster.namenodes[0], "/bulk", bulk)
    return store, cluster, ns


def drive(columnar: bool, bulk: int, n_ops: int, dev, on_start=None,
          failover: bool = False):
    """Build, replay the trace, du the namespace, then the client batch;
    returns results.  With ``failover`` (phase 11) the cluster starts with
    FAILOVER_NAMENODES namenodes and the trace replays under the elastic
    pool and the fault plan, recovered by the §7.6 protocol
    (``failover_replay``)."""
    import repro_torch.core as T
    from repro_torch.core.workload import make_spotify_trace
    t0 = time.perf_counter()
    store, cluster, ns = build(columnar, bulk, dev,
                               FAILOVER_NAMENODES if failover else 4)
    t_build = time.perf_counter() - t0
    trace = make_spotify_trace(ns, n_ops, seed=5)
    client = T.DFSClient(cluster)
    # keep the planned pipeline the replay builds, to read its plan report,
    # and the wall time of its run
    pipes, spans = [], []
    real_run = T.PlannedRequestPipeline.run

    def run(self, wops):
        pipes.append(self)
        t = time.perf_counter()
        try:
            return real_run(self, wops)
        finally:
            spans.append(time.perf_counter() - t)

    T.PlannedRequestPipeline.run = run
    if on_start:
        on_start()
    t1 = time.perf_counter()
    extra = {}
    try:
        if failover:
            stats, extra = failover_replay(client, trace)
        else:
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
    return dict(store=store, cluster=cluster, stats=stats, runs=runs,
                paths=paths, du=du, counts=counts, t_build=t_build,
                t_trace=t_trace, t_pipeline=spans[0], t_du=t_du,
                t_batch=t_batch, **extra)


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


def _first_diff(a, b) -> int:
    """Index of the first element where sequences a and b differ (the
    shorter one's length when one is a prefix of the other)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def replay_differences(a, b) -> list:
    """What differs between two results of ``drive``: the first table and
    row of ``dump_state`` that differ, the first op whose outcome differs
    (both outcomes), the du's and the batch's results, and every key of
    the counts and of the OpCost that differs.  Empty when they agree."""
    out = []
    sa, sb = a["store"].dump_state(), b["store"].dump_state()
    for name in sorted(set(sa) | set(sb)):
        ra, rb = sa.get(name, []), sb.get(name, [])
        if ra != rb:
            i = _first_diff(ra, rb)
            out.append(f"dump_state table {name!r} ({len(ra)} vs {len(rb)} "
                       f"rows) first differs at row {i}: "
                       f"{ra[i] if i < len(ra) else None!r} vs "
                       f"{rb[i] if i < len(rb) else None!r}")
            break
    (oa, da, ba), (ob, db, bb) = outcomes(a), outcomes(b)
    if oa != ob:
        i = _first_diff(oa, ob)
        out.append(f"op {i} of {len(oa)} vs {len(ob)} first differs: "
                   f"{oa[i] if i < len(oa) else None!r} vs "
                   f"{ob[i] if i < len(ob) else None!r}")
    if da != db:
        out.append(f"du: {da!r} vs {db!r}")
    if ba != bb:
        i = _first_diff(ba, bb)
        out.append(f"batch run {i} differs")
    for what, ka, kb in (("counts", a["counts"], b["counts"]),
                         ("OpCost", _total_cost(a), _total_cost(b))):
        keys = sorted(k for k in set(ka) | set(kb) if ka.get(k) != kb.get(k))
        if keys:
            out.append(f"{what}: " + ", ".join(
                f"{k} {ka.get(k)} vs {kb.get(k)}" for k in keys))
    return out


def _total_cost(r) -> dict:
    """The replay's OpCost: the pipeline's, or a chaos report's outcomes'."""
    st = r["stats"]
    cost = st.total_cost if hasattr(st, "total_cost") else st.outcome_cost
    return cost.as_dict()


def canonical_state(store, skip=("id_seq",)):
    """Every table's rows but ``skip``'s (``id_seq``, the id allocators'
    positions, by default) with inode ids replaced by paths, block ids by
    (file path, block index), and the namenodes' own atime/mtime clocks
    left out: what two runs must share when the same ops ran on other
    namenodes, which draw other ids and stamp other times.  An id whose
    inode is gone (the lease rows that deleted files leave behind) becomes
    "no inode": such rows are compared by their number only."""
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
        if name in skip:
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


# ---------------------------------------------------------------------------
# phase 11: failover at deployment size
# ---------------------------------------------------------------------------

#: phase 11's cluster starts with this many namenodes, under an elastic pool
#: of 2 to 4 alive.  A tick of the pool (one a planner window) reads the
#: load as (ops served since the last tick + ops still queued) / namenodes
#: alive: 10,000 after the first of the trace's 20 windows, under 1,500
#: from the 18th, so the pool scales out in the first windows (again after
#: the crashes) and back in at the end
FAILOVER_NAMENODES = 2
FAILOVER_POOL = dict(min_namenodes=2, max_namenodes=4, high_load=4000.0,
                     low_load=1500.0, hysteresis=1, cooldown=1)
#: phase 11's faults, fired in the replay: (site, at, victim, kind,
#: heal_after, delay_ticks); ``at`` counts a site's firings from 0 over all
#: namenodes.  Namenode 0, the leader, crashes at the last batch exchange
#: of the window after the first scale-out (exchange 33; the pool scales
#: out after exchange 16); namenode 1 is cut off from the client for two
#: exchanges from the last of the next window (51); the first joiner,
#: namenode 2, limps for two exchanges from exchange 80 (2 ticks each); and
#: a namenode dies between two chunk commits of a subtree delete (before
#: chunk commit 32).  A batch refused or orphaned by a death is re-dealt
#: only at its window's end, after the window's later batches (the
#: reference's planner does this too: ROADMAP queue 3), so each fault
#: strikes where no later op of its window reads what it would change:
#: the run must end where the fault-free phase 3 ends.  The exchange
#: counts do not depend on --bulk (the trace never touches /bulk)
FAILOVER_PLAN = (
    ("batch_exchange", 33, 0, "crash", 3, 2),
    ("batch_exchange", 51, 1, "partition", 1, 2),
    ("batch_exchange", 80, 2, "delay", 2, 2),
    ("subtree_chunk", 32, None, "crash", 3, 2),
)
#: tables the phase-3 comparison leaves out beside ``id_seq``: the
#: election's heartbeat rows, one per namenode alive or crashed, differ
#: with the membership by design
FAILOVER_SKIP = ("id_seq", "leader")


def failover_replay(client, trace):
    """Phase 11's replay: an ElasticNamenodePool attached to ``client``
    (``DFSClient.attach_pool``), FAILOVER_PLAN's injector, and the trace
    through ``replay_with_recovery(planned=True)``, the §7.6 protocol, with
    the planned pipeline ``DFSClient.run_trace`` builds (batches of 64,
    windows of 1,024, the client's hint cache, the pool ticked once a
    window).  Joiners run their subtree pools at SUBTREE_PARALLELISM as
    the founders do.  Returns the ChaosReport and the pool, the injector
    and, for each scale event, the batch exchanges fired before it."""
    import repro_torch.core as T
    import repro_torch.core.batch_planner as bp
    cluster = client.cluster
    pool = T.ElasticNamenodePool(cluster, **FAILOVER_POOL)
    client.attach_pool(pool)
    inj = T.FaultInjector(T.ChaosPlan(tuple(
        T.Fault(T.FaultSite(site), at=at, victim=victim, kind=kind,
                heal_after=heal, delay_ticks=ticks)
        for site, at, victim, kind, heal, ticks in FAILOVER_PLAN)), cluster)
    scale_at = []

    def on_scale(ev):
        for nn in cluster.namenodes:
            nn.subtree.parallelism = SUBTREE_PARALLELISM
        scale_at.append((ev.action, ev.nn_id,
                         inj.counts[T.FaultSite.BATCH_EXCHANGE]))

    pool.subscribe(on_scale)
    real = bp.PlannedRequestPipeline

    class Planned(real):
        def __init__(self, cluster, batch_size):
            super().__init__(cluster, batch_size=batch_size, window=1024,
                             adaptive=False, client_cache=client.hint_cache,
                             pool=client.pool)

    bp.PlannedRequestPipeline = Planned
    try:
        rep = T.replay_with_recovery(cluster, trace, injector=inj,
                                     batch_size=64, planned=True)
    finally:
        bp.PlannedRequestPipeline = real
    return rep, dict(pool=pool, injector=inj, scale_at=scale_at)


def quiesce(cluster) -> None:
    """The leader's housekeeping once every lease has outlived its limit:
    heartbeat rounds past ``lease_limit``, the lease-recovery sweep and the
    lease-path scrub.  Phase 11 holds its final state against phase 3's,
    both brought to this point: the trace's one lease holder renews at
    every write, on a clock the pool and the DELAY fault move and phase 3
    never does."""
    limit = cluster.alive_namenodes()[0].ops.lease_limit
    for _ in range(limit + 1):
        cluster.tick()
    cluster.recover_leases()
    cluster.scrub_leases()


def chaos_report(rep) -> dict:
    """A ChaosReport as plain data."""
    return {"outcomes": [(o.ok, o.error, o.batched,
                          None if o.result is None else o.result.value,
                          None if o.result is None
                          else o.result.cost.as_dict())
                         for o in rep.outcomes],
            "ok": rep.ok, "failed": rep.failed,
            "recovery_rounds": rep.recovery_rounds,
            "retried_ops": rep.retried_ops,
            "events": [(e.site.value, e.occurrence, e.nn_id, e.kind,
                        e.action) for e in rep.events],
            "outcome_cost": rep.outcome_cost.as_dict(),
            "housekeeping_cost": rep.housekeeping_cost.as_dict(),
            "per_nn_delta": {k: v.as_dict()
                             for k, v in rep.per_nn_delta.items()}}


def failover_differences(a, b) -> list:
    """``replay_differences`` of two phase-11 runs, and every field of their
    chaos reports, pool events and samples, and scale points that
    differs."""
    out = replay_differences(a, b)
    ra, rb = chaos_report(a["stats"]), chaos_report(b["stats"])
    out += [f"ChaosReport {k} differs" for k in ra if ra[k] != rb[k]]
    for what, fn in (("pool events", lambda r: [
            (e.t, e.action, e.nn_id, e.reason, e.migrated_entries)
            for e in r["pool"].events]),
            ("pool samples", lambda r: [
                (s.t, s.alive, s.ops_delta, s.queue_depth, s.load)
                for s in r["pool"].samples]),
            ("scale points", lambda r: r["scale_at"])):
        if fn(a) != fn(b):
            out.append(f"{what}: {fn(a)!r} vs {fn(b)!r}")
    return out


def kernel_pairs() -> dict:
    """Each metadata kernel's binding, its plain version, its work count and
    the binding the Recorder keeps its first call under."""
    from repro_torch.kernels.hintchain import kernel as hk, ref as hr
    from repro_torch.kernels.phash import kernel as pk, ref as pr
    from repro_torch.kernels.pkval import kernel as vk, ref as vr
    from repro_torch.kernels.treeagg import kernel as tk, ref as tr
    return {"phash": (pk.phash, pr.phash_ref, work_phash, "phash"),
            "phash_chain": (pk.phash_chain, pr.phash_chain_ref,
                            work_phash_chain, "phash_chain"),
            "pkval": (vk.pkval, vr.pkval_ref, work_pkval, "pkval"),
            "hintchain": (hk.hintchain, hr.hintchain_ref, work_hintchain,
                          "hintchain"),
            "treeagg": (tk.treeagg_compact, tr.treeagg_expand_ref,
                        work_treeagg, "treeagg_compact")}


def first_call(name, kern, plain, args, kw):
    """The kernel and its plain version on a recorded call's inputs, in the
    plain version's form; raises unless bit-equal."""
    from repro_torch.kernels.treeagg import kernel as tk
    got, want = kern(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if name == "treeagg":
        got = tk.unpack(got, args[0].numel(), args[2].numel())
        want = tuple(t.cpu() for t in want)
    if not same(got, want):
        raise AssertionError(f"{name}: kernel != plain on main path")
    return got, want


def phase_failover(args, dev, phase3) -> None:
    """Phase 11 (module docstring); ``phase3`` holds phase 3's outcomes and
    its quiesced canonical state."""
    import repro_torch.core as T
    from repro_torch.core.cluster_sim import profile_ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder()
    try:
        card = drive(True, args.bulk, args.ops, dev,
                     on_start=reset_launch_counts, failover=True)
        launches = launch_counts()
    finally:
        rec.restore()
    rep, pool, inj = card["stats"], card["pool"], card["injector"]
    peak = torch.cuda.max_memory_allocated()
    log(f"phase11 store: inodes={card['store'].table('inode').n_rows} "
        f"namenodes {FAILOVER_NAMENODES} -> {len(card['cluster'].namenodes)}"
        f" (alive {len(card['cluster'].alive_namenodes())}); "
        f"build_s={card['t_build']:.3f} "
        f"replay_s={card['t_pipeline']:.3f} "
        f"recovery_s={card['t_trace'] - card['t_pipeline']:.3f} "
        f"du_s={card['t_du']:.3f} batch_s={card['t_batch']:.3f}")
    log(f"phase11 report: ops={len(rep.outcomes)} ok={rep.ok} "
        f"failed={rep.failed} recovery_rounds={rep.recovery_rounds} "
        f"retried_ops={rep.retried_ops} "
        f"outcome_round_trips={rep.outcome_cost.round_trips} "
        f"housekeeping_round_trips={rep.housekeeping_cost.round_trips}")
    log("phase11 scale events: " + "; ".join(
        f"t={e.t} {e.action} nn{e.nn_id} ({e.reason}) "
        f"migrated={e.migrated_entries}" for e in pool.events)
        + " | batch exchanges before each: " + json.dumps(card["scale_at"]))
    log("phase11 fault events: " + "; ".join(
        f"{e.site.value}#{e.occurrence} nn{e.nn_id} {e.kind} {e.action}"
        for e in inj.events))
    log(f"phase11 counts: {json.dumps(card['counts'])}")
    log(f"phase11 launches: {json.dumps(launches)} "
        f"peak_device_bytes={peak}")
    # every planned fault fired, the leader's crash after the first
    # scale-out, and the pool moved both ways
    if inj.pending:
        raise AssertionError(f"faults never fired: {inj.pending}")
    outs = [k for k in pool.events if k.action == "scale_out"]
    if not outs or pool.scale_ins < 1:
        raise AssertionError(f"pool: {pool.scale_outs} scale-outs, "
                             f"{pool.scale_ins} scale-ins")
    crash0 = next(e for e in inj.events
                  if e.action == "killed" and e.nn_id == 0)
    if crash0.occurrence < card["scale_at"][0][2]:
        raise AssertionError("namenode 0 crashed before the first scale-out")
    # 1. each kernel launched, its first call bit-equal to its plain version
    missing = [k for k in REPLACES if launches[k] < 1]
    if missing:
        raise AssertionError(f"failover path never launched {missing}")
    for name, (kern, plain, _, binding) in kernel_pairs().items():
        first_call(name, kern, plain, *rec.calls[binding])
    rec.calls.clear()
    log("phase11 kernels: " + ", ".join(
        f"{k} {launches[k]} launches" for k in REPLACES)
        + "; each first call bit-equal to its plain version")
    # 3. recovery invariants: no orphan lease, UC or block rows, no stale
    # subtree lock, every lock released
    T.RecoveryInvariants(card["store"], card["cluster"]).assert_all()
    log("phase11 RecoveryInvariants: 0 orphan lease, lease_path, "
        "under-construction and block rows, 0 subtree locks, LockManager "
        "released")
    # 2. the same build, plan and trace on the host, byte-equal
    host = drive(True, args.bulk, args.ops, torch.device("cpu"),
                 failover=True)
    differ = failover_differences(card, host)
    if differ:
        raise AssertionError("phase 11 card run (first) != host run "
                             "(second): " + "; ".join(differ))
    log(f"phase11 host: state, {len(rep.outcomes)} outcomes, du, batch, "
        f"ChaosReport, pool events, counts equal; "
        f"host replay_s={host['t_pipeline']:.3f} "
        f"recovery_s={host['t_trace'] - host['t_pipeline']:.3f}")
    del host
    # 4. the fault-free run: the same outcomes and, quiesced, the same
    # tables up to ids and clocks
    ops, du, stats = outcomes(card, physical=False)
    wrong = [i for i, (x, y) in enumerate(zip(ops, phase3["ops"])) if x != y]
    if wrong or (du, stats) != phase3["rest"]:
        raise AssertionError(f"outcomes differ from phase 3's at ops "
                             f"{wrong[:20]} ({len(wrong)} in all)")
    quiesce(card["cluster"])
    canon = canonical_state(card["store"], skip=FAILOVER_SKIP)
    differ = [k for k in sorted(set(canon) | set(phase3["canon"]))
              if canon.get(k) != phase3["canon"].get(k)]
    if differ:
        raise AssertionError(f"quiesced tables {differ} != phase 3's")
    log(f"phase11 fault-free: outcomes equal phase 3's ({rep.failed} "
        f"failed in both, 0 beyond), du and batch equal; quiesced, "
        f"{len(canon)} tables ({sum(map(len, canon.values()))} rows) "
        f"equal phase 3's up to ids and clocks")
    del card, canon
    # 5. the DES's profiles, measured on the card and on the host
    cp, hp = profile_ops(device=dev), profile_ops(device="cpu")
    if cp != hp:
        raise AssertionError("profile_ops on the card != on the host")
    log(f"phase11 profile_ops: {len(cp)} profiles equal on card and host")


# ---------------------------------------------------------------------------
# phases 5 to 7: the model stack's float kernels and the zamba2 path
# ---------------------------------------------------------------------------

#: each model kernel's source on the main paths (bf16: flash and gmm on the
#: tensor cores, their fp32 SIMT versions in model_kernels.cu; the scans'
#: tensor-core and fp32 SIMT kernels share a file each)
MODEL_SOURCE = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_tc.cu",
    "ssd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "wkv6": "src/repro_torch/kernels/csrc/wkv_scan.cu",
    "gmm": "src/repro_torch/kernels/csrc/gmm_tc.cu",
}
MODEL_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
    "ssd": "src/repro/kernels/mamba2_ssd/kernel.py:76",
    "wkv6": "src/repro/kernels/rwkv6_scan/kernel.py:79",
    "gmm": "src/repro/kernels/moe_gmm/kernel.py:50",
}
#: H100 SXM data sheet, dense: bf16 on the tensor cores, fp32 on the CUDA
#: cores (the rate of each input type)
FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: the kernels whose bf16 path runs on the tensor cores: their rows give
#: the achieved TFLOP/s and its share of the bf16 peak (gmm and the scans
#: also their route, the scans their segments and state scratch)
TENSOR_CORE_KERNELS = ("flash_attention", "gmm", "ssd", "wkv6")
#: the route each scan must take by dtype: the tensor cores for bf16, no
#: fallback
SCAN_ROUTES = {torch.bfloat16: "tc", torch.float32: "simt"}
#: kernel vs plain version: tests/test_kernels.py's tolerances (flash atol
#: 2e-5 fp32 / 2e-2 bf16 with rtol 1e-2; the SSD scan four times those
#: with rtol 2e-2)
FLASH_TOL = {torch.float32: (2e-5, 1e-2), torch.bfloat16: (2e-2, 1e-2)}
SSD_TOL = {torch.float32: (8e-5, 2e-2), torch.bfloat16: (8e-2, 2e-2)}
#: the WKV scan: tests/test_kernels.py's four times (2e-5, 2e-2) with rtol
#: 2e-2; gmm: (2e-5, 2e-2) times the plain output's RMS with rtol 2e-2
#: (tests/test_kernels.py scales by sqrt(D), the RMS of its products of
#: unit normals; a model's weights are scaled by 1/sqrt(fan_in), and its
#: products' RMS is about 1 whatever D)
WKV_TOL = SSD_TOL
GMM_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: model phase and host check: bf16 rounds at other places on the two
#: paths (kernels vs plain, card vs host), and random weights amplify a
#: rounding; so a bf16 result must be no further from the plain bf16
#: result than that is from the plain fp32 result, times NOISE_FACTOR,
#: plus NOISE_FLOOR (relative L2 over the whole tensor)
NOISE_FACTOR = 1.5
NOISE_FLOOR = 1e-3
#: sizes: the synthetic kernel phase's sequence and ragged lengths; the
#: model phase's scoring (B, S), prefill (B, S, cache slots) and serving
#: prompts; the host check's depth and (B, S)
SYNTH_S, RAGGED_S = 4096, 1000
SCORE_BS = (2, 4096)
PREFILL_BSC = (4, 1024, 2048)
SERVE_PROMPTS = (8, 24, 40, 64)
HOST_LAYERS, HOST_BS = 6, (1, 512)
#: phases 8 to 10: the WKV scan at rwkv6_3b's heads (B, H, hd; S is
#: SYNTH_S); gmm at qwen3-moe's expert shape (E=128, capacity
#: C = ceil(8192 tokens x top-8 / 128 x 1.25) = 640 for B=2, S=4096,
#: D=2048, F=768) and a ragged one; the rwkv6 host check's depth
WKV_BHD = (2, 40, 64)
GMM_QWEN3 = (128, 640, 2048, 768)
GMM_RAGGED = (8, 600, 1000, 700)
RWKV_HOST_LAYERS = 4


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float().to(a.device)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def within_noise(name: str, got, plain, plain_fp32) -> str:
    """Hold ``got`` against ``plain`` by the noise rule above; returns the
    line to log."""
    err, noise = rel_l2(got, plain), rel_l2(plain, plain_fp32)
    ok = bool(torch.isfinite(got.float()).all()) \
        and err <= NOISE_FACTOR * noise + NOISE_FLOOR
    mae = float((got.float() - plain.float().to(got.device)).abs().max())
    line = (f"{name}: rel_l2={err:.6f} max_abs={mae:.6f} "
            f"noise(bf16 vs fp32 plain)={noise:.6f}")
    if not ok:
        raise AssertionError(f"{line}: above {NOISE_FACTOR} x noise + "
                             f"{NOISE_FLOOR}")
    return line


def fbound(bytes_: int, flops: int, dtype) -> tuple:
    """(bound_ms, bound_by, bytes, operations) of one float kernel call."""
    tb = bytes_ / BYTES_PER_S * 1e3
    tf = flops / FLOPS_PER_S[dtype] * 1e3
    return (tb, "bytes", bytes_, flops) if tb >= tf \
        else (tf, "operations", bytes_, flops)


def work_flash(q, k, v, causal=True, window=None, softcap=None):
    """q, k, v read once and the output written once; 4 hd operations
    (q.k and p.v) per visible (query, key) pair: causal rows see their
    position + 1 keys, a window caps that."""
    B, S, H, hd = q.shape
    vis = torch.arange(1, S + 1) if causal else torch.full((S,), S)
    if window is not None:
        vis = vis.clamp(max=window)
    pairs = B * H * int(vis.sum())
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return fbound(n_bytes, 4 * hd * pairs, q.dtype)


def work_ssd(x, dt, A, Bc, Cc, h0=None, chunk=128):
    """Inputs read once, y and h written once.  Operations per chunk of L
    steps: C.B^T on and below the diagonal once per batch row (B and C are
    shared across heads), then per head the decay matrix (3 per entry),
    M @ x, (C e^cum) @ h^T, the state update and its decay."""
    B, S, H, hd = x.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    flops = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        tri = L * (L + 1) // 2
        flops += B * 2 * N * tri
        flops += B * H * (3 * tri + 2 * hd * tri + 4 * L * N * hd
                          + 2 * hd * N)
    e = x.element_size()
    n_bytes = (2 * x.numel() * e + (Bc.numel() + Cc.numel()) * e
               + 4 * (dt.numel() + A.numel()) + 4 * B * H * hd * N
               * (2 if h0 is not None else 1))
    return fbound(n_bytes, flops, x.dtype)


def work_wkv(r, k, v, w, u, s0=None, chunk=32):
    """Inputs read once, y and S written once.  Operations per chunk of L
    steps and (batch row, head): the clamped log decay and its sums (5 per
    element), each kept pair's exponent, product and sum over the channels
    (5 per channel), the bonus (3 per channel and step), att @ v on and
    below the diagonal, the decayed r and k (5 per element), r @ S, and the
    state update with its decay."""
    B, S, H, hd = r.shape
    Q = min(chunk, S)
    flops = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        pairs = L * (L - 1) // 2
        flops += B * H * (5 * L * hd + 5 * hd * pairs + 3 * L * hd
                          + 2 * hd * (pairs + L) + 5 * L * hd
                          + 4 * L * hd * hd + 3 * hd * hd)
    e = r.element_size()
    n_bytes = (4 * r.numel() * e + 4 * (w.numel() + u.numel())
               + 4 * B * H * hd * hd
               + (s0.numel() * s0.element_size() if s0 is not None else 0))
    return fbound(n_bytes, flops, r.dtype)


def work_gmm(x, w):
    """x and w read once, y written once; 2 D operations per output."""
    E, C, D = x.shape
    F = w.shape[2]
    n_bytes = x.element_size() * (x.numel() + w.numel() + E * C * F)
    return fbound(n_bytes, 2 * E * C * D * F, x.dtype)


def sdpa_fn(q, k, v, window=None, softcap=None):
    """One ``scaled_dot_product_attention`` call computing the same
    function (a boolean mask for the window, GQA by ``enable_gqa``), or
    None where it has no softcap."""
    if softcap:
        return None
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def rms(t: torch.Tensor) -> float:
    return float(t.float().pow(2).mean().sqrt())


def gmm_tol(args, want):
    """gmm's (atol, rtol) against one block of its plain output."""
    return GMM_ATOL[args[0].dtype] * rms(want), 2e-2


#: gmm's plain version is checked over blocks of experts of at most
#: about this many elements of input or output: each expert's product is
#: independent, and the whole fp32 product and comparison of qwen3-moe's
#: dense route do not fit beside the model (phase 12)
GMM_CHECK_ELEMENTS = 1 << 26


def whole(args):
    return [(slice(None), args)]


def expert_blocks(args):
    """gmm's arguments in blocks of experts (GMM_CHECK_ELEMENTS), each with
    the rows of the output it gives."""
    x, w = args
    per_expert = max(1, x[0].numel(), x.shape[1] * w.shape[-1])
    step = max(1, GMM_CHECK_ELEMENTS // per_expert)
    return [(slice(e0, e0 + step), (x[e0:e0 + step], w[e0:e0 + step]))
            for e0 in range(0, x.shape[0], step)]


def model_kernels() -> dict:
    """name -> (binding module, its attribute, plain version, work
    counter, tolerance (atol, rtol) of a call's arguments and the plain
    output it is held to, the library call of those arguments or None,
    the arguments' blocks whose plain outputs are computed and compared
    one at a time)."""
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.mamba2_ssd import kernel as sk, ref as sr
    from repro_torch.kernels.moe_gmm import kernel as gk, ref as gr
    from repro_torch.kernels.rwkv6_scan import kernel as wk, ref as wr
    return {
        "flash_attention": (
            fk, "flash_attention_fwd", fr.attention_ref, work_flash,
            lambda a, want: FLASH_TOL[a[0].dtype],
            lambda a, kw: sdpa_fn(*a, window=kw.get("window"),
                                  softcap=kw.get("softcap")), whole),
        "ssd": (sk, "ssd_fwd", sr.ssd_ref, work_ssd,
                lambda a, want: SSD_TOL[a[0].dtype], lambda a, kw: None,
                whole),
        "wkv6": (wk, "wkv6_fwd", wr.wkv6_ref, work_wkv,
                 lambda a, want: WKV_TOL[a[0].dtype], lambda a, kw: None,
                 whole),
        "gmm": (gk, "gmm", gr.gmm_ref, work_gmm, gmm_tol,
                lambda a, kw: (lambda: torch.bmm(a[0], a[1])),
                expert_blocks),
    }


def plain_pairs(blocks, got, plain, args, kw):
    """(kernel output, plain output) of one launch, one block of the
    arguments at a time."""
    gots = got if isinstance(got, tuple) else (got,)
    for rows, part in blocks(args):
        want = plain(*part, **kw)
        wants = want if isinstance(want, tuple) else (want,)
        yield from zip((g[rows] for g in gots), wants)


def check_pairs(name, tol_of, pairs, args, what) -> tuple:
    """Holds each pair within tolerance; returns (largest error, largest
    atol, rtol)."""
    err = atol_max = 0.0
    for g, w in pairs:
        atol, rtol = tol_of(args, w)
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol,
                                   msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g.float() - w.float()).abs().max()))
        atol_max = max(atol_max, atol)
    return err, atol_max, rtol


def model_kernel_row(name, args, kw, tag, reps=10):
    """Kernel vs plain version on one input set: checked within tolerance,
    timed; returns the row's numbers."""
    mod, attr, plain, work, tol_of, lib_of, blocks = model_kernels()[name]
    kern = getattr(mod, attr)
    lib = lib_of(args, kw)
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    err, *tol = check_pairs(name, tol_of, plain_pairs(
        blocks, got, plain, args, kw), args, tag)
    del got
    ms = device_ms(lambda: kern(*args, **kw), reps=reps, warmup=1)
    call_ms = cuda_ms(lambda: kern(*args, **kw), reps=reps, warmup=1)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
    lib_ms = None if lib is None else device_ms(lib, reps=reps, warmup=1)
    b_ms, b_by, n_bytes, n_ops = work(*args, **kw)
    shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
    opts = {k: tuple(v.shape) if torch.is_tensor(v) else v
            for k, v in kw.items() if v is not None}
    rate = ""
    if name in TENSOR_CORE_KERNELS:
        tflops = n_ops / ms / 1e9
        rate = (f" tflops={tflops:.1f} share_of_bf16_peak="
                f"{tflops * 1e12 / FLOPS_PER_S[torch.bfloat16]:.4f}")
        if name != "flash_attention":
            rate += f" route={mod.LAST_ROUTE}"
        if name in ("ssd", "wkv6"):
            rate += f" plan={json.dumps(mod.LAST_PLAN)}"
    log(f"{tag} {name} {str(args[0].dtype)[6:]} {opts} "
        f"shapes={shapes}: max_abs_err={err:.3g} (atol {tol[0]:.3g}, rtol "
        f"{tol[1]}) ms={ms:.6f} call_ms={call_ms:.6f} "
        f"plain_ms={plain_ms:.6f} library_ms="
        f"{'null' if lib_ms is None else f'{lib_ms:.6f}'} "
        f"bound_ms={b_ms:.6f} ({b_by}; bytes={n_bytes} ops={n_ops}){rate}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def kernel_row(name, rec, launches, tag, path):
    """The JSON line's row of a kernel on one path: its launches there,
    and the numbers of its first call there replayed."""
    args, kw = rec.calls[name]
    nums = model_kernel_row(name, args, kw, tag)
    return {"name": name, "route": "cuda", "source": MODEL_SOURCE[name],
            "replaces": MODEL_REPLACES[name], "path": path,
            "launches": launches[name], **nums}


def phase_model_kernels(seed: int, dev) -> None:
    """Phase 5: both model kernels against their plain versions at the
    synthetic sizes."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        q = randn(1, SYNTH_S, 32, 128, dtype=dtype)
        k, v = randn(1, SYNTH_S, 8, 128, dtype=dtype), \
            randn(1, SYNTH_S, 8, 128, dtype=dtype)
        for window in (None, 1024):
            for softcap in (None, 50.0):
                model_kernel_row("flash_attention", (q, k, v),
                                 dict(causal=True, window=window,
                                      softcap=softcap), "phase5")
        zq, zk, zv = (randn(1, SYNTH_S, 32, 80, dtype=dtype)
                      for _ in range(3))
        model_kernel_row("flash_attention", (zq, zk, zv),
                         dict(causal=True, window=None, softcap=None),
                         "phase5")
        rq, rk, rv = (randn(1, RAGGED_S, 32, 80, dtype=dtype)
                      for _ in range(3))
        model_kernel_row("flash_attention", (rq, rk, rv),
                         dict(causal=True, window=None, softcap=None),
                         "phase5 ragged")
        del q, k, v, zq, zk, zv, rq, rk, rv
        if dtype == torch.bfloat16:
            # two more of the tensor-core kernel's head dims beside
            # hd=128 and 80 (hd=256: its 32-key tiles)
            for hd in (64, 256):
                q = randn(1, SYNTH_S, 32, hd, dtype=dtype)
                k, v = (randn(1, SYNTH_S, 8, hd, dtype=dtype)
                        for _ in range(2))
                model_kernel_row("flash_attention", (q, k, v),
                                 dict(causal=True, window=None,
                                      softcap=None), "phase5")
                del q, k, v
        B, S, H, hd, N = 2, SYNTH_S, 80, 64, 64
        x = randn(B, S, H, hd, dtype=dtype)
        dt = torch.nn.functional.softplus(randn(B, S, H))
        A = -torch.exp(randn(H) * 0.3)
        Bc, Cc = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        h0 = randn(B, H, hd, N)
        for h in (None, h0):
            model_kernel_row("ssd", (x, dt, A, Bc, Cc),
                             dict(h0=h, chunk=128), "phase5")
        cut = tuple(t[:, :RAGGED_S].contiguous() for t in (x, dt, Bc, Cc))
        model_kernel_row("ssd", cut[:2] + (A,) + cut[2:],
                         dict(h0=h0, chunk=128), "phase5 ragged")
        torch.cuda.empty_cache()


class KernelWatch:
    """Wraps the model kernel bindings: holds each scan launch to its
    route (SCAN_ROUTES), records each launch's route and keyword
    arguments, and either keeps a copy of each kernel's first call or,
    with ``check``, holds every launch against the plain version on the
    same inputs (FLASH_TOL, SSD_TOL, WKV_TOL, GMM_ATOL) and keeps the
    largest error of each kernel."""

    def __init__(self, check: bool = False):
        self.calls, self.checked = {}, {}
        #: per kernel, each launch's route (where the binding records one)
        #: and its keyword arguments other than tensors
        self.routes, self.kws = {}, {}
        self._orig = []
        for name, (mod, attr, plain, _, tol_of, _, blocks) in \
                model_kernels().items():
            real = getattr(mod, attr)
            self._orig.append((mod, attr, real))
            setattr(mod, attr, self._wrap(name, mod, real, plain if check
                                          else None, tol_of, blocks))

    def _wrap(self, name, mod, real, plain, tol_of, blocks):
        def watched(*args, **kw):
            if plain is None and name not in self.calls:
                self.calls[name] = (tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args),
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in kw.items()})
            got = real(*args, **kw)
            self.kws.setdefault(name, []).append(
                {k: v for k, v in kw.items() if not torch.is_tensor(v)})
            if hasattr(mod, "LAST_ROUTE"):
                self.routes.setdefault(name, []).append(mod.LAST_ROUTE)
            if name in ("ssd", "wkv6") \
                    and mod.LAST_ROUTE != SCAN_ROUTES[args[0].dtype]:
                raise AssertionError(f"{name}: route {mod.LAST_ROUTE}")
            if plain is not None:
                n, err = self.checked.get(name, (0, 0.0))
                e, _, _ = check_pairs(name, tol_of, plain_pairs(
                    blocks, got, plain, args, kw), args, f"launch {n}")
                self.checked[name] = (n + 1, max(err, e))
            return got
        return watched

    def restore(self):
        for mod, attr, real in self._orig:
            setattr(mod, attr, real)


def checked_run(fn) -> str:
    """Runs ``fn`` with every model kernel launch held against its plain
    version; returns the line to log."""
    watch = KernelWatch(check=True)
    try:
        fn()
    finally:
        watch.restore()
    return "every launch within tolerance of its plain version: " + \
        ", ".join(f"{k} {n} launches max_abs_err={e:.4g}"
                  for k, (n, e) in watch.checked.items())


def model_params(cfg, seed: int, dev):
    from repro_torch.models import init_params, param_specs
    return init_params(param_specs(cfg),
                       torch.Generator(device=dev).manual_seed(seed),
                       device=dev)


def engine_cache(cfg, B: int, S_max: int, dev):
    """Zeros in the serving engine's cache dtypes (bf16 at rank >= 3)."""
    from repro_torch.models import init_cache_specs
    from repro_torch.models.params import tree_map
    return tree_map(lambda s: torch.zeros(
        s.shape, dtype=torch.bfloat16 if len(s.shape) >= 3
        else torch.float32, device=dev), init_cache_specs(cfg, B, S_max))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_launches(what: str, want: dict) -> dict:
    """Every kernel's launches since the last reset, held to ``want``
    (none for a kernel it does not name); returns those that launched."""
    from repro_torch.kernels import launch_counts
    return held_launches(what, launch_counts(), want)


def held_launches(what: str, got: dict, want: dict) -> dict:
    """A launch count ``got`` held to ``want``, as ``exact_launches``."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what} launched {got}, want {full}")
    return {k: n for k, n in got.items() if n}


def serve_run(tag: str, cfg, params, prompts, max_new: int, max_batch: int,
              max_seq: int, rng, dev) -> None:
    """``ServeEngine`` on one request a prompt length: each must come back
    with ``max_new`` tokens in the vocabulary; logs the time per decode
    step and the launches (the decode branch runs no kernel)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                      device=dev)
    for i, n in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new=max_new))
    reset_launch_counts()
    done, t_serve = timed(lambda: eng.run(max_iters=64))
    gen = {r.rid: r.generated for r in done}
    if sorted(gen) != list(range(len(prompts))) or any(
            len(g) != max_new or not all(0 <= t < cfg.vocab_size for t in g)
            for g in gen.values()):
        raise AssertionError(f"{tag} serving engine: {gen}")
    steps = sum(prompts) + max_new * -(-len(prompts) // max_batch)
    log(f"{tag} serve: max_batch={max_batch} max_seq={max_seq}, prompts "
        f"{prompts}, max_new={max_new}: wall_s={t_serve:.4f} "
        f"decode_steps={steps} ms_per_decode_step="
        f"{1e3 * t_serve / steps:.3f} launches="
        f"{json.dumps(launch_counts())} tokens={json.dumps(gen)}")


def phase_model(seed: int, dev) -> tuple:
    """Phase 6: the full zamba2_2_7b on the card.  Returns the two kernel
    rows of the JSON line (launches from the scoring forward, the main
    path; times and errors on its own first inputs) and the parameters."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import count_params, forward, param_specs
    cfg = get_config("zamba2_2_7b")
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: model_params(cfg, seed, dev))
    n_apps = cfg.n_layers // cfg.shared_attn_every
    log(f"phase6 zamba2_2_7b: {count_params(param_specs(cfg))} params fp32 "
        f"on the card, {cfg.n_layers} layers, {n_apps} shared-attention "
        f"applications, init_s={t_init:.3f}")
    rng = np.random.default_rng(seed)
    want = {"flash_attention": n_apps, "ssd": cfg.n_layers}

    # 1. scoring forward, B=2, S=4096
    tok = rng.integers(0, cfg.vocab_size, SCORE_BS).astype(np.int32)
    rec = KernelWatch()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (lk, _), t_k = timed(lambda: forward(params, {"tokens": tok}, cfg=cfg,
                                         use_kernels=True, device=dev))
    launches = launch_counts()
    rec.restore()
    peak_k = torch.cuda.max_memory_allocated()
    log(f"phase6 scoring forward B,S={SCORE_BS} use_kernels=True: "
        f"wall_s={t_k:.4f} launches={json.dumps(launches)} "
        f"peak_device_bytes={peak_k}")
    exact_launches("scoring forward", want)
    reset_launch_counts()
    (lp, _), t_p = timed(lambda: forward(params, {"tokens": tok}, cfg=cfg,
                                         use_kernels=False, device=dev))
    (lf, _), t_f = timed(lambda: forward(
        params, {"tokens": tok}, cfg=cfg.derive(dtype="float32"),
        use_kernels=False, device=dev))
    exact_launches("the plain path", {})
    log(f"phase6 plain forward bf16 wall_s={t_p:.4f}, fp32 wall_s="
        f"{t_f:.4f}")
    log("phase6 " + within_noise("scoring logits, kernels vs plain",
                                 lk, lp, lf)
        + f" argmax_agree={float((lk.argmax(-1) == lp.argmax(-1)).float().mean()):.4f}")
    del lk, lp, lf
    log("phase6 scoring forward again, " + checked_run(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev)))

    # the kernels on the main path's own first inputs
    rows = [kernel_row(name, rec, launches, "phase6 main-path",
                       "zamba2_2_7b forward (phase 6)")
            for name in ("flash_attention", "ssd")]
    rec.calls.clear()
    torch.cuda.empty_cache()

    # 2. cache-filling prefill, B=4, S=1024 into a 2048-slot cache
    B, S, slots = PREFILL_BSC
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    reset_launch_counts()
    (lk, ck), t_k = timed(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev,
        cache=engine_cache(cfg, B, slots, dev)))
    got = exact_launches("prefill", want)
    (lp, cp), t_p = timed(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=False, device=dev,
        cache=engine_cache(cfg, B, slots, dev)))
    lf, cf = forward(params, {"tokens": tok}, cfg=cfg.derive(
        dtype="float32"), cache=engine_cache(cfg, B, slots, dev), device=dev)
    log(f"phase6 prefill B={B} S={S} cache {slots}: kernels "
        f"wall_s={t_k:.4f} launches={json.dumps(got)} plain "
        f"wall_s={t_p:.4f}")
    log("phase6 " + within_noise("prefill logits", lk, lp, lf))
    log("phase6 prefill again, " + checked_run(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev,
        cache=engine_cache(cfg, B, slots, dev))))
    for key in ck:
        log("phase6 " + within_noise(
            f"prefill cache {key} {tuple(ck[key].shape)} "
            f"{str(ck[key].dtype)[6:]}", ck[key], cp[key], cf[key]))
    del lk, ck, lp, cp, lf, cf
    torch.cuda.empty_cache()

    # 3. the serving engine
    serve_run("phase6", cfg, params, SERVE_PROMPTS, 16, 4, 256, rng, dev)
    log(f"phase6 peak_device_bytes={torch.cuda.max_memory_allocated()}")
    return rows, params


def phase_host(arch: str, params, n_layers: int, seed: int, dev,
               tag: str, bs: tuple = None) -> None:
    """Phases 7, 10 and 12: full width, the first ``n_layers`` layers (for
    zamba2 6: one shared-attention application), the same parameter
    tensors on the host: the card's kernel path against the host's plain
    path at (B, S) ``bs`` (HOST_BS by default), and the card's engine
    against the host's."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    from repro_torch.models.params import tree_map
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config(arch).derive(n_layers=n_layers)
    p6 = dict(params, layers=tree_map(lambda a: a[:n_layers],
                                      params["layers"]))
    host = tree_map(lambda t: t.cpu(), p6)
    rng = np.random.default_rng(seed + 1)
    bs = bs or HOST_BS
    tok = rng.integers(0, cfg.vocab_size, bs).astype(np.int32)
    card_l, t_c = timed(lambda: forward(p6, {"tokens": tok}, cfg=cfg,
                                        use_kernels=True, device=dev)[0])
    t0 = time.perf_counter()
    host_l, _ = forward(host, {"tokens": tok}, cfg=cfg, device="cpu")
    t_h = time.perf_counter() - t0
    host_f, _ = forward(host, {"tokens": tok}, cfg=cfg.derive(
        dtype="float32"), device="cpu")
    log(f"{tag} {arch} {n_layers} layers B,S={bs}: card (kernels) "
        f"wall_s={t_c:.4f}, host (plain) wall_s={t_h:.4f}")
    log(f"{tag} " + within_noise("logits, card kernels vs host plain",
                                 card_l, host_l, host_f))

    class Recording(ServeEngine):
        """Keeps every decode step's tokens, index and last logits."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps = []

        def _decode_fn(self, params, tokens, cache, index):
            logits, new_cache = forward(
                params, {"tokens": tokens}, cfg=self.cfg, cache=cache,
                cache_index=index, device=self.device)
            self.steps.append((tokens.cpu().numpy(), index,
                               logits[:, -1].float().cpu()))
            return torch.argmax(logits[:, -1], dim=-1), new_cache

    ref = Recording(cfg, host, max_batch=2, max_seq=64, device="cpu")
    for i, n in enumerate((6, 3)):
        ref.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new=4))
    ref.run()
    replays = {}
    for name, c, params_, d in (
            ("card", cfg, p6, dev),
            ("host fp32", cfg.derive(dtype="float32"), host, "cpu")):
        eng = Recording(c, params_, max_batch=2, max_seq=64, device=d)
        for tokens, index, _ in ref.steps:       # fed the host's tokens
            _, eng.cache = eng._decode_fn(eng.params, torch.from_numpy(
                tokens).to(eng.device), eng.cache, index)
        replays[name] = [s[2] for s in eng.steps]
    worst = (0.0, "")
    for i, (_, index, want) in enumerate(ref.steps):
        line = within_noise(f"decode step {i} index {index}",
                            replays["card"][i], want,
                            replays["host fp32"][i])
        err = rel_l2(replays["card"][i], want)
        worst = max(worst, (err, line))
    log(f"{tag} engine: {len(ref.steps)} decode steps, card vs host "
        f"within noise at every step; worst {worst[1]}")


# ---------------------------------------------------------------------------
# phases 8 to 10: the WKV scan and gmm, and the rwkv6 path
# ---------------------------------------------------------------------------

def phase_new_kernels(seed: int, dev) -> dict:
    """Phase 8: gmm's own path first, the experts' SwiGLU FFN of one
    qwen3-moe layer over its capacity buffers (bf16) through
    ``ops.gmm``, the launch counts set to 0 just before and read just
    after, every launch held against the plain version; then both new
    kernels against their plain versions at the synthetic sizes, in bf16
    and fp32.  Returns gmm's row of the JSON line."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.moe_gmm import kernel as gk, ops as gmm_ops
    g = torch.Generator(device=dev).manual_seed(seed + 8)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype)

    E, C, D, F = GMM_QWEN3
    bf16 = torch.bfloat16
    x = randn(E, C, D, dtype=bf16)
    wi, wg = (randn(E, D, F, dtype=bf16, scale=D ** -0.5) for _ in range(2))
    wo = randn(E, F, D, dtype=bf16, scale=F ** -0.5)

    def expert_ffn():
        a, gate = gmm_ops.gmm(x, wi), gmm_ops.gmm(x, wg)
        return gmm_ops.gmm(Fn.silu(gate) * a, wo)

    rec = KernelWatch()
    reset_launch_counts()
    try:
        y, t = timed(expert_ffn)
        launches = launch_counts()
    finally:
        rec.restore()
    routes = rec.routes.get("gmm", [])
    if routes != ["tma"] * 3:
        raise AssertionError(f"expert FFN's gmm routes {routes}: expected "
                             f"TMA")
    exact_launches("expert FFN", {"gmm": 3})
    if y.shape != (E, C, D) or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError("expert FFN: bad output")
    log(f"phase8 qwen3-moe expert FFN E={E} C={C} D={D} F={F} bf16 through "
        f"ops.gmm: wall_s={t:.4f} launches={json.dumps(launches)} "
        f"routes={routes}")
    log("phase8 expert FFN again, " + checked_run(expert_ffn))
    row = kernel_row("gmm", rec, launches, "phase8 main-path",
                     "qwen3-moe expert FFN on capacity buffers (phase 8)")
    rec.calls.clear()
    del x, wi, wg, wo, y
    torch.cuda.empty_cache()

    B, H, hd = WKV_BHD
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v = (randn(B, SYNTH_S, H, hd, dtype=dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, SYNTH_S, H, hd) * 0.5))
        u = randn(H, hd, scale=0.1)
        s0 = randn(B, H, hd, hd)
        for st in (None, s0):
            model_kernel_row("wkv6", (r, k, v, w, u), dict(s0=st, chunk=32),
                             "phase8")
        cut = tuple(t[:, :RAGGED_S].contiguous() for t in (r, k, v, w))
        model_kernel_row("wkv6", cut + (u,), dict(s0=s0, chunk=32),
                         "phase8 ragged")
        model_kernel_row("wkv6", (r, k, v, torch.full_like(w, 1e-45),
                                  torch.ones_like(u)),
                         dict(s0=None, chunk=32), "phase8 strong-decay")
        del r, k, v, w, cut
        for shape, tag, route in ((GMM_QWEN3, "phase8", "tma"),
                                  (GMM_RAGGED, "phase8 ragged", "loads")):
            E, C, D, F = shape
            model_kernel_row("gmm", (randn(E, C, D, dtype=dtype),
                                     randn(E, D, F, dtype=dtype)), {}, tag)
            want = route if dtype == torch.bfloat16 else "simt"
            if gk.LAST_ROUTE != want:
                raise AssertionError(f"gmm {shape} {dtype}: route "
                                     f"{gk.LAST_ROUTE}, expected {want}")
        torch.cuda.empty_cache()
    return row


def phase_rwkv(seed: int, dev) -> tuple:
    """Phase 9: the full rwkv6_3b on the card.  Returns the WKV row of
    the JSON line (launches from the scoring forward, the main path; times
    and errors on its own first inputs) and the parameters."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import count_params, forward, param_specs
    cfg = get_config("rwkv6_3b")
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: model_params(cfg, seed, dev))
    log(f"phase9 rwkv6_3b: {count_params(param_specs(cfg))} params fp32 "
        f"on the card, {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
        f"init_s={t_init:.3f}")
    rng = np.random.default_rng(seed + 9)
    want = {"wkv6": cfg.n_layers}

    # 1. scoring forward, B=2, S=4096
    tok = rng.integers(0, cfg.vocab_size, SCORE_BS).astype(np.int32)
    rec = KernelWatch()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (lk, _), t_k = timed(lambda: forward(params, {"tokens": tok}, cfg=cfg,
                                         use_kernels=True, device=dev))
    launches = launch_counts()
    rec.restore()
    peak_k = torch.cuda.max_memory_allocated()
    log(f"phase9 scoring forward B,S={SCORE_BS} use_kernels=True: "
        f"wall_s={t_k:.4f} launches={json.dumps(launches)} "
        f"peak_device_bytes={peak_k}")
    exact_launches("scoring forward", want)
    reset_launch_counts()
    (lp, _), t_p = timed(lambda: forward(params, {"tokens": tok}, cfg=cfg,
                                         use_kernels=False, device=dev))
    (lf, _), t_f = timed(lambda: forward(
        params, {"tokens": tok}, cfg=cfg.derive(dtype="float32"),
        use_kernels=False, device=dev))
    exact_launches("the plain path", {})
    log(f"phase9 plain forward bf16 wall_s={t_p:.4f}, fp32 wall_s="
        f"{t_f:.4f}")
    log("phase9 " + within_noise("scoring logits, kernels vs plain",
                                 lk, lp, lf)
        + f" argmax_agree={float((lk.argmax(-1) == lp.argmax(-1)).float().mean()):.4f}")
    del lk, lp, lf
    log("phase9 scoring forward again, " + checked_run(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev)))
    rows = [kernel_row("wkv6", rec, launches, "phase9 main-path",
                       "rwkv6_3b forward (phase 9)")]
    rec.calls.clear()
    torch.cuda.empty_cache()

    # 2. a cache-filling prefill in two segments, B=4: S=1024 from the
    # engine's zero cache, then S=1024 more from the returned cache (the
    # kernel with a nonzero initial state)
    B, S, slots = PREFILL_BSC
    tok = rng.integers(0, cfg.vocab_size, (B, 2 * S)).astype(np.int32)
    segs = (tok[:, :S], tok[:, S:])

    def prefill(c, use_kernels, cache1=None):
        """(logits, cache) of the second segment; the first segment's
        cache is taken as given, or made here."""
        if cache1 is None:
            _, cache1 = forward(params, {"tokens": segs[0]}, cfg=c,
                                use_kernels=use_kernels, device=dev,
                                cache=engine_cache(c, B, slots, dev))
        return forward(params, {"tokens": segs[1]}, cfg=c,
                       use_kernels=use_kernels, device=dev, cache=cache1)

    reset_launch_counts()
    (_, c1), t_1 = timed(lambda: forward(
        params, {"tokens": segs[0]}, cfg=cfg, use_kernels=True, device=dev,
        cache=engine_cache(cfg, B, slots, dev)))
    exact_launches("prefill segment 1", want)
    reset_launch_counts()
    (lk, ck), t_2 = timed(lambda: prefill(cfg, True, c1))
    got = exact_launches("prefill segment 2", want)
    s0_max = float(c1["wkv"].abs().max())
    if not s0_max > 0:
        raise AssertionError("segment 2 started from a zero state")
    (lp, cp), t_p = timed(lambda: prefill(cfg, False))
    lf, cf = prefill(cfg.derive(dtype="float32"), False)
    log(f"phase9 prefill B={B} S={S}+{S}: kernels wall_s={t_1:.4f}+"
        f"{t_2:.4f} launches per segment={json.dumps(got)} (segment 2 from "
        f"a state of max |wkv| {s0_max:.4g}); plain wall_s={t_p:.4f} for "
        f"both")
    log("phase9 " + within_noise("prefill segment 2 logits", lk, lp, lf))
    for key in ck:
        log("phase9 " + within_noise(
            f"prefill cache {key} {tuple(ck[key].shape)} "
            f"{str(ck[key].dtype)[6:]}", ck[key], cp[key], cf[key]))
    log("phase9 prefill segment 2 again, " + checked_run(
        lambda: prefill(cfg, True, c1)))
    del lk, ck, lp, cp, lf, cf, c1
    torch.cuda.empty_cache()

    # 3. the serving engine
    serve_run("phase9", cfg, params, SERVE_PROMPTS, 16, 4, 256, rng, dev)
    log(f"phase9 peak_device_bytes={torch.cuda.max_memory_allocated()}")
    return rows, params


# ---------------------------------------------------------------------------
# phases 12 and 13: the decoder families (moe, dense, vlm, encdec)
# ---------------------------------------------------------------------------

#: phase 12: qwen3-moe at full width, QWEN3_LAYERS of its 48 layers (all
#: 48 are 30,079,125,504 parameters, 120.3 GB in fp32, more than the card
#: holds; 24 are 15,350,728,704, 61.4 GB); the scoring forward's (B, S),
#: the prefill's (B, S, cache slots), the host check's depth and (B, S);
#: the engine serves SERVE_PROMPTS
QWEN3_LAYERS = 24
MOE_SCORE_BS = (2, 2048)
MOE_PREFILL_BSC = (4, 512, 1024)
MOE_HOST_LAYERS, MOE_HOST_BS = 2, (1, 128)
#: phase 13: each family at full width and this many layers (None: all):
#: gemma3 one 5:1 local-to-global group, qwen2-vl 4, seamless whole (12 +
#: 12), mixtral 2 (~21.6 GB); the scoring forward's (B, S); the engine's
#: two prompts, 8 new tokens each
FAMILY_CUTS = (("gemma3_12b", 6), ("qwen2_vl_7b", 4),
               ("seamless_m4t_medium", None), ("mixtral_8x22b", 2))
FAMILY_BS = (1, 2048)
FAMILY_PROMPTS = (12, 20)


def device_split(fn, wall_s: float, top: int = 10) -> str:
    """One call of ``fn`` under ``torch.profiler``: the device time of its
    kernels, copies and fills by name (the ``top`` largest, each with its
    share and launches), their sum against ``wall_s`` (a warm call's wall
    time, not profiled) and so the device's idle share."""
    by_name = {}
    for name, _, us, k in kernel_us(fn, calls=1, cats=(
            "kernel", "gpu_memcpy", "gpu_memset")):
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, n + k)
    busy = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (f"device time of one forward: busy_ms={busy / 1e3:.3f} of "
            f"wall_ms={wall_s * 1e3:.3f} (idle share "
            f"{1 - busy / 1e3 / (wall_s * 1e3):.4f}); largest: " + "; ".join(
                f"{name} {t / 1e3:.3f} ms ({t / busy:.4f}) x{n:g}"
                for name, (t, n) in rows))


def family_batch(cfg, B: int, S: int, rng, dev) -> dict:
    """Tokens and the family's other inputs, on the card: qwen2-vl's patch
    embeddings over the leading ``n_patches`` positions with M-RoPE
    positions (t, h, w: the patches a square grid at t = 0, the text after
    them on all three streams from the grid's side on), seamless's encoder
    frames."""
    def card_(a):
        return torch.from_numpy(a).to(dev)
    b = {"tokens": card_(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32))}
    if cfg.family == "vlm":
        P = cfg.n_patches
        side = int(round(P ** 0.5))
        b["patch_embeds"] = card_(rng.standard_normal(
            (B, P, cfg.d_model), dtype=np.float32))
        i = np.arange(S)
        text = i - P + side
        pos = np.stack([np.where(i < P, 0, text),
                        np.where(i < P, i // side, text),
                        np.where(i < P, i % side, text)], -1)
        b["positions"] = card_(np.broadcast_to(pos, (B, S, 3)).astype(
            np.int32).copy())
    if cfg.family == "encdec":
        b["frames"] = card_(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32))
    return b


def phase_moe(seed: int, dev) -> list:
    """Phase 12: qwen3-moe at full width and QWEN3_LAYERS deep on the
    card.  Returns the flash and gmm rows of the JSON line (launches from
    the scoring forward, this path; times and errors on its first
    inputs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import count_params, forward, param_specs
    full = get_config("qwen3_moe_30b_a3b")
    cfg = full.derive(n_layers=QWEN3_LAYERS)
    L = cfg.n_layers
    torch.cuda.empty_cache()
    params, t_init = timed(lambda: model_params(cfg, seed, dev))
    n = count_params(param_specs(cfg))
    log(f"phase12 qwen3_moe_30b_a3b: {L} of {full.n_layers} layers "
        f"({count_params(param_specs(full))} params at {full.n_layers}), "
        f"{n} params fp32 on the card ({4 * n} bytes); d={cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd}, kv {cfg.n_kv_heads}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token}, expert d_ff "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}; init_s={t_init:.3f}")
    rng = np.random.default_rng(seed + 12)
    want = {"flash_attention": L, "gmm": 3 * L}

    # 1. scoring forward
    B, S = MOE_SCORE_BS
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    rec = KernelWatch()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        (lk, _), t_first = timed(lambda: forward(
            params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev))
        launches = launch_counts()
    finally:
        rec.restore()
    exact_launches("scoring forward", want)
    routes = rec.routes.get("gmm", [])
    if routes != ["tma"] * (3 * L):
        raise AssertionError(f"scoring forward's gmm routes: {routes}")
    if lk.shape != (B, S, cfg.vocab_size) \
            or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"scoring logits {tuple(lk.shape)} not finite")
    del lk
    reset_launch_counts()
    _, t_k = timed(lambda: forward(params, {"tokens": tok}, cfg=cfg,
                                   use_kernels=True, device=dev))
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"phase12 scoring forward B,S={MOE_SCORE_BS} use_kernels=True: "
        f"wall_s={t_k:.4f} tokens_per_s={B * S / t_k:.1f} (first call, "
        f"launches recorded: wall_s={t_first:.4f}) launches="
        f"{json.dumps(launches)}, all {len(routes)} gmm on route tma; "
        f"peak_device_bytes={peak} of {total}, free at peak {total - peak}")
    log("phase12 " + device_split(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev),
        t_k))
    # the first calls replayed, then their copies freed: the checked run
    # needs the room
    rows = [kernel_row(name, rec, launches, "phase12 main-path",
                       f"qwen3_moe_30b_a3b forward, {L} layers (phase 12)")
            for name in ("flash_attention", "gmm")]
    rec.calls.clear()
    torch.cuda.empty_cache()
    log("phase12 scoring forward again, " + checked_run(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev)))
    torch.cuda.empty_cache()

    # 2. cache-filling prefill against the plain path
    B, S, slots = MOE_PREFILL_BSC
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    reset_launch_counts()
    (lk, ck), t_k = timed(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev,
        cache=engine_cache(cfg, B, slots, dev)))
    got = exact_launches("prefill", want)
    reset_launch_counts()
    (lp, cp), t_p = timed(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=False, device=dev,
        cache=engine_cache(cfg, B, slots, dev)))
    exact_launches("plain prefill", {})
    f32 = cfg.derive(dtype="float32")
    lf, cf = forward(params, {"tokens": tok}, cfg=f32, device=dev,
                     cache=engine_cache(f32, B, slots, dev))
    log(f"phase12 prefill B={B} S={S} cache {slots}: kernels "
        f"wall_s={t_k:.4f} launches={json.dumps(got)} plain "
        f"wall_s={t_p:.4f}")
    # at this depth the bf16-vs-fp32 gap has saturated and the noise rule
    # below cannot tell a wrong kernel: the launches are held one by one
    log("phase12 prefill again, " + checked_run(lambda: forward(
        params, {"tokens": tok}, cfg=cfg, use_kernels=True, device=dev,
        cache=engine_cache(cfg, B, slots, dev))))
    log("phase12 " + within_noise("prefill logits", lk, lp, lf)
        + f" argmax_agree="
        f"{float((lk.argmax(-1) == lp.argmax(-1)).float().mean()):.4f}")
    for key in ck:
        log("phase12 " + within_noise(
            f"prefill cache {key} {tuple(ck[key].shape)} "
            f"{str(ck[key].dtype)[6:]}", ck[key], cp[key], cf[key]))
    del lk, ck, lp, cp, lf, cf
    torch.cuda.empty_cache()

    # 3. the serving engine
    serve_run("phase12", cfg, params, SERVE_PROMPTS, 16, 4, 256, rng, dev)
    log(f"phase12 peak_device_bytes={torch.cuda.max_memory_allocated()}")

    # 4. the card against the host at full width, MOE_HOST_LAYERS deep
    phase_host("qwen3_moe_30b_a3b", params, MOE_HOST_LAYERS, seed, dev,
               "phase12 host", MOE_HOST_BS)
    del params
    torch.cuda.empty_cache()
    return rows


def phase_families(seed: int, dev) -> None:
    """Phase 13: gemma3, qwen2-vl, seamless and mixtral at full width and
    the depths of FAMILY_CUTS, one model at a time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import (count_params, forward, layer_flags,
                                    param_specs)
    for arch, layers in FAMILY_CUTS:
        full = get_config(arch)
        cfg = full if layers is None else full.derive(n_layers=layers)
        tag = f"phase13 {arch}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, t_init = timed(lambda: model_params(cfg, seed, dev))
        n_attn = cfg.n_dec_layers if cfg.family == "encdec" \
            else cfg.n_layers
        want = {"flash_attention": n_attn,
                "gmm": 3 * cfg.n_layers if cfg.is_moe else 0}
        depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers} layers"
                 if cfg.family == "encdec"
                 else f"{cfg.n_layers} of {full.n_layers} layers")
        log(f"{tag}: {depth}, {count_params(param_specs(cfg))} params fp32 "
            f"on the card; d={cfg.d_model}, {cfg.n_heads} heads of "
            f"{cfg.hd}, kv {cfg.n_kv_heads}, window {cfg.sliding_window}; "
            f"init_s={t_init:.3f}")
        rng = np.random.default_rng(seed + 13)
        B, S = FAMILY_BS
        batch = family_batch(cfg, B, S, rng, dev)

        def run(use_kernels=True, c=cfg, b=batch):
            return forward(params, b, cfg=c, use_kernels=use_kernels,
                           device=dev)[0]

        rec = KernelWatch()
        reset_launch_counts()
        try:
            lk, t_k = timed(run)
        finally:
            rec.restore()
        got = exact_launches(f"{arch} scoring forward", want)
        if lk.shape != (B, S, cfg.vocab_size) \
                or not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"{arch}: logits {tuple(lk.shape)} not "
                                 f"finite")
        routes = rec.routes.get("gmm", [])
        if routes != ["tma"] * want["gmm"]:
            raise AssertionError(f"{arch}: gmm routes {routes}")
        windows = [kw.get("window") for kw in rec.kws["flash_attention"]]
        del lk
        rec.calls.clear()
        _, t_warm = timed(run)
        log(f"{tag} scoring forward B,S={FAMILY_BS} use_kernels=True: "
            f"wall_s={t_warm:.4f} tokens_per_s={B * S / t_warm:.1f} (first "
            f"call, launches recorded: wall_s={t_k:.4f}) launches="
            f"{json.dumps(got)} flash windows={windows} gmm routes="
            f"{routes} peak_device_bytes={torch.cuda.max_memory_allocated()}")
        log(f"{tag} scoring forward again, " + checked_run(run))
        if arch == "gemma3_12b":
            # the reference's fault, kept: the global layer's launch also
            # gets the window (ROADMAP.md queue 3)
            flags = layer_flags(cfg)
            if not flags.any() or any(w != cfg.sliding_window
                                      for w in windows):
                raise AssertionError(f"gemma3 flash windows {windows}")
            log(f"{tag}: the global layers {np.flatnonzero(flags).tolist()}"
                f" launched flash with window={cfg.sliding_window}, as the "
                f"reference's kernel path does (its fault, kept)")
            # within the window the fault cannot show: kernels vs plain
            short = {"tokens": batch["tokens"][:, :cfg.sliding_window]}
            log(f"{tag} S={cfg.sliding_window} (= window), "
                + checked_run(lambda: run(b=short)))
            lk = run(b=short)
            lp = run(False, b=short)
            lf = run(False, c=cfg.derive(dtype="float32"), b=short)
            log(f"{tag} S={cfg.sliding_window} (= window) " + within_noise(
                "logits, kernels vs plain", lk, lp, lf))
            del lk, lp, lf
        serve_run(tag, cfg, params, FAMILY_PROMPTS, 8, 2, 64, rng, dev)
        del params, batch
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 14 and 15: training
# ---------------------------------------------------------------------------

#: phase 14: qwen1.5-4B trained at full width and TRAIN_LAYERS of its 40
#: layers under remat="full" (3,950,369,280 fp32 parameters; with their
#: gradients and AdamW's two moments 63.2 GB), TRAIN_STEPS steps on one
#: batch of TRAIN_BS (B, S) with TRAIN_OPT; the remat comparison's depth;
#: the host check's depth and (B, S)
TRAIN_LAYERS = 40
TRAIN_BS = (1, 2048)
TRAIN_STEPS = 3
TRAIN_OPT = dict(lr=1e-4, warmup_steps=0, total_steps=3)
REMAT_LAYERS = 8
TRAIN_HOST_LAYERS, TRAIN_HOST_BS = 2, (1, 128)
#: AdamW on the card against the host on identical gradients
ADAMW_ATOL = 1e-6
#: phase 15: the other kernels' training paths at full width, one model
#: at a time, each this deep (zamba2: two shared-attention applications),
#: one step at (B, S) TRAIN_CUT_BS; then the trainer as users start it:
#: TRAINER_RUNS[0] steps checkpointing every TRAINER_RUNS[1], then resumed
#: up to TRAINER_RUNS[2]
TRAIN_CUTS = (("zamba2_2_7b", 12), ("rwkv6_3b", 8),
              ("qwen3_moe_30b_a3b", 2))
TRAIN_CUT_BS = (1, 1024)
TRAINER_RUNS = (12, 5, 14)


def leaf_paths(tree, prefix=""):
    """The key paths of a nested dict's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}/{k}")]
    return [prefix]


def loss_and_grads(cfg, params, batch, use_kernels: bool, dev) -> tuple:
    """(loss, gradients in ``tree_leaves`` order, the launches of the
    forward, the launches of forward and backward)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import loss_fn
    from repro_torch.models.params import tree_leaves, tree_map
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    diff = tree_map(lambda _: next(it), params)
    reset_launch_counts()
    loss = loss_fn(diff, batch, cfg=cfg, use_kernels=use_kernels,
                   device=dev)
    fwd = launch_counts()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return loss.detach(), list(grads), fwd, launch_counts()


def grads_within_noise(tag: str, names, got, plain, plain_fp32) -> str:
    """Every gradient leaf by the noise rule; returns the line naming the
    worst leaf (largest error over its allowance)."""
    worst = (-1.0, "")
    for name, g, p, f in zip(names, got, plain, plain_fp32):
        line = within_noise(f"grad {name}", g, p, f)
        err, noise = rel_l2(g, p), rel_l2(p, f)
        worst = max(worst, (err / (NOISE_FACTOR * noise + NOISE_FLOOR),
                            line))
    return (f"{tag}: {len(names)} gradient leaves within noise; worst "
            f"(error over allowance {worst[0]:.4f}) {worst[1]}")


def all_finite(tree) -> bool:
    from repro_torch.models.params import tree_leaves
    return all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(tree))


#: the parts of a train step's device time (``train_split``)
SPLIT_PARTS = ("flash kernels (forward and remat recompute)",
               "attention backward (plain version: recompute and autograd)",
               "LM head and loss (forward and backward)",
               "optimizer (adamw_update)",
               "layers' other work (projections, MLP, norms, RoPE, casts; "
               "their recompute and backward; gradient stacking)")


def train_split(fn, wall_s: float) -> dict:
    """One call of ``fn`` (a train step) under ``torch.profiler``: the
    device time of its kernels, copies and fills in SPLIT_PARTS, each
    device event placed by where its launch was made (the launch's host
    thread and time, joined through the trace's correlation ids): inside
    ``adamw_update``; inside the autograd node of the flash Function's
    backward; on the forward's thread from the LM head on, or on the
    backward's thread before its first flash launch (the LM head and the
    loss); a flash kernel by its name.  Also the busy time against
    ``wall_s`` (a warm step's wall time, not profiled) and the largest
    kernels."""
    import repro_torch.models.lm as lm
    import repro_torch.train.step as step_mod
    from torch.profiler import ProfilerActivity, profile, record_function
    real_update, real_head = step_mod.adamw_update, lm.lm_head

    def update(*a, **kw):
        with record_function("adamw_update"):
            return real_update(*a, **kw)

    def head(*a, **kw):
        with record_function("lm_head"):
            return real_head(*a, **kw)

    step_mod.adamw_update, lm.lm_head = update, head
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        step_mod.adamw_update, lm.lm_head = real_update, real_head
    path = ROOT / "build" / "train_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    launch, device, ranges = {}, [], {}
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["name"], e["dur"], args.get("correlation")))
        elif cat in ("cpu_op", "user_annotation") and e.get("ph") == "X":
            name = e["name"]
            key = ("update" if name == "adamw_update" else "head"
                   if name == "lm_head" else "attn_bwd"
                   if name.startswith("autograd::engine::evaluate_function")
                   and "_FlashAttentionBackward" in name else None)
            if key:
                ranges.setdefault(key, []).append(
                    (e["tid"], e["ts"], e["ts"] + e["dur"]))

    def inside(key, at):
        return any(t == at[0] and a <= at[1] <= b
                   for t, a, b in ranges.get(key, ()))

    head_at = min(ranges["head"], key=lambda r: r[1])
    flash_at = sorted(launch[c] for n, _, c in device
                      if "flash" in n.lower() and c in launch)
    bwd_tid = ranges["attn_bwd"][0][0] if "attn_bwd" in ranges else None
    first_bwd_flash = min((ts for t, ts in flash_at if t == bwd_tid),
                          default=float("inf"))
    parts = {p: [0.0, 0] for p in SPLIT_PARTS}
    by_name = {}
    for name, dur, corr in device:
        at = launch.get(corr, (None, 0.0))
        if "flash" in name.lower():
            part = SPLIT_PARTS[0]
        elif inside("update", at):
            part = SPLIT_PARTS[3]
        elif inside("attn_bwd", at):
            part = SPLIT_PARTS[1]
        elif (at[0] == head_at[0] and at[1] >= head_at[1]) or (
                at[0] == bwd_tid and at[1] < first_bwd_flash):
            part = SPLIT_PARTS[2]
        else:
            part = SPLIT_PARTS[4]
        parts[part][0] += dur
        parts[part][1] += 1
        t, k = by_name.get(name[:60], (0.0, 0))
        by_name[name[:60]] = (t + dur, k + 1)
    busy = sum(t for t, _ in parts.values())
    return {"busy_ms": busy / 1e3, "wall_ms": wall_s * 1e3,
            "idle_share": 1 - busy / 1e3 / (wall_s * 1e3),
            "ranges": {k: len(v) for k, v in ranges.items()},
            "parts": {p: {"ms": t / 1e3, "share": t / max(busy, 1e-30),
                          "events": n}
                      for p, (t, n) in parts.items()},
            "largest": [(n, t / 1e3, k) for n, (t, k) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:8]]}


def phase_train(seed: int, dev) -> tuple:
    """Phase 14: qwen1.5-4B training at full width on the card.  Returns
    the flash row of the JSON line (launches from a train step, this path;
    times and errors on its first inputs) and the phase's figures."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import count_params, param_specs
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.parallel.sharding import MeshPolicy
    from repro_torch.train import (OptConfig, adamw_init, adamw_update,
                                   make_train_step)
    full = get_config("qwen1_5_4b")
    cfg = full.derive(n_layers=TRAIN_LAYERS, remat="full")
    L = cfg.n_layers
    B, S = TRAIN_BS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: model_params(cfg, seed, dev))
    opt_state = adamw_init(params)
    n = count_params(param_specs(cfg))
    log(f"phase14 qwen1_5_4b training: {L} of {full.n_layers} layers, "
        f"remat={cfg.remat}, {n} params fp32 on the card (params, grads, "
        f"mu, nu: {16 * n} bytes); d={cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; B,S={TRAIN_BS}"
        f", {TRAIN_STEPS} steps of AdamW {TRAIN_OPT}; init_s={t_init:.3f}")
    batch = synthetic_batch(B, S, cfg.vocab_size, step=0, seed=seed,
                            device=dev)
    step = make_train_step(cfg, MeshPolicy(), None,
                           opt=OptConfig(**TRAIN_OPT), use_kernels=True,
                           device=dev)
    want = {"flash_attention": 2 * L}
    losses, walls, out, rec = [], [], {}, None
    for i in range(TRAIN_STEPS):
        reset_launch_counts()
        if i == 0:
            # every launch, forward and remat recompute, against its
            # plain version on its own inputs
            t0 = time.perf_counter()
            line = checked_run(lambda: out.update(
                r=step(params, opt_state, batch)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"phase14 step 0 (checked), {line}")
        elif i == 1:
            rec = KernelWatch()
            try:
                out["r"], wall = timed(lambda: step(params, opt_state,
                                                    batch))
            finally:
                rec.restore()
        else:
            out["r"], wall = timed(lambda: step(params, opt_state, batch))
        launches = exact_launches(f"train step {i}", want)
        losses.append(float(out["r"][2]))
        walls.append(wall)
        log(f"phase14 step {i}: loss={losses[-1]:.6f} wall_s={wall:.4f} "
            f"launches={json.dumps(launches)}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    if not all(np.isfinite(losses)) or losses[-1] > losses[0] + 0.5:
        raise AssertionError(f"phase14 losses {losses}")
    if not all_finite(params):
        raise AssertionError("phase14: parameters not finite")
    warm = walls[-1]
    log(f"phase14 train step: ms_per_warm_step={warm * 1e3:.3f} "
        f"training_tokens_per_s={B * S / warm:.1f} losses={losses} "
        f"peak_device_bytes={peak} of {total}, free at peak "
        f"{total - peak}; parameters finite")
    split = train_split(lambda: step(params, opt_state, batch), warm)
    log("phase14 device split of one warm step: busy_ms="
        f"{split['busy_ms']:.3f} of wall_ms={split['wall_ms']:.3f} (idle "
        f"share {split['idle_share']:.4f}); ranges found "
        f"{json.dumps(split['ranges'])}; " + "; ".join(
            f"{p} {v['ms']:.3f} ms ({v['share']:.4f}, {v['events']} events)"
            for p, v in split["parts"].items()) + "; largest: " + "; ".join(
            f"{nm} {t:.3f} ms x{k}" for nm, t, k in split["largest"]))
    row = kernel_row("flash_attention", rec, launches, "phase14 main-path",
                     f"qwen1_5_4b train step, {L} layers, remat full "
                     f"(phase 14)")
    rec.calls.clear()
    figures = {"layers": L, "params": n, "losses": losses,
               "step_walls_s": walls, "ms_per_warm_step": warm * 1e3,
               "training_tokens_per_s": B * S / warm, "peak_device_bytes":
               peak, "free_at_peak_bytes": total - peak,
               "flash_launches_per_step": launches["flash_attention"],
               "split": {p: v["ms"] for p, v in split["parts"].items()},
               "busy_ms": split["busy_ms"],
               "idle_share": split["idle_share"]}
    del params, opt_state, step, out
    torch.cuda.empty_cache()

    # remat: equal loss and gradients, twice the flash launches
    c8 = full.derive(n_layers=REMAT_LAYERS)
    p8 = model_params(c8, seed, dev)
    names = leaf_paths(p8)
    res = {}
    for remat in ("none", "full"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (loss, grads, _, got), wall = timed(lambda: loss_and_grads(
            c8.derive(remat=remat), p8, batch, True, dev))
        held_launches(f"remat={remat}", got, {
            "flash_attention": REMAT_LAYERS * (2 if remat == "full" else 1)})
        # the run's own peak, above what was held before it
        res[remat] = (loss, grads, got["flash_attention"],
                      torch.cuda.max_memory_allocated() - base, wall)
    (l0, g0, n0, pk0, w0), (l1, g1, n1, pk1, w1) = res["none"], res["full"]
    bitwise = [bool(torch.equal(a, b)) for a, b in zip(g1, g0)]
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(g1, g0))
    if not torch.equal(l0, l1) and abs(float(l1 / l0) - 1) > 1e-6 \
            or worst > 1e-6:
        raise AssertionError(f"remat changed the loss ({float(l0)} vs "
                             f"{float(l1)}) or a gradient ({worst})")
    log(f"phase14 remat at {REMAT_LAYERS} layers, loss and gradients "
        f"(B,S={TRAIN_BS}): none vs full: loss bitwise "
        f"{bool(torch.equal(l0, l1))} ({float(l0):.6f}), gradient leaves "
        f"bitwise equal {sum(bitwise)} of {len(bitwise)}, largest "
        f"difference over the leaf's largest element {worst:.3g}; flash "
        f"launches {n0} vs {n1}; peak device bytes above the parameters "
        f"{pk0} vs {pk1}; wall_s "
        f"{w0:.4f} vs {w1:.4f}")
    figures["remat"] = {"layers": REMAT_LAYERS, "loss_bitwise":
                        bool(torch.equal(l0, l1)), "bitwise_leaves":
                        sum(bitwise), "leaves": len(bitwise),
                        "max_rel_diff": worst, "flash_launches": [n0, n1],
                        "peak_bytes_above_params": [pk0, pk1]}
    del res, g0, g1

    # the card's kernel path against the host's plain path, 2 layers
    c2 = full.derive(n_layers=TRAIN_HOST_LAYERS)
    p2 = dict(p8, layers=tree_map(lambda a: a[:TRAIN_HOST_LAYERS],
                                  p8["layers"]))
    host = tree_map(lambda t: t.cpu(), p2)
    Bh, Sh = TRAIN_HOST_BS
    hb = synthetic_batch(Bh, Sh, c2.vocab_size, step=1, seed=seed,
                         device="cpu")
    (lk, gk, _, got), t_c = timed(lambda: loss_and_grads(
        c2, p2, {k: v.to(dev) for k, v in hb.items()}, True, dev))
    held_launches("host check, card", got,
                  {"flash_attention": TRAIN_HOST_LAYERS})
    t0 = time.perf_counter()
    lp, gp, _, _ = loss_and_grads(c2, host, hb, False, "cpu")
    t_h = time.perf_counter() - t0
    lf, gf, _, _ = loss_and_grads(c2.derive(dtype="float32"), host, hb,
                                  False, "cpu")
    log(f"phase14 host check {TRAIN_HOST_LAYERS} layers B,S="
        f"{TRAIN_HOST_BS}: card (kernels) wall_s={t_c:.4f}, host (plain) "
        f"wall_s={t_h:.4f}; " + within_noise("loss", lk, lp, lf))
    log("phase14 " + grads_within_noise("host check", leaf_paths(p2), gk,
                                        gp, gf))
    # AdamW on identical gradients (the host's fp32 ones) on both
    opt = OptConfig(**TRAIN_OPT)
    cp = tree_map(torch.clone, p2)
    hp = tree_map(torch.clone, host)
    cs, hs = adamw_init(cp), adamw_init(hp)
    it_c, it_h = iter([g.to(dev) for g in gf]), iter(gf)
    adamw_update(opt, cp, tree_map(lambda _: next(it_c), cp), cs)
    adamw_update(opt, hp, tree_map(lambda _: next(it_h), hp), hs)
    err = max(float((a.cpu() - b).abs().max()) for x, y in (
        (cp, hp), (cs["mu"], hs["mu"]), (cs["nu"], hs["nu"]))
        for a, b in zip(tree_leaves(x), tree_leaves(y)))
    if err > ADAMW_ATOL:
        raise AssertionError(f"adamw_update card vs host: {err}")
    log(f"phase14 adamw_update card vs host on identical gradients: "
        f"params, mu and nu max_abs_err={err:.3g} (atol {ADAMW_ATOL})")
    figures["host_adamw_max_abs_err"] = err
    del p8, p2, cp, cs, gk
    torch.cuda.empty_cache()
    return row, figures


def run_trainer(*argv) -> str:
    """``python -m repro_torch.launch.train`` in a subprocess, as users
    start it (on the card, its default); returns its standard output."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get(
            "PYTHONPATH") else []))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"trainer {argv} exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return r.stdout


def phase_train_paths(seed: int, dev) -> dict:
    """Phase 15: zamba2, rwkv6 and qwen3-moe training steps at full width
    (TRAIN_CUTS), then the trainer, started, checkpointed and resumed."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import count_params, param_specs
    from repro_torch.parallel.sharding import MeshPolicy
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    figures = {}
    B, S = TRAIN_CUT_BS
    for arch, layers in TRAIN_CUTS:
        full = get_config(arch)
        cfg = full.derive(n_layers=layers)
        tag = f"phase15 {arch}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model_params(cfg, seed, dev)
        want = {"ssd": layers if cfg.family == "hybrid" else 0,
                "wkv6": layers if cfg.family == "ssm" else 0,
                "gmm": 3 * layers if cfg.is_moe else 0,
                "flash_attention": max(1, layers // cfg.shared_attn_every)
                if cfg.family == "hybrid" else 0 if cfg.family == "ssm"
                else layers}
        log(f"{tag}: {layers} of {full.n_layers} layers, "
            f"{count_params(param_specs(cfg))} params fp32 on the card, "
            f"B,S={TRAIN_CUT_BS}")
        batch = synthetic_batch(B, S, cfg.vocab_size, step=0, seed=seed,
                                device=dev)
        (lk, gk, fwd, got), t_k = timed(lambda: loss_and_grads(
            cfg, params, batch, True, dev))
        if got != fwd:
            raise AssertionError(f"{arch}: the backward launched kernels: "
                                 f"{got} after the forward's {fwd}")
        launches = held_launches(f"{arch} loss and gradients", got, want)
        lp, gp, _, g_p = loss_and_grads(cfg, params, batch, False, dev)
        lf, gf, _, g_f = loss_and_grads(cfg.derive(dtype="float32"), params,
                                        batch, False, dev)
        held_launches(f"{arch} plain paths", {k: g_p[k] + g_f[k]
                                              for k in g_p}, {})
        log(f"{tag} loss and gradients with the kernels: wall_s={t_k:.4f} "
            f"launches={json.dumps(launches)}, none in the backward; "
            + within_noise("loss, kernels vs plain", lk, lp, lf))
        log(tag + " " + grads_within_noise("kernels vs plain",
                                           leaf_paths(params), gk, gp, gf))
        del gk, gp, gf
        torch.cuda.empty_cache()
        opt_state = adamw_init(params)
        step = make_train_step(cfg, MeshPolicy(), None,
                               opt=OptConfig(**TRAIN_OPT), use_kernels=True,
                               device=dev)
        out = {}
        reset_launch_counts()
        line = checked_run(lambda: out.update(r=step(params, opt_state,
                                                      batch)))
        exact_launches(f"{arch} train step", want)
        loss = float(out["r"][2])
        if not np.isfinite(loss) or not all_finite(params):
            raise AssertionError(f"{arch} train step: loss {loss}")
        log(f"{tag} train step: loss={loss:.6f} (before it "
            f"{float(lk):.6f}), parameters finite; {line}; "
            f"peak_device_bytes={torch.cuda.max_memory_allocated()}")
        figures[arch] = {"layers": layers, "launches": launches,
                         "loss": loss}
        del params, opt_state, step, out, batch
        torch.cuda.empty_cache()

    # the trainer, as users start it, then resumed
    steps, every, more = TRAINER_RUNS
    with tempfile.TemporaryDirectory() as d:
        common = ("--arch", "qwen1_5_4b", "--smoke", "--ckpt-every",
                  str(every), "--ckpt-dir", d)
        t0 = time.perf_counter()
        first = run_trainer("--steps", str(steps), *common)
        t1 = time.perf_counter()
        second = run_trainer("--resume", "--steps", str(more), *common)
        t2 = time.perf_counter()
    last = (steps // every) * every
    if f"checkpointed step {last}" not in first \
            or not first.strip().endswith(
                f"ledger last step = {steps - 1}"):
        raise AssertionError(f"trainer: {first[-600:]}")
    if f"resumed from step {last}" not in second \
            or not second.strip().endswith(f"ledger last step = {more - 1}"):
        raise AssertionError(f"trainer resumed: {second[-600:]}")
    log(f"phase15 trainer: {steps} steps checkpointing every {every} "
        f"(wall_s={t1 - t0:.3f}): {first.strip().splitlines()[-1]!r}; "
        f"--resume --steps {more} (wall_s={t2 - t1:.3f}): resumed from "
        f"step {last}, {second.strip().splitlines()[-1]!r}")
    figures["trainer"] = {"resumed_from": last, "ledger_last_step": more - 1,
                          "wall_s": [t1 - t0, t2 - t1]}
    return figures


# ---------------------------------------------------------------------------
# phase 16: the multi-device layer
# ---------------------------------------------------------------------------

#: phase 16 on one card: a full-width qwen3-moe layer over (B, S) tokens on
#: a (1, 1) mesh; the one-stage pipeline: qwen1.5-4B's first layers, the
#: microbatches and their (B, S); the trainer's steps
MESH1_MOE_BS = (1, 512)
MESH1_PIPE = (2, 4, (1, 512))
MESH1_TRAIN_STEPS = 2
#: on four cards (phase 16's second part): qwen3-moe at full width and all
#: 48 layers over a (1, 4) mesh, the expert-parallel route, scoring at
#: EP_SCORE_BS; the depth of the 4-rank-vs-one-card check and its (B, S);
#: the pipeline: PIPE_LAYERS of qwen1.5-4B's layers over PIPE_STAGES
#: stages, PIPE_MICRO microbatches of PIPE_BS; the ranks' time limit
EP_RANKS = 4
EP_SCORE_BS = (2, 2048)
EP_CHECK_LAYERS, EP_CHECK_BS = 2, (2, 512)
PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO, PIPE_BS = 4, 8, 8, (1, 512)
EP_TIMEOUT = 480.0
#: data parallelism on four cards: a DP_LAYERS-deep qwen3-moe train step
#: at full width in fp32 over a (2, 2) ("data", "model") mesh on DP_BS
#: tokens, against one card's step on the whole batch in two
#: microbatches, the `data` ranks' rows (every row holds as many labels,
#: so that is the whole batch's mean): the router's matmul then has the
#: same rows on both sides, so no top-k choice flips on a rounding (in a
#: first run against the undivided batch, a parameter differed by
#: 2.56e-5); the capacity factor holds every token (the one card's
#: dense route drops none); tests/test_torch_dp.py's optimizer and
#: parameter tolerance
DP_LAYERS, DP_BS = 2, (4, 256)
DP_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=4, eps=1e-3)
DP_ATOL, DP_LOSS_RTOL = 1e-5, 1e-5
DP_TIMEOUT = 180.0


def decoder_layer_fn(cfg, S: int, dev):
    """One dense decoder layer of ``cfg`` as ``layer_fn(lp, h)`` (the
    port's ``_decoder_stack`` at depth 1, the kernels on): what
    ``pipeline_apply`` runs a layer at a time."""
    from repro_torch.models.lm import _decoder_stack
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.sharding import MeshPolicy
    one = cfg.derive(n_layers=1)
    pos = torch.arange(S, device=dev)[None, :]

    def layer_fn(lp, h):
        out, _ = _decoder_stack(
            {"layers": tree_map(lambda a: a[None], lp)}, h, cfg=one,
            policy=MeshPolicy(), mesh=None,
            positions=pos.expand(h.shape[0], S), use_kernels=True)
        return out
    return layer_fn


def layers_in_sequence(layer_fn, layers, n: int, x):
    """Each microbatch of ``x`` through the ``n`` stacked ``layers`` in
    turn, on one card: what the pipeline must equal."""
    from repro_torch.models.params import tree_map
    outs = []
    for m in range(x.shape[0]):
        h = x[m]
        for i in range(n):
            h = layer_fn(tree_map(lambda a, i=i: a[i], layers), h)
        outs.append(h)
    return torch.stack(outs)


def phase_mesh(seed: int, dev) -> dict:
    """Phase 16, the part every run makes: a one-rank NCCL group and
    ``make_host_mesh()``; a full-width qwen3-moe layer on that (1, 1) mesh
    (the dense route) against ``mesh=None``, bitwise; ``pipeline_apply``
    with one stage against the layers in sequence, bitwise; the trainer's
    smoke configuration, MESH1_TRAIN_STEPS steps on the mesh.  Returns the
    line's results."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.launch.train as trainer
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.mesh import init_host_group, make_host_mesh
    from repro_torch.models import init_params, param_specs
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import (MeshPolicy, mesh_shape,
                                               shard_constraint)
    torch.cuda.empty_cache()
    owns = init_host_group(dev)
    try:
        mesh = make_host_mesh()
        res = {"ranks": dist.get_world_size(), "backend": dist.get_backend(),
               "mesh": mesh_shape(mesh)}
        # 1. a qwen3-moe layer on the (1, 1) mesh: the dense route
        cfg = get_config("qwen3_moe_30b_a3b")
        gen = torch.Generator(device=dev).manual_seed(seed + 16)
        p = init_params(moe.moe_specs(cfg), gen, device=dev)
        B, S = MESH1_MOE_BS
        x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(
            torch.bfloat16)
        reset_launch_counts()
        on_mesh = moe.moe_apply(p, x, cfg=cfg, policy=MeshPolicy(),
                                mesh=mesh, use_kernels=True)
        res["moe_launches"] = exact_launches("moe_apply on the (1, 1) mesh",
                                             {"gmm": 3})
        bare = moe.moe_apply(p, x, cfg=cfg, policy=MeshPolicy(),
                             use_kernels=True)
        if not torch.equal(on_mesh, bare):
            raise AssertionError("moe_apply on the (1, 1) mesh != mesh=None")
        if shard_constraint(on_mesh, ("batch", "seq", "act_embed"),
                            MeshPolicy(), mesh) is not on_mesh:
            raise AssertionError("shard_constraint on a local tensor")
        res.update(moe_route=moe.moe_route(cfg, mesh),
                   moe_bitwise_equal_to_no_mesh=True)
        del p, x, on_mesh, bare
        # 2. the pipeline with one stage
        n, M, (B, S) = MESH1_PIPE
        q = get_config("qwen1_5_4b").derive(n_layers=n)
        layers = init_params(param_specs(q)["layers"], gen, device=dev)
        x = torch.randn(M, B, S, q.d_model, generator=gen, device=dev).to(
            torch.bfloat16)
        stage = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
        fn = decoder_layer_fn(q, S, dev)
        stacked = tree_map(lambda a: a[None], layers)
        pipeline_apply(fn, stacked, x, mesh=stage)          # warm-up
        out, t_pipe = timed(lambda: pipeline_apply(fn, stacked, x,
                                                   mesh=stage))
        seq, t_seq = timed(lambda: layers_in_sequence(fn, layers, n, x))
        if not torch.equal(out, seq):
            raise AssertionError(f"one-stage pipeline != layers in sequence:"
                                 f" max_abs {float((out - seq).abs().max())}")
        res.update(pipeline_one_stage_bitwise_equal=True,
                   pipeline_shape=[M, B, S, q.d_model], pipeline_s=t_pipe,
                   sequence_s=t_seq)
        del layers, x, out, seq
        torch.cuda.empty_cache()
        # 3. the trainer on the mesh (it joins this group)
        with tempfile.TemporaryDirectory() as d:
            text = io.StringIO()
            with redirect_stdout(text):
                trainer.main(["--smoke", "--steps", str(MESH1_TRAIN_STEPS),
                              "--batch", "2", "--seq", "64",
                              "--ckpt-every", "1", "--ckpt-dir", d,
                              "--device", dev.type])
            out = text.getvalue()
        last = MESH1_TRAIN_STEPS - 1
        if f"done: {MESH1_TRAIN_STEPS} steps" not in out or not \
                out.strip().endswith(f"ledger last step = {last}") or \
                f"checkpointed step {MESH1_TRAIN_STEPS}" not in out:
            raise AssertionError(f"trainer on the mesh: {out[-600:]}")
        res["trainer"] = out.strip().splitlines()[-1]
    finally:
        if owns:
            dist.destroy_process_group()
    log("phase16 " + json.dumps(res))
    return res


class AllToAllWatch:
    """Counts the MoE route's all-to-alls and times each by CUDA events on
    the current stream (it waits for NCCL's)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.events = moe, moe._all_to_all, []
        moe._all_to_all = self._timed

    def _timed(self, t, group):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.real(t, group)
        b.record()
        self.events.append((a, b, t.numel() * t.element_size()))
        return out

    def restore(self) -> dict:
        self.moe._all_to_all = self.real
        torch.cuda.synchronize()
        return {"count": len(self.events),
                "ms": sum(a.elapsed_time(b) for a, b, _ in self.events),
                "bytes_each": sorted({n for _, _, n in self.events})}


def ep_params(cfg, seed: int, rank: int, mesh, dev):
    """qwen3-moe's parameters for one rank of an EP mesh: the replicated
    leaves from ``seed`` (alike on every rank), the rank's slices of the
    experts from ``(seed, rank)``, drawn at their local shape."""
    from repro_torch.models import axes_tree, init_params, param_specs
    from repro_torch.models import moe
    from repro_torch.models.params import ParamSpec
    from repro_torch.parallel.sharding import mesh_shape
    specs = param_specs(cfg)
    pspecs = moe.moe_pspecs(axes_tree(specs), cfg, mesh)
    sizes = mesh_shape(mesh)
    rep = torch.Generator(device=dev).manual_seed(seed)
    own = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + 1
                                                  + rank)

    def make(s, ps):
        if isinstance(s, dict):
            return {k: make(v, ps[k]) for k, v in s.items()}
        if all(e is None for e in ps):
            return init_params(s, rep, device=dev)
        shape = tuple(n // sizes[e] if e else n for n, e in zip(s.shape, ps))
        return init_params(ParamSpec(shape, s.axes, s.init, s.scale), own,
                           device=dev)

    return make(specs, pspecs), pspecs


def one_card_moe(p, x, *, cfg, policy, mesh=None, use_kernels=False):
    """The function the EP route computes, on one card: ``_dispatch``,
    every expert through ``_expert_ffn`` with the route's capacity, then
    ``_combine`` (a check of this script's, not a route of the model)."""
    from repro_torch.models import moe
    B, S, d = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.n_experts
    C = moe._capacity(T, k, E, cfg.capacity_factor)
    w, idx = moe._router(p, x, k)
    buf, keep, pos, w2 = moe._dispatch(x.reshape(T, d), w.reshape(T, k),
                                       idx.reshape(T, k), E, C)
    y = moe._expert_ffn(p, buf, use_kernels=use_kernels)
    return moe._combine(y, idx.reshape(T, k), pos, keep,
                        w2).reshape(B, S, d)


def _same_on_every_rank(t: torch.Tensor) -> bool:
    """Bitwise equality of ``t`` across the default group: the element-wise
    largest and smallest of its bits agree."""
    import torch.distributed as dist
    bits = t.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16}[t.element_size()])
    if bits.dtype == torch.int16:          # NCCL reduces no int16
        bits = bits.to(torch.int32)
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def ep_rank(rank: int, world: int, dev, seed: int) -> dict:
    """One rank of phase 16's four-card part (``spawn_ranks``, NCCL, one
    card a rank).  Every check raises on the rank that fails it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.models.lm as lm
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import gather_params, init_params, param_specs
    from repro_torch.models import forward, moe, shard_params
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import P
    from repro_torch.launch.mesh import make_host_mesh
    res = {"rank": rank, "device": str(dev)}
    mesh = make_host_mesh()
    cfg = get_config("qwen3_moe_30b_a3b")
    L = res["layers"] = cfg.n_layers
    params, pspecs = ep_params(cfg, seed, rank, mesh, dev)
    if moe.moe_route(cfg, mesh) != "ep":
        raise AssertionError(f"route {moe.moe_route(cfg, mesh)} on {mesh}")
    rep = [t for t, ps in zip(tree_leaves(params), tree_leaves(pspecs))
           if all(e is None for e in ps)]
    sums = torch.stack([t.double().sum() for t in rep])
    if not _same_on_every_rank(sums):
        raise AssertionError("the replicated leaves differ across ranks")
    log(f"phase16 rank {rank}: parameters on {dev}")
    res["params_on_card"] = sum(t.numel() for t in tree_leaves(params))
    res["replicated_params"] = sum(t.numel() for t in rep)

    # 1. the scoring forward at full width and depth, expert-parallel
    B, S = EP_SCORE_BS
    tok = np.random.default_rng(seed + 16).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    def score():
        return forward(params, {"tokens": tok}, cfg=cfg, mesh=mesh,
                       use_kernels=True, device=dev)[0]

    rec = KernelWatch()
    first = AllToAllWatch()
    reset_launch_counts()
    try:
        lk, t_first = timed(score)
        launches = launch_counts()
    finally:
        rec.restore()
        a2a_first = first.restore()
    exact_launches("EP scoring forward", {"flash_attention": L,
                                          "gmm": 3 * L})
    routes = rec.routes.get("gmm", [])
    if routes != ["tma"] * (3 * L):
        raise AssertionError(f"EP forward's gmm routes: {routes}")
    if a2a_first["count"] != 2 * L:
        raise AssertionError(f"{a2a_first['count']} all-to-alls, want "
                             f"{2 * L}")
    del lk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    warm = AllToAllWatch()
    try:
        lk, t_warm = timed(score)
    finally:
        a2a = warm.restore()
    peak = torch.cuda.max_memory_allocated()
    if a2a["count"] != 2 * L or lk.shape != (B, S, cfg.vocab_size) \
            or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"warm EP forward: {a2a['count']} all-to-alls,"
                             f" logits {tuple(lk.shape)}")
    res.update(launches={k: n for k, n in launches.items() if n}, a2a=a2a,
               first_call_s=t_first,
               warm_s=t_warm, tokens_per_s=B * S / t_warm, peak_bytes=peak,
               total_bytes=torch.cuda.get_device_properties(
                   dev).total_memory)
    res["logits_bitwise_equal_across_ranks"] = _same_on_every_rank(lk)
    if not res["logits_bitwise_equal_across_ranks"]:
        raise AssertionError("EP logits differ across ranks")
    del lk
    torch.cuda.empty_cache()
    # every rank profiles its own forward: the forward's collectives must
    # meet on every rank in the same order
    res["device_split"] = device_split(score, t_warm)
    if rank == 0:
        res["gmm_row"] = kernel_row(
            "gmm", rec, launches, "phase16 main-path",
            f"qwen3_moe_30b_a3b forward, {L} layers over {world} cards, "
            f"expert-parallel (phase 16)")
    rec.calls.clear()
    torch.cuda.empty_cache()
    res["checked"] = checked_run(score)
    log(f"phase16 rank {rank}: scoring forward timed and checked")

    # 2. EP_CHECK_LAYERS deep: the four ranks against one card
    cfg2 = cfg.derive(n_layers=EP_CHECK_LAYERS)
    p2 = dict(params, layers=tree_map(
        lambda a: a[:EP_CHECK_LAYERS].clone(), params["layers"]))
    del params
    torch.cuda.empty_cache()
    B, S = EP_CHECK_BS
    tok2 = np.random.default_rng(seed + 17).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ep_out = forward(p2, {"tokens": tok2}, cfg=cfg2, mesh=mesh,
                     use_kernels=True, device=dev)[0]
    full = gather_params(p2, pspecs, mesh)
    del p2
    if rank == 0:
        real = lm.moe_apply
        lm.moe_apply = one_card_moe
        try:
            one = forward(full, {"tokens": tok2}, cfg=cfg2, mesh=None,
                          use_kernels=True, device=dev)[0]
        finally:
            lm.moe_apply = real
        err = rel_l2(ep_out, one)
        res["ep_vs_one_card"] = {
            "layers": EP_CHECK_LAYERS, "B,S": [B, S], "rel_l2": err,
            "max_abs": float((ep_out.float() - one.float()).abs().max()),
            "bitwise": bool(torch.equal(ep_out, one)),
            "tolerance_rel_l2": NOISE_FLOOR}
        if err > NOISE_FLOOR:
            raise AssertionError(f"EP vs one card: {res['ep_vs_one_card']}")
        del one
    del full, ep_out
    torch.cuda.empty_cache()

    log(f"phase16 rank {rank}: {EP_CHECK_LAYERS}-layer check done")

    # 3. the pipeline: PIPE_LAYERS of qwen1.5-4B over PIPE_STAGES stages
    q = get_config("qwen1_5_4b").derive(n_layers=PIPE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    layers = init_params(param_specs(q)["layers"], gen, device=dev)
    B, S = PIPE_BS
    x = torch.randn(PIPE_MICRO, B, S, q.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    per = PIPE_LAYERS // PIPE_STAGES
    stacked = tree_map(lambda a: a.reshape(PIPE_STAGES, per, *a.shape[1:]),
                       layers)
    stages = init_device_mesh("cuda", (PIPE_STAGES,),
                              mesh_dim_names=("stage",))
    local = shard_params(stacked, tree_map(lambda a: P("stage"), stacked),
                         stages, dev)
    fn = decoder_layer_fn(q, S, dev)
    pipeline_apply(fn, local, x, mesh=stages)           # warm-up
    dist.barrier()
    out, t_pipe = timed(lambda: pipeline_apply(fn, local, x, mesh=stages))
    res["pipeline_s"] = t_pipe
    if rank == 0:
        layers_in_sequence(fn, layers, PIPE_LAYERS, x[:1])    # warm-up
        seq, t_seq = timed(lambda: layers_in_sequence(fn, layers,
                                                      PIPE_LAYERS, x))
        err = rel_l2(out, seq)
        res["pipeline"] = {
            "stages": PIPE_STAGES, "layers": PIPE_LAYERS,
            "microbatches": PIPE_MICRO, "B,S": [B, S], "pipeline_s": t_pipe,
            "sequence_s": t_seq, "rel_l2": err, "bitwise":
            bool(torch.equal(out, seq)), "tolerance_rel_l2": NOISE_FLOOR}
        if err > NOISE_FLOOR:
            raise AssertionError(f"pipeline vs sequence: {res['pipeline']}")
    dist.barrier()
    return res


def dp_rank(rank: int, world: int, dev, seed: int) -> dict:
    """Phase 16's data-parallel check, one of four ranks (``spawn_ranks``,
    NCCL, one card a rank; ranks of their own, after ``ep_rank``'s): the
    batch's rows split over `data`, the experts over `model` (EP); every
    rank's gathered parameters bitwise alike; rank 0 runs the same step
    on the whole batch on its card alone (the dense route, the `data`
    ranks' rows as two microbatches: DP_LAYERS) and holds loss and
    parameters to it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import (axes_tree, gather_params, init_params,
                                    param_specs, shard_params)
    from repro_torch.models.moe import moe_pspecs, moe_route
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel.sharding import MeshPolicy, param_pspecs
    from repro_torch.train import OptConfig, adamw_init, train_step_fn
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    base = get_config("qwen3_moe_30b_a3b")
    cfg = base.derive(n_layers=DP_LAYERS, dtype="float32",
                      capacity_factor=base.n_experts / base.experts_per_token)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    full = init_params(param_specs(cfg), gen, device=dev)
    B, S = DP_BS
    rng = np.random.default_rng(seed + 19)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tok, "labels": labels}
    pspecs = moe_pspecs(axes_tree(param_specs(cfg)), cfg, mesh)
    p = shard_params(full, pspecs, mesh, dev)
    rows = shard_params(batch, param_pspecs(
        {"tokens": ("batch", None), "labels": ("batch", None)},
        MeshPolicy(), mesh), mesh, dev)
    opt = OptConfig(**DP_OPT)
    log(f"phase16 dp rank {rank}: parameters and rows on {dev}")
    (_, _, loss), t_dp = timed(lambda: train_step_fn(
        p, adamw_init(p), rows, cfg=cfg, policy=MeshPolicy(), mesh=mesh,
        opt=opt, use_kernels=True, device=dev))
    log(f"phase16 dp rank {rank}: step done in {t_dp:.3f} s")
    got = gather_params(p, pspecs, mesh)
    del p
    alike = all(_same_on_every_rank(t) for t in tree_leaves(got)) and \
        _same_on_every_rank(loss)
    if not alike:
        raise AssertionError("DP: the ranks' parameters or losses differ")
    res = {"mesh": [2, 2], "route": moe_route(cfg, mesh), "layers":
           DP_LAYERS, "B,S": [B, S], "step_s": t_dp, "loss": float(loss),
           "bitwise_alike_across_ranks": True}
    if rank == 0:
        one_loss = train_step_fn(full, adamw_init(full), batch, cfg=cfg,
                                 policy=MeshPolicy(), mesh=None, opt=opt,
                                 microbatches=2, use_kernels=True,
                                 device=dev)[2]
        errs = {k: float((a - b).abs().max()) for k, a, b in zip(
            leaf_paths(got), tree_leaves(got), tree_leaves(full))}
        worst = max(errs, key=errs.get)
        res.update(one_card_loss=float(one_loss),
                   params_max_abs=errs[worst], worst_leaf=worst,
                   loss_rel=abs(float(loss) / float(one_loss) - 1),
                   tolerance={"params_atol": DP_ATOL,
                              "loss_rtol": DP_LOSS_RTOL})
        log(f"phase16 dp rank 0 against one card: {json.dumps(res)}")
        if errs[worst] > DP_ATOL or res["loss_rel"] > DP_LOSS_RTOL:
            raise AssertionError(f"DP vs one card: {res}")
    dist.barrier()
    return res


def spawn_dp(seed: int) -> dict:
    """``dp_rank`` on EP_RANKS spawned ranks; rank 0's result."""
    import tempfile
    from repro_torch.launch.mesh import spawn_ranks
    with tempfile.TemporaryDirectory() as d:
        return spawn_ranks(dp_rank, EP_RANKS, seed, store_dir=d,
                           device_type="cuda", timeout=DP_TIMEOUT)[0]


def phase_mesh4(seed: int) -> list:
    """Phase 16's four-card part, when EP_RANKS cards are visible: EP_RANKS
    ranks spawned (NCCL, one card each) run ``ep_rank``; returns gmm's EP
    row for the kernels' line, or nothing when it did not run."""
    import tempfile
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks
    n = torch.cuda.device_count()
    if n < EP_RANKS:
        log(f"phase16 four-card part NOT RUN: {n} card(s) visible, it "
            f"needs {EP_RANKS}; nothing of it is reported")
        return []
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    log("phase16 nvidia-smi topo -m:\n" + (topo.stdout + topo.stderr).rstrip())
    log("phase16 peer access (torch.cuda.can_device_access_peer): " + str(
        [[i == j or torch.cuda.can_device_access_peer(i, j)
          for j in range(n)] for i in range(n)]))
    _build.library()              # built once here: the ranks only load it
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ranks, t = timed(lambda: spawn_ranks(
            ep_rank, EP_RANKS, seed, store_dir=d, device_type="cuda",
            timeout=EP_TIMEOUT))
    dp, t_dp = timed(lambda: spawn_dp(seed))
    zero = ranks[0]
    log(f"phase16 qwen3_moe_30b_a3b, {zero['layers']} layers over "
        f"{EP_RANKS} cards "
        f"(EP, (1, {EP_RANKS}) mesh): {zero['params_on_card']} params fp32 "
        f"a card ({zero['replicated_params']} replicated, alike on every "
        f"rank by an all-reduced checksum); spawn to end wall_s={t:.1f}")
    for r in ranks:
        log(f"phase16 rank {r['rank']} ({r['device']}): scoring B,S="
            f"{EP_SCORE_BS} warm wall_s={r['warm_s']:.4f} tokens_per_s="
            f"{r['tokens_per_s']:.1f} (first call {r['first_call_s']:.4f} s)"
            f" launches={json.dumps(r['launches'])} all-to-alls "
            f"{r['a2a']['count']} ({r['a2a']['bytes_each']} bytes each) in "
            f"{r['a2a']['ms']:.3f} ms; peak_device_bytes={r['peak_bytes']} "
            f"of {r['total_bytes']}; logits bitwise equal across ranks: "
            f"{r['logits_bitwise_equal_across_ranks']}; {r['checked']}")
    log(f"phase16 rank 0 {zero['device_split']}")
    log(f"phase16 EP vs one card: {json.dumps(zero['ep_vs_one_card'])}")
    from repro_torch.parallel.pipeline import pipeline_bubble_fraction
    log(f"phase16 pipeline: {json.dumps(zero['pipeline'])} "
        f"bubble_fraction={pipeline_bubble_fraction(PIPE_STAGES, PIPE_MICRO)}"
        f" (every rank: {[round(r['pipeline_s'], 4) for r in ranks]} s)")
    log(f"phase16 data parallel: {json.dumps(dp)}; spawn to end "
        f"wall_s={t_dp:.1f}")
    return [zero["gmm_row"]]


# ---------------------------------------------------------------------------
# phase 17: one production rank's step, the dry run's prediction against
# the card
# ---------------------------------------------------------------------------

#: a cell runs on the card if the dry run's predicted executed peak of
#: rank 0 is under this (the card holds 80 GB; the rest is room for the
#: caching allocator and the launch checks)
DRYRUN_LIMIT = 70e9
#: the flash cell is the first of these whose prediction fits, the
#: prefill cells first (a train_4k rank's 16 rows of 4,096 tokens hold
#: the plain attention backward's S x S scores); the gmm cell is this one
DRYRUN_FLASH_SHAPES = ("prefill_32k", "train_4k")
DRYRUN_GMM_CELL = ("qwen3_moe_30b_a3b", "decode_32k")
#: rows of each launch held to the plain version: the first and the last
#: DRYRUN_ROWS query rows of every flash launch (the last see every key),
#: the first and the last DRYRUN_ROWS rows of every expert of every gmm
#: launch (each row of a product is independent)
DRYRUN_ROWS = 128


def flash_rows(q, k, v, r0: int, causal=True, window=None, softcap=None):
    """``attention_ref``'s output rows ``r0:`` for queries ``q`` (those
    rows only) against keys and values ``k``, ``v`` of positions
    ``0 .. r0 + len(q) - 1``: the plain version's arithmetic, offset."""
    import math
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    logits = logits / math.sqrt(hd)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(r0, r0 + Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


class RankWatch:
    """Wraps the flash and gmm bindings for phase 17: keeps a copy of each
    kernel's first call and holds every launch's first and last
    DRYRUN_ROWS rows to the plain version on the same inputs (FLASH_TOL,
    GMM_ATOL); a launch outside tolerance raises."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.moe_gmm import kernel as gk
        self.first, self.checked = {}, {}
        self._orig = [(fk, "flash_attention_fwd", fk.flash_attention_fwd),
                      (gk, "gmm", gk.gmm)]
        fk.flash_attention_fwd = self._wrap("flash_attention",
                                            fk.flash_attention_fwd)
        gk.gmm = self._wrap("gmm", gk.gmm)

    def _pairs(self, name, got, args, kw):
        from repro_torch.kernels.flash_attention import ref as fr
        from repro_torch.kernels.moe_gmm import ref as gr
        R = DRYRUN_ROWS
        if name == "gmm":
            x, w = args
            for rows in (slice(0, R), slice(max(0, x.shape[1] - R), None)):
                want = gr.gmm_ref(x[:, rows], w)
                yield got[:, rows], want, gmm_tol(args, want)
            return
        q, k, v = args
        S = q.shape[1]
        r0 = max(0, S - R)
        yield got[:, :R], fr.attention_ref(
            q[:, :R], k[:, :R], v[:, :R], **kw), FLASH_TOL[q.dtype]
        yield got[:, r0:], flash_rows(q[:, r0:], k, v, r0, **kw), \
            FLASH_TOL[q.dtype]

    def _wrap(self, name, real):
        def watched(*args, **kw):
            if name not in self.first:
                self.first[name] = (tuple(a.clone() for a in args), kw)
            got = real(*args, **kw)
            n, err = self.checked.get(name, (0, 0.0))
            for g, want, (atol, rtol) in self._pairs(name, got, args, kw):
                torch.testing.assert_close(
                    g.float(), want.float(), atol=atol, rtol=rtol,
                    msg=lambda m: f"phase17 {name} launch {n}: {m}")
                err = max(err, float((g.float() - want.float()).abs()
                                     .max()))
            self.checked[name] = (n + 1, err)
            return got
        return watched

    def restore(self):
        for mod, attr, real in self._orig:
            setattr(mod, attr, real)


def first_launch_times(first: dict) -> dict:
    """Each kernel's first launch (RankWatch) timed alone: its device time,
    bound and library call."""
    out = {}
    for name, (a, kw) in first.items():
        mod, attr, _, work, _, lib_of, _ = model_kernels()[name]
        kern = getattr(mod, attr)
        lib = lib_of(a, kw)
        b_ms, b_by, n_bytes, n_ops = work(*a, **kw)
        out[name] = {
            "shapes": [list(t.shape) for t in a], "bytes": n_bytes,
            "operations": n_ops,
            "ms": device_ms(lambda: kern(*a, **kw), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else device_ms(
                lib, reps=5, warmup=1)}
    return out


def dryrun_cells() -> list:
    """Phase 17's cells: the dry run's prediction of rank 0 (16x16 mesh)
    for each candidate in turn, the first flash cell and the gmm cell
    whose predicted executed peak is under DRYRUN_LIMIT."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import run_cell
    picked = []
    for todo in ([(a, s) for s in DRYRUN_FLASH_SHAPES for a in ARCHS],
                 [DRYRUN_GMM_CELL]):
        for arch, shape in todo:
            pred, t = timed(lambda: run_cell(arch, shape, multi_pod=False))
            peak = pred["memory"]["executed_peak_bytes_per_device"]
            log(f"phase17 prediction {arch} x {shape}: executed peak "
                f"{peak} bytes ({'fits' if peak < DRYRUN_LIMIT else 'over'}"
                f" {DRYRUN_LIMIT:.0f}) in {t:.1f} s")
            if peak < DRYRUN_LIMIT:
                if (arch, shape) not in [(p["arch"], p["shape"])
                                         for p in picked]:
                    picked.append(pred)
                break
        else:
            raise AssertionError(f"phase17: no cell of {todo} fits")
    return picked


def dryrun_rank(pred: dict, cfg, seed: int, dev, smi: str) -> dict:
    """Phase 17 for one cell: rank 0's step of ``pred`` (``run_cell``'s
    result for ``cfg``) run for real on the card, on a fake process group
    of 256 ranks, at the rank's shard shapes.  A first call, under the
    dry run's FLOP counter and a ``StepRecorder(fill=True)`` (every
    collective's output written as if each rank held this one's tensor),
    with every flash and gmm launch held to its plain version: its
    launches, FLOPs (equal to the prediction's) and collectives (equal
    too).  Then each kernel's first launch timed alone, and a warm call
    (the collectives write nothing there and take no time): its device
    time by CUDA events against the roofline's bound, and its peak
    against the predicted executed peak.  Returns the line's object."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import cell_policy
    arch, shape = pred["arch"], pred["shape"]
    with dryrun.fake_world(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        policy = cell_policy(cfg, shape)
        args = dryrun.rank_inputs(cfg, shape, mesh, policy, device=dev,
                                  seed=seed)
        cache = args.get("cache")

        def step():
            if cache is not None:
                args["cache"] = cache
            return dryrun.rank_step(cfg, shape, args, mesh=mesh,
                                    policy=policy, device=dev)

        reset_launch_counts()
        watch = RankWatch()
        try:
            with dryrun.flop_counter() as counter, \
                    dryrun.StepRecorder(fill=True) as rec:
                out, t_first = timed(step)
        finally:
            watch.restore()
        launches = {k: n for k, n in launch_counts().items() if n}
        first = out[-1] if pred["kind"] == "train" else out[0]
        if not bool(torch.isfinite(first).all()):
            raise AssertionError(f"phase17 {arch} x {shape}: not finite")
        del out, first
        flops = counter.get_total_flops()
        want = pred["cost_raw"]
        if flops != want["flops"] or rec.collectives != \
                want["collectives_by_kind"]:
            raise AssertionError(
                f"phase17 {arch} x {shape}: counted {flops} FLOPs and "
                f"{rec.collectives}, predicted {want['flops']} and "
                f"{want['collectives_by_kind']}")
        checked = dict(watch.checked)
        for name in ("flash_attention", "gmm"):
            if launches.get(name, 0) != checked.get(name, (0,))[0]:
                raise AssertionError(f"phase17 {name}: {launches} launches,"
                                     f" {checked} checked")
        kernels = first_launch_times(watch.first)
        del watch
        # the warm call: the kernels' clones freed, no empty_cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step()
        b.record()
        b.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out, args, cache
    warm_s = a.elapsed_time(b) / 1e3
    mem, rl = pred["memory"], pred["roofline"]
    predicted_peak = mem["executed_peak_bytes_per_device"]
    torch.cuda.empty_cache()
    return {"card": smi, "cell": f"{arch} x {shape}", "mesh": pred["mesh"],
            "rank": 0, "layers": cfg.n_layers,
            "predicted": {"memory": mem, "roofline": rl,
                          "flops": want["flops"],
                          "collectives_by_kind": want["collectives_by_kind"]},
            "measured": {
                "peak_bytes": peak, "predicted_peak_bytes": predicted_peak,
                "peak_over_predicted": peak / predicted_peak,
                "flops": flops, "flops_equal_to_prediction": True,
                "first_call_s": t_first, "warm_step_s": warm_s,
                "bound_s": rl["bound_s"], "bound_by": rl["dominant"],
                "warm_over_bound": warm_s / rl["bound_s"],
                "collectives_by_kind": rec.collectives,
                "collective_calls": rec.calls, "launches": launches,
                "checked": {k: {"launches": n, "max_abs_err": e}
                            for k, (n, e) in checked.items()},
                "kernels": kernels}}


def phase_dryrun(seed: int, dev, smi: str) -> list:
    """Phase 17: the cells dryrun_cells picks, each through dryrun_rank
    at full width and depth; one ``{"dryrun_rank": ...}`` line each."""
    from repro_torch.configs import get_config
    lines = []
    for pred in dryrun_cells():
        res = dryrun_rank(pred, get_config(pred["arch"]), seed, dev, smi)
        print(json.dumps({"dryrun_rank": res}), flush=True)
        lines.append(res)
    launched = {k for r in lines for k in r["measured"]["launches"]}
    if not {"flash_attention", "gmm"} <= launched:
        raise AssertionError(f"phase17 launched only {launched}")
    return lines


#: --scan-times: (kernel, case, dtype, shape, from a state): zamba2's
#: scoring forward (B=2, S=4096) and its cache-filling prefill (B=4,
#: S=1024, from a state); rwkv6's scoring forward and the second segment
#: of its prefill (from a bf16 state)
SCAN_CASES = (
    ("ssd", "zamba2 scoring", torch.bfloat16, (2, 4096, 80, 64, 64), False),
    ("ssd", "zamba2 prefill h0", torch.bfloat16, (4, 1024, 80, 64, 64), True),
    ("ssd", "zamba2 scoring", torch.float32, (2, 4096, 80, 64, 64), False),
    ("wkv6", "rwkv6 scoring", torch.bfloat16, (2, 4096, 40, 64), False),
    ("wkv6", "rwkv6 prefill s0", torch.bfloat16, (4, 1024, 40, 64), True),
    ("wkv6", "rwkv6 scoring", torch.float32, (2, 4096, 40, 64), False),
)


def kernel_us(fn, calls: int = 5, cats=("kernel",)) -> list:
    """[(kernel name, grid, mean device us a call, launches a call)] of
    ``calls`` calls, from the profiler's trace (written under build/, read
    back, removed); ``cats`` adds other device events ("gpu_memcpy",
    "gpu_memset")."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # one file a process: phase 16's ranks profile at once
    path = ROOT / "build" / f"scan_times_trace.{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    sums = {}
    for e in events:
        if e.get("cat") in cats:
            key = (e["name"][:80], str(e.get("args", {}).get("grid")))
            us, k = sums.get(key, (0.0, 0))
            sums[key] = (us + e["dur"] / calls, k + 1)
    return [(n, g, round(us, 3), k / calls)
            for (n, g), (us, k) in sums.items()]


def scan_times(tag: str, profile: bool, seed: int, dev) -> None:
    """--scan-times: each of SCAN_CASES through model_kernel_row (held
    against the plain version, timed), then one JSON line."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=g, device=dev) * scale

    for kernel, case, dtype, shape, with_state in SCAN_CASES:
        if kernel == "ssd":
            B, S, H, hd, N = shape
            a = (randn(B, S, H, hd).to(dtype),
                 torch.nn.functional.softplus(randn(B, S, H)),
                 -torch.exp(randn(H) * 0.3), randn(B, S, N).to(dtype),
                 randn(B, S, N).to(dtype))
            kw = {"h0": randn(B, H, hd, N) if with_state else None}
        else:
            B, S, H, hd = shape
            a = (randn(B, S, H, hd).to(dtype), randn(B, S, H, hd).to(dtype),
                 randn(B, S, H, hd).to(dtype),
                 torch.exp(-torch.exp(randn(B, S, H, hd) * 0.5)),
                 randn(H, hd, scale=0.1))
            kw = {"s0": randn(B, H, hd, hd).to(torch.bfloat16)
                  if with_state else None}
        nums = model_kernel_row(kernel, a, kw, f"scan-times {tag} {case}")
        mod, attr = model_kernels()[kernel][:2]
        row = {"tag": tag, "kernel": kernel, "case": case,
               "dtype": str(dtype)[6:], "shape": shape, "ms": nums["ms"],
               "max_abs_err": nums["max_abs_err"], "route": mod.LAST_ROUTE,
               "plan": mod.LAST_PLAN}
        if profile:
            kern = getattr(mod, attr)
            row["kernels_us"] = kernel_us(lambda: kern(*a, **kw))
        print(json.dumps(row), flush=True)
        del a, kw
        torch.cuda.empty_cache()


#: --meta-times: (kernel, case) at the metadata path's shapes (phase 3):
#: a subtree op's wave of one small directory (W=1) and the wave that holds
#: /bulk (W=128, a million children) over 1,002,162 inode slots, and
#: planner windows (N=1,024, D=16) over the first window's 64 + 8,192
#: slots and over the largest snapshots of the replay, 4,096 + 16,384
META_CASES = (("treeagg", "first wave W=1"), ("treeagg", "/bulk wave W=128"),
              ("hintchain", "first window 64+8192"),
              ("hintchain", "late window 4096+16384"),
              ("pkval", "first call N=4704"),
              ("phash_chain", "planner window N=1024 D=16"))
META_SLOTS = 1_002_162
#: the pkval case: the probes of phase 3's first pkval call (4,704), against
#: a 2^23-slot index of ~1M keys whose mirror refreshes META_DIRTY slots
#: before each call (phase 3's refreshes send 115 a call on average)
META_PROBES = 4_704
META_DIRTY = 128
#: timed wrapper calls a case (the first 5 left out); host times on a
#: shared host spread, so each row gives the median and the least
META_CALLS = 100


def meta_columns(rng):
    """Inode hot columns shaped as phase 3's store (host arrays): a
    namespace of 217 directories and their files, then /bulk's files,
    a few cleared slots; ids are slot + 1, the root is id 1."""
    c, n_dirs, n_ns = META_SLOTS, 217, 2_162
    ids = np.arange(1, c + 1, dtype=np.int64)
    par = np.empty(c, np.int64)
    par[0] = 0
    par[1:n_dirs] = rng.integers(1, np.arange(2, n_dirs + 1))
    par[n_dirs:n_ns] = rng.integers(2, n_dirs + 1, size=n_ns - n_dirs)
    par[n_dirs:n_dirs + 16] = 5                  # a small directory
    par[n_ns:] = n_dirs                          # /bulk is the last dir
    par[rng.random(c) < 0.005] = -1              # deleted inodes
    isdir = (np.arange(c) < n_dirs) & (par >= 0)
    size = np.where(par >= 0, rng.integers(0, 1 << 20, size=c), 0)
    return ids, par, isdir, size


def meta_index(rng):
    """The inode hash index of phase 3's store, built in bulk
    (``synthetic_index``: 2^23 slots, ~1M keys, tombstones, AMBIG), and
    the slots of keys that ``set`` finds where they are (so that a write
    dirties one slot and never grows the index)."""
    from repro_torch.core.columnar import HashIndex
    (tp, tn, tv), _, _ = synthetic_index(rng, 1 << 23, 1_050_000)
    idx = HashIndex()
    idx.cap = tp.size
    idx.par, idx.nam = tp.astype(np.int32), tn.astype(np.uint32)
    idx.val = tv.astype(np.int32)
    idx.used, idx.live = int((tp != -1).sum()), int((tp >= 0).sum())
    live = rng.choice(np.flatnonzero(tp >= 0), 40 * META_DIRTY,
                      replace=False)
    found = [int(j) for j in live
             if idx._find(int(tp[j]), int(tn[j]))[0] == j]
    return idx, found


def host_top(stages, before, calls: int = 50) -> list:
    """The wrapper's host time by function, from ``cProfile`` over
    ``calls`` calls (its own overhead included): [(function, us of its own
    time a call, calls a call)] of the ten largest."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    for _ in range(calls):
        if before:
            before()
        prof.enable()
        for _, stage in stages:
            stage()
        prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats                 # type: ignore[attr-defined]
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    return [(f"{Path(f).name}:{line}({name})", round(tt / calls * 1e6, 1),
             nc / calls) for (f, line, name), (_, nc, tt, _, _) in top]


def copy_split(arrays, dev) -> dict:
    """Host us of the two ways to move a wrapper's inputs to the card and
    an output of the same size back, timed in turns in one process
    (median of 200 calls each): one pageable copy an array
    (``torch.from_numpy(a).to(dev)``) and a synchronising ``.cpu()``,
    against one packed page-locked upload (``_staging.upload_i32``) and
    one copy back into page-locked memory (``_staging.download_i32``);
    empty for a tree without the latter."""
    from repro_torch.kernels import _staging
    if not hasattr(_staging, "download_i32"):
        return {}
    out = torch.zeros(sum(a.size for a in arrays), dtype=torch.int32,
                      device=dev)
    steps = {"pageable_uploads": lambda: [torch.from_numpy(a).to(dev)
                                          for a in arrays],
             "packed_upload": lambda: _staging.upload_i32(arrays, dev),
             "pageable_copy_back": lambda: out.cpu().numpy(),
             "pinned_copy_back": lambda: _staging.download_i32(out)}
    times = {k: [] for k in steps}
    for _ in range(200):
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            times[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {k: statistics.median(v) * 1e6 for k, v in times.items()}


def binding_split(kern, args, tensors, launcher, c_args) -> dict:
    """Host us of the binding's steps, each timed alone (median of 200
    calls): the input checks, the output's allocation, the current stream
    (as a Stream object, and as the raw handle ``_build.launch`` takes),
    the library's lookup, the ctypes call with its launch, and the whole
    binding."""
    from repro_torch.kernels import _build
    lib = _build.library()
    fn = getattr(lib, launcher)
    stream = torch.cuda.current_stream().cuda_stream
    first = next(iter(tensors.values()))
    steps = {"checks": lambda: _build.require_cuda_int32(**tensors),
             "empty_like": lambda: torch.empty_like(first),
             "current_stream": lambda: torch.cuda.current_stream()
             .cuda_stream,
             "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                 torch.cuda.current_device()),
             "library": _build.library,
             "ctypes_launch": lambda: fn(*c_args, stream),
             "binding": lambda: kern(*args)}
    out = {}
    for name, step in steps.items():
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        out[name] = statistics.median(times) * 1e6
    return out


def meta_times(tag: str, profile: bool, seed: int, dev) -> None:
    """--meta-times: each of META_CASES through its wrapper on the card and
    on the host (equal), the kernel's device time and the wrapper's host
    time a call, then one JSON line."""
    from repro_torch.kernels.hintchain import kernel as hk, ops as ho
    from repro_torch.kernels.phash import kernel as pk, ops as po
    from repro_torch.kernels.pkval import kernel as vk, ops as vo
    from repro_torch.kernels.treeagg import kernel as tk, ops as to
    rng = np.random.default_rng(seed)
    ids, par, isdir, size = meta_columns(rng)
    host = (torch.from_numpy(ids),
            *(torch.from_numpy(a.astype(np.int32)) for a in (par, isdir,
                                                              size)))
    card_cols = tuple(t.to(dev) for t in host)
    floor = launch_floor(dev)
    if floor:
        print(json.dumps({"tag": tag, "kernel": "empty", "case": "launch "
                          "floor", "ms": floor[0], "call_ms": floor[1],
                          "round_trip_ms": floor[2]}), flush=True)
    for kernel, case in META_CASES:
        if kernel == "treeagg":
            wave = np.array([5]) if case.endswith("W=1") else np.unique(
                np.concatenate([rng.choice(np.arange(2, 217), 127,
                                           replace=False), [217]]))
            wrap = (to.treeagg_expand, (wave, *card_cols), {})
            plain = to.treeagg_expand(wave, *host)
            w_card = i32(wave, dev)
            # the binding the main path of this repro_torch launches
            launch_ = (lambda: tk.treeagg_compact(w_card, *card_cols)) \
                if hasattr(tk, "treeagg_compact") \
                else (lambda: tk.treeagg(w_card, *card_cols[1:]))
        elif kernel == "pkval":
            idx, found = meta_index(rng)
            n = META_PROBES
            pick = rng.integers(0, len(found), size=n)
            ppar = idx.par[np.array(found)[pick]].astype(np.int64)
            pnam = idx.nam[np.array(found)[pick]].astype(np.int64)
            miss = rng.random(n) < 0.1
            ppar[miss] = rng.integers(1, 1 << 30, size=int(miss.sum()))
            writes = iter(range(10**6))

            def before():                 # the writes since the last call
                for j in rng.choice(found, META_DIRTY, replace=False):
                    idx.set(int(idx.par[j]), int(idx.nam[j]),
                            2 + next(writes))

            def plain():
                host = (torch.from_numpy(idx.par),
                        torch.from_numpy(idx.nam.view(np.int32)),
                        torch.from_numpy(idx.val))
                return (vo.pkval_lookup(*host, ppar, pnam),)

            mirror = {}

            def refresh():
                mirror["t"] = idx.device_arrays(dev)

            stages = (("device_arrays", refresh),
                      ("pkval_lookup",
                       lambda: (vo.pkval_lookup(*mirror["t"], ppar, pnam),)))
            idx.device_arrays(dev)                   # the first, whole copy
            tensors = dict(zip(("tp", "tn", "tv"), idx.device_arrays(dev)))
            tensors.update(parents=i32(ppar, dev), name_hashes=i32(pnam, dev))
            b_args = tuple(tensors.values())
            out = torch.empty_like(tensors["parents"])
            c_args = (*(t.data_ptr() for t in b_args[:3]), idx.cap,
                      b_args[3].data_ptr(), b_args[4].data_ptr(),
                      out.data_ptr(), n, 8)
            launch_ = (lambda: vk.pkval(*b_args))
            split = (vk.pkval, b_args, tensors, "pkval_launch", c_args)
            moved = b_args[3:]
        elif kernel == "phash_chain":
            n, d = 1024, 16
            cpar = rng.integers(0, 1 << 32, size=(n, d))
            cnam = rng.integers(0, 1 << 32, size=(n, d))
            hints = rng.integers(0, 1 << 32, size=n)
            depths = rng.integers(1, d + 1, size=n)
            past = np.arange(d) >= depths[:, None]
            cpar[past], cnam[past] = 0, 0
            before = None
            stages = (("wrapper", lambda: po.phash_chains(
                cpar, cnam, hints, depths, 64, device=dev)),)
            plain = lambda: po.phash_chains(                # noqa: E731
                cpar, cnam, hints, depths, 64, device="cpu")
            tensors = dict(zip(("parents", "names", "hints", "depths"),
                               (i32(a, dev) for a in (cpar, cnam, hints,
                                                      depths))))
            b_args = (*tensors.values(), 64)
            out = torch.empty(n * d + 2 * n, dtype=torch.int32, device=dev)
            o = out.data_ptr()
            c_args = (*(t.data_ptr() for t in b_args[:4]), o,
                      o + 4 * n * d, o + 4 * (n * d + n), n, d, 64)
            launch_ = (lambda: pk.phash_chain(*b_args))
            split = (pk.phash_chain, b_args, tensors, "phash_chain_launch",
                     c_args)
            moved = b_args[:4]
        else:
            late = "4096" in case
            client, fallback, names, depths = synthetic_hint_tables(
                rng, 1024, n_nodes=4000 if late else 2000,
                client_max=1000 if late else 24,
                caps=(4096, 16384) if late else (64, 8192))
            wrap = (ho.hintchain_resolve, (client.arrays(),
                                           fallback.arrays(), names, depths),
                    {"device": dev})
            plain = ho.hintchain_resolve(client.arrays(), fallback.arrays(),
                                         names, depths, device="cpu")
            args = tuple(i32(a, dev) for a in (*client.arrays(),
                                                *fallback.arrays(), names,
                                                depths))
            launch_ = (lambda: hk.hintchain(*args))
        if kernel not in ("pkval", "phash_chain"):
            fn, a, kw = wrap
            stages = (("wrapper", lambda: fn(*a, **kw)),)
            before = split = None
        if before:
            before()
        for _, stage in stages:
            got = stage()
        want = plain() if callable(plain) else plain
        if len(got) != len(want) or not all(
                np.array_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"--meta-times {case}: card != host")
        ms = device_ms(launch_)
        walls = {k: [] for k, _ in stages}
        cpus = {k: [] for k, _ in stages}
        for _ in range(META_CALLS):
            if before:
                before()
            for k, stage in stages:
                t0, c0 = time.perf_counter(), time.thread_time()
                stage()
                walls[k].append(time.perf_counter() - t0)
                cpus[k].append(time.thread_time() - c0)
        totals = [sum(c) for c in zip(*walls.values())][5:]
        row = {"tag": tag, "kernel": kernel, "case": case, "ms": ms,
               "wrapper_ms": statistics.median(totals) * 1e3,
               "wrapper_min_ms": min(totals) * 1e3,
               "route": getattr(hk, "LAST_ROUTE", None)
               if kernel == "hintchain" else None}
        if len(stages) > 1:
            row["stages_ms"] = {k: statistics.median(v[5:]) * 1e3
                                for k, v in walls.items()}
        # the thread's CPU clock may tick coarsely (10 ms on a shared
        # host): the mean over the calls, not the median, estimates it
        row["wrapper_cpu_ms"] = statistics.fmean(
            [sum(c) for c in zip(*cpus.values())][5:]) * 1e3
        if split:
            kern, b_args, tensors, launcher, c_args = split
            row["call_ms"] = cuda_ms(lambda: kern(*b_args))
            row["binding_us"] = binding_split(*split)
            row["copies_us"] = copy_split(
                [t.cpu().numpy() for t in moved], dev)
        if kernel == "pkval":
            host_idx = (idx.par, idx.nam.view(np.int32), idx.val)
            if not all(torch.equal(m.cpu(), torch.from_numpy(h)) for m, h
                       in zip(idx.device_arrays(dev), host_idx)):
                raise AssertionError("--meta-times: index mirror != host")
            row["dirty_slots_a_call"] = META_DIRTY
        if profile:
            row["host_top_us"] = host_top(stages, before)
            row["kernels_us"] = kernel_us(launch_)
            row["wrapper_device_us"] = {k: kernel_us(
                lambda st=stage: (before and before(), st()), calls=1,
                cats=("kernel", "gpu_memcpy", "gpu_memset"))
                for k, stage in stages}
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bulk", type=int, default=1_000_000)
    ap.add_argument("--ops", type=int, default=20_000)
    ap.add_argument("--scan-times", action="store_true",
                    help="time the two chunked scans only")
    ap.add_argument("--meta-times", action="store_true",
                    help="time the redesigned metadata kernels only")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="with --scan-times or --meta-times: where "
                    "repro_torch is imported from")
    ap.add_argument("--tag", default="this",
                    help="with --scan-times or --meta-times: the name of "
                    "its JSON lines")
    ap.add_argument("--profile", action="store_true",
                    help="with --scan-times or --meta-times: each call's "
                    "CUDA kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
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
    if args.scan_times:
        scan_times(args.tag, args.profile, args.seed, dev)
        return 0
    if args.meta_times:
        meta_times(args.tag, args.profile, args.seed, dev)
        return 0
    for line in str(_build.build_info["log"]).splitlines():
        if "registers" in line or "spill" in line or "C75" in line:
            log(f"  ptxas: {line.strip()}")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               _build.build_info["path"]],
                              capture_output=True, text=True,
                              timeout=300).stdout
        log(f"build: {sass.count('HGMMA')} HGMMA (wgmma) instructions in "
            f"the library's SASS")

    # -- phase 2 -----------------------------------------------------------
    floor = phase_kernels(args.seed, dev)

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
    in_kernels = sum(t for _, t, _ in rec.host_s.values())
    log("phase3 host time in kernel wrappers: " + ", ".join(
        f"{k} {n} calls {t:.4f} s" for k, (n, t, _) in rec.host_s.items())
        + f"; {in_kernels:.4f} s of {wall:.3f} s trace+du+batch wall "
        f"({100 * in_kernels / wall:.2f}%); treeagg_expand calls with "
        f">= {BIG_WAVE} children: {rec.big_waves[0]} calls "
        f"{rec.big_waves[1]:.4f} s")
    log("phase3 wrapper wall vs thread CPU: " + ", ".join(
        f"{k} wall={t:.4f} cpu={c:.4f} waited={t - c:.4f} s"
        for k, (n, t, c) in rec.host_s.items())
        + f"; hash index refreshes {rec.dirty[0]}, dirty slots sent "
        f"{rec.dirty[1]} (most {rec.dirty[2]})")
    log(f"phase3 launches: {json.dumps(launches)} peak_device_bytes="
        f"{torch.cuda.max_memory_allocated()}")
    missing = [k for k in REPLACES if launches[k] < 1]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if len(rec.hint_routes) != launches["hintchain"] \
            or set(rec.hint_routes) != {"smem"}:
        raise AssertionError(f"hintchain routes on the main path: "
                             f"{rec.hint_routes}, not all smem")
    log(f"phase3 hintchain routes: {len(rec.hint_routes)} launches, all "
        f"smem; client + fallback slots a launch: "
        + ", ".join(f"{c}+{f}" for c, f in rec.hint_slots))

    # kernels vs plain on the main path's own inputs
    from repro_torch.kernels.hintchain import kernel as hk
    rows = []
    for name, (kern, plain, work, binding) in kernel_pairs().items():
        a, kw = rec.calls[binding]
        got, want = first_call(name, kern, plain, a, kw)
        ms = device_ms(lambda: kern(*a, **kw))
        call_ms = cuda_ms(lambda: kern(*a, **kw))
        plain_ms = cuda_ms(lambda: plain(*a, **kw), reps=5, warmup=1)
        b_ms, b_by, n_bytes, n_ops = work(*a, **kw)
        shapes = [tuple(t.shape) for t in a if torch.is_tensor(t)]
        extra = f" route={hk.LAST_ROUTE}" if name == "hintchain" else ""
        if floor and name in LATENCY_CHAIN:
            trips = LATENCY_CHAIN[name]
            extra += (f" latency_bound_ms={floor[0] + trips * floor[2]:.6f}"
                      f" (launch floor + {trips} round trip)")
        log(f"phase3 {name}: first main-path call shapes={shapes} "
            f"bit-equal ms={ms:.6f} call_ms={call_ms:.6f} "
            f"plain_ms={plain_ms:.6f} bound_ms={b_ms:.6f} "
            f"({b_by}; bytes={n_bytes} ops={n_ops}){extra}")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "path": "metadata request path (phase 3)",
                     "launches": launches[name],
                     "max_abs_err": max_abs_err(got, want), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    rec.calls.clear()

    # -- phase 4 -----------------------------------------------------------
    # the same run on the host, plain versions: equal in every byte
    host = drive(True, args.bulk, args.ops, torch.device("cpu"))
    differ = replay_differences(col, host)
    if differ:
        raise AssertionError("card run (first) != host run (second): "
                             + "; ".join(differ))
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
    del oracle, canon
    # what phase 11 is held to: phase 3's outcomes, and its tables once
    # quiesced
    ops3, *rest3 = outcomes(col, physical=False)
    quiesce(col["cluster"])
    phase3 = dict(ops=ops3, rest=tuple(rest3),
                  canon=canonical_state(col["store"], skip=FAILOVER_SKIP))
    del col

    # -- phases 5 to 7 -----------------------------------------------------
    t5 = time.perf_counter()
    phase_model_kernels(args.seed, dev)
    t6 = time.perf_counter()
    model_rows, params = phase_model(args.seed, dev)
    rows += model_rows
    t7 = time.perf_counter()
    phase_host("zamba2_2_7b", params, HOST_LAYERS, args.seed, dev, "phase7")
    del params
    torch.cuda.empty_cache()

    # -- phases 8 to 10 ----------------------------------------------------
    t8 = time.perf_counter()
    gmm_row = phase_new_kernels(args.seed, dev)
    t9 = time.perf_counter()
    wkv_rows, params = phase_rwkv(args.seed, dev)
    rows += wkv_rows + [gmm_row]
    t10 = time.perf_counter()
    phase_host("rwkv6_3b", params, RWKV_HOST_LAYERS, args.seed, dev,
               "phase10")
    del params

    # -- phase 11 ----------------------------------------------------------
    t11 = time.perf_counter()
    phase_failover(args, dev, phase3)

    # -- phases 12 and 13 --------------------------------------------------
    t12 = time.perf_counter()
    rows += phase_moe(args.seed, dev)
    t13 = time.perf_counter()
    phase_families(args.seed, dev)

    # -- phases 14 and 15 --------------------------------------------------
    t14 = time.perf_counter()
    train_row, train = phase_train(args.seed, dev)
    rows.append(train_row)
    t15 = time.perf_counter()
    train["paths"] = phase_train_paths(args.seed, dev)

    # -- phase 16 ----------------------------------------------------------
    t16 = time.perf_counter()
    phase_mesh(args.seed, dev)
    rows += phase_mesh4(args.seed)

    # -- phase 17 ----------------------------------------------------------
    t17 = time.perf_counter()
    phase_dryrun(args.seed, dev, smi)
    t_end = time.perf_counter()
    log(f"phase5_s={t6 - t5:.1f} phase6_s={t7 - t6:.1f} "
        f"phase7_s={t8 - t7:.1f} phase8_s={t9 - t8:.1f} "
        f"phase9_s={t10 - t9:.1f} phase10_s={t11 - t10:.1f} "
        f"phase11_s={t12 - t11:.1f} phase12_s={t13 - t12:.1f} "
        f"phase13_s={t14 - t13:.1f} phase14_s={t15 - t14:.1f} "
        f"phase15_s={t16 - t15:.1f} phase16_s={t17 - t16:.1f} "
        f"phase17_s={t_end - t17:.1f}")
    log(f"total_s={t_end - t_start:.1f}")
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
