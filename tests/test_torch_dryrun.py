"""The port's dry run (``launch.dryrun``) and ``launch.perf`` against the
JAX package's, on the CPU.

The reference runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (this process's
JAX sees one device): its ``run_cell(fast=True)`` on the smoke
configurations (``cfg_override``) of qwen1.5 x train_4k and qwen3-moe x
decode_32k on the 16x16 mesh and qwen3-moe x prefill_32k on the 2x16x16
mesh, its ``_period``/``_derive_depth`` for every architecture, its
``weighted_collective_bytes`` and its ``variant_overrides`` for every
variant and every cell.  The port's ``run_cell(fast=True)`` on the same
cells runs rank 0's step on a fake process group of 256 or 512 ranks
under ``FakeTensorMode``.

Held equal: the cell's names, mesh, kind, chip count and policy; the
model FLOP counts; the analytic bytes and collective bytes (each roofline
term times its constant; rtol 1e-12, the division by another constant
rounds apart); the reference layout's argument and alias bytes (the
reference's ``memory_analysis()``).  Not held equal: the output bytes
(XLA chooses the outputs' layout), the temp bytes and the counted FLOPs
(the port's own: its executed layout and ``FlopCounterMode``).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cells, get_config, \
    get_smoke_config
from repro_torch.launch import dryrun, perf

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 240
#: (arch, shape, multi_pod)
CELLS = [("qwen1_5_4b", "train_4k", False),
         ("qwen3_moe_30b_a3b", "decode_32k", False),
         ("qwen3_moe_30b_a3b", "prefill_32k", True)]
#: the reference's constants (src/repro/launch/dryrun.py)
REF_CONSTANTS = {"compute": 197e12, "memory": 819e9, "collective": 50e9}
COLL = {"all-reduce": 1234.0, "all-to-all": 56.0, "all-gather": 7.0,
        "collective-permute": 3.0, "reduce-scatter": 11.0}

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import dataclasses, json, sys
    sys.path.insert(0, %r)
    from repro.launch import dryrun, perf
    from repro.configs import ARCHS, SHAPES, cells, get_config, \\
        get_smoke_config

    out = {"cells": {}, "depth": {}, "variants": {}}
    for arch, shape, mp in %r:
        out["cells"][f"{arch}/{shape}/{mp}"] = dryrun.run_cell(
            arch, shape, multi_pod=mp, fast=True,
            cfg_override=get_smoke_config(arch))
    for arch in ARCHS:
        cfg = get_config(arch)
        p = dryrun._period(cfg)
        out["depth"][arch] = [p] + [dataclasses.asdict(
            dryrun._derive_depth(cfg, L, SHAPES[s]["seq"]))
            for L in (p, 2 * p) for s in SHAPES]
    out["weighted"] = dryrun.weighted_collective_bytes(%r)
    for variant in perf.VARIANTS:
        for arch, shape, _ in cells():
            try:
                c, pol, kw = perf.variant_overrides(variant,
                                                    get_config(arch), shape)
            except AssertionError:
                res = None
            else:
                res = [dataclasses.asdict(c), None if pol is None else
                       [pol.fsdp, pol.seq_shard, [list(r) for r in
                                                  pol.rules]], kw]
            out["variants"][f"{variant}/{arch}/{shape}"] = res
    print("RESULT", json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    r = subprocess.run([sys.executable, "-c", REFERENCE % (
        str(SRC), CELLS, COLL)], capture_output=True, text=True,
        timeout=TIMEOUT)
    line = [s for s in r.stdout.splitlines() if s.startswith("RESULT ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(line[0].split(" ", 1)[1])


def _roundtrip(x):
    """What JSON makes of ``x`` (tuples become lists)."""
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_run_cell_fast_matches_the_reference(reference, arch, shape,
                                             multi_pod):
    want = reference["cells"][f"{arch}/{shape}/{multi_pod}"]
    got = dryrun.run_cell(arch, shape, multi_pod=multi_pod, fast=True,
                          cfg_override=get_smoke_config(arch))
    assert not dist.is_initialized()          # the fake group is gone
    for k in ("arch", "shape", "mesh", "kind", "n_chips", "policy"):
        assert _roundtrip(got[k]) == want[k], k
    for k in ("n_active_params", "tokens", "model_flops"):
        assert got["model_flops"][k] == want["model_flops"][k], k
    for k in ("argument_bytes_per_device", "alias_bytes_per_device"):
        assert got["memory"][k] == want["memory"][k], k
    assert got["roofline"]["dominant"] in REF_CONSTANTS
    constants = {"compute": dryrun.PEAK_FLOPS, "memory": dryrun.HBM_BW,
                 "collective": dryrun.ICI_BW}
    for term, c in constants.items():
        np.testing.assert_allclose(
            got["roofline"][f"{term}_s"] * c,
            want["roofline"][f"{term}_s"] * REF_CONSTANTS[term],
            rtol=1e-12, err_msg=term)
    assert got["roofline"]["analytic_only"] is True
    mem = got["memory"]
    assert mem["executed_peak_bytes_per_device"] > \
        mem["temp_bytes_per_device"] > 0
    assert got["cost_raw"]["flops"] > 0


def test_collectives_of_the_traced_train_step():
    """qwen1.5's smoke train_4k cell: the batch split over `data` (16),
    so rank 0's step all-reduces the label counts, each gradient leaf and
    the loss over `data`, nothing else (dense leaves are whole on every
    rank: no clip-norm all-reduce); qwen3-moe's decode cell on the TP
    route (8 experts on 16 ranks) all-reduces its experts' output once a
    layer."""
    from repro_torch.models.params import tree_leaves
    cfg = get_smoke_config("qwen1_5_4b")
    got = dryrun.run_cell("qwen1_5_4b", "train_4k", multi_pod=False,
                          cfg_override=cfg)
    n_leaves = len(tree_leaves(dryrun.param_specs(cfg)))
    assert got["cost_raw"]["collective_calls"] == {
        "all-reduce": n_leaves + 2}
    # each leaf fp32 once, the counts (one microbatch) and the loss
    n_params = sum(int(np.prod(s.shape))
                   for s in tree_leaves(dryrun.param_specs(cfg)))
    assert got["per_device"]["collectives_by_kind"] == {
        "all-reduce": 4.0 * n_params + 8}
    assert got["per_device"]["collective_bytes_recorded"] == \
        2 * (4.0 * n_params + 8)
    assert got["per_device"]["flops"] == got["cost_raw"]["flops"]
    assert got["roofline"]["compute_s"] == \
        got["per_device"]["flops"] / dryrun.PEAK_FLOPS
    moe = get_smoke_config("qwen3_moe_30b_a3b")
    got = dryrun.run_cell("qwen3_moe_30b_a3b", "decode_32k",
                          multi_pod=False, fast=True, cfg_override=moe)
    assert got["cost_raw"]["collective_calls"] == {
        "all-reduce": moe.n_layers}


def test_period_and_derive_depth_match_the_reference(reference):
    import dataclasses
    for arch in ARCHS:
        cfg = get_config(arch)
        p = dryrun._period(cfg)
        got = [p] + [dataclasses.asdict(dryrun._derive_depth(
            cfg, L, SHAPES[s]["seq"])) for L in (p, 2 * p) for s in SHAPES]
        assert _roundtrip(got) == reference["depth"][arch], arch


@pytest.mark.parametrize("arch,shape", [
    ("qwen1_5_4b", "train_4k"), ("gemma3_12b", "prefill_32k"),
    ("zamba2_2_7b", "prefill_32k"), ("qwen3_moe_30b_a3b", "decode_32k")])
def test_depth_extrapolation_equals_the_full_depth_count(arch, shape):
    """The reference's extrapolation from depths P and 2P, on the counts
    of the port's traced step, equals the count at full depth wherever
    the stack repeats its period (each smoke stack deepened to 3P)."""
    base = get_smoke_config(arch)
    P = dryrun._period(base)
    full = base.derive(n_layers=3 * P)
    seq = SHAPES[shape]["seq"]
    with dryrun.fake_world(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        policy = dryrun.cell_policy(full, shape)
        counts = [dryrun.lower_cell(dryrun._derive_depth(full, L, seq),
                                    shape, mesh, policy)["flops"]
                  for L in (P, 2 * P, 3 * P)]
    assert counts[0] < counts[1] < counts[2]
    assert dryrun._extrap(counts[0], counts[1], 3) == counts[2]


def test_weighted_collective_bytes_matches_the_reference(reference):
    assert dryrun.weighted_collective_bytes(COLL) == reference["weighted"]


def test_variant_overrides_match_the_reference(reference):
    import dataclasses
    for variant in perf.VARIANTS:
        for arch, shape, _ in cells():
            try:
                c, pol, kw = perf.variant_overrides(variant,
                                                    get_config(arch), shape)
            except AssertionError:
                got = None
            else:
                got = [dataclasses.asdict(c), None if pol is None else
                       [pol.fsdp, pol.seq_shard, [list(r) for r in
                                                  pol.rules]], kw]
            key = f"{variant}/{arch}/{shape}"
            assert _roundtrip(got) == reference["variants"][key], key


def test_kernels_count_as_their_plain_versions():
    """``FlopCounterMode`` counts each kernel op as what it counts for
    the plain version on the same inputs (and alike under
    ``FakeTensorMode``, where the op gives only its output's shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as fa, ref as far
    from repro_torch.kernels.mamba2_ssd import ops as so, ref as sr
    from repro_torch.kernels.moe_gmm import ops as go, ref as gr
    from repro_torch.kernels.rwkv6_scan import ops as wo, ref as wr
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g)

    q, k = r(2, 70, 4, 16), r(2, 70, 2, 16)
    x, dt, A, Bc = r(2, 70, 3, 16), r(2, 70, 3).exp(), -r(3).exp(), \
        r(2, 70, 8)
    w = torch.sigmoid(r(2, 70, 3, 16))
    cases = [
        (lambda: fa.flash_attention(q, k, k, True, 32, None),
         lambda: far.attention_ref(q, k, k, causal=True, window=32)),
        (lambda: go.gmm(r(3, 20, 16), r(3, 16, 24)),
         lambda: gr.gmm_ref(r(3, 20, 16), r(3, 16, 24))),
        (lambda: so.ssd(x, dt, A, Bc, Bc, chunk=32),
         lambda: sr.ssd_ref(x, dt, A, Bc, Bc, chunk=32)),
        (lambda: wo.wkv6(x, x, x, w, r(3, 16), s0=r(2, 3, 16, 16),
                         chunk=32),
         lambda: wr.wkv6_ref(x, x, x, w, r(3, 16), s0=r(2, 3, 16, 16),
                             chunk=32)),
    ]
    for op, plain in cases:
        counts = []
        for fn in (op, plain):
            with FlopCounterMode(display=False) as c:
                fn()
            counts.append(c.get_total_flops())
        assert counts[0] == counts[1] > 0
    with FakeTensorMode():
        fq, fk = torch.empty(2, 70, 4, 16), torch.empty(2, 70, 2, 16)
        with FlopCounterMode(display=False) as c:
            out = fa.flash_attention(fq, fk, fk, True, 32, None)
    assert c.get_total_flops() == counts_of(lambda: far.attention_ref(
        q, k, k, causal=True, window=32))
    assert out.shape == q.shape


def counts_of(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def test_step_recorder_fills_collectives_and_tracks_memory():
    """On the fake group: an all-reduce's output is the group's size
    times the input, an all-to-all's this rank's own chunk from every
    source; the bytes and calls by kind; the peak of the live bytes, the
    held arguments left out; which arguments some op reads."""
    from torch.distributed.nn.functional import all_to_all_single
    with dryrun.fake_world(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        group = mesh.get_group("model")
        arg = torch.arange(32.0).reshape(16, 2)
        unread = torch.ones(1000)
        rec = dryrun.StepRecorder(fill=True)
        assert rec.hold({"a": arg, "b": [unread, arg[1:]]}) == 128 + 4000
        with rec:
            t = arg * 1.0                                    # 128 bytes
            dist.all_reduce(t, group=group)
            out = all_to_all_single(torch.empty_like(arg), arg, group=group)
            tmp = torch.zeros_like(unread)                   # 4000 bytes
            del tmp
            big = torch.zeros(3000)                          # 12000 bytes
            del big
        assert torch.equal(t, arg * 16)
        assert torch.equal(out, arg[0].expand(16, 2))  # rank 0's chunk
        assert rec.collectives == {"all-reduce": 128.0, "all-to-all": 128.0}
        assert rec.calls == {"all-reduce": 1, "all-to-all": 1}
        assert rec.peak == 128 + 128 + 12000
        assert arg.untyped_storage()._cdata in rec.read
        assert unread.untyped_storage()._cdata not in rec.read
    assert not dist.is_initialized()


def test_dryrun_and_perf_main_write_their_files(tmp_path, monkeypatch,
                                                capsys):
    assert dryrun.RESULTS.parts[-2:] == ("results", "dryrun_torch")
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(perf, "RESULTS", tmp_path)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(perf, "get_config", get_smoke_config)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "gemma3_12b",
                                      "--shape", "decode_32k"])
    dryrun.main()
    assert (tmp_path / "gemma3_12b__decode_32k__16x16.json").exists()
    monkeypatch.setattr(sys, "argv", ["perf", "--arch", "gemma3_12b",
                                      "--shape", "decode_32k", "--variant",
                                      "serve_replicated"])
    perf.main()
    out = capsys.readouterr().out
    res = json.loads((tmp_path / "gemma3_12b__decode_32k__16x16__"
                      "serve_replicated.json").read_text())
    assert res["policy"]["fsdp"] is False
    assert "baseline -> serve_replicated" in out
    for term in ("compute_s", "memory_s", "collective_s", "dominant",
                 "roofline frac"):
        assert term in out
