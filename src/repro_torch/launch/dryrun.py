"""Production-mesh dry run and roofline, the JAX package's
``repro.launch.dryrun`` in PyTorch, with the H100's constants.

For one (architecture x input shape) cell on the 16x16 mesh (256 ranks)
or the 2x16x16 mesh (512 ranks, ``--multipod``):

  1. **the traced step** (the reference's compile proof).  This process is
     rank 0 of a fake process group of the mesh's size
     (``torch.testing._internal.distributed.fake_pg``: every collective
     returns at once and writes nothing), made here unless a default
     group exists, and destroyed again; importing this module touches no
     process group.  ``launch.mesh.make_production_mesh(device_type=
     "cpu")`` builds the mesh over it.  Rank 0's whole step, train
     (params and AdamW state updated in place: the reference donates
     them), prefill or decode (the cache handed over: the reference
     donates it), runs at full depth and width under ``FakeTensorMode``:
     tensors with shapes and no data, so nothing is computed and no card
     is touched, as the reference's dry run touches no TPU.  Its inputs
     are this rank's shards as the port executes them
     (:func:`rank_inputs`): every dense leaf replicated, the experts split
     over `model` (``models.moe.moe_pspecs``), the batch's rows and the
     cache's split over the batch's mesh axes.  The kernels
     (flash attention, gmm, the SSD and WKV scans) are dispatcher ops
     (``kernels.*.ops``): under the trace each gives its output's shape,
     as the kernel allocates it, and nothing of its plain version runs.
  2. **memory** (the reference's ``memory_analysis()``), bytes a device:
       * ``argument_bytes_per_device``, ``output_bytes_per_device`` and
         ``alias_bytes_per_device`` are of the REFERENCE's layout: each
         leaf's local shard under ``parallel.sharding.param_pspecs`` of
         the cell's policy (FSDP, heads, MLP and vocab over `model`),
         XLA's ceil-division where a dimension does not divide, summed
         as XLA sums them; the outputs in their inputs' layout (the
         loss, the logits and the caches by their logical axes), the
         aliases the donated arguments that the step returns;
       * ``temp_bytes_per_device`` is the PORT's own: the peak of the
         bytes that rank 0's traced step holds beyond its arguments (each
         storage counted from the op that makes it until it is freed);
       * ``executed_peak_bytes_per_device``: the port's arguments (its
         layout: dense leaves replicated) plus that peak, what rank 0
         needs on its card, against 80 GB.
  3. **cost**: ``torch.utils.flop_counter.FlopCounterMode`` over the
     traced step gives ``per_device["flops"]`` (``cost_raw["flops"]``
     with ``--fast``).  Eager tracing visits every layer, so the count is
     at full depth; the reference's depth extrapolation (its cost
     analysis visits a loop body once) stays as :func:`_derive_depth`,
     :func:`_period` and :func:`_extrap`, which the tests hold equal to
     the full-depth count where the stack is homogeneous.  The mode
     counts matmul-class operations only (XLA counts every operation), so
     the count and ``useful_ratio`` are the port's own, not the
     reference's.  A kernel counts what its plain version counts
     (``kernels.count_as_plain``): flash attention the whole ``S x S``
     product, no causal skip.
  4. **collectives**: every collective that rank 0's step issues, by the
     reference's kind names (``all-reduce``, ``all-to-all``, ...), summed
     result bytes, counted once a call (:class:`StepRecorder`).  They are
     the port's own: the MoE routes' all-to-alls (EP) and all-reduces
     (TP), the data-parallel gradient all-reduce, the clip norm's
     all-reduce; not GSPMD's.  Recorded as ``collectives_by_kind`` and,
     weighted by :func:`weighted_collective_bytes`,
     ``collective_bytes_recorded``.
  5. **roofline**: compute from the counted FLOPs (``--fast``: the model
     FLOPs, ``6 N D`` train, ``2 N D`` inference, a lower bound), memory
     and collective terms from ``launch.analytic`` (the kernelized HBM
     bytes and the analytic collective bytes, as in the reference), each
     over one H100's rate (:data:`PEAK_FLOPS`, :data:`HBM_BW`,
     :data:`ICI_BW`).  ``ICI_BW`` keeps the reference's name for the link:
     NVLink 4 in one direction.  The 16-wide `model` axis spans two
     8-GPU nodes; this term models a single NVLink domain and prices no
     InfiniBand hop.

The reference's ``bytes_hlo_upper``, ``memory_s_hlo_upper``,
``collective_bytes_hlo`` and ``collective_s_hlo_upper`` come from XLA's
HLO and have no counterpart here.

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(the reference's ``results/dryrun/`` is its own).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_moe_30b_a3b \\
      --shape decode_32k [--fast]
  python -m repro_torch.launch.dryrun --all [--multipod] [--fast]
      [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, LONG_CONTEXT_OK, SHAPES, cells, get_config
from ..models import init_params, param_specs
from ..models.config import ModelConfig
from ..models.moe import moe_pspecs
from ..models.params import ParamSpec, axes_tree, tree_leaves
from ..parallel.sharding import MeshPolicy, logical_to_pspec, mesh_shape
from ..train.optimizer import adamw_init
from ..train.step import (_batch_groups, decode_step_fn, prefill_step_fn,
                          train_step_fn)
from .analytic import analytic_bytes, analytic_collective_bytes
from .inputs import batch_axes, batch_specs, cache_abstract, cell_policy
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# NVIDIA H100 SXM5 (data sheet; dense, no sparsity), the roofline's
# denominators
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
ICI_BW = 450e9               # NVLink 4, bytes/s per card in one direction
                             # (900 GB/s both ways); one NVLink domain


# ---------------------------------------------------------------------------
# collectives and memory of a step (the reference parses its HLO)
# ---------------------------------------------------------------------------

#: c10d ops -> the reference's kind names
_KINDS = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "reduce_scatter_tensor_coalesced_": "reduce-scatter",
          "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
          "send": "collective-permute", "recv_": "collective-permute"}
def _tensors(x: Any) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: ops that read a tensor's shape and not its values
_SHAPE_ONLY = ("zeros_like", "empty_like", "ones_like", "full_like",
               "new_zeros", "new_empty", "new_ones", "new_full")


class StepRecorder(TorchDispatchMode):
    """A dispatch mode over one step of this rank: the result bytes of
    each collective by kind, the live bytes of the storages the step
    makes (their peak), and the storages whose values some op reads (a
    view, ``zeros_like`` or a query of the device reads none).
    :meth:`hold` marks the arguments' storages, which are not counted.

    With ``fill`` (a step run on the card over the fake group, which
    writes no collective's output) each collective's output is written as
    if every rank of its group held this rank's tensor: an all-reduce
    (sum) gives ``size`` times the tensor, an all-to-all this rank's own
    chunk from every source; so every value the step computes is finite.
    Any other collective then raises."""

    def __init__(self, fill: bool = False) -> None:
        super().__init__()
        self.fill = fill
        self.collectives: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.live = self.peak = 0
        self.read: set = set()
        self._seen: Dict[int, Any] = {}

    def hold(self, tree: Any) -> int:
        """Marks the storages of ``tree``'s tensors as there before the
        step; returns their bytes, each storage once."""
        total = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._seen:
                self._seen[st._cdata] = None
                total += st.nbytes()
        return total

    def _release(self, key: int, n: int) -> None:
        self._seen.pop(key, None)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = weakref.finalize(st, self._release, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func._opname not in _SHAPE_ONLY and \
                func.namespace != "prim":           # prim.device, ...
            self.read.update(t.untyped_storage()._cdata
                             for t in _tensors((args, kwargs)))
        if func.namespace == "c10d" and func._opname in _KINDS:
            self._collective(func._opname, args)
        for t in _tensors(out):
            self._track(t)
        return out

    def _collective(self, name: str, args: tuple) -> None:
        kind = _KINDS[name]
        result = _tensors(args[0])               # every kind's result
        self.collectives[kind] = self.collectives.get(kind, 0.0) + float(
            sum(_nbytes(t) for t in result))
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if not self.fill:
            return
        import torch.distributed as dist
        group = dist.ProcessGroup.unbox(
            args[2] if name == "alltoall_base_" else args[1])
        size, me = group.size(), group.rank()
        if name == "allreduce_":
            for t in result:
                t.mul_(size)
        elif name == "alltoall_base_":
            out, inp = args[0], args[1]
            if args[3] or args[4]:
                raise NotImplementedError("StepRecorder(fill=True): an "
                                          "all-to-all with split sizes")
            out.view(size, -1).copy_(inp.reshape(size, -1)[me])
        else:
            raise NotImplementedError(f"StepRecorder(fill=True): {name}")


# ---------------------------------------------------------------------------
# collective-bytes weighting
# ---------------------------------------------------------------------------


def weighted_collective_bytes(per_kind: Dict[str, float]) -> float:
    """Bytes actually moved per chip: ring all-reduce moves ~2x its payload,
    ag/rs/a2a/permute ~1x."""
    w = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}
    return sum(v * w.get(k, 1.0) for k, v in per_kind.items())


# ---------------------------------------------------------------------------
# depth extrapolation (the reference's; kept for its equality with the
# full-depth count)
# ---------------------------------------------------------------------------


def _derive_depth(cfg: ModelConfig, L: int, seq: int) -> ModelConfig:
    """Reduced-depth, full-width variant for the cost-extrapolation
    compiles: layers unrolled, inner scans unrolled, attention tiles sized
    so long-sequence HLO stays bounded (~16 q-blocks)."""
    kw: Dict[str, Any] = {"n_layers": L, "scan_layers": False,
                          "unroll_scans": True,
                          "attn_block_q": max(512, seq // 16),
                          "attn_block_k": max(512, min(seq // 16,
                                                       cfg.sliding_window or
                                                       seq))}
    if cfg.family == "encdec":
        kw["n_enc_layers"] = L
        kw["n_dec_layers"] = L
    return cfg.derive(**kw)


def _period(cfg: ModelConfig) -> int:
    if cfg.global_interval:
        return cfg.global_interval
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        return cfg.shared_attn_every
    return 1


def _extrap(v1: float, v2: float, reps: int) -> float:
    """total(L) = F(P) + (L/P - 1) * (F(2P) - F(P)), from the counts at
    depths P and 2P (``reps`` = L / P)."""
    d = v2 - v1
    if d <= 0:
        # XLA CSE/DCE across the duplicated layers can make the 2P-depth
        # compile cheaper per layer than P-depth; fall back to the
        # per-period average of the deeper compile
        return (v2 / 2.0) * (reps + 1)
    return v1 + (reps - 1) * d


# ---------------------------------------------------------------------------
# rank 0's step
# ---------------------------------------------------------------------------


@contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks,
    unless a default group exists (then it is used as it is); a group
    made here is destroyed on exit."""
    import torch.distributed as dist
    made = not dist.is_initialized()
    if made:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def _local(shape: tuple, axes: tuple, split: Dict[str, int]) -> tuple:
    """``shape`` with each dimension whose logical axis is in ``split``
    divided by its count (exactly: the port cuts only what divides)."""
    out = []
    for n, ax in zip(shape, axes):
        k = split.get(ax, 1)
        if n % k:
            raise ValueError(f"dimension {n} ({ax}) does not split {k} ways")
        out.append(n // k)
    return tuple(out)


def rank_inputs(cfg: ModelConfig, shape_name: str, mesh: Any,
                policy: MeshPolicy, *, kv_len_override: Optional[int] = None,
                device: Any = "cpu", seed: int = 0) -> Dict[str, Any]:
    """This rank's arguments of the cell's step, as the port executes
    them: ``params`` (fp32, every dense leaf whole, the experts' slices of
    ``moe_pspecs``; ``init_params`` from ``seed``), ``opt_state``
    (train), ``batch`` (its rows: tokens and labels uniform over the
    vocabulary, embeddings normal), ``cache`` (zeros, its rows) and
    ``index`` (decode: the cache's last position).  Under
    ``FakeTensorMode`` every tensor is fake."""
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    sizes = mesh_shape(mesh)
    specs = param_specs(cfg)
    pspecs = moe_pspecs(axes_tree(specs), cfg, mesh)

    def cut(s: ParamSpec, spec: tuple) -> ParamSpec:
        shape = tuple(n // (sizes[e] if e else 1)
                      for n, e in zip(s.shape, tuple(spec) + (None,) * (
                          len(s.shape) - len(spec))))
        return dataclasses.replace(s, shape=shape)

    def walk(t: Any, p: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v, p[k]) for k, v in t.items()}
        return cut(t, p)

    g = torch.Generator(device=device).manual_seed(seed)
    params = init_params(walk(specs, pspecs), g, device=device)
    rows = {"batch": _batch_groups(policy, mesh)[1]}
    batch = {}
    for name, meta in batch_specs(cfg, shape_name).items():
        shape = (meta.shape[0] // rows["batch"],) + tuple(meta.shape[1:])
        if name == "positions":
            pos = torch.arange(shape[1], device=device, dtype=torch.int32)
            batch[name] = pos[None, :, None].expand(shape).contiguous()
        elif meta.dtype == torch.int32:
            batch[name] = torch.randint(0, cfg.vocab_size, shape, generator=g,
                                        device=device, dtype=torch.int32)
        else:
            batch[name] = torch.randn(shape, generator=g, device=device,
                                      dtype=meta.dtype)
    out: Dict[str, Any] = {"params": params, "batch": batch}
    if kind == "train":
        out["opt_state"] = adamw_init(params)
    else:
        c_abs, c_axes = cache_abstract(cfg, shape_name,
                                       kv_len=kv_len_override
                                       if kind == "decode" else None)
        out["cache"] = {k: torch.zeros(_local(tuple(v.shape), c_axes[k],
                                              rows),
                                       dtype=v.dtype, device=device)
                        for k, v in c_abs.items()}
        if kind == "decode":
            out["index"] = (kv_len_override or sh["seq"]) - 1
    return out


def rank_step(cfg: ModelConfig, shape_name: str, args: Dict[str, Any], *,
              mesh: Any, policy: MeshPolicy, microbatches: int = 1,
              device: Any = "cpu") -> Any:
    """This rank's step of the cell on :func:`rank_inputs`' ``args``,
    through the kernels (``use_kernels``).  A serving step takes the cache
    out of ``args`` (the reference donates it); a train step updates
    ``params`` and ``opt_state`` in place (it donates them)."""
    kind = SHAPES[shape_name]["kind"]
    kw = dict(cfg=cfg, policy=policy, mesh=mesh, use_kernels=True,
              device=device)
    if kind == "train":
        return train_step_fn(args["params"], args["opt_state"],
                             args["batch"], microbatches=microbatches, **kw)
    if kind == "prefill":
        return prefill_step_fn(args["params"], args["batch"],
                               args.pop("cache"), **kw)
    return decode_step_fn(args["params"], args["batch"], args.pop("cache"),
                          args["index"], **kw)


def flop_counter():
    """A ``FlopCounterMode`` that knows the kernels' formulas: it copies
    the registry when made, and the models import the kernels' ops (which
    register them) at their first call."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels.flash_attention import ops as _fa  # noqa: F401
    from ..kernels.mamba2_ssd import ops as _ssd  # noqa: F401
    from ..kernels.moe_gmm import ops as _gmm  # noqa: F401
    from ..kernels.rwkv6_scan import ops as _wkv  # noqa: F401
    return FlopCounterMode(display=False)


def lower_cell(cfg: ModelConfig, shape_name: str, mesh: Any,
               policy: MeshPolicy, *, microbatches: int = 1,
               kv_len_override: Optional[int] = None) -> Dict[str, Any]:
    """Rank 0's whole step traced under ``FakeTensorMode`` (module
    docstring): its counted FLOPs, collectives by kind (result bytes and
    calls), its arguments' bytes as executed and the peak of the bytes it
    holds beyond them, and the paths of the argument leaves whose values
    it never reads (``jax.jit`` drops those arguments: ``keep_unused``
    is False)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = rank_inputs(cfg, shape_name, mesh, policy,
                           kv_len_override=kv_len_override)
        rec = StepRecorder()
        arg_bytes = rec.hold(args)
        keys = {path: t.untyped_storage()._cdata for path, t in _paths(args)}
        with flop_counter() as counter, rec:
            out = rank_step(cfg, shape_name, args, mesh=mesh, policy=policy,
                            microbatches=microbatches)
        del out
        unread = {path for path, key in keys.items() if key not in rec.read}
    return {"flops": counter.get_total_flops(),
            "collectives": dict(rec.collectives), "calls": dict(rec.calls),
            "argument_bytes": arg_bytes, "temp_bytes": rec.peak,
            "unread": unread}


def _paths(tree: Any, prefix: tuple = ()) -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [(prefix, tree)] if torch.is_tensor(tree) else []


# ---------------------------------------------------------------------------
# the reference's layout (memory_analysis)
# ---------------------------------------------------------------------------


def _layout_bytes(shape: tuple, axes: tuple, itemsize: int,
                  policy: MeshPolicy, mesh: Any) -> int:
    """One leaf's shard under the reference's sharding of ``axes``,
    XLA's ceil-division where a dimension does not divide."""
    spec = logical_to_pspec(axes, policy, mesh)
    sizes = mesh_shape(mesh)
    n = itemsize
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        n *= -(-dim // math.prod(sizes[a] for a in names))
    return n


def reference_layout(cfg: ModelConfig, shape_name: str, mesh: Any,
                     policy: MeshPolicy,
                     kv_len_override: Optional[int] = None,
                     unread: frozenset = frozenset()) -> Dict[str, int]:
    """``argument``, ``output`` and ``alias`` bytes a device of the
    reference's step under ``policy``: fp32 parameters (and AdamW
    moments, an int32 step), the batch, the cache (bf16 KV), decode's
    int32 index, less the leaves at the paths in ``unread`` (the step
    reads only their shapes: ``jax.jit`` drops them, so they are neither
    arguments nor aliased; a prefill's cache); the outputs the donated
    trees, the loss (fp32) or the logits (the reference's dtype, by
    ``("batch", "seq", "vocab")``) and the cache."""
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    specs = param_specs(cfg)
    p = sum(_layout_bytes(s.shape, s.axes, 4, policy, mesh)
            for s in tree_leaves(specs))
    b_axes = batch_axes(cfg, shape_name)
    batch = sum(_layout_bytes(tuple(v.shape), b_axes[k], v.element_size(),
                              policy, mesh)
                for k, v in batch_specs(cfg, shape_name).items()
                if ("batch", k) not in unread)
    if kind == "train":
        donated = 3 * p + 4                     # params, mu, nu, step
        return {"argument": donated + batch, "output": donated + 4,
                "alias": donated}
    c_abs, c_axes = cache_abstract(cfg, shape_name, kv_len=kv_len_override
                                   if kind == "decode" else None)
    cache = {k: _layout_bytes(tuple(v.shape), c_axes[k], v.element_size(),
                              policy, mesh) for k, v in c_abs.items()}
    read = sum(n for k, n in cache.items() if ("cache", k) not in unread)
    logits = _layout_bytes((sh["batch"], 1, cfg.vocab_size),
                           ("batch", "seq", "vocab"),
                           getattr(torch, cfg.dtype).itemsize, policy, mesh)
    index = 4 if kind == "decode" else 0
    return {"argument": p + batch + read + index,
            "output": logits + sum(cache.values()), "alias": read}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             fast: bool = False, cfg_override: Optional[ModelConfig] = None,
             policy_override: Optional[MeshPolicy] = None,
             microbatches: int = 1,
             kv_len_override: Optional[int] = None) -> Dict[str, Any]:
    """Full dry run for one cell: the traced step and the roofline.
    Overrides support the §Perf variants (launch/perf.py)."""
    t_start = time.time()
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        sizes = mesh_shape(mesh)
        n_chips = math.prod(sizes.values())
        policy = policy_override if policy_override is not None else \
            cell_policy(cfg, shape_name, model_axis=sizes["model"],
                        data_axis=sizes["data"],
                        n_pods=sizes.get("pod", 1))
        sh = SHAPES[shape_name]
        out: Dict[str, Any] = {
            "arch": arch, "shape": shape_name,
            "mesh": "x".join(str(sizes[a]) for a in mesh.mesh_dim_names),
            "kind": sh["kind"], "n_chips": n_chips,
            "policy": {"fsdp": policy.fsdp, "seq_shard": policy.seq_shard,
                       "rules": dict(policy.rules)},
        }

        # ---- 1. rank 0's traced step + memory -------------------------
        step = lower_cell(cfg, shape_name, mesh, policy,
                          microbatches=microbatches,
                          kv_len_override=kv_len_override)
        ref = reference_layout(cfg, shape_name, mesh, policy,
                               kv_len_override, step["unread"])
    out["memory"] = {
        "argument_bytes_per_device": ref["argument"],
        "output_bytes_per_device": ref["output"],
        "temp_bytes_per_device": step["temp_bytes"],
        "alias_bytes_per_device": ref["alias"],
        "executed_peak_bytes_per_device":
            step["argument_bytes"] + step["temp_bytes"],
    }
    coll = step["collectives"]
    out["cost_raw"] = {"flops": step["flops"],
                       "collectives_by_kind": coll,
                       "collective_calls": step["calls"]}
    out["compile_ok"] = True
    out["compile_s"] = round(time.time() - t_start, 1)

    # ---- 2. roofline ------------------------------------------------------
    ana = analytic_bytes(cfg, shape_name, policy, sizes)
    ana_coll = analytic_collective_bytes(cfg, shape_name, policy, sizes)
    n_active = cfg.active_param_count()
    tokens = sh["batch"] * (sh["seq"] if sh["kind"] != "decode" else 1)
    mult = 6 if sh["kind"] == "train" else 2
    model_flops = mult * n_active * tokens
    # fast: the compute term from MODEL flops (a lower bound, labeled)
    flops_dev = model_flops / n_chips if fast else float(step["flops"])
    terms = (("compute", flops_dev / PEAK_FLOPS),
             ("memory", ana["total"] / HBM_BW),
             ("collective", ana_coll["total"] / ICI_BW))
    dominant = max(terms, key=lambda t: t[1])
    out["roofline"] = {f"{k}_s": v for k, v in terms}
    out["roofline"].update(dominant=dominant[0], bound_s=dominant[1])
    if fast:
        out["roofline"]["analytic_only"] = True
    else:
        out["per_device"] = {"flops": flops_dev,
                             "bytes_kernelized": ana["total"],
                             "bytes_breakdown": ana,
                             "collective_bytes_recorded":
                                 weighted_collective_bytes(coll),
                             "collective_bytes_analytic": ana_coll["total"],
                             "collective_breakdown": ana_coll,
                             "collectives_by_kind": coll}
    counted_global = 0.0 if fast else flops_dev * n_chips
    out["model_flops"] = {
        "n_active_params": n_active, "tokens": tokens,
        "model_flops": model_flops,
        "counted_flops_global": counted_global,
        "useful_ratio": (model_flops / counted_global
                         if counted_global else 0.0),
        "roofline_fraction": (model_flops / n_chips / PEAK_FLOPS)
        / dominant[1] if dominant[1] else 0.0}
    out["elapsed_s"] = round(time.time() - t_start, 1)
    return out


def cell_path(arch: str, shape: str, multi_pod: bool) -> Path:
    mesh = "2x16x16" if multi_pod else "16x16"
    return RESULTS / f"{arch}__{shape}__{mesh}.json"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="analytic-only roofline (model FLOPs for compute)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    RESULTS.mkdir(parents=True, exist_ok=True)
    todo = []
    if args.all:
        for a, s, skip in cells():
            todo.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        if args.shape == "long_500k" and args.arch not in LONG_CONTEXT_OK:
            print(f"SKIP {args.arch} long_500k (pure full-attention; "
                  "see DESIGN.md §3.3)")
            return
        todo.append((args.arch, args.shape))

    n_fail = 0
    for arch, shape in todo:
        path = cell_path(arch, shape, args.multipod)
        if args.skip_existing and path.exists():
            print(f"cached {path.name}")
            continue
        try:
            res = run_cell(arch, shape, multi_pod=args.multipod,
                           fast=args.fast)
            path.write_text(json.dumps(res, indent=1))
            rl = res.get("roofline", {})
            peak = res["memory"]["executed_peak_bytes_per_device"]
            print(f"OK  {arch:22s} {shape:12s} mesh={res['mesh']:8s} "
                  f"dominant={rl.get('dominant', '-'):10s} "
                  f"peak={peak / 1e9:.2f}GB compile={res['compile_s']}s")
        except Exception as e:
            n_fail += 1
            traceback.print_exc()
            print(f"FAIL {arch} {shape}: {type(e).__name__}: {e}")
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
