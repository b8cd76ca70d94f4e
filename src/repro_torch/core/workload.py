"""Industrial workload generator (paper Table 1 + §7.4).

Reproduces the Spotify HDFS trace characteristics:

  * relative op frequencies of Table 1 (reads 68.73%, stat 17%, ls 9%, ...),
    including the per-op directory/file split where the paper gives it;
  * namespace shape: average path depth 7, ~16 files + 2 subdirs per
    directory, average name length 34;
  * heavy-tailed access popularity (Yahoo: 3% of files take 80% of
    accesses) via a Zipf-like sampler.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ops_registry import REGISTRY, WorkloadOp, synthesize
from .tables import ROOT_ID

# (op, weight_pct, fraction_on_directories)
TABLE1_MIX: List[Tuple[str, float, float]] = [
    ("append",          0.0,   0.0),
    ("mkdirs",          0.02,  1.0),
    ("set_replication", 0.14,  0.0),
    ("delete",          0.75,  0.035),
    ("rename",          1.3,   0.0003),
    ("ls",              9.0,   0.945),
    ("read",            68.73, 0.0),
    ("content_summary", 0.01,  0.5),
    ("set_permissions", 0.03,  0.263),
    ("set_owner",       0.32,  1.0),
    ("create",          1.2,   0.0),
    ("add_block",       1.5,   0.0),
    ("stat",            17.0,  0.233),
]

# derived from the op registry (single source of truth for op semantics);
# the name survives for importers
READ_ONLY_OPS = REGISTRY.read_only_ops()

# Spotify operational trace mix (paper §7.2): the throughput-scaling
# experiment replays the production trace rather than the steady-state
# Table 1 mix — getBlockLocations dominates (~67%), listStatus is ~12%.
# Same (op, weight_pct, fraction_on_directories) schema as TABLE1_MIX.
SPOTIFY_TRACE_MIX: List[Tuple[str, float, float]] = [
    ("read",            67.0, 0.0),    # getBlockLocations
    ("ls",              12.0, 0.95),   # listStatus
    ("stat",            10.0, 0.25),   # getFileInfo
    ("create",           3.5, 0.0),
    ("add_block",        2.0, 0.0),
    ("delete",           1.5, 0.03),
    ("rename",           1.0, 0.0),
    ("mkdirs",           1.0, 1.0),
    ("set_permissions",  0.5, 0.25),
    ("set_owner",        0.5, 1.0),
    ("set_replication",  0.5, 0.0),
    ("content_summary",  0.3, 0.5),
    ("append",           0.2, 0.0),
]

# Write-heavy block-layer mix (ingest-shaped: the paper's Spotify trace is
# write-heavy AT THE BLOCK LAYER — every created file streams several
# blocks through addBlock/complete before readers arrive). This is the
# mix that exercises the lease-ordered grouped block-write path:
# create/add_block/complete/append dominate, reads are the minority.
# Same (op, weight_pct, fraction_on_directories) schema as TABLE1_MIX;
# "complete" records carry block_id=-1 ("last allocated block") + a
# sampled size, since block ids only exist at replay time.
WRITE_HEAVY_MIX: List[Tuple[str, float, float]] = [
    ("create",          14.0, 0.0),
    ("add_block",       24.0, 0.0),
    ("complete",        12.0, 0.0),
    ("append",           8.0, 0.0),
    ("read",            22.0, 0.0),
    ("stat",             7.0, 0.25),
    ("ls",               5.0, 0.95),
    ("mkdirs",           2.5, 1.0),
    ("set_permissions",  1.5, 0.25),
    ("set_replication",  1.5, 0.0),
    ("set_owner",        0.8, 1.0),
    ("delete",           0.7, 0.03),
    ("rename",           0.5, 0.0),
    ("content_summary",  0.5, 0.5),
]


# Adjacent-traffic mix for the big-directory scenario: what the cluster
# keeps serving NEXT TO a paced delete-subtree.  Read-heavy like the
# Spotify mix but with a visible deep-aggregation share (du +
# content_summary — the ops the treeagg kernel fuses on the columnar
# backend).  Deliberately NO subtree-mutating ops ("delete"/"rename" on
# dirs): the pace hook replays these records from inside a running
# subtree op, which must never nest another one.
# Same (op, weight_pct, fraction_on_directories) schema as TABLE1_MIX.
BIG_DIR_MIX: List[Tuple[str, float, float]] = [
    ("read",            33.0, 0.0),
    ("stat",            15.0, 0.25),
    ("ls",              13.0, 0.9),
    ("create",          12.0, 0.0),
    ("du",               8.0, 0.7),
    ("content_summary",  7.0, 0.7),
    ("mkdirs",           5.0, 1.0),
    ("set_permissions",  4.0, 0.0),
    ("set_owner",        3.0, 0.0),
]


@dataclass
class NamespaceSpec:
    """Spotify-like namespace shape (§7.4)."""
    depth: int = 7
    files_per_dir: int = 16
    dirs_per_dir: int = 2
    name_len: int = 34
    seed: int = 7


class SyntheticNamespace:
    """Builds a namespace matching the spec and serves popularity-weighted
    path samples. Paths are materialized lazily per directory level."""

    def __init__(self, spec: NamespaceSpec, *, n_dirs: int = 200,
                 files_per_dir: Optional[int] = None):
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.dirs: List[str] = []
        self.files: List[str] = []
        fpd = files_per_dir if files_per_dir is not None \
            else spec.files_per_dir
        # build a tree of depth `spec.depth` with the right fanout, capped
        # at n_dirs directories
        frontier = ["/w"]
        self.dirs.append("/w")
        depth = 1
        while len(self.dirs) < n_dirs and depth < spec.depth:
            nxt = []
            for d in frontier:
                for k in range(spec.dirs_per_dir):
                    sub = f"{d}/{self._name(depth, k)}"
                    self.dirs.append(sub)
                    nxt.append(sub)
                    if len(self.dirs) >= n_dirs:
                        break
                if len(self.dirs) >= n_dirs:
                    break
            frontier = nxt or frontier
            depth += 1
        leaf_dirs = [d for d in self.dirs]
        for d in leaf_dirs:
            for i in range(fpd):
                self.files.append(f"{d}/f{i:04d}.parquet")
        # heavy-tailed popularity: rank files by a Zipf(1.1)-ish law
        self._pop_weights = [1.0 / (r + 1) ** 1.1
                             for r in range(len(self.files))]

    def _name(self, depth: int, k: int) -> str:
        base = f"d{depth}x{k}"
        pad = max(0, self.spec.name_len - len(base) - 20)
        return base + "u" * min(pad, 8)

    def sample_file(self, rng: random.Random) -> str:
        return rng.choices(self.files, weights=self._pop_weights, k=1)[0]

    def sample_dir(self, rng: random.Random) -> str:
        return rng.choice(self.dirs)


def make_big_dir_namespace(n_children: int, *, n_side_dirs: int = 12,
                           files_per_dir: int = 4, seed: int = 7,
                           big_path: str = "/bigdir"
                           ) -> Tuple[SyntheticNamespace, str, int]:
    """Namespace plan for the big-directory scenario: a small *side*
    namespace serving adjacent traffic, plus one flat directory of
    ``n_children`` files that subtree ops target (materialize it with
    ``namenode.materialize_big_dir``).  The big dir is NOT in the side
    namespace's live path sets, so sampled adjacent ops never collide
    with the subtree lock.  Returns ``(side_ns, big_path, n_children)``."""
    ns = SyntheticNamespace(NamespaceSpec(seed=seed), n_dirs=n_side_dirs,
                            files_per_dir=files_per_dir)
    return ns, big_path, n_children


class SpotifyWorkload:
    """Stream of WorkloadOps distributed per an op mix (Table 1 by default;
    pass ``mix=SPOTIFY_TRACE_MIX`` for the §7.2 trace-replay mix).

    Op synthesis is driven by the registry's ``MIX_BINDINGS`` (this class
    only implements the sampling context protocol: ``rng``, ``live_file``,
    ``live_dir``, ``retire``, ``next_create_path``), so records carry real
    arguments — sampled perms, owners, replication factors — end-to-end
    instead of the executor hardcoding defaults."""

    def __init__(self, ns: SyntheticNamespace, seed: int = 13,
                 mix: Sequence[Tuple[str, float, float]] = TABLE1_MIX):
        self.ns = ns
        self.rng = random.Random(seed)
        self.mix = list(mix)
        self._ops = [m[0] for m in self.mix]
        self._weights = [m[1] for m in self.mix]
        self._dir_frac = {m[0]: m[2] for m in self.mix}
        self._create_seq = 0
        # liveness tracking: a real trace doesn't read files it already
        # deleted/renamed, so destructive ops retire their targets from
        # the sampling pool
        self._dead: set = set()
        self._dead_dirs: set = set()

    # -- liveness-aware sampling ----------------------------------------
    def _is_dead(self, path: str) -> bool:
        """Dead iff the path itself or any ancestor directory was retired.
        Checked against sets, O(path depth) — depth is bounded (~7), while
        the dead pools grow with trace length."""
        if path in self._dead:
            return True
        prefix = ""
        for seg in path.split("/"):
            if not seg:
                continue
            prefix += "/" + seg
            if prefix in self._dead_dirs:
                return True
        return False

    # -- sampling context protocol (consumed by registry MIX_BINDINGS) --
    def live_file(self) -> str:
        for _ in range(32):
            f = self.ns.sample_file(self.rng)
            if not self._is_dead(f):
                return f
        return self.ns.sample_file(self.rng)

    def live_dir(self) -> str:
        for _ in range(32):
            d = self.ns.sample_dir(self.rng)
            if not self._is_dead(d):
                return d
        return self.ns.sample_dir(self.rng)

    def retire(self, path: str, *, is_dir: bool) -> None:
        """A destructive op consumed this target: drop it from sampling."""
        (self._dead_dirs if is_dir else self._dead).add(path)

    def next_create_path(self) -> str:
        self._create_seq += 1
        return f"{self.live_dir()}/w{self._create_seq:08d}"

    def next_op(self) -> WorkloadOp:
        mix_name = self.rng.choices(self._ops, weights=self._weights, k=1)[0]
        on_dir = self.rng.random() < self._dir_frac[mix_name]
        return synthesize(mix_name, self, on_dir)

    def make_trace(self, n_ops: int) -> List[WorkloadOp]:
        """Materialize ``n_ops`` ops up-front as a replayable trace."""
        return [self.next_op() for _ in range(n_ops)]

    def mix_histogram(self, n: int = 100_000) -> Dict[str, float]:
        counts: Dict[str, int] = {}
        for _ in range(n):
            o = self.next_op()
            counts[o.op] = counts.get(o.op, 0) + 1
        return {k: 100.0 * v / n for k, v in sorted(counts.items())}


def make_spotify_trace(ns: SyntheticNamespace, n_ops: int, *,
                       seed: int = 17,
                       mix: Sequence[Tuple[str, float, float]]
                       = SPOTIFY_TRACE_MIX) -> List[WorkloadOp]:
    """Generate a fixed Spotify-style trace (§7.2). The same trace replayed
    at every namenode count keeps throughput curves comparable — exactly the
    replay methodology of the paper's Fig 7 scaling experiment."""
    return SpotifyWorkload(ns, seed=seed, mix=mix).make_trace(n_ops)


def make_phased_trace(ns: SyntheticNamespace, phase_ops: Sequence[int], *,
                      seed: int = 13,
                      mix: Sequence[Tuple[str, float, float]]
                      = SPOTIFY_TRACE_MIX
                      ) -> Tuple[List[WorkloadOp], List[int]]:
    """One CONTINUOUS workload stream cut into phases: returns the full
    trace plus the cumulative phase boundaries ``[len(p0), len(p0)+len(p1),
    ...]``. The elasticity bench replays phases through the same pipeline
    with membership changes between them — a single stream (one generator,
    one liveness state) keeps the phases a real continuation of each other
    instead of three unrelated traces, so hint-cache warmth genuinely
    carries across scale events."""
    w = SpotifyWorkload(ns, seed=seed, mix=mix)
    trace: List[WorkloadOp] = []
    boundaries: List[int] = []
    for n in phase_ops:
        trace.extend(w.make_trace(n))
        boundaries.append(len(trace))
    return trace, boundaries


def make_zipf_tenant_trace(ns: SyntheticNamespace, n_ops: int, *,
                           n_tenants: int = 8,
                           s: float = 1.1,
                           seed: int = 23,
                           mix: Sequence[Tuple[str, float, float]]
                           = SPOTIFY_TRACE_MIX) -> List[WorkloadOp]:
    """Spotify-style trace with each op tagged by a Zipf(s)-weighted tenant
    identity (``WorkloadOp.tenant``). Tenant ``t0`` is the hot client,
    ``t{n-1}`` the coldest — at the paper-realistic skew s≈1.1, t0 issues
    roughly 1/(1)^s : 1/(2)^s : ... of the traffic. The overload bench and
    the admission-controller tests use this shape to show weighted fair
    queueing keeps the hot tenant from starving the cold ones. Tenants are
    billing identities only: lease-holding ops still run under the single
    default ``client``, so clock advancement mid-replay cannot strand a
    lease held by a tenant that never returns."""
    rng = random.Random(seed ^ 0x7E4A47)
    tenants = [f"t{k}" for k in range(max(1, n_tenants))]
    weights = [1.0 / (k + 1) ** s for k in range(len(tenants))]
    trace = make_spotify_trace(ns, n_ops, seed=seed, mix=mix)
    for wop in trace:
        wop.tenant = rng.choices(tenants, weights=weights, k=1)[0]
    return trace


def make_block_contention_trace(path: str, n_rounds: int, *,
                                clients: Sequence[str] = ("c1", "c2"),
                                block_size: int = 1 << 20
                                ) -> List[WorkloadOp]:
    """Adversarial same-file block-write contention: ``clients`` interleave
    append/add_block/complete_block on ONE file, round-robin per round.
    While the first client's lease is live, every other client's block
    write must be refused with ``LeaseConflict`` — and because the ops mix
    block-write TYPES on one path, the batch planner pins them all to
    submission order, so planned (including planned+concurrent) replay
    stays state-equal to sequential replay. The shape
    ``tests/test_closed_loop_pipeline.py`` asserts."""
    trace: List[WorkloadOp] = []
    for _ in range(n_rounds):
        for c in clients:
            trace.append(WorkloadOp("append", path, args={"client": c}))
            trace.append(WorkloadOp("add_block", path, args={"client": c}))
            trace.append(WorkloadOp("complete_block", path,
                                    args={"block_id": -1,
                                          "size": block_size,
                                          "client": c}))
    return trace


# ---------------------------------------------------------------------------
# columnar (struct-of-arrays) trace lowering — the batch planner's input
# ---------------------------------------------------------------------------


def name_hash32(name: str) -> int:
    """32-bit per-component name hash fed to the fused chain kernel."""
    return zlib.crc32(name.encode()) & 0xFFFFFFFF


@dataclass
class ColumnarTrace:
    """Struct-of-arrays lowering of a trace window (paper §2.2 batching +
    λFS-style client-side planning): one row per op, with the hint-cache
    chain resolution broken out per path component so the whole window can
    be hashed in ONE fused ``phash_chain`` kernel launch instead of per-op
    Python hashing.

    ``parent_ids[n, d]`` / ``name_hashes[n, d]`` are the composite PK
    (parent_id, hash(name)) of op n's d-th path component as the client's
    hint view resolves it (zero-padded past ``depths[n]``); ``hint_ids``
    is the op's partition-hint inode id (its target for file ops, its
    parent for namespace mutations — the same OpSpec.hint rule the
    namenodes use); ``pks``/``target_ids`` carry the exact resolution that
    ships to the executor as planner hints."""
    n: int
    max_depth: int
    type_ids: np.ndarray                       # [n] int32 registry ordinal
    depths: np.ndarray                         # [n] int32 resolved comps
    parent_ids: np.ndarray                     # [n, D] int64
    name_hashes: np.ndarray                    # [n, D] int64 (uint32 vals)
    hint_ids: np.ndarray                       # [n] int64
    resolved: List[bool] = field(default_factory=list)
    pks: List[Optional[Tuple[Tuple[int, str], ...]]] = \
        field(default_factory=list)
    target_ids: List[Optional[int]] = field(default_factory=list)


def lower_trace(wops: Sequence[WorkloadOp], resolver: Any,
                *, max_depth: int = 16) -> ColumnarTrace:
    """Lower a trace window to columnar form, resolving every op's hint
    chain in bulk against ``resolver`` (anything with a
    ``peek(parent_id, name) -> Optional[int]``, e.g. a namenode hint cache
    or the planner's merged view of all of them).

    Resolution requirements mirror the grouped executors: batchable reads
    and target-hinted mutations need the full chain including the leaf;
    parent-hinted mutations (create/mkdirs) need only the ancestors. Ops
    that fall short stay unresolved — the planner deals them in submission
    order and the namenode runs them through the exact sequential path."""
    n = len(wops)
    type_names = list(REGISTRY.names())
    type_of = {name: i for i, name in enumerate(type_names)}
    type_ids = np.zeros(n, np.int32)
    depths = np.zeros(n, np.int32)
    parent_ids = np.zeros((n, max_depth), np.int64)
    name_hashes = np.zeros((n, max_depth), np.int64)
    hint_ids = np.full(n, ROOT_ID, np.int64)
    ct = ColumnarTrace(n=n, max_depth=max_depth, type_ids=type_ids,
                       depths=depths, parent_ids=parent_ids,
                       name_hashes=name_hashes, hint_ids=hint_ids)
    for i, wop in enumerate(wops):
        spec = REGISTRY.get(wop.op)
        type_ids[i] = type_of.get(wop.op, -1)
        comps = [c for c in wop.path.split("/") if c]
        if spec is None or not comps or len(comps) > max_depth:
            ct.resolved.append(False)
            ct.pks.append(None)
            ct.target_ids.append(None)
            continue
        need_leaf = spec.batchable or (spec.group_mutable
                                       and spec.hint == "target")
        pks: List[Tuple[int, str]] = []
        parent = ROOT_ID
        target_id: Optional[int] = None
        ok = True
        for d, name in enumerate(comps):
            pks.append((parent, name))
            parent_ids[i, d] = parent
            name_hashes[i, d] = name_hash32(name)
            child = resolver.peek(parent, name)
            if child is None:
                if d < len(comps) - 1 or need_leaf:
                    ok = False
                break
            parent = child
            if d == len(comps) - 1:
                target_id = child
        depths[i] = len(pks)
        if not ok:
            ct.resolved.append(False)
            ct.pks.append(None)
            ct.target_ids.append(None)
            continue
        if spec.hint == "parent":
            hint_ids[i] = pks[-1][0]
        else:
            hint_ids[i] = target_id if target_id is not None else parent
        ct.resolved.append(True)
        ct.pks.append(tuple(pks))
        ct.target_ids.append(target_id)
    return ct


class TraceReplay:
    """Replays a pre-generated trace cyclically through the DES / pipeline
    client interface (``next_op``). Deterministic: op ``i`` issued by the
    replay is always ``trace[i % len(trace)]`` irrespective of namenode
    count, client count, or batching."""

    def __init__(self, trace: Sequence[WorkloadOp]):
        if not trace:
            raise ValueError("empty trace")
        self.trace = list(trace)
        self._i = 0
        self.issued = 0

    def __len__(self) -> int:
        return len(self.trace)

    def next_op(self) -> WorkloadOp:
        op = self.trace[self._i]
        self._i = (self._i + 1) % len(self.trace)
        self.issued += 1
        return op

    def mix_histogram(self) -> Dict[str, float]:
        counts: Dict[str, int] = {}
        for o in self.trace:
            counts[o.op] = counts.get(o.op, 0) + 1
        n = len(self.trace)
        return {k: 100.0 * v / n for k, v in sorted(counts.items())}
