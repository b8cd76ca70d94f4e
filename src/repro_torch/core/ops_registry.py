"""First-class operation protocol: the one table every layer reads.

Before this module existed, adding one FS operation meant editing five
parallel string tables (`Namenode._DISPATCH`, `execute_wop`'s hardcoded
defaults, `workload.READ_ONLY_OPS`, `BatchedHopsFSSim._BATCHABLE`, and the
`SpotifyWorkload` if-chain).  Now each operation is declared ONCE as an
:class:`OpSpec` in :data:`REGISTRY`:

  * handler binding  — which method on the namenode serves it
    (``ops.create``, ``subtree.delete_subtree``, ...);
  * argument schema  — extra arguments beyond the path(s), each with a
    default (a value, or a callable of the :class:`WorkloadOp`), so
    workload records can carry real arguments end-to-end instead of the
    executor hardcoding them;
  * semantic flags   — ``read_only`` (may never mutate), ``batchable``
    (the batched pipeline may group runs of it), ``subtree`` (goes through
    the §6 subtree protocol);
  * partition-hint derivation — whether the op's distribution-aware
    transaction should land on the *target* inode's partition (file ops:
    file-related rows live there) or the *parent*'s (namespace mutations).

Consumers: ``Namenode.invoke/execute_batch``, ``RequestPipeline``,
``DFSClient``, ``BatchedHopsFSSim``/``HDFSSim`` (DES), the workload
generator (via :data:`MIX_BINDINGS`, replacing the old if-chain), and the
benchmarks.  Registering a new op here — see ``docs/API.md`` — makes it
executable through every one of those layers with no dispatch edits;
``truncate`` and ``concat`` below are the proof.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from .store import READ_COMMITTED
from .tables import ROOT_ID

#: sentinel: the argument has no default and MUST be supplied by the caller
REQUIRED = object()


@dataclass
class WorkloadOp:
    """The canonical operation record: what clients submit, what traces
    are made of, and what the registry knows how to execute.  ``args``
    carries the op's real extra arguments (perm, owner, repl, sizes, ...)
    end-to-end; missing keys fall back to the :class:`OpSpec` defaults."""
    op: str
    path: str
    path2: Optional[str] = None
    on_dir: bool = False
    args: Dict[str, Any] = field(default_factory=dict)
    #: admission-control metadata (repro_torch.core.admission): the latest
    #: election-clock tick by which this op must COMPLETE (None = no
    #: deadline — never shed), and the billing tenant the weighted
    #: fair queue accounts it to (None = the anonymous tenant).
    deadline: Optional[int] = None
    tenant: Optional[str] = None


@dataclass(frozen=True)
class ArgSpec:
    """One extra argument of an op: its name and default.  The default may
    be a plain value or a callable of the WorkloadOp (e.g. rename's
    destination defaults to ``wop.path + ".mv"``); :data:`REQUIRED` means
    the caller must supply it."""
    name: str
    default: Any = REQUIRED

    def value_for(self, wop: WorkloadOp) -> Any:
        if self.name in wop.args:
            return wop.args[self.name]
        if self.default is REQUIRED:
            raise TypeError(
                f"op {wop.op!r} requires argument {self.name!r} "
                f"(supply it in WorkloadOp.args)")
        return self.default(wop) if callable(self.default) else self.default


@dataclass
class GroupWriteCtx:
    """Validated lock-phase state handed to a :attr:`OpSpec.group_apply`
    execute phase: the (cache-fresh) parent and target rows, the path
    components, and the op's keyword arguments."""
    parent: Dict[str, Any]
    target: Optional[Dict[str, Any]]
    comps: List[str]
    path: str
    kw: Dict[str, Any]


@dataclass(frozen=True)
class OpSpec:
    """Declaration of one file-system operation."""
    name: str
    holder: str                      # attribute on Namenode: "ops"|"subtree"
    method: str                      # method name on that holder
    args: Tuple[ArgSpec, ...] = ()
    paths: int = 1                   # positional path args (0, 1 or 2)
    read_only: bool = False
    batchable: bool = False
    subtree: bool = False
    hint: str = "target"             # partition-hint derivation: see below
    # batchable ops only: the payload phase run inside the shared grouped
    # transaction, (fsops, txn, target_row) -> value.  MUST be the same
    # helper the sequential handler uses, so the two paths cannot diverge.
    batch_payload: Optional[Callable[[Any, Any, Dict[str, Any]], Any]] = None
    # the op's lock phase folds a dependent lease read into the validation
    # exchange (§5.1) — mirrored by the grouped executor
    lease_read: bool = False
    # removes or moves namespace rows (delete/rename/truncate/concat):
    # the batch planner never reorders these across other ops — a read
    # hopping over one would spuriously fail
    destructive: bool = False
    # mutations the grouped WRITE path may share a transaction across
    # (create/mkdirs/setattr-class): group_apply is the execute phase,
    # (fsops, txn, GroupWriteCtx) -> value, and MUST be built from the same
    # fs.py helpers the sequential handler uses. group_aux lists the
    # dependent lock-phase reads folded into the shared validation exchange,
    # (kw, parent_id, target_row) -> [(table, pk, lock), ...].
    group_mutable: bool = False
    group_apply: Optional[Callable[[Any, Any, GroupWriteCtx], Any]] = None
    group_aux: Optional[Callable[[Dict[str, Any], int,
                                  Optional[Dict[str, Any]]],
                                 List[Tuple[str, Tuple[Any, ...], str]]]] \
        = None
    # lease-ordered block writes (add_block/append/complete_block): ops
    # sharing a lease_order key (the file path == the per-inode lease) must
    # apply in submission order — block indices and under-construction
    # state depend on it — while ops with DIFFERENT keys may batch freely
    # across files. The batch planner keeps same-key ops in submission
    # order through its stable (partition, type) sort instead of pinning
    # them out of the groupable stream.
    lease_order: Optional[Callable[[WorkloadOp], Any]] = None
    # the handler itself stamps the client's lease inside its transaction
    # (create/append via lease_write, renew_lease by definition): the RPC
    # layer's piggybacked touch_lease would be a redundant second lock
    # round trip on the same row, so it skips these
    renews_lease: bool = False

    def __post_init__(self) -> None:
        assert self.paths in (0, 1, 2)
        assert self.hint in ("target", "parent")
        assert not (self.batchable and not self.read_only), \
            f"{self.name}: only read-only ops may be batched"
        assert not (self.batchable and self.batch_payload is None), \
            f"{self.name}: batchable ops must declare batch_payload"
        assert not (self.group_mutable and self.read_only), \
            f"{self.name}: group_mutable is for mutations (use batchable)"
        assert not (self.group_mutable and
                    (self.group_apply is None or self.paths != 1
                     or self.subtree)), \
            f"{self.name}: group_mutable needs group_apply and a single " \
            f"non-subtree path"

    @property
    def has_client_arg(self) -> bool:
        """The op is executed on behalf of a named client (its arg schema
        carries ``client``). Such ops double as lease heartbeats: the
        namenode RPC layer refreshes the executing client's lease stamp
        after any successful op (``HopsFSOps.touch_lease``, skipped when
        ``renews_lease`` says the handler already stamped it), so a
        steadily-writing holder never expires — piggybacked renewal."""
        return any(a.name == "client" for a in self.args)

    # -- execution ------------------------------------------------------
    def resolve(self, namenode: Any) -> Callable[..., Any]:
        """Bind the handler on a namenode (``ops``/``subtree`` holder)."""
        return getattr(getattr(namenode, self.holder), self.method)

    def path_args(self, wop: WorkloadOp) -> List[str]:
        """The op's positional path arguments, with rename's implicit
        destination default applied — THE one place the ``path + ".mv"``
        rule lives (the planner's conflict analysis and the client-side
        invalidation rule both resolve paths through here)."""
        paths: List[str] = []
        if self.paths >= 1:
            paths.append(wop.path)
        if self.paths == 2:
            paths.append(wop.path2 if wop.path2 is not None
                         else wop.path + ".mv")
        return paths

    def call_args(self, wop: WorkloadOp) -> Tuple[List[str], Dict[str, Any]]:
        """Positional path args + keyword args for one workload record:
        the record's own ``args`` overlaid on the spec defaults."""
        return (self.path_args(wop),
                {a.name: a.value_for(wop) for a in self.args})

    # -- partition-hint derivation --------------------------------------
    def hint_components(self, path_components: Sequence[str]
                        ) -> Sequence[str]:
        """The path chain whose last resolved inode id is the op's
        distribution-aware transaction hint: the target itself for file
        ops, the parent directory for namespace mutations (the new/removed
        row lives on the PARENT's shard — inode partitioning is by
        parent_id, §4.2)."""
        return (path_components[:-1] if self.hint == "parent"
                else path_components)

    def hint_id(self, ops: Any, path_components: Sequence[str]) -> int:
        """Hinted inode id via the namenode's hint cache (ROOT if cold)."""
        if ops.cache is None:
            return ROOT_ID
        v = ops.cache.last_resolved_id(self.hint_components(path_components))
        return v if v is not None else ROOT_ID

    def sim_partition(self, path: str, n_partitions: int) -> int:
        """Path -> partition approximation used by the DES, derived from
        the same hint rule (hash the hint path, not always the full path).
        Must stay deterministic and cheap — the DES calls it per op."""
        comps = [c for c in path.split("/") if c]
        key = "/".join(self.hint_components(comps)) or "/"
        return zlib.crc32(key.encode()) % n_partitions


class OpRegistry:
    """Ordered name -> :class:`OpSpec` mapping with derived views."""

    def __init__(self) -> None:
        self._specs: "Dict[str, OpSpec]" = {}

    def register(self, spec: OpSpec, *, replace: bool = False) -> OpSpec:
        if spec.name in self._specs and not replace:
            raise ValueError(f"op {spec.name!r} already registered")
        self._specs[spec.name] = spec
        return spec

    def unregister(self, name: str) -> None:
        self._specs.pop(name, None)

    def get(self, name: str) -> Optional[OpSpec]:
        return self._specs.get(name)

    def __getitem__(self, name: str) -> OpSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown op {name!r}; registered: {sorted(self._specs)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __iter__(self) -> Iterator[OpSpec]:
        return iter(self._specs.values())

    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    # -- derived tables (the old parallel string tables, now views) -----
    def read_only_ops(self) -> frozenset:
        return frozenset(s.name for s in self if s.read_only)

    def batchable_ops(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self if s.batchable)

    def group_mutable_ops(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self if s.group_mutable)

    def lease_ordered_ops(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self if s.lease_order is not None)

    def subtree_ops(self) -> frozenset:
        return frozenset(s.name for s in self if s.subtree)


REGISTRY = OpRegistry()


def register_op(name: str, holder: str, method: str, *,
                args: Sequence[Tuple[str, Any]] = (), paths: int = 1,
                read_only: bool = False, batchable: bool = False,
                subtree: bool = False, hint: str = "target",
                batch_payload: Optional[Callable[..., Any]] = None,
                lease_read: bool = False, destructive: bool = False,
                group_mutable: bool = False,
                group_apply: Optional[Callable[..., Any]] = None,
                group_aux: Optional[Callable[..., Any]] = None,
                lease_order: Optional[Callable[..., Any]] = None,
                renews_lease: bool = False,
                registry: OpRegistry = REGISTRY,
                replace: bool = False) -> OpSpec:
    """Convenience declaration helper (also the public extension point)."""
    spec = OpSpec(name=name, holder=holder, method=method,
                  args=tuple(ArgSpec(n, d) for n, d in args), paths=paths,
                  read_only=read_only, batchable=batchable, subtree=subtree,
                  hint=hint, batch_payload=batch_payload,
                  lease_read=lease_read, destructive=destructive,
                  group_mutable=group_mutable,
                  group_apply=group_apply, group_aux=group_aux,
                  lease_order=lease_order, renews_lease=renews_lease)
    return registry.register(spec, replace=replace)


# ---------------------------------------------------------------------------
# Default operation set (paper Table 1 + block protocol + subtree ops §6)
# ---------------------------------------------------------------------------

# grouped-execution payload phases: the SAME fs.py helpers the sequential
# handlers use, so batched and sequential execution cannot diverge
def _payload_read(fsops: Any, txn: Any, target: Dict[str, Any]) -> Any:
    return fsops.read_payload(txn, target)


def _payload_stat(fsops: Any, txn: Any, target: Dict[str, Any]) -> Any:
    return fsops.stat_payload(target)


def _payload_ls(fsops: Any, txn: Any, target: Dict[str, Any]) -> Any:
    return fsops.listing_payload(txn, target)


# grouped write-path execute phases: the SAME fs.py apply helpers the
# sequential handlers run after their lock phase, so grouped and sequential
# mutations cannot diverge (state equivalence is asserted by
# tests/test_batched_pipeline.py)
def _apply_create(fsops: Any, txn: Any, ctx: GroupWriteCtx) -> Any:
    return fsops.create_apply(txn, ctx.parent, ctx.target, ctx.comps[-1],
                              ctx.path, **ctx.kw)


def _apply_mkdirs(fsops: Any, txn: Any, ctx: GroupWriteCtx) -> Any:
    # ancestors were validated present by the grouped lock phase, so only
    # the leaf mkdir remains; an existing leaf is mkdirs' sequential no-op
    if ctx.target is not None:
        return None
    return fsops.mkdir_apply(txn, ctx.parent, ctx.target, ctx.comps[-1],
                             ctx.path, **ctx.kw)


def _apply_setattr(field: str) -> Callable[[Any, Any, GroupWriteCtx], Any]:
    def apply(fsops: Any, txn: Any, ctx: GroupWriteCtx) -> Any:
        value = ctx.kw[field]
        return fsops.setattr_apply(txn, ctx.target, ctx.path,
                                   lambda n: n.update({field: value}))
    return apply


def _aux_create(kw: Dict[str, Any], parent_id: int,
                target: Optional[Dict[str, Any]]
                ) -> List[Tuple[str, Tuple[Any, ...], str]]:
    return [("lease", (kw.get("client", "client"),), READ_COMMITTED),
            ("quota", (parent_id,), READ_COMMITTED)]


def _aux_setattr(kw: Dict[str, Any], parent_id: int,
                 target: Optional[Dict[str, Any]]
                 ) -> List[Tuple[str, Tuple[Any, ...], str]]:
    client = (target.get("client") or "client") if target else "client"
    return [("lease", (client,), READ_COMMITTED),
            ("quota", (parent_id,), READ_COMMITTED)]


# lease-ordered block writes: the SAME fs.py apply helpers the sequential
# add_block/append_file/complete_block handlers run after their lock phase
def _apply_add_block(fsops: Any, txn: Any, ctx: GroupWriteCtx) -> Any:
    return fsops.add_block_apply(txn, ctx.target, ctx.path, **ctx.kw)


def _apply_append(fsops: Any, txn: Any, ctx: GroupWriteCtx) -> Any:
    return fsops.append_apply(txn, ctx.target, ctx.path, **ctx.kw)


def _apply_complete_block(fsops: Any, txn: Any, ctx: GroupWriteCtx) -> Any:
    return fsops.complete_block_apply(txn, ctx.target, ctx.path, **ctx.kw)


def _aux_lease_holder(kw: Dict[str, Any], parent_id: int,
                      target: Optional[Dict[str, Any]]
                      ) -> List[Tuple[str, Tuple[Any, ...], str]]:
    """The dependent lease read of the block ops' lock phases: the file's
    current holder for add_block/complete_block, the requesting client for
    append (which is about to take the lease over)."""
    client = (target.get("client") or kw.get("client", "client")) \
        if target else kw.get("client", "client")
    return [("lease", (client,), READ_COMMITTED)]


def _aux_lease_client(kw: Dict[str, Any], parent_id: int,
                      target: Optional[Dict[str, Any]]
                      ) -> List[Tuple[str, Tuple[Any, ...], str]]:
    return [("lease", (kw.get("client", "client"),), READ_COMMITTED)]


def _lease_key_path(wop: WorkloadOp) -> Any:
    """Per-inode lease-order key: the file path (one lease per file)."""
    return wop.path


register_op("create", "ops", "create",
            args=(("repl", 3), ("client", "client"), ("overwrite", False)),
            hint="parent", group_mutable=True, group_apply=_apply_create,
            group_aux=_aux_create, renews_lease=True)
register_op("read", "ops", "get_block_locations",
            read_only=True, batchable=True, batch_payload=_payload_read,
            lease_read=True)
register_op("ls", "ops", "listing", read_only=True, batchable=True,
            batch_payload=_payload_ls)
register_op("stat", "ops", "stat", read_only=True, batchable=True,
            batch_payload=_payload_stat, lease_read=True)
register_op("mkdir", "ops", "mkdir", args=(("perm", 0o755),), hint="parent")
register_op("mkdirs", "ops", "mkdirs", args=(("perm", 0o755),),
            hint="parent", group_mutable=True, group_apply=_apply_mkdirs)
register_op("delete_file", "ops", "delete_file", hint="parent",
            destructive=True)
register_op("rename_file", "ops", "rename_file", paths=2, hint="parent",
            destructive=True)
register_op("add_block", "ops", "add_block",
            args=(("client", "client"),),
            group_mutable=True, group_apply=_apply_add_block,
            group_aux=_aux_lease_holder, lease_order=_lease_key_path)
# NOTE: no group_aux — the sequential complete_block lock phase performs
# no lease read (its _check_lease consults the charge-free txn.peek), so
# the grouped path must not charge one either: grouped and sequential
# OpCost profiles for the same op stay identical (Table 3)
register_op("complete_block", "ops", "complete_block",
            args=(("block_id", -1), ("size", REQUIRED),
                  ("client", "client")),
            group_mutable=True, group_apply=_apply_complete_block,
            lease_order=_lease_key_path)
register_op("append", "ops", "append_file", args=(("client", "client"),),
            group_mutable=True, group_apply=_apply_append,
            group_aux=_aux_lease_client, lease_order=_lease_key_path,
            renews_lease=True)
register_op("renew_lease", "ops", "renew_lease", paths=0,
            args=(("client", "client"),), renews_lease=True)
# client-initiated soft-limit lease takeover (HDFS recoverLease): the new
# writer forces recovery of an expired lease instead of waiting for the
# leader's sweep — see HopsFSOps.recover_lease
register_op("recover_lease", "ops", "recover_lease",
            args=(("client", "client"),))
register_op("chmod_file", "ops", "chmod_file", args=(("perm", 0o640),),
            group_mutable=True, group_apply=_apply_setattr("perm"),
            group_aux=_aux_setattr)
register_op("chown_file", "ops", "chown_file", args=(("owner", "wluser"),),
            group_mutable=True, group_apply=_apply_setattr("owner"),
            group_aux=_aux_setattr)
register_op("set_replication", "ops", "set_replication",
            args=(("repl", 2),),
            group_mutable=True, group_apply=_apply_setattr("repl"),
            group_aux=_aux_setattr)
register_op("content_summary", "ops", "content_summary", read_only=True)
register_op("du", "ops", "du", read_only=True)
register_op("set_quota", "ops", "set_quota",
            args=(("ns_quota", -1), ("ss_quota", -1)))
register_op("truncate", "ops", "truncate", args=(("new_size", 0),),
            destructive=True)
register_op("concat", "ops", "concat", args=(("srcs", REQUIRED),),
            destructive=True)
register_op("delete_subtree", "subtree", "delete_subtree", subtree=True,
            destructive=True)
register_op("rename_subtree", "subtree", "rename_subtree", paths=2,
            subtree=True, hint="parent", destructive=True)
register_op("chmod_subtree", "subtree", "chmod_subtree",
            args=(("perm", 0o640),), subtree=True)
register_op("chown_subtree", "subtree", "chown_subtree",
            args=(("owner", "wluser"),), subtree=True)
register_op("block_report", "ops", "process_block_report", paths=0,
            args=(("datanode_id", REQUIRED), ("block_ids", REQUIRED)))


# ---------------------------------------------------------------------------
# Workload synthesis bindings (replaces the SpotifyWorkload if-chain)
# ---------------------------------------------------------------------------
#
# A *mix name* (Table 1 / §7.2 vocabulary: "delete", "set_permissions", ...)
# maps to registered ops via a builder that samples a target and REAL
# arguments from the workload context.  The context protocol (implemented by
# SpotifyWorkload) is: ``rng`` (random.Random), ``live_file()``,
# ``live_dir()``, ``retire(path, is_dir)``, ``next_create_path()``.

#: realistic argument pools the builders sample from
_PERM_POOL = (0o644, 0o640, 0o755, 0o750, 0o700)
_OWNER_POOL = tuple(f"user{i}" for i in range(8))
_REPL_POOL = (1, 2, 3)
#: sampled sizes for completed blocks (64 MiB HDFS default ± partials)
_BLOCK_SIZE_POOL = (1 << 26, 1 << 25, 1 << 24, 1 << 20)

MixBuilder = Callable[[Any, bool], WorkloadOp]


def _mix_mkdirs(ctx: Any, on_dir: bool) -> WorkloadOp:
    d = ctx.live_dir()
    return WorkloadOp("mkdirs", f"{d}/new{ctx.rng.randrange(1 << 30):x}",
                      on_dir=True)


def _mix_create(ctx: Any, on_dir: bool) -> WorkloadOp:
    return WorkloadOp("create", ctx.next_create_path(),
                      args={"repl": ctx.rng.choice(_REPL_POOL)})


def _mix_add_block(ctx: Any, on_dir: bool) -> WorkloadOp:
    return WorkloadOp("add_block", ctx.live_file())


def _mix_rename(ctx: Any, on_dir: bool) -> WorkloadOp:
    src = ctx.live_file()
    ctx.retire(src, is_dir=False)
    return WorkloadOp("rename_file", src, src + ".mv", on_dir=on_dir)


def _mix_delete(ctx: Any, on_dir: bool) -> WorkloadOp:
    if on_dir:
        d = ctx.live_dir()
        ctx.retire(d, is_dir=True)
        return WorkloadOp("delete_subtree", d, on_dir=True)
    f = ctx.live_file()
    ctx.retire(f, is_dir=False)
    return WorkloadOp("delete_file", f)


def _mix_set_permissions(ctx: Any, on_dir: bool) -> WorkloadOp:
    p = ctx.live_dir() if on_dir else ctx.live_file()
    return WorkloadOp("chmod_subtree" if on_dir else "chmod_file", p,
                      on_dir=on_dir,
                      args={"perm": ctx.rng.choice(_PERM_POOL)})


def _mix_set_owner(ctx: Any, on_dir: bool) -> WorkloadOp:
    p = ctx.live_dir() if on_dir else ctx.live_file()
    return WorkloadOp("chown_subtree" if on_dir else "chown_file", p,
                      on_dir=on_dir,
                      args={"owner": ctx.rng.choice(_OWNER_POOL)})


def _mix_set_replication(ctx: Any, on_dir: bool) -> WorkloadOp:
    return WorkloadOp("set_replication", ctx.live_file(),
                      args={"repl": ctx.rng.choice(_REPL_POOL)})


def _mix_read(ctx: Any, on_dir: bool) -> WorkloadOp:
    return WorkloadOp("read", ctx.live_file())


def _mix_append(ctx: Any, on_dir: bool) -> WorkloadOp:
    return WorkloadOp("append", ctx.live_file())


def _mix_complete(ctx: Any, on_dir: bool) -> WorkloadOp:
    # block ids are allocated at replay time, so trace records complete
    # "the last allocated block" (block_id=-1) with a sampled size
    return WorkloadOp("complete_block", ctx.live_file(),
                      args={"block_id": -1,
                            "size": ctx.rng.choice(_BLOCK_SIZE_POOL)})


def _target_file_or_dir(op: str) -> MixBuilder:
    def build(ctx: Any, on_dir: bool) -> WorkloadOp:
        p = ctx.live_dir() if on_dir else ctx.live_file()
        return WorkloadOp(op, p, on_dir=on_dir)
    return build


#: mix-name -> builder; every produced op name must be in :data:`REGISTRY`
MIX_BINDINGS: Dict[str, MixBuilder] = {
    "mkdirs": _mix_mkdirs,
    "create": _mix_create,
    "add_block": _mix_add_block,
    "rename": _mix_rename,
    "delete": _mix_delete,
    "set_permissions": _mix_set_permissions,
    "set_owner": _mix_set_owner,
    "set_replication": _mix_set_replication,
    "append": _mix_append,
    "complete": _mix_complete,
    "read": _mix_read,
    "ls": _target_file_or_dir("ls"),
    "stat": _target_file_or_dir("stat"),
    "content_summary": _target_file_or_dir("content_summary"),
    "du": _target_file_or_dir("du"),
}


def synthesize(mix_name: str, ctx: Any, on_dir: bool) -> WorkloadOp:
    """Build one workload record for a mix entry; unknown mix names fall
    back to a read on a live file (the dominant op of every mix)."""
    builder = MIX_BINDINGS.get(mix_name, _mix_read)
    return builder(ctx, on_dir)
