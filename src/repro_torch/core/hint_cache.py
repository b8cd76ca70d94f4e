"""Inode hint cache (paper §5.1) — namenode-side AND client-side.

Each namenode caches **only the primary keys** of inodes: for path component
``name`` under parent ``parent_id`` it remembers the child's inode id. Given
``/a/b/c`` and hits for every component, the namenode knows the composite PK
``(parent_id, name)`` of every component and can read them all **in one
batched PK operation** instead of N sequential round trips.

Cache entries are validated by the batch read itself (§5.1.1): if a hinted PK
misses (row moved by a rename) the namenode falls back to recursive
resolution and repairs the cache. Entries go stale rarely — rename/move are
<2% of typical workloads (Table 1).

The same class backs the **client-side** hint cache of the closed-loop
planned pipeline: namenode responses piggyback the ``(parent_id, name) ->
inode_id`` resolutions they touched (``OpResult.hints``), clients absorb
them (:meth:`InodeHintCache.absorb`) and invalidate on destructive ops
(:meth:`InodeHintCache.invalidate_path`). ``stale_overwrites`` counts
absorbed entries that CONTRADICTED a cached id — direct evidence of
hint staleness (rename/delete+recreate), the telemetry
``docs/HINTS.md`` documents.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from .tables import ROOT_ID, split_path

#: parent-id tag of the epoch entries piggybacked inside ``OpResult.hints``
#: (real parent ids are always >= ROOT_ID, so -1 can never collide with a
#: genuine (parent_id, name, inode_id) resolution). Two shapes ride under
#: it: ``(-1, "", epoch)`` — the store's current hint epoch — and
#: ``(-1, "/a/b", epoch)`` — a path invalidated at that epoch. Producers:
#: ``MetadataStore.hint_piggyback``; consumer: :func:`absorb_response`.
EPOCH_TAG = -1


def split_epoch_entries(hints: Iterable[Tuple[int, str, int]]
                        ) -> Tuple[List[Tuple[int, str, int]],
                                   List[Tuple[int, str, int]]]:
    """Partition a response's hints into (resolutions, epoch entries)."""
    res: List[Tuple[int, str, int]] = []
    epochs: List[Tuple[int, str, int]] = []
    for h in hints:
        (epochs if h[0] == EPOCH_TAG else res).append(h)
    return res, epochs


class InodeHintCache:
    """LRU of (parent_id, name) -> inode_id."""

    def __init__(self, capacity: int = 1_000_000):
        self.capacity = capacity
        self._lru: "OrderedDict[Tuple[int, str], int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.stale_overwrites = 0   # puts that contradicted a cached id
        #: cross-client invalidation-push state: highest store hint epoch
        #: this cache has observed, and the count of wholesale clears a
        #: coverage gap forced (the bounded invalidation log aged out
        #: epochs this cache never saw)
        self.seen_epoch = 0
        self.epoch_resets = 0

    def get(self, parent_id: int, name: str) -> Optional[int]:
        key = (parent_id, name)
        v = self._lru.get(key)
        if v is None:
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return v

    def put(self, parent_id: int, name: str, inode_id: int) -> None:
        key = (parent_id, name)
        prev = self._lru.get(key)
        if prev is not None and prev != inode_id:
            self.stale_overwrites += 1
        self._lru[key] = inode_id
        self._lru.move_to_end(key)
        if len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    def peek(self, parent_id: int, name: str) -> Optional[int]:
        """Probe without touching LRU order or hit/miss counters — the
        client-side batch planner reads namenode caches through this so
        planning never skews a namenode's own cache statistics."""
        return self._lru.get((parent_id, name))

    def invalidate(self, parent_id: int, name: str) -> None:
        if self._lru.pop((parent_id, name), None) is not None:
            self.invalidations += 1

    def invalidate_path(self, components: Sequence[str]) -> bool:
        """Client-side invalidation on a destructive op (rename/delete/
        subtree move): walk the cached chain and drop the LEAF entry.
        Dropping the leaf suffices for reachable entries — descendants of
        a removed directory become unreachable through the cache (every
        resolution walks from the root, and inode ids are never reused),
        so they age out of the LRU. Best-effort, not airtight: if an
        intermediate entry was LRU-evicted the walk stops early and a
        stale leaf may survive (and become reachable again once the
        intermediate is re-warmed) — harmless, because hints are never
        trusted: the namenode's in-transaction validation misses on the
        stale PK and falls back to sequential resolution (§5.1.1)."""
        parent = ROOT_ID
        for i, name in enumerate(components):
            if i == len(components) - 1:
                if (parent, name) in self._lru:
                    self.invalidate(parent, name)
                    return True
                return False
            child = self.peek(parent, name)
            if child is None:
                return False
            parent = child
        return False

    def absorb(self, hints: Iterable[Tuple[int, str, int]]) -> None:
        """Warm the cache from response-piggybacked resolutions
        (``OpResult.hints``): each entry is (parent_id, name, inode_id).
        Tagged epoch entries (:data:`EPOCH_TAG`) are skipped — they are
        :meth:`observe_epoch`'s business, not cache content."""
        for parent_id, name, inode_id in hints:
            if parent_id == EPOCH_TAG:
                continue
            self.put(parent_id, name, inode_id)

    def observe_epoch(self, entries: Iterable[Tuple[int, str, int]]) -> None:
        """Apply a response's piggybacked invalidation-epoch entries (the
        cross-client push): invalidate every logged path newer than
        :attr:`seen_epoch`; if the log tail starts AFTER the first epoch
        this cache missed (the bounded log aged it out), fall back to a
        wholesale :meth:`clear` — correctness over retention. Advances
        ``seen_epoch`` to the piggybacked current epoch either way."""
        current = self.seen_epoch
        min_logged = None
        todo: List[Tuple[int, str]] = []
        for _tag, payload, e in entries:
            if payload:
                if min_logged is None or e < min_logged:
                    min_logged = e
                todo.append((e, payload))
            elif e > current:
                current = e
        if current <= self.seen_epoch:
            return
        if min_logged is not None and min_logged > self.seen_epoch + 1:
            # epochs (seen, min_logged) were invalidations we never saw
            self.clear()
            self.epoch_resets += 1
        else:
            for e, path in todo:
                if e > self.seen_epoch:
                    self.invalidate_path(split_path(path))
        self.seen_epoch = current

    def export_entries(self, limit: Optional[int] = None
                       ) -> List[Tuple[int, str, int]]:
        """The cache contents as absorbable (parent_id, name, inode_id)
        hints, oldest-first so :meth:`absorb` on the receiver reproduces
        the LRU recency order. With ``limit``, only the NEWEST ``limit``
        entries — the warm working set a retiring namenode migrates to its
        successors (and a joining one is pre-warmed with)."""
        items = [(p, n, v) for (p, n), v in self._lru.items()]
        if limit is not None and len(items) > limit:
            items = items[-limit:]
        return items

    def clear(self) -> None:
        self._lru.clear()

    # deliberately NOT __len__: fs.py/namenode.py guard the optional cache
    # with `if self.cache:` (identity semantics), and a __len__ would make
    # an EMPTY cache falsy — disabling cache repair before the first entry
    @property
    def entries(self) -> int:
        """Current cache population."""
        return len(self._lru)

    # ------------------------------------------------------------------
    def resolve_pks(self, components: Sequence[str]
                    ) -> Optional[List[Tuple[int, str]]]:
        """Given path components (excluding root), return the composite PKs
        [(parent_id, name), ...] for every component **iff every lookup
        hits**. The root inode (id=ROOT_ID) is always known (§5.1).
        Returns None on any miss (caller falls back to recursive resolve).
        """
        pks: List[Tuple[int, str]] = []
        parent = ROOT_ID
        for i, name in enumerate(components):
            pks.append((parent, name))
            if i == len(components) - 1:
                break  # last component's own id is not needed to know its PK
            child = self.get(parent, name)
            if child is None:
                return None
            parent = child
        return pks

    def resolve_pks_and_id(self, components: Sequence[str]
                           ) -> Optional[Tuple[List[Tuple[int, str]], int]]:
        """Full-chain resolution for the batched pipeline: the composite PK
        of every component **plus the target's inode id**, iff every lookup
        (including the target itself) hits. The target id is what the
        batched executor feeds to the vectorized partition hash to group
        same-partition ops; a miss anywhere returns None and the op falls
        back to the sequential path (which repairs the cache)."""
        pks: List[Tuple[int, str]] = []
        parent = ROOT_ID
        for name in components:
            pks.append((parent, name))
            child = self.get(parent, name)
            if child is None:
                return None
            parent = child
        return pks, parent

    def last_resolved_id(self, components: Sequence[str]) -> Optional[int]:
        parent = ROOT_ID
        for name in components:
            child = self.get(parent, name)
            if child is None:
                return None
            parent = child
        return parent


def absorb_response(cache: InodeHintCache, wop: Any, spec: Any,
                    hints: Iterable[Tuple[int, str, int]]) -> None:
    """THE closed-loop absorb rule for one response, shared by the
    ``DFSClient`` facade and the planned pipeline so the two cannot
    diverge: drop what a destructive op (``OpSpec.destructive``)
    removed/moved — the primary path, rename's destination (an
    overwriting rename replaces the old mapping; the fresh one arrives
    with the hints), and concat's ``srcs`` — then warm the cache from the
    response's piggybacked hints (``OpResult.hints``). ``wop`` is the
    executed :class:`~repro_torch.core.ops_registry.WorkloadOp`, ``spec`` its
    OpSpec (or None for unregistered ops).

    Since the cross-client invalidation push, responses also carry tagged
    epoch entries (:data:`EPOCH_TAG`): the store's current hint epoch plus
    the recently invalidated paths. Those are applied FIRST
    (:meth:`InodeHintCache.observe_epoch` — they describe world state
    older than this response), then the op's own destructive
    invalidation, then the fresh post-execution resolutions."""
    hints, epochs = split_epoch_entries(hints)
    if epochs:
        cache.observe_epoch(epochs)
    if spec is not None and spec.destructive:
        # OpSpec.path_args applies rename's implicit ".mv" destination —
        # the same canonical rule the planner's conflict analysis uses
        for p in spec.path_args(wop):
            cache.invalidate_path(split_path(p))
        for src in (wop.args or {}).get("srcs", ()) or ():
            cache.invalidate_path(split_path(str(src)))
    cache.absorb(hints)
