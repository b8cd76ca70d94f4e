"""HopsFS core in PyTorch: the planned metadata request path on the
partitioned, transactional, in-memory store, with its integer hot paths on
the card.

Public surface (the request path's modules; the simulator, chaos harness,
elastic pool and HDFS baseline are not part of the port yet):
  MetadataStore        — NDB-equivalent partitioned store w/ node groups;
                         ``device`` says where its kernels run (CUDA unless
                         ``device="cpu"`` is asked for)
  Transaction          — 3-phase txn template (lock/execute/update) + OpCost
  REGISTRY / OpSpec / register_op — the typed operation protocol
  DFSClient            — HDFS-style typed facade with composable middleware
  HopsFSOps            — inode operations (Fig 4 template, Table 3 costs)
  SubtreeOps           — subtree operations protocol (§6)
  NamenodeCluster / Client — stateless namenodes + selection policies
  RequestPipeline      — batched multi-namenode request pipeline (§7.2)
  BatchPlanner / PlannedRequestPipeline — client-side columnar batch
                         planner: partition-aligned, type-sorted dealing
  LeaderElection       — DB-as-shared-memory leader election (§3)
  AdmissionController / BreakerBoard / RetryBudget — overload-hardened
                         request path (deadlines, fair queueing, breakers)
"""
from .admission import (AdmissionController, BREAKER_FAILURES, BreakerBoard,
                        CircuitBreaker, DeadlineExpired, OverloadShed,
                        RetryBudget, TenantLoad, circuit_breaker,
                        stamp_deadlines)
from .batch_planner import (BatchPlanner, HintResolver, MultiCacheResolver,
                            PlanReport, PlannedBatch,
                            PlannedRequestPipeline, WindowController)
from .dfs_client import (BlockLocation, ConcatSummary, ContentSummary,
                         DFSClient, DeleteSummary, FileStatus,
                         TruncateSummary)
from .fs import (FSError, FileAlreadyExists, FileNotFound, HopsFSOps,
                 LeaseConflict, OpResult, SubtreeLockedError, format_fs,
                 split_path)
from .hint_cache import EPOCH_TAG, InodeHintCache, split_epoch_entries
from .leader import LeaderElection
from .middleware import (CallContext, compose, failover,
                         membership_refresh, subtree_retry, txn_retry)
from .namenode import (BATCHABLE_READ_OPS, Client, GROUP_MUTABLE_OPS,
                       Namenode, NamenodeCluster, OpOutcome, PipelineStats,
                       PlanHint, RequestPipeline, materialize_big_dir,
                       materialize_namespace, namespace_snapshot)
from .ops_registry import (ArgSpec, OpSpec, OpRegistry, REGISTRY, REQUIRED,
                           WorkloadOp, register_op)
from .store import (EXCLUSIVE, READ_COMMITTED, SHARED, LockTimeout,
                    MetadataStore, NetworkPartition, NodeGroupDown, OpCost,
                    StoreError)
from .subtree import SubtreeOps, TreeNode
from .tables import ROOT_ID, hdfs_capacity_files, hopsfs_capacity_files
from .transactions import Transaction, run_with_retry

__all__ = [
    "MetadataStore", "Transaction", "OpCost", "HopsFSOps", "SubtreeOps",
    "TreeNode", "NamenodeCluster", "Namenode", "Client", "LeaderElection",
    "RequestPipeline", "PipelineStats", "OpOutcome", "BATCHABLE_READ_OPS",
    "GROUP_MUTABLE_OPS", "PlanHint", "BatchPlanner", "HintResolver",
    "MultiCacheResolver", "PlannedBatch", "PlannedRequestPipeline",
    "PlanReport", "WindowController",
    "materialize_big_dir", "materialize_namespace", "namespace_snapshot",
    "REGISTRY", "OpRegistry", "OpSpec", "ArgSpec", "REQUIRED",
    "register_op", "WorkloadOp",
    "DFSClient", "FileStatus", "BlockLocation", "ContentSummary",
    "DeleteSummary", "TruncateSummary", "ConcatSummary",
    "CallContext", "compose", "failover", "membership_refresh",
    "subtree_retry", "txn_retry",
    "EPOCH_TAG", "split_epoch_entries",
    "InodeHintCache", "format_fs",
    "split_path", "run_with_retry", "FSError", "FileNotFound",
    "FileAlreadyExists", "LeaseConflict", "SubtreeLockedError",
    "StoreError", "LockTimeout",
    "NodeGroupDown", "NetworkPartition", "ROOT_ID", "READ_COMMITTED",
    "SHARED", "EXCLUSIVE",
    "AdmissionController", "BreakerBoard", "CircuitBreaker", "RetryBudget",
    "TenantLoad", "DeadlineExpired", "OverloadShed", "BREAKER_FAILURES",
    "circuit_breaker", "stamp_deadlines",
    "hdfs_capacity_files", "hopsfs_capacity_files",
]
