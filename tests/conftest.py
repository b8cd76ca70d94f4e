"""Shared fixtures. NB: XLA_FLAGS / device count is NOT set here — smoke
tests and benches must see the real (1-CPU) device; only dryrun.py forces
512 placeholder devices."""
import jax
import pytest

from repro.core import (MetadataStore, NamenodeCluster, RequestPipeline,
                        format_fs, materialize_namespace,
                        namespace_snapshot)
from repro.core.workload import NamespaceSpec, SyntheticNamespace

jax.config.update("jax_enable_x64", False)

# Chaos/property suites run under a pinned, derandomized profile so CI
# failures always reproduce locally (hypothesis is optional: the fixed-seed
# regression tests in test_chaos_recovery.py run without it).
try:
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "chaos", derandomize=True, max_examples=20, deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile("chaos")
except ImportError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chaos: deterministic fault-injection / failover recovery suite")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's CUDA kernels)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture
def make_cluster():
    """Seeded cluster factory shared by the FS-layer suites.

    ``make_cluster(n)`` returns ``(store, cluster)``; pass ``dirs=`` /
    ``files=`` to pre-create paths, or ``namespace=True`` to materialize a
    :class:`~repro.core.workload.SyntheticNamespace` and get
    ``(store, cluster, ns)`` back — the setup every trace-replay test
    needs, deterministic via ``NamespaceSpec.seed``.
    """
    def factory(n_namenodes=1, *, dirs=(), files=(), namespace=False,
                n_dirs=16, files_per_dir=4, n_datanodes=4, **cluster_kw):
        store = MetadataStore(n_datanodes=n_datanodes)
        format_fs(store)
        cluster = NamenodeCluster(store, n_namenodes, **cluster_kw)
        nn = cluster.namenodes[0]
        for d in dirs:
            nn.ops.mkdirs(d)
        for f in files:
            nn.ops.create(f)
        if namespace:
            ns = SyntheticNamespace(NamespaceSpec(), n_dirs=n_dirs,
                                    files_per_dir=files_per_dir)
            materialize_namespace(nn, ns)
            return store, cluster, ns
        return store, cluster
    return factory


@pytest.fixture
def differential_replay(make_cluster):
    """Dict-vs-columnar oracle lock: replay the same trace on a fresh
    dict-backed cluster and a fresh columnar-backed cluster built
    identically, and return both ``(store, cluster, stats)`` triples.

    ``pipeline`` picks the execution path: ``"sequential"`` (batch=1),
    ``"reactive"`` (FIFO batches) or ``"planned"`` (closed-loop batch
    planner, where the fused kernels may engage). The caller asserts what
    the mode guarantees — ``dump_state`` byte-equality always holds; op-
    for-op cost equality additionally holds whenever both backends walk
    the identical code path (no pkval demotions)."""
    from repro.core import PlannedRequestPipeline
    from repro.core.columnar import ColumnarMetadataStore

    def replay(wops, *, n_namenodes=1, pipeline="sequential",
               batch_size=8, namespace=False, n_dirs=16, files_per_dir=4,
               window=None, **cluster_kw):
        out = []
        for store_cls in (MetadataStore, ColumnarMetadataStore):
            store = store_cls(n_datanodes=4)
            format_fs(store)
            cluster = NamenodeCluster(store, n_namenodes, **cluster_kw)
            if namespace:
                ns = SyntheticNamespace(NamespaceSpec(), n_dirs=n_dirs,
                                        files_per_dir=files_per_dir)
                materialize_namespace(cluster.namenodes[0], ns)
            if pipeline == "sequential":
                stats = RequestPipeline(cluster, batch_size=1).run(
                    list(wops))
            elif pipeline == "reactive":
                stats = RequestPipeline(cluster, batch_size=batch_size) \
                    .run(list(wops))
            elif pipeline == "planned":
                pipe = PlannedRequestPipeline(
                    cluster, batch_size=batch_size,
                    window=window or batch_size * 8)
                stats = pipe.run(list(wops))
            else:
                raise ValueError(pipeline)
            out.append((store, cluster, stats))
        return out[0], out[1]
    return replay


@pytest.fixture
def oracle_replay(make_cluster):
    """Fault-free sequential oracle: replay a trace on a fresh single
    namenode, one op per exchange, and return ``(snapshot, outcomes)``.
    Chaos and equivalence tests compare their final namespace against this
    snapshot byte-for-byte (the §7.6 'no metadata loss' check)."""
    def replay(wops, *, dirs=(), files=(), namespace=False, n_dirs=16,
               files_per_dir=4):
        built = make_cluster(1, dirs=dirs, files=files, namespace=namespace,
                             n_dirs=n_dirs, files_per_dir=files_per_dir)
        store, cluster = built[0], built[1]
        stats = RequestPipeline(cluster, batch_size=1).run(list(wops))
        return namespace_snapshot(store), stats.outcomes
    return replay
