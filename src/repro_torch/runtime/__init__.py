from .fleet import FleetRuntime, WorkerState, elastic_remesh
