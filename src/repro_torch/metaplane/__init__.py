from .service import MetadataPlane, CheckpointManifest
