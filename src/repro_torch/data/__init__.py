from .pipeline import DataPipeline, synthetic_batch
