"""prepare: host prepare of one super-batch (detect, render, PNG submit),
``VisualSegmentationPipeline._prepare_batch``."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._prepare_batch"
