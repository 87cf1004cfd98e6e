"""prepare: host prepare of one super-batch (detect, render, PNG submit on
the prepare threads, the wait and the paste),
``VisualSegmentationPipeline._prepare_pages``."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._prepare_pages"
