"""process: ``VisualSegmentationPipeline.process()`` of one book."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline.process"
