"""enrich: sync recognition, gate, classify, enrich and write one
super-batch, ``VisualSegmentationPipeline._enrich_finish``."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._enrich_finish"
