"""ocr_dispatch: sync a super-batch's analyze pass, the DB detector on its
scanned-like crops, tile cutting and the recognizer's enqueue,
``VisualSegmentationPipeline._ocr_dispatch``."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._ocr_dispatch"
