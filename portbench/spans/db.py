"""db: the DB line detector over a super-batch's scanned-like crops
(views, model, post stage, host unshrink and refine),
``models/detector.py::DBLineDetector.detect_lines``."""
TARGET = "synapta_tpu_torch.models.detector:DBLineDetector.detect_lines"


def attrs(args, kwargs, result):
    return {"crops": int(args[1].shape[0])}
