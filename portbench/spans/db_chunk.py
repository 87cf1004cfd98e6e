"""db_chunk: one fixed 16-view chunk through the DB model and its post
stage (threshold, closing, CC, stats), ``models/detector.py::boxes_device``
as ``detect_lines`` looks it up. Real views: those not all white (padding)."""
TARGET = "synapta_tpu_torch.models.detector:boxes_device"


def attrs(args, kwargs, result):
    import numpy as np

    views = np.asarray(args[1])
    real = int((views.reshape(views.shape[0], -1).min(axis=1) < 255).sum())
    return {"views": real, "size": int(views.shape[-1])}
