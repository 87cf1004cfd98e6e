"""analyze: one crop chunk's fused analyze pass enqueued on the device
(host split, H2D, CC and edge-stats kernels inside),
``ops/features.py::device_analyze_dispatch``."""
TARGET = "synapta_tpu_torch.ops.features:device_analyze_dispatch"


def attrs(args, kwargs, result):
    return {"chunks": 1, "crops": int(args[0].shape[0])}
