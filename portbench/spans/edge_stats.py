"""edge_stats: one call of the fused edge-stats wrapper,
``ops/cuda_kernels.py::fused_edge_stats`` as ``ops/features.py`` binds it."""
TARGET = "synapta_tpu_torch.ops.features:fused_edge_stats"


def attrs(args, kwargs, result):
    return {"shape": list(args[0].shape), "counts": int(result.shape[1])}
