"""cc: one call of the CC kernel's wrapper, ``ops/cuda_cc.py``
(looked up by ``ops/cc.py::connected_components`` at each call)."""
TARGET = "synapta_tpu_torch.ops.cuda_cc:connected_components_cuda"


def attrs(args, kwargs, result):
    conn = kwargs.get("connectivity", args[2] if len(args) > 2 else 8)
    return {"shape": list(args[0].shape), "connectivity": int(conn)}
