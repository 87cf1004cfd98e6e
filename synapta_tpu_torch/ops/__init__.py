"""Image ops in PyTorch plus the wrappers of the hand-written CUDA kernels.

Counterpart of synapta_tpu/ops, with the names it exports. Nothing is
imported eagerly: a name's submodule is loaded when the name is first asked
for, so importing one op never drags in the rest.
"""
import importlib

_EXPORTS = {
    "rgb_to_gray": "color", "rgb_to_hsv": "color",
    "sobel_edges": "filters", "erode": "filters", "dilate": "filters",
    "morph_open_h": "filters", "morph_open_v": "filters",
    "connected_components": "cc", "component_stats": "cc",
    "dominant_colors": "kmeans",
    "extract_crop_features": "features",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
