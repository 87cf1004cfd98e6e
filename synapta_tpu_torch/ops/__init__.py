"""Image ops in PyTorch plus the wrappers of the hand-written CUDA kernels.

Counterpart of synapta_tpu/ops. Submodules are imported where they are used
(nothing is imported eagerly here), so importing one op never drags in the
rest.
"""
