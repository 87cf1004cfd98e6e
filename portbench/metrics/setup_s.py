"""Set-up: seconds from the process's start (across the native engine's
re-exec, which keeps the process) to the first timed book, less the books'
generation: imports, CUDA initialisation, the kernels' library (nvcc on a
checkout's first run), the weights and the warm-up book."""


def read(run):
    return run.setup_s
