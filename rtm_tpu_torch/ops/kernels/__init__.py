"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""


def kernel_wrappers():
    """name -> the wrapper of each CUDA kernel; each counts its launches
    (`.launches`), which the plain versions on the CPU never touch."""
    from .intersect_kernel import intersect_sweep
    from .megakernel import mega_trace
    from .mxu_kernel import mxu_trace
    from .sweep_kernel import cluster_sweep
    from .trav_kernel import trav_trace

    return {"mxu": mxu_trace, "trav": trav_trace, "megakernel": mega_trace,
            "wavefront2": cluster_sweep, "pallas": intersect_sweep}
