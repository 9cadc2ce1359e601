"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""


def kernel_wrappers():
    """route name -> the wrapper of the route's tracing kernel; each
    counts its launches (`.launches`), which the plain versions on the CPU
    never touch.  The post-pass kernel's wrapper, shared by the mxu, trav
    and megakernel routes, is megakernel.mega_postpass."""
    from .intersect_kernel import intersect_sweep
    from .megakernel import mega_trace
    from .mxu_kernel import mxu_trace
    from .sweep_kernel import cluster_sweep
    from .trav_kernel import trav_trace

    return {"mxu": mxu_trace, "trav": trav_trace, "megakernel": mega_trace,
            "wavefront2": cluster_sweep, "pallas": intersect_sweep}
