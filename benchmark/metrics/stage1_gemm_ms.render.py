"""Device ms a frame in cuBLAS's matrix products (kernels with "gemm" in
their name): in the port's render only stage 1's f32 bender and rigidity
products reach cuBLAS. Nothing to read where no such kernel ran (the
time-conditioned baseline has no stage-1 network)."""


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(lambda n: "gemm" in n.lower())
    return 1e3 * seconds / run.trace_units if seconds > 0 else None
