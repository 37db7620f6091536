"""K2's share of its roofline in the traced frames: the least time of its
launches (``counts.k2_work`` on each launch's shape and the iterations it
ran, against HBM's rate and the float32 peak) over its kernel time in
the profile."""

from portbench.counts import bound_ms, k2_work

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms"
KERNEL = "bini_cg_kernel"
WRAPS = "super_primitive_tpu_torch.ops.stencil:bini_cg"


def record(args, kwargs, out):
    """(N, H, W, the iterations tensor) of a ``bini_cg(b, ...)`` call."""
    return (*args[0].shape, out[1])


def read(run):
    tr = run.get("trace") or {}
    device_s = sum(s for name, s in tr.get("kernel_s", {}).items() if KERNEL in name)
    launches = run.get("launches", {}).get("k2_roofline")
    if not launches or device_s <= 0:
        return None
    least_ms = sum(bound_ms(*k2_work(N, H, W, int(it.sum()))) for N, H, W, it in launches)
    return 100.0 * least_ms * 1e-3 / device_s
