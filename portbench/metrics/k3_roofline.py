"""K3's share of its roofline in the traced frames: the least time of its
launches (``counts.k3_bytes`` on each launch's shape, against HBM's
rate; K3 has no operation bound) over its kernel time in the profile."""

from portbench.counts import bound_ms, k3_bytes

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms"
KERNEL = "phase_counts_kernel"
WRAPS = "super_primitive_tpu_torch.ops.phase_counts:phase_counts"


def record(args, kwargs, out):
    """(N, S, s, input_hw) of a ``phase_counts(x, s, input_hw)`` call."""
    x, s, input_hw = args
    return (x.shape[0], x.shape[-1], int(s), tuple(input_hw))


def read(run):
    tr = run.get("trace") or {}
    device_s = sum(s for name, s in tr.get("kernel_s", {}).items() if KERNEL in name)
    launches = run.get("launches", {}).get("k3_roofline")
    if not launches or device_s <= 0:
        return None
    least_ms = sum(bound_ms(k3_bytes(N, S, s, hw), 0) for N, S, s, hw in launches)
    return 100.0 * least_ms * 1e-3 / device_s
