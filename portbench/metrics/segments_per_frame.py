"""The keyframe's segments after the split: the program's ``segments``
(``utils.timing.count`` calls) over the profiled frames; nothing from a
program without counters."""

from portbench.run import TRACE_FRAMES
from super_primitive_tpu_torch.utils import timing

LAYER = "BiNI"
UNIT = "segments"
MOVES = "frame_ms"
if hasattr(timing, "count"):
    WRAPS = "super_primitive_tpu_torch.utils.timing:count"


def record(args, kwargs, out):
    """(name, n) of a ``count(name, n=1)`` call."""
    return (args[0] if args else kwargs["name"],
            args[1] if len(args) > 1 else kwargs.get("n", 1))


def read(run):
    calls = run.get("launches", {}).get("segments_per_frame")
    if calls is None:
        return None
    return sum(n for name, n in calls if name == "segments") / TRACE_FRAMES
