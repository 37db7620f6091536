"""The program's reads of device values: its ``host_reads``
(``utils.timing.count`` calls, one in each ``to_host`` and ``host_flag``)
over the profiled frames; nothing from a program without counters.  The
trace's device-to-host copies (``host_reads_per_frame``) count the
entry's own reads too."""

from portbench.run import TRACE_FRAMES
from super_primitive_tpu_torch.utils import timing

LAYER = "frontend post"
UNIT = "reads"
MOVES = "frame_ms"
if hasattr(timing, "count"):
    WRAPS = "super_primitive_tpu_torch.utils.timing:count"


def record(args, kwargs, out):
    """(name, n) of a ``count(name, n=1)`` call."""
    return (args[0] if args else kwargs["name"],
            args[1] if len(args) > 1 else kwargs.get("n", 1))


def read(run):
    calls = run.get("launches", {}).get("program_reads_per_frame")
    if calls is None:
        return None
    return sum(n for name, n in calls if name == "host_reads") / TRACE_FRAMES
