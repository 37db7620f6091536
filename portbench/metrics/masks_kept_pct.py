"""The share of SAM's prompts whose mask the selection keeps: the
program's ``masks_kept`` over its ``prompts_decoded`` (``utils.timing.count``
calls) in the profiled frames; nothing from a program without counters."""

from super_primitive_tpu_torch.utils import timing

LAYER = "nets and selection"
UNIT = "%"
MOVES = "frame_ms"
if hasattr(timing, "count"):
    WRAPS = "super_primitive_tpu_torch.utils.timing:count"


def record(args, kwargs, out):
    """(name, n) of a ``count(name, n=1)`` call."""
    return (args[0] if args else kwargs["name"],
            args[1] if len(args) > 1 else kwargs.get("n", 1))


def read(run):
    calls = run.get("launches", {}).get("masks_kept_pct")
    prompts = sum(n for name, n in calls or () if name == "prompts_decoded")
    if not prompts:
        return None
    return 100.0 * sum(n for name, n in calls if name == "masks_kept") / prompts
