"""The share of keyframes whose SAM input frame a kernel made on the card:
the program's ``sam_frame_on_card`` over it plus ``sam_frame_on_host`` (the
numpy resizes) (``utils.timing.count`` calls) in the profiled frames;
nothing from a program without those counters."""

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
    calls = run.get("launches", {}).get("sam_frame_on_card_pct") or ()
    card = sum(n for name, n in calls if name == "sam_frame_on_card")
    host = sum(n for name, n in calls if name == "sam_frame_on_host")
    if not card + host:
        return None
    return 100.0 * card / (card + host)
