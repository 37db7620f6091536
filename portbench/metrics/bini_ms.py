"""BiNI's stage: ``StageTimer`` stage ``bini`` (the per-segment solves on
K2 not yet done when round 2 ends, and the composite on the host) over
the frames of the window's second half."""

LAYER = "BiNI"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    s = run.get("stages", {}).get("bini")
    return None if s is None else 1e3 * s / run["frames"]
