"""The card's idle share in the traced frames: the part of their span in
which no kernel, copy or memset ran, from the profile."""

LAYER = "device"
UNIT = "%"
MOVES = "frame_ms"


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
