"""The host's reads of device values: device-to-host copies in the traced
frames' profile, a frame's worth (each waits for the card)."""

LAYER = "frontend post"
UNIT = "reads"
MOVES = "frame_ms"


def read(run):
    tr = run.get("trace") or {}
    return tr["dtoh"] / tr["frames"] if tr.get("frames") else None
