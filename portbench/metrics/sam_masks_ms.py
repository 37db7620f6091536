"""SAM's stage: ``StageTimer`` stage ``sam_masks`` (the encode, both
prompt rounds' decode and selection on K3, NMS, the edge maps) over the
frames of the window's second half."""

LAYER = "nets and selection"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    s = run.get("stages", {}).get("sam_masks")
    return None if s is None else 1e3 * s / run["frames"]
