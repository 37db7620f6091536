"""The SAM image encoder: ``StageTimer`` stage ``sam_encode`` (inside
``sam_masks``) over the frames of the window's second half; nothing from a
program without it."""

LAYER = "nets and selection"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    s = run.get("stages", {}).get("sam_encode")
    return None if s is None else 1e3 * s / run["frames"]
