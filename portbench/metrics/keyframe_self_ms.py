"""The keyframe's own time: ``StageTimer`` stage ``keyframe`` (the whole
``process_to_kf``) less the stages directly inside it, over the frames of
the window's second half; nothing from a program without it."""

LAYER = "entry"
UNIT = "ms"
MOVES = "frame_ms"
CHILDREN = ("normals", "sam_resize", "sam_upload", "sam_masks", "bini", "host_pack", "split")


def read(run):
    st = run.get("stages", {})
    if "keyframe" not in st:
        return None
    return 1e3 * (st["keyframe"] - sum(st.get(c, 0.0) for c in CHILDREN)) / run["frames"]
