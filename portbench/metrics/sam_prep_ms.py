"""The SAM frame's preparation on the host: ``StageTimer`` stages
``sam_resize`` (the frame resized to SAM's ``infer_resolution``) and
``sam_upload`` (the predictor's resize to its input frame, the pinned copy
to the card) over the frames of the window's second half; nothing from a
program without them."""

LAYER = "nets and selection"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    st = run.get("stages", {})
    if "sam_resize" not in st:
        return None
    return 1e3 * (st["sam_resize"] + st.get("sam_upload", 0.0)) / run["frames"]
