"""The NNET's stage: ``StageTimer`` stage ``normals`` (the net, the
nearest subsample to the integration shape and the copy to the host)
over the frames of the window's second half."""

LAYER = "nets"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    s = run.get("stages", {}).get("normals")
    return None if s is None else 1e3 * s / run["frames"]
