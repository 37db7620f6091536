"""Depth completion's own stages: ``StageTimer`` stages ``depth_reinit``
and ``render_avg`` over the frames of the window's second half; nothing
in a cell without them."""

LAYER = "completion"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    st = run.get("stages", {})
    if "depth_reinit" not in st:
        return None
    return 1e3 * (st["depth_reinit"] + st.get("render_avg", 0.0)) / run["frames"]
