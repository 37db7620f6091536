"""The keyframe's last steps: ``StageTimer`` stages ``host_pack`` and
``split`` over the frames of the window's second half."""

LAYER = "frontend post"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    st = run.get("stages", {})
    if "host_pack" not in st:
        return None
    return 1e3 * (st["host_pack"] + st.get("split", 0.0)) / run["frames"]
