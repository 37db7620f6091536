"""The whole frame's share of the card's peak: the least time of the
model work of the frames in the traced run's first half-window, which
runs without the stage timer (the entry's ``model_s``: for the frontend,
the SAM encoder and every prompt decoded at the bf16 peak, the NNET at
the float32 peak), over that half-window's time."""

LAYER = "device"
UNIT = "%"
MOVES = "frame_ms"


def read(run):
    if not run.get("plain_frames"):
        return None
    return 100.0 * run["model_s"] / run["plain_s"]
