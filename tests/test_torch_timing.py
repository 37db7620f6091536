"""The port's spans and counters (``utils.timing``) and the host RSS sampler
the full-size day-0 leg reports with (``utils.timing.RSSSampler``).

- ``span`` opens nothing without a timer or a profiler, a ``stage:<name>``
  profiler range under a recording profiler, and a timer's stage with one;
- ``StageTimer`` keeps each stage's parent, self time and what each
  counter gained inside it; ``count`` reaches a wrapper set on the module
  attribute, as the benchmark's launch recorder sets one;
- on ``frontend/fakes.DeviceFakeSAM`` on the CPU, ``process_to_kf`` counts
  the prompts decoded, the masks kept and the segments, and its
  ``keyframe`` stage holds every stage of the keyframe.
"""

import mmap
import time

import numpy as np
import pytest
import torch

from super_primitive_tpu_torch.config import load_config
from super_primitive_tpu_torch.data.synthetic import PlanesSequence
from super_primitive_tpu_torch.frontend import process_frame
from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend
from super_primitive_tpu_torch.image.resize import linear_resize
from super_primitive_tpu_torch.utils import timing
from super_primitive_tpu_torch.utils.timing import RSSSampler, StageTimer


def _refuse_ranges(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _profiled_names(fn) -> list[str]:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_span_without_a_timer_or_a_profiler_opens_nothing(monkeypatch):
    _refuse_ranges(monkeypatch)
    with timing.span(None, "quiet"):
        x = torch.ones(4).sum()
    assert float(x) == 4.0


def test_span_under_a_cpu_profiler_opens_a_stage_range():
    def work():
        with timing.span(None, "outer"):
            with timing.span(None, "inner"):
                torch.ones(8).sum()

    names = _profiled_names(work)
    assert "stage:outer" in names and "stage:inner" in names


def test_a_timer_stage_opens_its_range_under_a_profiler_only(monkeypatch):
    timer = StageTimer()

    def work():
        with timing.span(timer, "timed"):
            torch.ones(8).sum()

    assert "stage:timed" in _profiled_names(work)
    _refuse_ranges(monkeypatch)
    work()
    assert timer.counts["timed"] == 2


def test_nested_stages_give_parents_self_time_and_counters():
    timer = StageTimer()
    with timing.span(timer, "outer"):
        time.sleep(0.02)
        with timing.span(timer, "inner"):
            time.sleep(0.03)
            timing.count("masks_kept", 5)
            timing.to_host(torch.ones(3))
        with timing.span(timer, "inner"):
            timing.count("masks_kept", 2)
    timing.count("masks_kept", 100)  # outside every stage
    s = timer.summary()
    assert s["outer"]["parent"] is None and s["inner"]["parent"] == "outer"
    assert timer.counts["inner"] == 2 and timer.last["inner"] < 0.02
    assert s["outer"]["self_s"] == pytest.approx(timer.totals["outer"] - timer.totals["inner"])
    assert 0.02 <= s["outer"]["self_s"] < timer.totals["outer"] - 0.03
    assert s["inner"]["self_s"] == timer.totals["inner"]
    assert s["inner"]["counters"] == {"masks_kept": 7, "host_reads": 1}
    assert s["outer"]["counters"] == {"masks_kept": 7, "host_reads": 1}
    assert timer.syncs == {"inner": 1, "outer": 1}
    assert dict(timer.counters) == {"masks_kept": 7, "host_reads": 1}
    lines = timer.report().splitlines()
    assert lines[1].startswith("outer ") and lines[2].startswith("  inner ")
    assert lines[2].endswith("masks_kept=7")


def test_a_stage_that_raises_leaves_its_parent_open_and_records_nothing():
    timer = StageTimer()
    with timing.span(timer, "outer"):
        with pytest.raises(ValueError):
            with timing.span(timer, "failing"):
                raise ValueError("in the stage")
        with timing.span(timer, "after"):
            pass
    assert "failing" not in timer.totals
    assert timer.parents == {"after": "outer", "outer": None}


def test_count_reaches_a_wrap_of_the_module_attribute(monkeypatch):
    seen = []
    orig = timing.count

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(args)
        return out

    monkeypatch.setattr(timing, "count", wrapped)
    timing.to_host(torch.zeros(2))
    timing.host_flag(torch.tensor(True))
    timing.count("segments", 3)
    assert seen == [("host_reads",), ("host_reads",), ("segments", 3)]


def test_to_host_shares_no_memory_with_a_cpu_tensor():
    t = torch.zeros(3)
    a = timing.to_host(t)
    t += 1
    assert a.tolist() == [0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def keyframe_run():
    """A 96x128 keyframe of the frontend on DeviceFakeSAM on the CPU, the
    split on, under a stage timer; the masks ``infer_masks`` returned."""
    cfg = load_config({
        "save_path": "unused",
        "frontend": {
            "downsample_pow": 0, "num_pts": 64, "num_pts_active": 16,
            "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
            "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": True,
        },
        "sam_params": {"infer_resolution": [96, 128], "filter_edge_points": False},
    })
    f = PlanesSequence(n_frames=1, H=96, W=128)[0]
    fe = StructuredFakeFrontend(cfg, n_cells=24, device="cpu", device_sam=True)
    fe.observe(f)
    preloaded = []

    def prepare_frame(image, hw):  # the real predictor's frame on the device
        preloaded.append(linear_resize(image, hw))
        return preloaded[-1]

    fe.mask_predict_fn.prepare_frame = prepare_frame
    returned = []
    infer_masks = process_frame.infer_masks

    def kept(*args, **kwargs):
        gen = infer_masks(*args, **kwargs)
        returned.append(gen["masks"])
        return gen

    process_frame.infer_masks = kept
    try:
        plain = fe.process_to_kf(f["image"], f["intrinsics"])
        fe.rng = np.random.default_rng(42)
        fe.timer = StageTimer("cpu")
        kf = fe.process_to_kf(f["image"], f["intrinsics"])
    finally:
        process_frame.infer_masks = infer_masks
    return cfg, plain, kf, fe.timer, returned[-1], preloaded


def test_the_keyframe_counts_prompts_masks_and_segments(keyframe_run):
    cfg, _, kf, timer, masks, _ = keyframe_run
    got = timer.counted["keyframe"]
    fc = cfg.frontend
    assert got["prompts_decoded"] == fc.num_pts + fc.num_pts_active
    assert got["masks_kept"] == masks.shape[0] > 0
    assert got["segments"] == kf["regions"].shape[0] > 0
    assert got["host_reads"] == timer.syncs["keyframe"] > 0
    assert got["sam_frame_on_host"] == 1 and "sam_frame_on_card" not in got
    assert timer.counters == got


def test_the_keyframe_stage_holds_every_stage_of_the_keyframe(keyframe_run):
    _, plain, kf, timer, _, preloaded = keyframe_run
    s = timer.summary()

    def ancestors(name):
        while s[name]["parent"] is not None:
            name = s[name]["parent"]
            yield name

    stages = ("normals", "sam_resize", "sam_upload", "sam_masks", "sam_encode", "sam_round1",
              "sam_round2", "sam_edges", "bini", "host_pack", "split", "split_disc",
              "split_cc", "split_parts")
    for name in stages:
        assert "keyframe" in ancestors(name), name
    assert s["sam_encode"]["parent"] == "sam_masks"
    assert s["keyframe"]["parent"] is None and s["keyframe"]["self_s"] >= 0
    assert len(preloaded) == 2 and preloaded[0].shape == (96, 128, 3)
    for key in ("regions", "logdepth_perseg", "keypoints_rc"):  # spans change nothing
        np.testing.assert_array_equal(plain[key], kf[key])


def test_rss_sampler_sees_an_allocation():
    """64 MiB of fresh anonymous pages, every one written.  An array from
    the allocator would not do: a long-lived worker's heap can hold freed
    pages that are still resident, and a 64 MiB array placed there leaves
    the resident set where it was (in a worker that had run other test
    files first, it rose by 16 KiB)."""
    size = 64 * 2**20
    with RSSSampler() as rss:
        with mmap.mmap(-1, size) as buf:
            buf.write(b"\x01" * size)
            # held until the sampler's thread has read it: on a loaded host
            # the thread can miss a fixed 50 ms window
            deadline = time.monotonic() + 10.0
            while rss.peak - rss.start < 48 * 2**20 and time.monotonic() < deadline:
                time.sleep(0.01)
    assert rss.start > 0
    assert rss.peak - rss.start >= 48 * 2**20
