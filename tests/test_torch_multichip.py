"""The port's (dp, sp) layouts over torch.distributed, on the CPU.

One module-scoped group of 4 ranks (gloo on localhost, mesh dp 2 x sp 2)
runs every sharded flow of ``parallel/dryrun.py`` once; the parent runs the
same flows unsharded.  Bounds, the JAX package's own in
``tests/test_multichip.py``:

- Adam mapping (targets over dp, points over sp): poses, log-depths and
  losses within 1e-4;
- ``assemble`` (points over sp): H within 2e-4 absolute, the rest 1e-5,
  relative 1e-5; also with affines and a point stride of 2;
- ``gn_mapping``: poses within 1e-3, final cost within relative 1e-3;
- the fused frame step: the packed result and the log-depth row 1e-4;
- the SAM encode (image batch over dp): 1e-5;
- the prompt decode and selection (prompts over all ranks): 1e-4, the
  packed masks, validity and picks and K3's counts exact;
- BiNI (segments over sp, full field and cropped): 1e-5; the solve of a
  segment does not depend on its batch, and the result is bit-identical;
- CC (masks over sp): equal to the unsharded labels and the same
  partition as ``scipy.ndimage.label``.

Every rank holds every flow's output bit for bit (asserted inside the
ranks and again here), and takes the same number of LM iterations.  The
flows and ``run_flows`` default to the card, as the port's other entry
points do: without a card and without a mesh or a device they raise.  The
sharded ``assemble``, BiNI and CC are also held against the JAX package's
unsharded functions on the same inputs, with the bounds that
``tests/test_torch_gn.py`` and ``tests/test_torch_bini.py`` hold the
unsharded port to.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage
from test_torch_gn import GEO, JAX_TOL, close_to_max, par_mask_of, window_setup  # noqa: F401

from super_primitive_tpu.integrate import bini as jbini
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.ops import connected_components as jcc
from super_primitive_tpu.parallel.mesh import make_mesh as jax_make_mesh
from super_primitive_tpu.solve import gn_mapping as jgm
from super_primitive_tpu_torch.integrate.bini import BiniConfig
from super_primitive_tpu_torch.nets import synth
from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_TINY_TEST
from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor
from super_primitive_tpu_torch.odometry import mapper as tmap
from super_primitive_tpu_torch.parallel import dryrun, launch
from super_primitive_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parents[1]
N_RANKS = 4
BINI_CFG = BiniConfig(cg_max_iter=40, cg_tol=1e-5)


def _fused_step(jw, ds):
    """The fused frame of tests/test_torch_gn.py (frame 8 against keyframe
    slot 2, frame 7 the previous tracked frame)."""
    i, fid = 2, 8
    trg = np.asarray(ds[fid]["image"], np.float32) / 255.0
    T_init = np.asarray(jse3.retract(jnp.asarray(ds.poses[fid], jnp.float32),
                                     jnp.asarray([0.005, 0, 0, 0.01, 0, 0], jnp.float32)))
    prev = np.asarray(ds[7]["image"], np.float32) / 255.0
    supp_valid = np.asarray(jw.supp_valid).copy()
    supp_valid[i] = [True, True]
    slots = tmap.build_slots(3, 3, supp_valid, "supp")
    t = torch.from_numpy
    return dict(kf_slot=i, trg_image=t(trg), T_init=t(T_init), current_aff=torch.zeros(2),
                prev_img=t(prev), prev_pose=t(np.asarray(ds.poses[7], np.float32)),
                prev_aff=torch.zeros(2), supp_trg_index=slots.trg_index[i],
                supp_trg_valid=slots.trg_valid[i], geo_dims=GEO, levels=(0, 1),
                pyramid_min=0, pyramid_max=2, max_iters=4, supp_max_iters=3)


def port_window_args(tw, opt_supporting=False, affine=False):
    """``window_args`` of tests/test_torch_gn.py from the port's mapper, so
    that the ranks unpickle no JAX type."""
    supp_valid = tw.supp_valid.numpy()
    return (tmap.build_slots(3, tw.capacity, supp_valid, "map"),
            tmap.build_masks(3, tw.capacity, supp_valid, "map", tw.capacity, opt_supporting,
                             affine))


def _decode_inputs():
    """Tiny-ViT weights, one image's features and 10 prompts (padded to 12
    over 4 ranks)."""
    sd = synth.scale_like_trained(synth.synth_sam_state_dict(VIT_TINY_TEST))
    pred = SamPredictor(sd, VIT_TINY_TEST, device="cpu")
    pred.set_image(np.random.default_rng(3).integers(0, 255, (48, 60, 3), np.uint8))
    r = np.random.default_rng(4)
    pts = torch.from_numpy((r.random((10, 2)) * 40).round().astype(np.float32))
    S = 4 * VIT_TINY_TEST.img_size // VIT_TINY_TEST.patch_size
    return dict(state_dict=sd, cfg=VIT_TINY_TEST, features=pred._features,
                input_hw=pred._input_hw, pts=pts, out_size=S)


@pytest.fixture(scope="module")
def flows(window_setup):  # noqa: F811
    """{name: (job, plain output, [rank outputs])} of every flow."""
    jw, tw, _, ds = window_setup
    slots, masks = port_window_args(tw)
    slots_aff, masks_aff = port_window_args(tw, opt_supporting=True, affine=True)
    win = dict(buffers=tw, geo_dims=GEO)
    sd = synth.synth_sam_state_dict(VIT_TINY_TEST)
    imgs = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (4, VIT_TINY_TEST.img_size, VIT_TINY_TEST.img_size, 3)).astype(np.float32))
    normals, bmasks, K = dryrun.bini_case(8)
    cc_masks = torch.from_numpy(np.random.default_rng(9).uniform(size=(8, 24, 32)) < 0.4)
    jobs = {
        "adam": ("adam", dict(win, slots=slots, masks=masks, max_iters=25)),
        "assemble": ("assemble", dict(win, slots=slots, masks=masks)),
        "assemble_affine_stride2": ("assemble", dict(
            win, slots=slots_aff, masks=masks_aff, use_affine=True, point_stride=2)),
        "gn_mapping": ("gn_mapping", dict(win, slots=slots, masks=masks, max_iters=5, tol=0.0)),
        "fused": ("fused", dict(buffers=tw, step=_fused_step(jw, ds))),
        "encode": ("encode", dict(state_dict=sd, cfg=VIT_TINY_TEST, images=imgs)),
        "decode": ("decode", _decode_inputs()),
        "bini": ("bini", dict(normals=normals, masks=bmasks, K=K, config=BINI_CFG)),
        "bini_cropped": ("bini", dict(normals=normals, masks=bmasks[:7], K=K,
                                      config=BINI_CFG, crop=16)),
        "cc": ("cc", dict(masks=cc_masks)),
    }
    names = list(jobs)
    ranks = launch.run(dryrun.run_flows, N_RANKS, "gloo", "cpu",
                       args=([jobs[k] for k in names],), timeout=60)
    # the ranks run on one torch thread each; so does the unsharded run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = dryrun.run_flows(None, [jobs[k] for k in names], device="cpu")
    finally:
        torch.set_num_threads(threads)
    return {k: (jobs[k], plain[i], [r[i] for r in ranks]) for i, k in enumerate(names)}


def _tensors(out: dict) -> dict:
    flat = {}
    for k, v in out.items():
        if torch.is_tensor(v):
            flat[k] = v
        elif isinstance(v, tuple) and all(torch.is_tensor(t) for t in v):
            flat.update({f"{k}{j}": t for j, t in enumerate(v)})
    return flat


@pytest.mark.parametrize("name", ["adam", "assemble", "assemble_affine_stride2", "gn_mapping",
                                  "fused", "encode", "decode", "bini", "bini_cropped", "cc"])
def test_ranks_hold_the_same_bits(flows, name):
    _, _, ranks = flows[name]
    assert all(r["replicated"] for r in ranks)
    first = _tensors(ranks[0])
    assert first
    for r in ranks[1:]:
        for k, v in _tensors(r).items():
            assert torch.equal(v, first[k]), (name, k)
        for k in ("num_iters", "track_iters", "supp_iters"):
            if k in r:
                assert r[k] == ranks[0][k], (name, k)


def test_adam_mapping(flows):
    _, plain, ranks = flows["adam"]
    got = ranks[0]
    assert got["num_iters"] == plain["num_iters"] == 25
    for k in ("poses", "kp_logdepth", "losses"):
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), atol=1e-4, rtol=0,
                                   err_msg=k)
    assert float(plain["losses"][-1]) < float(plain["losses"][0])


@pytest.mark.parametrize("name", ["assemble", "assemble_affine_stride2"])
def test_assemble(flows, name):
    _, plain, ranks = flows[name]
    for a, b, key in zip(ranks[0]["lin"], plain["lin"], ("H", "g_t", "D", "gl", "Bs", "cost")):
        atol = 2e-4 if key == "H" else 1e-5
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=1e-5, err_msg=key)
    assert float(plain["lin"][4].abs().max()) > 0


def test_assemble_against_jax(flows, window_setup):  # noqa: F811
    jw, _, _, _ = window_setup
    (_, job), _, ranks = flows["assemble"]
    slots, masks = job["slots"], job["masks"]
    ti = jnp.asarray(slots.trg_index)
    want = jgm.assemble(jw, ti, jnp.asarray(slots.trg_valid), jnp.asarray(slots.src_valid),
                        jw.image_pool()[ti], jw.source_samples(GEO),
                        jnp.asarray(par_mask_of(masks)), GEO, False, jw.pose_pool(),
                        jw.kp_logdepth, jw.affine_pool())
    got = ranks[0]["lin"]
    for k, key in enumerate(("H", "g_t", "D", "gl", "Bs")):
        close_to_max(got[k], want[k], JAX_TOL[key], "sharded port vs JAX " + key)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-5)


def test_gn_mapping(flows):
    _, plain, ranks = flows["gn_mapping"]
    got = ranks[0]
    assert np.isfinite(float(got["final_cost"]))
    assert float(got["final_cost"]) < float(got["initial_cost"])
    np.testing.assert_allclose(got["poses"].numpy(), plain["poses"].numpy(), atol=1e-3)
    np.testing.assert_allclose(float(got["final_cost"]), float(plain["final_cost"]), rtol=1e-3)


def test_fused_step(flows):
    _, plain, ranks = flows["fused"]
    got = ranks[0]
    assert np.isfinite(got["packed"].numpy()).all()
    np.testing.assert_allclose(got["packed"].numpy(), plain["packed"].numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["kp_logdepth"].numpy(), plain["kp_logdepth"].numpy(),
                               atol=1e-4)
    assert got["supp_iters"] >= 1 and len(got["track_iters"]) == 2


def test_encode(flows):
    _, plain, ranks = flows["encode"]
    np.testing.assert_allclose(ranks[0]["features"].numpy(), plain["features"].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert ranks[0]["features"].shape[0] == 4


def test_decode_select(flows):
    _, plain, ranks = flows["decode"]
    got = ranks[0]
    for k in ("packed", "valid", "pick", "counts"):
        assert torch.equal(got[k], plain[k]), k
    for k in ("iou", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert got["packed"].shape[0] == 10 and int(got["counts"][..., 2].sum()) > 0


@pytest.mark.parametrize("name", ["bini", "bini_cropped"])
def test_bini(flows, name):
    _, plain, ranks = flows[name]
    got, want = ranks[0]["out"][0], plain["out"][0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # each segment's solve is independent of its batch: bit for bit
    assert torch.equal(got, want)
    assert float(got.abs().sum()) > 0


def test_bini_against_jax(flows):
    (_, job), _, ranks = flows["bini"]
    cfg = jbini.BiniConfig(cg_max_iter=40, cg_tol=1e-5)
    want = jbini.integrate_normals(jnp.asarray(job["normals"].numpy()),
                                   jnp.asarray(job["masks"].numpy()),
                                   jnp.asarray(job["K"].numpy()), cfg)
    np.testing.assert_allclose(ranks[0]["out"][0].numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_cc(flows):
    (_, job), plain, ranks = flows["cc"]
    got = ranks[0]["labels"].numpy()
    masks = job["masks"].numpy()
    np.testing.assert_array_equal(got, plain["labels"].numpy())
    np.testing.assert_array_equal(got, np.asarray(jcc.label_components(jnp.asarray(masks))))
    structure = np.asarray([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for i in range(masks.shape[0]):
        ref, n_ref = ndimage.label(masks[i], structure=structure)
        assert (got[i] >= 0).sum() == (ref > 0).sum()
        assert len(np.unique(got[i][got[i] >= 0])) == n_ref
        for lbl in range(1, n_ref + 1):
            assert len(np.unique(got[i][ref == lbl])) == 1


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert dict(jax_make_mesh(n).shape) == dict(zip(("dp", "sp"), tmesh.mesh_shape(n)))


def test_reducers_are_identity_without_a_group(window_setup):  # noqa: F811
    _, tw, _, _ = window_setup
    x = torch.arange(6.0)
    pair = (x, x + 1)
    assert tmesh.reduce_sum(x, None) is x and tmesh.reduce_sum(pair, None) is pair
    assert tmesh.reduce_min(x, None) is x
    part, rows = tmesh.shard_rows(x, None)
    assert part is x and rows is None and tmesh.gather_rows(x, None) is x
    idx = np.arange(5)
    assert tmesh.shard_targets(idx, None) is idx
    assert tw.mesh is None and tw.group is None and tw.bundle_at(0).group is None
    assert tw.bundle_at(0).start == 0


def test_launch_reports_failing_ranks():
    with pytest.raises(RuntimeError, match="KeyError: 'no_such_flow'"):
        launch.run(dryrun.run_flows, 2, "gloo", "cpu", args=([("no_such_flow", {})],),
                   timeout=20, deadline=60)


def test_launch_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        launch.check(2, "mpi", "cpu")
    with pytest.raises(ValueError):
        launch.check(1, "nccl", "cpu")
    with pytest.raises(RuntimeError):
        launch.check(torch.cuda.device_count() + 1, "nccl", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.run(dryrun.run_flows, 1, "gloo", "cuda", args=([],))


@pytest.mark.parametrize("name", [*dryrun.FLOWS, "run_flows"])
def test_flows_default_to_the_card(name):
    """Every flow and ``run_flows`` runs on the card unless the caller asks
    for the CPU: with no mesh and no device on a machine without a card,
    the CC flow (alone and through ``run_flows``) raises instead of running
    on the CPU."""
    fn = dryrun.run_flows if name == "run_flows" else dryrun.FLOWS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if name in ("cc", "run_flows") and not torch.cuda.is_available():
        masks = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 8, 8)) > 0.5)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            if name == "cc":
                dryrun.flow_cc(None, masks)
            else:
                dryrun.run_flows(None, [("cc", {"masks": masks})])


def test_dryrun_cli():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    p = subprocess.run([sys.executable, "-m", "super_primitive_tpu_torch.parallel.dryrun",
                        "--n", "4", "--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "dryrun_multichip OK: mesh {'dp': 2, 'sp': 2}" in p.stdout, p.stdout


def test_window_slots_are_placed_contiguously(window_setup):  # noqa: F811
    """shard_window's ranges tile each slot's valid points, in order, and
    a slot's sharded bundle is shard_bundle's of its unsharded one."""
    _, tw, _, _ = window_setup
    n = tw.num_valid
    for size in (2, 3):
        starts, rows = [], []
        for rank in range(size):
            g = tmesh.Group(pg=None, ranks=tuple(range(size)), rank=rank)
            mesh = tmesh.Mesh(world=g, dp=g, sp=g, device=torch.device("cpu"))
            sw = tmesh.shard_window(tw, mesh)
            starts.append(sw.point_start)
            rows.append(sw.point_rows)
            b = sw.bundle_at(1)
            lo = int(sw.point_start[1])
            assert b.num_valid == int(n[1]) and b.start == lo and b.group is g
            assert torch.equal(b.uv, tw.uv[1, lo:lo + b.uv.shape[0]])
            sb = tmesh.shard_bundle(tw.bundle_at(1), mesh)
            assert (sb.start, sb.num_valid, sb.group) == (b.start, b.num_valid, b.group)
            for f in ("uv", "seg_id", "base_logdepth", "valid"):
                assert torch.equal(getattr(sb, f), getattr(b, f)), f
        np.testing.assert_array_equal(np.sum(rows, axis=0), n)
        np.testing.assert_array_equal(starts[0], 0)
        for r in range(1, size):
            np.testing.assert_array_equal(starts[r], starts[r - 1] + rows[r - 1])
