"""Photometric cost, keyframe packing, retraction Adam and the two-frame
slice: the PyTorch port against the JAX package on the CPU.

Tolerances: cost value relative 1e-5 and gradients relative 1e-4 (float32,
sums in another order); 50 Adam steps from one init agree to 1e-4
(torch.optim.Adam and optax round the same law differently in the last
bits); the whole slice at 96x128 (2 levels, 60 iterations a level) gives
final poses within |log| 1e-3, and both packages cut the pose error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu import keyframe as jkf
from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu.cost import photometric as jph
from super_primitive_tpu.data.synthetic import PlanesSequence
from super_primitive_tpu.frontend.fakes import StructuredFakeFrontend as JFrontend
from super_primitive_tpu.frontend.stub import GridSegmentFrontend
from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.solve import retraction_adam as jra
from super_primitive_tpu.solve import two_frame as jtf
from super_primitive_tpu_torch import keyframe as tkf
from super_primitive_tpu_torch import run_sfm as trun
from super_primitive_tpu_torch.config import load_config as tload_config
from super_primitive_tpu_torch.convert import from_jax_arrays
from super_primitive_tpu_torch.cost import photometric as tph
from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend as TFrontend
from super_primitive_tpu_torch.lie import se3 as tse3
from super_primitive_tpu_torch.ops.sampling import pack_bilinear_taps
from super_primitive_tpu_torch.solve import retraction_adam as tra
from super_primitive_tpu_torch.solve import two_frame as ttf

GEO_FIELDS = ("keypoints", "logdepth", "regions", "seg_valid")
BUNDLE_FIELDS = ("uv", "seg_id", "base_logdepth", "valid", "num_valid")


def fields(obj, names):
    return {k: np.asarray(getattr(obj, k)) for k in names}


@pytest.fixture(scope="module")
def problem():
    """A source keyframe with grid segments from GT depth and a target
    frame, at 48x64, in both packages."""
    seq = PlanesSequence(n_frames=3, H=48, W=64)
    src, trg = seq[0], seq[2]
    stub = GridSegmentFrontend(rows=3, cols=4)
    stub.observe(src)
    kf = stub.process_to_kf(src["image"], src["intrinsics"])
    kp = 2.0 * kf["keypoints_rc"] / (np.asarray(kf["regions"].shape[1:]) - 1) - 1.0
    geo = jkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"])
    bundle = jkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"])
    port = from_jax_arrays("cpu", keyframe=kf, geo=fields(geo, GEO_FIELDS),
                           bundle=fields(bundle, BUNDLE_FIELDS))
    T_rel = (np.linalg.inv(trg["T"]) @ src["T"]).astype(np.float32)
    return dict(kf=kf, geo=geo, bundle=bundle, port=port, src=src, trg=trg,
                T_rel=T_rel, K=kf["K"])


class TestKeyframe:
    def test_bundle_geometry_and_convert(self, problem):
        kf, port = problem["kf"], problem["port"]
        kp = 2.0 * kf["keypoints_rc"] / (np.asarray(kf["regions"].shape[1:]) - 1) - 1.0
        geo_t = tkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"], device="cpu")
        bun_t = tkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"], device="cpu")
        for k in GEO_FIELDS:
            assert np.array_equal(getattr(geo_t, k).numpy(), getattr(port["geo"], k).numpy())
        for k in BUNDLE_FIELDS[:-1]:
            assert np.array_equal(getattr(bun_t, k).numpy(), getattr(port["bundle"], k).numpy())
        assert bun_t.num_valid == port["bundle"].num_valid == int(problem["bundle"].num_valid)
        np.testing.assert_array_equal(
            geo_t.keypoint_base_logdepth().numpy(),
            np.asarray(problem["geo"].keypoint_base_logdepth()),
        )
        assert port["keyframe"]["keypoints_rc"].dtype == torch.int64

    def test_put_keypoints_back(self):
        r = np.random.default_rng(0)
        regions = r.uniform(size=(5, 20, 30)) > 0.7
        regions[2] = False
        kps = r.uniform(-1, 1, (5, 2)).astype(np.float32)
        ld = r.normal(size=regions.shape).astype(np.float32)
        out_t = tkf.put_keypoints_back(kps, regions, ld)
        out_j = jkf.put_keypoints_back(kps, regions, ld)
        for a, b in zip(out_t, out_j):
            assert np.array_equal(a, b)

    def test_put_keypoints_back_far_pixels(self):
        """Masks whose nearest pixel lies beyond the first search windows,
        and equidistant pixels (the first in row-major order wins)."""
        r = np.random.default_rng(1)
        regions = np.zeros((6, 96, 128), bool)
        regions[0, 90:, 120:] = True          # a far corner
        regions[1, 10, 5] = regions[1, 30, 5] = True  # a tie at distance 10
        regions[2, 50:52, :] = True
        regions[3] = r.uniform(size=(96, 128)) > 0.999
        regions[4, 0, 0] = True
        regions[5] = r.uniform(size=(96, 128)) > 0.5
        kps = np.float32([[-1, -1], [-0.58, -0.92], [0.9, 0.1], [0.0, 0.0], [1, 1], [0.3, -0.2]])
        out_t = tkf.put_keypoints_back(kps, regions)
        out_j = jkf.put_keypoints_back(kps, regions)
        for a, b in zip(out_t, out_j):
            assert np.array_equal(a, b)

    def test_pyramid_builds_bundle(self, problem):
        port = problem["port"]
        kfr = tkf.KeyFrame(image=torch.from_numpy(problem["kf"]["image"]),
                           K=torch.from_numpy(problem["K"]),
                           K_img=torch.from_numpy(problem["K"]), geo=port["geo"])
        pyr = tkf.keyframe_pyramid(kfr, 0, 3)
        assert pyr.num_levels == 3 and pyr.bundle.num_valid == port["bundle"].num_valid
        assert pyr.bundle.capacity == tkf.round_up(2 * 48 * 64, 1024)


class TestPhotometric:
    def test_value_and_grads(self, problem):
        geo, bundle, port = problem["geo"], problem["bundle"], problem["port"]
        img_s, img_t = problem["kf"]["image"], problem["trg"]["image"]
        K, dims = problem["K"], geo.geo_dims
        r = np.random.default_rng(1)
        ld = np.asarray(geo.keypoint_base_logdepth()) + r.normal(size=geo.num_segments).astype(np.float32) * 0.05
        xi = (r.normal(size=6) * 0.01).astype(np.float32)
        T = problem["T_rel"]

        src_j = jph.precompute_source(jnp.asarray(img_s), bundle, dims)
        kp_base_j = geo.keypoint_base_logdepth()

        def cost_j(ld, xi):
            pose = jnp.asarray(T) @ jse3.exp(xi)
            return jph.photometric_cost(bundle, src_j, jnp.asarray(img_t), jnp.asarray(K),
                                        dims, ld, kp_base_j, pose)

        v_j, (g_ld_j, g_xi_j) = jax.value_and_grad(cost_j, argnums=(0, 1))(
            jnp.asarray(ld), jnp.asarray(xi))

        src_t = tph.precompute_source(torch.from_numpy(img_s), port["bundle"], dims)
        np.testing.assert_allclose(src_t.pixels.numpy(), np.asarray(src_j.pixels), atol=1e-6)
        assert np.array_equal(src_t.valid.numpy(), np.asarray(src_j.valid))
        ld_t = torch.tensor(ld, requires_grad=True)
        xi_t = torch.tensor(xi, requires_grad=True)
        pose_t = torch.from_numpy(T) @ tse3.exp(xi_t)
        v_t = tph.photometric_cost(
            port["bundle"], src_t, pack_bilinear_taps(torch.from_numpy(img_t)),
            torch.from_numpy(K), dims, ld_t, port["geo"].keypoint_base_logdepth(), pose_t,
        )
        v_t.backward()
        np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-5)
        for g_t, g_j in ((ld_t.grad, g_ld_j), (xi_t.grad, g_xi_j)):
            g_j = np.asarray(g_j)
            np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())

    def test_spread_logdepth(self, problem):
        port, bundle, geo = problem["port"], problem["bundle"], problem["geo"]
        ld = np.linspace(0.5, 1.5, geo.num_segments).astype(np.float32)
        a = tph.spread_logdepth(port["bundle"], torch.from_numpy(ld),
                                port["geo"].keypoint_base_logdepth())
        b = jph.spread_logdepth(bundle, jnp.asarray(ld), geo.keypoint_base_logdepth())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


class TestRetractionAdam:
    def test_fifty_steps_match_optax(self, problem):
        geo, bundle, port = problem["geo"], problem["bundle"], problem["port"]
        img_s, img_t, K, dims = (problem["kf"]["image"], problem["trg"]["image"],
                                 problem["K"], geo.geo_dims)
        r = np.random.default_rng(2)
        T0 = problem["T_rel"] @ np.asarray(jse3.exp(jnp.asarray(
            (r.normal(size=6) * 0.02).astype(np.float32))))
        ld0 = (np.asarray(geo.keypoint_base_logdepth())
               + r.normal(size=geo.num_segments) * 0.1).astype(np.float32)

        src_j = jph.precompute_source(jnp.asarray(img_s), bundle, dims)
        kp_base_j = geo.keypoint_base_logdepth()

        def loss_j(poses, ld, affine):
            return jnp.abs(jph.photometric_cost(bundle, src_j, jnp.asarray(img_t),
                                                jnp.asarray(K), dims, ld, kp_base_j, poses[0]))

        opt = jra.make_optimizer(1e-3, 1e-2)
        params = jra.OptParams(poses=jnp.asarray(T0)[None], xi=jnp.zeros((1, 6)),
                               kp_logdepth=jnp.asarray(ld0), affine=jnp.zeros((1, 2)))
        res = jax.jit(lambda p, s: jra.run_adam(loss_j, p, opt, s, 50, fold=False,
                                                skip_first_step=True))(params, opt.init(params))

        conv = from_jax_arrays("cpu", opt={"poses": np.asarray(params.poses),
                                           "xi": np.asarray(params.xi), "kp_logdepth": ld0})
        p_t = conv["opt"]
        src_t = tph.precompute_source(torch.from_numpy(img_s), port["bundle"], dims)
        trg_t = pack_bilinear_taps(torch.from_numpy(img_t))
        kp_base_t = port["geo"].keypoint_base_logdepth()

        def loss_t(poses, ld):
            return torch.abs(tph.photometric_cost(port["bundle"], src_t, trg_t,
                                                  torch.from_numpy(K), dims, ld, kp_base_t, poses[0]))

        losses = tra.run_adam(loss_t, p_t, tra.make_optimizer(p_t, 1e-3, 1e-2), 50,
                              skip_first_step=True)
        np.testing.assert_allclose(losses.numpy(), np.asarray(res.losses), atol=1e-4, rtol=0)
        np.testing.assert_allclose(p_t.xi.detach().numpy(), np.asarray(res.params.xi), atol=1e-4)
        np.testing.assert_allclose(p_t.kp_logdepth.detach().numpy(),
                                   np.asarray(res.params.kp_logdepth), atol=1e-4)


def small_cfg(load_config, save_path, solver="adam"):
    return load_config({
        "save_path": str(save_path),
        "dataset": {"type": "planes", "path": "linear", "source_id": 0, "target_id": 4},
        "frontend": {
            "downsample_pow": 0, "num_pts": 48, "num_pts_active": 16,
            "normals": {"integration_shape": [48, 64], "network_dim": [96, 128]},
            "cg_max_iter": 150, "cg_tol": 1e-3, "check_for_depth_disc": False,
        },
        "sam_params": {"infer_resolution": [96, 128]},
        "alignment": {"pyramid_min": 0, "pyramid_max": 2,
                      "mapping": {"solver": solver, "gn_max_iters": 10}},
    })


class TestTwoFrameSlice:
    def test_slice_matches_jax(self, tmp_path):
        seq = PlanesSequence(n_frames=5, H=96, W=128)
        src, trg = seq[0], seq[4]
        T_rel = np.linalg.inv(trg["T"]) @ src["T"]
        r = np.random.default_rng(42)
        noise = (r.normal(size=6) * 0.05).astype(np.float32)
        T_init = (T_rel.astype(np.float32) @ np.asarray(jse3.exp(jnp.asarray(noise)))).astype(np.float32)

        def run(pkg):
            if pkg == "jax":
                fe = JFrontend(small_cfg(jload_config, tmp_path), seed=0, n_cells=24)
            else:
                fe = TFrontend(small_cfg(tload_config, tmp_path), seed=0, n_cells=24, device="cpu")
            fe.observe(src)
            kf = fe.process_to_kf(src["image"], src["intrinsics"])
            supp = fe.process_to_supp_kf(trg["image"], trg["intrinsics"])
            kp = 2.0 * kf["keypoints_rc"] / (np.asarray(kf["regions"].shape[1:]) - 1) - 1.0
            ld0 = np.log(np.random.default_rng(43).uniform(2.0, 4.0, len(kp))).astype(np.float32)
            if pkg == "jax":
                geo = jkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"])
                bundle = jkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"])
                mk = lambda im, g=None: jkf.KeyFrame(  # noqa: E731
                    image=jnp.asarray(im["image"]), K=jnp.asarray(im["K"]),
                    K_img=jnp.asarray(im["K"]), geo=g)
                sp = jkf.keyframe_pyramid(mk(kf, geo), 0, 2, bundle=bundle)
                tp = jkf.keyframe_pyramid(mk(supp), 0, 2)
                poses, _, losses = jtf.solve_two_frame(
                    sp, [tp], jnp.asarray(T_init)[None], jnp.asarray(ld0),
                    jtf.TwoFrameConfig(num_iters=60))
                return np.asarray(poses[0]), np.asarray(losses[-1])
            geo = tkf.make_segment_geometry(kp, kf["regions"], kf["logdepth_perseg"], device="cpu")
            bundle = tkf.build_bundle_np(kf["regions"], kf["logdepth_perseg"], device="cpu")
            mk = lambda im, g=None: tkf.KeyFrame(  # noqa: E731
                image=torch.from_numpy(im["image"]), K=torch.from_numpy(im["K"]),
                K_img=torch.from_numpy(im["K"]), geo=g)
            sp = tkf.keyframe_pyramid(mk(kf, geo), 0, 2, bundle=bundle)
            tp = tkf.keyframe_pyramid(mk(supp), 0, 2)
            poses, _, losses = ttf.solve_two_frame(
                sp, [tp], torch.from_numpy(T_init)[None], torch.from_numpy(ld0),
                ttf.TwoFrameConfig(num_iters=60))
            return poses[0].numpy(), losses[-1].numpy()

        (P_j, L_j), (P_t, L_t) = run("jax"), run("torch")

        def err(P):
            return float(np.linalg.norm(np.asarray(jse3.log(jnp.asarray(
                np.linalg.inv(T_rel).astype(np.float32) @ P)))))

        d = float(np.linalg.norm(np.asarray(jse3.log(jnp.asarray(np.linalg.inv(P_j) @ P_t)))))
        assert d <= 1e-3, d
        e0 = err(T_init)
        assert err(P_j) < e0 and err(P_t) < e0
        np.testing.assert_allclose(L_t, L_j, rtol=1e-3)

    def test_run_two_frame_entry_point(self, tmp_path):
        cfg = small_cfg(tload_config, tmp_path)
        seq = trun.load_dataset(cfg)
        fe = TFrontend(cfg, n_cells=24, device="cpu")
        r = trun.run_two_frame(cfg, fe, seq, device="cpu",
                               solve_cfg=ttf.TwoFrameConfig(num_iters=40))
        assert r["pose_err_final"] < r["pose_err_init"]
        assert np.isfinite(r["final_loss"]) and r["kp_logdepth"].shape == (r["num_segments"],)
        saved = np.load(tmp_path / "two_frame_result.npz")
        assert np.array_equal(saved["pose"], r["pose"])

    def test_run_two_frame_dispatches_on_mapping_solver(self, tmp_path):
        """``alignment.mapping.solver: gn`` takes ``solve_two_frame_gn``
        (per-level (initial, final) costs), as the JAX CLI chooses it."""
        cfg = small_cfg(tload_config, tmp_path, solver="gn")
        fe = TFrontend(cfg, n_cells=24, device="cpu")
        r = trun.run_two_frame(cfg, fe, trun.load_dataset(cfg), device="cpu")
        assert r["solver"] == "gn" and len(r["losses"]) == 2
        assert all(l.shape == (2,) and l[1] <= l[0] for l in r["losses"])
        assert r["pose_err_final"] < r["pose_err_init"]
        assert np.isfinite(r["kp_logdepth"]).all()
        cfg.alignment.mapping.solver = "lbfgs"
        with pytest.raises(ValueError, match="unknown solver"):
            trun.run_two_frame(cfg, fe, trun.load_dataset(cfg), device="cpu")

    def test_cli_raises_on_missing_card_and_unported_paths(self, tmp_path):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                trun.require_device("cuda")
        cfg = tmp_path / "c.yaml"
        cfg.write_text("dataset:\n  type: kitti\n")
        with pytest.raises(ValueError, match="unknown dataset type"):
            trun.main(["--config", str(cfg), "--odom", "--device", "cpu"])
        with pytest.raises(ValueError, match="unknown dataset type"):
            trun.main(["--config", str(cfg), "--device", "cpu", "--fake-frontend"])
        with pytest.raises(ValueError, match="--sam-ckpt and --nnet-ckpt"):
            trun.build_frontend(trun.argparse.Namespace(stub_frontend=False, fake_frontend=False,
                                                        sam_ckpt="sam.npz", nnet_ckpt=None),
                                tload_config(str(cfg)), "cpu")
