"""Numbers behind the float64 repairs and restated checks of the port's GN
and Adam tests (CPU; JAX and the port on the same numpy inputs).  Not a
test module: run it as a script.

    JAX_PLATFORMS=cpu python tests/torch_diagnostics.py gn
    JAX_PLATFORMS=cpu python tests/torch_diagnostics.py two_frame
    JAX_PLATFORMS=cpu python tests/torch_diagnostics.py adam [--seeds 30]
    JAX_PLATFORMS=cpu python tests/torch_diagnostics.py resume [--seeds 12]

- ``gn``: ``gn_track``'s first linearization (``test_torch_gn.py``'s
  window, robust "none"): JtJ and Jtr of float32 ``torch.einsum``,
  ``utils.numerics.einsum64`` and XLA's HIGHEST-precision einsum against
  float64, and the damped step each gives; then JAX's own final cost and
  iteration count with the log-depths one ulp up and down, and the float64
  floor (``test_torch_gn.float64_floor``).
- ``two_frame``: JAX's ``solve_two_frame_gn`` and the port's on the inputs
  of ``test_torch_solve.py``'s two-frame GN test: pose error against the
  truth before and after, raw and with the translation rescaled to the
  truth's length, and the translation's scale.
- ``adam``: the 8-frame Adam loop of ``test_torch_odometry.py``, and
  ``resume``: the Adam leg resumed from JAX's checkpoint of
  ``test_torch_resume.py``: each package's float32 tracked poses against
  JAX's run with float64 solvers (``float64_reference``), on the test's
  frames and on ``--seeds`` copies with 0.1% of the pixels one intensity
  level up, and the largest and mean readings over them.

It uses the test modules' plain helpers (no fixtures), so it reads the
inputs the tests read.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from float64_reference import jax_float64_solvers, pose_err  # noqa: E402


def gn():
    from jax import lax

    import test_torch_gn as t
    from super_primitive_tpu.lie import se3 as jse3
    from super_primitive_tpu.ops.sampling import pack_bilinear_taps as jpack
    from super_primitive_tpu_torch.ops.sampling import pack_bilinear_taps as tpack
    from super_primitive_tpu_torch.utils.numerics import einsum64

    torch.set_num_threads(1)
    jw, tw, gt, ds = t.make_window()
    T_init = np.asarray(jse3.retract(t.J(ds.poses[2]), t.J([0.01, -0.015, 0.01, -0.02, 0.03,
                                                             0.02])))
    R0 = (np.linalg.inv(T_init) @ gt[0]).astype(np.float32)
    trg = np.asarray(ds[2]["image"], np.float32) / 255.0
    tb, jb = tw.bundle_at(0), jw.bundle_at(0)
    src_t = t.tph.precompute_source(tw.images[0], tb, t.GEO)
    src_j = t.jph.precompute_source(jw.images[0], jb, t.GEO)
    res = t.tgn._residuals(torch.zeros(8), t.T(R0), tb, src_t, tpack(t.T(trg)), tw.K[0], t.GEO,
                           tw.kp_logdepth[0], tw.kp_base[0], torch.zeros(2), False)
    J = torch.func.jacfwd(lambda p: t.tgn._residuals(
        p, t.T(R0), tb, src_t, tpack(t.T(trg)), tw.K[0], t.GEO, tw.kp_logdepth[0],
        tw.kp_base[0], torch.zeros(2), False)[0])(torch.zeros(8))
    r = res[0]
    J64, r64 = J.double().reshape(-1, 8), r.double().reshape(-1)
    JtJ64, Jtr64 = J64.T @ J64, J64.T @ r64

    def step(JtJ, Jtr):
        JtJ, Jtr = np.asarray(JtJ, np.float64), np.asarray(Jtr, np.float64)
        return -np.linalg.solve(JtJ + 1e-3 * np.diag(np.diag(JtJ)) + 1e-6 * np.eye(8), Jtr)

    s64 = step(JtJ64, Jtr64)
    sums = {
        "torch float32 einsum": (torch.einsum("pci,pcj->ij", J, J),
                                 torch.einsum("pci,pc->i", J, r)),
        "einsum64, rounded": (einsum64("pci,pcj->ij", J, J).float(),
                              einsum64("pci,pc->i", J, r).float()),
        "XLA float32 einsum": tuple(np.asarray(x) for x in (
            jnp.einsum("pci,pcj->ij", jnp.asarray(J.numpy()), jnp.asarray(J.numpy()),
                       precision=lax.Precision.HIGHEST),
            jnp.einsum("pci,pc->i", jnp.asarray(J.numpy()), jnp.asarray(r.numpy()),
                       precision=lax.Precision.HIGHEST))),
    }
    print(f"gn_track, first linearization: {J64.shape[0]} terms, cond(JtJ[:6, :6]) "
          f"{np.linalg.cond(JtJ64[:6, :6].numpy()):.0f}")
    for name, (JtJ, Jtr) in sums.items():
        JtJ, Jtr = np.asarray(JtJ, np.float64), np.asarray(Jtr, np.float64)
        e_h = np.abs(JtJ - JtJ64.numpy()).max() / np.abs(JtJ64.numpy()).max()
        e_g = np.abs(Jtr - Jtr64.numpy()).max() / np.abs(Jtr64.numpy()).max()
        e_s = np.abs(step(JtJ, Jtr) - s64).max() / np.abs(s64).max()
        print(f"  {name}: JtJ {e_h:.2e}, Jtr {e_g:.2e} of max from float64; step {e_s:.2e}")

    kl = np.asarray(jw.kp_logdepth[0])
    for robust in ("none", "l1"):
        for label, kld in (("as is", kl), ("one ulp up", np.nextafter(kl, np.float32(np.inf))),
                           ("one ulp down", np.nextafter(kl, np.float32(-np.inf)))):
            res = t.jgn.gn_track(jb, src_j, t.J(trg), jw.K[0], t.J(kld), jw.kp_base[0], t.J(R0),
                                 jnp.zeros(2), jnp.zeros(2), t.GEO, max_iters=25, robust=robust)
            print(f"  JAX {robust}, log-depths {label}: {int(res.num_iters)} iterations, final "
                  f"cost {float(res.final_cost):.9g}")
        floor = t.float64_floor(jb, jw.images[0], trg, jw.K[0], jw.kp_logdepth[0], jw.kp_base[0],
                                R0, False, robust)
        print(f"  float64 floor ({robust}): {floor:.9g}")


def two_frame():
    import test_torch_solve as ts
    from super_primitive_tpu.keyframe import (KeyFrame, build_bundle_np, keyframe_pyramid,
                                              make_segment_geometry)
    from super_primitive_tpu.lie import se3 as jse3
    from super_primitive_tpu.solve.two_frame import solve_two_frame_gn as j_gn
    from super_primitive_tpu_torch import run_sfm as trun
    from super_primitive_tpu_torch.lie import se3
    from super_primitive_tpu_torch.solve.two_frame import (TwoFrameConfig, random_depth_seeds,
                                                           solve_two_frame_gn)

    cfg = ts.small_cfg(ts.tload_config, tempfile.mkdtemp(), solver="gn")
    fe = ts.TFrontend(cfg, n_cells=24, device="cpu")
    ds = trun.load_dataset(cfg)
    src, trg = ds[cfg.dataset.source_id], ds[cfg.dataset.target_id]
    fe.observe(src)
    kf = fe.process_to_kf(src["image"], src["intrinsics"])
    supp = fe.process_to_supp_kf(trg["image"], trg["intrinsics"])
    src_pyr, trg_pyr = trun.make_pyramids(cfg, kf, supp, "cpu")
    T_rel = np.linalg.inv(trg["T"]) @ src["T"]
    T_init = torch.from_numpy(T_rel.astype(np.float32)) @ se3.random(
        torch.Generator().manual_seed(42), sigma=0.05, device="cpu")
    ld0 = random_depth_seeds(torch.Generator().manual_seed(43), src_pyr.geo.num_segments,
                             TwoFrameConfig(), device="cpu")

    def report(name, T, losses):
        T = np.asarray(T, np.float64)
        scale = np.linalg.norm(T[:3, 3]) / np.linalg.norm(T_rel[:3, 3])
        aligned = T.copy()
        aligned[:3, 3] /= scale
        err = [float(np.linalg.norm(np.asarray(jse3.log(jnp.asarray(
            (np.linalg.inv(T_rel) @ x).astype(np.float32)))))) for x in (T, aligned)]
        costs = "" if losses is None else ", level costs " + ", ".join(
            f"{a:.7g} -> {b:.7g}" for a, b in losses)
        print(f"  {name}: pose error {err[0]:.4f}, scale-aligned {err[1]:.4f}, translation "
              f"{scale:.3f}x the truth's{costs}")

    print("two-frame GN on the same inputs:")
    report("start", T_init.numpy(), None)
    poses, _, losses = solve_two_frame_gn(src_pyr, [trg_pyr], T_init[None], ld0,
                                          max_iters=cfg.alignment.mapping.gn_max_iters)
    report("port", poses[0].numpy(), losses)
    geo = make_segment_geometry(
        2.0 * kf["keypoints_rc"] / (np.asarray(kf["regions"].shape[1:]) - 1) - 1.0,
        kf["regions"], kf["logdepth_perseg"])
    f = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    lo, hi = cfg.alignment.pyramid_min, cfg.alignment.pyramid_max
    jsrc = keyframe_pyramid(KeyFrame(image=f(kf["image"]), K=f(kf["K"]), K_img=f(kf["K"]),
                                     geo=geo), lo, hi,
                            bundle=build_bundle_np(kf["regions"], kf["logdepth_perseg"]))
    jtrg = keyframe_pyramid(KeyFrame(image=f(supp["image"]), K=f(supp["K"]),
                                     K_img=f(supp["K"])), lo, hi)
    jposes, _, jlosses = j_gn(jsrc, [jtrg], f(T_init.numpy())[None], f(ld0.numpy()),
                              max_iters=cfg.alignment.mapping.gn_max_iters)
    report("JAX", np.asarray(jposes[0]), jlosses)


class _Nudged:
    """A sequence whose images have 0.1% of their pixels one level up."""

    def __init__(self, base, seed):
        self.base, self.rng, self.cache = base, np.random.default_rng(seed), {}

    def __len__(self):
        return len(self.base)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __getitem__(self, i):
        if i not in self.cache:
            frame = dict(self.base[i])
            img = np.asarray(frame["image"]).copy()
            hit = self.rng.random(img.shape) < 1e-3
            img[hit] = np.minimum(img[hit].astype(int) + 1, 255).astype(img.dtype)
            frame["image"] = img
            self.cache[i] = frame
        return self.cache[i]


def _report(label, runs, ref, seeds_read):
    keys = sorted(ref, key=int)
    d = {n: [pose_err(tr[k], ref[k]) for k in keys] for n, tr in runs.items()}
    for n, v in d.items():
        seeds_read.setdefault(n, []).append((max(v), float(np.median(v))))
    print(f"  {label}: " + "; ".join(f"{n} {max(v):.3e} / {np.median(v):.3e}"
                                      for n, v in d.items()), flush=True)


def _summary(seeds_read):
    for n, v in seeds_read.items():
        mx, md = np.array(v).T
        print(f"  over {len(v)} inputs, {n}: largest {mx.max():.3e} (mean {mx.mean():.3e}), "
              f"median {md.max():.3e} (mean {md.mean():.3e})")


def adam(seeds: int):
    import test_torch_odometry as t

    torch.set_num_threads(1)
    base = t.PlaneSequence(n_frames=12)
    print("Adam loop, 8 frames: distance in |log| from JAX's float64-solver loop, largest / "
          "median over the tracked frames")
    seeds_read = {}
    for seed in range(seeds + 1):
        seq = base if seed == 0 else _Nudged(base, seed)
        tmp = Path(tempfile.mkdtemp())
        jo = t.JOdometry(t.odom_cfg(t.jload_config, tmp / "jax"), t.JGrid(rows=4, cols=5), seq)
        jo.run(max_frames=t.LOOP_FRAMES)
        to = t.TOdometry(t.odom_cfg(t.tload_config, tmp / "torch"), t.TGrid(rows=4, cols=5), seq,
                         device="cpu")
        to.run(max_frames=t.LOOP_FRAMES)
        with jax_float64_solvers():
            ref = t.JOdometry(t.odom_cfg(t.jload_config, tmp / "float64"),
                              t.JGrid(rows=4, cols=5), seq)
            ref.run(max_frames=t.LOOP_FRAMES)
        _report("the test's frames" if seed == 0 else f"nudged, seed {seed}",
                {"JAX float32": jo.global_track_trajectory,
                 "port float32": to.global_track_trajectory}, ref.global_track_trajectory,
                seeds_read)
    _summary(seeds_read)


def resume(seeds: int):
    import test_torch_resume as r

    torch.set_num_threads(1)
    base = r.PlaneSequence(n_frames=12)
    print("Adam, resumed from JAX's checkpoint: post-restore distance in |log| from JAX's "
          "float64-solver run, largest / median")
    seeds_read = {}
    for seed in range(seeds + 1):
        seq = base if seed == 0 else _Nudged(base, seed)
        tmp = Path(tempfile.mkdtemp())
        first = r.JOdometry(r.odom_cfg(r.jload_config, tmp / "first", "adam"),
                            r.JGrid(rows=4, cols=5), seq)
        first.run(max_frames=r.SPLIT)
        ckpt = r.last_checkpoint(tmp / "first")
        jo = r.JOdometry(r.resume_cfg(r.jload_config, tmp / "jax", "adam", ckpt),
                         r.JGrid(rows=4, cols=5), seq)
        jo.run()
        to = r.TOdometry(r.resume_cfg(r.tload_config, tmp / "torch", "adam", ckpt),
                         r.TGrid(rows=4, cols=5), seq, device="cpu")
        to.run()
        with jax_float64_solvers():
            ref = r.JOdometry(r.resume_cfg(r.jload_config, tmp / "float64", "adam", ckpt),
                              r.JGrid(rows=4, cols=5), seq)
            ref.run()
        fid = ckpt["frame_id"]
        _report("the test's frames" if seed == 0 else f"nudged, seed {seed}",
                {"JAX float32": r.post_restore(jo, fid), "port float32": r.post_restore(to, fid)},
                r.post_restore(ref, fid), seeds_read)
    _summary(seeds_read)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("gn", "two_frame", "adam", "resume"))
    ap.add_argument("--seeds", type=int, default=0,
                    help="adam, resume: nudged copies of the frames")
    args = ap.parse_args()
    {"gn": gn, "two_frame": two_frame, "adam": lambda: adam(args.seeds),
     "resume": lambda: resume(args.seeds)}[args.what]()
