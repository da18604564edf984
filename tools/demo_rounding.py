#!/usr/bin/env python3
"""How the pyramid's rounding decides tools/demo_synthetic.py --slam at
--size vga, in the port and in the JAX package (ROADMAP, Queue 3, item e).

Two steps. On the card, the demo's 8 VGA frames as the port renders them
there (torch only):

    python3 tools/demo_rounding.py --dump FRAMES.npz [--device cuda]

Then on the CPU, with jax, over those frames:

    JAX_PLATFORMS=cpu python3 tools/demo_rounding.py --frames FRAMES.npz

It prints one JSON line: the frame-to-frame inliers of frames 4->5, 5->6
and 6->7 (the port's register_frames at the default tracking config, its
draws from seed 0) from the keypoints of each package's
extract_features, with its pyramid resize as shipped and with one other
rounding of the same weighted sums (the port: float32 products summed in
tap order, its rounding before this was changed; the JAX package:
jax.image.resize's two matrix products taken columns first); then the
verdict of the JAX package's demo pipeline (examples/demo_synthetic.py
--slam, without its texture) on the frames with each of its two
roundings, and of the port's demo (--slam --texture, --device cpu).
min_matches is 20: below it frame 6 is lost. Takes minutes and a few GB
of memory.
"""

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PAIRS = ((4, 5), (5, 6), (6, 7))
N_FRAMES = 8


def dump(path: str, device: str) -> None:
    import torch

    from texturefusion_torch.config import CameraConfig
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.io import synthetic
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")
    intr = cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr,
                                             synthetic.orbit_trajectory(N_FRAMES),
                                             device=device)
    np.savez_compressed(path, depths=depths, rgbs=rgbs)


def _port_resize_f32(img, nh, nw):
    """The port's resize before each pass was rounded once: float32
    products, summed in tap order."""
    from texturefusion_torch.slam import features as tf
    for n, axis in ((nh, 0), (nw, 1)):
        idx, wt = tf._taps(img.shape[axis], n, img.device)
        taps = img[idx] * wt[..., None] if axis == 0 else img[:, idx] * wt
        parts = taps.unbind(1 if axis == 0 else -1)
        img = parts[0]
        for t in parts[1:]:
            img = img + t
    return img


def _jax_resize_columns_first(img, shape, method):
    """jax.image.resize(img, shape, "linear") with its two products taken
    columns first: the same weights, the same function."""
    import jax.numpy as jnp
    from jax._src.image import scale as js
    (m, n), (nh, nw) = img.shape, shape
    k = js._kernels[js.ResizeMethod.LINEAR]
    wh = js.compute_weight_mat(m, nh, jnp.float32(nh / m), jnp.float32(0.0), k, True)
    ww = js.compute_weight_mat(n, nw, jnp.float32(nw / n), jnp.float32(0.0), k, True)
    return jnp.dot(wh.T, jnp.dot(img, ww, precision="highest"), precision="highest")


def analyse(path: str) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    torch.set_num_threads(4)

    import chip_smoke
    from texturefusion_torch.config import CameraConfig, PipelineConfig
    from texturefusion_torch.core import camera as tcam
    from texturefusion_torch.slam import features as tf
    from texturefusion_torch.slam import matching as tm
    from texturefusion_torch.utils.convert import keypoints_from_numpy
    from texturefusion_tpu.config import CameraConfig as JCameraConfig
    from texturefusion_tpu.config import PipelineConfig as JPipelineConfig
    from texturefusion_tpu.config import TSDFConfig as JTSDFConfig
    from texturefusion_tpu.core import camera as jcam
    from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline as JPipeline
    from texturefusion_tpu.io import synthetic as jsyn
    from texturefusion_tpu.io import tum as jtum
    from texturefusion_tpu.ops import preprocess as jpre
    from texturefusion_tpu.slam import features as jf

    z = np.load(path)
    depths, rgbs = z["depths"], z["rgbs"]
    cfg = PipelineConfig().tracking
    lite = tm.lite_config(cfg)
    ti = tcam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    ji = jcam.Intrinsics.from_config(JCameraConfig(far_plane=6.0))
    draws = tm.ransac_draws(lite, cfg.max_features_pad, torch.Generator().manual_seed(0))
    grays = {i: np.asarray(jpre.rgb_to_gray(jnp.asarray(rgbs[i])) * 255.0)
             for i in sorted({i for p in PAIRS for i in p})}

    def inliers(extract):
        kps = {i: extract(g, depths[i]) for i, g in grays.items()}
        return {f"{a}->{b}": int(tm.register_frames(kps[a], kps[b], draws, lite, ti).n_inliers)
                for a, b in PAIRS}

    def port(g, d):
        return tf.extract_features(torch.tensor(g), torch.tensor(d), cfg, ti)

    def jax_(g, d):
        return keypoints_from_numpy(jf.extract_features(jnp.asarray(g), jnp.asarray(d),
                                                        JPipelineConfig().tracking, ji), "cpu")

    out = {"f2f_inliers": {}, "demo": {}}
    shipped = tf.resize_linear
    out["f2f_inliers"]["port, each pass rounded once (shipped)"] = inliers(port)
    tf.resize_linear = _port_resize_f32
    try:
        out["f2f_inliers"]["port, float32 sums in tap order"] = inliers(port)
    finally:
        tf.resize_linear = shipped
    resize = jax.image.resize
    poses = jsyn.orbit_trajectory(N_FRAMES)
    for name, fn in (("jax.image.resize (shipped)", resize),
                     ("jax.image.resize, columns first", _jax_resize_columns_first)):
        jax.image.resize = fn
        jax.clear_caches()
        try:
            out["f2f_inliers"]["JAX, " + name] = inliers(jax_)
            pipe = JPipeline(JPipelineConfig(
                camera=JCameraConfig(far_plane=6.0),
                tsdf=JTSDFConfig(voxel_resolution=0.03, capacity=8192, max_update_chunks=1024)))
            for i in range(N_FRAMES):
                pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                                   timestamp=float(i))
            pipe.finish()
            ate = jtum.ate_rmse(pipe.trajectory(), np.stack(poses))
            out["demo"]["JAX pipeline, " + name] = {
                "pass": bool(ate < 0.02), "ate_mm": round(float(ate) * 1e3, 3),
                "keyframes": pipe.stats["keyframes"],
                "lost_frames": [f.index for f in pipe.slam.frames if not f.tracking_success]}
        finally:
            jax.image.resize = resize
            jax.clear_caches()
    demo = chip_smoke.load_tool("demo_synthetic")
    with contextlib.redirect_stdout(io.StringIO()):
        res = demo.run(["--size", "vga", "--slam", "--texture", "--device", "cpu",
                        "--out", os.path.join(os.path.dirname(os.path.abspath(path)),
                                              "demo_rounding_out")],
                       frames=(depths, rgbs))
    out["demo"]["port demo (--slam --texture), shipped"] = {
        "pass": res["rc"] == 0, "ate_mm": round(res["ate_mm"], 3),
        "keyframes": res["keyframes"], "lost_frames": res["lost_frames"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", help="render the demo's frames on --device into this .npz")
    ap.add_argument("--frames", help="analyse the frames of this .npz on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.dump:
        dump(args.dump, args.device)
    if args.frames:
        print(json.dumps(analyse(args.frames)))
    if not (args.dump or args.frames):
        ap.error("give --dump or --frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
