#!/usr/bin/env python3
"""Generate a TUM-fr1-matched synthetic RGB-D dataset on disk and run the
port's command line over it: the fr1 proxy of examples/make_tum_proxy.py
(docs/ATE_PROXY.md), rendered and run by the PyTorch port.

Sensor model (TUM freiburg1 and the Kinect-v1 error literature):
  * fr1 intrinsics (fx 517.3, fy 516.5, cx 318.6, cy 255.3, 640x480)
  * asymmetric Brown-Conrady distortion with tangential terms: frames are
    rendered through the distorted camera, the tracker undistorts
  * depth quantised to uint16 at the TUM factor 5000 (0.2 mm steps)
  * axial depth noise sigma(z) = 1.2 mm + 1.9 mm (z - 0.4)^2 (Khoshelham
    and Elberink)
  * projector-shadow dropout at strong depth edges, plus salt speckle
  * per-frame auto-exposure flicker on top of a 2/3-stop step over half
    the loop
  * a motion-blur burst (sigma 3 Gaussian, 3 frames)
  * groundtruth.txt in another world frame (a mocap rig's), so the ATE's
    Umeyama alignment works for real

Every random draw comes from one numpy generator in the JAX script's
order, so both scripts write the same frames at the same seed (up to the
renderers' last bits). It imports no jax, no cv2 and no PIL: the PNGs go
through io/png (RGB in 8 bits, depth in 16) and the blur is OpenCV's
Gaussian written in numpy (`gaussian_blur`).

    python3 tools/make_tum_proxy.py [--frames 120] [--out DIR] [--run]
                                    [--device cuda|cpu]

--run then runs the dataset path end to end,
    python -m texturefusion_torch DIR "" 0.02 0 --out DIR/out --device DEVICE
(associate.txt -> calib.txt -> pipeline -> trajectory.txt), and prints
the ATE of DIR/out/trajectory.txt against DIR/groundtruth.txt. The frames
are rendered on the GPU unless --device names another device; --device
cuda without CUDA raises.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FR1_CAMERA = dict(width=640, height=480, fx=517.3, fy=516.5,
                  cx=318.6, cy=255.3, depth_scale=5000.0, far_plane=6.0,
                  # moderate asymmetric Brown-Conrady set (k1, k2, p1, p2):
                  # fr1's own k-series is stronger but diverges the
                  # iterative inverse at the frame corners; this keeps
                  # >5 px of correction at the border
                  d0=0.12, d1=-0.18, d2=-0.004, d3=0.003)

BLUR_FRAMES = (46, 47, 48)
EXPOSURE_GAIN = 1.55
EXPOSURE_RANGE = (60, 95)
ROOM = dict(room_min=(-2.6, -1.5, -2.6), room_max=(2.6, 1.5, 2.6))
# the mocap frame of groundtruth.txt: rotation (x, y, z, w) and translation
GT_ROTATION = (0.18, -0.05, 0.3, 0.936)
GT_TRANSLATION = (0.7, -0.2, 1.1)
T0 = 1305030000.0


def kinect_depth_noise(rng, depth):
    """Khoshelham & Elberink axial error: sigma(z) = 1.2 + 1.9 (z - 0.4)^2 mm."""
    sigma = (0.0012 + 0.0019 * np.square(np.maximum(depth, 0.4) - 0.4))
    return np.where(depth > 0,
                    depth + rng.normal(0.0, 1.0, depth.shape) * sigma,
                    0.0).astype(np.float32)


def depth_shadow_dropout(rng, depth, edge_mm=40.0, speckle=0.004):
    """Projector-shadow dropout near strong depth edges + salt speckle
    (real Kinect frames lose the occlusion boundary strip)."""
    gx = np.abs(np.diff(depth, axis=1, prepend=depth[:, :1]))
    gy = np.abs(np.diff(depth, axis=0, prepend=depth[:1]))
    edge = (np.maximum(gx, gy) > edge_mm * 1e-3)
    # dilate the edge band one step to the right (IR baseline is horizontal)
    band = edge | np.roll(edge, 1, axis=1) | np.roll(edge, 2, axis=1)
    drop = band | (rng.random(depth.shape) < speckle)
    return np.where(drop, 0.0, depth).astype(np.float32)


def gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV's float Gaussian kernel for GaussianBlur(ksize=(0, 0)):
    ksize = round(8 sigma + 1) | 1 taps exp(-x^2 / 2 sigma^2), normalised
    to sum 1 in double, then rounded to float32."""
    n = int(np.floor(sigma * 4 * 2 + 1 + 0.5)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (taps / taps.sum()).astype(np.float32)


def gaussian_blur(image: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(image, (0, 0), sigma) of a float32 [H, W] or
    [H, W, C] image: the taps of `gaussian_taps` along the rows, then the
    columns, with OpenCV's default border (BORDER_REFLECT_101, numpy's
    "reflect")."""
    taps = gaussian_taps(sigma)
    r = len(taps) // 2
    out = np.asarray(image, np.float64)
    for axis in (1, 0):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for k, t in enumerate(taps):
            acc += float(t) * (p[:, k:k + n] if axis == 1 else p[k:k + n])
        out = acc
    return out.astype(np.float32)


def generate(out_dir: str, n_frames: int = 120, seed: int = 11, device="cuda") -> str:
    """Render the proxy on `device` and write it as a TUM directory:
    rgb/ and depth/ PNGs, associate.txt, rgb.txt, depth.txt,
    groundtruth.txt and calib.txt. Returns out_dir."""
    import torch

    from texturefusion_torch.config import CameraConfig
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.core import se3
    from texturefusion_torch.io import png, synthetic
    from texturefusion_torch.utils.device import resolve_device

    device = resolve_device(str(device))
    camera = CameraConfig(**FR1_CAMERA)
    intr = cam.Intrinsics.from_config(camera)
    # keep per-frame motion at the nominal 120-frame cadence: short runs
    # render a short arc of the loop, not the whole loop compressed
    base = max(n_frames, 120)
    poses = synthetic.loop_trajectory(base, radius=1.5)[:n_frames]
    scene = synthetic.BoxRoomScene(**ROOM)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses, device=device)

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rng = np.random.default_rng(seed)
    t_off = np.eye(4, dtype=np.float32)
    t_off[:3, :3] = se3.matrix_from_quaternion(
        torch.tensor(GT_ROTATION, dtype=torch.float32)).numpy()
    t_off[:3, 3] = GT_TRANSLATION

    assoc, gt_lines, rgb_lines, depth_lines = [], [], [], []
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        ts = T0 + i / 30.0
        d = kinect_depth_noise(rng, d)
        d = depth_shadow_dropout(rng, d)
        gain = 1.0 + rng.normal(0.0, 0.02)          # auto-exposure flicker
        if EXPOSURE_RANGE[0] <= i < EXPOSURE_RANGE[1]:
            gain *= EXPOSURE_GAIN
        c = np.clip(c * gain, 0.0, 1.0)
        if i in BLUR_FRAMES:
            c = gaussian_blur(c, 3.0)
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        png.write_png(os.path.join(out_dir, rp), (c * 255).astype(np.uint8))
        png.write_png(os.path.join(out_dir, dp),
                      np.round(d * camera.depth_scale).astype(np.uint16))
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
        rgb_lines.append(f"{ts:.6f} {rp}")
        depth_lines.append(f"{ts:.6f} {dp}")
        g = t_off @ poses[i]
        q = se3.quaternion_from_matrix(torch.as_tensor(g[:3, :3])).numpy()
        gt_lines.append(f"{ts:.6f} " + " ".join(f"{v:.6f}" for v in (*g[:3, 3], *q)))

    with open(os.path.join(out_dir, "associate.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(depth_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    with open(os.path.join(out_dir, "calib.txt"), "w") as f:
        f.write(f"{camera.fx} {camera.fy} {camera.cx} {camera.cy} "
                f"{camera.width} {camera.height} {camera.depth_scale} "
                f"{camera.d0} {camera.d1} {camera.d2} {camera.d3} "
                f"{camera.d4}\n")
    print(f"wrote {n_frames}-frame fr1-proxy dataset to {out_dir}")
    return out_dir


def trajectory_ate(out_dir: str, root: str):
    """ATE RMSE (metres) of out_dir/trajectory.txt against
    root/groundtruth.txt after the Umeyama alignment, and the number of
    poses associated (timestamps within 10 ms)."""
    from texturefusion_torch.io import tum
    ts, est = tum.trajectory_from_tum(os.path.join(out_dir, "trajectory.txt"))
    gt_ts, gt = tum.trajectory_from_tum(os.path.join(root, "groundtruth.txt"))
    pairs = tum.associate_timestamps(ts, gt_ts, max_dt=0.01)
    if len(pairs) < 3:
        return float("nan"), len(pairs)
    return tum.ate_rmse(est[[i for i, _ in pairs]], gt[[j for _, j in pairs]]), len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="tum_fr1_proxy")
    ap.add_argument("--run", action="store_true",
                    help="run the port's command line over the generated dataset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from texturefusion_torch.utils.device import resolve_device
    resolve_device(args.device)
    generate(args.out, args.frames, device=args.device)
    if not args.run:
        return 0
    from texturefusion_torch.__main__ import main as cli_main
    out = os.path.join(args.out, "out")
    rc = cli_main([args.out, "", "0.02", "0", "--out", out, "--device", args.device])
    ate, n = trajectory_ate(out, args.out)
    print(f"trajectory.txt against groundtruth.txt: ATE RMSE {ate * 1e3:.3f} mm "
          f"over {n} poses")
    return rc


if __name__ == "__main__":
    sys.exit(main())
