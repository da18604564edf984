#!/usr/bin/env python3
"""Where the GPU and the CPU part: the tiny orbit through
ReconstructionPipeline on both devices with the same draws, every fetch
landed at once, each stage of each frame recorded.

    python3 tools/device_lockstep.py 14:s 20:p    # frames:tracker (s synchronous, p pipelined)

Records, in call order: preprocess_bundle (depth, grey image, blur
score), extract_features (keypoints and descriptors), every registration
(stats, matches, inliers) and every BA (poses in and out). For each
frames:tracker pair it runs the GPU twice and the CPU once and prints
the keyframes of each run, the per-frame position differences, a
SUMMARY line (the records whose discrete values — descriptor bits,
matches, inliers, levels, validity — differ between GPU and CPU), and
every record's largest GPU-against-CPU difference.

Run it from the repository root on a machine with an NVIDIA GPU; it
builds the kernels as chip_smoke.py does.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from texturefusion_torch.models import reconstruction as rec  # noqa: E402
from texturefusion_torch.ops import preprocess  # noqa: E402
from texturefusion_torch.slam import fastba, gcslam  # noqa: E402
from texturefusion_torch.utils import async_fetch  # noqa: E402

RECORDS = []


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _record(mod, name, tag, fields):
    fn = getattr(mod, name)

    def recorded(*a, **k):
        out = fn(*a, **k)
        RECORDS.append((tag, [_np(v) for v in fields(a, out)]))
        return out

    setattr(mod, name, recorded)


def _keypoints(kp):
    return [kp.uv, kp.desc, kp.valid, kp.points3d, kp.level, kp.angle, kp.response]


_record(preprocess, "preprocess_bundle", "bundle", lambda a, o: [o[0], o[3], o[4]])
_record(rec, "extract_features", "features", lambda a, o: _keypoints(o))
for _mod in (rec, gcslam):
    _record(_mod, "register_frames", "register", lambda a, o: [o.stats, o.match_idx, o.inliers])
_record(gcslam, "register_frames_batch", "register_batch",
        lambda a, o: [o.stats, o.match_idx, o.inliers])
_record(fastba, "optimize", "ba", lambda a, o: [a[0], o[0], o[2]])


def run(config, packed, device):
    RECORDS.clear()
    pipe = c.run_pipeline(config, packed, device, c.cpu_draw_fn(config.tracking))[0]
    out = (list(RECORDS), pipe.trajectory(), [k.frame_index for k in pipe.slam.keyframes])
    pipe.close()
    return out


def difference(a, b):
    """Largest |a - b| of float arrays, count of unequal entries otherwise."""
    if a.shape != b.shape:
        return f"shape {a.shape} vs {b.shape}"
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        return int((a != b).sum())
    return float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0


def discrete_parts(ra, rb):
    """Indices of the records whose tags or discrete fields differ."""
    out = []
    for i, ((ta, va), (tb, vb)) in enumerate(zip(ra, rb)):
        ds = [difference(x, y) for x, y in zip(va, vb)]
        if ta != tb or any(not isinstance(d, float) and d != 0 for d in ds):
            out.append(i)
    return out


def main() -> int:
    c.phase_device()
    c.phase_build()
    async_fetch.fetch_async = c.LandedFetch
    for arg in sys.argv[1:]:
        n, tracker = arg.split(":")
        config = c._pipeline_config(small=True, pipelined=tracker == "p")
        _, packed = c._orbit_frames(config, int(n))
        g1, t1, k1 = run(config, packed, "cuda")
        _, t2, k2 = run(config, packed, "cuda")
        cp, tc, kc = run(config, packed, "cpu")
        same_shape = t1.shape == tc.shape
        pos = np.abs(t1[:, :3, 3] - tc[:, :3, 3]).max(-1) * 1e3 if same_shape else None
        print(f"#### frames={n} pipelined={tracker == 'p'} keyframes gpu={k1} gpu again={k2} "
              f"cpu={kc}")
        print("position difference gpu-cpu mm",
              None if pos is None else np.round(pos, 4).tolist())
        print("position difference gpu-gpu mm",
              np.round(np.abs(t1[:, :3, 3] - t2[:, :3, 3]).max(-1) * 1e3, 4).tolist())
        print(f"SUMMARY frames={n} pipelined={tracker == 'p'} keyframes_equal={k1 == kc} "
              f"position_max_mm={None if pos is None else float(pos.max())} "
              f"records={len(g1)}/{len(cp)} discrete_parts={discrete_parts(g1, cp)[:10]}",
              flush=True)
        for i, ((ta, va), (tb, vb)) in enumerate(zip(g1, cp)):
            if ta != tb:
                print(f"  {i}: the runs part: {ta} vs {tb}")
                break
            print(f"  {i} {ta} {[difference(x, y) for x, y in zip(va, vb)]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
