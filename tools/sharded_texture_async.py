#!/usr/bin/env python3
"""The textured pipeline over a sharded pool, with the fusion thread
against the same run without it, on the card(s).

    python3 tools/sharded_texture_async.py [--frames 120]

Runs chip_smoke's bench loop (the hardened VGA loop) through
TexturedPipeline with the TSDF rows, the mesh pool and BA's edges over
chip_smoke's 4 shards (one a card where 4 cards exist, else 4 shards of
the first), twice: synchronous, and with parallel.async_fusion, where the
texture cycles, and their gathers of pool rows from the other cards'
shards, run on the fusion thread and its stream. A gather that overtook
a shard's remesh would read stale rows. Prints the card's name and power
limit, then one JSON line: the largest position difference, the share of
chunks (by id) with the same label and of textured chunks with the same
uvs, whether the atlases are equal, frames/s of each run, and
chip_smoke.sharded_cycle_check on the threaded run; exits 1 when that
cycle is not exact.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    print(c.phase_device())
    c.phase_build()
    cfg = c._tracked_config(False)
    _, _, packed = c._frames(cfg, args.frames, "cuda", harden=True)
    mesh, where = c._shards()
    runs = {}
    for name, threaded in (("sync", False), ("async", True)):
        config = c._pipeline_config(async_fusion=threaded)
        c.run_pipeline(config, packed[:10], "cuda", textured=True, mesh=mesh)[0].close()
        pipe, loop, _ = c.run_pipeline(config, packed, "cuda", textured=True, mesh=mesh)
        pipe.close()
        runs[name] = (pipe, len(packed) / loop)
    (s, s_fps), (a, a_fps) = runs["sync"], runs["async"]
    ids_s, ids_a = s.volume.ids, a.volume.ids
    tex_s = {tuple(ids_s[k].tolist()): t for k, t in s.texture.chunk_tex.items()}
    tex_a = {tuple(ids_a[k].tolist()): t for k, t in a.texture.chunk_tex.items()}
    common = sorted(tex_s.keys() & tex_a.keys())
    uv = [k for k in common if tex_s[k].uv16 is not None and tex_a[k].uv16 is not None]
    out = {
        "where": where, "frames": len(packed),
        "position_diff_mm": float(np.abs(s.trajectory()[:, :3, 3]
                                         - a.trajectory()[:, :3, 3]).max() * 1e3),
        "chunks": [len(tex_s), len(tex_a), len(common)],
        "same_label": float(np.mean([tex_s[k].label == tex_a[k].label for k in common])),
        "same_uv16": float(np.mean([np.array_equal(tex_s[k].uv16, tex_a[k].uv16)
                                    for k in uv])) if uv else None,
        "atlas_equal": bool(np.array_equal(s.texture.atlas.image, a.texture.atlas.image)),
        "fps": {"sync": s_fps, "async": a_fps},
        "cycle": c.sharded_cycle_check(a),
    }
    print(json.dumps(out))
    return 0 if out["cycle"]["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
