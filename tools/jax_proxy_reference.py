#!/usr/bin/env python3
"""Counter reference for chip_smoke.py's [fr1-proxy] phase: the JAX
package's command line and the port's on one fr1 proxy, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_proxy_reference.py [--frames 120] [--scale 0.5]
                                                          [--voxel 0.02] [--out DIR]

The proxy is examples/make_tum_proxy.py's (the JAX generator), with the
fr1 camera scaled by --scale (the distortion kept, as
tests/test_ate_proxy_cli.py scales it). Runs of `CLI ROOT "" VOXEL 0
--no-texture` on it (the generator's --run arguments, untextured: the
JAX command line's textured export trips its fault 1, ROADMAP Queue 3,
on this proxy): the JAX command line at its default configuration, the
same with its fault 16 repaired as the parity tests repair it (a
deferred probe's candidate 0 is the superseded keyframe; ROADMAP Queue
3), the JAX command line at the synchronous configuration its default
was when docs/ATE_PROXY.md was recorded (defer_promote=False,
ParallelConfig(async_fusion=False, pipelined_tracking=False,
async_cycle_results=False)), and the port's command line (--device cpu,
its default configuration), untextured and textured. It prints one JSON
line with each run's keyframes, reintegrations, BA rounds (the count of
the "cpp_ba" stopwatch, which only the deferred promotion runs: 0 in the
synchronous configuration), chunks created (in all, within the drift
reintegrations, and elsewhere within finish()), chunks meshed, vertices, ATE and the discovery prefetches
deferred as stale. Needs jax; takes ~15 minutes and a few GB of memory
at --scale 0.5.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _repair_fault16(jslam):
    """The JAX GCSLAM's deferred probe with the superseded keyframe as its
    candidate 0: the keyframe adopted just before is set aside while the
    probe dispatches (tests/test_torch_gcslam.py's repair)."""
    promote_dispatch, dispatch_probe = jslam._promote_dispatch, jslam._dispatch_probe

    def promote(self, *args, **kw):
        self._probing_parent = True
        try:
            return promote_dispatch(self, *args, **kw)
        finally:
            self._probing_parent = False

    def probe(self, *args, **kw):
        if not getattr(self, "_probing_parent", False):
            return dispatch_probe(self, *args, **kw)
        adopted = self.keyframes.pop()
        try:
            return dispatch_probe(self, *args, **kw)
        finally:
            self.keyframes.append(adopted)

    def restore():
        jslam._promote_dispatch, jslam._dispatch_probe = promote_dispatch, dispatch_probe

    jslam._promote_dispatch, jslam._dispatch_probe = promote, probe
    return restore


def _count_creations(volume_cls, pipeline_cls, counts):
    """Count into `counts` the chunks each volume creates: within the
    drift reintegrations (`_reintegrate_drifted`), and elsewhere in
    finish() and out of it."""
    register = volume_cls._register_new

    def counted_register(self, new_slots):
        where = ("in_reintegration" if counts["reintegrating"]
                 else "in_finish" if counts["finishing"] else "elsewhere")
        counts[where] += len(new_slots)
        return register(self, new_slots)

    def flagged(fn, flag):
        def wrapped(self, *args, **kw):
            counts[flag] = True
            try:
                return fn(self, *args, **kw)
            finally:
                counts[flag] = False
        return wrapped

    volume_cls._register_new = counted_register
    pipeline_cls.finish = flagged(pipeline_cls.finish, "finishing")
    pipeline_cls._reintegrate_drifted = flagged(pipeline_cls._reintegrate_drifted,
                                                "reintegrating")


def _synchronous(apply_params):
    """The JAX command line's apply_params, then its round-5 settings."""
    from texturefusion_tpu.config import ParallelConfig

    def wrapped(config, params):
        config = apply_params(config, params)
        return config.replace(
            tracking=dataclasses.replace(config.tracking, defer_promote=False),
            parallel=ParallelConfig(async_fusion=False, pipelined_tracking=False,
                                    async_cycle_results=False))
    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--voxel", default="0.02")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(4)

    import chip_smoke
    from texturefusion_torch import __main__ as tmain
    from texturefusion_torch.fusion import chunkmap as tchunkmap
    from texturefusion_torch.fusion import pipeline as tpipeline
    from texturefusion_torch.utils.stopwatch import STOPWATCH as TSTOPWATCH
    from texturefusion_tpu import __main__ as jmain
    from texturefusion_tpu.fusion import chunkmap as jchunkmap
    from texturefusion_tpu.fusion import pipeline as jpipeline
    from texturefusion_tpu.slam.gcslam import GCSLAM as JGCSLAM
    from texturefusion_tpu.utils.stopwatch import STOPWATCH as JSTOPWATCH
    jmk = chip_smoke.load_tool("make_tum_proxy", "examples")
    tmk = chip_smoke.load_tool("make_tum_proxy")

    for k in ("width", "height"):
        jmk.FR1_CAMERA[k] = int(round(jmk.FR1_CAMERA[k] * args.scale))
    for k in ("fx", "fy", "cx", "cy"):
        jmk.FR1_CAMERA[k] = jmk.FR1_CAMERA[k] * args.scale
    tmp = None if args.out else tempfile.TemporaryDirectory()
    root = args.out or os.path.join(tmp.name, "fr1_proxy")
    with contextlib.redirect_stdout(io.StringIO()):
        jmk.generate(root, n_frames=args.frames)

    counts = {"finishing": False, "reintegrating": False}
    _count_creations(jchunkmap.TSDFVolume, jpipeline.ReconstructionPipeline, counts)
    _count_creations(tchunkmap.TSDFVolume, tpipeline.ReconstructionPipeline, counts)

    def run(name, fn, textured=False):
        out = os.path.join(root, name)
        JSTOPWATCH.reset()
        TSTOPWATCH.reset()
        counts.update(in_reintegration=0, in_finish=0, elsewhere=0)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = fn([root, "", args.voxel, "0", "--out", out]
                    + ([] if textured else ["--no-texture"]))
        deferred = (JSTOPWATCH.counts.get("disco_pref_defer", 0)
                    + TSTOPWATCH.counts.get("disco_pref_defer", 0))
        res = chip_smoke.check_cli_outputs(out, args.frames, textured=textured)
        ate_m, n_pairs = tmk.trajectory_ate(out, root)
        return dict(chip_smoke.cli_run_stats(out),
                    created_in_reintegration=counts["in_reintegration"],
                    created_in_finish_otherwise=counts["in_finish"], rc=rc, verts=res["verts"], ate_mm=round(ate_m * 1e3, 3), poses=n_pairs,
                    prefetches_deferred=deferred)

    runs = {"jax_default": run("jax_default", jmain.main)}
    restore = _repair_fault16(JGCSLAM)
    try:
        runs["jax_default_fault16_repaired"] = run("jax_default_fault16_repaired", jmain.main)
    finally:
        restore()
    apply_params = jmain.apply_params
    jmain.apply_params = _synchronous(apply_params)
    try:
        runs["jax_synchronous"] = run("jax_synchronous", jmain.main)
    finally:
        jmain.apply_params = apply_params
    for textured in (False, True):
        runs["port_default" + ("_textured" if textured else "")] = run(
            "port_default" + ("_textured" if textured else ""),
            lambda a: tmain.main(a + ["--device", "cpu"]), textured=textured)
    print(json.dumps({"frames": args.frames, "scale": args.scale, "voxel": float(args.voxel),
                      "camera": {k: jmk.FR1_CAMERA[k] for k in ("width", "height", "fx")},
                      "runs": runs}))
    if tmp is not None:
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
