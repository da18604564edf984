#!/usr/bin/env python3
"""Time kernel K2 alone at several widths, in this checkout or another one.

    python3 tools/k2_widths.py [--root DIR] [--widths 241,1008,2048]

Loads `texturefusion_torch` from DIR (default: this checkout), builds its
kernels and prints one JSON line: the card's name and power limit, and
for each width (chunks listed in one launch) the warm and cold
milliseconds of chip_smoke.k2_width_times (+1 on pre-integrated rows of
the "wide" scene). A checkout whose K2 wrapper still takes `n_lanes`
gets the slot list padded to its budget (1024, or the width when larger)
with active flags, as its TSDFVolume passed it. To compare two versions
of the kernel, run both in one command on one card, in turns (A, B, B, A).
"""

import argparse
import importlib.util
import inspect
import json
import os
import sys

import torch


def _padded_launch(cuda_kernels):
    """A K2 launch for a wrapper that takes a padded list and n_lanes, for
    one width; the padding is made on the first (warm-up) call, outside
    the timing."""
    cache = {}

    def launch(rows, slots, origins, d, rgb, q, pose, sign, intr, cfg):
        w = slots.numel()
        if "idx" not in cache:
            u = max(1024, w)
            pad = torch.full((u - w,), cfg.capacity, dtype=torch.int64, device=slots.device)
            cache["idx"] = torch.cat([slots, pad])
            cache["active"] = torch.arange(u, device=slots.device) < w
        return cuda_kernels.tsdf_integrate_cuda(*rows, cache["idx"], cache["active"], origins,
                                                d, rgb, q, pose, sign, intr, cfg, n_lanes=w)
    return launch


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--widths", default="241,1008,2048")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k2_widths.py needs CUDA: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.abspath(a.root))
    # this checkout's chip_smoke, whichever package it then imports
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from texturefusion_torch.ops import cuda_kernels
    cuda_kernels.build()
    padded = "n_lanes" in inspect.signature(cuda_kernels.tsdf_integrate_cuda).parameters
    times = {}
    for w in (int(x) for x in a.widths.split(",")):
        warm, cold = chip_smoke.k2_width_times(w, _padded_launch(cuda_kernels) if padded else None)
        times[w] = {"kernel_ms": warm, "kernel_cold_ms": cold}
    print(json.dumps({"root": a.root, "card": chip_smoke.nvidia_smi("name,power.limit"),
                      "padded_list": padded, "k2": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
