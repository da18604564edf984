"""The texture consume's batched pass against the per-chunk loop it
replaced, and kernel K4 (csrc/atlas_blit.cu) against its plain version.

- `resize_patches` on the CPU against `resize_bilinear` of each region as
  the per-chunk loop cut it (corners truncated, at least a pixel a side,
  ends exclusive and clamped to the image), at patch sizes 16, 24 and 96:
  bit for bit.
- `TextureManager._consume` against the per-chunk loop, kept here as the
  oracle (`oracle_consume`, with the old `add_or_update_patch` and
  `atlas_uv`), on every consume of a small textured pipeline run on the
  CPU, with the atlas at its size and with an atlas that fills in the
  middle of a cycle: the atlas image, records and free list, every
  ChunkTexture field, the selector's labels, the carry, the transfers,
  the poisoned observations and the number of blits (the counter
  `tex_blits`), all equal.
- K4 on the card (cuda-marked) against `resize_patches`' plain version,
  bit for bit. This file imports neither JAX nor the JAX package, so it
  runs on the card's machine with `--noconftest -m cuda`.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as c
from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.texture import manager as mgr
from texturefusion_torch.texture.atlas import (Atlas, PatchRecord, resize_bilinear,
                                               resize_patches, roi_table)
from texturefusion_torch.utils.stopwatch import STOPWATCH

torch.set_num_threads(2)

H, W = 240, 320
# (bbox_min, bbox_max) of regions 1×1, 3×200, 17×23, 150×190, and ones
# clamped at the image's right and bottom edges
BOXES = [((10, 20), (10, 20)), ((5, 7), (204, 9)), ((40, 30), (62, 46)),
         ((100, 60), (289, 209)), ((300, 200), (319, 239)), ((250, 230), (400, 300)),
         ((0, 0), (0, 0)), ((319, 239), (319, 239))]
SIZES = (16, 24, 96)


def _images(n=2, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)
    return np.ascontiguousarray(np.cumsum(imgs, axis=2) % 256, np.uint8)   # some structure


def _old_cut(img, lo, hi):
    """The region add_or_update_patch cut before the batched pass."""
    x0, y0 = int(lo[0]), int(lo[1])
    x1 = max(int(hi[0]) + 1, x0 + 1)
    y1 = max(int(hi[1]) + 1, y0 + 1)
    return img[y0:y1, x0:x1]


def _table(seed=1):
    lo = np.asarray([b[0] for b in BOXES], np.float32)
    hi = np.asarray([b[1] for b in BOXES], np.float32)
    src = np.random.default_rng(seed).integers(0, 2, len(BOXES))
    return src, lo, hi, roi_table(src, lo, hi, H, W)


@pytest.mark.parametrize("size", SIZES)
def test_resize_patches_equals_resize_bilinear_of_the_old_cut(size):
    imgs = _images()
    src, lo, hi, table = _table()
    got = resize_patches([torch.from_numpy(i) for i in imgs], table, size)
    assert got.shape == (len(BOXES), size, size, 3) and got.dtype == np.uint8
    for i in range(len(BOXES)):
        want = resize_bilinear(_old_cut(imgs[src[i]], lo[i], hi[i]), size, size)
        np.testing.assert_array_equal(got[i], want)


def test_roi_table_refuses_a_region_outside_its_image():
    with pytest.raises(ValueError):
        roi_table(np.zeros(1), np.asarray([[W, 0.0]]), np.asarray([[W + 5.0, 4.0]]), H, W)
    with pytest.raises(ValueError):
        roi_table(np.zeros(1), np.asarray([[-2.0, 0.0]]), np.asarray([[5.0, 4.0]]), H, W)


# ------------------------------------------------- the per-chunk loop


def _old_add_or_update_patch(atlas, chunk_slot, kf_id, bbox_min, bbox_max, kf_rgb):
    """Atlas.add_or_update_patch as it was, one patch a call."""
    rec = atlas.patches.get(chunk_slot)
    if rec is None:
        if not atlas.free:
            atlas.overflowed = True
            return None
        rec = PatchRecord(atlas.free.pop(), kf_id, np.asarray(bbox_min), np.asarray(bbox_max))
        atlas.patches[chunk_slot] = rec
    rec.kf_id = kf_id
    rec.bbox_min = np.asarray(bbox_min)
    rec.bbox_max = np.asarray(bbox_max)
    roi = _old_cut(kf_rgb, rec.bbox_min, rec.bbox_max)
    ox, oy = atlas._slot_origin(rec.slot_index)
    atlas._ensure_rows(oy + atlas.patch_size)
    atlas.image[oy:oy + atlas.patch_size, ox:ox + atlas.patch_size] = resize_bilinear(
        roi, atlas.patch_size, atlas.patch_size)
    return rec


def _old_atlas_uv(atlas, chunk_slot, uv_img):
    rec = atlas.patches[chunk_slot]
    span = np.maximum(rec.bbox_max - rec.bbox_min, 1.0)
    rel = np.clip((uv_img - rec.bbox_min) / span, 0.0, 1.0)
    ox, oy = atlas._slot_origin(rec.slot_index)
    px = (ox + rel[:, 0] * (atlas.patch_size - 1)) / atlas.size
    py = (oy + rel[:, 1] * (atlas.patch_size - 1)) / atlas.size
    return np.stack([px, 1.0 - py], axis=-1)


class Twin:
    """Copies of what a consume writes: the oracle's side."""

    def __init__(self, tm, volume):
        self.cfg = tm.cfg
        self.atlas = copy.deepcopy(tm.atlas)
        self.chunk_tex = copy.deepcopy(tm.chunk_tex)
        self.labels = tm.selector.labels.copy()
        self.carry = set(tm._carry)
        self.kf_transfer = tm._kf_transfer
        self.obs_q, self.obs_mask = volume._obs_q.copy(), volume._obs_mask
        self.blits = 0
        self.stopped = None      # (chunk index, chunks projected) where the atlas filled


def oracle_consume(tw, mesher, rgb_host, kf_states, slots, want, rows, proj_kf, n_changed,
                   uv16, uv_ok, bmin, bmax, wrong, t_np, mt_np, mv_np):
    """TextureManager._consume as it was: one chunk an iteration."""
    m = min(n_changed, tw.cfg.patch_project_budget)
    projected = set()
    for i in range(m):
        s = int(slots[int(rows[i])])
        kf = int(proj_kf[i])
        projected.add(s)
        tex = tw.chunk_tex.setdefault(s, mgr.ChunkTexture())
        if wrong[i] or kf not in kf_states:
            if wrong[i] and kf >= 0 and tw.obs_mask[s, kf]:
                tw.obs_q[s, kf] = -1e11
            tex.wrong = True
            continue
        rec = tw.atlas.patches.get(s)
        escaped = (rec is not None and rec.kf_id == kf
                   and ((bmin[i] < rec.bbox_min - 0.5).any()
                        or (bmax[i] > rec.bbox_max + 0.5).any()))
        if rec is None or rec.kf_id != kf or escaped:
            rec = _old_add_or_update_patch(tw.atlas, s, kf, bmin[i], bmax[i], rgb_host(kf))
            if rec is None:
                tw.carry = set()
                tw.stopped = (i, m)
                return
            tw.blits += 1
        nv = int(mesher.vcount[s])
        tex.label = kf
        tex.wrong = False
        tw.labels[s] = kf
        tex.uv16 = uv16[i, :nv]
        tex.atlas_uv = _old_atlas_uv(tw.atlas, s, uv16[i, :nv].astype(np.float32) / 16.0)
        tex.uv_valid = uv_ok[i, :nv]
    if n_changed > m:
        in_graph = set(slots.tolist())
        tw.carry = {s for s in want if s not in projected and s in in_graph}
    else:
        tw.carry = set()
    tw.kf_transfer = {kf: (t_np[kf], mt_np[kf], mv_np[kf])
                      for kf in sorted(kf_states) if kf < len(t_np)}


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _assert_equal(tm, volume, tw):
    a, b = tm.atlas, tw.atlas
    np.testing.assert_array_equal(a.image, b.image)
    assert a.free == b.free and a.overflowed == b.overflowed
    assert a.patches.keys() == b.patches.keys()
    for s, r in a.patches.items():
        o = b.patches[s]
        assert (r.slot_index, r.kf_id) == (o.slot_index, o.kf_id)
        assert _same(r.bbox_min, o.bbox_min) and _same(r.bbox_max, o.bbox_max)
    assert tm.chunk_tex.keys() == tw.chunk_tex.keys()
    for s, t in tm.chunk_tex.items():
        o = tw.chunk_tex[s]
        assert (t.label, t.wrong) == (o.label, o.wrong), s
        for f in ("uv16", "atlas_uv", "uv_valid", "color_adjust"):
            assert _same(getattr(t, f), getattr(o, f)), (s, f)
    np.testing.assert_array_equal(tm.selector.labels, tw.labels)
    assert tm._carry == tw.carry
    assert (tm._kf_transfer is None) == (tw.kf_transfer is None)
    if tm._kf_transfer is not None:
        assert tm._kf_transfer.keys() == tw.kf_transfer.keys()
        for k, tr in tm._kf_transfer.items():
            assert all(_same(x, y) for x, y in zip(tr, tw.kf_transfer[k]))
    np.testing.assert_array_equal(volume._obs_q, tw.obs_q)


def _run_against_oracle(monkeypatch, atlas_size=None):
    """A small textured pipeline on the CPU (11 orbit frames, packed with
    their host copies), every consume checked against the oracle on
    copies of the state. Returns (pipe, [(blits, oracle blits, stopped)])."""
    cfg = c._pipeline_config(small=True)
    if atlas_size is not None:
        cfg = cfg.replace(texture=dataclasses.replace(cfg.texture, atlas_size=atlas_size))
    _, packed = c._orbit_frames(cfg, 11)
    real = mgr.TextureManager._consume
    pipes, checks = [], []

    def both(self, volume, mesher, kf_states, *out):
        tw = Twin(self, volume)
        oracle_consume(tw, mesher, lambda k: pipes[0].kf_states[k].rgb_np(), kf_states, *out)
        before = STOPWATCH.counts.get("tex_blits", 0)
        real(self, volume, mesher, kf_states, *out)
        _assert_equal(self, volume, tw)
        checks.append((STOPWATCH.counts.get("tex_blits", 0) - before, tw.blits, tw.stopped))

    monkeypatch.setattr(mgr.TextureManager, "_consume", both)
    # the oracle reads each keyframe's host rgb from the pipeline
    from texturefusion_torch.fusion import pipeline as pl
    real_pipe_init = pl.TexturedPipeline.__init__

    def pipe_init(self, *a, **kw):
        pipes.append(self)
        real_pipe_init(self, *a, **kw)

    monkeypatch.setattr(pl.TexturedPipeline, "__init__", pipe_init)
    pipe, _, _ = c.run_pipeline(cfg, packed, "cpu", textured=True)
    return pipe, checks


def test_consume_equals_the_per_chunk_loop(monkeypatch):
    pipe, checks = _run_against_oracle(monkeypatch)
    assert len(checks) >= 3 and sum(o for _, o, _ in checks) > 0
    assert all(got == want for got, want, _ in checks)
    assert all(stop is None for _, _, stop in checks)
    # the blits read rgb_np()'s bytes, taken from the packed frames
    sts = list(pipe.kf_states.values())
    assert all(np.array_equal(st.rgb_blit().numpy(), st.rgb_np()) for st in sts)
    assert all(st.rgb_blit() is not st.rgb for st in sts)


def test_rgb_blit_holds_the_host_bytes():
    """The device rgb is rounded from float and may differ from the host
    copy by a level (on the card a division by 255 is a multiplication
    by its reciprocal): the blits' source is the host copy's bytes, also
    for a keyframe restored from a checkpoint (no device copy yet), and
    rgb itself where the host copy is read from it."""
    from texturefusion_torch.fusion.pipeline import KeyframeFusionState
    rgb = torch.from_numpy(_images(1)[0])
    host = (_images(1)[0] ^ 1).astype(np.uint8)
    z = torch.zeros(H, W)
    st = KeyframeFusionState(0, 0, z, rgb, z, [], [], rgb_host=host)
    np.testing.assert_array_equal(st.rgb_blit().numpy(), host)
    st = KeyframeFusionState(0, 0, z, rgb, z, [], [])
    assert st.rgb_blit() is rgb
    st.rgb_np()
    assert st.rgb_blit() is rgb


def test_consume_equals_the_per_chunk_loop_when_the_atlas_fills(monkeypatch):
    cfg = c._pipeline_config(small=True)
    size = Atlas(cfg.texture, cfg.tsdf.voxel_resolution).patch_size * 3   # 9 slots
    _, checks = _run_against_oracle(monkeypatch, atlas_size=size)
    assert all(got == want for got, want, _ in checks)
    stops = [s for _, _, s in checks if s is not None]
    assert any(0 < i < m - 1 for i, m in stops), checks     # filled mid-batch


# --------------------------------------------------------------- K4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_k4_refuses_cpu_tensors():
    before = dict(cuda_kernels.LAUNCHES)
    _, _, _, table = _table()
    with pytest.raises(ValueError):
        cuda_kernels.atlas_blit_cuda([torch.from_numpy(i) for i in _images()], table, 24)
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_k4_matches_plain_bit_for_bit(cuda_device, size):
    imgs = _images(3, seed=size)
    src, lo, hi, table = _table()
    rng = np.random.default_rng(size)
    n = 2048 if size < 96 else 384
    lo_r = rng.uniform(0, [W - 1, H - 1], (n, 2)).round()
    hi_r = np.minimum(lo_r + rng.uniform(0, 120, (n, 2)).round(), [W - 1, H - 1])
    table = np.concatenate([table, roi_table(rng.integers(0, 3, n), lo_r, hi_r, H, W)])
    host = [torch.from_numpy(i) for i in imgs]
    want = resize_patches(host, table, size)
    before = cuda_kernels.LAUNCHES["atlas_blit"]
    got = resize_patches([t.to(cuda_device) for t in host], table, size)
    assert cuda_kernels.LAUNCHES["atlas_blit"] == before + 1
    np.testing.assert_array_equal(got, want)
