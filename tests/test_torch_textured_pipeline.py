"""TexturedPipeline, port against the JAX package.

tests/test_torch_pipeline.py's synchronous setting carries over: the
rows config (local_frames_per_keyframe = 0), the same RANSAC draws on
both sides, the test-side discovery at integration on both sides, and on
the JAX side its pose sync and the TPU kernel's bilateral step. The JAX side here is a
TexturedPipeline with those overrides whose finish() ends with the
texture catch-up (the JAX package runs it only with async_cycle_results,
the port always). Chunks are matched by chunk id.

On 10 orbit frames (one keyframe, textured at finish): labels and wrong
flags equal, the same patched chunks; where both meshes of a chunk
agree, the same patch records, atlas uvs within 1e-4 on ≥ 99% of the
vertices, atlas tiles within one level on ≥ 99% of the values and
exported vertex colours within 2/255; the exports' v / vt / f counts
within 0.2%, as the meshes' (tests/test_torch_pipeline.py). On 11 orbit
frames (three keyframes, texture cycles during the loop) the labels
agree on ≥ 99% of the chunks. With the fusion thread
(async_fusion=True) the port's textured run equals its synchronous one.
A dropped slot's texture state is released (fault 8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxKeyDraws, tracked2_draws
from test_torch_pipeline import (CFG0, JI, SCENE, SYNC, JaxSyncPipeline, PortSyncPipeline,
                                 _pallas_bilateral)
from texturefusion_tpu.fusion.pipeline import TexturedPipeline as JTextured
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_torch import TexturedPipeline
from texturefusion_torch.io import png

torch.set_num_threads(2)


class JaxSyncTextured(JaxSyncPipeline, JTextured):
    """JaxSyncPipeline's discovery and pose sync, with texturing."""

    def finish(self):
        super().finish()
        self._texture_final()


class PortSyncTextured(PortSyncPipeline, TexturedPipeline):
    """PortSyncPipeline's discovery at integration, with texturing."""


def _port(cfg, depths, rgbs):
    pipe = PortSyncTextured(cfg, device="cpu", draw_fn=JaxKeyDraws(),
                            frame_draws=lambda i: tracked2_draws(jax.random.PRNGKey(7), i,
                                                                 cfg.tracking))
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        pipe.process_frame(d, c, timestamp=float(i))
    pipe.finish()
    pipe.close()
    return pipe


def _jax(cfg, depths, rgbs):
    pipe = JaxSyncTextured(cfg)
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        pipe.process_frame(jnp.asarray(d), jnp.asarray(c), timestamp=float(i))
    pipe.finish()
    return pipe


@pytest.fixture(scope="module")
def runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        jax.clear_caches()
        try:
            for n in (10, 11):
                poses = jsyn.orbit_trajectory(n)
                depths, rgbs = jsyn.render_sequence(SCENE, JI, poses)
                out[n] = (_jax(CFG0, depths, rgbs), _port(CFG0, depths, rgbs), depths, rgbs)
        finally:
            jax.clear_caches()
    return out


def _by_id(pipe):
    """chunk id → (slot, ChunkTexture) of the chunks with texture state."""
    ids = pipe.volume.ids
    return {tuple(ids[s].tolist()): (s, t) for s, t in pipe.texture.chunk_tex.items()}


def _tile(atlas, rec):
    ox, oy = atlas._slot_origin(rec.slot_index)
    return atlas.image[oy:oy + atlas.patch_size, ox:ox + atlas.patch_size].astype(np.int64)


def _export(pipe, out_dir):
    """Export, then split the OBJ's v records (position, colour) by chunk
    in export order: {slot: [k, 6]}, and the vt and f counts."""
    path = pipe.export_textured(out_dir)
    recs = {"v": [], "vt": [], "f": []}
    for ln in open(path):
        key = ln.split(" ", 1)[0]
        if key in recs:
            recs[key].append(ln.split()[1:])
    v = np.asarray(recs["v"], np.float64)
    chunks, base = {}, 0
    meshes = pipe.mesher.meshes
    for s in sorted(pipe.texture.chunk_tex):
        tex = pipe.texture.chunk_tex[s]
        if tex.atlas_uv is None or s not in meshes:
            continue
        k = min(len(meshes[s][0]), len(tex.atlas_uv))
        chunks[s] = v[base:base + k]
        base += k
    assert base == len(v)
    return chunks, len(recs["vt"]), len(recs["f"])


def test_textured_pipeline_matches_jax(runs, tmp_path):
    """Chunks whose meshes differ (a voxel at the edge of the band,
    tests/test_torch_pipeline.py) are compared by count only: at most two
    of the patched chunks (the chunks that share a flipped voxel's cells),
    and vertex, uv and face counts within 0.2%."""
    jp, tp, _, _ = runs[10]
    assert len(tp.slam.keyframes) == len(jp.slam.keyframes) == 1
    t, j = _by_id(tp), _by_id(jp)
    assert t.keys() == j.keys() and len(t) > 20
    assert [t[c][1].label for c in t] == [j[c][1].label for c in t]
    assert [t[c][1].wrong for c in t] == [j[c][1].wrong for c in t]
    t_patched = {c for c, (s, _) in t.items() if s in tp.texture.atlas.patches}
    assert t_patched == {c for c, (s, _) in j.items() if s in jp.texture.atlas.patches}
    assert len(t_patched) > 20
    same_mesh = [c for c in sorted(t_patched)
                 if tp.mesher.vcount[t[c][0]] == jp.mesher.vcount[j[c][0]]]
    assert len(t_patched) - len(same_mesh) <= 2
    close, uv_close = [], []
    for c in same_mesh:
        (ts, tt), (js, jt) = t[c], j[c]
        trec, jrec = tp.texture.atlas.patches[ts], jp.texture.atlas.patches[js]
        assert (trec.slot_index, trec.kf_id) == (jrec.slot_index, jrec.kf_id)
        np.testing.assert_array_equal(trec.bbox_min, jrec.bbox_min)
        np.testing.assert_array_equal(trec.bbox_max, jrec.bbox_max)
        np.testing.assert_array_equal(tt.uv_valid, jt.uv_valid)
        uv_close.append(np.abs(tt.atlas_uv - jt.atlas_uv).max(-1) <= 1e-4)
        close.append(np.abs(_tile(tp.texture.atlas, trec) - _tile(jp.texture.atlas, jrec)) <= 1)
    # one uv16 step (1/16 px, the projections' rounding) moves an atlas uv
    # by up to (patch - 1) / (16 · bbox span · atlas size)
    assert np.mean(np.concatenate(uv_close)) >= 0.99
    assert np.mean(np.concatenate([a.ravel() for a in close])) >= 0.99

    (tc, tvt, tf), (jc, jvt, jf) = (_export(p, str(tmp_path / n))
                                    for p, n in ((tp, "port"), (jp, "jax")))
    nt, nj = sum(map(len, tc.values())), sum(map(len, jc.values()))
    for a, b in ((nt, nj), (tvt, jvt), (tf, jf)):
        assert abs(a - b) <= 0.002 * b and b > 100, (a, b)
    assert tc.keys() == jc.keys()
    for c in same_mesh:
        got, want = tc[t[c][0]], jc[j[c][0]]
        np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-5)   # as the meshes
        assert np.abs(got[:, 3:] - want[:, 3:]).max() <= 2 / 255
    img = png.read_png(str(tmp_path / "port" / "model.png"))
    assert img.shape == (tp.texture.atlas.used_rows(), tp.texture.atlas.size, 3)


def test_textured_pipeline_with_cycles_matches_jax(runs):
    """11 orbit frames: three keyframes, so texture cycles run during the
    loop (keyframe stack rows, warm starts, carried labels)."""
    jp, tp, _, _ = runs[11]
    assert len(tp.slam.keyframes) == len(jp.slam.keyframes) >= 2
    jv, tv = jp.volume, tp.volume
    np.testing.assert_array_equal(tv.ids[tv.used], jv.ids[jv.used])
    t, j = _by_id(tp), _by_id(jp)
    common = sorted(t.keys() & j.keys())
    assert len(common) >= 0.99 * len(j) and len(common) > 20
    same = [t[c][1].label == j[c][1].label for c in common]
    assert np.mean(same) >= 0.99
    assert len({t[c][1].label for c in common}) >= 2       # more than one keyframe used
    assert tp.texture.kf_stack.present == jp.texture.kf_stack.present


def test_async_textured_run_matches_sync(runs):
    """The same 11 frames with the fusion thread: the keyframe images and
    poses a cycle's texture stage reads are taken when it is submitted,
    so the run equals the synchronous one."""
    _, sync, depths, rgbs = runs[11]
    cfg = CFG0.replace(parallel=dataclasses.replace(SYNC, async_fusion=True))
    pipe = _port(cfg, depths, rgbs)
    np.testing.assert_allclose(pipe.trajectory(), sync.trajectory(), atol=1e-6, rtol=0)
    a, s = _by_id(pipe), _by_id(sync)
    assert a.keys() == s.keys()
    for c in a:
        assert a[c][1].label == s[c][1].label and a[c][1].wrong == s[c][1].wrong
        if a[c][1].atlas_uv is not None:
            np.testing.assert_array_equal(a[c][1].uv16, s[c][1].uv16)
    np.testing.assert_array_equal(pipe.texture.atlas.image, sync.texture.atlas.image)


def test_dropped_slots_release_their_texture(runs):
    """ROADMAP Queue 3 fault 8: when the mesher drops a textured slot (GC,
    streaming), the port forgets its atlas patch, ChunkTexture, label and
    moment rows and warm start; the JAX package keeps them, so a recycled
    slot starts from the last chunk's patch and label."""
    jp, tp, _, _ = runs[10]
    slot = next(s for s in sorted(tp.texture.chunk_tex) if s in tp.texture.atlas.patches)
    atlas_index = tp.texture.atlas.patches[slot].slot_index
    tp.mesher.drop([slot])
    tm = tp.texture
    assert slot not in tm.chunk_tex and slot not in tm.atlas.patches
    assert tm.atlas.free[-1] == atlas_index and tm.selector.labels[slot] == -1
    assert int(tm._labels_dev[slot]) == -1 and float(tm._stats_dev[slot].abs().sum()) == 0.0
    jslot = next(s for s in sorted(jp.texture.chunk_tex) if s in jp.texture.atlas.patches)
    jp.mesher.drop([jslot])
    assert jslot in jp.texture.chunk_tex and jslot in jp.texture.atlas.patches
    assert int(np.asarray(jp.texture._labels_dev)[jslot]) >= 0
