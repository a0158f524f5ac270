"""The port's multi-device layer (parallel/sharded.py) on the CPU, over gloo.

Four rank processes (tests/_torch_sharded_worker.py: torch and the port
only) are spawned by a module fixture, so once for each pytest-xdist worker
that runs a case of this file: under ``--dist loadfile`` (the tier-1
command) one worker takes the whole file, so four processes in all. They
serve every case; each case sends its job to all four, so a (1, 2) mesh
leaves ranks 2 and 3 outside.
The JAX package runs in this process on the conftest's 8-device CPU mesh.

  * the exact sharded frame against JAX ``render_frame_sharded`` on a
    (2, 2) mesh: images within 1e-3, num_pairs and num_slab_overflow equal;
  * the fast path's exchange stage by stage against JAX: the JAX package's
    block frames and big sets of each shard (its readable projection and
    ``build_block_frame2``, no Pallas) go through sharded.py:216-279
    written in numpy here and through the port's ``exchange_blocks`` and
    ``gather_bigs`` on the ranks; the pools, big sets and JAX's
    ``bin_blocks2``/``bin_bigs`` at ``tile_row_offset=y0`` must be
    bit-equal on every rank (the render from there on is held to JAX by
    the render tests); and the whole fast sharded frame against JAX's;
  * a wide splat that a slab emits in another group than the whole frame
    (a tier against the base): JAX's sharded exact frame differs from its
    single-device frame, the port's does the same, and the two sharded
    frames agree within 1e-3; with one emission group they agree with
    the single-device frames;
  * the port against itself: the exact sharded frame equal to the
    quirk-free ``render_frame`` within 1e-3, the fast one at >= 40 dB
    against the single-device fast frame with whole-superblock shards
    (slab padding at 160 px, tile 32, 4 ways), the exchange overflow
    counted exactly, and ``make_mesh``'s shapes and errors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import blocks2 as blocks_t
from godotgaussiansplatting_torch.ops import projection as projection_t
from godotgaussiansplatting_torch.parallel import sharded
from godotgaussiansplatting_tpu.ops import bigbin as bigbin_j
from godotgaussiansplatting_tpu.ops import binning2 as binning_j
from godotgaussiansplatting_tpu.ops import blocks2 as blocks_j
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection import project_splats
from godotgaussiansplatting_tpu.parallel import sharded as sharded_j

from _torch_parity import np_, port_cloud, psnr
from _torch_sharded_worker import Ranks

WORLD = 4
U32 = np.uint32(0xFFFFFFFF)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(WORLD, tmp_path_factory.mktemp("gloo"))
    yield r
    r.close()


def _cloud_np(cloud) -> dict:
    """A cloud of either package as the numpy fields the ranks rebuild."""
    return {f: np_(getattr(cloud, f)) for f in
            ("means", "cov3d", "opacity", "sh", "upload_time")} | {
        "num_splats": cloud.num_splats}


def _unis(cams, cfg_j) -> tuple:
    """JAX uniforms of each camera, stacked (numpy), and per camera."""
    unis = [make_uniforms(c, cfg_j) for c in cams]
    return tuple(np_(a) for a in sharded_j.stack_uniforms(unis)), unis


def _port_uni(stacked, v):
    return gt.FrameUniforms(*(torch.from_numpy(np.array(a[v]))
                              for a in stacked))


def _members(out, n_view, n_tile):
    """The mesh ranks' results, all equal; ranks outside return None."""
    n = n_view * n_tile
    assert all(o is None for o in out[n:])
    for o in out[1:n]:
        for a, b in zip(out[0], o):
            np.testing.assert_array_equal(a, b)
    return out[0]


# --- make_mesh ---------------------------------------------------------------

@pytest.mark.parametrize("n_view,n_tile", [(1, 2), (2, 2), (1, 4), (1, None)])
def test_make_mesh_shapes(ranks, n_view, n_tile):
    out = ranks.run("mesh", n_view=n_view, n_tile=n_tile)
    nt = n_tile or WORLD // n_view
    for rank, m in enumerate(out):
        assert m["shape"] == {"view": n_view, "tile": nt}
        assert m["device"] == "cpu" and m["backend"] == "gloo"
        if rank < n_view * nt:
            assert m["member"]
            assert (m["view"], m["tile"]) == (rank // nt, rank % nt)
            row = rank // nt
            assert m["row"] == list(range(row * nt, (row + 1) * nt))
        else:
            assert not m["member"] and m["view"] is None


def test_make_mesh_errors(ranks):
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharded.make_mesh(1, 1, device="cpu", backend="gloo")
    too_big = ranks.run("mesh_error", n_view=3, n_tile=2, device="cpu",
                        backend="gloo")
    assert all(e.startswith("ValueError") and "6 ranks" in e for e in too_big)
    nccl_cpu = ranks.run("mesh_error", n_view=1, n_tile=2, device="cpu")
    assert all(e.startswith("ValueError") and "gloo" in e for e in nccl_cpu)


# --- exact path --------------------------------------------------------------

def _exact_scene(n_view, width, height):
    cfg_j = gj.RasterizerConfig(width=width, height=height,
                                reference_boundary_quirk=False)
    cloud = gj.synthetic_scene(2000, seed=5, extent=2.5,
                               scale_range=(0.01, 0.1))
    cams = [gj.Camera.reset_pose().with_yaw_pitch(180 + 15 * i, -5 * i)
            for i in range(n_view)]
    return cfg_j, cloud, cams


def test_exact_sharded_matches_jax(ranks):
    """(2, 2): two views, two slabs each, against JAX render_frame_sharded
    on four devices of the CPU mesh."""
    cfg_j, cloud, cams = _exact_scene(2, 64, 64)
    stacked, unis = _unis(cams, cfg_j)
    # jitted whole: the same function, compiled once (62 s eagerly here)
    img_j, pairs_j, over_j = jax.jit(
        sharded_j.render_frame_sharded, static_argnums=(2, 3, 4))(
        cloud, sharded_j.stack_uniforms(unis), cfg_j,
        sharded_j.make_mesh(2, 2), 512)
    cfg_t = gt.RasterizerConfig(**dataclasses.asdict(cfg_j))
    img, pairs, over = _members(ranks.run(
        "frame", fast=False, cloud=_cloud_np(cloud), unis=stacked,
        cfg=cfg_t, n_view=2, n_tile=2, tile_capacity=512), 2, 2)
    assert img.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(img, np_(img_j), atol=1e-3)
    np.testing.assert_array_equal(pairs, np_(pairs_j))
    np.testing.assert_array_equal(over, np_(over_j))
    assert pairs.min() > 0


@pytest.mark.parametrize("n_view,n_tile,width,height", [
    (1, 4, 128, 80),     # 5 tile rows over 4 slabs: 2-row slabs, padded
    (2, 2, 128, 128),
])
def test_exact_sharded_matches_single_device(ranks, n_view, n_tile, width,
                                             height):
    cfg_j, cloud, cams = _exact_scene(n_view, width, height)
    stacked, _ = _unis(cams, cfg_j)
    cfg_t = gt.RasterizerConfig(**dataclasses.asdict(cfg_j))
    img, pairs, over = _members(ranks.run(
        "frame", fast=False, cloud=_cloud_np(cloud), unis=stacked,
        cfg=cfg_t, n_view=n_view, n_tile=n_tile, tile_capacity=512),
        n_view, n_tile)
    assert img.shape == (n_view, height, width, 4)
    assert over.tolist() == [0] * n_view
    pc = port_cloud(cloud)
    for v in range(n_view):
        single = gt.render_frame(pc, _port_uni(stacked, v), cfg_t,
                                 tile_capacity=512)
        np.testing.assert_allclose(img[v], single.image.numpy(), atol=1e-3,
                                   err_msg=f"view {v}")
        assert pairs[v] == int(single.stats.num_pairs)


def _tie_scene():
    """Two splats at one mean, so of one depth16: splat 0 wide (6 x 6 tiles
    at 128x128, tile 16), splat 1 narrow (2 x 2 tiles), red and green."""
    sh = np.zeros((2, 16, 3), np.float32)
    sh[0, 0], sh[1, 0] = [2, -1, -1], [-1, 2, -1]
    return gj.from_arrays(
        np.array([[0, 0, 5]] * 2, np.float32),
        np.array([[1.0] * 3, [0.12] * 3], np.float32),
        np.array([[0, 0, 0, 1]] * 2, np.float32),
        np.array([0.95, 0.95], np.float32), sh)


@pytest.mark.parametrize("one_group", [False, True],
                         ids=["tiers", "one_group"])
def test_exact_slab_emission_groups_as_jax(ranks, one_group):
    """A slab clips a wide splat's rect: the whole frame emits splat 0's 36
    tiles in the 128-tile group, after every base pair, each 4-row slab its
    18 in the base group, before splat 1. Their pairs share (tile,
    depth16) keys, so the sharded frame composites them in the other order.
    JAX's render_frame_sharded differs from its render_frame just so, and
    the port's sharded frame is JAX's within 1e-3. With one emission group
    (no tiers, no giants, no per-splat cap) sharded and whole frames
    agree."""
    cfg_j = gj.RasterizerConfig(width=128, height=128,
                                reference_boundary_quirk=False)
    if one_group:
        cfg_j = cfg_j.replace(exact_tiers=(), giant_splat_capacity=0,
                              max_tiles_per_splat=cfg_j.num_tiles)
    cloud = _tie_scene()
    stacked, unis = _unis([gj.Camera.reset_pose()], cfg_j)
    img_j, pairs_j, over_j = jax.jit(
        sharded_j.render_frame_sharded, static_argnums=(2, 3, 4))(
        cloud, sharded_j.stack_uniforms(unis), cfg_j,
        sharded_j.make_mesh(1, 2), 512)
    single_j = gj.render_frame_jit(cloud, unis[0], cfg_j, tile_capacity=512)
    cfg_t = gt.RasterizerConfig(**dataclasses.asdict(cfg_j))
    img, pairs, over = _members(ranks.run(
        "frame", fast=False, cloud=_cloud_np(cloud), unis=stacked,
        cfg=cfg_t, n_view=1, n_tile=2, tile_capacity=512), 1, 2)
    single = gt.render_frame(port_cloud(cloud), _port_uni(stacked, 0),
                             cfg_t, tile_capacity=512)
    np.testing.assert_allclose(img, np_(img_j), atol=1e-3)
    np.testing.assert_allclose(single.image.numpy(), np_(single_j.image),
                               atol=1e-3)
    assert pairs.tolist() == np_(pairs_j).tolist() == [40]
    assert over.tolist() == np_(over_j).tolist() == [0]
    apart_j = np.abs(np_(img_j)[0] - np_(single_j.image)).max()
    apart = np.abs(img[0] - single.image.numpy()).max()
    if one_group:
        assert apart_j <= 1e-3 and apart <= 1e-3
    else:       # at the centre, red over green against green over red
        assert apart_j > 0.5 and apart > 0.5
        assert img[0, 64, 64, 0] > 0.9 and single.image[64, 64, 0] < 0.4


# --- fast path: the exchange against JAX, stage by stage ---------------------

def _jax_shard_blocks(cloud, uni, cfg_j, n_tile):
    """JAX's block frame and big set of each shard (sharded.py:207-213),
    jitted once for the shards' shape."""
    @jax.jit
    def build(means, cov3d, opacity, sh, upload_time):
        prj = project_splats(means, cov3d, opacity, sh, upload_time,
                             uni.view, uni.proj, uni.camera_pos,
                             uni.model_scale, uni.time, cfg_j)
        return blocks_j.build_block_frame2(
            prj, cfg_j, num_splats=cloud.num_splats,
            big_cap=cfg_j.big_capacity, words_payload=cfg_j.words_payload)

    pl = cloud.capacity // n_tile
    return [build(*(getattr(cloud, f)[t * pl:(t + 1) * pl] for f in (
        "means", "cov3d", "opacity", "sh", "upload_time")))
        for t in range(n_tile)]


def _np_exchange(shards, n_tile, rows_per, k_x):
    """sharded.py:216-279 in numpy on the JAX arrays: (each slab's pool,
    each source shard's exchange overflow, the gathered big set)."""
    sends, overs = [], []
    for bf, _ in shards:
        r = np.asarray(bf.rect).astype(np.int64)
        nonempty = (r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1])
        dy0 = np.arange(n_tile)[:, None] * rows_per
        inter = ((r[:, 1][None] < dy0 + rows_per) & (r[:, 3][None] > dy0)
                 & nonempty[None])
        selkey = np.sort(np.where(inter, np.arange(r.shape[0])[None],
                                  0xFFFFFFFF), axis=1)[:, :k_x]
        ok = selkey != 0xFFFFFFFF
        sel = np.where(ok, selkey, 0)
        overs.append(int(np.maximum(inter.sum(1) - k_x, 0).sum()))

        def take(a):
            return np.asarray(a)[sel]

        mm = (take(bf.min_depth) << 16) | (take(bf.max_depth) & 0xFFFF)
        sends.append({
            "payload": take(bf.payload),
            "rect": np.where(ok[..., None], take(bf.rect), np.int32(0)),
            "bitmap": np.where(ok, take(bf.bitmap), np.uint32(0)),
            "mm": np.where(ok, mm.astype(np.uint32), U32),
            "nv": np.where(ok, take(bf.num_valid), np.int32(0))})
    pools = []
    for d, (bf, _) in enumerate(shards):
        recv = {k: np.concatenate([sends[s][k][d] for s in range(n_tile)])
                for k in sends[0]}
        pools.append(blocks_j.BlockFrame2(
            payload=recv["payload"], rect=recv["rect"],
            bitmap=recv["bitmap"], min_depth=recv["mm"] >> 16,
            max_depth=recv["mm"] & 0xFFFF, num_valid=recv["nv"],
            num_culled_pairs=np.asarray(bf.num_culled_pairs)))
    cat = [np.concatenate([np.asarray(getattr(b, f)) for _, b in shards])
           for f in ("table", "depth16", "rect", "valid")]
    idx = cat[0][:, 13].copy().view(np.uint32)
    order = np.lexsort((idx, cat[1]))               # stable, depth16 first
    bigs = blocks_j.BigSet(*(a[order] for a in cat), residual=np.int32(
        sum(int(b.residual) for _, b in shards)))
    return pools, overs, bigs


@pytest.mark.parametrize("n_view,n_tile,payload,cap", [
    (1, 4, "words", None),    # tile 32, 3 rows: the last slab is all padding
    (2, 2, "cooked", None),   # tile 16, 6 rows: two view rows at once
    (1, 4, "words", 3),       # a cap of 3 blocks drops blocks
])
def test_fast_exchange_bit_equal_to_jax(ranks, n_view, n_tile, payload, cap):
    cfg_j = gj.RasterizerConfig(width=128, height=96)
    cfg_j = (cfg_j.fast_defaults().replace(projection_kernel=False)
             if payload == "words" else cfg_j.replace(quality="fast"))
    cloud = gj.mortonize(gj.synthetic_scene(16384, seed=9, extent=2.5,
                                            scale_range=(0.02, 0.4)))
    uni = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    shards = _jax_shard_blocks(cloud, uni, cfg_j, n_tile)
    rows_per = sharded._slab_rows(cfg_j, n_tile)
    _, k_x = sharded.exchange_shape(cloud.capacity, n_tile, cap)
    pools, overs, bigs = _np_exchange(shards, n_tile, rows_per, k_x)
    assert int(bigs.valid.sum()) > 20, "scene must have big lanes"
    assert (sum(overs) > 0) == (cap is not None)

    cfg_t = gt.RasterizerConfig(**dataclasses.asdict(cfg_j))
    out = ranks.run(
        "exchange", cfg=cfg_t, n_view=n_view, n_tile=n_tile, k_x=k_x,
        blocks=[tuple(np_(a) for a in bf) for bf, _ in shards],
        bigs=[tuple(np_(a) for a in b) for _, b in shards])
    slab_j = cfg_j.replace(height=rows_per * cfg_j.tile_size,
                           width=cfg_j.target_size[0], render_scale=1.0)
    bin_j = jax.jit(functools.partial(binning_j.bin_blocks2, cfg=slab_j))
    bigbin_j_ = jax.jit(functools.partial(bigbin_j.bin_bigs, cfg=slab_j))
    bigs_jx = blocks_j.BigSet(*(jnp.asarray(a) for a in bigs))
    expect = {}     # slab -> (JAX's tile bins, big bins) at its row offset
    for t in range(n_tile):
        pool_j = blocks_j.BlockFrame2(*(jnp.asarray(a) for a in pools[t]))
        expect[t] = (bin_j(pool_j, tile_row_offset=t * rows_per),
                     bigbin_j_(bigs_jx, tile_row_offset=t * rows_per))
    for rank in range(n_view * n_tile):
        t = rank % n_tile
        pool, bigs_t, bins, tile_bigs, over = out[rank]
        for f, a in zip(blocks_j.BlockFrame2._fields, pool):
            np.testing.assert_array_equal(a, np_(getattr(pools[t], f)),
                                          err_msg=f"rank {rank} pool {f}")
        for f, a in zip(blocks_j.BigSet._fields, bigs_t):
            np.testing.assert_array_equal(a, np_(getattr(bigs, f)),
                                          err_msg=f"rank {rank} bigs {f}")
        assert int(over) == overs[t]
        bins_j, tb_j = expect[t]
        for f, a in zip(bins_j._fields, bins):
            np.testing.assert_array_equal(a, np_(getattr(bins_j, f)),
                                          err_msg=f"rank {rank} bins {f}")
        for f, a in zip(tb_j._fields, tile_bigs):
            np.testing.assert_array_equal(a, np_(getattr(tb_j, f)),
                                          err_msg=f"rank {rank} bigs {f}")
    assert all(o is None for o in out[n_view * n_tile:])


# --- fast path: the port against itself -------------------------------------

def _fast_scene(n, width, height, fast_defaults):
    cfg = gt.RasterizerConfig(width=width, height=height)
    cfg = cfg.fast_defaults() if fast_defaults else cfg
    cloud = gt.mortonize(gt.synthetic_scene(
        n, seed=11, extent=2.5, scale_range=(0.004, 0.05), device="cpu"))
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    stacked = tuple(a.numpy() for a in sharded.stack_uniforms([uni]))
    return cfg, cloud, uni, stacked


@pytest.mark.parametrize("width,height,fast_defaults", [
    (64, 64, False),       # readable projection, screen clustering, tile 16
    (64, 64, True),        # fused projection, words, bricks, tile 32
    (128, 160, True),      # 5 tile rows over 4 slabs: 2-row slabs, padded
])
def test_fast_sharded_psnr_normal_opacity(ranks, width, height,
                                          fast_defaults):
    """Whole-superblock shards (4 x 8192 splats) and the full splat count
    for the cell shift cluster as the single device does, so the sharded
    frame must read >= 40 dB against it at normal opacity (the counterpart
    of tests/test_multichip.py:128-159), with equal pairs."""
    cfg, cloud, uni, stacked = _fast_scene(4 * 8192, width, height,
                                           fast_defaults)
    img, pairs, over = _members(ranks.run(
        "frame", fast=True, cloud=_cloud_np(cloud), unis=stacked, cfg=cfg,
        n_view=1, n_tile=4), 1, 4)
    assert img.shape == (1, 4, height, width)
    assert over.tolist() == [0]
    single = gt.render_frame_fast(cloud, uni, cfg)
    ref = single.image.numpy()
    assert np.isfinite(img).all() and img[0, :3].max() > 0.01
    assert psnr(img[0, :3], ref[:3]) >= 40.0
    assert pairs[0] == int(single.stats.num_pairs)


def test_mesh_traffic_counts_the_collectives(ranks):
    """Mesh.traffic: each collective's input and the bytes it sent to and
    received from the other ranks, by what it carried, at (1, 4): the
    all-to-all's buffer holds n_tile * k_x blocks of words and 7 meta
    words, a quarter of it stays; the exact path gathers 15 words a
    splat."""
    cfg, cloud, _, stacked = _fast_scene(4 * 8192, 64, 64, True)
    kw = dict(cloud=_cloud_np(cloud), unis=stacked, n_view=1, n_tile=4)
    _, k_x = sharded.exchange_shape(cloud.capacity, 4)
    block = 8 * 128 * 4 + 7 * 4
    for t in ranks.run("traffic", fast=True, cfg=cfg, **kw):
        assert t["blocks"] == {"calls": 2, "buffer": 4 * k_x * block,
                               "sent": 3 * k_x * block,
                               "received": 3 * k_x * block}
        assert t["bigs"]["calls"] == 3 and "splats" not in t
        assert t["image"]["buffer"] == 4 * 32 * 64 * 4   # 1-row slabs
    exact = cfg.replace(quality="exact", reference_boundary_quirk=False)
    for t in ranks.run("traffic", fast=False, cfg=exact, **kw):
        assert t["splats"] == {"calls": 2, "buffer": 8192 * 15 * 4,
                               "sent": 3 * 8192 * 15 * 4,
                               "received": 3 * 8192 * 15 * 4}
        assert "blocks" not in t


def test_fast_exchange_overflow_counted(ranks):
    """A cap of 2 blocks per (source, slab) pair: the frame reports exactly
    the intersecting non-empty blocks beyond the cap, counted here from
    each shard's own block frame."""
    cap, n_tile = 2, 4
    cfg, cloud, _, stacked = _fast_scene(4 * 8192, 64, 64, False)
    img, pairs, over = _members(ranks.run(
        "frame", fast=True, cloud=_cloud_np(cloud), unis=stacked, cfg=cfg,
        n_view=1, n_tile=n_tile, exchange_cap=cap), 1, n_tile)
    rows_per = sharded._slab_rows(cfg, n_tile)
    uni = _port_uni(stacked, 0)
    pl = cloud.capacity // n_tile
    dropped = 0
    for t in range(n_tile):
        s = slice(t * pl, (t + 1) * pl)
        prj = projection_t.project_splats(
            cloud.means[s], cloud.cov3d[s], cloud.opacity[s], cloud.sh[s],
            cloud.upload_time[s], *uni[:5], cfg)
        bf, _ = blocks_t.build_block_frame2(
            prj, cfg, num_splats=cloud.num_splats)
        r = bf.rect.numpy()
        for d in range(n_tile):
            hit = ((r[:, 2] > r[:, 0]) & (r[:, 3] > r[:, 1])
                   & (r[:, 1] < (d + 1) * rows_per) & (r[:, 3] > d * rows_per))
            dropped += max(int(hit.sum()) - cap, 0)
    assert dropped > 0
    assert over.tolist() == [dropped]
    assert np.isfinite(img).all()


def test_fast_sharded_matches_jax(ranks):
    """The whole fast sharded frame against JAX render_frame_fast_sharded
    (interpret mode, jitted whole: 9 s here, 131 s eagerly) on (1, 2) at
    64x64, tile 16: two tile rows a slab.
    Opacity x 0.15 as in tests/test_multichip.py:117-122, so the two
    clusterings' ordering differences stay second order (atol 2.5e-2)."""
    cfg_j = gj.RasterizerConfig(width=64, height=64)
    cloud = gj.mortonize(gj.synthetic_scene(3000, seed=9, extent=2.5,
                                            scale_range=(0.01, 0.1)))
    cloud = dataclasses.replace(cloud, opacity=cloud.opacity * 0.15)
    stacked, unis = _unis([gj.Camera.reset_pose()], cfg_j)
    img_j, pairs_j, over_j = jax.jit(
        sharded_j.render_frame_fast_sharded,
        static_argnames=("cfg", "mesh", "interpret"))(
        cloud, sharded_j.stack_uniforms(unis), cfg=cfg_j,
        mesh=sharded_j.make_mesh(1, 2), interpret=True)
    cfg_t = gt.RasterizerConfig(**dataclasses.asdict(cfg_j))
    img, pairs, over = _members(ranks.run(
        "frame", fast=True, cloud=_cloud_np(cloud), unis=stacked, cfg=cfg_t,
        n_view=1, n_tile=2), 1, 2)
    assert img.shape == (1, 4, 64, 64)
    np.testing.assert_allclose(img, np_(img_j), atol=2.5e-2)
    np.testing.assert_array_equal(pairs, np_(pairs_j))
    np.testing.assert_array_equal(over, np_(over_j))
