"""The orderings the render kernels' per-tile pipeline (csrc/render_tile.cuh,
run by the v3 and the v4 kernel) rests on, held on the tile lists of both
packages.

The kernel adds each resident big lane's log-alpha once per pixel per tile
and each batch's mass once per big-lane suffix, which is exact only if:

  * each tile's chain list is ordered by block min depth, so a batch's min
    depth never decreases from one batch to the next;
  * each tile's big lanes are rank-ascending (depth16 << 16 | idx >> 7) and
    carry depth16 as an integer-valued f32;
  * hence, for every batch, the big lanes in front of it ({b : bd < bmin})
    are a prefix of the list and those behind it ({b : bd > bmax}) a
    suffix; and a batch the straddle gate passes over has no big lane in
    its depth range.

A big-heavy parity scene goes through the JAX projection and block build
of four configurations: fast_defaults() with each clustering (fused
projection, words, tile 32), and the two v4 configurations,
RasterizerConfig(kernel="v4").fast_defaults() (the cooked payload, tile
32, U=2) and RasterizerConfig(quality="fast", kernel="v4") (the readable
projection, screen clustering, the cooked payload, tile 16, U=4). Each
BlockFrame2 and BigSet is binned by both packages (``bin_blocks2``,
``bin_bigs``), and every check runs on both packages' lists.
"""

import numpy as np
import pytest

import godotgaussiansplatting_tpu as gj
from godotgaussiansplatting_torch.ops import bigbin as bigbin_t
from godotgaussiansplatting_torch.ops import binning2 as binning_t
from godotgaussiansplatting_torch.ops import blocks2 as blocks_t
import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_tpu.models.splats import fast_cloud_view
from godotgaussiansplatting_tpu.ops import bigbin as bigbin_j
from godotgaussiansplatting_tpu.ops import binning2 as binning_j
from godotgaussiansplatting_tpu.ops import blocks2 as blocks_j
from godotgaussiansplatting_tpu.ops.pipeline import make_uniforms
from godotgaussiansplatting_tpu.ops.projection import project_splats
from godotgaussiansplatting_tpu.ops.projection_pallas import project_words

from _torch_parity import np_, port_tuple

SIZE = (512, 384)


# fixture id -> (RasterizerConfig keywords, fast_defaults())
CONFIGS = {
    "bricks": (dict(cluster="bricks"), True),
    "screen": (dict(cluster="screen"), True),
    "v4-tile32-cooked": (dict(kernel="v4"), True),
    "v4-tile16-quality-fast": (dict(kernel="v4", quality="fast"), False),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def lists(request):
    """{package: (nb, minmax, nbig, big depth, big rank, big prefix)} as
    int64/f32 numpy arrays, for one configuration."""
    w, h = SIZE
    kw, fast = CONFIGS[request.param]
    cfg_j = gj.RasterizerConfig(width=w, height=h, **kw)
    cfg_t = gt.RasterizerConfig(width=w, height=h, **kw)
    if fast:
        cfg_j, cfg_t = cfg_j.fast_defaults(), cfg_t.fast_defaults()
    assert cfg_t.tile_size == (16 if request.param.startswith("v4-tile16")
                               else 32)
    cj = gj.mortonize(gj.synthetic_scene(16384, seed=9, extent=3.0,
                                         scale_range=(0.02, 0.25)))
    if cfg_j.projection_kernel:       # it reads the planar bf16 SH view
        cj = fast_cloud_view(cj)
    u = make_uniforms(gj.Camera.reset_pose(), cfg_j)
    args = (cj.means, cj.cov3d, cj.opacity, cj.sh, cj.upload_time, u.view,
            u.proj, u.camera_pos, u.model_scale, u.time, cfg_j)
    if cfg_j.projection_kernel:
        fj, bj = blocks_j.build_block_frame2_words(
            project_words(*args, num_splats=cj.num_splats), cfg_j,
            words_payload=cfg_j.words_payload)
    else:
        fj, bj = blocks_j.build_block_frame2(
            project_splats(*args), cfg_j, num_splats=cj.num_splats,
            words_payload=cfg_j.words_payload)
    out = {}
    for name, bins, bigs in (
            ("jax", binning_j.bin_blocks2(fj, cfg_j),
             bigbin_j.bin_bigs(bj, cfg_j)),
            ("port", binning_t.bin_blocks2(
                port_tuple(blocks_t.BlockFrame2, fj), cfg_t),
             bigbin_t.bin_bigs(port_tuple(blocks_t.BigSet, bj), cfg_t))):
        pay = np_(bigs.bigpay)
        bd = pay[:, 12, :]
        idx = pay[:, 13, :].view(np.int32).astype(np.int64)
        rank = ((np.minimum(bd, 65535.0).astype(np.int64) << 16)
                | ((idx >> 7) & 0xFFFF))
        out[name] = (np_(bins.tile_nblocks).astype(np.int64),
                     np_(bins.tile_minmax).astype(np.int64) & 0xFFFFFFFF,
                     np_(bigs.tile_nbig).astype(np.int64), bd, rank,
                     np_(bigs.big_prefix).astype(np.int64))
    nb, _, nbig = out["port"][:3]
    assert int(nb.max()) > 8, "tiles must hold several batches"
    assert int((nbig > 4).sum()) > 4, "tiles must hold resident big lanes"
    return out


@pytest.mark.parametrize("package", ["jax", "port"])
def test_chain_min_depth_never_decreases(lists, package):
    nb, minmax = lists[package][:2]
    for t in range(nb.shape[0]):
        mins = minmax[t, :nb[t]] >> 16
        assert np.all(np.diff(mins) >= 0), f"tile {t}: min depth decreases"


@pytest.mark.parametrize("package", ["jax", "port"])
def test_big_lanes_rank_ascending_integer_depth(lists, package):
    _, _, nbig, bd, rank, _ = lists[package]
    for t in np.nonzero(nbig)[0]:
        n = nbig[t]
        assert np.all(np.diff(rank[t, :n]) >= 0), f"tile {t}: rank order"
        d = bd[t, :n]
        assert np.all(d == np.floor(d)) and np.all((d >= 0) & (d <= 65535))


def _runs(mask):
    """Number of value changes along a boolean vector."""
    return int(np.count_nonzero(mask[1:] != mask[:-1]))


@pytest.mark.parametrize("U", [1, 2, 4])
def test_front_is_prefix_back_is_suffix(lists, U):
    n_batches = n_nonstrad = 0
    for package, (nb, minmax, nbig, bd, _, prefix) in lists.items():
        for t in np.nonzero(nbig)[0]:
            d = bd[t, :nbig[t]]
            for k in range(-(-nb[t] // U)):
                mm = minmax[t, k * U:min(nb[t], k * U + U)]
                bmin, bmax = int((mm >> 16).min()), int((mm & 0xFFFF).max())
                front, back = d < bmin, d > bmax
                assert _runs(front) <= 1 and (front[0] or not front.any()), (
                    f"{package} tile {t} batch {k}: front not a prefix")
                assert _runs(back) <= 1 and (back[-1] or not back.any()), (
                    f"{package} tile {t} batch {k}: back not a suffix")
                b0 = min(max(bmin >> 9, 0), 127)
                b1 = min(max(bmax >> 9, 0), 127)
                lo = prefix[t, b0 - 1] if b0 > 0 else 0
                if prefix[t, b1] == lo:       # the gate: no straddle
                    assert np.all(front | back)
                    n_nonstrad += 1
                n_batches += 1
    assert n_batches > 100 and 0 < n_nonstrad < n_batches
