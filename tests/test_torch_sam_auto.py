"""The port's everything-mode generators (regda_tpu_torch/models/sam/auto.py)
against the JAX package's and against the upstream-order post-processing
oracle (tests/sam_postproc_oracle.py).

One set of SAM weights (vit_t, 128^2 model frame, float32), initialised by the
JAX package, is carried into the port's `Sam` by `load_jax_variables`; the same
seeded uint8 tiles go through both packages' generators. The JAX side runs its
default path, its Pallas kernels in interpret mode; the port takes its
kernels' plain versions, as it does for any CPU tensor.

Region maps must be IDENTICAL. Every decision on the way is a threshold (IoU,
stability, logit > 0 per pixel), and the two packages agree on the logits only
to float32 rounding, so the tiles are at pinned seeds where no value sits
within that rounding of its threshold (tests/test_sam_postproc_oracle.py pins
its seeds for the same reason). The seeds are that file's, 3 and 11; they
needed no re-pinning. A seed that lands a logit on a threshold is to be
re-pinned, not the equality loosened.

The oracle is driven with the PORT's encoder and stock decoder through a small
adapter, so that it checks the port's post-processing, from logits to region
map, against an independent implementation.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regda_tpu.models.sam import auto as jauto
from regda_tpu.models.sam.auto import Sam as JaxSam
from regda_tpu_torch.models.sam import auto
from regda_tpu_torch.models.sam.auto import Sam
from regda_tpu_torch.models.sam.convert import load_jax_variables
from regda_tpu_torch.models.sam.vit import VIT_CONFIGS
from tests.sam_postproc_oracle import OracleMaskGenerator

IMG = 128
# the thresholds of tests/test_sam_postproc_oracle.py: on random weights they
# make every filter stage reject something
_KW = dict(points_per_side=8, points_per_batch=32, pred_iou_thresh=0.1,
           stability_score_thresh=0.0002)
# the small configuration of tests/test_sam.py: everything passes the filters
_OPEN = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=-1e9,
             stability_score_thresh=0.0, mask_budget=16)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The generators run thousands of small eager ops, each an OpenMP region
    under torch's default thread pool; at these sizes the pool gains nothing,
    and its spinning workers cost a parallel test run its cores (this file is
    three times slower there with the pool than with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def models():
    """(JAX model, its variables, the port's model), float32, one set of weights."""
    jax_model = JaxSam(vit_config='vit_t', img_size=IMG, dtype=jnp.float32)
    variables = jax_model.init({'params': jax.random.PRNGKey(0)},
                               jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 1, 2)),
                               jnp.ones((1, 1), jnp.int32))
    model = Sam(vit_config='vit_t', img_size=IMG, dtype=torch.float32).eval()
    load_jax_variables(model, variables)
    return jax_model, variables, model


def _tile(seed=3, h=96, w=96):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 255, (h, w, 3), np.uint8).astype(np.uint8)


def _pair(models, cls: str, **kw):
    """The same generator of both packages."""
    jax_model, variables, model = models
    return (getattr(jauto, cls)(jax_model, variables, compute_dtype=jnp.float32, **kw),
            getattr(auto, cls)(model, **kw))


class _PortAsJaxModel:
    """What `OracleMaskGenerator` asks of a model, answered by the port's
    `Sam`: `apply(variables, *args, method=model.encode | model.decode_points)`
    with array arguments, numpy results."""

    encode, decode_points = 'encode', 'decode_points'

    def __init__(self, model: Sam):
        self.model, self.img_size = model, model.img_size

    def apply(self, variables, *args, method):
        tensors = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
        with torch.inference_mode():
            out = getattr(self.model, method)(*tensors)
        return out.numpy() if torch.is_tensor(out) else tuple(o.numpy() for o in out)


class _MemoOracle(OracleMaskGenerator):
    """The oracle with `generate` remembered per image: `regions` calls it
    again, and two tests ask for the same tiles."""

    def generate(self, image_np):
        memo = self.__dict__.setdefault('_memo', {})
        key = image_np.tobytes()
        if key not in memo:
            memo[key] = super().generate(image_np)
        return memo[key]


@pytest.fixture(scope='module')
def shared(models):
    """crop_n_layers -> (JAX region generator, oracle over the port's model) at
    the `_KW` thresholds, made once for the module: the JAX generator's
    `generate` is its annotation path (the region generator inherits it), so
    both paths' tests share one set of compiled encode and decode functions."""
    made = {}

    def get(crop_n_layers: int):
        if crop_n_layers not in made:
            kw = dict(crop_n_layers=crop_n_layers, crop_n_points_downscale_factor=2, **_KW)
            jgen = jauto.SamRegionGenerator(models[0], models[1], compute_dtype=jnp.float32, **kw)
            made[crop_n_layers] = (jgen, _MemoOracle(_PortAsJaxModel(models[2]), None, **kw))
        return made[crop_n_layers]
    return get


# --------------------------------------------------------------- host helpers

@pytest.mark.parametrize('size,layers', [((512, 512), 1), ((96, 96), 1), ((64, 100), 2),
                                         ((300, 200), 0)])
def test_generate_crop_boxes_match_jax(size, layers):
    assert auto.generate_crop_boxes(size, layers, 512 / 1500) == \
        jauto.generate_crop_boxes(size, layers, 512 / 1500)
    if size == (512, 512):     # the reference configuration's pyramid
        boxes, idxs = auto.generate_crop_boxes(size, 1, 512 / 1500)
        assert boxes[0] == [0, 0, 512, 512] and idxs == [0, 1, 1, 1, 1]
        assert {(b[2] - b[0], b[3] - b[1]) for b in boxes[1:]} == {(343, 343)}


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_nms_boxes_matches_jax_ties_included(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, size=(60, 2)).astype(np.float32)
    wh = rng.uniform(4, 40, size=(60, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    boxes[10:20] = boxes[:10] + rng.uniform(-1, 1, (10, 4)).astype(np.float32)   # overlaps
    # whole groups tie, as the cross-crop pass's 1 / crop-area scores do
    scores = rng.choice(np.array([0.25, 0.5, 1.0], np.float32), size=60)
    for thresh in (0.3, 0.7):
        got = auto.nms_boxes(boxes, scores, thresh)
        want = jauto.nms_boxes(boxes, scores, thresh)
        np.testing.assert_array_equal(got, want)
    # among equal scores the earlier box is kept first
    same = auto.nms_boxes(boxes, np.ones(60, np.float32), 0.7)
    assert same[0] == 0 and np.all(np.diff(same) > 0)


def test_is_box_near_crop_edge_and_scores_match_jax():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 400, size=(200, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 120, (200, 2)).astype(np.float32)], 1)
    for crop in ([0, 0, 512, 512], [169, 0, 512, 343], [0, 169, 343, 512]):
        got = auto.is_box_near_crop_edge(boxes, crop, (512, 512))
        want = jauto.is_box_near_crop_edge(boxes, crop, (512, 512))
        np.testing.assert_array_equal(got, want)
        assert got.any() or crop == [0, 0, 512, 512]
        assert auto._crop_nms_scores(crop) == jauto._crop_nms_scores(crop)


def test_regions_from_anns_and_max_regions_match_jax():
    assert auto._lrh_max_regions() == jauto._lrh_max_regions()
    rng = np.random.default_rng(6)
    anns = [{'segmentation': rng.random((32, 32)) < 0.2, 'area': int(a)}
            for a in (5, 300, 40, 1024)]
    for thresh in (1, 32, 1024):
        np.testing.assert_array_equal(auto.regions_from_anns(anns, (32, 32), thresh),
                                      jauto.regions_from_anns(anns, (32, 32), thresh))


def test_exact_stability_matrices_and_point_grid_match_jax(models):
    jgen, gen = _pair(models, 'SamAutomaticMaskGenerator', crop_n_layers=1,
                      crop_n_points_downscale_factor=2, **_KW)
    for key_hw in ((128, 128, 96, 96), (128, 96, 96, 72), (128, 128, 64, 64)):
        for got, want in zip(gen._exact_stability_matrices(key_hw, 32),
                             jgen._exact_stability_matrices(key_hw, 32)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    pts, valid = gen._points(1, 128, 96)
    want = jauto.build_point_grid(4) * np.array([96, 128], np.float32)
    assert tuple(pts.shape) == (32, 2) and int(valid.sum()) == 16
    np.testing.assert_array_equal(pts.numpy()[:16], want.astype(np.float32))


# ----------------------------------------------------------------- generators

@pytest.mark.parametrize('crop_n_layers', [0, 1])
def test_generate_matches_jax_and_oracle(models, shared, crop_n_layers):
    """Ann path: `generate()` anns equal the JAX generator's and the oracle's,
    in ORDER, and so do the packed region maps."""
    kw = dict(crop_n_layers=crop_n_layers, crop_n_points_downscale_factor=2, **_KW)
    gen = auto.SamAutomaticMaskGenerator(models[2], **kw)
    jgen, oracle = shared(crop_n_layers)
    img = _tile()
    anns, j_anns, o_anns = gen.generate(img), jgen.generate(img), oracle.generate(img)
    assert len(anns) == len(j_anns) == len(o_anns) > 0
    for a, j, o in zip(anns, j_anns, o_anns):
        assert a['area'] == j['area'] == o['area']
        assert a['bbox'] == j['bbox'] and a['crop_box'] == j['crop_box']
        assert np.array_equal(a['segmentation'], j['segmentation'])
        assert np.array_equal(a['segmentation'], o['segmentation'])
        np.testing.assert_allclose(a['predicted_iou'], j['predicted_iou'], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a['predicted_iou'], o['predicted_iou'], rtol=1e-4, atol=1e-4)
    got = auto.regions_from_anns(anns, img.shape[:2], area_threshold=32)
    np.testing.assert_array_equal(got, jauto.regions_from_anns(j_anns, img.shape[:2], 32))
    np.testing.assert_array_equal(got, oracle.regions(img, area_threshold=32))


@pytest.mark.parametrize('crop_n_layers', [0, 1])
def test_generate_regions_match_jax_and_oracle(models, shared, crop_n_layers):
    """Device path: single, batched and streamed region maps are IDENTICAL to
    the JAX `SamRegionGenerator`'s and to the oracle's upstream-order packing."""
    kw = dict(crop_n_layers=crop_n_layers, crop_n_points_downscale_factor=2, **_KW)
    gen = auto.SamRegionGenerator(models[2], **kw)
    jgen, oracle = shared(crop_n_layers)
    img, img2 = _tile(), _tile(seed=11)
    want, want2 = (jgen.generate_regions(t, area_threshold=32) for t in (img, img2))
    assert (want > 0).any() and (want2 > 0).any()
    np.testing.assert_array_equal(oracle.regions(img, area_threshold=32), want)

    got = gen.generate_regions(img, area_threshold=32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got_b = gen.generate_regions_batch([img, img2], area_threshold=32)
    np.testing.assert_array_equal(got_b[0], want)
    np.testing.assert_array_equal(got_b[1], want2)
    np.testing.assert_array_equal(got_b[1], oracle.regions(img2, area_threshold=32))
    streamed = list(gen.generate_regions_stream(iter([[img], [img2], [img2, img]]),
                                                area_threshold=32))
    assert [len(s) for s in streamed] == [1, 1, 2]
    for m, w in zip((streamed[0][0], streamed[1][0], *streamed[2]), (want, want2, want2, want)):
        np.testing.assert_array_equal(m, w)


@pytest.mark.parametrize('thresholds', [(-1e9, 0.0), (2.0, 1.1), (0.1, 0.0002)])
def test_budget_skip_changes_no_map(models, thresholds):
    """The budget skip on and off give identical maps, where the budget fills
    early (later chunks really are skipped), where it never fills (every
    chunk live, nothing selected) and in between, where they are also held
    to the JAX generator's (with its own skip on)."""
    t_iou, t_st = thresholds
    kw = dict(points_per_side=8, points_per_batch=8, pred_iou_thresh=t_iou,
              stability_score_thresh=t_st, crop_n_layers=1,
              crop_n_points_downscale_factor=2, mask_budget=16)
    gen = auto.SamRegionGenerator(models[2], **kw)
    gen_off = auto.SamRegionGenerator(models[2], budget_skip=False, **kw)
    tiles = [_tile(), _tile(seed=11)]
    on = gen.generate_regions_batch(tiles, area_threshold=4)
    off = gen_off.generate_regions_batch(tiles, area_threshold=4)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    # 8 chunks for crop 0 and 2 for each of the 4 layer-1 crops, per tile
    assert gen_off.counts == {'chunks_live': 32, 'chunks_skipped': 0}
    assert gen.counts['chunks_live'] + gen.counts['chunks_skipped'] == 32
    if t_iou < 0:
        # 24 candidates a chunk all pass: the budget of 16 is full after chunk
        # 0, which is known once chunk 1 is queued, so crop 0 runs 2 of 8
        assert gen.counts['chunks_skipped'] == 2 * 6 and all(m.any() for m in on)
    elif t_iou > 1:
        assert gen.counts['chunks_skipped'] == 0 and not any(m.any() for m in on)
    else:
        jgen = jauto.SamRegionGenerator(models[0], models[1], compute_dtype=jnp.float32, **kw)
        assert any(m.any() for m in on)
        for a, w in zip(on, jgen.generate_regions_batch(tiles, area_threshold=4)):
            np.testing.assert_array_equal(a, w)


def test_empty_result_has_shape_and_dtype(models):
    gen = auto.SamRegionGenerator(models[2], **{**_OPEN, 'pred_iou_thresh': 1e9,
                                                'stability_score_thresh': 1.0})
    tiles = [_tile(seed=4, h=64, w=64), _tile(seed=5, h=64, w=64)]
    maps = gen.generate_regions_batch(tiles)
    single = gen.generate_regions(tiles[0])
    for m in (*maps, single):
        assert m.shape == (64, 64) and m.dtype == np.int32 and not m.any()
    assert auto.SamAutomaticMaskGenerator(
        models[2], **{**_OPEN, 'pred_iou_thresh': 1e9}).generate(tiles[0]) == []


def test_mask_budget_above_grid_size(models):
    """A budget larger than the candidate count (grid * 3): id vectors are
    sized to the actual selection."""
    kw = dict(points_per_side=2, points_per_batch=4, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0, crop_n_layers=0, mask_budget=256)
    jgen, gen = _pair(models, 'SamRegionGenerator', **kw)
    img = _tile(seed=3, h=64, w=64)
    out = gen.generate_regions(img, area_threshold=4)
    assert out.shape == (64, 64) and out.any()
    np.testing.assert_array_equal(out, jgen.generate_regions(img, area_threshold=4))
    outs = gen.generate_regions_batch([img, img], area_threshold=4)
    np.testing.assert_array_equal(outs[0], out)
    np.testing.assert_array_equal(outs[1], out)


@pytest.mark.parametrize('crop_n_layers', [0, 1])
def test_interleaved_masks_equal_blocked(models, crop_n_layers):
    kw = dict(crop_n_layers=crop_n_layers, crop_n_points_downscale_factor=2, **_KW)
    img = _tile()
    blocked = auto.SamRegionGenerator(models[2], **kw).generate_regions_batch([img], 32)[0]
    inter = auto.SamRegionGenerator(models[2], blocked_masks=False, **kw)
    assert blocked.any()
    np.testing.assert_array_equal(inter.generate_regions_batch([img], 32)[0], blocked)
    np.testing.assert_array_equal(inter.generate_regions(img, 32), blocked)


def test_iou_gate_changes_no_map(models):
    kw = dict(crop_n_layers=1, crop_n_points_downscale_factor=2, **_KW)
    img = _tile(seed=11)
    gated = auto.SamRegionGenerator(models[2], **kw).generate_regions(img, 32)
    ungated = auto.SamRegionGenerator(models[2], iou_gate=False, **kw).generate_regions(img, 32)
    assert gated.any()
    np.testing.assert_array_equal(gated, ungated)


def test_fast_stability_matches_jax_fast_mode(models, monkeypatch):
    """Stability on the low-res logits, by argument and by the environment
    switch, against the JAX generator's fast mode."""
    kw = dict(crop_n_layers=1, crop_n_points_downscale_factor=2, points_per_side=8,
              points_per_batch=32, pred_iou_thresh=0.1, stability_score_thresh=0.02)
    jgen, gen = _pair(models, 'SamRegionGenerator', stability_on_upscaled=False, **kw)
    img = _tile()
    want = jgen.generate_regions(img, area_threshold=32)
    assert want.any()
    np.testing.assert_array_equal(gen.generate_regions(img, area_threshold=32), want)
    exact = auto.SamRegionGenerator(models[2], **kw)
    monkeypatch.setenv('REGDA_SAM_FAST_STABILITY', '1')
    by_env = auto.SamRegionGenerator(models[2], **kw)
    assert exact.stability_on_upscaled and not by_env.stability_on_upscaled
    np.testing.assert_array_equal(by_env.generate_regions_batch([img], 32)[0], want)


def test_region_generator_partitions_like_ann_path(models):
    """`generate_regions` and `generate` + `regions_from_anns` of the port
    paint the same map: the two preprocess paths (host matrices, device
    interpolate) agree to float32 rounding, and the seed keeps clear of the
    thresholds."""
    kw = dict(crop_n_layers=1, crop_n_points_downscale_factor=2, **_KW)
    img = _tile()
    anns = auto.SamAutomaticMaskGenerator(models[2], **kw).generate(img)
    ref = auto.regions_from_anns(anns, img.shape[:2], area_threshold=32)
    dev = auto.SamRegionGenerator(models[2], **kw).generate_regions(img, area_threshold=32)
    np.testing.assert_array_equal(dev, ref)


def test_timing_report_counts(models, capsys):
    """`timing=True` prints the phase line, counts what passes each filter and
    times the stages; the maps are those of the untimed generator."""
    kw = dict(crop_n_layers=1, crop_n_points_downscale_factor=2, **_KW)
    img = _tile()
    gen = auto.SamRegionGenerator(models[2], timing=True, **kw)
    got = gen.generate_regions_batch([img], area_threshold=32)[0]
    np.testing.assert_array_equal(
        got, auto.SamRegionGenerator(models[2], **kw).generate_regions_batch([img], 32)[0])
    assert '[sam-timing] n=1' in capsys.readouterr().out
    rep = gen.report()
    assert rep['candidates'] == 3 * (64 + 4 * 16)
    assert rep['candidates'] > rep['pass_iou'] > rep['pass_iou_and_stability'] > 0
    assert rep['selected'] >= rep['off_crop_edge'] >= rep['per_crop_nms'] \
        >= rep['cross_crop_nms'] >= rep['painted'] > 0
    assert {'preprocess', 'encode', 'decode', 'stability', 'select', 'mask_stats', 'nms',
            'paint', 'download'} <= set(rep['stage_ms'])
    gen.reset_report()
    assert gen.report()['candidates'] == 0 and gen.counts['chunks_live'] == 0


# ------------------------------------------------------------------- the CLI

@pytest.mark.parametrize('fast', [1, 0])
def test_seg_everything_cli_writes_region_tifs(models, tmp_path, fast):
    """`python -m regda_tpu_torch.tools.seg_everything` on the CPU: int32 .tif
    region maps in the sibling reg_dir, from a segment-anything state_dict."""
    from PIL import Image
    from regda_tpu_torch.tools import seg_everything
    img_dir = tmp_path / 'img_dir' / 'train'
    img_dir.mkdir(parents=True)
    # fast: a batch of two and a ragged one of one
    tiles = {f'tile{i}.png': _tile(seed=30 + i, h=64, w=64) for i in range(3 if fast else 2)}
    for name, tile in tiles.items():
        Image.fromarray(tile).save(img_dir / name)
    ckpt = tmp_path / 'sam_vit_t.pth'
    torch.save(models[2].state_dict(), ckpt)
    seg_everything.main(['--img-dirs', str(img_dir), '--checkpoint', str(ckpt), '--model-type',
                         'vit_t', '--img-size', str(IMG), '--device', 'cpu', '--points-per-side',
                         '4', '--pred-iou-thresh=-1e9', '--stability-thresh', '0',
                         '--area-threshold', '16', '--batch-tiles', '2', '--fast', str(fast)])
    # the CLI computes in bfloat16, the port's default
    model = Sam(vit_config='vit_t', img_size=IMG).eval()
    model.load_state_dict(models[2].state_dict())
    gen = auto.SamRegionGenerator(model, points_per_side=4, pred_iou_thresh=-1e9,
                                  stability_score_thresh=0.0, crop_n_layers=1,
                                  crop_n_points_downscale_factor=2)
    for name, tile in tiles.items():
        out = np.asarray(Image.open(tmp_path / 'reg_dir' / 'train' / name.replace('.png', '.tif')))
        assert out.dtype == np.int32 and out.shape == (64, 64) and out.any()
        if fast and name != 'tile1.png':     # the first batch's and the ragged one's
            np.testing.assert_array_equal(out, gen.generate_regions(tile, area_threshold=16))


def _upstream_checkpoint(models):
    """A segment-anything state_dict at the CLI test's vit_t size: the
    upstream-faithful oracle's keys, its mask-prompt branch
    (`prompt_encoder.mask_downscaling.*`) and pixel constants included, with
    every key the port shares taken from the port's model (the two layouts
    agree, test_torch_sam_model.py)."""
    from tests.torch_sam_oracle import SamOracle
    state = SamOracle(img_size=IMG, **VIT_CONFIGS['vit_t']).state_dict()
    port = models[2].state_dict()
    assert any(k.startswith('prompt_encoder.mask_downscaling.') for k in state)
    assert set(port) <= set(state)
    return {k: port.get(k, v).clone() for k, v in state.items()}


def _cli_args(ckpt):
    from regda_tpu_torch.tools import seg_everything
    return seg_everything.build_parser().parse_args(
        ['--checkpoint', str(ckpt), '--model-type', 'vit_t', '--img-size', str(IMG),
         '--device', 'cpu'])


def test_seg_everything_cli_loads_an_upstream_checkpoint(models, tmp_path):
    """The CLI loads a segment-anything checkpoint that holds the mask-prompt
    branch, and every parameter of its model is the saved one."""
    from regda_tpu_torch.tools import seg_everything
    state = _upstream_checkpoint(models)
    ckpt = tmp_path / 'sam_upstream.pth'
    torch.save(state, ckpt)
    loaded = seg_everything.load_model(_cli_args(ckpt)).state_dict()
    assert set(loaded) <= set(state)
    for key, value in loaded.items():
        assert torch.equal(value, state[key].to(value.dtype)), key


@pytest.mark.parametrize('key', ['mask_decoder.iou_token.weight',
                                 'image_encoder.blocks.1.attn.qkv.weight'])
def test_seg_everything_cli_rejects_a_renamed_key(models, tmp_path, key):
    """One key renamed: the CLI raises KeyError naming it, instead of leaving
    that parameter at its random value."""
    from regda_tpu_torch.tools import seg_everything
    state = _upstream_checkpoint(models)
    state[key.replace('weight', 'kernel')] = state.pop(key)
    ckpt = tmp_path / 'sam_renamed.pth'
    torch.save(state, ckpt)
    with pytest.raises(KeyError, match=re.escape(key)) as err:
        seg_everything.load_model(_cli_args(ckpt))
    assert key.replace('weight', 'kernel') in str(err.value)


def test_seg_everything_cli_rejects_a_missing_key(models, tmp_path):
    from regda_tpu_torch.tools import seg_everything
    state = _upstream_checkpoint(models)
    del state['prompt_encoder.not_a_point_embed.weight']
    ckpt = tmp_path / 'sam_missing.pth'
    torch.save(state, ckpt)
    with pytest.raises(KeyError, match='not_a_point_embed'):
        seg_everything.load_model(_cli_args(ckpt))


def test_seg_everything_cli_needs_a_card_by_default(tmp_path):
    from regda_tpu_torch.tools import seg_everything
    args = seg_everything.build_parser().parse_args([])
    assert args.device == 'cuda' and args.fast == 1 and args.crop_n_layers == 1
    assert (args.pred_iou_thresh, args.stability_thresh, args.points_per_side) == (0.90, 0.95, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            seg_everything.load_model(args)
