"""The port's SAM (regda_tpu_torch/models/sam/) against the JAX package.

One set of weights, drawn with numpy, goes into the JAX `Sam` as its Flax
tree and into the port's `Sam` through `sam_from_jax_variables`; the same
numpy inputs go through both at `vit_t`, 128^2 (an 8x8 grid, so windowed
blocks pad 8 -> 14), in float32 and in bfloat16. The JAX side runs its default path, the
Pallas kernels in interpret mode; the port takes its kernels' plain versions,
as it does for any CPU tensor.

Tolerances are those of tests/test_sam_oracle.py, which holds the JAX
modules to the same architecture: rtol 1e-4 / atol 1e-5 for the encoder,
1e-4 / 1e-4 for masks and IoU; the prompt encoder is elementwise, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regda_tpu.models.sam import vit as jvit
from regda_tpu.models.sam.auto import Sam as JaxSam
from regda_tpu.models.sam.auto import build_point_grid as jax_point_grid
from regda_tpu.models.sam.convert import convert_sam_checkpoint
from regda_tpu_torch import entry as port_entry
from regda_tpu_torch.models.sam import vit
from regda_tpu_torch.models.sam.auto import Sam, build_point_grid, preprocess_shape
from regda_tpu_torch.models.sam.convert import load_jax_variables, sam_from_jax_variables

IMG = 128


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    points = np.array([[[17.0, 90.0]], [[64.0, 3.0]], [[100.5, 55.25]], [[0.0, 127.0]]],
                      np.float32)
    labels = np.array([[1.0], [1.0], [0.0], [1.0]], np.float32)
    return images, points, labels


@pytest.fixture(scope='module')
def models(inputs):
    """(jax model, its variables with numpy leaves, the port's model)."""
    images, points, labels = inputs
    jax_model = JaxSam(vit_config='vit_t', img_size=IMG, dtype=jnp.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                               jnp.asarray(points), jnp.asarray(labels))
    # every leaf perturbed: the zero-initialised tables (pos_embed, rel_pos_*)
    # contribute and the LayerNorm affines differ from identity
    rng = np.random.default_rng(4)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        variables)
    model = Sam(vit_config='vit_t', img_size=IMG, dtype=torch.float32).eval()
    load_jax_variables(model, variables)
    return jax_model, variables, model


def test_encode_matches_jax(models, inputs):
    jax_model, variables, model = models
    images = inputs[0]
    want = np.asarray(jax_model.apply(variables, jnp.asarray(images), method=jax_model.encode))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, IMG // 16, IMG // 16, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_prompt_encoder_matches_jax(models, inputs):
    jax_model, variables, model = models
    _, points, labels = inputs
    sparse_j, dense_j = jax_model.apply(
        variables, jnp.asarray(points), jnp.asarray(labels),
        method=lambda m, p, l: m.prompt_encoder(p, l))
    pe_j = jax_model.apply(variables, method=lambda m: m.prompt_encoder.get_dense_pe())
    with torch.no_grad():
        sparse_t, dense_t = model.prompt_encoder(torch.from_numpy(points),
                                                 torch.from_numpy(labels))
        pe_t = model.prompt_encoder.get_dense_pe()
    assert tuple(dense_t.shape) == (4, IMG // 16, IMG // 16, 256)
    assert tuple(sparse_t.shape) == (4, 2, 256)
    np.testing.assert_allclose(sparse_t.numpy(), np.asarray(sparse_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dense_t.detach().numpy(), np.asarray(dense_j))
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=1e-5, atol=1e-5)


def test_decode_points_matches_jax(models, inputs):
    jax_model, variables, model = models
    _, points, labels = inputs
    emb = np.random.default_rng(5).normal(size=(1, IMG // 16, IMG // 16, 256)).astype(np.float32)
    masks_j, iou_j = jax_model.apply(variables, jnp.asarray(emb), jnp.asarray(points),
                                     jnp.asarray(labels), method=jax_model.decode_points)
    with torch.no_grad():
        masks_t, iou_t = model.decode_points(torch.from_numpy(emb), torch.from_numpy(points),
                                             torch.from_numpy(labels))
    assert tuple(masks_t.shape) == (4, 3, IMG // 4, IMG // 4) and tuple(iou_t.shape) == (4, 3)
    np.testing.assert_allclose(masks_t.numpy(), np.asarray(masks_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(iou_t.numpy(), np.asarray(iou_j), rtol=1e-4, atol=1e-4)


def test_forward_matches_jax(models, inputs):
    jax_model, variables, model = models
    images, points, labels = inputs
    masks_j, iou_j = jax_model.apply(variables, jnp.asarray(images[:1]), jnp.asarray(points),
                                     jnp.asarray(labels))
    with torch.no_grad():
        masks_t, iou_t = model(torch.from_numpy(images[:1]), torch.from_numpy(points),
                               torch.from_numpy(labels))
    np.testing.assert_allclose(masks_t.numpy(), np.asarray(masks_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(iou_t.numpy(), np.asarray(iou_j), rtol=1e-4, atol=1e-4)


# bfloat16, the main path's compute dtype, against the JAX package in
# bfloat16. Both round at the same places, but sum in different orders and the
# port's Linear adds its bias before the one rounding where Flax's Dense
# rounds the product and then the sum, so results differ by a few roundings.
# One step below is 2^-8, bfloat16's relative precision, times the largest
# magnitude of the JAX result.
_BF16_STEP = 2.0 ** -8


def _assert_within_bf16_steps(got, want, steps):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    limit = steps * _BF16_STEP * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= limit


@pytest.fixture(scope='module')
def bf16_models(models):
    _, variables, _ = models
    jax_model = JaxSam(vit_config='vit_t', img_size=IMG, dtype=jnp.bfloat16)
    model = Sam(vit_config='vit_t', img_size=IMG).eval()      # bfloat16 by default
    load_jax_variables(model, variables)
    return jax_model, variables, model


@pytest.mark.parametrize('index,window', [(0, 14), (1, 0)], ids=['windowed', 'global'])
def test_bfloat16_block_matches_jax(bf16_models, index, window):
    """One encoder block on the same bfloat16 input: the residual stream stays
    bfloat16 and the two agree within two bfloat16 spacings at the largest
    magnitude (one rounding in the branch, one in the residual add)."""
    _, variables, model = bf16_models
    x = np.random.default_rng(9).normal(size=(2, IMG // 16, IMG // 16, 64)).astype(np.float32)
    block = jvit.Block(64, 2, window_size=window, input_size=(IMG // 16, IMG // 16),
                       dtype=jnp.bfloat16)
    params = variables['params']['image_encoder'][f'block{index}']
    want = block.apply({'params': params}, jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        got = model.image_encoder.blocks[index](torch.from_numpy(x).bfloat16())
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert float(np.abs(got - want).max()) <= 2 * spacing
    assert float(np.sqrt(((got - want) ** 2).mean())) <= 0.5 * spacing


@pytest.mark.parametrize('jax_norm', ['vit.LayerNorm2d', 'decoder.LayerNorm2dDec'])
def test_bfloat16_layernorm2d_matches_jax(jax_norm):
    """LayerNorm2d on a bfloat16 map (the neck's and the mask head's): moments
    and the normalized value in bfloat16, the float32 affine promoting the
    result. Elementwise after the two means, so the two agree to float32
    rounding; moments taken in float32 instead would be a bfloat16 step off."""
    from regda_tpu.models.sam import decoder as jdecoder
    cls = jvit.LayerNorm2d if jax_norm == 'vit.LayerNorm2d' else jdecoder.LayerNorm2dDec
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 8, 8, 256)) * 1.5 + 0.3).astype(np.float32)
    w, b = (rng.normal(size=256).astype(np.float32) for _ in range(2))
    want = cls().apply({'params': {'weight': w, 'bias': b}},
                       jnp.asarray(x).astype(jnp.bfloat16))
    norm = vit.LayerNorm2d(256)
    norm.load_state_dict({'weight': torch.from_numpy(w), 'bias': torch.from_numpy(b)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x).bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_bfloat16_decoder_attention_matches_jax(bf16_models):
    """The mask decoder's attention on the same float32 inputs, computing in
    bfloat16 with its softmax in float32: within four bfloat16 spacings at
    the largest magnitude (the logits, rounded to bfloat16 before the softmax,
    the probabilities, the product with v and the output projection)."""
    from regda_tpu.models.sam.decoder import AttentionDS as JaxAttentionDS
    _, variables, model = bf16_models
    rng = np.random.default_rng(12)
    q = rng.normal(size=(3, 7, 256)).astype(np.float32)
    k = rng.normal(size=(3, 64, 256)).astype(np.float32)
    v = rng.normal(size=(3, 64, 256)).astype(np.float32)
    name = 'cross_attn_token_to_image'
    params = variables['params']['mask_decoder']['transformer']['layer1'][name]
    want = JaxAttentionDS(256, 8, 2, dtype=jnp.bfloat16).apply(
        {'params': params}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    attn = getattr(model.mask_decoder.transformer.layers[1], name)
    with torch.no_grad():
        got = attn(*(torch.from_numpy(a) for a in (q, k, v)))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert float(np.abs(got - want).max()) <= 4 * spacing


def test_bfloat16_stem_and_neck_match_jax(bf16_models, inputs):
    """An encoder of depth 0: patch embedding, the cast of pos_embed, the neck
    convs in bfloat16 and its two LayerNorm2d, which promote to float32 and
    divide by a bfloat16 deviation, so a rounding of the input grows."""
    _, variables, model = bf16_models
    kwargs = dict(img_size=IMG, embed_dim=64, depth=0, num_heads=2, global_attn_indexes=())
    params = {k: v for k, v in variables['params']['image_encoder'].items()
              if not k.startswith('block')}
    want = jvit.ImageEncoderViT(dtype=jnp.bfloat16, **kwargs).apply(
        {'params': params}, jnp.asarray(inputs[0]))
    stem = vit.ImageEncoderViT(dtype=torch.bfloat16, **kwargs).eval()
    stem.load_state_dict({k: v for k, v in model.image_encoder.state_dict().items()
                          if not k.startswith('blocks.')})
    with torch.no_grad():
        got = stem(torch.from_numpy(inputs[0]))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _assert_within_bf16_steps(got.numpy(), want, steps=4)


def test_bfloat16_encode_matches_jax(bf16_models, inputs):
    jax_model, variables, model = bf16_models
    images = inputs[0]
    want = jax_model.apply(variables, jnp.asarray(images), method=jax_model.encode)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(images))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _assert_within_bf16_steps(got.numpy(), want, steps=6)


def test_bfloat16_decode_points_matches_jax(bf16_models, inputs):
    jax_model, variables, model = bf16_models
    _, points, labels = inputs
    emb = np.random.default_rng(5).normal(size=(1, IMG // 16, IMG // 16, 256)).astype(np.float32)
    masks_j, iou_j = jax_model.apply(variables, jnp.asarray(emb), jnp.asarray(points),
                                     jnp.asarray(labels), method=jax_model.decode_points)
    with torch.no_grad():
        masks_t, iou_t = model.decode_points(torch.from_numpy(emb), torch.from_numpy(points),
                                             torch.from_numpy(labels))
    assert masks_j.dtype == iou_j.dtype == jnp.float32
    assert masks_t.dtype == iou_t.dtype == torch.float32
    _assert_within_bf16_steps(masks_t.numpy(), masks_j, steps=6)
    _assert_within_bf16_steps(iou_t.numpy(), iou_j, steps=6)


def test_bfloat16_forward_stays_near_float32(models, inputs):
    """The default compute dtype: float32 parameters, float32 embedding, masks
    and IoU out, and values near the float32 run's. A sanity check only (a
    tenth of the value range); the tests above hold bfloat16 to the JAX
    package's bfloat16."""
    _, variables, model = models
    images, points, labels = (torch.from_numpy(a) for a in inputs)
    half = Sam(vit_config='vit_t', img_size=IMG).eval()      # bfloat16 by default
    load_jax_variables(half, variables)
    assert all(p.dtype == torch.float32 for p in half.parameters())
    with torch.no_grad():
        want = model(images[:1], points, labels)
        emb = half.encode(images[:1])
        got = half.decode_points(emb, points, labels)
    assert emb.dtype == torch.float32
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= 0.1 * float(w.abs().max())


@pytest.mark.parametrize('rows,q_size,k_size', [
    (27, 14, 14),     # the table's own size: no resize
    (127, 14, 14),    # a longer table is shrunk (antialiased on the JAX side)
    (15, 14, 14),     # a shorter table is stretched
    (27, 8, 14)])     # q and k sizes differ
def test_get_rel_pos_matches_jax(rows, q_size, k_size):
    table = np.random.default_rng(rows).normal(size=(rows, 16)).astype(np.float32)
    want = np.asarray(jvit._get_rel_pos(q_size, k_size, jnp.asarray(table)))
    got = vit._get_rel_pos(q_size, k_size, torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (q_size, k_size, 16)
    # the resize weights are float32 on both sides, summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_window_partition_round_trip_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 10, 4)).astype(np.float32)
    win_j, pad_j = jvit.window_partition(jnp.asarray(x), 7)
    win_t, pad_t = vit.window_partition(torch.from_numpy(x), 7)
    assert tuple(pad_t) == tuple(pad_j) == (14, 14)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    back = vit.window_unpartition(win_t, 7, pad_t, (8, 10))
    np.testing.assert_array_equal(back.numpy(), x)


def test_conversion_round_trip_is_exact(models):
    """convert_sam_checkpoint(port state_dict) is the JAX tree, bit for bit."""
    _, variables, model = models
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    back, want = _flat(convert_sam_checkpoint(state)), _flat(variables)
    assert back.keys() == want.keys()
    for key in want:
        assert back[key].dtype == want[key].dtype and np.array_equal(back[key], want[key]), key
    direct = _flat(convert_sam_checkpoint(
        {k: v.numpy() for k, v in sam_from_jax_variables(variables).items()}))
    assert all(np.array_equal(direct[key], want[key]) for key in want)


def test_state_dict_loads_strictly_into_upstream_layout(models, inputs):
    """The port's keys are segment-anything's: its state_dict loads with
    strict=True into the upstream-faithful oracle (whose mask-prompt branch,
    unused by either package, is removed first), and the oracle, an
    independent implementation, then agrees with the port."""
    from tests.torch_sam_oracle import SamOracle
    _, _, model = models
    images, points, labels = (torch.from_numpy(a) for a in inputs)
    oracle = SamOracle(img_size=IMG, embed_dim=64, depth=2, num_heads=2,
                       global_attn_indexes=(1,), window_size=14).eval()
    del oracle.prompt_encoder.mask_downscaling
    oracle.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        masks_o, iou_o = oracle(images[:1].permute(0, 3, 1, 2), points, labels)
        masks_t, iou_t = model(images[:1], points, labels)
    np.testing.assert_allclose(masks_t.numpy(), masks_o.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(iou_t.numpy(), iou_o.numpy(), rtol=1e-4, atol=1e-4)


def test_helpers_match_jax():
    np.testing.assert_array_equal(build_point_grid(32), jax_point_grid(32))
    assert preprocess_shape(300, 500, 1024) == (614, 1024)
    assert vit.VIT_CONFIGS == jvit.VIT_CONFIGS


def test_sam_entry_is_seeded_and_fills_the_position_tables():
    kwargs = dict(vit_config='vit_t', img_size=64, crops=2, points=5, dtype=torch.float32)
    model, (images, points, labels) = port_entry.sam_entry('cpu', **kwargs)
    again, args = port_entry.sam_entry('cpu', **kwargs)
    assert tuple(images.shape) == (2, 64, 64, 3) and tuple(points.shape) == (5, 1, 2)
    assert tuple(labels.shape) == (5, 1) and not model.training
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip((images, points, labels), args))
    for name, p in model.named_parameters():
        if name.endswith(('pos_embed', 'rel_pos_h', 'rel_pos_w')):
            assert float(p.detach().abs().max()) > 0, name
    np.testing.assert_allclose(points[:, 0].numpy(), build_point_grid(32)[:5] * 64, rtol=1e-6)
    with torch.no_grad():
        masks, iou = model(images[:1], points, labels)
    assert tuple(masks.shape) == (5, 3, 16, 16) and bool(torch.isfinite(masks).all())


@pytest.mark.parametrize('call', ['entry', 'stage2_state', 'stage2_steps', 'sam_entry'])
def test_entry_points_default_to_the_card(call):
    """With no device named, an entry point runs on the card, and raises
    where there is none: nothing moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card; the default device would be used')
    fn = getattr(port_entry, call)
    with pytest.raises(RuntimeError, match='CUDA'):
        fn(1) if call == 'stage2_steps' else fn()
