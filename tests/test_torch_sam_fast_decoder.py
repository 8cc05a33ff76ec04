"""The port's fast SAM decoder (regda_tpu_torch/models/sam/fast_decoder.py and
the plain versions of its two kernels) against the JAX package.

`two_way_fused` and `upscale_hyper_masks` (regda_tpu_torch/ops/kernels/) take
their plain PyTorch versions on CPU tensors; those are what the CUDA kernels
are held against on the card (tests/test_torch_cuda.py, chip_smoke.py). Here
the same numpy-seeded inputs go through the plain versions and through the
JAX package's Pallas kernels (interpret mode off-TPU, as its own tests run
them) and their stock twins; one set of decoder weights, drawn with numpy,
goes through the JAX `mask_decoder_fast` and the port's, and one set of SAM
weights through both `Sam.decode_points_fast`. `REGDA_FUSED_TWOWAY=1` makes
the JAX `mask_decoder_fast` take its two-way kernel off-TPU.

Tolerances: float32 rtol/atol 1e-4, the JAX tests' own (tests/test_sam.py);
gradients 2e-3 (two-way) and 1e-3 (mask head), again theirs. bfloat16 is
counted in steps of 2^-8 times the largest magnitude of the JAX result, as
in tests/test_torch_sam_model.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regda_tpu.models.sam import fast_decoder as jfast
from regda_tpu.models.sam import pallas_twoway as jtw
from regda_tpu.models.sam import pallas_upscale as jup
from regda_tpu.models.sam.auto import Sam as JaxSam
from regda_tpu.models.sam.decoder import MaskDecoder as JaxMaskDecoder
from regda_tpu_torch.models.sam import fast_decoder as fast
from regda_tpu_torch.models.sam.auto import Sam
from regda_tpu_torch.models.sam.convert import load_jax_variables, sam_from_jax_variables
from regda_tpu_torch.models.sam.decoder import MaskDecoder
from regda_tpu_torch.ops.kernels import two_way as tw
from regda_tpu_torch.ops.kernels import upscale as up

TOL = dict(rtol=1e-4, atol=1e-4)
_BF16_STEP = 2.0 ** -8


def _np(t):
    return t.detach().float().numpy()


def _bf16_steps(got, want):
    """max |got - want| in steps of 2^-8 * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (_BF16_STEP * float(np.abs(want).max()))


# ------------------------------------------------------------ two-way kernel

def _two_way_operands(n, b=2, t=64, c=256, d=128, mlp=512, seed=0):
    """Operands as numpy: n of the 8 token rows used, the rest zero-padded."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)
    acts = [f(b, 8, d), f(b, 8, d), f(b, 8, c), f(b, 8, c), f(t, c), f(t, c), f(t, d)]
    for a in acts[:4]:
        a[:, n:] = 0
    maskb = np.where(np.arange(8) < n, 0.0, -1e9)[None].astype(np.float32)
    weights = {k: f(*shape) for k, shape in tw._weight_shapes(c, d, mlp).items()}
    return acts, maskb, weights


def _jax_ops(acts, maskb, weights, dtype=jnp.float32):
    return (*(jnp.asarray(a).astype(dtype) for a in acts), jnp.asarray(maskb),
            {k: jnp.asarray(v) for k, v in weights.items()})


def _torch_ops(acts, maskb, weights, dtype=torch.float32, requires_grad=False):
    def leaf(a, dt=None):
        t = torch.from_numpy(a.copy())
        t = t if dt is None else t.to(dt)
        return t.requires_grad_(requires_grad)
    return (*(leaf(a, dtype) for a in acts), leaf(maskb),
            {k: leaf(v) for k, v in weights.items()})


def test_weight_keys_match_jax():
    assert tw.WKEYS == jtw.WKEYS and tw.NP == jtw.NP and tw.EPS == jtw.EPS
    assert set(tw._weight_shapes(256, 128, 2048)) == set(tw.WKEYS)


@pytest.mark.parametrize('n', [7, 5])
@pytest.mark.parametrize('reference', ['stock', 'pallas'])
def test_two_way_plain_matches_jax(n, reference):
    case = _two_way_operands(n)
    before = tw.launches
    keys2, qout = tw.two_way_fused(_torch_ops(*case))
    assert tw.launches == before            # a CPU tensor takes the plain version
    assert tuple(keys2.shape) == (2, 64, 256) and tuple(qout.shape) == (2, 8, 256)
    ops = _jax_ops(*case)
    want_k, want_q = (jtw._twoway_stock(ops, 8) if reference == 'stock'
                      else jtw.two_way_fused(ops))
    np.testing.assert_allclose(_np(keys2), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(_np(qout)[:, :n], np.asarray(want_q)[:, :n], **TOL)


def test_two_way_plain_bfloat16_matches_jax():
    """bfloat16 against the JAX stock twin in bfloat16: the same rounding
    points, so at most a sum taken in another order lands one step off;
    measured 0 steps (equal on these inputs) for keys2 and the queries."""
    case = _two_way_operands(7, seed=1)
    keys2, qout = tw.two_way_fused(_torch_ops(*case, dtype=torch.bfloat16))
    want_k, want_q = jtw._twoway_stock(_jax_ops(*case, dtype=jnp.bfloat16), 8)
    assert keys2.dtype == qout.dtype == torch.bfloat16 and want_k.dtype == jnp.bfloat16
    assert _bf16_steps(_np(keys2), want_k.astype(jnp.float32)) <= 1
    assert _bf16_steps(_np(qout)[:, :7], want_q.astype(jnp.float32)[:, :7]) <= 1


def test_two_way_gradients_match_jax():
    """Gradients of the wrapper (CPU: through the plain version) against
    jax.grad of the stock twin, for every operand and weight."""
    case = _two_way_operands(7, seed=2)
    ops = _torch_ops(*case, requires_grad=True)
    keys2, qout = tw.two_way_fused(ops)
    ((keys2 ** 2).sum() + (qout[:, :7] ** 2).sum()).backward()

    def loss(o):
        k2, q = jtw._twoway_stock(o, 8)
        return jnp.sum(k2 ** 2) + jnp.sum(q[:, :7] ** 2)
    want = jax.grad(loss)(_jax_ops(*case))
    for i, name in enumerate(('ktok0', 'vtok0', 'q1', 'qpe', 'keys0', 'pe', 'qimg0')):
        np.testing.assert_allclose(_np(ops[i].grad), np.asarray(want[i]), rtol=2e-3, atol=2e-3,
                                   err_msg=name)
    for key in tw.WKEYS:
        np.testing.assert_allclose(_np(ops[8][key].grad), np.asarray(want[8][key]),
                                   rtol=2e-3, atol=2e-3, err_msg=key)


@pytest.mark.parametrize('bad', ['tokens', 'weights', 'device'])
def test_two_way_rejects_bad_operands(bad):
    acts, maskb, weights = _two_way_operands(7)
    ops = list(_torch_ops(acts, maskb, weights))
    if bad == 'tokens':
        ops[0] = torch.zeros(2, 9, 128)
    elif bad == 'weights':
        ops[8] = {k: v for k, v in ops[8].items() if k != 'bkt'}
    else:
        ops[4] = ops[4].to('meta')
    with pytest.raises(ValueError):
        tw.two_way_fused(tuple(ops))


@pytest.mark.parametrize('b,t', [(64, 4096), (256, 4096), (1, 4096), (3, 64), (2, 200),
                                 (1, 40000)])
def test_two_way_column_splits_cover_every_row(b, t):
    """What the launch checks: whole tiles per block, every row in one block,
    no block without a row, no more blocks than the token kernels merge."""
    rows, splits = tw.column_splits(b, t, sms=132)
    assert rows % tw.PASS_TILE == 0 and 1 <= splits <= tw.MAX_SPLITS
    assert (splits - 1) * rows < t <= splits * rows


# ---------------------------------------------------------- mask-head kernel

def _upscale_args(b=2, h=8, w=8, c=256, m=3, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    c4, c8 = c // 4, c // 8
    return (f(b, h, w, c), f(b, m, c8), f(c, 4 * c4, scale=0.1), f(1, 4 * c4), f(1, c4),
            f(1, c4), f(c4, 4 * c8, scale=0.2), f(1, 4 * c8))


def _cast(args, dtype, lib):
    """src, hyper_in, k1 and k2 in `dtype`; biases and the affine float32."""
    conv = (lambda a, dt: torch.from_numpy(a).to(dt)) if lib is torch else \
        (lambda a, dt: jnp.asarray(a).astype(dt))
    f32 = torch.float32 if lib is torch else jnp.float32
    return tuple(conv(a, dtype if i in (0, 1, 2, 6) else f32) for i, a in enumerate(args))


@pytest.mark.parametrize('m', [1, 3])
@pytest.mark.parametrize('reference', ['stock', 'pallas'])
def test_upscale_plain_matches_jax(m, reference):
    args = _upscale_args(m=m, seed=m)
    before = up.launches
    got = up.upscale_hyper_masks(*_cast(args, torch.float32, torch))
    assert up.launches == before
    assert tuple(got.shape) == (2, m, 32, 32) and got.dtype == torch.float32
    jargs = _cast(args, jnp.float32, jnp)
    want = (jup._upscale_stock(*jargs, jnp.float32) if reference == 'stock'
            else jup.upscale_hyper_masks(*jargs))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_upscale_blocked_and_gated_match_jax():
    args = _upscale_args(b=3, seed=5)
    targs, jargs = _cast(args, torch.float32, torch), _cast(args, jnp.float32, jnp)
    plain = up.upscale_hyper_masks(*targs)
    blocked = up.upscale_hyper_masks(*targs, blocked=True)
    assert tuple(blocked.shape) == (3, 48, 64)
    assert torch.equal(up.masks_from_blocked(blocked, 8, 8), plain)
    np.testing.assert_allclose(_np(blocked),
                               np.asarray(jup.upscale_hyper_masks(*jargs, blocked=True)), **TOL)
    np.testing.assert_array_equal(
        _np(up.masks_from_blocked(blocked, 8, 8)),
        np.asarray(jup.masks_from_blocked(jnp.asarray(_np(blocked)), 8, 8)))
    active = np.array([True, False, True])
    for is_blocked in (False, True):
        gated = up.upscale_hyper_masks(*targs, active=torch.from_numpy(active),
                                       blocked=is_blocked)
        full = blocked if is_blocked else plain
        assert torch.equal(gated[active], full[active])
        assert bool((gated[~active] == 0).all())
        want = jup.upscale_hyper_masks(*jargs, active=jnp.asarray(active), blocked=is_blocked)
        np.testing.assert_allclose(_np(gated), np.asarray(want), **TOL)


def test_upscale_plain_bfloat16_matches_jax():
    """bfloat16 compute and output against the JAX stock twin in bfloat16.
    The port's gelu evaluates in float32 and rounds once where XLA rounds
    each step of it, so values differ by a few roundings; measured 1.1
    steps."""
    args = _upscale_args(seed=6)
    got = up.upscale_hyper_masks(*_cast(args, torch.bfloat16, torch), out_dtype=torch.bfloat16)
    want = jup._upscale_stock(*_cast(args, jnp.bfloat16, jnp), jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _bf16_steps(_np(got), want.astype(jnp.float32)) <= 3


def test_upscale_gradients_match_jax():
    """The JAX test's own case (tests/test_sam.py): narrow widths, 4 masks."""
    args = _upscale_args(b=1, c=64, m=4, seed=7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (up.upscale_hyper_masks(*leaves) ** 2).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jup._upscale_stock(*a, jnp.float32) ** 2),
                    argnums=tuple(range(8)))(*map(jnp.asarray, args))
    for i, (leaf, ref) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(_np(leaf.grad), np.asarray(ref), rtol=1e-3, atol=1e-3,
                                   err_msg=str(i))


def test_upscale_rejects_bad_operands():
    targs = list(_cast(_upscale_args(), torch.float32, torch))
    with pytest.raises(ValueError):
        up.upscale_hyper_masks(*targs[:2], targs[2][:, :128], *targs[3:])
    with pytest.raises(TypeError):
        up.upscale_hyper_masks(*targs, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        up.upscale_hyper_masks(targs[0].to('meta'), *targs[1:])


# ------------------------------------------------------- the decoder as a whole

@pytest.fixture(scope='module')
def decoder_case():
    """(jax params, port decoder f32, port decoder bf16, numpy inputs)."""
    rng = np.random.default_rng(11)

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    inputs = (f(1, 8, 8, 256), f(1, 8, 8, 256), f(5, 2, 256), f(1, 8, 8, 256))
    variables = JaxMaskDecoder(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    # every leaf perturbed: zero biases and identity LayerNorms would hide terms
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        variables['params'])
    state = {k[len('mask_decoder.'):]: v for k, v in
             sam_from_jax_variables({'params': {'mask_decoder': params}}).items()}
    decoders = []
    for dtype in (torch.float32, torch.bfloat16):
        dec = MaskDecoder(dtype=dtype).eval()
        dec.load_state_dict(state)
        decoders.append(dec)
    return params, decoders[0], decoders[1], inputs


@pytest.mark.parametrize('variant', ['fused2', 'dense'])
def test_two_way_transformer_matches_stock_and_jax(decoder_case, variant):
    params, dec, _, (emb, pe, _, _) = decoder_case
    tokens = np.random.default_rng(12).normal(size=(5, 7, 256)).astype(np.float32)
    port_fn = getattr(fast, f'two_way_transformer_{variant}')
    jax_fn = getattr(jfast, f'two_way_transformer_{variant}')
    targs = tuple(torch.from_numpy(a) for a in (emb, pe, tokens))
    with torch.no_grad():
        q, k = port_fn(dec.transformer, *targs)
        q0, k0 = dec.transformer(*targs)
    assert tuple(q.shape) == (5, 7, 256) and tuple(k.shape) == (5, 64, 256)
    np.testing.assert_allclose(_np(q), _np(q0), **TOL)
    np.testing.assert_allclose(_np(k), _np(k0), **TOL)
    qj, kj = jax_fn(params['transformer'], *map(jnp.asarray, (emb, pe, tokens)))
    np.testing.assert_allclose(_np(q), np.asarray(qj), **TOL)
    np.testing.assert_allclose(_np(k), np.broadcast_to(np.asarray(kj), k.shape), **TOL)


def test_fused_prep_rejects_too_many_tokens_and_batched_images(decoder_case):
    _, dec, _, (emb, pe, _, _) = decoder_case
    with pytest.raises(ValueError, match='tokens'):
        fast.two_way_transformer_fused2(dec.transformer, torch.from_numpy(emb),
                                        torch.from_numpy(pe), torch.zeros(2, 9, 256))
    with pytest.raises(ValueError, match='batch-1'):
        fast.two_way_transformer_fused2(dec.transformer, torch.zeros(2, 8, 8, 256),
                                        torch.from_numpy(pe), torch.zeros(2, 7, 256))


@pytest.mark.parametrize('multimask', [True, False], ids=['multimask', 'single'])
@pytest.mark.parametrize('blocked', [False, True], ids=['interleaved', 'blocked'])
@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'gemm'])
def test_mask_decoder_fast_matches_stock_and_jax(decoder_case, monkeypatch, fused, blocked,
                                                 multimask):
    monkeypatch.setenv('REGDA_FUSED_TWOWAY', '1')
    params, dec, _, inputs = decoder_case
    targs = tuple(torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        masks, iou = fast.mask_decoder_fast(dec, *targs, multimask_output=multimask,
                                            fused_upscale=fused, blocked_masks=blocked)
        masks0, iou0 = dec(*targs, multimask_output=multimask)
    m = 3 if multimask else 1
    assert tuple(masks.shape) == ((5, m * 16, 64) if blocked else (5, m, 32, 32))
    assert masks.dtype == iou.dtype == torch.float32 and tuple(iou.shape) == (5, m)
    full = up.masks_from_blocked(masks, 8, 8) if blocked else masks
    np.testing.assert_allclose(_np(full), _np(masks0), **TOL)
    np.testing.assert_allclose(_np(iou), _np(iou0), **TOL)
    masks_j, iou_j = jfast.mask_decoder_fast(
        params, *map(jnp.asarray, inputs), multimask_output=multimask, dtype=jnp.float32,
        fused_upscale=fused, blocked_masks=blocked)
    np.testing.assert_allclose(_np(masks), np.asarray(masks_j), **TOL)
    np.testing.assert_allclose(_np(iou), np.asarray(iou_j), **TOL)


@pytest.mark.parametrize('blocked', [False, True], ids=['interleaved', 'blocked'])
def test_mask_decoder_fast_gate_matches_jax(decoder_case, monkeypatch, blocked):
    """A threshold between the prompts' best IoUs: gated prompts return zero
    masks, the others the ungated masks, and the IoU is untouched."""
    monkeypatch.setenv('REGDA_FUSED_TWOWAY', '1')
    params, dec, _, inputs = decoder_case
    targs = tuple(torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        masks, iou = fast.mask_decoder_fast(dec, *targs, blocked_masks=blocked)
        best = iou.max(dim=1).values.sort().values
        thresh = float((best[1] + best[2]) / 2)
        gated, gated_iou = fast.mask_decoder_fast(dec, *targs, blocked_masks=blocked,
                                                  iou_gate_thresh=thresh)
    active = (iou > thresh).any(dim=1)
    assert int(active.sum()) == 3
    assert torch.equal(gated_iou, iou) and torch.equal(gated[active], masks[active])
    assert bool((gated[~active] == 0).all())
    masks_j, iou_j = jfast.mask_decoder_fast(
        params, *map(jnp.asarray, inputs), dtype=jnp.float32, blocked_masks=blocked,
        iou_gate_thresh=thresh)
    np.testing.assert_allclose(_np(gated), np.asarray(masks_j), **TOL)
    np.testing.assert_allclose(_np(gated_iou), np.asarray(iou_j), **TOL)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'gemm'])
def test_mask_decoder_fast_bfloat16_matches_jax(decoder_case, monkeypatch, fused):
    """bfloat16 compute with bfloat16 masks against the JAX function in
    bfloat16 and in float32. On these inputs every bfloat16 path, the JAX
    package's two included, sits 6 to 7 steps from the float32 result (masks;
    4 to 7 on the IoU), and the JAX package's fused and GEMM paths sit 4.0
    steps from each other: the chain rounds some forty times, the port's
    Linear rounds once after the bias where Flax rounds twice, its gelu
    rounds once where XLA rounds each step, and the Pallas kernels take their
    LayerNorm moments from rounded values. So the port is held to the JAX
    package in bfloat16 within 10 steps (measured 8.0 fused and 8.9 GEMM on
    the masks, 6.4 and 7.4 on the IoU) and to float32 within 8 steps
    (measured 6.3 and 6.1; 4.0 and 7.1), no further than the JAX package's
    own bfloat16 (7.3 and 6.9; 4.0 and 3.9)."""
    monkeypatch.setenv('REGDA_FUSED_TWOWAY', '1')
    params, _, dec, inputs = decoder_case
    with torch.no_grad():
        masks, iou = fast.mask_decoder_fast(dec, *(torch.from_numpy(a) for a in inputs),
                                            fused_upscale=fused, mask_dtype=torch.bfloat16)
    jargs = tuple(map(jnp.asarray, inputs))
    masks_j, iou_j = jfast.mask_decoder_fast(params, *jargs, dtype=jnp.bfloat16,
                                             fused_upscale=fused, mask_dtype=jnp.bfloat16)
    masks_f, iou_f = jfast.mask_decoder_fast(params, *jargs, dtype=jnp.float32,
                                             fused_upscale=False)
    assert masks.dtype == torch.bfloat16 and masks_j.dtype == jnp.bfloat16
    assert iou.dtype == torch.float32 and iou_j.dtype == jnp.float32
    assert _bf16_steps(_np(masks), masks_j.astype(jnp.float32)) <= 10
    assert _bf16_steps(_np(iou), iou_j) <= 10
    assert _bf16_steps(_np(masks), masks_f) <= 8
    assert _bf16_steps(_np(iou), iou_f) <= 8


# ------------------------------------------------------------- the Sam bundle

@pytest.mark.parametrize('blocked', [False, True], ids=['interleaved', 'blocked'])
def test_decode_points_fast_matches_jax(monkeypatch, blocked):
    monkeypatch.setenv('REGDA_FUSED_TWOWAY', '1')
    img = 128
    rng = np.random.default_rng(3)
    image = rng.normal(size=(1, img, img, 3)).astype(np.float32)
    points = np.array([[[17.0, 90.0]], [[64.0, 3.0]], [[100.5, 55.25]]], np.float32)
    labels = np.ones((3, 1), np.float32)
    emb = rng.normal(size=(1, img // 16, img // 16, 256)).astype(np.float32)
    jax_model = JaxSam(vit_config='vit_t', img_size=img, dtype=jnp.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(points),
                               jnp.asarray(labels))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), variables)
    model = Sam(vit_config='vit_t', img_size=img, dtype=torch.float32).eval()
    load_jax_variables(model, variables)
    masks_j, iou_j = jax_model.apply(
        variables, jnp.asarray(emb), jnp.asarray(points), jnp.asarray(labels),
        blocked_masks=blocked, method=jax_model.decode_points_fast)
    with torch.no_grad():
        args = tuple(torch.from_numpy(a) for a in (emb, points, labels))
        masks, iou = model.decode_points_fast(*args, blocked_masks=blocked)
        masks0, iou0 = model.decode_points(*args)
    assert tuple(masks.shape) == ((3, 48, 64) if blocked else (3, 3, 32, 32))
    np.testing.assert_allclose(_np(masks), np.asarray(masks_j), **TOL)
    np.testing.assert_allclose(_np(iou), np.asarray(iou_j), **TOL)
    full = up.masks_from_blocked(masks, 8, 8) if blocked else masks
    np.testing.assert_allclose(_np(full), _np(masks0), **TOL)
    np.testing.assert_allclose(_np(iou), _np(iou0), **TOL)
