"""The port's periphery modules against the JAX package on the CPU:
ops/{whiten,mix,losses_extra,align_losses}.py, utils/ema.py and
models/{transnorm,discriminators,deeplab_mmd,spixelnet}.py, the models on
the JAX models' weights carried across by utils/convert.py. Inputs are
seeded numpy, float32 on both sides.

Tolerances: integer and selection outputs exactly (mixes, votes); the
losses rtol 1e-5, atol 1e-6 (one reduction order against another), their
gradients rtol 1e-4, atol 1e-6 (TransNorm's through its batch statistics
atol 1e-4); the convolutional models' outputs rtol 1e-4, atol 1e-5, in
train mode atol 1e-4 (tests/test_torch_step.py), and their BN statistics
rtol 1e-4, atol 1e-6 (XLA's and oneDNN's convolutions sum in different
orders, as tests/test_torch_model.py says). The random draws (mix, pixel contrast) cannot be JAX's: each body is
held on JAX's own draws, converted to tensors, and each draw by what it
must satisfy. The top-k and argsort inputs hold no ties (continuous draws),
so both packages pick the same indices.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regda_tpu.models.deeplab_mmd import DeeplabV2MMD as JaxMMD
from regda_tpu.models.discriminators import FCDiscriminator as JaxFC
from regda_tpu.models.discriminators import FCDiscriminatorLocal as JaxFCLocal
from regda_tpu.models.discriminators import PixelDiscriminator as JaxPixel
from regda_tpu.models.spixelnet import SpixelNet as JaxSpixel
from regda_tpu.models.transnorm import TransNorm as JaxTransNorm
from regda_tpu.ops import align_losses as JA
from regda_tpu.ops import losses_extra as JE
from regda_tpu.ops import mix as JM
from regda_tpu.ops import whiten as JW
from regda_tpu.utils import ema as JEMA
from regda_tpu_torch.models.deeplab_mmd import DeeplabV2MMD
from regda_tpu_torch.models.discriminators import (FCDiscriminator, FCDiscriminatorLocal,
                                                   PixelDiscriminator)
from regda_tpu_torch.models.spixelnet import SpixelNet
from regda_tpu_torch.models.transnorm import TransNorm, TransNorm1d, TransNorm2d
from regda_tpu_torch.ops import align_losses as A
from regda_tpu_torch.ops import losses_extra as E
from regda_tpu_torch.ops import mix as M
from regda_tpu_torch.ops import whiten as W
from regda_tpu_torch.utils import ema as EMA
from regda_tpu_torch.utils.convert import (from_flax_variables, from_jax_variables,
                                           spixelnet_from_jax)

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
CONV = dict(rtol=1e-4, atol=1e-5)
TRAIN = dict(rtol=1e-4, atol=1e-4)    # train-mode forwards (tests/test_torch_step.py)


@pytest.fixture(scope='module', autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.array(a))


def jit(fn, *arrays):
    """fn(*arrays) on the JAX side, compiled whole: run op by op, JAX
    compiles every primitive on its own, which costs this file most of its
    time."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# -------------------------------------------------------------------- whiten
def test_whitening_reference_golden_value():
    a = np.array([[2, 1, 3, 0], [5, 6, 7, 8], [1, 2, 3, 4], [2, 3, 4, 5], [0, 1, 0, 1],
                  [5, 1, 3, 1]], np.float32)
    labels = np.array([1, 0, 0, 1, 0, 0]).reshape(1, 1, 6)
    loss = W.class_ware_whitening(t(a.reshape(1, 1, 6, 4)), t(labels), [1, 2])
    assert float(loss) == 12.4375


def test_whitening_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 4, 4))
    for groups in (1, 2, 4):
        close(W.class_ware_whitening(t(feats), t(labels), [0, 1, 2, 3], groups),
              JW.class_ware_whitening(jnp.asarray(feats), jnp.asarray(labels),
                                      [0, 1, 2, 3], groups), **LOSS)
    mask = (labels.reshape(-1) == 1).astype(np.float32)
    close(W.masked_covariance(t(feats.reshape(-1, 8)), t(mask)),
          JW.masked_covariance(jnp.asarray(feats.reshape(-1, 8)), jnp.asarray(mask)), **LOSS)


# ----------------------------------------------------------------------- mix
def _mix_batch(seed, b=4, h=16, w=16, classes=6):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3), np.float32), rng.integers(-1, classes, (b, h, w)),
            rng.random((b, h, w, 3), np.float32), rng.integers(-1, classes, (b, h, w)))


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_mix_bodies_on_jax_draws_equal_jax(seed):
    batch = _mix_batch(seed)
    jb = [jnp.asarray(a) for a in batch]
    tb = [t(a) for a in batch]
    key = jax.random.PRNGKey(seed)
    h, w = batch[0].shape[1:3]
    # classmix: the first int(C * ratio) of a permutation
    perm = np.asarray(jax.random.permutation(key, 6))
    chosen = torch.zeros(6, dtype=torch.bool)
    chosen[t(perm[:3])] = True
    _same(M.classmix_apply(chosen, *tb), JM.classmix(key, *jb, ratio=0.5, class_num=6))
    # cutmix: lam ~ Beta, a uniform centre
    k_lam, k_cx, k_cy = jax.random.split(key, 3)
    draws = (float(jax.random.beta(k_lam, 1.0, 1.0)),
             float(jax.random.uniform(k_cx, (), minval=0.0, maxval=float(w))),
             float(jax.random.uniform(k_cy, (), minval=0.0, maxval=float(h))))
    _same(M.cutmix_apply(M.box_mask(h, w, *draws), *tb), JM.cutmix(key, *jb))
    # cutmix2: a batch permutation and a box
    k_perm, k_box = jax.random.split(key)
    idx = t(np.asarray(jax.random.permutation(k_perm, 4)))
    k_lam, k_cx, k_cy = jax.random.split(k_box, 3)
    box = M.box_mask(h, w, float(jax.random.beta(k_lam, 1.0, 1.0)),
                     float(jax.random.uniform(k_cx, (), minval=0.0, maxval=float(w))),
                     float(jax.random.uniform(k_cy, (), minval=0.0, maxval=float(h))))
    _same(M.cutmix2_apply(idx, box, tb[0], tb[1]), JM.cutmix2(key, jb[0], jb[1]))
    # mixup: a batch permutation and lam ~ Beta(0.2, 0.2)
    k_perm, k_lam = jax.random.split(key)
    idx = t(np.asarray(jax.random.permutation(k_perm, 4)))
    lam = float(jax.random.beta(k_lam, 0.2, 0.2))
    _same(M.mixup_apply(idx, lam, *tb), JM.mixup(key, *jb))


def test_mix_draws_satisfy_their_laws():
    g = torch.Generator().manual_seed(0)
    for class_num, ratio in ((7, 0.5), (6, 0.5), (10, 0.3)):
        assert int(M.classmix_draw(g, class_num, ratio).sum()) == int(class_num * ratio)
    assert sorted(torch.randperm(9, generator=g).tolist()) == list(range(9))
    draws = np.array([M.beta_draw(g, 0.2, 0.2) for _ in range(4000)])
    assert draws.min() >= 0.0 and draws.max() <= 1.0
    assert abs(draws.mean() - 0.5) < 0.03          # Beta(a, a) has mean 1/2
    assert abs(draws.var() - 0.25 / 1.4) < 0.02    # and variance 1 / (4 (2a + 1))
    uni = np.array([M.beta_draw(g, 1.0, 1.0) for _ in range(4000)])
    assert abs(uni.mean() - 0.5) < 0.02 and abs(uni.var() - 1 / 12) < 0.01
    for lam in (0.0, 0.36, 0.75):                  # a centred box: (1 - lam) of the image
        assert int(M.box_mask(100, 100, lam, 50.0, 50.0).sum()) == round((1 - lam) * 1e4)
    lam, cx, cy = M.box_draw(g, 32, 48)
    assert 0 <= lam <= 1 and 0 <= cx < 48 and 0 <= cy < 32
    img_s, lab_s, img_t, lab_t = (t(a) for a in _mix_batch(3))
    _, _, img_m, lab_m = M.cutmix(g, img_s, lab_s, img_t, lab_t)
    from_src = (img_m == img_s).all(-1)
    assert bool(((img_m == img_s).all(-1) | (img_m == img_t).all(-1)).all())
    assert bool((lab_m[from_src] == lab_s[from_src]).all())


# --------------------------------------------------------------- losses_extra
def test_gdp_loss_matches_jax_over_two_steps():
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(2, 8, 8, 5)) * 3).astype(np.float32)
    labels = rng.integers(-1, 5, (2, 8, 8))
    extra = rng.random((2, 8, 8)).astype(np.float32)
    js, ts = JE.GDPState.create(), E.GDPState.create()
    for kw in ({}, dict(extra=extra, n_extra=1)):
        jkw = dict(extra_pixel_weight=jnp.asarray(kw['extra']), n_extra=1) if kw else {}
        tkw = dict(extra_pixel_weight=t(kw['extra']), n_extra=1) if kw else {}
        jl, js = JE.gdp_loss(js, jnp.asarray(logits), jnp.asarray(labels), **jkw)
        tl, ts = E.gdp_loss(ts, t(logits), t(labels), **tkw)
        close(tl, jl, **LOSS)
        close(ts.acc_sum, js.acc_sum, **LOSS)
    lg = t(logits).requires_grad_()
    E.gdp_loss(E.GDPState.create(), lg, t(labels))[0].backward()
    jg = jax.grad(lambda x: JE.gdp_loss(JE.GDPState.create(), x, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    close(lg.grad, jg, **GRAD)


def test_domain_balance_matches_jax():
    batches = [np.array([[[0, 1], [-1, 2]]]), np.array([[[-1, -1], [3, 4]]])]
    assert E.examples_cnt(batches) == JE.examples_cnt(batches) == (5.0, 5 / 8)
    assert E.examples_cnt([t(b) for b in batches]) == (5.0, 5 / 8)
    probs = [np.random.default_rng(0).random((1, 3, 2, 2)).astype(np.float32)]
    assert E.examples_cnt(probs, save_prob=True) == JE.examples_cnt(probs, save_prob=True)
    for args in ((100, 0.5, 50, 0.5), (50, 0.5, 200, 0.5), (10, 0.3, 7, 0.9)):
        assert E.target_domain_weight(*args) == JE.target_domain_weight(*args)


# -------------------------------------------------------------- align_losses
def _grad_pair(tfn, jfn, x):
    xt = t(x).requires_grad_()
    tfn(xt).backward()
    close(xt.grad, jit(jax.grad(jfn), x), **GRAD)


def test_margin_alignment_losses_match_jax():
    rng = np.random.default_rng(0)
    p1 = rng.normal(size=(6, 32)).astype(np.float32)
    p2 = rng.normal(size=(6, 32)).astype(np.float32)
    for margin in (0.3, 2.0):
        close(A.class_align_loss(t(p1), t(p2), margin),
              jit(lambda a, b: JA.class_align_loss(a, b, margin), p1, p2), **LOSS)
    _grad_pair(lambda x: A.class_align_loss(x, t(p2), 2.0),
               lambda x: JA.class_align_loss(x, jnp.asarray(p2), 2.0), p1)
    feat = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    proto = rng.normal(size=(6, 16)).astype(np.float32)
    lab = rng.integers(-1, 6, (2, 4, 4))
    close(A.instance_align_loss(t(feat), t(lab), t(proto)),
          jit(JA.instance_align_loss, feat, lab, proto), **LOSS)
    assert abs(float(A.instance_align_loss(t(feat), torch.full((2, 4, 4), -1), t(proto)))) < 1e-5
    _grad_pair(lambda x: A.instance_align_loss(x, t(lab), t(proto)),
               lambda x: JA.instance_align_loss(x, jnp.asarray(lab), jnp.asarray(proto)), feat)


def test_saw_and_triplet_losses_match_jax():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    w_cls = rng.normal(size=(6, 16)).astype(np.float32)
    for sel in ([1, 2], [0, 1, 2, 3]):
        close(A.saw_loss(t(feats), t(w_cls), sel),
              jit(lambda f, w: JA.saw_loss(f, w, sel), feats, w_cls), **LOSS)
    _grad_pair(lambda x: A.saw_loss(x, t(w_cls), [1, 2]),
               lambda x: JA.saw_loss(x, jnp.asarray(w_cls), [1, 2]), feats)
    with pytest.raises(ValueError):
        A.saw_loss(t(feats), t(w_cls), [1, 2, 3])
    emb = rng.normal(size=(8, 8)).astype(np.float32)
    tgt = np.array([0] * 4 + [1] * 4)
    close(A.triplet_loss(t(emb), t(tgt)), jit(JA.triplet_loss, emb, tgt), **LOSS)
    sep = np.concatenate([np.zeros((4, 8)), 100.0 + np.zeros((4, 8))]).astype(np.float32)
    assert float(A.triplet_loss(t(sep), t(tgt))) == 0.0


def test_pixel_contrast_loss_body_on_jax_priority_matches_jax():
    b, h, w, k, c = 2, 8, 8, 16, 4
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(b, h, w, k)).astype(np.float32)
    # 16 pixels of each class an image, more than max_views = 8: every slot
    # is valid, so no anchor is drawn from a -inf priority tie
    labels = np.stack([rng.permutation(np.repeat(np.arange(c), h * w // c)).reshape(h, w)
                       for _ in range(b)])
    predict = rng.integers(0, c, (b, h, w))
    key = jax.random.PRNGKey(0)
    kw = dict(max_views=8, max_samples=64)
    want = jit(lambda f, y, p: JA.pixel_contrast_loss(key, f, y, p, c, **kw),
               feats, labels, predict)
    u = t(np.asarray(jax.random.uniform(key, (b, c, h * w))))
    close(A.pixel_contrast_loss_body(u, t(feats), t(labels), t(predict), c, **kw), want,
          **LOSS)
    _grad_pair(lambda x: A.pixel_contrast_loss_body(u, x, t(labels), t(predict), c, **kw),
               lambda x: JA.pixel_contrast_loss(key, x, jnp.asarray(labels),
                                                jnp.asarray(predict), c, **kw), feats)
    drawn = A.pixel_contrast_loss(torch.Generator().manual_seed(0), t(feats), t(labels),
                                  t(predict), c, **kw)
    assert math.isfinite(float(drawn))
    prio = A.pixel_contrast_priority(torch.Generator().manual_seed(0), b, c, h * w)
    assert prio.shape == (b, c, h * w) and 0 <= float(prio.min()) and float(prio.max()) < 1


def test_msc_and_context_losses_match_jax():
    rng = np.random.default_rng(5)
    fs = rng.normal(size=(32, 16)).astype(np.float32)
    ls = rng.integers(0, 4, (32,))
    ft = rng.normal(size=(24, 16)).astype(np.float32)
    close(A.msc_loss(t(fs), t(ls), t(ft), 4),
          jit(lambda a, b, c: JA.msc_loss(a, b, c, 4), fs, ls, ft), **LOSS)
    p1 = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    p2 = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    ft = rng.normal(size=(4, 8, 8, 16)).astype(np.float32)
    q1 = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    q2 = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    gt = rng.normal(size=(4, 8, 8, 16)).astype(np.float32)
    j = [jnp.asarray(a) for a in (p1, p2, ft, q1, q2, gt)]
    tt = [t(a) for a in (p1, p2, ft, q1, q2, gt)]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(p1), -1))
    for bg in (False, True):
        close(A.category_context(t(probs), tt[2], bg),
              jit(lambda a, b: JA.category_context(a, b, bg), probs, ft), **LOSS)
    # the JAX correlation regulariser indexes by a boolean mask, which does
    # not compile: these two run op by op
    close(A.icr_loss(tt[0], tt[1], tt[2], 6), JA.icr_loss(j[0], j[1], j[2], 6), **LOSS)
    close(A.ccr_loss(tt[:3], tt[3:], 6), JA.ccr_loss(tuple(j[:3]), tuple(j[3:]), 6), **LOSS)
    close(A.mse_context_loss(tt[:3], tt[3:]),
          jit(lambda *x: JA.mse_context_loss(x[:3], x[3:]), p1, p2, ft, q1, q2, gt), **LOSS)
    assert abs(float(A.mse_context_loss(tt[:3], tt[:3]))) < 1e-6
    xt = t(gt).requires_grad_()
    A.ccr_loss(tt[:3], (tt[3], tt[4], xt), 6).backward()
    close(xt.grad, jax.grad(lambda x: JA.ccr_loss(tuple(j[:3]), (j[3], j[4], x), 6))(j[5]),
          **GRAD)


# ----------------------------------------------------------------------- ema
def test_ema_on_a_module_follows_the_jax_formula():
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(1.0)
        net.bias.zero_()
    state = EMA.ema_register(net)
    jstate = JEMA.ema_register({'weight': jnp.ones((2, 3)), 'bias': jnp.zeros(2)})
    with torch.no_grad():
        net.weight.fill_(3.0)
        net.bias.fill_(1.0)
    state = EMA.ema_update(state, net, decay=0.9)
    jstate = JEMA.ema_update(jstate, {'weight': jnp.full((2, 3), 3.0), 'bias': jnp.ones(2)}, 0.9)
    for k in ('weight', 'bias'):
        close(state.shadow[k], jstate.shadow[k], rtol=1e-6)
    np.testing.assert_allclose(state.shadow['weight'].numpy(), 1.2, rtol=1e-6)
    backup = EMA.ema_apply_shadow(state, net)
    np.testing.assert_allclose(net.weight.detach().numpy(), 1.2, rtol=1e-6)
    np.testing.assert_allclose(net.bias.detach().numpy(), 0.1, rtol=1e-6)
    EMA.ema_restore(net, backup)
    assert float(net.weight.detach().min()) == 3.0 and float(net.bias.detach().max()) == 1.0
    shadow = EMA.ema_update(EMA.ema_register({'w': torch.ones(2)}), {'w': torch.zeros(2)}, 0.5)
    assert shadow.shadow['w'].tolist() == [0.5, 0.5]


# ----------------------------------------------------------------- transnorm
@pytest.mark.parametrize('shape', [(4, 6, 6, 8), (6, 5)])
def test_transnorm_train_and_eval_match_jax(shape):
    x = (np.random.default_rng(0).normal(size=shape) * 2 + 1).astype(np.float32)
    c = shape[-1]
    jtn = JaxTransNorm()
    variables = jtn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = jax.tree.map(np.asarray, variables)
    variables['params']['scale'] = np.linspace(0.5, 1.5, c).astype(np.float32)
    variables['params']['bias'] = np.linspace(-0.2, 0.2, c).astype(np.float32)
    jy, jnew = jtn.apply(variables, jnp.asarray(x), train=True, mutable=['batch_stats'])
    tn = TransNorm2d(c) if len(shape) == 4 else TransNorm1d(c)
    tn.load_state_dict(from_flax_variables(variables))
    tn.train()
    xt = t(x).requires_grad_()
    close(tn(xt), jy, **LOSS)
    state = tn.state_dict()
    for k, v in jnew['batch_stats'].items():
        close(state[k], v, **LOSS)
    (tn(xt) ** 2).sum().backward()
    jg = jax.grad(lambda v: (jtn.apply(variables, v, train=True,
                                       mutable=['batch_stats'])[0] ** 2).sum())(jnp.asarray(x))
    close(xt.grad, jg, rtol=1e-4, atol=1e-4)
    new = dict(variables, batch_stats=jax.tree.map(np.asarray, jnew['batch_stats']))
    tn.load_state_dict(from_flax_variables(new))    # the second train call moved them again
    tn.eval()
    close(tn(t(x)), jtn.apply(new, jnp.asarray(x), train=False), **LOSS)
    assert TransNorm is TransNorm2d


# -------------------------------------------------------------- the models
def _init(module, x, **kw):
    init = jax.jit(module.init, static_argnames=tuple(kw))
    return jax.tree.map(np.asarray, init({'params': jax.random.PRNGKey(0)}, jnp.asarray(x), **kw))


@pytest.mark.parametrize('kind', ['fc', 'local', 'pixel'])
def test_discriminators_match_jax(kind):
    rng = np.random.default_rng(1)
    jmod, tmod, shape = {
        'fc': (JaxFC(ndf=8), FCDiscriminator(6, ndf=8), (2, 64, 64, 6)),
        'local': (JaxFCLocal(ndf=8), FCDiscriminatorLocal(38, ndf=8), (1, 64, 64, 38)),
        'pixel': (JaxPixel(ndf=16, num_classes=2), PixelDiscriminator(8, ndf=16, num_classes=2),
                  (2, 16, 16, 8)),
    }[kind]
    x = rng.normal(size=shape).astype(np.float32)
    variables = _init(jmod, x)
    tmod.load_state_dict(from_flax_variables(variables))
    close(tmod(t(x)), jmod.apply(variables, jnp.asarray(x)), **CONV)


def test_deeplab_mmd_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = JaxMMD(resnet_type='resnet18', num_classes=7, inchannels=512)
    variables = _init(jm, x, train=False)
    model = DeeplabV2MMD('resnet18', num_classes=7, inchannels=512)
    model.load_state_dict(from_jax_variables(variables))
    apply = jax.jit(jm.apply, static_argnames=('train', 'mutable'))
    (jlogits, jreduced), jnew = apply(variables, jnp.asarray(x), train=True,
                                      mutable=('batch_stats',))
    logits, reduced = model.train()(t(x))
    close(logits, jlogits, **TRAIN)
    close(reduced, jreduced, **TRAIN)
    state = from_jax_variables({'batch_stats': jax.tree.map(np.asarray, jnew['batch_stats'])})
    got = model.state_dict()
    for k, v in state.items():
        close(got[k], v, rtol=1e-4, atol=1e-6)
    new = dict(variables, batch_stats=jax.tree.map(np.asarray, jnew['batch_stats']))
    close(model.eval()(t(x)), apply(new, jnp.asarray(x), train=False), **CONV)


def test_spixelnet_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jn = JaxSpixel()
    variables = _init(jn, x, train=False)
    net = SpixelNet()
    net.load_state_dict(spixelnet_from_jax(variables))
    apply = jax.jit(jn.apply, static_argnames=('train', 'mutable'))
    want, jnew = apply(variables, jnp.asarray(x), train=True, mutable=('batch_stats',))
    got = net.train()(t(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        close(g, w, **TRAIN)
    new = dict(variables, batch_stats=jax.tree.map(np.asarray, jnew['batch_stats']))
    for g, w in zip(net.eval()(t(x)), apply(new, jnp.asarray(x), train=False)):
        close(g, w, **CONV)
