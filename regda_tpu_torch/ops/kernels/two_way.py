"""SAM's two-way transformer from layer 0's image-to-token update to the
final attention, per prompt against one shared image embedding: the CUDA
kernels' wrapper and the plain version.

Replaces the Pallas TPU kernel `two_way_fused`
(regda_tpu/models/sam/pallas_twoway.py:474, pallas_call at :460) with
`csrc/two_way.cu`; the source note there says what bounds it on the card and
how one call's five launches divide the chain.

`two_way_fused` takes the kernels for CUDA tensors and `two_way_plain` (the
counterpart of `pallas_twoway._twoway_stock`) for CPU tensors; any other
device raises. There is no fallback: a CUDA input that the kernels cannot
take raises. `launches` counts calls that went to the kernels and
`cuda_launches` the kernels those calls queued on the stream, as the C entry
counted them; plain-version calls count in neither. The gradient
differentiates the plain version, as the JAX `custom_vjp` does: the JAX
package has no backward kernel either.

The operand tuple is the JAX package's: (ktok0 (B, NP, D), vtok0 (B, NP, D),
q1 (B, NP, C), qpe (B, NP, C), keys0 (T, C), pe (T, C), qimg0 (T, D),
maskb (1, NP), weights), with NP = 8 token rows (7 used in everything-mode,
the pad rows masked by `maskb` = -1e9), C = 256, D = 128, and `weights` a
dict under `WKEYS` holding (in, out) matrices and 1-D biases and norm
parameters. The compute dtype is keys0's. Returns (keys2 (B, T, C),
queries_out (B, NP, C)), both in the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.ops.kernels._autograd import grad_through_plain
from regda_tpu_torch.utils.profiling import span

NP = 8          # padded token count (everything-mode uses 7)
EPS = 1e-5      # nn.LayerNorm's default, as in the SAM decoder

# order of the weights in the operand tuple's dict and at the kernel
WKEYS = ('wo0', 'bo0', 'n40w', 'n40b',
         'wqt', 'bqt', 'wkt', 'bkt', 'wvt', 'bvt', 'wot', 'bot',
         'n2w', 'n2b',
         'w1', 'b1', 'w2', 'b2', 'n3w', 'n3b',
         'wqi', 'bqi', 'wki', 'bki', 'wvi', 'bvi', 'woi', 'boi',
         'n41w', 'n41b',
         'wqf', 'bqf', 'wkf', 'bkf', 'wvf', 'bvf', 'wof', 'bof',
         'nfw', 'nfb')

# the matrices that the bfloat16 token kernels take transposed, (out, in), as
# the B operands of their tensor-core products
TRANSPOSED = ('wo0', 'wqt', 'wvt', 'wot', 'w1', 'w2', 'wki', 'wvi', 'woi', 'wqf', 'wvf', 'wof')

PASS_TILE = 64   # rows per tile of the passes (csrc/two_way.cu)
MAX_SPLITS = 255  # partials of one prompt that the token kernels can merge

# calls of `two_way_fused` that went to the kernels in this process, and the
# kernels that those calls queued (one call is a chain of five: prompt prep,
# pass A, token work, pass B, closing token work)
launches = 0
cuda_launches = 0

_lib = None
_INVALID_VALUE = 1   # cudaErrorInvalidValue


def _ln(x, w, b):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + EPS) * w.float() + b.float()


def two_way_plain(operands, num_heads: int = 8):
    """Plain multi-head forms of the chain, batched over prompts, with the
    stock twin's rounding points: every product of the compute dtype is a
    float32 sum rounded to it, softmaxes and LayerNorms are float32, and the
    query state stays float32 between its LayerNorms. Token-to-image
    attention attends with keys + pe but takes its values from keys."""
    ktok0, vtok0, q1, qpe, keys0, pe, qimg0, maskb, w = operands
    dt = keys0.dtype
    h = num_heads

    def mm(a, b):
        return (a.to(dt).float() @ b.to(dt).float()).to(dt)

    def heads(x):
        *lead, n, d = x.shape
        return x.reshape(*lead, n, h, d // h).transpose(-3, -2)

    def merge(x):
        x = x.transpose(-3, -2)
        return x.reshape(*x.shape[:-2], -1)

    def attn_t2i(qtok, keys_k, keys_v, name):
        kp = mm(keys_k, w['wk' + name]) + w['bk' + name].to(dt)
        vp = mm(keys_v, w['wv' + name]) + w['bv' + name].to(dt)
        qh, kh, vh = heads(qtok.to(dt)), heads(kp), heads(vp)
        logits = mm(qh, kh.transpose(-1, -2)).float() / (qh.shape[-1] ** 0.5)
        a = torch.softmax(logits, dim=-1).to(dt)
        return mm(merge(mm(a, vh)), w['wo' + name]) + w['bo' + name].to(dt)

    def attn_i2t_delta(qimg, ktok, vtok):
        qh, kh, vh = heads(qimg), heads(ktok.to(dt)), heads(vtok.to(dt))
        logits = mm(qh, kh.transpose(-1, -2)).float() / (qh.shape[-1] ** 0.5)
        a = torch.softmax(logits + maskb[0].float(), dim=-1).to(dt)
        return merge(mm(a, vh))

    delta0 = attn_i2t_delta(qimg0.to(dt), ktok0, vtok0)            # (B, T, D)
    x1 = mm(delta0, w['wo0']).float() + w['bo0'].float() + keys0.float()
    keys1 = _ln(x1, w['n40w'], w['n40b']).to(dt)
    k1pe = keys1 + pe.to(dt)
    q1f, qpef = q1.float(), qpe.float()
    qtok = mm(q1f + qpef, w['wqt']).float() + w['bqt'].float()
    out_t = attn_t2i(qtok, k1pe, keys1, 't')
    q2 = _ln(q1f + out_t.float(), w['n2w'], w['n2b'])
    hidden = torch.relu(mm(q2, w['w1']).float() + w['b1'].float())
    q3 = _ln(q2 + mm(hidden, w['w2']).float() + w['b2'].float(), w['n3w'], w['n3b'])
    qp3 = (q3 + qpef).to(dt)
    ktok1 = mm(qp3, w['wki']).float() + w['bki'].float()
    vtok1 = mm(q3, w['wvi']).float() + w['bvi'].float()
    qimg1 = mm(k1pe, w['wqi']) + w['bqi'].to(dt)
    delta1 = attn_i2t_delta(qimg1, ktok1, vtok1)
    x2 = mm(delta1, w['woi']).float() + w['boi'].float() + keys1.float()
    keys2 = _ln(x2, w['n41w'], w['n41b']).to(dt)
    qtokf = mm(qp3, w['wqf']).float() + w['bqf'].float()
    outf = attn_t2i(qtokf, keys2 + pe.to(dt), keys2, 'f')
    qfin = _ln(q3 + outf.float(), w['nfw'], w['nfb'])
    return keys2, qfin.to(dt)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('two_way')
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.two_way_launch.argtypes = [ptr] * 13 + [i32] * 6 + [ptr, ctypes.POINTER(i32)]
        lib.two_way_launch.restype = ctypes.c_int
        lib.two_way_error_string.argtypes = [ctypes.c_int]
        lib.two_way_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _weight_shapes(c: int, d: int, mlp: int) -> dict:
    shapes = {'wo0': (d, c), 'bo0': (c,), 'w1': (c, mlp), 'b1': (mlp,),
              'w2': (mlp, c), 'b2': (c,)}
    for a in 'tif':   # layer 1's token-to-image and image-to-token, the final one
        for p in 'qkv':
            shapes['w' + p + a], shapes['b' + p + a] = (c, d), (d,)
        shapes['wo' + a], shapes['bo' + a] = (d, c), (c,)
    for norm in ('n40', 'n2', 'n3', 'n41', 'nf'):
        shapes[norm + 'w'] = shapes[norm + 'b'] = (c,)
    return shapes


def _check(operands, num_heads: int):
    ktok0, vtok0, q1, qpe, keys0, pe, qimg0, maskb, w = operands
    if keys0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'two_way: keys0 must be float32 or bfloat16, got {keys0.dtype}')
    if keys0.ndim != 2 or ktok0.ndim != 3:
        raise ValueError(f'two_way: keys0 must be (T, C) and ktok0 (B, NP, D), got '
                         f'{tuple(keys0.shape)} and {tuple(ktok0.shape)}')
    (t, c), (b, n, d) = keys0.shape, ktok0.shape
    if n != NP:
        raise ValueError(f'two_way: token operands carry NP = {NP} rows, got {n}')
    if d % num_heads:
        raise ValueError(f'two_way: D = {d} is no multiple of {num_heads} heads')
    want = {'ktok0': (b, NP, d), 'vtok0': (b, NP, d), 'q1': (b, NP, c), 'qpe': (b, NP, c),
            'keys0': (t, c), 'pe': (t, c), 'qimg0': (t, d), 'maskb': (1, NP)}
    for (name, shape), got in zip(want.items(), operands):
        if tuple(got.shape) != shape:
            raise ValueError(f'two_way: {name} must be {shape}, got {tuple(got.shape)}')
        if got.device != keys0.device:
            raise ValueError(f'two_way: keys0 on {keys0.device}, {name} on {got.device}')
    for key, shape in _weight_shapes(c, d, w['w1'].shape[1]).items():
        if tuple(w[key].shape) != shape:
            raise ValueError(f'two_way: weights[{key!r}] must be {shape}, '
                             f'got {tuple(w[key].shape)}')
        if w[key].device != keys0.device:
            raise ValueError(f'two_way: keys0 on {keys0.device}, weights[{key!r}] on '
                             f'{w[key].device}')


def column_splits(batch: int, t: int, sms: int) -> tuple[int, int]:
    """(rows per block, blocks per prompt) of the two passes: whole tiles of
    PASS_TILE rows. A pass runs one block an SM, so a block takes about its
    tiles plus one (staging its operands costs about a tile) and the call
    that times the waves of blocks: the split count (at most MAX_SPLITS)
    that makes this least, the fewest blocks among equals; no block without
    a row."""
    tiles = -(-t // PASS_TILE)
    splits = min(range(1, min(tiles, MAX_SPLITS) + 1),
                 key=lambda s: (-(-batch * s // sms) * (-(-tiles // s) + 1), s))
    rows = -(-tiles // splits) * PASS_TILE
    return rows, -(-t // rows)


def _launch(operands, num_heads: int):
    global launches, cuda_launches
    lib = _library()
    ktok0, vtok0, q1, qpe, keys0, pe, qimg0, maskb, w = operands
    dt, dev = keys0.dtype, keys0.device
    (t, c), (b, _, d) = keys0.shape, ktok0.shape
    mlp = w['w1'].shape[1]
    if (c, d, num_heads) != (256, 128, 8) or mlp not in (256, 512, 1024, 2048) or b > 65535:
        raise ValueError(
            f'two_way: the kernels are built for C = 256, D = 128, 8 heads, an MLP '
            f'width of 256, 512, 1024 or 2048 and at most 65535 prompts; '
            f'got C = {c}, D = {d}, {num_heads} heads, MLP {mlp}, B = {b}')
    if t == 0:
        raise ValueError('two_way: the kernels need at least one image token, got T = 0')
    if b == 0:   # nothing to launch, and nothing counted
        return (torch.empty((0, t, c), dtype=dt, device=dev),
                torch.empty((0, NP, c), dtype=dt, device=dev))
    # small operands: cast and lay out as the kernels read them (matrices in
    # the compute dtype, in bfloat16 the token products' transposed; biases
    # and norm parameters in float32)
    acts = [x.to(dt).contiguous() for x in (ktok0, vtok0, q1, qpe, keys0, pe, qimg0)]
    maskb = maskb.float().contiguous()
    weights = []
    for k in WKEYS:
        if w[k].ndim == 2:
            m = w[k].t() if dt == torch.bfloat16 and k in TRANSPOSED else w[k]
            if m.dtype != dt or not m.is_contiguous() or m.data_ptr() % 16:
                m = torch.empty(m.shape, dtype=dt, device=dev).copy_(m)   # casts, lays out
            weights.append(m)
        else:
            weights.append(w[k].float().contiguous())
    for x in acts + weights:
        if x.data_ptr() % 16:
            raise ValueError('two_way: tensors must start on a 16-byte boundary')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, splits = column_splits(b, t, sms)
    keys2 = torch.empty((b, t, c), dtype=dt, device=dev)
    qout = torch.empty((b, NP, c), dtype=dt, device=dev)
    hn = num_heads * NP
    # per prompt: five (64, 256)-sized operands of the two passes
    scratch = torch.empty((b, 5, hn * c), dtype=dt, device=dev)
    # per prompt: the passes' partial maxima, sums and products, the
    # float32 query state and one bias row
    partials = torch.empty((b, splits * (hn * c + 2 * hn) + NP * c + hn),
                           dtype=torch.float32, device=dev)
    table = (ctypes.c_void_p * len(weights))(*(x.data_ptr() for x in weights))
    queued = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.two_way_launch(
            *(x.data_ptr() for x in acts), maskb.data_ptr(),
            ctypes.cast(table, ctypes.c_void_p), keys2.data_ptr(),
            qout.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
            b, t, mlp, rows, splits, int(dt == torch.bfloat16), stream,
            ctypes.byref(queued))
    if err == _INVALID_VALUE and queued.value == 0:   # refused before any launch
        raise ValueError(f'two_way: the kernels refused B = {b}, T = {t}, MLP {mlp}')
    if err:   # keys2 and the scratch buffers may be half written
        raise RuntimeError(f'two_way kernel launch failed after {queued.value} of the '
                           f'chain\'s kernels were queued: '
                           + lib.two_way_error_string(err).decode())
    launches += 1
    cuda_launches += queued.value
    return keys2, qout


def _forward(operands, num_heads: int):
    _check(operands, num_heads)
    device = operands[4].device
    if device.type == 'cuda':
        return _launch(operands, num_heads)
    if device.type == 'cpu':
        return two_way_plain(operands, num_heads)
    raise ValueError(f'two_way: no kernel for device {device}')


def _pack(tensors):
    return (*tensors[:8], dict(zip(WKEYS, tensors[8:])))


class _TwoWay(torch.autograd.Function):
    """Forward through the kernels; backward through the plain version."""

    @staticmethod
    def forward(ctx, num_heads, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.num_heads = num_heads
        return _forward(_pack(tensors), num_heads)

    @staticmethod
    def backward(ctx, *grads):
        num_heads = ctx.num_heads
        return (None, *grad_through_plain(
            lambda *t: two_way_plain(_pack(t), num_heads),
            ctx.saved_tensors, ctx.needs_input_grad[1:], grads))


def two_way_fused(operands, num_heads: int = 8):
    """The prompt-resident core of the two-way transformer: operands as in
    the module docstring -> (keys2 (B, T, C), queries_out (B, NP, C))."""
    *acts, w = operands
    if set(w) != set(WKEYS):
        raise ValueError(f'two_way: weights must hold exactly {WKEYS}')
    with span('kernel.two_way'):
        return _TwoWay.apply(num_heads, *acts, *(w[k] for k in WKEYS))
