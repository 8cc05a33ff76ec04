#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`regda_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):
  0. card     nvidia-smi name and power limit.
  1. kernel   build every CUDA kernel of the main paths from `regda_tpu_torch/
              csrc/` (one nvcc per source, all at once) and hold each against
              its plain PyTorch version on the card at the main path's shapes
              and at ragged inputs: the segment histogram exactly; LayerNorm
              and rel-pos attention in f32 (rtol/atol 2e-5 and 2e-4, the JAX
              tests' own) and in bf16 (LN_BF16_TOL, ATTN_BF16_TOL below).
              Each is timed with CUDA events beside its plain version, its
              bound (bytes over 3.35 TB/s or operations over the peak rate,
              whichever is larger) and one library call as a yardstick that
              the port itself never makes.
     check    small-size agreement of the card with the CPU: the ResNet-101
              eval forward (f32, rtol/atol 1e-4) and one resnet18 stage-2
              step with dropout off (losses rtol 1e-4), `homogenize` at
              8x512^2, kernel on the card against plain on the CPU (equal),
              the SAM encoder at ViT-B width and depth on a 256^2 image and a
              whole `Sam.forward` at vit_t (f32, SAM_CHECK_TOL below).
  2. serve    ResNet-101 DeepLabv2 (C = 6) eval forward on 16 tiles of 512^2,
              bf16 compute with f32 weights: shape, finiteness, probabilities
              summing to 1 within 1e-2, tiles/s.
  3. train    `stage2_steps(3)`: ResNet-101, C = 6, 512^2 crops, batch 8 per
              domain, f32, with align_domain, refine_label and sam_refine.
              Every loss finite, step count 3, and the segment-histogram
              kernel launched at least once per step.
  4. sam      `sam_entry()`: SAM ViT-B at full width and depth, bf16 compute
              with f32 weights: `encode` of the 5-crop pyramid of one tile
              (5 x 1024^2) then `decode_points` of 64 grid points on crop 0.
              Shapes, finiteness, exactly 24 LayerNorm and 12 attention
              kernel launches in the encode, ms/encode, crops/s, ms/decode
              chunk, peak memory, and a torch.profiler split of one encode.
Launch counts are zeroed just before phases 2-3 and again just before phase
4, and read just after each.
TF32 is off in every phase (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` both False): phases 2
and 4 compute in bf16, and the others hold float32 as float32, as the JAX
train path does.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the card's name and power limit, and the line before that the
kernels' JSON record. Without a CUDA device the script exits non-zero at
once and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {'bf16': 989e12, 'f32': 67e12}   # dense tensor-core bf16; f32 units

# bf16 results: kernel and plain round the same float32 value, which the two
# compute in different orders, so they may land one bf16 step (2^-8 relative)
# apart. The attention kernel also rounds its probabilities relative to a
# running maximum instead of the final one, a second rounding of that size.
LN_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
ATTN_BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -7)
# f32 card vs CPU through 12 transformer blocks: different summation orders
SAM_CHECK_TOL = dict(rtol=1e-3, atol=1e-3)


def bound_ms(nbytes: float, flops: float, rate: str) -> tuple[float, str]:
    """Least milliseconds the card could take: (time, 'bytes' | 'operations')."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def build_kernels() -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from regda_tpu_torch.ops.kernels import _build
    names = ('segment_hist', 'layernorm', 'rel_attention')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load_library, names))
    print(f'[kernel] {", ".join(names)} built/loaded in {time.perf_counter() - t0:.2f} s')
    for name in names:
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[kernel] ptxas {name}:', line.strip())


def _assert_close(what: str, got, want, rtol: float, atol: float) -> float:
    import torch
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all())
            and torch.allclose(got, want, rtol=rtol, atol=atol)):
        raise AssertionError(f'{what}: max abs err {err} (rtol {rtol}, atol {atol})')
    return err


def _hist_inputs(rng, kind: str, b: int, n: int, num_regions: int, num_classes: int):
    """Labels include -1 and values >= C; regions include ids outside [0, R)."""
    import numpy as np
    if kind == 'sam':  # SAM-like: large regions, one label per region mostly
        side = int(math.isqrt(n))
        from regda_tpu_torch.entry import synthetic_stage2_batch
        regs = synthetic_stage2_batch(rng, b, side, num_classes)[3].reshape(b, n)
        labels = (regs * 7 + 3) % (num_classes + 2) - 1
        noise = rng.random((b, n)) < 0.1
        labels = np.where(noise, rng.integers(-1, num_classes + 2, (b, n)), labels)
        oob = rng.random((b, n)) < 0.01
        regs = np.where(oob, rng.choice([-3, num_regions, 5000], (b, n)), regs)
    elif kind == 'uniform':  # worst contention: one region, one label
        regs = np.full((b, n), 5)
        labels = np.full((b, n), 2)
    else:
        labels = rng.integers(-1, num_classes + 2, (b, n))
        regs = rng.integers(-3, num_regions + 50, (b, n))
    return labels.astype(np.int32), regs.astype(np.int32)


def phase_kernel(device) -> dict:
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import segment_hist as sh

    rng = np.random.default_rng(0)
    cases = [('sam', 8, 512 * 512, 1024, 6), ('random', 8, 512 * 512, 1024, 6),
             ('sam', 8, 512 * 512, 1024, 7), ('random', 3, 1000, 1024, 7),
             ('random', 3, 1001, 1024, 6), ('random', 2, 3, 64, 6),
             ('uniform', 2, 512 * 512, 1024, 6), ('random', 4, 4096, 64, 6)]
    max_err = 0.0
    for kind, b, n, r, c in cases:
        lab_np, reg_np = _hist_inputs(rng, kind, b, n, r, c)
        lab = torch.from_numpy(lab_np).to(device)
        reg = torch.from_numpy(reg_np).to(device)
        got = sh.segment_hist_labels(lab, reg, r, c)
        want = sh.segment_hist_labels_plain(lab, reg, r, c)
        want_cpu = sh.segment_hist_labels_plain(lab.cpu(), reg.cpu(), r, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not (torch.equal(got, want) and torch.equal(got.cpu(), want_cpu)):
            raise AssertionError(f'segment_hist {kind} B={b} N={n} R={r} C={c}: '
                                 f'kernel != plain, max abs err {err}')
        print(f'[kernel] {kind:7s} B={b} N={n} R={r} C={c}: exact '
              f'(total {int(got.sum())} counted pixels)')

    # time at the main path's shape: B = 8 512^2 maps, R = 1024, C = 6
    lab_np, reg_np = _hist_inputs(rng, 'sam', 8, 512 * 512, 1024, 6)
    lab = torch.from_numpy(lab_np).to(device)
    reg = torch.from_numpy(reg_np).to(device)
    ms = cuda_ms(lambda: sh.segment_hist_labels(lab, reg, 1024, 6), 200)
    plain_ms = cuda_ms(lambda: sh.segment_hist_labels_plain(lab, reg, 1024, 6), 200)
    # yardstick: the one library call at the plain version's core, the
    # scatter_add_ into a zeroed histogram, given the bin index ready-made
    # (no PyTorch call takes labels and regions as they are)
    bins = 1024 * 6
    valid = (lab >= 0) & (lab < 6) & (reg >= 0) & (reg < 1024)
    idx = torch.where(valid, reg.long() * 6 + lab.long(), bins)
    src = valid.float()
    library_ms = cuda_ms(lambda: torch.zeros((8, bins + 1), device=device)
                         .scatter_add_(1, idx, src), 200)
    # each id read once (two int32 per pixel), one count per region and
    # class, in float32, written once; one add per pixel
    bound, by = bound_ms(2 * lab.numel() * 4 + 8 * bins * 4, lab.numel(), 'f32')
    print(f'[kernel] segment_hist B=8 N=512^2 R=1024 C=6: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, scatter_add_ alone {library_ms:.4f} ms, bound '
          f'{bound:.4f} ms ({by}) (CUDA events, 200 calls, inputs L2-warm)')
    return {'name': 'segment_hist_labels', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/segment_hist.cu',
            'replaces': 'regda_tpu/ops/pallas/segment_hist.py:82',
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': by, 'library_ms': library_ms}


def phase_layernorm(device) -> dict:
    """The one-pass LayerNorm kernel against its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from regda_tpu_torch.ops.kernels import layernorm as ln

    rng = np.random.default_rng(10)
    # the encoder's activations at 5 crops, the window-padded row count, a
    # row count below one block, and the other ViT widths
    shapes = [(5, 64, 64, 768), (24500, 768), (3, 768), (5, 8, 8, 64),
              (1001, 1024), (1000, 1280)]
    max_err = 0.0
    for shape in shapes:
        c = shape[-1]
        x32 = torch.from_numpy((rng.normal(size=shape) * 2 + 0.5).astype(np.float32)).to(device)
        w = torch.from_numpy(rng.normal(size=c).astype(np.float32)).to(device)
        b = torch.from_numpy(rng.normal(size=c).astype(np.float32)).to(device)
        for dtype, tol in ((torch.float32, dict(rtol=2e-5, atol=2e-5)),
                           (torch.bfloat16, LN_BF16_TOL)):
            x = x32.to(dtype)
            got = ln.layernorm(x, w, b, 1e-6)
            want = ln.layernorm_plain(x, w, b, 1e-6)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != x.shape:
                raise AssertionError(f'layernorm {shape} {dtype}: got {got.dtype} {got.shape}')
            err = _assert_close(f'layernorm {shape} {dtype}', got, want, **tol)
            max_err = max(max_err, err)
            print(f'[kernel] layernorm {shape} {str(dtype)[6:]}: max abs err {err:.3g}')

    # time at the main path's shape: bf16 (5, 64, 64, 768), 24 calls per encode
    shape = (5, 64, 64, 768)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device).bfloat16()
    w = torch.from_numpy(rng.normal(size=768).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=768).astype(np.float32)).to(device)
    # two rounds of (kernel, plain, library), each read the same way (50
    # calls to warm up, 200 timed, the 31 MB input L2-warm): the card's
    # clocks move between readings, so both are printed and their mean kept
    w16, b16 = w.bfloat16(), b.bfloat16()   # F.layer_norm wants one dtype
    calls = {'kernel': lambda: ln.layernorm(x, w, b, 1e-6),
             'plain': lambda: ln.layernorm_plain(x, w, b, 1e-6),
             'library': lambda: F.layer_norm(x, (768,), w16, b16, 1e-6)}
    reads = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            reads[k].append(cuda_ms(fn, 200, warmup=50))
    ms, plain_ms, library_ms = (sum(reads[k]) / 2 for k in calls)
    # x read once, out written once, scale and bias read once; ~8 operations
    # per element on the f32 units
    bound, by = bound_ms(2 * x.numel() * 2 + 2 * 768 * 4, 8 * x.numel(), 'f32')
    then = {k: ' then '.join(f'{t:.4f}' for t in v) for k, v in reads.items()}
    print(f'[kernel] layernorm bf16 {shape}: kernel {then["kernel"]} ms, '
          f'plain {then["plain"]} ms, F.layer_norm {then["library"]} ms, bound {bound:.4f} ms '
          f'({by}) (CUDA events, 200 calls each; the record keeps the means)')
    return {'name': 'layernorm', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/layernorm.cu',
            'replaces': 'regda_tpu/models/sam/pallas_ln.py:101',
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': by, 'library_ms': library_ms}


def _attn_inputs(rng, device, dtype, b, heads, kh, kw, d):
    """qkv as the ViT makes it, the permuted (3, B, H, N, D) view of a
    (B, N, 3 * H * D) projection, and the two bias tables."""
    import numpy as np
    import torch
    n = kh * kw
    proj = torch.from_numpy(rng.normal(size=(b, n, 3 * heads * d)).astype(np.float32))
    qkv = proj.to(device, dtype).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    rh = torch.from_numpy(rng.normal(size=(b, heads, n, kh)).astype(np.float32)).to(device, dtype)
    rw = torch.from_numpy(rng.normal(size=(b, heads, n, kw)).astype(np.float32)).to(device, dtype)
    return qkv, rh, rw


def _attn_times(rng, device, b, heads, kh, kw, d, iters):
    """Kernel, plain and library times and the bound, in bf16."""
    import torch
    import torch.nn.functional as F
    from regda_tpu_torch.ops.kernels import rel_attention as ra
    n, scale = kh * kw, d ** -0.5
    qkv, rh, rw = _attn_inputs(rng, device, torch.bfloat16, b, heads, kh, kw, d)
    ms = cuda_ms(lambda: ra.rel_attention(qkv, rh, rw, scale=scale, kh=kh, kw=kw), iters)
    plain_ms = cuda_ms(lambda: ra.rel_attention_plain(qkv, rh, rw, scale, kh, kw),
                       max(2, iters // 10), warmup=1)
    # yardstick: scaled_dot_product_attention with the bias laid out as a
    # (B, H, N, N) additive mask beforehand (not timed)
    mask = (rh[..., :, None] + rw[..., None, :]).reshape(b, heads, n, n)
    q, k, v = qkv[0], qkv[1], qkv[2]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), iters)
    del mask
    # q, k, v, rh and rw read once, out written once; the two products
    nbytes = b * heads * n * (4 * d + kh + kw) * 2
    bound, by = bound_ms(nbytes, 4.0 * b * heads * n * n * d, 'bf16')
    return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
            'library_ms': library_ms}


def phase_attention(device) -> dict:
    """The rel-pos attention kernels against their plain version."""
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import rel_attention as ra

    rng = np.random.default_rng(11)
    # (B, H, kh, kw, D): a global layer of ViT-B at the main path's 5 crops
    # (the plain version's float32 logits are 4 GB) and at one crop, its
    # windowed layer at 5 crops, then ragged shapes: vit_t's head dim, a
    # single short tile, kh != kw, and vit_h's head dim
    cases = [(5, 12, 64, 64, 64), (1, 12, 64, 64, 64), (125, 12, 14, 14, 64),
             (3, 2, 14, 14, 32),
             (2, 2, 4, 4, 32), (2, 3, 5, 7, 64), (2, 2, 14, 14, 80)]
    max_err = 0.0
    for b, heads, kh, kw, d in cases:
        for dtype, tol in ((torch.float32, dict(rtol=2e-4, atol=2e-4)),
                           (torch.bfloat16, ATTN_BF16_TOL)):
            qkv, rh, rw = _attn_inputs(rng, device, dtype, b, heads, kh, kw, d)
            what = f'rel_attention B={b} H={heads} N={kh}x{kw} D={d} {str(dtype)[6:]}'
            got = ra.rel_attention(qkv, rh, rw, scale=d ** -0.5, kh=kh, kw=kw)
            want = ra.rel_attention_plain(qkv, rh, rw, d ** -0.5, kh, kw)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f'{what}: got {got.dtype} {tuple(got.shape)}')
            err = _assert_close(what, got, want, **tol)
            # the strided view and a contiguous copy of it are the same input
            same = ra.rel_attention(qkv.contiguous(), rh, rw, scale=d ** -0.5, kh=kh, kw=kw)
            if not torch.equal(same, got):
                raise AssertionError(f'{what}: strided and contiguous qkv disagree')
            max_err = max(max_err, err)
            print(f'[kernel] {what}: max abs err {err:.3g}; strided = contiguous')
            del qkv, rh, rw, got, want, same
            torch.cuda.empty_cache()
    bad = torch.zeros((3, 1, 2, 16, 64), device=device)[..., ::2]   # head dim strided
    try:
        ra.rel_attention(bad, torch.zeros((1, 2, 16, 4), device=device),
                         torch.zeros((1, 2, 16, 4), device=device), scale=1.0, kh=4, kw=4)
    except ValueError:
        print('[kernel] rel_attention: a strided head dim raises')
    else:
        raise AssertionError('rel_attention took a qkv whose head dim is strided')

    # time at the main path's shapes, bf16, 5 crops: a global layer (4 per
    # encode) and a windowed layer (8 per encode)
    glob = _attn_times(rng, device, 5, 12, 64, 64, 64, 20)
    torch.cuda.empty_cache()
    win = _attn_times(rng, device, 125, 12, 14, 14, 64, 50)
    torch.cuda.empty_cache()
    for name, t in (('global B=5 N=4096', glob), ('windowed B=125 N=196', win)):
        print(f'[kernel] rel_attention bf16 {name} H=12 D=64: kernel {t["ms"]:.4f} ms, '
              f'plain {t["plain_ms"]:.4f} ms, SDPA with mask {t["library_ms"]:.4f} ms, '
              f'bound {t["bound_ms"]:.4f} ms ({t["bound_by"]}) (CUDA events)')
    return {'name': 'rel_attention', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/rel_attention.cu',
            'replaces': 'regda_tpu/models/sam/pallas_attention.py:176',
            'max_abs_err': max_err, **glob, 'windowed': win}


def phase_check(device):
    """The card agrees with the CPU on small inputs."""
    import torch
    from regda_tpu_torch.models import build_deeplabv2

    model = build_deeplabv2('ResNet101', 6, generator=torch.Generator().manual_seed(1)).eval()
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = model(x)
        got = model.to(device)(x.to(device)).cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f'eval forward card vs CPU: max abs err {err}')
    print(f'[check] ResNet-101 eval forward 2x64^2 f32, card vs CPU: max abs err {err:.3g}')

    import numpy as np
    from regda_tpu_torch.entry import stage2_state, synthetic_stage2_batch
    from regda_tpu_torch.models.heads import Dropout2d
    from regda_tpu_torch.ops.lrh import homogenize

    batch_np = synthetic_stage2_batch(np.random.default_rng(4), 2, 64, 6)
    runs = {}
    for dev in ('cpu', device):
        state, step = stage2_state(dev, resnet='resnet18', seed=3)
        for m in state.model.modules():
            if isinstance(m, Dropout2d):
                m.p = 0.0   # the two devices draw different dropout bits
        metrics = step(state, *(torch.from_numpy(a).to(dev) for a in batch_np))
        runs[dev] = ({k: float(v) for k, v in metrics.items()},
                     state.prototypes.cpu())
    (m_cpu, p_cpu), (m_gpu, p_gpu) = runs['cpu'], runs[device]
    for k in m_cpu:
        if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4, abs_tol=1e-5):
            raise AssertionError(f'stage-2 {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}')
    if not torch.allclose(p_gpu, p_cpu, rtol=1e-4, atol=1e-5):
        raise AssertionError('stage-2 prototypes differ between card and CPU')
    print(f'[check] resnet18 stage-2 step 2x64^2, card vs CPU: losses agree '
          f'(rtol 1e-4): {m_gpu}')

    # LRH on the main path's shape: the card (kernel) vs the CPU (plain)
    rng = np.random.default_rng(5)
    regs = synthetic_stage2_batch(rng, 8, 512, 6)[3]
    pseudo = np.where(rng.random(regs.shape) < 0.3, -1, (regs * 5) % 6)
    pseudo = np.where(rng.random(regs.shape) < 0.2,
                      rng.integers(-1, 6, regs.shape), pseudo).astype(np.int32)
    regs[:, :8] = 4000   # over-budget ids abstain
    want = homogenize(torch.from_numpy(pseudo), torch.from_numpy(regs))
    got = homogenize(torch.from_numpy(pseudo).to(device),
                     torch.from_numpy(regs).to(device)).cpu()
    if not torch.equal(got, want):
        raise AssertionError('homogenize differs between card and CPU')
    print(f'[check] homogenize 8x512^2 R=1024 C=6, card vs CPU: equal '
          f'({int((want != torch.from_numpy(pseudo)).sum())} labels changed)')

    # SAM in f32: kernels on the card vs plain versions on the CPU. A 256^2
    # image gives a 16x16 grid, so windowed blocks pad 16 -> 28.
    from regda_tpu_torch.entry import sam_entry
    model, (images, points, labels) = sam_entry(
        'cpu', vit_config='vit_b', img_size=256, crops=2, points=4,
        dtype=torch.float32, seed=6)
    with torch.inference_mode():
        want = model.encode(images)
        got = model.to(device).encode(images.to(device)).cpu()
    err = _assert_close('ViT-B encode 2x256^2 f32 card vs CPU', got, want, **SAM_CHECK_TOL)
    print(f'[check] ViT-B encoder 2x256^2 f32, card vs CPU: max abs err {err:.3g} '
          f'(max |value| {float(want.abs().max()):.3g})')
    model, (images, points, labels) = sam_entry(
        'cpu', vit_config='vit_t', img_size=128, crops=1, points=4,
        dtype=torch.float32, seed=7)
    with torch.inference_mode():
        want = model(images, points, labels)
        got = model.to(device)(images.to(device), points.to(device), labels.to(device))
    for name, g, w in zip(('masks', 'iou'), got, want):
        err = _assert_close(f'vit_t Sam.forward {name} card vs CPU', g.cpu(), w, **SAM_CHECK_TOL)
        print(f'[check] vit_t Sam.forward 128^2 f32 {name} {tuple(w.shape)}, card vs CPU: '
              f'max abs err {err:.3g}')


def phase_serve(device) -> None:
    import torch
    from regda_tpu_torch.entry import entry

    forward, (image,) = entry(device, batch=16, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probs = forward(image)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if tuple(probs.shape) != (16, 512, 512, 6):
        raise AssertionError(f'serve output shape {tuple(probs.shape)}')
    p = probs.float()
    if not bool(torch.isfinite(p).all()):
        raise AssertionError('serve output is not finite')
    sum_err = float((p.sum(-1) - 1.0).abs().max())
    if sum_err > 1e-2:
        raise AssertionError(f'probabilities sum to 1 only within {sum_err}')
    ms = cuda_ms(lambda: forward(image), iters=10, warmup=2)
    print(f'[serve] ResNet-101 bf16 eval 16x512^2: first call {first_s:.3f} s, '
          f'{ms:.3f} ms/batch, {16e3 / ms:.2f} tiles/s, |sum-1| <= {sum_err:.3g}, '
          f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')


def phase_train(device) -> None:
    import torch
    from regda_tpu_torch.entry import stage2_steps

    torch.cuda.reset_peak_memory_stats()
    state, metrics, seconds = stage2_steps(3, device)
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f'step {i}: non-finite loss {vals}')
        print(f'[train] step {i}: {seconds[i] * 1e3:.1f} ms {vals}')
    if state.step != 3:
        raise AssertionError(f'step counter {state.step} != 3')
    print(f'[train] ResNet-101 stage-2 f32 2x8x512^2: '
          f'{sum(seconds[1:]) / 2 * 1e3:.1f} ms/step (steps 1-2), '
          f'peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')


def _encode_profile(model, images) -> str:
    """Device time of one encode by kind of kernel, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.encode(images)
        torch.cuda.synchronize()
    kinds = {'rel_attn': 0.0, 'layernorm_kernel': 0.0, 'gemm': 0.0, 'other': 0.0}
    for ev in prof.events():
        if str(ev.device_type).endswith('CUDA'):
            name = ev.name.lower()
            kind = ('rel_attn' if 'rel_attn' in name else
                    'layernorm_kernel' if 'layernorm_kernel' in name else
                    'gemm' if any(t in name for t in ('gemm', 'nvjet', 'cutlass', 'xmma'))
                    else 'other')
            kinds[kind] += ev.device_time / 1e3
    total = sum(kinds.values())
    if total <= 0:
        return 'not measured (the profiler reported no device time)'
    return f'{total:.2f} ms of kernels: ' + ', '.join(
        f'{k} {v:.2f} ms ({100 * v / total:.1f} %)' for k, v in kinds.items())


def phase_sam(device):
    """One encode and one decode chunk, checked; returns what `sam_timings`
    needs, so that the caller can read the launch counts in between."""
    import torch
    from regda_tpu_torch.entry import sam_entry

    model, (images, points, labels) = sam_entry(device)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        emb = model.encode(images)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        masks, iou = model.decode_points(emb[:1], points, labels)
        torch.cuda.synchronize()
    for name, t, shape in (('embedding', emb, (5, 64, 64, 256)),
                           ('masks', masks, (64, 3, 256, 256)), ('iou', iou, (64, 3))):
        if tuple(t.shape) != shape:
            raise AssertionError(f'sam {name} shape {tuple(t.shape)} != {shape}')
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f'sam {name} is not finite')
    if float(masks.float().std()) == 0.0:
        raise AssertionError('sam masks are constant')
    return model, images, points, labels, emb, first_s


def sam_timings(model, images, points, labels, emb, first_s) -> None:
    import torch
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: model.encode(images), iters=5, warmup=1)
        dec_ms = cuda_ms(lambda: model.decode_points(emb[:1], points, labels),
                         iters=5, warmup=1)
        split = _encode_profile(model, images)
    print(f'[sam] ViT-B bf16 encode 5x1024^2: first call {first_s:.3f} s, '
          f'{enc_ms:.3f} ms/encode, {5e3 / enc_ms:.2f} crops/s; decode_points 64 prompts: '
          f'{dec_ms:.3f} ms/chunk; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    print(f'[sam] one encode under torch.profiler: {split}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a GPU',
              file=sys.stderr)
        return 1
    import regda_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from regda_tpu_torch.ops.kernels import layernorm as ln
    from regda_tpu_torch.ops.kernels import rel_attention as ra
    from regda_tpu_torch.ops.kernels import segment_hist as sh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = 'cuda'
    card = card_line()
    print(f'[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    build_kernels()
    record = phase_kernel(device)
    ln_record = phase_layernorm(device)
    attn_record = phase_attention(device)
    phase_check(device)

    sh.launches = 0
    phase_serve(device)
    phase_train(device)
    record['launches'] = sh.launches
    if record['launches'] < 3:
        raise AssertionError(f'segment_hist launched {record["launches"]} times '
                             f'in 3 stage-2 steps; LRH did not go through the kernel')

    ln.launches = ra.launches = 0
    sam = phase_sam(device)
    ln_record['launches'], attn_record['launches'] = ln.launches, ra.launches
    if (ln.launches, ra.launches) != (24, 12):
        raise AssertionError(f'one ViT-B encode launched layernorm {ln.launches} times '
                             f'(expected 24) and rel_attention {ra.launches} (expected 12)')
    sam_timings(*sam)   # these launch more, after the counts are read

    print(json.dumps({'kernels': [record, ln_record, attn_record]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
