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
              tests' own) and in bf16 (LN_BF16_TOL, ATTN_BF16_TOL below);
              the fused mask head and the two-way transformer in f32
              (rtol/atol 2e-4) and in bf16 (UPSCALE_BF16_STEPS,
              TWOWAY_BF16_STEPS below), gated prompts exactly zero, and the
              mask head's bf16 gelu table equal to the exact erf form on all
              65,536 bf16 inputs, bit for bit; the
              stability counts (both entries; STAB_* below) at one chunk's
              768 candidates on the 512^2 and 343^2 frames, and the mask
              statistics (STATS_ZERO_BAND below) at the main path's two
              calls a tile, crop 0's 256 slots on 512^2 and the four layer-1
              crops' 1024 slots on 343^2; both at ragged frames too, gated
              outputs exactly zero.
              Each is timed with CUDA events beside its plain version, its
              bound (bytes over 3.35 TB/s or operations over the peak rate,
              whichever is larger) and, where one PyTorch call computes the
              same function, that call as a yardstick that the port itself
              never makes. The histogram and the mask statistics are read
              with their inputs L2-warm and L2-cold (COLD_BYTES below); the
              histogram also in a CUDA graph of back-to-back calls (the
              device's pace, and its kernel's device time from
              torch.profiler) beside the host's microseconds a call.
     check    small-size agreement of the card with the CPU: the ResNet-101
              eval forward (f32, rtol/atol 1e-4) and one resnet18 stage-2
              step with dropout off (losses rtol 1e-4), `homogenize` at
              8x512^2, kernel on the card against plain on the CPU (equal),
              the SAM encoder at ViT-B width and depth on a 256^2 image, a
              whole `Sam.forward` at vit_t, and `Sam.decode_points_fast` at
              vit_t against the same call on the CPU and against
              `Sam.decode_points` on the card (f32, SAM_CHECK_TOL below);
              a vit_t f32 region generator (96^2 tiles): `generate_regions`,
              `generate_regions_batch` and `generate_regions_stream` on the
              card give the CPU's maps, and a run with interleaved masks
              gives the blocked ones through the interleaved stability entry.
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
              Then the fast decode as everything-mode calls it,
              `decode_points_fast(emb[:1], points, labels, mask_dtype=bf16,
              blocked_masks=True)`, on 64 and on 256 grid prompts: shapes,
              finiteness, exactly one two-way and one mask-head call per
              chunk; after the counts are read, the fast chunk against the
              stock one in bf16 (FAST_VS_STOCK_BF16_STEPS), the IoU gate at
              the median IoU (gated masks equal or exactly zero), ms per
              chunk of both paths at both sizes, peak memory, and a
              torch.profiler split of one fast chunk of 64 and one of 256
              prompts with its idle share and the two-way kernels by launch.
  5. regions  `sam_regions_entry()`: `SamRegionGenerator` over SAM ViT-B, 8
              tiles of 512^2, the reference's everything-mode configuration
              (32 x 32 points, crop_n_layers=1 with the grid halved, 256
              prompts a chunk, budget 256, exact stability, IoU gate, bf16,
              blocked masks). The weights are random, so the IoU and
              stability thresholds and the stability offset are the medians
              of the run's own scores on crop 0 of tile 0 (printed).
              `generate_regions_batch(tiles)` once, with the launch counts
              around it asserted exactly (per live chunk one stability, one
              two-way and one mask-head call; mask statistics twice a tile;
              24 LayerNorm and 12 attention launches an encode); int32
              (512, 512) maps with ids below MAX_REGIONS, not all empty
              (on random weights every mask spans its crop, so NMS leaves
              about one region a tile); then `generate_regions_stream` over 3
              batches, its maps equal to the batch call's. Tiles/s of both,
              ms per tile by stage, candidates through each filter, chunks
              skipped, peak memory, and a torch.profiler split of one tile
              with the device's idle share. Last, the same generator with
              both NMS thresholds at 1.0, so that hundreds of masks a tile
              are painted: every tile holds more than one region, and
              `generate_regions_batch` and `generate_regions` give the maps
              of `generate()` + `regions_from_anns`, whose boxes, areas and
              paint are numpy on the host.
Launch counts are zeroed just before phases 2-3, again just before the
encode of phase 4, again just before its fast decode and again just before
phase 5's batch call, and read just after each.
TF32 is off in every phase (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` both False): phases 2,
4 and 5 compute in bf16, and the others hold float32 as float32, as the JAX
train path does.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the card's name and power limit, and the line before that the
kernels' JSON record, one for each of the JAX package's nine `pallas_call`s
(the blocked stability entry stands for both blocked TPU kernels). Without a
CUDA device the script exits non-zero at once and prints no result.

    python3 chip_smoke.py --parent DIR

also times the mask-head, stability, mask-statistics and histogram kernels
of the checkout at DIR (the parent commit, unpacked by `git archive`) beside
this checkout's, in turns, in phase 1 (the histogram through each side's own
wrapper, warm, cold, and cold in a CUDA graph).
"""

from __future__ import annotations

import itertools
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


# Inputs read L2-cold: a timing loop rotates through copies of its inputs that
# together exceed this many bytes, twice the H100's 50 MB L2, so that no call
# finds its inputs in the cache from the call before.
COLD_BYTES = 100_000_000


def cold_copies(*tensors) -> list:
    """Copies of `tensors` (the first is the tensors themselves) that together
    hold more than COLD_BYTES."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(COLD_BYTES // nbytes)]


def rotating(fn, copies):
    """fn(*copy) for the next copy at each call."""
    turn = itertools.count()
    return lambda: fn(*copies[next(turn) % len(copies)])


def graph_ms(fn, calls: int, kernel: str, replays: int = 10) -> tuple[float, float]:
    """(milliseconds per call, kernel milliseconds per call) of fn() captured
    `calls` times in one CUDA graph and replayed: the first is the device's
    pace without the host's cost between calls (CUDA events around the
    replays), the second the device time of the kernels whose name holds
    `kernel` alone (torch.profiler over one replay; a profile that does not
    show one such kernel a call is taken again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # first use (libraries, allocator) outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, replays, warmup=2) / calls
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        times = [ev.device_time for ev in prof.events()
                 if str(ev.device_type).endswith('CUDA') and kernel in ev.name]
        if len(times) == calls:
            break
    else:
        raise AssertionError(f'torch.profiler showed {len(times)} {kernel} kernels in a graph '
                             f'of {calls} calls')
    del graph
    return ms, sum(times) / 1e3 / calls


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn(), back to back, without waiting for
    the device between calls (it keeps up unless the host outpaces it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


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
# the fused mask head and the two-way kernels in bf16, in steps of 2^-8 times
# the largest magnitude of the plain version's result: kernel and plain round
# the same chain at the same places but sum in another order, so a value may
# land one step off at each of the chain's roundings
UPSCALE_BF16_STEPS = 4
TWOWAY_BF16_STEPS = 8
# the fast decode against the stock decode, both in bf16 at full width: two
# computations of one function that round at different places throughout
FAST_VS_STOCK_BF16_STEPS = 16
# stability counts over a (ch, cw) frame: the kernel sums each pixel's 4 + 4
# taps with fused multiply-adds in index order, the plain version with dense
# matmuls in the library's order, so a resized logit within an ulp of +-offset
# may fall on the other side and move a count by one. In bf16 the row-resized
# intermediate is rounded to bf16 as well, and a value on a rounding boundary
# there moves the pixel by a whole bf16 step (2^-8 relative): more pixels can
# change sides, still a small share of the frame. Limits: |count difference|
# <= 1 + share * ch * cw, and in bf16 also the stability score inter / union.
# On an H100 no count has differed at any shape below; the bf16 share leaves
# room for a few such pixels a candidate at the smallest frame.
STAB_F32_SHARE = 1e-5
STAB_BF16_SHARE = 1e-4
STAB_BF16_SCORE_TOL = 5e-4
# mask statistics are float32 throughout and thresholded at 0: bits, boxes and
# areas must equal the plain version's, except that a pixel may differ where
# the plain version's resized logit lies within this share of the largest
# |logit| of 0 (fused multiply-adds and the order of 4-term sums)
STATS_ZERO_BAND = 2.0 ** -20


def bound_ms(nbytes: float, flops: float, rate: str) -> tuple[float, str]:
    """Least milliseconds the card could take: (time, 'bytes' | 'operations')."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def build_kernels() -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from regda_tpu_torch.ops.kernels import _build
    names = ('segment_hist', 'layernorm', 'rel_attention', 'upscale', 'two_way',
             'stability', 'mask_stats')
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
    call = lambda lab, reg: sh.segment_hist_labels(lab, reg, 1024, 6)  # noqa: E731
    ms = cuda_ms(lambda: call(lab, reg), 200)
    copies = cold_copies(lab, reg)
    ms_cold = cuda_ms(rotating(call, copies), 200)
    graph_cold, kernel_cold = graph_ms(rotating(call, copies), 4 * len(copies),
                                       'segment_hist_kernel')
    graph_warm, kernel_warm = graph_ms(lambda: call(lab, reg), 4 * len(copies),
                                       'segment_hist_kernel')
    us = host_us(lambda: call(lab, reg))
    ncopies = len(copies)
    del copies
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
    print(f'[kernel] segment_hist B=8 N=512^2 R=1024 C=6: wrapper calls {ms:.4f} ms warm, '
          f'{ms_cold:.4f} ms cold (CUDA events, 200 calls back to back: the host\'s pace '
          f'or the device\'s, whichever is slower); in one CUDA graph of '
          f'{4 * ncopies} calls {graph_warm:.4f} ms warm, {graph_cold:.4f} ms cold a call, '
          f'of which the histogram kernel {kernel_warm:.4f} / {kernel_cold:.4f} ms '
          f'(torch.profiler); the host {us:.1f} us a wrapper call; plain {plain_ms:.4f} ms, '
          f'scatter_add_ alone {library_ms:.4f} ms, bound {bound:.4f} ms ({by}) (inputs warm: '
          f'one copy, 16.8 MB, in the L2; cold: {ncopies} copies in turns, '
          f'{ncopies * 2 * lab.numel() * 4 / 1e6:.1f} MB)')
    return {'name': 'segment_hist_labels', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/segment_hist.cu',
            'replaces': 'regda_tpu/ops/pallas/segment_hist.py:82',
            'max_abs_err': max_err, 'ms': ms, 'ms_cold': ms_cold,
            'graph_ms': graph_warm, 'graph_ms_cold': graph_cold,
            'kernel_device_ms': kernel_warm, 'kernel_device_ms_cold': kernel_cold,
            'host_us_per_call': us, 'plain_ms': plain_ms,
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
    # single short tile, kh != kw, vit_h's head dim, kh != kw = 64 (a global
    # layer of a non-square grid), and N = 2304, no multiple of 128 rows
    cases = [(5, 12, 64, 64, 64), (1, 12, 64, 64, 64), (125, 12, 14, 14, 64),
             (3, 2, 14, 14, 32),
             (2, 2, 4, 4, 32), (2, 3, 5, 7, 64), (2, 2, 14, 14, 80),
             (2, 12, 32, 64, 64), (1, 4, 48, 48, 64)]
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


def _within_bf16_steps(what: str, got, want, steps: float) -> float:
    """max |got - want| <= steps * 2^-8 * max |want|; returns the error."""
    import torch
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    limit = steps * 2.0 ** -8 * float(want.abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= limit):
        raise AssertionError(f'{what}: max abs err {err} > {limit} ({steps} bf16 steps '
                             f'of max |value| {float(want.abs().max())})')
    return err


def _upscale_inputs(rng, device, dtype, b, h, w, m):
    """src like a LayerNorm's output, weights at the scale that keeps every
    stage of the chain at unit size."""
    import numpy as np
    import torch

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)
    return (f(b, h, w, 256).to(dtype), f(b, m, 32).to(dtype), f(256, 256, scale=1 / 16).to(dtype),
            f(1, 256, scale=0.1), 1 + f(1, 64, scale=0.1), f(1, 64, scale=0.1),
            f(64, 128, scale=1 / 8).to(dtype), f(1, 128, scale=0.1))


def phase_upscale(device) -> dict:
    """The fused mask-head kernels against their plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from regda_tpu_torch.ops.kernels import upscale as up

    # the bf16 kernel's gelu is a table built from the exact erf form: it must
    # give the exact form's bits for every one of the 65,536 bf16 inputs
    fast, exact = up.gelu_table_check(device)
    torch.cuda.synchronize()
    if not torch.equal(fast, exact):
        bad = (fast != exact).nonzero().flatten()[:8].tolist()
        raise AssertionError(f'upscale: the bf16 gelu differs from the exact form at '
                             f'{int((fast != exact).sum())} inputs, e.g. bits {bad}')
    x = torch.arange(65536, dtype=torch.int32, device=device).to(torch.int16).view(torch.bfloat16)
    finite = torch.isfinite(x.float())
    torch_bits = F.gelu(x).view(torch.int16)
    print(f'[kernel] upscale: the bf16 gelu equals the exact erf form on all 65536 bf16 inputs, '
          f'bit for bit ({int((torch_bits != exact)[finite].sum())} of the '
          f'{int(finite.sum())} finite ones differ from torch\'s bf16 gelu on the card)')

    rng = np.random.default_rng(12)
    # (B, H, W, M, blocked, out dtype or None for the compute dtype, active):
    # the main path's chunks of 64 and of 256 prompts (blocked, 3 masks,
    # output in the compute dtype), then ragged ones: one prompt, an 8 x 8 grid (half a
    # tile), 1 and 4 masks, interleaved output, float32 output from bfloat16,
    # and the gate with some, all and no prompts off
    cases = [(64, 64, 64, 3, True, None, None), (256, 64, 64, 3, True, None, None),
             (1, 64, 64, 3, False, None, None),
             (3, 8, 8, 1, True, None, None), (2, 8, 8, 4, False, torch.float32, None),
             (5, 12, 12, 3, True, torch.bfloat16, 'some'), (5, 12, 12, 3, False, None, 'some'),
             (3, 8, 8, 3, True, None, 'all'), (3, 8, 8, 3, True, None, 'none')]
    max_err = 0.0
    for b, h, w, m, blocked, out_dtype, gate in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _upscale_inputs(rng, device, dtype, b, h, w, m)
            odt = out_dtype or dtype
            active = None
            if gate is not None:
                active = torch.from_numpy(rng.random(b) < 0.5).to(device)
                active[0], active[1] = True, False
                if gate != 'some':
                    active[:] = gate == 'none'
            what = (f'upscale B={b} {h}x{w} M={m} {"blocked" if blocked else "interleaved"} '
                    f'{str(dtype)[6:]}->{str(odt)[6:]} gate={gate}')
            got = up.upscale_hyper_masks(*args, out_dtype=odt, active=active, blocked=blocked)
            want = up.upscale_plain(*args, odt, active, blocked)
            torch.cuda.synchronize()
            if got.dtype != odt or got.shape != want.shape:
                raise AssertionError(f'{what}: got {got.dtype} {tuple(got.shape)}')
            if dtype == torch.float32 and odt == torch.float32:
                err = _assert_close(what, got, want, rtol=2e-4, atol=2e-4)
            else:
                err = _within_bf16_steps(what, got, want, UPSCALE_BF16_STEPS)
            if active is not None and bool((got[~active] != 0).any()):
                raise AssertionError(f'{what}: a gated prompt is not exactly zero')
            max_err = max(max_err, err)
            print(f'[kernel] {what}: max abs err {err:.3g} '
                  f'(max |value| {float(want.float().abs().max()):.3g})')
            del args, got, want
            torch.cuda.empty_cache()
    try:
        up.upscale_hyper_masks(*_upscale_inputs(rng, device, torch.float32, 1, 4, 4, 3)[:2],
                               *_upscale_inputs(rng, device, torch.bfloat16, 1, 4, 4, 3)[2:])
    except ValueError:
        print('[kernel] upscale: a src of another dtype than k1 raises')
    else:
        raise AssertionError('upscale took a float32 src with bfloat16 weights')

    # time at the main path's shapes: 64 and 256 prompts, bf16 in and out,
    # blocked
    def times(b, hw=4096, m=3):
        args = _upscale_inputs(rng, device, torch.bfloat16, b, 64, 64, m)
        ms = cuda_ms(lambda: up.upscale_hyper_masks(*args, out_dtype=torch.bfloat16,
                                                    blocked=True), 20)
        plain_ms = cuda_ms(lambda: up.upscale_plain(*args, torch.bfloat16, None, True), 3,
                           warmup=1)
        # src and hyper_in read once, the weights once, the masks written
        # once; the three products
        nbytes = 2 * (b * hw * 256 + b * m * 32 + 256 * 256 + 64 * 128 + b * m * 16 * hw)
        bound, by = bound_ms(nbytes, 2.0 * b * hw * (256 * 256 + 4 * 64 * 128 + 16 * 32 * m),
                             'bf16')
        print(f'[kernel] upscale bf16 B={b} HW={hw} M={m} blocked: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); no single PyTorch call '
              f'computes it (CUDA events)')
        torch.cuda.empty_cache()
        return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
                'library_ms': None}
    return {'name': 'upscale_hyper_masks', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/upscale.cu',
            'replaces': 'regda_tpu/models/sam/pallas_upscale.py:309',
            'max_abs_err': max_err, **times(64), 'prompts_256': times(256)}


def _two_way_operands(rng, device, dtype, b, t, n, mlp):
    """Operands of `two_way_fused` at unit scale: n of the 8 token rows used,
    weights drawn at 1 / sqrt(fan-in)."""
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import two_way as tw

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)
    acts = [f(b, 8, 128), f(b, 8, 128), f(b, 8, 256), f(b, 8, 256),
            f(t, 256), f(t, 256), f(t, 128)]
    for a in acts[:4]:
        a[:, n:] = 0
    maskb = torch.where(torch.arange(8, device=device) < n, 0.0, -1e9)[None].float()
    w = {}
    for key, shape in tw._weight_shapes(256, 128, mlp).items():
        if len(shape) == 2:
            w[key] = f(*shape, scale=shape[0] ** -0.5).to(dtype)
        else:
            w[key] = (1 + f(*shape, scale=0.1)) if key[0] == 'n' and key[-1] == 'w' \
                else f(*shape, scale=0.1)
    return (*(a.to(dtype) for a in acts), maskb, w)


def _kernel_name(name: str) -> str:
    """A profiler event's kernel name without its return type, namespace and
    arguments."""
    return name.replace('(anonymous namespace)::', '').replace('void ', '').split('(')[0]


def kernel_split(fn) -> dict:
    """Device milliseconds of one call of fn() by kernel name, from
    torch.profiler (device tracing only; the second profile counts, the first
    pays for starting the tracer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    split = {}
    for ev in prof.events():
        if str(ev.device_type).endswith('CUDA'):
            name = _kernel_name(ev.name)
            split[name] = split.get(name, 0.0) + ev.device_time / 1e3
    return split


def two_way_split(device, b: int, t: int = 4096, mlp: int = 2048) -> dict:
    """One bf16 `two_way_fused` call at the main path's shape, by launch."""
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import two_way as tw
    ops = _two_way_operands(np.random.default_rng(b), device, torch.bfloat16, b, t, 7, mlp)
    split = kernel_split(lambda: tw.two_way_fused(ops))
    print(f'[kernel] two_way bf16 B={b} T={t} by launch (torch.profiler, one call): '
          + ', '.join(f'{k} {v:.4f} ms' for k, v in split.items())
          + f'; total {sum(split.values()):.4f} ms')
    return split


def phase_two_way(device) -> dict:
    """The two-way transformer kernels against their plain version."""
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import two_way as tw

    rng = np.random.default_rng(13)
    # (B, T, tokens used, MLP width): the main path's chunks of 64 and of 256
    # prompts, then ragged ones: one prompt (every tile its own block), an 8 x 8 grid
    # with 5 tokens, a T that is no multiple of any tile with all 8 tokens
    cases = [(64, 4096, 7, 2048), (256, 4096, 7, 2048), (1, 4096, 7, 2048),
             (3, 64, 5, 512), (2, 200, 8, 256)]
    max_err = 0.0
    for b, t, n, mlp in cases:
        for dtype in (torch.float32, torch.bfloat16):
            ops = _two_way_operands(rng, device, dtype, b, t, n, mlp)
            what = f'two_way B={b} T={t} n={n} mlp={mlp} {str(dtype)[6:]}'
            got = tw.two_way_fused(ops)
            want = tw.two_way_plain(ops)
            torch.cuda.synchronize()
            errs = []
            for name, g_, w_ in zip(('keys2', 'queries'), got, want):
                if g_.dtype != dtype or g_.shape != w_.shape:
                    raise AssertionError(f'{what} {name}: got {g_.dtype} {tuple(g_.shape)}')
                g_, w_ = (g_, w_) if name == 'keys2' else (g_[:, :n], w_[:, :n])
                if dtype == torch.float32:
                    errs.append(_assert_close(f'{what} {name}', g_, w_, rtol=2e-4, atol=2e-4))
                else:
                    errs.append(_within_bf16_steps(f'{what} {name}', g_, w_, TWOWAY_BF16_STEPS))
            max_err = max(max_err, *errs)
            print(f'[kernel] {what}: max abs err keys2 {errs[0]:.3g}, queries {errs[1]:.3g} '
                  f'(max |value| {float(want[0].float().abs().max()):.3g}, '
                  f'{float(want[1][:, :n].float().abs().max()):.3g})')
            del ops, got, want
            torch.cuda.empty_cache()
    ops = _two_way_operands(rng, device, torch.float32, 1, 64, 7, 384)
    try:
        tw.two_way_fused(ops)
    except ValueError:
        print('[kernel] two_way: an MLP width the kernels are not built for raises')
    else:
        raise AssertionError('two_way took an MLP width of 384')

    # time at the main path's shapes: 64 and 256 prompts, bf16
    def times(b, t=4096, mlp=2048):
        ops = _two_way_operands(rng, device, torch.bfloat16, b, t, 7, mlp)
        ms = cuda_ms(lambda: tw.two_way_fused(ops), 20)
        plain_ms = cuda_ms(lambda: tw.two_way_plain(ops), 3, warmup=1)
        # read once: the shared keys0, pe and qimg0, the prompts' four token
        # operands and the weights; written once: keys2 and the query state.
        # Operations: per prompt and image token 8 x (16 x 8) logits of layer
        # 0 and seven 64 x 256 products; per prompt the token work (two value
        # projections of 64 x 256 x 16, two out-projections, the MLP, five
        # projections to D, five folded operands of 256 x 64 x 16)
        weights = sum(v.numel() * v.element_size() for v in ops[8].values())
        nbytes = 2 * (t * (256 + 256 + 128) + b * 8 * (2 * 128 + 2 * 256) +
                      b * t * 256 + b * 8 * 256) + weights
        macs = b * (t * (8 * 16 * 8 + 7 * 64 * 256) + 7 * 64 * 256 * 16 +
                    2 * 8 * 128 * 256 + 2 * 8 * 256 * mlp + 5 * 8 * 256 * 128)
        bound, by = bound_ms(nbytes, 2.0 * macs, 'bf16')
        print(f'[kernel] two_way bf16 B={b} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
              f'bound {bound:.4f} ms ({by}); no single PyTorch call computes it (CUDA events)')
        del ops
        torch.cuda.empty_cache()
        two_way_split(device, b, t, mlp)
        return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
                'library_ms': None}
    return {'name': 'two_way_fused', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/two_way.cu',
            'replaces': 'regda_tpu/models/sam/pallas_twoway.py:460',
            'max_abs_err': max_err, **times(64), 'prompts_256': times(256)}


def _resize_case(rng, device, dtype, m, s, frame, main: bool, scale: float = 2.0):
    """Logits (M, S, S) and the `ResizeFrame` of one frame on the card: the
    composed chain of the main path (crops resized to the 1024^2 model frame)
    or, for the small cases, the plain half-pixel matrices that the JAX tests
    use."""
    import numpy as np
    import torch
    from regda_tpu_torch.models.sam.auto import composed_resize_matrices
    from regda_tpu_torch.ops.kernels._band import ResizeFrame
    from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel
    ch, cw = frame
    if main:
        m_h, m_w = composed_resize_matrices(4 * s, (4 * s, 4 * s, ch, cw), s)
    else:
        m_h, m_w = _interp_matrix_half_pixel(s, ch), _interp_matrix_half_pixel(s, cw)
    logits = torch.from_numpy((rng.normal(size=(m, s, s)) * scale).astype(np.float32))
    return logits.to(device, dtype), ResizeFrame(m_h, m_w, device)


def _band_flops(fr, dtype, m: int, sw: int) -> float:
    """Operations of the separable resize that these matrices need for m
    candidates: a multiply and an add per non-zero tap, sw values a row-tap
    and ch values a column-tap (the band's zero taps add nothing)."""
    h_taps, w_taps = fr.bands(dtype)[1], fr.bands(dtype)[3]
    return m * 2.0 * (float((h_taps != 0).sum()) * sw + float((w_taps != 0).sum()) * fr.ch)


def _gate(rng, device, m: int, kind):
    import torch
    if kind is None:
        return None
    active = torch.from_numpy(rng.random(m) < 0.5).to(device)
    active[0], active[1] = True, False
    if kind != 'some':
        active[:] = kind == 'all'
    return active


def phase_stability(device) -> tuple[dict, dict]:
    """The stability-count kernel's two entries against the plain version."""
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import stability as st

    rng = np.random.default_rng(14)
    # (M, S, frame, main-path matrices, gate): one chunk's 768 candidates on
    # crop 0 (512^2) and on a layer-1 crop (343^2), then the JAX tests' ragged
    # frames at S = 32, and the gate with some, all and no candidates on
    cases = [(768, 256, (512, 512), True, None), (768, 256, (343, 343), True, 'some'),
             (7, 32, (51, 77), False, None), (7, 32, (51, 77), False, 'some'),
             (5, 32, (100, 96), False, 'all'), (5, 32, (100, 96), False, 'none'),
             (3, 64, (37, 200), False, 'some')]
    max_err = {'blocked': 0.0, 'fused': 0.0}
    for m, s, (ch, cw), main, gate in cases:
        for dtype in (torch.float32, torch.bfloat16):
            logits, frame = _resize_case(rng, device, dtype, m, s, (ch, cw), main)
            active = _gate(rng, device, m, gate)
            want_i, want_u = st.stability_counts_plain(logits, frame.m_h, frame.m_wt, 1.0,
                                                       active)
            blk = st.block_masks(logits, s // 4, s // 4).contiguous()
            if not torch.equal(st.unblock_masks(blk, s // 4, s // 4), logits):
                raise AssertionError('block_masks / unblock_masks do not invert each other')
            share = STAB_F32_SHARE if dtype == torch.float32 else STAB_BF16_SHARE
            limit = 1 + share * ch * cw
            for entry, (got_i, got_u) in (
                    ('blocked', st.stability_counts_blocked(blk, frame, s // 4, s // 4, 1.0,
                                                            active)),
                    ('fused', st.stability_counts_fused(logits, frame, 1.0, active))):
                torch.cuda.synchronize()
                what = (f'stability {entry} M={m} S={s} frame {ch}x{cw} {str(dtype)[6:]} '
                        f'gate={gate}')
                if got_i.dtype != torch.float32 or tuple(got_i.shape) != (m,):
                    raise AssertionError(f'{what}: got {got_i.dtype} {tuple(got_i.shape)}')
                d_i, d_u = (got_i - want_i).abs(), (got_u - want_u).abs()
                err = float(torch.maximum(d_i, d_u).max())
                if not err <= limit:
                    raise AssertionError(f'{what}: counts differ by {err} > {limit:.2f}')
                if active is not None and bool(((got_i != 0) | (got_u != 0))[~active].any()):
                    raise AssertionError(f'{what}: a gated candidate is not exactly zero')
                score = float((got_i / got_u.clamp(min=1) - want_i / want_u.clamp(min=1))
                              .abs().max())
                if dtype == torch.bfloat16 and score > STAB_BF16_SCORE_TOL:
                    raise AssertionError(f'{what}: stability scores differ by {score}')
                max_err[entry] = max(max_err[entry], err)
                print(f'[kernel] {what}: {int((d_i > 0).sum())} + {int((d_u > 0).sum())} of '
                      f'{m} + {m} counts differ, by at most {err:.0f} (limit {limit:.2f}, counts '
                      f'up to {float(want_u.max()):.0f}); score differs by at most {score:.2g}')
            del logits, blk
            torch.cuda.empty_cache()
    dense = np.ones((20, 16), np.float32)
    try:
        st.ResizeFrame(dense, dense, device)
    except ValueError:
        print('[kernel] stability: a resize matrix with more than 4 taps a row raises')
    else:
        raise AssertionError('stability took a dense resize matrix')

    # time one chunk's 768 candidates, bf16, as the main path calls it: half
    # of them gated off would halve the work; here all are on
    def times(entry, frame):
        ch, cw = frame
        logits, fr = _resize_case(rng, device, torch.bfloat16, 768, 256, frame, True)
        if entry == 'blocked':
            blk = st.block_masks(logits, 64, 64).contiguous()
            ms = cuda_ms(lambda: st.stability_counts_blocked(blk, fr, 64, 64, 1.0), 50)
        else:
            ms = cuda_ms(lambda: st.stability_counts_fused(logits, fr, 1.0), 50)
        plain_ms = cuda_ms(lambda: st.stability_counts_plain(logits, fr.m_h, fr.m_wt, 1.0), 3,
                           warmup=1)
        # the logits read once, the band forms once, two counts a candidate
        # written; the non-zero taps of the row-resized strip's values and of
        # the frame's pixels, a multiply and an add each, on the f32 units
        nbytes = logits.numel() * 2 + (ch + cw) * 20 + 768 * 8
        bound, by = bound_ms(nbytes, _band_flops(fr, torch.bfloat16, 768, 256), 'f32')
        dense_ms = 768 * 2.0 * (ch * 256 * 256 + ch * 256 * cw) / PEAK_FLOPS['bf16'] * 1e3
        print(f'[kernel] stability {entry} bf16 M=768 S=256 frame {ch}x{cw}: kernel {ms:.4f} ms, '
              f'plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; the dense products of the '
              f'TPU kernels would be {dense_ms:.4f} ms at the bf16 tensor peak); no single '
              f'PyTorch call computes it (CUDA events, 50 calls, inputs L2-cold: 100 MB)')
        torch.cuda.empty_cache()
        return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
                'library_ms': None}
    src = 'regda_tpu_torch/csrc/stability.cu'
    blocked = {'name': 'stability_counts_blocked', 'route': 'cuda', 'source': src,
               'replaces': 'regda_tpu/models/sam/pallas_stability.py:415',
               'max_abs_err': max_err['blocked'], **times('blocked', (512, 512)),
               'frame_343': times('blocked', (343, 343))}
    fused = {'name': 'stability_counts_fused', 'route': 'cuda', 'source': src,
             'replaces': 'regda_tpu/models/sam/pallas_stability.py:135',
             'max_abs_err': max_err['fused'], **times('fused', (512, 512)),
             'frame_343': times('fused', (343, 343))}
    return blocked, fused


def _parent_module(parent, name: str):
    """The wrapper module `regda_tpu_torch/ops/kernels/<name>.py` of another
    checkout, loaded under another name, whose library is built from that
    checkout's sources: the wrapper as that checkout called its kernel."""
    import importlib.util
    from pathlib import Path

    from regda_tpu_torch.ops.kernels import _build
    root = Path(parent) / 'regda_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        f'parent_{name}', root / 'ops' / 'kernels' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class ParentBuild:
        @staticmethod
        def load_library(lib_name):
            return _build.load_library(lib_name, root / 'csrc')
    mod._build = ParentBuild
    return mod


def parent_times(parent) -> dict:
    """The mask-head, stability, mask-statistics and histogram kernels of
    another checkout (`parent`, the root of one, e.g. the parent commit
    unpacked by `git archive`), built from its own sources, timed in turns
    with this checkout's on the same inputs at the main path's shapes:
    parent, this, this, parent. The first three are called through this
    checkout's wrapper with the parent's library swapped in (their C entries
    take the same arguments); the histogram through the parent's own wrapper
    as well, which zeroed its output with a launch of its own. Returns {case:
    {'parent': [ms, ms], 'this': [ms, ms]}}."""
    from pathlib import Path

    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import _build
    from regda_tpu_torch.ops.kernels import mask_stats as ms_
    from regda_tpu_torch.ops.kernels import segment_hist as sh
    from regda_tpu_torch.ops.kernels import stability as st
    from regda_tpu_torch.ops.kernels import upscale as up

    csrc = Path(parent) / 'regda_tpu_torch' / 'csrc'
    libs = {}
    for mod, name in ((up, 'upscale'), (st, 'stability'), (ms_, 'mask_stats')):
        this, other = mod._library(), _build.load_library(name, csrc)
        for fn in (f'{name}_launch', f'{name}_error_string'):
            getattr(other, fn).argtypes = getattr(this, fn).argtypes
            getattr(other, fn).restype = getattr(this, fn).restype
        libs[mod] = {'this': this, 'parent': other}

    def swapped(mod, fn):   # fn with `mod` calling each side's library in turn
        def pick(which):
            mod._lib = libs[mod][which]
            return fn
        return pick

    def events(iters):
        return lambda fn: cuda_ms(fn, iters)
    rng = np.random.default_rng(16)
    cases = {}
    for b in (64, 256):
        args = _upscale_inputs(rng, 'cuda', torch.bfloat16, b, 64, 64, 3)
        cases[f'upscale bf16 B={b} HW=4096 M=3 blocked'] = (swapped(
            up, lambda args=args: up.upscale_hyper_masks(*args, out_dtype=torch.bfloat16,
                                                         blocked=True)), events(20))
    for ch in (512, 343):
        logits, fr = _resize_case(rng, 'cuda', torch.bfloat16, 768, 256, (ch, ch), True)
        blk = st.block_masks(logits, 64, 64).contiguous()
        cases[f'stability blocked bf16 M=768 frame {ch}^2'] = (swapped(
            st, lambda blk=blk, fr=fr: st.stability_counts_blocked(blk, fr, 64, 64, 1.0)),
            events(50))
        cases[f'stability fused bf16 M=768 frame {ch}^2'] = (swapped(
            st, lambda x=logits, fr=fr: st.stability_counts_fused(x, fr, 1.0)), events(50))
    for m, ch in ((256, 512), (1024, 343)):
        logits, fr = _resize_case(rng, 'cuda', torch.bfloat16, m, 256, (ch, ch), True)
        copies = cold_copies(logits)
        cases[f'mask_stats bf16 M={m} frame {ch}^2 warm'] = (swapped(
            ms_, lambda x=logits, fr=fr: ms_.mask_stats_fused(x, fr)), events(50))
        cases[f'mask_stats bf16 M={m} frame {ch}^2 cold'] = (swapped(
            ms_, rotating(lambda x, fr=fr: ms_.mask_stats_fused(x, fr), copies)), events(50))
    parent_sh = _parent_module(parent, 'segment_hist')
    lab_np, reg_np = _hist_inputs(rng, 'sam', 8, 512 * 512, 1024, 6)
    lab, reg = (torch.from_numpy(a).cuda() for a in (lab_np, reg_np))
    copies = cold_copies(lab, reg)
    hist = {'this': lambda lab, reg: sh.segment_hist_labels(lab, reg, 1024, 6),
            'parent': lambda lab, reg: parent_sh.segment_hist_labels(lab, reg, 1024, 6)}
    for which in hist:   # the same counts from both, and the first use outside the timing
        if not torch.equal(hist[which](lab, reg), sh.segment_hist_labels_plain(lab, reg, 1024, 6)):
            raise AssertionError(f'segment_hist of the {which} checkout != plain')
    calls = 4 * len(copies)
    for protocol, timer in (('warm', events(200)), ('cold', events(200)),
                            ('cold, CUDA graph',
                             lambda fn: graph_ms(fn, calls, 'segment_hist_kernel')[0]),
                            ('cold, kernel device time',
                             lambda fn: graph_ms(fn, calls, 'segment_hist_kernel')[1])):
        pick = (lambda which, p=protocol: (lambda: hist[which](lab, reg)) if p == 'warm'
                else rotating(hist[which], copies))
        cases[f'segment_hist B=8 N=512^2 R=1024 C=6 {protocol}'] = (pick, timer)
    out = {}
    for case, (pick, timer) in cases.items():
        reads = {'parent': [], 'this': []}
        for which in ('parent', 'this', 'this', 'parent'):
            reads[which].append(timer(pick(which)))
        out[case] = reads
        print(f'[kernel] {case}: parent ' + ' / '.join(f'{t:.4f}' for t in reads['parent'])
              + ' ms, this checkout ' + ' / '.join(f'{t:.4f}' for t in reads['this'])
              + ' ms (CUDA events, read in turns: parent, this, this, parent)')
    for mod in libs:
        mod._lib = libs[mod]['this']
    del cases, copies
    torch.cuda.empty_cache()
    return out


def phase_mask_stats(device) -> dict:
    """The mask-statistics kernel against the plain version."""
    import numpy as np
    import torch
    from regda_tpu_torch.ops.kernels import mask_stats as ms_

    rng = np.random.default_rng(15)
    # (M, S, frame, main-path matrices, gate): the main path's two calls a
    # tile, crop 0's 256 budget slots on the 512^2 frame and the four layer-1
    # crops' 1024 slots together on the 343^2 frame, then one crop's 256 slots
    # there (`generate_regions` works crop by crop), the ragged frames and the
    # gate
    cases = [(256, 256, (512, 512), True, 'some'), (1024, 256, (343, 343), True, 'some'),
             (256, 256, (343, 343), True, None),
             (7, 32, (51, 77), False, None), (7, 32, (51, 77), False, 'some'),
             (5, 32, (100, 96), False, 'all'), (5, 32, (100, 96), False, 'none'),
             (3, 64, (37, 200), False, 'some')]
    flipped = 0
    for m, s, (ch, cw), main, gate in cases:
        for dtype in (torch.float32, torch.bfloat16):
            logits, frame = _resize_case(rng, device, dtype, m, s, (ch, cw), main)
            m_h, m_wt = frame.m_h, frame.m_wt
            logits[m - 1] = -1.0       # an empty mask: box [0, 0, 0, 0], area 0
            active = _gate(rng, device, m, gate)
            bits, boxes, areas = ms_.mask_stats_fused(logits, frame, active=active)
            w_bits, w_boxes, w_areas = ms_.mask_stats_plain(logits, m_h, m_wt, ch, cw, active)
            torch.cuda.synchronize()
            what = f'mask_stats M={m} S={s} frame {ch}x{cw} {str(dtype)[6:]} gate={gate}'
            if bits.dtype != torch.uint8 or tuple(bits.shape) != (m, ch, (cw + 7) // 8):
                raise AssertionError(f'{what}: bits {bits.dtype} {tuple(bits.shape)}')
            got_mask = ms_.unpack_bits(bits, cw).bool()
            diff = got_mask != ms_.unpack_bits(w_bits, cw).bool()
            n_diff = int(diff.sum())
            if n_diff:
                # a differing pixel must lie in the plain version's zero band
                y = torch.matmul(torch.matmul(m_h, logits.float()), m_wt)
                band = STATS_ZERO_BAND * float(logits.float().abs().max())
                if float(y[diff].abs().max()) > band:
                    raise AssertionError(f'{what}: {n_diff} pixels differ, one with |y| = '
                                         f'{float(y[diff].abs().max())} > {band}')
                del y
            # its boxes and areas are those of ITS bits (computed anew here),
            # so they differ from the plain version's by those pixels alone
            own = ms_.mask_stats_plain(torch.where(got_mask, 1.0, -1.0), *(
                torch.eye(n, device=device) for n in (ch, cw)), ch, cw)
            if not (torch.equal(boxes, own[1]) and torch.equal(areas, own[2])):
                raise AssertionError(f'{what}: boxes or areas do not belong to the bits')
            if n_diff == 0 and not (torch.equal(boxes, w_boxes) and torch.equal(areas, w_areas)):
                raise AssertionError(f'{what}: boxes or areas differ from the plain version')
            pad = ms_.unpack_bits(bits, 8 * bits.shape[-1])[..., cw:]
            if bool(pad.any()):
                raise AssertionError(f'{what}: a bit past the frame is set')
            if active is not None and bool(bits[~active].any() or boxes[~active].any()
                                           or areas[~active].any()):
                raise AssertionError(f'{what}: a gated slot is not exactly zero')
            if float(areas[m - 1]) != 0 or bool(boxes[m - 1].any()):
                raise AssertionError(f'{what}: the empty mask has a box or an area')
            flipped += n_diff
            print(f'[kernel] {what}: {n_diff} of {m * ch * cw} pixels differ (all within the '
                  f'zero band), boxes and areas belong to the bits; areas up to '
                  f'{float(areas.max()):.0f}')
            del logits, bits, got_mask, diff
            torch.cuda.empty_cache()

    # time the main path's two calls a tile, bf16 logits, all slots active
    def times(m, frame):
        ch, cw = frame
        logits, fr = _resize_case(rng, device, torch.bfloat16, m, 256, frame, True)
        ms = cuda_ms(lambda: ms_.mask_stats_fused(logits, fr), 50)
        copies = cold_copies(logits)
        ms_cold = cuda_ms(rotating(lambda x: ms_.mask_stats_fused(x, fr), copies), 50)
        del copies
        plain_ms = cuda_ms(lambda: ms_.mask_stats_plain(logits, fr.m_h, fr.m_wt, ch, cw), 3,
                           warmup=1)
        # the logits read once, the band forms once; bits, boxes and areas
        # written once; the non-zero taps, on the f32 units
        nbytes = logits.numel() * 2 + (ch + cw) * 20 + m * (ch * ((cw + 7) // 8) + 20)
        bound, by = bound_ms(nbytes, _band_flops(fr, torch.float32, m, 256), 'f32')
        dense_ms = m * 2.0 * (ch * 256 * 256 + ch * 256 * cw) / PEAK_FLOPS['f32'] * 1e3
        print(f'[kernel] mask_stats bf16 logits M={m} S=256 frame {ch}x{cw}: kernel {ms:.4f} ms '
              f'warm, {ms_cold:.4f} ms cold, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; '
              f'dense float32 products would be {dense_ms:.4f} ms at the f32 peak); no single '
              f'PyTorch call computes it (CUDA events, 50 calls; warm: one copy of the '
              f'{logits.numel() * 2 / 1e6:.1f} MB of logits; cold: copies in turns, over '
              f'{COLD_BYTES / 1e6:.0f} MB)')
        torch.cuda.empty_cache()
        return {'ms': ms, 'ms_cold': ms_cold, 'plain_ms': plain_ms, 'bound_ms': bound,
                'bound_by': by, 'library_ms': None}
    return {'name': 'mask_stats_fused', 'route': 'cuda',
            'source': 'regda_tpu_torch/csrc/mask_stats.cu',
            'replaces': 'regda_tpu/models/sam/pallas_stats.py:148',
            'max_abs_err': float(flipped), 'pixels_in_zero_band_that_differ': flipped,
            **times(256, (512, 512)), 'frame_343_m1024': times(1024, (343, 343))}


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

    # the fast decode (two-way and mask-head kernels on the card) against the
    # same call on the CPU (plain versions) and against the stock decode on
    # the card, blocked masks through `masks_from_blocked`
    from regda_tpu_torch.ops.kernels.upscale import masks_from_blocked
    emb = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 8, 8, 256))
                           .astype(np.float32))
    with torch.inference_mode():
        model.cpu()
        want = model.decode_points_fast(emb, points, labels, blocked_masks=True)
        model.to(device)
        dev_args = (emb.to(device), points.to(device), labels.to(device))
        got = model.decode_points_fast(*dev_args, blocked_masks=True)
        stock = model.decode_points(*dev_args)
    for name, g, w in zip(('masks', 'iou'), got, want):
        err = _assert_close(f'vit_t decode_points_fast {name} card vs CPU', g.cpu(), w,
                            **SAM_CHECK_TOL)
        print(f'[check] vit_t decode_points_fast f32 {name} {tuple(w.shape)}, card vs CPU: '
              f'max abs err {err:.3g}')
    for name, g, w in zip(('masks', 'iou'), (masks_from_blocked(got[0], 8, 8), got[1]), stock):
        err = _assert_close(f'vit_t decode_points_fast vs decode_points {name}', g, w,
                            **SAM_CHECK_TOL)
        print(f'[check] vit_t decode_points_fast vs decode_points on the card, f32 {name}: '
              f'max abs err {err:.3g}')


def _crop_scores(gen, tile) -> dict:
    """Predicted IoU, stability score and logit scale (median |low-res logit|)
    of every candidate of the full-image crop, (points, 3) numpy arrays, with
    no gate and no filter."""
    import torch
    h, w = tile.shape[:2]
    out = {'iou': [], 'stability': [], 'logit_scale': []}
    gate, gen.iou_gate = gen.iou_gate, False
    with torch.inference_mode():
        batchable, (nh, nw) = gen._preprocess(tile)
        embedding = gen._encode(torch.from_numpy(batchable).to(gen.device))
        pts, valid = gen._points(0, nh, nw)
        for chunk in pts.split(gen.points_per_batch):
            masks, iou, stab = gen._decode_chunk(embedding, chunk, (nh, nw, h, w))
            p, m3 = iou.shape
            out['iou'].append(iou)
            out['stability'].append(stab)
            out['logit_scale'].append(masks.reshape(p, m3, -1).float().abs().median(-1).values)
        n = int(valid.sum())
    gen.iou_gate = gate
    return {k: torch.cat(v)[:n].cpu().numpy() for k, v in out.items()}


def _calibrate(gen, tile) -> tuple[float, float, float]:
    """Thresholds from the run's own score distribution, for random weights
    (the published 0.88 / 0.95 at offset 1.0 pass nothing there): the median
    predicted IoU of the full-image crop's candidates, the median logit scale
    of those that pass it as the stability offset, and their median stability
    at that offset. Sets them on the generator."""
    import numpy as np
    scores = _crop_scores(gen, tile)
    t_iou = float(np.median(scores['iou']))
    passing = scores['iou'] > t_iou
    gen.stability_score_offset = float(np.median(scores['logit_scale'][passing]))
    t_st = float(np.median(_crop_scores(gen, tile)['stability'][passing]))
    gen.pred_iou_thresh, gen.stability_score_thresh = t_iou, t_st
    return t_iou, t_st, gen.stability_score_offset


def check_regions(device) -> int:
    """Small-size region generation, card against CPU: a vit_t f32 generator
    (128^2 model frame, 96^2 tiles, 8 x 8 points, one crop layer). The three
    calls on the card must give the maps of the same calls on the CPU. Then
    one run with interleaved masks, which goes through the interleaved
    stability entry; returns that run's launches of it."""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import sam_regions_entry
    from regda_tpu_torch.ops.kernels import stability as st

    # on random weights every candidate's mask spans its crop, all boxes are
    # the crop's, and NMS at the reference's 0.7 keeps one region a crop. At
    # 1.0 it suppresses nothing: every selected mask is painted, and the
    # maps check many masks' bits (the NMS itself is host numpy, held to the
    # JAX package's by the CPU tests)
    kw = dict(vit_config='vit_t', img_size=128, tiles=3, tile=96, seed=9, dtype=torch.float32,
              points_per_side=8, points_per_batch=32, box_nms_thresh=1.0,
              crop_nms_thresh=1.0)
    cpu, tiles = sam_regions_entry('cpu', **kw)
    t_iou, t_st, off = _calibrate(cpu, tiles[0])
    kw.update(pred_iou_thresh=t_iou, stability_score_thresh=t_st, stability_score_offset=off)
    card = sam_regions_entry(device, **kw)[0]
    print(f'[check] vit_t region generator: thresholds from crop 0 of tile 0 on the CPU: IoU > '
          f'{t_iou:.4f}, stability >= {t_st:.4f} at offset {off:.4f}')
    calls = {
        'generate_regions': lambda g: [g.generate_regions(t, area_threshold=32) for t in tiles],
        'generate_regions_batch': lambda g: g.generate_regions_batch(tiles, area_threshold=32),
        'generate_regions_stream': lambda g: [m for maps in g.generate_regions_stream(
            [tiles[:1], tiles[1:], tiles[::-1]], area_threshold=32) for m in maps]}
    for name, call in calls.items():
        want, got = call(cpu), call(card)
        regions = [len(np.unique(m)) - 1 for m in want]
        if max(regions) < 2:
            raise AssertionError(f'{name}: the CPU maps hold {regions} regions; the check is empty')
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != np.int32 or g.shape != (96, 96) or not np.array_equal(g, w):
                raise AssertionError(f'{name}: map {i} on the card differs from the CPU\'s on '
                                     f'{int((g != w).sum())} of {w.size} pixels')
        print(f'[check] vit_t {name} f32, card vs CPU: {len(want)} maps equal '
              f'({regions} regions)')
    want = calls['generate_regions_batch'](card)
    inter = sam_regions_entry(device, blocked_masks=False, **kw)[0]
    st.launches_fused = 0
    got = calls['generate_regions_batch'](inter)
    launches, chunks = st.launches_fused, inter.counts['chunks_live']
    if launches != chunks or launches == 0:
        raise AssertionError(f'interleaved masks: {launches} launches of the interleaved '
                             f'stability entry in {chunks} live chunks')
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError('interleaved masks give other maps than blocked masks')
    print(f'[check] vit_t generate_regions_batch with blocked_masks=False: maps equal the '
          f'blocked ones; {launches} launches of the interleaved stability entry, one per '
          f'live chunk')
    return launches


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


def _grid_prompts(device, count: int, img_size: int = 1024):
    """The first `count` prompts of the 32 x 32 everything-mode grid."""
    import numpy as np
    import torch
    from regda_tpu_torch.models.sam.auto import build_point_grid
    grid = np.ascontiguousarray(build_point_grid(32)[:count] * img_size, np.float32)
    return (torch.from_numpy(grid[:, None, :]).to(device),
            torch.ones((count, 1), dtype=torch.float32, device=device))


def phase_sam_fast(device, model, emb):
    """One fast decode chunk at 64 and at 256 prompts, as everything-mode
    calls it (bf16 masks, blocked), checked against the stock decode of the
    same prompts; then the IoU gate. Two wrapper calls of each kernel."""
    import torch

    fast = dict(mask_dtype=torch.bfloat16, blocked_masks=True)
    for count in (64, 256):
        points, labels = _grid_prompts(device, count)
        with torch.inference_mode():
            masks, iou = model.decode_points_fast(emb[:1], points, labels, **fast)
            torch.cuda.synchronize()
        if tuple(masks.shape) != (count, 48, 4096) or masks.dtype != torch.bfloat16:
            raise AssertionError(f'fast masks {masks.dtype} {tuple(masks.shape)}')
        if tuple(iou.shape) != (count, 3) or iou.dtype != torch.float32:
            raise AssertionError(f'fast iou {iou.dtype} {tuple(iou.shape)}')
        if not bool(torch.isfinite(masks.float()).all() and torch.isfinite(iou).all()):
            raise AssertionError('fast decode output is not finite')
    return masks, iou


def sam_fast_checks_and_timings(device, model, emb, tw_record: dict) -> None:
    """After the launch counts are read: the fast chunk against the stock one
    in bf16, the gate, ms per chunk of both paths, and a profile of one chunk
    of 64 and one of 256 prompts. Each profile must show as many two-way
    kernels in one chunk as the C entry counted for each call of the main
    path (`tw_record`)."""
    import torch
    from regda_tpu_torch.ops.kernels.upscale import masks_from_blocked

    fast = dict(mask_dtype=torch.bfloat16, blocked_masks=True)
    points, labels = _grid_prompts(device, 64)
    with torch.inference_mode():
        masks, iou = model.decode_points_fast(emb[:1], points, labels, **fast)
        stock_masks, stock_iou = model.decode_points(emb[:1], points, labels)
        # both paths compute in bf16 and round at different places
        err_m = _within_bf16_steps('fast vs stock masks, bf16',
                                   masks_from_blocked(masks, 64, 64), stock_masks,
                                   FAST_VS_STOCK_BF16_STEPS)
        err_i = _within_bf16_steps('fast vs stock iou, bf16', iou, stock_iou,
                                   FAST_VS_STOCK_BF16_STEPS)
        print(f'[sam] decode_points_fast vs decode_points, 64 prompts bf16: masks max abs err '
              f'{err_m:.3g} (max |value| {float(stock_masks.abs().max()):.3g}), iou {err_i:.3g} '
              f'(max |value| {float(stock_iou.abs().max()):.3g})')
        # the gate at the median of the prompts' best IoU: about half pass
        thresh = float(iou.max(dim=1).values.median())
        active = (iou > thresh).any(dim=1)
        gated, gated_iou = model.decode_points_fast(emb[:1], points, labels,
                                                    iou_gate_thresh=thresh, **fast)
        torch.cuda.synchronize()
        if not (0 < int(active.sum()) < 64):
            raise AssertionError(f'the gate passed {int(active.sum())} of 64 prompts')
        if not (torch.equal(gated_iou, iou) and torch.equal(gated[active], masks[active])
                and bool((gated[~active] == 0).all())):
            raise AssertionError('gated masks differ from the ungated ones on active '
                                 'prompts or are not zero on the rest')
        print(f'[sam] IoU gate at {thresh:.4f}: {int(active.sum())} of 64 prompts active, '
              f'their masks equal the ungated ones, the rest are exactly zero')

        for count in (64, 256):
            points, labels = _grid_prompts(device, count)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fast_ms = cuda_ms(lambda: model.decode_points_fast(emb[:1], points, labels, **fast),
                              iters=10, warmup=2)
            fast_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            stock_ms = cuda_ms(lambda: model.decode_points(emb[:1], points, labels),
                               iters=5, warmup=1)
            stock_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f'[sam] decode chunk of {count} prompts, bf16: decode_points_fast '
                  f'{fast_ms:.3f} ms (peak {fast_peak:.2f} GiB), decode_points {stock_ms:.3f} ms '
                  f'(peak {stock_peak:.2f} GiB)')

    for count in (64, 256):
        _fast_chunk_profile(model, emb, count, fast, tw_record)


# the kernels of one two-way call, as the profiler names them
TWO_WAY_TAGS = ('prep_kernel', 'mid_kernel', 'final_kernel', 'pass_wgmma_kernel',
                'pass_simt_kernel')


def _fast_chunk_profile(model, emb, count: int, fast: dict, tw_record: dict) -> None:
    """One fast chunk of `count` prompts under torch.profiler (device tracing
    only; the second profile counts, the first pays for starting the tracer):
    device time by kind, idle share, and the two-way kernels by launch, whose
    number must be what the C entry counted per call of the main path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    points, labels = _grid_prompts(emb.device, count)
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.decode_points_fast(emb[:1], points, labels, **fast)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {'two_way': 0.0, 'upscale': 0.0, 'gemm': 0.0, 'other': 0.0}
    detail = {}
    device_events = two_way_events = 0
    first_us, last_us = math.inf, -math.inf
    for ev in prof.events():
        if str(ev.device_type).endswith('CUDA'):
            device_events += 1
            first_us = min(first_us, ev.time_range.start)
            last_us = max(last_us, ev.time_range.end)
            name = ev.name.lower()
            two_way = [t for t in TWO_WAY_TAGS if t in name]
            kind = ('two_way' if two_way else 'upscale' if 'upscale_' in name else
                    'gemm' if any(t in name for t in ('gemm', 'nvjet', 'cutlass', 'xmma'))
                    else 'other')
            kinds[kind] += ev.device_time / 1e3
            if two_way:
                two_way_events += 1
                key = _kernel_name(ev.name)
                detail[key] = detail.get(key, 0.0) + ev.device_time / 1e3
    total = sum(kinds.values())
    if total <= 0:
        print(f'[sam] one fast chunk of {count} under torch.profiler: not measured (no device '
              f'time)')
        return
    per_call, rest = divmod(tw_record['cuda_launches'], tw_record['launches'])
    if rest or two_way_events != per_call:
        raise AssertionError(f'the profile shows {two_way_events} two-way kernels in one chunk; '
                             f'the C entry counted {tw_record["cuda_launches"]} in '
                             f'{tw_record["launches"]} calls of the main path')
    # busy and idle from this one profiled call: the device's span runs from
    # its first kernel's start to its last kernel's end
    span_ms = (last_us - first_us) / 1e3
    print(f'[sam] one fast chunk of {count} under torch.profiler: {total:.3f} ms in '
          f'{device_events} kernels and copies ({two_way_events} of them two_way\'s, as its '
          f'C entry counted): '
          + ', '.join(f'{k} {v:.3f} ms ({100 * v / total:.1f} %)' for k, v in kinds.items())
          + f'; device idle {100 * (1 - total / span_ms):.1f} % of the {span_ms:.3f} ms from '
          f'its first kernel\'s start to its last kernel\'s end (the profiled call took '
          f'{wall_ms:.3f} ms of wall time); two_way by launch: '
          + ', '.join(f'{k} {v:.4f}' for k, v in detail.items()))


def _regions_profile(gen, tile) -> str:
    """Device time of one tile's region map by kind of kernel, and the idle
    share of the device between its first kernel's start and its last one's
    end, from torch.profiler (device tracing only; the second profile counts,
    the first pays for starting the tracer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gen.generate_regions_batch([tile])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    tags = {'rel_attention': ('rel_attn',), 'layernorm': ('layernorm_kernel',),
            'two_way': TWO_WAY_TAGS,
            'upscale': ('upscale_',), 'stability': ('stability_kernel',),
            'mask_stats': ('mask_stats_kernel',),
            'gemm': ('gemm', 'nvjet', 'cutlass', 'xmma')}
    kinds = {k: 0.0 for k in (*tags, 'other')}
    first_us, last_us, events = math.inf, -math.inf, 0
    for ev in prof.events():
        if str(ev.device_type).endswith('CUDA'):
            events += 1
            first_us = min(first_us, ev.time_range.start)
            last_us = max(last_us, ev.time_range.end)
            name = ev.name.lower()
            kind = next((k for k, ts in tags.items() if any(t in name for t in ts)), 'other')
            kinds[kind] += ev.device_time / 1e3
    total = sum(kinds.values())
    if total <= 0:
        return 'not measured (the profiler reported no device time)'
    span_ms = (last_us - first_us) / 1e3
    return (f'{total:.2f} ms of device time in {events} kernels and copies: '
            + ', '.join(f'{k} {v:.3f} ms ({100 * v / total:.1f} %)' for k, v in kinds.items())
            + f'; device idle {100 * (1 - total / span_ms):.1f} % of the {span_ms:.2f} ms from its '
            f'first kernel\'s start to its last kernel\'s end (the profiled call took '
            f'{wall_ms:.2f} ms of wall time)')


def regions_many_masks(gen, tiles) -> None:
    """The full-width generator with both NMS thresholds at 1.0, where nothing
    is suppressed and every selected mask off the crop edge is painted:
    hundreds of regions a tile go through slot selection, the mask statistics,
    the ids and the paint. `generate_regions_batch` (one 5-crop encode a tile,
    budget skip) and `generate_regions` (crop by crop) must give the map of
    `generate()` + `regions_from_anns`, whose boxes, areas, NMS bookkeeping
    and paint run on the host in numpy on the downloaded mask bits. The
    annotation path resizes its crop on the host; here it is given the card's
    preprocess, so that all three feed the encoder the same bits: in bf16 with
    thresholds at the medians of the scores, an input one rounding apart would
    move candidates across a threshold."""
    import numpy as np
    import torch
    from regda_tpu_torch.models.sam.auto import (SamRegionGenerator, preprocess_shape,
                                                 regions_from_anns)
    from regda_tpu_torch.ops.lrh import MAX_REGIONS

    class AnnPath(SamRegionGenerator):
        def _preprocess(self, crop_np):
            crop = torch.from_numpy(np.ascontiguousarray(crop_np)).to(self.device)
            return (self._preprocess_device(crop).float().cpu().numpy(),
                    preprocess_shape(*crop_np.shape[:2], self.img_size))

    kw = dict(points_per_side=gen.points_per_side, points_per_batch=gen.points_per_batch,
              pred_iou_thresh=gen.pred_iou_thresh,
              stability_score_thresh=gen.stability_score_thresh,
              stability_score_offset=gen.stability_score_offset, crop_n_layers=gen.crop_n_layers,
              crop_n_points_downscale_factor=gen.crop_n_points_downscale_factor,
              mask_budget=gen.mask_budget, box_nms_thresh=1.0, crop_nms_thresh=1.0)
    open_gen, ann_path = SamRegionGenerator(gen.model, **kw), AnnPath(gen.model, **kw)
    t0 = time.perf_counter()
    maps = open_gen.generate_regions_batch(tiles)
    batch_s = time.perf_counter() - t0
    regions = [len(np.unique(m)) - (0 in m) for m in maps]
    if min(regions) < 2:
        raise AssertionError(f'NMS off: a tile has fewer than two regions: {regions}')
    for i, (tile, got) in enumerate(zip(tiles, maps)):
        # the region generator keeps the first MAX_REGIONS - 1 of the keep order
        anns = ann_path.generate(tile)[:MAX_REGIONS - 1]
        want = regions_from_anns(anns, tile.shape[:2])
        single = open_gen.generate_regions(tile)
        for name, m in (('generate_regions_batch', got), ('generate_regions', single)):
            if m.dtype != np.int32 or m.max() >= MAX_REGIONS or not np.array_equal(m, want):
                raise AssertionError(
                    f'NMS off, tile {i}: {name} differs from generate() + regions_from_anns on '
                    f'{int((m != want).sum())} of {want.size} pixels ({len(anns)} annotations)')
    print(f'[regions] NMS off (both thresholds 1.0), {len(tiles)} tiles: regions per tile '
          f'{regions}, covering {100 * float(np.mean([(m > 0).mean() for m in maps])):.1f} % of '
          f'the pixels; generate_regions_batch ({batch_s * 1e3:.1f} ms) and generate_regions '
          f'equal generate() + regions_from_anns (boxes, areas and paint on the host) on every '
          f'tile')


def phase_regions(device, **entry_kwargs) -> dict:
    """Phase 5: everything-mode region maps at full width (`entry_kwargs`: a
    smaller model for a rehearsal). Returns the launch counts of one
    `generate_regions_batch` over the 8 tiles."""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import sam_regions_entry
    from regda_tpu_torch.ops.kernels import layernorm as ln
    from regda_tpu_torch.ops.kernels import mask_stats as ms_
    from regda_tpu_torch.ops.kernels import rel_attention as ra
    from regda_tpu_torch.ops.kernels import stability as st
    from regda_tpu_torch.ops.kernels import two_way as tw
    from regda_tpu_torch.ops.kernels import upscale as up
    from regda_tpu_torch.ops.lrh import MAX_REGIONS

    gen, tiles = sam_regions_entry(device, timing=True, **entry_kwargs)
    n = len(tiles)
    t_iou, t_st, off = _calibrate(gen, tiles[0])
    print(f'[regions] SAM {entry_kwargs.get("vit_config", "vit_b")} {str(gen.compute_dtype)[6:]}, '
          f'{n} tiles of 512^2, {gen.points_per_side}^2 points, crop_n_layers='
          f'{gen.crop_n_layers}, {gen.points_per_batch} prompts a chunk, budget '
          f'{gen.mask_budget}, exact stability, IoU gate, blocked masks. Random '
          f'weights: the thresholds are the medians of crop 0 of tile 0, IoU > {t_iou:.4f} and '
          f'stability >= {t_st:.3g} at offset {off:.4f}; they stand in for 0.90 / 0.95 at '
          f'offset 1.0, which pass nothing on random weights')
    gen.generate_regions_batch(tiles[:1])          # first use: caches, band forms, allocator
    torch.cuda.synchronize()
    gen.reset_report()
    torch.cuda.reset_peak_memory_stats()

    # the main path: one batch call, the launch counts around it
    ln.launches = ra.launches = tw.launches = tw.cuda_launches = up.launches = 0
    st.launches_blocked = st.launches_fused = ms_.launches = 0
    t0 = time.perf_counter()
    maps = gen.generate_regions_batch(tiles)
    batch_s = time.perf_counter() - t0
    counts = {'layernorm': ln.launches, 'rel_attention': ra.launches, 'two_way': tw.launches,
              'two_way_cuda': tw.cuda_launches, 'upscale': up.launches,
              'stability_blocked': st.launches_blocked, 'stability_fused': st.launches_fused,
              'mask_stats': ms_.launches}
    rep = gen.report()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # per tile: 4 chunks on crop 0 and 1 on each of the 4 layer-1 crops, less
    # what the budget skip saved; one stability, two-way and mask-head call per
    # live chunk; the mask statistics once per group of crops of one size
    # (crop 0; the four layer-1 crops together); one encode of the 5 crops
    live, skipped = rep['chunks_live'], rep['chunks_skipped']
    want = {'layernorm': 24 * n, 'rel_attention': 12 * n, 'two_way': live, 'upscale': live,
            'stability_blocked': live, 'stability_fused': 0, 'mask_stats': 2 * n}
    if live + skipped != 8 * n:
        raise AssertionError(f'{live} live + {skipped} skipped chunks != {8 * n}')
    for key, val in want.items():
        if counts[key] != val:
            raise AssertionError(f'regions: {key} launched {counts[key]} times, expected {val} '
                                 f'(all counts {counts}, {live} live chunks)')
    regions = [len(np.unique(m)) - (0 in m) for m in maps]
    for m in maps:
        if m.dtype != np.int32 or m.shape != (512, 512):
            raise AssertionError(f'region map {m.dtype} {m.shape}')
        if m.min() < 0 or m.max() >= MAX_REGIONS:
            raise AssertionError(f'region ids span {m.min()}..{m.max()}')
    if max(regions) < 1:
        raise AssertionError(f'every region map is empty: {regions}')
    print(f'[regions] generate_regions_batch({n} tiles): {batch_s * 1e3:.1f} ms, '
          f'{n / batch_s:.3f} tiles/s; regions per tile {regions}, covering '
          f'{100 * float(np.mean([(m > 0).mean() for m in maps])):.1f} % of the pixels; peak '
          f'{peak:.2f} GiB')
    print(f'[regions] launches in that call: {counts}; chunks: {live} live, {skipped} skipped '
          f'by the budget skip')
    print(f'[regions] candidates {rep["candidates"]}: pass IoU {rep["pass_iou"]}, and stability '
          f'{rep["pass_iou_and_stability"]}, selected within the budget {rep["selected"]}, off '
          f'the crop edge {rep["off_crop_edge"]}, after per-crop NMS {rep["per_crop_nms"]}, after '
          f'cross-crop NMS {rep["cross_crop_nms"]}, painted (area >= 1024) {rep["painted"]}')
    print('[regions] ms per tile by stage (device timeline between CUDA events, idle gaps '
          'included; nms on the host clock): '
          + ', '.join(f'{k} {v / n:.3f}' for k, v in rep['stage_ms'].items()))

    # the stream: 3 batches in flight; its maps are the batch call's. Both
    # calls are host-bound and vary with the host, so each is read twice, in turns
    batches = [tiles, tiles[::-1], tiles]
    reads = {'stream': [], 'batch': [batch_s / n]}
    for turn in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamed = list(gen.generate_regions_stream(iter(batches)))
        reads['stream'].append((time.perf_counter() - t0) / (3 * n))
        for got, order in zip(streamed, (1, -1, 1)):
            if not all(np.array_equal(g, w) for g, w in zip(got, maps[::order])):
                raise AssertionError('a streamed map differs from the batch call\'s')
        if turn == 0:
            t0 = time.perf_counter()
            gen.generate_regions_batch(tiles)
            reads['batch'].append((time.perf_counter() - t0) / n)
    print(f'[regions] generate_regions_stream(3 batches of {n}, depth 3): '
          + ' and '.join(f'{1 / t:.3f}' for t in reads['stream'])
          + ' tiles/s; maps equal the batch call\'s; generate_regions_batch read in turns with '
          'it: ' + ' and '.join(f'{1 / t:.3f}' for t in reads['batch']) + ' tiles/s')
    print(f'[regions] one tile under torch.profiler: {_regions_profile(gen, tiles[0])}')
    regions_many_masks(gen, tiles)
    return counts


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description='Smoke test of regda_tpu_torch on one GPU.')
    parser.add_argument('--parent', default=None,
                        help='root of another checkout (e.g. the parent commit, unpacked): '
                             'its mask-head, stability, mask-statistics and histogram '
                             'kernels are timed beside these')
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a GPU',
              file=sys.stderr)
        return 1
    import regda_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from regda_tpu_torch.ops.kernels import layernorm as ln
    from regda_tpu_torch.ops.kernels import rel_attention as ra
    from regda_tpu_torch.ops.kernels import segment_hist as sh
    from regda_tpu_torch.ops.kernels import two_way as tw
    from regda_tpu_torch.ops.kernels import upscale as up

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = 'cuda'
    card = card_line()
    print(f'[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    build_kernels()
    record = phase_kernel(device)
    ln_record = phase_layernorm(device)
    attn_record = phase_attention(device)
    up_record = phase_upscale(device)
    tw_record = phase_two_way(device)
    stb_record, stf_record = phase_stability(device)
    stats_record = phase_mask_stats(device)
    if args.parent:
        parent = parent_times(args.parent)
        for rec, prefix in ((up_record, 'upscale '), (stb_record, 'stability blocked '),
                            (stf_record, 'stability fused '), (stats_record, 'mask_stats '),
                            (record, 'segment_hist ')):
            rec['parent_ms'] = {k: v for k, v in parent.items() if k.startswith(prefix)}
    phase_check(device)
    # the interleaved stability entry's path: the small generator run with
    # blocked_masks=False (the full-width path below takes the blocked entry)
    stf_record['launches'] = check_regions(device)

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
    model, emb = sam[0], sam[4]
    tw.launches = tw.cuda_launches = up.launches = 0
    phase_sam_fast(device, model, emb)
    tw_record['launches'], up_record['launches'] = tw.launches, up.launches
    # the kernels that the C entry queued in those calls, as it counted them
    tw_record['cuda_launches'] = tw.cuda_launches
    if (tw.launches, up.launches) != (2, 2):
        raise AssertionError(f'two fast decode chunks called two_way {tw.launches} times and '
                             f'upscale {up.launches} times (expected 1 + 1 per chunk)')
    sam_timings(*sam)   # these launch more, after the counts are read
    sam_fast_checks_and_timings(device, model, emb, tw_record)
    del sam, model, emb
    torch.cuda.empty_cache()

    counts = phase_regions(device)   # zeroes every count before its batch call
    stb_record['launches'] = counts['stability_blocked']
    stats_record['launches'] = counts['mask_stats']
    for rec, key in ((ln_record, 'layernorm'), (attn_record, 'rel_attention'),
                     (tw_record, 'two_way'), (up_record, 'upscale')):
        rec['launches_regions'] = counts[key]

    # one record per pallas_call: the blocked entry replaces both blocked TPU
    # kernels, so its record stands for each
    stb_v1 = {**stb_record, 'replaces': 'regda_tpu/models/sam/pallas_stability.py:303'}
    print(json.dumps({'kernels': [record, ln_record, attn_record, tw_record, up_record,
                                  stb_record, stb_v1, stf_record, stats_record]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
