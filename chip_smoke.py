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
              eval forward (f32, rtol/atol 1e-4), the resnet18 eval forward
              at output strides 8 and 32 (f32, rtol/atol 1e-4) and a
              ResNet-101 output-stride-8 eval forward of 2 x 512^2 (shapes,
              finiteness, ms), a resnet18 `SegInferencer`
              (folded, fused; slide + TTA on a 96x80 image, tile 64, stride
              32; f32, rtol 1e-4, atol 1e-5), one resnet18 stage-2
              step with dropout off (losses rtol 1e-4), `homogenize` at
              8x512^2, kernel on the card against plain on the CPU (equal),
              the SAM encoder at ViT-B width and depth on a 256^2 image, a
              whole `Sam.forward` at vit_t, and `Sam.decode_points_fast` at
              vit_t against the same call on the CPU and against
              `Sam.decode_points` on the card (f32, SAM_CHECK_TOL below);
              a vit_t f32 region generator (96^2 tiles): `generate_regions`,
              `generate_regions_batch` and `generate_regions_stream` on the
              card give the CPU's maps, and a run with interleaved masks
              gives the blocked ones through the interleaved stability entry;
              a resnet18 stage-1 step (both align settings; 8 crops a domain
              at 64^2: losses rtol 1e-4, parameters atol 1e-5, `ppm.0.2`
              1e-4) and a prototype pass (sums rtol/atol 1e-4, counts equal);
              a resnet18 stage-3 step with lt='uvem' and bct, and with
              lt='ghm' (the same sizes and tolerances; prototypes, both
              class-balance EMAs and the GHM histogram too).
  2. serve    `serve_entry()`: a `SegInferencer` over ResNet-101 DeepLabv2
              (C = 6) with seeded weights and BN statistics, bf16 compute with
              f32 weights, BN folded into the convs and both PPM heads'
              feature conv fused, beside the stock forward of the same weights
              (`fold_bn=False`). (a) `predict_probs(slide=False)` on 16 tiles
              of 512^2: shape, finiteness, probabilities summing to 1 within
              1e-2, the two forwards within FOLDED_VS_STOCK_BF16_STEPS, tiles/s
              of both in turns, and a torch.profiler split of one batch of
              each by kind of kernel: none of batch-norm in the served one.
              (b) one 1024^2 scene by slide (512, stride 256) + TTA, 72 tile
              forwards: `predict_labels` equal to the argmax of
              `predict_probs` wherever the top two differ by more than 1e-3,
              scenes/s, peak memory. (c) `predict_multiscale` on 2 x 512^2 at
              the six default scales: shape, finiteness, ms.
  3. train    `stage2_steps(3)`: ResNet-101, C = 6, 512^2 crops, batch 8 per
              domain, f32, with align_domain, refine_label and sam_refine.
              Every loss finite, step count 3, and the segment-histogram
              kernel launched at least once per step. Then `stage3_steps(3)`
              at the same shape (lt='uvem', refine_label and sam_refine on,
              seeded soft pseudo-labels): every loss finite, exactly one
              histogram launch a step; ms/step (steps 1-2) and peak of each.
              Then remat (`phase_remat`): `stage2_steps(3, remat=True)` and
              `stage3_steps(3, remat=True)` from the plain runs' seeds:
              losses against the plain runs' (step 1 rtol 1e-6, later
              REMAT_LATER_RTOL), every BN running statistic moved by step 1
              and within REMAT_BN_ATOL of the plain step 1's, within
              REMAT_BN_TOL after 3 steps, exactly one histogram launch a
              step, ms/step and peak beside the plain runs'. (Where the
              memory goes, with and without remat: `python -m
              regda_tpu_torch.tools.remat_memory`.)
  3b. parallel `phase_parallel`: the same stage-2 and stage-3 steps inside a
              one-rank NCCL process group (the losses' and gradients'
              collectives run, over one rank; each BatchNorm takes the
              plain cuDNN path, its one rank's statistics being the global
              ones), held to the plain runs' losses, BN statistics,
              parameters, prototypes and EMAs (PARALLEL_* below), one
              histogram launch a step, ms/step beside the plain step's;
              then stage 2 again with every BatchNorm forced onto the
              formula of N > 1 ranks (`_global_forward`: all-reduced sums),
              its ms/step and peak beside the plain step's, step 1 held at
              TWO_RANK_RTOL. `phase_parallel_two`: two ranks sharing the
              card over gloo, two stage-2 steps of 4 + 4 rows a domain,
              step 1 against the plain step 1 of 8 (TWO_RANK_RTOL); where
              gloo refuses a collective on CUDA tensors (a one-element
              probe), it says so and the phase goes on; any other fault
              fails. Then `dryrun_data_parallel(2, 'cuda', backend='gloo')`
              on the same two ranks.
              After phase 5, `phase_data_mesh`: `seg_everything --data-mesh
              2` (two processes on the card) over 8 tiles of 512^2 with ViT-B
              writes the one-process run's maps exactly.
  8.  periphery `phase_periphery` (after phase 5 too): the mixes, whitening,
              GDP and alignment losses, EMA, TransNorm, the discriminators,
              DeeplabV2MMD and SpixelNet at the recipe's widths on the card
              against the CPU (PERIPHERY_TOL below; the mixes and the EMA
              exactly).
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
  6. stages   `phase_stages()`: the five stage CLIs in this process through
              their `main(argv)`, on `configs/st/regda/full_smoke.py`'s
              synthetic tree written to a fresh temporary directory
              (REGDA_FULL_ROOT; ResNet-101, C = 6, 512^2 tiles, batch 8 per
              domain, 32 train / 8 val / 8 test tiles a domain, region maps),
              f32 with TF32 off, STAGE_STEPS steps a stage: train_src
              --align-domain 1; init_prototypes on its `_best.pth`;
              train_align_reg --align-domain 1 --refine-label 1 --sam-refine
              --percent 0.5; eval --test 1 on stage 2's `_best.pth`;
              train_ssl_reg --gen 1 --refine-label 1 --sam-refine --percent
              0.5 --lt uvem from stage 2's `_best.pth` and
              `prototypes_best.npy`; eval --test 1 on stage 3's `_best.pth`.
              Every loss finite, the checkpoints (`_curr`, `_best`, `_state` +
              `.json`, and `prototypes_best.npy` for stages 1-2) written,
              both `_best.pth` loading strictly into a fresh CPU model,
              prototype counts > 0 for every class in the source labels, the
              32 pseudo-label maps (512, 512, 6) float32 summing to 1 within
              1e-3 (read before the CLI removes them) and their directory
              gone at the end, exactly one segment-histogram launch per
              stage-2 and per stage-3 step, both test mIoUs finite in [0, 1].
              Before stage 3, the classifiers of stage 2's `_best.pth` are
              multiplied by UVEM_LOGIT_SCALE, so that its pseudo-labels are
              confident enough for UVEM: every stage-3 step's target loss is
              above 0. The pseudo maps and the target labels are kept for
              phase 7.
              Printed on `[stages]` lines: ms/step through the loop (StepTimer
              EMA and mean of steps 2-6) beside phase 3's bare steps, the
              loader's decode path, pseudo generation's seconds and ms a
              tile, the prototype pass, the batch waits of each step, eval
              seconds per split and per tile, the checkpoint chain's seconds,
              each stage's peak memory.
  7. prep     `phase_prep()`: (a) `get_superpixels` with LSC and with SLIC
              on the card over PREP_TILES seeded 512^2 tiles, int32 maps, the
              boundary maps of PREP_CPU_TILES of them against a CPU run
              (PREP_BOUNDARY_AGREEMENT), ms a tile; (b) `analysis_pseudo_labels`
              over phase 6's 32 stage-3 pseudo maps, counts equal to a CPU
              run's, acc and diffi within 1e-5, the share of pixels used; (c)
              `check_sam_stability --device cuda --vit-config vit_b --tiles 2
              --auto-thresh --out <tmp>`: the report written, its flip rates
              and region counts, SAM's kernels launched; (d) `convert_potsdam`
              on a synthetic 6000^2 RGBIR scene and `convert_vaihingen` on a
              2000 x 2500 IRRG one: the tile count `tile_boxes` gives, three
              tiles decoded by PIL equal to their crops.
Launch counts are zeroed just before phases 2-3, again just before phase
3's stage-3 steps, just before each remat run and each of phase 3b's
group runs (and in each of its two ranks), just before the encode of
phase 4, again just before its fast decode, again just before phase 5's
batch call, again just before phase 6's stage-2 run and its stage-3 run,
and just before phase 7's stability check, and read just after each.
TF32 is off in every phase (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` both False): phases 2,
4 and 5 compute in bf16, and the others hold float32 as float32, as the JAX
train path does.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the card's name and power limit, and the line before that the
kernels' JSON record, one for each of the JAX package's nine `pallas_call`s
(the blocked stability entry stands for both blocked TPU kernels); the
histogram's record carries its launches in phase 3's stage-2 steps
(`launches`), in phase 3b's one-rank group (`launches_parallel_stage2`,
`launches_parallel_stage3`) and on each of its two ranks
(`launches_two_ranks`, where gloo ran), in phase 6's stage-2 and stage-3 CLI runs (`launches_stages`,
`launches_stage3`), in phase 3's bare stage-3 steps
(`launches_stage3_bare`) and in its remat steps (`launches_stage2_remat`,
`launches_stage3_remat`); the SAM kernels' records carry their launches in
phase 7's stability check (`launches_stability_check`). Without a
CUDA device the script exits non-zero at once and prints no result.

    python3 chip_smoke.py --parent DIR

also times the mask-head, stability, mask-statistics and histogram kernels
of the checkout at DIR (the parent commit, unpacked by `git archive`) beside
this checkout's, in turns, in phase 1 (the histogram through each side's own
wrapper, warm, cold, and cold in a CUDA graph).
"""

from __future__ import annotations

import contextlib
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
# the served forward (BN folded into the convs, whose cuDNN epilogue adds
# bias, residual and ReLU in float32 before one rounding; both heads' feature
# conv fused) against the stock forward (bf16 roundings after every conv, BN
# and add), both bf16 at full width: again one function rounded at different
# places throughout ~110 layers. Each lies ~9 steps from the float32 forward
# at 16x512^2 (NVIDIA H100 80GB HBM3, 700.00 W), ~7 at 2x128^2 on the CPU,
# so their difference can reach about twice that
FOLDED_VS_STOCK_BF16_STEPS = 20
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
    from regda_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        decode = pool.submit(native.available)   # the loader's host decode (g++)
        list(pool.map(_build.load_library, names))
    import shutil
    why = '' if decode.result() else f' (g++ at {shutil.which("g++")}; or no libpng)'
    print(f'[kernel] {", ".join(names)} built/loaded in {time.perf_counter() - t0:.2f} s; '
          f'native tile decode {"built" if decode.result() else "unavailable: Python path"}{why}')
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
    check_output_strides(device)

    # the serve path: SegInferencer (folded, fused) on the card vs the CPU
    import copy
    from regda_tpu_torch.entry import seed_bn_statistics
    from regda_tpu_torch.infer import SegInferencer
    generator = torch.Generator().manual_seed(9)
    model = build_deeplabv2('resnet18', 6, generator=generator)
    seed_bn_statistics(model, generator)
    image = torch.randn(1, 96, 80, 3, generator=generator).numpy()
    want = SegInferencer(model.eval(), 6, tile=64, stride=32).predict_probs(image, tta=True)
    inf = SegInferencer(copy.deepcopy(model).to(device), 6, tile=64, stride=32)
    got = inf.predict_probs(image, tta=True)
    err = _assert_close('SegInferencer slide + TTA card vs CPU', torch.from_numpy(got),
                        torch.from_numpy(want), rtol=1e-4, atol=1e-5)
    print(f'[check] resnet18 SegInferencer f32, folded + fused, slide 64/32 + TTA on 96x80, '
          f'card vs CPU: max abs err {err:.3g}')

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
    check_stage1(device)
    check_stage3(device)

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


def check_output_strides(device) -> None:
    """The eval forward at output strides 8 and 32: resnet18 on the card
    against the CPU (2x64^2, f32, rtol/atol 1e-4), then ResNet-101 at
    output stride 8 on 2x512^2 (shape, finiteness, ms)."""
    import torch
    from regda_tpu_torch.models import build_deeplabv2

    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(11))
    for output_stride in (8, 32):
        model = build_deeplabv2('resnet18', 6, output_stride=output_stride,
                                generator=torch.Generator().manual_seed(12)).eval()
        with torch.inference_mode():
            want = model(x)
            got = model.to(device)(x.to(device)).cpu()
        err = _assert_close(f'resnet18 OS {output_stride} eval forward card vs CPU', got, want,
                            rtol=1e-4, atol=1e-4)
        print(f'[check] resnet18 eval forward at output stride {output_stride}, 2x64^2 f32, '
              f'card vs CPU: max abs err {err:.3g}')
    model = build_deeplabv2('ResNet101', 6, output_stride=8,
                            generator=torch.Generator().manual_seed(13))
    model = model.to(device, memory_format=torch.channels_last).eval()
    x = torch.randn(2, 512, 512, 3, generator=torch.Generator().manual_seed(14)).to(device)
    with torch.inference_mode():
        probs = model(x)
        feat = model.features(x)
        ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
    if probs.shape != (2, 512, 512, 6) or feat.shape[-2:] != (64, 64):
        raise AssertionError(f'ResNet-101 OS 8: probs {tuple(probs.shape)}, '
                             f'features {tuple(feat.shape)}')
    if not torch.isfinite(probs).all():
        raise AssertionError('ResNet-101 OS 8 eval forward: non-finite probabilities')
    print(f'[check] ResNet-101 eval forward at output stride 8, 2x512^2 f32 (features '
          f'{tuple(feat.shape)}): {ms:.2f} ms a call')
    del model, x, probs, feat
    torch.cuda.empty_cache()


def check_stage1(device) -> None:
    """One resnet18 stage-1 step (dropout off) in both `align_domain`
    settings and one prototype-accumulation pass, card against CPU from the
    same weights, at the recipe's batch of 8 crops a domain (64^2): losses
    rtol 1e-4, parameters atol 1e-5 (the PPM scale-1 BN, `ppm.0.2`, 1e-4: it
    normalizes rounding noise in train mode), sums rtol and atol 1e-4,
    counts equal. (At batch 2 or 4 the train-mode BN of the PPM's scale-2
    branch normalizes B x 4 values, and cuDNN's and the CPU's roundings
    there part by tenths of that branch's gradient: 27-28 of 154 tensors
    end over 1e-5 apart, up to 1.1e-4, against 8e-7 with cuDNN off.)"""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import synthetic_stage2_batch
    from regda_tpu_torch.models import build_deeplabv2
    from regda_tpu_torch.models.heads import Dropout2d
    from regda_tpu_torch.train import create_train_state, make_optimizer
    from regda_tpu_torch.train.steps import make_stage1_step, proto_accum_step

    def model_on(dev):
        model = build_deeplabv2('resnet18', 6, generator=torch.Generator().manual_seed(11))
        for m in model.modules():
            if isinstance(m, Dropout2d):
                m.p = 0.0   # the two devices draw different dropout bits
        return model.to(dev)

    batch_np = synthetic_stage2_batch(np.random.default_rng(4), 8, 64, 6)
    images_s, label_s, images_t = (torch.from_numpy(a) for a in batch_np[:3])
    for align in (False, True):
        runs = {}
        for dev in ('cpu', device):
            model = model_on(dev)
            state = create_train_state(model, make_optimizer(model, 1e-2, 10),
                                       torch.Generator(device=dev))
            metrics = make_stage1_step(align_domain=align, num_classes=6)(
                state, images_s.to(dev), label_s.to(dev), images_t.to(dev))
            runs[dev] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.cpu() for k, v in model.state_dict().items()})
        (m_cpu, p_cpu), (m_gpu, p_gpu) = runs['cpu'], runs[device]
        for k in m_cpu:
            if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4, abs_tol=1e-6):
                raise AssertionError(f'stage-1 (align {align}) {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}')
        worst = 0.0
        for k, want in p_cpu.items():
            err = float((p_gpu[k] - want).abs().max())
            if err > (1e-4 if '.ppm.0.2.' in k else 1e-5):
                raise AssertionError(f'stage-1 (align {align}) {k}: card vs CPU max abs err {err}')
            worst = max(worst, err)
        print(f'[check] resnet18 stage-1 step 2x8x64^2 align_domain={align}, card vs CPU: '
              f'losses agree (rtol 1e-4) {m_gpu}; parameters within {worst:.3g}')

    sums = {}
    for dev in ('cpu', device):
        model = model_on(dev)
        sums[dev] = [t.cpu() for t in proto_accum_step(
            model, torch.zeros(6, 512, device=dev), torch.zeros(6, 1, device=dev),
            images_s.to(dev), label_s.to(dev), 6)]
    (s_cpu, c_cpu), (s_gpu, c_gpu) = sums['cpu'], sums[device]
    if not torch.equal(c_gpu, c_cpu) or not c_cpu.sum() > 0:
        raise AssertionError(f'prototype counts: card {c_gpu.ravel()} vs CPU {c_cpu.ravel()}')
    err = _assert_close('prototype sums card vs CPU', s_gpu, s_cpu, rtol=1e-4, atol=1e-4)
    print(f'[check] resnet18 prototype accumulation 8x64^2, card vs CPU: counts equal '
          f'({np.asarray(c_cpu).ravel().astype(int).tolist()}), sums within {err:.3g}')


def check_stage3(device) -> None:
    """One resnet18 stage-3 step (dropout off; refine and LRH on) with
    `lt='uvem'` and `bct`, and with `lt='ghm'`, card against CPU from the
    same weights, prototypes and batch (8 crops a domain at 64^2, seeded
    soft labels), at check_stage1's tolerances: losses rtol 1e-4,
    parameters atol 1e-5 (`ppm.0.2` 1e-4), prototypes rtol 1e-4 / atol
    1e-5, the class-balance EMAs rtol 1e-6; the GHM histogram EMA rtol 1e-6
    in its total and each bin within 0.05 absolute: a pixel whose
    g = |p_y - 1| lies within the devices' rounding of a bin edge moves
    0.01 between two bins, so five such pixels a bin are allowed (printed)."""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import stage3_state, synthetic_soft_labels, synthetic_stage2_batch
    from regda_tpu_torch.models.heads import Dropout2d

    rng = np.random.default_rng(12)
    batch_np = synthetic_stage2_batch(rng, 8, 64, 6)
    batch_np = (*batch_np[:3], synthetic_soft_labels(rng, 8, 64), batch_np[3])
    for flags in (dict(lt='uvem', bct=True), dict(lt='ghm')):
        runs = {}
        for dev in ('cpu', device):
            state, step = stage3_state(dev, resnet='resnet18', seed=13, **flags)
            for m in state.model.modules():
                if isinstance(m, Dropout2d):
                    m.p = 0.0   # the two devices draw different dropout bits
            metrics = step(state, *(torch.from_numpy(a).to(dev) for a in batch_np))
            runs[dev] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.cpu() for k, v in state.model.state_dict().items()},
                         state.prototypes.cpu(), state.class_freq_s.freq.cpu(),
                         state.class_freq_t.freq.cpu(), state.ghm.acc_sum.cpu())
        (m_cpu, p_cpu, *rest_cpu), (m_gpu, p_gpu, *rest_gpu) = runs['cpu'], runs[device]
        what = f"stage-3 ({flags['lt']})"
        for k in m_cpu:
            if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4, abs_tol=1e-6):
                raise AssertionError(f'{what} {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}')
        worst = 0.0
        for k, want in p_cpu.items():
            err = float((p_gpu[k] - want).abs().max())
            if err > (1e-4 if '.ppm.0.2.' in k else 1e-5):
                raise AssertionError(f'{what} {k}: card vs CPU max abs err {err}')
            worst = max(worst, err)
        protos_err = _assert_close(f'{what} prototypes', rest_gpu[0], rest_cpu[0],
                                   rtol=1e-4, atol=1e-5)
        for name, g, w in zip(('class_freq_s', 'class_freq_t'), rest_gpu[1:3], rest_cpu[1:3]):
            _assert_close(f'{what} {name}', g, w, rtol=1e-6, atol=0.0)
        acc_gpu, acc_cpu = rest_gpu[3], rest_cpu[3]
        if not math.isclose(float(acc_gpu.sum()), float(acc_cpu.sum()), rel_tol=1e-6):
            raise AssertionError(f'{what} GHM total: card {acc_gpu.sum()} vs CPU {acc_cpu.sum()}')
        ghm_err = _assert_close(f'{what} GHM bins', acc_gpu, acc_cpu, rtol=0.0, atol=0.05)
        print(f'[check] resnet18 stage-3 step 2x8x64^2 {flags}, card vs CPU: losses agree '
              f'(rtol 1e-4) {m_gpu}; parameters within {worst:.3g}, prototypes within '
              f'{protos_err:.3g}; GHM total {float(acc_gpu.sum()):.4f}, bins within {ghm_err:.3g}')


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


SERVE_KINDS = (('batch_norm', ('batch_norm', 'batchnorm', 'bn_fw')), ('upsample', ('upsample',)),
               ('pool', ('pool',)), ('softmax', ('softmax',)), ('copy', ('copy',)),
               ('conv', ('conv', 'fprop', 'xmma', 'cutlass', 'nvjet', 'gemm')),
               ('elementwise', ('elementwise', 'reduce')))


def serve_split(fn) -> tuple[dict, dict]:
    """Device ms and kernel count of one call of fn() by kind of kernel
    (SERVE_KINDS by name, first match; the rest 'other'), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):   # the second profile counts: the first starts the tracer
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    ms, count = {}, {}
    for ev in prof.events():
        if str(ev.device_type).endswith('CUDA'):
            name = ev.name.lower()
            kind = next((k for k, tags in SERVE_KINDS if any(s in name for s in tags)), 'other')
            ms[kind] = ms.get(kind, 0.0) + ev.device_time / 1e3
            count[kind] = count.get(kind, 0) + 1
    return ms, count


def _split_line(ms: dict, count: dict) -> str:
    total = sum(ms.values())
    return f'{total:.3f} ms of kernels: ' + ', '.join(
        f'{k} {v:.3f} ms ({100 * v / total:.1f} %, {count[k]} kernels)'
        for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))


def phase_serve(device) -> None:
    """`serve_entry()`: ResNet-101, C = 6, bf16 compute with f32 weights,
    through `SegInferencer` (BN folded, dual-PPM conv fused), beside the
    stock forward of the same weights; (a) 16 whole tiles, (b) one 1024^2
    scene by slide + TTA, (c) multi-scale."""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import serve_entry

    folded, images = serve_entry(device)
    stock, _ = serve_entry(device, fold_bn=False)
    if not (folded.fold_bn and folded.fused_ppm and folded.model.folded) or stock.model.folded:
        raise AssertionError('serve_entry did not give a folded, fused inferencer')
    x = torch.from_numpy(images).to(device)

    # (a) whole tiles
    t0 = time.perf_counter()
    probs = folded.predict_probs(images, slide=False)
    first_s = time.perf_counter() - t0
    if probs.shape != (16, 512, 512, 6) or not np.isfinite(probs).all():
        raise AssertionError(f'serve output {probs.shape}, finite {np.isfinite(probs).all()}')
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if sum_err > 1e-2:
        raise AssertionError(f'probabilities sum to 1 only within {sum_err}')
    want = stock.predict_probs(images, slide=False)
    err = _within_bf16_steps('folded + fused vs stock forward, bf16', torch.from_numpy(probs),
                             torch.from_numpy(want), FOLDED_VS_STOCK_BF16_STEPS)
    print(f'[serve] (a) ResNet-101 bf16 16x512^2 through SegInferencer.predict_probs: first call '
          f'{first_s:.3f} s, |sum-1| <= {sum_err:.3g}; folded + fused vs stock forward: max abs '
          f'err {err:.4g} (max |value| {float(np.abs(want).max()):.4g}, limit '
          f'{FOLDED_VS_STOCK_BF16_STEPS} bf16 steps)')
    with torch.inference_mode():
        times = {'stock': [], 'folded': []}
        for name in ('stock', 'folded', 'folded', 'stock'):
            inf = folded if name == 'folded' else stock
            times[name].append(cuda_ms(lambda: inf.probs_tensor(x, slide=False), iters=10, warmup=2))
        print('[serve] (a) ms per batch of 16 (CUDA events, in turns stock, folded, folded, stock): '
              + '; '.join(f'{k} {", ".join(f"{v:.3f}" for v in vs)} ms = '
                          f'{", ".join(f"{16e3 / v:.2f}" for v in vs)} tiles/s'
                          for k, vs in times.items()))
        splits = {name: serve_split(lambda: inf.probs_tensor(x, slide=False))
                  for name, inf in (('folded', folded), ('stock', stock))}
    for name, (ms, count) in splits.items():
        print(f'[serve] (a) {name} batch by kind (torch.profiler, one batch): {_split_line(ms, count)}')
    if splits['folded'][1].get('batch_norm', 0) or not splits['stock'][1].get('batch_norm', 0):
        raise AssertionError(f'batch-norm kernels: folded {splits["folded"][1].get("batch_norm", 0)}, '
                             f'stock {splits["stock"][1].get("batch_norm", 0)} (expected 0 and some)')
    del x, probs, want
    stock.model.cpu()
    torch.cuda.empty_cache()

    # (b) one 1024^2 scene, slide + TTA: 9 tiles x 8 = 72 tile forwards
    scene = np.random.default_rng(1).normal(size=(1, 1024, 1024, 3)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probs = folded.predict_probs(scene, slide=True, tta=True)
    first_s = time.perf_counter() - t0
    labels = folded.predict_labels(scene, slide=True, tta=True)
    if probs.shape != (1, 1024, 1024, 6) or not np.isfinite(probs).all():
        raise AssertionError(f'scene output {probs.shape}, finite {np.isfinite(probs).all()}')
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    if labels.dtype != np.int32 or not np.array_equal(labels[clear], probs.argmax(-1)[clear]):
        raise AssertionError('predict_labels differs from the argmax of predict_probs')
    xs = torch.from_numpy(scene).to(device)
    with torch.inference_mode():
        ms = cuda_ms(lambda: folded.probs_tensor(xs, slide=True, tta=True), iters=5, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        folded.predict_labels(scene, slide=True, tta=True)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f'[serve] (b) one 1024^2 scene, slide 512/256 + TTA (72 tile forwards): first call '
          f'{first_s:.3f} s; probs_tensor {ms:.3f} ms = {1e3 / ms:.3f} scenes/s (CUDA events); '
          f'predict_labels from numpy {host_ms:.3f} ms = {1e3 / host_ms:.3f} scenes/s (host clock); '
          f'labels = argmax of probs at the {clear.mean() * 100:.2f} % of pixels whose top two '
          f'differ by more than 1e-3; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del xs

    # (c) multi-scale, 2 x 512^2 at the six default scales
    pair = images[:2]
    t0 = time.perf_counter()
    probs = folded.predict_multiscale(pair)
    first_s = time.perf_counter() - t0
    if probs.shape != (2, 512, 512, 6) or not np.isfinite(probs).all():
        raise AssertionError(f'multiscale output {probs.shape}, finite {np.isfinite(probs).all()}')
    xp = torch.from_numpy(pair).to(device)
    with torch.inference_mode():
        ms = cuda_ms(lambda: folded.multiscale_tensor(xp), iters=3, warmup=1)
    print(f'[serve] (c) predict_multiscale 2x512^2, scales 0.75-2.0: first call {first_s:.3f} s, '
          f'{ms:.3f} ms per call (CUDA events)')


def _bn_stats(model) -> dict:
    """Copies of every BatchNorm running statistic of `model`, by name."""
    return {k: v.detach().clone() for k, v in model.state_dict().items() if 'running' in k}


def _first_bn_stats(into: dict, protos: dict | None = None):
    """An `after_step` for `stage{2,3}_steps` that fills `into` with the
    running statistics after step 1 (and `protos`, where given, with the
    prototypes then, under 'prototypes')."""
    def after_step(i, state):
        if i == 0:
            into.update(_bn_stats(state.model))
            if protos is not None:
                protos['prototypes'] = state.prototypes.detach().clone()
    return after_step


def _final_state(state) -> dict:
    """Host copies of a train state's parameters, running statistics,
    prototypes and class-balance EMAs, by name."""
    out = {f'model.{k}': v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    out.update(prototypes=state.prototypes.detach().cpu().clone(),
               class_freq_s=state.class_freq_s.freq.detach().cpu().clone(),
               class_freq_t=state.class_freq_t.freq.detach().cpu().clone())
    return out


def phase_train(device) -> dict:
    """The bare stage-2 step, `stage2_steps(3)`, then the bare stage-3 step,
    `stage3_steps(3)` (lt='uvem', refine and LRH on, seeded soft labels),
    each with its peak memory; the histogram's count is zeroed before the
    stage-3 run. -> {'stage2_ms', 'stage3_ms' (steps 1-2), 'stage2_launches'
    (since the caller zeroed the count), 'stage3_launches', and per stage
    'stage{n}_metrics' (floats a step), 'stage{n}_peak' (GiB),
    'stage{n}_bn1' and 'stage{n}_bn' (the running statistics after step 1
    and after the 3 steps), 'stage{n}_protos1' (the prototypes after step
    1) and 'stage{n}_state' (`_final_state` after the 3 steps)}."""
    import torch
    from regda_tpu_torch.entry import stage2_steps, stage3_steps
    from regda_tpu_torch.ops.kernels import segment_hist as sh

    out = {}
    for stage, run in ((2, stage2_steps), (3, stage3_steps)):
        if stage == 3:
            out['stage2_launches'] = sh.launches
            sh.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bn1, protos1 = {}, {}
        state, metrics, seconds = run(3, device, after_step=_first_bn_stats(bn1, protos1))
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        for i, vals in enumerate(metrics):
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f'stage-{stage} step {i}: non-finite loss {vals}')
            print(f'[train] stage {stage} step {i}: {seconds[i] * 1e3:.1f} ms {vals}')
        if state.step != 3:
            raise AssertionError(f'stage-{stage} step counter {state.step} != 3')
        ms = sum(seconds[1:]) / 2 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        out.update({f'stage{stage}_ms': ms, f'stage{stage}_metrics': metrics,
                    f'stage{stage}_peak': peak, f'stage{stage}_bn1': bn1,
                    f'stage{stage}_bn': _bn_stats(state.model),
                    f'stage{stage}_protos1': protos1['prototypes'],
                    f'stage{stage}_state': _final_state(state)})
        extra = (f'; segment_hist launches {sh.launches} in 3 steps'
                 if stage == 3 else '')
        print(f'[train] ResNet-101 stage-{stage} f32 2x8x512^2: '
              f'{ms:.1f} ms/step (steps 1-2), peak {peak:.2f} GiB{extra}')
        del state
    out['stage3_launches'] = sh.launches
    if out['stage3_launches'] != 3:
        raise AssertionError(f'segment_hist launched {out["stage3_launches"]} times in 3 '
                             f'stage-3 steps; expected one a step')
    train_split(device)
    return out


# Remat against the plain step, phase 3: step 1's losses, and the running
# statistics after step 1, are the same forward's from the same seeded state,
# so they are held to float32 identity; later steps start from parameters
# that the backward's unordered atomic adds (bilinear upsample, cuDNN weight
# gradients) leave a few ulps apart in each run, so their losses are held to
# REMAT_LATER_RTOL and the running statistics after 3 steps to REMAT_BN_TOL.
REMAT_BN_ATOL = 1e-6
REMAT_LATER_RTOL = 1e-5
REMAT_BN_TOL = dict(rtol=1e-4, atol=1e-5)


def phase_remat(device, bare: dict) -> dict:
    """Phase 3, remat: `stage2_steps(3, remat=True)` and
    `stage3_steps(3, remat=True)` at full width (ResNet-101, 2x8x512^2, f32,
    TF32 off, the seeds of phase 3's plain runs in `bare`). Losses against
    the plain run's (step 1 rtol 1e-6, later steps REMAT_LATER_RTOL); every
    running statistic moved from its initial value by step 1 (moved once a
    step: the recompute in the backward leaves it alone) and within
    REMAT_BN_ATOL of the plain step 1's, within REMAT_BN_TOL after 3 steps;
    exactly one histogram launch a step (the count zeroed just before each
    run); ms/step and peak beside the plain run's. -> {'stage2': launches,
    'stage3': launches}."""
    import torch
    from regda_tpu_torch.entry import stage2_steps, stage3_steps
    from regda_tpu_torch.ops.kernels import segment_hist as sh

    launches = {}
    for stage, run in ((2, stage2_steps), (3, stage3_steps)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sh.launches = 0
        bn1 = {}
        state, metrics, seconds = run(3, device, remat=True, after_step=_first_bn_stats(bn1))
        launches[f'stage{stage}'] = sh.launches
        if not state.model.remat:
            raise AssertionError(f'stage{stage}_steps(remat=True) built a model without remat')
        if sh.launches != 3:
            raise AssertionError(f'segment_hist launched {sh.launches} times in 3 remat '
                                 f'stage-{stage} steps; expected one a step')
        for i, (m, want) in enumerate(zip(metrics, bare[f'stage{stage}_metrics'])):
            rtol = 1e-6 if i == 0 else REMAT_LATER_RTOL
            for k, v in want.items():
                if not math.isclose(float(m[k]), v, rel_tol=rtol, abs_tol=1e-7):
                    raise AssertionError(f'stage-{stage} remat step {i} {k}: {float(m[k])} '
                                         f'vs plain {v} (rtol {rtol:g})')
        want1 = bare[f'stage{stage}_bn1']
        worst1 = max(float((bn1[k] - want1[k]).abs().max()) for k in want1)
        if not worst1 <= REMAT_BN_ATOL:
            raise AssertionError(f'stage-{stage} remat step 1: BN running statistics {worst1} '
                                 f'from the plain step\'s')
        still = [k for k, v in bn1.items()
                 if torch.equal(v, torch.ones_like(v) if k.endswith('running_var')
                                else torch.zeros_like(v))]
        if still:
            raise AssertionError(f'stage-{stage} remat step 1 left {len(still)} running '
                                 f'statistics at their initial values, e.g. {still[0]}')
        bn, want = _bn_stats(state.model), bare[f'stage{stage}_bn']
        worst = max(float((bn[k] - want[k]).abs().max()) for k in want)
        if not all(torch.allclose(bn[k], want[k], **REMAT_BN_TOL) for k in want):
            raise AssertionError(f'stage-{stage} remat: BN running statistics after 3 steps '
                                 f'{worst} from the plain run\'s')
        ms = sum(seconds[1:]) / 2 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_ms, plain_peak = bare[f'stage{stage}_ms'], bare[f'stage{stage}_peak']
        print(f'[train] remat ResNet-101 stage-{stage} f32 2x8x512^2: {ms:.1f} ms/step '
              f'(steps 1-2) against {plain_ms:.1f} without remat ({ms / plain_ms - 1:+.1%}); '
              f'peak {peak:.2f} GiB against {plain_peak:.2f}; losses '
              f'{[float(m["total"]) for m in metrics]} '
              f'equal the plain run\'s (step 1 rtol 1e-6, steps 2-3 rtol {REMAT_LATER_RTOL:g}); '
              f'{len(bn1)} BN running statistics all moved by step 1, within {worst1:.3g} of '
              f'the plain step 1\'s (limit {REMAT_BN_ATOL:g}), within {worst:.3g} after 3 '
              f'steps; segment_hist launches {sh.launches} in 3 steps')
        del state
        torch.cuda.empty_cache()
    return launches


def train_split(device) -> None:
    """Device time of one bare stage-2 and one bare stage-3 step by kind of
    kernel (torch.profiler, `serve_split`'s kinds), on a fresh state and a
    seeded batch each: where stage 3's extra time goes."""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import (stage2_state, stage3_state, synthetic_soft_labels,
                                       synthetic_stage2_batch)
    rng = np.random.default_rng(2)
    images_s, label_s, images_t, regs = synthetic_stage2_batch(rng, 8, 512)
    soft = synthetic_soft_labels(rng, 8, 512)
    for stage, make, arrays in ((2, stage2_state, (images_s, label_s, images_t, regs)),
                                (3, stage3_state, (images_s, label_s, images_t, soft, regs))):
        state, step = make(device)
        batch = [torch.from_numpy(a).to(device) for a in arrays]
        step(state, *batch)      # warm
        ms, count = serve_split(lambda: step(state, *batch))
        print(f'[train] one stage-{stage} step under torch.profiler: {_split_line(ms, count)}')
        del state, batch
        torch.cuda.empty_cache()


STAGE_STEPS = 6   # REGDA_FULL_STEPS and REGDA_FULL_STEPS2 of phase 6


def _loop_ms(trainer) -> tuple[float, float]:
    """(StepTimer EMA over steps 2.., their mean) in ms: the loop's pace."""
    from regda_tpu_torch.utils.profiling import StepTimer
    timer = StepTimer()
    for dt in trainer.step_seconds[1:]:
        timer.record(dt)
    later = trainer.step_seconds[1:]
    return timer.ema * 1e3, sum(later) / len(later) * 1e3


class _StageProbe:
    """What one stage CLI run did, read around its calls: the metrics of
    every `Trainer.run_step`, the host seconds spent waiting in
    `InfiniteIterator.next` for a batch, and in `evaluate`; for stage 3,
    `gener_target_pseudo`'s seconds and what it wrote (read before the CLI
    removes it): file count, shapes, the worst |sum of probabilities - 1|."""

    def __init__(self, keep: str | None = None):
        self.metrics, self.batch_wait, self.eval_s, self.pseudo = [], [], [], []
        self.keep = keep   # a directory to copy the pseudo-label maps into


    def _pseudo(self, gen):
        def probed(cfg, inferencer, loader, path, **kwargs):
            import os
            import numpy as np
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen(cfg, inferencer, loader, path, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if self.keep:
                import shutil
                shutil.copytree(path, self.keep)
            shapes, worst = set(), 0.0
            files = sorted(os.listdir(path))
            for f in files:
                a = np.load(os.path.join(path, f))
                shapes.add((a.shape, str(a.dtype)))
                worst = max(worst, float(np.abs(a.sum(-1, dtype=np.float64) - 1.0).max()))
            self.pseudo.append(dict(seconds=seconds, files=len(files), shapes=shapes,
                                    worst=worst))
        return probed

    def patches(self):
        from unittest import mock
        from regda_tpu_torch.datasets import InfiniteIterator
        from regda_tpu_torch.tools import eval as eval_cli
        from regda_tpu_torch.tools import train_ssl_reg
        from regda_tpu_torch.train.loop import Trainer

        def wrap(fn, out, keep_result=False):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                out.append(result if keep_result else time.perf_counter() - t0)
                return result
            return timed

        return (mock.patch.object(Trainer, 'run_step', wrap(Trainer.run_step, self.metrics, True)),
                mock.patch.object(InfiniteIterator, 'next',
                                  wrap(InfiniteIterator.next, self.batch_wait)),
                mock.patch.object(eval_cli, 'evaluate', wrap(eval_cli.evaluate, self.eval_s)),
                mock.patch.object(train_ssl_reg, 'gener_target_pseudo',
                                  self._pseudo(train_ssl_reg.gener_target_pseudo)))


def _stage_run(name: str, fn, argv, keep: str | None = None):
    """fn(argv) on the card with the peak memory and seconds around it ->
    (fn's result, seconds, peak GiB, _StageProbe); `keep`: where the probe
    copies the pseudo-label maps that a stage-3 run writes."""
    import contextlib
    import torch
    probe = _StageProbe(keep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in probe.patches():
            stack.enter_context(patch)
        out = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f'[stages] {name}: {seconds:.2f} s, peak {peak:.2f} GiB')
    return out, seconds, peak, probe


# Phase 6 multiplies the classifiers of stage 2's `_best.pth` by this before
# stage 3 reads it: a few steps from random weights leave every pixel of the
# pseudo-labels above UVEM's entropy threshold (0.7), and the target loss at
# 0. A pseudo-label is the mean of 2 heads x 8 TTA views, which a barely
# trained model does not agree on, so the mean stays soft however sharp each
# view is: at x16 no pixel passed in a CPU run of this phase cut to resnet18
# at 64^2; at x1000 each view is one-hot, and the pixels where most views
# agree pass.
UVEM_LOGIT_SCALE = 1000.0


def sharpen_classifiers(path: str, scale: float) -> None:
    """Multiply the final 1x1 classifier (`conv_last.4`) of both heads in
    the checkpoint at `path` by `scale`, in place: every logit times scale."""
    import torch
    state = torch.load(path, map_location='cpu', weights_only=True)
    keys = [k for k in state if '.conv_last.4.' in k]
    if len(keys) != 4:
        raise AssertionError(f'{path}: classifier keys {keys}')
    for k in keys:
        state[k] = state[k] * scale
    torch.save(state, path)


def phase_stages(device='cuda', bare: dict | None = None, keep: str | None = None) -> dict:
    """Phase 6: the five stage CLIs in this process at full width on
    `configs/st/regda/full_smoke.py`'s synthetic tree (ResNet-101, C = 6,
    512^2 tiles, batch 8 per domain, f32, TF32 off). `bare`: phase 3's
    bare-step times, printed beside the loop's. `keep`: a directory that
    receives stage 3's pseudo-label maps (`keep/pseudo`) and the target
    tiles' labels (`keep/labels`). Returns the segment histogram's launches
    in the stage-2 and the stage-3 runs (exactly one a step each), zeroed
    just before each run: {'stage2': n, 'stage3': n}."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from regda_tpu_torch.models import build_deeplabv2
    from regda_tpu_torch.ops.kernels import segment_hist as sh
    from regda_tpu_torch.tools import eval as eval_cli
    from regda_tpu_torch.tools import init_prototypes, train_align_reg, train_src, train_ssl_reg
    from regda_tpu_torch.utils.checkpoint import load_checkpoint
    from regda_tpu_torch.utils.tools import import_config

    cfg_name = 'st.regda.full_smoke'
    env = {f'REGDA_FULL_STEPS{n}': str(STAGE_STEPS) for n in ('', '2', '3')}
    saved = {k: os.environ.get(k) for k in (*env, 'REGDA_FULL_ROOT')}
    launches = {}
    with tempfile.TemporaryDirectory(prefix='regda_full_smoke_') as root:
        os.environ.update(env, REGDA_FULL_ROOT=root)
        try:
            t0 = time.perf_counter()
            cfg = import_config(cfg_name, create=False, copy=False)   # writes the tree
            print(f'[stages] synthetic tree (32 train, 8 val, 8 test 512^2 tiles a domain, '
                  f'region maps): {time.perf_counter() - t0:.2f} s')
            log = os.path.join(root, 'log')
            src, align, ssl = (os.path.join(log, d) for d in ('src', 'align', 'ssl'))
            common = ['--config-path', cfg_name, '--device', device]

            s1, _, s1_peak, probe1 = _stage_run('stage 1 (train_src --align-domain 1)',
                                                train_src.main, [*common, '--align-domain', '1'])
            (protos, counts), proto_s, proto_peak, _ = _stage_run(
                'init_prototypes', init_prototypes.main,
                [*common, '--ckpt-model', f'{src}/Vaihingen_best.pth',
                 '--ckpt-proto', f'{src}/prototypes_best'])
            sh.launches = 0
            s2, _, s2_peak, probe2 = _stage_run(
                'stage 2 (train_align_reg --align-domain 1 --refine-label 1 --sam-refine)',
                train_align_reg.main,
                [*common, '--ckpt-model', f'{src}/Vaihingen_best.pth',
                 '--ckpt-proto', f'{src}/prototypes_best.npy', '--align-domain', '1',
                 '--refine-label', '1', '--sam-refine', '--percent', '0.5'])
            launches['stage2'] = sh.launches
            (_, miou), eval_cli_s, eval_peak, probe_eval = _stage_run(
                'eval --test 1 (stage 2)', eval_cli.main,
                [*common, '--ckpt-path', f'{align}/Vaihingen_best.pth', '--test', '1'])
            sharpen_classifiers(f'{align}/Vaihingen_best.pth', UVEM_LOGIT_SCALE)
            sh.launches = 0
            s3, s3_s, s3_peak, probe3 = _stage_run(
                'stage 3 (train_ssl_reg --gen 1 --refine-label 1 --sam-refine --lt uvem)',
                train_ssl_reg.main,
                [*common, '--ckpt-model', f'{align}/Vaihingen_best.pth',
                 '--ckpt-proto', f'{align}/prototypes_best.npy', '--gen', '1',
                 '--refine-label', '1', '--sam-refine', '--percent', '0.5', '--lt', 'uvem'],
                keep=keep and os.path.join(keep, 'pseudo'))
            launches['stage3'] = sh.launches
            if keep:
                shutil.copytree(os.path.join(root, 'Vaihingen', 'ann_dir', 'train'),
                                os.path.join(keep, 'labels'))
            (_, miou3), eval3_cli_s, eval3_peak, probe_eval3 = _stage_run(
                'eval --test 1 (stage 3)', eval_cli.main,
                [*common, '--ckpt-path', f'{ssl}/Vaihingen_best.pth', '--test', '1'])

            for stage, probe in (('stage 1', probe1), ('stage 2', probe2), ('stage 3', probe3)):
                seen = probe.metrics
                if len(seen) != STAGE_STEPS:
                    raise AssertionError(f'{stage} ran {len(seen)} steps, not {STAGE_STEPS}')
                for i, m in enumerate(seen):
                    vals = {k: float(v) for k, v in m.items()}
                    if not all(math.isfinite(v) for v in vals.values()):
                        raise AssertionError(f'{stage} step {i}: non-finite loss {vals}')
                print(f'[stages] {stage} last step losses {vals}')
            targets = [float(m['loss_target']) for m in probe3.metrics]
            if not all(t > 0 for t in targets):
                raise AssertionError(f'stage 3 target losses {targets}: UVEM used no pixel')
            print(f'[stages] stage 3 target (UVEM) losses {targets}, on pseudo-labels from '
                  f'stage 2\'s checkpoint with its classifiers x{UVEM_LOGIT_SCALE:g}')
            for d in (src, align, ssl):
                names = ['Vaihingen_curr.pth', 'Vaihingen_best.pth', 'Vaihingen_state.pth',
                         'Vaihingen_state.pth.json']
                if d != ssl:
                    names.append('prototypes_best.npy')
                for name in names:
                    if not os.path.isfile(os.path.join(d, name)):
                        raise AssertionError(f'{d}/{name} was not written')
            if os.path.exists(s3.pseudo_label):
                raise AssertionError(f'{s3.pseudo_label} was not removed')
            gen = probe3.pseudo
            if (len(gen) != 1 or gen[0]['files'] != 32
                    or gen[0]['shapes'] != {((512, 512, 6), 'float32')}
                    or not gen[0]['worst'] <= 1e-3):
                raise AssertionError(f'pseudo-labels: {gen}; expected 32 (512, 512, 6) float32 '
                                     f'maps whose probabilities sum to 1 within 1e-3')
            for path in (f'{align}/Vaihingen_best.pth', f'{ssl}/Vaihingen_best.pth'):
                load_checkpoint(build_deeplabv2(cfg.MODEL, 6), path)  # strict keys, on the CPU
            present = set()
            for f in os.listdir(os.path.join(root, 'Potsdam', 'ann_dir', 'train')):
                ids = np.unique(np.asarray(Image.open(
                    os.path.join(root, 'Potsdam', 'ann_dir', 'train', f))))
                present.update(int(i) for i in ids if i < 6)
            if not present or not all(counts[c, 0] > 0 for c in present):
                raise AssertionError(f'prototype counts {counts.ravel()} for classes {present}')
            if not np.isfinite(protos).all():
                raise AssertionError('non-finite prototypes')
            for stage, n in launches.items():
                if n != STAGE_STEPS:
                    raise AssertionError(f'segment_hist launched {n} times in {STAGE_STEPS} '
                                         f'{stage} steps; expected one a step')
            for m in (miou, miou3):
                if not (math.isfinite(m) and 0.0 <= m <= 1.0):
                    raise AssertionError(f'test mIoU {m}')
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    loops = {stage: _loop_ms(run.trainer) for stage, run in
             (('stage 1', s1), ('stage 2', s2), ('stage 3', s3))}
    bare = bare or {}
    bare2, bare3 = (f'{bare[k]:.1f}' if k in bare else 'not measured'
                    for k in ('stage2_ms', 'stage3_ms'))
    print(f'[stages] ResNet-101 f32 2x8x512^2 through the loop, host clock a run_step, '
          f'steps 2-{STAGE_STEPS}: '
          + '; '.join(f'{stage} EMA {ema:.1f} ms/step (mean {mean:.1f})'
                      for stage, (ema, mean) in loops.items())
          + f'; bare steps of phase 3: stage 2 {bare2}, stage 3 {bare3} ms/step')
    print('[stages] loader paths: ' + '; '.join(
        f'{stage} source {run.source.paths}, target {run.target.paths}'
        for stage, run in (('stage 1', s1), ('stage 2', s2), ('stage 3', s3))))
    gen = probe3.pseudo[0]
    print(f'[stages] stage 3 pseudo-label generation (32 target tiles, slide + TTA, 8 views '
          f'of 512^2 a tile, f32): {gen["seconds"]:.2f} s, {gen["seconds"] / 32 * 1e3:.1f} '
          f'ms/tile; 32 maps (512, 512, 6) float32, sums within {gen["worst"]:.2g} of 1; '
          f'the stage-3 CLI {s3_s:.2f} s in all')
    for stage, probe in (('stage 1', probe1), ('stage 2', probe2), ('stage 3', probe3)):
        # two next() calls a step; 4 batches an epoch of this tree, so step 5
        # opens an epoch, whose producer thread starts with an empty queue
        waits = [sum(probe.batch_wait[i:i + 2]) * 1e3 for i in range(0, len(probe.batch_wait), 2)]
        later = waits[1:]
        print(f'[stages] {stage}: host wait for the two batches of each step '
              f'(InfiniteIterator.next): {", ".join(f"{w:.1f}" for w in waits)} ms; steps '
              f'2-{STAGE_STEPS} mean {sum(later) / len(later):.1f}, median '
              f'{sorted(later)[len(later) // 2]:.1f} ms/step')
    print(f'[stages] prototype pass (init_prototypes, 4 batches of 8): {proto_s:.2f} s; '
          f'counts {counts.ravel().astype(int).tolist()}')
    for stage, t in (('stage 1', s1.trainer), ('stage 2', s2.trainer), ('stage 3', s3.trainer)):
        evals = ', '.join(f'{x:.3f} s ({x / 8 * 1e3:.1f} ms/tile)' for x in t.eval_seconds)
        ck = t.ckpt_seconds
        print(f'[stages] {stage}: val eval (8 tiles, slide) {evals}; checkpoint chain: host '
              f'copy {ck["snapshot"]:.3f} s, writes {ck["chain"]:.3f} s in the background, '
              f'join_saver wait {ck["join_wait"]:.3f} s; best mIoU {t.mIoU_max}')
    for stage, probe, cli_s, m in (('stage 2', probe_eval, eval_cli_s, miou),
                                   ('stage 3', probe_eval3, eval3_cli_s, miou3)):
        test_s = probe.eval_s[0]
        print(f'[stages] eval CLI on the {stage} test split (8 tiles, slide): evaluate '
              f'{test_s:.3f} s ({test_s / 8 * 1e3:.1f} ms/tile, with the checkpoint load and '
              f'the BN folding), the CLI {cli_s:.2f} s with the model build; mIoU {m}')
    print(f'[stages] peak GiB: stage 1 {s1_peak:.2f}, prototypes {proto_peak:.2f}, '
          f'stage 2 {s2_peak:.2f}, eval {eval_peak:.2f}, stage 3 {s3_peak:.2f} (generation '
          f'included), eval {eval3_peak:.2f}; segment_hist launches in the stage-2 run '
          f'{launches["stage2"]}, in the stage-3 run {launches["stage3"]} ({STAGE_STEPS} steps '
          f'each)')
    return launches


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


# phase 7 (a): the least share of pixels whose superpixel boundary map (is
# the pixel's right or lower neighbour in another superpixel) agrees
# between the card and the CPU. A float centre sum added in another order
# can move a pixel almost tied between two centres; a boundary map does not
# depend on the ids' numbering, which connectivity renumbers after a change.
PREP_BOUNDARY_AGREEMENT = 0.99
PREP_TILES = 8
PREP_CPU_TILES = 2


def _prep_tiles(rng, n: int, size: int = 512):
    """Seeded uint8 tiles with regions: a 16x16 grid of palette colours
    upsampled to the tile, plus pixel noise (std 12)."""
    import numpy as np
    palette = rng.integers(30, 225, size=(6, 3))
    tiles = []
    for _ in range(n):
        grid = palette[rng.integers(0, 6, size=(16, 16))]
        img = np.kron(grid, np.ones((size // 16, size // 16, 1))) + rng.normal(
            0, 12, (size, size, 3))
        tiles.append(np.clip(img, 0, 255).astype(np.uint8))
    return tiles


def _boundaries(labels):
    import numpy as np
    edge = np.zeros(labels.shape, bool)
    edge[:, :-1] |= labels[:, 1:] != labels[:, :-1]
    edge[:-1, :] |= labels[1:, :] != labels[:-1, :]
    return edge


def phase_prep(device, kept: str) -> dict:
    """Phase 7: the data-prep chain and the evidence CLIs on the card.
    (a) `get_superpixels` (LSC, then SLIC) over PREP_TILES seeded 512^2
    tiles: int32 maps, their boundary maps against a CPU run of
    PREP_CPU_TILES tiles (PREP_BOUNDARY_AGREEMENT; SLIC's ids too, which
    keep the grid's numbering, where LSC's connectivity pass numbers its
    segments in scan order, so one moved pixel renumbers those after it),
    ms a tile. (b) `analysis_pseudo_labels` over phase 6's 32 stage-3 pseudo maps
    (`kept`): cnt_used and cnt_true equal a CPU run's, acc and diffi within
    1e-5; the share of pixels used. (c) `check_sam_stability --device cuda
    --vit-config vit_b --tiles 2 --auto-thresh --out <tmp>` with the launch
    counts zeroed just before and read just after (-> the returned dict);
    its report written, flip rate and region counts printed. (d)
    `convert_potsdam` on a 6000^2 RGBIR scene and `convert_vaihingen` on a
    2000x2500 IRRG scene, both synthetic: as many tiles as `tile_boxes`
    gives, names and PIL-decoded tiles equal to the scene's crops."""
    import json
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from regda_tpu_torch.analysis import analysis_pseudo_labels
    from regda_tpu_torch.data_prep.superpixels import get_superpixels
    from regda_tpu_torch.data_prep.tiling import tile_boxes
    from regda_tpu_torch.ops.kernels import layernorm as ln
    from regda_tpu_torch.ops.kernels import mask_stats as ms_
    from regda_tpu_torch.ops.kernels import rel_attention as ra
    from regda_tpu_torch.ops.kernels import stability as st
    from regda_tpu_torch.ops.kernels import two_way as tw
    from regda_tpu_torch.ops.kernels import upscale as up
    from regda_tpu_torch.tools import check_sam_stability, convert_potsdam, convert_vaihingen

    with tempfile.TemporaryDirectory(prefix='regda_prep_') as tmp:
        # (a) superpixels
        img_dir, cpu_dir = os.path.join(tmp, 'img'), os.path.join(tmp, 'img_cpu')
        os.makedirs(img_dir)
        os.makedirs(cpu_dir)
        for i, tile in enumerate(_prep_tiles(np.random.default_rng(21), PREP_TILES)):
            Image.fromarray(tile).save(os.path.join(img_dir, f't{i}.png'))
            if i < PREP_CPU_TILES:
                Image.fromarray(tile).save(os.path.join(cpu_dir, f't{i}.png'))
        for method in ('lsc', 'slic'):
            out, out_cpu = os.path.join(tmp, f'sup_{method}'), os.path.join(tmp, f'cpu_{method}')
            get_superpixels(img_dir, out, method=method, device=device)   # first use
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = get_superpixels(img_dir, out, method=method, device=device)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            get_superpixels(cpu_dir, out_cpu, method=method, device='cpu')
            cpu_s = time.perf_counter() - t0
            agree, same_ids, counts = [], [], []
            for i in range(n):
                card = np.asarray(Image.open(os.path.join(out, f't{i}.tif')))
                if card.dtype != np.int32 or card.shape != (512, 512):
                    raise AssertionError(f'{method} map t{i}: {card.dtype} {card.shape}')
                counts.append(int(card.max()) + 1)
                if i < PREP_CPU_TILES:
                    cpu = np.asarray(Image.open(os.path.join(out_cpu, f't{i}.tif')))
                    agree.append(float((_boundaries(card) == _boundaries(cpu)).mean()))
                    same_ids.append(float((card == cpu).mean()))
            if min(agree) < PREP_BOUNDARY_AGREEMENT:
                raise AssertionError(f'{method}: boundary agreement card vs CPU {agree}')
            if method == 'slic' and min(same_ids) < PREP_BOUNDARY_AGREEMENT:
                raise AssertionError(f'slic: ids equal card vs CPU at {same_ids} of the pixels')
            print(f'[prep] get_superpixels({method}) on {n} seeded 512^2 tiles: '
                  f'{card_s / n * 1e3:.1f} ms a tile on the card (files included; the CPU '
                  f'{cpu_s / PREP_CPU_TILES * 1e3:.1f}), superpixels a tile {counts}; card vs CPU '
                  f'on {PREP_CPU_TILES} tiles: boundary agreement {agree} (limit '
                  f'{PREP_BOUNDARY_AGREEMENT}), ids equal at {same_ids} of the pixels'
                  + (f' (limit {PREP_BOUNDARY_AGREEMENT})' if method == 'slic' else ''))

        # (b) pseudo-label analysis
        labels, pseudo = os.path.join(kept, 'labels'), os.path.join(kept, 'pseudo')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = analysis_pseudo_labels(labels, pseudo, n_classes=6, device=device)
        card_s = time.perf_counter() - t0
        cpu = analysis_pseudo_labels(labels, pseudo, n_classes=6, device='cpu')
        for k in ('cnt_used', 'cnt_true'):
            if not np.array_equal(card[k], cpu[k]):
                raise AssertionError(f'analysis {k}: card and CPU differ')
        for k in ('acc', 'diffi'):
            if not np.allclose(card[k], cpu[k], rtol=0, atol=1e-5):
                raise AssertionError(f'analysis {k}: card vs CPU {np.abs(card[k] - cpu[k]).max()}')
        n_maps = len(os.listdir(pseudo))
        used = card['cnt_used'].sum() / (n_maps * 512 * 512)
        right = card['cnt_true'].sum() / max(card['cnt_used'].sum(), 1)
        print(f'[prep] analysis_pseudo_labels over phase 6\'s {n_maps} stage-3 pseudo maps: '
              f'{card_s:.2f} s on the card; counts equal the CPU\'s, acc / diffi within 1e-5; '
              f'{used:.4f} of the pixels used, {right:.4f} of those right')

        # (c) the stability check: SAM ViT-B, both generators
        ln.launches = ra.launches = tw.launches = tw.cuda_launches = up.launches = 0
        st.launches_blocked = st.launches_fused = ms_.launches = 0
        report_path = os.path.join(tmp, 'stability.json')
        t0 = time.perf_counter()
        report = check_sam_stability.main(['--device', device, '--vit-config', 'vit_b',
                                           '--tiles', '2', '--auto-thresh',
                                           '--out', report_path])
        stab_s = time.perf_counter() - t0
        counts = {'layernorm': ln.launches, 'rel_attention': ra.launches,
                  'two_way': tw.launches, 'upscale': up.launches,
                  'stability_blocked': st.launches_blocked,
                  'stability_fused': st.launches_fused, 'mask_stats': ms_.launches}
        with open(report_path) as f:
            if json.load(f) != json.loads(json.dumps(report)):
                raise AssertionError('check_sam_stability: the report written differs')
        if counts['stability_fused'] or not all(v > 0 for k, v in counts.items()
                                                if k != 'stability_fused'):
            raise AssertionError(f'check_sam_stability launches {counts}')
        delta = report['stability_delta']
        print(f'[prep] check_sam_stability vit_b, 2 tiles of 512^2, 32^2 points: {stab_s:.1f} s; '
              f'{delta["n_candidates"]} candidates, mean |fast - exact| {delta["mean_abs"]:.4f}, '
              f'flip rate {delta["flip_rate"]:.4f} at 0.95 and {delta["flip_rate_at_median"]:.4f} '
              f'at the median; regions fast / exact: crop 0 '
              f'{report["regions_crop0"]["region_counts_fast"]} / '
              f'{report["regions_crop0"]["region_counts_exact"]}, crop 1 '
              f'{report["regions_crop1"]["region_counts_fast"]} / '
              f'{report["regions_crop1"]["region_counts_exact"]}; launches {counts}')

        # (d) the tilers
        rng = np.random.default_rng(22)
        for name, shape, channels, convert, argv, sub in (
                ('top_potsdam_2_10_RGBIR.tif', (6000, 6000), 4, convert_potsdam.main,
                 lambda d, o: [d, '-o', o], ('img_dir', 'train')),
                ('top_mosaic_09cm_area1.tif', (2000, 2500), 3, convert_vaihingen.main,
                 lambda d, o: ['--image-dir', d, '-o', o], ('img_dir', 'train'))):
            raw, out = os.path.join(tmp, f'raw_{channels}'), os.path.join(tmp, f'tiles_{channels}')
            os.makedirs(raw)
            scene = rng.integers(0, 256, size=shape + (channels,), dtype=np.uint8)
            Image.fromarray(scene).save(os.path.join(raw, name))
            t0 = time.perf_counter()
            n = convert(argv(raw, out))
            conv_s = time.perf_counter() - t0
            boxes = tile_boxes(*shape, 512)
            files = sorted(os.listdir(os.path.join(out, *sub)))
            if n != len(boxes) or len(files) != len(boxes):
                raise AssertionError(f'{name}: {n} tiles, {len(files)} files, '
                                     f'{len(boxes)} boxes')
            select = [3, 0, 1] if channels == 4 else [0, 1, 2]
            prefix = '2_10' if channels == 4 else 'area1'
            for x0, y0, x1, y1 in boxes[[0, len(boxes) // 2, -1]]:
                f = f'{prefix}_{x0}_{y0}_{x1}_{y1}.png'
                tile = np.asarray(Image.open(os.path.join(out, *sub, f)))
                if not np.array_equal(tile, scene[y0:y1, x0:x1][..., select]):
                    raise AssertionError(f'{name}: tile {f} differs from the scene')
            print(f'[prep] {convert.__module__.rsplit(".", 1)[1]} on one synthetic '
                  f'{shape[0]}x{shape[1]}x{channels} scene: {n} tiles as tile_boxes gives, '
                  f'{conv_s:.2f} s; three tiles decoded by PIL equal their crops')
    return counts


# ------------------------------------------------------------------ parallel
# Phase 3b holds the data-parallel steps to the plain ones of phase 3. At
# world size 1 the losses' and gradients' collectives sum one rank and the
# BatchNorms take the plain path (a rank's statistics are the global ones),
# so step 1's losses are held to PARALLEL_FIRST_RTOL (measured: equal).
# Later steps start from parameters that the backward's unordered atomic
# adds leave a few ulps apart in any two runs (phase 3's remat holds), so
# their losses are held to PARALLEL_LATER_RTOL (measured 1.24e-6), the BN
# statistics to REMAT_BN_TOL (1.4e-5), and the parameters, prototypes and
# EMAs after 3 steps to PARALLEL_STATE_TOL (2.5e-6).
PARALLEL_FIRST_RTOL = 1e-6
PARALLEL_LATER_RTOL = 1e-5
PARALLEL_STATE_TOL = dict(rtol=1e-4, atol=1e-5)
# Two ranks on one card (gloo), stage-2 step 1 of 4 rows a domain a rank
# against the plain step 1 of 8: the global BN sums by its own formula, and
# cuDNN picks its algorithms by batch size, so the two sum in other orders
# (measured 1.06e-6). The same tolerance holds the one-rank run whose BNs
# are forced onto that formula.
TWO_RANK_RTOL = 1e-4


@contextlib.contextmanager
def _global_bn():
    """While inside, every train-mode BatchNorm in a data-parallel group
    takes the formula of N > 1 ranks (`BatchNorm2d._global_forward`), also
    in a group of one, where it otherwise takes cuDNN's: what a step on N
    cards pays for its BatchNorms, measured on one."""
    from regda_tpu_torch.models.resnet import BatchNorm2d
    plain = BatchNorm2d.forward

    def forward(self, x):
        if self.training and self.data_group is not None:
            return self._global_forward(x)
        return plain(self, x)

    BatchNorm2d.forward = forward
    try:
        yield
    finally:
        BatchNorm2d.forward = plain


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _worst(got: dict, want: dict, keys=None) -> tuple[float, str]:
    """(largest |got - want|, its name) over the named tensors."""
    keys = want.keys() if keys is None else keys
    return max((float((got[k].float().cpu() - want[k].float().cpu()).abs().max()), k)
               for k in keys)


def _hold_state(what: str, got: dict, want: dict, tol: dict) -> str:
    import torch
    bad = [k for k in want if not torch.allclose(got[k].float().cpu(), want[k].float().cpu(),
                                                 **tol)]
    worst, name = _worst(got, want)
    print(f'[parallel] {what}: largest gap {worst:.3g} at {name}; {len(bad)} of {len(want)} '
          f'beyond {tol}')
    if bad:
        raise AssertionError(f'{what}: {len(bad)} tensors beyond {tol}, e.g. {bad[0]}; '
                             f'largest gap {worst} at {name}')
    return f'{worst:.3g} at {name}'


def phase_parallel(device, bare: dict) -> dict:
    """Phase 3b: `stage2_steps(3)` and `stage3_steps(3)` (ResNet-101,
    2x8x512^2, f32) inside a one-rank NCCL process group, from the seeds of
    phase 3's plain runs in `bare`: losses (step 1 PARALLEL_FIRST_RTOL, later
    REMAT_LATER_RTOL), running statistics after step 1 (REMAT_BN_TOL) and
    after 3 steps, parameters, prototypes and class-balance EMAs after 3
    steps (PARALLEL_STATE_TOL) against the plain runs'; exactly one histogram
    launch a step (the count zeroed just before each run); ms/step beside
    the plain step's, the difference being the cost of the losses' and
    gradients' collectives. Then `stage2_steps(3)` in the group with every
    BatchNorm on the N > 1 formula (`_global_bn`): step 1's losses
    (TWO_RANK_RTOL) and BN statistics (REMAT_BN_TOL) against the plain
    run's, one histogram launch a step, ms/step and peak beside the plain
    step's; then one more such step's wall time and its kernels by kind
    (torch.profiler), and the device's idle share. -> {'stage2': launches,
    'stage3': launches, 'global_bn': launches, 'stage2_ms', 'stage3_ms',
    'global_bn_ms', 'global_bn_peak'}."""
    import torch
    import torch.distributed
    from regda_tpu_torch import parallel
    from regda_tpu_torch.entry import stage2_steps, stage3_steps
    from regda_tpu_torch.ops.kernels import segment_hist as sh

    group = parallel.data_group(0, 1, device, init_method=f'tcp://127.0.0.1:{_free_port()}')
    out = {}
    try:
        for stage, run in ((2, stage2_steps), (3, stage3_steps)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sh.launches = 0
            bn1 = {}
            state, metrics, seconds = run(3, device, group=group,
                                          after_step=_first_bn_stats(bn1))
            out[f'stage{stage}'] = sh.launches
            if sh.launches != 3:
                raise AssertionError(f'segment_hist launched {sh.launches} times in 3 '
                                     f'data-parallel stage-{stage} steps; expected one a step')
            gaps = [max(abs(float(m[k]) - v) / max(abs(v), 1e-12) for k, v in want.items())
                    for m, want in zip(metrics, bare[f'stage{stage}_metrics'])]
            print(f'[parallel] stage-{stage} group losses against the plain run\'s, relative, '
                  f'by step: {", ".join(f"{g:.3g}" for g in gaps)}')
            for i, gap in enumerate(gaps):
                rtol = PARALLEL_FIRST_RTOL if i == 0 else PARALLEL_LATER_RTOL
                if not gap <= rtol:
                    raise AssertionError(f'data-parallel stage-{stage} step {i}: losses '
                                         f'{gap:.3g} from the plain step\'s (rtol {rtol:g})')
            bn1_gap = _hold_state(f'stage-{stage} group step 1 BN statistics', bn1,
                                  bare[f'stage{stage}_bn1'], REMAT_BN_TOL)
            final = _final_state(state)
            want = bare[f'stage{stage}_state']
            bn_keys = [k for k in want if 'running' in k]
            bn_gap = _hold_state(f'stage-{stage} group BN statistics after 3 steps',
                                 {k: final[k] for k in bn_keys}, {k: want[k] for k in bn_keys},
                                 REMAT_BN_TOL)
            rest = [k for k in want if 'running' not in k]
            state_gap = _hold_state(f'stage-{stage} group parameters, prototypes, EMAs',
                                    {k: final[k] for k in rest}, {k: want[k] for k in rest},
                                    PARALLEL_STATE_TOL)
            ms = sum(seconds[1:]) / 2 * 1e3
            plain = bare[f'stage{stage}_ms']
            out[f'stage{stage}_ms'] = ms
            print(f'[parallel] world size 1 ({torch.distributed.get_backend()}) stage-{stage} '
                  f'ResNet-101 f32 2x8x512^2: '
                  f'{ms:.1f} ms/step (steps 1-2) against {plain:.1f} plain '
                  f'({ms - plain:+.1f} ms, {ms / plain - 1:+.2%}: the collectives), peak '
                  f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB against '
                  f'{bare[f"stage{stage}_peak"]:.2f}; losses {[float(m["total"]) for m in metrics]} '
                  f'within {gaps[0]:.3g} (step 1) and {max(gaps[1:]):.3g} (steps 2-3) of the '
                  f'plain run\'s (relative); BN statistics after '
                  f'step 1 {bn1_gap}, after 3 steps {bn_gap}; parameters, prototypes and EMAs '
                  f'after 3 steps {state_gap}; segment_hist launches {sh.launches} in 3 steps')
            del state, final
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sh.launches = 0
        bn1 = {}
        with _global_bn():
            state, metrics, seconds = stage2_steps(3, device, group=group,
                                                   after_step=_first_bn_stats(bn1))
        out['global_bn'] = sh.launches
        if sh.launches != 3:
            raise AssertionError(f'segment_hist launched {sh.launches} times in 3 stage-2 '
                                 f'steps with the global BatchNorm; expected one a step')
        want = bare['stage2_metrics'][0]
        gap = max(abs(float(metrics[0][k]) - v) / max(abs(v), 1e-12) for k, v in want.items())
        if not gap <= TWO_RANK_RTOL:
            raise AssertionError(f'stage-2 step 1 with the global BatchNorm: losses {gap:.3g} '
                                 f'from the plain step\'s (rtol {TWO_RANK_RTOL:g})')
        bn1_gap = _hold_state('stage-2 global-BN step 1 BN statistics', bn1,
                              bare['stage2_bn1'], REMAT_BN_TOL)
        ms, peak = sum(seconds[1:]) / 2 * 1e3, torch.cuda.max_memory_allocated() / 2**30
        plain, group_ms = bare['stage2_ms'], out['stage2_ms']
        out.update(global_bn_ms=ms, global_bn_peak=peak)
        # beside the group's cuDNN-BN run just before too: phase 3's one
        # plain reading has spread from 430 to 520 ms between calls
        print(f'[parallel] world size 1, every BatchNorm on the N > 1 formula '
              f'(_global_forward), stage-2 ResNet-101 f32 2x8x512^2: {ms:.1f} ms/step '
              f'(steps 1-2) against {plain:.1f} plain ({ms - plain:+.1f} ms, '
              f'{ms / plain - 1:+.2%}) and {group_ms:.1f} in the group with cuDNN\'s BN '
              f'({ms / group_ms - 1:+.2%}), peak {peak:.2f} GiB against '
              f'{bare["stage2_peak"]:.2f}; step 1\'s losses within {gap:.3g} of the plain '
              f'step\'s (relative), BN statistics {bn1_gap}; segment_hist launches '
              f'{sh.launches} in 3 steps')
        del state
        # where that step's time goes: one more step's wall time (after a
        # warm one), then its kernels by kind under torch.profiler
        import numpy as np
        from regda_tpu_torch.entry import stage2_state, synthetic_stage2_batch
        with _global_bn():
            state, step = stage2_state(device, group=group)
            batch = [torch.from_numpy(a).to(device)
                     for a in synthetic_stage2_batch(np.random.default_rng(2), 8, 512)]
            step(state, *batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, *batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            kernel_ms, count = serve_split(lambda: step(state, *batch))
        busy = sum(kernel_ms.values())
        print(f'[parallel] one stage-2 step with the N > 1 BatchNorm: {wall:.1f} ms of wall '
              f'time; one more under torch.profiler: {_split_line(kernel_ms, count)}; '
              f'device idle {1 - busy / wall:.1%} of the wall step')
        del state, batch
    finally:
        parallel.shutdown()
    return out


def _two_rank_step(rank: int, init: str, out: str, device: str) -> None:
    """One rank of phase 3b's two ranks on one card (gloo): a one-element
    all-reduce of a CUDA tensor first, whose failure on either rank is
    gloo's refusal (the ranks agree on it over a CPU tensor, which gloo
    always takes); then `stage2_steps(2)` on its 4 rows a domain. Writes
    step 1's losses, prototypes and BN statistics, step 2's seconds and the
    histogram's launches, or the refusal, or any other error, to
    out/rank<r>.pt."""
    import traceback
    import torch
    import torch.distributed as dist
    from regda_tpu_torch import parallel
    from regda_tpu_torch.entry import stage2_steps
    from regda_tpu_torch.ops.kernels import segment_hist as sh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {}
    try:
        group = parallel.data_group(rank, 2, device, init_method=init, backend='gloo')
        try:
            refusal = None
            try:
                dist.all_reduce(torch.ones(1, device=device))
            except RuntimeError:
                refusal = traceback.format_exc()
            accepted = torch.tensor([0 if refusal else 1])
            dist.all_reduce(accepted, op=dist.ReduceOp.MIN)
            if not int(accepted):
                result = dict(refused=refusal or 'the other rank was refused')
            else:
                sh.launches = 0
                bn1, protos1 = {}, {}
                state, metrics, seconds = stage2_steps(
                    2, device, group=group, after_step=_first_bn_stats(bn1, protos1))
                launches = sh.launches
                parallel.assert_replicated(dict(protos1, **bn1), group)
                result = dict(metrics={k: float(v) for k, v in metrics[0].items()},
                              seconds=seconds[1], launches=launches,
                              prototypes=protos1['prototypes'].cpu(),
                              bn1={k: v.cpu() for k, v in bn1.items()})
        finally:
            parallel.shutdown()
    except Exception:      # reported by the parent, which fails
        result = dict(error=traceback.format_exc())
    torch.save(result, f'{out}/rank{rank}.pt')


def phase_parallel_two(bare: dict, device: str = 'cuda:0') -> dict | None:
    """Phase 3b, two ranks sharing the one card over gloo (NCCL refuses two
    ranks on one GPU): two stage-2 steps at full width, 4 rows a domain a
    rank, step 1 held to the plain step 1 of phase 3 on all 8 (losses and
    prototypes TWO_RANK_RTOL, BN statistics REMAT_BN_TOL), the ranks'
    prototypes and BN statistics bit for bit alike, one histogram launch a
    step on each rank, step 2's ms. Where gloo refuses the probe's
    all-reduce of a CUDA tensor, prints why and returns None; any other
    fault of a rank fails. -> {'launches': per rank, 'ms': per rank}."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix='regda_two_') as tmp:
        init = f'tcp://127.0.0.1:{_free_port()}'
        t0 = time.perf_counter()
        mp.spawn(_two_rank_step, args=(init, tmp, device), nprocs=2, join=True)
        wall = time.perf_counter() - t0
        ranks = [torch.load(f'{tmp}/rank{r}.pt') for r in range(2)]
    errors = [r['error'] for r in ranks if 'error' in r]
    if errors:
        raise AssertionError(f'two ranks on one card (gloo): a rank failed:\n{errors[0]}')
    refused = [r['refused'] for r in ranks if 'refused' in r]
    if refused:
        print(f'[parallel] two ranks on one card: gloo refuses an all-reduce of a CUDA '
              f'tensor, the world-size-1 run stands alone. '
              f'{refused[0].strip().splitlines()[-1]}')
        return None
    want = bare['stage2_metrics'][0]
    for r, res in enumerate(ranks):
        if res['launches'] != 2:
            raise AssertionError(f'rank {r}: segment_hist launched {res["launches"]} times '
                                 f'in two data-parallel steps')
        for k, v in want.items():
            if not math.isclose(res['metrics'][k], v, rel_tol=TWO_RANK_RTOL):
                raise AssertionError(f'two ranks, rank {r}: {k} {res["metrics"][k]} vs the '
                                     f'one-process step\'s {v} (rtol {TWO_RANK_RTOL:g})')
    protos_gap = _hold_state('two ranks: prototypes after step 1',
                             {'p': ranks[0]['prototypes']}, {'p': bare['stage2_protos1']},
                             dict(rtol=TWO_RANK_RTOL, atol=1e-6))
    bn_gap = _hold_state('two ranks: BN statistics after step 1', ranks[0]['bn1'],
                         bare['stage2_bn1'], REMAT_BN_TOL)
    gaps = max(abs(ranks[0]['metrics'][k] - v) / abs(v) for k, v in want.items() if v)
    print(f'[parallel] two ranks on one card (gloo, CUDA tensors), stage 2 ResNet-101 f32, '
          f'4 + 4 rows a domain: step 2 {ranks[0]["seconds"] * 1e3:.1f} / '
          f'{ranks[1]["seconds"] * 1e3:.1f} ms on ranks 0 / 1 (both share the card; phase 3\'s '
          f'plain step of 8 rows {bare["stage2_ms"]:.1f}), {wall:.1f} s for the two processes '
          f'in all; step 1\'s losses within {gaps:.3g} of the one-process step\'s, '
          f'prototypes {protos_gap}, BN statistics {bn_gap}; segment_hist launches '
          f'{[r["launches"] for r in ranks]} in 2 steps a rank')
    return {'launches': [r['launches'] for r in ranks],
            'ms': [r['seconds'] * 1e3 for r in ranks]}


def phase_data_mesh(device: str = 'cuda', model_type: str = 'vit_b', img_size: int = 1024,
                    n: int = 8, size: int = 512) -> None:
    """Phase 3b, SAM replicas: `seg_everything --data-mesh 2` (two processes
    on the one card, each writing the maps of its tiles) over phase 5's 8
    tiles of 512^2 (SAM ViT-B, seeded weights, both thresholds open so that
    NMS paints regions), against the one-process run: every `reg_dir/*.tif`
    equal, not all empty."""
    import os
    import tempfile
    import numpy as np
    from PIL import Image
    from regda_tpu_torch.tools import seg_everything
    rng = np.random.default_rng(0)
    tiles = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8) for _ in range(n)]
    args = ['--model-type', model_type, '--img-size', str(img_size), '--pred-iou-thresh=-1e9',
            '--stability-thresh', '0', '--batch-tiles', str(n // 2), '--device', device]
    with tempfile.TemporaryDirectory(prefix='regda_mesh_') as tmp:
        dirs, seconds = {}, {}
        for name in ('one', 'two'):
            img_dir = os.path.join(tmp, name, 'img_dir', 'train')
            os.makedirs(img_dir)
            for i, t in enumerate(tiles):
                Image.fromarray(t).save(os.path.join(img_dir, f'tile{i}.png'))
            t0 = time.perf_counter()
            seg_everything.main(['--img-dirs', img_dir] + args
                                + (['--data-mesh', '2'] if name == 'two' else []))
            seconds[name] = time.perf_counter() - t0
            dirs[name] = img_dir.replace('img_dir', 'reg_dir')
        names = sorted(os.listdir(dirs['one']))
        if names != sorted(os.listdir(dirs['two'])) or len(names) != n:
            raise AssertionError(f'--data-mesh 2 wrote {sorted(os.listdir(dirs["two"]))}, '
                                 f'one process {names}')
        regions = 0
        for name in names:
            a = np.asarray(Image.open(os.path.join(dirs['one'], name)))
            b = np.asarray(Image.open(os.path.join(dirs['two'], name)))
            if not np.array_equal(a, b):
                raise AssertionError(f'--data-mesh 2: {name} differs from the one-process map '
                                     f'at {int((a != b).sum())} pixels')
            regions += len(np.unique(a[a > 0]))
    if regions == 0:
        raise AssertionError('--data-mesh 2: every map is empty; nothing was compared')
    print(f'[parallel] seg_everything --data-mesh 2 over {n} tiles of {size}^2 ({model_type}, '
          f'two processes on one card): {n} maps equal to the one-process run\'s, {regions} '
          f'regions in all; {seconds["two"]:.1f} s against {seconds["one"]:.1f} s in one '
          f'process (each process builds its own SAM)')


# --------------------------------------------------------------- periphery
# cuDNN against oneDNN, f32, TF32 off; DEEP_TOL for DeeplabV2MMD's 50-layer
# train forward (its logits about 2 in size), where the two libraries' sums
# part by ~1e-4 after the encoder
PERIPHERY_TOL = dict(rtol=1e-4, atol=1e-4)
DEEP_TOL = dict(rtol=1e-3, atol=1e-3)


def phase_periphery(device, size: int = 512, feat_hw: int = 64, width: int = 2048,
                    resnet: str = 'ResNet101', mmd: str = 'resnet50') -> None:
    """Phase 8: each periphery module at the recipe's widths on the card
    against the same call on the CPU, float32: the mixes exactly on 8 x
    512^2 images with C = 6 labels; the whitening, GDP, alignment, SAW,
    pixel-contrast, triplet, MSC and context losses on 2048-channel
    features at 64^2 (8 images; MSC, triplet on 1024 rows) within
    PERIPHERY_TOL; the EMA of a ResNet-101 DeepLabv2's parameters exactly;
    TransNorm on 16 x 64^2 x 2048 (8 + 8), the discriminators on 6-class
    softmax maps (FCDiscriminator 8 x 512^2, the local one on [logits,
    features] at 64^2, the pixel one at 64^2), DeeplabV2MMD (ResNet-50) and
    SpixelNet on 2 x 512^2, outputs within PERIPHERY_TOL."""
    import numpy as np
    import torch
    from regda_tpu_torch.entry import build_deeplabv2
    from regda_tpu_torch.models.deeplab_mmd import DeeplabV2MMD
    from regda_tpu_torch.models.discriminators import (FCDiscriminator,
                                                       FCDiscriminatorLocal,
                                                       PixelDiscriminator)
    from regda_tpu_torch.models.resnet import ResNet
    from regda_tpu_torch.models.spixelnet import SpixelNet
    from regda_tpu_torch.models.transnorm import TransNorm
    from regda_tpu_torch.ops import align_losses as A
    from regda_tpu_torch.ops import losses_extra as E
    from regda_tpu_torch.ops import mix as M
    from regda_tpu_torch.ops import whiten as W
    from regda_tpu_torch.utils import ema as EMA

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    worst = {}

    def both(name, fn, *arrays, exact=False, tol=PERIPHERY_TOL):
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        got, want = fn(*[a.to(device) for a in cpu]), fn(*cpu)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        gap = 0.0
        for g, w in zip(got, want):
            g = g.detach().cpu()
            w = w.detach()
            if exact:
                if not torch.equal(g, w):
                    raise AssertionError(f'periphery {name}: card differs from the CPU')
            else:
                gap = max(gap, float((g - w).abs().max()))
                if not bool(torch.isfinite(w).all()) or not torch.allclose(g, w, **tol):
                    raise AssertionError(f'periphery {name}: card {g.flatten()[:4]} vs CPU '
                                         f'{w.flatten()[:4]}, largest gap {gap:.3g}, beyond {tol}')
        worst[name] = gap

    img = rng.random((8, size, size, 3), np.float32)
    img2 = rng.random((8, size, size, 3), np.float32)
    lab = rng.integers(-1, 6, (8, size, size)).astype(np.int64)
    lab2 = rng.integers(-1, 6, (8, size, size)).astype(np.int64)
    chosen = M.classmix_draw(torch.Generator().manual_seed(0), 6, 0.5)
    box = M.box_mask(size, size, 0.4, 0.4 * size, 0.6 * size)
    idx = torch.randperm(8, generator=torch.Generator().manual_seed(1))
    both('classmix', lambda a, b, c, d: M.classmix_apply(chosen, a, b, c, d),
         img, lab, img2, lab2, exact=True)
    both('cutmix', lambda a, b, c, d: M.cutmix_apply(box.to(a.device), a, b, c, d),
         img, lab, img2, lab2, exact=True)
    both('cutmix2', lambda a, b: M.cutmix2_apply(idx, box.to(a.device), a, b), img, lab,
         exact=True)
    both('mixup', lambda a, b, c, d: M.mixup_apply(idx, 0.3, a, b, c, d), img, lab, img2, lab2,
         exact=True)
    del img, img2

    feat = rng.normal(size=(8, feat_hw, feat_hw, width)).astype(np.float32)
    flab = rng.integers(-1, 6, (8, feat_hw, feat_hw)).astype(np.int64)
    logits = rng.normal(size=(8, feat_hw, feat_hw, 6)).astype(np.float32)
    logits2 = rng.normal(size=(8, feat_hw, feat_hw, 6)).astype(np.float32)
    protos = rng.normal(size=(6, width)).astype(np.float32)
    both('class_ware_whitening', lambda f, l: W.class_ware_whitening(f, l, range(6), 8),
         feat, flab)
    both('gdp_loss', lambda x, l: E.gdp_loss(E.GDPState.create(device=x.device), x, l)[0],
         rng.normal(size=(8, size, size, 6)).astype(np.float32) * 3, lab)
    both('class_align_loss', A.class_align_loss, protos, protos[::-1].copy())
    both('instance_align_loss', A.instance_align_loss, feat, flab, protos)
    both('saw_loss', lambda f, w: A.saw_loss(f, w, [1, 2]), feat,
         rng.normal(size=(6, width)).astype(np.float32))
    prio = A.pixel_contrast_priority(torch.Generator().manual_seed(2), 8, 6, feat_hw ** 2)
    both('pixel_contrast_loss',
         lambda f, l, p: A.pixel_contrast_loss_body(prio.to(f.device), f, l, p, 6),
         feat, np.abs(flab), rng.integers(0, 6, (8, feat_hw, feat_hw)))
    rows = feat.reshape(-1, width)[:1024]
    both('triplet_loss', A.triplet_loss, rows, rng.integers(0, 6, 1024))
    both('msc_loss', lambda s, l, t_: A.msc_loss(s, l, t_, 6), rows,
         rng.integers(0, 6, 1024), feat.reshape(-1, width)[1024:2048])
    both('icr_loss', lambda a, b, f: A.icr_loss(a, b, f, 6), logits, logits2, feat)
    both('ccr_loss', lambda a, b, f, c, d: A.ccr_loss((a, b, f), (c, d, f), 6),
         logits, logits2, feat, logits2, logits)
    both('mse_context_loss', lambda a, b, f, c, d: A.mse_context_loss((a, b, f), (c, d, f)),
         logits, logits2, feat, logits2, logits)

    model = build_deeplabv2(resnet, 6, generator=torch.Generator().manual_seed(0))
    moved = {k: v + 0.01 for k, v in model.state_dict().items() if v.is_floating_point()}
    names = [k for k, _ in model.named_parameters()]
    cpu_state = EMA.ema_update(EMA.ema_register(model), {k: moved[k] for k in names}, 0.999)
    card_state = EMA.ema_update(EMA.ema_register(model.to(device)),
                                {k: moved[k].to(device) for k in names}, 0.999)
    if not all(torch.equal(card_state.shadow[k].cpu(), cpu_state.shadow[k]) for k in names):
        raise AssertionError('periphery ema: the card\'s shadow differs from the CPU\'s')
    del model, moved, cpu_state, card_state

    def module(name, build, *arrays, tol=PERIPHERY_TOL):
        torch.manual_seed(0)
        net = build()
        card = build().to(device)
        card.load_state_dict(net.state_dict())
        both(name, lambda *xs: (card if xs[0].is_cuda else net)(*xs), *arrays, tol=tol)

    tn_x = rng.normal(size=(16, feat_hw, feat_hw, width)).astype(np.float32)
    module('TransNorm', lambda: TransNorm(width).train(), tn_x)
    soft = np.asarray(torch.softmax(torch.from_numpy(
        rng.normal(size=(8, size, size, 6)).astype(np.float32)), -1))
    module('FCDiscriminator', lambda: FCDiscriminator(6), soft)
    module('FCDiscriminatorLocal', lambda: FCDiscriminatorLocal(6 + width),
           np.concatenate([soft[:, ::size // feat_hw, ::size // feat_hw], feat], -1))
    module('PixelDiscriminator', lambda: PixelDiscriminator(6), soft[:, ::size // feat_hw, ::size // feat_hw])
    x2 = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    module('DeeplabV2MMD', lambda: DeeplabV2MMD(
        mmd, num_classes=6, inchannels=ResNet(mmd).out_channels).train(), x2, tol=DEEP_TOL)
    module('SpixelNet', lambda: SpixelNet().train(), x2)
    print(f'[periphery] on the card against the CPU (f32, TF32 off): the mixes and the EMA '
          f'of ResNet-101\'s parameters equal; largest gaps '
          + ', '.join(f'{k} {v:.3g}' for k, v in worst.items() if v)
          + f' (limit {PERIPHERY_TOL}, DeeplabV2MMD {DEEP_TOL}); '
          f'{time.perf_counter() - t0:.1f} s')


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
    bare = phase_train(device)   # zeroes the count again before its stage-3 steps
    record['launches'] = bare['stage2_launches']
    if record['launches'] < 3:
        raise AssertionError(f'segment_hist launched {record["launches"]} times '
                             f'in 3 stage-2 steps; LRH did not go through the kernel')
    remat = phase_remat(device, bare)   # zeroes the count before each of its runs
    record['launches_stage2_remat'] = remat['stage2']
    record['launches_stage3_remat'] = remat['stage3']
    parallel = phase_parallel(device, bare)   # zeroes the count before each of its runs
    record['launches_parallel_stage2'] = parallel['stage2']
    record['launches_parallel_stage3'] = parallel['stage3']
    record['launches_parallel_global_bn'] = parallel['global_bn']
    torch.cuda.empty_cache()
    two = phase_parallel_two(bare)
    if two is not None:
        record['launches_two_ranks'] = two['launches']
        from regda_tpu_torch.entry import dryrun_data_parallel
        t0 = time.perf_counter()
        dryrun_data_parallel(2, device, backend='gloo')     # raises if a rank fails
        print(f'[parallel] dryrun_data_parallel(2) on cuda:0 over gloo: '
              f'{time.perf_counter() - t0:.1f} s')
    for k in [k for k in bare if k.endswith(('_bn', '_bn1', '_state', '_protos1'))]:
        del bare[k]
    torch.cuda.empty_cache()

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
    torch.cuda.empty_cache()
    phase_data_mesh()
    phase_periphery(device)
    torch.cuda.empty_cache()

    import tempfile
    with tempfile.TemporaryDirectory(prefix='regda_kept_') as kept:
        # zeroes the histogram's count just before its stage-2 and stage-3 CLI runs
        stages = phase_stages(device, bare, keep=kept)
        record['launches_stages'] = stages['stage2']
        record['launches_stage3'] = stages['stage3']
        record['launches_stage3_bare'] = bare['stage3_launches']
        torch.cuda.empty_cache()
        # zeroes every SAM kernel's count just before the stability check
        prep = phase_prep(device, kept)
    for rec, key in ((ln_record, 'layernorm'), (attn_record, 'rel_attention'),
                     (tw_record, 'two_way'), (up_record, 'upscale'),
                     (stb_record, 'stability_blocked'), (stf_record, 'stability_fused'),
                     (stats_record, 'mask_stats')):
        rec['launches_stability_check'] = prep[key]

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
