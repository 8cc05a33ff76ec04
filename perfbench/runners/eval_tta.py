"""Runner of the eval-TTA traffic: one client in a closed loop sends one
normalised tile at a time to the port's `SegInferencer.predict_labels(tile,
slide=True, tta=True)`, the call the eval CLI makes under `--tta 1`, numpy
in and labels on the host out, and sends the next when they are back. The
tiles are a pool made from the seed and cycled.

Set-up builds the program's segmenter on the card from seeded weights and
BatchNorm statistics and its inferencer as the eval CLI does (BN folding
and the fused heads at their defaults), and serves `warmup` tiles.

The check frees the program, runs the plain reference (reference/eval_tta.py)
once over each pool tile, and judges every answer of the window: the widest
gap by which the probability of a label it served lies below the best
class's. An answer over the limit counts as failed.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from perfbench import harness, inputs
from perfbench.runners.stage_step import build_model
from perfbench.reference import deeplabv2 as ref_model
from perfbench.reference import eval_tta as ref_eval


def setup(cell, seed: int, device):
    from regda_tpu_torch import infer
    from regda_tpu_torch.utils.tools import disable_tf32

    disable_tf32()
    m, ev, mix = cell.config['model'], cell.config['eval'], cell.mix
    model = build_model(m, inputs.seeded_weights(ref_model.shapes(m), seed, device), device)
    inferencer = infer.SegInferencer(model.eval(), m['num_classes'], tile=ev['tile'],
                                     stride=ev['stride'])
    pool = inputs.eval_tiles(seed, mix['pool'], mix['tile'], *ev['target_stats'])
    for i in range(mix['warmup']):
        inferencer.predict_labels(pool[i % len(pool)], slide=True, tta=True)
    return types.SimpleNamespace(cell=cell, seed=seed, device=device, inferencer=inferencer,
                                 pool=pool, order=np.random.default_rng(
                                     inputs.sub_seed(seed, 5)).permutation(len(pool)))


def window(system, seconds: float, tracer) -> dict:
    inferencer, pool, order = system.inferencer, system.pool, system.order
    answers, latencies = [], []
    tracer.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = int(order[len(answers) % len(order)])
        sent = time.perf_counter()
        labels = inferencer.predict_labels(pool[i], slide=True, tta=True)
        latencies.append(time.perf_counter() - sent)
        answers.append((i, labels))
        tracer.item_done()
    window_s = time.perf_counter() - t0
    return {'tiles': len(answers), 'window_s': window_s, 'latencies_s': latencies,
            'answers': answers, 'tile': system.cell.mix['tile']}


def reference_probs(cell, seed: int, pool: list, device, tiles, tf32: bool = False) -> dict:
    """Pool index -> the reference's (1, C, H, W) probabilities of that tile."""
    m, ev = cell.config['model'], cell.config['eval']
    with ref_model.tf32(tf32):
        model = ref_model.build(m).to(device).eval()
        model.load_state_dict(inputs.seeded_weights(ref_model.shapes(m), seed, device))
        return {i: ref_eval.slide_tta_probs(model, torch.from_numpy(pool[i]).to(device),
                                            m['num_classes'], ev['tile'], ev['stride'])
                for i in sorted(tiles)}


def gaps(answers, probs: dict, device) -> list:
    """The widest gap of each answer (pool index, (1, H, W) labels)."""
    return [ref_eval.widest_gap(probs[i], torch.from_numpy(labels[0]).to(device))
            for i, labels in answers]


def check(system, samples) -> harness.Check:
    system.inferencer = None
    gc.collect()
    if system.device.type == 'cuda':
        torch.cuda.empty_cache()
    answers = samples['answers']
    probs = reference_probs(system.cell, system.seed, system.pool, system.device,
                            {i for i, _ in answers})
    found = gaps(answers, probs, system.device)
    limit = system.cell.limits['prob_gap']
    widest = max(found) if found else float('inf')
    return harness.Check({'prob_gap': widest}, system.cell.limits, len(answers),
                         sum(1 for g in found if not g <= limit))


def control(cell, seed: int, device) -> dict:
    """The numbers of the control: the labels of the reference in TF32, the
    precision below the configuration's float32 with TF32 off, judged
    against the reference, over every tile of the pool."""
    pool = inputs.eval_tiles(seed, cell.mix['pool'], cell.mix['tile'],
                             *cell.config['eval']['target_stats'])
    tiles = range(len(pool))
    low = reference_probs(cell, seed, pool, device, tiles, tf32=True)
    answers = [(i, low[i].argmax(1).to(torch.uint8).cpu().numpy()) for i in tiles]
    return {'prob_gap': max(gaps(answers, reference_probs(cell, seed, pool, device, tiles),
                                device))}
