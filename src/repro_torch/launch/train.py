"""Training launcher (``repro.launch.train`` ported):
``python -m repro_torch.launch.train --arch <id> [...]`` on the card, or
``train(arch, ..., device="cpu")`` from Python.

Without ``--full-config`` it trains the arch's ``reduced()`` variant on
synthetic LM data, as the reference does on a CPU; with it, the published
config.  Federated mode (``--groups G --sync-every H``) is the paper's
technique: G model replicas train locally, each on its own
``SyntheticLMStream`` and with its own optimiser, and their parameters are
averaged (Eq. 1, ``steps.federated_sync``) every H steps.

Data and seeds follow the reference: stream g is ``SyntheticLMStream(
vocab, seed=g)`` sampled at ``seed = 1000·step + g`` (the same tokens
byte for byte), and group g's weights are ``init`` at seed g.  The
modality inputs (``extra_input_shapes``: whisper's frames) come from one
``torch.Generator`` at seed 0, drawn in (step, group) order, where the
reference splits one key: the same distribution, other bits.  deepseek-v2
and arctic train with adafactor at ``warmup_cosine(1e-3, ...)``, every
other arch with adamw at ``warmup_cosine(3e-4, ...)``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from repro_torch.checkpoint import save_round
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.lm import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import federated_sync, make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.tree import tree_leaves, tree_map

ADAFACTOR_ARCHS = ("deepseek-v2-236b", "arctic-480b")


@dataclass
class TrainResult:
    """One ``train`` run: ``losses[step][group]`` (floats), ``step_s`` the
    seconds of each step (all groups and the sync, host clock ending in a
    synchronise), the parameter count of one model, the peak device memory
    (GiB allocated, None on the CPU), and the groups' final params."""
    losses: List[List[float]]
    step_s: List[float]
    n_params: int
    peak_gib: Optional[float]
    params: list


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_optimizer(arch: str, steps: int):
    """The reference's choice: adafactor for the giant MoE configs, adamw
    otherwise, each on a 10-step warm-up and a cosine to ``max(100,
    steps)``."""
    if arch in ADAFACTOR_ARCHS:
        return adafactor(warmup_cosine(1e-3, 10, max(100, steps)))
    return adamw(warmup_cosine(3e-4, 10, max(100, steps)))


def _fmt(losses):
    return [f"{l:.3f}" for l in losses]


def train(arch: str, *, steps: int = 20, batch: int = 4, seq: int = 128,
          groups: int = 1, sync_every: int = 5, full_config: bool = False,
          microbatches: int = 1, ckpt_dir: Optional[str] = None,
          device=None, init_params: Optional[Sequence] = None
          ) -> TrainResult:
    """Train ``groups`` replicas of ``arch`` for ``steps`` steps of
    ``batch`` sequences of ``seq`` tokens, syncing every ``sync_every``
    steps when ``groups > 1`` and saving group 0's params with
    ``save_round`` every 10th step when ``ckpt_dir`` is given.

    ``init_params`` (one param tree a group) replaces the inits at seeds
    0..G-1, e.g. with the reference's weights."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if not full_config:
        cfg = cfg.reduced(max_seq_len=max(512, seq))
    model = build_model(cfg)
    G = groups
    if init_params is None:
        params_g = [model.init(torch.Generator(device=dev).manual_seed(g))
                    for g in range(G)]
    else:
        if len(init_params) != G:
            raise ValueError(f"init_params holds {len(init_params)} trees "
                             f"for {G} groups")
        params_g = [tree_map(lambda a: a.to(dev), p) for p in init_params]
    n = sum(a.numel() for a in tree_leaves(params_g[0]))
    print(f"arch={arch} ({'full' if full_config else 'reduced'}) "
          f"params={n/1e6:.1f}M groups={G}")

    opt = make_optimizer(arch, steps)
    step_fn = make_train_step(model, opt, num_microbatches=microbatches)
    streams = [SyntheticLMStream(vocab=cfg.vocab_size, seed=g)
               for g in range(G)]
    opt_g = [opt.init(p) for p in params_g]
    extras_shapes = model.extra_input_shapes(batch, seq)
    extras_gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    all_losses, step_s = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for step in range(steps):
        t_step = time.perf_counter()
        losses = []
        for g in range(G):
            toks, tgt = streams[g].sample(batch, seq, seed=1000 * step + g)
            b = {"tokens": torch.from_numpy(toks).to(dev),
                 "targets": torch.from_numpy(tgt).to(dev)}
            for k, shp in extras_shapes.items():
                b[k] = torch.randn(shp, generator=extras_gen, device=dev)
            params_g[g], opt_g[g], m = step_fn(params_g[g], opt_g[g], b,
                                               step)
            losses.append(float(m["loss"]))
        synced = G > 1 and (step + 1) % sync_every == 0
        if synced:
            stacked = tree_map(lambda *xs: torch.stack(xs), *params_g)
            mean = federated_sync(stacked)
            params_g = [tree_map(lambda x: x[g], mean) for g in range(G)]
            del stacked, mean
        _sync(dev)
        step_s.append(time.perf_counter() - t_step)
        all_losses.append(losses)
        if synced:
            print(f"step {step+1:4d} losses={_fmt(losses)} [sync]")
        elif (step + 1) % 5 == 0 or step == 0:
            print(f"step {step+1:4d} losses={_fmt(losses)} "
                  f"({time.perf_counter()-t0:.0f}s)")
        if ckpt_dir and (step + 1) % 10 == 0:
            save_round(ckpt_dir, step + 1, fog_model=params_g[0],
                       metadata={"loss": losses[0], "arch": arch})
    print(f"trained {steps} steps in {time.perf_counter()-t0:.0f}s; "
          f"final losses={_fmt(all_losses[-1]) if steps else []}")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    return TrainResult(losses=all_losses, step_s=step_s, n_params=n,
                       peak_gib=peak, params=params_g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--groups", type=int, default=1,
                    help=">1 enables the federated schedule")
    ap.add_argument("--sync-every", type=int, default=5)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          groups=args.groups, sync_every=args.sync_every,
          full_config=args.full_config, microbatches=args.microbatches,
          ckpt_dir=args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
