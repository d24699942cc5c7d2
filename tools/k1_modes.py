#!/usr/bin/env python3
"""The acquisition-score kernel's (K1's) two modes, timed against each other
on one CUDA card: the measurements behind ``launch_plan``'s choices.

    python3 tools/k1_modes.py

from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
CUDA PyTorch.  For each shape ``[D, T, W, C]`` it checks both modes against
the plain version (atol 1e-4 from C = 32768 on, 1e-5 below), then times
them with ``chip_smoke.py``'s ``timed`` (profiler device time) in turns
warp, split, split, warp.  The shapes are the LeNet paths' (C = 10), the
LM paths' (C = 32768, 50288), and class counts between them at the LM
fleet's 256 rows, the paper's 800 and the massive path's 8192: where the
warp mode gives way to the split mode (``SPLIT_MIN_C``).  Last, path A's
shape in the split mode at each number of class slices (the plan picks
one).  It prints the card's name and power limit first.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# [D, T, W, C]: the paper and massive paths; the LM paths; C between them
SHAPES = ([(4, 16, 200, 10), (256, 4, 32, 10)]
          + [(8, 4, 32, C) for C in (32, 64, 128, 256, 512, 1024, 2048,
                                     4096, 32768, 50288)]
          + [(4, 16, 200, C) for C in (64, 256, 1024, 4096)]
          + [(256, 4, 32, C) for C in (64, 256, 1024, 4096)])
PATH_A = (8, 4, 32, 50288)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_modes: torch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import acquisition_scores as k1

    print(f"card: {cs.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    match = "acquisition_scores_kernel"
    rows_out = []
    for shape in SHAPES:
        D, T, W, C = shape
        lp = cs.k1_inputs(torch, gen, shape)
        plans = {"warp": k1.LaunchPlan("warp", 1, k1.THREADS, 1),
                 "split": k1._split_plan(D * W, C, lp.dtype, True)}
        want = k1.acquisition_scores_plain(lp)
        tol = 1e-4 if C >= 32768 else 1e-5
        for mode, plan in plans.items():
            err = cs.max_err(torch, k1._launch(lp, plan), want)
            if not err <= tol:
                raise AssertionError(f"{shape} {mode}: max_abs_err {err}")
        run = {m: (lambda p=p: k1._launch(lp, p)) for m, p in plans.items()}
        turns = [cs.timed(torch, run[m], match)
                 for m in ("warp", "split", "split", "warp")]
        if any(how != "profiler (device)" for _, how, _ in turns):
            raise AssertionError(f"{shape}: no device time for a turn")
        warp = (turns[0][0] + turns[3][0]) / 2
        split = (turns[1][0] + turns[2][0]) / 2
        chosen = k1.launch_plan(D * W, T, C, lp.dtype).mode
        print(f"  {list(shape)}: warp {turns[0][0]:.5f}, {turns[3][0]:.5f} "
              f"ms; split ({plans['split'].slices} slice(s), vec "
              f"{plans['split'].vec}) {turns[1][0]:.5f}, {turns[2][0]:.5f} "
              f"ms; split/warp {split / warp:.3f}; the plan picks {chosen}")
        rows_out.append({"shape": list(shape), "warp_ms": [turns[0][0],
                                                           turns[3][0]],
                         "split_ms": [turns[1][0], turns[2][0]],
                         "slices": plans["split"].slices,
                         "vec": plans["split"].vec, "plan": chosen})
        del lp, want
        torch.cuda.empty_cache()

    D, T, W, C = PATH_A
    lp = cs.k1_inputs(torch, gen, PATH_A)
    vec = k1.launch_plan(D * W, T, C, lp.dtype).vec
    by_slices = {}
    for S in (1, 2, 4, 8):
        plan = k1.LaunchPlan("split", S, k1.THREADS, vec)
        ms, how, _ = cs.timed(torch, lambda: k1._launch(lp, plan), match)
        if how != "profiler (device)":
            raise AssertionError(f"path A, {S} slices: no device time")
        by_slices[S] = ms
    print(f"  path A {list(PATH_A)} split by slices: " + ", ".join(
        f"{S}: {ms:.5f} ms" for S, ms in by_slices.items())
        + f"; the plan picks {k1.launch_plan(D * W, T, C, lp.dtype).slices}")
    print(json.dumps({"modes": rows_out, "path_a_by_slices": by_slices}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
