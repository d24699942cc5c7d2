"""Serving launcher (``repro.launch.serve`` ported):
``python -m repro_torch.launch.serve --arch <id> [...]`` on the card, or
``serve(arch, ..., device="cpu")`` from Python.

Batched request serving: prefill the prompt batch, then step the decode
loop against the per-family KV, latent and recurrent caches, or
whisper's self and cross caches (``models.api``).  Without
``--full-config`` it serves the family's ``reduced()`` config, as the
reference does on a CPU.

Weights, prompts, the modality inputs (``extra_input_shapes``: image
embeddings, or whisper's frames ``[batch, prompt_len, d_model]``, the
reference's rule) and samples come from ``torch.Generator``s seeded from
``seed`` (weights at ``seed``, prompts at ``seed + 1``, the modality
inputs at ``seed + 2``, sampling at ``seed + 3``),
where the reference splits JAX keys 0-3: other bits, the same
distributions.  Greedy decoding (``temperature`` 0) draws nothing at
decode time and is the case the parity checks hold.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.api import build_model
from repro_torch.tree import tree_leaves


@dataclass
class ServeResult:
    """One ``serve`` run: ``tokens [B, max_new_tokens]`` (the model's
    choices), the ``prompts [B, prompt_len]``, with ``keep_logits`` every
    step's next-token logits ``[B, max_new_tokens, vocab]``; prefill and
    decode seconds (host clock, ending in a synchronise) and decode tokens
    a second, as the reference counts them (``B · max_new_tokens /
    decode_s``)."""
    tokens: torch.Tensor
    prompts: torch.Tensor
    logits: Optional[torch.Tensor]
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    n_params: int
    max_cache_len: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32,
          max_new_tokens: int = 16, temperature: float = 0.0,
          full_config: bool = False, device=None, impl: str = "auto",
          seed: int = 0, dtype: Optional[torch.dtype] = None,
          forced: Optional[torch.Tensor] = None,
          keep_logits: bool = False) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``max_new_tokens`` (the first from the prefill's logits), the
    caches ``prompt_len + max_new_tokens + 1`` slots long.

    ``impl`` is the attention route of every prefill and decode call
    (``"pallas"``: the flash-attention kernel).  ``dtype`` sets the
    params, activations and attention caches (default: the config's, and
    bfloat16 caches as in the reference).  ``forced [B, max_new_tokens]``
    teacher-forces the decode loop: step i feeds ``forced[:, i]`` in place
    of the model's own choice, which ``tokens`` still records."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if not full_config:
        cfg = cfg.reduced(max_seq_len=prompt_len + max_new_tokens + 8)
    cache_dtype = torch.bfloat16
    if dtype is not None:
        cfg = replace(cfg, param_dtype=dtype, dtype=dtype)
        cache_dtype = dtype
    model = build_model(cfg)
    gen = lambda k: torch.Generator(device=dev).manual_seed(seed + k)
    params = model.init(gen(0))
    max_len = prompt_len + max_new_tokens + 1
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen(1), device=dev)
    extras = {k: torch.randn(shape, generator=gen(2), device=dev)
              for k, shape in model.extra_input_shapes(batch,
                                                      prompt_len).items()}
    prefill = make_prefill_step(model, max_cache_len=max_len,
                                cache_dtype=cache_dtype, impl=impl)
    decode = make_decode_step(model, impl=impl)
    sampler = gen(3)

    def sample(logits):
        last = logits[:, -1].float()
        if temperature <= 0:
            return last.argmax(dim=-1, keepdim=True)
        return torch.multinomial(torch.softmax(last / temperature, dim=-1),
                                 1, generator=sampler)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts, **extras})
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    kept = [logits[:, -1]] if keep_logits else None
    tok = sample(logits)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(max_new_tokens - 1):
        feed = tok if forced is None else forced[:, i:i + 1]
        logits, caches = decode(params, feed, caches, prompt_len + i,
                                extras=extras or None)
        if keep_logits:
            kept.append(logits[:, -1])
        tok = sample(logits)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(
        tokens=torch.cat(out, dim=1), prompts=prompts,
        logits=torch.stack(kept, dim=1) if keep_logits else None,
        prefill_s=prefill_s, decode_s=decode_s,
        tokens_per_s=batch * max_new_tokens / max(decode_s, 1e-9),
        n_params=sum(a.numel() for a in tree_leaves(params)),
        max_cache_len=max_len)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--full-config", action="store_true")
    args = ap.parse_args(argv)
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, full_config=args.full_config)
    print(f"arch={args.arch} ({'full' if args.full_config else 'reduced'}) "
          f"batch={args.batch} prompt={args.prompt_len} params "
          f"{res.n_params:,}")
    print(f"prefill: {res.prefill_s:.2f}s   decode: {args.max_new_tokens} "
          f"tokens in {res.decode_s:.2f}s ({res.tokens_per_s:.1f} tok/s)")
    gen = res.tokens.cpu()
    for b in range(min(args.batch, 2)):
        print(f"  request {b}: {gen[b][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
