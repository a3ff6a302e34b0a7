"""Serving driver: prefill a prompt batch, then batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        [--tiny] --batch 4 --prompt-len 32 --gen 16 [--device cuda|cpu]

Prefill feeds the prompt one token at a time through the decode step
(``models.decode_step``, which writes each layer group's cache once a
step); decode then takes the argmax of each step's logits. An
encoder-decoder config attends, at every step, encoder keys and values
drawn as the JAX driver draws them: one standard normal of (n_layers,
batch, prompt_len, heads, head_dim) from a stream of its own, used as
both k and v (not the encoder's output). The step and
the argmax run once on a throwaway cache before any timer starts, and
prefill (prompt ingestion, latency-bound) is timed apart from decode
(generation, throughput-bound). Parameters and compute are float32, as in
the JAX driver, drawn from a generator seeded 0 on the device.
Counterpart of ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from ..configs import get_config
from ..data.synthetic import step_generator
from ..kernels.backend import resolve_device
from ..models import decode_step, init_caches, init_params
from ..models.model import effective_window


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None,
         params=None) -> Dict:
    """Run the driver; returns ``{"prompt", "generated", "prefill_ms",
    "decode_s", "decode_tok_s", "params"}``. ``params`` (the port's, on the
    device) replaces the seeded initialisation."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    if params is None:
        params = init_params(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
    B = args.batch
    s_max = args.prompt_len + args.gen
    caches = init_caches(cfg, B, s_max, device=device)
    win = effective_window(cfg, s_max)
    tok = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                        generator=step_generator(0, 1)).to(device)
    extra = {}
    if cfg.input_kind == "encdec":
        enc = torch.randn((cfg.n_layers, B, args.prompt_len, cfg.n_heads,
                           cfg.head_dim), generator=step_generator(0, 2))
        enc = enc.to(device=device, dtype=cfg.cdtype)
        extra["enc_kv"] = {"k": enc, "v": enc}

    def step(batch, cache):
        return decode_step(params, cfg, batch, cache, window=win)

    def step_batch(i, cur):
        """Inputs of one single-token step (fresh embeddings each step)."""
        if cfg.input_kind == "embeds":
            emb = torch.randn((B, 1, cfg.d_model),
                              generator=step_generator(0, 3, i))
            return {"embeds": emb.to(device), **extra}
        return {"tokens": cur, **extra}

    # warm up the step and the greedy glue on a throwaway cache, outside
    # every timed region
    warm_logits, _ = step(step_batch(0, tok[:, :1]),
                          init_caches(cfg, B, s_max, device=device))
    torch.argmax(warm_logits[:, -1], dim=-1)[:, None]
    _sync(device)
    del warm_logits

    t0 = time.perf_counter()
    logits = None
    for i in range(args.prompt_len):
        logits, caches = step(step_batch(i, tok[:, i:i + 1]), caches)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t1 = time.perf_counter()
    out_toks = []
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(args.gen):
        out_toks.append(cur)
        logits, caches = step(step_batch(args.prompt_len + i, cur), caches)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    gen = torch.cat(out_toks, dim=1)
    _sync(device)
    t_decode = time.perf_counter() - t1

    decode_toks_s = B * args.gen / t_decode if t_decode else float("inf")
    print(f"[serve] device={device} prefill: {B}x{args.prompt_len} tokens "
          f"in {t_prefill * 1e3:.1f}ms "
          f"({t_prefill * 1e3 / args.prompt_len:.2f}ms/step)")
    print(f"[serve] decode:  generated {tuple(gen.shape)} in "
          f"{t_decode:.2f}s ({decode_toks_s:.1f} tok/s)")
    print(gen[0].tolist())
    return dict(prompt=tok, generated=gen,
                prefill_ms=t_prefill * 1e3 / args.prompt_len,
                decode_s=t_decode, decode_tok_s=decode_toks_s, params=params)


if __name__ == "__main__":
    main()
