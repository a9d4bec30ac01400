"""Batched serving: prefill a prompt batch, then decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The counterpart of ``repro/launch/serve.py``: the model's weights are
random (drawn from ``--seed``), the prompt is the Zipf ``TokenStream``'s
first batch, and decoding is greedy or, with ``--temperature``, sampled
from a generator seeded ``--seed + 1``.  Times end in
``torch.cuda.synchronize()`` on the card.  Runs on ``cuda`` unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, flash_attention
from repro_torch.models import api


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: api.Model, prompt: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Dict:
    """Prefill ``prompt [B, S]`` into a cache of ``S + gen`` slots, then
    decode: the first token from the prefill's logits, ``gen - 1`` more
    from decode steps.  Greedy at temperature 0, else sampled from
    ``softmax(logits / temperature)`` with ``generator``.  Returns the
    tokens ``[B, gen]`` and the prefill and decode wall times (s)."""
    dev = model.device
    b, s = prompt.shape

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if temperature > 0:
            p = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(p, 1, generator=generator)[:, 0]
        return logits.argmax(-1)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompt}, max_len=s + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tokens = pick(logits)
    out: List[torch.Tensor] = [tokens]
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode_step(cache, tokens)
        tokens = pick(logits)
        out.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    return {"tokens": torch.stack(out, 1), "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be at least 1")

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    dev = resolve_device(args.device)
    if dev.type == "cuda":      # build the kernel before the timed prefill
        _build.load(flash_attention.SOURCE)
    model = api.build(cfg, dev,
                      torch.Generator(device=dev).manual_seed(args.seed))
    prompt = TokenStream(cfg, args.batch, args.prompt_len,
                         seed=args.seed).batch_at(0)["tokens"]
    prompt = prompt[:, :args.prompt_len].to(dev)
    sampler = torch.Generator(device=dev).manual_seed(args.seed + 1)
    res = generate(model, prompt, args.gen, temperature=args.temperature,
                   generator=sampler)

    prefill_tok = args.batch * args.prompt_len
    gen_tok = args.batch * (args.gen - 1)
    print(f"arch={cfg.name} batch={args.batch} device={dev}")
    print(f"prefill: {prefill_tok} tok in {res['prefill_s']:.3f}s "
          f"({prefill_tok / res['prefill_s']:.0f} tok/s)")
    print(f"decode:  {gen_tok} tok in {res['decode_s']:.3f}s "
          f"({gen_tok / max(res['decode_s'], 1e-9):.0f} tok/s)")
    print("sample token ids:", res["tokens"][0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
