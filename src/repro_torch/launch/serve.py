"""Serving launcher of the port: batched generation with a KV/SSM cache, the
CLI of ``repro/launch/serve.py`` plus ``--device``.

Runs on ``cuda`` unless ``--device cpu``; every attention decode goes
through the ``decode_attention`` kernel and every SSD chunk of a Mamba-2
prefill through ``ssd_intra_chunk`` (``--no-use-kernel`` takes the plain
PyTorch forms). Weights are random, from ``--seed``, or restored from
``--ckpt`` (a checkpoint of one model's params, as ``save_checkpoint``
writes it); prompts, then the vlm and audio frontends' stub embeddings
(``frontend_tokens`` × ``d_model`` float32 a request), are drawn from
numpy's generator of the same seed, in the reference's order.

The default cache holds ``prompt_len + max_new + 8`` positions and, for
vlm, the ``frontend_tokens`` patch positions too. The reference's default
leaves them out, so its internvl2 prefill (S + 256 > C) writes a ring
cache, and every decode step overwrites the cache's last slot.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --prompt-len 16 --max-new 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 16 --prompt-len 2048 --max-new 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \\
      --batch 16 --prompt-len 768 --max-new 64
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..checkpoint import load_checkpoint
from ..configs import get_arch, reduced_for_smoke
from ..device import resolve_device
from ..models import transformer
from ..serve import ServeConfig, ServingEngine

__all__ = ["main", "parse_args", "default_cache_len", "stub_frontend"]


def default_cache_len(cfg, prompt_len: int, max_new: int) -> int:
    """Cache positions: the prompt, the new tokens, 8 spare and, for vlm,
    the patch prefix."""
    prefix = cfg.frontend_tokens if cfg.arch_type == "vlm" else 0
    return prompt_len + prefix + max_new + 8


def stub_frontend(cfg, rng: np.random.Generator, batch: int) -> dict | None:
    """The stub frontend's embeddings, ``{"embeds": (batch, frontend_tokens,
    d_model)}`` float32 from standard normal draws of ``rng`` (None for a
    model without a frontend)."""
    if not cfg.frontend_tokens:
        return None
    return {"embeds": rng.normal(size=(batch, cfg.frontend_tokens, cfg.d_model))
            .astype(np.float32)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction, default=True,
                    help="the decode_attention / ssd_intra_chunk kernels (default); "
                         "--no-use-kernel takes the plain PyTorch forms")
    ap.add_argument("--ckpt", default=None,
                    help="npz checkpoint of one model's params to serve (from save_checkpoint)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Generate once and report; returns what ``--json-out`` writes: the
    tokens, the prefill time (to the first token), each decode step's time,
    the tokens per second and, on a card, the peak device memory."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    params = tree_map(lambda t: t.to(dev), transformer.init_params(args.seed, cfg))
    if args.ckpt:
        params, _ = load_checkpoint(args.ckpt, params)

    cache_len = args.cache_len or default_cache_len(cfg, args.prompt_len, args.max_new)
    scfg = ServeConfig(batch_size=args.batch, cache_len=cache_len,
                       max_new_tokens=args.max_new, temperature=args.temperature,
                       long_context=args.long_context, use_kernel=args.use_kernel)
    engine = ServingEngine(cfg, params, scfg, eos_id=-1)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int64).astype(np.int32)
    extra = stub_frontend(cfg, rng, args.batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, extra_inputs=extra, seed=args.seed)
    dt = time.perf_counter() - t0
    steps = engine.timings["step_s"]
    steady = steps[2:] or steps
    res = {"config": vars(args), "arch": cfg.name, "vocab_size": cfg.vocab_size,
           "device": str(dev),
           "param_count": transformer.param_count(params), "cache_len": cache_len,
           "tokens": out.tolist(), "generated_per_request": int(out.shape[1]),
           "prefill_ms": 1e3 * engine.timings["prefill_s"],
           "step_ms": [1e3 * s for s in steps],
           "steady_step_ms": 1e3 * float(np.mean(steady)) if steady else None,
           "wall_s": dt, "tokens_per_s": out.size / dt,
           "decode_tokens_per_s": args.batch / float(np.mean(steady)) if steady else None,
           "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                          if dev.type == "cuda" else None)}
    print(f"arch={cfg.name} device={dev} batch={args.batch} prompt={args.prompt_len} "
          f"generated {out.shape[1]} tokens/req in {dt:.2f}s ({out.size / dt:.1f} tok/s "
          f"incl. prefill {res['prefill_ms']:.1f} ms)", flush=True)
    for i in range(min(args.batch, 2)):
        print(f"  req{i}: {out[i][:16].tolist()}{'...' if out.shape[1] > 16 else ''}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.json_out}")
    return res


if __name__ == "__main__":
    main()
