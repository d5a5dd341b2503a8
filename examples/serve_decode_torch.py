"""Batched decode serving of an assigned architecture (reduced config),
on the PyTorch port: the counterpart of ``examples/serve_decode.py``.

Prefills a batch of prompts by streaming them through the decode cache,
then decodes greedy tokens against it with the same `lm.decode_step`
that `repro_torch.launch.serve.build_decode_step` runs.  Text-only
archs: the dense, moe, ssm and hybrid families (a vlm or encdec arch is
refused, as in the JAX example).

    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
    PYTHONPATH=src python examples/serve_decode_torch.py --arch zamba2-7b
    PYTHONPATH=src python examples/serve_decode_torch.py   # on the card
"""
import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit(f"{args.arch}: use a text-only arch for this demo")
    B, T = args.batch, args.prompt_len
    params = lm.init_params(prng.PRNGKey(0, dev), cfg)
    prompts = prng.randint(prng.PRNGKey(1, dev), (B, T), 0,
                           cfg.vocab).to(torch.int32)

    # "prefill" by streaming the prompt through the decode cache (what
    # tests/test_torch_lm.py holds against the flash prefill)
    cap = T + args.new_tokens
    cache = lm.init_decode_cache(cfg, B, cap, device=dev)
    for _, t in tree_leaves(cache):     # an empty cache: pos 0, zero state
        t.zero_()

    def dstep(c, t):
        return lm.decode_step(params, c, {"tokens": t}, cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(T):
        logits, cache = dstep(cache, prompts[:, t:t + 1])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [prompts]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens):
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out.append(nxt)
        logits, cache = dstep(cache, nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.cat(out, dim=1).cpu()
    print(f"arch={args.arch} ({cfg.family}), B={B}, device={dev}")
    print(f"prefill: {1e3 * t_prefill / T:.1f} ms/tok | "
          f"decode: {1e3 * t_decode / args.new_tokens:.1f} ms/tok")
    for b in range(min(B, 2)):
        print(f"  seq[{b}]: {toks[b, T:T + 12].tolist()} ...")
    return {"tokens": toks, "logits": logits.cpu(),
            "prefill_ms_per_token": 1e3 * t_prefill / T,
            "decode_ms_per_token": 1e3 * t_decode / args.new_tokens}


if __name__ == "__main__":
    main()
