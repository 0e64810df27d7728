"""Serving driver: the continuous-batching engine over synthetic requests
(``repro/launch/serve.py``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --requests 16 --device cpu

It serves the reduced (smoke) config of ``--arch`` (yi-9b by default, as
in the reference) with weights drawn from seed 0, on the card unless
``--device cpu``.  It serves the archs of ``repro_torch.configs.PORTED``
but the vlm and encdec families, which the engine refuses (its requests
carry tokens only, as the reference's do).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import build
from repro_torch.serve import Engine, Request


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_smoke(args.arch)
    model = build(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    eng = Engine(model, params, n_slots=args.slots, max_len=args.max_len,
                 device=args.device)

    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        n = int(rng.integers(3, 12))
        reqs.append(Request(
            uid=uid, prompt=[int(t) for t in rng.integers(1, cfg.vocab, n)],
            max_new_tokens=args.max_new, temperature=args.temperature,
        ))
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in reqs)
    print(f"arch={args.arch} slots={args.slots} requests={args.requests} "
          f"device={model.device}")
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks/dt:,.1f} tok/s, {eng.steps} engine steps, "
          f"{toks/max(eng.steps,1):.2f} tokens/step batching efficiency)")
    assert all(r.done for r in reqs)


if __name__ == "__main__":
    main()
