#!/usr/bin/env python3
"""Time the paged decode kernel of two checkouts on one card, in turns.

    python3 decode_ab.py A_DIR B_DIR [--turns 2]

Each turn is a process started in A_DIR or B_DIR, in the order A, B, B, A
(repeated ``--turns`` times). It builds that checkout's
``beholder_tpu_torch/csrc/paged_decode.cu``, checks the kernel against the
checkout's own plain version (``paged_decode_reference``, within
``chip_smoke.KERNEL_TOL``), and times ``paged_decode_attention`` with CUDA
events (L2 flushed before each launch, median of 25) at ``chip_smoke.py``'s
headline and long shapes, for every pool family, window off and on. Prints
the card's name and power limit, then one line per case with both sides'
times in milliseconds, and the ratio of the medians. Needs one CUDA card;
the two checkouts must both hold ``paged_decode_attention`` with the same
Python signature.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke

#: the shapes of chip_smoke.py's decode phase that it times
SHAPES = {name: chip_smoke.DECODE_SHAPES[name] for name in chip_smoke.DECODE_TIMED}

#: runs in the checkout's directory; prints one JSON list of cases
CHILD = r"""
import json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, ".")
from beholder_tpu_torch.ops import paged_attention as pa
from beholder_tpu_torch.ops.quant import pool_quantize

shapes, tol, spin = json.loads(sys.argv[1]), float(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda")
flush = torch.empty(64 * 2**20 // 4, device=dev)

def time_ms(fn, reps=25, warm=3):
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)

cases = []
for shape, c in shapes.items():
    rng = np.random.default_rng(7)
    S, H, Hkv, Dh, page, N, P = (c[k] for k in ("S", "H", "Hkv", "Dh", "page", "N", "P"))
    q = torch.from_numpy(rng.normal(0, 1, (S, H, Dh)).astype(np.float32)).to(dev).bfloat16()
    k_f = torch.from_numpy(rng.normal(0, 1, (N, Hkv, Dh, page)).astype(np.float32)).to(dev)
    v_f = torch.from_numpy(rng.normal(0, 1, (N, Hkv, Dh, page)).astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.permutation(N)[: S * P].reshape(S, P).astype(np.int32)).to(dev)
    lens = torch.tensor(c["lens"], dtype=torch.int32, device=dev)
    for family in ("bf16", "int8", "fp8"):
        if family == "bf16":
            kp, vp, ks, vs = k_f.bfloat16(), v_f.bfloat16(), None, None
        else:
            dt = torch.int8 if family == "int8" else torch.float8_e4m3fn
            kp, ks = pool_quantize(k_f, axis=-2, values_dtype=dt)
            vp, vs = pool_quantize(v_f, axis=-2, values_dtype=dt)
        for window in (None, c["window"]):
            kw = dict(window=window, k_scale=ks, v_scale=vs)
            args = (q, kp, vp, table, lens)
            err = float((pa.paged_decode_attention(*args, **kw).float()
                         - pa.paged_decode_reference(*args, **kw).float()).abs().max())
            if not err <= tol:
                sys.exit(f"{shape}/{family}/window={window}: err {err} > {tol}")
            ms = time_ms(lambda: pa.paged_decode_attention(*args, **kw))
            cases.append(dict(shape=shape, pool=family, window=window, ms=ms, err=err))
print(json.dumps(cases))
"""


def turn(where: Path) -> list[dict]:
    out = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(SHAPES), str(chip_smoke.KERNEL_TOL),
         str(chip_smoke.SPIN_CYCLES)],
        cwd=where, capture_output=True, text=True, timeout=900,
    )
    if out.returncode != 0:
        chip_smoke.fail(f"{where}: {out.stderr.strip()[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a", type=Path)
    parser.add_argument("b", type=Path)
    parser.add_argument("--turns", type=int, default=1, help="repeats of A, B, B, A")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on the card")
    print(chip_smoke.card_line(), flush=True)
    times: dict[tuple, dict[str, list[float]]] = {}
    for _ in range(args.turns):
        for side in ("a", "b", "b", "a"):
            for c in turn(getattr(args, side)):
                key = (c["shape"], c["pool"], c["window"])
                times.setdefault(key, {"a": [], "b": []})[side].append(c["ms"])
    for (shape, pool, window), t in times.items():
        a, b = statistics.median(t["a"]), statistics.median(t["b"])
        print(f"decode {shape:8s} {pool:4s} window={window!s:5s} A ms={t['a']} B ms={t['b']} "
              f"B/A={b / a:.3f}", flush=True)


if __name__ == "__main__":
    main()
