#!/usr/bin/env python3
"""Compare the serving throughput of two checkouts of the port on one card.

``python3 serve_ab.py A_ROOT B_ROOT`` serves ``chip_smoke.py``'s headline
traffic (same model, weights and requests) through each checkout's
``ContinuousBatcher.run_waves(device_results=True)`` and ``run``, over bf16,
int8 and fp8 pools. Each checkout runs in a process of its own (both name
their package ``beholder_tpu_torch``), in the order A, B, B, A, repeated
``--rounds`` times, so a drift of the shared host during the call shows as
spread among the A processes. Each process warms each path once, then times
``--runs`` calls (host clock, each ended by a synchronise). Prints each
process's median tokens/s per path, then per path the median over B's
processes over the median over A's, beside the spread (max - min over
median) of each side. The record goes to ``chiprun_out/serve_ab.json``.

``--train`` times the training step instead: ``chip_smoke.py``'s headline
training model, flash and ring (P = 4 on the one card), ``TRAIN_STEPS``
``seq_train_step``s each (CUDA events, steps 2 on), and records to
``chiprun_out/train_ab.json``. Needs one CUDA card and nvcc; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PATHS = [f"{family}/{mode}" for family in ("bf16", "int8", "fp8")
         for mode in ("run_waves", "run")]
TRAIN_PATHS = ["train/flash", "train/ring"]


def load_smoke():
    """This checkout's ``chip_smoke.py`` (traffic, pool shape, timers),
    loaded by path: A's root may hold another one."""
    spec = importlib.util.spec_from_file_location("_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(root: str, runs: int, train: bool) -> None:
    """Serve the traffic (or, with ``train``, take the training steps)
    through ``root``'s package; print one JSON line of seconds per timed
    call."""
    sys.path.insert(0, str(Path(root).resolve()))
    smoke = load_smoke()
    import torch

    import beholder_tpu_torch
    from beholder_tpu_torch import csrc
    from beholder_tpu_torch.models import TelemetrySequenceModel
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request

    pkg = Path(beholder_tpu_torch.__file__).resolve().parent.parent
    if pkg != Path(root).resolve():
        raise RuntimeError(f"imported the package from {pkg}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if train:
        train_child(root, smoke, torch)
        return
    csrc.build("paged_decode")
    model = TelemetrySequenceModel(dim=512, heads=8, kv_heads=2, layers=4)
    load_flax_params(model, init_params(model, seed=0, bf16_matrices=True))
    rng = np.random.default_rng(0)
    wave_reqs = smoke.make_requests(rng, Request, [256] * 8, [128] * 8)
    run_reqs = smoke.make_requests(rng, Request, [256] * 12, smoke.RUN_HORIZONS)
    seconds = {}
    for path in PATHS:
        family, mode = path.split("/")
        b = ContinuousBatcher(model, **smoke.SERVE, cache_dtype=family)
        reqs = run_reqs if mode == "run" else wave_reqs

        def serve():
            if mode == "run":
                return b.run(reqs)
            return b.run_waves(reqs, device_results=True)

        serve()
        seconds[path] = dict(tokens=sum(r.horizon for r in reqs),
                             seconds=smoke.timed(torch, serve, runs=runs))
    print(json.dumps({"root": root, "paths": seconds}), flush=True)


def train_child(root: str, smoke, torch) -> None:
    """``chip_smoke.py``'s training runs, flash and ring, through
    ``root``'s package: seconds of each step after the first."""
    from beholder_tpu_torch import csrc
    from beholder_tpu_torch.models import TelemetrySequenceModel, init_seq_state
    from beholder_tpu_torch.ops import flash_attention as fa
    from beholder_tpu_torch.parallel import Mesh

    csrc.build("flash_fwd", "flash_bwd")
    feats, targets = smoke.train_streams(torch, 0, smoke.TRAIN_B, smoke.TRAIN_T)
    models = {
        "train/flash": smoke.TRAIN_MODEL,
        "train/ring": {**smoke.TRAIN_MODEL, "attention": "ring",
                       "mesh": Mesh(["cuda:0"] * smoke.RING_P)},
    }
    seconds = {}
    for path, kw in models.items():
        state = init_seq_state(0, TelemetrySequenceModel(**kw))
        state, losses, step_ms, _, _ = smoke.train_steps(torch, fa, state, feats, targets)
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{path}: losses not finite {losses}")
        seconds[path] = dict(tokens=smoke.TRAIN_B * smoke.TRAIN_T,
                             seconds=[ms / 1e3 for ms in step_ms[1:]])
        del state
    print(json.dumps({"root": root, "paths": seconds}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a_root", nargs="?")
    parser.add_argument("b_root", nargs="?")
    parser.add_argument("--runs", type=int, default=5, help="timed calls per path")
    parser.add_argument("--rounds", type=int, default=1, help="A, B, B, A repeats")
    parser.add_argument("--train", action="store_true",
                        help="time the training step (flash, ring) instead of serving")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.child, args.runs, args.train)
        return
    if not (args.a_root and args.b_root):
        parser.error("give two checkout roots, A and B")
    card = load_smoke().card_line()
    print(card, flush=True)
    order = [("A", args.a_root), ("B", args.b_root), ("B", args.b_root),
             ("A", args.a_root)] * args.rounds
    procs = []
    for label, root in order:
        out = subprocess.run(
            [sys.executable, __file__, "--child", root, "--runs", str(args.runs)]
            + ["--train"] * args.train,
            capture_output=True, text=True, timeout=900,
        )
        if out.returncode != 0:
            sys.exit(f"serve_ab: {label} ({root}) failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["label"] = label
        procs.append(rec)
        medians = {
            p: v["tokens"] / statistics.median(v["seconds"]) for p, v in rec["paths"].items()
        }
        print(f"{label} {root}: " + " ".join(f"{p}={t:.1f}" for p, t in medians.items()),
              flush=True)
    summary = {}
    for path in TRAIN_PATHS if args.train else PATHS:
        med = {"A": [], "B": []}
        for r in procs:
            v = r["paths"][path]
            med[r["label"]].append(v["tokens"] / statistics.median(v["seconds"]))
        a, b = statistics.median(med["A"]), statistics.median(med["B"])
        spread = {k: (max(m) - min(m)) / statistics.median(m) for k, m in med.items()}
        summary[path] = dict(tokens_per_s=med, b_over_a=b / a, spread=spread)
        print(f"{path:14s} A {a:7.1f} (spread {spread['A']:.4f})  B {b:7.1f} "
              f"(spread {spread['B']:.4f})  B/A {b / a:.4f}", flush=True)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / ("train_ab.json" if args.train else "serve_ab.json")).write_text(
        json.dumps({"card": card, "a": args.a_root, "b": args.b_root, "processes": procs,
                    "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
