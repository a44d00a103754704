"""Entry points: the port's counterpart of the reference's
``__graft_entry__.py``.

``entry(device=None)``            the ``ProgressAnomalyModel`` forward and its
                                  example (a batch of 256 windows), on the
                                  card unless ``device`` names another;
``dryrun_multichip(n, devices)``  every parallel cell of the reference's
                                  dryrun at its tiny shapes, each against
                                  the unsharded computation in the
                                  reference's band.

The members of ``dryrun_multichip``'s meshes sit on the visible cards,
repeated round-robin up to ``n`` (one card may hold every member), or on
``devices`` when given (``["cpu"] * 8`` runs the plain PyTorch path).
Parameters and data come from numpy seeds. In a process group of more than
one process (:func:`~beholder_tpu_torch.parallel.initialize`) ``n`` counts
every process's members, each process bringing ``n / P`` of them: every
mesh cell runs on a mesh over the processes (process ``p`` holding the
``p``-th block of ``n / P`` members in row-major order), and the two
single-batcher cells (paged serving, the what-if fork) run whole in each
process.

Run ``python -m beholder_tpu_torch.dryrun [N]`` for the dryrun on the card
(``--cpu`` on the CPU); the entry's forward runs first.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

#: the reference's dryrun cells, in its order
CELLS = ("dp×tp", "tp", "ring", "ulysses", "pipeline", "dp×pp pipeline", "dp×pp×tp pipeline",
         "zero3", "moe", "expert-choice moe", "dp×tp×sp", "sharded serving", "paged serving",
         "what-if fork")
#: the cells whose mesh spans the processes of a group; the others run one
#: batcher whole in each process
ACROSS_PROCESSES = tuple(c for c in CELLS if c not in ("paged serving", "what-if fork"))


def entry(device=None):
    """``(forward, (model, windows))``: the anomaly model's forward and a
    (256, WINDOW * FEATURES) f32 example from a numpy seed, on the card
    unless ``device`` says otherwise (the reference's ``entry()``)."""
    from beholder_tpu_torch.device import resolve_device
    from beholder_tpu_torch.models.anomaly import FEATURES, WINDOW, init_train_state

    device = resolve_device(device)
    model = init_train_state(0, device=device).model
    rng = np.random.default_rng(0)
    example = torch.from_numpy(rng.normal(size=(256, WINDOW * FEATURES)).astype(np.float32))

    def forward(model, windows):
        with torch.no_grad():
            return model(windows)

    return forward, (model, example.to(device))


def _close(name: str, got, want, tol: float) -> None:
    got, want = float(got), float(want)
    if not np.isfinite(got):
        raise AssertionError(f"non-finite {name} loss {got}")
    if abs(got - want) > tol * max(1.0, abs(want)):
        raise AssertionError(f"{name} loss {got} != unsharded {want}")


def _grads_close(name: str, grads: dict, ref: dict) -> None:
    """The reference's gradient band for its pipelines: a few bf16 eps of
    the largest leaf value (``__graft_entry__.py:271-286``)."""
    for n, rg in ref.items():
        err = float((grads[n].float() - rg.float()).abs().max())
        mag = float(rg.abs().max())
        if err > 5e-2 * max(1.0, mag):
            raise AssertionError(f"{name} grad {n} differs from sequential by {err} "
                                 f"(magnitude {mag})")


class _Run:
    """The dryrun's members, meshes, data and states."""

    def __init__(self, n: int, devices):
        from beholder_tpu_torch.parallel import process_count, serving_shard_devices

        self.n, self.procs = n, process_count()
        if n % self.procs:
            raise ValueError(f"{n} members do not split over {self.procs} processes")
        self.members = serving_shard_devices(n // self.procs, devices=devices)
        self.dev = self.members[0]
        self.every = [str(d) for d in self.members]
        if self.procs > 1:
            import torch.distributed as dist

            lists = [None] * self.procs
            dist.all_gather_object(lists, self.every)
            self.every = [d for ds in lists for d in ds]

    def mesh(self, shape, names):
        """The mesh of ``shape`` over every process's members, process ``p``
        holding the ``p``-th block of them in row-major order."""
        from beholder_tpu_torch.parallel import Mesh, process_index

        per = self.n // self.procs
        return Mesh(np.array(self.every, dtype=object).reshape(shape).tolist(), names,
                    owners=[i // per for i in range(self.n)], rank=process_index())

    def dp_tp_mesh(self, tp: int):
        """The ("dp", "tp") mesh over every process's members."""
        from beholder_tpu_torch.parallel import make_hybrid_mesh

        return make_hybrid_mesh(tp, devices=self.members)

    def streams(self, seed: int, b: int, t: int):
        """``b`` CONVERTING streams of ``t + 1`` events, from a numpy seed
        of the cell's own (so a cell's data does not depend on which cells
        ran before it)."""
        from beholder_tpu_torch.models import stream_features
        from beholder_tpu_torch.proto import TelemetryStatusEntry

        rng = np.random.default_rng(seed)
        prog = np.cumsum(1.0 + rng.normal(0, 0.05, (b, t + 1)), axis=-1)
        stats = np.full((b, t + 1), int(TelemetryStatusEntry.CONVERTING))
        return stream_features(torch.from_numpy(prog).to(self.dev),
                               torch.from_numpy(stats).to(self.dev))

    def seq_state(self, seed: int, **kw):
        from beholder_tpu_torch.models import TelemetrySequenceModel, init_seq_state

        return init_seq_state(seed, TelemetrySequenceModel(**kw, device=self.dev))


def _mlp(run: _Run) -> tuple:
    from beholder_tpu_torch.models import anomaly
    from beholder_tpu_torch.parallel import place_state, sharded_train_step
    from beholder_tpu_torch.proto import TelemetryStatusEntry

    mesh = run.dp_tp_mesh(2 if run.n % 2 == 0 else 1)
    t = 8 * max(8, run.n) + 32
    # the reference's first draw of its seed-0 stream
    progress = np.cumsum(1.0 + np.random.default_rng(0).normal(0, 0.05, t)).clip(0)
    windows, targets = anomaly.make_windows(
        torch.from_numpy(progress).to(run.dev),
        torch.full((t,), int(TelemetryStatusEntry.CONVERTING), device=run.dev))
    n = (windows.shape[0] // run.n) * run.n
    windows, targets = windows[:n], targets[:n]
    _, ref = anomaly.train_step(anomaly.init_train_state(0, device=run.dev), windows, targets)
    _, loss = sharded_train_step(place_state(anomaly.init_train_state(0, device=run.dev), mesh),
                                 windows, targets)
    _close("dp×tp", loss, ref, 1e-3)
    print(f"dryrun_multichip ok: mesh={mesh.shape} loss={float(loss):.4f} "
          f"== unsharded {float(ref):.4f}")
    return float(loss), float(ref)


def _tp(run: _Run) -> tuple:
    from beholder_tpu_torch.models import seq_train_step
    from beholder_tpu_torch.parallel import place_seq_state, sharded_seq_train_step

    mesh = run.dp_tp_mesh(2 if run.n % 2 == 0 else 1)
    feats, targets = run.streams(1, run.n, 16)
    kw = dict(dim=32, heads=4, layers=1)
    _, ref = seq_train_step(run.seq_state(7, **kw), feats, targets)
    sstate, loss = sharded_seq_train_step(place_seq_state(run.seq_state(7, **kw), mesh),
                                          feats, targets)
    _close("tp", loss, ref, 8e-3)
    tp = mesh.shape["tp"]
    whole = dict(sstate.model.named_parameters())
    for name, dim in (("q_proj", 0), ("up", 0), ("down", 1)):
        key = f"blocks.0.{name}.weight"
        want = list(whole[key].shape)
        want[dim] //= tp
        got = list(sstate.members[0][key].shape)
        if got != want:
            raise AssertionError(f"{name} shard {got}, expected {want}")
    print(f"dryrun_multichip ok: megatron dp×tp transformer (dp={mesh.shape['dp']} tp={tp}) "
          f"loss={float(loss):.4f} == unsharded {float(ref):.4f}")
    return float(loss), float(ref)


def _sequence_parallel(run: _Run) -> tuple:
    """Ring, then Ulysses, over an ``sp`` axis of every member, each one
    step against the full-attention step on the same params."""
    from beholder_tpu_torch.models import seq_train_step

    mesh = run.mesh((run.n,), ("sp",))
    seq_len = 16 * run.n
    feats, targets = run.streams(2, 2, seq_len)
    out = []
    for name, label, seed, heads, tol in (("ring", "ring attention", 1, 2, 4e-3),
                                          ("ulysses", "ulysses all-to-all", 5, run.n, 1e-3)):
        kw = dict(dim=32, heads=heads, layers=1)
        _, ref = seq_train_step(run.seq_state(seed, **kw, attention="full"), feats, targets)
        _, loss = seq_train_step(run.seq_state(seed, **kw, attention=name, mesh=mesh),
                                 feats, targets)
        _close(name, loss, ref, tol)
        extra = "" if name == "ring" else f", {heads} heads"
        print(f"dryrun_multichip ok: {label} over sp={run.n} (seq {seq_len}{extra}) "
              f"loss={float(loss):.4f} == unsharded {float(ref):.4f}")
        out.append((float(loss), float(ref)))
    return tuple(out)


def _sequential(stage_fn, stacked: dict, x, y, mb_loss):
    """The stages in sequence on every microbatch: (loss, stacked grads)."""
    leaves = {n: t.detach().clone().requires_grad_() for n, t in stacked.items()}
    s = next(iter(stacked.values())).shape[0]
    losses = []
    for j in range(x.shape[0]):
        z = x[j]
        for i in range(s):
            z = stage_fn({n: t[i] for n, t in leaves.items()}, z)
        losses.append(mb_loss(z, y[j]))
    loss = torch.stack(losses).mean()
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _pipelines(run: _Run) -> dict:
    """1F1B over pp = n; dp x pp; dp x pp x tp (megatron inside the
    stages), each against the stages applied in sequence."""
    import torch.nn.functional as F

    from beholder_tpu_torch.models import TelemetrySequenceModel, pipeline_stages
    from beholder_tpu_torch.models.bridge import init_params, load_flax_params
    from beholder_tpu_torch.parallel import (
        pipeline_train_step, stack_stage_grads, stack_stage_params, stage_specs,
    )
    from beholder_tpu_torch.parallel.collectives import like, tp_all_reduce, tp_replicate

    n, out = run.n, {}
    dim, seq = 16, 8
    n_micro = 2 * n
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n_micro, 2, seq, dim)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(n_micro, 2, seq)).astype(np.float32))
    x, y = x.to(run.dev), y.to(run.dev)
    head = torch.from_numpy(rng.normal(size=dim).astype(np.float32) * 0.1)
    head = head.to(run.dev)

    def mb_loss(o, t):
        return ((o @ head - t) ** 2).mean()

    def stages(s: int, seed: int):
        model = TelemetrySequenceModel(dim=dim, heads=2, layers=s, device=run.dev)
        load_flax_params(model, init_params(model, seed))
        stage_fn, params = pipeline_stages(model, s)
        return stage_fn, stack_stage_params(params)

    def one(name, mesh, s, seed, tol_name, **kw):
        stage_fn, stacked = stages(s, seed)
        ref_loss, ref_grads = _sequential(stage_fn, stacked, x, y, mb_loss)
        loss, grads = pipeline_train_step(stage_fn, mb_loss, stacked, x, y, mesh, **kw)
        _close(tol_name, loss, ref_loss, 1e-3)
        _grads_close(name, stack_stage_grads(grads, mesh, stage_specs(stacked)), ref_grads)
        return float(loss), float(ref_loss)

    out["pipeline"] = one("1F1B", run.mesh((n,), ("pp",)), n, 2, "pipeline")
    print(f"dryrun_multichip ok: {n}-stage 1F1B pipeline ({n_micro} microbatches) "
          f"loss={out['pipeline'][0]:.4f} == sequential {out['pipeline'][1]:.4f}, grads match")
    if n % 2 == 0 and n >= 4:
        dpp, spp = 2, n // 2
        out["dp×pp pipeline"] = one("dp×pp", run.mesh((dpp, spp), ("dp", "pp")), spp, 12,
                                    "dp×pp pipeline", dp_axis="dp")
        print(f"dryrun_multichip ok: dp×pp 1F1B pipeline (dp={dpp} pp={spp}) "
              f"loss={out['dp×pp pipeline'][0]:.4f} == sequential "
              f"{out['dp×pp pipeline'][1]:.4f}, grads match")
    if n % 8 == 0:
        d3, p3, t3 = 2, 2, n // 4
        mesh3 = run.mesh((d3, p3, t3), ("dp", "pp", "tp"))
        dim3, ff3 = 8, 4 * t3
        g = np.random.default_rng(13)
        params3 = {"w1": torch.from_numpy((g.normal(size=(p3, dim3, ff3)) * 0.3)
                                          .astype(np.float32)).to(run.dev),
                   "w2": torch.from_numpy((g.normal(size=(p3, ff3, dim3)) * 0.3)
                                          .astype(np.float32)).to(run.dev)}
        specs3 = {"w1": ("pp", None, "tp"), "w2": ("pp", "tp", None)}
        g = np.random.default_rng(14)
        x3 = torch.from_numpy(g.normal(size=(4, 4, dim3)).astype(np.float32)).to(run.dev)
        y3 = torch.from_numpy(g.normal(size=(4, 4, dim3)).astype(np.float32)).to(run.dev)

        def gelu(h):
            return F.gelu(h, approximate="tanh")

        def stage3(ps, zs):
            hs = [gelu(z @ p["w1"]) for p, z in zip(ps, tp_replicate(zs))]
            parts = tp_all_reduce(like(zs, [h @ p["w2"] for p, h in zip(ps, hs)]))
            return [z + s for z, s in zip(zs, parts)]

        def whole3(p, z):
            return z + gelu(z @ p["w1"]) @ p["w2"]

        def mb3_loss(o, t):
            return ((o - t) ** 2).mean()

        ref_loss, ref_grads = _sequential(whole3, params3, x3, y3, mb3_loss)
        loss, grads = pipeline_train_step(stage3, mb3_loss, params3, x3, y3, mesh3,
                                          dp_axis="dp", param_specs=specs3)
        _close("dp×pp×tp pipeline", loss, ref_loss, 1e-3)
        _grads_close("dp×pp×tp", stack_stage_grads(grads, mesh3, specs3), ref_grads)
        out["dp×pp×tp pipeline"] = float(loss), float(ref_loss)
        print(f"dryrun_multichip ok: dp×pp×tp 1F1B (dp={d3} pp={p3} tp={t3}) "
              f"loss={float(loss):.4f} == sequential {float(ref_loss):.4f}, "
              f"grads tp+pp-sharded and match")
    return out


def _zero3(run: _Run) -> tuple:
    from beholder_tpu_torch.models import seq_train_step
    from beholder_tpu_torch.parallel import place_zero_state, zero_train_step

    mesh = run.dp_tp_mesh(1).take(tp=0)
    kw = dict(dim=32, heads=2, layers=1, attention="flash", remat=True)
    feats, targets = run.streams(4, run.n, 16)
    _, ref = seq_train_step(run.seq_state(6, **kw), feats, targets)
    _, loss = zero_train_step(place_zero_state(run.seq_state(6, **kw), mesh, shard_params=True),
                              feats, targets)
    _close("zero3", loss, ref, 1e-3)
    print(f"dryrun_multichip ok: ZeRO-3 (+remat+flash) over dp={run.n} "
          f"loss={float(loss):.4f} == unsharded {float(ref):.4f}")
    return float(loss), float(ref)


def _moe(run: _Run) -> dict:
    """Switch MoE, then expert choice, on a ("dp", "ep") mesh; the unsharded
    step's model carries the same mesh, so it groups tokens alike."""
    from beholder_tpu_torch.models import seq_train_step
    from beholder_tpu_torch.parallel import place_seq_state, sharded_seq_train_step

    n = run.n
    ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    dp = n // ep
    mesh = run.mesh((dp, ep), ("dp", "ep"))
    feats, targets = run.streams(5, 2 * dp, 16)
    out = {}
    for name, seed, tol, kw in (("moe", 4, 2e-3, {}),
                                ("expert-choice moe", 5, 1e-3, {"moe_router": "experts"})):
        kw = dict(dim=16, heads=2, layers=1, ffn="moe", num_experts=max(2, ep), mesh=mesh, **kw)
        _, ref = seq_train_step(run.seq_state(seed, **kw), feats, targets)
        _, loss = sharded_seq_train_step(place_seq_state(run.seq_state(seed, **kw), mesh),
                                         feats, targets)
        _close(name, loss, ref, tol)
        what = "Switch-MoE" if name == "moe" else "expert-choice MoE"
        print(f"dryrun_multichip ok: {what} over dp={dp} ep={ep} loss={float(loss):.4f} "
              f"== unsharded {float(ref):.4f}")
        out[name] = float(loss), float(ref)
    return out


def _dp_tp_sp(run: _Run) -> tuple:
    from beholder_tpu_torch.models import seq_train_step
    from beholder_tpu_torch.parallel import place_seq_state, sharded_seq_train_step

    d3, t3, s3 = 2, 2, run.n // 4
    mesh = run.mesh((d3, t3, s3), ("dp", "tp", "sp"))
    feats, targets = run.streams(6, 2 * d3, 8 * s3)
    kw = dict(dim=32, heads=4, layers=2)
    _, ref = seq_train_step(run.seq_state(8, **kw), feats, targets)
    sstate, loss = sharded_seq_train_step(
        place_seq_state(run.seq_state(8, **kw, attention="ring", mesh=mesh, seq_shard=True),
                        mesh), feats, targets)
    _close("dp×tp×sp", loss, ref, 4e-3)
    shard = tuple(sstate.members[0]["blocks.0.q_proj.weight"].shape)
    if shard != (32 // t3, 32):
        raise AssertionError(f"q_proj shard {shard}")
    print(f"dryrun_multichip ok: dp×tp×sp composed (dp={d3} tp={t3} sp={s3}, ring + megatron "
          f"+ seq-shard) loss={float(loss):.4f} == unsharded {float(ref):.4f}")
    return float(loss), float(ref)


def _serving(run: _Run) -> dict:
    """dp-sharded dense serving, the paged batcher's waves against the dense
    rollout, and a what-if fork against the plain wave."""
    from beholder_tpu_torch.models import (
        TelemetrySequenceModel, forecast_deltas, forecast_eta, init_seq_state, serving_params,
        sharded_forecast_eta, sharded_prefill, stream_features,
    )
    from beholder_tpu_torch.models.serving import ContinuousBatcher, Request
    from beholder_tpu_torch.proto import TelemetryStatusEntry

    n, dev, out = run.n, run.dev, {}
    converting = int(TelemetryStatusEntry.CONVERTING)
    mesh = run.mesh((n,), ("dp",))
    model = init_seq_state(9, TelemetrySequenceModel(dim=32, heads=2, layers=2, device=dev)).model
    rng = np.random.default_rng(7)
    prog = torch.from_numpy(np.cumsum(2.0 + rng.normal(0, 0.3, (n, 17)), axis=-1)).to(dev)
    stats = torch.full((n, 17), converting, device=dev)
    horizon = 8
    with torch.no_grad():
        eta_ref, reached_ref = forecast_eta(model, prog, stats, horizon)
        params = serving_params(model, mesh)
        eta, reached = sharded_forecast_eta(model, mesh, horizon)(params, prog, stats)
        if not (torch.equal(eta.cpu(), eta_ref.cpu()) and torch.equal(reached.cpu(),
                                                                      reached_ref.cpu())):
            raise AssertionError(f"sharded eta {eta} != unsharded {eta_ref}")
        _, cache = sharded_prefill(model, mesh, 16 + horizon)(
            params, stream_features(prog, stats)[0])
    if cache.keys[0][0].shape[0] != 1:
        raise AssertionError(f"cache shard {tuple(cache.keys[0][0].shape)}: not one stream")
    print(f"dryrun_multichip ok: dp-sharded serving (cache {n}-way, forecast horizon "
          f"{horizon}) eta == unsharded")
    out["sharded serving"] = float(eta.float().mean()), float(eta_ref.float().mean())

    pg_model = init_seq_state(
        10, TelemetrySequenceModel(dim=32, heads=4, kv_heads=2, layers=2, device=dev)).model
    reqs = [Request(np.cumsum(2.0 + rng.normal(0, 0.3, 13)), np.full(13, converting), 6)
            for _ in range(3)]
    batcher = ContinuousBatcher(pg_model, num_pages=16, page_size=8, slots=2, max_prefix=16,
                                max_pages_per_seq=4, device=dev)
    got = batcher.run_waves(reqs)
    worst, wants = 0.0, []
    for i, req in enumerate(reqs):
        with torch.no_grad():
            want = forecast_deltas(pg_model, torch.from_numpy(req.progress)[None].to(dev),
                                   torch.from_numpy(req.statuses)[None].to(dev),
                                   req.horizon)[0].float().cpu().numpy()
        err = float(np.max(np.abs(got[i] - want)))
        if err > 0.1:
            raise AssertionError(f"paged wave forecast {i} differs from dense rollout by {err}")
        worst, wants = max(worst, err), wants + [want]
    if int(batcher.state.free_top) != 16:
        raise AssertionError("pages leaked")
    print("dryrun_multichip ok: paged serving (the paged decode kernel's path, wave "
          "scheduling) forecasts == dense rollout")
    out["paged serving"] = (float(np.mean([np.mean(g) for g in got])),
                            float(np.mean([np.mean(w) for w in wants])))

    (plain,) = batcher.run_waves([reqs[0]])
    wi = batcher.run_what_if(reqs[0].progress, reqs[0].statuses,
                             [converting, int(TelemetryStatusEntry.ERRORED)], horizon=6)
    if wi.shape != (2, 6):
        raise AssertionError(f"what-if shape {wi.shape}")
    err = float(np.max(np.abs(wi[0] - plain)))
    if err > 1e-4:
        raise AssertionError(f"what-if observed-status branch differs from plain rollout: {err}")
    if int(batcher.state.free_top) != 16:
        raise AssertionError("fork pages leaked")
    print("dryrun_multichip ok: prefix-shared what-if fork == plain rollout")
    out["what-if fork"] = float(np.mean(wi[0])), float(np.mean(plain))
    return out


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Every parallel cell of the reference's dryrun (its order, tiny
    shapes and bands) on ``n_devices`` members: each sharded step's loss
    against the unsharded step's from the same params and data, the
    pipelines' gradients against the stages in sequence, dp-sharded serving
    bitwise the unsharded rollout, the paged batcher and its what-if fork
    against the dense rollout. Returns ``{cell: (value, unsharded value)}``
    (the losses; for the serving cells the mean forecast each way). Raises
    ``AssertionError`` at the first cell out of its band. In a process group
    every mesh cell runs on a mesh over the processes, and the
    single-batcher cells whole in each process."""
    run = _Run(n_devices, devices)
    out = {}
    if run.procs > 1:
        whole = [c for c in CELLS if c not in ACROSS_PROCESSES]
        print(f"dryrun_multichip: {run.procs} processes; whole in each process: "
              f"{', '.join(whole)}")
    out["dp×tp"] = _mlp(run)
    out["tp"] = _tp(run)
    out["ring"], out["ulysses"] = _sequence_parallel(run)
    out.update(_pipelines(run))
    out["zero3"] = _zero3(run)
    out.update(_moe(run))
    if run.n % 8 == 0:
        out["dp×tp×sp"] = _dp_tp_sp(run)
    out.update(_serving(run))
    return {c: out[c] for c in CELLS if c in out}


def main(argv: list[str]) -> None:
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if not a.startswith("--")]
    n = int(args[0]) if args else 8
    fn, example = entry(device)
    print(f"entry ok: output shape {tuple(fn(*example).shape)}")
    dryrun_multichip(n, ["cpu"] * n if device == "cpu" else None)


if __name__ == "__main__":
    main(sys.argv[1:])
