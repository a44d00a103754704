"""Ring attention in the port against the JAX package: the flash kernels'
block-pair mode (plain versions here), the ring forward and gradients, and
the ring sequence model and its training step.

Inputs are made from numpy seeds and handed to both sides. The JAX side
runs as its own tests run it on the CPU: Pallas in interpret mode, the ring
over ``Mesh(np.array(jax.devices()[:4]), ("sp",))``. The port's ring runs
on ``Mesh(["cpu"] * 4)``, one process holding every shard. Tolerances,
with their reasons:

- block pair: the bands of ``tests/test_torch_flash.py`` (f32: the
  reference's ``tests/test_flash_attention.py:33, :54``; bf16: 2**-6 of
  the largest value, a few bf16 ULPs);
- ring forward: the reference's ring band, ``tests/test_attention.py:47``
  (rtol 2e-4, atol 2e-5); ring gradients against the reference's
  ``flash_attention``: its ring-gradient band, ``:255`` (rtol 1e-3, atol
  1e-4). Each pair's online softmax and the combine sum in other orders on
  the two sides;
- the einsum backend against the flash backend: the reference's own band
  for that pair, ``tests/test_attention.py:330-335``;
- the ring model against the reference's ring model:
  ``tests/test_sequence_model.py:57`` (rtol/atol 5e-2); one training step
  of the ring model against the port's flash model on the same params: the
  gradient band of ``tests/test_sequence_model.py:131`` (rtol/atol 5e-2)
  and Adam's first step within ``2 * lr`` (``tests/test_torch_train.py``);
  the loss within rel 2e-3: each ring pair rounds its bf16 output before
  the combine rounds it again, as the reference does (3.4e-4 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import init_seq_state as jax_init_seq_state
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.ops.attention import ring_attention as jax_ring
from beholder_tpu.ops.attention import sequence_sharding
from beholder_tpu.ops.flash_attention import flash_attention as jax_flash
from beholder_tpu.ops.flash_attention import flash_block_attend as jax_block_attend
from beholder_tpu.ops.flash_attention import flash_block_backward as jax_block_backward
from beholder_tpu_torch.models import TelemetrySequenceModel, seq_train_step, stream_features
from beholder_tpu_torch.models.bridge import flax_named, load_flax_params
from beholder_tpu_torch.models.train import init_state
from beholder_tpu_torch.ops import attention as att
from beholder_tpu_torch.ops import flash_attention as fa
from beholder_tpu_torch.ops.attention import ring_attention
from beholder_tpu_torch.ops.flash_attention import flash_attention
from beholder_tpu_torch.parallel import Mesh

P = 4
BANDS = {"f32": ((1e-4, 1e-5), (1e-3, 1e-4)), "bf16": ((2**-6, 2**-6), (2**-6, 2**-6))}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_mesh():
    return JaxMesh(np.array(jax.devices()[:P]), ("sp",))


def _close(got, want, band, name, scaled):
    rtol, atol = band
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if scaled:
        atol = atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


#: one block pair each: (b, h, hkv, t, d) and the mask's global placement
PAIRS = {
    # a rotated block wholly in the past: every pair live
    "live-offaxis": dict(shape=(1, 4, 2, 128, 8), q_offset=256, kv_offset=128),
    # a wrapped future block: no pair live (o = 0, lse = -1e30, zero grads)
    "dead": dict(shape=(1, 4, 2, 128, 64), q_offset=0, kv_offset=128),
    # the causal edge 32 keys below the diagonal, crossing the 64-tiles
    "edge-in-shard": dict(shape=(1, 4, 2, 128, 8), q_offset=96, kv_offset=128),
    # a window reaching back across the shard boundary
    "window-straddle": dict(shape=(1, 4, 2, 128, 64), q_offset=128, kv_offset=0, window=100),
    # GQA 4:1 over a live off-axis pair
    "gqa4-offaxis": dict(shape=(2, 4, 1, 64, 8), q_offset=64, kv_offset=0),
    # T/P = 100, not a multiple of 64: the last tile partial
    "t100-edge": dict(shape=(1, 4, 2, 100, 64), q_offset=100, kv_offset=50),
    # head dim 128 (the reference's bench_ring_block width): a live off-axis
    # pair under GQA 4:1, the diagonal, a dead pair and a straddling window
    "d128-gqa4-offaxis": dict(shape=(1, 4, 1, 128, 128), q_offset=256, kv_offset=128),
    "d128-diagonal": dict(shape=(1, 4, 2, 128, 128), q_offset=128, kv_offset=128),
    "d128-dead": dict(shape=(1, 4, 2, 64, 128), q_offset=0, kv_offset=64),
    "d128-window-straddle": dict(shape=(1, 4, 2, 128, 128), q_offset=128, kv_offset=0,
                                 window=100),
}


def _pair_inputs(seed, b, h, hkv, t, d):
    rng = np.random.default_rng(seed)
    q, o, do = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))
    k, v = (rng.normal(size=(b, hkv, t, d)).astype(np.float32) for _ in range(2))
    # the ring's global logsumexp: finite for every row (each row sees its
    # own position somewhere on the ring)
    lse = rng.uniform(1.0, 3.0, size=(b, h, t)).astype(np.float32)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_block_pair_matches_jax(pair, dtype):
    """The port's ``flash_block_attend`` / ``flash_block_backward`` (the
    kernels' plain versions in offset mode) against the reference's, whose
    Pallas kernels run with the same offsets in interpret mode."""
    c = PAIRS[pair]
    q, k, v, o, do, lse = _pair_inputs(7, *c["shape"])
    offs = dict(q_offset=c["q_offset"], kv_offset=c["kv_offset"])
    kw = dict(causal=True, window=c.get("window"))
    jdt, tdt = DTYPES[dtype]
    jin = [jnp.asarray(a).astype(jdt) for a in (q, k, v, o, do)]
    want_o, want_lse = jax_block_attend(*jin[:3], **kw, **offs)
    want_grads = jax_block_backward(*jin[:4], jnp.asarray(lse), jin[4], **kw, **offs)

    tin = [torch.from_numpy(a).to(tdt) for a in (q, k, v, o, do)]
    got_o, got_lse = fa.flash_block_attend(*tin[:3], **kw, **offs)
    got_grads = fa.flash_block_backward(*tin[:4], torch.from_numpy(lse), tin[4], **kw, **offs)
    fwd_band, grad_band = BANDS[dtype]
    scaled = dtype == "bf16"
    assert got_o.dtype == tdt and got_lse.dtype == torch.float32
    _close(got_o, want_o, fwd_band, "o", scaled)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv"), got_grads, want_grads):
        assert got.dtype == tdt
        _close(got, want, grad_band, name, scaled)
    if pair.endswith("dead"):
        assert not got_o.any() and bool((got_lse == -1e30).all())
        assert not any(g.any() for g in got_grads)


def test_offset_mode_counts_apart_and_rejects_segments():
    """Offsets reach the plain versions on CPU tensors (no launch counted);
    segment ids with offsets raise, as in the reference; the two offsets
    come together."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(4, 64, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
    counts = [(w.launches, w.offset_launches)
              for w in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)]
    o, lse = fa.flash_forward(q, k, k, causal=True, offsets=(64, 0))
    want = fa.flash_forward_reference(q, k, k, causal=True, offsets=(64, 0))
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    # (64, 0): every key is in the past, so the pair is the non-causal one
    full = fa.flash_forward_reference(q, k, k, causal=False)
    assert torch.equal(o, full[0]) and torch.equal(lse, full[1])
    assert counts == [(w.launches, w.offset_launches)
                      for w in (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)]
    seg = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="segment ids"):
        fa.flash_forward(q, k, k, causal=True, segment_ids=seg, offsets=(64, 0))
    with pytest.raises(ValueError, match="together"):
        fa.flash_block_attend(q, k, k, q_offset=64)


def _qkv(seed, b, h, hkv, t, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, t, d)).astype(np.float32) for _ in range(2))
    return q, k, v


RINGS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "gqa-window40": dict(causal=True, window=40),
}


@pytest.mark.parametrize("ring", list(RINGS))
def test_ring_forward_matches_jax_ring(ring, jax_mesh):
    """The port's ring (flash backend, 4 shards) against the reference's
    ``ring_attention`` on the 4-device CPU mesh."""
    kw = RINGS[ring]
    hkv = 2 if ring.startswith("gqa") else 4
    q, k, v = _qkv(11, 2, 4, hkv, 128, 8)
    sh = lambda a: jax.device_put(jnp.asarray(a), sequence_sharding(jax_mesh, a.ndim))
    want = jax.jit(lambda q, k, v: jax_ring(q, k, v, jax_mesh, **kw))(sh(q), sh(k), sh(v))
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), Mesh(["cpu"] * P), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("ring", list(RINGS))
def test_ring_gradients_match_jax_flash(ring):
    """Ring gradients (the block-pair backward over 4 shards) against
    ``jax.grad`` of the reference's ``flash_attention``, which avoids
    differentiating through the reference's collectives."""
    kw = RINGS[ring]
    hkv = 2 if ring.startswith("gqa") else 4
    q, k, v = _qkv(12, 1, 4, hkv, 128, 8)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v, **kw) ** 2),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ring_attention(tq, tk, tv, Mesh(["cpu"] * P), **kw).square().sum().backward()
    assert tk.grad.shape == tk.shape  # dk at kv-head width
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*xs)
    out.float().square().sum().backward()
    return out, [x.grad for x in xs]


def test_one_shard_ring_is_flash_attention_bit_for_bit():
    """P = 1: one diagonal pair, combined with nothing, so the ring runs
    the same kernels in the same order as ``flash_attention``: the same
    bits, forward and gradients, here in bf16 on the plain versions."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(13, 2, 4, 2, 96, 16))
    kw = dict(causal=True, window=50)
    ring_out, ring_g = _grads(lambda *x: ring_attention(*x, Mesh(["cpu"]), **kw), q, k, v)
    flash_out, flash_g = _grads(lambda *x: flash_attention(*x, **kw), q, k, v)
    assert torch.equal(ring_out, flash_out)
    for a, b in zip(ring_g, flash_g):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ring", list(RINGS))
def test_ring_einsum_backend_matches_flash_backend(ring):
    """``backend="einsum"`` (the reference's plain block path) against
    ``backend="flash"`` (the kernels' plain versions), value and gradient,
    within the reference's band for the same pair of backends."""
    kw = RINGS[ring]
    hkv = 2 if ring.startswith("gqa") else 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(14, 1, 4, hkv, 128, 16))
    mesh = Mesh(["cpu"] * P)
    out_f, g_f = _grads(lambda *x: ring_attention(*x, mesh, backend="flash", **kw), q, k, v)
    out_e, g_e = _grads(lambda *x: ring_attention(*x, mesh, backend="einsum", **kw), q, k, v)
    torch.testing.assert_close(out_f, out_e, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_f, g_e):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def test_window_bounds_the_rotations():
    """The counterpart of ``tests/test_attention.py:259``: a window much
    shorter than a shard stops the ring after the first rotation, forward
    and backward; the rotations' count follows ``_ring_steps``."""
    assert att._ring_steps(4, 32, True, None) == 4
    assert att._ring_steps(4, 32, False, None) == 4
    assert att._ring_steps(4, 32, True, 5) == 2
    assert att._ring_steps(4, 32, True, 1) == 1
    assert att._ring_steps(4, 32, True, 34) == 3
    assert att._ring_steps(4, 32, True, 1000) == 4
    mesh = Mesh(["cpu"] * P)
    moves = []
    rotate = att._rotate

    def counted(blocks):
        moves.append(len(blocks))
        return rotate(blocks)

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(15, 1, 2, 2, 128, 8))
    att._rotate = counted
    try:
        for window in (None, 5):
            moves.clear()
            ring_attention(q, k, v, mesh, causal=True, window=window).sum().backward()
            steps = att._ring_steps(P, 128 // P, True, window)
            # forward: k, v; backward: k, v, dk, dv; each (steps - 1) times
            assert len(moves) == 6 * (steps - 1), (window, moves)
    finally:
        att._rotate = rotate
    assert att._ring_steps(P, 32, True, 5) - 1 < (P - 1) / 2


def test_ring_checks_like_the_reference():
    q = torch.zeros(1, 2, 130, 8)
    mesh = Mesh(["cpu"] * P)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, q, q, mesh)
    q = torch.zeros(1, 2, 128, 8)
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, q, q, mesh, window=8)
    with pytest.raises(ValueError, match="window"):
        ring_attention(q, q, q, mesh, causal=True, window=0)
    with pytest.raises(ValueError, match="GQA"):
        ring_attention(torch.zeros(1, 3, 128, 8), q, q, mesh, causal=True)
    with pytest.raises(ValueError, match="mesh"):
        TelemetrySequenceModel(attention="ring", device="cpu")


def test_ring_saves_only_q_k_v_o_lse():
    """The forward saves each shard's q, k, v, o and lse (all O(T/P * d)),
    nothing of a (T/P, T/P) block."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(16, 1, 4, 2, 64, 8))
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = ring_attention(q, k, v, Mesh(["cpu"] * P), causal=True)
    out.sum().backward()
    shard = [(1, 4, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8), (1, 4, 16, 8), (1, 4, 16)]
    assert sorted(saved) == sorted(shard * P), saved


# -- the model -----------------------------------------------------------------

T = 128  # divisible by the 4-shard mesh, as tests/test_sequence_model.py:17
LR = 1e-3


def _streams(seed, batch=4):
    rng = np.random.default_rng(seed)
    progress = np.cumsum(1.0 + rng.normal(0, 0.05, size=(batch, T + 1)), axis=-1).clip(0)
    statuses = np.full((batch, T + 1), 2)  # CONVERTING
    return progress, statuses


@pytest.fixture(scope="module")
def ring_reference(jax_mesh):
    """The reference's ring model (``dim=32, heads=4``: head dim 8, 2
    layers), its params and its forward on sequence-sharded features."""
    progress, statuses = _streams(1)
    feats, _ = jax_stream_features(jnp.asarray(progress), jnp.asarray(statuses))
    state, _, _ = jax_init_seq_state(jax.random.PRNGKey(2), T, model=JaxSeqModel(dim=32, heads=4))
    ring_model = JaxSeqModel(dim=32, heads=4, attention="ring", mesh=jax_mesh)
    feats_sh = jax.device_put(feats, sequence_sharding(jax_mesh, feats.ndim))
    preds = jax.jit(lambda p, f: ring_model.apply(p, f))(state.params, feats_sh)
    return dict(progress=progress, statuses=statuses,
                params=jax.tree.map(np.asarray, state.params), preds=np.asarray(preds))


def _port_model(params, attention, **kw):
    model = TelemetrySequenceModel(dim=32, heads=4, attention=attention, device="cpu", **kw)
    load_flax_params(model, params)
    return model


def test_ring_model_matches_jax_ring_model(ring_reference):
    """``attention="ring"`` on a 4-shard mesh against the reference's ring
    model on the 4-device CPU mesh, on the same params."""
    r = ring_reference
    model = _port_model(r["params"], "ring", mesh=Mesh(["cpu"] * P))
    feats, _ = stream_features(torch.from_numpy(r["progress"]), torch.from_numpy(r["statuses"]))
    with torch.no_grad():
        got = model(feats)
    np.testing.assert_allclose(got.numpy(), r["preds"], rtol=5e-2, atol=5e-2)


def test_ring_train_step_matches_flash_train_step(ring_reference):
    """One ``seq_train_step`` of the ring model against the port's flash
    model on the same bridged params: the loss, every gradient and the
    params after Adam's first step. The bridge is the same for both
    backends: the params do not depend on the attention backend."""
    r = ring_reference
    models = {a: _port_model(r["params"], a, **({"mesh": Mesh(["cpu"] * P)} if a == "ring" else {}))
              for a in ("ring", "flash")}
    want = flax_named(models["ring"], r["params"])
    assert sorted(want) == sorted(n for n, _ in models["flash"].named_parameters())
    for model in models.values():
        for name, p in model.named_parameters():
            assert torch.equal(p, want[name]), name
    feats, targets = stream_features(torch.from_numpy(r["progress"]),
                                     torch.from_numpy(r["statuses"]))
    grads, losses, states = {}, {}, {}
    for name, model in models.items():
        state = init_state(model, LR)
        state, losses[name] = seq_train_step(state, feats, targets)
        grads[name] = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        states[name] = state
    assert states["ring"].step == 1
    # each ring pair rounds its o to bf16 before the combine, which rounds
    # again (the reference's rounding, ops/attention.py:297): the attention
    # outputs differ from flash's by a bf16 ULP here and there, and the loss
    # by 3.4e-4 relative on these inputs
    assert losses["ring"].item() == pytest.approx(losses["flash"].item(), rel=2e-3)
    for n, g in grads["flash"].items():
        np.testing.assert_allclose(grads["ring"][n].numpy(), g.numpy(), rtol=5e-2, atol=5e-2,
                                   err_msg=n)
    flash_params = dict(states["flash"].model.named_parameters())
    for n, p in states["ring"].model.named_parameters():
        assert float((p - flash_params[n]).detach().abs().max()) <= 2 * LR + 1e-6, n


def test_ring_model_remat_gives_the_same_gradients():
    """``remat=True`` recomputes each block (and its ring) in the backward:
    the same gradients, bit for bit."""
    progress, statuses = _streams(3, batch=2)
    feats, targets = stream_features(torch.from_numpy(progress), torch.from_numpy(statuses))
    from beholder_tpu_torch.models import seq_loss
    from beholder_tpu_torch.models.bridge import init_params

    grads = []
    for remat in (False, True):
        model = TelemetrySequenceModel(dim=32, heads=4, attention="ring", mesh=Mesh(["cpu"] * P),
                                       remat=remat, device="cpu")
        load_flax_params(model, init_params(model, 5))
        model.requires_grad_(True)
        seq_loss(model, feats, targets).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
