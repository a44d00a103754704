"""Training in the port against the JAX package: the flash sequence model's
loss, gradients and Adam steps, the anomaly model, and checkpoints.

One small ``TelemetrySequenceModel(dim=64, heads=4, kv_heads=2, layers=2,
attention="flash")`` is initialised by the reference (``init_seq_state``)
and loaded into the port through the bridge; numpy-seeded streams go
through both. The JAX side runs its Pallas flash kernels in interpret mode.
Tolerances, with their reasons:

- predictions: ``atol=2e-3``, the port's forward band
  (``tests/test_torch_models.py``: both sides reproduce flax's bf16 dtype
  mix op for op, products are summed in other orders);
- loss: ``rtol=1e-4`` (a mean of those predictions' squared errors);
- gradients, per parameter: the repo's band for flash against full
  attention, ``tests/test_sequence_model.py:131`` (rtol 5e-2, atol 5e-2),
  and over all parameters together a relative L2 error below 1e-2. The
  q/k/v projections are bf16, so every gradient carries bf16 rounding noise;
  the k-projection bias gradient is zero in exact arithmetic (softmax is
  shift-invariant) and is pure noise on both sides;
- Adam from identical gradients: ``atol=1e-6`` (f32 rounding of two orders
  of the same update);
- params after the first ``seq_train_step``: Adam's first step moves each
  entry by ``lr * sign(g)``, so where the two gradients are noise of
  opposite signs an entry differs by ``2 * lr``: every entry within
  ``2 * lr + 1e-6``, and fewer than 1 % beyond 1e-5 (0.13 % measured);
- params after a second step, taken by both from the reference's state
  after the first (params and optax moments through the bridge): within
  ``lr / 2`` (2e-4 measured: the moments average the gradient noise);
- the anomaly model is f32 after a bf16 input rounding: forward, loss and
  scores ``rtol=1e-5``; params after two steps ``atol=lr/100``: a gradient
  entry that is a sum with cancellation keeps few f32 digits, and Adam
  divides it by its own size (1.9e-6 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beholder_tpu.models import anomaly as jax_anomaly
from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import init_seq_state as jax_init_seq_state
from beholder_tpu.models.sequence import seq_loss as jax_seq_loss
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu_torch.models import (
    ProgressAnomalyModel,
    TelemetrySequenceModel,
    anomaly_scores,
    init_seq_state,
    make_windows,
    restore_state,
    save_state,
    seq_loss,
    seq_train_step,
    stream_features,
)
from beholder_tpu_torch.models import anomaly
from beholder_tpu_torch.models.bridge import (
    flax_named,
    init_params,
    load_flax_params,
    load_optax_adam,
)
from beholder_tpu_torch.models.train import adam, init_state

SIZES = dict(dim=64, heads=4, kv_heads=2, layers=2, attention="flash")
T = 64
LR = 1e-3


def _streams(seed, batch=2, t=T):
    rng = np.random.default_rng(seed)
    progress = np.cumsum(1.0 + rng.normal(0, 0.05, size=(batch, t + 1)), axis=-1)
    statuses = np.full((batch, t + 1), 2)  # CONVERTING
    return progress, statuses


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """The reference's side, computed once: preds, loss and grads at the
    initial params, then two Adam steps (params and optax state after each)."""
    progress, statuses = _streams(0)
    feats, targets = jax_stream_features(jnp.asarray(progress), jnp.asarray(statuses))
    model = JaxSeqModel(**SIZES)
    state, tx, _ = jax_init_seq_state(jax.random.PRNGKey(0), T, model=model)
    # eager, not jitted: under jit XLA may keep excess precision inside
    # fusions and skip bf16 roundings that flax's op sequence (and the port)
    # makes; the loss at params1 then moves by ~1.6 %
    grad_fn = jax.value_and_grad(lambda p: jax_seq_loss(model, p, feats, targets))
    out = dict(progress=progress, statuses=statuses, params0=_np(state.params),
               preds=np.asarray(model.apply(state.params, feats)))
    params, opt_state = state.params, state.opt_state
    for step in (1, 2):
        loss, grads = grad_fn(params)
        out[f"loss{step - 1}"], out[f"grads{step - 1}"] = float(loss), _np(grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out[f"params{step}"], out[f"opt{step}"] = _np(params), _np(opt_state)
    return out


def _port(params, remat=False):
    model = TelemetrySequenceModel(**SIZES, remat=remat, device="cpu")
    load_flax_params(model, params)
    return init_state(model, LR)


def _port_streams(ref):
    return stream_features(torch.from_numpy(ref["progress"]), torch.from_numpy(ref["statuses"]))


def _assert_params(model, want_tree, atol, name):
    want = flax_named(model, want_tree)
    worst = 0.0
    for pname, p in model.named_parameters():
        worst = max(worst, float((p.detach() - want[pname]).abs().max()))
    assert worst <= atol, f"{name}: params differ by {worst} > {atol}"
    return want


def test_seq_model_preds_loss_and_grads_match_jax(reference):
    state = _port(reference["params0"])
    feats, targets = _port_streams(reference)
    with torch.no_grad():
        preds = state.model(feats)
    np.testing.assert_allclose(preds.numpy(), reference["preds"], rtol=0, atol=2e-3)
    loss = seq_loss(state.model, feats, targets)
    assert loss.item() == pytest.approx(reference["loss0"], rel=1e-4)
    loss.backward()
    want = flax_named(state.model, reference["grads0"])
    diff2 = norm2 = 0.0
    for name, p in state.model.named_parameters():
        got, w = p.grad.numpy(), want[name].numpy()
        np.testing.assert_allclose(got, w, rtol=5e-2, atol=5e-2, err_msg=name)
        diff2 += float(np.square(got - w).sum())
        norm2 += float(np.square(w).sum())
    assert np.sqrt(diff2 / norm2) < 1e-2


def test_seq_train_step_matches_jax(reference):
    state = _port(reference["params0"])
    feats, targets = _port_streams(reference)
    state, loss = seq_train_step(state, feats, targets)
    assert state.step == 1
    assert loss.item() == pytest.approx(reference["loss0"], rel=1e-4)
    want = _assert_params(state.model, reference["params1"], 2 * LR + 1e-6, "step 1")
    beyond = sum(int(((p.detach() - want[n]).abs() > 1e-5).sum())
                 for n, p in state.model.named_parameters())
    total = sum(p.numel() for p in state.model.parameters())
    assert beyond < 0.01 * total, f"{beyond} of {total} entries beyond 1e-5"

    # a second step, both sides from the reference's state after the first
    state = load_optax_adam(_port(reference["params1"]), reference["opt1"])
    assert state.step == 1
    state, loss = seq_train_step(state, feats, targets)
    assert loss.item() == pytest.approx(reference["loss1"], rel=1e-4)
    _assert_params(state.model, reference["params2"], LR / 2, "step 2")


def test_adam_matches_optax_from_identical_gradients():
    """torch.optim.Adam with optax's defaults, fed the same gradients as
    ``optax.adam``, over three steps, also resumed from a bridged state."""
    rng = np.random.default_rng(4)
    model = ProgressAnomalyModel(hidden=8, window=2, device="cpu")
    params = {"params": {
        name: {"kernel": rng.normal(size=shape).astype(np.float32),
               "bias": rng.normal(size=shape[1]).astype(np.float32)}
        for name, shape in (("in_proj", (14, 8)), ("mid_proj", (8, 8)), ("out_proj", (8, 1)))
    }}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
             for _ in range(3)]
    tx = optax.adam(LR)
    jp, opt = jax.tree.map(jnp.asarray, params), tx.init(params)
    states = []
    for g in grads:
        updates, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, updates)
        states.append((_np(jp), _np(opt)))

    load_flax_params(model, params)
    state = init_state(model, LR)
    for step, g in enumerate(grads):
        named = flax_named(model, g)
        for name, p in model.named_parameters():
            p.grad = named[name].clone()
        state.optimizer.step()
        _assert_params(model, states[step][0], 1e-6, f"adam step {step + 1}")
    # resume from the reference's state after step 1, then take steps 2 and 3
    resumed = ProgressAnomalyModel(hidden=8, window=2, device="cpu")
    load_flax_params(resumed, states[0][0])
    state = load_optax_adam(init_state(resumed, LR), states[0][1])
    for step, g in enumerate(grads[1:], start=1):
        named = flax_named(resumed, g)
        for name, p in resumed.named_parameters():
            p.grad = named[name].clone()
        state.optimizer.step()
        _assert_params(resumed, states[step][0], 1e-6, f"resumed adam step {step + 1}")


def test_remat_is_bitwise_no_remat():
    feats, targets = stream_features(*(torch.from_numpy(a) for a in _streams(3)))
    params = init_params(TelemetrySequenceModel(**SIZES, device="cpu"), 3)
    plain, remat = _port(params), _port(params, remat=True)
    for state in (plain, remat):
        seq_loss(state.model, feats, targets).backward()
    for (name, a), (_, b) in zip(plain.model.named_parameters(), remat.model.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    with torch.no_grad():
        assert torch.equal(plain.model(feats), remat.model(feats))


def test_seq_training_reduces_loss():
    state = init_seq_state(0, TelemetrySequenceModel(**SIZES, device="cpu"))
    feats, targets = stream_features(*(torch.from_numpy(a) for a in _streams(1)))
    losses = []
    for _ in range(8):
        state, loss = seq_train_step(state, feats, targets)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses


def test_init_seq_state_turns_gradients_on_and_serving_keeps_them_off():
    assert not any(p.requires_grad for p in TelemetrySequenceModel(device="cpu").parameters())
    state = init_seq_state(0, device="cpu")
    assert all(p.requires_grad for p in state.model.parameters())
    assert state.step == 0


@pytest.fixture(scope="module")
def anomaly_pair():
    """The reference's anomaly state and the port's, with the same params;
    one job's streams and their windows from both."""
    rng = np.random.default_rng(5)
    progress = np.cumsum(np.abs(rng.normal(1.0, 0.3, 80))).astype(np.float32)
    statuses = rng.integers(0, 6, 80).astype(np.int32)
    jstate, tx = jax_anomaly.init_train_state(jax.random.PRNGKey(1))
    model = ProgressAnomalyModel(device="cpu")
    load_flax_params(model, _np(jstate.params))
    return dict(progress=progress, statuses=statuses, jstate=jstate, tx=tx,
                state=init_state(model, LR))


def test_anomaly_windows_forward_loss_and_scores_match_jax(anomaly_pair):
    a = anomaly_pair
    jw, jt = jax_anomaly.make_windows(jnp.asarray(a["progress"]), jnp.asarray(a["statuses"]))
    w, t = make_windows(torch.from_numpy(a["progress"]), torch.from_numpy(a["statuses"]))
    assert w.shape == (80 - 16 - 1, 16 * 7)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    params = a["jstate"].params
    model = a["state"].model
    with torch.no_grad():
        np.testing.assert_allclose(
            model(w).numpy(), np.asarray(jax_anomaly.ProgressAnomalyModel().apply(params, jw)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(anomaly.loss_fn(model, w, t).item(),
                                   float(jax_anomaly.loss_fn(params, jw, jt)), rtol=1e-5)
    np.testing.assert_allclose(anomaly_scores(model, w, t).numpy(),
                               np.asarray(jax_anomaly.anomaly_scores(params, jw, jt)),
                               rtol=1e-5, atol=1e-6)


def test_anomaly_train_step_matches_jax(anomaly_pair):
    a = anomaly_pair
    jw, jt = jax_anomaly.make_windows(jnp.asarray(a["progress"]), jnp.asarray(a["statuses"]))
    w, t = make_windows(torch.from_numpy(a["progress"]), torch.from_numpy(a["statuses"]))
    jstate, state = a["jstate"], a["state"]
    for _ in range(2):
        jstate, jloss = jax_anomaly.train_step(jstate, a["tx"], jw, jt)
        state, loss = anomaly.train_step(state, w, t)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert state.step == int(jstate.step) == 2
    _assert_params(state.model, _np(jstate.params), LR / 100, "anomaly after 2 steps")


def test_anomaly_training_reduces_loss():
    state = anomaly.init_train_state(0, device="cpu")
    rng = np.random.default_rng(6)
    progress = torch.from_numpy(np.cumsum(1.0 + rng.normal(0, 0.05, 300)))
    w, t = make_windows(progress, torch.full((300,), 2))
    losses = []
    for _ in range(20):
        state, loss = anomaly.train_step(state, w, t)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("kind", ["sequence", "anomaly"])
def test_checkpoint_resume_is_bitwise(tmp_path, kind):
    """Save after two steps, take a third; restore into a fresh state and
    take the third again: loss and every param equal bit for bit. A second
    save to the same path overwrites the first."""
    if kind == "sequence":
        feats, targets = stream_features(*(torch.from_numpy(a) for a in _streams(2)))

        def fresh(seed):
            return init_seq_state(seed, TelemetrySequenceModel(**SIZES, device="cpu"))

        def step(state):
            return seq_train_step(state, feats, targets)
    else:
        rng = np.random.default_rng(7)
        w, t = make_windows(torch.from_numpy(np.cumsum(1.0 + rng.normal(0, 0.1, 60))),
                            torch.full((60,), 2))

        def fresh(seed):
            return anomaly.init_train_state(seed, device="cpu")

        def step(state):
            return anomaly.train_step(state, w, t)

    path = tmp_path / "latest.pt"
    state = fresh(0)
    state, _ = step(state)
    save_state(path, state)          # overwritten below
    state, _ = step(state)
    save_state(path, state)
    state, want_loss = step(state)

    restored = restore_state(path, fresh(1))
    assert restored.step == 2
    restored, loss = step(restored)
    assert restored.step == 3
    assert torch.equal(loss, want_loss)
    for (name, a), (_, b) in zip(state.model.named_parameters(),
                                 restored.model.named_parameters()):
        assert torch.equal(a, b), name
    assert list(tmp_path.iterdir()) == [path]


def test_adam_defaults_are_optax():
    opt = adam([torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 0.0)
    assert not group["amsgrad"]
