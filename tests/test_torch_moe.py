"""The port's mixture-of-experts layer against the JAX package: routing
(top-1, top-2, expert choice), capacity and padding, the router terms, the
MoE sequence model's loss and gradients, and the expert-parallel step on a
("dp", "ep") mesh.

Params come from the reference's ``init`` through the bridge; inputs from
numpy seeds. The reference's layer runs eagerly with ``mutable=
"intermediates"`` to read what it sows; its sharded step runs jitted over
the 8 virtual CPU devices as ``__graft_entry__.py::dryrun_multichip`` runs
it. Tolerances, with their reasons:

- dispatch one-hots: exact, against a numpy routing written from the
  reference's rules (argmax, f32 queue positions, capacity) and, for the
  sharded step, against the unsharded layer's routing of the same tokens;
- layer outputs: ``tests/test_moe.py:60`` (rtol 2e-2, atol 2e-2): the
  expert products round to bf16 on both sides, summed in other orders;
- router terms: z-loss and aux loss ``rtol=1e-5`` (f32 sums in another
  order), drop and unrouted fractions exact (counts over n);
- the MoE model's loss against the reference's ``seq_loss`` (router terms
  included): rel 2e-3, the reference's MoE band
  (``__graft_entry__.py:116-118``). The dense model holds rel 1e-4
  (``tests/test_torch_train.py``), but a two-layer MoE model at this width
  read 1.05e-4: one bf16 spacing in a LayerNorm input of the second block
  (4.9e-3; the forward band of ``tests/test_torch_models.py`` is atol 2e-3
  on the predictions) is fed through the router and the expert products;
  the layer metrics of such inputs rel 1e-3; gradients the repo's band
  rtol/atol 5e-2 (``tests/test_sequence_model.py:131``);
- the ep step: losses against the unsharded port step rel 2e-3 (the
  dryrun's MoE band, ``__graft_entry__.py:116-118``) and against the
  reference's ep step rel 2e-2 (``tests/test_parallel.py:67``); params
  after the step rtol 2e-2, atol 5e-3 (``tests/test_parallel.py:169-177``);
  the reduced gradients against both steps' leaf by leaf, rel 2e-2
  (``test_torch_parallel._check_grads``, whose docstring gives the reason);
  dp replicas and the expert stacks' shapes exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from beholder_tpu.models.sequence import TelemetrySequenceModel as JaxSeqModel
from beholder_tpu.models.sequence import init_seq_state as jax_init_seq_state
from beholder_tpu.models.sequence import seq_loss as jax_seq_loss
from beholder_tpu.models.sequence import seq_train_step as jax_seq_train_step
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu.ops import moe as jax_moe
from beholder_tpu_torch.models import (
    TelemetrySequenceModel,
    seq_loss,
    seq_train_step,
    stream_features,
)
from beholder_tpu_torch.models.bridge import flax_named, load_flax_params, load_optax_adam
from beholder_tpu_torch.models.train import init_state
from beholder_tpu_torch.ops.moe import SwitchFFN, expert_specs, moe_metrics
from beholder_tpu_torch.parallel import Mesh, gather_state, place_seq_state, sharded_seq_train_step

from test_torch_parallel import _check_grads, _jax_grads

DIM, FF = 8, 16
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


#: (layer kwargs, input shape, input kind) — the cases of tests/test_moe.py
LAYER_CASES = {
    "top1": (dict(num_experts=4, capacity_factor=4.0), (2, 6), "normal"),
    "top2": (dict(num_experts=4, capacity_factor=4.0, router_topk=2), (1, 6), "normal"),
    "capacity-drops": (dict(num_experts=2, capacity_factor=0.25), (1, 16), "normal"),
    "groups-of-4": (dict(num_experts=2, capacity_factor=0.5, group_size=4), (1, 8), "ones"),
    "prime-padded": (dict(num_experts=2, capacity_factor=1.0, group_size=8), (1, 13), "normal"),
    "padding-aux": (dict(num_experts=2, capacity_factor=2.0, group_size=8), (1, 5), "ones"),
    "top2-tight": (dict(num_experts=4, capacity_factor=0.5, router_topk=2, group_size=8),
                   (2, 8), "normal"),
    "experts": (dict(num_experts=4, capacity_factor=2.0, router_type="experts"), (1, 12),
                "normal"),
    "experts-ties": (dict(num_experts=4, capacity_factor=1.0, router_type="experts",
                          group_size=8), (2, 8), "ones"),
}


def _layer_pair(case, seed=0):
    kw, (b, t), kind = LAYER_CASES[case]
    jm = jax_moe.SwitchFFN(DIM, FF, **kw)
    rng = np.random.default_rng(seed)
    x = (np.ones((b, t, DIM), np.float32) if kind == "ones"
         else rng.normal(size=(b, t, DIM)).astype(np.float32))
    params = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    tm = SwitchFFN(DIM, FF, device="cpu", **kw)
    load_flax_params(tm, {"params": params})
    return jm, params, tm, x


def _manual_dispatch(params, x, kw):
    """The reference's routing rules in numpy: (G, S, E, C) token choice or
    (G, E, C, S) expert choice."""
    e = kw["num_experts"]
    cf, gs = kw.get("capacity_factor", 2.0), kw.get("group_size", 1024)
    topk, experts = kw.get("router_topk", 1), kw.get("router_type") == "experts"
    xf = x.reshape(-1, DIM)
    n = len(xf)
    s = min(gs, n)
    g = -(-n // s)
    xf = np.concatenate([xf, np.zeros((g * s - n, DIM), np.float32)])
    valid = (np.arange(g * s) < n).reshape(g, s)
    logits = xf @ params["router"]["kernel"] + params["router"]["bias"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).reshape(g, s, e)
    if experts:
        cap = min(s, max(1, int(cf * s / e)))
        out = np.zeros((g, e, cap, s), np.float32)
        for gi in range(g):
            for ei in range(e):
                score = np.where(valid[gi], probs[gi, :, ei], -1.0)
                for c, si in enumerate(np.argsort(-score, kind="stable")[:cap]):
                    out[gi, ei, c, si] = 1.0
        return out
    cap = max(1, int(cf * topk * s / e))
    out = np.zeros((g, s, e, cap), np.float32)
    for gi in range(g):
        order = np.argsort(-probs[gi], axis=-1, kind="stable")
        count = np.zeros(e, int)
        for rank in range(topk):
            for si in range(s):
                if not valid[gi, si]:
                    continue
                ei = order[si, rank]
                if count[ei] < cap:
                    out[gi, si, ei, count[ei]] = 1.0
                count[ei] += 1
    return out


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_switch_ffn_matches_jax(case):
    """Output, router terms and dispatch one-hots of the layer."""
    jm, params, tm, x = _layer_pair(case)
    kw = LAYER_CASES[case][0]
    want, sown = jm.apply({"params": params}, jnp.asarray(x), mutable="intermediates")
    terms = {}
    with torch.no_grad():
        got = tm(torch.from_numpy(x), terms)
        dispatch = tm.routing(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(dispatch.numpy(), _manual_dispatch(params, x, kw))
    want_terms = {k: float(v[0]) for k, v in sown["intermediates"].items()}
    assert set(want_terms) == set(terms)
    for key, value in want_terms.items():
        if key in ("drop_fraction", "unrouted_fraction"):
            assert float(terms[key]) == pytest.approx(value, abs=1e-6), key
        else:
            assert float(terms[key]) == pytest.approx(value, rel=1e-5), key
    if case == "groups-of-4":       # cap 1 a group of 4 identical tokens
        assert float(terms["drop_fraction"]) == pytest.approx(0.75)
        nonzero = got.reshape(8, DIM).abs().sum(-1) > 1e-9
        assert nonzero[:4].sum() == 1 and nonzero[4:].sum() == 1
    if case == "capacity-drops":
        norms = got[0].norm(dim=-1)
        assert (norms == 0).any() and (norms > 0).any()
    if case == "padding-aux":       # 5 identical tokens: f = [1, 0], aux in (1, 2]
        assert 1.0 < float(terms["aux_loss"]) <= 2.0 + 1e-6
    if case == "experts-ties":      # identical tokens: each expert takes the first cap
        assert dispatch[0, :, :, :].argmax(-1).tolist() == [[0, 1]] * 4


def test_router_checks():
    x = torch.zeros(1, 4, DIM)
    for kw, match in ((dict(router_type="nope"), "router_type"),
                      (dict(router_type="experts", router_topk=2), "router_topk"),
                      (dict(router_topk=3), "router_topk")):
        with pytest.raises(ValueError, match=match):
            SwitchFFN(DIM, FF, 2, device="cpu", **kw)(x)
    with pytest.raises(ValueError, match="ffn"):
        TelemetrySequenceModel(dim=16, heads=2, layers=1, ffn="sparse", device="cpu")


def test_switch_ffn_lies_on_the_card_and_starts_initialised():
    """Built without a device the layer goes to the card, and raises where
    there is none; its expert stacks start from a normal draw of std
    ``1/sqrt(fan_in)`` (the reference's ``lecun_normal`` scale), the biases
    at zero, and a forward of them is finite and not zero."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SwitchFFN(DIM, FF, 4)
    torch.manual_seed(0)
    tm = SwitchFFN(64, 256, 4, device="cpu")
    for name, fan_in in (("expert_up", 64), ("expert_down", 256)):
        w = getattr(tm, name).detach()
        assert torch.isfinite(w).all(), name
        assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05, name
    assert not tm.expert_up_bias.any() and not tm.expert_down_bias.any()
    with torch.no_grad():
        y = tm(torch.randn(2, 8, 64))
    assert torch.isfinite(y).all() and y.abs().sum() > 0


def test_expert_specs_and_metrics():
    jm = jax_moe.SwitchFFN(DIM, FF, 4)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 6, DIM)))
    flat = jax.tree_util.tree_flatten_with_path(jax_moe.expert_specs(variables["params"]),
                                                is_leaf=lambda s: isinstance(s, P))[0]
    want = {"/".join(str(p.key) for p in path): tuple(spec) for path, spec in flat}
    tm = SwitchFFN(DIM, FF, 4, device="cpu")
    got = expert_specs(dict(tm.named_parameters()))
    assert got["expert_up"] == ("ep", None, None) and want["expert_up"] == ("ep", None, None)
    assert got["expert_down_bias"] == ("ep", None) and want["expert_down_bias"][0] == "ep"
    assert got["router.weight"] == () and want["router/kernel"] == ()
    terms = {"block_0": {"aux_loss": torch.tensor(1.0), "drop_fraction": torch.tensor(0.5)},
             "block_1": {"aux_loss": torch.tensor(3.0), "drop_fraction": torch.tensor(0.0)}}
    assert moe_metrics(terms) == {"aux_loss": 2.0, "drop_fraction": 0.25}


# -- the MoE sequence model -----------------------------------------------------------

MODEL_CASES = {
    "switch": dict(ffn="moe", num_experts=2),
    "top2": dict(ffn="moe", num_experts=4, moe_topk=2),
    "experts": dict(ffn="moe", num_experts=4, moe_router="experts"),
}


def _streams(seed, batch, t):
    rng = np.random.default_rng(seed)
    prog = np.cumsum(1.0 + rng.normal(0, 0.05, (batch, t + 1)), axis=-1)
    return prog, np.full((batch, t + 1), 2)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_moe_sequence_model_matches_jax(case):
    """``seq_loss`` with the router terms, its gradients, and the layers'
    metrics, against the reference (eager)."""
    kw = dict(dim=16, heads=2, layers=1, **MODEL_CASES[case])
    prog, stats = _streams(0, 2, 32)
    jmodel = JaxSeqModel(**{k: v for k, v in kw.items()})
    state, _, _ = jax_init_seq_state(jax.random.PRNGKey(0), 32, model=jmodel)
    jfeats, jtargets = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    want, want_grads = jax.value_and_grad(
        lambda p: jax_seq_loss(jmodel, p, jfeats, jtargets))(state.params)
    _, sown = jmodel.apply(state.params, jfeats, mutable="intermediates")
    model = TelemetrySequenceModel(**kw, device="cpu").requires_grad_(True)
    load_flax_params(model, _np(state.params))
    feats, targets = stream_features(torch.from_numpy(prog), torch.from_numpy(stats))
    terms = {}
    loss = seq_loss(model, feats, targets, terms)
    assert loss.item() == pytest.approx(float(want), rel=2e-3)
    loss.backward()
    grads = flax_named(model, _np(want_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=5e-2, atol=5e-2,
                                   err_msg=name)
    want_metrics = jax_moe.moe_metrics(sown)
    got_metrics = moe_metrics(terms)
    assert set(got_metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        assert got_metrics[key] == pytest.approx(value, rel=1e-3, abs=1e-6), key


# -- expert parallelism -----------------------------------------------------------------

EP_CASES = {
    "switch": dict(moe_topk=1),
    "top2": dict(moe_topk=2),
    "experts": dict(moe_router="experts"),
}


@pytest.fixture(scope="module")
def ep_reference():
    """Per case, the reference's ep step on a (dp, ep) = (2, 4) mesh, from
    its state after one unsharded step (the dryrun's sizes: dim 16, 2 heads,
    1 layer, 4 experts, 4 streams of 16 events)."""
    prog, stats = _streams(4, 4, 16)
    feats, targets = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "ep"))
    out = {}

    def run(case):
        if case in out:
            return out[case]
        kw = dict(dim=16, heads=2, layers=1, ffn="moe", num_experts=4, **EP_CASES[case])
        model = JaxSeqModel(**kw, mesh=jmesh)
        state, tx, _ = jax_init_seq_state(jax.random.PRNGKey(4), 16, model=model)
        step = jax.jit(lambda s, f, t: jax_seq_train_step(model, tx, s, f, t))
        state, _ = step(state, feats, targets)
        state_sh = jax_moe.expert_shardings(state, jmesh)
        data_sh = NamedSharding(jmesh, P("dp"))
        mstep = jax.jit(lambda s, f, t: jax_seq_train_step(model, tx, s, f, t),
                        in_shardings=(state_sh, data_sh, data_sh),
                        out_shardings=(state_sh, NamedSharding(jmesh, P())))
        after, loss = mstep(jax.device_put(state, state_sh), feats, targets)
        out[case] = dict(prog=prog, stats=stats, params=_np(state.params),
                         opt=_np(state.opt_state), loss=float(loss), after=_np(after.params),
                         after_opt=_np(after.opt_state))
        return out[case]

    return run


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_step_matches_unsharded_and_jax(case, ep_reference):
    """One Adam step (live moments) on a ("dp", "ep") mesh against the
    unsharded port step (grouped alike: the plain model carries the mesh,
    which sets the token shards) and the reference's ep step; each member's
    dispatch one-hots bitwise the unsharded routing of its groups; expert
    stacks split along E; dp replicas bitwise."""
    r = ep_reference(case)
    mesh = Mesh(np.full((2, 4), "cpu", dtype=object).tolist(), ("dp", "ep"))
    kw = dict(dim=16, heads=2, layers=1, ffn="moe", num_experts=4, mesh=mesh, **EP_CASES[case])
    feats, targets = stream_features(torch.from_numpy(r["prog"]), torch.from_numpy(r["stats"]))

    def state():
        m = TelemetrySequenceModel(**kw, device="cpu")
        load_flax_params(m, r["params"])
        return load_optax_adam(init_state(m, LR), r["opt"])

    sstate = place_seq_state(state(), mesh)
    assert tuple(sstate.members[0]["blocks.0.moe.expert_up"].shape) == (1, 16, 64)
    # the members' forward as the step runs it (gradients on: LayerNorm
    # takes its training reduction), on detached leaves
    members = [{n: t.detach() for n, t in m.items()} for m in sstate.members]
    _, member_terms = sstate.model.members_forward(
        members, [feats[:2]] * 4 + [feats[2:]] * 4, mesh)
    sstate, loss = sharded_seq_train_step(sstate, feats, targets)
    plain = state()
    seen = {}

    def keep_routing(module, args):
        with torch.no_grad():
            seen.setdefault("routing", module.routing(args[0], mesh))

    hook = plain.model.blocks[0].moe.register_forward_pre_hook(keep_routing)
    plain, plain_loss = seq_train_step(plain, feats, targets)
    hook.remove()
    routing = seen["routing"]
    per = routing.shape[0] // mesh.size
    for i, terms in enumerate(member_terms):
        assert torch.equal(terms["block_0"]["dispatch"], routing[i * per:(i + 1) * per]), i
    assert loss.item() == pytest.approx(plain_loss.item(), rel=2e-3)
    assert loss.item() == pytest.approx(r["loss"], rel=2e-2)
    _check_grads(sstate, plain, _jax_grads(plain.model, r["opt"], r["after_opt"]))
    for i, c in enumerate(mesh.coords()):
        for name, leaf in sstate.members[i].items():
            twin = mesh.coords().index((0, c[1]) if sstate.specs[name] else (0, 0))
            assert torch.equal(leaf, sstate.members[twin][name]), (c, name)
    got = gather_state(sstate).model
    want = flax_named(got, r["after"])
    mine = dict(plain.model.named_parameters())
    for name, p in got.named_parameters():
        if p.ndim >= 2:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=2e-2,
                                       atol=5e-3, err_msg=name)
            np.testing.assert_allclose(p.detach().numpy(), mine[name].detach().numpy(),
                                       rtol=2e-2, atol=5e-3, err_msg=name)


def test_ep_layout_checks():
    """Groups that would straddle a dp row, and meshes the MoE layer does not
    shard over, are refused."""
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object).tolist(), ("dp", "ep"))
    model = TelemetrySequenceModel(dim=16, heads=2, layers=1, ffn="moe", num_experts=4,
                                   device="cpu")
    sstate = place_seq_state(init_state(model, LR), mesh)
    feats, targets = stream_features(*(torch.from_numpy(a) for a in _streams(1, 2, 13)))
    with pytest.raises(ValueError, match="whole groups"):
        sharded_seq_train_step(sstate, feats, targets)
    tp = Mesh(np.full((2, 2), "cpu", dtype=object).tolist(), ("dp", "tp"))
    with pytest.raises(ValueError, match="dp and ep"):
        sharded_seq_train_step(place_seq_state(init_state(model, LR), tp), feats, targets)
