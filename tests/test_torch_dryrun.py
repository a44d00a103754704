"""The port's entry points (``beholder_tpu_torch/dryrun.py``) against the
reference's ``__graft_entry__.py``.

``dryrun_multichip(8, devices=["cpu"] * 8)`` runs the reference's cells in
its order at its tiny shapes, each against the port's unsharded computation
in the reference's own band (the ``tol=`` of each ``_assert_close``,
``__graft_entry__.py:111-128, :165, :211, :232, :273, :286, :316, :372,
:429, :474, :527, :574``; the pipelines' gradients within 5e-2 of the
largest value, ``:271-286``; sharded serving bitwise, ``:620-621``; the
paged waves within 0.1 of the dense rollout, ``:663``; the fork within
1e-4, ``:683``). Its dp x tp MLP loss is also held against the reference's
jitted ``sharded_train_step`` and unsharded ``train_step`` on the same
params and windows (``:117-128``), within the same 1e-3; ``entry()``'s
forward against the reference's ``ProgressAnomalyModel`` on the bridged
params, within f32 rounding (rtol 1e-5, atol 1e-6: both run the Dense
layers in f32 on a bf16-rounded input).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beholder_tpu.models import anomaly as jax_anomaly
from beholder_tpu.models.train import TrainState as JaxTrainState
from beholder_tpu.parallel import make_mesh as jax_make_mesh
from beholder_tpu.parallel import mesh as jax_mesh_mod
from beholder_tpu_torch import dryrun
from beholder_tpu_torch.models import ProgressAnomalyModel
from beholder_tpu_torch.models.bridge import init_params

#: each training cell's band (relative to max(1, |unsharded|))
BANDS = {"dp×tp": 1e-3, "tp": 8e-3, "ring": 4e-3, "ulysses": 1e-3, "pipeline": 1e-3,
         "dp×pp pipeline": 1e-3, "dp×pp×tp pipeline": 1e-3, "zero3": 1e-3, "moe": 2e-3,
         "expert-choice moe": 1e-3, "dp×tp×sp": 4e-3}


@pytest.fixture(scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ran(one_thread):
    return dryrun.dryrun_multichip(8, devices=["cpu"] * 8)


def test_dryrun_runs_the_reference_cells_in_order(ran):
    assert tuple(ran) == dryrun.CELLS


@pytest.mark.parametrize("cell", dryrun.CELLS)
def test_dryrun_cell_within_the_reference_band(ran, cell):
    got, want = ran[cell]
    assert np.isfinite(got) and np.isfinite(want)
    if cell in BANDS:
        assert abs(got - want) <= BANDS[cell] * max(1.0, abs(want)), (got, want)
    elif cell == "paged serving":
        assert abs(got - want) <= 0.1
    elif cell == "what-if fork":
        assert abs(got - want) <= 1e-4
    else:
        assert got == want


def test_dryrun_on_four_members_runs_the_reference_subset(one_thread, capsys):
    """At n = 4 the reference skips dp x pp x tp and dp x tp x sp (each needs
    n % 8 == 0) and runs dp x pp (n even, >= 4)."""
    ran = dryrun.dryrun_multichip(4, devices=["cpu"] * 4)
    assert tuple(ran) == tuple(c for c in dryrun.CELLS
                               if c not in ("dp×pp×tp pipeline", "dp×tp×sp"))
    out = capsys.readouterr().out
    assert "mesh={'dp': 2, 'tp': 2}" in out and "dp×pp 1F1B pipeline (dp=2 pp=2)" in out


def test_dryrun_mlp_matches_the_reference_steps(ran):
    """The reference's jitted sharded step on make_mesh(8) and its jitted
    unsharded step, from the port's initial params on the dryrun's windows."""
    rng = np.random.default_rng(0)
    t = 8 * 8 + 32
    progress = jnp.asarray(np.cumsum(1.0 + rng.normal(0, 0.05, t)).clip(0))
    windows, targets = jax_anomaly.make_windows(progress, jnp.full(t, 2))
    n = (windows.shape[0] // 8) * 8
    windows, targets = windows[:n], targets[:n]
    tx = optax.adam(1e-3)
    params = jax.tree.map(jnp.asarray, init_params(ProgressAnomalyModel(device="cpu"), 0))
    state = JaxTrainState(params, tx.init(params), jnp.int32(0))
    _, ref_loss = jax.jit(lambda s, w, y: jax_anomaly.train_step(s, tx, w, y))(
        state, windows, targets)
    mesh = jax_make_mesh(8)
    step = jax_mesh_mod.sharded_train_step(tx, mesh, state)
    _, loss = step(jax_mesh_mod.place_state(state, mesh), windows, targets)
    got, unsharded = ran["dp×tp"]
    for want in (float(loss), float(ref_loss)):
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (got, want)
        assert abs(unsharded - want) <= 1e-3 * max(1.0, abs(want)), (unsharded, want)


def test_entry_matches_the_reference_forward():
    fn, (model, example) = dryrun.entry("cpu")
    got = fn(model, example)
    assert got.shape == (256,) and example.shape == (256, 16 * 7)
    params = jax.tree.map(jnp.asarray, init_params(model, 0))
    want = jax_anomaly.ProgressAnomalyModel().apply(params, jnp.asarray(example.numpy()))
    assert want.shape == got.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(8)
