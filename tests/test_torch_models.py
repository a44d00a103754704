"""The port's sequence model and dense decode path against the JAX
reference, through the weight bridge.

One small model (``dim=32, heads=4, kv_heads=2, layers=2``) and its flax
params are built once per module; numpy-seeded inputs go through
``model.apply`` and through the port. Tolerances, with their reasons:

- forward and prefill: ``atol=2e-3`` on predictions of size ~1-3. The
  port reproduces flax's dtype mix op for op (bf16 Dense products and bias
  adds, op-by-op bf16 gelu, f32 LayerNorm with the fast variance), so what
  is left is f32 and bf16 products summed in another order (a bf16 ULP at
  1 is 2**-8; measured differences are ~1e-4 to 1e-3);
- cached decode steps: each step's kv column carries the previous steps'
  ULP differences into the cache, so the check is the repo's teacher-forced
  band for one tick (``tests/test_serving.py:106-109``: rtol 2e-2,
  atol 8e-3);
- k/v from ``return_kv`` and the dense cache: one bf16 ULP relative;
- ``forecast_deltas``: fed-back predictions amplify the per-step
  difference, so the check is the serving band of
  ``tests/test_serving.py:161-163`` (rtol 3e-2, atol 1.5e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beholder_tpu.models import TelemetrySequenceModel as JaxModel
from beholder_tpu.models import forecast_deltas as jax_forecast
from beholder_tpu.models.sequence import FEATURES
from beholder_tpu.models.decode import decode_step as jax_decode_step
from beholder_tpu.models.decode import prefill as jax_prefill
from beholder_tpu.models.sequence import stream_features as jax_stream_features
from beholder_tpu_torch.models import TelemetrySequenceModel, forecast_deltas
from beholder_tpu_torch.models.bridge import init_params, load_flax_params
from beholder_tpu_torch.models.decode import decode_step, prefill
from beholder_tpu_torch.models.sequence import stream_features

SIZES = dict(dim=32, heads=4, layers=2)
# MHA (kv_heads == heads) is the G=1 case of the same code; the op tests
# cover it on its own
VARIANTS = {
    "gqa": dict(kv_heads=2),
    "mqa-window": dict(kv_heads=1, window=5),
}


def _as_bf16(params):
    return jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params
    )


@pytest.fixture(scope="module")
def pairs():
    """(jax model, jax params, port model) per variant and param dtype."""
    out = {}
    for name, kw in VARIANTS.items():
        jm = JaxModel(**SIZES, **kw)
        # the params init_seq_state makes, without its optimizer state
        init = {"params": jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, FEATURES)))["params"]}
        for cast in ("f32", "bf16"):
            params = init if cast == "f32" else _as_bf16(init)
            tm = TelemetrySequenceModel(**SIZES, **kw, device="cpu")
            load_flax_params(tm, jax.tree.map(np.asarray, params))
            out[name, cast] = (jm, params, tm)
    return out


def _feats(seed, b=2, t=13):
    return np.random.default_rng(seed).normal(0, 1, (b, t, 7)).astype(np.float32)


@pytest.mark.parametrize("cast", ["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_return_kv_match_jax(pairs, variant, cast):
    jm, params, tm = pairs[variant, cast]
    feats = _feats(1)
    want, want_kv = jm.apply(params, jnp.asarray(feats), return_kv=True)
    got, got_kv = tm(torch.from_numpy(feats), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)
    np.testing.assert_allclose(
        tm(torch.from_numpy(feats)).numpy(), got.numpy(), rtol=0, atol=0
    )
    for (jk, jv), (tk, tv) in zip(want_kv, got_kv):
        assert tk.dtype == torch.bfloat16 and tuple(tk.shape) == jk.shape
        for j, t in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                rtol=2**-7, atol=2**-7,
            )


def test_bridge_keeps_bf16_leaves_and_maps_names(pairs):
    _, params, tm = pairs["gqa", "bf16"]
    block = tm.blocks[0]
    assert block.q_proj.weight.dtype == torch.bfloat16
    assert block.ln0.weight.dtype == torch.float32
    np.testing.assert_array_equal(
        block.up.weight.float().numpy(),
        np.asarray(params["params"]["block_0"]["up"]["kernel"].astype(jnp.float32)).T,
    )
    # the seeded initialiser builds the same tree shape the bridge reads
    fresh = init_params(tm, seed=0, bf16_matrices=True)
    load_flax_params(TelemetrySequenceModel(**SIZES, kv_heads=2, device="cpu"), fresh)
    # flash, ring and ulysses are ported (tests/test_torch_flash.py,
    # tests/test_torch_ring.py, tests/test_torch_parallel.py): ring and
    # ulysses need a mesh
    with pytest.raises(ValueError, match="mesh"):
        TelemetrySequenceModel(**SIZES, attention="ring", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        TelemetrySequenceModel(**SIZES, attention="ulysses", device="cpu")


@pytest.mark.parametrize(
    "variant,cast", [("gqa", "bf16"), ("mqa-window", "bf16"), ("gqa", "f32")]
)
def test_prefill_and_dense_decode_steps_match_jax(pairs, variant, cast):
    """Prefill then six cached steps (teacher-forced): predictions and the
    dense caches agree step for step."""
    jm, params, tm = pairs[variant, cast]
    feats = _feats(2, t=9)
    steps = np.random.default_rng(3).normal(0, 1, (6, 2, 7)).astype(np.float32)
    jp, jc = jax_prefill(jm, params, jnp.asarray(feats), 16)
    tp, tc = prefill(tm, torch.from_numpy(feats), 16)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-3)
    for i in range(6):
        jp, jc = jax_decode_step(jm, params, jc, jnp.asarray(steps[i]))
        tp, tc = decode_step(tm, tc, torch.from_numpy(steps[i]))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-2, atol=8e-3,
                                   err_msg=f"step {i}")
    assert int(tc.index) == int(jc.index) == 15
    for jk, tk in zip(jc.keys, tc.keys):
        np.testing.assert_allclose(
            tk.float().numpy(), np.asarray(jk.astype(jnp.float32)), rtol=2**-7, atol=2**-7
        )


def test_per_row_dense_cache_index_matches_jax(pairs):
    """The vector-index cache path (one position per row), t == 1 and the
    t > 1 chunked continuation, against the JAX block."""
    jm, params, tm = pairs["gqa", "bf16"]
    feats = _feats(4, t=8)
    _, jc = jax_prefill(jm, params, jnp.asarray(feats), 16)
    _, tc = prefill(tm, torch.from_numpy(feats), 16)
    index = np.array([8, 5], np.int64)
    apply = jax.jit(lambda p, x, c: jm.apply(p, x, cache=c))
    for t in (1, 3):
        x = _feats(5 + t, t=t)
        want, _ = apply(params, jnp.asarray(x),
                        (jc.keys, jc.values, jnp.asarray(index, jnp.int32)))
        got, _ = tm(torch.from_numpy(x), cache=(
            tuple(k.clone() for k in tc.keys), tuple(v.clone() for v in tc.values),
            torch.from_numpy(index)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


def test_stream_features_and_forecast_match_jax(pairs):
    jm, params, tm = pairs["gqa", "bf16"]
    rng = np.random.default_rng(6)
    prog = np.cumsum(2.0 + rng.normal(0, 0.3, (2, 14)), axis=-1)
    stats = rng.integers(0, 6, (2, 14))
    jf, jt = jax_stream_features(jnp.asarray(prog), jnp.asarray(stats))
    tf, tt = stream_features(torch.from_numpy(prog), torch.from_numpy(stats))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    want = np.asarray(jax_forecast(jm, params, jnp.asarray(prog), jnp.asarray(stats), 8))
    got = forecast_deltas(tm, torch.from_numpy(prog), torch.from_numpy(stats), 8).numpy()
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=1.5e-2)
