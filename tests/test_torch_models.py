"""glt_tpu_torch.models against glt_tpu.models on padded COO batches.

Aggregation compares to f32 round-off (``segment_sum`` and
``index_add_`` add in different orders): atol = rtol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.models import conv as jconv
from glt_tpu_torch.models import (
    GraphSAGE,
    params_from_flax,
    scatter_mean,
    scatter_sum,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _batch(n=30, e=90, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[-4:] = 0                                   # padding rows
    ei = rng.integers(0, n - 4, (2, e)).astype(np.int32)
    mask = rng.random(e) < 0.8
    ei[:, ~mask] = -1
    ei[1, :3] = -1                               # padding dst, mask on
    return x, ei, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("fn", ["sum", "mean"])
def test_scatter(fn, with_mask):
    x, ei, mask = _batch()
    jf = jconv.scatter_sum if fn == "sum" else jconv.scatter_mean
    tf = scatter_sum if fn == "sum" else scatter_mean
    msgs = x[np.clip(ei[0], 0, None)]
    ref = jf(jnp.asarray(msgs), jnp.asarray(ei[1]), x.shape[0],
             jnp.asarray(mask) if with_mask else None)
    got = tf(torch.from_numpy(msgs), torch.from_numpy(ei[1]), x.shape[0],
             torch.from_numpy(mask) if with_mask else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("layers", [1, 3])
def test_graphsage_forward(layers):
    x, ei, mask = _batch(seed=layers)
    jm = JaxSAGE(hidden_features=16, out_features=5, num_layers=layers)
    params = jm.init({"params": jax.random.PRNGKey(layers)},
                     jnp.asarray(x), jnp.asarray(ei), jnp.asarray(mask))
    tm = GraphSAGE(12, 16, 5, num_layers=layers)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(ei),
                   jnp.asarray(mask), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ei),
                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_params_from_flax_layout():
    jm = JaxSAGE(hidden_features=8, out_features=3, num_layers=2)
    x, ei, mask = _batch(d=6)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                     jnp.asarray(ei), jnp.asarray(mask))
    sd = params_from_flax(params)
    k = np.asarray(params["params"]["conv0"]["lin_self"]["kernel"])
    np.testing.assert_array_equal(sd["convs.0.lin_self.weight"].numpy(), k.T)
    assert "convs.1.lin_nbr.bias" not in sd
    assert set(sd) == set(GraphSAGE(6, 8, 3, num_layers=2).state_dict())
    with pytest.raises(KeyError):
        params_from_flax({"params": {"lin": {}}})
