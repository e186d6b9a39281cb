"""The port's EMA (``pnpflow_tpu_torch/training/ema.py``) against
``pnpflow_tpu.training.ema`` on the same parameters.

Bound: 1e-7 absolute after five updates, with and without the warmup decay
(the same float32 operations in the same order on values of order 1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.training import ema as jema
from pnpflow_tpu_torch.training.ema import EMA


def _params(rng, shapes=((3, 4), (5,), (2, 2, 3, 3))):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("as_dict", [False, True])
def test_five_updates_match_jax(warmup, as_dict):
    rng = np.random.default_rng(0)
    init = _params(rng)
    updates = [_params(rng) for _ in range(5)]
    jstate = jema.init([jnp.asarray(p) for p in init], 0.999,
                       use_num_updates=warmup)
    tens = [torch.from_numpy(p.copy()) for p in init]
    ema = EMA(dict(enumerate(tens)) if as_dict else tens, 0.999,
              use_num_updates=warmup)
    for u in updates:
        jstate = jema.update(jstate, [jnp.asarray(p) for p in u])
        ema.update([torch.from_numpy(p) for p in u])
    got = ema.copy_to()
    if as_dict:
        assert list(got) == [0, 1, 2]
        got = list(got.values())
    for g, w in zip(got, jstate.shadow):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)
    assert ema.num_updates == (5 if warmup else None)
    # the params it was built from are copies, not the shadow
    np.testing.assert_array_equal(tens[0].numpy(), init[0])


def test_copy_to_store_restore_and_state_dict():
    rng = np.random.default_rng(1)
    params = [torch.from_numpy(p) for p in _params(rng)]
    ema = EMA(params, 0.9)
    with pytest.raises(ValueError, match="No parameters stored"):
        ema.restore(params)
    ema.update([p + 1.0 for p in params])
    orig = [p.clone() for p in params]
    ema.store(params)
    ema.copy_to(params)
    for p, s in zip(params, ema.shadow):
        assert torch.equal(p, s)
    ema.restore(params)
    for p, o in zip(params, orig):
        assert torch.equal(p, o)

    sd = ema.state_dict()
    assert sd["decay"] == 0.9 and sd["num_updates"] == 1
    other = EMA([torch.zeros_like(p) for p in params], 0.5,
                use_num_updates=False)
    other.load_state_dict(sd)
    assert other.decay == 0.9 and other.num_updates == 1
    for a, b in zip(other.shadow, ema.shadow):
        assert torch.equal(a, b) and a is not b
    ema.update(params)
    other.update(params)
    for a, b in zip(other.shadow, ema.shadow):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shadow"):
        EMA(params[:1], 0.9).load_state_dict(sd)
    with pytest.raises(ValueError, match="between 0 and 1"):
        EMA(params, 1.5)
